"""conv3x3 over a virtual concat of NHWC parts: the decoder-fusion op
(counterpart of ops/decoder_fusion.py::fused_upcat_conv3x3).

Every nested decoder node of NestedUNet computes
``conv3x3(concat(skips..., upsample2x(low))) + bias``. On a CUDA tensor
`multipart_conv3x3` launches the hand-written kernel in
`csrc/decoder_fusion.cu`, which reads each part through its own base pointer,
so the concatenated activation is never written. It takes every shape: there
is no shape guard and no fall-back. On CPU tensors it runs the plain version,
`reference_multipart_conv3x3`, which the tests hold against the JAX package.

Weights are HWIO `[3, 3, cin, co]` (co contiguous), the JAX kernel's layout and
the one the CUDA kernel reads; `pack_weight` makes it from torch's OIHW once.
This slice is forward-only: inputs that require grad are refused.
"""

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

# Launches of the CUDA kernel; chip_smoke.py zeroes it before driving the
# serving path and reads it after.
LAUNCHES = 0

MAX_PARTS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def pack_weight(weight_oihw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch OIHW [co, cin, 3, 3] -> contiguous HWIO [3, 3, cin, co] in `dtype`."""
    return weight_oihw.detach().to(dtype).permute(2, 3, 1, 0).contiguous()


def reference_multipart_conv3x3(parts: Sequence[torch.Tensor], kernel: torch.Tensor,
                                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: torch.cat + F.conv2d, bias added in the parts' dtype.

    The semantics spec of the kernel (JAX: reference_multipart_conv3x3).
    """
    x = torch.cat(list(parts), dim=-1) if len(parts) > 1 else parts[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.contiguous()


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("decoder_fusion")
        fn = lib.decoder_fusion_fwd
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_cuda_args(parts, kernel, bias):
    dev, dt = parts[0].device, parts[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"multipart_conv3x3: dtype {dt} not supported (float32, bfloat16)")
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"multipart_conv3x3: 1..{MAX_PARTS} parts, got {len(parts)}")
    b, h, w = parts[0].shape[:3]
    for p in parts:
        if p.device != dev or p.dtype != dt:
            raise ValueError("multipart_conv3x3: parts differ in device or dtype")
        if p.dim() != 4 or tuple(p.shape[:3]) != (b, h, w):
            raise ValueError(f"multipart_conv3x3: part shape {tuple(p.shape)} is not "
                             f"({b}, {h}, {w}, C)")
        if not p.is_contiguous():
            raise ValueError("multipart_conv3x3: parts must be NHWC-contiguous")
    cin = sum(int(p.shape[-1]) for p in parts)
    if (kernel.device != dev or kernel.dtype != dt or kernel.dim() != 4
            or tuple(kernel.shape[:3]) != (3, 3, cin) or not kernel.is_contiguous()):
        raise ValueError(f"multipart_conv3x3: kernel must be contiguous [3, 3, {cin}, co] "
                         f"{dt} on {dev}, got {tuple(kernel.shape)} {kernel.dtype} "
                         f"on {kernel.device}")
    co = int(kernel.shape[-1])
    if bias is not None and (bias.device != dev or bias.dtype != torch.float32
                             or tuple(bias.shape) != (co,) or not bias.is_contiguous()):
        raise ValueError(f"multipart_conv3x3: bias must be contiguous float32 ({co},) "
                         f"on {dev}")
    return dev, dt, (b, h, w), co


def multipart_conv3x3(parts: Sequence[torch.Tensor], kernel: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(concat(parts, -1), kernel) + bias; NHWC parts, HWIO kernel.

    CUDA tensors: the kernel, bias in float32 added before the one rounding to
    the parts' dtype. CPU tensors: `reference_multipart_conv3x3`.
    """
    global LAUNCHES
    parts = tuple(parts)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (*parts, kernel, bias)):
        raise NotImplementedError("multipart_conv3x3 is forward-only; its backward "
                                  "comes with the training slice (ROADMAP.md)")
    if all(t is None or t.device.type == "cpu" for t in (*parts, kernel, bias)):
        return reference_multipart_conv3x3(parts, kernel, bias)
    if parts[0].device.type != "cuda":
        raise ValueError(f"multipart_conv3x3: no kernel for device {parts[0].device}")
    dev, dt, (b, h, w), co = _check_cuda_args(parts, kernel, bias)
    out = torch.empty((b, h, w, co), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    ptrs = (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts])
    chans = (ctypes.c_int * len(parts))(*[int(p.shape[-1]) for p in parts])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decoder_fusion_fwd(
            _DTYPE_CODE[dt], ptrs, chans, len(parts), kernel.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, co, stream)
    if err != 0:
        raise RuntimeError(f"decoder_fusion_fwd launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
