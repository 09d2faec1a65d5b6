"""conv3x3 over a virtual concat of NHWC parts: the decoder-fusion op
(counterpart of ops/decoder_fusion.py::fused_upcat_conv3x3 and its custom VJP).

Every nested decoder node of NestedUNet computes
``conv3x3(concat(skips..., upsample2x(low))) + bias``. On a CUDA tensor
`multipart_conv3x3` launches the hand-written kernel in
`csrc/decoder_fusion.cu`, which reads each part through its own base pointer,
so the concatenated activation is never written: an implicit GEMM, in
bfloat16 on the tensor cores and in float32 on the FP32 cores. It takes
every shape: there is no shape guard and no fall-back. On CPU tensors it runs
the plain version,
`reference_multipart_conv3x3`, which the tests hold against the JAX package.
Under `torch.export` it is the registered operator
`torch.ops.nested_unet_torch.multipart_conv3x3` (CUDA: the kernel launch;
CPU: the plain version; any other device: the dispatcher raises), which
stays one node of the serving artifact (serving.py); everywhere else it
calls the launch directly, without the dispatcher's host time. The launch
is a ctypes call on the tensors' pointers.

Weights are HWIO `[3, 3, cin, co]` (co contiguous), the JAX kernel's layout and
the one the CUDA kernel reads; `pack_weight` makes it from torch's OIHW.

Gradients: `conv3x3_parts` takes torch's OIHW float32 weight and is a
`torch.autograd.Function` whose forward is `multipart_conv3x3` and whose
backward is the plain conv VJP (cuDNN), as JAX's `_mp_bwd` is plain XLA: one
`convolution_backward` per part against its own cin rows of the weight gives
that part's gradient and its rows of the weight gradient, so the backward
never builds the concat (nor splits a concatenated gradient); dbias is the
float32 sum of the gradient over (B, H, W). `multipart_conv3x3` routes
through it when an input requires grad.
"""

import ctypes
from typing import List, Optional, Sequence

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
    """torch OIHW [co, cin, 3, 3] -> contiguous HWIO [3, 3, cin, co] in `dtype`
    (detached: the gradient goes through `conv3x3_parts`)."""
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
        plan = lib.decoder_fusion_plan
        plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch_plan(dtype: torch.dtype, b: int, h: int, w: int, part_channels: Sequence[int],
                co: int) -> dict:
    """The launch the kernel makes in `dtype` on the current CUDA device for
    a shape: its pixel tile, output channels per block, K split (blocks per
    cluster), block count, threads per block and dynamic shared memory
    (builds the library on first use)."""
    chans = (ctypes.c_int * len(part_channels))(*part_channels)
    out = (ctypes.c_int * 7)()
    err = _lib().decoder_fusion_plan(_DTYPE_CODE[dtype], b, h, w, co, chans,
                                     len(part_channels), out)
    if err != 0:
        raise RuntimeError(f"decoder_fusion_plan failed: cudaError {err}")
    keys = ("tile_h", "tile_w", "co_per_block", "split", "blocks", "threads", "smem_bytes")
    return dict(zip(keys, out))


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
    the parts' dtype. CPU tensors: `reference_multipart_conv3x3`. Under
    `torch.export`, the registered operator
    `torch.ops.nested_unet_torch.multipart_conv3x3`, which the exported graph
    records. Inputs that require grad go through `conv3x3_parts` (the
    kernel's OIHW view).
    """
    parts = tuple(parts)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (*parts, kernel, bias)):
        return conv3x3_parts(parts, kernel.permute(3, 2, 0, 1), bias)
    if torch.compiler.is_exporting():
        return torch.ops.nested_unet_torch.multipart_conv3x3(list(parts), kernel, bias)
    return _forward(parts, kernel, bias)


def _forward(parts, kernel, bias):
    """The plain version on CPU tensors, the kernel on CUDA tensors, and an
    error on any other device."""
    if all(t is None or t.device.type == "cpu" for t in (*parts, kernel, bias)):
        return reference_multipart_conv3x3(parts, kernel, bias)
    if parts[0].device.type != "cuda":
        raise ValueError(f"multipart_conv3x3: no kernel for device {parts[0].device}")
    return _launch(parts, kernel, bias)


def _launch(parts, kernel, bias):
    """Check the arguments, launch the CUDA kernel on the current stream and
    count the launch."""
    global LAUNCHES
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


# The registered operator. Its CUDA implementation is `_launch` (no fall-back),
# its CPU implementation the plain version; the dispatcher raises on any other
# device. The fake implementation gives the output's shape and dtype from the
# inputs' alone, so the batch may be symbolic under torch.export.
@torch.library.custom_op("nested_unet_torch::multipart_conv3x3", mutates_args=(),
                         device_types="cuda")
def _multipart_conv3x3_op(parts: List[torch.Tensor], kernel: torch.Tensor,
                          bias: Optional[torch.Tensor]) -> torch.Tensor:
    return _launch(parts, kernel, bias)


@_multipart_conv3x3_op.register_kernel("cpu")
def _(parts, kernel, bias):
    return reference_multipart_conv3x3(parts, kernel, bias)


@_multipart_conv3x3_op.register_fake
def _(parts, kernel, bias):
    b, h, w = parts[0].shape[:3]
    return parts[0].new_empty((b, h, w, kernel.shape[-1]))


class _MultipartConv3x3(torch.autograd.Function):
    """Forward: the kernel (or its plain version) on the packed weight.
    Backward: the plain conv VJP of reference_multipart_conv3x3."""

    @staticmethod
    def forward(ctx, weight, bias, *parts):
        ctx.save_for_backward(weight, *parts)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _forward(parts, pack_weight(weight, parts[0].dtype), bias)

    @staticmethod
    def backward(ctx, g):
        weight, *parts = ctx.saved_tensors
        dt = parts[0].dtype
        g_nchw = g.to(dt).permute(0, 3, 1, 2)  # channels_last view of the NHWC gradient
        w = weight.to(dt)
        need_w = ctx.needs_input_grad[0]
        dparts, dweights, off = [], [], 0
        for i, p in enumerate(parts):
            cp = int(p.shape[-1])
            # one conv VJP per part against its own cin rows of the weight:
            # its input gradient and its slice of the weight gradient
            dp, dw, _ = torch.ops.aten.convolution_backward(
                g_nchw, p.permute(0, 3, 1, 2), w[:, off:off + cp], None, (1, 1), (1, 1),
                (1, 1), False, (0, 0), 1, (ctx.needs_input_grad[2 + i], need_w, False))
            dparts.append(None if dp is None else dp.permute(0, 2, 3, 1).contiguous())
            dweights.append(dw)
            off += cp
        dweight = torch.cat(dweights, dim=1).to(weight.dtype) if need_w else None
        dbias = None
        if ctx.bias_dtype is not None and ctx.needs_input_grad[1]:
            dbias = g.to(torch.float32).sum((0, 1, 2)).to(ctx.bias_dtype)
        return (dweight, dbias, *dparts)


def conv3x3_parts(parts: Sequence[torch.Tensor], weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable conv3x3(concat(parts, -1)) + bias with torch's OIHW
    weight [co, cin, 3, 3] (float32), packed to HWIO in the parts' dtype inside.
    Gradients reach the parts, the OIHW weight and the bias."""
    return _MultipartConv3x3.apply(weight, bias, *parts)
