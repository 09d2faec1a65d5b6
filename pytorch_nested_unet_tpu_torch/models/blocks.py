"""Conv blocks of the model zoo over NHWC tensors (counterpart of models/blocks.py).

`UnetConv2` and `ConvBNReLU` keep the reference's index-style layout
(`conv1.0` the conv, `conv1.1` the BN; a score block's `0` and `1`), so
their state-dict keys are the reference CRDN checkpoints' own.
"""

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.decoder_fusion import conv3x3_parts, multipart_conv3x3, pack_weight
from ..ops.fused_bn import FusedBatchNormReLU, bn_relu, recomputing
from ..ops.layers import TorchConv, empty_output


class MultipartConv3x3(nn.Module):
    """conv3x3(concat(parts), padding=1) with TorchConv's parameters.

    `weight` [co, cin, 3, 3] and `bias` [co] are float32 under torch's names, so
    a reference checkpoint's `<node>.conv1.{weight,bias}` load into it. The
    forward runs the decoder-fusion kernel on the parts tuple. When gradients
    are taken it goes through `ops.decoder_fusion.conv3x3_parts`, which packs
    the weight on every call so the gradient reaches `weight`; without them
    (serving, eval) the HWIO copy of the weights in the compute dtype is made
    once and made again only when the weights change (a step, a load, a move
    to another device). Under `torch.export` that copy, made before the
    trace, is what the exported program holds.

    `halo` = (rows, cols), 0 or 1 each, set on the 'x'/'y' mesh axes
    (`parallel.mesh.spatial_partition`): the parts carry that many of their
    neighbours' rows (and columns) beyond the band, the kernel runs on them
    with its padding of 1, and the output's first and last `rows` rows and
    `cols` columns are dropped. On an empty band (a map of fewer rows than
    bands) the parts are empty and so is the output, without a launch.
    """

    halo = (0, 0)

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self._packed = None
        self._packed_key = None

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        if torch.compiler.is_exporting():
            # the copy made before the trace (serving.py) becomes a constant of
            # the exported program; the traced weight has no data to key on
            if self._packed is None or self._packed.dtype != dtype:
                raise RuntimeError("MultipartConv3x3: call packed_weight(dtype) on the real "
                                   "weights before torch.export")
            return self._packed
        w = self.weight
        # a tensor made under inference_mode keeps no version counter
        version = -1 if w.is_inference() else w._version
        key = (w.data_ptr(), version, w.device, dtype)
        if key != self._packed_key:
            self._packed, self._packed_key = pack_weight(w, dtype), key
        return self._packed

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        dt = self.dtype or parts[0].dtype
        parts = tuple(p.to(dt) for p in parts)
        if parts[0].shape[1] == 0 or parts[0].shape[2] == 0:  # an empty band: no launch
            b, h, w = parts[0].shape[:3]
            return empty_output((b, h and h - 2 * self.halo[0], w and w - 2 * self.halo[1],
                                 self.weight.shape[0]), torch.cat(parts, -1), self.weight,
                                self.bias)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (self.weight, self.bias, *parts)):
            y = conv3x3_parts(parts, self.weight, self.bias)
        else:
            y = multipart_conv3x3(parts, self.packed_weight(dt), self.bias)
        rows, cols = self.halo
        if rows or cols:
            y = y[:, rows:y.shape[1] - rows, cols:y.shape[2] - cols].contiguous()
        return y


REMAT_MODES = ("none", "full", "policy")


class VGGBlock(nn.Module):
    """(conv3x3 -> BN -> ReLU) x2 (reference archs_backup.py:24-42).

    Given a tuple of NHWC parts (a decoder node's skips and its upsampled feed),
    the first conv is a MultipartConv3x3 over them; given one tensor, it is a
    TorchConv. `in_channels` is the parts' total.

    `remat` (one of REMAT_MODES) chooses what a train-mode forward under
    autograd keeps for backward, as the JAX package's `nn.remat` of the block:
    "none" every residual; "full" only the block's inputs, the block run
    again in backward (`torch.utils.checkpoint`; inside that recompute K1
    leaves the running statistics alone, and K1 and K4 launch again);
    "policy" the two conv outputs (which the BNs keep anyway): the
    activation conv2 needs for its weight gradient is not kept but made
    again in backward from conv1's output and bn1's mean and inv
    (`ops.fused_bn.bn_relu`), so no conv and no K1 runs twice.

    On bands (the 'x'/'y' mesh axes, `parallel.mesh.spatial_partition`)
    "full" runs the block's halo exchanges and its BNs' all-reduces again in
    the recompute; "policy" keeps of conv2's haloed input only its halo
    strips and makes its core, y1, again as above.
    """

    def __init__(self, in_channels: int, middle_channels: int, out_channels: int,
                 multipart: bool = False, dtype: Optional[torch.dtype] = None,
                 remat: str = "none"):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
        self.remat = remat
        if multipart:
            self.conv1 = MultipartConv3x3(in_channels, middle_channels, dtype=dtype)
        else:
            self.conv1 = TorchConv(in_channels, middle_channels, 3, padding=1, dtype=dtype)
        self.bn1 = FusedBatchNormReLU(middle_channels, dtype=dtype)
        self.conv2 = TorchConv(middle_channels, out_channels, 3, padding=1, dtype=dtype)
        self.bn2 = FusedBatchNormReLU(out_channels, dtype=dtype)

    def _block(self, x) -> torch.Tensor:
        x = self.bn1(self.conv1(x))
        return self.bn2(self.conv2(x))

    def _block_policy(self, x) -> torch.Tensor:
        x1 = self.conv1(x)
        y1, mean, inv = self.bn1.train_forward(x1)
        gamma, beta, dt = self.bn1.weight.detach(), self.bn1.bias.detach(), y1.dtype
        storage = y1.untyped_storage().data_ptr()
        # On bands conv2's halo pre-hook (parallel/mesh.py) hands it y1 with
        # its neighbours' edge rows: a copy, which conv2 would keep whole.
        # `record`, a pre-hook that runs after it, keeps the copy's halo
        # strips and its core's place; the core is y1, made again in unpack
        # like y1 itself, so no halo exchange runs in backward.
        haloed = {}

        def record(module, args):
            t = args[0]
            if t.shape == y1.shape:
                return
            rows, cols = (t.shape[1] - y1.shape[1]) // 2, (t.shape[2] - y1.shape[2]) // 2
            core = t[:, rows:t.shape[1] - rows]
            haloed.update(storage=t.untyped_storage().data_ptr(),
                          top=t[:, :rows].clone(), bottom=t[:, t.shape[1] - rows:].clone(),
                          left=core[:, :, :cols].clone(),
                          right=core[:, :, core.shape[2] - cols:].clone())

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr == storage:  # a view of y1: made again
                return False, t.size(), t.stride(), t.storage_offset()
            if ptr == haloed.get("storage"):  # a view of the haloed y1: made again
                return True, t.size(), t.stride(), t.storage_offset()
            return t

        def unpack(packed):
            if isinstance(packed, torch.Tensor):
                return packed
            with torch.no_grad():
                y = bn_relu(x1, mean, inv, gamma, beta).to(dt)
                if packed[0]:
                    h = haloed
                    y = torch.cat([h["top"], torch.cat([h["left"], y, h["right"]], 2),
                                   h["bottom"]], 1)
                return y.as_strided(*packed[1:])

        handle = self.conv2.register_forward_pre_hook(record)
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                x2 = self.conv2(y1)
        finally:
            handle.remove()
        return self.bn2(x2)

    def forward(self, x) -> torch.Tensor:
        if self.remat == "none" or not (self.training and torch.is_grad_enabled()):
            return self._block(x)
        if self.remat == "policy":
            return self._block_policy(x)
        multipart = isinstance(x, (tuple, list))
        # On bands the recompute makes collectives in backward: the halo
        # pre-hooks' exchanges and the BNs' all-reduces, between those of
        # the halos' own backward. Every rank builds the same graph in the
        # same order, and autograd runs a graph's nodes in an order that the
        # graph fixes (one device thread, by each node's sequence number), so
        # each rank starts this recompute, and each of its collectives, at
        # the same point of its backward.

        def run(*parts):
            return self._block(parts if multipart else parts[0])

        return checkpoint(run, *(x if multipart else (x,)), use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), recomputing()))


class UnetConv2(nn.Module):
    """(conv3x3 [-> BN] -> ReLU) x2 (reference archs_backup.py:365-383,
    CRDN.py:201-221): `conv1` and `conv2` are each (conv, BN+ReLU), or
    (conv, ReLU) without batch norm."""

    def __init__(self, in_channels: int, out_channels: int, is_batchnorm: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for i, cin in ((1, in_channels), (2, out_channels)):
            act = FusedBatchNormReLU(out_channels, dtype=dtype) if is_batchnorm else nn.ReLU()
            setattr(self, f"conv{i}", nn.Sequential(
                TorchConv(cin, out_channels, 3, padding=1, dtype=dtype), act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class ConvBNReLU(nn.Sequential):
    """conv -> BN -> ReLU as one (conv, BN+ReLU) sequence: the CRDN score
    blocks (reference archs_backup.py:313-321). The JAX module's stride and
    conv_impl options have no caller there and are not ported."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__(TorchConv(in_channels, out_channels, kernel_size, padding, dtype),
                         FusedBatchNormReLU(out_channels, dtype=dtype))
