"""The port's spatial partitioning (the 'x'/'y' mesh axes: parallel/halo.py,
the band ops, the spatial train and eval steps, `train --mesh x=2`).

One process, no ranks: each band op on a band given with its window (its
halo, cut from the zero-padded full tensor) against the band of the
full-image op, at every band of x = 2, 3, 4 and of 'y' splits, forward and
gradient (float64 where the op allows it, 1e-10; K4's plain version, the
float32 upsample and the CRDN cell's carry resize 1e-6; the nearest
upsample exactly); the JAX rule that `check_spatial` now holds every arch
to, at the sizes each arch's band rule used to refuse; a VGGBlock under
--remat policy on a band keeps conv2's halo strips, not its haloed input.

Several OS processes over Gloo on 127.0.0.1 (2 intra-op threads each; this
file run as a script is the worker), one launch per world size serving
every case of it:

- world 2 ('x' = 2): the row fetch of a symmetric halo (`halo.fetch`)
  against the padded full tensor and its adjoint (<halo(x), g> = <x,
  halo^T(g)> over the ranks, float64, 1e-6);
  `gather_bands` forward and backward; the train step of every x=2 case of
  `CASES` (UNet, NestedUNet wDS also under --remat full and policy,
  AttU_Net, R2AttU_Net, UNetRNN with each decoder, UNetRM3, UNetRM7)
  against the JAX package's spatial step on 2 of its virtual CPU devices
  (`make_train_step(..., mesh=make_mesh((1, 2), ("data", "x")),
  spatial=True)`) from the same weights: loss 1e-5, running statistics
  1e-5, the SGD momentum buffers (the first step's g + wd * p) within 1e-4
  relative L2 (the chaotic narrow steps of the archs after UNet and
  NestedUNet within their readings, `_hold_to_jax`) and the parameters
  after the step within 1e-6; the remat steps bitwise the band step
  without remat; the eval step against the port's one-process eval step; a
  halo wait on a peer that never sends raises after `halo.TIMEOUT` (2 s
  there);
- world 4: the halo and `gather_bands` with 'x' = 'y' = 2 (the corners);
  the UNet step under x=2,y=2 and the NestedUNet wDS step under
  data=2,x=2 against the port's one-process step (the same gates) and
  against the JAX package's spatial step on 4 of its virtual CPU devices
  (make_mesh((1, 2, 2), ('data', 'x', 'y')) and make_mesh((2, 2), ('data',
  'x')), the two-rank test's gates), and the data=2,x=2 eval step on a
  padded batch.

`train --mesh x=2` as two processes against `--mesh data=1` in one, the
JAX CLI test's bounds (loss 3e-3, IoU 3e-2), for UNet, for UNetRNN and
for NestedUNet wDS under --remat policy.
"""

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.models.blocks import MultipartConv3x3
from pytorch_nested_unet_tpu_torch.ops.layers import BatchNorm, FlaxBatchNorm, TorchConv
from pytorch_nested_unet_tpu_torch.ops.pool import max_pool2x2
from pytorch_nested_unet_tpu_torch.ops.resize import resize_band, resize_window, upsample2x
from pytorch_nested_unet_tpu_torch.parallel import mesh as tmesh
from pytorch_nested_unet_tpu_torch.parallel.halo import cut

NARROW = (4, 8, 16, 32, 64)
HW = 32
BATCH = 4  # the global batch of the steps
CRDN = {"feature_scale": 16}
# The narrow models of the band steps: (arch, both packages' create_model
# keywords, the input's (H, W)). The CRDN UNets' coarsest band must hold 2
# rows (their 5x5 score convs' halo), so UNetRNN runs at 64x64 and UNetRM7,
# whose 6 pools halve 96 rows only down to 3, at 256x64; the dual-attention
# UNetRNNs and VGG16RNN (full width: it has no width option) split only H
# at 64x32, UNetRNNAttention also 'y' at 64x64; UNetRNNGhost's Ghost score
# blocks take a halo of 1, as CA-Net's convs do (its dropout 0 against the
# JAX package: the two draw their masks from different generators).
MODELS = {"UNet": ("UNet", {"nb_filter": NARROW}, (HW, HW)),
          "NestedUNet": ("NestedUNet", {"nb_filter": NARROW}, (HW, HW)),
          "AttU_Net": ("AttU_Net", {"filters": NARROW}, (HW, HW)),
          "R2AttU_Net": ("R2AttU_Net", {"filters": NARROW}, (HW, HW)),
          **{f"UNetRNN_{d}": ("UNetRNN", {**CRDN, "decoder": d}, (64, 64))
             for d in ("GRU", "LSTM", "vanilla")},
          "UNetRM3": ("UNetRM3", CRDN, (HW, HW)),
          "UNetRM7": ("UNetRM7", CRDN, (256, 64)),
          "UNetRNNGhost": ("UNetRNNGhost", CRDN, (HW, HW)),
          "UNetRNNPAttention": ("UNetRNNPAttention", CRDN, (64, HW)),
          "UNetRNNCAttention": ("UNetRNNCAttention", CRDN, (64, HW)),
          "UNetRNNAttention": ("UNetRNNAttention", CRDN, (64, 64)),
          "VGG16RNN": ("VGG16RNN", {}, (64, HW)),
          "CANet": ("Comprehensive_Atten_Unet", {"feature_scale": 16, "drop_rate": 0.0},
                    (HW, HW)),
          "CANet_dropout": ("Comprehensive_Atten_Unet", {"feature_scale": 16, "drop_rate": 0.5},
                            (HW, HW))}
X2 = ((1, 2), ("data", "x"))
# The band steps, by key: (model, deep supervision, --remat, the port's mesh
# (sizes, names), the JAX package's mesh for its spatial step, BN finishes
# per step: one per FusedBatchNormReLU, twice under "full", whose recompute
# finishes again; the attention U-Nets' and CA-Net's plain BNs finish none,
# UNetRNNGhost's Ghost score blocks' neither). A case runs in the world of its
# port mesh's size; one without a JAX mesh (CA-Net with dropout on) is held
# to the port's one-process step only.
CASES = {"UNet_data1_x2": ("UNet", False, "none", X2, X2, 18),
         "NestedUNet_data1_x2": ("NestedUNet", True, "none", X2, X2, 30),
         "NestedUNet_full_x2": ("NestedUNet", True, "full", X2, X2, 60),
         "NestedUNet_policy_x2": ("NestedUNet", True, "policy", X2, X2, 30),
         "AttU_Net_x2": ("AttU_Net", False, "none", X2, X2, 0),
         "R2AttU_Net_x2": ("R2AttU_Net", False, "none", X2, X2, 0),
         **{f"UNetRNN_{d}_x2": (f"UNetRNN_{d}", False, "none", X2, X2, 15)
            for d in ("GRU", "LSTM", "vanilla")},
         "UNetRM3_x2": ("UNetRM3", False, "none", X2, X2, 9),
         "UNetRM7_x2": ("UNetRM7", False, "none", X2, X2, 21),
         "UNetRNNGhost_x2": ("UNetRNNGhost", False, "none", X2, X2, 10),
         **{f"{a}_x2": (a, False, "none", X2, X2, 15)
            for a in ("UNetRNNPAttention", "UNetRNNCAttention", "UNetRNNAttention")},
         "VGG16RNN_x2": ("VGG16RNN", False, "none", X2, X2, 18),
         "CANet_x2": ("CANet", False, "none", X2, X2, 0),
         "CANet_dropout_x2": ("CANet_dropout", False, "none", X2, None, 0),
         "UNet_x2_y2": ("UNet", False, "none", ((2, 2), ("x", "y")),
                        ((1, 2, 2), ("data", "x", "y")), 18),
         "NestedUNet_data2_x2": ("NestedUNet", True, "none", ((2, 2), ("data", "x")),
                                 ((2, 2), ("data", "x")), 30),
         "UNetRNNAttention_x2_y2": ("UNetRNNAttention", False, "none", ((2, 2), ("x", "y")),
                                    ((1, 2, 2), ("data", "x", "y")), 15)}
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPLITS = [(2, 1), (3, 1), (4, 1), (1, 2), (2, 2), (1, 3)]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's torch work in the test process
    (the ranks set their own): the suite runs in several worker processes
    at once, and the port's one-process steps of the band cases and their
    weight readings run faster on 2 threads each than oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ one process

class _Band(tuple):
    """(h0, hb, w0, wb) of a band, its (i, j) as `index`."""

    def __new__(cls, values, index):
        band = super().__new__(cls, values)
        band.index = index
        return band


def _bands(h, w, nx, ny):
    """(h0, hb, w0, wb) of every band of an h x w image split nx x ny (the
    cut, `parallel.halo.cut`: equal bands where nx divides h)."""
    ch, cw = cut(h, nx), cut(w, ny)
    return [_Band((ch[i], ch[i + 1] - ch[i], cw[j], cw[j + 1] - cw[j]), (i, j))
            for i in range(nx) for j in range(ny)]


def _haloed(x, band, rows, cols, edge=0.0):
    """The band of (B, H, W, C) x with `rows` / `cols` of halo, zeros past
    the edge: what halo_exchange gives the rank that holds it (`edge`:
    another value past the edge)."""
    h0, hb, w0, wb = band
    return F.pad(x, (0, 0, cols, cols, rows, rows), value=edge)[:, h0:h0 + hb + 2 * rows,
                                                                w0:w0 + wb + 2 * cols]


def _with_halo(mod, halo, *args):
    """mod(*args) with its `halo` set as `parallel.mesh.spatial_partition`
    sets it, then back to a whole image's."""
    mod.halo = halo
    try:
        return mod(*args)
    finally:
        mod.halo = (0, 0)


def _windowed(x, rows, cols, edge=0.0):
    """Rows [rows[0], rows[1]) and columns [cols[0], cols[1]) of (B, H, W,
    C) x, `edge` outside it."""
    p = max(0, -rows[0], -cols[0], rows[1] - x.shape[1], cols[1] - x.shape[2])
    xp = F.pad(x, (0, 0, p, p, p, p), value=edge)
    return xp[:, rows[0] + p:rows[1] + p, cols[0] + p:cols[1] + p]


def _check_band_op(full_op, band_op, x, nx, ny, rows, cols, tol, params=(), edge=0.0,
                   window=None):
    """band_op(haloed band, band) against full_op(x)'s band, and the
    gradients of <out, ct> with respect to x and `params` (`edge`: the
    halo's value past the image's edge; `window(band)`: the band's window
    ((row lo, hi), (column lo, hi)) in place of its symmetric halo)."""
    want_full = full_op(x)
    (h, w), (ho, wo) = x.shape[1:3], want_full.shape[1:3]
    gen = torch.Generator().manual_seed(7)
    ct = torch.randn(want_full.shape, generator=gen, dtype=x.dtype)
    xs = [x.detach().clone().requires_grad_(True) for _ in range(2)]
    got_sum = 0
    for k, band in enumerate(_bands(h, w, nx, ny)):
        h0, hb, w0, wb = band
        i, j = divmod(k, ny)
        out_rows = slice(cut(ho, nx)[i], cut(ho, nx)[i + 1])
        out_cols = slice(cut(wo, ny)[j], cut(wo, ny)[j + 1])
        xin = (_haloed(xs[0], band, rows, cols, edge) if window is None
               else _windowed(xs[0], *window(band), edge))
        got = band_op(xin, band)
        want = want_full[:, out_rows, out_cols]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=tol,
                                   rtol=tol)
        got_sum = got_sum + (got * ct[:, out_rows, out_cols]).sum()
    got_grads = torch.autograd.grad(got_sum, [xs[0], *params])
    want_grads = torch.autograd.grad((full_op(xs[1]) * ct).sum(), [xs[1], *params])
    for g, wg in zip(got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), wg.numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("nx,ny", SPLITS)
@pytest.mark.parametrize("h,w", [(12, 12), (24, 36)])
def test_upsample2x_band_matches_the_full_upsample(nx, ny, h, w):
    """Every band of a 2x align-corners upsample from a one-row halo
    (`resize_band`, what `Upsample2x` runs on bands through `Bands.resize`):
    the positions are global (output row i reads i * (H - 1) / (2H - 1) of
    the whole map), float32 within 1e-6 of `F.interpolate` on the full map."""
    x = torch.randn(2, h, w, 3, generator=torch.Generator().manual_seed(h * w + nx))
    rows, cols = int(nx > 1), int(ny > 1)
    _check_band_op(upsample2x, _resize_on(h, w, 2 * h, 2 * w, rows, cols, nx, ny, True), x, nx,
                   ny, rows, cols, 1e-6)


def _resize_on(h, w, ho, wo, rows, cols, nx, ny, align_corners, mode="bilinear",
               exact=False):
    """band_op: `resize_band` of an (h, w) map to (ho, wo) on a band given
    with `rows` / `cols` of halo: its output band under the cut; `exact`:
    (band_op, window) on the band's window (`resize_window`) instead."""
    def spans(band):
        i, j = band.index
        return ((cut(ho, nx)[i], cut(ho, nx)[i + 1]), (cut(wo, ny)[j], cut(wo, ny)[j + 1]))

    def window(band):
        return tuple(resize_window(n, no, a, b, mode, align_corners) if n != no
                     else (band[2 * k], band[2 * k] + band[2 * k + 1])
                     for k, (n, no, (a, b)) in enumerate(zip((h, w), (ho, wo), spans(band))))

    def band_op(xh, band):
        origin = ([lo for lo, _ in window(band)] if exact
                  else (band[0] - rows, band[2] - cols))
        return resize_band(xh, origin, (h, w), (ho, wo), spans(band), mode, align_corners)

    return (band_op, window) if exact else band_op


@pytest.mark.parametrize("nx,ny", SPLITS)
@pytest.mark.parametrize("decoder", ["GRU", "LSTM"])
def test_rdc_carry_resize_on_bands_matches_the_full_resize(nx, ny, decoder):
    """The CRDN cell's carry resize on a band (the 2x align-corners resize
    of a carry given with a one-row halo, `resize_band`, which `RDC._resize`
    runs on bands through `Bands.resize`): the band of `resize_bilinear`'s
    2x align-corners resize of the whole carry (h_pre, and c_pre for the
    LSTM: the same resize), value and adjoint, float32 within 1e-6; and
    RM7's 1 -> 3 and 3 -> 6 at 96x96 from the rows they read. On a whole
    image it is `resize_bilinear` itself, to any size, bit for bit."""
    from pytorch_nested_unet_tpu_torch.models.rdc import RDC
    from pytorch_nested_unet_tpu_torch.ops.resize import resize_bilinear

    rdc = RDC(1, decoder=decoder)
    h, w = 12, 24
    x = torch.randn(2, h, w, 1, generator=torch.Generator().manual_seed(nx * 10 + ny))
    rows, cols = int(nx > 1), int(ny > 1)
    _check_band_op(lambda t: resize_bilinear(t, (2 * h, 2 * w), align_corners=True),
                   _resize_on(h, w, 2 * h, 2 * w, rows, cols, nx, ny, True), x, nx, ny, rows,
                   cols, 1e-6)
    for hi, ho in ((3, 6), (1, 3)):
        xs = torch.randn(2, hi, w, 1, generator=torch.Generator().manual_seed(hi))
        band_op, window = _resize_on(hi, w, ho, w, 0, 0, nx, ny, True, exact=True)
        _check_band_op(lambda t: resize_bilinear(t, (ho, w), align_corners=True), band_op, xs,
                       nx, ny, 0, 0, 1e-6, window=window)
    for size in ((2 * h, 2 * w), (3, 6), (h, w)):
        np.testing.assert_array_equal(rdc._resize(x, size).numpy(),
                                      resize_bilinear(x, size, align_corners=True).numpy())


@pytest.mark.parametrize("nx,ny", SPLITS)
@pytest.mark.parametrize("scale", [1, 2, 4, 8])
def test_resize_bilinear_band_matches_the_full_resize(nx, ny, scale):
    """The band half-pixel resize (`resize_band`) at integer factors 1, 2, 4
    and 8 (CA-Net's half-pixel resizes: the grid gates' 2x, UpCat's
    bilinear 2x, the heads' 2x / 4x / 8x) on every band from a one-row
    halo, float64 within 1e-10 of `F.interpolate` on the whole map, value
    and adjoint. The halo past the image's edge is NaN: at the edge the
    half-pixel positions clamp to the edge row, so no output reads past it;
    factor 1 takes no halo."""
    h, w = 12, 24
    x = torch.randn(2, h, w, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(nx * 10 + ny + scale))
    rows, cols = (int(n > 1 and scale > 1) for n in (nx, ny))

    def full_op(t):
        return F.interpolate(t.permute(0, 3, 1, 2), size=(h * scale, w * scale), mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)

    _check_band_op(full_op, _resize_on(h, w, h * scale, w * scale, rows, cols, nx, ny, False), x,
                   nx, ny, rows, cols, 1e-10, edge=float("nan"))


@pytest.mark.parametrize("nx,ny", SPLITS[:3] + SPLITS[4:5])
def test_kernel_stride_conv_and_deconv_stay_local_on_bands(nx, ny):
    """A conv of kernel = stride without padding (CA-Net's grid gates' theta
    at attention_dsample (2, 2)) and a 2x2 stride-2 transposed conv
    (UpCat's deconv) on bands that the stride divides, without a halo: the
    band of the whole map's output, value and gradients, float64 within
    1e-10; `conv_halo` gives such a conv no halo and `check_transposed_conv`
    accepts the deconv."""
    from pytorch_nested_unet_tpu_torch.ops.layers import TorchConvTranspose

    torch.manual_seed(nx * 10 + ny)
    conv = TorchConv(3, 5, 2, 0, stride=2).double()
    deconv = TorchConvTranspose(3, 4, 2, 2).double()
    for m in (conv, deconv):
        with torch.no_grad():
            m.weight.normal_()
            m.bias.normal_()
    assert tmesh.conv_halo(conv, _FakeMesh(nx, ny)) == (0, 0)
    tmesh.check_transposed_conv(deconv, _FakeMesh(nx, ny))
    x = torch.randn(2, 24, 24, 3, dtype=torch.float64)
    for m in (conv, deconv):
        _check_band_op(m, lambda xh, band: m(xh), x, nx, ny, 0, 0, 1e-10,
                       (m.weight, m.bias))


@pytest.mark.parametrize("nx,ny", SPLITS)
def test_nearest_upsample_stays_local_on_bands(nx, ny):
    """The attention U-Nets' nearest 2x upsample (`Upsample2xNearest`) on a
    band without a halo: output row i of the band reads its row i // 2, so
    it is the band of the whole map's upsample, value and adjoint,
    exactly."""
    from pytorch_nested_unet_tpu_torch.models.attention_unet import Upsample2xNearest

    up = Upsample2xNearest()
    x = torch.randn(2, 12, 12, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(nx * 10 + ny))
    _check_band_op(up, lambda xh, band: up(xh), x, nx, ny, 0, 0, 0.0)


@pytest.mark.parametrize("nx,ny", SPLITS)
def test_max_pool2x2_stays_local_on_even_bands(nx, ny):
    """Bands of an even number of rows and columns pool on their own: the
    band of the full pool, value and gradient, exactly."""
    x = torch.randn(2, 24, 24, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(nx * 10 + ny))
    _check_band_op(max_pool2x2, lambda xh, band: max_pool2x2(xh), x, nx, ny, 0, 0, 0.0)


@pytest.mark.parametrize("nx,ny", SPLITS)
@pytest.mark.parametrize("kernel,padding,dilation", [(3, 1, 1), (1, 0, 1), (3, 2, 2)])
def test_torch_conv_band_forward_matches_the_full_conv(nx, ny, kernel, padding, dilation):
    """TorchConv on a band with padding * dilation rows of halo and no
    padding on the split axes: float64 within 1e-10, the input's and the
    weight's gradients too."""
    torch.manual_seed(nx * 100 + ny * 10 + kernel)
    conv = TorchConv(3, 5, kernel, padding=padding, dilation=dilation).double()
    with torch.no_grad():
        conv.weight.normal_()
        conv.bias.normal_()
    rows, cols = tmesh.conv_halo(conv, _FakeMesh(nx, ny))
    assert (rows, cols) == (padding if nx > 1 else 0, padding if ny > 1 else 0)
    x = torch.randn(2, 12, 12, 3, dtype=torch.float64)
    _check_band_op(conv, lambda xh, band: _with_halo(conv, (rows, cols), xh), x, nx, ny, rows,
                   cols, 1e-10, (conv.weight, conv.bias))


def test_torch_conv_refuses_a_size_changing_conv_on_bands():
    """A conv that changes the size (a valid 3x3, strided or not) is now
    accepted on a split axis: it reads the window of its output rows and
    runs without padding (`conv_halo` is its padding, 0); a transposed conv
    whose windows overlap is still refused there (no arch has one); kernel
    = stride reads its own rows (no halo)."""
    from pytorch_nested_unet_tpu_torch.ops.layers import TorchConvTranspose

    for kw in ({"stride": 2, "padding": 0}, {"padding": 0}):
        assert tmesh.conv_halo(TorchConv(3, 4, 3, **kw), _FakeMesh(2, 1)) == (0, 0)
    assert tmesh.conv_halo(TorchConv(3, 4, 3, stride=2, padding=1), _FakeMesh(1, 1)) == (0, 0)
    assert tmesh.conv_halo(TorchConv(3, 4, 2, stride=2), _FakeMesh(2, 2)) == (0, 0)
    with pytest.raises(ValueError, match="overlaps its windows"):
        tmesh.check_transposed_conv(TorchConvTranspose(3, 4, 3, 2, 1), _FakeMesh(1, 2))
    tmesh.check_transposed_conv(TorchConvTranspose(3, 4, 3, 2, 1), _FakeMesh(1, 1))


@pytest.mark.parametrize("nx,ny", SPLITS)
def test_multipart_conv3x3_band_matches_the_full_conv(nx, ny):
    """K4's module on haloed parts with its padding of 1, the first and last
    halo rows of the output dropped: its plain version (no grad) and the
    conv3x3_parts VJP (grad), float32 within 1e-5 of the full conv."""
    torch.manual_seed(nx * 10 + ny)
    conv = MultipartConv3x3(7, 6)
    with torch.no_grad():
        conv.weight.normal_(0, 0.3)
        conv.bias.normal_()
    parts = [torch.randn(2, 12, 12, c) for c in (3, 4)]
    rows, cols = int(nx > 1), int(ny > 1)
    x = torch.cat(parts, -1)

    def full_op(t):
        return conv((t[..., :3], t[..., 3:]))

    def band_op(th, band):
        return _with_halo(conv, (rows, cols), (th[..., :3], th[..., 3:]))

    _check_band_op(full_op, band_op, x, nx, ny, rows, cols, 1e-5, (conv.weight, conv.bias))
    with torch.no_grad():  # the no-grad path: the kernel's plain version
        want = full_op(x)
        for band in _bands(12, 12, nx, ny):
            h0, hb, w0, wb = band
            np.testing.assert_allclose(band_op(_haloed(x, band, rows, cols), band).numpy(),
                                       want[:, h0:h0 + hb, w0:w0 + wb].numpy(), atol=1e-5)


def test_remat_policy_keeps_no_haloed_copy_on_bands():
    """VGGBlock on a band (its convs' halo set and their inputs given one
    zero row above and below, as the halo pre-hook gives them): under
    --remat policy conv2's haloed input is not kept for backward (only its
    halo strips are, the core made again from conv1's output), under none
    it is; both give the same gradients, bit for bit."""
    import gc
    import weakref

    from pytorch_nested_unet_tpu_torch.models.blocks import VGGBlock
    from pytorch_nested_unet_tpu_torch.ops.init import init_convs_

    grads = {}
    for mode in ("none", "policy"):
        block = VGGBlock(3, 4, 5, remat=mode).train()
        init_convs_(block, torch.Generator().manual_seed(3))
        seen = []
        for conv in (block.conv1, block.conv2):
            conv.halo = (1, 0)
            conv.register_forward_pre_hook(lambda m, a: (F.pad(a[0], (0, 0, 0, 0, 1, 1)),))
        block.conv2.register_forward_pre_hook(lambda m, a: seen.append(weakref.ref(a[0])))
        x = torch.randn(2, 6, 5, 3, generator=torch.Generator().manual_seed(4),
                        requires_grad=True)
        y = block(x)
        gc.collect()
        assert (seen[0]() is None) == (mode == "policy"), mode
        (y * torch.arange(y.numel()).reshape(y.shape).sin()).sum().backward()
        grads[mode] = [x.grad] + [p.grad for p in block.parameters()]
    for a, b in zip(grads["none"], grads["policy"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


class _FakeMesh:
    """The partition a conv asks about, without ranks."""

    def __init__(self, nx, ny):
        self.shape = {"x": nx, "y": ny}

    def partitioned(self, axis):
        return self.shape[axis] > 1


def test_spatial_partition_refuses_other_archs_and_remat():
    """What the band rule used to refuse is accepted: ResNet50FCN, a depth
    other than the table's (AttU_Net at 4 levels), an element-wise dropout
    (it draws its data row's whole mask and keeps the band's share), as a
    channel dropout is; an arch the registry does not hold is refused.
    Every --remat mode of NestedUNet is accepted.
    On UNet, a pre-hook and a halo (the padding it leaves out) on every 3x3
    conv and K4 node (none on the 1x1 head and none on the model: its step
    runs inside `bands_of(m).step`), and the upsample's `bands`; on
    UNetRNN the 5x5
    score convs' halo of 2 and the CRDN cell's `bands`; None undoes it
    all."""
    from pytorch_nested_unet_tpu_torch.ops.layers import ChannelDropout, Dropout

    mesh = _mesh_of(("data", "x"), (1, 2), rank=1)
    tmesh.spatial_partition(create_model("ResNet50FCN", layers=(1, 1, 1, 1)), mesh)
    tmesh.spatial_partition(create_model("AttU_Net", filters=NARROW[:4]), mesh)
    with pytest.raises(ValueError, match="unknown arch 'Linear'"):
        tmesh.spatial_partition(torch.nn.Linear(2, 2), mesh)
    att = create_model("AttU_Net", filters=NARROW)
    att.Conv4.dropout = Dropout(0.5)
    tmesh.spatial_partition(att, mesh)
    assert att.Conv4.dropout.bands.place == ((1, 2), (0, 1))
    att.Conv4.dropout = ChannelDropout(0.5)  # a channel dropout draws per data row
    tmesh.spatial_partition(att, mesh)
    for remat in ("full", "policy"):
        m = create_model("NestedUNet", nb_filter=NARROW, remat=remat)
        tmesh.spatial_partition(m, mesh)
        assert m.conv0_0.conv2.halo == m.conv0_1.conv1.halo == (1, 0)
    m = create_model("UNetRNN", feature_scale=16, decoder="LSTM")
    tmesh.spatial_partition(m, mesh)
    assert m.score_block1[0].halo == (2, 0) and m.RDC.lstm_catconv.halo == (1, 0)
    assert m.RDC.bands is m.bands and m.RDC.bands.place == ((1, 2), (0, 1))
    assert not m.RDC._forward_pre_hooks
    m = create_model("UNet", nb_filter=NARROW)
    for _ in range(2):  # a second call (the eval step's) replaces the hooks
        tmesh.spatial_partition(m, mesh)
    hooked = {n for n, s in m.named_modules() if s._forward_pre_hooks}
    assert len(hooked) == 18 and all(len(m.get_submodule(n)._forward_pre_hooks) == 1
                                     for n in hooked)
    assert "" not in hooked and "up" not in hooked and tmesh.bands_of(m) is m.bands
    assert m.conv0_0.conv1.halo == m.conv0_4.conv1.halo == (1, 0)
    assert m.final.halo == (0, 0) and "final" not in hooked
    assert m.up.bands is m.bands and m.bands.place == ((1, 2), (0, 1))
    tmesh.spatial_partition(m, None)
    assert not any(s._forward_pre_hooks for s in m.modules())
    assert all(getattr(s, "halo", (0, 0)) == (0, 0) for s in m.modules())
    assert m.up.bands is None and tmesh.bands_of(m) is None


@pytest.mark.parametrize("arch,kw", [
    ("UNetRNNGhost", CRDN), ("UNetRNNPAttention", {**CRDN, "fast_pam": True}),
    ("UNetRNNCAttention", CRDN), ("UNetRNNAttention", CRDN), ("VGG16RNN", {}),
    ("Comprehensive_Atten_Unet", {"feature_scale": 16}),
    ("Comprehensive_Atten_Unet", {"feature_scale": 16, "is_deconv": False,
                                  "attention_dsample": (2, 2),
                                  "nonlocal_mode": "concatenation_residual"}),
    ("Comprehensive_Atten_Unet", {"feature_scale": 16, "attention_dsample": (2, 2),
                                  "nonlocal_mode": "concatenation_debug"})])
def test_spatial_partition_puts_the_whole_map_archs_on_bands(arch, kw):
    """The archs that attend, pool or resize over the whole map go on bands:
    each module that declares `bands` gets the mesh's (this rank's place;
    the BNs and the models that pool declare it too), the 5x5 score convs a
    halo of 2, the Ghost blocks' depthwise 3x3s 1, a theta of kernel =
    stride a pre-hook that gives it the window of its output rows and no
    halo, CA-Net with its dropout on (a channel dropout); None takes it all
    off again."""
    mesh = _mesh_of(("data", "x"), (1, 2), rank=1)
    m = create_model(arch, **kw)
    tmesh.spatial_partition(m, mesh)
    declared = [s for s in m.modules() if hasattr(type(s), "bands")]
    assert all(s.bands.place == ((1, 2), (0, 1)) for s in declared)
    assert any(isinstance(s, (BatchNorm, FlaxBatchNorm)) or
               type(s).__name__ == "FusedBatchNormReLU" for s in declared)
    if arch == "Comprehensive_Atten_Unet":
        assert m.conv4.dropout.p == 0.5
        theta = m.attentionblock3.gate_block_1.theta
        assert theta.halo == (0, 0) and len(theta._forward_pre_hooks) == (
            kw.get("attention_dsample", (1, 1)) == (2, 2))
    elif arch == "UNetRNNGhost":
        assert m.score_block1[0].ghost1.cheap_operation[0].halo == (1, 0)
        assert m.score_block1[0].shortcut[0].halo == (1, 0)
    else:
        assert m.score_block1[0].halo == (2, 0)
    tmesh.spatial_partition(m, None)
    assert all(s.bands is None for s in declared)
    assert not any(s._forward_pre_hooks for s in m.modules())


def test_check_spatial_needs_bands_whole_through_the_pools():
    """The JAX rule alone (x divides H, y divides W): the sizes whose bands
    did not stay whole and even through the pools are accepted now (a map
    of fewer rows than bands leaves empty bands), a size x does not divide
    is refused."""
    tmesh.check_spatial("NestedUNet", (96, 96), {"data": 2, "x": 6})
    for shape in ({"x": 4}, {"x": 2, "y": 4}):
        tmesh.check_spatial("UNet", (96, 96), shape)
    # UNetRM7's 6 pools: its levels at 96x96 go 3 -> 1, at 256x64 they halve
    tmesh.check_spatial("UNetRM7", (96, 96), {"x": 2})
    tmesh.check_spatial("UNetRM7", (256, 64), {"x": 2})
    with pytest.raises(ValueError, match="multiple of x = 5"):
        tmesh.check_spatial("UNet", (96, 96), {"x": 5})


@pytest.mark.parametrize("arch,hw,shape", [
    ("NestedUNet", (96, 96), {"data": 2, "x": 6}),
    ("UNet", (96, 96), {"x": 4}),
    ("UNet", (96, 96), {"x": 2, "y": 4}),
    ("AttU_Net", (96, 96), {"x": 2}),
    ("R2U_Net", (32, 64), {"x": 2, "y": 4}),
    ("R2AttU_Net", (48, 32), {"x": 2}),
    ("UNetRNN", (64, 64), {"x": 2}),
    ("UNetRNN", (32, 32), {"x": 2}),
    ("UNetRNN", (96, 96), {"x": 3}),
    ("UNetRNN", (48, 48), {"x": 3}),
    ("UNetRM3", (32, 32), {"x": 2}),
    ("UNetRM3", (40, 32), {"x": 4}),
    ("UNetRM3", (32, 32), {"x": 8}),
    ("UNetRM7", (256, 64), {"x": 2}),
    ("UNetRM7", (96, 96), {"x": 2}),
    ("DeepLab", (96, 96), {"x": 2}),
    ("UNetRNNPSP", (64, 32), {"x": 2}),
    ("ResNet50UNet", (96, 96), {"x": 2}),
    ("DoubleUnet", (96, 96), {"x": 2}),
    ("UNetRNNGhost", (32, 32), {"x": 2}),
    ("UNetRNNGhost", (32, 32), {"x": 4}),
    ("UNetRNNPAttention", (64, 32), {"x": 2}),
    ("UNetRNNCAttention", (64, 64), {"x": 2, "y": 2}),
    ("UNetRNNAttention", (32, 32), {"x": 2}),
    ("VGG16RNN", (64, 32), {"x": 2}),
    ("VGG16RNN", (96, 96), {"x": 3}),
    ("VGG16RNN", (32, 64), {"x": 2}),
    ("Comprehensive_Atten_Unet", (32, 32), {"x": 2}),
    ("Comprehensive_Atten_Unet", (256, 256), {"data": 2, "x": 2, "y": 2}),
    ("Comprehensive_Atten_Unet", (48, 32), {"x": 2})])
def test_check_spatial_follows_each_archs_band_rule(arch, hw, shape):
    """Every (arch, size, mesh) the per-arch band rule was tried on, the
    ones it refused among them (UNet at 96x96 under x=4, UNetRM7 at 96x96
    under x=2, DeepLab, the bands thinner than a halo), passes the JAX rule
    that `check_spatial` holds every arch to: x divides H and y divides W."""
    tmesh.check_spatial(arch, hw, shape)


def test_train_canet_preset_takes_the_x_axis():
    """`train_canet --mesh x=2` (the CA-Net preset, 256x256) passes the JAX
    rule as `train --mesh x=2 --arch Comprehensive_Atten_Unet` does, at a
    height its 4 pools split too (272: bands of 8 and 9 rows at 1/16); a
    height x does not divide exits."""
    from pytorch_nested_unet_tpu_torch import train as ptrain
    from pytorch_nested_unet_tpu_torch import train_canet
    from pytorch_nested_unet_tpu_torch.train_isic import _with_defaults

    config = ptrain.parse_args(_with_defaults(["--mesh", "x=2"], train_canet.PRESET))
    assert config["arch"] == "Comprehensive_Atten_Unet" and config["input_h"] == 256
    assert ptrain._mesh_axes(config) == (("x",), (2,))
    config = ptrain.parse_args(_with_defaults(["--mesh", "x=2", "--input_h", "272"],
                                              train_canet.PRESET))
    assert ptrain._mesh_axes(config) == (("x",), (2,))
    config = ptrain.parse_args(_with_defaults(["--mesh", "x=3", "--input_h", "272"],
                                              train_canet.PRESET))
    with pytest.raises(SystemExit, match="multiple of x = 3"):
        ptrain._mesh_axes(config)


def test_one_process_spatial_mesh_is_the_whole_image():
    """'x' = 1 in one process: one band, the whole image; the halo is zeros
    and gather_bands is the identity."""
    from pytorch_nested_unet_tpu_torch.parallel import halo

    mesh = tmesh.make_mesh((1, 1), ("data", "x"))
    assert mesh.spatial and not mesh.partitioned("x") and mesh.spatial_group is None
    band = tmesh.batch_sharding(mesh, 6, spatial=True, hw=(32, 16))
    assert band == tmesh.Band(slice(0, 6), 0, 32, 0, 16, 32, 16)
    x = torch.randn(2, 4, 4, 3)
    assert halo.gather_bands(x, mesh, (4, 4)) is x
    np.testing.assert_array_equal(_halo_exchange(x, mesh, 1, 0).numpy(),
                                  F.pad(x, (0, 0, 0, 0, 1, 1)).numpy())
    with pytest.raises(ValueError, match="not divisible by the spatial mesh axes"):
        tmesh.batch_sharding(_mesh_of(("x",), (3,)), 6, True, (32, 16))


def _halo_exchange(x, mesh, rows, cols):
    """Band x of a map cut into equal bands with `rows` of each 'x'
    neighbour's edge rows above and below, then `cols` of each 'y'
    neighbour's columns (zeros past the image's edge): `halo.fetch` of the
    band's symmetric window on each axis, what a stride-1 conv of padding
    `rows` / `cols` reads."""
    from pytorch_nested_unet_tpu_torch.parallel import halo

    for axis, dim, k in (("x", 1, rows), ("y", 2, cols)):
        if k:
            parts = mesh.shape.get(axis, 1)
            n = x.shape[dim] * parts
            c = cut(n, parts)
            x = halo.fetch(x, mesh, axis, n, [(c[i] - k, c[i + 1] + k) for i in range(parts)])
    return x


def _mesh_of(names, sizes, rank=0):
    """A Mesh's layout for `rank` of a world of prod(sizes), without ranks."""
    m = tmesh.Mesh(names, (1,) * len(names))
    m.shape = dict(zip(names, sizes))
    m.rank = rank
    m.coords = m.coords_of(rank)
    return m


def test_ranks_lie_row_major_over_the_axes_as_jax_lays_out_devices():
    """`np.asarray(devices).reshape(axis_sizes)`: rank r sits at
    np.unravel_index(r, sizes); its 'x' neighbours are the ranks of the same
    data row and 'y' band."""
    names, sizes = ("data", "x", "y"), (2, 3, 2)
    layout = np.arange(12).reshape(sizes)
    for r in range(12):
        m = _mesh_of(names, sizes, r)
        d, i, j = (int(v) for v in np.argwhere(layout == r)[0])
        assert m.coords == {"data": d, "x": i, "y": j} and m.index == d
        assert m.neighbor("x", -1) == (layout[d, i - 1, j] if i else None)
        assert m.neighbor("x", 1) == (layout[d, i + 1, j] if i < 2 else None)
        assert m.neighbor("y", 1) == (layout[d, i, j + 1] if j < 1 else None)
        band = tmesh.batch_sharding(m, 8, spatial=True, hw=(96, 64))
        assert band == tmesh.Band(slice(4 * d, 4 * d + 4), 32 * i, 32, 32 * j, 32, 96, 64)


# ------------------------------------------------------------------ the ranks' worker

def _grads_of(opt):
    """Each parameter's SGD momentum buffer after the first step: g + wd * p
    with g the step's (averaged) gradient."""
    return {n: opt.inner.state[p]["momentum_buffer"].numpy().copy()
            for n, p in opt._names.items()}


def _tables(t):
    """The module whose MODELS and CASES a helper reads: `t`, or this one
    (tests/test_torch_spatial_strided.py passes itself)."""
    return t if t is not None else sys.modules[__name__]


def _port_model(inp, name, ds, remat="none", t=None):
    """The port's `MODELS[name]` from the JAX model's weights, strict."""
    arch, kw, _ = _tables(t).MODELS[name]
    if remat != "none":
        kw = {**kw, "remat": remat}
    m = create_model(arch, 1, 3, ds, **kw)
    m.load_state_dict(inp[f"state_{name}"], strict=True)
    return m


def _record_masks(m):
    """{name: [mask, ...]} of every dropout of `m`, filled with each
    train-mode mask it draws."""
    from pytorch_nested_unet_tpu_torch.ops.layers import Dropout

    masks = {}
    for name, d in m.named_modules():
        if isinstance(d, Dropout):
            def keep(x, draw=d.keep, drawn=masks.setdefault(name, [])):
                k = draw(x)
                drawn.append(k.numpy().copy())
                return k

            d.keep = keep
    return masks


def _step_case(inp, case, mesh, t=None):
    """CASES[case]'s train step on this rank's rows of its model's batch."""
    from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn
    from pytorch_nested_unet_tpu_torch.training import optim
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step

    t = _tables(t)
    name, ds, remat = t.CASES[case][:3]
    imgs, masks = (torch.from_numpy(v) for v in inp["batches"][t.MODELS[name][2]])
    rows = tmesh.batch_sharding(mesh, BATCH)
    m = _port_model(inp, name, ds, remat, t)
    drawn = _record_masks(m)
    opt = optim.build_optimizer(m.parameters(), "SGD", 1e-2, 0.9, 1e-4)
    opt._names = dict(m.named_parameters())
    step = make_train_step(m, opt, "BCEDiceLoss", ds, "none", mesh)
    calls = {"finish": 0}
    real = bn.reference_bn_finish

    def counted(*a, **k):
        calls["finish"] += 1
        return real(*a, **k)

    bn.reference_bn_finish = counted
    try:
        with torch.backends.mkldnn.flags(enabled=False):  # see _one_process_step
            metrics = step(imgs[rows], masks[rows], torch.Generator().manual_seed(0))
    finally:
        bn.reference_bn_finish = real
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": _grads_of(opt),
            "params": {n: p.detach().numpy().copy() for n, p in m.named_parameters()},
            "stats": {n: b.numpy().copy() for n, b in m.named_buffers()},
            "finish_calls": calls["finish"], "masks": drawn}


def _worker(world, rank, port, d):
    """Every case of a world of `world` ranks on this rank; writes
    out<world>_<rank>.pt."""
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.parallel import halo, initialize_distributed, make_mesh
    from pytorch_nested_unet_tpu_torch.training.loop import make_eval_step

    torch.set_num_threads(2)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank)
    inp = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    out = {}
    halo_mesh = make_mesh((2,) if world == 2 else (2, 2), ("x",) if world == 2 else ("x", "y"))
    x = torch.from_numpy(inp["halo_x"])
    band = tmesh.batch_sharding(halo_mesh, x.shape[0], True, x.shape[1:3])
    xb = band.take(x).requires_grad_(True)
    rows, cols = 2, (1 if world == 4 else 0)
    hx = _halo_exchange(xb, halo_mesh, rows, cols)
    g = torch.from_numpy(inp["halo_g"][rank])
    (hx * g).sum().backward()
    out["halo"] = {"y": hx.detach().numpy(), "band": band,
                   "inner_y": float((hx.detach() * g).sum()),
                   "inner_x": float((xb.detach() * xb.grad).sum()), "dx": xb.grad.numpy()}
    tb = band.take(x).requires_grad_(True)
    gathered = halo.gather_bands(tb, halo_mesh, x.shape[1:3])
    (gathered * torch.from_numpy(inp["halo_ct"])).sum().backward()
    out["gather"] = {"y": gathered.detach().numpy(), "dx": tb.grad.numpy()}
    out["band_ops"] = _run_band_ops(inp, halo_mesh)

    imgs, masks = (torch.from_numpy(v) for v in inp["batches"][(HW, HW)])
    for case, (*_, (sizes, names), _, _) in CASES.items():
        if int(np.prod(sizes)) == world:
            out[case] = _step_case(inp, case, make_mesh(sizes, names))
    mesh = make_mesh(*CASES["NestedUNet_data1_x2" if world == 2 else "NestedUNet_data2_x2"][3])
    rows_ = tmesh.batch_sharding(mesh, BATCH)
    m = _port_model(inp, "NestedUNet", True)
    ev = make_eval_step(m, "BCEDiceLoss", True, mesh)
    out["eval"] = {k: v.item() for k, v in ev(imgs[rows_], masks[rows_],
                                              torch.tensor([1.0, 1.0, 1.0, 0.0])[rows_]).items()}
    out["dropout"] = _dropout_masks(mesh, BATCH, 6)
    if world == 4:
        torch.save(out, os.path.join(d, f"out{world}_{rank}.pt"))
        dist.destroy_process_group()
        return
    # a peer that never sends: rank 0's halo waits give up after TIMEOUT
    # while rank 1 lives on; the exchange stays pending, so no teardown
    halo.TIMEOUT = timedelta(seconds=2)
    if rank == 0:
        t0 = time.perf_counter()
        try:
            _halo_exchange(torch.zeros(1, 4, 4, 1), halo_mesh, 1, 0)
        except RuntimeError as e:
            out["timeout"] = {"s": time.perf_counter() - t0, "error": str(e)}
        torch.save(out, os.path.join(d, f"out{world}_{rank}.pt"))
    else:
        torch.save(out, os.path.join(d, f"out{world}_{rank}.pt"))
        t0 = time.perf_counter()
        while (not os.path.exists(os.path.join(d, f"out{world}_0.pt"))
               and time.perf_counter() - t0 < 120):
            time.sleep(0.1)
    sys.stdout.flush()
    os._exit(0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, d, script=None):
    """`script` (default this file) as `world` worker processes over Gloo:
    their outputs out<world>_<rank>.pt."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]), OMP_NUM_THREADS="2")
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, script or os.path.abspath(__file__), str(world), str(rank),
                 str(port), str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        # a hung collective must not leave live workers behind
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} of {world} failed:\n{log[-3000:]}"
    outs = []
    for r in range(world):  # loaded, then removed: a world's outputs can take GBs
        outs.append(torch.load(d / f"out{world}_{r}.pt", weights_only=False))
        os.remove(d / f"out{world}_{r}.pt")
    return outs


def _inputs(d, world):
    """The ranks' inputs, from numpy seeds; the weights from the JAX
    models' variables (the BN-fed conv biases at 0) of the models that the
    world's cases step (`_case_inputs`)."""
    rng = np.random.default_rng(world)
    x = rng.standard_normal((2, 12, 8, 3))
    inp = {"halo_x": x, "halo_ct": rng.standard_normal(x.shape), "batches": {},
           "band_ops": _band_op_inputs(rng, world)}
    nx, ny = (2, 1) if world == 2 else (2, 2)
    rows, cols = 2, (1 if world == 4 else 0)
    inp["halo_g"] = [rng.standard_normal((2, 12 // nx + 2 * rows, 8 // ny + 2 * cols, 3))
                     for _ in range(world)]
    jax_side = _case_inputs(inp, world)
    torch.save(inp, d / "in.pt")
    return inp, jax_side


def _case_inputs(inp, world, t=None):
    """Into `inp`: a batch of every model's input size (numpy seeds) and the
    weights of each model that the world's cases step, from the JAX
    models' variables (the BN-fed conv biases at 0); returns {model: JAX
    variables, case: (JAX model, its variables)}."""
    import jax

    from pytorch_nested_unet_tpu.models import create_model as jax_create_model
    from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
    from test_torch_crdn import jax_variables, zero_bn_fed_biases

    t = _tables(t)
    inp.setdefault("batches", {})
    for seed, hw in enumerate(sorted({hw for _, _, hw in t.MODELS.values()})):
        batch = np.random.default_rng(seed)
        inp["batches"][hw] = (batch.integers(0, 256, (BATCH, *hw, 3), dtype=np.uint8),
                              (batch.random((BATCH, *hw, 1)) > 0.6).astype(np.uint8) * 255)
    jax_side = {}
    for case, (name, ds, remat, (sizes, _), _, _) in t.CASES.items():
        if int(np.prod(sizes)) != world:
            continue
        arch, kw, hw = t.MODELS[name]
        if name not in jax_side:
            variables = zero_bn_fed_biases(jax_variables(jax_create_model(arch, 1, 3, ds, **kw),
                                                         (BATCH, *hw, 3), 0))
            inp[f"state_{name}"] = state_dict_from_jax(jax.device_get(variables), arch)
            jax_side[name] = variables
        jm = jax_create_model(arch, 1, 3, ds, **kw, **({} if remat == "none" else
                                                     {"remat": remat}))
        jax_side[case] = (jm, jax_side[name])
    return jax_side


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("spatial2")
    inp, jax_side = _inputs(d, 2)
    return inp, _launch(2, d), jax_side


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("spatial4")
    inp, jax_side = _inputs(d, 4)
    return inp, _launch(4, d), jax_side


def _both(outs, *keys):
    """The value every rank holds (asserted equal across ranks)."""
    vals = []
    for o in outs:
        for k in keys:
            o = o[k]
        vals.append(o)
    for v in vals[1:]:
        if isinstance(v, dict):
            assert v.keys() == vals[0].keys()
            for k in v:
                np.testing.assert_array_equal(v[k], vals[0][k], err_msg=str(keys + (k,)))
        else:
            np.testing.assert_array_equal(v, vals[0])
    return vals[0]


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_is_the_padded_band_and_its_adjoint(world, two_ranks, four_ranks):
    """Each rank's haloed band equals its window of the zero-padded full
    tensor (corners from the diagonal band at x=y=2), and the backward is
    the adjoint: sum over ranks of <halo(x), g> = <x, halo^T(g)> to 1e-6."""
    inp, outs = (two_ranks if world == 2 else four_ranks)[:2]
    x = inp["halo_x"]
    rows, cols = 2, (1 if world == 4 else 0)
    for o in outs:
        b = o["halo"]["band"]
        want = _haloed(torch.from_numpy(x), (b.h0, b.h, b.w0, b.w), rows, cols).numpy()
        np.testing.assert_array_equal(o["halo"]["y"], want)
    lhs = sum(o["halo"]["inner_y"] for o in outs)
    rhs = sum(o["halo"]["inner_x"] for o in outs)
    assert abs(lhs - rhs) <= 1e-6 * max(1.0, abs(lhs))
    # the adjoint, value by value: the halo of the padded full gradient field
    full = torch.zeros(x.shape[0], x.shape[1] + 2 * rows, x.shape[2] + 2 * cols, x.shape[3],
                       dtype=torch.float64)
    for o, g in zip(outs, inp["halo_g"]):
        b = o["halo"]["band"]
        full[:, b.h0:b.h0 + b.h + 2 * rows, b.w0:b.w0 + b.w + 2 * cols] += torch.from_numpy(g)
    for o in outs:
        b = o["halo"]["band"]
        np.testing.assert_allclose(o["halo"]["dx"], full[:, rows + b.h0:rows + b.h0 + b.h,
                                                          cols + b.w0:cols + b.w0 + b.w],
                                   atol=1e-12)


@pytest.mark.parametrize("world", [2, 4])
def test_gather_bands_forward_and_backward(world, two_ranks, four_ranks):
    inp, outs = (two_ranks if world == 2 else four_ranks)[:2]
    np.testing.assert_array_equal(_both(outs, "gather", "y"), inp["halo_x"])
    for o in outs:
        b = o["halo"]["band"]
        np.testing.assert_array_equal(o["gather"]["dx"],
                                      inp["halo_ct"][:, b.h0:b.h0 + b.h, b.w0:b.w0 + b.w])


# ------------------------------------------------------------------ band collectives

class _Reduce(torch.nn.Module):
    """x times a reduction of x over the whole map, so that the band
    collective's value and adjoint both reach x: "sum" (`Bands.sum` of the
    band sums), "max" (`global_max_pool`: ties split over every band),
    "mean" (`global_avg_pool`), "softmax" (per channel over the flattened
    map; x is then the softmax's input, not a factor)."""

    bands = None

    def __init__(self, kind):
        super().__init__()
        self.kind = kind

    def forward(self, x):
        from pytorch_nested_unet_tpu_torch.ops.pool import global_avg_pool, global_max_pool

        if self.kind == "sum":
            s = x.sum((1, 2), keepdim=True)
            return x * (s if self.bands is None else self.bands.sum(s))
        if self.kind == "max":
            return x * global_max_pool(x, self.bands)[:, None, None]
        if self.kind == "mean":
            return x * global_avg_pool(x, bands=self.bands)
        b, h, w, c = x.shape
        flat = x.permute(0, 3, 1, 2).reshape(b, c, h * w)
        att = torch.softmax(flat, -1) if self.bands is None else self.bands.softmax(flat)
        return att.reshape(b, c, h, w).permute(0, 2, 3, 1)


class _Gather(torch.nn.Module):
    """The whole map of keys from this band's (`Bands.gather`): on every
    rank the whole map, whose gradient sums every rank's reading."""

    bands = None

    def forward(self, x):
        return x if self.bands is None else self.bands.gather(x)


class _Pair(torch.nn.Module):
    """A block of two inputs on one map: `block(x, max_pool2x2(x))` (the
    grid gates' gating map and UpCat's lower level, a level down), its
    first output."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x):
        out = self.block(x, max_pool2x2(x))
        return out[0] if isinstance(out, tuple) else out


class _First(torch.nn.Module):
    """`block(x)`'s first output (the SE and channel gates return their gate
    too, which every band holds whole)."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x):
        return self.block(x)[0]


class _Dsv(torch.nn.Module):
    """CA-Net's deep-supervision head resized by `scale` (2, 4, 8)."""

    def __init__(self, c, scale):
        super().__init__()
        from pytorch_nested_unet_tpu_torch.models.canet import UnetDsv3

        self.dsv, self.scale = UnetDsv3(c), scale

    def forward(self, x):
        return self.dsv(x, (x.shape[1] * self.scale, x.shape[2] * self.scale))


def _band_op(name, moved=None):
    """BAND_OPS[name]'s module, float64, every parameter N(0, 0.25) from a
    seed (attention gammas and zero-started BN scales nonzero; a BN-fed conv
    bias 0), train mode; `moved`: a seed, every parameter then multiplied by
    1 + 1e-7 * N(0, 1) from it (a WEIGHT_READINGS reading)."""
    from pytorch_nested_unet_tpu_torch.models import canet, dual_attention, ghost

    kind, *args = BAND_OPS[name][0]
    if kind == "reduce":
        m = _Reduce(*args)
    elif kind == "gather":
        m = _Gather()
    elif kind == "pam":
        m = dual_attention.PAMModule(4, fast_rank1=args[0])
    elif kind == "cam":
        m = dual_attention.CAMModule()
    elif kind == "nonlocal":
        m = canet.NonLocalBlock2D(4, 2, mode=args[0])
    elif kind == "grid":
        m = _Pair(canet.GridAttentionBlock2D(4, 4, 3, args[0], args[1]))
    elif kind == "upcat":
        m = _Pair(canet.UpCat(4, 3, is_deconv=args[0]))
    elif kind == "channel_gate":
        m = _First(canet.ChannelGate(8))
    elif kind == "se":
        m = _First(canet.SEConvBlock(4, 3))
    elif kind == "dsv":
        m = _Dsv(4, args[0])
    elif kind == "canet":
        m = create_model("Comprehensive_Atten_Unet", 1, 3, feature_scale=16, drop_rate=0.0,
                         is_deconv=args[0], attention_dsample=args[1], nonlocal_mode=args[2])
    else:
        m = ghost.GhostBottleneck(4, 2, 3)
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    with torch.no_grad():
        for prm in m.parameters():
            prm.copy_(0.5 * torch.randn(prm.shape, generator=gen))
        for seq in m.modules():  # a BN-fed conv bias at 0, or it swamps the BN's variance
            if isinstance(seq, torch.nn.Sequential):
                for conv, bn in zip(seq, list(seq)[1:]):
                    if isinstance(bn, (BatchNorm, FlaxBatchNorm)) and conv.bias is not None:
                        conv.bias.zero_()
        if kind == "nonlocal":  # sharp attention, or its output is flat and W's BN cancels
            m.theta.weight.mul_(4)
            m.phi[0].weight.mul_(4)
        if moved is not None:
            noise = torch.Generator().manual_seed(moved)
            for prm in m.parameters():
                prm.mul_(1 + 1e-7 * torch.randn(prm.shape, generator=noise))
    m.double()
    for bn in m.modules():  # a BN keeps float32 parameters and statistics
        if isinstance(bn, (BatchNorm, FlaxBatchNorm)):
            bn.float()
    return m.train()


# The band ops of the ranks' worker: (module spec, input (H, W, C) of the
# whole map, tolerance, chaotic). float64 where the op allows it; the
# attention modules' softmaxes and every BN compute in float32 (1e-5; the
# residual grid gate's softmax over the map scales its output, and with it
# the variance of W's BN, by 1/64, so its inverse deviation amplifies
# float32 rounding: 1e-4). In the chaotic ones a ReLU follows a float32 BN,
# so a value within its rounding of 0 takes the other side on bands and
# moves gradients by up to 1e-3 (a 1e-7 change of the weights moves the
# narrow CA-Net's input gradient by up to 4e-4): their gradients are held
# to the tolerance or 4x their largest movement under WEIGHT_READINGS, as
# the chaotic archs' steps are. Inputs of "max" are on a grid of 0.5 so that
# maxima tie within and across bands.
BAND_OPS = {
    "sum": (("reduce", "sum"), (8, 8, 3), 1e-10, False),
    "max": (("reduce", "max"), (8, 8, 3), 1e-10, False),
    "mean": (("reduce", "mean"), (8, 8, 3), 1e-10, False),
    "softmax": (("reduce", "softmax"), (8, 8, 3), 1e-10, False),
    "gather": (("gather",), (8, 8, 3), 1e-12, False),
    "cam": (("cam",), (8, 8, 4), 1e-5, False),
    "pam": (("pam", False), (8, 8, 4), 1e-5, False),
    "pam_fast_rank1": (("pam", True), (8, 8, 4), 1e-5, False),
    **{f"nonlocal_{mode}": (("nonlocal", mode), (8, 8, 4), 1e-5, False)
       for mode in ("embedded_gaussian", "dot_product")},
    **{f"grid_{mode}_{sf}": (("grid", mode, (sf, sf)), (8, 8, 4),
                             1e-4 if mode == "concatenation_residual" else 1e-5, False)
       for mode in ("concatenation", "concatenation_debug", "concatenation_residual")
       for sf in (1, 2)},
    "upcat_deconv": (("upcat", True), (8, 8, 4), 1e-10, False),
    "upcat_bilinear": (("upcat", False), (8, 8, 4), 1e-6, False),
    "channel_gate": (("channel_gate",), (8, 8, 8), 1e-10, False),
    "se_block": (("se",), (8, 8, 4), 1e-5, True),
    **{f"dsv_x{s}": (("dsv", s), (8, 8, 4), 1e-6, False) for s in (2, 4, 8)},
    "ghost": (("ghost",), (8, 8, 4), 1e-5, True),
    # the whole narrow CA-Net beyond CANet_x2's defaults: UpCat's bilinear
    # branch with theta strides of 2, and the deconvs with the softplus gates
    "canet_bilinear_dsample2_residual": (("canet", False, (2, 2), "concatenation_residual"),
                                         (32, 32, 3), 1e-4, True),
    "canet_deconv_debug": (("canet", True, (1, 1), "concatenation_debug"), (32, 32, 3), 1e-4,
                           True),
}


def _band_op_inputs(rng, world):
    """{op: (x, each rank's cotangent)}: the whole map and, for an op whose
    output is the whole map on every rank ("gather"), a cotangent per rank,
    else one of the whole output for every rank to cut."""
    out = {}
    for name, (_, (h, w, c), *_) in BAND_OPS.items():
        x = rng.standard_normal((2, h, w, c))
        if name == "max":  # the maximum tied within the map and across its corner bands
            x = np.round(2 * x) / 2
            x[:, 0, 0] = x[:, -1, -1] = x[:, 0, 1] = x.max((1, 2)) + 0.5
        with torch.no_grad():
            shape = _band_op(name)(torch.from_numpy(x)).shape
        cts = [rng.standard_normal(shape) for _ in range(world if name == "gather" else 1)]
        out[name] = (x, cts)
    return out


def _run_band_ops(inp, mesh):
    """Each BAND_OPS module on this rank's band of its input (halos, BN
    moments over the world and the band collectives put on as
    `spatial_partition` puts them): its output, the gradient of its input's
    band and of its parameters under <output, cotangent> (the whole output's
    cotangent cut to this band, or this rank's own for a whole output)."""
    out = {}
    for name, (x, cts) in inp["band_ops"].items():
        m = _band_op(name)
        tmesh.put_on_bands(m, mesh)
        tmesh.sync_batch_norm(m, mesh)
        x = torch.from_numpy(x)
        band = tmesh.batch_sharding(mesh, x.shape[0], True, x.shape[1:3])
        xb = band.take(x).requires_grad_(True)
        y = m(xb)
        ct = torch.from_numpy(cts[mesh.rank] if len(cts) > 1 else cts[0])
        if len(cts) == 1:
            ho, wo = ct.shape[1] * band.h // band.full_h, ct.shape[2] * band.w // band.full_w
            ct = ct[:, band.h0 * ho // band.h:band.h0 * ho // band.h + ho,
                    band.w0 * wo // band.w:band.w0 * wo // band.w + wo]
        params = dict(m.named_parameters())
        grads = torch.autograd.grad((y * ct).sum(), [xb, *params.values()])
        out[name] = {"y": y.detach().numpy(), "dx": grads[0].numpy(),
                     "dp": {n: g.numpy() for n, g in zip(params, grads[1:])},
                     "band": (band.h0, band.h, band.w0, band.w)}
    return out


def _dropout_masks(mesh, b, c):
    """A ChannelDropout's first two train-mode masks on this rank's rows of
    a global batch of `b` (drawn over the data rows, `sync_batch_norm`)."""
    from pytorch_nested_unet_tpu_torch.ops.layers import ChannelDropout

    d = ChannelDropout(0.5, torch.Generator().manual_seed(5)).train()
    tmesh.sync_batch_norm(d, mesh)
    x = torch.ones(b // mesh.size, 4, 4, c)
    return [d.keep(x).numpy() for _ in range(2)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(BAND_OPS))
def test_band_op_matches_the_whole_map_op(name, world, two_ranks, four_ranks):
    """Each BAND_OPS module on the ranks' bands (x=2; x=2,y=2) against the
    module on the whole map in one process, in float64 where it allows:
    each rank's output is the whole output's band (the gathered keys: the
    whole map), the gradient of its input band is the whole gradient's
    band, and the ranks' parameter gradients sum to the whole one's
    (relative L2 of the larger of its own norm and its module's weight
    gradient's). The keys' gradient sums every rank's reading (each rank
    its own cotangent of the gathered map); the max splits over the tied
    maxima of every band; the grid gates in every GRID_MODES mode at theta
    strides 1 and 2 (kernel = stride: local); UpCat's 2x2 deconv (local)
    and its half-pixel bilinear branch, the heads' resizes by 2, 4 and 8
    (a halo row or column from each neighbour); the whole narrow CA-Net with
    its other options. A chaotic op's gradients (BAND_OPS) are held to its
    tolerance or 4x their movement under WEIGHT_READINGS."""
    inp, outs = (two_ranks if world == 2 else four_ranks)[:2]
    x, cts = inp["band_ops"][name]
    tol, chaotic = BAND_OPS[name][2:]

    def whole(moved=None):
        m = _band_op(name, moved)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = m(xt)
        params = dict(m.named_parameters())
        grads = torch.autograd.grad((y * torch.from_numpy(sum(cts))).sum(),
                                    [xt, *params.values()])
        return y.detach().numpy(), grads[0].numpy(), dict(zip(params, (g.numpy()
                                                                       for g in grads[1:])))

    def rel(got, want, n):  # 0 where both are 0 (a ReLU that no input opens)
        return np.linalg.norm(got[n] - want[n]) / max(
            np.linalg.norm(want[n]), np.finfo(np.float64).tiny,
            np.linalg.norm(want.get(n.rsplit(".", 1)[0] + ".weight", want[n])))

    y, dx, dp = whole()
    dx_tol, dp_tol = tol, dict.fromkeys(dp, tol)
    for seed in WEIGHT_READINGS if chaotic else ():
        _, dx_moved, dp_moved = whole(seed)
        dx_tol = max(dx_tol, 4 * float(np.abs(dx_moved - dx).max()))
        dp_tol = {n: max(t, 4 * rel(dp_moved, dp, n)) for n, t in dp_tol.items()}
    (h, w), (ho, wo) = x.shape[1:3], y.shape[1:3]
    for o in outs:
        got = o["band_ops"][name]
        h0, hb, w0, wb = got["band"]
        want = y if name == "gather" else y[:, h0 * ho // h:(h0 + hb) * ho // h,
                                            w0 * wo // w:(w0 + wb) * wo // w]
        np.testing.assert_allclose(got["y"], want, atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_allclose(got["dx"], dx[:, h0:h0 + hb, w0:w0 + wb], atol=dx_tol,
                                   rtol=tol, err_msg=name)
    summed = {n: sum(o["band_ops"][name]["dp"][n] for o in outs) for n in dp}
    for n in dp:
        assert rel(summed, dp, n) <= dp_tol[n], f"{name} {n}"


@pytest.mark.parametrize("world", [2, 4])
def test_channel_dropout_draws_per_data_row(world, two_ranks, four_ranks):
    """A ChannelDropout on the mesh (`sync_batch_norm` puts it on the data
    group): under x=2 both bands of the one data row draw the same masks,
    and under data=2,x=2 the bands of each row draw alike, each row its
    rows of the masks one process draws over the whole batch, twice in a
    row (the generator advances alike)."""
    from pytorch_nested_unet_tpu_torch.ops.layers import ChannelDropout

    outs = (two_ranks if world == 2 else four_ranks)[1]
    d = ChannelDropout(0.5, torch.Generator().manual_seed(5)).train()
    want = [d.keep(torch.ones(BATCH, 4, 4, 6)).numpy() for _ in range(2)]
    rows = BATCH // (world // 2)
    for rank, o in enumerate(outs):
        row = rank // 2  # ranks lie row-major over ('data', 'x')
        for got, w in zip(o["dropout"], want):
            np.testing.assert_array_equal(got, w[row * rows:(row + 1) * rows])
    assert any(not w.all() for w in want) and any(w.any() for w in want)


def test_two_rank_canet_dropout_step_matches_one_process(two_ranks):
    """CA-Net with dropout on (drop_rate 0.5) under x=2: conv4's, center's
    and up4's channel dropouts draw one mask per data row, so both bands
    drop the channels that the port's one-process step drops over the
    global batch; the step is held to that one-process step with the gates
    of the chaotic archs (1e-4, or 4x the one-process step's movement under
    WEIGHT_READINGS). The JAX package draws its masks from another
    generator, so CANet_x2 (dropout 0) is the case held to it."""
    inp, outs, _ = two_ranks
    case = "CANet_dropout_x2"
    masks = {}
    one = _one_process_step(inp, case, masks=masks)
    assert sorted(masks) == ["center.dropout", "conv4.dropout", "up4.dropout"]
    for name, want in masks.items():
        assert len(want) == 1 and not want[0].all()
        for o in outs:
            np.testing.assert_array_equal(o[case]["masks"][name][0], want[0], err_msg=name)
    gate = dict.fromkeys(one[1], 1e-4)
    for seed in WEIGHT_READINGS:
        moved = _one_process_step(inp, case, seed)
        gate = {n: max(g, 4 * _rel(moved[1], one[1], n)) for n, g in gate.items()}
    got = {k: _both(outs, case, k) for k in ("metrics", "grads", "params", "stats",
                                              "finish_calls")}
    _hold_step(got, *one, 0, f"{case} against the port's one-process step", gate)


def _den(grads, name):
    return max(np.linalg.norm(grads[name]),
               np.linalg.norm(grads.get(name.rsplit(".", 1)[0] + ".weight", grads[name])))


def _rel(got, want, name):
    return np.linalg.norm(got[name] - want[name]) / _den(want, name)


def _hold_step(got, loss, grads, params, stats, finish_calls, what, gate=None, floor=None):
    """loss 1e-5, running statistics 1e-5, momentum buffers 1e-4 relative
    L2 (of the larger of their own norm and their module's weight's; `gate`:
    per buffer), parameters 1e-6 (times gate / 1e-4 and that norm where it
    is above 1: lr times the buffer); BN finishes: one per BN layer.
    `floor`: (the loss's tolerance, {statistic: its atol}) in place of
    1e-5 (a step whose loss and statistics are chaotic too)."""
    loss_tol, stats_tol = floor if floor is not None else (1e-5, {})
    assert abs(got["metrics"]["loss"] - loss) <= loss_tol, what
    for name, s in got["stats"].items():
        np.testing.assert_allclose(s, stats[name], atol=stats_tol.get(name, 1e-5), rtol=1e-5,
                                   err_msg=f"{what} {name}")
    for name in got["grads"]:
        tol = 1e-4 if gate is None else gate[name]
        assert _rel(got["grads"], grads, name) <= tol, f"{what} {name}"
        np.testing.assert_allclose(got["params"][name], params[name],
                                   atol=1e-6 * tol / 1e-4 * max(1.0, _den(grads, name)),
                                   err_msg=f"{what} {name}")
    assert got["finish_calls"] == finish_calls, what


_JAX_STEPS = {}  # (model, remat, mesh): both worlds draw the same batch and weights


def _jax_step(case, jax_side, inp, mesh_shape=None, t=None):
    """The JAX package's step of CASES[case]'s model; with `mesh_shape` =
    (sizes, names), under make_mesh(sizes, names) with spatial=True on the
    first prod(sizes) of its 8 virtual CPU devices: (loss, momentum buffers,
    parameters, running statistics) in the port's names."""
    t = _tables(t)
    name, ds, remat = t.CASES[case][:3]
    key = (name, remat, mesh_shape)
    if key not in _JAX_STEPS:
        jm, variables = jax_side[case]
        _JAX_STEPS[key] = _run_jax_step(jm, t.MODELS[name][0], variables, ds,
                                        *inp["batches"][t.MODELS[name][2]], mesh_shape)
    return _JAX_STEPS[key]


def _run_jax_step(jm, arch, variables, ds, imgs, masks, mesh_shape):
    import jax
    import jax.numpy as jnp

    from pytorch_nested_unet_tpu.parallel import make_mesh, replicated_sharding
    from pytorch_nested_unet_tpu.training import TrainState, build_optimizer, make_train_step
    from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax

    tx = build_optimizer("SGD", 1e-2, 0.9, 1e-4)
    state = TrainState.create(variables, tx)
    mesh = None
    if mesh_shape is not None:
        sizes, names = mesh_shape
        mesh = make_mesh(sizes, names, devices=jax.devices()[:int(np.prod(sizes))])
    step = make_train_step(jm, tx, "BCEDiceLoss", ds, augment=False, donate=False, mesh=mesh,
                           spatial=mesh is not None)
    if mesh is not None:
        state = jax.device_put(state, replicated_sharding(mesh))
    new, metrics = step(state, jnp.asarray(imgs), jnp.asarray(masks), jax.random.PRNGKey(0))
    new = jax.device_get(new)
    sd = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats}, arch)
    trace = state_dict_from_jax({"params": new.opt_state.inner_state[1].trace,
                                 "batch_stats": new.batch_stats}, arch)
    stat = ("running_mean", "running_var")
    names = [n for n in sd if not n.endswith(stat)]
    return (float(metrics["loss"]), {n: trace[n].numpy() for n in names},
            {n: sd[n].numpy() for n in names},
            {n: v.numpy() for n, v in sd.items() if n.endswith(stat)})


# the two cases of before, under their ids of before
OLD_IDS = {"UNet_data1_x2": "UNet-False", "NestedUNet_data1_x2": "NestedUNet-True",
           "UNet_x2_y2": "UNet-False-UNet_x2_y2", "NestedUNet_data2_x2":
           "NestedUNet-True-NestedUNet_data2_x2"}
TWO_RANK_CASES = [pytest.param(c, id=OLD_IDS.get(c, c)) for c, v in CASES.items()
                  if int(np.prod(v[3][0])) == 2 and v[4] is not None]
FOUR_RANK_CASES = ["UNet_x2_y2", "NestedUNet_data2_x2"]


@pytest.mark.parametrize("case", TWO_RANK_CASES)
def test_two_rank_x2_step_matches_the_jax_spatial_step(case, two_ranks):
    """The port's step under x=2 on 2 ranks (each its band, halos, BN over
    both bands: K1's sums, bn_finish, K2 and K3 for FusedBatchNormReLU,
    all-reduces for the attention U-Nets' plain BN; the CRDN cell's carry
    resized on bands; NestedUNet wDS under --remat full and policy too)
    against the JAX package's GSPMD-partitioned step from the same weights
    (NestedUNet's under the same `nn.remat`), and against its unpartitioned
    step. The JAX spatial step itself moves some gradients off its
    unpartitioned step (UNet's by up to 2e-3 relative L2: its partitioned
    sums add in another order and the step is chaotic at init), so against
    it each buffer is held to 1e-4 or 4x that movement, whichever is more;
    against the unpartitioned step, to 1e-4."""
    _hold_to_jax(case, two_ranks)


# The seeds of the 1e-7 weight changes that read how far the port's own
# one-process step moves (chip_smoke.py's MOVEMENT_READINGS' "weights")
WEIGHT_READINGS = (12, 13, 14)


def _hold_to_jax(case, ranks, t=None, jax=True):
    """The ranks' step `case` against the JAX package's spatial step under
    the case's JAX mesh (each momentum buffer within 1e-4 or 4x the JAX
    spatial step's own movement off its unpartitioned step, whichever is
    more) and against its unpartitioned step (1e-4).

    The archs after UNet and NestedUNet are chaotic at these narrow widths
    and batches: a discrete choice (a ReLU mask, a pool's maximum) sits
    within rounding of its edge, and which side a step lands on moves some
    gradients by 1e-3 to 1e-1. A 1e-7 change of the weights moves the
    port's own one-process step of UNetRM7 at 256x64 by 1.5e-3 (seed 2;
    the port's and the JAX package's unpartitioned steps are 1.5e-3 apart
    there too), of AttU_Net by 3e-3 at the median (seed 1; its band step
    and the JAX spatial step land on the other side from both
    unpartitioned steps), of R2AttU_Net by 1e-1; the JAX spatial step of
    UNetRNN with the LSTM decoder sits 6.5e-3 off its unpartitioned one.
    So these cases are held to 1e-4 or 4x the largest of their readings,
    as chip_smoke.py holds its band runs: against the port's one-process
    step (the band path's own check) the JAX spatial step's movement and
    the port's one-process step's under WEIGHT_READINGS; against each JAX
    step those and how far the port's one-process step is from the JAX
    package's unpartitioned one.

    Two readings more where `t` asks for them: `t.ORDER_READINGS`, thread
    counts at which the port's one-process step also runs (its sums then
    add in another order, as chip_smoke.py's "order" readings reorder the
    batch), and for the cases of `t.STEP_FLOOR`, whose loss and running
    statistics are chaotic too, those held to 1e-5 or 4x their largest
    reading (`_hold_step`'s `floor`). With `jax` False, against the port's
    one-process step alone, by its readings."""
    t = _tables(t)
    inp, outs, jax_side = ranks
    mesh_shape, calls = t.CASES[case][4:]
    got = {k: _both(outs, case, k) for k in ("metrics", "grads", "params", "stats",
                                              "finish_calls")}
    gate = dict.fromkeys(got["grads"], 1e-4)
    if jax:
        spatial = _jax_step(case, jax_side, inp, mesh_shape, t)
        plain = _jax_step(case, jax_side, inp, None, t)
        gate = {n: max(1e-4, 4 * _rel(spatial[1], plain[1], n)) for n in plain[1]}
        if t.CASES[case][0] in ("UNet", "NestedUNet"):
            _hold_step(got, *spatial, calls, f"{case} against JAX's spatial step {mesh_shape}",
                       gate)
            _hold_step(got, *plain, calls, f"{case} against JAX's step")
            return
    one = _one_process_step(inp, case, t=t)
    readings = ([_one_process_step(inp, case, seed, t=t) for seed in WEIGHT_READINGS]
                + [_one_process_step(inp, case, t=t, threads=n)
                   for n in getattr(t, "ORDER_READINGS", ())])
    for moved in readings:
        gate = {n: max(g, 4 * _rel(moved[1], one[1], n)) for n, g in gate.items()}
    floor = None
    if case in getattr(t, "STEP_FLOOR", ()):
        floor = (max([1e-5] + [4 * abs(m[0] - one[0]) for m in readings]),
                 {n: max([1e-5] + [4 * float(np.abs(m[3][n] - v).max()) for m in readings])
                  for n, v in one[3].items()})
    _hold_step(got, *one, calls, f"{case} against the port's one-process step", gate, floor)
    if not jax:
        return
    gate = {n: max(g, 4 * _rel(one[1], plain[1], n)) for n, g in gate.items()}
    if floor is not None:
        floor = (max(floor[0], 4 * abs(one[0] - plain[0])),
                 {n: max(v, 4 * float(np.abs(one[3][n] - plain[3][n]).max()))
                  for n, v in floor[1].items()})
    _hold_step(got, *spatial, calls, f"{case} against JAX's spatial step {mesh_shape}", gate,
               floor)
    _hold_step(got, *plain, calls, f"{case} against JAX's step", gate, floor)


@pytest.mark.parametrize("remat", ["full", "policy"])
def test_two_rank_remat_step_is_the_band_step(remat, two_ranks):
    """NestedUNet wDS under x=2 with --remat full (the recompute's halo
    exchanges and BN all-reduces in backward) and policy (conv2's haloed
    input kept as its halo strips, its core made again) gives the band step
    without remat bit for bit on the CPU: loss, momentum buffers,
    parameters and running statistics; bn_finish twice per BN under full."""
    keys = ("metrics", "grads", "params", "stats", "finish_calls")
    got, want = ({k: _both(two_ranks[1], f"NestedUNet_{m}_x2", k) for k in keys}
                 for m in (remat, "data1"))
    assert got["metrics"]["loss"] == want["metrics"]["loss"]
    for k in ("grads", "params", "stats"):
        assert got[k].keys() == want[k].keys()
        for n in got[k]:
            np.testing.assert_array_equal(got[k][n], want[k][n], err_msg=f"{remat} {k} {n}")
    assert got["finish_calls"] == (60 if remat == "full" else 30)


_ONE_STEPS = {}  # (model, deep supervision, reading): both worlds load the same weights


def _one_process_step(inp, case, moved=None, masks=None, t=None, threads=None):
    """The port's step of CASES[case]'s model without a mesh over the global
    batch; `moved`: a seed, every weight first multiplied by 1 + 1e-7 *
    N(0, 1) from it; `masks`: a dict to fill with its dropouts' masks
    (`_record_masks`). The port's steps here, and the ranks' band steps, run
    torch's direct CPU convolution, not oneDNN's, which rounds 2-3x coarser
    (test_torch_attention_unet.py). `threads`: run on that many intra-op
    threads (another summation order)."""
    from pytorch_nested_unet_tpu_torch.training import optim
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step

    t = _tables(t)
    name, ds = t.CASES[case][:2]
    key = (name, ds, moved, threads)
    if masks is None and key in _ONE_STEPS:
        return _ONE_STEPS[key]
    m = _port_model(inp, name, ds, t=t)
    if masks is not None:
        masks.update(_record_masks(m))
    if moved is not None:
        noise = torch.Generator().manual_seed(moved)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=noise))
    opt = optim.build_optimizer(m.parameters(), "SGD", 1e-2, 0.9, 1e-4)
    opt._names = dict(m.named_parameters())
    imgs, labels = (torch.from_numpy(v) for v in inp["batches"][t.MODELS[name][2]])
    before = torch.get_num_threads()
    torch.set_num_threads(threads or before)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            metrics = make_train_step(m, opt, "BCEDiceLoss", ds, "none")(
                imgs, labels, torch.Generator().manual_seed(0))
    finally:
        torch.set_num_threads(before)
    out = (metrics["loss"].item(), _grads_of(opt),
           {n: p.detach().numpy() for n, p in m.named_parameters()},
           {n: b.numpy() for n, b in m.named_buffers()})
    if masks is None:
        _ONE_STEPS[key] = out
    return out


@pytest.mark.parametrize("case", [pytest.param(c, id=OLD_IDS[c]) for c in FOUR_RANK_CASES])
def test_four_rank_steps_match_the_one_process_step(case, four_ranks):
    """UNet under x=2,y=2 (the corners) and NestedUNet wDS under data=2,x=2
    (2 rows of 2 bands each) against the port's one-process step."""
    inp, outs = four_ranks[:2]
    got = {k: _both(outs, case, k) for k in ("metrics", "grads", "params", "stats",
                                              "finish_calls")}
    _hold_step(got, *_one_process_step(inp, case), CASES[case][5], case)


@pytest.mark.parametrize("case", [pytest.param(c, id=f"{OLD_IDS[c]}-mesh_shape{i}")
                                  for i, c in enumerate(FOUR_RANK_CASES)]
                         + ["UNetRNNAttention_x2_y2"])
def test_four_rank_steps_match_the_jax_spatial_step(case, four_ranks):
    """The same 4-rank steps against the JAX package's spatial step on 4 of
    its virtual CPU devices (its `batch_sharding` puts H on 'x' and W on
    'y'; data=2,x=2 as its tests/test_parallel.py lays out data by 'x'),
    from the same weights: the column exchange, the corners and the
    grouping of bands by data row, held as the two-rank test holds x=2;
    UNetRNNAttention under x=2,y=2 (PAM's keys gathered from a 2-D grid of
    bands into the whole map's row-major order; `_hold_to_jax` also holds
    it to the port's one-process step)."""
    _hold_to_jax(case, four_ranks)


def test_halo_wait_times_out_under_gloo(two_ranks):
    """A peer that never sends: on CPU tensors under Gloo the halo's wait
    raises after `halo.TIMEOUT` (2 s here) instead of blocking."""
    got = two_ranks[1][0]["timeout"]
    assert 1.5 <= got["s"] <= 30, got
    assert "timed out" in got["error"].lower(), got


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_eval_step_matches_one_process(world, two_ranks, four_ranks):
    """The eval step on bands (x=2; data=2,x=2 with the padded global batch
    weights 1, 1, 1, 0) scores as one process scores the whole batch."""
    from pytorch_nested_unet_tpu_torch.training.loop import make_eval_step

    inp, outs = (two_ranks if world == 2 else four_ranks)[:2]
    m = _port_model(inp, "NestedUNet", True)
    want = make_eval_step(m, "BCEDiceLoss", True)(
        *(torch.from_numpy(v) for v in inp["batches"][(HW, HW)]),
        torch.tensor([1.0, 1.0, 1.0, 0.0]))
    got = _both(outs, "eval")
    assert abs(got["loss"] - want["loss"].item()) <= 1e-6
    assert got["iou"] == pytest.approx(want["iou"].item(), abs=1e-6)
    assert got["acc"] == pytest.approx(want["acc"].item(), abs=1e-7)


def test_train_cli_mesh_x2_two_processes_matches_one_process(tmp_path):
    """`train --mesh x=2` as two processes (each the top or bottom 16 rows of
    every image) trains an epoch of the narrow UNet at 32x32 (batch 8, fp32,
    Adam, augment full): rank 0 alone writes, and its log.csv matches
    `--mesh data=1` in one process within the JAX CLI test's bounds (loss
    and val_loss 3e-3, IoU 3e-2: tests/test_train_cli_round2.py); then
    `--resume` to a second epoch adopts rank 0's last.pth on both ranks."""
    import pandas as pd

    from pytorch_nested_unet_tpu_torch import train as ptrain
    from test_torch_multihost import CAPSULE, _args, _run_two, _write_set

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _write_set(tmp_path / "inputs", seed=4)
        outs = _run_two(tmp_path, ["--mesh", "x=2", "--epochs", "1"])
        assert "mesh: {'x': 2} (spatial H/W partitioning on)" in outs[0]
        for f in CAPSULE:
            assert (tmp_path / "out0" / "run" / f).is_file()
            assert not (tmp_path / "out1" / "run" / f).exists()
        ptrain.main(_args(tmp_path, tmp_path / "one", ["--mesh", "data=1", "--epochs", "1"]))
        resumed = _run_two(tmp_path, ["--mesh", "x=2", "--epochs", "2", "--resume", "true"])
        assert all("resumed from epoch 0" in out for out in resumed)
    finally:
        torch.set_num_threads(before)
    a = pd.read_csv(tmp_path / "out0" / "run" / "log.csv")
    b = pd.read_csv(tmp_path / "one" / "run" / "log.csv")
    assert list(a["epoch"]) == [0, 1] and list(b["epoch"]) == [0]
    a = a[a["epoch"] == 0]
    for col in ("loss", "val_loss"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-3, rtol=3e-3, err_msg=col)
    for col in ("iou", "val_iou"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-2, err_msg=col)


def test_train_cli_mesh_x2_unetrnn_two_processes_matches_one_process(tmp_path):
    """`train --mesh x=2 --arch UNetRNN` as two processes (narrow, 64x64:
    its coarsest band holds 2 rows, its 5x5 score convs' halo; the GRU
    decoder's carry resized on bands) trains an epoch, and rank 0's log.csv
    matches `--mesh data=1` in one process within the JAX CLI test's bounds
    (loss and val_loss 3e-3, IoU 3e-2); `--arch UNetRNN` at 32x32 under
    x=2, whose coarsest band is thinner than its 5x5 score convs' halo, is
    accepted (the CLI's mesh check: no run)."""
    import pandas as pd

    from pytorch_nested_unet_tpu_torch import train as ptrain
    from test_torch_multihost import _args, _run_two, _write_set

    extra = ["--arch", "UNetRNN", "--arch_kwargs", '{"feature_scale": 16}', "--input_w", "64",
             "--input_h", "64", "--epochs", "1"]
    _write_set(tmp_path / "inputs", seed=5)
    outs = _run_two(tmp_path, extra + ["--mesh", "x=2"])
    assert "mesh: {'x': 2} (spatial H/W partitioning on)" in outs[0]
    ptrain.main(_args(tmp_path, tmp_path / "one", extra + ["--mesh", "data=1"]))
    thin = ptrain.parse_args(_args(tmp_path, tmp_path / "thin", extra[:4] + ["--mesh", "x=2"]))
    assert ptrain._mesh_axes(thin) == (("x",), (2,))
    a = pd.read_csv(tmp_path / "out0" / "run" / "log.csv")
    b = pd.read_csv(tmp_path / "one" / "run" / "log.csv")
    assert list(a["epoch"]) == list(b["epoch"]) == [0]
    for col in ("loss", "val_loss"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-3, rtol=3e-3, err_msg=col)
    for col in ("iou", "val_iou"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-2, err_msg=col)


def test_train_cli_mesh_x2_unetrnn_attention_two_processes_matches_one_process(tmp_path):
    """`train --mesh x=2 --arch UNetRNNAttention` as two processes (narrow,
    64x32: its 5x5 score convs' halo of 2 rows at the coarsest level; PAM's
    keys and values gathered from both bands, CAM's gram summed over them)
    trains an epoch, and rank 0's log.csv matches `--mesh data=1` in one
    process within the JAX CLI test's bounds (loss and val_loss 3e-3, IoU
    3e-2); `--arch ResNet50FCN` under x=2 is accepted (the CLI's mesh
    check: no run)."""
    import pandas as pd

    from pytorch_nested_unet_tpu_torch import train as ptrain
    from test_torch_multihost import _args, _run_two, _write_set

    extra = ["--arch", "UNetRNNAttention", "--arch_kwargs", '{"feature_scale": 16}',
             "--input_w", "32", "--input_h", "64", "--epochs", "1"]
    _write_set(tmp_path / "inputs", seed=7)
    outs = _run_two(tmp_path, extra + ["--mesh", "x=2"])
    assert "mesh: {'x': 2} (spatial H/W partitioning on)" in outs[0]
    ptrain.main(_args(tmp_path, tmp_path / "one", extra + ["--mesh", "data=1"]))
    fcn = ptrain.parse_args(_args(tmp_path, tmp_path / "fcn", ["--arch", "ResNet50FCN",
                                                               "--mesh", "x=2"]))
    assert ptrain._mesh_axes(fcn) == (("x",), (2,))
    a = pd.read_csv(tmp_path / "out0" / "run" / "log.csv")
    b = pd.read_csv(tmp_path / "one" / "run" / "log.csv")
    assert list(a["epoch"]) == list(b["epoch"]) == [0]
    for col in ("loss", "val_loss"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-3, rtol=3e-3, err_msg=col)
    for col in ("iou", "val_iou"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-2, err_msg=col)


def test_train_cli_mesh_x2_remat_policy_two_processes_matches_one_process(tmp_path):
    """`train --mesh x=2 --arch NestedUNet --remat policy` as two processes
    (narrow, 32x32, deep supervision) trains an epoch, and rank 0's log.csv
    matches `--mesh data=1 --remat policy` in one process within the JAX CLI
    test's bounds (loss and val_loss 3e-3, IoU 3e-2)."""
    import pandas as pd

    from pytorch_nested_unet_tpu_torch import train as ptrain
    from test_torch_multihost import _args, _run_two, _write_set

    extra = ["--arch", "NestedUNet", "--deep_supervision", "true", "--remat", "policy",
             "--epochs", "1"]
    _write_set(tmp_path / "inputs", seed=6)
    outs = _run_two(tmp_path, extra + ["--mesh", "x=2"])
    assert "mesh: {'x': 2} (spatial H/W partitioning on)" in outs[0]
    ptrain.main(_args(tmp_path, tmp_path / "one", extra + ["--mesh", "data=1"]))
    assert "remat: policy" in (tmp_path / "out0" / "run" / "config.yml").read_text()
    a = pd.read_csv(tmp_path / "out0" / "run" / "log.csv")
    b = pd.read_csv(tmp_path / "one" / "run" / "log.csv")
    assert list(a["epoch"]) == list(b["epoch"]) == [0]
    for col in ("loss", "val_loss"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-3, rtol=3e-3, err_msg=col)
    for col in ("iou", "val_iou"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-2, err_msg=col)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
