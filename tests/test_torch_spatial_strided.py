"""The 'x'/'y' mesh axes for the archs with strided trunks: the ResNet*RNN
and ResNet50UNet backbones, DoubleUnet and the PSP hybrids (UNetRNNPSP,
UNetRNNCAttention_PSP).

One process, no ranks: a strided conv on a band given with its halo of p
rows (cut from the zero-padded full tensor) against the band of the full
conv at every band of x = 2, 3, 4 and of 'y' splits, forward and gradient
in float64 (1e-10): 7x7/2 p3, 3x3/2 p1, 1x1/2 p0, and a valid 3x3 accepted;
the 3x3/2 max-pool on the window of its output rows (-inf past the image's
edge, an all-negative input whose maxima tie across band edges; float64,
1e-12), on even bands and on the unequal bands of a 6-row map; the resize
of a whole map of PSP's 1, 2, 3 and 6 bins onto a band's rows (float64,
1e-10); the JAX rule `check_spatial` holds these archs to at the sizes
their band rule refused, and the halos and `bands` that
`spatial_partition` puts on each built model.

Several OS processes over Gloo on 127.0.0.1 (2 intra-op threads each; this
file run as a script is the worker; tests/test_torch_spatial.py's launch,
steps and gates), one launch per world size:

- world 2 ('x' = 2) and 4 ('x' = 'y' = 2): the band adaptive average pool
  at 1, 2, 3 and 6 bins against the whole map's in float64 (1e-10), at 8
  and 12 rows (bins that overlap and cross the band edge), and the band
  3x3/2 pool (exact), forward and adjoint;
- world 2: the train step of every x=2 case of `CASES` against the JAX
  package's GSPMD step and its unpartitioned step from the same weights,
  held by `_hold_to_jax` (1e-4, or 4x the largest movement under the weight
  readings: these steps are chaotic at init), K1-K3's BN finishes counted
  (the ResNet*RNN score blocks 5, the PSP hybrids' trunk 15); the PSP
  hybrids against the port's one-process step here, against the JAX
  package's steps in the slow lane (over 100 s each with an empty JAX
  cache);
- world 4: ResNet18RNN under x=2,y=2 the same way.

`train --mesh x=2 --arch ResNet18RNN` as two processes against `--mesh
data=1` in one, the JAX CLI test's bounds (loss 3e-3, IoU 3e-2).
"""

import os
import sys

import numpy as np
import pytest
import torch

import test_torch_spatial as ts
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops.layers import TorchConv
from pytorch_nested_unet_tpu_torch.ops.pool import adaptive_avg_pool, max_pool_3x3_s2_p1
from pytorch_nested_unet_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_to_band
from pytorch_nested_unet_tpu_torch.parallel import mesh as tmesh

ONE_BLOCK = (1, 1, 1, 1)
PSP = {"feature_scale": 16}
# The models of the band steps: (arch, both packages' create_model keywords,
# the input's (H, W)). The ResNet trunks and DoubleUnet have no width
# option: full width, one block a stage. DoubleUnet halves 5 times, so its
# 64 rows leave bands of 1 row at 1/32; the PSP hybrids' coarsest band must
# hold 2 rows (UNetRNN's 5x5 score convs) and their 1/8 band 4 (the
# refinement trunk's dilation-4 convs): 64 rows.
MODELS = {"ResNet18RNN": ("ResNet18RNN", {"layers": ONE_BLOCK}, (32, 32)),
          "ResNet50RNN": ("ResNet50RNN", {"layers": ONE_BLOCK}, (32, 32)),
          "ResNet50UNet": ("ResNet50UNet", {"layers": ONE_BLOCK}, (32, 32)),
          "ResNet50UNet_bilinear": ("ResNet50UNet", {"layers": ONE_BLOCK, "is_deconv": False},
                                    (32, 32)),
          "DoubleUnet": ("DoubleUnet", {"layers": ONE_BLOCK, "iterations": 2,
                                        "weighted_sum": True}, (64, 64)),
          "UNetRNNPSP": ("UNetRNNPSP", PSP, (64, 32)),
          "UNetRNNCAttention_PSP": ("UNetRNNCAttention_PSP", PSP, (64, 32))}
X2 = ts.X2
# The band steps (tests/test_torch_spatial.py's CASES layout): (model, deep
# supervision, --remat, the port's mesh, the JAX package's mesh, BN finishes
# per step: the ResNet*RNN score blocks' 5 and the PSP hybrids' 15
# FusedBatchNormReLU; the trunks' plain BNs finish none).
CASES = {"ResNet18RNN_x2": ("ResNet18RNN", False, "none", X2, X2, 5),
         "ResNet50RNN_x2": ("ResNet50RNN", False, "none", X2, X2, 5),
         "ResNet50UNet_x2": ("ResNet50UNet", False, "none", X2, X2, 0),
         "ResNet50UNet_bilinear_x2": ("ResNet50UNet_bilinear", False, "none", X2, X2, 0),
         "DoubleUnet_x2": ("DoubleUnet", True, "none", X2, X2, 0),
         "UNetRNNPSP_x2": ("UNetRNNPSP", False, "none", X2, X2, 15),
         "UNetRNNCAttention_PSP_x2": ("UNetRNNCAttention_PSP", False, "none", X2, X2, 15),
         "ResNet18RNN_x2_y2": ("ResNet18RNN", False, "none", ((2, 2), ("x", "y")),
                               ((1, 2, 2), ("data", "x", "y")), 5)}
# The one-process step's extra readings (`ts._hold_to_jax`): on 1 intra-op
# thread, not 2 (its convs' sums then add in another order: ResNet50RNN's
# lands 3.3e-4 off the JAX package's unpartitioned step at layer3.0 on 2
# threads and 1.0e-4 on 1, where the band step and the JAX spatial step sit
# within 5e-6 of it); and the cases whose loss and running statistics are
# chaotic too, the PSP hybrids' refinement cascade at init (a 1e-7 change
# of the weights moves their loss by ~1e-4 and a running mean by ~1e-4),
# held to 1e-5 or 4x their readings.
ORDER_READINGS = (1,)
STEP_FLOOR = PSP_CASES = ["UNetRNNPSP_x2", "UNetRNNCAttention_PSP_x2"]
SPLITS = ts.SPLITS
_SELF = sys.modules[__name__]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's torch work (see
    tests/test_torch_spatial.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ one process

@pytest.mark.parametrize("nx,ny", SPLITS)
@pytest.mark.parametrize("kernel,stride,padding", [(7, 2, 3), (3, 2, 1), (1, 2, 0)])
def test_strided_conv_band_matches_the_full_conv(nx, ny, kernel, stride, padding):
    """A strided conv with d(k-1) + 1 - s <= 2p <= d(k-1) on a band with a
    halo of p and no padding on the split axes: its output is the band's
    rows of the full conv's (float64 within 1e-10, the input's and the
    weight's gradients too); a valid 3x3, strided or not, is accepted (it
    reads the window of its output rows, with no halo to leave out)."""
    torch.manual_seed(nx * 100 + ny * 10 + kernel)
    conv = TorchConv(3, 5, kernel, padding=padding, stride=stride).double()
    with torch.no_grad():
        conv.weight.normal_()
        conv.bias.normal_()
    rows, cols = tmesh.conv_halo(conv, ts._FakeMesh(nx, ny))
    assert (rows, cols) == (padding if nx > 1 else 0, padding if ny > 1 else 0)
    x = torch.randn(2, 24, 24, 3, dtype=torch.float64)
    ts._check_band_op(conv, lambda xh, band: ts._with_halo(conv, (rows, cols), xh), x, nx, ny,
                      rows, cols, 1e-10, (conv.weight, conv.bias))
    for kw in ({"stride": 2}, {}):
        assert tmesh.conv_halo(TorchConv(3, 4, 3, padding=0, **kw),
                               ts._FakeMesh(nx, ny)) == (0, 0)


class _GivenWindow:
    """The `bands` of one band of one process: its split axes, and as the
    window of its output rows the window cut from the padded full tensor
    (`ts._windowed`)."""

    def __init__(self, window, nx, ny):
        self.given, self.axes = window, (int(nx > 1), int(ny > 1))

    def split_axes(self):
        return self.axes

    def window(self, x, kernel, stride, padding, dilation, edge=0.0):
        return self.given


def _pool_window(h, w, nx, ny):
    """window(band) of the 3x3/2 pool: its output rows' input window
    (`conv_windows`) on a split axis, the whole axis elsewhere."""
    from pytorch_nested_unet_tpu_torch.parallel.bands import conv_windows

    def window(band):
        i, j = band.index
        return tuple(conv_windows(n, parts, 3, 2, 1, 1)[1][k] if parts > 1 else (0, n)
                     for n, parts, k in ((h, nx, i), (w, ny, j)))

    return window


@pytest.mark.parametrize("nx,ny", SPLITS)
def test_max_pool_3x3_s2_band_matches_the_full_pool(nx, ny):
    """The 3x3/2 pool on the window of a band's output rows (rows [2a - 1,
    2b) for output rows [a, b)), -inf past the image's edge (what
    `Bands.window` gives; zeros there would win over an all-negative map),
    is the band's rows of the full pool, and its gradient the full
    gradient's band, within 1e-12 in float64 (a row whose maxima feed
    windows of two bands adds their gradients in another order): the
    inputs are all negative on a grid of 0.5, so maxima tie within windows
    and across band edges, and the band takes the same element of a tie as
    the full pool. On even bands of 24 rows, and on a 6x6 map whose bands
    are unequal and odd (1, 2, 1, 2 rows at x = 4)."""
    rng = np.random.default_rng(nx * 10 + ny)
    for hw in (24, 6):
        x = torch.from_numpy(-(np.round(2 * np.abs(rng.standard_normal((2, hw, hw, 3)))) / 2
                               + 0.5))

        def band_op(xw, band):
            return max_pool_3x3_s2_p1(None, _GivenWindow(xw, nx, ny))

        ts._check_band_op(max_pool_3x3_s2_p1, band_op, x, nx, ny, 0, 0, 1e-12,
                          edge=float("-inf"), window=_pool_window(hw, hw, nx, ny))


@pytest.mark.parametrize("nx,ny", SPLITS)
@pytest.mark.parametrize("bins", [1, 2, 3, 6])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_of_a_whole_map_onto_a_band(nx, ny, bins, align_corners):
    """PSP's pooled map (bins x bins, whole on every band) resized onto a
    band's rows and columns of the 24x36 map with no halo
    (`resize_bilinear_to_band`) is the band of `resize_bilinear`'s whole
    resize, and the bands' gradients of the small map sum to the whole
    resize's: float64 within 1e-10 (the taps at F.interpolate's float64
    positions)."""
    gen = torch.Generator().manual_seed(bins * 10 + nx)
    x = torch.randn(2, bins, bins, 4, generator=gen, dtype=torch.float64, requires_grad=True)
    want = resize_bilinear(x, (24, 36), align_corners)
    ct = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    (want * ct).sum().backward()
    want_grad, x.grad = x.grad.clone(), None
    total = 0
    for h0, hb, w0, wb in ts._bands(24, 36, nx, ny):
        got = resize_bilinear_to_band(x, h0, hb, 24, w0, wb, 36, align_corners)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want[:, h0:h0 + hb, w0:w0 + wb].detach().numpy(), atol=1e-10)
        total = total + (got * ct[:, h0:h0 + hb, w0:w0 + wb]).sum()
    total.backward()
    np.testing.assert_allclose(x.grad.numpy(), want_grad.numpy(), atol=1e-10)


@pytest.mark.parametrize("arch,hw,shape", [
    ("ResNet50RNN", (96, 96), {"x": 2}),
    ("ResNet50RNN", (96, 96), {"x": 4}),
    ("ResNet18RNN", (32, 32), {"x": 2, "y": 2}),
    ("ResNet152RNN", (64, 48), {"data": 2, "x": 2}),
    ("ResNet50UNet", (64, 64), {"x": 4}),
    ("DoubleUnet", (96, 96), {"x": 2}),
    ("DoubleUnet", (128, 128), {"x": 2}),
    ("UNetRNNPSP", (64, 32), {"x": 2}),
    ("UNetRNNPSP", (32, 32), {"x": 2}),
    ("UNetRNNCAttention_PSP", (32, 32), {"x": 2}),
    ("UNetRNNCAttention_PSP", (96, 64), {"x": 3}),
    ("ResNet50FCN", (96, 96), {"x": 2}),
    ("DeepLab", (96, 96), {"x": 2})])
def test_check_spatial_follows_the_strided_archs_band_rules(arch, hw, shape):
    """Every (arch, size, mesh) the strided archs' band rule was tried on,
    the ones it refused among them (ResNet50RNN under x=4, DoubleUnet at
    96x96, the PSP hybrids' thin bands, ResNet50FCN, DeepLab), passes the JAX rule `check_spatial` holds every
    arch to: thin bands at 1/16 and 1/32, ResNet50FCN and DeepLab too."""
    tmesh.check_spatial(arch, hw, shape)


def test_spatial_partition_puts_the_strided_archs_on_bands():
    """The strided archs go on bands at their rule's depth: the stride-1 7x7
    stem of the ResNet*RNN trunk and DoubleUnet's and the refinement
    trunk's 7x7/2 stems a halo of 3, the blocks' 3x3/2 convs 1 and their
    1x1/2 projections none (each strided conv a pre-hook that checks its
    band divides by the stride), the refinement trunk's dilated convs 2 and
    4, and every module that declares `bands` this rank's place (the
    trunks' 3x3/2 pool, UnetUp's x2, DoubleUnet's resizes, the PSP pools and
    upsamples); None takes it all off. What the band rule refused goes on
    bands now: ResNet50RNN with `kernel_size` 5 at 32x32 (a coarsest band
    thinner than its RDC's halo of 2; the step's first call accepts it), a
    trunk with an empty stage, ResNet50FCN."""
    from pytorch_nested_unet_tpu_torch.training.loop import _Bands

    mesh = ts._mesh_of(("data", "x"), (1, 2), rank=1)
    models = {arch: create_model(arch, **kw) for arch, kw in (
        ("ResNet18RNN", {"layers": ONE_BLOCK}),
        ("ResNet50UNet", {"layers": ONE_BLOCK, "is_deconv": False}),
        ("DoubleUnet", {"layers": ONE_BLOCK}), ("UNetRNNPSP", PSP))}
    for arch, m in models.items():
        tmesh.spatial_partition(m, mesh)
        declared = [s for s in m.modules() if hasattr(type(s), "bands")]
        assert declared and all(s.bands.place == ((1, 2), (0, 1)) for s in declared), arch
    r18, r50u, dbl, psp = models.values()
    trunk = psp.psp.feats
    for conv, halo in ((r18.conv1, 3), (r18.layer2[0].conv1, 1), (dbl.fe_conv1, 3),
                       (dbl.bu1_block0.conv1, 1), (trunk.conv1, 3), (trunk.layer2[0].conv2, 1),
                       (trunk.layer3[1].conv2, 2), (trunk.layer4[1].conv2, 4),
                       (psp.score_block1[0], 2)):
        assert conv.halo == (halo, 0)
    for conv in (r18.layer2[0].conv1, r18.layer2[0].downsample[0], dbl.fe_conv1,
                 dbl.bu1_block0.downsample_conv, trunk.layer2[0].downsample[0]):
        assert len(conv._forward_pre_hooks) == 1
    assert r18.layer2[0].downsample[0].halo == (0, 0)
    assert r50u.up_concat1.bands is r50u.bands and psp.psp.psp.stages[3][0].bands is not None
    for m in models.values():
        tmesh.spatial_partition(m, None)
        assert not any(s._forward_pre_hooks for s in m.modules())
        assert all(getattr(s, "bands", None) is None for s in m.modules())
    wide = create_model("ResNet50RNN", layers=ONE_BLOCK, kernel_size=5)
    tmesh.spatial_partition(wide, mesh)
    assert wide.RDC.lstm_catconv.halo == (2, 0)
    images = torch.arange(4 * 32 * 32 * 3, dtype=torch.float32).reshape(4, 32, 32, 3)
    np.testing.assert_array_equal(_Bands(mesh, wide)(4, images).numpy(), images[:, 16:].numpy())
    tmesh.spatial_partition(create_model("ResNet18RNN", layers=(1, 0, 1, 1)), mesh)
    fcn = create_model("ResNet50FCN", layers=ONE_BLOCK)
    tmesh.spatial_partition(fcn, mesh)
    assert fcn.classifier[0].halo == (0, 0) and len(fcn.classifier[0]._forward_pre_hooks) == 1


# ------------------------------------------------------------------ the ranks

class _Pyramid(torch.nn.Module):
    """PSP's adaptive average pools at 1, 2, 3 and 6 bins, each flattened,
    concatenated: (B, 50, C), the whole map's on every band."""

    bands = None

    def forward(self, x):
        return torch.cat([adaptive_avg_pool(x, (s, s), self.bands).flatten(1, 2)
                          for s in (1, 2, 3, 6)], 1)


class _StemPool(torch.nn.Module):
    """The 3x3/2 pool of the ResNet stems."""

    bands = None

    def forward(self, x):
        return max_pool_3x3_s2_p1(x, self.bands)


# The pools of the ranks' worker: (module, the whole map's (H, W, C)). At 8
# rows the 6 bins span 2 rows each and overlap; at 12 the band edge at 6
# cuts bins of 3. The 3x3/2 pool's input is all negative on a grid of 0.5.
POOLS = {"adaptive_8": (_Pyramid, (8, 8, 3)), "adaptive_12": (_Pyramid, (12, 12, 3)),
         "max_pool": (_StemPool, (8, 8, 3))}


def _pool_inputs(rng, world):
    """{pool: (x, cotangents)}: the whole map in float64 and, for the
    pyramid (the whole output on every rank), a cotangent per rank, else one
    of the whole output for every rank to cut."""
    out = {}
    for name, (module, (h, w, c)) in POOLS.items():
        x = rng.standard_normal((2, h, w, c))
        if module is _StemPool:
            x = -(np.round(2 * np.abs(x)) / 2 + 0.5)
        with torch.no_grad():
            shape = module()(torch.from_numpy(x)).shape
        out[name] = (x, [rng.standard_normal(shape)
                         for _ in range(world if module is _Pyramid else 1)])
    return out


def _run_pools(inp, mesh):
    """Each POOLS module on this rank's band of its input (`put_on_bands`):
    its output and the gradient of its band under <output, cotangent>."""
    out = {}
    for name, (x, cts) in inp["pools"].items():
        m = POOLS[name][0]()
        tmesh.put_on_bands(m, mesh)
        x = torch.from_numpy(x)
        band = tmesh.batch_sharding(mesh, x.shape[0], True, x.shape[1:3])
        xb = band.take(x).requires_grad_(True)
        y = m(xb)
        if len(cts) > 1:
            ct = torch.from_numpy(cts[mesh.rank])
        else:
            ct = torch.from_numpy(cts[0])[:, band.h0 // 2:(band.h0 + band.h) // 2,
                                          band.w0 // 2:(band.w0 + band.w) // 2]
        (dx,) = torch.autograd.grad((y * ct).sum(), [xb])
        out[name] = {"y": y.detach().numpy(), "dx": dx.numpy(),
                     "band": (band.h0, band.h, band.w0, band.w)}
    return out


def _worker(world, rank, port, d):
    """The pools and every case of a world of `world` ranks on this rank;
    writes out<world>_<rank>.pt."""
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(2)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank)
    inp = torch.load(os.path.join(d, "in.pt"), weights_only=False, mmap=True)
    pools = make_mesh((2,), ("x",)) if world == 2 else make_mesh((2, 2), ("x", "y"))
    out = {"pools": _run_pools(inp, pools)}
    for case, (*_, (sizes, names), _, _) in CASES.items():
        if int(np.prod(sizes)) == world:
            got = ts._step_case(inp, case, make_mesh(sizes, names), _SELF)
            out[case] = {"metrics": got["metrics"], "agree": _agree_with_rank0(got),
                         "finish_calls": got["finish_calls"]}
            if rank == 0:
                torch.save(got, os.path.join(d, f"{case}.pt"))
            del got
    torch.save(out, os.path.join(d, f"out{world}_{rank}.pt"))
    dist.destroy_process_group()


def _agree_with_rank0(got):
    """Whether this rank's momentum buffers, parameters and running
    statistics after the step are rank 0's bit for bit (each broadcast from
    rank 0): rank 0 alone then writes them, a file a case (<case>.pt, read
    by the case's test and removed), whose arrays (the PSP hybrids' 67.7M
    parameters twice) would otherwise be written, and held in the test
    process, once a rank."""
    import torch.distributed as dist

    agree = True
    for key in ("grads", "params", "stats"):
        for name in sorted(got[key]):
            mine = torch.from_numpy(np.ascontiguousarray(got[key][name]))
            theirs = mine.clone()
            dist.broadcast(theirs, src=0)
            agree = agree and torch.equal(mine, theirs)
    return agree


def _inputs(d, world):
    """The ranks' inputs from numpy seeds, the weights from the JAX models'
    variables (`ts._case_inputs`)."""
    inp = {"pools": _pool_inputs(np.random.default_rng(world), world)}
    jax_side = ts._case_inputs(inp, world, _SELF)
    torch.save(inp, d / "in.pt")
    return inp, jax_side


def _ranks(tmp_path_factory, world):
    """The world's launch: (inputs, each rank's summary, the JAX side, the
    folder of rank 0's <case>.pt); the folder emptied at teardown."""
    d = tmp_path_factory.mktemp(f"strided{world}")
    inp, jax_side = _inputs(d, world)
    outs = ts._launch(world, d, os.path.abspath(__file__))
    os.remove(d / "in.pt")
    yield inp, outs, jax_side, d
    for f in d.glob("*.pt"):
        f.unlink()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    yield from _ranks(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    yield from _ranks(tmp_path_factory, 4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(POOLS))
def test_band_pool_matches_the_whole_map_pool(name, world, two_ranks, four_ranks):
    """The adaptive average pools at 1, 2, 3 and 6 bins on the ranks' bands
    (x=2; x=2,y=2): every rank holds the whole map's pool, each band's
    share of every bin summed over the bands (bins that overlap at 8 rows,
    a band edge inside a bin at 12), and the gradient of its band is the
    whole gradient's band under the sum of the ranks' cotangents (the
    all-reduce adjoint); the 3x3/2 pool's output is the whole pool's band
    (-inf past the image's edge, ties across the band edges), its gradient
    the whole gradient's band. float64 within 1e-10."""
    inp, outs = (two_ranks if world == 2 else four_ranks)[:2]
    x, cts = inp["pools"][name]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = POOLS[name][0]()(xt)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(sum(cts))).sum(), [xt])
    for o in outs:
        got = o["pools"][name]
        h0, hb, w0, wb = got["band"]
        want = y if len(cts) > 1 else y[:, h0 // 2:(h0 + hb) // 2, w0 // 2:(w0 + wb) // 2]
        np.testing.assert_allclose(got["y"], want.detach().numpy(), atol=1e-10, rtol=1e-10,
                                   err_msg=name)
        np.testing.assert_allclose(got["dx"], dx[:, h0:h0 + hb, w0:w0 + wb].numpy(),
                                   atol=1e-10, rtol=1e-10, err_msg=name)


def _hold_to_jax(case, ranks, jax=True, last=True):
    """Every rank's step bitwise rank 0's (`_agree_with_rank0`) and its loss
    and BN finishes the same, then rank 0's (read from <case>.pt, removed
    after the case's `last` test, else at the fixture's teardown) held by
    `ts._hold_to_jax` (`jax` False: against the port's one-process step
    alone); the case's cached steps are dropped after (the PSP hybrids'
    67.7M-parameter steps would otherwise pile up in the test process)."""
    inp, outs, jax_side, d = ranks
    for o in outs:
        assert o[case]["agree"], f"{case}: a rank's step differs from rank 0's"
        assert o[case]["metrics"] == outs[0][case]["metrics"]
        assert o[case]["finish_calls"] == outs[0][case]["finish_calls"]
    got = torch.load(d / f"{case}.pt", weights_only=False)
    if last:
        os.remove(d / f"{case}.pt")
    try:
        ts._hold_to_jax(case, (inp, [{case: got}], jax_side), _SELF, jax)
    finally:
        name = CASES[case][0]
        for cache in (ts._ONE_STEPS, ts._JAX_STEPS):
            for key in [k for k in cache if k[0] == name]:
                del cache[key]


X2_CASES = [c for c, v in CASES.items() if int(np.prod(v[3][0])) == 2]


@pytest.mark.parametrize("case", [c for c in X2_CASES if c not in PSP_CASES])
def test_two_rank_x2_step_matches_the_jax_spatial_step(case, two_ranks):
    """The port's step under x=2 on 2 ranks (each its band; the strided
    convs, the 3x3/2 pool and the resizes on bands; BN over both bands:
    K1's sums, bn_finish, K2 and K3 for the score blocks, all-reduces for
    the trunks' plain BN) against the JAX package's GSPMD-partitioned step
    from the same weights and its unpartitioned step, held by
    `_hold_to_jax`: the steps are chaotic at init, so each momentum buffer
    within 1e-4 or 4x the largest movement under the weight readings, the
    port's one-process step among the yardsticks."""
    _hold_to_jax(case, two_ranks)


@pytest.mark.parametrize("case", PSP_CASES)
def test_two_rank_psp_step_matches_the_one_process_step(case, two_ranks):
    """The PSP hybrids' step under x=2 on 2 ranks (the UNetRNN trunk's BNs
    through K1's sums, bn_finish, K2 and K3; the refinement net's 7x7/2
    stem, 3x3/2 pool, strided and dilated convs, adaptive pools summed over
    the bands and resizes on bands) against the port's one-process step,
    its gradients, loss and running statistics within 1e-4 / 1e-5 or 4x
    their readings (`STEP_FLOOR`). Against the JAX package's steps: the
    slow lane (`test_two_rank_psp_step_matches_the_jax_spatial_step`)."""
    _hold_to_jax(case, two_ranks, jax=False, last=False)


@pytest.mark.slow
@pytest.mark.parametrize("case", PSP_CASES)
def test_two_rank_psp_step_matches_the_jax_spatial_step(case, two_ranks):
    """The same PSP steps against the JAX package's GSPMD step and its
    unpartitioned step as `test_two_rank_x2_step_matches_the_jax_spatial_step`
    holds the others: slow, each over 100 s with an empty JAX cache (its
    two JAX steps of the 67.7M-parameter cascade compile for ~30 s more)."""
    _hold_to_jax(case, two_ranks)


def test_four_rank_resnet18rnn_step_matches_the_jax_spatial_step(four_ranks):
    """ResNet18RNN under x=2,y=2 (the strided convs' and the pool's column
    halos, the corners from the diagonal band) against the JAX package's
    spatial step on 4 of its virtual CPU devices, held as the two-rank
    steps are."""
    _hold_to_jax("ResNet18RNN_x2_y2", four_ranks)


def test_train_cli_mesh_x2_resnet18rnn_two_processes_matches_one_process(tmp_path):
    """`train --mesh x=2 --arch ResNet18RNN` as two processes (one block a
    stage, 32x32: its coarsest band holds 1 row, the halo of its 3x3 score
    convs and RDC) trains an epoch, and rank 0's log.csv matches `--mesh
    data=1` in one process within the JAX CLI test's bounds (loss and
    val_loss 3e-3, IoU 3e-2)."""
    import pandas as pd

    from pytorch_nested_unet_tpu_torch import train as ptrain
    from test_torch_multihost import _args, _run_two, _write_set

    extra = ["--arch", "ResNet18RNN", "--arch_kwargs", '{"layers": [1, 1, 1, 1]}',
             "--epochs", "1"]
    _write_set(tmp_path / "inputs", seed=8)
    outs = _run_two(tmp_path, extra + ["--mesh", "x=2"])
    assert "mesh: {'x': 2} (spatial H/W partitioning on)" in outs[0]
    ptrain.main(_args(tmp_path, tmp_path / "one", extra + ["--mesh", "data=1"]))
    a = pd.read_csv(tmp_path / "out0" / "run" / "log.csv")
    b = pd.read_csv(tmp_path / "one" / "run" / "log.csv")
    assert list(a["epoch"]) == list(b["epoch"]) == [0]
    for col in ("loss", "val_loss"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-3, rtol=3e-3, err_msg=col)
    for col in ("iou", "val_iou"):
        np.testing.assert_allclose(a[col], b[col], atol=3e-2, err_msg=col)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
