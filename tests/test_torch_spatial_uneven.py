"""The 'x' mesh axis on uneven and thin bands: the row fetch and every op
that maps a band, over maps whose rows the bands do not divide evenly.

A map of n rows is cut into rows [floor(i*n/X), floor((i+1)*n/X)) for band i
of X (`parallel.halo.cut`), so bands may be unequal, or empty where n < X.

One process, no ranks: K1-K3's plain versions on a band of zero rows (zero
sums, an empty dx) and on unequal bands (the bands' sums add to the whole
map's, K3 divides by the whole map's rows); `conv_windows`, the windows of
each band's output rows; `check_spatial` over the registry's 25 archs (the
JAX rule alone).

Several OS processes over Gloo on 127.0.0.1 (this file run as a script is
the worker; tests/test_torch_spatial.py's launch), one launch per world of
X = 2, 3 and 4 ranks: each op of `OPS` on the ranks' bands of a map of
7, 6, 5 or 3 rows (unequal bands at every X, empty ones at X = 4 on 3 rows),
against the op on the whole map in one process, float64 where the op allows
(1e-10): each rank's output is the whole output's band under its cut (or
the whole output, for what every band holds whole), the gradient of its
input band is the whole gradient's band, and the ranks' parameter gradients
sum to the whole one's. The convs take windows wider than a band (a
dilation of 4, a 7x7/2 stem on 9 rows), a valid 3x3 and strided ones
windows that are asymmetric; the resizes run at non-integer ratios (bilinear
with and without aligned corners, nearest up and down); a BN's count is the
whole map's (its running variance's n / (n - 1) shows it) and K1-K3 run on
every band, an empty one's included (their plain versions on the CPU); an
element-wise dropout's masks are the one-process masks cut to the band.
A forward inside `Bands.step` reads its maps' whole sizes back from the
first forward of its kind; size calls out of step over the bands raise on
every rank.
"""

import os
import sys

import numpy as np
import pytest
import torch

import test_torch_spatial as ts
from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn
from pytorch_nested_unet_tpu_torch.ops.layers import (BatchNorm, Dropout, TorchConv,
                                                      TorchConvTranspose)
from pytorch_nested_unet_tpu_torch.ops.pool import (adaptive_avg_pool, global_avg_pool,
                                                    global_max_pool, max_pool2x2,
                                                    max_pool_3x3_s2_p1)
from pytorch_nested_unet_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from pytorch_nested_unet_tpu_torch.parallel import mesh as tmesh
from pytorch_nested_unet_tpu_torch.parallel.bands import conv_windows
from pytorch_nested_unet_tpu_torch.parallel.halo import cut

WORLDS = (2, 3, 4)


class _Op(torch.nn.Module):
    """A band op of `kind` over a map: `fn(x, bands)`."""

    bands = None

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x, self.bands)


def _resize(out_h, kind, align_corners=False):
    """The band op resizing an (h, 4) map to (out_h, 4): on bands the
    target's size is given as this band's share, as the models give it."""
    def fn(x, bands):
        h = out_h
        if bands is not None:  # a share whose sum over the bands is out_h
            i, parts = bands.place[0]
            h = cut(out_h, parts)[i + 1] - cut(out_h, parts)[i]
        if kind == "nearest":
            return resize_nearest(x, (h, x.shape[2]), bands)
        return resize_bilinear(x, (h, x.shape[2]), align_corners, bands)

    return fn


def _gather(x, bands):
    return x if bands is None else bands.gather(x)


def _pad_to(out_h):
    def fn(x, bands):
        if bands is None:
            idx = torch.minimum(torch.arange(out_h), torch.tensor(x.shape[1] - 1))
            return x.index_select(1, idx)
        i, parts = bands.place[0]
        return bands.pad_replicate(x, (cut(out_h, parts)[i + 1] - cut(out_h, parts)[i],
                                       x.shape[2]))

    return fn


def _conv(*args, **kw):
    def make():
        torch.manual_seed(3)
        m = TorchConv(*args, **kw).double()
        with torch.no_grad():
            m.weight.normal_()
            m.bias.normal_()
        return m

    return make


def _deconv():
    torch.manual_seed(4)
    m = TorchConvTranspose(3, 2, 2, 2).double()
    with torch.no_grad():
        m.weight.normal_()
        m.bias.normal_()
    return m


# {name: (module factory, the whole map's (H, W, C), tolerance, whole on
# every band)}: maps of 7, 6, 5 and 3 rows, unequal over 2, 3 and 4 bands
# (3 rows leave an empty band at 4). The indexing ops' outputs are exact; a
# gradient row that sums reads of several bands adds them in another order
# (1e-12).
OPS = {
    "conv3x3": (_conv(3, 4, 3, 1), (7, 4, 3), 1e-10, False),
    "conv_dilated4": (_conv(3, 4, 3, 4, dilation=4), (6, 4, 3), 1e-10, False),
    "conv_dilated_thin": (_conv(3, 4, 3, 2, dilation=2), (3, 4, 3), 1e-10, False),
    "conv_strided": (_conv(3, 4, 3, 1, stride=2), (7, 4, 3), 1e-10, False),
    "conv_7x7_s2": (_conv(3, 4, 7, 3, stride=2), (9, 6, 3), 1e-10, False),
    "conv_1x1_s2": (_conv(3, 4, 1, 0, stride=2), (7, 4, 3), 1e-10, False),
    "conv_valid": (_conv(3, 4, 3, 0), (7, 4, 3), 1e-10, False),
    "conv_valid_thin": (_conv(3, 4, 3, 0), (3, 4, 3), 1e-10, False),
    "deconv": (_deconv, (5, 4, 3), 1e-10, False),
    "pool2x2": (lambda: _Op(max_pool2x2), (7, 4, 3), 1e-12, False),
    "pool3x3s2": (lambda: _Op(max_pool_3x3_s2_p1), (7, 4, 3), 1e-12, False),
    "bilinear_ac_up": (lambda: _Op(_resize(12, "bilinear", True)), (5, 4, 3), 1e-10, False),
    "bilinear_ac_from_thin": (lambda: _Op(_resize(6, "bilinear", True)), (3, 4, 3), 1e-10,
                              False),
    "bilinear_hp_down": (lambda: _Op(_resize(3, "bilinear")), (7, 4, 3), 1e-10, False),
    "nearest_up": (lambda: _Op(_resize(11, "nearest")), (3, 4, 3), 1e-12, False),
    "nearest_down": (lambda: _Op(_resize(4, "nearest")), (6, 4, 3), 1e-12, False),
    "pad_replicate": (lambda: _Op(_pad_to(7)), (5, 4, 3), 1e-12, False),
    "global_avg": (lambda: _Op(lambda x, b: global_avg_pool(x, bands=b)), (3, 4, 3), 1e-12,
                   True),
    "global_max": (lambda: _Op(global_max_pool), (3, 4, 3), 1e-12, True),
    "adaptive_3": (lambda: _Op(lambda x, b: adaptive_avg_pool(x, (3, 3), b)), (5, 4, 3),
                   1e-12, True),
    "gather": (lambda: _Op(_gather), (3, 4, 3), 1e-12, True),
}


def _whole_out(name, x):
    m = OPS[name][0]()
    xt = torch.from_numpy(x).requires_grad_(True)
    return m, xt, m(xt)


def _inputs(world):
    """{op: (x, cotangents)} from a numpy seed: the whole map, and the
    whole output's cotangent (one per rank for a whole output); the BN, the
    fused BN and the dropout on 3 rows."""
    rng = np.random.default_rng(world)
    out = {}
    for name, (_, (h, w, c), _, whole) in OPS.items():
        x = rng.standard_normal((2, h, w, c))
        if name == "pool3x3s2":
            x = -(np.round(2 * np.abs(x)) / 2 + 0.5)
        with torch.no_grad():
            shape = _whole_out(name, x)[2].shape
        out[name] = (x, [rng.standard_normal(shape) for _ in range(world if whole else 1)])
    out["bn"] = (rng.standard_normal((2, 3, 4, 5)), [rng.standard_normal((2, 3, 4, 5))])
    out["dropout"] = rng.standard_normal((2, 5, 4, 3))
    return out


def _band_of(t, mesh, n=None):
    """This rank's rows of (B, n, ...) t under the cut over 'x'."""
    i, parts = mesh.band_of("x")
    c = cut(t.shape[1] if n is None else n, parts)
    return t[:, c[i]:c[i + 1]]


def _run_ops(inp, mesh):
    """Each op on this rank's band: its output, its input band's gradient
    and its parameters' gradients under <output, cotangent>."""
    out = {}
    for name, (x, cts) in inp.items():
        if name not in OPS:
            continue
        m = OPS[name][0]()
        tmesh.put_on_bands(m, mesh)
        xb = _band_of(torch.from_numpy(x), mesh).contiguous().requires_grad_(True)
        y = m(xb)
        ct = torch.from_numpy(cts[mesh.rank] if len(cts) > 1 else cts[0])
        if len(cts) == 1:
            ct = _band_of(ct, mesh)
        params = dict(m.named_parameters())
        grads = torch.autograd.grad((y * ct).sum(), [xb, *params.values()])
        out[name] = {"y": y.detach().numpy(), "dx": grads[0].numpy(),
                     "dp": {n: g.numpy() for n, g in zip(params, grads[1:])}}
    return out


def _run_bns(inp, mesh):
    """BatchNorm (plain, two-pass) and FusedBatchNormReLU (K1 sums-only,
    bn_finish, K2, K3: their plain versions) in train mode on this rank's
    band of a 3-row map, their BN on the world: output, input gradient,
    parameter gradients, running statistics, and the kernels' launches of
    a CPU run (none) against the finishes (one)."""
    x, (ct,) = inp["bn"]
    out = {}
    for kind in ("plain", "fused"):
        m = (BatchNorm(5) if kind == "plain" else bn.FusedBatchNormReLU(5)).train()
        tmesh.put_on_bands(m, mesh)
        tmesh.sync_batch_norm(m, mesh)
        xb = _band_of(torch.from_numpy(x).float(), mesh).contiguous().requires_grad_(True)
        y = m(xb)
        g = torch.autograd.grad((y * _band_of(torch.from_numpy(ct).float(), mesh)).sum(),
                                [xb, m.weight, m.bias])
        out[kind] = {"y": y.detach().numpy(), "dx": g[0].numpy(), "dw": g[1].numpy(),
                     "db": g[2].numpy(), "stats": (m.running_mean.numpy().copy(),
                                                   m.running_var.numpy().copy())}
    return out


def _run_dropout(inp, mesh):
    """An element-wise dropout's first two masks on this rank's band."""
    d = Dropout(0.5, torch.Generator().manual_seed(5)).train()
    tmesh.put_on_bands(d, mesh)
    tmesh.sync_batch_norm(d, mesh)
    xb = _band_of(torch.from_numpy(inp["dropout"]), mesh).contiguous()
    return [d.keep(xb).numpy() for _ in range(2)]


def _run_sizes(inp, mesh):
    """The size calls of a 3x3 conv's two forwards on this rank's band of a
    7-row map, each inside `Bands.step` (the second answered with no
    all-gather), of a forward outside one, and of calls out of step (this
    rank's call numbered by its rank): what each raised, if anything."""
    from pytorch_nested_unet_tpu_torch.parallel.bands import Bands

    m = OPS["conv3x3"][0]()
    tmesh.put_on_bands(m, mesh)
    bands, asked = tmesh.bands_of(m), []
    ask = bands._all_sizes
    bands._all_sizes = lambda *a: asked.append(a[0]) or ask(*a)
    x, _ = inp["conv3x3"]
    xb = _band_of(torch.from_numpy(x), mesh)
    ys = []
    for _ in range(2):
        with bands.step(x.shape[1:3], True):
            ys.append(m(xb).detach())
        asked.append("forward")
    ys.append(m(xb).detach())
    strayed = Bands(mesh)
    strayed._calls = mesh.rank
    try:
        strayed.whole(xb.shape[1:3])
        error = None
    except RuntimeError as e:
        error = str(e)
    return {"asked": asked, "same": all(torch.equal(y, ys[0]) for y in ys), "error": error}


def _worker(world, rank, port, d):
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank)
    inp = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    mesh = make_mesh((world,), ("x",))
    out = {"ops": _run_ops(inp, mesh), "bn": _run_bns(inp, mesh),
           "dropout": _run_dropout(inp, mesh), "sizes": _run_sizes(inp, mesh)}
    torch.save(out, os.path.join(d, f"out{world}_{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: (inputs, each rank's outputs)} of one launch per world."""
    got = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"uneven{world}")
        inp = _inputs(world)
        torch.save(inp, d / "in.pt")
        got[world] = (inp, ts._launch(world, d, os.path.abspath(__file__)))
    return got


# ------------------------------------------------------------------ one process

@pytest.mark.parametrize("rows", [(0, 0, 7), (0, 3, 7), (0, 1, 3, 4, 6), (0, 0, 0, 1, 2)])
def test_bn_kernels_plain_versions_on_zero_and_unequal_rows(rows):
    """K1 (sums-only), K2 and K3's plain versions, as the CPU band steps run
    them, on each band of a (rows, C) map cut at `rows`: a zero-row band's
    sums are zeros and its dx empty; the bands' sums add to the whole
    map's (float64 inputs, summed in float32: 1e-5), and K3 with n the whole
    map's rows gives each band its rows of the whole map's dx."""
    rng = np.random.default_rng(len(rows))
    n = rows[-1]
    x = torch.from_numpy(rng.standard_normal((n, 6)) * 1.5 + 0.3).float()
    dy = torch.from_numpy(rng.standard_normal((n, 6))).float()
    gamma, beta = torch.rand(6) + 0.5, torch.rand(6) - 0.5
    _, _, mean, _, inv = bn.reference_bn_stats(x)
    total, red = torch.zeros(2, 6), torch.zeros(2, 6)
    for lo, hi in zip(rows, rows[1:]):
        sums = bn.bn_sums(x[lo:hi])
        part = bn.bn_bwd_reduce_sums(x[lo:hi], dy[lo:hi], mean, inv, gamma, beta)
        if hi == lo:
            assert sums.shape == part.shape == (2, 6) and not sums.any() and not part.any()
        total, red = total + sums, red + part
    np.testing.assert_allclose(total.numpy(), torch.stack(bn.reference_bn_sums(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        red.numpy(), torch.stack(bn.reference_bn_bwd_reduce(x, dy, mean, inv, gamma, beta)
                                 ).numpy(), rtol=1e-5, atol=1e-5)
    whole = bn.bn_bwd_dx(x, dy, mean, inv, gamma, beta, red[0], red[1], n)
    for lo, hi in zip(rows, rows[1:]):
        dx = bn.bn_bwd_dx(x[lo:hi], dy[lo:hi], mean, inv, gamma, beta, red[0], red[1], n)
        assert dx.shape == (hi - lo, 6)
        np.testing.assert_allclose(dx.numpy(), whole[lo:hi].numpy(), rtol=1e-6, atol=1e-6)


def test_check_spatial_takes_every_arch_under_the_jax_rule():
    """`check_spatial` holds every arch of the registry to the JAX CLI's rule
    alone (train.py:299-302): x divides H and y divides W, whatever the maps'
    rows at depth (bands there unequal or empty); a size x or y does not
    divide is refused, as is a name the registry does not hold."""
    from pytorch_nested_unet_tpu_torch.models import arch_names

    assert len(arch_names()) == 25
    for arch in arch_names():
        for hw, shape in (((96, 96), {"x": 4}), ((96, 96), {"x": 2}), ((96, 64), {"x": 3}),
                          ((32, 48), {"data": 2, "x": 2, "y": 3}), ((64, 64), {"y": 4}),
                          ((96, 96), {"x": 2, "model": 2})):
            tmesh.check_spatial(arch, hw, shape)
        for hw, shape in (((96, 96), {"x": 5}), ((96, 97), {"x": 2, "y": 2})):
            with pytest.raises(ValueError, match="not divisible by the spatial mesh axes"):
                tmesh.check_spatial(arch, hw, shape)
    with pytest.raises(ValueError, match="unknown arch"):
        tmesh.check_spatial("UNet3D", (96, 96), {"x": 2})


def test_conv_windows_are_the_output_rows_inputs():
    """Each band's window reads exactly the input rows of its output rows:
    a stride-1 3x3 the band with one row of each side (a symmetric halo),
    the 3x3/2 pool [2a - 1, 2b), a valid 3x3 [a, b + 2), a dilation wider
    than the map rows past both edges; an empty output band reads nothing."""
    assert conv_windows(8, 2, 3, 1, 1, 1) == (8, ((-1, 5), (3, 9)))
    assert conv_windows(8, 2, 3, 2, 1, 1) == (4, ((-1, 4), (3, 8)))
    assert conv_windows(7, 3, 3, 1, 0, 1) == (5, ((0, 3), (1, 5), (3, 7)))
    assert conv_windows(3, 2, 3, 1, 6, 6) == (3, ((-6, 7), (-5, 9)))
    assert conv_windows(1, 2, 3, 1, 1, 1) == (1, ((-1, -1), (-1, 2)))
    assert conv_windows(2, 4, 2, 2, 0, 1)[1] == ((0, 0), (0, 0), (0, 0), (0, 2))


# ------------------------------------------------------------------ the ranks

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(OPS))
def test_band_op_on_uneven_bands_matches_the_whole_map_op(name, world, worlds):
    """Each op of OPS on X ranks' unequal (X = 4 on 3 rows: empty) bands
    against the whole map's op in one process: each rank's output is the
    whole output's rows under the output map's cut (the whole output where
    every band holds it), its input band's gradient the whole gradient's
    band, the parameter gradients summed over the ranks the whole ones."""
    inp, outs = worlds[world][0], worlds[world][1]
    x, cts = inp[name]
    m, xt, y = _whole_out(name, x)
    params = dict(m.named_parameters())
    whole_ct = torch.from_numpy(sum(cts))
    grads = torch.autograd.grad((y * whole_ct).sum(), [xt, *params.values()])
    tol, whole = OPS[name][2], OPS[name][3]
    dp = {n: 0 for n in params}
    for rank, o in enumerate(outs):
        got = o["ops"][name]
        c_out, c_in = cut(y.shape[1], world), cut(x.shape[1], world)
        want = y if whole else y[:, c_out[rank]:c_out[rank + 1]]
        np.testing.assert_allclose(got["y"], want.detach().numpy(), atol=tol, rtol=tol,
                                   err_msg=f"{name} rank {rank}")
        np.testing.assert_allclose(got["dx"], grads[0][:, c_in[rank]:c_in[rank + 1]].numpy(),
                                   atol=tol, rtol=tol, err_msg=f"{name} rank {rank} dx")
        for n in params:
            dp[n] = dp[n] + got["dp"][n]
    for n, g in zip(params, grads[1:]):
        np.testing.assert_allclose(dp[n], g.numpy(), atol=1e-9, rtol=1e-9, err_msg=n)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["plain", "fused"])
def test_bn_on_uneven_bands_counts_the_whole_map(kind, world, worlds):
    """A train-mode BN on the ranks' bands of a 3-row map (unequal, empty at
    X = 4): its output and input gradient are the whole map's BN's band, its
    parameter gradients sum to the whole one's, and its running statistics
    are the one-process BN's (the running variance's n / (n - 1) with n the
    whole map's pixels: 2 * 3 * 4 = 24, not a band's rows times the ranks).
    The fused BN runs K1 sums-only, bn_finish, K2 and K3 on every band (the
    plain versions on the CPU). float32, 1e-5."""
    inp, outs = worlds[world]
    x, (ct,) = inp["bn"]
    m = (BatchNorm(5) if kind == "plain" else bn.FusedBatchNormReLU(5)).train()
    xt = torch.from_numpy(x).float().requires_grad_(True)
    y = m(xt)
    g = torch.autograd.grad((y * torch.from_numpy(ct).float()).sum(), [xt, m.weight, m.bias])
    c = cut(3, world)
    dw = db = 0
    for rank, o in enumerate(outs):
        got = o["bn"][kind]
        np.testing.assert_allclose(got["y"], y[:, c[rank]:c[rank + 1]].detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["dx"], g[0][:, c[rank]:c[rank + 1]].numpy(), atol=1e-5,
                                   rtol=1e-5)
        for a, b in zip(got["stats"], (m.running_mean, m.running_var)):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-6, rtol=1e-6)
        dw, db = dw + got["dw"], db + got["db"]
    np.testing.assert_allclose(dw, g[1].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(db, g[2].numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_elementwise_dropout_masks_are_the_whole_maps_cut(world, worlds):
    """An element-wise dropout on the ranks' unequal bands of a 5-row map
    draws the whole map's mask from the generator every band shares and
    keeps its band's rows: each rank's first two masks are the one-process
    dropout's, cut to its band."""
    inp, outs = worlds[world]
    d = Dropout(0.5, torch.Generator().manual_seed(5)).train()
    x = torch.from_numpy(inp["dropout"])
    want = [d.keep(x).numpy() for _ in range(2)]
    c = cut(5, world)
    for rank, o in enumerate(outs):
        for got, w in zip(o["dropout"], want):
            np.testing.assert_array_equal(got, w[:, c[rank]:c[rank + 1]])


@pytest.mark.parametrize("world", WORLDS)
def test_size_calls_are_kept_within_a_step_and_checked_over_the_bands(world, worlds):
    """Forwards inside `Bands.step` at the batch's whole size (as the train
    and eval steps run theirs) ask the bands for their maps' whole sizes
    once: the second forward of that kind makes no all-gather, and one
    outside a step asks again; all give the same output. Size calls out
    of step over the bands (each rank at another call) raise on every rank
    at once, none left waiting in a collective."""
    _, outs = worlds[world]
    for o in outs:
        got = o["sizes"]
        assert got["asked"][0] == 0 and got["asked"].count("forward") == 2, got["asked"]
        first = got["asked"].index("forward")
        assert got["asked"][first + 1] == "forward" and len(got["asked"]) > first + 2
        assert got["same"]
        assert "out of step" in got["error"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
