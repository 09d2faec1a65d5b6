"""The port's spatial partitioning (the 'x'/'y' mesh axes: parallel/halo.py,
the band ops, the spatial train and eval steps, `train --mesh x=2`).

One process, no ranks: each band op on a band given with its halo (cut
from the zero-padded full tensor) against the band of the full-image op, at
every band of x = 2, 3, 4 and of 'y' splits, forward and gradient (float64
where the op allows it, 1e-10; K4's plain version and the float32 upsample
1e-6).

Several OS processes over Gloo on 127.0.0.1 (2 intra-op threads each; this
file run as a script is the worker), one launch per world size serving
every case of it:

- world 2 ('x' = 2): `halo_exchange` against the padded full tensor and its
  adjoint (<halo(x), g> = <x, halo^T(g)> over the ranks, float64, 1e-6);
  `gather_bands` forward and backward; the train step of UNet and of
  NestedUNet wDS against the JAX package's spatial step on 2 of its virtual
  CPU devices (`make_train_step(..., mesh=make_mesh((1, 2), ("data", "x")),
  spatial=True)`) from the same weights: loss 1e-5, running statistics
  1e-5, the SGD momentum buffers (the first step's g + wd * p) within 1e-4
  relative L2 and the parameters after the step within 1e-6; the eval step
  against the port's one-process eval step; a halo wait on a peer that
  never sends raises after `halo.TIMEOUT` (2 s there);
- world 4: the halo and `gather_bands` with 'x' = 'y' = 2 (the corners);
  the UNet step under x=2,y=2 and the NestedUNet wDS step under
  data=2,x=2 against the port's one-process step (the same gates) and
  against the JAX package's spatial step on 4 of its virtual CPU devices
  (make_mesh((1, 2, 2), ('data', 'x', 'y')) and make_mesh((2, 2), ('data',
  'x')), the two-rank test's gates), and the data=2,x=2 eval step on a
  padded batch.

`train --mesh x=2` as two processes against `--mesh data=1` in one, the
JAX CLI test's bounds (loss 3e-3, IoU 3e-2).
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
from pytorch_nested_unet_tpu_torch.ops.layers import TorchConv
from pytorch_nested_unet_tpu_torch.ops.pool import max_pool2x2
from pytorch_nested_unet_tpu_torch.ops.resize import Upsample2x, upsample2x
from pytorch_nested_unet_tpu_torch.parallel import mesh as tmesh

NARROW = (4, 8, 16, 32, 64)
HW = 32
BATCH = 4  # the global batch of the steps
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPLITS = [(2, 1), (3, 1), (4, 1), (1, 2), (2, 2), (1, 3)]


# ------------------------------------------------------------------ one process

def _bands(h, w, nx, ny):
    """(h0, hb, w0, wb) of every band of an h x w image split nx x ny."""
    hb, wb = h // nx, w // ny
    return [(i * hb, hb, j * wb, wb) for i in range(nx) for j in range(ny)]


def _haloed(x, band, rows, cols):
    """The band of (B, H, W, C) x with `rows` / `cols` of halo, zeros past
    the edge: what halo_exchange gives the rank that holds it."""
    h0, hb, w0, wb = band
    return F.pad(x, (0, 0, cols, cols, rows, rows))[:, h0:h0 + hb + 2 * rows,
                                                    w0:w0 + wb + 2 * cols]


def _with_halo(mod, halo, *args):
    """mod(*args) with its `halo` set as `parallel.mesh.spatial_partition`
    sets it, then back to a whole image's."""
    mod.halo = halo
    try:
        return mod(*args)
    finally:
        mod.halo = (0, 0)


def _check_band_op(full_op, band_op, x, nx, ny, rows, cols, tol, params=()):
    """band_op(haloed band, band) against full_op(x)'s band, and the
    gradients of <out, ct> with respect to x and `params`."""
    want_full = full_op(x)
    (h, w), (ho, wo) = x.shape[1:3], want_full.shape[1:3]
    gen = torch.Generator().manual_seed(7)
    ct = torch.randn(want_full.shape, generator=gen, dtype=x.dtype)
    xs = [x.detach().clone().requires_grad_(True) for _ in range(2)]
    got_sum = 0
    for band in _bands(h, w, nx, ny):
        h0, hb, w0, wb = band
        out_rows = slice(h0 * ho // h, (h0 + hb) * ho // h)
        out_cols = slice(w0 * wo // w, (w0 + wb) * wo // w)
        got = band_op(_haloed(xs[0], band, rows, cols), band)
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
    (`Upsample2x` with its band's place set, through `upsample2x_band`):
    the positions are global (output row i reads i * (H - 1) / (2H - 1) of
    the whole map), float32 within 1e-6 of `F.interpolate` on the full map."""
    x = torch.randn(2, h, w, 3, generator=torch.Generator().manual_seed(h * w + nx))
    rows, cols = int(nx > 1), int(ny > 1)
    up = Upsample2x()

    def band_op(xh, band):
        h0, hb, w0, wb = band
        up.band = ((h0 // hb, nx), (w0 // wb, ny))
        return _with_halo(up, (rows, cols), xh)

    _check_band_op(upsample2x, band_op, x, nx, ny, rows, cols, 1e-6)


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
    for kw in ({"stride": 2, "padding": 1}, {"padding": 0}):
        with pytest.raises(ValueError, match="cannot run on bands"):
            tmesh.conv_halo(TorchConv(3, 4, 3, **kw), _FakeMesh(2, 1))
    assert tmesh.conv_halo(TorchConv(3, 4, 3, stride=2, padding=1), _FakeMesh(1, 1)) == (0, 0)


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


class _FakeMesh:
    """The partition a conv asks about, without ranks."""

    def __init__(self, nx, ny):
        self.shape = {"x": nx, "y": ny}

    def partitioned(self, axis):
        return self.shape[axis] > 1


def test_spatial_partition_refuses_other_archs_and_remat():
    """Refusals; on UNet, a pre-hook and a halo on every 3x3 conv, K4 node
    and upsample (none on the 1x1 head), the upsample's band; None undoes
    it all."""
    mesh = _mesh_of(("data", "x"), (1, 2), rank=1)
    with pytest.raises(ValueError, match="not UNetRNN.*ROADMAP.md"):
        tmesh.spatial_partition(create_model("UNetRNN", feature_scale=16), mesh)
    with pytest.raises(ValueError, match="--remat full.*ROADMAP.md"):
        tmesh.spatial_partition(create_model("NestedUNet", nb_filter=NARROW, remat="full"),
                                mesh)
    m = create_model("UNet", nb_filter=NARROW)
    for _ in range(2):  # a second call (the eval step's) replaces the hooks
        tmesh.spatial_partition(m, mesh)
    hooked = {n for n, s in m.named_modules() if s._forward_pre_hooks}
    assert len(hooked) == 18 + 1 and all(len(m.get_submodule(n)._forward_pre_hooks) == 1
                                         for n in hooked)
    assert m.conv0_0.conv1.halo == m.conv0_4.conv1.halo == m.up.halo == (1, 0)
    assert m.final.halo == (0, 0) and "final" not in hooked
    assert m.up.band == ((1, 2), (0, 1))
    tmesh.spatial_partition(m, None)
    assert not any(s._forward_pre_hooks for s in m.modules())
    assert all(getattr(s, "halo", (0, 0)) == (0, 0) for s in m.modules())
    assert m.up.band == ((0, 1), (0, 1))


def test_check_spatial_needs_bands_whole_through_the_pools():
    tmesh.check_spatial("NestedUNet", None, (96, 96), {"data": 2, "x": 6})
    for shape in ({"x": 4}, {"x": 2, "y": 4}):
        with pytest.raises(ValueError, match="multiple of 16.*ROADMAP.md"):
            tmesh.check_spatial("UNet", None, (96, 96), shape)


def test_one_process_spatial_mesh_is_the_whole_image():
    """'x' = 1 in one process: one band, the whole image; the halo is zeros
    and gather_bands is the identity."""
    from pytorch_nested_unet_tpu_torch.parallel import halo

    mesh = tmesh.make_mesh((1, 1), ("data", "x"))
    assert mesh.spatial and not mesh.partitioned("x") and mesh.spatial_group is None
    band = tmesh.batch_sharding(mesh, 6, spatial=True, hw=(32, 16))
    assert band == tmesh.Band(slice(0, 6), 0, 32, 0, 16, 32, 16)
    x = torch.randn(2, 4, 4, 3)
    assert halo.gather_bands(x, mesh) is x
    np.testing.assert_array_equal(halo.halo_exchange(x, mesh, 1, 0).numpy(),
                                  F.pad(x, (0, 0, 0, 0, 1, 1)).numpy())
    with pytest.raises(ValueError, match="not divisible by the spatial mesh axes"):
        tmesh.batch_sharding(_mesh_of(("x",), (3,)), 6, True, (32, 16))


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


def _step_case(inp, arch, ds, mesh, imgs, masks):
    from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn
    from pytorch_nested_unet_tpu_torch.training import optim
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step

    m = create_model(arch, 1, 3, ds, nb_filter=NARROW)
    m.load_state_dict(inp[f"state_{arch}"], strict=True)
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
        metrics = step(imgs, masks, torch.Generator().manual_seed(0))
    finally:
        bn.reference_bn_finish = real
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": _grads_of(opt),
            "params": {n: p.detach().numpy().copy() for n, p in m.named_parameters()},
            "stats": {n: b.numpy().copy() for n, b in m.named_buffers()},
            "finish_calls": calls["finish"]}


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
    hx = halo.halo_exchange(xb, halo_mesh, rows, cols)
    g = torch.from_numpy(inp["halo_g"][rank])
    (hx * g).sum().backward()
    out["halo"] = {"y": hx.detach().numpy(), "band": band,
                   "inner_y": float((hx.detach() * g).sum()),
                   "inner_x": float((xb.detach() * xb.grad).sum()), "dx": xb.grad.numpy()}
    tb = band.take(x).requires_grad_(True)
    gathered = halo.gather_bands(tb, halo_mesh)
    (gathered * torch.from_numpy(inp["halo_ct"])).sum().backward()
    out["gather"] = {"y": gathered.detach().numpy(), "dx": tb.grad.numpy()}

    imgs, masks = (torch.from_numpy(inp[k]) for k in ("imgs", "masks"))
    cases = ([("UNet", False, (1, 2), ("data", "x")), ("NestedUNet", True, (1, 2), ("data", "x"))]
             if world == 2 else
             [("UNet", False, (2, 2), ("x", "y")), ("NestedUNet", True, (2, 2), ("data", "x"))])
    for arch, ds, sizes, names in cases:
        mesh = make_mesh(sizes, names)
        rows_ = tmesh.batch_sharding(mesh, BATCH)
        key = f"{arch}_{'_'.join(f'{n}{s}' for n, s in zip(names, sizes))}"
        out[key] = _step_case(inp, arch, ds, mesh, imgs[rows_], masks[rows_])
    mesh = make_mesh(*cases[-1][2:])
    rows_ = tmesh.batch_sharding(mesh, BATCH)
    m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
    m.load_state_dict(inp["state_NestedUNet"], strict=True)
    ev = make_eval_step(m, "BCEDiceLoss", True, mesh)
    out["eval"] = {k: v.item() for k, v in ev(imgs[rows_], masks[rows_],
                                              torch.tensor([1.0, 1.0, 1.0, 0.0])[rows_]).items()}
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
            halo.halo_exchange(torch.zeros(1, 4, 4, 1), halo_mesh, 1, 0)
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


def _launch(world, d):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]), OMP_NUM_THREADS="2")
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(world), str(rank), str(port),
                 str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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
    return [torch.load(d / f"out{world}_{r}.pt", weights_only=False) for r in range(world)]


def _inputs(d, world):
    """The ranks' inputs, from numpy seeds; the weights from the JAX
    models' variables (the BN-fed conv biases at 0)."""
    import jax

    from pytorch_nested_unet_tpu.models import create_model as jax_create_model
    from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
    from test_torch_crdn import jax_variables, train_batch, zero_bn_fed_biases

    rng = np.random.default_rng(world)
    imgs, masks = train_batch(0, b=BATCH, hw=HW)
    x = rng.standard_normal((2, 12, 8, 3))
    inp = {"halo_x": x, "imgs": imgs, "masks": masks,
           "halo_ct": rng.standard_normal(x.shape)}
    nx, ny = (2, 1) if world == 2 else (2, 2)
    rows, cols = 2, (1 if world == 4 else 0)
    inp["halo_g"] = [rng.standard_normal((2, 12 // nx + 2 * rows, 8 // ny + 2 * cols, 3))
                     for _ in range(world)]
    jax_side = {}
    for arch, ds in (("UNet", False), ("NestedUNet", True)):
        jm = jax_create_model(arch, 1, 3, ds, nb_filter=NARROW)
        variables = zero_bn_fed_biases(jax_variables(jm, imgs.shape, 0))
        inp[f"state_{arch}"] = state_dict_from_jax(jax.device_get(variables))
        jax_side[arch] = (jm, variables)
    torch.save(inp, d / "in.pt")
    return inp, jax_side


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


def _rel(got, want, name):
    den = max(np.linalg.norm(want[name]),
              np.linalg.norm(want[name.rsplit(".", 1)[0] + ".weight"]))
    return np.linalg.norm(got[name] - want[name]) / den


def _hold_step(got, loss, grads, params, stats, finish_calls, what, gate=None):
    """loss 1e-5, running statistics 1e-5, momentum buffers 1e-4 relative
    L2 (of the larger of their own norm and their module's weight's; `gate`:
    per buffer), parameters 1e-6 (times gate / 1e-4: lr times the buffer);
    BN finishes: one per BN layer."""
    assert abs(got["metrics"]["loss"] - loss) <= 1e-5, what
    for name, s in got["stats"].items():
        np.testing.assert_allclose(s, stats[name], atol=1e-5, rtol=1e-5, err_msg=f"{what} {name}")
    for name in got["grads"]:
        tol = 1e-4 if gate is None else gate[name]
        assert _rel(got["grads"], grads, name) <= tol, f"{what} {name}"
        np.testing.assert_allclose(got["params"][name], params[name], atol=1e-6 * tol / 1e-4,
                                   err_msg=f"{what} {name}")
    assert got["finish_calls"] == finish_calls, what


_JAX_STEPS = {}  # (arch, mesh): both worlds draw the same batch and weights


def _jax_step(arch, jm, variables, ds, imgs, masks, mesh_shape=None):
    """The JAX package's step; with `mesh_shape` = (sizes, names), under
    make_mesh(sizes, names) with spatial=True on the first prod(sizes) of
    its 8 virtual CPU devices: (loss, momentum buffers, parameters, running
    statistics) in the port's names."""
    key = (arch, mesh_shape)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _run_jax_step(jm, variables, ds, imgs, masks, mesh_shape)
    return _JAX_STEPS[key]


def _run_jax_step(jm, variables, ds, imgs, masks, mesh_shape):
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
    sd = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats})
    trace = state_dict_from_jax({"params": new.opt_state.inner_state[1].trace,
                                 "batch_stats": new.batch_stats})
    stat = ("running_mean", "running_var")
    names = [n for n in sd if not n.endswith(stat)]
    return (float(metrics["loss"]), {n: trace[n].numpy() for n in names},
            {n: sd[n].numpy() for n in names},
            {n: v.numpy() for n, v in sd.items() if n.endswith(stat)})


@pytest.mark.parametrize("arch,ds", [("UNet", False), ("NestedUNet", True)])
def test_two_rank_x2_step_matches_the_jax_spatial_step(arch, ds, two_ranks):
    """The port's step under x=2 on 2 ranks (each its 16-row band, halos,
    BN over both bands through K1's sums, bn_finish, K2 and K3) against
    the JAX package's GSPMD-partitioned step from the same weights, and
    against its unpartitioned step. The JAX spatial step itself moves some
    gradients off its unpartitioned step (UNet's by up to 2e-3 relative
    L2: its partitioned sums add in another order and the step is chaotic
    at init), so against it each buffer is held to 1e-4 or 4x that
    movement, whichever is more; against the unpartitioned step, to 1e-4."""
    _hold_to_jax(arch, ds, f"{arch}_data1_x2", two_ranks, ((1, 2), ("data", "x")))


def _hold_to_jax(arch, ds, key, ranks, mesh_shape):
    """The ranks' step `key` against the JAX package's spatial step under
    `mesh_shape` (each momentum buffer within 1e-4 or 4x the JAX spatial
    step's own movement off its unpartitioned step, whichever is more) and
    against its unpartitioned step (1e-4)."""
    inp, outs, jax_side = ranks
    jm, variables = jax_side[arch]
    spatial = _jax_step(arch, jm, variables, ds, inp["imgs"], inp["masks"], mesh_shape)
    plain = _jax_step(arch, jm, variables, ds, inp["imgs"], inp["masks"])
    gate = {n: max(1e-4, 4 * _rel(spatial[1], plain[1], n)) for n in plain[1]}
    got = {k: _both(outs, key, k) for k in ("metrics", "grads", "params", "stats",
                                             "finish_calls")}
    calls = 30 if ds else 18
    _hold_step(got, *spatial, calls, f"{key} against JAX's spatial step {mesh_shape}", gate)
    _hold_step(got, *plain, calls, f"{key} against JAX's step")


def _one_process_step(inp, arch, ds):
    """The port's step without a mesh over the global batch."""
    from pytorch_nested_unet_tpu_torch.training import optim
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step

    m = create_model(arch, 1, 3, ds, nb_filter=NARROW)
    m.load_state_dict(inp[f"state_{arch}"], strict=True)
    opt = optim.build_optimizer(m.parameters(), "SGD", 1e-2, 0.9, 1e-4)
    opt._names = dict(m.named_parameters())
    metrics = make_train_step(m, opt, "BCEDiceLoss", ds, "none")(
        torch.from_numpy(inp["imgs"]), torch.from_numpy(inp["masks"]),
        torch.Generator().manual_seed(0))
    return (metrics["loss"].item(), _grads_of(opt),
            {n: p.detach().numpy() for n, p in m.named_parameters()},
            {n: b.numpy() for n, b in m.named_buffers()})


@pytest.mark.parametrize("arch,ds,key", [("UNet", False, "UNet_x2_y2"),
                                         ("NestedUNet", True, "NestedUNet_data2_x2")])
def test_four_rank_steps_match_the_one_process_step(arch, ds, key, four_ranks):
    """UNet under x=2,y=2 (the corners) and NestedUNet wDS under data=2,x=2
    (2 rows of 2 bands each) against the port's one-process step."""
    inp, outs = four_ranks[:2]
    got = {k: _both(outs, key, k) for k in ("metrics", "grads", "params", "stats",
                                             "finish_calls")}
    _hold_step(got, *_one_process_step(inp, arch, ds), 30 if ds else 18, key)


@pytest.mark.parametrize("arch,ds,key,mesh_shape", [
    ("UNet", False, "UNet_x2_y2", ((1, 2, 2), ("data", "x", "y"))),
    ("NestedUNet", True, "NestedUNet_data2_x2", ((2, 2), ("data", "x")))])
def test_four_rank_steps_match_the_jax_spatial_step(arch, ds, key, mesh_shape, four_ranks):
    """The same 4-rank steps against the JAX package's spatial step on 4 of
    its virtual CPU devices (its `batch_sharding` puts H on 'x' and W on
    'y'; data=2,x=2 as its tests/test_parallel.py lays out data by 'x'),
    from the same weights: the column exchange, the corners and the
    grouping of bands by data row, held as the two-rank test holds x=2."""
    _hold_to_jax(arch, ds, key, four_ranks, mesh_shape)


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
    m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
    m.load_state_dict(inp["state_NestedUNet"], strict=True)
    want = make_eval_step(m, "BCEDiceLoss", True)(
        torch.from_numpy(inp["imgs"]), torch.from_numpy(inp["masks"]),
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


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
