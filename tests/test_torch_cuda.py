"""The port on a CUDA card: each kernel against its plain version, K4's
gradients against autograd through its plain version, and the model (serving
and one train step) on the card against the same weights on the CPU.

Every test carries the `cuda` marker and skips on a host without CUDA (the
`cuda` fixture decides, at run time). This file imports no JAX, so on a
machine that has the card but no JAX it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn
from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

pytestmark = pytest.mark.cuda

NARROW = (4, 8, 16, 32, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, cps, co, hw, dev, dtype, batch=2):
    g = torch.Generator().manual_seed(seed)
    parts = [torch.randn(batch, *hw, c, generator=g).to(dev, dtype) for c in cps]
    kernel = (torch.randn(3, 3, sum(cps), co, generator=g) * 0.1).to(dev, dtype)
    bias = torch.randn(co, generator=g).to(dev)
    return parts, kernel, bias


# f32: summation order over K = 9*cin; bf16: one rounding of the output, and the
# plain version adds the bias after that rounding where the kernel adds it before.
# The shapes hit the edges of the bf16 kernel's tiling: 8 parts (MAX_PARTS), a
# part whose channel count is not a multiple of 8 between parts whose are (scalar
# staging), co not a multiple of 8 (scalar weights and stores) and co > 128,
# H and W off the 12x12 pixel tile (one pixel, 13x10, 5x33, 25x25: ragged tiles
# in both directions), batch 1, and K split over a cluster of 2 blocks (each
# shape of 6 or more K chunks over few blocks).
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("cps,co,hw,batch", [
    ((5, 3, 8), 6, (13, 10), 2), ((7,), 4, (1, 1), 2), ((32, 32, 64), 32, (24, 24), 2),
    ((64, 128), 70, (9, 17), 2), ((1,) * 8, 3, (5, 33), 2),
    ((32, 5, 64), 64, (12, 12), 2), ((96, 40), 136, (13, 10), 1),
    ((64, 128), 70, (24, 24), 1), ((8, 16, 8, 24, 8, 8, 32, 40), 48, (13, 10), 2),
    ((256, 200), 136, (12, 12), 1), ((256, 512), 256, (12, 12), 2),
    ((32, 64), 32, (25, 25), 2), ((64, 128), 64, (25, 25), 2), ((32, 5, 64), 64, (5, 33), 2),
])
def test_multipart_conv3x3_kernel(cuda, dtype, tol, cps, co, hw, batch):
    parts, kernel, bias = _inputs(0, cps, co, hw, cuda, dtype, batch=batch)
    before = df.LAUNCHES
    out = df.multipart_conv3x3(parts, kernel, bias)
    torch.cuda.synchronize()
    assert df.LAUNCHES == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    ref = df.reference_multipart_conv3x3([p.float() for p in parts], kernel.float(), bias)
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    nobias = df.multipart_conv3x3(parts, kernel)
    ref0 = df.reference_multipart_conv3x3([p.float() for p in parts], kernel.float())
    torch.testing.assert_close(nobias.float(), ref0, atol=tol, rtol=tol)


# NestedUNet's decoder nodes at batch 16: (H = W, part channels, co)
NODES = [(96, (32, 64), 32), (96, (32, 32, 64), 32), (96, (32, 32, 32, 64), 32),
         (96, (32, 32, 32, 32, 64), 32), (48, (64, 128), 64), (48, (64, 64, 128), 64),
         (48, (64, 64, 64, 128), 64), (24, (128, 256), 128), (24, (128, 128, 256), 128),
         (12, (256, 512), 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size,cps,co", NODES)
def test_launch_fills_the_card(cuda, size, cps, co, dtype):
    """Every decoder node at batch 16 launches a block per SM, or its tiles
    are too few for that and it splits K to fill more of them (the 12x12
    node: 64 tiles, 128 blocks)."""
    plan = df.launch_plan(dtype, 16, size, size, cps, co)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan["blocks"] >= sms or plan["split"] == 2, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cps,co,hw,batch", [
    ((256, 200), 136, (12, 12), 1), ((8, 16, 8, 24, 8, 8, 32, 40), 48, (13, 10), 2)])
def test_split_k_is_deterministic(cuda, cps, co, hw, batch, dtype):
    """The split-K route sums its partials in a fixed order: the same bits
    on every run."""
    assert df.launch_plan(dtype, batch, *hw, cps, co)["split"] == 2
    parts, kernel, bias = _inputs(3, cps, co, hw, cuda, dtype, batch=batch)
    first = df.multipart_conv3x3(parts, kernel, bias)
    for _ in range(3):
        assert torch.equal(df.multipart_conv3x3(parts, kernel, bias), first)


def test_multipart_conv3x3_rejects_bad_inputs(cuda):
    parts, kernel, bias = _inputs(1, (4, 4), 8, (6, 6), cuda, torch.float32)
    with pytest.raises(ValueError):  # not NHWC-contiguous
        df.multipart_conv3x3([parts[0].transpose(1, 2), parts[1]], kernel, bias)
    with pytest.raises(ValueError):  # kernel dtype differs
        df.multipart_conv3x3(parts, kernel.bfloat16(), bias)
    with pytest.raises(ValueError):  # mixed devices
        df.multipart_conv3x3(parts, kernel.cpu(), bias)
    with pytest.raises(TypeError):
        df.multipart_conv3x3([p.half() for p in parts], kernel.half(), bias)


def test_predictor_cuda_matches_cpu(cuda):
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    kw = dict(deep_supervision=True, batch_size=2, arch_kwargs={"nb_filter": NARROW})
    gpu = Predictor(device="cuda", **kw)
    before = df.LAUNCHES
    out = gpu.predict_u8(images)
    assert df.LAUNCHES - before == 10 * 2  # 10 decoder nodes x 2 batches
    sd = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    ref = Predictor(device="cpu", weights=sd, **kw).predict_u8(images)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_k4_operator_launches_the_kernel(cuda):
    """The registered operator on CUDA tensors is the kernel launch: one
    count a call, the kernel's result, and torch.library.opcheck's schema,
    fake and dispatch checks; a CPU kernel beside CUDA parts is refused."""
    parts, kernel, bias = _inputs(2, (5, 3, 8), 6, (13, 10), cuda, torch.float32)
    op = torch.ops.nested_unet_torch.multipart_conv3x3.default
    before = df.LAUNCHES
    out = op(parts, kernel, bias)
    assert df.LAUNCHES - before == 1
    want = df.reference_multipart_conv3x3(parts, kernel, bias)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    torch.library.opcheck(op, (parts, kernel, bias))
    with pytest.raises(ValueError):
        op([p.cpu() for p in parts], kernel, bias)


def test_artifact_serves_through_k4_on_the_card(cuda, tmp_path):
    """A narrow NestedUNet wDS capsule exported with a dynamic batch: loaded
    on the card it launches K4 at the 10 decoder nodes per call and gives
    the live Predictor's probabilities at batch 1 and 3."""
    from pytorch_nested_unet_tpu_torch import serving
    from pytorch_nested_unet_tpu_torch.utils.config import save_config

    model = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW,
                         generator=torch.Generator().manual_seed(3))
    save_config({"arch": "NestedUNet", "num_classes": 1, "input_channels": 3,
                 "deep_supervision": True, "input_h": 32, "input_w": 32, "precision": "fp32",
                 "name": "run", "arch_kwargs": '{"nb_filter": [4, 8, 16, 32, 64]}'},
                str(tmp_path / "run"))
    torch.save(model.state_dict(), tmp_path / "run" / "model.pth")
    path, manifest = serving.export_capsule(str(tmp_path / "run"), device="cuda")
    predict, _ = serving.load_exported(path, "cuda")
    rng = np.random.default_rng(1)
    for b in (1, 3):
        images = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        live = Predictor.from_capsule(str(tmp_path / "run"), batch_size=b, device="cuda")[0]
        before = df.LAUNCHES
        got = predict(images).cpu().numpy()
        assert df.LAUNCHES - before == 10
        np.testing.assert_allclose(got, live.predict_u8(images), atol=1e-5, rtol=0)


# K1-K3, against the plain version in f32 on the same (rounded) inputs. The
# per-channel sums differ by summation order only; dbeta and dgamma add terms
# of either sign, so their error is held against the sum of the summands'
# magnitudes (1e-6 of it). mean, var, inv and the running stats atol = rtol =
# 1e-5 (f32) / 1e-4 (bf16); dx 1e-4 (f32) / 1e-2 (bf16, rounded once).
BN_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-4, 1e-2)}


def _assert_sums_close(got, want, magnitude):
    assert ((got - want).abs() <= 1e-6 * magnitude).all(), (got - want).abs().max()


# NestedUNet's training step has five levels, (32, 147456), (64, 36864),
# (128, 9216), (256, 2304) and (512, 576); 40001 rows are no multiple of any
# kernel's unrolled stride (kUnroll rows of every lane of a block). The CRDN
# family adds the score blocks' C = num_classes (1 or 2, scalar loads) over
# up to 147456 rows, UNetRNN's level 0 (16), RM3's level 1 (72) and RM7's
# 1x1 level (512 over 16 rows).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,rows", [
    (32, 1000), (64, 37), (1, 1), (1, 1000), (3, 37), (48, 1000), (70, 37), (70, 1),
    (512, 576), (256, 2304), (32, 147456), (64, 36864), (32, 40001),
    (1, 147456), (2, 147456), (16, 147456), (72, 36864), (512, 16),
])
def test_bn_kernels(cuda, dtype, c, rows):
    g = torch.Generator().manual_seed(1000 * c + rows)
    x = (torch.randn(rows, c, generator=g) * 1.5 + 0.3).to(cuda, dtype)
    dy = torch.randn(rows, c, generator=g).to(cuda, dtype)
    gamma = (torch.rand(c, generator=g) + 0.5).to(cuda)
    beta = (torch.rand(c, generator=g) * 0.6 - 0.3).to(cuda)
    rm, rv = torch.zeros(c, device=cuda), torch.ones(c, device=cuda)
    rm_ref, rv_ref = rm.clone(), rv.clone()
    vec_tol, dx_tol = BN_TOL[dtype]
    before = dict(bn.LAUNCHES)

    xf, dyf = x.float(), dy.float()
    got = bn.bn_stats(x, 1e-5, rm, rv)
    want = bn.reference_bn_stats(xf, 1e-5, rm_ref, rv_ref)
    _assert_sums_close(got[0], want[0], xf.abs().sum(0))
    _assert_sums_close(got[1], want[1], (xf * xf).sum(0))
    for a, b in zip((*got[2:], rm, rv), (*want[2:], rm_ref, rv_ref)):
        torch.testing.assert_close(a, b, atol=vec_tol, rtol=vec_tol)

    _, _, mean, _, inv = want
    dbeta, dgamma = bn.bn_bwd_reduce(x, dy, mean, inv, gamma, beta)
    ref_db, ref_dg = bn.reference_bn_bwd_reduce(xf, dyf, mean, inv, gamma, beta)
    xhat = (xf - mean) * inv
    dz = torch.where(gamma * xhat + beta > 0, dyf, 0.0)
    _assert_sums_close(dbeta, ref_db, dz.abs().sum(0))
    _assert_sums_close(dgamma, ref_dg, (dz * xhat).abs().sum(0))
    dx = bn.bn_bwd_dx(x, dy, mean, inv, gamma, beta, ref_db, ref_dg)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.shape == x.shape
    ref_dx = bn.reference_bn_bwd_dx(xf, dyf, mean, inv, gamma, beta, ref_db, ref_dg)
    torch.testing.assert_close(dx.float(), ref_dx, atol=dx_tol, rtol=dx_tol)
    assert {k: bn.LAUNCHES[k] - before[k] for k in before} == {
        "bn_stats": 1, "bn_bwd_reduce": 1, "bn_bwd_dx": 1, "bn_finish": 0}
    # no float atomics: the same inputs give the same bits
    assert torch.equal(bn.bn_stats(x)[0], got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,rows", [(32, 147456), (512, 576), (70, 37), (1, 1)])
def test_bn_split_path_gives_one_k1_calls_bits(cuda, dtype, c, rows):
    """Data-parallel K1: the sums-only launch and bn_finish on its sums give
    the bits of one K1 call (the running stats too); bn_finish matches its
    plain version; K3 divides by the n it is given."""
    g = torch.Generator().manual_seed(c + rows)
    x = (torch.randn(rows, c, generator=g) * 1.5 + 0.3).to(cuda, dtype)
    rm, rv = torch.rand(c, device=cuda), torch.rand(c, device=cuda) + 0.5
    rm1, rv1 = rm.clone(), rv.clone()
    before = dict(bn.LAUNCHES)
    one = bn.bn_stats(x, 1e-5, rm1, rv1)
    sums = bn.bn_sums(x)
    split = bn.bn_finish(sums, rows, 1e-5, rm, rv)
    torch.cuda.synchronize()
    assert {k: bn.LAUNCHES[k] - before[k] for k in before} == {
        "bn_stats": 2, "bn_bwd_reduce": 0, "bn_bwd_dx": 0, "bn_finish": 1}
    assert torch.equal(sums, torch.stack(one[:2]))
    for a, b in zip((*split, rm, rv), (*one[2:], rm1, rv1)):
        assert torch.equal(a, b)
    rm2, rv2 = rm.clone(), rv.clone()
    want = bn.reference_bn_finish(sums[0], sums[1], 2 * rows, 1e-5, rm2, rv2)
    got = bn.bn_finish(sums, 2 * rows, 1e-5, rm, rv)
    for a, b in zip((*got, rm, rv), (*want, rm2, rv2)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    dy = torch.randn(rows, c, generator=g).to(cuda, dtype)
    gamma, beta = torch.rand(c, device=cuda) + 0.5, torch.rand(c, device=cuda) - 0.5
    db, dg = bn.bn_bwd_reduce(x, dy, got[0], got[2], gamma, beta)
    dx = bn.bn_bwd_dx(x, dy, got[0], got[2], gamma, beta, db, dg, 2 * rows)
    ref = bn.reference_bn_bwd_dx(x.float(), dy.float(), got[0], got[2], gamma, beta, db, dg,
                                 2 * rows)
    torch.testing.assert_close(dx.float(), ref, atol=BN_TOL[dtype][1], rtol=BN_TOL[dtype][1])


def _k2_inputs(c, rows, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, c, generator=g) * 1.5 + 0.3).to(dev, dtype)
    dy = torch.randn(rows, c, generator=g).to(dev, dtype)
    gamma = (torch.rand(c, generator=g) + 0.5).to(dev)
    beta = (torch.rand(c, generator=g) * 0.6 - 0.3).to(dev)
    xf = x.float()
    mean = xf.mean(0)
    inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
    return x, dy, mean, inv, gamma, beta


def _assert_k2_close(got, args):
    x, dy, mean, inv, gamma, beta = args
    xf, dyf = x.float(), dy.float()
    want = bn.reference_bn_bwd_reduce(xf, dyf, mean, inv, gamma, beta)
    xhat = (xf - mean) * inv
    dz = torch.where(gamma * xhat + beta > 0, dyf, 0.0)
    _assert_sums_close(got[0], want[0], dz.abs().sum(0))
    _assert_sums_close(got[1], want[1], (dz * xhat).abs().sum(0))


def _assert_k1_close(got, args):
    xf = args[0].float()
    want = bn.reference_bn_stats(xf)
    _assert_sums_close(got[0], want[0], xf.abs().sum(0))
    _assert_sums_close(got[1], want[1], (xf * xf).sum(0))
    vec_tol = BN_TOL[args[0].dtype][0]
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, atol=vec_tol, rtol=vec_tol)


# K1 and K2 each are one launch whose last block sums the partials in a fixed
# order and resets its ticket: level 0 of the training step and the ragged
# shapes give the same bits on every rerun.
@pytest.mark.parametrize("kernel", ["bn_stats", "bn_bwd_reduce"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,rows", [(32, 147456)] + [
    (c, rows) for c in (1, 3, 48, 70) for rows in (1, 37, 1000)])
def test_bn_bwd_reduce_same_bits(cuda, dtype, c, rows, kernel):
    args = _k2_inputs(c, rows, dtype, cuda, seed=c + rows)
    if kernel == "bn_stats":
        run, check = (lambda: bn.bn_stats(args[0])), _assert_k1_close
    else:
        run, check = (lambda: bn.bn_bwd_reduce(*args)), _assert_k2_close
    first = run()
    check(first, args)
    for _ in range(3):
        got = run()
        assert all(torch.equal(a, b) for a, b in zip(got, first))


def test_bn_bwd_reduce_back_to_back_shapes(cuda):
    """K1 and K2 calls of different shapes, interleaved on one stream with no
    sync between them, are each right: every call leaves the ticket buffer
    that the two kernels share at 0 for the next."""
    cases = [(32, 147456, torch.float32), (70, 37, torch.bfloat16), (512, 576, torch.float32),
             (1, 1, torch.bfloat16), (48, 1000, torch.float32), (256, 2304, torch.bfloat16),
             (3, 37, torch.float32), (64, 36864, torch.bfloat16)]
    args = [_k2_inputs(c, rows, dtype, cuda, seed=i) for i, (c, rows, dtype) in enumerate(cases)]
    torch.cuda.synchronize()
    stats, reds = [], []
    for i, a in enumerate(args):
        stats.append(bn.bn_stats(a[0]))
        reds.append(bn.bn_bwd_reduce(*args[(i + 3) % len(args)]))
    torch.cuda.synchronize()
    for i, a in enumerate(args):
        _assert_k1_close(stats[i], a)
        _assert_k2_close(reds[i], args[(i + 3) % len(args)])


def test_bn_bwd_reduce_graph_replay(cuda):
    """K2 captured in a CUDA graph gives the eager result on every replay."""
    args = _k2_inputs(64, 36864, torch.bfloat16, cuda, seed=7)
    want = bn.bn_bwd_reduce(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bn.bn_bwd_reduce(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bn.bn_bwd_reduce(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_stats_graph_replay(cuda, dtype):
    """K1 captured in a CUDA graph gives the eager sums on every replay, and
    its running statistics after N replays equal those of N eager calls: the
    update is applied once per launch."""
    x = _k2_inputs(64, 36864, dtype, cuda, seed=8)[0]
    want = bn.bn_stats(x)
    graph_run = [torch.zeros(64, device=cuda), torch.ones(64, device=cuda)]
    eager_run = [t.clone() for t in graph_run]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bn.bn_stats(x, 1e-5, *graph_run)
    for _ in range(3):
        graph.replay()
        bn.bn_stats(x, 1e-5, *eager_run)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert all(torch.equal(a, b) for a, b in zip(graph_run, eager_run))
    assert not torch.equal(graph_run[0], torch.zeros(64, device=cuda))


# The band runs' BN shapes: a whole map's rows cut into unequal bands, and a
# band of zero rows (UNetRM7's 1-row level over 2 bands).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cuts", [(512, (0, 0, 16)), (32, (0, 1, 3, 4, 6)),
                                    (70, (0, 36864, 73729)), (1, (0, 0, 0, 5))])
def test_bn_kernels_on_zero_and_unequal_band_rows(cuda, dtype, c, cuts):
    """K1 (sums-only), K2 and K3 on each band of a (rows, C) map cut at
    `cuts` (unequal bands, and bands of zero rows) against their plain
    versions: each band's sums within 1e-6 of their magnitude (zeros on a
    zero-row band), the bands' sums adding to the whole map's, K3's dx with
    n the whole map's rows; one launch of each kernel per band, a zero-row
    band's included. K1 with its finish refuses zero rows."""
    g = torch.Generator().manual_seed(c + len(cuts))
    rows = cuts[-1]
    x = (torch.randn(rows, c, generator=g) * 1.5 + 0.3).to(cuda, dtype)
    dy = torch.randn(rows, c, generator=g).to(cuda, dtype)
    gamma = (torch.rand(c, generator=g) + 0.5).to(cuda)
    beta = (torch.rand(c, generator=g) * 0.6 - 0.3).to(cuda)
    _, _, mean, _, inv = bn.reference_bn_stats(x.float())
    total = torch.zeros(2, c, device=cuda)
    grads = torch.zeros(2, c, device=cuda)
    before = dict(bn.LAUNCHES)
    for lo, hi in zip(cuts, cuts[1:]):
        xb, dyb = x[lo:hi].contiguous(), dy[lo:hi].contiguous()
        sums = bn.bn_sums(xb)
        want = torch.stack(bn.reference_bn_sums(xb.float()))
        _assert_sums_close(sums[0], want[0], xb.float().abs().sum(0))
        _assert_sums_close(sums[1], want[1], (xb.float() ** 2).sum(0))
        red = bn.bn_bwd_reduce_sums(xb, dyb, mean, inv, gamma, beta)
        _assert_k2_close(red, (xb, dyb, mean, inv, gamma, beta))
        if hi == lo:
            assert not sums.any() and not red.any()
        total += sums
        grads += red
    for lo, hi in zip(cuts, cuts[1:]):
        xb, dyb = x[lo:hi].contiguous(), dy[lo:hi].contiguous()
        dx = bn.bn_bwd_dx(xb, dyb, mean, inv, gamma, beta, grads[0], grads[1], rows)
        ref = bn.reference_bn_bwd_dx(xb.float(), dyb.float(), mean, inv, gamma, beta, grads[0],
                                     grads[1], rows)
        assert dx.shape == xb.shape
        torch.testing.assert_close(dx.float(), ref, atol=BN_TOL[dtype][1], rtol=BN_TOL[dtype][1])
    torch.cuda.synchronize()
    want = torch.stack(bn.reference_bn_sums(x.float()))
    _assert_sums_close(total[0], want[0], x.float().abs().sum(0))
    _assert_sums_close(total[1], want[1], (x.float() ** 2).sum(0))
    n = len(cuts) - 1
    assert {k: bn.LAUNCHES[k] - before[k] for k in before} == {
        "bn_stats": n, "bn_bwd_reduce": n, "bn_bwd_dx": n, "bn_finish": 0}
    with pytest.raises(ValueError, match="rows >= 1"):
        bn.bn_stats(x[:0].contiguous())


def test_bn_kernels_reject_bad_inputs(cuda):
    x = torch.randn(8, 4, device=cuda)
    with pytest.raises(ValueError):
        bn.bn_stats(x.t())  # not contiguous (rows, C)
    with pytest.raises(TypeError):
        bn.bn_stats(x.half())
    with pytest.raises(ValueError):
        bn.bn_bwd_reduce(x, x.bfloat16(), *[torch.ones(4, device=cuda)] * 4)


@pytest.mark.parametrize("cps,co,hw", [((32, 64), 32, (24, 24)), ((5, 3, 8), 6, (13, 10))])
def test_multipart_conv3x3_gradients(cuda, cps, co, hw):
    parts, kernel, bias = _inputs(2, cps, co, hw, cuda, torch.float32)
    weight = kernel.permute(3, 2, 0, 1).contiguous().requires_grad_(True)
    bias.requires_grad_(True)
    ps = [p.clone().requires_grad_(True) for p in parts]
    ct = torch.randn(2, *hw, co, device=cuda)
    before = df.LAUNCHES
    (df.conv3x3_parts(ps, weight, bias) * ct).sum().backward()
    assert df.LAUNCHES == before + 1
    ref_ps = [p.clone().requires_grad_(True) for p in parts]
    ref_w = weight.detach().clone().requires_grad_(True)
    ref_b = bias.detach().clone().requires_grad_(True)
    (df.reference_multipart_conv3x3(ref_ps, ref_w.permute(2, 3, 1, 0), ref_b) * ct).sum().backward()
    for got, want in [(p.grad, r.grad) for p, r in zip(ps, ref_ps)] + [
            (weight.grad, ref_w.grad), (bias.grad, ref_b.grad)]:
        assert (got - want).norm() <= 1e-4 * want.norm()


def test_train_step_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    masks = torch.from_numpy((rng.random((2, 32, 32, 1)) > 0.6).astype(np.uint8) * 255)
    models, metrics = {}, {}
    for dev in ("cpu", "cuda"):
        m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
        # Every conv bias that feeds a BN starts at 0. Train-mode BN subtracts
        # the batch mean, so such a bias changes nothing in exact arithmetic;
        # at its init it dominates the first conv's output on these inputs
        # (mean^2 up to 1,370 times var), and var = E[x^2] - mean^2 then turns
        # the last bit of a BN sum into a 1e-4 change of var. On the CPU alone,
        # taking those sums exactly instead of in f32 order moves the
        # gradients by up to 865 times the bound below (0.12 times with these
        # biases at 0), so the comparison would hold the card to the CPU's
        # summation order rather than to the step.
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith(("conv1.bias", "conv2.bias")):
                    p.zero_()
        m = m.to(dev)
        step = make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-2), "BCEDiceLoss",
                               True, augment="none")
        before = (dict(bn.LAUNCHES), df.LAUNCHES)
        metrics[dev] = step(imgs.to(dev), masks.to(dev), torch.Generator(device=dev))
        if dev == "cuda":
            assert {k: bn.LAUNCHES[k] - before[0][k] for k in bn.LAUNCHES} == {
                "bn_stats": 30, "bn_bwd_reduce": 30, "bn_bwd_dx": 30, "bn_finish": 0}
            assert df.LAUNCHES - before[1] == 10
        models[dev] = m
    assert abs(float(metrics["cuda"]["loss"]) - float(metrics["cpu"]["loss"])) <= 1e-5
    # relative to the larger of the parameter's own gradient norm and its
    # module's weight gradient norm: a conv bias that feeds a BN has a true
    # gradient of zero (the BN's mean subtraction cancels it), so both devices
    # compute rounding noise for it
    grads = {n: p.grad for n, p in models["cpu"].named_parameters()}
    for name, p in models["cuda"].named_parameters():
        want = grads[name]
        scale = max(want.norm(), grads[name.rsplit(".", 1)[0] + ".weight"].norm())
        assert (p.grad.cpu() - want).norm() <= 1e-4 * scale, name
    cpu_bufs = dict(models["cpu"].named_buffers())
    for name, b in models["cuda"].named_buffers():
        torch.testing.assert_close(b.cpu(), cpu_bufs[name], atol=1e-5, rtol=1e-5)


def _zero_bn_fed_biases(m):
    """Every conv bias that feeds a BN starts at 0 (see
    test_train_step_cuda_matches_cpu)."""
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith(("conv1.bias", "conv2.bias", "conv1.0.bias", "conv2.0.bias")) \
                    or (name.startswith("score_block") and name.endswith(".0.bias")):
                p.zero_()
    return m


def test_unetrnn_train_step_cuda_matches_cpu(cuda):
    """A narrow UNetRNN step on the card against the CPU: 15 launches of each
    BN kernel (10 encoder BNs, 5 score blocks at C = 1), no K4; the loss,
    gradients and running stats within the NestedUNet step's bounds."""
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    masks = torch.from_numpy((rng.random((2, 32, 32, 1)) > 0.6).astype(np.uint8) * 255)
    models, metrics = {}, {}
    for dev in ("cpu", "cuda"):
        m = _zero_bn_fed_biases(create_model("UNetRNN", feature_scale=16)).to(dev)
        step = make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-2), "BCEDiceLoss",
                               False, augment="none")
        before = (dict(bn.LAUNCHES), df.LAUNCHES)
        metrics[dev] = step(imgs.to(dev), masks.to(dev), torch.Generator(device=dev))
        if dev == "cuda":
            assert {k: bn.LAUNCHES[k] - before[0][k] for k in bn.LAUNCHES} == {
                "bn_stats": 15, "bn_bwd_reduce": 15, "bn_bwd_dx": 15, "bn_finish": 0}
            assert df.LAUNCHES == before[1]
        models[dev] = m
    assert abs(float(metrics["cuda"]["loss"]) - float(metrics["cpu"]["loss"])) <= 1e-5
    grads = {n: p.grad for n, p in models["cpu"].named_parameters()}
    for name, p in models["cuda"].named_parameters():
        want = grads[name]
        scale = max(want.norm(), grads[name.rsplit(".", 1)[0] + ".weight"].norm())
        assert (p.grad.cpu() - want).norm() <= 1e-4 * scale, name
    cpu_bufs = dict(models["cpu"].named_buffers())
    for name, b in models["cuda"].named_buffers():
        torch.testing.assert_close(b.cpu(), cpu_bufs[name], atol=1e-5, rtol=1e-5)


def test_unet_runs_k4_at_its_four_decoder_nodes(cuda):
    """UNet launches K4 once per decoder node: 4 per forward, served or
    trained, and its 18 BN layers run K1-K3 in a train step."""
    kw = {"arch_kwargs": {"nb_filter": NARROW}, "batch_size": 2}
    pred = Predictor("UNet", device="cuda", **kw)
    before = df.LAUNCHES
    out = pred.predict_u8(np.zeros((3, 32, 32, 3), np.uint8))
    assert df.LAUNCHES - before == 4 * 2 and np.isfinite(out).all()
    m = pred.model
    step = make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-2), "BCEDiceLoss",
                           False, augment="none")
    before = (dict(bn.LAUNCHES), df.LAUNCHES)
    imgs = torch.zeros(2, 32, 32, 3, dtype=torch.uint8, device=cuda)
    step(imgs, imgs[..., :1], torch.Generator(device=cuda))
    assert df.LAUNCHES - before[1] == 4
    assert {k: bn.LAUNCHES[k] - before[0][k] for k in bn.LAUNCHES} == {
        "bn_stats": 18, "bn_bwd_reduce": 18, "bn_bwd_dx": 18, "bn_finish": 0}


def test_folder_cli_trains_an_epoch_with_the_expected_launches(cuda, tmp_path):
    """The image library builds on the card's host and round-trips a 96x96
    PNG; train.main runs 1 epoch on a 40-image folder (seed-41 split: 32
    train, 8 val), launching each BN kernel 30 times per step (2 steps) and
    K4 10 times per forward (2 steps and 1 padded val batch)."""
    from pytorch_nested_unet_tpu_torch import train
    from pytorch_nested_unet_tpu_torch.data import image_io

    rng = np.random.default_rng(0)
    base = tmp_path / "inputs" / "folder"
    (base / "images").mkdir(parents=True)
    (base / "masks" / "0").mkdir(parents=True)
    for i in range(40):
        img = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
        mask = (rng.random((96, 96)) > 0.5).astype(np.uint8) * 255
        image_io.write_png(str(base / "images" / f"{i:02d}.png"), img)
        image_io.write_png(str(base / "masks" / "0" / f"{i:02d}.png"), mask)
        if i == 0:
            np.testing.assert_array_equal(image_io.load_image(str(base / "images" / "00.png")),
                                          img)
    before = (dict(bn.LAUNCHES), df.LAUNCHES)
    r = train.main(["--dataset", "folder", "--data_dir", str(tmp_path / "inputs"),
                    "--output_dir", str(tmp_path / "models"), "--epochs", "1",
                    "--deep_supervision", "true", "--arch_kwargs",
                    '{"nb_filter": [4, 8, 16, 32, 64]}', "--device", "cuda"])
    assert {k: bn.LAUNCHES[k] - before[0][k] for k in bn.LAUNCHES} == {
        "bn_stats": 60, "bn_bwd_reduce": 60, "bn_bwd_dx": 60, "bn_finish": 0}
    assert df.LAUNCHES - before[1] == 30
    assert len(r["log"]["loss"]) == 1 and np.isfinite(r["log"]["loss"][0])
    for f in ("config.yml", "log.csv", "model.pth", "last.pth"):
        assert (tmp_path / "models" / "folder_NestedUNet_wDS" / f).is_file()


@pytest.mark.parametrize("arch,kw", [("AttU_Net", {"filters": NARROW}),
                                     ("Comprehensive_Atten_Unet", {"feature_scale": 16})])
def test_attention_archs_serve_on_the_card_like_the_cpu(cuda, arch, kw):
    """Narrow AttU_Net and CA-Net (its dropout on, as trained) served on the
    card against the same weights on the CPU within 1e-4, and one bf16 train
    step on the card: no kernel launched (plain BN, no decoder-fusion node)."""
    images = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    gpu = Predictor(arch, device="cuda", batch_size=2, arch_kwargs=kw)
    before = (dict(bn.LAUNCHES), df.LAUNCHES)
    out = gpu.predict_u8(images)
    sd = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    ref = Predictor(arch, device="cpu", batch_size=2, arch_kwargs=kw,
                    weights=sd).predict_u8(images)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    m = create_model(arch, dtype=torch.bfloat16, **kw).to(cuda)
    step = make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-2), "BCEDiceLoss",
                           False, augment="full")
    imgs = torch.from_numpy(images[:2]).to(cuda)
    loss = step(imgs, imgs[..., :1], torch.Generator(device=cuda))["loss"]
    assert torch.isfinite(loss)
    assert (dict(bn.LAUNCHES), df.LAUNCHES) == before


def test_train_step_is_bitwise_repeatable_under_deterministic_algorithms(cuda, monkeypatch):
    """Under torch.use_deterministic_algorithms(True) the narrow NestedUNet
    wDS fp32 step runs on the card (the bilinear upsample's gradient is
    the port's matmul adjoint; F.interpolate's backward adds with atomics
    and torch refuses it in that mode) and gives the same loss, gradients
    and running statistics bit for bit on every run."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    g = torch.Generator().manual_seed(4)
    imgs = torch.randint(0, 256, (4, 32, 32, 3), generator=g, dtype=torch.uint8).to(cuda)
    masks = (torch.rand(4, 32, 32, 1, generator=g) > 0.6).to(torch.uint8).mul(255).to(cuda)

    def run():
        m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW,
                         generator=torch.Generator().manual_seed(3)).to(cuda)
        opt = build_optimizer(m.parameters(), "SGD", 1e-2, 0.9, 1e-4)
        loss = make_train_step(m, opt, "BCEDiceLoss", True, "none")(
            imgs, masks, torch.Generator(cuda).manual_seed(0))["loss"]
        return [loss.detach().cpu()] + [t.detach().cpu() for t in
                                        [*(p.grad for p in m.parameters()), *m.buffers()]]

    torch.use_deterministic_algorithms(True)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        first, second = run(), run()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = was
    assert all(torch.equal(a, b) for a, b in zip(first, second))


_MODEL_AXIS_WORKER = """
import sys
import torch
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.parallel import initialize_distributed, make_mesh
from pytorch_nested_unet_tpu_torch.parallel.mesh import full_weights, tensor_parallel_of
from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer, state_bytes

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", rank)
torch.cuda.set_device(dev)
initialize_distributed(backend="nccl", device=dev, world_size=2, rank=rank,
                       init_method=f"tcp://127.0.0.1:{port}")
m = create_model("NestedUNet", 1, 3, True, nb_filter=(4, 8, 16, 32, 64),
                 generator=torch.Generator().manual_seed(3)).to(dev)
opt = build_optimizer(m.parameters(), "SGD", 1e-2, 0.9, 1e-4)
mesh = make_mesh((2,), ("model",))
mesh.min_shardable = 512
step = make_train_step(m, opt, "BCEDiceLoss", True, "none", mesh)
g = torch.Generator().manual_seed(4)
imgs = torch.randint(0, 256, (4, 32, 32, 3), generator=g, dtype=torch.uint8).to(dev)
masks = (torch.rand(4, 32, 32, 1, generator=g) > 0.6).to(torch.uint8).mul(255).to(dev)
loss = step(imgs, masks, torch.Generator(dev).manual_seed(0))["loss"].item()
tp = tensor_parallel_of(m)
nbytes = state_bytes(m, opt)
with full_weights(m):
    params = {n: p.detach().cpu() for n, p in m.named_parameters()}
for _ in range(2):
    step(imgs, masks, torch.Generator(dev).manual_seed(0))
with full_weights(m):
    later = {n: t.detach().cpu() for n, t in [*m.named_parameters(), *m.named_buffers()]}
torch.save({"loss": loss, "params": params, "sharded": len(tp.shards), "bytes": nbytes,
            "later": later}, out)
torch.distributed.destroy_process_group()
"""


def test_model_axis_on_two_cards_matches_one_card(cuda, tmp_path):
    """The narrow NestedUNet wDS step under a 'model' = 2 mesh over NCCL, a
    card a rank (each rank all 4 rows, its slices of the deeper kernels and
    their momentum), against the step without a mesh on the first card:
    loss within 1e-5 and every updated parameter within 1e-5 (the card's
    step adds some gradients with atomics, so not bitwise); each rank holds
    fewer bytes of state than the whole; after two more steps both ranks
    hold bitwise the same parameters and running statistics."""
    import os
    import socket
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _MODEL_AXIS_WORKER, str(r), str(port),
                               str(tmp_path / f"r{r}.pt")], env=env, cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW,
                     generator=torch.Generator().manual_seed(3)).to(cuda)
    opt = build_optimizer(m.parameters(), "SGD", 1e-2, 0.9, 1e-4)
    g = torch.Generator().manual_seed(4)
    imgs = torch.randint(0, 256, (4, 32, 32, 3), generator=g, dtype=torch.uint8).to(cuda)
    masks = (torch.rand(4, 32, 32, 1, generator=g) > 0.6).to(torch.uint8).mul(255).to(cuda)
    loss = make_train_step(m, opt, "BCEDiceLoss", True, "none")(
        imgs, masks, torch.Generator(cuda).manual_seed(0))["loss"].item()
    whole = 8 * sum(p.numel() for p in m.parameters())
    for r in range(2):
        got = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        assert got["sharded"] > 0 and got["bytes"] < whole
        assert abs(got["loss"] - loss) <= 1e-5
        for n, p in m.named_parameters():
            np.testing.assert_allclose(got["params"][n].numpy(), p.detach().cpu().numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=n)
    later = [torch.load(tmp_path / f"r{r}.pt", weights_only=False)["later"] for r in range(2)]
    for n, t in later[0].items():
        assert torch.equal(t, later[1][n]), n
