"""The 'x' mesh axis on thin and empty bands: the train steps of the archs
whose maps the bands do not divide evenly, against the JAX package.

Several OS processes over Gloo on 127.0.0.1 (this file run as a script is
the worker; tests/test_torch_spatial.py's launch, steps and gates through
their `t=` argument), one launch per world size:

- world 2 ('x' = 2): UNetRM7 (feature_scale 16, 64x64: its levels go 2 ->
  1 row, an empty band at the deepest), ResNet50FCN (one block a stage,
  48x48: the classifier's valid 3x3 makes 1 row of 3 at 1/16, an empty
  band, and the nearest resizes 1 -> 6 -> 12 -> 24 -> 48 cross the band
  edges; its channel dropouts at p = 0 on both sides) and DeepLab (one
  block a stage, 64x64: bands of 2 rows at 1/16 under layer4's dilations
  of 2 and ASPP's 6, 12 and 18; its element-wise dropouts at p = 0 on both
  sides) against the JAX package's GSPMD step
  and its unpartitioned step from the same weights, held by
  `_hold_to_jax` (1e-4, or 4x the largest movement under the weight
  readings: these steps are chaotic at init); DeepLab with its dropouts on
  against the port's one-process step, each band's masks the one-process
  masks cut to the band;
- world 4 ('x' = 4): the narrow NestedUNet wDS at 32x32 (2 rows at 1/16 over
  4 bands: two of them empty; K4 at every decoder node, K1-K3 at 30 BNs a
  step, an empty band's included) the same way.

`train --mesh x=2 --arch ResNet50FCN` as two processes against `--mesh
data=1` in one, the JAX CLI test's bounds (loss 3e-3, IoU 3e-2).
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

import test_torch_spatial as ts
from pytorch_nested_unet_tpu_torch.parallel.halo import cut

ONE_BLOCK = (1, 1, 1, 1)
# The models of the band steps (tests/test_torch_spatial.py's MODELS
# layout): (arch, both packages' create_model keywords, the input's (H, W)),
# named apart from that file's (its caches are keyed by name).
MODELS = {"NestedUNet_thin": ("NestedUNet", {"nb_filter": ts.NARROW}, (32, 32)),
          "UNetRM7_thin": ("UNetRM7", ts.CRDN, (64, 64)),
          "ResNet50FCN_thin": ("ResNet50FCN", {"layers": ONE_BLOCK}, (48, 48)),
          "DeepLab_thin": ("DeepLab", {"layers": ONE_BLOCK}, (64, 64)),
          "DeepLab_drop": ("DeepLab", {"layers": ONE_BLOCK}, (64, 64))}
X2, X4 = ts.X2, ((1, 4), ("data", "x"))
# The band steps (CASES layout): (model, deep supervision, --remat, the
# port's mesh, the JAX package's mesh (None: the port's one-process step
# only), BN finishes per step: NestedUNet's 30 and UNetRM7's 21
# FusedBatchNormReLU; the trunks' and heads' plain BNs finish none).
CASES = {"UNetRM7_x2_empty": ("UNetRM7_thin", False, "none", X2, X2, 21),
         "ResNet50FCN_x2": ("ResNet50FCN_thin", False, "none", X2, X2, 0),
         "DeepLab_x2": ("DeepLab_thin", False, "none", X2, X2, 0),
         "DeepLab_dropout_x2": ("DeepLab_drop", False, "none", X2, None, 0),
         "NestedUNet_x4_empty": ("NestedUNet_thin", True, "none", X4, X4, 30)}
# dropouts at p = 0 on both sides: the JAX package draws its masks from
# another generator (DeepLab's element-wise dropouts, ResNet50FCN's two
# channel dropouts in its classifier)
NO_DROPOUT = ("DeepLab_x2", "ResNet50FCN_x2")
_SELF = sys.modules[__name__]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's torch work (see
    tests/test_torch_spatial.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _dropouts_off(case, jax_too=False):
    """Under NO_DROPOUT: the port's DeepLab and ResNet50FCN built with p = 0
    dropouts (and flax's Dropout the identity), as
    tests/test_torch_dual_deeplab.py runs DeepLab against the JAX package."""
    if case not in NO_DROPOUT:
        yield
        return
    from pytorch_nested_unet_tpu_torch.models import crdn_backbones as tcb
    from pytorch_nested_unet_tpu_torch.models import dual_deeplab as tdl
    from pytorch_nested_unet_tpu_torch.ops.layers import ChannelDropout, Dropout

    real = tdl.Dropout, tcb.ChannelDropout
    tdl.Dropout = lambda p, generator=None: Dropout(0.0, generator)
    tcb.ChannelDropout = lambda p, generator=None: ChannelDropout(0.0, generator)
    patched = None
    if jax_too:
        import flax.linen as flax_nn

        patched = flax_nn.Dropout.__call__
        flax_nn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        yield
    finally:
        tdl.Dropout, tcb.ChannelDropout = real
        if patched is not None:
            flax_nn.Dropout.__call__ = patched


def _worker(world, rank, port, d):
    """Every case of a world of `world` ranks on this rank; writes
    out<world>_<rank>.pt, and rank 0 each case's arrays (<case>.pt)."""
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.parallel import initialize_distributed, make_mesh
    from test_torch_spatial_strided import _agree_with_rank0

    torch.set_num_threads(2)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank)
    inp = torch.load(os.path.join(d, "in.pt"), weights_only=False, mmap=True)
    out = {}
    for case, (*_, (sizes, names), _, _) in CASES.items():
        if int(np.prod(sizes)) != world:
            continue
        with _dropouts_off(case):
            got = ts._step_case(inp, case, make_mesh(sizes, names), _SELF)
        out[case] = {"metrics": got["metrics"], "agree": _agree_with_rank0(got),
                     "finish_calls": got["finish_calls"], "masks": got["masks"]}
        if rank == 0:
            torch.save(got, os.path.join(d, f"{case}.pt"))
    torch.save(out, os.path.join(d, f"out{world}_{rank}.pt"))
    dist.destroy_process_group()


def _ranks(tmp_path_factory, world):
    """The world's launch: (inputs, each rank's summary, the JAX side, the
    folder of rank 0's <case>.pt); the folder emptied at teardown."""
    d = tmp_path_factory.mktemp(f"thin{world}")
    inp = {}
    jax_side = ts._case_inputs(inp, world, _SELF)
    torch.save(inp, d / "in.pt")
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


def _rank0(ranks, case):
    """Every rank's step bitwise rank 0's and its loss and BN finishes the
    same; then rank 0's step, read from <case>.pt (removed)."""
    inp, outs, jax_side, d = ranks
    for o in outs:
        assert o[case]["agree"], f"{case}: a rank's step differs from rank 0's"
        assert o[case]["metrics"] == outs[0][case]["metrics"]
        assert o[case]["finish_calls"] == outs[0][case]["finish_calls"]
    got = torch.load(d / f"{case}.pt", weights_only=False)
    os.remove(d / f"{case}.pt")
    return inp, [{case: got}], jax_side


@pytest.mark.parametrize("case", ["UNetRM7_x2_empty", "ResNet50FCN_x2", "DeepLab_x2"])
def test_two_rank_thin_band_step_matches_the_jax_spatial_step(case, two_ranks):
    """The port's step under x=2 on 2 ranks, on bands that are empty
    (UNetRM7's 1-row level, ResNet50FCN's classifier output) or thinner than
    the windows their convs read (DeepLab's dilations at 1/16), against the
    JAX package's GSPMD step from the same weights and its unpartitioned
    step, held by `_hold_to_jax` (each momentum buffer within 1e-4 or 4x
    its largest reading), K1-K3's finishes counted (UNetRM7's 21)."""
    ranks = _rank0(two_ranks, case)
    with _dropouts_off(case, jax_too=True):
        ts._hold_to_jax(case, ranks, _SELF)


def test_two_rank_deeplab_dropout_step_matches_one_process(two_ranks):
    """DeepLab with its element-wise dropouts on (p = 0.1) under x=2: each
    band draws its data rows' whole mask from the generator every band
    shares and keeps its rows, so the bands' masks are the port's
    one-process step's cut to the band (the head's at 1/4, the auxiliary
    head's at 1/16); the step is held to that one-process step with the
    chaotic archs' gates (1e-4, or 4x its movement under the weight
    readings). The JAX package draws its masks from another generator."""
    case = "DeepLab_dropout_x2"
    outs = two_ranks[1]
    masks = {}
    one = ts._one_process_step(two_ranks[0], case, masks=masks, t=_SELF)
    assert sorted(masks) == ["head.auxlayer.dropout", "head.dropout"]
    for name, want in masks.items():
        assert len(want) == 1 and not want[0].all()
        c = cut(want[0].shape[1], 2)
        for rank, o in enumerate(outs):
            np.testing.assert_array_equal(o[case]["masks"][name][0],
                                          want[0][:, c[rank]:c[rank + 1]], err_msg=name)
    inp, ranks_out, _ = _rank0(two_ranks, case)
    gate = dict.fromkeys(one[1], 1e-4)
    for seed in ts.WEIGHT_READINGS:
        moved = ts._one_process_step(inp, case, seed, t=_SELF)
        gate = {n: max(g, 4 * ts._rel(moved[1], one[1], n)) for n, g in gate.items()}
    got = {k: ts._both(ranks_out, case, k) for k in ("metrics", "grads", "params", "stats",
                                                     "finish_calls")}
    ts._hold_step(got, *one, 0, f"{case} against the port's one-process step", gate)


def test_four_rank_nested_unet_on_empty_bands_matches_the_jax_spatial_step(four_ranks):
    """The narrow NestedUNet wDS under x=4 at 32x32 (its 2 rows at 1/16 cut
    0/1/0/1: two empty bands there; 8 rows at 1/4) against the JAX
    package's spatial step on 4 of its virtual CPU devices and its
    unpartitioned step, held by `_hold_to_jax`; its 30 BNs finish once
    each on every rank, the empty bands' K1-K3 (their plain versions here)
    included."""
    ts._hold_to_jax("NestedUNet_x4_empty", _rank0(four_ranks, "NestedUNet_x4_empty"), _SELF)


def test_train_cli_mesh_x2_resnet50fcn_two_processes_matches_one_process(tmp_path):
    """`train --mesh x=2 --arch ResNet50FCN` as two processes (one block a
    stage, 48x48: the classifier's 1 row at 1/16 leaves an empty band, the
    nearest resizes cross band edges) trains an epoch, and rank 0's log.csv
    matches `--mesh data=1` in one process within the JAX CLI test's bounds
    (loss and val_loss 3e-3, IoU 3e-2)."""
    import pandas as pd

    from pytorch_nested_unet_tpu_torch import train as ptrain
    from test_torch_multihost import _args, _run_two, _write_set

    extra = ["--arch", "ResNet50FCN", "--arch_kwargs", '{"layers": [1, 1, 1, 1]}',
             "--input_w", "48", "--input_h", "48", "--epochs", "1"]
    _write_set(tmp_path / "inputs", seed=9)
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
