"""The x=2 train steps of the attention nets held to the JAX package's
spatial step: AttU_Net and R2AttU_Net (filters (4, 8, 16, 32, 64), 32x32),
UNetRNNPAttention and UNetRNNCAttention (feature_scale 16, 64x32: PAM's
keys and values all-gathered from both bands, CAM's gram all-reduced over
them) and CA-Net (feature_scale 16, dropout 0). UNetRNNAttention's x=2
step stays in tests/test_torch_spatial.py beside its x=2,y=2 step.

tests/test_torch_spatial.py's cases, models, launch and gates
(`ts._hold_to_jax`: each momentum buffer within 1e-4 or 4x the largest
movement under the weight readings, these narrow steps being chaotic at
init; K1-K3's BN finishes counted), in a launch of 2 Gloo processes of
their own (this file run as a script is the worker), so that this family
runs on its own xdist worker under --dist loadfile.
"""

import sys

import pytest
import torch

import test_torch_spatial as ts

MODELS = ts.MODELS
CASES = {c: ts.ALL_CASES[c] for c in ts.FAMILIES["attention"]}
_SELF = sys.modules[__name__]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's torch work (see
    tests/test_torch_spatial.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return ts._family_ranks(tmp_path_factory, _SELF, __file__)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_x2_step_matches_the_jax_spatial_step(case, two_ranks):
    """The port's step under x=2 on 2 ranks (each its band, halos, BN over
    both bands: all-reduces for the plain BNs, K1's sums, bn_finish, K2 and
    K3 for the UNetRNN trunks' FusedBatchNormReLU; attention over the
    gathered keys and values) against the JAX package's GSPMD-partitioned
    step from the same weights and against its unpartitioned step, by
    `ts._hold_to_jax`."""
    ts._hold_to_jax(case, two_ranks, _SELF)


if __name__ == "__main__":
    ts._family_worker(_SELF, int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
