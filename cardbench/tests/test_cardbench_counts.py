"""The work each configuration asks for, counted from its shapes."""

import pytest

from cardbench import counts, reference
from cardbench.lib import spec


def config(name):
    cell = next(w for w in spec.benchmark()["workloads"] if w["config"] == name)
    return spec.resolve(cell["name"]).config


@pytest.mark.parametrize("name,flops", [("NestedUNet_wDS", 9_700_835_328),
                                        ("VGG16RNN", 5_695_523_136)])
def test_forward_flops_per_image(name, flops):
    """torch.utils.flop_counter over the frozen reference at 96x96, batch 1:
    the count it gives on the port's CPU path."""
    cfg = config(name)
    assert counts.flops_per_image(cfg, train=False) == flops == cfg["forward_flops_per_image"]
    # the backward of every conv but the first layer's input: about twice more
    assert 2.9 < counts.flops_per_image(cfg, train=True) / flops < 3.0


def test_layers_and_nodes():
    nested, vgg = config("NestedUNet_wDS"), config("VGG16RNN")
    assert len(reference.module("NestedUNet").k4_nodes(nested, 128)) == 10
    assert len(reference.module("NestedUNet").bn_layers(nested, 128)) == 30
    assert reference.module("VGG16RNN").k4_nodes(vgg, 128) == []
    assert len(reference.module("VGG16RNN").bn_layers(vgg, 128)) == 18


def test_bounds_scale_with_the_batch_and_match_the_kernel_table():
    """At batch 16 the counts give the kernel table's bounds (PERF.md: K4 bf16
    0.1225 ms, K1 + K2 + K3 bf16 0.0455 + 0.0909 + 0.1363 ms, VGG16RNN's
    0.0239 + 0.0478 + 0.0717 ms); both are linear in the batch."""
    nested, vgg = config("NestedUNet_wDS"), config("VGG16RNN")
    assert counts.k4_bound_s(nested, 16) * 1e3 == pytest.approx(0.1225, rel=1e-3)
    assert counts.bn_bound_s_per_step(nested, 16) * 1e3 == pytest.approx(0.2727, rel=1e-3)
    assert counts.bn_bound_s_per_step(vgg, 16) * 1e3 == pytest.approx(0.1434, rel=1e-3)
    assert counts.k4_bound_s(vgg, 16) == 0
    assert counts.k4_bound_s(nested, 128) == pytest.approx(8 * counts.k4_bound_s(nested, 16),
                                                           rel=1e-3)
