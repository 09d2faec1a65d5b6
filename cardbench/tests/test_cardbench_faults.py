"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct.

Each run is a CPU rehearsal (the look for a card skipped) at the tests' size,
in a process of its own whose `sitecustomize` plants the fault in the port
(rank processes inherit it), held to the limits set for this size
(conftest.CPU_LIMITS); each fault reads far outside them. The exchange
between cards is left out of a data-parallel run of two ranks over Gloo.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from cardbench.lib import spec
from conftest import CPU_LIMITS

FAULTS = {
    "state_unchanged": """
        from pytorch_nested_unet_tpu_torch.training import optim
        optim.Optimizer.step = lambda self: None
    """,
    "half_batch": """
        from pytorch_nested_unet_tpu_torch.training import loop
        whole = loop.augment_batch
        def half(images, masks, ops, generator, shard=None):
            h = images.shape[0] // 2
            return whole(images[:h], masks[:h], ops, generator, shard)
        loop.augment_batch = half
    """,
    "no_exchange": """
        from pytorch_nested_unet_tpu_torch.parallel import mesh
        from pytorch_nested_unet_tpu_torch.training import optim
        optim.all_reduce_mean_ = lambda tensors, m: None
        mesh.sync_batch_norm = lambda module, m: None
    """,
    "answer_altered": """
        from pytorch_nested_unet_tpu_torch import infer
        served = infer.Predictor.predict_u8
        def altered(self, images):
            out = served(self, images)
            out[0, 0, 0, 0] = 1.0 - out[0, 0, 0, 0]
            return out
        infer.Predictor.predict_u8 = altered
    """,
    "half_answers": """
        from pytorch_nested_unet_tpu_torch import infer
        served = infer.Predictor.predict_u8
        def half(self, images):
            out = served(self, images)
            out[len(out) // 2:] = 0.0
            return out
        infer.Predictor.predict_u8 = half
    """,
}

RUN = """
import json, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import torch
from conftest import tiny
from cardbench import run
cell = tiny({cell!r}, **{traffic!r})
cell.limits = {limits!r}
sys.exit(run.main(["--workload", cell.name, "--seed", "2600000017", "--seconds", "0.3",
                   "--trace", "0"], device=torch.device("cpu"), cell=cell))
"""


def rehearse(tmp_path, cell, fault=None, **traffic):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    if fault:
        (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(FAULTS[fault]))
        env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), spec.REPO,
                                             env.get("PYTHONPATH", "")])
    kind = spec.resolve(cell).kind
    code = RUN.format(repo=spec.REPO, tests=os.path.dirname(__file__), cell=cell,
                      traffic=traffic, limits=CPU_LIMITS[kind])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=spec.REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


CASES = [("NestedUNet_wDS.train.b128", None, {}),
         ("NestedUNet_wDS.train.b128", "state_unchanged", {}),
         ("NestedUNet_wDS.train.b128", "half_batch", {}),
         ("NestedUNet_wDS.train.b128", None, {"data_parallel": 2, "batch": 4}),
         ("NestedUNet_wDS.train.b128", "no_exchange", {"data_parallel": 2, "batch": 4}),
         ("NestedUNet_wDS.serve.b128", None, {}),
         ("NestedUNet_wDS.serve.b128", "answer_altered", {}),
         ("NestedUNet_wDS.serve.b128", "half_answers", {}),
         ("NestedUNet_wDS.serve.b128.r28", None, {}),
         ("NestedUNet_wDS.serve.b128.r28", "answer_altered", {}),
         ("VGG16RNN.train.b128", None, {}),
         ("VGG16RNN.train.b128", "state_unchanged", {}),
         ("VGG16RNN.train.b128", "half_batch", {})]


@pytest.mark.parametrize("cell,fault,traffic", CASES,
                         ids=[f"{c}-{t.get('data_parallel', 1)}-{f or 'sound'}"
                              for c, f, t in CASES])
def test_fault_comes_out_not_correct(tmp_path, cell, fault, traffic):
    result = rehearse(tmp_path, cell, fault, **traffic)
    assert result["correct"] is (fault is None), result["checks"]
