"""The port's multi-process runs (parallel/multihost.py, train.py --mesh):
the one-process forms of the helpers, then the folder CLI over two OS
processes (a Gloo world on 127.0.0.1, the variables torchrun sets, 2
intra-op threads each), as the JAX package's tests/test_multihost.py runs
its train.py: `--mesh data=2` over 2 processes reproduces `--mesh data=1` in
one (the narrow UNet, 32x32, 2 epochs, augment full; loss rtol 2e-4 / atol
2e-5, IoU atol 0.02, the JAX test's bounds), rank 0 alone writes, and
`--resume` adopts rank 0's last.pth on every rank without a shared
filesystem."""

import os
import socket
import subprocess
import sys

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from pytorch_nested_unet_tpu_torch import train as ptrain
from pytorch_nested_unet_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = '{"nb_filter": [4, 8, 16, 32, 64]}'
CAPSULE = ("config.yml", "log.csv", "model.pth", "last.pth")


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_distributed() is False
    assert (multihost.process_index(), multihost.process_count(), multihost.local_rank()) == \
        (0, 1, 0)
    assert multihost.global_batch_slice(16) == (16, 0)
    x = torch.arange(6.0).reshape(3, 2)
    assert multihost.make_global_array(x) is x


def _write_set(root, seed, n=12):
    rng = np.random.default_rng(seed)
    img_dir, mask_dir = root / "synth" / "images", root / "synth" / "masks" / "0"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    yy, xx = np.mgrid[0:32, 0:32]
    for i in range(n):
        img = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
        cy, cx = rng.integers(10, 22, 2)
        mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < 25).astype(np.uint8) * 255
        img[mask > 0] = 220
        cv2.imwrite(str(img_dir / f"im{i:02d}.png"), img)
        cv2.imwrite(str(mask_dir / f"im{i:02d}.png"), mask)


def _args(tmp_path, out, extra):
    return ["--data_dir", str(tmp_path / "inputs"), "--output_dir", str(out),
            "--dataset", "synth", "--arch", "UNet", "--arch_kwargs", KW, "--name", "run",
            "--input_w", "32", "--input_h", "32", "--batch_size", "8", "--optimizer", "Adam",
            "--precision", "fp32", "--device", "cpu", *extra]


def _run_two(tmp_path, extra):
    """train.main over 2 processes, each with its own --output_dir (out0,
    out1: no shared filesystem); returns their outputs."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                       PYTHONPATH=ROOT)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pytorch_nested_unet_tpu_torch.train",
                 *_args(tmp_path, tmp_path / f"out{rank}", extra)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        # a hung collective (or a stolen port) must not leak live trainers
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return outs


@pytest.fixture
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("pipeline", ["device", "host"])
def test_two_process_training_matches_one_process(tmp_path, pipeline, threads):
    _write_set(tmp_path / "inputs", seed=3)
    extra = ["--epochs", "2", "--pipeline", pipeline]
    outs = _run_two(tmp_path, ["--mesh", "data=2", *extra])
    assert "multi-host: process 0/2" in outs[0] and "multi-host: process 1/2" in outs[1]
    assert "mesh: {'data': 2}" in outs[0]
    for f in CAPSULE:  # rank 0 alone writes
        assert (tmp_path / "out0" / "run" / f).is_file()
        assert not (tmp_path / "out1" / "run" / f).exists()

    # one process over the same global batches, on the collective path too
    ptrain.main(_args(tmp_path, tmp_path / "one", ["--mesh", "data=1", *extra]))
    a = pd.read_csv(tmp_path / "out0" / "run" / "log.csv")
    b = pd.read_csv(tmp_path / "one" / "run" / "log.csv")
    assert list(a["epoch"]) == list(b["epoch"]) == [0, 1]
    for col in ("loss", "val_loss"):
        np.testing.assert_allclose(a[col], b[col], rtol=2e-4, atol=2e-5, err_msg=col)
    # IoU thresholds the sigmoid at 0.5: an ulp of the reduction layout
    # flips the pixels that sit at the threshold of a barely trained model
    for col in ("iou", "val_iou"):
        np.testing.assert_allclose(a[col], b[col], atol=0.02, err_msg=col)


def test_resume_broadcasts_rank0_state(tmp_path, threads):
    """Only rank 0 has last.pth (the only writer, no shared filesystem): on
    --resume every rank adopts its state rather than starting at epoch 0,
    and an optimizer that does not match it stops every rank."""
    _write_set(tmp_path / "inputs", seed=5)
    _run_two(tmp_path, ["--epochs", "2"])
    assert (tmp_path / "out0" / "run" / "last.pth").is_file()
    assert not (tmp_path / "out1" / "run" / "last.pth").exists()
    outs = _run_two(tmp_path, ["--epochs", "3", "--resume", "true"])
    for rank, out in enumerate(outs):
        assert "resumed from epoch 1" in out, f"rank {rank}:\n{out[-2000:]}"
    log = pd.read_csv(tmp_path / "out0" / "run" / "log.csv")
    assert list(log["epoch"]) == [0, 1, 2]
    with pytest.raises(AssertionError, match="does not match the current optimizer"):
        _run_two(tmp_path, ["--epochs", "4", "--resume", "true", "--skip_nonfinite", "1"])
