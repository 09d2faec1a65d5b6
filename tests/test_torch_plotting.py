"""The port's plot utilities (utils/plotting.py, plot) against the JAX
package's (utils/plotting.py, plot.py) on a log.csv the port's trainer
writes."""

import os
import subprocess
import sys

import numpy as np
import pytest

import plot as jax_plot
from pytorch_nested_unet_tpu.utils import plotting as jax_plotting
from pytorch_nested_unet_tpu_torch import plot as pplot
from pytorch_nested_unet_tpu_torch import train as ptrain
from pytorch_nested_unet_tpu_torch.utils import plotting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_log(path, log_acc, epochs=23):
    """A log.csv as the port's epoch loop writes it (train._write_log)."""
    cols = ptrain._log_cols(log_acc)
    rng = np.random.default_rng(0)
    log = {k: (list(range(epochs)) if k == "epoch" else list(rng.random(epochs)))
           for k in cols}
    ptrain._write_log(str(path), log, cols)
    return log


@pytest.mark.parametrize("log_acc", [False, True])
@pytest.mark.parametrize("every", [1, 10])
def test_read_log_and_pngs_match_jax(tmp_path, log_acc, every):
    log = _port_log(tmp_path / "log.csv", log_acc)
    cols = plotting.read_log(str(tmp_path / "log.csv"), every)
    assert cols == jax_plotting.read_log(str(tmp_path / "log.csv"), every)
    assert cols["epoch"] == [float(e) for e in log["epoch"][every - 1::every]]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    written = plotting.plot_data(str(tmp_path / "log.csv"), every, str(port_dir))
    want = jax_plotting.plot_data(str(tmp_path / "log.csv"), every, str(jax_dir))
    assert [os.path.basename(p) for p in written] == [os.path.basename(p) for p in want] == (
        ["loss.png", "iou.png"] + (["acc.png"] if log_acc else []))
    for p in written:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    _port_log(tmp_path / "log.csv", log_acc=False)
    pplot.main([str(tmp_path / "log.csv"), "--every", "5"])
    port = capsys.readouterr().out
    jax_plot.main([str(tmp_path / "log.csv"), "--every", "5"])
    assert port == capsys.readouterr().out == "".join(
        f"{tmp_path / name}\n" for name in ("loss.png", "iou.png"))


def test_matplotlib_is_imported_by_plot_data_only():
    code = ("import sys\n"
            "import pytorch_nested_unet_tpu_torch.plot\n"
            "print('matplotlib' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
