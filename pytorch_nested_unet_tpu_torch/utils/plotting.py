"""Training curves from a run's log.csv (counterpart of utils/plotting.py;
reference Ploting.py:20-69).

`plot_data(path)` draws the train and validation loss and IoU (and accuracy
when the log has it) against the epoch and saves them as PNGs beside the csv
(loss.png, iou.png, acc.png), headless (matplotlib's Agg backend), on every
`every`-th row (the reference samples every 10th, Ploting.py:57).
matplotlib is imported inside `plot_data` only: nothing else of the port
needs it.
"""

import csv
import os
from typing import Dict, List, Optional


def read_log(path: str, every: int = 1) -> Dict[str, List[float]]:
    """The columns of a log.csv as floats, from every `every`-th row."""
    cols: Dict[str, List[float]] = {}
    with open(path, "r") as f:
        for i, row in enumerate(csv.DictReader(f)):
            if (i + 1) % every:
                continue
            for k, v in row.items():
                cols.setdefault(k, []).append(float(v))
    return cols


def _plot_pair(plt, epochs, y1, y2, ylabel, labels, out_path):
    fig = plt.figure()
    plt.plot(epochs, y1, color="red", marker="|", label=labels[0])
    plt.plot(epochs, y2, color="blue", marker="|", label=labels[1])
    plt.xlabel("epoch")
    plt.ylabel(ylabel)
    plt.legend()
    plt.title(f"{ylabel}_result")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_data(path: str, every: int = 10, out_dir: Optional[str] = None,
              show: bool = False) -> List[str]:
    """Plot the loss / IoU (and acc if logged) curves of a run's log.csv
    (reference Ploting.py:39-63) into out_dir (default: the csv's
    directory). Returns the written PNG paths."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = read_log(path, every=max(1, every))
    out_dir = out_dir or os.path.dirname(os.path.abspath(path))
    epochs = [int(e) for e in cols["epoch"]]
    written = [
        _plot_pair(plt, epochs, cols["loss"], cols["val_loss"], "Loss",
                   ("train_loss", "val_loss"), os.path.join(out_dir, "loss.png")),
        _plot_pair(plt, epochs, cols["iou"], cols["val_iou"], "iou",
                   ("train_iou", "val_iou"), os.path.join(out_dir, "iou.png"))]
    if "acc" in cols and "val_acc" in cols:
        written.append(_plot_pair(plt, epochs, cols["acc"], cols["val_acc"], "acc",
                                  ("train_acc", "val_acc"), os.path.join(out_dir, "acc.png")))
    if show:
        plt.show()
    return written
