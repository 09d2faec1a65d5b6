"""Serving entry point of the port (counterpart of infer.py at the repo root).

`Predictor` answers requests of uint8 NHWC images the way infer.py serves a
capsule: fixed-size batches with the short one padded, so every batch has one
shape; each batch is timed from the host-to-device copy to the end of the
device-to-host copy; `summary()` gives the steady-state p50/p95 per batch and
img/s, with the first batch reported apart.

    python -m pytorch_nested_unet_tpu_torch.infer --input images.npy \
        --output probs.npy [--weights model.pth] [--deep_supervision true] \
        [--precision bf16] [--batch_size 16] [--device cuda]

reads a (N,H,W,3) uint8 `.npy` and writes (N,H,W,num_classes) float32
probabilities. Image decoding, capsule loading and --refine wait for the data
and CLI slices (ROADMAP.md queue 1).
"""

import argparse
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

from .models import create_model
from .training.loop import make_predict_fn
from .utils.convert import load_reference_pth
from .utils.device import resolve_device

PRECISIONS = {"fp32": None, "bf16": torch.bfloat16}


class Predictor:
    """A model on one device, answering `predict_u8` requests in fixed batches.

    weights: None (random init from `seed`), a path to a reference-layout
    `model.pth`, or a state dict; loaded strict. arch_kwargs go to the model
    constructor (e.g. nb_filter).
    """

    def __init__(self, arch: str = "NestedUNet", num_classes: int = 1,
                 input_channels: int = 3, deep_supervision: bool = False,
                 precision: str = "fp32", batch_size: int = 16, weights=None,
                 seed: int = 0, device="cuda", arch_kwargs: Optional[Mapping] = None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.num_classes = int(num_classes)
        model = create_model(arch, num_classes, input_channels, deep_supervision,
                             dtype=PRECISIONS[precision],
                             generator=torch.Generator().manual_seed(seed),
                             **dict(arch_kwargs or {}))
        if weights is not None:
            if isinstance(weights, (str, os.PathLike)):
                weights = load_reference_pth(weights)
            model.load_state_dict(weights, strict=True)
        self.model = model.to(self.device)
        self._predict = make_predict_fn(self.model)
        self.latencies = []   # seconds per batch, in order
        self.images = 0       # real (unpadded) images answered

    def predict_u8(self, images: np.ndarray) -> np.ndarray:
        """(N,H,W,C) uint8 -> (N,H,W,num_classes) float32 probabilities."""
        images = np.asarray(images)
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"expected (N,H,W,C) uint8 images, got "
                             f"{images.dtype} {images.shape}")
        b = self.batch_size
        outs = []
        for s in range(0, len(images), b):
            chunk = images[s:s + b]
            valid = len(chunk)
            if valid < b:  # pad: one shape for every batch
                chunk = np.concatenate(
                    [chunk, np.zeros((b - valid, *chunk.shape[1:]), chunk.dtype)])
            t0 = time.perf_counter()
            probs = self._predict(torch.from_numpy(chunk).to(self.device))
            probs = probs.cpu().numpy()  # the device-to-host copy ends the timing
            self.latencies.append(time.perf_counter() - t0)
            self.images += valid
            outs.append(probs[:valid])
        if not outs:
            return np.zeros((0, *images.shape[1:3], self.num_classes), np.float32)
        return np.concatenate(outs)

    def summary(self) -> dict:
        """Steady-state p50/p95 ms per batch (first batch apart) and img/s over
        every batch, as infer.py reports them."""
        if not self.latencies:
            raise RuntimeError("no batch answered yet")
        lat = self.latencies
        steady = sorted(t * 1e3 for t in (lat[1:] if len(lat) > 1 else lat))
        return {"batches": len(lat), "batch_size": self.batch_size,
                "p50_ms": steady[len(steady) // 2],
                "p95_ms": steady[min(len(steady) - 1, int(len(steady) * 0.95))],
                "img_per_s": self.images / sum(lat),
                "first_batch_ms": lat[0] * 1e3}


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="(N,H,W,C) uint8 .npy")
    p.add_argument("--output", required=True, help="probabilities .npy to write")
    p.add_argument("--weights", default=None, help="reference-layout model.pth")
    p.add_argument("--arch", default="NestedUNet")
    p.add_argument("--num_classes", default=1, type=int)
    p.add_argument("--input_channels", default=3, type=int)
    p.add_argument("--deep_supervision", default=False, type=_str2bool)
    p.add_argument("--precision", default="fp32", choices=sorted(PRECISIONS))
    p.add_argument("-b", "--batch_size", default=16, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    predictor = Predictor(args.arch, args.num_classes, args.input_channels,
                          args.deep_supervision, args.precision, args.batch_size,
                          weights=args.weights, seed=args.seed, device=args.device)
    probs = predictor.predict_u8(np.load(args.input))
    np.save(args.output, probs)
    s = predictor.summary()
    print(f"{len(probs)} images -> {args.output}")
    print(f"batches {s['batches']} x {s['batch_size']}: steady-state p50 "
          f"{s['p50_ms']:.1f} ms, p95 {s['p95_ms']:.1f} ms, {s['img_per_s']:.1f} "
          f"img/s end-to-end (first batch {s['first_batch_ms']:.0f} ms) on "
          f"{predictor.device}")
    return s


if __name__ == "__main__":
    main()
