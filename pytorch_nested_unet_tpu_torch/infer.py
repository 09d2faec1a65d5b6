"""Serving entry point of the port (counterpart of infer.py at the repo root).

`Predictor` answers requests of uint8 NHWC images the way infer.py serves a
capsule: fixed-size batches with the short one padded, so every batch has one
shape; each batch is timed from the host-to-device copy to the end of the
device-to-host copy; `summary()` gives the steady-state p50/p95 per batch and
img/s, with the first batch reported apart.

Serving a capsule on a directory of images:

    python -m pytorch_nested_unet_tpu_torch.infer --name dsb2018_96_NestedUNet_wDS \
        --input_dir new_images/ [--output_dir models] [--save_dir outputs] \
        [--img_ext .png] [-b 16] [--threshold 0.5] [--full_res true] \
        [--out_ext .png|.jpg] [--precision bf16|fp32] [--device cuda] \
        [--refine true [--refine_weights PTH] [--refine_L 900] [--refine_fast true] \
         [--refine_tile_batch K]]

loads models/<name>/{config.yml, model.pth} (in the capsule's precision
unless --precision says otherwise), decodes and resizes one batch of images
at a time (an unreadable image is skipped with a warning), and writes one
mask per image and class to <save_dir>/<name>/<c>/<id><out_ext>: the
probability x255, resized back to the image's own size with --full_res true,
thresholded to 0/255 (after that resize) with --threshold >= 0. It prints the
steady-state p50/p95 ms per batch and img/s, the first batch apart (the
model's batches; refinement is not in them). `--refine true` refines each
class mask with CascadePSP (refinement/refiner.py: the released weights
from --refine_weights, .pth or .npz, or a random init) on the resized image
before --full_res and --threshold: the global pass alone with --refine_fast
true (the default), else the global pass and the tiled local pass, at a
longer side of --refine_L, --refine_tile_batch tiles per forward. The
refinement runs in float32 on the model's device whatever --precision
says.

Serving arrays:

    python -m pytorch_nested_unet_tpu_torch.infer --input images.npy \
        --output probs.npy [--weights model.pth] [--arch NestedUNet] \
        [--arch_kwargs JSON] [--deep_supervision true] [--precision fp32] \
        [--batch_size 16] [--device cuda]

reads a (N,H,W,C) uint8 `.npy` and writes (N,H,W,num_classes) float32
probabilities, for any registered arch, refined as above with --refine true.

Serving an artifact (export.py) on a directory of images:

    python -m pytorch_nested_unet_tpu_torch.infer --artifact \
        models/<name>/serving/<name>.pt2 --input_dir new_images/ [...as above]

loads the exported program (serving.load_exported: no model code, no
registry, no checkpoint) and serves it as a capsule is served, with the
same batching, timing, masks and --refine; the name and the image size come
from its manifest, and an artifact that pins its batch overrides -b.
"""

import argparse
import glob
import os
import sys
import time
from typing import Mapping, Optional

import numpy as np
import torch

from .data import image_io
from .models import PRECISIONS, arch_names, create_model, parse_arch_kwargs
from .refinement import Refiner
from .training.loop import make_predict_fn
from .utils.config import str2bool
from .utils.convert import load_reference_pth
from .utils.device import resolve_device


class Predictor:
    """A model on one device, answering `predict_u8` requests in fixed batches.

    arch: any registered arch. weights: None (random init from `seed`), a
    path to a reference-layout `model.pth` (a CRDN checkpoint's gate convs of
    other decoders than the model's are dropped), or a state dict; loaded
    strict. arch_kwargs go to the model constructor (e.g. nb_filter,
    decoder); an option the arch does not have raises ValueError.
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
                             **parse_arch_kwargs(arch, arch_kwargs))
        if weights is not None:
            if isinstance(weights, (str, os.PathLike)):
                weights = load_reference_pth(weights, arch, getattr(model, "decoder", None),
                                             init=model.state_dict())
            model.load_state_dict(weights, strict=True)
        self._serve(model)

    def _serve(self, model):
        self.model = model.to(self.device)
        self._start(make_predict_fn(self.model))

    def _start(self, predict):
        self._predict = predict  # uint8 batch on the device -> probabilities there
        self.latencies = []   # seconds per batch, in order
        self.images = 0       # real (unpadded) images answered

    @classmethod
    def from_capsule(cls, model_dir: str, precision: Optional[str] = None,
                     batch_size: int = 16, device="cuda"):
        """A Predictor of the models/<name>/ capsule at model_dir (its
        config.yml and model.pth; precision None takes the capsule's).
        Returns (predictor, config)."""
        from .training.checkpoint import load_capsule

        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        model, config = load_capsule(model_dir, precision)
        self.batch_size = int(batch_size)
        self.num_classes = int(config["num_classes"])
        self._serve(model)
        return self, config

    @classmethod
    def from_artifact(cls, path: str, batch_size: int = 16, device="cuda"):
        """A Predictor of a serving artifact (serving.py; no model code, no
        checkpoint). An artifact that pins its batch serves that batch
        whatever `batch_size` says, with a message. Returns (predictor,
        manifest); `model` is None."""
        from .serving import load_exported

        self = cls.__new__(cls)
        self.device = resolve_device(device)
        predict, manifest = load_exported(path, self.device)
        pinned = manifest["batch"]
        if pinned != "dynamic" and batch_size != pinned:
            print(f"artifact pins batch={pinned}; overriding --batch_size {batch_size}")
            batch_size = int(pinned)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.model = None
        self.batch_size = int(batch_size)
        self.num_classes = int(manifest["num_classes"])
        self._start(predict)
        return self, manifest

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


def refine_masks(refiner: Refiner, images: np.ndarray, probs: np.ndarray, classes,
                 fast: bool, L: int) -> np.ndarray:
    """Refine probs[j, ..., c] for every image j and class c in `classes`, in
    place: CascadePSP on images[j] (uint8, HWC) and the mask uint8(prob x
    255), the result / 255 (reference main.py:59-81). Returns probs."""
    for j in range(len(probs)):
        for c in classes:
            refined = refiner.refine(images[j], (probs[j, :, :, c] * 255).astype(np.uint8),
                                     fast=fast, L=L)
            probs[j, :, :, c] = refined.astype(np.float32) / 255.0
    return probs


def add_refine_flags(p: argparse.ArgumentParser, fast_default: bool):
    """--refine and its options, as the JAX CLIs take them."""
    p.add_argument("--refine", default=False, type=str2bool,
                   help="refine each mask with CascadePSP (refinement/refiner.py)")
    p.add_argument("--refine_weights", default=None,
                   help="CascadePSP weights (.pth state dict or .npz); random init if omitted")
    p.add_argument("--refine_L", default=900, type=int,
                   help="the refinement's working size (longer side)")
    p.add_argument("--refine_fast", default=fast_default, type=str2bool,
                   help="global pass only; false adds the tiled local pass")
    p.add_argument("--refine_tile_batch", default=None, type=int,
                   help="tiles per forward in the local pass")


def make_refiner(args: dict, device) -> Optional[Refiner]:
    """The Refiner that --refine asks for (float32, on `device`), or None."""
    if not args["refine"]:
        return None
    return Refiner(model_path=args["refine_weights"], tile_batch=args["refine_tile_batch"],
                   device=device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", default=None, help="capsule name (models/<name>)")
    p.add_argument("--artifact", default=None,
                   help="serve a .pt2 serving artifact (export.py) instead of a capsule: no "
                        "model code or checkpoint; supersedes --name/--output_dir/--precision")
    p.add_argument("--input_dir", default=None,
                   help="directory of images (with --name or --artifact)")
    p.add_argument("--img_ext", default=None,
                   help="glob extension (default: the capsule's img_ext)")
    p.add_argument("--output_dir", default="models")
    p.add_argument("--save_dir", default="outputs")
    p.add_argument("--threshold", default=-1.0, type=float,
                   help=">= 0: write 0/255 masks at this probability (after any "
                        "--full_res resize); default: probabilities x255")
    p.add_argument("--full_res", default=False, type=str2bool,
                   help="resize each mask back to its image's own size")
    p.add_argument("--out_ext", default=".png", choices=[".png", ".jpg"])
    p.add_argument("--input", default=None, help="(N,H,W,C) uint8 .npy (array mode)")
    p.add_argument("--output", default=None, help="probabilities .npy to write")
    p.add_argument("--weights", default=None, help="reference-layout model.pth")
    p.add_argument("--arch", default="NestedUNet", choices=arch_names())
    p.add_argument("--arch_kwargs", default=None,
                   help="JSON object of the arch's constructor options")
    p.add_argument("--num_classes", default=1, type=int)
    p.add_argument("--input_channels", default=3, type=int)
    p.add_argument("--deep_supervision", default=False, type=str2bool)
    p.add_argument("--precision", default=None, choices=sorted(PRECISIONS),
                   help="compute precision (default: the capsule's; fp32 in array mode)")
    p.add_argument("-b", "--batch_size", default=16, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda")
    add_refine_flags(p, fast_default=True)
    return p.parse_args(argv)


def _print_summary(s, predictor, n, where):
    print(f"{n} -> {where}")
    print(f"batches {s['batches']} x {s['batch_size']}: steady-state p50 "
          f"{s['p50_ms']:.1f} ms, p95 {s['p95_ms']:.1f} ms, {s['img_per_s']:.1f} "
          f"img/s end-to-end (first batch {s['first_batch_ms']:.0f} ms) on "
          f"{predictor.device}")


def serve_folder(args) -> dict:
    """--name / --artifact mode: see the module docstring. Returns the
    Predictor's summary with `written` (mask files) and `unreadable` (images
    skipped)."""
    if args.artifact:
        predictor, config = Predictor.from_artifact(args.artifact, args.batch_size, args.device)
        args.name = args.name or config.get("name") or \
            os.path.splitext(os.path.basename(args.artifact))[0]
        args.batch_size = predictor.batch_size
    else:
        predictor, config = Predictor.from_capsule(
            os.path.join(args.output_dir, args.name), args.precision, args.batch_size,
            args.device)
    size_hw = (config["input_h"], config["input_w"])
    ext = args.img_ext or config.get("img_ext", ".png")
    paths = sorted(glob.glob(os.path.join(args.input_dir, f"*{ext}")))
    if not paths:
        sys.exit(f"no images found under {args.input_dir} (*{ext})")
    out_dirs = [os.path.join(args.save_dir, args.name, str(c))
                for c in range(config["num_classes"])]
    for d in out_dirs:
        os.makedirs(d, exist_ok=True)
    refiner = make_refiner(vars(args), predictor.device)

    written = unreadable = 0
    for s in range(0, len(paths), args.batch_size):
        chunk = paths[s:s + args.batch_size]  # one batch decoded at a time
        images, status, sizes = image_io.decode_batch(chunk, size_hw, 3)
        for p, code in zip(chunk, status):
            if code:
                print(f"warning: unreadable image skipped: {image_io.image_error(p, code)}")
        ok = np.flatnonzero(status == 0)
        unreadable += len(chunk) - len(ok)
        if not len(ok):
            continue
        probs = predictor.predict_u8(images[ok])
        if refiner is not None:  # before --full_res and --threshold
            refine_masks(refiner, images[ok], probs, range(config["num_classes"]),
                         args.refine_fast, args.refine_L)
        for j, i in enumerate(ok):
            img_id = os.path.splitext(os.path.basename(chunk[i]))[0]
            for c, d in enumerate(out_dirs):
                m = probs[j, ..., c]
                if args.full_res:
                    m = image_io.resize_prob(m, *sizes[i])
                if args.threshold >= 0:  # after the resize: truly binary output
                    m = (m >= args.threshold).astype(np.float32)
                image_io.write_image(os.path.join(d, img_id + args.out_ext),
                                     (m * 255).astype(np.uint8))
                written += 1
    if not predictor.latencies:
        sys.exit(f"no readable images among the {unreadable} matched under "
                 f"{args.input_dir}")
    summary = predictor.summary()
    _print_summary(summary, predictor, f"{written} masks",
                   os.path.join(args.save_dir, args.name))
    return {**summary, "written": written, "unreadable": unreadable}


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.name or args.artifact:
        if not args.input_dir:
            sys.exit("--name and --artifact need --input_dir")
        return serve_folder(args)
    if not (args.input and args.output):
        sys.exit("one of --name or --artifact is required (with --input_dir: images), or "
                 "--input and --output (.npy arrays)")
    predictor = Predictor(args.arch, args.num_classes, args.input_channels,
                          args.deep_supervision, args.precision or "fp32", args.batch_size,
                          weights=args.weights, seed=args.seed, device=args.device,
                          arch_kwargs=args.arch_kwargs)
    images = np.load(args.input)
    probs = predictor.predict_u8(images)
    refiner = make_refiner(vars(args), predictor.device)
    if refiner is not None:
        refine_masks(refiner, images, probs, range(args.num_classes), args.refine_fast,
                     args.refine_L)
    np.save(args.output, probs)
    s = predictor.summary()
    _print_summary(s, predictor, f"{len(probs)} images", args.output)
    return s


if __name__ == "__main__":
    main()
