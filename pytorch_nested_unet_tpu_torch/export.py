"""Export CLI of the port: trained capsule -> one self-contained serving
artifact (counterpart of export.py at the repo root).

    python -m pytorch_nested_unet_tpu_torch.export --name dsb2018_96_NestedUNet_wDS
    python -m pytorch_nested_unet_tpu_torch.infer --artifact \
        models/dsb2018_96_NestedUNet_wDS/serving/dsb2018_96_NestedUNet_wDS.pt2 \
        --input_dir new_images/

`torch.export` traces the eval forward (the eval transform, the model, the
sigmoid of the last head) with the trained weights inside the program and
saves it as models/<name>/serving/<name>.pt2 beside <name>.manifest.json
(serving.py). The serving host needs no model code, no checkpoint and no
arch registry. The batch dimension is symbolic unless --batch pins it;
--platforms lists the devices the artifact may be loaded on (cuda, cpu);
--device is the one the trace and the check run on.

`--check true` (default) reloads the artifact and compares a seeded uint8
batch with the live `Predictor` of the capsule: within 1e-5 in fp32 and
2e-2 in bf16.
"""

import argparse
import os

import numpy as np

from .models import PRECISIONS
from .utils.config import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", required=True, help="capsule name (models/<name>)")
    p.add_argument("--output_dir", default="models")
    p.add_argument("--out", default=None,
                   help="artifact path (default: models/<name>/serving/<name>.pt2)")
    p.add_argument("--batch", default=None, type=int,
                   help="pin the batch dimension to this size; default exports a symbolic "
                        "batch: one artifact serves any batch size")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma list of the devices the artifact may be loaded on (cuda, cpu)")
    p.add_argument("--precision", default=None, choices=sorted(PRECISIONS),
                   help="compute precision baked into the artifact (default: the capsule's)")
    p.add_argument("--check", default=True, type=str2bool,
                   help="reload the artifact and compare a seeded batch with the live model")
    p.add_argument("--device", default="cuda", help="device of the trace and the check")
    return vars(p.parse_args(argv))


def main(argv=None) -> str:
    args = parse_args(argv)
    from .serving import export_capsule

    model_dir = os.path.join(args["output_dir"], args["name"])
    platforms = tuple(s.strip() for s in args["platforms"].split(",") if s.strip())
    out_path, manifest = export_capsule(model_dir, out_path=args["out"], batch=args["batch"],
                                        platforms=platforms, precision=args["precision"],
                                        device=args["device"])
    print(f"exported {manifest['arch']} ({manifest['name']}) -> {out_path}")
    print(f"  input  uint8 [{manifest['batch']}, {manifest['input_h']}, "
          f"{manifest['input_w']}, {manifest['input_channels']}]  "
          f"platforms {','.join(manifest['platforms'])}  "
          f"{manifest['artifact_bytes'] / 1e6:.1f} MB")

    if args["check"]:
        from .infer import Predictor

        b = args["batch"] or 2
        artifact, _ = Predictor.from_artifact(out_path, b, args["device"])
        live, config = Predictor.from_capsule(model_dir, args["precision"], b, args["device"])
        images = np.random.default_rng(0).integers(
            0, 255, (b, manifest["input_h"], manifest["input_w"], manifest["input_channels"]),
            dtype=np.uint8)
        got, want = artifact.predict_u8(images), live.predict_u8(images)
        precision = args["precision"] or config.get("precision") or "fp32"
        tol = 2e-2 if precision == "bf16" else 1e-5
        err = float(np.abs(got - want).max())
        if not err <= tol:
            raise SystemExit(f"round-trip check FAILED: max abs diff {err:.2e} > {tol}")
        print(f"  round-trip check ok (batch {b}, max abs diff {err:.2e})")
    return out_path


if __name__ == "__main__":
    main()
