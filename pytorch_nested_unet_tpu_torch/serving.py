"""Export a capsule to one self-contained serving artifact, and load it
(counterpart of serving.py).

`export_capsule` traces the eval forward that `Predictor` serves
(`training.loop.PredictModule`: the eval transform, the model, the sigmoid of
the last head) with `torch.export`, the trained weights inside the program,
and saves it with `torch.export.save`. The decoder-fusion kernel is the
registered operator `nested_unet_torch::multipart_conv3x3`
(ops/decoder_fusion.py), so it stays one node of the graph; the HWIO copies
of its weights in the compute dtype are constants of the program, made once
at export. The batch dimension is symbolic unless `batch` pins it.

A serving host loads the artifact with `load_exported`, which imports this
module and ops/decoder_fusion.py (to register the operator) and nothing of
the model code, the arch registry or the checkpoints: on a CUDA device the
program runs the hand-written K4 kernel and cuDNN's convolutions, on the CPU
the plain versions.

Artifact layout (out_path is the .pt2 file):
  <name>.pt2              torch.export.save of the program, its tensors on
                          the CPU, with the platforms it may be loaded on
  <name>.manifest.json    input/output contract (shapes, dtypes, semantics)
"""

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["export_capsule", "load_exported"]

PLATFORMS = ("cuda", "cpu")
_PLATFORMS_FILE = "platforms.json"  # an extra file inside the .pt2
_OUTPUT_SEMANTICS = (
    "sigmoid probabilities of the final head, NHWC, float; inputs are uint8 "
    "BGR images already resized to (input_h, input_w) — the same convention "
    "as the training loader (cv2.imread) and infer.py"
)


def _manifest_path(artifact_path: str) -> str:
    base, _ = os.path.splitext(artifact_path)
    return base + ".manifest.json"


def _check_platforms(platforms: Sequence[str]) -> list:
    platforms = list(platforms)
    if not platforms or not set(platforms) <= set(PLATFORMS):
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got {platforms}")
    return platforms


def export_capsule(model_dir: str, out_path: Optional[str] = None,
                   batch: Optional[int] = None, platforms: Sequence[str] = PLATFORMS,
                   precision: Optional[str] = None, device="cuda") -> Tuple[str, dict]:
    """Export a trained `models/<name>/` capsule to a serving artifact.

    batch=None exports a symbolic batch dimension (one artifact, any batch
    of at least 1); an int pins it. precision ('fp32' / 'bf16', None: the
    capsule's) is the compute precision baked in. The trace runs on
    `device`. Returns (out_path, manifest).
    """
    from torch.export import Dim
    from torch.export.passes import move_to_device_pass

    from .models.blocks import MultipartConv3x3
    from .training.checkpoint import load_capsule
    from .training.loop import PredictModule
    from .utils.device import resolve_device

    platforms = _check_platforms(platforms)
    dev = resolve_device(device)
    model, config = load_capsule(model_dir, precision)
    model = model.to(dev).eval().requires_grad_(False)
    for m in model.modules():
        if isinstance(m, MultipartConv3x3):
            # the HWIO copy in the compute dtype (the eval forward's input is
            # float32), a constant of the exported program
            m.packed_weight(m.dtype or torch.float32)
    h, w, c = config["input_h"], config["input_w"], config["input_channels"]
    # a dynamic batch is traced at 2: a traced size of 1 would be specialized
    example = torch.zeros((2 if batch is None else int(batch), h, w, c), dtype=torch.uint8,
                          device=dev)
    dynamic = ({0: Dim("batch", min=1)},) if batch is None else None
    program = torch.export.export(PredictModule(model), (example,), dynamic_shapes=dynamic)
    program = move_to_device_pass(program, "cpu")

    if out_path is None:
        out_dir = os.path.join(model_dir, "serving")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, config["name"] + ".pt2")
    tmp = out_path + ".tmp.pt2"
    torch.export.save(program, tmp, extra_files={_PLATFORMS_FILE: json.dumps(platforms)})
    os.replace(tmp, out_path)
    out_val = program.graph.find_nodes(op="output")[0].args[0][0].meta["val"]
    manifest = {
        "name": config["name"],
        "arch": config["arch"],
        "num_classes": config["num_classes"],
        "input_h": h, "input_w": w, "input_channels": c,
        "img_ext": config.get("img_ext", ".png"),
        "batch": "dynamic" if batch is None else int(batch),
        "input_dtype": "uint8",
        "output_dtype": str(out_val.dtype).replace("torch.", ""),
        "output": _OUTPUT_SEMANTICS,
        "platforms": platforms,
        "torch_version": torch.__version__,
        "schema_version": _schema_version(),
        "artifact_bytes": os.path.getsize(out_path),
    }
    with open(_manifest_path(out_path), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_path, manifest


def _schema_version() -> str:
    """The torch.export serialization schema's version, "major.minor"."""
    from torch._export.serde.schema import SCHEMA_VERSION

    return ".".join(str(v) for v in SCHEMA_VERSION)


def _recover_manifest(program, platforms) -> dict:
    """The contract from the program's input and output specs alone."""
    user_input = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == user_input)
    shape = node.meta["val"].shape
    out_shape = program.graph.find_nodes(op="output")[0].args[0][0].meta["val"].shape
    return {"batch": int(shape[0]) if isinstance(shape[0], int) else "dynamic",
            "input_h": int(shape[1]), "input_w": int(shape[2]),
            "input_channels": int(shape[3]), "num_classes": int(out_shape[-1]),
            "img_ext": ".png", "platforms": platforms}


def _check_device(artifact_path, platforms, dev):
    if dev.type not in platforms:
        raise ValueError(f"{artifact_path} was exported for {platforms}, not {dev.type}")


def load_exported(artifact_path: str, device="cuda"):
    """Load a serving artifact onto `device`. Returns (predict_u8, manifest)
    where predict_u8(images) takes (B,H,W,C) uint8 images (a numpy array or
    a tensor) and returns the probabilities (manifest['output']) as a tensor
    on `device`. Raises ValueError if the artifact was not exported for
    `device`'s type."""
    from torch.export.passes import move_to_device_pass

    from .ops import decoder_fusion  # noqa: F401  (registers the K4 operator)
    from .utils.device import resolve_device

    dev = resolve_device(device)
    manifest_path, manifest = _manifest_path(artifact_path), None
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        _check_device(artifact_path, manifest["platforms"], dev)
    extra = {_PLATFORMS_FILE: ""}
    program = torch.export.load(artifact_path, extra_files=extra)
    if manifest is None:  # the contract is still recoverable from the artifact itself
        manifest = _recover_manifest(program, json.loads(extra[_PLATFORMS_FILE]))
        _check_device(artifact_path, manifest["platforms"], dev)
    module = move_to_device_pass(program, dev).module()

    @torch.inference_mode()
    def predict_u8(images) -> torch.Tensor:
        x = torch.from_numpy(images) if isinstance(images, np.ndarray) else images
        if x.dtype != torch.uint8 or x.dim() != 4:
            raise ValueError(f"expected (B,H,W,C) uint8 images, got {x.dtype} "
                             f"{tuple(x.shape)}")
        return module(x.to(dev))

    return predict_u8, manifest
