"""`Refiner`: CascadePSP segmentation refinement behind one call
(counterpart of refinement/refiner.py; reference
segmentation-refinement/segmentation_refinement/main.py:13-92).

refine(image, mask, fast, L) follows main.py:59-81: the image normalized
with ImageNet's mean and deviation, the mask binarized at 127 and mapped to
+-1, the fast (global pass only) or full (global and tiled local) pipeline,
and the refined mask returned as uint8 probability x 255.

Weights: the released CascadePSP `model` file (a torch state dict, keys
with or without DataParallel's `module.`), an `.npz` of the same keys, a
state dict, or none (the port's seeded init). Nothing is downloaded:
`model_path="auto"` raises `WeightsUnavailable` saying where to put the
released file.
"""

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .driver import process_high_res_im, process_im_single_pass
from .pspnet import RefinementModule

_IM_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IM_STD = np.array([0.229, 0.224, 0.225], np.float32)
# where the reference's auto-download keeps the released file (main.py:22-31)
RELEASED_WEIGHTS = os.path.join("~", ".segmentation-refinement", "model")


class WeightsUnavailable(OSError):
    """The refinement weights asked for are not on this host."""


def convert_torch_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A CascadePSP state dict (tensors or arrays) -> the RefinementModule's:
    DataParallel `module.` prefixes stripped, `num_batches_tracked` counters
    dropped, every tensor float32 on the CPU. The keys are the module's
    own."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith("num_batches_tracked"):
            continue
        t = value if torch.is_tensor(value) else torch.from_numpy(np.array(value, np.float32))
        out[key] = t.detach().to("cpu", torch.float32)
    return out


def export_torch_style_state_dict(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The module's state dict as float32 numpy arrays under the released
    checkpoint's keys (an `.npz` of it loads through `Refiner`)."""
    return {k: v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}


def load_weights(path) -> Dict[str, torch.Tensor]:
    """Read CascadePSP weights: an `.npz` of state-dict keys, or a torch
    `.pth` state dict (read with weights_only=True), converted."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"refinement weights not found: {path}")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return convert_torch_state_dict({k: z[k] for k in z.files})
    return convert_torch_state_dict(torch.load(path, map_location="cpu", weights_only=True))


class Refiner:
    """CascadePSP refinement on one device (reference main.py:13-81).

    model_path: a `.pth` or `.npz` of the released keys, or "auto" (raises
    WeightsUnavailable: the port downloads nothing). state_dict: weights
    given directly. With neither, the network keeps its seeded init, drawn
    from `generator` (default seed 0) as torch draws a conv's weights; that
    init is the port's own and differs from the JAX package's flax init at
    PRNGKey(0). dtype: the compute dtype (None: float32). tile_batch: tiles
    per forward in the full pipeline's local step. device: "cuda" unless
    the caller asks for "cpu"; CUDA without a card raises.
    """

    def __init__(self, model_path=None, state_dict: Optional[Mapping] = None,
                 dtype: Optional[torch.dtype] = None, tile_batch: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        if model_path == "auto":
            raise WeightsUnavailable(
                "the CascadePSP weights are not downloaded by this package: place the "
                f"released 'model' file at {RELEASED_WEIGHTS} (or anywhere) and pass its "
                "path as model_path")
        if tile_batch is not None and tile_batch < 1:
            raise ValueError(f"tile_batch must be >= 1, got {tile_batch}")
        self.tile_batch = tile_batch
        model = RefinementModule(dtype, generator)
        if model_path is not None:
            state_dict = load_weights(model_path)
        if state_dict is not None:
            model.load_state_dict(convert_torch_state_dict(state_dict), strict=True)
        self.model = model.to(self.device).eval()
        self.tiles_run = 0  # local-pass tiles run by refine(), over every call

    @torch.no_grad()
    def apply_fn(self, im, seg, inter_s8=None, inter_s4=None):
        return self.model(im, seg, inter_s8, inter_s4)

    def inputs(self, image: np.ndarray, mask: np.ndarray):
        """The network's inputs on the device: the (1,H,W,3) image normalized
        with ImageNet's mean and deviation, the (1,H,W,1) mask binarized at
        127 and mapped to +-1 (reference main.py:59-72)."""
        img = (np.asarray(image, np.float32) / 255.0 - _IM_MEAN) / _IM_STD
        m = np.asarray(mask)
        if m.ndim == 3:
            m = m[..., 0]
        seg = ((m > 127).astype(np.float32) - 0.5) / 0.5
        return (torch.from_numpy(img[None]).to(self.device),
                torch.from_numpy(seg[None, ..., None]).to(self.device))

    def refine(self, image: np.ndarray, mask: np.ndarray, fast: bool = False,
               L: int = 900) -> np.ndarray:
        """image: (H,W,3) uint8; mask: (H,W) or (H,W,1) uint8, binarized at
        127. Returns the refined mask, (H,W) uint8 = probability x 255."""
        im, sg = self.inputs(image, mask)
        if fast:
            out = process_im_single_pass(self.apply_fn, im, sg, L)
        else:
            tiles = []
            out = process_high_res_im(self.apply_fn, im, sg, L, self.tile_batch, tiles)
            self.tiles_run += len(tiles)
        return (out[0, ..., 0].float().cpu().numpy() * 255).astype(np.uint8)
