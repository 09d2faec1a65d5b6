"""torchvision-format ResNet trunk import (counterpart of utils/pretrained.py).

The reference starts ResNet trunks from ImageNet weights by pouring a
torchvision ResNet state dict into them, the extra input channels of a wider
stem zero-initialized (reference cascadePSP_model/psp/extractors.py:12-33,
`load_weights_sequential`). The port's ResNet trunks (models/crdn_backbones.py)
key their modules as torchvision does (`conv1`, `bn1`,
`layerL.i.{convK,bnK,downsample.0,downsample.1}`), at the root of the
model's state dict, so the import is a key-for-key copy:

- `convert_torchvision_resnet`: a torchvision ResNet state dict
  (resnet18/34/50/101/152) -> its trunk tensors in float32, without the
  classifier (`fc.*`) and the BN counters;
- `find_trunk_scopes`: the module paths of the ResNet trunks of a model or
  state dict ('' for a trunk at the root);
- `graft_trunk`: a copy of the model's state dict with the trunk poured in
  at a scope; every trunk tensor must land on a tensor of the same shape,
  except a stem conv with more input channels, which gets zeros there;
- `load_pretrained_backbone`: a `.pth` file -> the converted trunk.

`train.py --pretrained_backbone PTH` applies them to every trunk of the
model after `--init_from`: the ResNet backbones' trunk at the root, the PSP
hybrids' refinement trunk at `psp.feats` (its 6-channel stem gets zeros in
the 3 segmentation channels).
"""

import re
from typing import Dict, List, Mapping, Tuple, Union

import torch
import torch.nn as nn

_TRUNK_KEY = re.compile(r"^(conv1|bn1|layer[1-4]\.\d+\.(conv\d|bn\d|downsample\.[01]))\."
                        r"(weight|bias|running_mean|running_var)$")

Target = Union[nn.Module, Mapping[str, torch.Tensor]]


def convert_torchvision_resnet(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision ResNet state dict (tensors or arrays; DataParallel
    `module.` prefixes allowed) -> {key: float32 CPU tensor} of its trunk.
    Raises ValueError on a key that is not a ResNet trunk's."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        if not _TRUNK_KEY.match(key):
            raise ValueError(f"unrecognized torchvision ResNet key {key!r}")
        out[key] = torch.as_tensor(value).detach().to("cpu", torch.float32)
    return out


def _keys(target: Target):
    return target.state_dict().keys() if isinstance(target, nn.Module) else target.keys()


def find_trunk_scopes(target: Target) -> List[str]:
    """Module paths ('' for the root) under which `target` has a ResNet
    trunk: a `conv1`, a `bn1` and a `layer1.0.conv1` beside them."""
    keys = set(_keys(target))
    scopes = []
    for key in sorted(keys):
        if key.endswith("layer1.0.conv1.weight"):
            prefix = key[:-len("layer1.0.conv1.weight")]
            if prefix + "conv1.weight" in keys and prefix + "bn1.running_var" in keys:
                scopes.append(prefix[:-1])
    return scopes


def graft_trunk(target: Target, trunk: Mapping[str, torch.Tensor],
                scope: str = "") -> Tuple[Dict[str, torch.Tensor], int]:
    """A copy of `target`'s state dict with `trunk` poured in at `scope`, and
    the number of tensors copied; `target` is left as it is. Raises KeyError
    when a trunk tensor has no counterpart (another depth or block type) and
    ValueError on a shape mismatch other than a stem conv with more input
    channels, whose extra channels are set to 0 (reference
    extractors.py:22-29)."""
    sd = dict(target.state_dict() if isinstance(target, nn.Module) else target)
    prefix = f"{scope}." if scope else ""
    for key, src in trunk.items():
        name = prefix + key
        if name not in sd:
            raise KeyError(f"pretrained trunk has {key} but the model has no {name}: "
                           "another depth or block type?")
        want = tuple(sd[name].shape)
        if tuple(src.shape) != want:
            if src.dim() == 4 and len(want) == 4 and want[0] == src.shape[0] \
                    and want[2:] == tuple(src.shape[2:]) and want[1] > src.shape[1]:
                src = torch.cat([src, src.new_zeros(want[0], want[1] - src.shape[1],
                                                    *want[2:])], dim=1)
            else:
                raise ValueError(f"shape mismatch at {name}: pretrained {tuple(src.shape)} "
                                 f"vs model {want}")
        sd[name] = src.to(sd[name].dtype).clone()
    return sd, len(trunk)


def load_pretrained_backbone(path) -> Dict[str, torch.Tensor]:
    """Read a torchvision-format ResNet `.pth` (a state dict, or a dict with
    one under `state_dict`) and convert it."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return convert_torchvision_resnet(obj)
