"""Carry weights into the port: from the JAX package's variables, or from a
reference-layout `model.pth` (counterpart of the NestedUNet/UNet branch of
utils/torch_convert.py:572-604).

Keys are the reference's (`conv0_0.conv1.weight`, `conv0_1.bn1.running_var`,
`final4.bias`, ...), conv weights OIHW float32.
"""

from typing import Dict, Mapping

import numpy as np
import torch

# flax leaf -> torch leaf for batch-norm parameters and statistics
_BN_LEAVES = {"scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} tree of numpy arrays -> the port's state dict.

    `<m>/conv/{kernel,bias}` become `<m>.{weight,bias}` (HWIO -> OIHW);
    batch-norm `scale/bias/mean/var` become `weight/bias/running_mean/running_var`.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            arr = np.asarray(v, np.float32)
            if path and path[-1] == "conv":
                base = ".".join(path[:-1])
                if k == "kernel":
                    out[base + ".weight"] = torch.from_numpy(arr.transpose(3, 2, 0, 1).copy())
                elif k == "bias":
                    out[base + ".bias"] = torch.from_numpy(arr.copy())
                else:
                    raise KeyError(f"unrecognized conv leaf: {'/'.join(path + (k,))}")
            elif k in _BN_LEAVES:
                out[".".join(path) + "." + _BN_LEAVES[k]] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"unrecognized leaf: {'/'.join(path + (k,))}")

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    return out


def load_reference_pth(path) -> Dict[str, torch.Tensor]:
    """Read a reference-layout `model.pth` (e.g. one written by
    `python convert.py --export`) as float32 tensors, dropping DataParallel
    `module.` prefixes and `num_batches_tracked` counters."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for key, value in sd.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith("num_batches_tracked"):
            continue
        out[key] = torch.as_tensor(value, dtype=torch.float32)
    return out
