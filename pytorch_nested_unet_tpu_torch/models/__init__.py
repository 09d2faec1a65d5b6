"""Model registry (counterpart of models/__init__.py).

The port registers NestedUNet only; the rest of the zoo is queued family by
family in ROADMAP.md (queue 1).
"""

import torch.nn as nn

from .nested_unet import NestedUNet

_REGISTRY = {"NestedUNet": NestedUNet}


def arch_names():
    return sorted(_REGISTRY)


def create_model(name: str, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, **kwargs) -> nn.Module:
    """Build a model with the reference trainer's constructor contract
    (reference trains.py:219-223); `kwargs` go to the model (nb_filter, dtype,
    generator)."""
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not ported yet (ported: {arch_names()}); "
                       "see ROADMAP.md queue 1 for the order of the rest of the zoo")
    return _REGISTRY[name](num_classes=num_classes, input_channels=input_channels,
                           deep_supervision=deep_supervision, **kwargs)
