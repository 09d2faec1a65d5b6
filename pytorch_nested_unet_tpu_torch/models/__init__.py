"""Model registry (counterpart of models/__init__.py).

The port registers the UNet family (UNet, NestedUNet), the CRDN family
(UNetRNN, UNetRM3, UNetRM7, UNetRNNGhost and the three UNetRNN attention
variants) and its backbones (VGG16RNN, ResNet{18,34,50,101,152}RNN,
ResNet50UNet, ResNet50FCN), the attention U-Nets (AttU_Net, R2U_Net,
R2AttU_Net), CA-Net (Comprehensive_Atten_Unet) and the PSP hybrids
(UNetRNNPSP, UNetRNNCAttention_PSP: UNetRNN with CascadePSP refinement in
the model): 23 of the JAX package's 25 archs. The rest of the zoo is queued
family by family in ROADMAP.md (queue 1).
"""

import inspect
import json

import torch
import torch.nn as nn

from .attention_unet import AttU_Net, R2AttU_Net, R2U_Net
from .canet import Comprehensive_Atten_Unet
from .crdn_backbones import (ResNet18RNN, ResNet34RNN, ResNet50FCN, ResNet50RNN,
                             ResNet50UNet, ResNet101RNN, ResNet152RNN, VGG16RNN)
from .dual_attention import UNetRNNAttention, UNetRNNCAttention, UNetRNNPAttention
from .ghost import UNetRNNGhost
from .nested_unet import NestedUNet
from .psp_hybrid import UNetRNNCAttention_PSP, UNetRNNPSP
from .rdc import UNetRM3, UNetRM7, UNetRNN
from .unet import UNet

_REGISTRY = {cls.__name__: cls for cls in (
    UNet, NestedUNet, UNetRNN, UNetRM3, UNetRM7, UNetRNNGhost,
    UNetRNNPAttention, UNetRNNCAttention, UNetRNNAttention, VGG16RNN, ResNet18RNN,
    ResNet34RNN, ResNet50RNN, ResNet101RNN, ResNet152RNN, ResNet50UNet, ResNet50FCN,
    AttU_Net, R2U_Net, R2AttU_Net, Comprehensive_Atten_Unet, UNetRNNPSP,
    UNetRNNCAttention_PSP)}
# --precision: the conv compute dtype (parameters are always float32)
PRECISIONS = {"fp32": None, "bf16": torch.bfloat16}
# constructor arguments that create_model and the entry points set themselves
_SET_BY_CALLER = ("num_classes", "input_channels", "deep_supervision", "dtype", "generator")


def arch_names():
    return sorted(_REGISTRY)


def model_class(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not ported yet (ported: {arch_names()}); "
                       "see ROADMAP.md queue 1 for the order of the rest of the zoo")
    return _REGISTRY[name]


def create_model(name: str, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, **kwargs) -> nn.Module:
    """Build a model with the reference trainer's constructor contract
    (reference trains.py:219-223); `kwargs` go to the model (nb_filter,
    decoder, feature_scale, ..., dtype, generator)."""
    return model_class(name)(num_classes=num_classes, input_channels=input_channels,
                      deep_supervision=deep_supervision, **kwargs)


def arch_options(name: str):
    """The constructor options of `name` that arch_kwargs may set, from its
    constructor and those of the classes it passes **kwargs on to."""
    names = []
    for cls in model_class(name).__mro__:
        if "__init__" not in vars(cls):
            continue
        params = inspect.signature(vars(cls)["__init__"]).parameters.values()
        names += [p.name for p in params
                  if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY) and p.name != "self"]
        if not any(p.kind is p.VAR_KEYWORD for p in params):
            break
    return sorted(set(names) - set(_SET_BY_CALLER))


def parse_arch_kwargs(name: str, raw):
    """Validate per-arch constructor options given as a JSON object string (or
    an already-parsed mapping): the --arch_kwargs format of the JAX package's
    train.py. JSON arrays become tuples. Raises ValueError naming unknown
    options."""
    if not raw:
        return {}
    kw = json.loads(raw) if isinstance(raw, str) else dict(raw)
    if not isinstance(kw, dict):
        raise ValueError(f"arch_kwargs must be a JSON object, got {raw!r}")
    allowed = arch_options(name)
    unknown = sorted(set(kw) - set(allowed))
    if unknown:
        raise ValueError(f"{name} has no option(s) {unknown}; available: {allowed}")

    def _freeze(v):
        return tuple(_freeze(x) for x in v) if isinstance(v, list) else v

    return {k: _freeze(v) for k, v in kw.items()}
