"""Carry weights into the port: from the JAX package's variables, or from a
reference-layout `model.pth` (counterpart of utils/torch_convert.py's
exporters and convert.py's import of the NestedUNet, UNet and CRDN families
and the CRDN backbones).

Keys are the reference's: `conv0_0.conv1.weight`, `conv0_1.bn1.running_var`
and `final4.bias` for the UNet family; `conv1.conv1.0.weight`,
`center.conv2.1.running_mean`, `score_block5.1.weight`, `RDC.gru_conv.bias`
for the CRDN family; `layer3.2.bn2.weight`, `conv_block2.4.weight`,
`conv5_score_block.1.running_var`, `up_concat4.up.weight`,
`classifier.5.running_mean` for the backbones; conv weights OIHW float32,
transposed-conv weights [in, out, kh, kw].
"""

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..models import model_class
from ..models.crdn_backbones import ResNetFCN, ResNetRNN, ResNetUNet, VGG16RNN, _ResNetTrunk
from ..models.ghost import UNetRNNGhost
from ..models.rdc import GATES, _UNetRNNBase

# flax leaf -> torch leaf for batch-norm parameters and statistics
_BN_LEAVES = {"scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}

# The reference CRDN modules key through indexed sequences: unetConv2 wraps
# each conv and its BN as `convN.convK.{0,1}`, a score block is
# `score_blockN.{0,1}`, and UNetRNN (with its Ghost and attention variants,
# not the RM3 / RM7 depth ablations) calls its 5th encoder block `center`.
# The JAX package names them by attribute (`conv1/bn1`, `score_block1/conv`,
# `conv5`); these rules take its attribute-style keys to the reference's
# (utils/torch_convert.py:40-50).
_ATTR_TO_CRDN = (
    (re.compile(r"^(conv\d)\.conv([12])\."), r"\1.conv\2.0."),
    (re.compile(r"^(conv\d)\.bn([12])\."), r"\1.conv\2.1."),
    (re.compile(r"^(score_block\d)\.conv\."), r"\1.0."),
    (re.compile(r"^(score_block\d)\.bn\."), r"\1.1."),
)
_CENTER = ((re.compile(r"^conv5\."), "center."),)
# UNetRNNGhost's score blocks: a one-element sequence around the bottleneck,
# indexed sequences for the ghost convs and the shortcut; the JAX package's
# plain BatchNorm sits one scope deeper (`primary_bn/bn/scale`)
# (utils/torch_convert.py:75-89). Applied before the CRDN rules.
_ATTR_TO_GHOST = (
    (re.compile(r"^(score_block\d)\.(ghost[12])\.primary_conv\."),
     r"\1.0.\2.primary_conv.0."),
    (re.compile(r"^(score_block\d)\.(ghost[12])\.primary_bn\.bn\."),
     r"\1.0.\2.primary_conv.1."),
    (re.compile(r"^(score_block\d)\.(ghost[12])\.cheap_conv\."),
     r"\1.0.\2.cheap_operation.0."),
    (re.compile(r"^(score_block\d)\.(ghost[12])\.cheap_bn\.bn\."),
     r"\1.0.\2.cheap_operation.1."),
    (re.compile(r"^(score_block\d)\.se\."), r"\1.0.se."),
    (re.compile(r"^(score_block\d)\.shortcut_dw\."), r"\1.0.shortcut.0."),
    (re.compile(r"^(score_block\d)\.shortcut_dw_bn\.bn\."), r"\1.0.shortcut.1."),
    (re.compile(r"^(score_block\d)\.shortcut_pw\."), r"\1.0.shortcut.2."),
    (re.compile(r"^(score_block\d)\.shortcut_pw_bn\.bn\."), r"\1.0.shortcut.3."),
)


# The CRDN backbones (utils/torch_convert.py:134-231). The JAX package
# flattens a residual stage's blocks to `encoder/layer{L}_{i}`, names the
# residual's conv and BN `downsample_conv` / `downsample_bn`, puts plain
# BatchNorm parameters one scope deeper (`bn1/bn/scale`), and names VGG16RNN's
# units `conv_block{b}_{i}`, each a (conv, bn) pair; the reference keys
# through torchvision-style Sequentials: `layer{L}.{i}.downsample.{0,1}`,
# VGG's stage Sequentials (a MaxPool before stages 2-5, a ReLU after each BN)
# and the FCN classifier's 9-element Sequential.
_RESNET_TRUNK = (
    (re.compile(r"^encoder\.conv1\."), "conv1."),
    (re.compile(r"^encoder\.bn1\.bn\."), "bn1."),
    (re.compile(r"^encoder\.layer(\d)_(\d+)\.downsample_conv\."), r"layer\1.\2.downsample.0."),
    (re.compile(r"^encoder\.layer(\d)_(\d+)\.downsample_bn\.bn\."), r"layer\1.\2.downsample.1."),
    (re.compile(r"^encoder\.layer(\d)_(\d+)\.bn(\d)\.bn\."), r"layer\1.\2.bn\3."),
    (re.compile(r"^encoder\.layer(\d)_(\d+)\.conv(\d)\."), r"layer\1.\2.conv\3."),
)
_RESNET_SCORE = (
    (re.compile(r"^(conv\d_score_block)\.conv\."), r"\1.0."),
    (re.compile(r"^(conv\d_score_block)\.bn\."), r"\1.1."),
)
_VGG = (
    (re.compile(r"^conv_block1_0\.conv\."), "conv_block1.0."),
    (re.compile(r"^conv_block1_0\.bn\."), "conv_block1.1."),
    (re.compile(r"^conv_block1_1\.conv\."), "conv_block1.3."),
    (re.compile(r"^conv_block1_1\.bn\."), "conv_block1.4."),
    (re.compile(r"^conv_block([2-5])_0\.conv\."), r"conv_block\1.1."),
    (re.compile(r"^conv_block([2-5])_0\.bn\."), r"conv_block\1.2."),
    (re.compile(r"^conv_block([2-5])_1\.conv\."), r"conv_block\1.4."),
    (re.compile(r"^conv_block([2-5])_1\.bn\."), r"conv_block\1.5."),
    (re.compile(r"^conv_block([3-5])_2\.conv\."), r"conv_block\1.7."),
    (re.compile(r"^conv_block([3-5])_2\.bn\."), r"conv_block\1.8."),
    (re.compile(r"^(score_block\d)\.conv\."), r"\1.0."),
    (re.compile(r"^(score_block\d)\.bn\."), r"\1.1."),
)
_RESNET_UNET = ((re.compile(r"^(up_concat\d)\.conv\.conv([12])\."), r"\1.conv.conv\2.0."),)
_FCN = (
    (re.compile(r"^classifier_conv1\."), "classifier.0."),
    (re.compile(r"^classifier_bn1\.bn\."), "classifier.1."),
    (re.compile(r"^classifier_conv2\."), "classifier.4."),
    (re.compile(r"^classifier_bn2\.bn\."), "classifier.5."),
    (re.compile(r"^classifier_conv3\."), "classifier.8."),
)
_BACKBONE_RENAMES = ((VGG16RNN, _VGG), (ResNetRNN, _RESNET_SCORE + _RESNET_TRUNK),
                     (ResNetUNet, _RESNET_UNET + _RESNET_TRUNK),
                     (ResNetFCN, _FCN + _RESNET_TRUNK))
# RNN-decoded archs: the reference builds every decoder's RDC gates
_RNN_ARCHS = (_UNetRNNBase, VGG16RNN, ResNetRNN)


def _renames(arch: str):
    """The rules that take `arch`'s attribute-style keys to the reference's,
    from its class: none outside the CRDN family and its backbones."""
    cls = model_class(arch)
    for family, rules in _BACKBONE_RENAMES:
        if issubclass(cls, family):
            return rules
    if not issubclass(cls, _UNetRNNBase):
        return ()
    rules = _ATTR_TO_CRDN + (_CENTER if cls.CENTER else ())
    return _ATTR_TO_GHOST + rules if issubclass(cls, UNetRNNGhost) else rules


def _rename(key: str, rules) -> str:
    for pat, repl in rules:
        key = pat.sub(repl, key)
    return key


def state_dict_from_jax(variables: Mapping, arch: str = "NestedUNet") -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} tree of numpy arrays of `arch` -> the port's
    state dict, the keys `converters_for_arch(arch)[1]` of the JAX package
    emits.

    `<m>/conv/{kernel,bias}` become `<m>.{weight,bias}` (HWIO -> OIHW);
    batch-norm `scale/bias/mean/var` become `weight/bias/running_mean/
    running_var`; attention `gamma` stays `gamma`; then the arch's renames.
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
            elif k in _BN_LEAVES or k == "gamma":
                out[".".join(path) + "." + _BN_LEAVES.get(k, k)] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"unrecognized leaf: {'/'.join(path + (k,))}")

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    rules = _renames(arch)
    return {_rename(k, rules): v for k, v in out.items()}


def load_reference_pth(path, arch: str = "NestedUNet", decoder: Optional[str] = None,
                       dropped: Optional[set] = None) -> Dict[str, torch.Tensor]:
    """Read a reference-layout `model.pth` (e.g. one written by
    `python convert.py --export`, or by the reference trainer) as float32
    tensors, dropping DataParallel `module.` prefixes, `num_batches_tracked`
    counters, the parameters the reference builds but never runs, and for
    the RNN-decoded archs the gate convs of the decoders other than
    `decoder` (default: the arch's: GRU, Ghost's vanilla, the backbones'
    LSTM). The reference's RDC cell builds all four gate convs and its
    forward uses the chosen decoder's only (reference
    finished/archs1.py:145-210); the port, as the JAX package, builds the
    live ones (models.rdc.GATES), and this drops the rest (convert.py:93-97,
    :169-176). The ResNet backbones' unused `fc` head (CRDN.py:440, :696,
    :802) and VGG16RNN's unused `score` conv (CRDN.py:353) go the same way
    (utils/torch_convert.py:230-231). The dropped keys are added to
    `dropped` when a set is given."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for key, value in sd.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith("num_batches_tracked"):
            continue
        out[key] = torch.as_tensor(value, dtype=torch.float32)
    cls = model_class(arch)
    dead = set()
    if issubclass(cls, _RNN_ARCHS):
        decoder = decoder or cls.DECODER
        gates = {g for d, names in GATES.items() if d != decoder for g in names}
        dead = {k for k in out if k.startswith("RDC.") and k.split(".")[1] in gates}
    head = ("fc." if issubclass(cls, _ResNetTrunk) else "score." if issubclass(cls, VGG16RNN)
            else None)
    if head:
        dead |= {k for k in out if k.startswith(head)}
    for key in dead:
        del out[key]
    if dropped is not None:
        dropped.update(dead)
    return out
