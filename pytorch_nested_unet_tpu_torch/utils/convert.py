"""Carry weights into the port: from the JAX package's variables, or from a
reference-layout `model.pth` (counterpart of utils/torch_convert.py's
exporters and convert.py's import of the NestedUNet, UNet and CRDN families
and the CRDN backbones).

Keys are the reference's: `conv0_0.conv1.weight`, `conv0_1.bn1.running_var`
and `final4.bias` for the UNet family; `conv1.conv1.0.weight`,
`center.conv2.1.running_mean`, `score_block5.1.weight`, `RDC.gru_conv.bias`
for the CRDN family; `layer3.2.bn2.weight`, `conv_block2.4.weight`,
`conv5_score_block.1.running_var`, `up_concat4.up.weight`,
`classifier.5.running_mean` for the backbones; `Conv1.conv.1.weight`,
`Att5.psi.0.bias`, `RRCNN2.RCNN.1.conv.0.weight` for the attention U-Nets;
`nonlocal4_2.W.1.running_var`, `up4.fc1.weight`,
`scale_att.cbam.SpatialGate.conv1.bn.weight` for CA-Net; the CRDN keys plus
the released CascadePSP keys under `psp.` (`psp.feats.layer3.2.bn2.weight`,
`psp.psp.stages.3.1.weight`, `psp.up_1.conv2.3.running_var`,
`psp.final_28.0.bias`) for the PSP hybrids; conv weights OIHW float32,
transposed-conv weights [in, out, kh, kw], linear weights [out, in].

DoubleUnet and DeepLab have no reference layout: the reference's copies of
both are dead code, so no reference checkpoint of either can exist. Their
keys are the JAX package's variable paths joined with `.`, plain BN's inner
`bn` scope dropped (`bu0_block0.downsample_bn.running_var`,
`td3_block1.conv2.weight`, `iteration_weights`,
`backbone.layer4_2.hha_conv2.weight`, `backbone.sagate0.fsp_rgb.fc1.weight`,
`head.aspp.map_conv3.weight`). The JAX package's own exporter
(`converters_for_arch(arch)[1]`) raises on both: `KeyError:
'iteration_weights'` for DoubleUnet with weighted_sum (the 1-D parameter
falls into its BN-leaf branch) and `ValueError: axes don't match array` for
DeepLab (FSP's raw Dense kernels get the 4-D conv transpose). Here they are
carried from the variables tree directly; `train` writes these keys to
model.pth and `val` / `infer` read them back.
"""

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..models import model_class
from ..models.attention_unet import _EncDecUNet
from ..models.canet import Comprehensive_Atten_Unet
from ..models.crdn_backbones import ResNetFCN, ResNetRNN, ResNetUNet, VGG16RNN, _ResNetTrunk
from ..models.double_unet import DoubleUnet
from ..models.dual_deeplab import DeepLab
from ..models.ghost import UNetRNNGhost
from ..models.psp_hybrid import _PSPTail
from ..models.rdc import GATES, _UNetRNNBase
from ..ops.layers import JAX_KERNEL_TO_PORT

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
# The attention U-Nets (utils/torch_convert.py:92-131): the reference keys
# conv_block as `*.conv.{0,1,3,4}` (conv, BN, conv, BN), up_conv as
# `*.up.{1,2}`, the gates as `*.{W_g,W_x,psi}.{0,1}` and an RRCNN block as
# `*.Conv_1x1` and `*.RCNN.{0,1}.conv.{0,1}`; the JAX package names them by
# attribute, its plain BatchNorm one scope deeper (`bn1/bn/scale`).
_ATTR_TO_ATTN = (
    (re.compile(r"\.rcnn1\.conv\."), ".RCNN.0.conv.0."),
    (re.compile(r"\.rcnn1\.bn\.bn\."), ".RCNN.0.conv.1."),
    (re.compile(r"\.rcnn2\.conv\."), ".RCNN.1.conv.0."),
    (re.compile(r"\.rcnn2\.bn\.bn\."), ".RCNN.1.conv.1."),
    (re.compile(r"^((?:Up_)?RRCNN\d)\.conv_1x1\."), r"\1.Conv_1x1."),
    (re.compile(r"\.conv1\."), ".conv.0."),
    (re.compile(r"\.bn1\.bn\."), ".conv.1."),
    (re.compile(r"\.conv2\."), ".conv.3."),
    (re.compile(r"\.bn2\.bn\."), ".conv.4."),
    (re.compile(r"\.(W_g|W_x|psi)_conv\."), r".\1.0."),
    (re.compile(r"\.(W_g|W_x|psi)_bn\.bn\."), r".\1.1."),
    (re.compile(r"^(Up\d)\.conv\."), r"\1.up.1."),
    (re.compile(r"^(Up\d)\.bn\.bn\."), r"\1.up.2."),
)
# CA-Net (utils/torch_convert.py:233-305): the reference's conv_block
# Sequentials, the gates' `W` and `combine_gates` Sequentials, the non-local
# block's wrapped g / phi / W, SE blocks with a `downchannel` Sequential,
# `dsvN.dsv.0`, the CBAM tree `scale_att.cbam.{ChannelGate.mlp.{1,3},
# SpatialGate.conv{1,2}.{conv,bn}}` and `final.0`. The JAX package's plain
# BatchNorm sits one scope deeper (`.bn.`); its two flax BNs (non-local
# W_bn, SpatialAtten conv1_bn) do not.
_ATTR_TO_CANET = (
    (re.compile(r"^scale_att\.channel_gate\.fc1\."), "scale_att.cbam.ChannelGate.mlp.1."),
    (re.compile(r"^scale_att\.channel_gate\.fc2\."), "scale_att.cbam.ChannelGate.mlp.3."),
    (re.compile(r"^scale_att\.spatial_gate\.conv1_conv\."),
     "scale_att.cbam.SpatialGate.conv1.conv."),
    (re.compile(r"^scale_att\.spatial_gate\.conv1_bn\."), "scale_att.cbam.SpatialGate.conv1.bn."),
    (re.compile(r"^scale_att\.spatial_gate\.conv2_conv\."),
     "scale_att.cbam.SpatialGate.conv2.conv."),
    (re.compile(r"^scale_att\.bn3\.bn\."), "scale_att.bn3."),
    (re.compile(r"^nonlocal4_2\.g\."), "nonlocal4_2.g.0."),
    (re.compile(r"^nonlocal4_2\.phi\."), "nonlocal4_2.phi.0."),
    (re.compile(r"^nonlocal4_2\.W_conv\."), "nonlocal4_2.W.0."),
    (re.compile(r"^nonlocal4_2\.W_bn\."), "nonlocal4_2.W.1."),
    (re.compile(r"^(attentionblock\d\.gate_block_\d)\.W_conv\."), r"\1.W.0."),
    (re.compile(r"^(attentionblock\d\.gate_block_\d)\.W_bn\.bn\."), r"\1.W.1."),
    (re.compile(r"^(attentionblock\d)\.combine_conv\."), r"\1.combine_gates.0."),
    (re.compile(r"^(attentionblock\d)\.combine_bn\.bn\."), r"\1.combine_gates.1."),
    (re.compile(r"^(up\d)\.bn(\d)\.bn\."), r"\1.bn\2."),
    (re.compile(r"^(up\d)\.downchannel_conv\."), r"\1.downchannel.0."),
    (re.compile(r"^(up\d)\.downchannel_bn\.bn\."), r"\1.downchannel.1."),
    (re.compile(r"^(dsv\d)\.conv\."), r"\1.dsv.0."),
    (re.compile(r"^final\."), "final.0."),
    (re.compile(r"^((?:conv\d|center))\.conv1\."), r"\1.conv.0."),
    (re.compile(r"^((?:conv\d|center))\.bn1\.bn\."), r"\1.conv.1."),
    (re.compile(r"^((?:conv\d|center))\.conv2\."), r"\1.conv.3."),
    (re.compile(r"^((?:conv\d|center))\.bn2\.bn\."), r"\1.conv.4."),
)
# The PSP hybrids' refinement network `psp` (refinement/refiner.py:181-215 of
# the JAX package, `_flax_path_to_torch_key`): the JAX package names the
# trunk's blocks `layer{L}_{i}` with `downsample_conv` / `downsample_bn`, the
# pyramid's convs `stage{k}_conv`, the upsample Sequentials' members
# `conv_{0,2,3,5}` / `conv2_{...}` and the heads' `final_28_{0,2}`, its plain
# BatchNorm one scope deeper (`bn1/bn/scale`); the released checkpoint keys
# them as `layer{L}.{i}.downsample.{0,1}`, `stages.{k}.1`, `conv.{i}` and
# `final_28.{i}`.
_PSP_HYBRID = (
    (re.compile(r"^psp\.feats\.bn1\.bn\."), "psp.feats.bn1."),
    (re.compile(r"^psp\.feats\.layer(\d)_(\d+)\.downsample_conv\."),
     r"psp.feats.layer\1.\2.downsample.0."),
    (re.compile(r"^psp\.feats\.layer(\d)_(\d+)\.downsample_bn\.bn\."),
     r"psp.feats.layer\1.\2.downsample.1."),
    (re.compile(r"^psp\.feats\.layer(\d)_(\d+)\.(bn\d)\.bn\."), r"psp.feats.layer\1.\2.\3."),
    (re.compile(r"^psp\.feats\.layer(\d)_(\d+)\.(conv\d)\."), r"psp.feats.layer\1.\2.\3."),
    (re.compile(r"^psp\.psp\.stage(\d)_conv\."), r"psp.psp.stages.\1.1."),
    (re.compile(r"^psp\.(up_\d)\.(conv2?)_(\d)\.bn\."), r"psp.\1.\2.\3."),
    (re.compile(r"^psp\.(up_\d)\.(conv2?)_(\d)\."), r"psp.\1.\2.\3."),
    (re.compile(r"^psp\.(final_(?:28|56))_(\d)\."), r"psp.\1.\2."),
)
# what a reference checkpoint of a PSP hybrid lacks (root convert.py:102-112)
_PSP_SYNTH_NOTE = (
    "refinement tensors the reference builds as a FRESH RANDOM PSPNet inside every forward "
    "(archs_backup.py:1533-1537) — fixed init here, trainable; graft the released "
    "CascadePSP weights with --refine_pth")
# DoubleUnet and DeepLab (no reference layout): the JAX paths, plain BN's
# inner `bn` scope dropped (`fe_bn1/bn/scale` -> `fe_bn1.weight`)
_DROP_BN_SCOPE = ((re.compile(r"\.bn\.(weight|bias|running_mean|running_var)$"), r".\1"),)
_FAMILY_RENAMES = ((_EncDecUNet, _ATTR_TO_ATTN), (Comprehensive_Atten_Unet, _ATTR_TO_CANET),
                     (VGG16RNN, _VGG), (ResNetRNN, _RESNET_SCORE + _RESNET_TRUNK),
                     (ResNetUNet, _RESNET_UNET + _RESNET_TRUNK),
                     (ResNetFCN, _FCN + _RESNET_TRUNK), (DoubleUnet, _DROP_BN_SCOPE),
                     (DeepLab, _DROP_BN_SCOPE))
# RNN-decoded archs: the reference builds every decoder's RDC gates
_RNN_ARCHS = (_UNetRNNBase, VGG16RNN, ResNetRNN)


def _renames(arch: str):
    """The rules that take `arch`'s attribute-style keys to the reference's,
    from its class: none for the UNet family."""
    cls = model_class(arch)
    for family, rules in _FAMILY_RENAMES:
        if issubclass(cls, family):
            return rules
    if not issubclass(cls, _UNetRNNBase):
        return ()
    rules = _ATTR_TO_CRDN + (_CENTER if cls.CENTER else ())
    if issubclass(cls, _PSPTail):
        return _PSP_HYBRID + rules
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
    `<m>/dense/{kernel,bias}` become `<m>.{weight,bias}` ([in, out] ->
    [out, in]); batch-norm `scale/bias/mean/var` become `weight/bias/running_mean/
    running_var`; attention `gamma` stays `gamma`; a raw flax Dense's 2-D
    `<m>/kernel` (any scope name: DeepLab's FSP `fc1`, `fc2`) becomes
    `<m>.weight` [out, in]; a 1-D parameter at the tree's root (DoubleUnet's
    `iteration_weights`) keeps its name; then the arch's renames. Any other
    leaf raises KeyError.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            arr = np.asarray(v, np.float32)
            if path and path[-1] in ("conv", "dense"):
                base = ".".join(path[:-1])
                if k == "kernel":
                    out[base + ".weight"] = torch.from_numpy(
                        arr.transpose(JAX_KERNEL_TO_PORT[arr.ndim]).copy())
                elif k == "bias":
                    out[base + ".bias"] = torch.from_numpy(arr.copy())
                else:
                    raise KeyError(f"unrecognized {path[-1]} leaf: {'/'.join(path + (k,))}")
            elif k in _BN_LEAVES or k == "gamma":
                out[".".join(path) + "." + _BN_LEAVES.get(k, k)] = torch.from_numpy(arr.copy())
            elif k == "kernel" and arr.ndim == 2:
                out[".".join(path) + ".weight"] = torch.from_numpy(
                    arr.transpose(JAX_KERNEL_TO_PORT[2]).copy())
            elif arr.ndim == 1 and not path:
                out[k] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"unrecognized leaf: {'/'.join(path + (k,))}")

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    rules = _renames(arch)
    return {_rename(k, rules): v for k, v in out.items()}


def load_reference_pth(path, arch: str = "NestedUNet", decoder: Optional[str] = None,
                       dropped: Optional[set] = None,
                       init: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Read a reference-layout `model.pth` (e.g. one written by
    `python convert.py --export`, or by the reference trainer; a checkpoint
    that keeps it under 'state_dict' beside other entries too) as float32
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
    `dropped` when a set is given. A PSP hybrid's reference checkpoint
    carries no `psp.*` (the reference builds that network inside forward):
    those tensors are taken from `init` (the model's own state dict), with a
    note printed, as the root convert.py synthesizes them."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), Mapping):  # {'state_dict': sd, ...metadata}
        sd = sd["state_dict"]
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
    if issubclass(cls, _PSPTail) and init is not None \
            and not any(k.startswith("psp.") for k in out):
        synth = {k: v.detach().to("cpu", torch.float32) for k, v in init.items()
                 if k.startswith("psp.")}
        out.update(synth)
        print(f"synthesized {len(synth)} {_PSP_SYNTH_NOTE}")
    return out
