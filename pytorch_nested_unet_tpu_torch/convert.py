"""Checkpoint migration CLI between the torch reference and the port's
capsules (counterpart of convert.py at the repo root).

Import (default): a reference-trained `model.pth` (saved by reference
trains.py:344-349, optionally through nn.DataParallel) becomes a
`models/<name>/{config.yml, model.pth}` capsule that the port's val, infer,
export and `train --init_from` read:

    python -m pytorch_nested_unet_tpu_torch.convert --pth model.pth \
        --arch NestedUNet --deep_supervision true --dataset dsb2018_96 \
        --name imported_run [--arch_kwargs JSON] [--refine_pth CASCADEPSP_PTH]

The port's capsules keep the reference's keys, so the import strips the
`module.` prefix, drops the dead RDC gate convs the reference builds and
never runs (and the backbones' unused heads, as the JAX package's converters
do), and checks every key and shape against the arch. Two archs are
synthesized, as the root convert.py does: UNetRNNAttention's attention
tensors, which the reference builds inside forward and never checkpoints
(the model's init, gamma 0: the attention adds nothing), and the PSP
hybrids' refinement network, which the reference rebuilds at random inside
every forward (the model's init, or the released CascadePSP weights with
--refine_pth). Any other missing or unexpected key exits, naming the keys.

Export (--export): a capsule's weights back out as a `.pth` the reference's
arch definitions load (the PSP hybrids without their refinement network):

    python -m pytorch_nested_unet_tpu_torch.convert --export --name imported_run \
        --out model_export.pth

DoubleUnet and DeepLab have no reference layout (utils/convert.py) and do
not export.
"""

import argparse
import os
import re
import sys

import torch

from .models import PRECISIONS, arch_names, model_class
from .models.double_unet import DoubleUnet
from .models.dual_deeplab import DeepLab
from .models.psp_hybrid import _PSPTail
from .training import checkpoint
from .utils.config import save_config, str2bool
from .utils.convert import load_reference_pth

# Archs whose reference class constructs part of itself inside `forward`, so
# its checkpoints cannot carry those tensors; imports synthesize them from
# this model's init: arch -> (missing-key regex, explanation printed). The
# PSP hybrids' refinement network is filled by `load_reference_pth` (every
# loader of a reference checkpoint does so), not here.
_SYNTHESIZABLE = {
    "UNetRNNAttention": (
        re.compile(r"^attention_block\d+\.(pam|cam)\."),
        "untrained dual-attention tensors the reference builds at forward time (gamma=0: "
        "attention is a no-op, semantics preserved)"),
}
_CONFIG_KEYS = ("arch", "arch_kwargs", "deep_supervision", "num_classes", "input_channels",
                "input_w", "input_h", "dataset", "img_ext", "mask_ext", "dataset_layout",
                "precision")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pth", default=None, help="torch state_dict to import")
    p.add_argument("--export", action="store_true",
                   help="reverse direction: models/<name> -> torch .pth")
    p.add_argument("--out", default=None, help="export target path (default <name>_export.pth)")
    p.add_argument("--name", default=None,
                   help="capsule name under --output_dir (default <dataset>_<arch>_{w,wo}DS)")
    p.add_argument("--arch", default="NestedUNet", choices=arch_names())
    p.add_argument("--arch_kwargs", default=None, metavar="JSON",
                   help="the arch's constructor options stored in the capsule (as train's), "
                        "e.g. '{\"decoder\": \"LSTM\"}' for a UNetRNN import")
    p.add_argument("--deep_supervision", default=False, type=str2bool)
    p.add_argument("--num_classes", default=1, type=int)
    p.add_argument("--input_channels", default=3, type=int)
    p.add_argument("--input_w", default=96, type=int)
    p.add_argument("--input_h", default=96, type=int)
    p.add_argument("--dataset", default="dsb2018_96")
    p.add_argument("--img_ext", default=".png")
    p.add_argument("--mask_ext", default=".png")
    p.add_argument("--dataset_layout", default="generic", choices=["generic", "isic"])
    p.add_argument("--refine_pth", default=None, metavar="PATH",
                   help="for the PSP hybrids (UNetRNNCAttention_PSP / UNetRNNPSP): fill the "
                        "refinement network from a CascadePSP checkpoint (.pth or .npz) "
                        "instead of the init")
    p.add_argument("--precision", default="fp32", choices=sorted(PRECISIONS))
    p.add_argument("--output_dir", default="models")
    return vars(p.parse_args(argv))


def export_reference_pth(model_dir: str, out: str) -> str:
    """--export: the capsule's weights in the reference layout, float32."""
    model, config = checkpoint.load_capsule(model_dir)
    cls = model_class(config["arch"])
    if issubclass(cls, (DoubleUnet, DeepLab)):
        sys.exit(f"--export: {config['arch']} has no reference layout (the reference's copy is "
                 "dead code); its model.pth is the port's own")
    psp = issubclass(cls, _PSPTail)  # the reference carries no refinement network
    sd = {k: v.detach().to("cpu", torch.float32).clone()
          for k, v in model.state_dict().items() if not (psp and k.startswith("psp."))}
    torch.save(sd, out)
    print(f"exported {len(sd)} tensors -> {out}")
    return out


def import_pth(args: dict) -> str:
    """--pth: see the module docstring. Returns the capsule's directory."""
    config = {k: args[k] for k in _CONFIG_KEYS}
    model = checkpoint.build_from_config(config, generator=torch.Generator().manual_seed(0))
    init = model.state_dict()
    dropped = set()
    # with --refine_pth (a PSP hybrid's) the graft must be whole: a missing
    # psp key is the checkpoint's fault
    sd = load_reference_pth(args["pth"], config["arch"], getattr(model, "decoder", None),
                            dropped=dropped, init=None if args["refine_pth"] else init)
    dead = sorted(k for k in dropped if k.startswith("RDC."))
    if dead:
        print(f"pruned {len(dead)} dead RDC-gate tensors the reference constructs but never "
              f"uses (e.g. {dead[0]})")
    if args["refine_pth"]:
        from .refinement.refiner import load_weights

        sd.update({f"psp.{k}": v for k, v in load_weights(args["refine_pth"]).items()})
        print(f"grafted CascadePSP refinement weights from {args['refine_pth']} into the "
              "psp submodule")
    missing = sorted(set(init) - set(sd))
    rule = _SYNTHESIZABLE.get(config["arch"])
    synth = [k for k in missing if rule and rule[0].search(k)]
    if synth:
        sd.update({k: init[k] for k in synth})
        missing = [k for k in missing if k not in synth]
        print(f"synthesized {len(synth)} {rule[1]}")
    unexpected = sorted(set(sd) - set(init))
    wrong = sorted(k for k in set(sd) & set(init) if sd[k].shape != init[k].shape)
    if missing or unexpected or wrong:
        msg = [f"converted checkpoint does not match {config['arch']} "
               f"(num_classes={config['num_classes']}, "
               f"input_channels={config['input_channels']}, "
               f"deep_supervision={config['deep_supervision']}):"]
        if missing:
            msg.append(f"  missing ({len(missing)}): {missing[:5]} ...")
        if unexpected:
            msg.append(f"  unexpected ({len(unexpected)}): {unexpected[:5]} ...")
        for k in wrong[:5]:
            msg.append(f"  shape mismatch {k}: checkpoint {tuple(sd[k].shape)} vs model "
                       f"{tuple(init[k].shape)}")
        sys.exit("\n".join(msg))
    model.load_state_dict(sd, strict=True)

    if not args["name"]:
        tag = "wDS" if config["deep_supervision"] else "woDS"
        args["name"] = f"{config['dataset']}_{config['arch']}_{tag}"
    config["name"] = args["name"]
    config["loss"] = "BCEDiceLoss"
    model_dir = os.path.join(args["output_dir"], args["name"])
    save_config(config, model_dir)
    checkpoint.save_model(model_dir, model)
    n = sum(p.numel() for p in model.parameters())
    print(f"imported {args['pth']} -> {model_dir}/model.pth ({n:,} params); validate with: "
          f"python -m pytorch_nested_unet_tpu_torch.val --name {args['name']}")
    return model_dir


def main(argv=None) -> str:
    args = parse_args(argv)
    if args["export"]:
        if not args["name"]:
            sys.exit("--export requires --name")
        if args["refine_pth"]:
            sys.exit("--refine_pth is an import-time graft; it has no meaning with --export "
                     "(the reference classes carry no refinement params to export into)")
        return export_reference_pth(os.path.join(args["output_dir"], args["name"]),
                                  args["out"] or f"{args['name']}_export.pth")
    if not args["pth"]:
        sys.exit("--pth PATH required (or --export)")
    if args["refine_pth"] and not issubclass(model_class(args["arch"]), _PSPTail):
        sys.exit("--refine_pth only applies to the PSP-hybrid archs "
                 "(UNetRNNCAttention_PSP / UNetRNNPSP)")
    return import_pth(args)


if __name__ == "__main__":
    main()
