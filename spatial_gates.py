#!/usr/bin/env python
"""The movement readings behind the gradient gates of `chip_smoke.py`'s
data-parallel and spatial checks, and those checks on one card.

    python3 spatial_gates.py    # needs one CUDA card

For full-width NestedUNet wDS and UNet (fp32, TF32 off, global batch 16 at
96x96) it prints each of `chip_smoke.MOVEMENT_READINGS` (the one-process
step under a 1e-7 weight change from three seeds, and over its batch in two
other orders): the median and largest movement over the gradients, and a
few deep gradients' readings. Then it runs, over Gloo on the one card and
against those gates: 2 data-parallel ranks (`dp_ranks`), `spatial_phase`
(NestedUNet x=2, UNet x=2,y=2, `train --mesh x=2`) and NestedUNet
data=2,x=2, whose five gradients nearest their gates it prints per rank.
"""

import glob
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main():
    from pytorch_nested_unet_tpu_torch.ops import _build
    from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
    from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn

    if not torch.cuda.is_available():
        print("spatial_gates: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print("card:", card, torch.__version__, flush=True)
    _build.build_all()
    refs = {}
    for arch in ("NestedUNet", "UNet"):
        t0 = time.perf_counter()
        refs[arch] = plain, spread, movement, readings = cs._dp_reference(arch=arch)
        print(f"{arch} reference {time.perf_counter() - t0:.1f} s", flush=True)
        for k, r in readings.items():
            v = np.array(list(r.values()))
            print(f"  {arch} reading {k}: median {np.median(v):.3g}, max {v.max():.3g} "
                  f"({max(r, key=r.get)})", flush=True)
        for n in ("conv3_1.bn1.bias", "conv2_2.bn1.bias", "conv1_3.conv1.weight"):
            print(f"  {arch} {n}: {cs._readings_of(readings, n)} spread {spread[n]:.3g}",
                  flush=True)
    nested = refs["NestedUNet"]
    cs.dp_ranks(2, "gloo", nested, card, steps=3)
    cs.spatial_phase(bn, df, card, nested)
    run = "NestedUNet data=2,x=2"
    failed = None
    try:
        cs.spatial_ranks([run], "gloo", {run: nested}, card)
    except AssertionError as e:
        failed = e
        print("FAILED", str(e)[:600], flush=True)
    gate = {n: max(1e-4, cs.GATE_FACTOR * v) for n, v in nested[2].items()}
    for f in sorted(glob.glob(os.path.join(cs.SPATIAL_ROOT, "*data=2_x=2*", "*.pt"))):
        r = torch.load(f, weights_only=False)
        rel = cs._dp_rel(r["result"], nested[0])
        top = sorted(((rel[n] / gate[n], n, rel[n]) for n in rel), reverse=True)[:5]
        print(os.path.basename(f), [(round(a, 3), n, float(f"{b:.3g}")) for a, n, b in top],
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
