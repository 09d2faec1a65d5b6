#!/usr/bin/env python
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

1. header: the card's name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
2. build every CUDA kernel of the port from the sources in this checkout,
   print ptxas' registers and spills, and count the tensor-core (HMMA)
   instructions of each decoder-fusion kernel in its SASS (the bf16 kernels
   must have some, the fp32 ones none);
3. K4 kernel phase: the decoder-fusion kernel against its plain PyTorch
   version at the shapes the serving path gives it (NestedUNet full width,
   batch 16, 96x96) and at shapes on the edges of its tiling, in float32 and
   bfloat16, with its time (and TFLOP/s, share of the bound, launch plan),
   the plain version's, one library call's as a yardstick, and the
   card's bound for the same work; then the host time of one K4 call from
   Python, direct (every path but the artifact) and through the registered
   operator (the artifact's), and of the bf16 launch plan alone;
4. serving path phase: full-width NestedUNet with deep supervision served
   through `Predictor` (8 requests of 16 uint8 96x96 images, fp32 then bf16),
   with the launch counts of every kernel read around each run, a
   torch.profiler breakdown of a few more batches by kernel, and the fp32
   probabilities held against the same weights on the CPU;
5. K1-K3 kernel phase: one bn_stats and one bn_bwd_reduce call must each run
   one CUDA kernel (torch.profiler, level 0, both dtypes); then the
   training-mode BN kernels against their plain versions at the (C, rows)
   shapes of the NestedUNet, UNetRNN and VGG16RNN training steps (full
   width, batch 16, 96x96), at the other CRDN archs' shapes (C = 2, 8, 72,
   256, 512) and at ragged shapes, both dtypes, with bounds and library
   yardsticks, per shape and summed over each step's instances (30, 15 and
   18); times are device
   time replayed from a CUDA graph (a call from Python also pays the host's
   launch gaps, printed beside it as "call"); then each kernel's step
   sequence per step, its instances replayed from one graph;
6. K4 backward phase: the differentiable decoder-fusion op's gradients against
   autograd through its plain version at the 10 node shapes, and its time;
7. training path phase: `train.fit` on full-width NestedUNet wDS (batch 16,
   96x96, BCEDice, SGD, cosine LR, augment full) over a seeded synthetic set,
   3 epochs of 4 steps, bf16 then fp32, with the launch counts of every kernel
   read around each run, log.csv and model.pth checked and served, then steady
   ms/step and a torch.profiler window over a few more steps;
7b. whole-run trajectory (`trajectory_phase`): `train.fit` over the whole
   of PARITY_RUN.json's protocol (full-width NestedUNet wDS, BCEDice,
   48x48, 64 / 16 images of parity.py's data, batch 8, 15 epochs, augment
   none), fp32 then bf16, from the port's seed-41 init: 30 launches of
   each of K1-K3 per train step and 10 of K4 per forward, train and val;
   the fp32 curves held to the JAX package's on the CPU
   (tests/data/trajectory_NestedUNet_wDS.json, written by
   trajectory_golden.py): the epoch-0 train loss within 2e-3, every
   epoch's within 1e-3, the final val IoU within 0.05; the bf16 run's
   gaps to that golden and its final val IoU printed beside fp32's;
8. card against CPU: one full-width fp32 train step (batch 2, augment none)
   on the card and on the CPU from the same weights: loss, every gradient and
   the running statistics;
9. the CRDN path: phases 4, 7 and 8 for UNetRNN (GRU, feature_scale 4): no
   kernel launched in eval, 15 launches of each BN kernel per train step and
   no K4; in phase 8 the conv biases that feed a BN start at 0 (at their
   init the first BN's mean^2 / var is ~3e4 on these inputs, and the
   comparison would measure summation order), and each conv's card-vs-CPU
   gap on the same input is measured and its effect on the CPU's gradients
   counted in their bounds;
10. arch sweep (run between UNetRNN's phases 7 and 8): UNet, UNetRM3,
   UNetRM7, UNetRNN with the LSTM and vanilla decoders, UNetRNNGhost, the
   three attention variants, VGG16RNN with the GRU and vanilla decoders,
   ResNet{18,34,101,152}RNN, ResNet50UNet, ResNet50FCN (and the
   archs of 11c), each at full
   width, 96x96, batch 2, bf16: one train step and one served batch with
   their K1-K3 and K4 launches counted;
10b. the CRDN backbones: phases 4, 7 and 8 for VGG16RNN (LSTM, full width):
   no kernel launched in eval, 18 launches of each BN kernel per train step
   and no K4, the card-vs-CPU step as UNetRNN's (BN-fed conv biases at 0,
   the conv gap counted) with the CPU's movement under the card's own conv
   outputs counted too; phases 4 and 7 for ResNet50RNN (LSTM): 5 launches
   of each BN kernel per step (its score blocks; the trunk's BN is plain);
11. the CLI path (`cli_phase`): the reference protocol through the port's
   image-folder CLIs at full width (NestedUNet wDS, batch 16, 96x96, bf16):
   a DSB2018-sized synthetic folder (670 PNG pairs, written by the port's
   encoder) and its decode rate, `train.main` for 2 epochs, `--resume` to a
   3rd, `--pipeline host` for 1, `val.main` (IoU against Predictor's) and
   `infer.main` on images of other sizes (full-res 0/255 masks, probability
   masks against Predictor's), with exact launch counts;
11a. the serving artifact (`export_phase`, on the CLI path's capsule):
   `export.main` in fp32 and bf16 with --check true, export seconds and
   MB; the fp32 artifact loaded by a fresh process that imports no model
   code (10 K4 launches a batch of 16, within 1e-5 of the live Predictor);
   batches 1, 3 and 16 through one dynamic artifact (10 K4 launches each,
   1e-5), a pinned artifact refusing 3; `infer.main --artifact` over the
   serving folder, masks within 1 LSB of `infer.main --name`'s; the
   artifact's p50 / p95, img/s and device-busy ms beside the live
   Predictor's; `train.main --profile` for 1 bf16 epoch, its trace naming
   K1-K3's and K4's kernels;
11b. `--pretrained_backbone` (`pretrained_phase`): a torchvision-format
   ResNet-50 state dict written from a seed, `train.main --arch ResNet50RNN
   --pretrained_backbone` for 1 bf16 epoch on the CLI path's folder, the
   tensor count it prints, 5 x 33 launches of each BN kernel, and the
   capsule served by `infer.main`;
11c. the attention U-Nets and CA-Net (no kernel on their paths, so
   every K1-K4 count stays 0): phases 4 and 7 for AttU_Net (full width);
   R2U_Net, R2AttU_Net and CA-Net (1 class, dropout on; its default and its
   concatenation_residual gates) join the arch sweep; `canet_cli_phase`
   runs `train_canet.main` for 1 bf16 epoch on a 64-pair ISIC-layout PNG
   folder at 256x256 (the device-busy share, config.yml, the log) and
   `val.main` on its capsule;
11d. the PSP hybrids: phases 4, 7 and 8 for UNetRNNPSP (full width,
   feature_scale 4: UNetRNN's 15 BN launches per train step, none in eval,
   no K4; the refinement network's BNs are plain), its card-vs-CPU step
   also holding the loss and the running statistics to 4x their CPU
   movement (`step_floor`: the random-init cascade is chaotic in f32);
   UNetRNNCAttention_PSP joins the arch sweep;
11e. CascadePSP refinement (`refine_phase`, seeded weights, no kernel):
   the Refiner fast and full at L = 224 on a 320x480 diagonal scene, card
   against CPU by the golden rule (uint8 within 1 gray level, >= 99%
   exact), the mask-guided full pipeline (the global prediction replaced
   by the mask, so the tiles along its edge run) against the CPU and with
   tile_batch=3 against one tile per forward (1e-5); then ms per image at
   L = 900, fp32 and bf16, fast, full and mask-guided full, on a
   1200x1600 and a 96x96 image, with tiles run, busy share and peak
   memory; `refine_cli_phase`: `train_isic_ca.main` (NestedUNet, 1 bf16
   epoch) on a 40 + 8 pair ISIC-layout folder, then `val.main` without
   and with `--refine` (fast, full) and `infer.main --refine`, seconds and
   IoU, launches counted;
11f. `--remat` (`remat_phase`): full-width NestedUNet wDS, one fp32 train
   step under --remat none, full and policy from the same weights, K1-K4
   launches per step (30/30/30/10, 60/30/30/20, 30/30/30/10), the loss equal
   to the plain step's, the gradients within 1e-4 and the running
   statistics equal; then each mode's bf16 step p50 and peak device memory
   at batch 16 and 256;
11g. the last two archs, DoubleUnet and DeepLab (plain BN, no kernel: every
   K1-K4 count stays 0): their parameter and running-statistic counts
   against the JAX package's, phases 4 (with a TFLOP/s line on XLA's count
   of the JAX forward) and 7 at full width, the card-vs-CPU fp32 step
   (DoubleUnet's BN-fed conv biases at 0; DeepLab's dropouts at p = 0 on
   both sides, the loss and statistics also held to 4x their CPU movement:
   ASPP's pooled BN normalizes 2 values per channel at batch 2), and
   `deeplab_cli_phase`: `train.main --arch DeepLab` for 1 bf16 epoch on
   the CLI path's folder, `val.main` and `infer.main` on its capsule;
11h. data parallelism: `bn_finish_phase` (run after phase 5: K1's
   sums-only launch against the plain sums, the sums-only launch plus
   `bn_finish` equal to one K1 call bit for bit, `bn_finish` and K3 at a
   global row count against their plain versions, and `bn_finish`'s time
   over a step's 30 instances against its bound) and `dp_phase`
   (NestedUNet wDS, full width, 96x96, global batch 16: a world of one
   process over NCCL bitwise the non-distributed step, both under
   deterministic algorithms (`deterministic`), 30 launches of K1
   in its sums-only mode, `bn_finish`, K2 and K3 and 10 of K4 per step, its
   p50 / p95 and busy share beside the plain step's in fp32 and bf16; then
   two ranks on this card over Gloo, two processes of this script run as
   `--dp-worker`, each on its 8 rows against the one-process step);
11i. spatial partitioning (`spatial_phase`, the 'x'/'y' mesh axes): first
   `k4_empty_band` (MultipartConv3x3 on a band of zero rows, fp32 and
   bf16: an empty output, no K4 launch, its backward's weight and bias
   gradients the plain version's); then on
   this card over Gloo, NestedUNet wDS under data=1,x=2 (2 ranks, 2 steps)
   and UNet under x=2,y=2 (4 ranks, 1 step), full width, 96x96, global
   batch 16, fp32, each rank (`--spatial-worker`) against the one-process
   step (dp_phase's gates), 30 launches of K1 in its sums-only mode,
   `bn_finish`, K2 and K3 and 10 of K4 per NestedUNet step (18 and 4 for
   UNet), halo bytes and host ms in the halo exchange and `gather_bands`
   per step, the step's p50 (a correctness run); then on 2 of the ranks
   AttU_Net (no kernel) and UNetRNN (GRU; 15 of K1 sums-only, `bn_finish`,
   K2 and K3, its carry resized on bands) under x=2, and NestedUNet wDS
   under x=2 with --remat full (60 / 60 / 30 / 30, K4 20) and policy, each
   remat run also against the band step without remat on the same ranks
   (both under deterministic algorithms: 1e-4 relative L2, statistics
   equal) with each step's peak device memory a rank (policy's below
   none's); then VGG16RNN (18 of K1 sums-only, `bn_finish`, K2 and K3),
   UNetRNNAttention (15; exact PAM's keys and values all-gathered from both
   bands, CAM's gram all-reduced over them) and CA-Net (no kernel; its
   channel dropout on, each mask asserted equal on both bands and to the
   one-process step's) under x=2, each step's peak device memory a rank
   beside the one-process step's, the band all-gathers' and all-reduces'
   bytes and host ms beside the halo's; then `train.main --mesh x=2` over 2 processes
   (`--gloo-train`) on dp_cli's narrow folder against `--mesh data=1`;
11j. the 'model' mesh axis (`model_phase`): on this card over Gloo,
   NestedUNet wDS under data=2,model=2 (4 ranks, `--model-worker`; full
   width, 96x96, global batch 16, fp32, SGD) against data=2 on two of the
   same ranks, bitwise, both under deterministic algorithms (where the
   data=2 step is not deterministic, dp_ranks' gates against the
   one-process step), 30/30/30/30/10 launches
   of K1 (sums-only), bn_finish, K2, K3 and K4 per rank and step, the
   'model' peers bitwise alike after 3 steps and an eval step, each
   rank's bytes of parameters and optimizer state between steps beside the
   arithmetic 36.89 MB (73.31 MB replicated), a step's peak device memory,
   the bf16 step's p50 beside data=2's; then `train.main --mesh
   data=2,model=2 --checkpoint_backend orbax` for 2 epochs and `--resume`
   of its sharded directory under `--mesh data=4` (`model_cli`) against
   `--mesh data=1` on the same schedule;
12. a JSON line of the kernels (launches over every path above; `cli`: the
   CLI path's own; `remat_step`: per fp32 step in each --remat mode; `dp`:
   dp_phase's; `spatial`: spatial_phase's; `model`: model_phase's;
   `artifact`: K4's launches by export_phase's artifacts), then
   the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`python3 chip_smoke.py --dp-cards N` runs only the data-parallel check over
N cards of one host (NCCL, one process a card): each rank's fp32 step on
its 16/N rows against the one-process step, and the bf16 step's p50 at 16
rows a rank beside one card's; with N >= 4 then the 'model' axis
(data=2,model=2 and data=1,x=2,model=2 against data=2 and data=1,x=2, as
in 11j), the folder CLI, `train --mesh data=2,x=2` over 4 processes
against `--mesh data=1`, and last NestedUNet wDS under data=2,x=2 (each
rank against the one-process step, with the band step's own movement
readings), whose gate fails over NCCL (ROADMAP.md F3).

Any failed check raises, so the script exits non-zero and prints no result.
"""

import contextlib
import copy
import csv
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

# cuBLAS gives the same sums on every run only with a fixed workspace, which
# torch asks for before it runs a matmul under deterministic algorithms
# (`deterministic`); set before the first cuBLAS call, and inherited by the
# worker processes
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM data sheet (dense): bf16 tensor-core rate, float32 rate outside the
# tensor cores (TF32 is off here, so float32 work is held to it), HBM3 rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16"}

BATCH, SIZE = 16, 96
NB = (32, 64, 128, 256, 512)
# NestedUNet's decoder nodes: (name, H=W, part channels skips first, co)
NODES = [
    ("x0_1", 96, (32, 64), 32), ("x0_2", 96, (32, 32, 64), 32),
    ("x0_3", 96, (32, 32, 32, 64), 32), ("x0_4", 96, (32, 32, 32, 32, 64), 32),
    ("x1_1", 48, (64, 128), 64), ("x1_2", 48, (64, 64, 128), 64),
    ("x1_3", 48, (64, 64, 64, 128), 64),
    ("x2_1", 24, (128, 256), 128), ("x2_2", 24, (128, 128, 256), 128),
    ("x3_1", 12, (256, 512), 256),
]
# Edges of the kernels' tiling: (name, (B, H, W), part channels, co). A part
# whose channel count is not a multiple of 8 (bf16) or 4 (fp32) is staged by
# scalar loads, such a co by scalar weight loads and stores; H and W off the
# 12x12 pixel tile (ragged_25: in both directions) and co off the 32/64-wide
# slices leave ragged tiles; eight_parts, co_70_batch1, split_k and
# one_ch_parts (6 or more K chunks over few blocks) split K over clusters of
# 2 blocks.
RAGGED = [("single_part", (2, 13, 10), (7,), 5), ("three_part", (2, 13, 10), (5, 3, 8), 6),
          ("eight_parts", (2, 13, 10), (8, 16, 8, 24, 8, 8, 32, 40), 48),
          ("odd_part_between", (2, 12, 12), (32, 5, 64), 64),
          ("co_70_batch1", (1, 24, 24), (64, 128), 70),
          ("co_136_batch1", (1, 13, 10), (96, 40), 136),
          ("split_k", (1, 12, 12), (256, 200), 136),
          ("one_ch_parts", (2, 5, 33), (1,) * 8, 3), ("ragged_25", (2, 25, 25), (32, 64), 32)]
# The training step's BN work: (level, C, rows = 16*S*S, BN instances per step)
BN_LEVELS = [(lvl, NB[lvl], BATCH * (SIZE >> lvl) ** 2, n)
             for lvl, n in zip(range(5), (10, 8, 6, 4, 2))]
BN_RAGGED = [(c, rows) for c in (1, 3, 48, 70) for rows in (1, 37, 1000)]
BN_PER_STEP = sum(n for *_, n in BN_LEVELS)  # 30
# UNetRNN's train step (feature_scale 4: filters 16..256, batch 16, 96x96):
# (name, C, H = W, BN instances per step) -- two encoder BNs per level and a
# score block's BN at C = num_classes = 1 per level
CRDN_FILTERS = (16, 32, 64, 128, 256)
UNETRNN_BN = ([(f"enc{lvl}", c, SIZE >> lvl, 2) for lvl, c in enumerate(CRDN_FILTERS)]
              + [(f"score{lvl}", 1, SIZE >> lvl, 1) for lvl in range(5)])
UNETRNN_BN_PER_STEP = sum(n for *_, n in UNETRNN_BN)  # 15
# VGG16RNN's train step (full width, LSTM, batch 16, 96x96): its 13 encoder
# units (64, 128, 256, 512, 512 channels; 2, 2, 3, 3, 3 per stage) and a 5x5
# score block's BN at C = num_classes = 1 per stage: 18 per step
VGG16RNN_BN = ([(f"enc{lvl}", c, SIZE >> lvl, n)
                for lvl, (c, n) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)))]
               + [(f"score{lvl}", 1, SIZE >> lvl, 1) for lvl in range(5)])
VGG16RNN_BN_PER_STEP = sum(n for *_, n in VGG16RNN_BN)  # 18
# ResNet50RNN's K1-K3 run at its 5 score blocks only (its trunk's 53 BN
# layers are plain F.batch_norm, as in the JAX package)
RESNET_RNN_BN_PER_STEP = 5
# UNetRM7's train step: two encoder BNs and a score block's BN at each of its
# 7 levels (96 rows: 96, 48, 24, 12, 6, 3, 1)
UNETRM7_BN_PER_STEP = 21
# BN shapes of the other new archs that neither step above has: num_classes
# 2 at level 0, RM7's level 0 and its 3x3 and 1x1 levels, RM3's level 1
CRDN_EXTRA_BN = [("nc2", 2, SIZE), ("rm7_l0", 8, SIZE), ("rm3_l1", 72, SIZE >> 1),
                 ("rm7_l5", 256, 3), ("rm7_l6", 512, 1)]
# The other new archs, each driven once at full width (96x96, batch 2):
# (arch, arch_kwargs, train-mode BN layers = K1-K3 launches per step, K4
# launches per forward)
ARCH_SWEEP = [("UNet", {}, 18, 4), ("UNetRM3", {}, 9, 0), ("UNetRM7", {}, 21, 0),
              ("UNetRNN", {"decoder": "LSTM"}, 15, 0), ("UNetRNN", {"decoder": "vanilla"}, 15, 0),
              ("UNetRNNGhost", {}, 10, 0), ("UNetRNNPAttention", {}, 15, 0),
              ("UNetRNNCAttention", {}, 15, 0), ("UNetRNNAttention", {}, 15, 0),
              ("VGG16RNN", {"decoder": "GRU"}, 18, 0), ("VGG16RNN", {"decoder": "vanilla"}, 18, 0),
              ("ResNet18RNN", {}, 5, 0), ("ResNet34RNN", {}, 5, 0), ("ResNet101RNN", {}, 5, 0),
              ("ResNet152RNN", {}, 5, 0), ("ResNet50UNet", {}, 0, 0), ("ResNet50FCN", {}, 0, 0),
              ("R2U_Net", {}, 0, 0), ("R2AttU_Net", {}, 0, 0),
              ("Comprehensive_Atten_Unet", {}, 0, 0),
              ("Comprehensive_Atten_Unet", {"nonlocal_mode": "concatenation_residual"}, 0, 0),
              ("UNetRNNCAttention_PSP", {}, 15, 0)]
LOG_COLUMNS = ["epoch", "lr", "loss", "iou", "val_loss", "val_iou"]


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps=10):
    """Mean device ms of fn() over `reps` runs, each timed by CUDA events after
    the L2 cache was flushed, so inputs come from device memory."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def graph_ms(fn, flush, reps=10):
    """Mean device ms of fn() replayed from a CUDA graph, each replay timed by
    CUDA events after an L2 flush: the work's own time on the card, without
    the host's launch gaps between its kernels (which `time_ms` counts)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, flush, reps)


def profiled_ms(fn, reps=5):
    """Mean device ms of the kernels fn() launches (torch.profiler), for work
    that a CUDA graph cannot capture (an autograd backward): the kernels' own
    time, without the host's gaps between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def conv_bound_ms(b, h, w, cps, co, dtype):
    """Least time for conv3x3 over the parts: each input and weight read once,
    the output written once, 2*9*cin*co operations per output pixel."""
    esz = torch.finfo(dtype).bits // 8
    cin = sum(cps)
    nbytes = (b * h * w * (cin + co) + 9 * cin * co) * esz + co * 4
    flops = 2.0 * b * h * w * 9 * cin * co
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


# K4's nodes take 0.04-0.8 ms; single runs of the bf16 kernel spread by up to
# 30% between calls, so each time is the mean of 30 flushed runs.
K4_REPS = 30


def kernel_phase(df, dev):
    """K4 against its plain version; returns {dtype: summary} over the nodes.
    Prints each case's TFLOP/s and share of the bound and the launch the
    kernel makes (pixel tile, co per block, K split, blocks)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
    F = torch.nn.functional
    node_names = {n[0] for n in NODES}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        agg = {"max_abs_err": 0.0, "nodes_max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0, "operations": 0.0}
        cases = [(n, (BATCH, s, s), cps, co) for n, s, cps, co in NODES] + RAGGED
        for name, (b, h, w), cps, co in cases:
            cin = sum(cps)
            parts = [torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
                     for c in cps]
            kernel = (torch.randn(3, 3, cin, co, generator=gen, device=dev)
                      / (9 * cin) ** 0.5).to(dtype)
            bias = torch.randn(co, generator=gen, device=dev) * 0.1
            got = df.multipart_conv3x3(parts, kernel, bias)
            torch.cuda.synchronize()
            # the plain version in float32 on the same (rounded) inputs
            want = df.reference_multipart_conv3x3([p.float() for p in parts],
                                                  kernel.float(), bias)
            err = (got.float() - want).abs().max().item()
            tol = TOL[dtype]
            if not torch.allclose(got.float(), want, atol=tol, rtol=tol):
                raise AssertionError(f"K4 {name} {DTYPE_NAME[dtype]}: max abs err {err} "
                                     f"outside atol=rtol={tol}")
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            ms = time_ms(lambda: df.multipart_conv3x3(parts, kernel, bias), flush, K4_REPS)
            plain_ms = time_ms(lambda: df.reference_multipart_conv3x3(parts, kernel, bias),
                               flush, K4_REPS)
            w_oihw = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib_bias = bias.to(dtype)
            lib_ms = time_ms(lambda: F.conv2d(torch.cat(parts, -1).permute(0, 3, 1, 2),
                                              w_oihw, lib_bias, padding=1), flush, K4_REPS)
            bound, by = conv_bound_ms(b, h, w, cps, co, dtype)
            tflops = 2.0 * b * h * w * 9 * cin * co / (ms * 1e-3) / 1e12
            plan = df.launch_plan(dtype, b, h, w, cps, co)
            grid = (f" | tile {plan['tile_h']}x{plan['tile_w']}x{plan['co_per_block']}, "
                    f"split {plan['split']}, {plan['blocks']} blocks of {plan['threads']}")
            print(f"K4 {DTYPE_NAME[dtype]} {name:11s} B={b} {h}x{w} parts={cps} co={co}: "
                  f"max_abs_err {err:.3g} (tol {tol}) | kernel {ms:.4f} ms "
                  f"({tflops:.1f} TFLOP/s, {100 * bound / ms:.1f}% of bound) | plain "
                  f"{plain_ms:.4f} ms | library {lib_ms:.4f} ms | bound {bound:.4g} ms "
                  f"({by}){grid}", flush=True)
            if name in node_names:  # the serving path's work: one forward
                agg["nodes_max_abs_err"] = max(agg["nodes_max_abs_err"], err)
                agg["ms"] += ms
                agg["plain_ms"] += plain_ms
                agg["library_ms"] += lib_ms
                agg["bound_ms"] += bound
                agg[by] += bound
        agg["bound_by"] = "bytes" if agg.pop("bytes") > agg.pop("operations") else "operations"
        print(f"K4 {DTYPE_NAME[dtype]} over the 10 nodes of one forward: kernel {agg['ms']:.4f} "
              f"ms | plain {agg['plain_ms']:.4f} ms | library {agg['library_ms']:.4f} ms | "
              f"bound {agg['bound_ms']:.4f} ms ({agg['bound_by']})", flush=True)
        out[dtype] = agg
    return out


def k4_host_us(df, dev, calls=200, rounds=5):
    """Host time in us of one K4 call from Python (enqueue only, at a small
    shape) in each dtype, as every path but the artifact calls it (the
    direct launch) and through the registered operator (the exported
    artifact's call), and of the bf16 launch plan alone through its C query:
    the best of `rounds` rounds of `calls` calls each."""
    import ctypes

    def best_us(fn):
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return best

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        parts = [torch.randn(2, 12, 12, 32, device=dev).to(dtype) for _ in range(2)]
        kernel = torch.randn(3, 3, 64, 32, device=dev).to(dtype)
        bias = torch.randn(32, device=dev)
        for _ in range(20):
            df.multipart_conv3x3(parts, kernel, bias)
        out[DTYPE_NAME[dtype]] = best_us(lambda: df.multipart_conv3x3(parts, kernel, bias))
        op = torch.ops.nested_unet_torch.multipart_conv3x3
        out[f"{DTYPE_NAME[dtype]} operator"] = best_us(lambda: op(parts, kernel, bias))
    chans, plan = (ctypes.c_int * 2)(32, 32), (ctypes.c_int * 7)()
    query = df._lib().decoder_fusion_plan
    out["bf16 plan"] = best_us(lambda: query(1, 2, 12, 12, 32, chans, 2, plan))
    print("K4 host us per call from Python (best of "
          f"{rounds} x {calls}): " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()),
          flush=True)
    return out


def hmma_counts(build, name):
    """Tensor-core (HMMA) instructions per kernel in the SASS of csrc/<name>.cu
    as built (cuobjdump beside nvcc)."""
    tool = os.path.join(os.path.dirname(os.path.realpath(build.nvcc_path())), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build._lib_path(name)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bHMMA\b", line):
            counts[fn] += 1
    return counts


def _activities(host_ops):
    """The profiler's activities: the card's kernels and copies, and the
    host's operators only where they are listed (tracing them is what makes
    a window of a large arch slow to read back)."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])


def profile_batches(pred, request, precision, host_ops=0):
    """Device time by kernel over a few served batches (torch.profiler), the
    share of the window in which some kernel or copy ran, and with host_ops
    > 0 the host's busiest operators (self CPU time); returns (wall, device
    busy) ms per batch."""
    from torch.profiler import profile

    batches = 3

    with profile(activities=_activities(host_ops)) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            pred.predict_u8(request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()  # aggregated once: slow for the large archs' traces
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"profile {precision}: {batches} batches, wall {wall_ms / batches:.3f} ms/batch, "
          f"device busy {busy_ms / batches:.3f} ms/batch ({100 * busy_ms / wall_ms:.1f}% "
          f"of wall; profiler on)")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms / batches:8.3f} ms/batch {100 * ms / busy_ms:5.1f}%  "
              f"x{e.count // batches:<3d} {e.key[:110]}")
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:host_ops]
    for e in host:
        print(f"  host {e.self_cpu_time_total / 1e3 / batches:8.3f} ms/batch "
              f"x{e.count // batches:<4d} {e.key[:100]}")
    return wall_ms / batches, busy_ms / batches


def path_phase(bn, df, card, arch="NestedUNet", deep_supervision=True, k4_per_batch=10,
               gflop=None):
    """Serve full-width `arch` through Predictor in fp32 and bf16: 8 requests of
    16 images, the launch counts read around each run (eval BN runs no K1-K3;
    K4 `k4_per_batch` times a batch), the fp32 probabilities held against the
    CPU. `gflop`, when given, is a yardstick count of one batch's forward
    (XLA's cost analysis of the JAX package's), printed as TFLOP/s at the
    steady p50. Returns the launch counts per precision."""
    from pytorch_nested_unet_tpu_torch.infer import Predictor

    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
                for _ in range(8)]
    launches, probs = {}, {}
    label = f"{arch}{' wDS' if deep_supervision else ''}"
    for precision in ("fp32", "bf16"):
        pred = Predictor(arch, 1, 3, deep_supervision=deep_supervision, precision=precision,
                         batch_size=BATCH, seed=0, device="cuda")
        reset_counts(bn, df)
        outs = [pred.predict_u8(r) for r in requests]
        counts = launch_counts(bn, df)
        launches[precision] = counts
        want = {**bn_want(0), "multipart_conv3x3": k4_per_batch * len(requests)}
        if counts != want:
            raise AssertionError(f"serve {label} {precision}: launches {counts}, expected {want} "
                                 f"(K4 at {k4_per_batch} decoder nodes x {len(requests)} batches, "
                                 "no K1-K3 in eval)")
        y = np.concatenate(outs)
        if y.shape != (len(requests) * BATCH, SIZE, SIZE, 1) or not np.isfinite(y).all() \
                or y.min() < 0 or y.max() > 1:
            raise AssertionError(f"{precision}: bad probabilities {y.shape} "
                                 f"[{np.nanmin(y)}, {np.nanmax(y)}]")
        probs[precision] = y
        s = pred.summary()
        rate = "" if gflop is None else (
            f", {gflop / s['p50_ms']:.2f} TFLOP/s at p50 on XLA's count of the JAX forward "
            f"({gflop} GFLOP per batch)")
        print(f"path {precision}: {label} batch {BATCH} {SIZE}x{SIZE}, "
              f"{s['batches']} batches: steady p50 {s['p50_ms']:.3f} ms, p95 "
              f"{s['p95_ms']:.3f} ms, {s['img_per_s']:.1f} img/s (first batch "
              f"{s['first_batch_ms']:.1f} ms){rate} | launches {counts} | card: {card}",
              flush=True)
        profile_batches(pred, requests[0], f"{label} {precision}")
        if precision == "fp32":
            sd = {k: v.cpu() for k, v in pred.model.state_dict().items()}
            cpu = Predictor(arch, 1, 3, deep_supervision=deep_supervision, precision="fp32",
                            batch_size=2, weights=sd, device="cpu")
            ref = cpu.predict_u8(requests[0][:2])
            err = float(np.abs(y[:2] - ref).max())
            print(f"path {label} fp32 vs CPU plain path, 2 images: max abs err {err:.3g} "
                  "(atol 1e-4)")
            if err > 1e-4:
                raise AssertionError(f"{label} fp32 card vs CPU: max abs err {err} > 1e-4")
    # bf16 rounds activations and weights at every layer; the same seeded
    # weights give probabilities within 2e-4 (NestedUNet) and 4e-4 (UNetRNN)
    # of fp32 on the card (PERF.md)
    err = float(np.abs(probs["bf16"] - probs["fp32"]).max())
    print(f"path {label} bf16 vs fp32 probabilities: max abs diff {err:.3g} (atol 1e-2)")
    if err > 1e-2:
        raise AssertionError(f"{label} bf16 vs fp32 probabilities: max abs diff {err} > 1e-2")
    return launches


# K1-K3 tolerances. The per-channel sums (K1's sum x and sum x^2, K2's dbeta
# and dgamma) are f32 in both versions and differ by summation order only;
# dbeta and dgamma add terms of either sign, so the error is held against
# the sum of the summands' magnitudes: |kernel - plain| <= 1e-6 * sum |term|
# (f32 rounding is 1.2e-7 of that scale per add). The rest against the plain
# version in f32 on the same (rounded) inputs: mean, var, inv and the running
# stats atol = rtol = 1e-5 (f32) / 1e-4 (bf16); dx 1e-4 (f32) / 1e-2 (bf16,
# one rounding of the output).
SUM_TOL = 1e-6
BN_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-4, 1e-2)}
# float32 operations per element (FP32 cores) and bytes moved per element in
# units of the activation dtype: K1 reads x; K2 reads x, dy; K3 reads x, dy
# and writes dx. Per-channel vectors are added to the byte count.
BN_OPS = {"K1": 3, "K2": 8, "K3": 9}
BN_PASSES = {"K1": 1, "K2": 2, "K3": 3}
BN_VECTORS = {"K1": 9, "K2": 6, "K3": 6}


def bn_bound_ms(kernel, rows, c, dtype):
    esz = torch.finfo(dtype).bits // 8
    nbytes = rows * c * esz * BN_PASSES[kernel] + BN_VECTORS[kernel] * c * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = rows * c * BN_OPS[kernel] / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def _max_err(got, want, tol, what):
    err = 0.0
    for a, b in zip(got, want):
        err = max(err, (a.float() - b.float()).abs().max().item())
        if not torch.allclose(a.float(), b.float(), atol=tol, rtol=tol):
            raise AssertionError(f"{what}: max abs err {err} outside atol=rtol={tol}")
    return err


def _sum_err(got, want, mags, what):
    """Max abs error of per-channel sums; raises if any exceeds SUM_TOL times
    its channel's sum of summand magnitudes."""
    err = worst = 0.0
    for a, b, m in zip(got, want, mags):
        d = (a - b).abs()
        err = max(err, d.max().item())
        worst = max(worst, (d / m.clamp_min(1e-30)).max().item())
    if worst > SUM_TOL:
        raise AssertionError(f"{what}: a sum is off by {worst:.3g} of its summands' "
                             f"magnitude (tol {SUM_TOL}); max abs err {err}")
    return err


def bn_kernels_per_call(bn, dev):
    """CUDA kernels one bn_stats (K1) and one bn_bwd_reduce (K2) call run at
    level 0 (147,456 x 32), in each dtype, counted by torch.profiler; raises
    unless each is one. A window in which the profiler recorded no device
    event at all (CUPTI can drop a short window; launches and results are
    checked elsewhere) is profiled again, up to 8 times, half a second apart
    (a card run has seen three empty windows in a row there, right after
    the same profiler had traced the path phase)."""
    from torch.profiler import ProfilerActivity, profile

    _, c, rows, _ = BN_LEVELS[0]
    gen = torch.Generator(device=dev).manual_seed(4)
    vecs = [torch.rand(c, generator=gen, device=dev) + 0.5 for _ in range(4)]
    found = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, dy = (torch.randn(rows, c, generator=gen, device=dev).to(dtype) for _ in range(2))
        rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        calls = {"K1": lambda: bn.bn_stats(x, 1e-5, rm, rv),
                 "K2": lambda: bn.bn_bwd_reduce(x, dy, *vecs)}
        for k, call in calls.items():
            call()
            torch.cuda.synchronize()
            for attempt in range(8):
                if attempt:
                    time.sleep(0.5)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                names = [e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
                if names:
                    break
            found[f"{k} {DTYPE_NAME[dtype]}"] = names
            if len(names) != 1:
                raise AssertionError(f"{k} {DTYPE_NAME[dtype]}: one call ran {len(names)} "
                                     f"CUDA kernels, expected 1: {names}")
    print("CUDA kernels per bn_stats (K1) and bn_bwd_reduce (K2) call at level 0 "
          "(torch.profiler): " + "; ".join(f"{k} {len(v)} ({v[0][:60]})"
                                           for k, v in found.items()), flush=True)


def bn_step_sequence(bn, dev, dtype, gen, flush, step, label):
    """K1-K3, their plain versions and library calls over the BN instances of
    one training step, `step` = [(C, H = W, instances)] at batch 16, each
    instance on its own buffers, each set captured in one CUDA graph and
    replayed after one L2 flush: the graph timing floor is paid once per
    step, not once per instance. K1 updates running stats, as in the step.
    Returns {kernel: (kernel, plain, library ms)}."""
    nbb = torch.ops.aten.native_batch_norm_backward
    insts = []
    for c, hw, n in step:
        nhw, rows = (BATCH, hw, hw), BATCH * hw * hw
        for _ in range(n):
            x = (torch.randn(rows, c, generator=gen, device=dev) * 1.5 + 0.3).to(dtype)
            dy = torch.randn(rows, c, generator=gen, device=dev).to(dtype)
            gamma = torch.rand(c, generator=gen, device=dev) + 0.5
            beta = torch.rand(c, generator=gen, device=dev) * 0.6 - 0.3
            _, _, mean, _, inv = bn.reference_bn_stats(x.float())
            db, dg = bn.reference_bn_bwd_reduce(x.float(), dy.float(), mean, inv, gamma, beta)
            xhat = (x.float() - mean) * inv
            dz4 = torch.where(gamma * xhat + beta > 0, dy.float(), 0.0).to(dtype) \
                .view(*nhw, c).permute(0, 3, 1, 2)
            insts.append(dict(x=x, dy=dy, p=(mean, inv, gamma, beta), db=db, dg=dg, dz4=dz4,
                              x4=x.view(*nhw, c).permute(0, 3, 1, 2),
                              run=(torch.zeros(c, device=dev), torch.ones(c, device=dev))))

    def each(fn):
        return lambda: [fn(i) for i in insts]

    fns = {
        "K1": (each(lambda i: bn.bn_stats(i["x"], 1e-5, *i["run"])),
               each(lambda i: bn.reference_bn_stats(i["x"], 1e-5, *i["run"])),
               each(lambda i: torch.var_mean(i["x"], dim=0, correction=0))),
        "K2": (each(lambda i: bn.bn_bwd_reduce(i["x"], i["dy"], *i["p"])),
               each(lambda i: bn.reference_bn_bwd_reduce(i["x"], i["dy"], *i["p"])),
               each(lambda i: nbb(i["dz4"], i["x4"], i["p"][2], None, None, i["p"][0],
                                  i["p"][1], True, 1e-5, [False, True, True]))),
        "K3": (each(lambda i: bn.bn_bwd_dx(i["x"], i["dy"], *i["p"], i["db"], i["dg"])),
               each(lambda i: bn.reference_bn_bwd_dx(i["x"], i["dy"], *i["p"], i["db"],
                                                     i["dg"])),
               each(lambda i: nbb(i["dz4"], i["x4"], i["p"][2], None, None, i["p"][0],
                                  i["p"][1], True, 1e-5, [True, False, False]))),
    }
    out = {k: tuple(graph_ms(f, flush) for f in trio) for k, trio in fns.items()}
    print(f"BN {DTYPE_NAME[dtype]} {label} step sequence (the {len(insts)} instances of one "
          "step in one CUDA graph, one L2 flush before each replay): " + " | ".join(
              f"{k} kernel {t[0]:.4f} ms plain {t[1]:.4f} library {t[2]:.4f}"
              for k, t in out.items()), flush=True)
    return out


# The BN steps whose instances bn_kernel_phase sums: path -> [(C, H = W,
# instances per step)] at batch 16
BN_STEPS = {"NestedUNet": [(c, SIZE >> lvl, n) for lvl, c, _, n in BN_LEVELS],
            "UNetRNN": [(c, hw, n) for _, c, hw, n in UNETRNN_BN],
            "VGG16RNN": [(c, hw, n) for _, c, hw, n in VGG16RNN_BN]}


def bn_kernel_phase(bn, dev):
    """K1-K3 against their plain versions at NestedUNet's, UNetRNN's and
    VGG16RNN's training-step shapes, the other new archs' shapes and ragged
    shapes; returns {(kernel, dtype, path): summary} with times summed over
    the BN instances of one training step of `path` (30 for NestedUNet, 15
    for UNetRNN, 18 for VGG16RNN). Each dtype ends with each path's step
    sequence (`bn_step_sequence`)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    nbb = torch.ops.aten.native_batch_norm_backward
    # the method's floor: one 4-byte fill kernel timed the same way
    tiny = torch.empty(1, device=dev)
    print(f"BN timing floor: one 4-byte fill replayed from a CUDA graph after the L2 flush "
          f"takes {graph_ms(tiny.zero_, flush):.4f} ms", flush=True)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        vec_tol, dx_tol = BN_TOL[dtype]
        aggs = {(path, k): {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                            "bound_ms": 0.0, "bytes": 0.0, "operations": 0.0, "call_ms": 0.0}
                for path in BN_STEPS for k in BN_OPS}
        # (name, C, rows, instances per step of each path, N/H/W of the rows)
        cases = [(f"level{lvl}", c, rows, {"NestedUNet": n}, (BATCH, SIZE >> lvl, SIZE >> lvl))
                 for lvl, c, rows, n in BN_LEVELS]
        cases += [(f"rnn_{name}", c, BATCH * hw * hw, {"UNetRNN": n}, (BATCH, hw, hw))
                  for name, c, hw, n in UNETRNN_BN]
        for name, c, hw, n in VGG16RNN_BN:  # a shape UNetRNN's step has too is run once
            same = [case for case in cases if case[1:3] == (c, BATCH * hw * hw)]
            if same:
                same[0][3]["VGG16RNN"] = n
            else:
                cases.append((f"vgg_{name}", c, BATCH * hw * hw, {"VGG16RNN": n}, (BATCH, hw, hw)))
        cases += [(name, c, BATCH * hw * hw, {}, (BATCH, hw, hw)) for name, c, hw in CRDN_EXTRA_BN]
        cases += [("ragged", c, rows, {}, (1, rows, 1)) for c, rows in BN_RAGGED]
        for name, c, rows, counts, nhw in cases:
            x = (torch.randn(rows, c, generator=gen, device=dev) * 1.5 + 0.3).to(dtype)
            dy = torch.randn(rows, c, generator=gen, device=dev).to(dtype)
            gamma = torch.rand(c, generator=gen, device=dev) + 0.5
            beta = torch.rand(c, generator=gen, device=dev) * 0.6 - 0.3
            xf, dyf = x.float(), dy.float()
            rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
            rm_ref, rv_ref = rm.clone(), rv.clone()
            what = f"{DTYPE_NAME[dtype]} C={c} rows={rows}"
            got = bn.bn_stats(x, 1e-5, rm, rv)
            want = bn.reference_bn_stats(xf, 1e-5, rm_ref, rv_ref)
            torch.cuda.synchronize()
            # K1's reported error is that of what the step consumes: mean, var,
            # inv and the running stats (its sums are checked by magnitude)
            _sum_err(got[:2], want[:2], [xf.abs().sum(0), (xf * xf).sum(0)], f"K1 {what}")
            errs = {"K1": _max_err([*got[2:], rm, rv], [*want[2:], rm_ref, rv_ref], vec_tol,
                                   f"K1 {what}")}
            mean, inv = want[2], want[4]
            db, dg = bn.bn_bwd_reduce(x, dy, mean, inv, gamma, beta)
            ref_db, ref_dg = bn.reference_bn_bwd_reduce(xf, dyf, mean, inv, gamma, beta)
            torch.cuda.synchronize()
            xhat = (xf - mean) * inv
            dz = torch.where(gamma * xhat + beta > 0, dyf, 0.0)
            errs["K2"] = _sum_err([db, dg], [ref_db, ref_dg],
                                  [dz.abs().sum(0), (dz * xhat).abs().sum(0)], f"K2 {what}")
            dx = bn.bn_bwd_dx(x, dy, mean, inv, gamma, beta, ref_db, ref_dg)
            ref_dx = bn.reference_bn_bwd_dx(xf, dyf, mean, inv, gamma, beta, ref_db, ref_dg)
            torch.cuda.synchronize()
            errs["K3"] = _max_err([dx], [ref_dx], dx_tol, f"K3 {what}")
            # library yardsticks on the NHWC activation's channels_last view
            x4 = x.view(*nhw, c).permute(0, 3, 1, 2)
            dz4 = dz.to(dtype).view(*nhw, c).permute(0, 3, 1, 2)
            fns = {
                "K1": (lambda: bn.bn_stats(x), lambda: bn.reference_bn_stats(x),
                       lambda: torch.var_mean(x, dim=0, correction=0)),
                "K2": (lambda: bn.bn_bwd_reduce(x, dy, mean, inv, gamma, beta),
                       lambda: bn.reference_bn_bwd_reduce(x, dy, mean, inv, gamma, beta),
                       lambda: nbb(dz4, x4, gamma, None, None, mean, inv, True, 1e-5,
                                   [False, True, True])),
                "K3": (lambda: bn.bn_bwd_dx(x, dy, mean, inv, gamma, beta, ref_db, ref_dg),
                       lambda: bn.reference_bn_bwd_dx(x, dy, mean, inv, gamma, beta,
                                                      ref_db, ref_dg),
                       lambda: nbb(dz4, x4, gamma, None, None, mean, inv, True, 1e-5,
                                   [True, False, False])),
            }
            parts = []
            for k, (kern, plain, lib) in fns.items():
                ms, plain_ms, lib_ms = (graph_ms(f, flush) for f in (kern, plain, lib))
                call_ms = time_ms(kern, flush)
                bound, by = bn_bound_ms(k, rows, c, dtype)
                for path, count in counts.items():  # the shapes of the path's step
                    a = aggs[(path, k)]
                    a["max_abs_err"] = max(a["max_abs_err"], errs[k])
                    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                                   ("bound_ms", bound), (by, bound), ("call_ms", call_ms)):
                        a[key] += count * v
                parts.append(f"{k} err {errs[k]:.3g} kernel {ms:.4f} ({100 * bound / ms:.1f}% of "
                             f"bound; call {call_ms:.4f}) plain {plain_ms:.4f} library "
                             f"{lib_ms:.4f} bound {bound:.4f} ({by})")
            count = sum(counts.values())
            print(f"BN {DTYPE_NAME[dtype]} {name:10s} C={c:<3d} rows={rows:<6d} x{count:<2d}| "
                  + " | ".join(parts), flush=True)
        for (path, k), a in aggs.items():
            a["bound_by"] = "bytes" if a.pop("bytes") > a.pop("operations") else "operations"
            call_ms = a.pop("call_ms")
            out[(k, dtype, path)] = a
            n = sum(i for *_, i in BN_STEPS[path])
            print(f"BN {DTYPE_NAME[dtype]} {k} over the {n} instances of one {path} step: "
                  f"kernel {a['ms']:.4f} ms (per call from Python: {call_ms:.4f} ms) | plain "
                  f"{a['plain_ms']:.4f} ms | library "
                  f"{a['library_ms']:.4f} ms | bound {a['bound_ms']:.4f} ms ({a['bound_by']}) "
                  f"| max abs err {a['max_abs_err']:.3g}", flush=True)
        for path, step in BN_STEPS.items():
            bn_step_sequence(bn, dev, dtype, gen, flush, step, path)
    return out


def k4_backward_phase(df, dev):
    """The differentiable decoder-fusion op's gradients against autograd
    through the plain version (f32, batch 4, 1e-4 relative L2 norm), then its
    backward's time at the training step's shapes (batch 16)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    worst = 0.0
    for name, s, cps, co in NODES:
        parts = [torch.randn(4, s, s, c, generator=gen, device=dev) for c in cps]
        weight = torch.randn(co, sum(cps), 3, 3, generator=gen, device=dev) / (9 * sum(cps)) ** 0.5
        bias = torch.randn(co, generator=gen, device=dev) * 0.1
        ct = torch.randn(4, s, s, co, generator=gen, device=dev)
        ins = [t.clone().requires_grad_(True) for t in (*parts, weight, bias)]
        got = torch.autograd.grad(df.conv3x3_parts(ins[:-2], ins[-2], ins[-1]), ins, ct)
        ref_ins = [t.clone().requires_grad_(True) for t in (*parts, weight, bias)]
        want = torch.autograd.grad(df.reference_multipart_conv3x3(
            ref_ins[:-2], ref_ins[-2].permute(2, 3, 1, 0), ref_ins[-1]), ref_ins, ct)
        for g, w in zip(got, want):
            rel = ((g - w).norm() / w.norm()).item()
            worst = max(worst, rel)
            if rel > 1e-4:
                raise AssertionError(f"K4 backward {name}: relative L2 error {rel} > 1e-4")
    print(f"K4 backward: dparts, dweight, dbias at the 10 node shapes (batch 4, fp32) "
          f"within {worst:.3g} relative L2 of autograd through the plain version (tol 1e-4)",
          flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        total = plain_total = dev_total = dev_plain_total = 0.0
        for name, s, cps, co in NODES:
            parts = [torch.randn(BATCH, s, s, c, generator=gen, device=dev).to(dtype)
                     .requires_grad_(True) for c in cps]
            weight = (torch.randn(co, sum(cps), 3, 3, generator=gen, device=dev)
                      / (9 * sum(cps)) ** 0.5).requires_grad_(True)
            bias = torch.zeros(co, device=dev, requires_grad=True)
            ct = torch.randn(BATCH, s, s, co, generator=gen, device=dev).to(dtype)
            out = df.conv3x3_parts(parts, weight, bias)
            ins = [*parts, weight, bias]
            ref = df.reference_multipart_conv3x3(parts, weight.permute(2, 3, 1, 0), bias)
            def bwd(out=out, ins=ins, ct=ct):
                return torch.autograd.grad(out, ins, ct, retain_graph=True)

            def bwd_plain(ref=ref, ins=ins, ct=ct):
                return torch.autograd.grad(ref, ins, ct, retain_graph=True)

            total += time_ms(bwd, flush)
            plain_total += time_ms(bwd_plain, flush)
            dev_total += profiled_ms(bwd)
            dev_plain_total += profiled_ms(bwd_plain)
        print(f"K4 backward {DTYPE_NAME[dtype]}: the 10 nodes' conv VJP at batch 16 take "
              f"{dev_total:.4f} ms of device time ({total:.4f} ms per call from Python, "
              f"L2 flushed); autograd through the plain torch.cat + conv: "
              f"{dev_plain_total:.4f} ms ({plain_total:.4f} ms per call)", flush=True)


def synthetic_set(n, seed, hw=SIZE):
    """Seeded segmentation images: 1-3 rotated ellipses (the mask) over a
    textured background, red rectangles as distractors, pixel noise;
    parity.py's make_synthetic_dataset at one class, line for line (the
    port's scripts import nothing of the JAX package's harness;
    tests/test_torch_trajectory.py holds the two equal)."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, hw, hw, 3), np.uint8)
    masks = np.zeros((n, hw, hw, 1), np.uint8)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(n):
        img = rng.integers(40, 120, (hw, hw, 3)).astype(np.float32)
        m = np.zeros((hw, hw), bool)
        for _ in range(int(rng.integers(1, 4))):
            cy = rng.integers(hw // 6, hw - hw // 6)
            cx = rng.integers(hw // 6, hw - hw // 6)
            ry, rx = rng.integers(max(2, hw // 12), max(3, hw // 5), 2)
            ang = rng.uniform(0, np.pi)
            ca, sa = np.cos(ang), np.sin(ang)
            u = (yy - cy) * ca + (xx - cx) * sa
            v = -(yy - cy) * sa + (xx - cx) * ca
            m |= (u / ry) ** 2 + (v / rx) ** 2 < 1.0
        img[m] += np.asarray([25, 60, 25], np.float32)
        rect = np.zeros((hw, hw), bool)
        if rng.random() < 0.7:
            y0 = rng.integers(0, max(1, hw - hw // 4))
            x0 = rng.integers(0, max(1, hw - hw // 4))
            rect[y0:y0 + hw // 6, x0:x0 + hw // 6] = True
            img[rect] += np.asarray([70, 20, 20], np.float32)
        img += rng.normal(0, 12, img.shape)
        images[i] = np.clip(img, 0, 255).astype(np.uint8)
        masks[i, ..., 0] = m * np.uint8(255)
    return images, masks


def launch_counts(bn, df):
    return {**bn.LAUNCHES, "multipart_conv3x3": df.LAUNCHES}


def bn_want(n, finish=0):
    """BN launches a path should count: n of each of K1-K3 and `finish` of
    bn_finish, which runs only in data-parallel steps (dp_phase)."""
    return {"bn_stats": n, "bn_bwd_reduce": n, "bn_bwd_dx": n, "bn_finish": finish}


def reset_counts(bn, df):
    for k in bn.LAUNCHES:
        bn.LAUNCHES[k] = 0
    df.LAUNCHES = 0


def profile_steps(step, batch, gen, precision, card, steps=5, host_ops=0):
    """Device time by kernel over a few train steps (torch.profiler), and
    with host_ops > 0 the host's busiest operators (self CPU time);
    returns (wall, device busy) ms per step."""
    from torch.profiler import profile

    with profile(activities=_activities(host_ops)) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()  # aggregated once: slow for the large archs' traces
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"train profile {precision}: {steps} steps, wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy_ms / steps:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}% of "
          f"wall; profiler on) | card: {card}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms / steps:8.3f} ms/step {100 * ms / busy_ms:5.1f}%  "
              f"x{e.count // steps:<3d} {e.key[:110]}")
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:host_ops]
    for e in host:
        print(f"  host {e.self_cpu_time_total / 1e3 / steps:8.3f} ms/step "
              f"x{e.count // steps:<4d} {e.key[:100]}")
    return wall_ms / steps, busy_ms / steps


def train_phase(bn, df, card, arch="NestedUNet", deep_supervision=True,
                bn_per_step=BN_PER_STEP, k4_per_forward=10):
    """train.fit on full-width `arch` in bf16 and fp32; returns the launch
    counts of each run: exactly `bn_per_step` launches of each BN kernel per
    train step and `k4_per_forward` K4 launches per step and per val batch."""
    from pytorch_nested_unet_tpu_torch.infer import Predictor
    from pytorch_nested_unet_tpu_torch.train import fit
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    tr_x, tr_y = synthetic_set(64, seed=0)
    va_x, va_y = synthetic_set(20, seed=1)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke")
    epochs, steps = 3, 64 // BATCH
    val_batches = -(-len(va_x) // BATCH)
    ds = "wDS" if deep_supervision else "woDS"
    label = f"{arch}{' wDS' if deep_supervision else ''}"
    launches = {}
    for precision in ("bf16", "fp32"):
        reset_counts(bn, df)
        t0 = time.perf_counter()
        r = fit(tr_x, tr_y, va_x, va_y, name=f"{arch}_{ds}_{precision}", output_dir=out_dir,
                epochs=epochs, batch_size=BATCH, arch=arch, deep_supervision=deep_supervision,
                loss="BCEDiceLoss", optimizer="SGD", lr=1e-3, momentum=0.9, weight_decay=1e-4,
                scheduler="CosineAnnealingLR", min_lr=1e-5, precision=precision, seed=41,
                augment="full", device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts(bn, df)
        launches[precision] = counts
        want = bn_want(bn_per_step * epochs * steps)
        want["multipart_conv3x3"] = k4_per_forward * epochs * (steps + val_batches)
        if counts != want:
            raise AssertionError(f"train {label} {precision}: launches {counts}, expected {want} "
                                 f"({bn_per_step} BN per step, {k4_per_forward} decoder nodes "
                                 f"per step and per val batch, {epochs}x{steps} steps, {epochs}x"
                                 f"{val_batches} val batches)")
        log = r["log"]
        with open(os.path.join(r["model_dir"], "log.csv")) as f:
            rows = list(csv.reader(f))
        if rows[0] != LOG_COLUMNS or len(rows) != 1 + epochs:
            raise AssertionError(f"train {label} {precision}: log.csv {rows}")
        if not all(np.isfinite(log[k]).all() for k in ("loss", "val_loss", "iou", "val_iou")):
            raise AssertionError(f"train {label} {precision}: non-finite log {log}")
        print(f"train {label} {precision}: fit 3 epochs x {steps} steps (+{val_batches} val "
              f"batches each, the last padded) in {fit_s:.2f} s; train s/epoch "
              f"{[round(t, 3) for t in r['train_s']]}, val s/epoch "
              f"{[round(t, 3) for t in r['val_s']]}; loss {[round(v, 4) for v in log['loss']]}, "
              f"val_loss {[round(v, 4) for v in log['val_loss']]}, val_iou "
              f"{[round(v, 4) for v in log['val_iou']]} | launches {counts} | card: {card}",
              flush=True)
        pth = os.path.join(r["model_dir"], "model.pth")
        pred = Predictor(arch, 1, 3, deep_supervision=deep_supervision, precision=precision,
                         batch_size=BATCH, weights=pth, device="cuda")
        probs = pred.predict_u8(va_x[:BATCH])
        if probs.shape != (BATCH, SIZE, SIZE, 1) or not np.isfinite(probs).all():
            raise AssertionError(f"train {label} {precision}: served model.pth gave "
                                 f"{probs.shape}")

        # steady step time: the same step as fit's, synchronized after each
        model = r["model"]
        step = make_train_step(model, build_optimizer(model.parameters(), "SGD", 1e-3, 0.9,
                                                      1e-4), "BCEDiceLoss", deep_supervision,
                               "full")
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = (torch.from_numpy(tr_x[:BATCH]).cuda(), torch.from_numpy(tr_y[:BATCH]).cuda())
        for _ in range(3):
            step(*batch, gen)
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            step(*batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        p50, p95 = times[len(times) // 2], times[min(len(times) - 1, int(len(times) * 0.95))]
        print(f"train {precision} steady: {label} full width, batch {BATCH} "
              f"{SIZE}x{SIZE}, 20 steps: p50 {p50:.3f} ms/step, p95 {p95:.3f} ms/step, "
              f"{BATCH * 1e3 / (sum(times) / len(times)):.1f} img/s | card: {card}", flush=True)
        profile_steps(step, batch, gen, f"{label} {precision}", card)
    return launches


TRAJECTORY_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                 "trajectory_NestedUNet_wDS.json")
# the card's whole run against the golden (the gates of the CPU's slow case
# in tests/test_torch_trajectory.py, from PARITY_RUN.json's checks)
TRAJECTORY_GATES = {"epoch0_loss": 2e-3, "epoch_loss": 1e-3, "final_val_iou": 0.05}


def trajectory_phase(bn, df, card):
    """`train.fit` over the whole of PARITY_RUN.json's protocol on the card
    (full-width NestedUNet wDS, BCEDice, 48x48, 64 / 16 images, batch 8, 15
    epochs, lr 1e-3 cosine to 1e-5, seed 41, augment none; TF32 off), from
    the port's seed-41 init, in fp32 and then bf16: 30 launches of each of
    K1-K3 per train step and 10 of K4 per forward, train and val. The fp32
    curves are held to the JAX package's on the CPU (the golden written by
    trajectory_golden.py): the epoch-0 train loss within 2e-3, every
    epoch's within 1e-3, the final val IoU within 0.05. The bf16 run has no
    golden: its gaps to the fp32 golden and its final val IoU are printed,
    not gated. Returns the launch counts of each run."""
    from pytorch_nested_unet_tpu_torch.train import fit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with open(TRAJECTORY_GOLDEN) as f:
        golden = json.load(f)
    p = golden["protocol"]
    want_curves = {k: np.asarray([e[k] for e in golden["epochs"]]) for k in golden["epochs"][0]}
    images, masks = synthetic_set(p["n_train"] + p["n_val"], p["seed"], p["size"])
    n, bs, epochs = p["n_train"], p["batch_size"], p["epochs"]
    steps, val_batches = n // bs, -(-p["n_val"] // bs)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke",
                           "trajectory")
    launches, final_iou = {}, {}
    for precision in ("fp32", "bf16"):
        reset_counts(bn, df)
        t1 = time.perf_counter()
        r = fit(images[:n], masks[:n], images[n:], masks[n:], name=precision,
                output_dir=out_dir, epochs=epochs, batch_size=bs, arch=p["arch"],
                deep_supervision=p["deep_supervision"], num_classes=p["num_classes"],
                loss=p["loss"], lr=p["lr"], min_lr=p["min_lr"], precision=precision,
                seed=p["seed"], augment="none", device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        counts = launch_counts(bn, df)
        launches[precision] = counts
        want = {**bn_want(BN_PER_STEP * epochs * steps),
                "multipart_conv3x3": 10 * epochs * (steps + val_batches)}
        if counts != want:
            raise AssertionError(f"trajectory {precision}: launches {counts}, expected {want} "
                                 f"({BN_PER_STEP} BN per step, 10 decoder nodes per step and "
                                 f"per val batch, {epochs}x{steps} steps, {epochs}x{val_batches} "
                                 f"val batches)")
        gaps = {k: np.abs(np.asarray(r["log"][k]) - want_curves[k]) for k in want_curves}
        final_iou[precision] = r["log"]["val_iou"][-1]
        print(f"trajectory {precision}: fit {epochs} epochs x {steps} steps in {fit_s:.2f} s; "
              f"gaps to the JAX golden: epoch-0 loss {gaps['loss'][0]:.3e}, largest epoch "
              f"loss {gaps['loss'].max():.3e} (epoch {int(gaps['loss'].argmax())}), final "
              f"val IoU {gaps['val_iou'][-1]:.3e}, largest val IoU {gaps['val_iou'].max():.3e}, "
              f"largest val loss {gaps['val_loss'].max():.3e}, largest train IoU "
              f"{gaps['iou'].max():.3e} | launches {counts} | card: {card}", flush=True)
        print(f"  per-epoch loss gap {[float(f'{g:.3e}') for g in gaps['loss']]}; val IoU "
              f"{[round(v, 4) for v in r['log']['val_iou']]} (golden "
              f"{want_curves['val_iou'].round(4).tolist()})", flush=True)
        if precision == "fp32":
            failed = [name for name, got in (("epoch0_loss", gaps["loss"][0]),
                                             ("epoch_loss", gaps["loss"].max()),
                                             ("final_val_iou", gaps["val_iou"][-1]))
                      if not got <= TRAJECTORY_GATES[name]]
            if failed:
                raise AssertionError(f"trajectory fp32: {failed} over their gates "
                                     f"{TRAJECTORY_GATES}: loss {r['log']['loss']} against "
                                     f"{want_curves['loss'].tolist()}, val IoU "
                                     f"{r['log']['val_iou']} against "
                                     f"{want_curves['val_iou'].tolist()}")
    print(f"trajectory: fp32 gates {TRAJECTORY_GATES} met; final val IoU fp32 "
          f"{final_iou['fp32']:.4f}, bf16 {final_iou['bf16']:.4f} (golden "
          f"{want_curves['val_iou'][-1]:.4f}); phase {time.perf_counter() - t0:.1f} s | "
          f"card: {card}", flush=True)
    return launches


def k4_empty_band(df, dev, dtype):
    """MultipartConv3x3 on a band of zero rows (a map of fewer rows than
    bands, its halo of 1 set) in `dtype`: an empty output without a K4
    launch, and a backward that runs: empty part gradients, and the weight
    and bias gradients of the plain version's zero-row band of a whole map
    (zeros). Raises otherwise."""
    from pytorch_nested_unet_tpu_torch.models.blocks import MultipartConv3x3

    cps, co, w = (32, 64), 32, 12
    m = MultipartConv3x3(sum(cps), co, dtype=dtype).to(dev)
    with torch.no_grad():
        m.weight.normal_()
        m.bias.normal_()
    m.halo = (1, 0)
    parts = [torch.randn(2, 0, w, c, device=dev, dtype=dtype, requires_grad=True) for c in cps]
    before = df.LAUNCHES
    y = m(parts)
    y.float().sum().backward()
    ref_w = m.weight.detach().clone().requires_grad_(True)
    ref_b = m.bias.detach().clone().requires_grad_(True)
    whole = [torch.randn(2, 1, w, c, device=dev) for c in cps]
    df.reference_multipart_conv3x3(whole, ref_w.permute(2, 3, 1, 0), ref_b)[:, :0].sum().backward()
    launched = df.LAUNCHES - before
    if (y.shape != (2, 0, w, co) or y.dtype != dtype or launched
            or any(p.grad is None or p.grad.shape != p.shape for p in parts)
            or not torch.equal(m.weight.grad, ref_w.grad)
            or not torch.equal(m.bias.grad, ref_b.grad)):
        raise AssertionError(f"K4 on an empty band {DTYPE_NAME[dtype]}: output "
                             f"{tuple(y.shape)} {y.dtype}, {launched} launches, gradients "
                             f"{[p.grad is not None for p in parts]}, weight {m.weight.grad}")


def cpu_step_phase(arch="NestedUNet", deep_supervision=True, zero_bn_fed_biases=False,
                   conv_gap=False, card_convs=False, step_floor=False, plain_bn=False,
                   no_dropout=False):
    """One full-width fp32 train step (batch 2, augment none) on the card and on
    the CPU from the same weights: the loss within 1e-5, the running statistics
    within atol = rtol = 1e-5, and every gradient within 1e-4 relative L2 norm
    or, where the step itself is less stable than that, within 4x of how far
    the CPU's own gradient moves when the weights move by 1e-7 of themselves
    (a last-bit change). At full width the deep layers' gradients move by
    several percent under such a change (ReLU masks and max-pool choices
    flip), so no implementation can meet 1e-4 there.

    Each gradient's norm is taken relative to the larger of its own norm and
    its module's weight gradient norm: a conv bias that feeds a BN has a true
    gradient of zero (the BN's mean subtraction cancels it), so every device
    computes rounding noise for it.

    zero_bn_fed_biases sets the bias of every conv that feeds a BN+ReLU
    (its sibling just before it) to 0 first, which changes nothing in exact
    arithmetic. At their init they can dominate the first BN's input: its
    largest mean^2 / var, printed, is the factor by which var = E[x^2] -
    mean^2 magnifies one rounding of a BN sum, so above ~1e3 the comparison
    holds the card to the CPU's summation order rather than to the step.

    conv_gap measures, for each conv, how far its output on the card is from
    its output on the CPU on the same input (the CPU's train-mode forward on
    these images): the rms of the difference, printed. The CPU step is then
    run once more with that much Gaussian noise added to each conv's output,
    and a gradient's movement under it also counts towards its bound: the
    card's convolutions differ from the CPU's by that much before anything
    else does.

    card_convs runs the CPU step once more with every conv, forward and
    backward, computed by the card on the CPU step's own tensors (the CPU
    computing the rest), and a gradient's movement under it also counts
    towards its bound: what the card's convolutions (cuDNN, not the port's
    code) alone move. Where a ReLU input lies within the card's conv
    rounding of 0 (VGG16RNN at full width: one BN output of its stage 4),
    the card's own rounding flips it, which a CPU run with Gaussian noise of
    the same size need not; and where a weight gradient sums cancelling
    terms (a score block's 5x5 conv to 1 channel, whose output gradient a
    train-mode BN has centred), the card's conv backward adds in another
    order.

    step_floor holds the loss and each running statistic, too, to 4x how
    far they move under those same CPU readings where that is more than
    their tolerance (loss 1e-5, statistics atol = rtol = 1e-5): for a step
    that is chaotic in f32. UNetRNNPSP's is at its init: its refinement
    network runs three passes, each feeding its outputs back as the next
    one's input, through BNs in train mode, and on the CPU a 1e-7 weight
    change moves its loss by 1.1e-3 and a running variance by 1.8e-2.

    plain_bn counts the plain BatchNorm layers as BNs too (for the zeroed
    biases and the first BN's ratio): the archs without a fused BN+ReLU.
    no_dropout sets every element-wise Dropout to p = 0 on both sides (the
    card's and the CPU's generators draw different masks).
    """
    from pytorch_nested_unet_tpu_torch.data.augment import eval_transform
    from pytorch_nested_unet_tpu_torch.models import create_model
    from pytorch_nested_unet_tpu_torch.ops.fused_bn import FusedBatchNormReLU
    from pytorch_nested_unet_tpu_torch.ops.layers import BatchNorm, Dropout
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    imgs, masks = synthetic_set(2, seed=3)
    imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)
    bn_types = (FusedBatchNormReLU, BatchNorm) if plain_bn else FusedBatchNormReLU

    def build(zero):
        m = create_model(arch, 1, 3, deep_supervision,
                         generator=torch.Generator().manual_seed(5))
        if no_dropout:
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0
        if zero:
            with torch.no_grad():
                for mod in m.modules():
                    kids = list(mod.children())
                    for conv, bn in zip(kids, kids[1:]):
                        if isinstance(bn, bn_types) and getattr(conv, "bias", None) is not None:
                            conv.bias.zero_()
        return m

    def convs(m):
        return {n: mod for n, mod in m.named_modules()
                if isinstance(getattr(mod, "weight", None), torch.Tensor) and mod.weight.dim() == 4}

    def first_bn_ratio(zero):
        """The first BN layer's largest mean^2 / var on these inputs (CPU)."""
        m, got = build(zero), []
        bn0 = next(b for b in m.modules() if isinstance(b, bn_types))
        bn0.register_forward_pre_hook(lambda _, args: got.append(
            args[0].double().reshape(-1, args[0].shape[-1])))
        with torch.no_grad():
            m.train()(eval_transform(imgs)[0])
        mean = got[0].mean(0)
        return (mean * mean / got[0].var(0, unbiased=False)).max().item()

    def measure_conv_gap():
        """{conv name: (rms of card - CPU output, rms of the CPU output)} over
        every call of the conv in one train-mode forward, same inputs."""
        m, ins = build(zero_bn_fed_biases), {}
        hooks = [mod.register_forward_pre_hook(
            lambda _, args, n=n: ins.setdefault(n, []).append(args[0].clone()))
            for n, mod in convs(m).items()]
        with torch.no_grad():
            m.train()(eval_transform(imgs)[0])
            for h in hooks:
                h.remove()
            gap = {}
            for n, mod in convs(m).items():
                card_mod = copy.deepcopy(mod).cuda()
                sq = ref_sq = count = 0.0
                for x in ins[n]:
                    want, got = mod(x), card_mod(x.cuda()).cpu()
                    sq += (got.double() - want.double()).pow(2).sum().item()
                    ref_sq += want.double().pow(2).sum().item()
                    count += want.numel()
                gap[n] = ((sq / count) ** 0.5, (ref_sq / count) ** 0.5)
        return gap

    ratios = [first_bn_ratio(False)] + ([first_bn_ratio(True)] if zero_bn_fed_biases else [])
    gap = measure_conv_gap() if conv_gap else {}

    def run(dev, perturb=0.0, noise=False, on_card=False):
        m = build(zero_bn_fed_biases)
        g = torch.Generator().manual_seed(6)
        if perturb:
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
        if noise:  # every conv output plus its measured card-vs-CPU gap times N(0, 1)
            for n, mod in convs(m).items():
                mod.register_forward_hook(lambda _, args, out, s=gap[n][0]: out + s * torch.randn(
                    out.shape, generator=g).to(out.dtype))
        if on_card:  # every conv, forward and backward, as the card computes it
            for n, mod in convs(m).items():
                twin = copy.deepcopy(mod).cuda()
                mod.forward = lambda x, mod=mod, twin=twin: ConvOnCard.apply(
                    x, mod.weight, mod.bias, twin)
        m = m.to(dev)
        step = make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-3, 0.9, 1e-4),
                               "BCEDiceLoss", deep_supervision, augment="none")
        t0 = time.perf_counter()
        loss = float(step(imgs.to(dev), masks.to(dev), torch.Generator(device=dev))["loss"])
        what = " (weights moved by 1e-7)" if perturb else \
            " (conv outputs moved by their card-vs-CPU gap)" if noise else \
            " (every conv computed by the card)" if on_card else ""
        print(f"card vs CPU {arch}: {dev}{what} step {time.perf_counter() - t0:.2f} s, loss "
              f"{loss:.7f}", flush=True)
        return (loss, {n: p.grad.cpu() for n, p in m.named_parameters()},
                {n: b.cpu() for n, b in m.named_buffers()})

    cuda, cpu, moved = run("cuda"), run("cpu"), run("cpu", perturb=1e-7)

    def rel(a, b):
        return {n: ((a[n] - b[n]).norm() / max(b[n].norm(), b[n.rsplit(".", 1)[0] + ".weight"]
                                                .norm())).item() for n in b}

    card_rel, floor = rel(cuda[1], cpu[1]), rel(moved[1], cpu[1])
    readings = [moved]
    moves = f"median movement under a 1e-7 weight change {np.median(list(floor.values())):.3g}"
    if gap:
        readings.append(run("cpu", noise=True))
        by_gap = rel(readings[-1][1], cpu[1])
        moves += f" and under the conv gap {np.median(list(by_gap.values())):.3g}"
        floor = {n: max(floor[n], by_gap[n]) for n in floor}
        share = {n: a / b for n, (a, b) in gap.items()}
        far = max(share, key=share.get)
        print(f"card vs CPU {arch}: conv outputs on the same input, rms(card - CPU) / rms(CPU) "
              f"over {len(gap)} convs: median {np.median(list(share.values())):.3g}, largest "
              f"{share[far]:.3g} ({far}); " + ", ".join(
                  f"{n} {a:.3g}/{b:.3g}" for n, (a, b) in gap.items()), flush=True)
    if card_convs:
        readings.append(run("cpu", on_card=True))
        by_card = rel(readings[-1][1], cpu[1])
        moves += f" and under the card's convs {np.median(list(by_card.values())):.3g}"
        floor = {n: max(floor[n], by_card[n]) for n in floor}
    bound = {n: max(1e-4, 4 * floor[n]) for n in floor}
    worst = max(card_rel, key=lambda n: card_rel[n] / bound[n])
    loss_err = abs(cuda[0] - cpu[0])
    loss_tol, stat_floor = 1e-5, {n: 0.0 for n in cpu[2]}
    if step_floor:
        loss_tol = max(loss_tol, 4 * max(abs(r[0] - cpu[0]) for r in readings))
        stat_floor = {n: 4 * max((r[2][n] - b).abs().max().item() for r in readings)
                      for n, b in cpu[2].items()}
    stat_ok = all(bool(((cuda[2][n] - b).abs() <= torch.clamp(
        1e-5 + 1e-5 * b.abs(), min=stat_floor[n])).all()) for n, b in cpu[2].items())
    stat_err = max((cuda[2][n] - b).abs().max().item() for n, b in cpu[2].items())
    stat_loose = sum(1 for n in cpu[2] if stat_floor[n] > 1e-5)
    loose = sorted(n for n in floor if bound[n] > 1e-4)
    cond = f"{ratios[0]:.3g} with the BN-fed conv biases at init"
    if zero_bn_fed_biases:
        cond += f", {ratios[1]:.3g} with them at 0 (compared here)"
    ranked = sorted(card_rel, key=lambda n: -card_rel[n] / bound[n])
    print(f"card vs CPU, one full-width fp32 {arch} train step (first BN layer's mean^2/var "
          f"on the CPU up to {cond}): loss diff {loss_err:.3g} (tol "
          f"{loss_tol:.3g}); gradients: worst {worst} at {card_rel[worst]:.3g} relative L2 against a "
          f"bound of {bound[worst]:.3g} (next: " + ", ".join(
              f"{n} {card_rel[n]:.3g} / {bound[n]:.3g}" for n in ranked[1:3])
          + f"); median card-vs-CPU {np.median(list(card_rel.values())):.3g}, {moves}; "
          f"{len(loose)} of "
          f"{len(floor)} gradients bounded by that movement rather than 1e-4 (largest: "
          f"{max(floor.values()):.3g}); running stats max abs diff {stat_err:.3g} "
          f"(atol = rtol = 1e-5" + (f", or 4x their movement: {stat_loose} of {len(stat_floor)} "
                                    f"statistics, up to {max(stat_floor.values()):.3g}"
                                    if step_floor else "") + ")", flush=True)
    if loss_err > loss_tol or card_rel[worst] > bound[worst] or not stat_ok:
        raise AssertionError(f"card vs CPU {arch} train step outside its bounds")


class ConvOnCard(torch.autograd.Function):
    """A conv of the CPU's step computed by its copy on the card, forward and
    backward, on the CPU step's own tensors: apply(x, weight, bias, twin)."""

    @staticmethod
    def forward(ctx, x, weight, bias, twin):
        ctx.save_for_backward(x, weight, bias)
        ctx.twin = twin
        params = {"weight": weight.cuda()} if bias is None else {
            "weight": weight.cuda(), "bias": bias.cuda()}
        with torch.no_grad():
            return torch.func.functional_call(twin, params, (x.cuda(),)).cpu()

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        ins = [t.detach().cuda().requires_grad_(True) for t in (x, weight)]
        params = {"weight": ins[1]}
        if bias is not None:
            ins.append(bias.detach().cuda().requires_grad_(True))
            params["bias"] = ins[2]
        with torch.enable_grad():
            y = torch.func.functional_call(ctx.twin, params, (ins[0],))
            grads = torch.autograd.grad(y, ins, grad.cuda())
        grads = [g.cpu() for g in grads] + [None] * (3 - len(ins))
        return (*grads, None)


def arch_sweep_phase(bn, df, card):
    """Each other new arch once at full width, 96x96, batch 2, in bf16: one
    train step (augment full) with its K1-K3 and K4 launches counted, then one
    served batch through Predictor (K4 only). Returns the summed launches."""
    from pytorch_nested_unet_tpu_torch.infer import Predictor
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    imgs, masks = synthetic_set(2, seed=4)
    total = {k: 0 for k in launch_counts(bn, df)}
    for arch, kw, bn_per_step, k4 in ARCH_SWEEP:
        label = arch + "".join(f" {k}={v}" for k, v in kw.items())
        pred = Predictor(arch, precision="bf16", batch_size=2, seed=0, device="cuda",
                         arch_kwargs=kw)
        m = pred.model
        params = sum(p.numel() for p in m.parameters())
        step = make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-3, 0.9, 1e-4),
                               "BCEDiceLoss", False, "full")
        batch = (torch.from_numpy(imgs).cuda(), torch.from_numpy(masks).cuda())
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(bn, df)
        t0 = time.perf_counter()
        loss = float(step(*batch, gen)["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
        train_counts = launch_counts(bn, df)
        want = {**bn_want(bn_per_step), "multipart_conv3x3": k4}
        if train_counts != want or not np.isfinite(loss):
            raise AssertionError(f"sweep {label}: train step loss {loss}, launches "
                                 f"{train_counts}, expected {want}")
        m.eval()  # the train step left it in train mode
        reset_counts(bn, df)
        t0 = time.perf_counter()
        probs = pred.predict_u8(imgs)
        serve_ms = (time.perf_counter() - t0) * 1e3
        serve_counts = launch_counts(bn, df)
        want = {**bn_want(0), "multipart_conv3x3": k4}
        if serve_counts != want or probs.shape != (2, SIZE, SIZE, 1) \
                or not np.isfinite(probs).all():
            raise AssertionError(f"sweep {label}: served {probs.shape}, launches "
                                 f"{serve_counts}, expected {want}")
        for k in total:
            total[k] += train_counts[k] + serve_counts[k]
        print(f"sweep {label}: {params} parameters, bf16, batch 2 {SIZE}x{SIZE}: first train "
              f"step {step_ms:.1f} ms (loss {loss:.4f}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB), first served batch "
              f"{serve_ms:.1f} ms | train launches {train_counts} | card: {card}", flush=True)
        del pred, m, step
    return total


# cli_phase: a DSB2018-sized synthetic folder (670 images, as stage1_train),
# its seed-41 split (536 train, 134 val), 8 more images of other sizes to serve
CLI_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke", "cli")
CLI_IMAGES, CLI_EPOCHS = 670, 2
CLI_STEPS = (CLI_IMAGES - -(-CLI_IMAGES // 5)) // BATCH  # 33 drop_last steps of 16
CLI_SERVE_SIZES = [(120, 100), (100, 120), (80, 130), (150, 90), (96, 96), (64, 64),
                   (101, 77), (200, 160)]


def _tee_stdout(fn):
    """Run fn() with its standard output both shown and kept; returns
    (result, text)."""
    import contextlib
    import io

    class Tee(io.StringIO):
        def write(self, s):
            sys.__stdout__.write(s)
            return super().write(s)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return result, buf.getvalue()


def cli_phase(bn, df, card):
    """The reference protocol through the port's CLIs on an image folder, at
    full width (NestedUNet wDS, batch 16, 96x96, bf16): write the folder with
    the port's encoder, time `load_all`'s decode, then `train.main` for 2
    epochs, `--resume` to a 3rd, `--pipeline host` for 1 on a fresh name,
    `val.main` and `infer.main` on the capsule, each checked and with its
    launches counted against what the split implies. Returns the bf16 launch
    counts of the path."""
    import shutil

    from pytorch_nested_unet_tpu_torch import infer, train, val
    from pytorch_nested_unet_tpu_torch.data import image_io
    from pytorch_nested_unet_tpu_torch.data.datasets import (
        SegmentationFolderDataset, list_image_ids, split_ids)
    from pytorch_nested_unet_tpu_torch.infer import Predictor
    from pytorch_nested_unet_tpu_torch.utils.config import load_config

    root = CLI_ROOT
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    jpeg = image_io.has_jpeg()
    codecs = "PNG (zlib) + JPEG (libjpeg)" if jpeg else "PNG (zlib) only, no JPEG"
    print(f"cli: image library built in {time.perf_counter() - t0:.1f} s: {codecs}", flush=True)

    # 1. the dataset, written with the port's own encoder
    data_dir = os.path.join(root, "inputs")
    base = os.path.join(data_dir, "dsb2018_96")
    os.makedirs(os.path.join(base, "images"))
    os.makedirs(os.path.join(base, "masks", "0"))
    images, masks = synthetic_set(CLI_IMAGES, seed=7)
    ids = [f"{i:04d}" for i in range(CLI_IMAGES)]
    t0 = time.perf_counter()
    for i, img_id in enumerate(ids):
        image_io.write_png(os.path.join(base, "images", img_id + ".png"), images[i])
        image_io.write_png(os.path.join(base, "masks", "0", img_id + ".png"), masks[i, ..., 0])
    write_s = time.perf_counter() - t0
    serve_dir = os.path.join(root, "serve")
    os.makedirs(serve_dir)
    extra, _ = synthetic_set(len(CLI_SERVE_SIZES), seed=8)
    serve_paths = []
    for i, hw in enumerate(CLI_SERVE_SIZES):
        serve_paths.append(os.path.join(serve_dir, f"s{i}.png"))
        image_io.write_png(serve_paths[-1], image_io.resize(extra[i], hw))
    everything = SegmentationFolderDataset(ids, os.path.join(base, "images"),
                                           os.path.join(base, "masks"), ".png", ".png", 1)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        got_x, got_y, _ = everything.load_all((SIZE, SIZE))
        rates.append(CLI_IMAGES / (time.perf_counter() - t0))
    if not (np.array_equal(got_x, images) and np.array_equal(got_y, masks)):
        raise AssertionError("cli: the decoded folder differs from the arrays written")
    paths = [everything.image_path(i) for i in ids]
    one = []  # the image files alone, on one thread and on every core
    for threads in (1, 0):
        t0 = time.perf_counter()
        image_io.load_batch(paths, (SIZE, SIZE), 3, num_threads=threads)
        one.append(CLI_IMAGES / (time.perf_counter() - t0))
    print(f"cli: wrote {CLI_IMAGES} image + mask PNG pairs at {SIZE}x{SIZE} in {write_s:.2f} s; "
          f"load_all decodes them (images and masks, {os.cpu_count()} host cores) at "
          f"{sorted(rates)[1]:.0f} img/s (median of 3: {[round(r) for r in rates]}), bit "
          f"for bit what was written; the 670 image files alone: {one[0]:.0f} files/s on one "
          f"thread, {one[1]:.0f} on {os.cpu_count()} | card: {card}", flush=True)

    n_val = -(-CLI_IMAGES // 5)  # ceil(0.2 n), the seed-41 split's val set
    steps, val_batches = (CLI_IMAGES - n_val) // BATCH, -(-n_val // BATCH)
    out_dir = os.path.join(root, "models")
    argv = ["--dataset", "dsb2018_96", "--data_dir", data_dir, "--output_dir", out_dir,
            "--arch", "NestedUNet", "--deep_supervision", "true", "--precision", "bf16",
            "--device", "cuda"]
    name = "dsb2018_96_NestedUNet_wDS"
    model_dir = os.path.join(out_dir, name)
    total = {k: 0 for k in launch_counts(bn, df)}

    def counted(what, fn, epochs=0, val_k4_batches=0):
        reset_counts(bn, df)
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts(bn, df)
        want = bn_want(BN_PER_STEP * steps * epochs)
        want["multipart_conv3x3"] = 10 * ((steps + val_batches) * epochs + val_k4_batches)
        if counts != want:
            raise AssertionError(f"cli {what}: launches {counts}, expected {want} ({epochs} "
                                 f"epoch(s) of {steps} steps and {val_batches} val batches, "
                                 f"{val_k4_batches} more batches served)")
        for k in total:
            total[k] += counts[k]
        return result, wall, counts

    def epoch_line(what, r, wall, counts):
        print(f"cli {what}: {len(r['train_s'])} epoch(s) in {wall:.2f} s of wall (set-up "
              f"included); per epoch train {[round(t, 3) for t in r['train_s']]} s "
              f"({[round(steps * BATCH / t, 1) for t in r['train_s']]} img/s), val "
              f"{[round(t, 3) for t in r['val_s']]} s, epoch wall "
              f"{[round(a + b, 3) for a, b in zip(r['train_s'], r['val_s'])]} s; val_iou "
              f"{[round(v, 4) for v in r['log']['val_iou']]} | launches {counts} | card: "
              f"{card}", flush=True)

    def log_rows():
        with open(os.path.join(model_dir, "log.csv")) as f:
            return list(csv.reader(f))

    # 2. train
    r, wall, counts = counted("train", lambda: train.main(argv + ["--epochs", str(CLI_EPOCHS)]),
                              CLI_EPOCHS)
    epoch_line("train (device pipeline)", r, wall, counts)
    want_cfg = train.parse_args(argv + ["--epochs", str(CLI_EPOCHS)])
    for k in train.NPY_FLAGS:
        del want_cfg[k]
    want_cfg["name"] = name
    if load_config(model_dir) != want_cfg:
        raise AssertionError(f"cli: config.yml reads back as {load_config(model_dir)}, "
                             f"not {want_cfg}")
    rows = log_rows()
    if rows[0] != LOG_COLUMNS or len(rows) != 1 + CLI_EPOCHS:
        raise AssertionError(f"cli: log.csv {rows}")
    for f in ("model.pth", "last.pth"):
        if not os.path.isfile(os.path.join(model_dir, f)):
            raise AssertionError(f"cli: no {f} in {model_dir}")

    # 3. resume, under the profiler: the device-busy share of a CLI epoch
    from torch.profiler import profile

    with profile(activities=_activities(0)) as prof:
        r, wall, counts = counted("resume", lambda: train.main(
            argv + ["--epochs", str(CLI_EPOCHS + 1), "--resume", "true"]), 1)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    epoch_s = r["train_s"][0] + r["val_s"][0]
    epoch_line("resume to epoch 3", r, wall, counts)
    print(f"cli resume profile (profiler on): device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / (1e3 * epoch_s):.1f}% of the epoch's {epoch_s:.3f} s "
          f"({100 * busy_ms / (1e3 * wall):.1f}% of the whole run's {wall:.2f} s)", flush=True)
    new_rows = log_rows()
    if new_rows[:1 + CLI_EPOCHS] != rows or len(new_rows) != 2 + CLI_EPOCHS:
        raise AssertionError(f"cli resume: log.csv {new_rows}, earlier rows {rows}")

    # 4. the host pipeline: the same launches as one device-pipeline epoch
    r, wall, counts = counted("host pipeline", lambda: train.main(
        argv + ["--epochs", "1", "--pipeline", "host", "--name", "host_pipeline"]), 1)
    epoch_line("train (host pipeline)", r, wall, counts)

    # 5. val, against Predictor on the same images decoded independently
    out_ext = ".jpg" if jpeg else ".png"
    save_dir = os.path.join(root, "outputs")
    iou, wall, counts = counted("val", lambda: val.main(
        ["--name", name, "--data_dir", data_dir, "--output_dir", out_dir, "--save_dir",
         save_dir, "--out_ext", out_ext, "--device", "cuda"]), 0, val_batches)
    _, val_ids = split_ids(list_image_ids(os.path.join(base, "images"), ".png"), 0.2, 41)
    vx, vy, _ = SegmentationFolderDataset(val_ids, os.path.join(base, "images"),
                                          os.path.join(base, "masks"), ".png", ".png",
                                          1).load_all((SIZE, SIZE))
    pth = os.path.join(model_dir, "model.pth")
    pred = Predictor("NestedUNet", 1, 3, deep_supervision=True, precision="bf16",
                     batch_size=BATCH, weights=pth, device="cuda")
    num = den = 0.0
    for s in range(0, len(vx), BATCH):
        p = pred.predict_u8(vx[s:s + BATCH]) > 0.5
        t = vy[s:s + BATCH].astype(np.float32) / 255.0 > 0.5
        num += len(p) * ((p & t).sum() + 1e-5) / ((p | t).sum() + 1e-5)
        den += len(p)
    written = sorted(os.listdir(os.path.join(save_dir, name, "0")))
    print(f"cli val: IoU {iou:.8f} vs {num / den:.8f} from Predictor on the same images "
          f"(atol 1e-6); {len(written)} {out_ext} masks ({codecs}); {wall:.2f} s | launches "
          f"{counts} | card: {card}", flush=True)
    if abs(iou - num / den) > 1e-6 or written != sorted(i + out_ext for i in val_ids):
        raise AssertionError(f"cli val: IoU {iou} vs {num / den}, {len(written)} masks")

    # 6. infer on images of other sizes: full-res binary masks, then probabilities
    inf_args = ["--name", name, "--input_dir", serve_dir, "--output_dir", out_dir,
                "--device", "cuda"]
    thr_dir, prob_dir = os.path.join(root, "infer_thr"), os.path.join(root, "infer_prob")
    (s, text), wall, counts = counted("infer", lambda: _tee_stdout(lambda: infer.main(
        inf_args + ["--save_dir", thr_dir, "--full_res", "true", "--threshold", "0.5"])),
        0, 1)
    if "img/s end-to-end" not in text or s["written"] != len(serve_paths):
        raise AssertionError(f"cli infer: summary {s}, printed {text!r}")
    for path, hw in zip(serve_paths, CLI_SERVE_SIZES):
        m = image_io.load_image(os.path.join(thr_dir, name, "0", os.path.basename(path)), 1)
        if m.shape != hw or not set(np.unique(m)) <= {0, 255}:
            raise AssertionError(f"cli infer {path}: mask {m.shape} (want {hw}) with values "
                                 f"{np.unique(m)[:8]}")
    (s, _), _, more = counted("infer", lambda: _tee_stdout(lambda: infer.main(
        inf_args + ["--save_dir", prob_dir])), 0, 1)
    want = (pred.predict_u8(image_io.load_batch(serve_paths, (SIZE, SIZE))) * 255).astype(
        np.uint8)
    got = np.stack([image_io.load_image(os.path.join(prob_dir, name, "0",
                                                     os.path.basename(p)), 1)
                    for p in serve_paths])
    lsb = int(np.abs(got.astype(int) - want[..., 0].astype(int)).max())
    print(f"cli infer: {len(serve_paths)} images of {len(set(CLI_SERVE_SIZES))} sizes, "
          f"full-res masks of the originals' sizes, only 0/255 at --threshold 0.5; "
          f"probability masks within {lsb} LSB of uint8(255 Predictor probs) (max 1) | "
          f"launches {counts} + {more} | card: {card}", flush=True)
    if lsb > 1:
        raise AssertionError(f"cli infer: probability masks {lsb} LSB from Predictor's")
    print(f"cli path launches (bf16): {total}", flush=True)
    return total


def torchvision_resnet50_sd(seed):
    """A torchvision-format ResNet-50 state dict (torchvision's names and
    shapes, its `fc` head and BN counters included) drawn from a numpy seed:
    conv weights N(0, 2 / fan_in) (torchvision's init), BN weights U(0.5,
    1.5), biases and running means N(0, 0.1^2), running variances U(0.5,
    1.5)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, a):
        sd[name] = torch.from_numpy(np.asarray(a, np.float32))

    def conv(name, o, i, k):
        put(f"{name}.weight", rng.standard_normal((o, i, k, k)) * (2.0 / (i * k * k)) ** 0.5)

    def norm(name, c):
        put(f"{name}.weight", rng.uniform(0.5, 1.5, c))
        put(f"{name}.bias", rng.standard_normal(c) * 0.1)
        put(f"{name}.running_mean", rng.standard_normal(c) * 0.1)
        put(f"{name}.running_var", rng.uniform(0.5, 1.5, c))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    conv("conv1", 64, 3, 7)
    norm("bn1", 64)
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for i in range(n):
            base = f"layer{stage + 1}.{i}"
            for k, (cin, cout, ks) in enumerate(((inplanes, planes, 1), (planes, planes, 3),
                                                 (planes, planes * 4, 1)), 1):
                conv(f"{base}.conv{k}", cout, cin, ks)
                norm(f"{base}.bn{k}", cout)
            if i == 0:
                conv(f"{base}.downsample.0", planes * 4, inplanes, 1)
                norm(f"{base}.downsample.1", planes * 4)
            inplanes = planes * 4
    put("fc.weight", rng.standard_normal((1000, 2048)) * 0.01)
    put("fc.bias", np.zeros(1000))
    return sd


def pretrained_phase(bn, df, card):
    """`train.main --arch ResNet50RNN --pretrained_backbone` on cli_phase's
    folder (which must exist): a torchvision-format ResNet-50 state dict
    written from a seed, 1 bf16 epoch (33 steps + 9 val batches), the
    printed tensor count (265: 53 convs, 53 BN layers' 4 tensors each), the
    flag in config.yml, 5 launches of each BN kernel per step and no K4,
    then the capsule served by `infer.main` (no kernel launched). Returns
    the launches."""
    from pytorch_nested_unet_tpu_torch import infer, train
    from pytorch_nested_unet_tpu_torch.utils.config import load_config

    data_dir, serve_dir = os.path.join(CLI_ROOT, "inputs"), os.path.join(CLI_ROOT, "serve")
    if not os.path.isdir(os.path.join(data_dir, "dsb2018_96")):
        raise AssertionError(f"pretrained: no cli_phase folder under {data_dir}")
    sd = torchvision_resnet50_sd(seed=9)
    trunk = sum(1 for k in sd if not k.startswith("fc.") and "num_batches" not in k)
    pth = os.path.join(CLI_ROOT, "resnet50_torchvision.pth")
    torch.save(sd, pth)
    out_dir, name = os.path.join(CLI_ROOT, "models"), "dsb2018_96_ResNet50RNN_pretrained"
    reset_counts(bn, df)
    t0 = time.perf_counter()
    r, text = _tee_stdout(lambda: train.main(
        ["--dataset", "dsb2018_96", "--data_dir", data_dir, "--output_dir", out_dir,
         "--name", name, "--arch", "ResNet50RNN", "--precision", "bf16", "--epochs", "1",
         "--pretrained_backbone", pth, "--device", "cuda"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(bn, df)
    want = {**bn_want(RESNET_RNN_BN_PER_STEP * CLI_STEPS), "multipart_conv3x3": 0}
    said = f"pretrained backbone: {trunk} tensors -> the model root"
    if said not in text or counts != want:
        raise AssertionError(f"pretrained: printed {said!r}: {said in text}; launches {counts}, "
                             f"expected {want}")
    cfg = load_config(os.path.join(out_dir, name))
    if cfg["pretrained_backbone"] != pth or not np.isfinite(r["log"]["val_loss"]).all():
        raise AssertionError(f"pretrained: config {cfg.get('pretrained_backbone')}, log {r['log']}")
    reset_counts(bn, df)
    s, _ = _tee_stdout(lambda: infer.main(
        ["--name", name, "--input_dir", serve_dir, "--output_dir", out_dir, "--save_dir",
         os.path.join(CLI_ROOT, "infer_pretrained"), "--device", "cuda"]))
    served = launch_counts(bn, df)
    if s["written"] != len(CLI_SERVE_SIZES) or any(served.values()):
        raise AssertionError(f"pretrained: infer wrote {s['written']}, launches {served}")
    print(f"pretrained: train.main --arch ResNet50RNN --pretrained_backbone ({trunk} tensors of "
          f"a torchvision-format ResNet-50) 1 bf16 epoch of {CLI_STEPS} steps in {wall:.2f} s "
          f"(train {r['train_s'][0]:.3f} s, val {r['val_s'][0]:.3f} s, val_iou "
          f"{r['log']['val_iou'][0]:.4f}); infer.main served {s['written']} images | launches "
          f"{counts} + {served} | card: {card}", flush=True)
    return counts


# export_phase's fresh serving process: it imports the port's serving module
# (and through it ops/) and nothing of the model code, loads the artifact on
# the card, answers one batch and reports K4's launches, its seconds to load
# and its largest difference from the probabilities the parent saved
EXPORT_LOADER = """
import sys, time
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
torch.cuda.init()
t1 = time.perf_counter()
from pytorch_nested_unet_tpu_torch.serving import load_exported
from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
predict, manifest = load_exported(sys.argv[1], "cuda")
t2 = time.perf_counter()
got = predict(np.load(sys.argv[2])).cpu().numpy()
t3 = time.perf_counter()
pkg = "pytorch_nested_unet_tpu_torch"
models = [m for m in sys.modules if m.startswith((pkg + ".models", pkg + ".training"))]
print(df.LAUNCHES, float(np.abs(got - np.load(sys.argv[3])).max()), t1 - t0, t2 - t1, t3 - t2,
      len(models))
"""


PROFILE_IMAGES = 80  # export_phase's traced epoch: 4 steps of 16 and 1 val batch


def export_phase(bn, df, card):
    """The serving artifact (serving.py) on the capsule cli_phase wrote
    (full-width NestedUNet wDS, 96x96): `export.main` in fp32 and bf16 with
    --check true (the reloaded artifact against the live Predictor, 1e-5 /
    2e-2), export and load seconds and MB; the fp32 artifact loaded in a
    fresh process that imports no model code (10 K4 launches, the batch
    within 1e-5 of the live Predictor); batches 1, 3 and 16 through the fp32
    artifact (10 K4 launches each, 1e-5 against the live Predictor); a
    pinned artifact refusing 3; `infer.main --artifact` over the serving
    folder, masks within 1 LSB of `infer.main --name`'s; the artifact's
    p50 / p95 and img/s beside the live Predictor's, each precision, order
    live, artifact, artifact, live, and the device-busy ms of the first live
    and the first artifact window; then `train.main --profile` for 1 bf16
    epoch on the folder's first PROFILE_IMAGES pairs, whose trace must name
    K1-K3 and a K4 kernel. Returns {dtype: launches} with, under
    "artifact", the K4 launches read in the windows that ran only an
    artifact (the fresh process's, batches 1/3/16, the pinned batch,
    `infer --artifact`, the timed artifact windows)."""
    import shutil

    from pytorch_nested_unet_tpu_torch import export, infer, serving, train
    from pytorch_nested_unet_tpu_torch.data import image_io
    from pytorch_nested_unet_tpu_torch.infer import Predictor

    name = "dsb2018_96_NestedUNet_wDS"
    out_dir = os.path.join(CLI_ROOT, "models")
    model_dir = os.path.join(out_dir, name)
    serve_dir = os.path.join(CLI_ROOT, "serve")
    if not os.path.isfile(os.path.join(model_dir, "model.pth")):
        raise AssertionError(f"export: no cli_phase capsule under {model_dir}")
    root = os.path.join(CLI_ROOT, "export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    start = time.perf_counter()
    launches = {p: {k: 0 for k in launch_counts(bn, df)} for p in ("fp32", "bf16")}
    artifact_k4 = {"fp32": 0, "bf16": 0}

    def counted(precision, fn, artifact=False):
        """Run fn between two reads of the counts; with artifact=True the
        window holds the artifact's calls alone and its K4 launches count
        as the artifact's."""
        reset_counts(bn, df)
        result = fn()
        torch.cuda.synchronize()
        counts = launch_counts(bn, df)
        for k in counts:
            launches[precision][k] += counts[k]
        if artifact:
            artifact_k4[precision] += counts["multipart_conv3x3"]
        return result, counts

    # 1. export in both precisions, --check true (the artifact's batch of 2
    # and the live Predictor's in one window: 20 K4 launches, not in the
    # artifact's tally)
    paths, sizes, export_s = {}, {}, {}
    for precision in ("fp32", "bf16"):
        out = os.path.join(root, f"{name}_{precision}.pt2")
        t0 = time.perf_counter()
        (_, text), counts = counted(precision, lambda: _tee_stdout(lambda: export.main(
            ["--name", name, "--output_dir", out_dir, "--out", out, "--precision", precision,
             "--device", "cuda", "--check", "true"])))
        export_s[precision] = time.perf_counter() - t0
        if "round-trip check ok" not in text or counts["multipart_conv3x3"] != 20:
            raise AssertionError(f"export {precision}: printed {text!r}, launches {counts}")
        paths[precision], sizes[precision] = out, os.path.getsize(out) / 1e6

    # 2. a fresh process loads the fp32 artifact and serves a batch of 16
    rng = np.random.default_rng(0)
    request = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    live = {p: Predictor.from_capsule(model_dir, p, BATCH, "cuda")[0] for p in ("fp32", "bf16")}
    want, _ = counted("fp32", lambda: live["fp32"].predict_u8(request))
    np.save(os.path.join(root, "request.npy"), request)
    np.save(os.path.join(root, "want.npy"), want)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", EXPORT_LOADER, paths["fp32"],
                        os.path.join(root, "request.npy"), os.path.join(root, "want.npy")],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=300)
    process_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"export: the serving process failed:\n{r.stderr[-3000:]}")
    k4, err, init_s, load_s, first_s, models = r.stdout.split()
    launches["fp32"]["multipart_conv3x3"] += int(k4)
    artifact_k4["fp32"] += int(k4)
    print(f"export: fresh serving process ({process_s:.1f} s in all): CUDA init "
          f"{float(init_s):.2f} s, load_exported {float(load_s):.2f} s, first batch "
          f"{float(first_s):.2f} s; {k4} K4 launches for a batch of {BATCH}, max abs diff "
          f"{float(err):.3g} from the live Predictor (atol 1e-5), model modules imported: "
          f"{models} | card: {card}", flush=True)
    if int(k4) != 10 or float(err) > 1e-5 or int(models):
        raise AssertionError(f"export: serving process launched {k4} K4, diff {err}, "
                             f"imported {models} model modules")

    # 3. batches 1, 3 and 16 through one dynamic artifact against the live
    # Predictor's model at the same batch; a pinned one refuses 3
    predict, manifest = serving.load_exported(paths["fp32"], "cuda")
    for b in (1, 3, BATCH):
        images = rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)
        got, counts = counted("fp32", lambda: predict(images).cpu().numpy(), artifact=True)
        ref = live["fp32"]._predict(torch.from_numpy(images).cuda()).cpu().numpy()
        err = float(np.abs(got - ref).max())
        if got.shape != (b, SIZE, SIZE, 1) or counts["multipart_conv3x3"] != 10 or err > 1e-5:
            raise AssertionError(f"export batch {b}: {got.shape}, launches {counts}, err {err}")
    pinned = os.path.join(root, "pinned.pt2")
    (_, _), _ = counted("fp32", lambda: _tee_stdout(lambda: export.main(
        ["--name", name, "--output_dir", out_dir, "--out", pinned, "--precision", "fp32",
         "--batch", str(BATCH), "--device", "cuda", "--check", "false"])))
    fixed, _ = serving.load_exported(pinned, "cuda")
    _, counts = counted("fp32", lambda: fixed(request), artifact=True)
    if counts["multipart_conv3x3"] != 10:
        raise AssertionError(f"export: the pinned artifact's batch launched {counts}")
    try:
        fixed(request[:3])
    except (AssertionError, RuntimeError) as e:
        refused = str(e).splitlines()[0][:80]
    else:
        raise AssertionError("export: the pinned artifact served a batch of 3")
    print(f"export: the dynamic fp32 artifact served batches 1, 3, {BATCH} (10 K4 launches "
          f"each, within 1e-5 of the live Predictor); the pinned one refused 3: {refused!r}",
          flush=True)

    # 4. infer --artifact over the serving folder against infer --name
    masks = {}
    for mode, flags in (("name", ["--name", name, "--output_dir", out_dir]),
                        ("artifact", ["--artifact", paths["bf16"]])):
        save = os.path.join(root, f"infer_{mode}")
        (s, text), counts = counted("bf16", lambda: _tee_stdout(lambda: infer.main(
            flags + ["--input_dir", serve_dir, "--save_dir", save, "--device", "cuda"])),
            artifact=mode == "artifact")
        if counts["multipart_conv3x3"] != 10 or s["written"] != len(CLI_SERVE_SIZES):
            raise AssertionError(f"export infer --{mode}: launches {counts}, summary {s}")
        masks[mode] = np.stack([image_io.load_image(os.path.join(save, name, "0", f), 1)
                                for f in sorted(os.listdir(os.path.join(save, name, "0")))])
    lsb = int(np.abs(masks["artifact"].astype(int) - masks["name"].astype(int)).max())
    print(f"export: infer --artifact (bf16) wrote {len(masks['artifact'])} masks within {lsb} "
          f"LSB of infer --name's (max 1)", flush=True)
    if lsb > 1:
        raise AssertionError(f"export: infer --artifact masks {lsb} LSB from infer --name's")

    # 5. the artifact beside the live Predictor: 16 requests of 16 each, twice;
    # the first window of each traced
    requests = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
                for _ in range(16)]
    load_s = {}
    for precision in ("fp32", "bf16"):
        t0 = time.perf_counter()
        artifact = Predictor.from_artifact(paths[precision], BATCH, "cuda")[0]
        load_s[precision] = time.perf_counter() - t0
        served, busy = {}, {}
        for mode in ("live", "artifact", "artifact", "live"):
            pred = live[precision] if mode == "live" else artifact
            pred.latencies, pred.images = [], 0
            _, counts = counted(precision, lambda: [pred.predict_u8(q) for q in requests],
                                artifact=mode == "artifact")
            if counts["multipart_conv3x3"] != 10 * len(requests):
                raise AssertionError(f"export {mode} {precision}: launches {counts}")
            s = pred.summary()
            if mode not in busy:
                busy[mode] = profile_batches(pred, requests[0], f"{mode} {precision}", 6)[1]
            served.setdefault(mode, []).append(
                f"p50 {s['p50_ms']:.3f} ms, p95 {s['p95_ms']:.3f} ms, "
                f"{s['img_per_s']:.1f} img/s")
        for mode, lines in served.items():
            print(f"export serving {precision} {mode}: " + " | ".join(lines)
                  + f" | device busy {busy[mode]:.3f} ms/batch | card: {card}", flush=True)
    print(f"export: seconds to export (with the check) fp32 {export_s['fp32']:.2f}, bf16 "
          f"{export_s['bf16']:.2f}; to load in this process fp32 {load_s['fp32']:.2f}, bf16 "
          f"{load_s['bf16']:.2f}; artifact MB fp32 {sizes['fp32']:.2f}, bf16 "
          f"{sizes['bf16']:.2f}", flush=True)

    # 6. train --profile: one bf16 epoch, traced, on the first PROFILE_IMAGES
    # pairs of the CLI folder (a trace of the whole epoch would run to
    # ~100 MB)
    src = os.path.join(CLI_ROOT, "inputs", "dsb2018_96")
    data_dir = os.path.join(root, "inputs")
    for sub in ("images", os.path.join("masks", "0")):
        os.makedirs(os.path.join(data_dir, "dsb2018_96", sub))
        for f in sorted(os.listdir(os.path.join(src, sub)))[:PROFILE_IMAGES]:
            os.link(os.path.join(src, sub, f), os.path.join(data_dir, "dsb2018_96", sub, f))
    trace_dir = os.path.join(root, "trace")
    (r, text), counts = counted("bf16", lambda: _tee_stdout(lambda: train.main(
        ["--dataset", "dsb2018_96", "--data_dir", data_dir, "--output_dir", out_dir,
         "--name", "profiled", "--precision", "bf16", "--deep_supervision", "true",
         "--epochs", "1", "--profile", trace_dir, "-b", str(BATCH), "--input_w", str(SIZE),
         "--input_h", str(SIZE), "--device", "cuda"])))
    n_val = -(-PROFILE_IMAGES // 5)  # the seed-41 split's val set
    steps, val_batches = (PROFILE_IMAGES - n_val) // BATCH, -(-n_val // BATCH)
    want = {**bn_want(BN_PER_STEP * steps), "multipart_conv3x3": 10 * (steps + val_batches)}
    files = os.listdir(trace_dir)
    if counts != want or files != ["epoch0.pt.trace.json"] \
            or f"profiler trace written to {trace_dir}" not in text:
        raise AssertionError(f"export train --profile: launches {counts} (want {want}), "
                             f"files {files}")
    trace = os.path.join(trace_dir, files[0])
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {k: sorted(n for n in kernels if k in n)
             for k in ("stats_kernel", "bwd_reduce_kernel", "bwd_dx_kernel", "conv3x3_")}
    print(f"export: train --profile, 1 bf16 epoch of {steps} steps ({r['train_s'][0]:.3f} s "
          f"train, the trace's writing apart): trace "
          f"{os.path.getsize(trace) / 1e6:.1f} MB, {len(events)} events, "
          f"{len(kernels)} kernel names; K1-K4 found: "
          + "; ".join(f"{k}: {[n[:60] for n in v]}" for k, v in found.items())
          + f" | card: {card}", flush=True)
    if not all(found.values()):
        raise AssertionError(f"export: the trace lacks {[k for k, v in found.items() if not v]}")
    print(f"export path launches: {launches}, of them the artifacts' K4: {artifact_k4}; "
          f"export_phase {time.perf_counter() - start:.1f} s", flush=True)
    return {**launches, "artifact": artifact_k4}


# canet_cli_phase: an ISIC-sized-image folder (64 PNG pairs at 256x256 in the
# ISIC layout, 52 train / 12 test), trained by the CA-Net preset at its own
# 256x256 and batch 2
CANET_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke",
                          "canet")
CANET_TRAIN, CANET_TEST, CANET_SIZE, CANET_BATCH = 52, 12, 256, 2


def canet_cli_phase(bn, df, card):
    """`train_canet.main` (the CA-Net preset: Comprehensive_Atten_Unet, 1
    class, drop_rate 0.5, batch 2, 256x256, ISIC layout, augment none) for 1
    bf16 epoch on a seeded ISIC-layout folder it writes, under the profiler
    (the epoch's device-busy share), then `val.main` on the capsule; checks
    config.yml's arch and batch size, the log, val's IoU against the log's,
    and that no kernel launched (no BN of CA-Net runs K1-K3, it has no
    decoder-fusion node). Returns the launches."""
    import shutil

    from torch.profiler import profile

    from pytorch_nested_unet_tpu_torch import train_canet, val
    from pytorch_nested_unet_tpu_torch.data import image_io
    from pytorch_nested_unet_tpu_torch.utils.config import load_config

    shutil.rmtree(CANET_ROOT, ignore_errors=True)
    data_dir = os.path.join(CANET_ROOT, "inputs")
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:CANET_SIZE, 0:CANET_SIZE]
    for split, n in (("train", CANET_TRAIN), ("test", CANET_TEST)):
        img_dir = os.path.join(data_dir, "ISIC", split, "image")
        mask_dir = os.path.join(data_dir, "ISIC", split, "mask")
        os.makedirs(img_dir)
        os.makedirs(mask_dir)
        for i in range(n):  # a lesion-like ellipse, darker than the skin around it
            cy, cx = rng.integers(CANET_SIZE // 4, 3 * CANET_SIZE // 4, 2)
            ry, rx = rng.integers(CANET_SIZE // 10, CANET_SIZE // 4, 2)
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            img = rng.normal([200, 160, 140], 15, (CANET_SIZE, CANET_SIZE, 3))
            img[m] -= [90, 80, 60]
            image_io.write_png(os.path.join(img_dir, f"ISIC_{split}{i:03d}.png"),
                               np.clip(img, 0, 255).astype(np.uint8))
            image_io.write_png(os.path.join(mask_dir, f"ISIC_{split}{i:03d}_segmentation.png"),
                               m.astype(np.uint8) * 255)
    out_dir, name = os.path.join(CANET_ROOT, "models"), "ISIC_Comprehensive_Atten_Unet_woDS"
    # --img_ext .png: the card's machine has no libjpeg (ROADMAP.md), so the
    # preset's .jpg images are written as PNG here
    argv = ["--data_dir", data_dir, "--output_dir", out_dir, "--img_ext", ".png",
            "--epochs", "1", "--precision", "bf16", "--device", "cuda"]
    reset_counts(bn, df)
    with profile(activities=_activities(0)) as prof:
        t0 = time.perf_counter()
        r = train_canet.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts(bn, df)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    cfg = load_config(os.path.join(out_dir, name))
    steps = CANET_TRAIN // CANET_BATCH
    epoch_s = r["train_s"][0] + r["val_s"][0]
    if (cfg["arch"], cfg["batch_size"], cfg["input_w"], cfg["dataset_layout"]) != (
            "Comprehensive_Atten_Unet", CANET_BATCH, CANET_SIZE, "isic") \
            or any(counts.values()) or len(r["log"]["loss"]) != 1 \
            or not np.isfinite(r["log"]["val_loss"]).all():
        raise AssertionError(f"canet cli: config {cfg['arch']} b{cfg['batch_size']} "
                             f"{cfg['input_w']} {cfg['dataset_layout']}, launches {counts}, "
                             f"log {r['log']}")
    reset_counts(bn, df)
    t0 = time.perf_counter()
    iou, _ = _tee_stdout(lambda: val.main(
        ["--name", name, "--data_dir", data_dir, "--output_dir", out_dir, "--save_dir",
         os.path.join(CANET_ROOT, "val"), "--out_ext", ".png", "-b", str(CANET_BATCH),
         "--device", "cuda"]))
    val_wall = time.perf_counter() - t0
    served = launch_counts(bn, df)
    # val.main scores model.pth, the weights of the epoch's validation, at
    # batch 2 as the epoch does; bf16 convs may pick other algorithms, and one
    # pixel of the 12 images' union moves the IoU by ~1e-4
    if any(served.values()) or abs(iou - r["log"]["val_iou"][0]) > 1e-2:
        raise AssertionError(f"canet cli val: IoU {iou} vs the log's "
                             f"{r['log']['val_iou'][0]}, launches {served}")
    print(f"canet cli: train_canet.main 1 bf16 epoch of {steps} steps (batch {CANET_BATCH}, "
          f"{CANET_SIZE}x{CANET_SIZE}, {CANET_TRAIN} train / {CANET_TEST} test PNG pairs) in "
          f"{wall:.2f} s of wall (set-up included); epoch wall {epoch_s:.3f} s (train "
          f"{r['train_s'][0]:.3f} s, {steps * CANET_BATCH / r['train_s'][0]:.1f} img/s; val "
          f"{r['val_s'][0]:.3f} s); device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / (1e3 * epoch_s):.1f}% of the epoch (profiler on); loss "
          f"{r['log']['loss'][0]:.4f}, val_iou {r['log']['val_iou'][0]:.4f}; val.main IoU "
          f"{iou:.4f} in {val_wall:.2f} s | launches {counts} + {served} | card: {card}",
          flush=True)
    return counts


# refine_phase: the Refiner with the port's seeded weights (the released
# CascadePSP file is not in the repository, so nothing is timed on it)
REFINE_CHECK_HW, REFINE_CHECK_L = (320, 480), 224
REFINE_TIMED = [(1200, 1600), (96, 96)]  # a photo-sized image; val --refine's 96x96
REFINE_L = 900


def refine_scene(h, w, seed):
    """A seeded (h, w) scene whose mask splits it along a diagonal, the
    image brighter and textured on the mask's side: (uint8 HWC, uint8 HW)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = yy * w + xx * h < h * w
    img = rng.normal(60, 12, (h, w, 3))
    img[mask] += np.asarray([120, 90, 60])
    return np.clip(img, 0, 255).astype(np.uint8), mask.astype(np.uint8) * 255


def mask_guided(apply_fn):
    """apply_fn with the global pass's pred_224 and pred_56_2 replaced by the
    input mask in [0, 1]: a random network's global prediction lies on one
    side of 0.5 everywhere, so every tile would be skipped as trivial; with
    the mask in its place the tiles along the mask's edge run through the
    network, as trained weights would have them run."""
    def fn(im, seg, inter_s8=None, inter_s4=None):
        out = apply_fn(im, seg, inter_s8, inter_s4)
        if inter_s8 is None:
            out = {**out, "pred_224": (seg + 1) / 2, "pred_56_2": (seg + 1) / 2}
        return out
    return fn


def golden_rule(got, want, what):
    """uint8 maps within 1 gray level everywhere and exact on >= 99%
    (tests/test_refinement_golden.py's rule); returns (max diff, exact share)."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    exact = float((diff == 0).mean())
    if got.shape != want.shape or diff.max() > 1 or exact < 0.99:
        raise AssertionError(f"{what}: max gray-level diff {diff.max()}, {exact:.4f} exact")
    return int(diff.max()), exact


def refine_phase(bn, df, card):
    """The CascadePSP Refiner on the card, fp32 with TF32 off, seeded weights:
    fast and full at L = 224 on a 320x480 diagonal scene against the CPU
    (uint8 by the golden rule), the mask-guided full pipeline against the CPU
    and with tile_batch=3 against its sequential tiles (1e-5 on the
    probabilities); then ms per image at L = 900, fp32 and bf16, fast and
    full, on a 1200x1600 image (area down for the global pass, 900x900
    tiles) and a 96x96 one (bicubic up to 900, one 96x96 tile), with the
    tiles run, the device-busy share and peak memory. No K1-K4 launches."""
    from torch.profiler import profile

    from pytorch_nested_unet_tpu_torch.refinement import Refiner, driver

    sd = Refiner(device="cpu").model.state_dict()  # the port's seeded init (seed 0)
    card_r, cpu_r = Refiner(state_dict=sd, device="cuda"), Refiner(state_dict=sd, device="cpu")
    h, w = REFINE_CHECK_HW
    image, mask = refine_scene(h, w, seed=12)
    reset_counts(bn, df)
    for fast in (True, False):
        n0 = card_r.tiles_run
        t0 = time.perf_counter()
        got = card_r.refine(image, mask, fast=fast, L=REFINE_CHECK_L)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = cpu_r.refine(image, mask, fast=fast, L=REFINE_CHECK_L)
        cpu_s = time.perf_counter() - t0
        top, exact = golden_rule(got, want, f"refine {'fast' if fast else 'full'} card vs CPU")
        print(f"refine {'fast' if fast else 'full'} L={REFINE_CHECK_L} {h}x{w} fp32: card vs "
              f"CPU uint8 max diff {top}, {100 * exact:.3f}% exact (<= 1, >= 99%); "
              f"{card_r.tiles_run - n0} tiles run; card {card_s:.3f} s, CPU {cpu_s:.2f} s",
              flush=True)
    im, sg = card_r.inputs(image, mask)
    seq_tiles, batched_tiles = [], []
    seq = driver.process_high_res_im(mask_guided(card_r.apply_fn), im, sg, REFINE_CHECK_L,
                                     tiles_run=seq_tiles)
    batched = driver.process_high_res_im(mask_guided(card_r.apply_fn), im, sg, REFINE_CHECK_L,
                                         tile_batch=3, tiles_run=batched_tiles)
    cpu_out = driver.process_high_res_im(mask_guided(cpu_r.apply_fn), *cpu_r.inputs(image, mask),
                                         REFINE_CHECK_L)
    seq, batched, cpu_out = (a[0, ..., 0].float().cpu().numpy() for a in (seq, batched, cpu_out))
    tb_err, cpu_err = float(np.abs(batched - seq).max()), float(np.abs(seq - cpu_out).max())
    top, exact = golden_rule((seq * 255).astype(np.uint8), (cpu_out * 255).astype(np.uint8),
                             "refine mask-guided full card vs CPU")
    counts = launch_counts(bn, df)
    print(f"refine mask-guided full L={REFINE_CHECK_L} {h}x{w} fp32: {len(seq_tiles)} tiles run; "
          f"tile_batch=3 vs one tile per forward max abs err {tb_err:.3g} (1e-5), same tiles "
          f"{batched_tiles == seq_tiles}; card vs CPU probabilities max abs err {cpu_err:.3g}, "
          f"uint8 max diff {top}, {100 * exact:.3f}% exact | launches {counts} | card: {card}",
          flush=True)
    if tb_err > 1e-5 or batched_tiles != seq_tiles or len(seq_tiles) < 3 or any(counts.values()):
        raise AssertionError(f"refine: tile_batch err {tb_err}, tiles {len(seq_tiles)} / "
                             f"{len(batched_tiles)}, launches {counts}")
    del card_r, cpu_r

    for dtype in (torch.float32, torch.bfloat16):
        r = Refiner(state_dict=sd, dtype=dtype, device="cuda")
        for hw in REFINE_TIMED:
            image, mask = refine_scene(*hw, seed=13)
            im, sg = r.inputs(image, mask)
            guided_tiles = []
            modes = {"fast": lambda: r.refine(image, mask, fast=True, L=REFINE_L),
                     "full": lambda: r.refine(image, mask, fast=False, L=REFINE_L),
                     "full, mask-guided": lambda: driver.process_high_res_im(
                         mask_guided(r.apply_fn), im, sg, REFINE_L, tiles_run=guided_tiles
                     ).cpu()}
            for mode, fn in modes.items():
                fn()  # cuDNN's first calls at these shapes
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                n0 = r.tiles_run + len(guided_tiles)
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                tiles = (r.tiles_run + len(guided_tiles) - n0) // 3
                with profile(activities=_activities(0)) as prof:
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                dev_items = sorted((e for e in prof.key_averages()
                                    if e.device_type == torch.autograd.DeviceType.CUDA
                                    and e.self_device_time_total > 0),
                                   key=lambda e: -e.self_device_time_total)
                busy = sum(e.self_device_time_total for e in dev_items) / 1e3
                peak = torch.cuda.max_memory_allocated() / 2**30
                ms = sorted(times)[1]
                print(f"refine {DTYPE_NAME[dtype]} L={REFINE_L} {hw[0]}x{hw[1]} {mode}: "
                      f"{ms:.1f} ms per image (median of 3: {[round(t, 1) for t in times]}), "
                      f"{tiles} tiles run; device busy {busy:.1f} ms of {wall:.1f} ms "
                      f"({100 * busy / wall:.1f}%, profiler on); peak device memory "
                      f"{peak:.2f} GiB; top device items: " + "; ".join(
                          f"{e.self_device_time_total / 1e3:.1f} ms x{e.count} {e.key[:60]}"
                          for e in dev_items[:4]) + f" | card: {card}", flush=True)
        del r
    counts = launch_counts(bn, df)
    if any(counts.values()):
        raise AssertionError(f"refine: launches {counts} (no kernel is on the refine path)")
    return counts


# refine_cli_phase: a small ISIC-layout folder at 96x96 (40 train, 8 test PNG
# pairs), NestedUNet trained by train_isic_ca, then val and infer --refine
REFINE_CLI_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs",
                               "chip_smoke", "refine_cli")
REFINE_CLI_TRAIN, REFINE_CLI_TEST = 40, 8


def refine_cli_phase(bn, df, card):
    """`train_isic_ca.main` (NestedUNet, 1 bf16 epoch of 2 steps of 16 at
    96x96) on a seeded ISIC-layout folder it writes, then `val.main` without
    and with `--refine` (fast and full, L = 900, random refinement weights)
    and `infer.main --refine` on the 8 test images; seconds and IoU printed,
    launches counted (K1-K3 30 per step, K4 10 per NestedUNet batch, none in
    the refinement). Returns the launches."""
    import shutil

    from pytorch_nested_unet_tpu_torch import infer, train_isic_ca, val
    from pytorch_nested_unet_tpu_torch.data import image_io

    shutil.rmtree(REFINE_CLI_ROOT, ignore_errors=True)
    data_dir = os.path.join(REFINE_CLI_ROOT, "inputs")
    images, masks = synthetic_set(REFINE_CLI_TRAIN + REFINE_CLI_TEST, seed=14)
    for split, ids in (("train", range(REFINE_CLI_TRAIN)),
                       ("test", range(REFINE_CLI_TRAIN, REFINE_CLI_TRAIN + REFINE_CLI_TEST))):
        img_dir = os.path.join(data_dir, "ISIC", split, "image")
        mask_dir = os.path.join(data_dir, "ISIC", split, "mask")
        os.makedirs(img_dir)
        os.makedirs(mask_dir)
        for i in ids:
            image_io.write_png(os.path.join(img_dir, f"ISIC_{i:03d}.png"), images[i])
            image_io.write_png(os.path.join(mask_dir, f"ISIC_{i:03d}_segmentation.png"),
                               masks[i, ..., 0])
    out_dir, name = os.path.join(REFINE_CLI_ROOT, "models"), "ISIC_NestedUNet_woDS"
    steps = REFINE_CLI_TRAIN // BATCH
    total = {k: 0 for k in launch_counts(bn, df)}

    def counted(what, fn, bn_launches, k4_launches):
        reset_counts(bn, df)
        t0 = time.perf_counter()
        result, _ = _tee_stdout(fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts(bn, df)
        want = {**bn_want(bn_launches), "multipart_conv3x3": k4_launches}
        if counts != want:
            raise AssertionError(f"refine cli {what}: launches {counts}, expected {want}")
        for k in total:
            total[k] += counts[k]
        return result, wall

    r, wall = counted("train_isic_ca", lambda: train_isic_ca.main(
        ["--data_dir", data_dir, "--output_dir", out_dir, "--img_ext", ".png", "--arch",
         "NestedUNet", "--epochs", "1", "--precision", "bf16", "--device", "cuda"]),
        BN_PER_STEP * steps, 10 * (steps + 1))
    print(f"refine cli: train_isic_ca.main NestedUNet 1 bf16 epoch of {steps} steps "
          f"({REFINE_CLI_TRAIN} train / {REFINE_CLI_TEST} test PNG pairs, {SIZE}x{SIZE}) in "
          f"{wall:.2f} s, val_iou {r['log']['val_iou'][0]:.4f} | card: {card}", flush=True)
    val_args = ["--name", name, "--data_dir", data_dir, "--output_dir", out_dir, "--out_ext",
                ".png", "--device", "cuda"]
    line = []
    for what, extra in (("val", []),
                        ("val --refine fast", ["--refine", "true", "--refine_fast", "true",
                                               "--refine_L", str(REFINE_L)]),
                        ("val --refine full", ["--refine", "true", "--refine_L", str(REFINE_L)])):
        iou, wall = counted(what, lambda: val.main(
            val_args + ["--save_dir", os.path.join(REFINE_CLI_ROOT, what.replace(" ", "_"))]
            + extra), 0, 10)
        if not np.isfinite(iou):
            raise AssertionError(f"refine cli {what}: IoU {iou}")
        line.append(f"{what} IoU {iou:.4f} in {wall:.2f} s")
    s, wall = counted("infer --refine", lambda: infer.main(
        ["--name", name, "--input_dir", os.path.join(data_dir, "ISIC", "test", "image"),
         "--img_ext", ".png", "--output_dir", out_dir, "--save_dir",
         os.path.join(REFINE_CLI_ROOT, "infer"), "--refine", "true", "--refine_L", str(REFINE_L),
         "--device", "cuda"]), 0, 10)
    if s["written"] != REFINE_CLI_TEST:
        raise AssertionError(f"refine cli infer --refine: wrote {s['written']}")
    line.append(f"infer --refine (fast) {s['written']} masks in {wall:.2f} s")
    print(f"refine cli ({REFINE_CLI_TEST} images, L={REFINE_L}, fp32 refinement, random "
          f"weights): " + "; ".join(line) + f" | launches {total} | card: {card}", flush=True)
    return total


# The last two archs at full width (DoubleUnet: layers (2, 2, 2, 2), 2
# iterations; DeepLab: the dual ResNet-101 (3, 4, 23, 3)): (parameters,
# running-statistic values) of the JAX package's init, and XLA's cost
# analysis of the JAX forward at batch 16, 96x96, in GFLOP (a yardstick for
# the TFLOP/s line, not a card number). Every BN of both is plain: no kernel.
NEW_ARCHS = {"DoubleUnet": (45_951_616, 21_632, 64.1), "DeepLab": (115_727_530, 216_672, 140.5)}


def new_arch_counts():
    """Parameter and running-statistic counts of both archs (and DoubleUnet's
    2 iteration weights with weighted_sum) against the JAX package's."""
    from pytorch_nested_unet_tpu_torch.models import create_model

    for arch, (params, buffers, _) in NEW_ARCHS.items():
        m = create_model(arch)
        got = (sum(p.numel() for p in m.parameters()), sum(b.numel() for b in m.buffers()))
        if got != (params, buffers):
            raise AssertionError(f"{arch}: {got} parameters / running-stat values, the JAX "
                                 f"package has {(params, buffers)}")
    ws = sum(p.numel() for p in create_model("DoubleUnet", weighted_sum=True).parameters())
    if ws != NEW_ARCHS["DoubleUnet"][0] + 2:
        raise AssertionError(f"DoubleUnet weighted_sum: {ws} parameters")
    print(f"counts: DoubleUnet {NEW_ARCHS['DoubleUnet'][0]:,} parameters (+2 with "
          f"weighted_sum), {NEW_ARCHS['DoubleUnet'][1]:,} running-stat values; DeepLab "
          f"{NEW_ARCHS['DeepLab'][0]:,} and {NEW_ARCHS['DeepLab'][1]:,}: the JAX package's",
          flush=True)


def deeplab_cli_phase(bn, df, card):
    """`train.main --arch DeepLab` for 1 bf16 epoch on cli_phase's folder
    (which must exist; 33 steps of 16, train mode's [aux, pred]), its
    model.pth under the port's own keys, then `val.main` and `infer.main`
    on the capsule (eval's pred): no kernel launched anywhere. Returns the
    launches."""
    from pytorch_nested_unet_tpu_torch import infer, train, val
    from pytorch_nested_unet_tpu_torch.models import create_model

    data_dir, serve_dir = os.path.join(CLI_ROOT, "inputs"), os.path.join(CLI_ROOT, "serve")
    if not os.path.isdir(os.path.join(data_dir, "dsb2018_96")):
        raise AssertionError(f"deeplab cli: no cli_phase folder under {data_dir}")
    out_dir, name = os.path.join(CLI_ROOT, "models"), "dsb2018_96_DeepLab_woDS"
    total = {k: 0 for k in launch_counts(bn, df)}
    walls = []
    runs = [lambda: train.main(["--dataset", "dsb2018_96", "--data_dir", data_dir,
                                "--output_dir", out_dir, "--arch", "DeepLab", "--precision",
                                "bf16", "--epochs", "1", "--device", "cuda"]),
            lambda: val.main(["--name", name, "--data_dir", data_dir, "--output_dir", out_dir,
                              "--save_dir", os.path.join(CLI_ROOT, "val_deeplab"), "--out_ext",
                              ".png", "--device", "cuda"]),
            lambda: _tee_stdout(lambda: infer.main(
                ["--name", name, "--input_dir", serve_dir, "--output_dir", out_dir,
                 "--save_dir", os.path.join(CLI_ROOT, "infer_deeplab"), "--device",
                 "cuda"]))[0]]
    results = []
    for run in runs:
        reset_counts(bn, df)
        t0 = time.perf_counter()
        results.append(run())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for k, v in launch_counts(bn, df).items():
            total[k] += v
    r, iou, served = results
    sd = torch.load(os.path.join(out_dir, name, "model.pth"), weights_only=True)
    keys = set(create_model("DeepLab").state_dict())
    if set(sd) != keys or any(total.values()) or not np.isfinite(r["log"]["val_loss"]).all() \
            or not 0 <= iou <= 1 or served["written"] != len(CLI_SERVE_SIZES):
        raise AssertionError(f"deeplab cli: model.pth keys match {set(sd) == keys}, launches "
                             f"{total}, log {r['log']}, val IoU {iou}, infer wrote "
                             f"{served['written']}")
    print(f"deeplab cli: train.main --arch DeepLab 1 bf16 epoch of {CLI_STEPS} steps in "
          f"{walls[0]:.2f} s (train {r['train_s'][0]:.3f} s = "
          f"{CLI_STEPS * BATCH / r['train_s'][0]:.1f} img/s, val {r['val_s'][0]:.3f} s, val_iou "
          f"{r['log']['val_iou'][0]:.4f}); model.pth: {len(sd)} tensors under the port's keys; "
          f"val.main IoU {iou:.4f} in {walls[1]:.2f} s; infer.main {served['written']} images "
          f"in {walls[2]:.2f} s | launches {total} | card: {card}", flush=True)
    return total


REMAT_MODES = ("none", "full", "policy")
# full-width NestedUNet wDS, launches per train step of K1, K2, K3 and K4
# under each --remat mode: "full" runs each block's forward again in backward
# (K1 without the running statistics, K4 at the 10 decoder nodes); "policy"
# makes only bn1's normalize + ReLU again
REMAT_LAUNCHES = {"none": (30, 30, 30, 10), "full": (60, 30, 30, 20),
                  "policy": (30, 30, 30, 10)}
REMAT_BATCHES = (16, 256)


def remat_phase(bn, df, card):
    """NestedUNet wDS at full width, 96x96, under --remat none, full and
    policy: one fp32 train step (batch 16, augment none, TF32 off) per mode
    from the same weights on the same batch, its K1-K4 launches checked
    against REMAT_LAUNCHES, the loss equal to the plain step's, every
    gradient within 1e-4 relative L2 of the plain step's (the card-vs-CPU
    gate; the norm as cpu_step_phase takes it) and the running statistics
    equal; then each mode's bf16 step p50 (20 steps, augment full) and peak
    device memory at batch 16 and 256. Returns {mode: launches of its fp32
    step}."""
    from pytorch_nested_unet_tpu_torch.models import create_model
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    x, y = synthetic_set(64, seed=10)
    init = create_model("NestedUNet", 1, 3, True,
                        generator=torch.Generator().manual_seed(11)).state_dict()

    def build(mode, dtype=None):
        m = create_model("NestedUNet", 1, 3, True, remat=mode, dtype=dtype)
        m.load_state_dict(init)
        m = m.cuda()
        return m, make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-3, 0.9, 1e-4),
                                  "BCEDiceLoss", True, "full" if dtype else "none")

    batch = (torch.from_numpy(x[:BATCH]).cuda(), torch.from_numpy(y[:BATCH]).cuda())
    launches, steps = {}, {}
    for mode in REMAT_MODES:
        m, step = build(mode)
        reset_counts(bn, df)
        loss = float(step(*batch, torch.Generator(device="cuda").manual_seed(0))["loss"])
        torch.cuda.synchronize()
        launches[mode] = launch_counts(bn, df)
        want = {**bn_want(0), **dict(zip(("bn_stats", "bn_bwd_reduce", "bn_bwd_dx",
                                            "multipart_conv3x3"), REMAT_LAUNCHES[mode]))}
        if launches[mode] != want:
            raise AssertionError(f"remat {mode}: launches {launches[mode]} per step, expected "
                                 f"{want}")
        steps[mode] = (loss, {n: p.grad.cpu() for n, p in m.named_parameters()},
                       {n: b.cpu() for n, b in m.named_buffers()})
        del m, step
    loss0, grads0, stats0 = steps["none"]
    for mode in ("full", "policy"):
        loss, grads, stats = steps[mode]
        rel = {n: float((g - grads0[n]).norm() / max(
            grads0[n].norm(), grads0[n.rsplit(".", 1)[0] + ".weight"].norm()))
            for n, g in grads.items()}
        worst = max(rel, key=rel.get)
        same_stats = all(torch.equal(b, stats0[n]) for n, b in stats.items())
        print(f"remat {mode} vs none, one fp32 step (batch {BATCH}, {SIZE}x{SIZE}): loss "
              f"{loss:.7f} vs {loss0:.7f}; gradients: worst {worst} at {rel[worst]:.3g} "
              f"relative L2 (gate 1e-4), median {np.median(list(rel.values())):.3g}; running "
              f"stats equal: {same_stats} | launches per step {launches[mode]} | card: {card}",
              flush=True)
        if loss != loss0 or rel[worst] > 1e-4 or not same_stats:
            raise AssertionError(f"remat {mode}: the step differs from the plain step")

    rows = []
    for b in REMAT_BATCHES:
        reps = -(-b // len(x))
        big = (torch.from_numpy(np.concatenate([x] * reps)[:b]).cuda(),
               torch.from_numpy(np.concatenate([y] * reps)[:b]).cuda())
        for mode in REMAT_MODES:
            m, step = build(mode, torch.bfloat16)
            gen = torch.Generator(device="cuda").manual_seed(0)
            for _ in range(3):
                step(*big, gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                step(*big, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            p50 = sorted(times)[len(times) // 2]
            rows.append((b, mode, p50, peak))
            print(f"remat {mode} bf16 step: NestedUNet wDS full width, batch {b} {SIZE}x{SIZE}, "
                  f"20 steps: p50 {p50:.3f} ms/step ({b * 1e3 / p50:.1f} img/s), peak device "
                  f"memory {peak:.3f} GiB | card: {card}", flush=True)
            del m, step
            torch.cuda.empty_cache()
    print("remat table (batch, mode, p50 ms/step, peak GiB): " + "; ".join(
        f"{b} {mode} {p50:.3f} {peak:.3f}" for b, mode, p50, peak in rows), flush=True)
    return launches


# K1's finish split off for data-parallel steps: float32 operations per
# channel of bn_finish (mean, var, inv, the running-stat update) and the
# floats it moves per channel (sums 2 and running stats 2 read; mean, var,
# inv 3 and running stats 2 written)
FINISH_OPS, FINISH_FLOATS = 14, 9


def finish_bound_ms(c):
    t_bytes = FINISH_FLOATS * 4 * c / PEAK_BYTES * 1e3
    t_ops = FINISH_OPS * c / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


# The band runs' BN rows, cut into bands (`halo.cut`): (C, the bands' row
# boundaries) of UNetRM7 x=2's 1-row level (16 images: 0 and 16 rows, an
# empty band) and its 3-row level (1 and 2 rows of 16 x 3), and NestedUNet
# x=4's level 4 (6 rows cut 1/2/1/2 of 16 x 6)
BAND_ROW_CASES = [(512, (0, 0, 16)), (256, (0, 48, 144)), (512, (0, 96, 288, 384, 576))]


def bn_band_rows_check(bn, dev, dtype, gen):
    """K1 (sums-only), K2 and K3 on each band of BAND_ROW_CASES, a band of
    zero rows among them, against their plain versions: each band's sums
    within SUM_TOL of their magnitude (a zero-row band's exactly zero), the
    bands' sums added equal to the whole map's plain sums, K3 with n the
    whole map's rows within BN_TOL. Returns {kernel: its largest error}."""
    err = dict.fromkeys(("bn_stats", "bn_bwd_reduce", "bn_bwd_dx"), 0.0)
    for c, cuts in BAND_ROW_CASES:
        rows = cuts[-1]
        what = f"band rows {DTYPE_NAME[dtype]} C={c} cuts={cuts}"
        x = (torch.randn(rows, c, generator=gen, device=dev) * 1.5 + 0.3).to(dtype)
        dy = torch.randn(rows, c, generator=gen, device=dev).to(dtype)
        gamma = torch.rand(c, generator=gen, device=dev) + 0.5
        beta = torch.rand(c, generator=gen, device=dev) * 0.6 - 0.3
        xf, dyf = x.float(), dy.float()
        _, _, mean, _, inv = bn.reference_bn_stats(xf)
        total, red = torch.zeros(2, c, device=dev), torch.zeros(2, c, device=dev)
        for lo, hi in zip(cuts, cuts[1:]):
            xb, dyb = x[lo:hi].contiguous(), dy[lo:hi].contiguous()
            sums = bn.bn_sums(xb)
            part = bn.bn_bwd_reduce_sums(xb, dyb, mean, inv, gamma, beta)
            torch.cuda.synchronize()
            xbf = xb.float()
            err["bn_stats"] = max(err["bn_stats"], _sum_err(
                sums, bn.reference_bn_sums(xbf), [xbf.abs().sum(0), (xbf * xbf).sum(0)],
                f"K1 sums-only {what} band {lo}:{hi}"))
            xhat = (xbf - mean) * inv
            dz = torch.where(gamma * xhat + beta > 0, dyb.float(), 0.0)
            err["bn_bwd_reduce"] = max(err["bn_bwd_reduce"], _sum_err(
                part, bn.reference_bn_bwd_reduce(xbf, dyb.float(), mean, inv, gamma, beta),
                [dz.abs().sum(0), (dz * xhat).abs().sum(0)], f"K2 {what} band {lo}:{hi}"))
            if hi == lo and (sums.any() or part.any()):
                raise AssertionError(f"{what}: a zero-row band's sums are not zero")
            total, red = total + sums, red + part
        _sum_err(total, bn.reference_bn_sums(xf), [xf.abs().sum(0), (xf * xf).sum(0)],
                 f"K1 sums-only {what}: the bands' sums added")
        for lo, hi in zip(cuts, cuts[1:]):
            xb, dyb = x[lo:hi].contiguous(), dy[lo:hi].contiguous()
            dx = bn.bn_bwd_dx(xb, dyb, mean, inv, gamma, beta, red[0], red[1], rows)
            ref = bn.reference_bn_bwd_dx(xb.float(), dyb.float(), mean, inv, gamma, beta,
                                         red[0], red[1], rows)
            torch.cuda.synchronize()
            if dx.shape != xb.shape:
                raise AssertionError(f"K3 {what} band {lo}:{hi}: dx {tuple(dx.shape)}")
            if hi > lo:
                err["bn_bwd_dx"] = max(err["bn_bwd_dx"], _max_err(
                    [dx], [ref], BN_TOL[dtype][1], f"K3 {what} band {lo}:{hi}"))
    print(f"K1 sums-only, K2, K3 on band rows {DTYPE_NAME[dtype]}: {len(BAND_ROW_CASES)} cuts "
          f"{[cuts for _, cuts in BAND_ROW_CASES]}, zero-row bands included, against their "
          f"plain versions: max abs err K1 {err['bn_stats']:.3g}, K2 {err['bn_bwd_reduce']:.3g}, "
          f"K3 {err['bn_bwd_dx']:.3g}", flush=True)
    return err


def bn_finish_phase(bn, dev):
    """The data-parallel split of K1 on the card, at NestedUNet's training-step
    shapes and the ragged ones, both dtypes: K1's sums-only launch against the
    plain sums (SUM_TOL); the sums-only launch plus bn_finish on its sums
    equal to one K1 call bit for bit, running statistics included; bn_finish
    at a global n = 2 * rows against its plain version (BN_TOL) and K3 at
    that n against its plain version; K1 (sums-only), K2 and K3 on the band
    runs' unequal and zero-row bands (`bn_band_rows_check`). Then bn_finish
    over the 30 instances of a NestedUNet step in one CUDA graph against its
    plain version and its bound. Returns {dtype: summary} (bn_finish reads
    float32 sums whatever the activations' dtype: the times are one
    measurement, the errors per dtype; "band_rows": K1-K3's errors on the
    band rows, which the kernels line gives K1-K3)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        vec_tol, dx_tol = BN_TOL[dtype]
        err = 0.0
        cases = [(c, rows) for _, c, rows, _ in BN_LEVELS] + BN_RAGGED
        for c, rows in cases:
            what = f"bn_finish {DTYPE_NAME[dtype]} C={c} rows={rows}"
            x = (torch.randn(rows, c, generator=gen, device=dev) * 1.5 + 0.3).to(dtype)
            xf = x.float()
            sums = bn.bn_sums(x)
            torch.cuda.synchronize()
            _sum_err(sums, bn.reference_bn_sums(xf), [xf.abs().sum(0), (xf * xf).sum(0)],
                     f"K1 sums-only {what}")
            run = [torch.rand(c, generator=gen, device=dev) + 0.5 for _ in range(2)]
            one_run = [t.clone() for t in run]
            one = bn.bn_stats(x, 1e-5, *one_run)
            split = bn.bn_finish(sums, rows, 1e-5, *run)
            torch.cuda.synchronize()
            if not torch.equal(sums, torch.stack(one[:2])) or not all(
                    torch.equal(a, b) for a, b in zip((*split, *run), (*one[2:], *one_run))):
                raise AssertionError(f"{what}: sums-only K1 + bn_finish differ from one K1 call")
            ref_run = [t.clone() for t in run]
            got = bn.bn_finish(sums, 2 * rows, 1e-5, *run)
            want = bn.reference_bn_finish(sums[0], sums[1], 2 * rows, 1e-5, *ref_run)
            torch.cuda.synchronize()
            err = max(err, _max_err([*got, *run], [*want, *ref_run], vec_tol, what))
            dy = torch.randn(rows, c, generator=gen, device=dev).to(dtype)
            gamma = torch.rand(c, generator=gen, device=dev) + 0.5
            beta = torch.rand(c, generator=gen, device=dev) * 0.6 - 0.3
            db, dg = bn.reference_bn_bwd_reduce(xf, dy.float(), want[0], want[2], gamma, beta)
            dx = bn.bn_bwd_dx(x, dy, want[0], want[2], gamma, beta, db, dg, 2 * rows)
            ref_dx = bn.reference_bn_bwd_dx(xf, dy.float(), want[0], want[2], gamma, beta, db,
                                            dg, 2 * rows)
            torch.cuda.synchronize()
            _max_err([dx], [ref_dx], dx_tol, f"K3 at n = 2 * rows {what}")
        out[dtype] = {"max_abs_err": err,
                      "band_rows": bn_band_rows_check(bn, dev, dtype, gen)}
    insts = []
    for c, _, n in BN_STEPS["NestedUNet"]:
        for _ in range(n):
            s = torch.rand(2, c, generator=gen, device=dev) * 1e4
            s[1] += s[0] ** 2 / 1e4
            insts.append((s, [torch.rand(c, generator=gen, device=dev) for _ in range(2)]))
    n_rows = 2 * BATCH * SIZE * SIZE
    ms = graph_ms(lambda: [bn.bn_finish(s, n_rows, 1e-5, *r) for s, r in insts], flush)
    plain_ms = graph_ms(lambda: [bn.reference_bn_finish(s[0], s[1], n_rows, 1e-5, *r)
                                 for s, r in insts], flush)
    bounds = [finish_bound_ms(s.shape[1]) for s, _ in insts]
    bound = sum(b for b, _ in bounds)
    by = "bytes" if sum(b for b, k in bounds if k == "bytes") >= bound / 2 else "operations"
    print(f"bn_finish over the {len(insts)} instances of one NestedUNet step (one CUDA graph, "
          f"one L2 flush): kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound:.6f} ms "
          f"({by}) | no library call takes sums | max abs err fp32 "
          f"{out[torch.float32]['max_abs_err']:.3g}, bf16 "
          f"{out[torch.bfloat16]['max_abs_err']:.3g}; the split path equals one K1 call bit "
          f"for bit at every shape", flush=True)
    for agg in out.values():
        agg.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
    return out



def bn_bits(bn, dev, path):
    """K1 (with its running-stat update), K2 and K3 outputs at the five
    levels of NestedUNet's training step, both dtypes, on seeded inputs,
    saved to `path`: run it on two trees' packages (each first on sys.path,
    in its own process) and compare the files to show that a change keeps
    the single-process kernels' bits."""
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for lvl, c, rows, _ in BN_LEVELS:
            x = (torch.randn(rows, c, generator=gen, device=dev) * 1.5 + 0.3).to(dtype)
            dy = torch.randn(rows, c, generator=gen, device=dev).to(dtype)
            gamma = torch.rand(c, generator=gen, device=dev) + 0.5
            beta = torch.rand(c, generator=gen, device=dev) * 0.6 - 0.3
            rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
            k1 = bn.bn_stats(x, 1e-5, rm, rv)
            db, dg = bn.bn_bwd_reduce(x, dy, k1[2], k1[4], gamma, beta)
            dx = bn.bn_bwd_dx(x, dy, k1[2], k1[4], gamma, beta, db, dg)
            out[f"{DTYPE_NAME[dtype]}_level{lvl}"] = [t.cpu() for t in (*k1, rm, rv, db, dg, dx)]
    torch.save(out, path)

# One data-parallel NestedUNet wDS step (full width, 96x96): launches of K1
# (its sums-only mode), bn_finish, K2, K3 and K4 on each rank
DP_LAUNCHES = {**bn_want(BN_PER_STEP, BN_PER_STEP), "multipart_conv3x3": 10}
DP_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke", "dp")
DP_RANKS = 2


def _dp_batch(n=BATCH):
    x, y = synthetic_set(64, seed=10)
    return np.resize(x, (n, *x.shape[1:])), np.resize(y, (n, *y.shape[1:]))


@contextlib.contextmanager
def deterministic():
    """Torch's deterministic algorithms (cuDNN's deterministic convolutions,
    the port's matmul adjoint of the bilinear resize, no atomics) inside
    the block: a step then gives the same bits on every run, so two paths
    that should compute the same step can be held to each other bitwise."""
    was = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.deterministic = was[1]


def _bn_fed_biases(m):
    """The names of the conv biases that feed a BN (a conv and its sibling
    BN just after it, fused, plain or flax-semantics: CA-Net's non-local W,
    whose one-pass variance cancels under a bias-dominated mean)."""
    from pytorch_nested_unet_tpu_torch.ops.fused_bn import FusedBatchNormReLU
    from pytorch_nested_unet_tpu_torch.ops.layers import BatchNorm, FlaxBatchNorm

    names = set()
    for prefix, mod in m.named_modules():
        kids = list(mod.named_children())
        for (name, conv), (_, bn) in zip(kids, kids[1:]):
            if isinstance(bn, (FusedBatchNormReLU, BatchNorm, FlaxBatchNorm)) and \
                    getattr(conv, "bias", None) is not None:
                names.add(f"{prefix}.{name}.bias" if prefix else f"{name}.bias")
    return names


def _dp_build(mesh=None, dtype=None, augment="none", moved=0.0, device="cuda",
              arch="NestedUNet", noise_seed=12, remat="none"):
    """Full-width NestedUNet wDS (or another arch, without deep supervision;
    NestedUNet under `remat`) from seed 11 on `device` and its SGD train
    step (under `mesh`, data-parallel or on bands); `moved`: every weight
    multiplied by 1 + moved * N(0, 1) (drawn from `noise_seed`), to measure
    how far rounding moves the step."""
    from pytorch_nested_unet_tpu_torch.models import create_model
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    ds = arch == "NestedUNet"
    m = create_model(arch, 1, 3, ds, dtype=dtype, generator=torch.Generator().manual_seed(11),
                     **({} if remat == "none" else {"remat": remat}))
    # the conv biases that feed a BN at 0, as in cpu_step_phase: at their
    # init they dominate the first conv's output, and var = E[x^2] - mean^2
    # then turns the rounding of a BN sum split over ranks into a 3% move of
    # a deep conv's gradient (the step would be held to summation order)
    noise = torch.Generator().manual_seed(noise_seed)
    fed = _bn_fed_biases(m)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name in fed:
                p.zero_()
            elif moved:
                p.mul_(1 + moved * torch.randn(p.shape, generator=noise))
    m = m.to(device)
    opt = build_optimizer(m.parameters(), "SGD", 1e-3, 0.9, 1e-4)
    step = make_train_step(m, opt, "BCEDiceLoss", ds, augment, mesh)
    step.optimizer = opt
    return m, step


def _dp_result(m, metrics):
    """(loss, gradients, running statistics) of a step, copied to the host."""
    return (float(metrics["loss"]),
            {n: p.grad.to("cpu", torch.float32, copy=True) for n, p in m.named_parameters()},
            {n: b.to("cpu", copy=True) for n, b in m.named_buffers()})


def _dp_rel(got, want):
    """Each gradient's L2 distance relative to the larger of its own norm and
    its module's weight gradient norm, as cpu_step_phase takes it."""
    grads, grads0 = got[1], want[1]
    return {n: float((g - grads0[n]).norm() / max(
        grads0[n].norm(), grads0.get(n.rsplit(".", 1)[0] + ".weight", grads0[n]).norm()))
        for n, g in grads.items()}


def _dp_compare(got, want, loss_tol, stats_tol, grad_tol, what):
    """Loss, running statistics and gradients (`_dp_rel`) of two steps;
    raises outside the tolerances (grad_tol: one for all, or per gradient).
    Returns (loss error, stats error, the gradient nearest its tolerance,
    its error, its tolerance)."""
    rel = _dp_rel(got, want)
    tol = grad_tol if isinstance(grad_tol, dict) else dict.fromkeys(rel, grad_tol)
    worst = max(rel, key=lambda n: rel[n] / tol[n])
    stats_err = max(float((b - want[2][n]).abs().max()) for n, b in got[2].items())
    loss_err = abs(got[0] - want[0])
    if loss_err > loss_tol or stats_err > stats_tol or rel[worst] > tol[worst]:
        raise AssertionError(f"{what}: loss {got[0]} vs {want[0]}, running stats off by "
                             f"{stats_err}, gradient {worst} off by {rel[worst]} relative L2 "
                             f"(tolerances {loss_tol}, {stats_tol}, {tol[worst]})")
    return loss_err, stats_err, worst, rel[worst], tol[worst]


def _p50_p95(step, batch, gen, steps=20):
    for _ in range(3):
        step(*batch, gen)
    if batch[0].is_cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(*batch, gen)
        if batch[0].is_cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], times[min(len(times) - 1, int(len(times) * 0.95))]


# What the gradient gates of dp_ranks and spatial_ranks are set from: the
# one-process step under a 1e-7 change of every weight (three seeds of the
# change) and over its global batch in two other orders (every sum over the
# batch, a BN's among them, then adds in another order, as it does when the
# step is split over ranks). At full width the step is chaotic at init
# (ReLU masks flip), and one reading of a gradient varies 2-3x between
# seeds, so a gradient is held to GATE_FACTOR x its largest reading.
MOVEMENT_READINGS = (("weights", 12), ("weights", 13), ("weights", 14), ("order", 1),
                     ("order", 2))
GATE_FACTOR = 4


def _dp_reference(device="cuda", arch="NestedUNet", with_floor=False, spread=True):
    """The non-distributed fp32 step over the global batch of 16 (augment
    none) and how far it moves: against itself run again (it is not
    deterministic on the card: bilinear upsampling's backward adds with
    atomics) and under each of MOVEMENT_READINGS ("weights", seed: every
    weight moved by 1e-7 N(0, 1) from that seed; "order", seed: the batch
    permuted by that seed). Returns (result,
    {gradient: run-to-run spread}, {gradient: its largest movement},
    {reading: {gradient: movement}}); `with_floor`: and (the loss's, the
    running statistics' largest movement over the readings), for a step
    whose loss and statistics are chaotic too (STEP_FLOOR_RUNS); without
    `spread`, None in place of the spread (one step fewer)."""
    x, y = _dp_batch()

    def run(order=None, **build):
        idx = np.arange(BATCH) if order is None else np.random.default_rng(order).permutation(BATCH)
        batch = (torch.from_numpy(x[idx]).to(device), torch.from_numpy(y[idx]).to(device))
        m, step = _dp_build(device=device, arch=arch, **build)
        if order is not None:
            _masks_follow(m, idx)
        out = _dp_result(m, step(*batch, torch.Generator(device).manual_seed(0)))
        del m, step
        return out

    plain = run()
    steps = {f"{kind} {seed}": run(order=seed) if kind == "order" else
             run(moved=1e-7, noise_seed=seed) for kind, seed in MOVEMENT_READINGS}
    readings = {k: _dp_rel(r, plain) for k, r in steps.items()}
    movement = {n: max(r[n] for r in readings.values()) for n in plain[1]}
    out = plain, _dp_rel(run(), plain) if spread else None, movement, readings
    if not with_floor:
        return out
    moved = [_loss_stats_moved(r, plain) for r in steps.values()]
    return out + (tuple(max(v) for v in zip(*moved)),)


def _loss_stats_moved(got, want):
    """(how far the loss, the running statistics) of step `got` are from
    `want`'s: absolute, the largest over every statistic."""
    return (abs(got[0] - want[0]),
            max(float((b - want[2][n]).abs().max()) for n, b in got[2].items()))


def _masks_follow(m, idx):
    """Every dropout of `m` draws its mask as before and permutes its rows by
    `idx`, so each image of a batch permuted by `idx` keeps the mask it has
    in the batch's own order: an "order" reading then moves only the order
    of the sums (CA-Net's channel dropouts)."""
    from pytorch_nested_unet_tpu_torch.ops.layers import Dropout

    for d in m.modules():
        if isinstance(d, Dropout):
            d.keep = lambda x, draw=d.keep: draw(x)[torch.as_tensor(idx, device=x.device)]


def _record_masks(m):
    """{name: [mask, ...]} of every dropout of `m` (on the host), filled with
    each train-mode mask it draws."""
    from pytorch_nested_unet_tpu_torch.ops.layers import Dropout

    masks = {}
    for name, d in m.named_modules():
        if isinstance(d, Dropout):
            def keep(x, draw=d.keep, drawn=masks.setdefault(name, [])):
                k = draw(x)
                drawn.append(k.cpu())
                return k

            d.keep = keep
    return masks


def _with_reading(reference, label, reading):
    """`reference` (from _dp_reference) with one more movement reading
    ({gradient: movement}) under `label`: a data-parallel split's own
    deviation off the one-process step, measured in the same call."""
    plain, spread, movement, readings = reference
    return (plain, spread, {n: max(v, reading[n]) for n, v in movement.items()},
            {**readings, label: reading})


def _readings_of(readings, name):
    """A gradient's movement under each of MOVEMENT_READINGS, for a line."""
    return ", ".join(f"{k} {r[name]:.3g}" for k, r in readings.items())


def dp_worker(rank, world, port, out_dir, backend, device, steps):
    """One rank of a data-parallel run (dp_phase's 2 ranks over Gloo on one
    card, `--dp-cards`' N over NCCL, one card each): one fp32 step of
    full-width NestedUNet wDS on this rank's rows of the global batch of 16
    (augment none, TF32 off), its launches and the p50 of `steps` more; over
    NCCL also the bf16 step's p50 at 16 rows a rank (augment full). Written
    to rank<rank>.pt under out_dir."""
    from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
    from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn
    from pytorch_nested_unet_tpu_torch.parallel import (batch_sharding, initialize_distributed,
                                                        make_mesh)
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_distributed(backend=backend, device=dev, world_size=world, rank=rank,
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh()
        x, y = _dp_batch()
        rows = batch_sharding(mesh, BATCH)
        batch = (torch.from_numpy(x[rows]).to(dev), torch.from_numpy(y[rows]).to(dev))
        m, step = _dp_build(mesh, device=dev)
        reset_counts(bn, df)
        result = _dp_result(m, step(*batch, torch.Generator(dev).manual_seed(0)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        first = launch_counts(bn, df)
        p50, _ = _p50_p95(step, batch, torch.Generator(dev).manual_seed(0), steps)
        out = {"result": result, "launches": first, "p50": p50, "backend": dist.get_backend()}
        del m, step
        if backend == "nccl":
            x16, y16 = _dp_batch(BATCH * world)
            rows = batch_sharding(mesh, BATCH * world)
            m, step = _dp_build(mesh, torch.bfloat16, "full", device=dev)
            out["bf16_p50"] = _p50_p95(step, (torch.from_numpy(x16[rows]).to(dev),
                                              torch.from_numpy(y16[rows]).to(dev)),
                                       torch.Generator(dev).manual_seed(0), steps)
        out["total"] = launch_counts(bn, df)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(argvs, what, envs=None, cwd=None, meanwhile=None):
    """One process per argv (with envs[rank] as its environment), all
    started together (`meanwhile()` runs here while they run); returns their
    outputs and the wall seconds, raising if one fails or outlasts 600 s
    (whatever is left is killed)."""
    t0 = time.perf_counter()
    procs = []
    try:
        for rank, argv in enumerate(argvs):
            procs.append(subprocess.Popen(
                argv, env=envs[rank] if envs else None, cwd=cwd, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        if meanwhile is not None:
            meanwhile()
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{what} rank {rank} of {len(argvs)} failed:\n{log[-3000:]}")
    return logs, time.perf_counter() - t0


def dp_ranks(world, backend, reference, card, steps=10, device=None):
    """Run `world` dp_worker processes (over NCCL each on its own card,
    cuda:RANK; over Gloo all on `device`, default the first card) and hold
    each rank's fp32 step against the one-process step over 16
    (`reference`, from _dp_reference): loss and running statistics within
    1e-5, each gradient within 1e-4 or GATE_FACTOR x its largest movement
    over MOVEMENT_READINGS, where that is more (a rank adds each BN's sums
    in another order; cpu_step_phase's step_floor rule), DP_LAUNCHES per
    step. Returns the ranks' outputs."""
    plain, _, movement, readings = reference
    os.makedirs(DP_ROOT, exist_ok=True)
    for f in os.listdir(DP_ROOT):
        os.remove(os.path.join(DP_ROOT, f))
    port = _free_port()
    _, wall = _run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--dp-worker", str(rank), str(world),
          str(port), DP_ROOT, backend,
          f"cuda:{rank}" if backend == "nccl" else (device or "cuda:0"), str(steps)]
         for rank in range(world)], f"dp ({backend})")
    outs = []
    gate = {n: max(1e-4, GATE_FACTOR * v) for n, v in movement.items()}
    for rank in range(world):
        r = torch.load(os.path.join(DP_ROOT, f"rank{rank}.pt"), weights_only=False)
        if r["launches"] != DP_LAUNCHES:
            raise AssertionError(f"dp rank {rank}: launches {r['launches']} per step, expected "
                                 f"{DP_LAUNCHES}")
        loss_err, stats_err, worst, rel, tol = _dp_compare(r["result"], plain, 1e-5, 1e-5, gate,
                                                           f"dp rank {rank} of {world}")
        largest = max(_dp_rel(r["result"], plain).items(), key=lambda kv: kv[1])
        bf16 = r.get("bf16_p50")
        print(f"dp rank {rank} of {world} ({r['backend']}, {BATCH // world} rows of {BATCH}), "
              f"one fp32 step against the one-process step over {BATCH}: loss off by "
              f"{loss_err:.3g} (1e-5), running stats by {stats_err:.3g} (1e-5), gradients: "
              f"nearest its gate {worst} at {rel:.3g} (gate {tol:.3g}), largest {largest[0]} "
              f"at {largest[1]:.3g} (its gate {gate[largest[0]]:.3g}); {worst}'s readings "
              f"({_readings_of(readings, worst)}); the step's largest movement over them: "
              f"median {np.median(list(movement.values())):.3g}, max "
              f"{max(movement.values()):.3g} "
              f"| launches per step {r['launches']} | fp32 p50 of {steps} steps "
              f"{r['p50']:.3f} ms"
              + (" (a correctness run: Gloo stages each all-reduce through host memory)"
                 if backend == "gloo" else "")
              + (f" | bf16 at {BATCH} rows a rank (global {BATCH * world}): p50 {bf16[0]:.3f} "
                 f"ms (p95 {bf16[1]:.3f})" if bf16 else "")
              + f" | all ranks' wall {wall:.1f} s | card: {card}", flush=True)
        outs.append(r)
    return outs


def dp_phase(bn, df, card, reference):
    """Data-parallel NestedUNet wDS (full width, 96x96, global batch 16):
    (a) a world of one process over NCCL (`--mesh data=1`'s path): one fp32
    step (augment none) against the non-distributed step from the same
    weights, both under deterministic algorithms (`deterministic`; the card's
    step is not deterministic without them): loss, running statistics and
    gradients bitwise equal, DP_LAUNCHES per step; then the step's
    p50 / p95 and busy share in fp32 and bf16 beside the plain step's
    (plain, mesh, mesh, plain); (b) two ranks on the one card over Gloo
    (`dp_ranks`), each stepping on its 8 rows. `reference`: _dp_reference().
    Returns {precision: launches} over every step driven here and by the
    ranks."""
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.parallel import initialize_single_process, make_mesh

    x, y = _dp_batch()
    batch = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)  # noqa: E731
    spread = reference[1]
    floor_worst = max(spread, key=spread.get)
    floor = spread[floor_worst]
    totals = {"fp32": bn_want(0), "bf16": bn_want(0)}
    for t in totals.values():
        t["multipart_conv3x3"] = 0

    def count(precision):
        for k, v in launch_counts(bn, df).items():
            totals[precision][k] += v

    initialize_single_process("nccl")
    try:
        mesh = make_mesh()
        with deterministic():
            reset_counts(bn, df)
            m, step = _dp_build(mesh)
            got = _dp_result(m, step(*batch, gen()))
            torch.cuda.synchronize()
            per_step = launch_counts(bn, df)
            count("fp32")
            del m, step
            m, step = _dp_build()
            want = _dp_result(m, step(*batch, gen()))
            del m, step
        if per_step != DP_LAUNCHES:
            raise AssertionError(f"dp world 1: launches {per_step} per step, expected "
                                 f"{DP_LAUNCHES}")
        pairs = [(torch.tensor(got[0]), torch.tensor(want[0]))] + [
            (v, want[i][n]) for i in (1, 2) for n, v in got[i].items()]
        if not all(torch.equal(a, b) for a, b in pairs):
            diff = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
            raise AssertionError(f"dp world 1 (NCCL): under deterministic algorithms the step "
                                 f"differs from the non-distributed step by {diff:.3g}")
        print(f"dp world 1 ({dist.get_backend()}), one fp32 step (batch {BATCH}, "
              f"{SIZE}x{SIZE}) under deterministic algorithms: bitwise the non-distributed "
              f"step under them (loss, running stats, every gradient; without them the plain "
              f"step moves run to run, {floor_worst} by {floor:.3g} relative L2) | launches "
              f"per step {per_step} | card: {card}", flush=True)
        for precision, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            rows = []
            reset_counts(bn, df)
            for kind in ("plain", "mesh", "mesh", "plain"):
                m, step = _dp_build(mesh if kind == "mesh" else None, dtype, "full")
                rows.append((kind, *_p50_p95(step, batch, gen())))
                del m, step
            count(precision)
            reset_counts(bn, df)
            busy = {}
            for kind in ("plain", "mesh"):
                m, step = _dp_build(mesh if kind == "mesh" else None, dtype, "full")
                step(*batch, gen())
                busy[kind] = profile_steps(step, batch, gen(), f"dp {kind} {precision}", card,
                                           host_ops=8)
                del m, step
            count(precision)
            print(f"dp step {precision}: NestedUNet wDS full width, batch {BATCH} "
                  f"{SIZE}x{SIZE}, 20 steps each, p50 (p95) ms: " + ", ".join(
                      f"{kind} {p50:.3f} ({p95:.3f})" for kind, p50, p95 in rows)
                  + " | busy ms/step (share of wall, profiler on): " + ", ".join(
                      f"{kind} {b:.3f} ({100 * b / w:.1f}%)" for kind, (w, b) in busy.items())
                  + f" | card: {card}", flush=True)
    finally:
        dist.destroy_process_group()

    for r in dp_ranks(DP_RANKS, "gloo", reference, card, steps=5):
        for k, v in r["total"].items():
            totals["fp32"][k] += v
    return totals


DP_CLI_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke",
                           "dp_cli")


def _dp_cli_launch(world, args, out_of_rank, device_of_rank, gloo=False):
    """train.main as `world` processes with torchrun's variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns their
    outputs, raising if one fails. `gloo`: each process joins a Gloo world
    first (`--gloo-train`), so that ranks can share a card (train.main
    takes NCCL for CUDA devices)."""
    port = _free_port()
    entry = ([os.path.abspath(__file__), "--gloo-train"] if gloo
             else ["-m", "pytorch_nested_unet_tpu_torch.train"])
    return _run_ranks(
        [[sys.executable, *entry, *args, "--output_dir", out_of_rank(rank), "--device",
          device_of_rank(rank)] for rank in range(world)], "cli",
        envs=[dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)) for rank in range(world)],
        cwd=os.path.dirname(os.path.abspath(__file__)))[0]


def _rank0_capsule(world, out_of_rank, what):
    """Raise unless rank 0 alone wrote the run's capsule; returns its dir."""
    capsule = ("config.yml", "log.csv", "model.pth", "last.pth")
    run0 = os.path.join(out_of_rank(0), "run")
    written = [r for r in range(1, world) for f in capsule
               if os.path.exists(os.path.join(out_of_rank(r), "run", f))]
    if not all(os.path.isfile(os.path.join(run0, f)) for f in capsule) or written:
        raise AssertionError(f"{what}: rank 0's capsule {os.listdir(run0)}, other ranks wrote "
                             f"{written}")
    return run0


def _dp_cli_set():
    """24 seeded 32x32 PNG pairs under DP_CLI_ROOT/inputs, written anew;
    returns the narrow UNet's train arguments on them."""
    import shutil

    from pytorch_nested_unet_tpu_torch.data import image_io

    shutil.rmtree(DP_CLI_ROOT, ignore_errors=True)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:32, 0:32]
    for sub in ("images", "masks/0"):
        os.makedirs(os.path.join(DP_CLI_ROOT, "inputs", "synth", sub))
    for i in range(24):
        img = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
        cy, cx = rng.integers(10, 22, 2)
        mask = ((((yy - cy) ** 2 + (xx - cx) ** 2) < 25) * 255).astype(np.uint8)
        img[mask > 0] = 220
        image_io.write_png(os.path.join(DP_CLI_ROOT, "inputs", "synth", "images",
                                        f"im{i:02d}.png"), img)
        image_io.write_png(os.path.join(DP_CLI_ROOT, "inputs", "synth", "masks", "0",
                                        f"im{i:02d}.png"), mask)
    return ["--data_dir", os.path.join(DP_CLI_ROOT, "inputs"), "--dataset", "synth",
            "--arch", "UNet", "--arch_kwargs", '{"nb_filter": [4, 8, 16, 32, 64]}', "--name",
            "run", "--input_w", "32", "--input_h", "32", "--batch_size", "8", "--lr", "1e-2",
            "--precision", "fp32"]


def _read_log(run_dir):
    with open(os.path.join(run_dir, "log.csv")) as f:
        return list(csv.DictReader(f))


def dp_cli(world, card, device="cuda"):
    """The folder CLI data-parallel over `world` processes, as
    tests/test_torch_multihost.py runs it on the CPU: a narrow UNet
    (nb_filter 4..64, 32x32, batch 8, fp32, Adam, augment full) on 24
    seeded PNG pairs, `--mesh data=N` for 2 epochs with each rank writing
    to its own --output_dir (no shared filesystem), then `--resume` to a
    3rd; then one process with `--mesh data=1` on the same schedule
    (`--resume` re-seeds the shuffle). Holds the two log.csv's to
    the JAX multi-host test's bounds (loss rtol 2e-4 / atol 2e-5, IoU atol
    0.02), checks that rank 0 alone wrote the capsule and that every rank
    resumed from epoch 1. `device`: "cuda" gives rank r cuda:r (NCCL);
    "cpu" runs the ranks on the CPU over Gloo."""
    args = _dp_cli_set()
    outs_of = lambda r: os.path.join(DP_CLI_ROOT, f"out{r}")  # noqa: E731
    dev_of = (lambda r: f"cuda:{r}") if device == "cuda" else (lambda r: "cpu")  # noqa: E731
    t0 = time.perf_counter()
    outs = _dp_cli_launch(world, args + ["--mesh", f"data={world}", "--epochs", "2"], outs_of,
                          dev_of)
    wall = time.perf_counter() - t0
    if f"multi-host: process 0/{world}" not in outs[0] or \
            f"mesh: {{'data': {world}}}" not in outs[0]:
        raise AssertionError(f"dp cli: rank 0 printed no multi-host / mesh line:\n"
                             f"{outs[0][-2000:]}")
    run0 = _rank0_capsule(world, outs_of, "dp cli")
    outs = _dp_cli_launch(world, args + ["--mesh", f"data={world}", "--epochs", "3",
                                         "--resume", "true"], outs_of, dev_of)
    if not all("resumed from epoch 1" in out for out in outs):
        raise AssertionError("dp cli: a rank did not resume from rank 0's last.pth")
    for extra in (["--epochs", "2"], ["--epochs", "3", "--resume", "true"]):
        # the same schedule in one process: --resume re-seeds the shuffle
        one = subprocess.run([sys.executable, "-m", "pytorch_nested_unet_tpu_torch.train",
                              *args, "--mesh", "data=1", *extra, "--output_dir",
                              os.path.join(DP_CLI_ROOT, "one"), "--device",
                              "cuda:0" if device == "cuda" else "cpu"],
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=600)
        if one.returncode != 0:
            raise AssertionError(f"dp cli one process failed:\n{one.stdout[-3000:]}")

    a, b = _read_log(run0), _read_log(os.path.join(DP_CLI_ROOT, "one", "run"))
    worst = {}
    for col, rtol, atol in (("loss", 2e-4, 2e-5), ("val_loss", 2e-4, 2e-5), ("iou", 0, 0.02),
                            ("val_iou", 0, 0.02)):
        x, y = (np.array([float(r[col]) for r in t]) for t in (a, b))
        if len(x) != 3 or len(y) != 3 or not np.allclose(x, y, rtol=rtol, atol=atol):
            raise AssertionError(f"dp cli: {col} over {world} ranks {x} vs one process {y}")
        worst[col] = float(np.abs(x - y).max())
    print(f"dp cli: train.main --mesh data={world} over {world} processes ({device}), narrow "
          f"UNet 32x32 batch 8 fp32, 2 epochs in {wall:.1f} s of wall, then --resume to a 3rd "
          f"(every rank resumed from rank 0's last.pth; rank 0 alone wrote the capsule); "
          f"log.csv against --mesh data=1 in one process, max abs diff " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items()) + f" | card: {card}", flush=True)


def dp_cards(world):
    """`python3 chip_smoke.py --dp-cards N`: data-parallel NestedUNet wDS over
    N cards of one host (NCCL, one process a card): each rank's fp32 step on
    its 16/N rows held against the one-process step over 16 on the first
    card (dp_ranks' gates), then each rank's bf16 step p50 at 16 rows a
    rank (global 16N) beside the one-card bf16 step's at 16; then the
    folder CLI over the N cards (`dp_cli`); with N >= 4 the 'model' axis
    runs before it (`model_ranks`: NestedUNet wDS under data=2,model=2 and
    data=1,x=2,model=2 against data=2 and data=1,x=2 on two of the cards),
    then `train --mesh data=2,x=2` (`spatial_cli`) and last NestedUNet wDS
    under data=2,x=2 (`spatial_ranks`; its gradient gates also read the
    N-way data split's own deviation, as one more MOVEMENT_READINGS entry:
    both add every BN sum in N partial sums; it also prints the band step's
    own movement under the weight readings and, before its gates, the ReLU
    masks and pool choices that differ from the one-process step's under
    deterministic algorithms (`flip_reading`), F3's evidence) over NCCL. That
    last check fails its gate by ~4% (ROADMAP.md F3), so it runs after
    every other."""
    from pytorch_nested_unet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    if torch.cuda.device_count() < world:
        raise AssertionError(f"--dp-cards {world}: {torch.cuda.device_count()} card(s)")
    print(f"card: {card} x{torch.cuda.device_count()} | torch {torch.__version__}", flush=True)
    _build.build_all()
    reference = _dp_reference()
    x, y = _dp_batch()
    m, step = _dp_build(None, torch.bfloat16, "full")
    p50, p95 = _p50_p95(step, (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()),
                        torch.Generator(device="cuda").manual_seed(0), 10)
    del m, step
    print(f"dp one card, bf16 step at {BATCH}: p50 {p50:.3f} ms (p95 {p95:.3f}) | card: {card}",
          flush=True)
    dp_outs = dp_ranks(world, "nccl", reference, card)
    if world >= 4:
        model_ranks(list(MODEL_RUNS), "nccl", reference, card)
    dp_cli(world, card)
    if world >= 4:
        spatial_cli(4, "data=2,x=2", card, gloo=False)
        # last: its gate fails over NCCL (ROADMAP.md F3), which must hide no
        # other check
        split = {n: max(_dp_rel(r["result"], reference[0])[n] for r in dp_outs)
                 for n in reference[2]}
        run = "NestedUNet data=2,x=2"
        spatial_ranks([run], "nccl", {run: _with_reading(reference, f"dp data={world}", split)},
                      card)
    return 0


# Spatial partitioning (the 'x'/'y' mesh axes): (arch, --mesh spec, ranks,
# steps, launches per rank per step, --remat). NestedUNet wDS's 30 BN layers
# through K1's sums-only mode, bn_finish, K2 and K3 and its 10 K4 nodes
# (under --remat full 60 K1 and bn_finish, whose recompute runs them again,
# and 20 K4); UNet's 18 and 4; UNetRNN's 15 (its GRU decoder's carry resized
# on bands) and no K4; AttU_Net's plain BNs none; VGG16RNN's 18 (LSTM
# decoder); UNetRNNAttention's 15 (exact PAM, its keys and values gathered
# from both bands, and CAM, its gram summed over them, at every level);
# CA-Net's plain and flax-semantics BNs none (feature_scale 4, one class,
# its channel dropout on at 0.5, drawn per data row: the run asserts that
# both bands and the one-process step draw the same masks); ResNet50RNN's 5
# score blocks (its trunk's strided convs and 3x3/2 pool on bands, its BNs
# plain); DoubleUnet's plain BNs none (its 3 rows at 1/32 cut
# 1/2); UNetRNNPSP's 15 in its
# UNetRNN trunk (the refinement net's BNs plain, its adaptive pools summed
# over the bands); and on the bands that the maps' rows do not divide
# evenly: NestedUNet wDS under x=4 (4 ranks; its 6 rows at 1/16 cut
# 1/2/1/2), UNetRM7's 21 (its 1-row level leaves rank 0 an empty band, on
# which K1-K3 launch on zero rows), ResNet50FCN (plain BNs; its valid 3x3
# classifier and nearest resizes at non-integer ratios) and DeepLab (plain
# BNs; bands of 3 rows at 1/16 under dilations up to 18, its element-wise
# dropouts on, each band's masks the one-process masks cut to the band).
# On one card over Gloo
# (NCCL refuses two ranks on one device); `--dp-cards 4` adds data=2,x=2
# over NCCL, a card a rank. Each gradient is held as dp_ranks holds it
# (GATE_FACTOR x its largest movement over MOVEMENT_READINGS, and under
# `--dp-cards` the data split's own deviation): a band's BN sums and the
# gathered heads' sums add in another order, as a data split's do. The
# remat runs are also held to the band step without remat on the same ranks
# (both under `deterministic`: 1e-4 relative L2, the running statistics
# equal, as remat_phase holds remat on one card), and print each rank's
# peak memory in both. data=2,x=2 over NCCL exceeds its gate by 4% at one
# level-3 gradient (ROADMAP.md queue 3, F3).
SPATIAL_RUNS = {
    "NestedUNet x=2": ("NestedUNet", "data=1,x=2", 2, 2, DP_LAUNCHES, "none"),
    "UNet x=2,y=2": ("UNet", "x=2,y=2", 4, 1, {**bn_want(18, 18), "multipart_conv3x3": 4},
                     "none"),
    "NestedUNet data=2,x=2": ("NestedUNet", "data=2,x=2", 4, 2, DP_LAUNCHES, "none"),
    "AttU_Net x=2": ("AttU_Net", "data=1,x=2", 2, 2, {**bn_want(0), "multipart_conv3x3": 0},
                     "none"),
    "UNetRNN x=2": ("UNetRNN", "data=1,x=2", 2, 2,
                    {**bn_want(UNETRNN_BN_PER_STEP, UNETRNN_BN_PER_STEP),
                     "multipart_conv3x3": 0}, "none"),
    "NestedUNet x=2 remat full": ("NestedUNet", "data=1,x=2", 2, 2,
                                  {"bn_stats": 60, "bn_bwd_reduce": 30, "bn_bwd_dx": 30,
                                   "bn_finish": 60, "multipart_conv3x3": 20}, "full"),
    "NestedUNet x=2 remat policy": ("NestedUNet", "data=1,x=2", 2, 2, DP_LAUNCHES, "policy"),
    "VGG16RNN x=2": ("VGG16RNN", "data=1,x=2", 2, 2,
                     {**bn_want(VGG16RNN_BN_PER_STEP, VGG16RNN_BN_PER_STEP),
                      "multipart_conv3x3": 0}, "none"),
    "UNetRNNAttention x=2": ("UNetRNNAttention", "data=1,x=2", 2, 2,
                             {**bn_want(UNETRNN_BN_PER_STEP, UNETRNN_BN_PER_STEP),
                              "multipart_conv3x3": 0}, "none"),
    "Comprehensive_Atten_Unet x=2": ("Comprehensive_Atten_Unet", "data=1,x=2", 2, 2,
                                     {**bn_want(0), "multipart_conv3x3": 0}, "none"),
    "ResNet50RNN x=2": ("ResNet50RNN", "data=1,x=2", 2, 2,
                        {**bn_want(RESNET_RNN_BN_PER_STEP, RESNET_RNN_BN_PER_STEP),
                         "multipart_conv3x3": 0}, "none"),
    "DoubleUnet x=2": ("DoubleUnet", "data=1,x=2", 2, 2, {**bn_want(0), "multipart_conv3x3": 0},
                       "none"),
    "UNetRNNPSP x=2": ("UNetRNNPSP", "data=1,x=2", 2, 2,
                       {**bn_want(UNETRNN_BN_PER_STEP, UNETRNN_BN_PER_STEP),
                        "multipart_conv3x3": 0}, "none"),
    "NestedUNet x=4": ("NestedUNet", "data=1,x=4", 4, 2, DP_LAUNCHES, "none"),
    "UNetRM7 x=2": ("UNetRM7", "data=1,x=2", 2, 2,
                    {**bn_want(UNETRM7_BN_PER_STEP, UNETRM7_BN_PER_STEP),
                     "multipart_conv3x3": 0}, "none"),
    "ResNet50FCN x=2": ("ResNet50FCN", "data=1,x=2", 2, 2,
                        {**bn_want(0), "multipart_conv3x3": 0}, "none"),
    "DeepLab x=2": ("DeepLab", "data=1,x=2", 2, 2, {**bn_want(0), "multipart_conv3x3": 0},
                    "none"),
}


# the runs whose one-process step's peak device memory is printed beside the
# band step's a rank (a band's PAM energy is (h*w) x (H*W) per image)
PEAK_RUNS = ("VGG16RNN x=2", "UNetRNNAttention x=2", "Comprehensive_Atten_Unet x=2",
             "ResNet50RNN x=2", "DoubleUnet x=2", "UNetRNNPSP x=2", "UNetRM7 x=2",
             "ResNet50FCN x=2", "DeepLab x=2")
SPATIAL_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke",
                            "spatial")
# The band runs whose workers also step under MOVEMENT_READINGS' weight
# changes (the seeds), to read how far the band step moves against its own
# unperturbed step. For data=2,x=2 the readings are printed beside its gate,
# not added to it (F3). The runs of BAND_GATED add them to their gates: the
# archs after UNet and NestedUNet, whose full-width steps on bands sit at
# discrete choices within rounding of their edge (UNetRNN's band step chooses
# otherwise than the one-process step in one level-2 max-pool window, whose
# two largest values are 3.96e-6 apart, and so moves conv3's gradients by
# 1.08e-3; a 1e-7 change of the weights moves the band step back). A fault
# of the band path would move the band steps alike under every weight
# change, and so stay outside the gate.
BAND_READINGS = {"NestedUNet data=2,x=2": (12, 13, 14), "AttU_Net x=2": (12, 13, 14),
                 "UNetRNN x=2": (12, 13, 14), **{run: (12, 13, 14) for run in PEAK_RUNS}}
BAND_GATED = {"AttU_Net x=2", "UNetRNN x=2", *PEAK_RUNS}
# The band runs whose maps leave empty bands, and the ranks that hold one:
# UNetRM7's 1-row level over 2 bands, cut 0/1
EMPTY_BAND_RUNS = {"UNetRM7 x=2": (0,)}
# The band runs whose loss and running statistics are chaotic too, and so
# are held to 1e-5 or GATE_FACTOR x their largest movement (the one-process
# readings' and the band step's own): UNetRNNPSP's refinement cascade at
# init, whose gradients move by up to 8.6x their norm under a 1e-7 weight
# change on the card, as cpu_step_phase's `step_floor` holds its step; and
# DeepLab, whose card step cpu_step_phase holds so too (its band step's
# running statistics sat 1.55e-5 off the one-process step's in a card run)
STEP_FLOOR_RUNS = {"UNetRNNPSP x=2", "DeepLab x=2"}


def _spatial_slug(run):
    return run.replace(" ", "_").replace(",", "_")


def _lanes(runs, world):
    """{run: the first of the consecutive ranks it runs on}: a run of the
    whole world on all of them, the smaller runs dealt in turn to the
    world's groups of their size (2-rank runs on ranks 0-1 and 2-3 at once:
    the band steps wait on the host, so two of them share the card)."""
    lanes, dealt = {}, {}
    for run in runs:
        ranks = SPATIAL_RUNS[run][2]
        k = dealt.get(ranks, 0)
        lanes[run], dealt[ranks] = (k % (world // ranks)) * ranks, k + 1
    return lanes


def spatial_worker(rank, world, port, out_dir, backend, device, runs):
    """One rank of one or more spatial runs (SPATIAL_RUNS' entries named in
    `runs`, ';'-joined, in order; a run of fewer ranks than the world on its
    lane's ranks, `_lanes`): the fp32 step of the full-width arch (augment
    none, TF32 off) on this rank's band of its rows of the global batch of
    16 at 96x96, its launches and halo statistics, then the rest of the
    run's steps timed. Written to <run>_rank<rank in the run>.pt."""
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
    from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn
    from pytorch_nested_unet_tpu_torch.parallel import (batch_sharding, halo,
                                                        initialize_distributed, make_mesh,
                                                        parse_mesh_spec)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    initialize_distributed(backend=backend, device=dev, world_size=world, rank=rank,
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        runs = runs.split(";")
        lanes, groups = _lanes(runs, world), {}
        # every rank creates every group, in one order (new_group is collective)
        for size in sorted({SPATIAL_RUNS[run][2] for run in runs}):
            for start in range(0, world, size):
                groups[size, start] = (dist.group.WORLD if size == world
                                       else dist.new_group(list(range(start, start + size))))
        for run in runs:
            arch, spec, ranks, steps, _, remat = SPATIAL_RUNS[run][:6]
            lane = lanes[run]
            if not lane <= rank < lane + ranks:
                continue
            group = groups[ranks, lane]
            names, sizes = parse_mesh_spec(spec)
            mesh = make_mesh(sizes, names, group=group)
            x, y = _dp_batch()
            rows = batch_sharding(mesh, BATCH)
            batch = (torch.from_numpy(x[rows]).to(dev), torch.from_numpy(y[rows]).to(dev))
            out = {}
            if remat != "none":
                # the band step without remat on the same ranks, both steps
                # under deterministic algorithms, each from a fresh model
                # with the peak counted from its step's start
                with deterministic():
                    m, step = _dp_build(mesh, device=dev, arch=arch)
                    out["none_result"], out["none_peak"] = _peak_step(m, step, batch, dev)
                del m, step
                gc.collect()
            m, step = _dp_build(mesh, device=dev, arch=arch, remat=remat)
            drawn = _record_masks(m)
            empty = _EmptyBandBNs(m)
            reset_counts(bn, df)
            halo.reset_stats()
            with deterministic() if remat != "none" else contextlib.nullcontext():
                result, out["peak"] = _peak_step(m, step, batch, dev)
            first, stats = launch_counts(bn, df), dict(halo.STATS)
            out["masks"] = {name: d[0] for name, d in drawn.items()}
            out["empty_bn"] = empty.close()
            halo.reset_stats()
            times = []
            for _ in range(steps - 1):
                t0 = time.perf_counter()
                step(*batch, torch.Generator(dev).manual_seed(0))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            # the first step also pays the collectives' set-up (NCCL creates
            # its communicators at their first use)
            steady = {k: v / len(times) for k, v in halo.STATS.items()} if times else None
            out.update(result=result, launches=first, halo=stats, steady=steady,
                       backend=dist.get_backend(), total=launch_counts(bn, df),
                       p50=float(np.median(times)) if times else None)
            del m, step
            if run in FLIP_READINGS:
                # the band step again under deterministic algorithms, its
                # ReLU masks and pool choices recorded (flip_reading compares them)
                with deterministic():
                    m, step = _dp_build(mesh, device=dev, arch=arch)
                    record = ActivationRecord(m)
                    try:
                        out["flips"] = {"result": _dp_result(m, step(
                            *batch, torch.Generator(dev).manual_seed(0))), **record.band()}
                    finally:
                        record.close()
                del m, step
            if run in BAND_READINGS:
                # the band step's own movement under MOVEMENT_READINGS' weight
                # changes, against its own unperturbed step, and for the runs
                # of FLIP_READINGS that step once more on a fresh model
                # (ROADMAP.md F3); the run's first rank keeps the steps to hold them
                # against the one-process step too
                out["band_readings"], kept = {}, {}
                again = [("again", {})] if run in FLIP_READINGS else []
                for label, build in ([(f"weights {seed}", {"moved": 1e-7, "noise_seed": seed})
                                      for seed in BAND_READINGS[run]] + again):
                    m, step = _dp_build(mesh, device=dev, arch=arch, **build)
                    kept[label] = _dp_result(m, step(*batch, torch.Generator(dev).manual_seed(0)))
                    out["band_readings"][label] = _dp_rel(kept[label], result)
                    del m, step
                if rank == lane:
                    out["band_steps"] = kept
            torch.save(out, os.path.join(out_dir, f"{_spatial_slug(run)}_rank{rank - lane}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


class _EmptyBandBNs:
    """The FusedBatchNormReLU forwards of a model on zero rows (a band of
    a map with fewer rows than bands): each launches K1 (sums-only) on
    zero rows, and its backward K2 and K3. `close()` removes the hooks and
    returns the count."""

    def __init__(self, m):
        from pytorch_nested_unet_tpu_torch.ops.fused_bn import FusedBatchNormReLU

        self.n = 0
        self.handles = [mod.register_forward_pre_hook(self._seen) for mod in m.modules()
                        if isinstance(mod, FusedBatchNormReLU)]

    def _seen(self, mod, args):
        if mod.training and args[0].numel() == 0:
            self.n += 1

    def close(self):
        for h in self.handles:
            h.remove()
        return self.n


def _peak_step(m, step, batch, dev):
    """(the step's result, the peak of device memory allocated during it,
    in MiB): the model and its optimizer state are in it."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    result = _dp_result(m, step(*batch, torch.Generator(dev).manual_seed(0)))
    torch.cuda.synchronize(dev)
    return result, torch.cuda.max_memory_allocated(dev) / 2**20


def spatial_ranks(runs, backend, references, card, extras=None, floors=None, prepare=None):
    """Run SPATIAL_RUNS' `runs` in one set of spatial_worker processes (as
    many as the largest run needs; over Gloo all on the first card, over
    NCCL rank r on cuda:r) and hold each rank's fp32 step against the
    one-process step over the global batch (`references[run]`, from
    _dp_reference): loss and running statistics within 1e-5, each gradient
    within 1e-4 or GATE_FACTOR x its largest movement over
    MOVEMENT_READINGS, the run's launches per step (SPATIAL_RUNS), and with
    `extras[run]` (from _one_process_extras) each dropout's mask equal to the
    one-process step's; with `floors[run]` (_dp_reference's `with_floor`
    movement of the loss and the running statistics, STEP_FLOOR_RUNS) the
    loss and statistics within 1e-5 or GATE_FACTOR x their largest movement
    over the readings and the band step's own (BAND_GATED). `prepare`: a
    function that returns (references, extras, floors), run here while the
    workers run (the one-process steps then overlap the band steps, which
    wait on the host). Prints each rank's halo bytes and host ms in halo
    exchange and gather_bands per step, the band collectives' (bands.py's
    all-gathers and all-reduces), its step p50 and its step's peak device
    memory (beside the one-process step's, with `extras`). Returns {run:
    the ranks' outputs}."""
    world = max(SPATIAL_RUNS[run][2] for run in runs)
    out_dir = os.path.join(SPATIAL_ROOT, _spatial_slug(runs[0]) if len(runs) == 1 else "all")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    port = _free_port()
    prepared = []
    _, wall = _run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--spatial-worker", str(rank), str(world),
          str(port), out_dir, backend, f"cuda:{rank}" if backend == "nccl" else "cuda:0",
          ";".join(runs)] for rank in range(world)], f"spatial ({backend})",
        meanwhile=prepare and (lambda: prepared.append(prepare())))
    if prepared:
        references, extras, floors = prepared[0]
    results = {}
    for run in runs:
        arch, spec, ranks, steps, want = SPATIAL_RUNS[run][:5]
        plain, _, movement, readings = references[run]
        results[run] = []
        outs = [torch.load(os.path.join(out_dir, f"{_spatial_slug(run)}_rank{rank}.pt"),
                           weights_only=False) for rank in range(ranks)]
        if run in BAND_GATED:  # the band step's own movement joins the readings
            band = {f"band {k}": v for k, v in outs[0]["band_readings"].items()
                    if k.startswith("weights")}
            movement = {n: max([v] + [b[n] for b in band.values()]) for n, v in movement.items()}
            readings = {**readings, **band}
        gate = {n: max(1e-4, GATE_FACTOR * v) for n, v in movement.items()}
        loss_tol = stats_tol = 1e-5
        if (floors or {}).get(run) is not None:
            moved = [floors[run]] + [_loss_stats_moved(res, outs[0]["result"])
                                     for k, res in outs[0].get("band_steps", {}).items()
                                     if k.startswith("weights")]
            loss_tol, stats_tol = (max([1e-5] + [GATE_FACTOR * v for v in vs])
                                   for vs in zip(*moved))
        if run in FLIP_READINGS:  # before the gates, which data=2,x=2's fails (F3)
            flip_reading(run, outs, card)
        extra = (extras or {}).get(run)
        for rank, r in enumerate(outs):
            if r["launches"] != want:
                raise AssertionError(f"spatial {run} rank {rank}: launches {r['launches']} per "
                                     f"step, expected {want}")
            if run in EMPTY_BAND_RUNS and rank in EMPTY_BAND_RUNS[run] and not r["empty_bn"]:
                raise AssertionError(f"spatial {run} rank {rank}: no BN ran on an empty band")
            if extra is not None:
                _hold_masks(run, rank, r["masks"], extra["masks"], card,
                            (rank % SPATIAL_RUNS[run][2], SPATIAL_RUNS[run][2]))
            if "band_steps" in r:
                _print_band_readings(run, r, plain, gate, movement, readings, card)
            if "none_result" in r:
                _hold_remat_band(run, rank, r, card)
            loss_err, stats_err, worst, rel, tol = _dp_compare(
                r["result"], plain, loss_tol, stats_tol, gate, f"spatial {run} rank {rank}")
            h, st = r["halo"], r["steady"]
            p50 = f"{r['p50']:.3f} ms" if r["p50"] is not None else "not measured (1 step)"
            later = [f" ({st[k] * 1e3:.1f} a later step)" if st else ""
                     for k in ("halo_s", "gather_s", "allgather_s", "allreduce_s")]
            print(f"spatial {run} rank {rank} of {ranks} ({r['backend']}, {arch} full width, "
                  f"global batch {BATCH} at {SIZE}x{SIZE}, fp32), one step "
                  f"against the one-process step: loss off by {loss_err:.3g} ({loss_tol:.3g}), "
                  f"running stats by {stats_err:.3g} ({stats_tol:.3g}), gradient nearest its "
                  f"gate {worst} at {rel:.3g} (gate {tol:.3g}: 1e-4 or {GATE_FACTOR}x its largest reading; readings "
                  f"{_readings_of(readings, worst)}) | "
                  f"launches per step {r['launches']} | per step: halo "
                  f"{h['halo_bytes'] / 1e6:.3f} MB sent, {h['halo_s'] * 1e3:.1f} host ms in "
                  f"halo.fetch the first step{later[0]}, gather_bands "
                  f"{h['gather_bytes'] / 1e6:.3f} MB, {h['gather_s'] * 1e3:.1f} host ms"
                  f"{later[1]}, keys' all-gathers {h['allgather_bytes'] / 1e6:.3f} MB, "
                  f"{h['allgather_s'] * 1e3:.1f} host ms{later[2]}, band all-reduces "
                  f"{h['allreduce_bytes'] / 1e6:.3f} MB, {h['allreduce_s'] * 1e3:.1f} host ms"
                  f"{later[3]} | K1, K2 and K3 launches on zero rows a step "
                  f"{r['empty_bn']} of {want['bn_stats']} | step p50 {p50} of {steps - 1} "
                  f"after the first"
                  + (" (a correctness run: Gloo stages every halo through host memory)"
                     if r["backend"] == "gloo" else "")
                  + (" (contended: the 2-rank runs run two at once on the card and the "
                     "host, `_lanes`; not comparable with a run alone, which "
                     "band_step_time.py times)" if ranks < world else "")
                  + f" | peak device memory of the first step {r['peak']:.1f} MiB a rank"
                  + (f" (one process over the global batch: {extra['peak']:.1f} MiB)"
                     if extra is not None else "")
                  + f" | wall of the {world} ranks' runs {wall:.1f} s | card: {card}", flush=True)
            results[run].append(r)
    return results


def _one_process_extras(arch, device="cuda"):
    """The one-process step's (_dp_build's, over the global batch) peak
    device memory in MiB and its dropouts' masks (`_record_masks`): what
    spatial_ranks prints beside a band run's peak and holds its masks to."""
    x, y = _dp_batch()
    m, step = _dp_build(device=device, arch=arch)
    drawn = _record_masks(m)
    _, peak = _peak_step(m, step, (torch.from_numpy(x).to(device),
                                   torch.from_numpy(y).to(device)), torch.device(device))
    del m, step
    gc.collect()
    return {"peak": peak, "masks": {name: d[0] for name, d in drawn.items()}}


def _hold_masks(run, rank, got, want, card, band=(0, 1)):
    """A band rank's dropout masks of its first step against the one-process
    step's over the global batch (a data=1 run over 'x': every rank holds
    every row; `band` = (this rank's 'x' index, the band count)): the same
    dropouts, each mask equal to the one-process mask cut to the band's
    rows of its map (a channel dropout's mask has no rows: the same on every
    band), so the bands drop what one process drops."""
    from pytorch_nested_unet_tpu_torch.parallel.halo import cut

    if sorted(got) != sorted(want):
        raise AssertionError(f"spatial {run} rank {rank}: dropouts {sorted(got)}, the "
                             f"one-process step's {sorted(want)}")
    for name, mask in got.items():
        whole = want[name]
        c = cut(whole.shape[1], band[1])
        mine = whole if whole.shape[1] == 1 else whole[:, c[band[0]]:c[band[0] + 1]]
        if mask.shape != mine.shape or not torch.equal(mask, mine):
            raise AssertionError(f"spatial {run} rank {rank}: {name}'s mask differs from the "
                                 f"one-process step's cut to the band")
    if got:
        kept = {n: f"{int(m.sum())}/{m.numel()}" for n, m in got.items()}
        print(f"spatial {run} rank {rank}: dropout masks equal to the one-process step's cut "
              f"to the band (kept {kept}) | card: {card}", flush=True)


def _hold_remat_band(run, rank, r, card):
    """A remat run's band step against the band step without remat on the
    same rank, both under deterministic algorithms (remat_phase's gates:
    the loss equal, every gradient within 1e-4 relative L2, the running
    statistics equal), and the peak device memory of each step; under
    "policy" the peak must be below the step's without remat."""
    remat = SPATIAL_RUNS[run][5]
    none = r["none_result"]
    rel = _dp_rel(r["result"], none)
    worst = max(rel, key=rel.get)
    same_stats = all(torch.equal(b, none[2][n]) for n, b in r["result"][2].items())
    print(f"spatial {run} rank {rank}: against the band step without remat on the same ranks "
          f"(both under deterministic algorithms): loss {r['result'][0]:.7f} vs {none[0]:.7f}, "
          f"gradients: worst {worst} at {rel[worst]:.3g} relative L2 (gate 1e-4), median "
          f"{np.median(list(rel.values())):.3g}; running stats equal: {same_stats} | peak "
          f"device memory of the step {r['peak']:.1f} MiB under --remat {remat}, "
          f"{r['none_peak']:.1f} MiB without | card: {card}", flush=True)
    if r["result"][0] != none[0] or rel[worst] > 1e-4 or not same_stats:
        raise AssertionError(f"spatial {run} rank {rank}: the remat step differs from the band "
                             f"step without remat")
    if remat == "policy" and not r["peak"] < r["none_peak"]:
        raise AssertionError(f"spatial {run} rank {rank}: --remat policy's peak {r['peak']:.1f} "
                             f"MiB is not below the step's without remat ({r['none_peak']:.1f})")


# The band runs whose step is also taken again under deterministic algorithms
# with every ReLU mask and max-pool choice recorded and held against the
# one-process step's (flip_reading; UNetRNN's shows the pool window behind
# BAND_GATED)
FLIP_READINGS = {"NestedUNet data=2,x=2", "UNetRNN x=2"}


class ActivationRecord:
    """One train step's discrete choices: each FusedBatchNormReLU's
    ReLU mask (its output > 0, i.e. its pre-activation's sign) and each 2x2
    max-pool's choice (the argmax of every window, and whether the window's
    largest value is positive: a window of zeros routes no gradient). With
    `reference`, also each BN's |pre-activation| (from its input and the
    batch's moments, in float64) and its output's gradient, and each pool
    window's margin (its largest value less the next). The pools are the
    model's, in their order (`max_pool2x2` wrapped in the model modules
    that call it while recording)."""

    def __init__(self, m, reference=False):
        from pytorch_nested_unet_tpu_torch.models import nested_unet, rdc, unet
        from pytorch_nested_unet_tpu_torch.ops.fused_bn import FusedBatchNormReLU

        self.reference, self.masks, self.pools = reference, {}, []
        self.z, self.dy, self.margins = {}, {}, []
        self.handles = [mod.register_forward_hook(functools.partial(self._bn, name))
                        for name, mod in m.named_modules()
                        if isinstance(mod, FusedBatchNormReLU)]
        self._modules = (nested_unet, rdc, unet)
        self._pool = nested_unet.max_pool2x2
        for module in self._modules:
            module.max_pool2x2 = self._pool_hook

    def _bn(self, name, mod, args, out):
        self.masks[name] = out.detach() > 0
        if not self.reference:
            return
        x = args[0].detach().double().reshape(-1, args[0].shape[-1])
        mean, var = x.mean(0), x.var(0, unbiased=False)
        z = ((x - mean) / torch.sqrt(var + mod.eps) * mod.weight.detach().double()
             + mod.bias.detach().double())
        self.z[name] = z.abs().float().reshape(out.shape)
        out.register_hook(lambda g: self.dy.__setitem__(name, g.detach().float()))

    def _pool_hook(self, x, bands=None):
        if bands is not None:  # the window of the band's output rows (Bands.window)
            x = bands.window(x, (2, 2), (2, 2), (0, 0), (1, 1))
        b, h, w, c = x.shape
        win = x.detach().reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        top = win.reshape(b, h // 2, w // 2, c, 4).topk(2, -1).values
        self.pools.append((win.reshape(b, h // 2, w // 2, c, 4).argmax(-1).to(torch.uint8),
                           top[..., 0] > 0))
        if self.reference:
            self.margins.append((top[..., 0] - top[..., 1]).float())
        return self._pool(x)

    def band(self):
        """What a rank sends back: its masks and pool choices, on the host."""
        return {"masks": {k: v.cpu() for k, v in self.masks.items()},
                "pools": [(a.cpu(), p.cpu()) for a, p in self.pools]}

    def close(self):
        for h in self.handles:
            h.remove()
        for module in self._modules:
            module.max_pool2x2 = self._pool


def flip_reading(run, outs, card, device="cuda"):
    """The flip reading (F3's, ROADMAP.md queue 3): the one-process step
    (global batch 16) under deterministic algorithms with an
    ActivationRecord, against each rank's band step under them (the
    "flips" entry of its output): for every BN, the ReLU-mask entries of
    each rank's band that differ from the one-process
    step's cut to the same rows and band, the smallest |pre-activation|
    among them, and how far those flips alone move the BN's own bias
    gradient (dbeta = sum of dy over the mask, so a flip adds or drops the
    one-process step's dy there; relative L2 as _dp_rel takes it) beside
    how far the band step's bias gradient is off; for every pool, the
    windows with a positive maximum whose choice differs and their
    smallest margin ('x' bands: the runs of FLIP_READINGS split no other
    axis). Prints a line per layer that flips, for NestedUNet where conv3_1
    sits, and then how far the band step is from the one-process step with
    the band's choices forced on it (`ForcedChoices`). `device`: where the
    one-process step runs."""
    from pytorch_nested_unet_tpu_torch.parallel import parse_mesh_spec

    arch, spec = SPATIAL_RUNS[run][:2]
    names, sizes = parse_mesh_spec(spec)
    shape = dict(zip(names, sizes))
    x, y = _dp_batch()
    with deterministic():
        m, step = _dp_build(device=device, arch=arch)
        record = ActivationRecord(m, reference=True)
        try:
            ref = _dp_result(m, step(torch.from_numpy(x).to(device),
                                     torch.from_numpy(y).to(device),
                                     torch.Generator(device).manual_seed(0)))
        finally:
            record.close()
    del m, step
    per, nx = BATCH // shape.get("data", 1), shape.get("x", 1)
    band_rel = _dp_rel(outs[0]["flips"]["result"], ref)
    flips, zmin, delta, forced = {}, {}, {}, {}
    for rank, r in enumerate(outs):
        coords = dict(zip(names, np.unravel_index(rank, [shape[a] for a in names])))
        rows = slice(int(coords.get("data", 0)) * per, (int(coords.get("data", 0)) + 1) * per)
        i = int(coords.get("x", 0))

        def cut(t):
            hb = t.shape[1] // nx
            return t[rows, i * hb:(i + 1) * hb]

        def where(diff, full):
            """The (b, h, w, c) indices of `diff`'s entries in the whole batch."""
            idx = diff.nonzero()
            idx[:, 0] += rows.start
            idx[:, 1] += i * (full.shape[1] // nx)
            return idx

        for name, mask in r["flips"]["masks"].items():
            want = cut(record.masks[name])
            diff = mask.to(device) != want
            forced.setdefault(name, []).append(where(diff, record.masks[name]))
            flips[name] = flips.get(name, 0) + int(diff.sum())
            if diff.any():
                zmin[name] = min(zmin.get(name, float("inf")),
                                 float(cut(record.z[name])[diff].min()))
            step_dy = (mask.to(device).float() - want.float()) * cut(record.dy[name])
            delta[name] = delta.get(name, 0) + step_dy.sum((0, 1, 2)).double()
        for level, ((arg, pos), (ref_arg, ref_pos)) in enumerate(zip(r["flips"]["pools"],
                                                                      record.pools)):
            diff = (arg.to(device) != cut(ref_arg)) & (pos.to(device) | cut(ref_pos))
            key = f"pool{level}"
            forced.setdefault(key, []).append((where(diff, ref_arg), arg.to(device)[diff]))
            flips[key] = flips.get(key, 0) + int(diff.sum())
            if diff.any():
                zmin[key] = min(zmin.get(key, float("inf")),
                                float(cut(record.margins[level])[diff].min()))
    grads = ref[1]
    for name in list(record.masks) + [f"pool{k}" for k in range(len(record.pools))]:
        if not flips.get(name) and not name.startswith("conv3_1"):
            continue
        line = (f"flip reading, spatial {run} against the one-process step, both under "
                f"deterministic algorithms: {name}: {flips.get(name, 0)} flipped over the "
                f"{len(outs)} ranks")
        if flips.get(name):
            line += f", smallest |{'margin' if name.startswith('pool') else 'pre-activation'}| " \
                    f"{zmin[name]:.3g}"
        if name in delta:
            bias = f"{name}.bias"
            den = max(grads[bias].norm(), grads[f"{name}.weight"].norm())
            line += (f"; these flips alone move {bias}'s gradient by "
                     f"{float(delta[name].norm().cpu() / den):.3g} relative L2, the band step "
                     f"is off by {band_rel[bias]:.3g}")
        print(line + f" | card: {card}", flush=True)
    worst = max(band_rel, key=band_rel.get)
    where = ""
    if "conv3_1.bn1" in record.masks:
        order = list(record.masks).index("conv3_1.bn1") + 1
        where = (f"; conv3_1 is the decoder node at level 3 ({SIZE >> 3}x{SIZE >> 3}, bands of "
                 f"{(SIZE >> 3) // nx} rows), fed by conv3_0 and the upsampled conv4_0, its bn1 "
                 f"and bn2 the BNs {order} and {order + 1} of {len(record.masks)} in forward "
                 f"order; conv3_1.bn1.bias off by {band_rel['conv3_1.bn1.bias']:.3g}")
    print(f"flip reading, spatial {run}: {sum(v for k, v in flips.items() if not k.startswith('pool'))}"
          f" ReLU-mask and {sum(v for k, v in flips.items() if k.startswith('pool'))} pool "
          f"flips in all; the band step under deterministic algorithms against the one-process "
          f"step under them: worst {worst} at {band_rel[worst]:.3g}{where} | card: {card}",
          flush=True)
    if not any(flips.values()):
        return
    # the one-process step again with the band's choices forced on it: each
    # flipped pre-activation moved across 0, each flipped pool window's
    # band choice raised above its maximum, by their own size (>= 1e-6)
    with deterministic():
        m, step = _dp_build(device=device, arch=arch)
        force = ForcedChoices(m, {k: torch.cat(v) for k, v in forced.items()
                                  if not k.startswith("pool")},
                              {int(k[4:]): (torch.cat([a for a, _ in v]),
                                            torch.cat([b for _, b in v]))
                               for k, v in forced.items() if k.startswith("pool")})
        try:
            moved = _dp_result(m, step(torch.from_numpy(x).to(device),
                                       torch.from_numpy(y).to(device),
                                       torch.Generator(device).manual_seed(0)))
        finally:
            force.close()
    del m, step
    forced_rel = _dp_rel(outs[0]["flips"]["result"], moved)
    top = max(forced_rel, key=forced_rel.get)
    named = [n for n in (worst, "conv3_1.bn1.bias") if n in forced_rel]
    print(f"flip reading, spatial {run}: the one-process step with the band step's "
          f"{sum(flips.values())} choices forced on it (each moved across its edge by its own "
          f"size) against the band step, both under deterministic algorithms: worst {top} at "
          f"{forced_rel[top]:.3g}, " + ", ".join(
              f"{n} at {forced_rel[n]:.3g} (unforced {band_rel[n]:.3g})" for n in named)
          + f", median {np.median(list(forced_rel.values())):.3g} (unforced "
          f"{np.median(list(band_rel.values())):.3g}) | card: {card}", flush=True)


class ForcedChoices:
    """The discrete choices of a one-process NestedUNet or UNetRNN train step
    set as a band step made them (flip_reading's evidence): `bn` {BN name:
    (k, 4) (b, h, w, c) indices}, each pre-activation there moved across 0
    (the BN's input moved by -(z + sign(z) * max(|z|, 1e-6)) / (gamma * inv),
    with z, mean and inv from the batch in float64: one entry of thousands,
    so the batch's moments move by rounding); `pools` {pool index: ((k, 4)
    indices of the pooled map, the band's choice 0-3 in each window)}, that
    element raised above the window's maximum by the window's margin (at
    least 1e-6). The changes are constants added to the activations, so the
    gradients flow as before."""

    def __init__(self, m, bn, pools):
        from pytorch_nested_unet_tpu_torch.models import nested_unet, rdc, unet
        from pytorch_nested_unet_tpu_torch.ops.fused_bn import FusedBatchNormReLU

        self.pools, self.calls = pools, 0
        self.handles = [mod.register_forward_pre_hook(functools.partial(self._bn, bn[name]))
                        for name, mod in m.named_modules()
                        if isinstance(mod, FusedBatchNormReLU) and name in bn and len(bn[name])]
        self._modules = (nested_unet, rdc, unet)
        self._pool = nested_unet.max_pool2x2
        for module in self._modules:
            module.max_pool2x2 = self._pool_hook

    @staticmethod
    def _bn(idx, mod, args):
        x = args[0]
        xd = x.detach().double().reshape(-1, x.shape[-1])
        mean, inv = xd.mean(0), torch.rsqrt(xd.var(0, unbiased=False) + mod.eps)
        b, h, w, c = idx.unbind(1)
        scale = inv[c] * mod.weight.detach().double()[c]
        z = (x.detach()[b, h, w, c].double() - mean[c]) * scale + mod.bias.detach().double()[c]
        delta = torch.zeros_like(x)
        delta[b, h, w, c] = (-(z + torch.sign(z) * z.abs().clamp_min(1e-6)) / scale).to(x.dtype)
        return (x + delta,)

    def _pool_hook(self, x, bands=None):
        if bands is not None:  # the window of the band's output rows (Bands.window)
            x = bands.window(x, (2, 2), (2, 2), (0, 0), (1, 1))
        level, self.calls = self.calls, self.calls + 1
        if level in self.pools and len(self.pools[level][0]):
            (b, h, w, c), choice = self.pools[level][0].unbind(1), self.pools[level][1].long()
            hi, wi = 2 * h + choice // 2, 2 * w + choice % 2
            win = x.detach().reshape(x.shape[0], x.shape[1] // 2, 2, x.shape[2] // 2, 2,
                                     x.shape[3])[b, h, :, w, :, c].reshape(-1, 4)
            top = win.topk(2, -1).values
            raised = top[:, 0] + (top[:, 0] - top[:, 1]).clamp_min(1e-6)
            delta = torch.zeros_like(x)
            delta[b, hi, wi, c] = raised - x.detach()[b, hi, wi, c]
            x = x + delta
        return self._pool(x)

    def close(self):
        for h in self.handles:
            h.remove()
        for module in self._modules:
            module.max_pool2x2 = self._pool


def _print_band_readings(run, r, plain, gate, movement, readings, card):
    """A BAND_READINGS run's evidence (rank 0: every rank holds the same
    averaged gradients): a gradient's deviation off the one-process step
    beside its gate, its one-process readings, the band step's own movement
    under the same weight changes and (FLIP_READINGS) the unperturbed step
    again on a fresh model (each against the first band step, then against
    the one-process step), for the gradient nearest its gate and the two
    that the band step moves most; then how many gradients the band step
    moves more than the one-process step moves under the same changes."""
    rel = _dp_rel(r["result"], plain)
    weights = {k: b for k, b in r["band_readings"].items() if k.startswith("weights")}
    later = {k: _dp_rel(res, plain) for k, res in r["band_steps"].items()}
    band_max = {n: max(b[n] for b in weights.values()) for n in rel}
    # the one-process step's movement under the same weight changes (a
    # gradient that neither step moves, a BN-fed bias's, has no ratio)
    same = {n: max(readings[k][n] for k in weights) for n in rel}
    ratio = {n: band_max[n] / same[n] for n in rel if same[n] > 0}
    names = [max(rel, key=lambda n: rel[n] / gate[n])]
    names += [n for n in sorted(band_max, key=band_max.get, reverse=True) if n not in names][:2]
    for n in names:
        print(f"band readings, spatial {run}: {n} off the one-process step by {rel[n]:.3g} "
              f"(gate {gate[n]:.3g}); one-process readings "
              f"({_readings_of(readings, n)}); the band step's own movement against its first "
              f"step (" + ", ".join(f"{k} {b[n]:.3g}" for k, b in r["band_readings"].items())
              + f"), largest under a weight change {band_max[n]:.3g} = "
              f"{ratio.get(n, float('nan')):.2f}x the one-process step's ({same[n]:.3g}); "
              f"those later band steps off the one-process step ("
              + ", ".join(f"{k} {v[n]:.3g}" for k, v in later.items())
              + f") | card: {card}", flush=True)
    again = (f", the same step again on a fresh model "
             f"{max(later['again'][n] / gate[n] for n in rel):.3g}" if "again" in later else "")
    print(f"band readings, spatial {run}: the band step moves "
          f"{sum(v > 1 for v in ratio.values())} of {len(ratio)} gradients more than the "
          f"one-process step moves under the same weight changes (median ratio "
          f"{np.median(list(ratio.values())):.3g}, max {max(ratio.values()):.3g}); against the "
          f"one-process step the first band step reaches {max(rel[n] / gate[n] for n in rel):.3g} "
          f"of a gate{again} | card: {card}", flush=True)


def spatial_cli(world, spec, card, gloo):
    """`train.main --mesh <spec>` over `world` processes on the narrow UNet
    (dp_cli's folder and arguments) for 1 epoch, then `--mesh data=1` in one
    process: rank 0 alone writes the capsule and the two log.csv's agree
    within the JAX CLI test's bounds (loss 3e-3, IoU 3e-2:
    tests/test_train_cli_round2.py). `gloo`: every rank on the first card
    over Gloo; else rank r on cuda:r over NCCL."""
    args = _dp_cli_set() + ["--epochs", "1"]
    root = os.path.join(DP_CLI_ROOT, "spatial")
    outs_of = lambda r: os.path.join(root, f"out{r}")  # noqa: E731
    dev_of = (lambda r: "cuda:0" if gloo else f"cuda:{r}")  # noqa: E731
    t0 = time.perf_counter()
    outs = _dp_cli_launch(world, args + ["--mesh", spec], outs_of, dev_of, gloo)
    wall = time.perf_counter() - t0
    if "(spatial H/W partitioning on)" not in outs[0]:
        raise AssertionError(f"spatial cli: rank 0 printed no spatial mesh line:\n"
                             f"{outs[0][-2000:]}")
    run0 = _rank0_capsule(world, outs_of, "spatial cli")
    from pytorch_nested_unet_tpu_torch import train

    # the one-process run in this process: no second start-up
    train.main(args + ["--mesh", "data=1", "--output_dir", os.path.join(root, "one"),
                       "--device", "cuda:0"])
    a, b = _read_log(run0), _read_log(os.path.join(root, "one", "run"))
    worst = {}
    for col, rtol, atol in (("loss", 3e-3, 3e-3), ("val_loss", 3e-3, 3e-3), ("iou", 0, 3e-2),
                            ("val_iou", 0, 3e-2)):
        x, y = (np.array([float(r[col]) for r in t]) for t in (a, b))
        if len(x) != 1 or len(y) != 1 or not np.allclose(x, y, rtol=rtol, atol=atol):
            raise AssertionError(f"spatial cli: {col} under --mesh {spec} {x} vs one process {y}")
        worst[col] = float(np.abs(x - y).max())
    print(f"spatial cli: train.main --mesh {spec} over {world} processes "
          f"({'Gloo, one card' if gloo else 'NCCL, a card each'}), narrow UNet 32x32 batch 8 "
          f"fp32, 1 epoch in {wall:.1f} s of wall (rank 0 alone wrote the capsule); log.csv "
          f"against --mesh data=1 in one process, max abs diff "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" | card: {card}", flush=True)


def spatial_phase(bn, df, card, reference):
    """Spatial partitioning on the one card over Gloo: UNet under x=2,y=2 (4
    ranks, 1 step, the corners), NestedUNet wDS under data=1,x=2 (2 of the
    same ranks, 2 steps; `reference`: its one-process step from
    _dp_reference), then on two ranks at a time (ranks 0-1 and 2-3 take
    the 2-rank runs in turn, `_lanes`) AttU_Net and UNetRNN (GRU) under x=2, NestedUNet wDS under x=2 with --remat full and policy, and
    VGG16RNN, UNetRNNAttention, CA-Net (dropout on), ResNet50RNN, DoubleUnet
    and UNetRNNPSP under x=2 (a checked step and a timed one
    each), each rank against the one-process step
    (`spatial_ranks`; the remat runs also against the band step without
    remat; the last six with their peak memory beside the one-process
    step's and CA-Net's masks against its); NestedUNet wDS under x=4
    on the 4 ranks, and UNetRM7, ResNet50FCN and DeepLab (dropout on, its
    masks against the one-process step's) under x=2, on bands that the maps'
    rows do not divide evenly (DoubleUnet at 96x96 too); then `train --mesh
    x=2` over 2 processes (`spatial_cli`). Returns {"fp32": launches} of
    every rank's steps."""
    t0 = time.perf_counter()
    for dtype in DTYPE_NAME:
        k4_empty_band(df, torch.device("cuda"), dtype)
    print("K4 on an empty band (fp32, bf16): an empty output, 0 launches, the backward's "
          "weight and bias gradients the plain version's (zeros)", flush=True)
    totals = {**bn_want(0), "multipart_conv3x3": 0}
    # the 4-rank runs first; then the 2-rank runs, two at a time (`_lanes`)
    runs = ["UNet x=2,y=2", "NestedUNet x=4", "NestedUNet x=2", "AttU_Net x=2", "UNetRNN x=2",
            "NestedUNet x=2 remat full", "NestedUNet x=2 remat policy", *PEAK_RUNS]

    def prepare():
        """The one-process references (their run-to-run spread unused
        here), extras and floors, computed while the band runs run."""
        references = {run: reference if SPATIAL_RUNS[run][0] == "NestedUNet" else
                      _dp_reference(arch=SPATIAL_RUNS[run][0],
                                    with_floor=run in STEP_FLOOR_RUNS, spread=False)
                      for run in runs}
        floors = {run: references[run][4] for run in STEP_FLOOR_RUNS}
        extras = {run: _one_process_extras(SPATIAL_RUNS[run][0]) for run in PEAK_RUNS}
        return {run: ref[:4] for run, ref in references.items()}, extras, floors

    for outs in spatial_ranks(runs, "gloo", None, card, prepare=prepare).values():
        for r in outs:
            for k, v in r["total"].items():
                totals[k] += v
    spatial_cli(2, "x=2", card, gloo=True)
    print(f"spatial phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"fp32": totals}


# The 'model' mesh axis: (--mesh spec, the spec without 'model'). Each run's
# step (NestedUNet wDS, full width, 96x96, global batch 16) is held to the
# step without 'model' on the first two ranks of the same workers: the
# gather is a copy and the SGD update elementwise, so the numbers are that
# step's wherever the step itself is deterministic.
MODEL_RUNS = {
    "NestedUNet data=2,model=2": ("data=2,model=2", "data=2"),
    "NestedUNet data=1,x=2,model=2": ("data=1,x=2,model=2", "data=1,x=2"),
}
MODEL_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke",
                          "model")
# Parameters plus SGD momentum of NestedUNet wDS in fp32 on one rank
# (9,163,428 parameters, 9,105,408 of them in the 24 weights the JAX rule
# shards): arithmetic, not measured
MODEL_STATE_MB = {1: 73.31, 2: 36.89, 4: 18.67}


def _model_run(mesh, dev, bn, df):
    """One fp32 step (augment none) of _dp_build's model under `mesh` on this
    rank's rows: its result (loss, the averaged gradients, read before the
    'model' axis frees them, running statistics), every parameter after the
    update (gathered), launches, the rank's bytes of parameters and
    optimizer state between steps, what the 'model' axis shards, and the
    step's peak device memory."""
    from pytorch_nested_unet_tpu_torch.parallel import batch_sharding
    from pytorch_nested_unet_tpu_torch.parallel.mesh import full_weights, tensor_parallel_of
    from pytorch_nested_unet_tpu_torch.training.optim import state_bytes

    x, y = _dp_batch()
    rows = batch_sharding(mesh, BATCH)
    batch = (torch.from_numpy(x[rows]).to(dev), torch.from_numpy(y[rows]).to(dev))
    m, step = _dp_build(mesh, device=dev)
    opt, kept = step.optimizer, {}
    update = opt.step

    def update_keeping():
        update()
        kept.update({n: p.grad.to("cpu", torch.float32, copy=True)
                     for n, p in m.named_parameters()})

    opt.step = update_keeping
    reset_counts(bn, df)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = step(*batch, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    tp = tensor_parallel_of(m)
    whole = sum(p.numel() for p in m.parameters())
    sharded = 0 if tp is None else sum(p.numel() for p in tp.shards)
    out = {"result": (float(metrics["loss"]), kept,
                      {n: b.to("cpu", copy=True) for n, b in m.named_buffers()}),
           "launches": launch_counts(bn, df), "bytes": state_bytes(m, opt), "peak": peak,
           "n_sharded": 0 if tp is None else len(tp.shards),
           # parameters and momentum, fp32: the replicated ones whole, the sharded 1/M
           "want_bytes": 8 * (whole - sharded + sharded // mesh.shape.get("model", 1))}
    with full_weights(m):
        out["params"] = {n: p.detach().to("cpu", copy=True) for n, p in m.named_parameters()}
    del m, step
    return out


def _model_peer_state(mesh, dev, steps=3):
    """`steps` fp32 train steps (augment full) and an eval step of
    _dp_build's model under `mesh`: each step's metrics and a digest of what
    this rank holds that its 'model' peers must hold bitwise alike (every
    parameter gathered, the running statistics, the momentum whole)."""
    import hashlib

    from pytorch_nested_unet_tpu_torch.parallel import batch_sharding
    from pytorch_nested_unet_tpu_torch.parallel.mesh import full_weights
    from pytorch_nested_unet_tpu_torch.training.loop import make_eval_step

    x, y = _dp_batch()
    rows = batch_sharding(mesh, BATCH)
    batch = (torch.from_numpy(x[rows]).to(dev), torch.from_numpy(y[rows]).to(dev))
    m, step = _dp_build(mesh, augment="full", device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    metrics = [step(*batch, gen) for _ in range(steps)]
    metrics.append(make_eval_step(m, "BCEDiceLoss", True, mesh)(
        *batch, torch.ones(len(batch[0]), device=dev)))
    momentum = [v for st in step.optimizer.state_dict()["inner"]["state"].values()
                for v in st.values() if torch.is_tensor(v)]
    digest = hashlib.sha256()
    with full_weights(m):
        for t in (*m.parameters(), *m.buffers(), *momentum):
            digest.update(t.detach().to("cpu", copy=True).numpy().tobytes())
    del m, step
    return {"digest": digest.hexdigest(),
            "metrics": [[float(v) for v in d.values()] for d in metrics]}


def model_worker(rank, world, port, out_dir, backend, device, runs, steps):
    """One rank of the 'model' axis runs (MODEL_RUNS' entries named in
    `runs`, ';'-joined): the run's step on every rank, its 3 steps and an
    eval step (`_model_peer_state`), then the step without 'model' twice on
    ranks 0-1 (a group of the same workers; twice to read whether it is
    deterministic; the single steps under deterministic algorithms, the
    peers' steps without), then the bf16 step's p50 over `steps` (augment
    full, global batch 16) with and without 'model'. Written to
    <run>_rank<rank>.pt."""
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
    from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn
    from pytorch_nested_unet_tpu_torch.parallel import (batch_sharding, initialize_distributed,
                                                        make_mesh, parse_mesh_spec)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    initialize_distributed(backend=backend, device=dev, world_size=world, rank=rank,
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        pair = dist.new_group([0, 1])  # every rank creates every group
        for run in runs.split(";"):
            out, meshes = {"backend": dist.get_backend()}, {}
            for kind, spec in zip(("tp", "ref"), MODEL_RUNS[run]):
                if kind == "tp" or rank < 2:
                    names, sizes = parse_mesh_spec(spec)
                    meshes[kind] = make_mesh(sizes, names, group=None if kind == "tp" else pair)
            with deterministic():
                out["tp"] = _model_run(meshes["tp"], dev, bn, df)
            out["peers"] = _model_peer_state(meshes["tp"], dev)
            if rank < 2:
                with deterministic():
                    out["ref"] = _model_run(meshes["ref"], dev, bn, df)
                    out["ref2"] = _model_run(meshes["ref"], dev, bn, df)
            x, y = _dp_batch()
            for kind, mesh in meshes.items():
                rows = batch_sharding(mesh, BATCH)
                m, step = _dp_build(mesh, torch.bfloat16, "full", device=dev)
                reset_counts(bn, df)
                out[f"{kind}_bf16"] = (*_p50_p95(step, (torch.from_numpy(x[rows]).to(dev),
                                                        torch.from_numpy(y[rows]).to(dev)),
                                                 torch.Generator(dev).manual_seed(0), steps),
                                       launch_counts(bn, df))
                del m, step
            torch.save(out, os.path.join(out_dir, f"{_spatial_slug(run)}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _bitwise(a, b):
    """(whether two _model_run outputs are bitwise equal in loss, running
    statistics, gradients and updated parameters, the largest difference)."""
    pairs = [(torch.tensor(a["result"][0]), torch.tensor(b["result"][0]))]
    for i in (1, 2):
        pairs += [(v, b["result"][i][n]) for n, v in a["result"][i].items()]
    pairs += [(v, b["params"][n]) for n, v in a["params"].items()]
    diff = max(float((x.double() - y.double()).abs().max()) for x, y in pairs)
    return all(torch.equal(x, y) for x, y in pairs), diff


def _model_peers(run, spec, outs, card):
    """Raise unless the ranks that differ only in their 'model' coordinate
    hold bitwise the same state after _model_peer_state's steps and read the
    same metrics; print it, and whether the other ranks do too."""
    from pytorch_nested_unet_tpu_torch.parallel import parse_mesh_spec

    names, sizes = parse_mesh_spec(spec)
    groups = {}
    for rank in range(len(outs)):
        coords = dict(zip(names, np.unravel_index(rank, sizes)))
        groups.setdefault(tuple(int(v) for a, v in coords.items() if a != "model"),
                          []).append(rank)
    for ranks in groups.values():
        first = outs[ranks[0]]["peers"]
        for r in ranks[1:]:
            if outs[r]["peers"] != first:
                raise AssertionError(f"model {run}: 'model' peers {ranks[0]} and {r} differ after "
                                     f"3 steps and an eval step (metrics {first['metrics']} vs "
                                     f"{outs[r]['peers']['metrics']})")
    alike = all(o["peers"] == outs[0]["peers"] for o in outs)
    print(f"model {run} peers: after 3 fp32 steps (augment full) and an eval step every group "
          f"of 'model' peers ({sorted(groups.values())}) holds bitwise the same parameters "
          f"(gathered), running statistics and momentum, and read the same train and eval "
          f"metrics; the groups {'hold the same too' if alike else 'differ from each other'} "
          f"| card: {card}", flush=True)


def model_ranks(runs, backend, reference, card, steps=10):
    """Run MODEL_RUNS' `runs` in one set of 4 model_worker processes (over
    Gloo all on the first card, over NCCL rank r on cuda:r) and check each:
    K1 (sums-only) / bn_finish / K2 / K3 / K4 launches 30/30/30/30/10 per
    rank and step; the 'model' peers bitwise alike after 3 steps and an
    eval step (`_model_peers`); the step bitwise the step without 'model'
    on ranks 0-1 (where that step is not deterministic itself, i.e. its two
    runs differ, each rank is held to dp_ranks' gates against the
    one-process step instead); each rank's bytes of parameters and optimizer state between
    steps equal to the replicated ones less (M-1)/M of the sharded ones,
    printed beside the arithmetic MODEL_STATE_MB; the step's peak device
    memory; the bf16 p50 with and without 'model'. Returns {precision:
    launches} over every step the ranks drove."""
    from pytorch_nested_unet_tpu_torch.parallel import parse_mesh_spec

    plain, _, movement, readings = reference
    gate = {n: max(1e-4, GATE_FACTOR * v) for n, v in movement.items()}
    world = 4
    out_dir = os.path.join(MODEL_ROOT, backend)
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    port = _free_port()
    _, wall = _run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--model-worker", str(rank), str(world),
          str(port), out_dir, backend, f"cuda:{rank}" if backend == "nccl" else "cuda:0",
          ";".join(runs), str(steps)] for rank in range(world)], f"model ({backend})")
    totals = {"fp32": {**bn_want(0), "multipart_conv3x3": 0},
              "bf16": {**bn_want(0), "multipart_conv3x3": 0}}
    for run in runs:
        spec, ref_spec = MODEL_RUNS[run]
        outs = [torch.load(os.path.join(out_dir, f"{_spatial_slug(run)}_rank{rank}.pt"),
                           weights_only=False) for rank in range(world)]
        ref, ref2 = outs[0]["ref"], outs[0]["ref2"]
        deterministic, spread = _bitwise(ref, ref2)
        _model_peers(run, spec, outs, card)
        for rank, o in enumerate(outs):
            runs_here = [o["tp"]] + ([o["ref"], o["ref2"]] if rank < 2 else [])
            for r in runs_here:
                if r["launches"] != DP_LAUNCHES:
                    raise AssertionError(f"model {run} rank {rank}: launches {r['launches']} per "
                                         f"step, expected {DP_LAUNCHES}")
                for k, v in r["launches"].items():
                    totals["fp32"][k] += v
            for kind in ("tp", "ref"):
                for k, v in o.get(f"{kind}_bf16", (0, 0, {}))[2].items():
                    totals["bf16"][k] += v
            tp = o["tp"]
            if tp["bytes"] != tp["want_bytes"] or not tp["n_sharded"]:
                raise AssertionError(f"model {run} rank {rank}: {tp['bytes']} bytes of state "
                                     f"between steps ({tp['n_sharded']} weights sharded), "
                                     f"expected {tp['want_bytes']}")
            same, diff = _bitwise(tp, ref)
            if same:
                verdict = (f"bitwise the {ref_spec} step (loss, statistics, gradients, "
                           f"parameters; both under deterministic algorithms)")
            elif deterministic:
                raise AssertionError(f"model {run} rank {rank}: the step differs from the "
                                     f"deterministic {ref_spec} step by {diff:.3g}")
            else:
                loss_err, stats_err, worst, rel, tol = _dp_compare(
                    tp["result"], plain, 1e-5, 1e-5, gate, f"model {run} rank {rank}")
                verdict = (f"not bitwise the {ref_spec} step (largest difference {diff:.3g}), "
                           f"nor is the {ref_spec} step itself run to run ({spread:.3g}: the "
                           f"card's step is not deterministic), so held to dp_ranks' gates "
                           f"against the one-process step: loss off by {loss_err:.3g} (1e-5), "
                           f"statistics {stats_err:.3g} (1e-5), gradient nearest its gate "
                           f"{worst} at {rel:.3g} (gate {tol:.3g}; readings "
                           f"{_readings_of(readings, worst)})")
            m = dict(zip(*parse_mesh_spec(spec)))["model"]
            tp_bf16, ref_bf16 = o["tp_bf16"], outs[min(rank, 1)]["ref_bf16"]
            print(f"model {run} rank {rank} of {world} ({o['backend']}; NestedUNet wDS full "
                  f"width, global batch {BATCH} at {SIZE}x{SIZE}, fp32, SGD): {verdict} | "
                  f"launches per step {tp['launches']} | {tp['n_sharded']} weights sharded; "
                  f"parameters + optimizer state between steps {tp['bytes'] / 1e6:.2f} MB on this "
                  f"rank (arithmetic {MODEL_STATE_MB[m]:.2f} MB), {ref['bytes'] / 1e6:.2f} MB "
                  f"under {ref_spec} (arithmetic {MODEL_STATE_MB[1]:.2f} MB) | peak device "
                  f"memory of a step {tp['peak'] / 2**20:.1f} MiB ({ref['peak'] / 2**20:.1f} MiB "
                  f"under {ref_spec}) | bf16 step p50 {tp_bf16[0]:.3f} ms (p95 "
                  f"{tp_bf16[1]:.3f}) vs {ref_bf16[0]:.3f} ms (p95 {ref_bf16[1]:.3f}) under "
                  f"{ref_spec}, {steps} steps, augment full, global batch {BATCH} (a correctness "
                  f"run, timed only to be written down"
                  + ("; Gloo stages every collective through host memory and the ranks share "
                     "one card" if o["backend"] == "gloo" else "")
                  + f") | all ranks' wall {wall:.1f} s | card: {card}", flush=True)
    return totals


def model_cli(card, device="cuda"):
    """`train.main --mesh data=2,model=2 --checkpoint_backend orbax` over 4
    processes on this card (Gloo, `--gloo-train`; one output directory) for
    2 epochs on dp_cli's narrow folder (the narrow UNet's 3 kernels of at
    least 16,384 elements shard; every epoch's best-model save and resume
    state gather the slices on every rank), then `--resume` of that sharded
    directory under `--mesh data=4` to a 3rd epoch; against `--mesh data=1`
    in this process on the same schedule (2 epochs, then `--resume` from
    last.pth: --resume re-seeds the shuffle, so an uninterrupted run draws
    another third epoch), log.csv within dp_cli's bounds (loss rtol 2e-4 / atol
    2e-5, IoU atol 0.02). `device` "cpu" runs it all on the CPU."""
    import shutil

    from pytorch_nested_unet_tpu_torch import train

    args = _dp_cli_set()
    root = os.path.join(DP_CLI_ROOT, "model")
    shared = os.path.join(root, "shared")
    t0 = time.perf_counter()
    dev = "cuda:0" if device == "cuda" else "cpu"
    outs = _dp_cli_launch(4, args + ["--mesh", "data=2,model=2", "--epochs", "2",
                                     "--checkpoint_backend", "orbax"],
                          lambda r: shared, lambda r: dev, gloo=True)
    found = re.search(r"tensor parallel: (\d+) kernels sharded over 'model'=2", outs[0])
    run = os.path.join(shared, "run")
    if not found or not os.path.isfile(os.path.join(run, "orbax_last", ".metadata")) or \
            not os.path.isfile(os.path.join(run, "model.pth")) or \
            os.path.exists(os.path.join(run, "last.pth")):
        raise AssertionError(f"model cli: no tensor-parallel line, no best model or no sharded "
                             f"checkpoint ({os.listdir(run)}):\n{outs[0][-2000:]}")
    outs = _dp_cli_launch(4, args + ["--mesh", "data=4", "--epochs", "3", "--resume", "true",
                                     "--checkpoint_backend", "orbax"],
                          lambda r: shared, lambda r: dev, gloo=True)
    wall = time.perf_counter() - t0
    if not all("resumed from epoch 1" in out for out in outs):
        raise AssertionError("model cli: a rank did not resume from the sharded directory")
    one = os.path.join(root, "one")
    shutil.rmtree(one, ignore_errors=True)
    for extra in (["--epochs", "2"], ["--epochs", "3", "--resume", "true"]):
        train.main(args + ["--mesh", "data=1", "--output_dir", one, "--device", dev, *extra])
    a, b = _read_log(run), _read_log(os.path.join(one, "run"))
    worst = {}
    for col, rtol, atol in (("loss", 2e-4, 2e-5), ("val_loss", 2e-4, 2e-5), ("iou", 0, 0.02),
                            ("val_iou", 0, 0.02)):
        x, y = (np.array([float(r[col]) for r in t]) for t in (a, b))
        if len(x) != 3 or len(y) != 3 or not np.allclose(x, y, rtol=rtol, atol=atol):
            raise AssertionError(f"model cli: {col} {x} vs one process {y}")
        worst[col] = float(np.abs(x - y).max())
    print(f"model cli: train.main --mesh data=2,model=2 --checkpoint_backend orbax over 4 "
          f"processes (Gloo, {'one card' if device == 'cuda' else 'CPU'}; "
          f"{found.group(1)} kernels sharded), narrow UNet 32x32 "
          f"batch 8 fp32, 2 epochs, then --resume of its sharded directory under --mesh data=4 "
          f"to a 3rd (every rank resumed), {wall:.1f} s of wall; log.csv against --mesh data=1 "
          f"in one process on the same schedule, max abs diff "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" | card: {card}", flush=True)


def model_phase(bn, df, card, reference):
    """The 'model' mesh axis on this card over Gloo: NestedUNet wDS under
    data=2,model=2 (4 ranks; `model_ranks`), then the CLI with the sharded
    checkpoint restored under data=4 (`model_cli`). `reference`:
    _dp_reference(). Returns {precision: launches} of the ranks' steps."""
    t0 = time.perf_counter()
    totals = model_ranks(["NestedUNet data=2,model=2"], "gloo", reference, card, steps=5)
    model_cli(card)
    print(f"model phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


def gloo_train(argv):
    """`python3 chip_smoke.py --gloo-train ARGS`: train.main(ARGS) in a Gloo
    world joined from torchrun's variables first (train.main then keeps it),
    so several ranks can share one card."""
    from pytorch_nested_unet_tpu_torch import train
    from pytorch_nested_unet_tpu_torch.parallel import initialize_distributed

    initialize_distributed(backend="gloo")
    train.main(argv)
    return 0


def main():
    if sys.argv[1:2] == ["--gloo-train"]:  # a CLI rank; `--device` says where
        return gloo_train(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-worker"]:
        rank, world, port, out_dir, backend, device, steps = sys.argv[2:9]
        return dp_worker(int(rank), int(world), int(port), out_dir, backend, device, int(steps))
    if sys.argv[1:2] == ["--dp-cards"]:
        return dp_cards(int(sys.argv[2]))
    if sys.argv[1:2] == ["--spatial-worker"]:
        rank, world, port, out_dir, backend, device, run = sys.argv[2:9]
        return spatial_worker(int(rank), int(world), int(port), out_dir, backend, device, run)
    if sys.argv[1:2] == ["--model-worker"]:
        rank, world, port, out_dir, backend, device, runs, steps = sys.argv[2:10]
        return model_worker(int(rank), int(world), int(port), out_dir, backend, device, runs,
                            int(steps))
    from pytorch_nested_unet_tpu_torch.ops import _build
    from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
    from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"nvcc {nvcc}", flush=True)

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {sorted(reports)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if re.search(r"registers|spill", line):
                print(f"  ptxas {name}: {line.strip()}")
    hmma = hmma_counts(_build, "decoder_fusion")
    for fn, count in hmma.items():
        print(f"  SASS decoder_fusion: {count} HMMA in {fn}")
    bf16_fns = [fn for fn in hmma if "bf16_mma" in fn]
    if not bf16_fns or not all(hmma[fn] for fn in bf16_fns):
        raise AssertionError(f"K4 bf16: tensor-core kernels without HMMA in their SASS: {hmma}")
    # the fp32 path is held to 1e-4: no TF32 (tensor-core) product may enter it
    f32_fns = [fn for fn in hmma if "f32_fma" in fn]
    if not f32_fns or any(hmma[fn] for fn in f32_fns):
        raise AssertionError(f"K4 fp32: FP32-core kernels missing or with HMMA: {hmma}")

    walls = {}

    def timed(fn, *args, **kwargs):
        """fn(*args, **kwargs), its wall added to `walls` under its name and
        its first string argument other than the card's line (the arch)."""
        label = " ".join([fn.__name__] + [a for a in args if isinstance(a, str) and a != card][:1])
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            walls[label] = walls.get(label, 0.0) + time.perf_counter() - t0

    k4 = timed(kernel_phase, df, dev)
    timed(k4_host_us, df, dev)
    runs = [timed(path_phase, bn, df, card)]
    timed(bn_kernels_per_call, bn, dev)
    bnk = timed(bn_kernel_phase, bn, dev)
    finish = timed(bn_finish_phase, bn, dev)
    timed(k4_backward_phase, df, dev)
    runs.append(timed(train_phase, bn, df, card))
    runs.append(timed(trajectory_phase, bn, df, card))
    timed(cpu_step_phase)
    runs.append(timed(path_phase, bn, df, card, "UNetRNN", False, k4_per_batch=0))
    runs.append(timed(train_phase, bn, df, card, "UNetRNN", False, UNETRNN_BN_PER_STEP, 0))
    unetrnn_train = runs[-1]
    runs.append({"bf16": timed(arch_sweep_phase, bn, df, card)})
    timed(cpu_step_phase, "UNetRNN", False, zero_bn_fed_biases=True, conv_gap=True)
    runs.append(timed(path_phase, bn, df, card, "VGG16RNN", False, k4_per_batch=0))
    runs.append(timed(train_phase, bn, df, card, "VGG16RNN", False, VGG16RNN_BN_PER_STEP, 0))
    vgg_train = runs[-1]
    timed(cpu_step_phase, "VGG16RNN", False, zero_bn_fed_biases=True, conv_gap=True,
          card_convs=True)
    runs.append(timed(path_phase, bn, df, card, "ResNet50RNN", False, k4_per_batch=0))
    runs.append(timed(train_phase, bn, df, card, "ResNet50RNN", False, RESNET_RNN_BN_PER_STEP,
                      0))
    cli = timed(cli_phase, bn, df, card)
    runs.append({"bf16": cli})
    export = timed(export_phase, bn, df, card)
    runs.append(export)
    runs.append({"bf16": timed(pretrained_phase, bn, df, card)})
    runs.append(timed(path_phase, bn, df, card, "AttU_Net", False, k4_per_batch=0))
    runs.append(timed(train_phase, bn, df, card, "AttU_Net", False, 0, 0))
    runs.append({"bf16": timed(canet_cli_phase, bn, df, card)})
    runs.append(timed(path_phase, bn, df, card, "UNetRNNPSP", False, k4_per_batch=0))
    runs.append(timed(train_phase, bn, df, card, "UNetRNNPSP", False, UNETRNN_BN_PER_STEP, 0))
    timed(cpu_step_phase, "UNetRNNPSP", False, zero_bn_fed_biases=True, conv_gap=True,
          step_floor=True)
    runs.append({"fp32": timed(refine_phase, bn, df, card)})
    runs.append({"bf16": timed(refine_cli_phase, bn, df, card)})
    remat = timed(remat_phase, bn, df, card)
    runs.append({"fp32": {k: sum(c[k] for c in remat.values()) for k in launch_counts(bn, df)}})
    reference = timed(_dp_reference)
    dp = timed(dp_phase, bn, df, card, reference)
    runs.append(dp)
    spatial = timed(spatial_phase, bn, df, card, reference)
    runs.append(spatial)
    model = timed(model_phase, bn, df, card, reference)
    runs.append(model)
    timed(new_arch_counts)
    for arch, (_, _, gflop) in NEW_ARCHS.items():
        runs.append(timed(path_phase, bn, df, card, arch, False, k4_per_batch=0, gflop=gflop))
        runs.append(timed(train_phase, bn, df, card, arch, False, 0, 0))
    timed(cpu_step_phase, "DoubleUnet", False, zero_bn_fed_biases=True, conv_gap=True,
          plain_bn=True)
    timed(cpu_step_phase, "DeepLab", False, conv_gap=True, step_floor=True, plain_bn=True,
          no_dropout=True)
    runs.append({"bf16": timed(deeplab_cli_phase, bn, df, card)})
    print("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; total {time.perf_counter() - t_start:.1f}", flush=True)
    # launches of each kernel per dtype over every path driven above
    launches = {name: {k: sum(r[name][k] for r in runs if name in r)
                       for k in launch_counts(bn, df)} for name in DTYPE_NAME.values()}

    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for dtype, agg in k4.items():
        name = DTYPE_NAME[dtype]
        entry = {
            "name": f"multipart_conv3x3[{name}]", "route": "cuda",
            "source": "pytorch_nested_unet_tpu_torch/ops/csrc/decoder_fusion.cu",
            "replaces": "pytorch_nested_unet_tpu/ops/decoder_fusion.py:209",
            "launches": launches[name]["multipart_conv3x3"],
            **{key: agg[key] for key in timed}}
        if dtype == torch.float32:  # per fp32 step of remat_phase, in each --remat mode
            entry["remat_step"] = {mode: c["multipart_conv3x3"] for mode, c in remat.items()}
        entry["dp"] = {"launches": dp[name]["multipart_conv3x3"]}
        entry["spatial"] = {"launches": spatial.get(name, {}).get("multipart_conv3x3", 0)}
        entry["model"] = {"launches": model[name]["multipart_conv3x3"]}
        entry["artifact"] = {"launches": export["artifact"][name]}
        if dtype == torch.bfloat16:  # the CLI path runs bf16, at the 10 nodes' shapes
            entry["cli"] = {"launches": cli["multipart_conv3x3"],
                            **{key: agg[key] for key in timed},
                            "max_abs_err": agg["nodes_max_abs_err"]}
        kernels.append(entry)
    bn_names = {"K1": ("bn_stats", "pytorch_nested_unet_tpu/ops/fused_bn.py:145"),
                "K2": ("bn_bwd_reduce", "pytorch_nested_unet_tpu/ops/fused_bn.py:260"),
                "K3": ("bn_bwd_dx", "pytorch_nested_unet_tpu/ops/fused_bn.py:284")}
    for (k, dtype, path), agg in bnk.items():
        if path != "NestedUNet":
            continue
        fn, replaces = bn_names[k]
        entry = {
            "name": f"{fn}[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "pytorch_nested_unet_tpu_torch/ops/csrc/fused_bn.cu",
            "replaces": replaces, "launches": launches[DTYPE_NAME[dtype]][fn],
            **{key: agg[key] for key in timed},
            "unetrnn_step": {"launches": unetrnn_train[DTYPE_NAME[dtype]][fn],
                             **{key: bnk[(k, dtype, "UNetRNN")][key] for key in timed}},
            "vgg16rnn_step": {"launches": vgg_train[DTYPE_NAME[dtype]][fn],
                              **{key: bnk[(k, dtype, "VGG16RNN")][key] for key in timed}},
            "band_rows": {"max_abs_err": finish[dtype]["band_rows"][fn]}}
        if dtype == torch.float32:
            entry["remat_step"] = {mode: c[fn] for mode, c in remat.items()}
        if dtype == torch.bfloat16:  # the CLI path: NestedUNet's training-step shapes
            entry["cli"] = {"launches": cli[fn], **{key: agg[key] for key in timed}}
        entry["dp"] = {"launches": dp[DTYPE_NAME[dtype]][fn]}
        entry["spatial"] = {"launches": spatial.get(DTYPE_NAME[dtype], {}).get(fn, 0)}
        entry["model"] = {"launches": model[DTYPE_NAME[dtype]][fn]}
        kernels.append(entry)
    for dtype, agg in finish.items():
        name = DTYPE_NAME[dtype]
        kernels.append({
            "name": f"bn_finish[{name}]", "route": "cuda",
            "source": "pytorch_nested_unet_tpu_torch/ops/csrc/fused_bn.cu",
            "replaces": "pytorch_nested_unet_tpu/ops/fused_bn.py:145",
            "launches": launches[name]["bn_finish"], **{key: agg[key] for key in timed},
            "spatial": {"launches": spatial.get(name, {}).get("bn_finish", 0)},
            "model": {"launches": model[name]["bn_finish"]}})
    print("times: multipart_conv3x3 sums over the 10 decoder nodes of one batch-16 NestedUNet "
          "forward; bn_* sums over the 30 BN instances of one batch-16 NestedUNet training "
          "step (unetrnn_step: the 15 of a UNetRNN step, its launches those of UNetRNN's fit; "
          "vgg16rnn_step: the 18 of a VGG16RNN step, its launches those of VGG16RNN's fit; "
          "band_rows: K1 sums-only, K2 and K3 on the band runs' unequal and zero-row bands "
          "against their plain versions; "
          "cli: the image-folder CLIs' path, bf16, its launches those of cli_phase; "
          "artifact: K4 launches by the exported serving artifacts of export_phase (the "
          "registered operator in a torch.export program), read in the windows that ran an "
          "artifact alone (export --check's windows, which hold the live Predictor's calls "
          "too, are left out; they and export_phase's other launches, train --profile's "
          "epoch included, are in the totals); "
          "remat_step: launches in one fp32 NestedUNet train step under --remat none, full "
          "and policy; dp: launches in dp_phase's data-parallel steps, world 1 over NCCL and "
          "2 ranks over Gloo; spatial: launches in spatial_phase's steps on bands (NestedUNet "
          "wDS x=2, 2 ranks x 2 steps; UNet x=2,y=2, 4 ranks x 1 step; "
          "AttU_Net (none) and "
          "UNetRNN x=2, 2 ranks x 2 steps; NestedUNet wDS x=2 under --remat full and policy, "
          "2 ranks x 2 steps each (their steps without remat and the band readings' steps "
          "are not counted); VGG16RNN, UNetRNNAttention, CA-Net (none), ResNet50RNN, "
          "DoubleUnet (none) and UNetRNNPSP x=2, 2 ranks x 2 steps; NestedUNet wDS "
          "x=4, 4 ranks x 2 steps, UNetRM7, ResNet50FCN (none) and DeepLab (none) x=2, "
          "2 ranks x 2 steps; fp32); model: "
          "launches in model_phase's steps (NestedUNet wDS data=2,model=2 on 4 ranks and "
          "data=2 on 2 ranks, Gloo: one fp32 step each, twice without 'model'; bf16 the "
          "timed steps); "
          "bn_finish: its 30 instances of one batch-16 NestedUNet step, "
          "on float32 sums in either dtype, launched only by data-parallel steps); "
          "max_abs_err: over the path's own shapes; launches: over every path "
          "driven (NestedUNet, UNetRNN, VGG16RNN, ResNet50RNN, AttU_Net and UNetRNNPSP "
          "serving and training, NestedUNet's 15-epoch trajectory runs, the arch sweep, "
          "the CLIs, the serving artifacts and train --profile, --pretrained_backbone, "
          "train_canet, the Refiner (none), train_isic_ca with val/infer --refine, the "
          "--remat steps, the data-parallel, spatial and 'model' axis steps, DoubleUnet "
          "and DeepLab "
          "serving and training "
          "and the DeepLab CLIs (none)); card:")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
