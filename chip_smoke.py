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
   Python and of the bf16 launch plan alone;
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
12. a JSON line of the kernels (launches over every path above; `cli`: the
   CLI path's own; `remat_step`: per fp32 step in each --remat mode), then
   the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

import copy
import csv
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

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
    shape) in each dtype, and of the bf16 launch plan alone through its C
    query: the best of `rounds` rounds of `calls` calls each."""
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


def profile_batches(pred, request, precision):
    """Device time by kernel over a few served batches (torch.profiler), and
    the share of the window in which some kernel or copy ran."""
    from torch.profiler import ProfilerActivity, profile

    batches = 3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            pred.predict_u8(request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"profile {precision}: {batches} batches, wall {wall_ms / batches:.3f} ms/batch, "
          f"device busy {busy_ms / batches:.3f} ms/batch ({100 * busy_ms / wall_ms:.1f}% "
          f"of wall; profiler on)")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms / batches:8.3f} ms/batch {100 * ms / busy_ms:5.1f}%  "
              f"x{e.count // batches:<3d} {e.key[:110]}")


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
        want = {**{k: 0 for k in bn.LAUNCHES}, "multipart_conv3x3": k4_per_batch * len(requests)}
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
    checked elsewhere) is profiled again, up to 3 times."""
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
            for _ in range(3):
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


def synthetic_set(n, seed):
    """Seeded segmentation images: 1-3 rotated ellipses (the mask) over a
    textured background, red rectangles as distractors, pixel noise."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, SIZE, SIZE, 3), np.uint8)
    masks = np.zeros((n, SIZE, SIZE, 1), np.uint8)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    for i in range(n):
        img = rng.integers(40, 120, (SIZE, SIZE, 3)).astype(np.float32)
        m = np.zeros((SIZE, SIZE), bool)
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.integers(SIZE // 6, SIZE - SIZE // 6, 2)
            ry, rx = rng.integers(SIZE // 12, SIZE // 5, 2)
            ang = rng.uniform(0, np.pi)
            u = (yy - cy) * np.cos(ang) + (xx - cx) * np.sin(ang)
            v = -(yy - cy) * np.sin(ang) + (xx - cx) * np.cos(ang)
            m |= (u / ry) ** 2 + (v / rx) ** 2 < 1.0
        img[m] += np.asarray([25, 60, 25], np.float32)
        if rng.random() < 0.7:
            y0, x0 = rng.integers(0, SIZE - SIZE // 4, 2)
            img[y0:y0 + SIZE // 6, x0:x0 + SIZE // 6] += np.asarray([70, 20, 20], np.float32)
        img += rng.normal(0, 12, img.shape)
        images[i] = np.clip(img, 0, 255).astype(np.uint8)
        masks[i, ..., 0] = m * np.uint8(255)
    return images, masks


def launch_counts(bn, df):
    return {**bn.LAUNCHES, "multipart_conv3x3": df.LAUNCHES}


def reset_counts(bn, df):
    for k in bn.LAUNCHES:
        bn.LAUNCHES[k] = 0
    df.LAUNCHES = 0


def profile_steps(step, batch, gen, precision, card, steps=5):
    """Device time by kernel over a few train steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"train profile {precision}: {steps} steps, wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy_ms / steps:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}% of "
          f"wall; profiler on) | card: {card}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms / steps:8.3f} ms/step {100 * ms / busy_ms:5.1f}%  "
              f"x{e.count // steps:<3d} {e.key[:110]}")


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
        want = {k: bn_per_step * epochs * steps for k in bn.LAUNCHES}
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
        want = {**{k: bn_per_step for k in bn.LAUNCHES}, "multipart_conv3x3": k4}
        if train_counts != want or not np.isfinite(loss):
            raise AssertionError(f"sweep {label}: train step loss {loss}, launches "
                                 f"{train_counts}, expected {want}")
        m.eval()  # the train step left it in train mode
        reset_counts(bn, df)
        t0 = time.perf_counter()
        probs = pred.predict_u8(imgs)
        serve_ms = (time.perf_counter() - t0) * 1e3
        serve_counts = launch_counts(bn, df)
        want = {**{k: 0 for k in bn.LAUNCHES}, "multipart_conv3x3": k4}
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
        want = {k: BN_PER_STEP * steps * epochs for k in bn.LAUNCHES}
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    want = {**{k: RESNET_RNN_BN_PER_STEP * CLI_STEPS for k in bn.LAUNCHES},
            "multipart_conv3x3": 0}
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

    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    from torch.profiler import ProfilerActivity, profile

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
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        want = {**{k: bn_launches for k in bn.LAUNCHES}, "multipart_conv3x3": k4_launches}
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
        want = dict(zip(launches[mode], REMAT_LAUNCHES[mode]))
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from pytorch_nested_unet_tpu_torch.ops import _build
    from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
    from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
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

    k4 = kernel_phase(df, dev)
    k4_host_us(df, dev)
    runs = [path_phase(bn, df, card)]
    bn_kernels_per_call(bn, dev)
    bnk = bn_kernel_phase(bn, dev)
    k4_backward_phase(df, dev)
    runs.append(train_phase(bn, df, card))
    cpu_step_phase()
    runs.append(path_phase(bn, df, card, "UNetRNN", False, k4_per_batch=0))
    runs.append(train_phase(bn, df, card, "UNetRNN", False, UNETRNN_BN_PER_STEP, 0))
    unetrnn_train = runs[-1]
    runs.append({"bf16": arch_sweep_phase(bn, df, card)})
    cpu_step_phase("UNetRNN", False, zero_bn_fed_biases=True, conv_gap=True)
    runs.append(path_phase(bn, df, card, "VGG16RNN", False, k4_per_batch=0))
    runs.append(train_phase(bn, df, card, "VGG16RNN", False, VGG16RNN_BN_PER_STEP, 0))
    vgg_train = runs[-1]
    cpu_step_phase("VGG16RNN", False, zero_bn_fed_biases=True, conv_gap=True, card_convs=True)
    runs.append(path_phase(bn, df, card, "ResNet50RNN", False, k4_per_batch=0))
    runs.append(train_phase(bn, df, card, "ResNet50RNN", False, RESNET_RNN_BN_PER_STEP, 0))
    cli = cli_phase(bn, df, card)
    runs.append({"bf16": cli})
    runs.append({"bf16": pretrained_phase(bn, df, card)})
    runs.append(path_phase(bn, df, card, "AttU_Net", False, k4_per_batch=0))
    runs.append(train_phase(bn, df, card, "AttU_Net", False, 0, 0))
    runs.append({"bf16": canet_cli_phase(bn, df, card)})
    runs.append(path_phase(bn, df, card, "UNetRNNPSP", False, k4_per_batch=0))
    runs.append(train_phase(bn, df, card, "UNetRNNPSP", False, UNETRNN_BN_PER_STEP, 0))
    cpu_step_phase("UNetRNNPSP", False, zero_bn_fed_biases=True, conv_gap=True, step_floor=True)
    runs.append({"fp32": refine_phase(bn, df, card)})
    runs.append({"bf16": refine_cli_phase(bn, df, card)})
    remat = remat_phase(bn, df, card)
    runs.append({"fp32": {k: sum(c[k] for c in remat.values()) for k in launch_counts(bn, df)}})
    new_arch_counts()
    for arch, (_, _, gflop) in NEW_ARCHS.items():
        runs.append(path_phase(bn, df, card, arch, False, k4_per_batch=0, gflop=gflop))
        runs.append(train_phase(bn, df, card, arch, False, 0, 0))
    cpu_step_phase("DoubleUnet", False, zero_bn_fed_biases=True, conv_gap=True, plain_bn=True)
    cpu_step_phase("DeepLab", False, conv_gap=True, step_floor=True, plain_bn=True,
                   no_dropout=True)
    runs.append({"bf16": deeplab_cli_phase(bn, df, card)})
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
                              **{key: bnk[(k, dtype, "VGG16RNN")][key] for key in timed}}}
        if dtype == torch.float32:
            entry["remat_step"] = {mode: c[fn] for mode, c in remat.items()}
        if dtype == torch.bfloat16:  # the CLI path: NestedUNet's training-step shapes
            entry["cli"] = {"launches": cli[fn], **{key: agg[key] for key in timed}}
        kernels.append(entry)
    print("times: multipart_conv3x3 sums over the 10 decoder nodes of one batch-16 NestedUNet "
          "forward; bn_* sums over the 30 BN instances of one batch-16 NestedUNet training "
          "step (unetrnn_step: the 15 of a UNetRNN step, its launches those of UNetRNN's fit; "
          "vgg16rnn_step: the 18 of a VGG16RNN step, its launches those of VGG16RNN's fit; "
          "cli: the image-folder CLIs' path, bf16, its launches those of cli_phase; "
          "remat_step: launches in one fp32 NestedUNet train step under --remat none, full "
          "and policy); max_abs_err: over the path's own shapes; launches: over every path "
          "driven (NestedUNet, UNetRNN, VGG16RNN, ResNet50RNN, AttU_Net and UNetRNNPSP "
          "serving and training, the arch sweep, the CLIs, --pretrained_backbone, "
          "train_canet, the Refiner (none), train_isic_ca with val/infer --refine, the "
          "--remat steps, DoubleUnet and DeepLab serving and training and the DeepLab CLIs "
          "(none)); card:")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
