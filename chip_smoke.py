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
   shapes of the training step (full width, batch 16, 96x96) and at ragged
   shapes, both dtypes, with bounds and library yardsticks, per level and
   summed over the step's 30 instances; times are device time replayed from
   a CUDA graph (a call from Python also pays the host's launch gaps,
   printed beside it as "call"); then each kernel's step sequence, the 30
   instances replayed from one graph;
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
9. a JSON line of the kernels, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

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
        agg = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "bytes": 0.0, "operations": 0.0}
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


def path_phase(df, card):
    """Serve full-width NestedUNet wDS through Predictor in fp32 and bf16."""
    from pytorch_nested_unet_tpu_torch.infer import Predictor

    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
                for _ in range(8)]
    launches, probs = {}, {}
    for precision in ("fp32", "bf16"):
        pred = Predictor("NestedUNet", 1, 3, deep_supervision=True, precision=precision,
                         batch_size=BATCH, seed=0, device="cuda")
        df.LAUNCHES = 0
        outs = [pred.predict_u8(r) for r in requests]
        launches[precision] = df.LAUNCHES
        want = 10 * len(requests)
        if launches[precision] != want:
            raise AssertionError(f"{precision}: K4 launched {launches[precision]} times, "
                                 f"expected {want} (10 decoder nodes x {len(requests)} batches)")
        y = np.concatenate(outs)
        if y.shape != (len(requests) * BATCH, SIZE, SIZE, 1) or not np.isfinite(y).all() \
                or y.min() < 0 or y.max() > 1:
            raise AssertionError(f"{precision}: bad probabilities {y.shape} "
                                 f"[{np.nanmin(y)}, {np.nanmax(y)}]")
        probs[precision] = y
        s = pred.summary()
        print(f"path {precision}: NestedUNet wDS nb_filter={NB} batch {BATCH} {SIZE}x{SIZE}, "
              f"{s['batches']} batches: steady p50 {s['p50_ms']:.3f} ms, p95 "
              f"{s['p95_ms']:.3f} ms, {s['img_per_s']:.1f} img/s (first batch "
              f"{s['first_batch_ms']:.1f} ms) | K4 launches {launches[precision]} | "
              f"card: {card}", flush=True)
        profile_batches(pred, requests[0], precision)
        if precision == "fp32":
            sd = {k: v.cpu() for k, v in pred.model.state_dict().items()}
            cpu = Predictor("NestedUNet", 1, 3, deep_supervision=True, precision="fp32",
                            batch_size=2, weights=sd, device="cpu")
            ref = cpu.predict_u8(requests[0][:2])
            err = float(np.abs(y[:2] - ref).max())
            print(f"path fp32 vs CPU plain path, 2 images: max abs err {err:.3g} (atol 1e-4)")
            if err > 1e-4:
                raise AssertionError(f"fp32 card vs CPU: max abs err {err} > 1e-4")
    # bf16 rounds activations and weights at every layer; the same seeded
    # weights give probabilities within 2e-4 of fp32 on the card (PERF.md)
    err = float(np.abs(probs["bf16"] - probs["fp32"]).max())
    print(f"path bf16 vs fp32 probabilities: max abs diff {err:.3g} (atol 1e-2)")
    if err > 1e-2:
        raise AssertionError(f"bf16 vs fp32 probabilities: max abs diff {err} > 1e-2")
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
    unless each is one."""
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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            found[f"{k} {DTYPE_NAME[dtype]}"] = names
            if len(names) != 1:
                raise AssertionError(f"{k} {DTYPE_NAME[dtype]}: one call ran {len(names)} "
                                     f"CUDA kernels, expected 1: {names}")
    print("CUDA kernels per bn_stats (K1) and bn_bwd_reduce (K2) call at level 0 "
          "(torch.profiler): " + "; ".join(f"{k} {len(v)} ({v[0][:60]})"
                                           for k, v in found.items()), flush=True)


def bn_step_sequence(bn, dev, dtype, gen, flush):
    """K1-K3, their plain versions and library calls over the 30 BN instances
    of one training step, each instance on its own buffers, each set of 30
    captured in one CUDA graph and replayed after one L2 flush: the graph
    timing floor is paid once per step, not once per instance. K1 updates
    running stats, as in the step. Returns {kernel: (kernel, plain, library ms)}."""
    nbb = torch.ops.aten.native_batch_norm_backward
    insts = []
    for lvl, c, rows, n in BN_LEVELS:
        nhw = (BATCH, SIZE >> lvl, SIZE >> lvl)
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
    print(f"BN {DTYPE_NAME[dtype]} step sequence (the {len(insts)} instances of one step in "
          "one CUDA graph, one L2 flush before each replay): " + " | ".join(
              f"{k} kernel {t[0]:.4f} ms plain {t[1]:.4f} library {t[2]:.4f}"
              for k, t in out.items()), flush=True)
    return out


def bn_kernel_phase(bn, dev):
    """K1-K3 against their plain versions; returns {(kernel, dtype): summary}
    with times summed over the 30 BN instances of one training step. Each
    dtype ends with the step sequence (`bn_step_sequence`)."""
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
        aggs = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "bound_ms": 0.0, "bytes": 0.0, "operations": 0.0, "call_ms": 0.0}
                for k in BN_OPS}
        cases = [(f"level{lvl}", c, rows, n, (BATCH, SIZE >> lvl, SIZE >> lvl))
                 for lvl, c, rows, n in BN_LEVELS]
        cases += [("ragged", c, rows, 0, (1, rows, 1)) for c, rows in BN_RAGGED]
        for name, c, rows, count, nhw in cases:
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
                a = aggs[k]
                a["max_abs_err"] = max(a["max_abs_err"], errs[k])
                for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                               ("bound_ms", bound), (by, bound), ("call_ms", call_ms)):
                    a[key] += count * v
                parts.append(f"{k} err {errs[k]:.3g} kernel {ms:.4f} ({100 * bound / ms:.1f}% of "
                             f"bound; call {call_ms:.4f}) plain {plain_ms:.4f} library "
                             f"{lib_ms:.4f} bound {bound:.4f} ({by})")
            print(f"BN {DTYPE_NAME[dtype]} {name:7s} C={c:<3d} rows={rows:<6d} x{count:<2d}| "
                  + " | ".join(parts), flush=True)
        for k, a in aggs.items():
            a["bound_by"] = "bytes" if a.pop("bytes") > a.pop("operations") else "operations"
            call_ms = a.pop("call_ms")
            out[(k, dtype)] = a
            print(f"BN {DTYPE_NAME[dtype]} {k} over the {BN_PER_STEP} instances of one step: "
                  f"kernel {a['ms']:.4f} ms (per call from Python: {call_ms:.4f} ms) | plain "
                  f"{a['plain_ms']:.4f} ms | library "
                  f"{a['library_ms']:.4f} ms | bound {a['bound_ms']:.4f} ms ({a['bound_by']}) "
                  f"| max abs err {a['max_abs_err']:.3g}", flush=True)
        bn_step_sequence(bn, dev, dtype, gen, flush)
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


def train_phase(bn, df, card):
    """train.fit on full-width NestedUNet wDS in bf16 and fp32; returns the
    launch counts of each run."""
    from pytorch_nested_unet_tpu_torch.infer import Predictor
    from pytorch_nested_unet_tpu_torch.train import fit
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    tr_x, tr_y = synthetic_set(64, seed=0)
    va_x, va_y = synthetic_set(20, seed=1)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke")
    epochs, steps = 3, 64 // BATCH
    val_batches = -(-len(va_x) // BATCH)
    launches = {}
    for precision in ("bf16", "fp32"):
        reset_counts(bn, df)
        t0 = time.perf_counter()
        r = fit(tr_x, tr_y, va_x, va_y, name=f"NestedUNet_wDS_{precision}", output_dir=out_dir,
                epochs=epochs, batch_size=BATCH, deep_supervision=True, loss="BCEDiceLoss",
                optimizer="SGD", lr=1e-3, momentum=0.9, weight_decay=1e-4,
                scheduler="CosineAnnealingLR", min_lr=1e-5, precision=precision, seed=41,
                augment="full", device="cuda")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts(bn, df)
        launches[precision] = counts
        want = {k: BN_PER_STEP * epochs * steps for k in bn.LAUNCHES}
        want["multipart_conv3x3"] = 10 * epochs * (steps + val_batches)
        if counts != want:
            raise AssertionError(f"train {precision}: launches {counts}, expected {want} "
                                 f"({BN_PER_STEP} BN per step, 10 decoder nodes per step and "
                                 f"per val batch, {epochs}x{steps} steps, {epochs}x"
                                 f"{val_batches} val batches)")
        log = r["log"]
        with open(os.path.join(r["model_dir"], "log.csv")) as f:
            rows = list(csv.reader(f))
        if rows[0] != LOG_COLUMNS or len(rows) != 1 + epochs:
            raise AssertionError(f"train {precision}: log.csv {rows}")
        if not all(np.isfinite(log[k]).all() for k in ("loss", "val_loss", "iou", "val_iou")):
            raise AssertionError(f"train {precision}: non-finite log {log}")
        print(f"train {precision}: fit 3 epochs x {steps} steps (+{val_batches} val batches "
              f"each, the last padded) in {fit_s:.2f} s; train s/epoch "
              f"{[round(t, 3) for t in r['train_s']]}, val s/epoch "
              f"{[round(t, 3) for t in r['val_s']]}; loss {[round(v, 4) for v in log['loss']]}, "
              f"val_loss {[round(v, 4) for v in log['val_loss']]}, val_iou "
              f"{[round(v, 4) for v in log['val_iou']]} | launches {counts} | card: {card}",
              flush=True)
        pth = os.path.join(r["model_dir"], "model.pth")
        pred = Predictor("NestedUNet", 1, 3, deep_supervision=True, precision=precision,
                         batch_size=BATCH, weights=pth, device="cuda")
        probs = pred.predict_u8(va_x[:BATCH])
        if probs.shape != (BATCH, SIZE, SIZE, 1) or not np.isfinite(probs).all():
            raise AssertionError(f"train {precision}: served model.pth gave {probs.shape}")

        # steady step time: the same step as fit's, synchronized after each
        model = r["model"]
        step = make_train_step(model, build_optimizer(model.parameters(), "SGD", 1e-3, 0.9,
                                                      1e-4), "BCEDiceLoss", True, "full")
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
        print(f"train {precision} steady: NestedUNet wDS nb_filter={NB} batch {BATCH} "
              f"{SIZE}x{SIZE}, 20 steps: p50 {p50:.3f} ms/step, p95 {p95:.3f} ms/step, "
              f"{BATCH * 1e3 / (sum(times) / len(times)):.1f} img/s | card: {card}", flush=True)
        profile_steps(step, batch, gen, precision, card)
    return launches


def cpu_step_phase():
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
    """
    from pytorch_nested_unet_tpu_torch.models import create_model
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    imgs, masks = synthetic_set(2, seed=3)
    imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)

    def run(dev, perturb=0.0):
        m = create_model("NestedUNet", 1, 3, True, generator=torch.Generator().manual_seed(5))
        if perturb:
            g = torch.Generator().manual_seed(6)
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
        m = m.to(dev)
        step = make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-3, 0.9, 1e-4),
                               "BCEDiceLoss", True, augment="none")
        t0 = time.perf_counter()
        loss = float(step(imgs.to(dev), masks.to(dev), torch.Generator(device=dev))["loss"])
        print(f"card vs CPU: {dev}{' (weights moved by 1e-7)' if perturb else ''} step "
              f"{time.perf_counter() - t0:.2f} s, loss {loss:.7f}", flush=True)
        return (loss, {n: p.grad.cpu() for n, p in m.named_parameters()},
                {n: b.cpu() for n, b in m.named_buffers()})

    cuda, cpu, moved = run("cuda"), run("cpu"), run("cpu", perturb=1e-7)

    def rel(a, b):
        return {n: ((a[n] - b[n]).norm() / max(b[n].norm(), b[n.rsplit(".", 1)[0] + ".weight"]
                                                .norm())).item() for n in b}

    card_rel, floor = rel(cuda[1], cpu[1]), rel(moved[1], cpu[1])
    bound = {n: max(1e-4, 4 * floor[n]) for n in floor}
    worst = max(card_rel, key=lambda n: card_rel[n] / bound[n])
    loss_err = abs(cuda[0] - cpu[0])
    stat_ok = all(torch.allclose(cuda[2][n], b, atol=1e-5, rtol=1e-5) for n, b in cpu[2].items())
    stat_err = max((cuda[2][n] - b).abs().max().item() for n, b in cpu[2].items())
    loose = sorted(n for n in floor if bound[n] > 1e-4)
    print(f"card vs CPU, one full-width fp32 train step: loss diff {loss_err:.3g} (tol 1e-5); "
          f"gradients: worst {worst} at {card_rel[worst]:.3g} relative L2 against a bound of "
          f"{bound[worst]:.3g}; median card-vs-CPU {np.median(list(card_rel.values())):.3g}, "
          f"median movement under a 1e-7 weight change {np.median(list(floor.values())):.3g}; "
          f"{len(loose)} of {len(floor)} gradients bounded by that movement rather than 1e-4 "
          f"(largest: {max(floor.values()):.3g}); running stats max abs diff {stat_err:.3g} "
          f"(atol = rtol = 1e-5)", flush=True)
    if loss_err > 1e-5 or card_rel[worst] > bound[worst] or not stat_ok:
        raise AssertionError("card vs CPU train step outside its bounds")


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
    serve_launches = path_phase(df, card)
    bn_kernels_per_call(bn, dev)
    bnk = bn_kernel_phase(bn, dev)
    k4_backward_phase(df, dev)
    train_launches = train_phase(bn, df, card)
    cpu_step_phase()

    kernels = []
    for dtype, agg in k4.items():
        name = DTYPE_NAME[dtype]
        kernels.append({
            "name": f"multipart_conv3x3[{name}]", "route": "cuda",
            "source": "pytorch_nested_unet_tpu_torch/ops/csrc/decoder_fusion.cu",
            "replaces": "pytorch_nested_unet_tpu/ops/decoder_fusion.py:209",
            "launches": serve_launches[name] + train_launches[name]["multipart_conv3x3"],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": agg["bound_by"], "library_ms": agg["library_ms"]})
    bn_names = {"K1": ("bn_stats", "pytorch_nested_unet_tpu/ops/fused_bn.py:145"),
                "K2": ("bn_bwd_reduce", "pytorch_nested_unet_tpu/ops/fused_bn.py:260"),
                "K3": ("bn_bwd_dx", "pytorch_nested_unet_tpu/ops/fused_bn.py:284")}
    for (k, dtype), agg in bnk.items():
        fn, replaces = bn_names[k]
        kernels.append({
            "name": f"{fn}[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "pytorch_nested_unet_tpu_torch/ops/csrc/fused_bn.cu",
            "replaces": replaces, "launches": train_launches[DTYPE_NAME[dtype]][fn],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": agg["bound_by"], "library_ms": agg["library_ms"]})
    print("times: multipart_conv3x3 sums over the 10 decoder nodes of one batch-16 forward; "
          "bn_* sums over the 30 BN instances of one batch-16 training step; launches: "
          "multipart_conv3x3 over the serving (8 batches) and training (3 epochs) runs, bn_* "
          "over the training run; card:")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
