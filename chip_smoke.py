#!/usr/bin/env python
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

1. header: the card's name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
2. build every CUDA kernel of the port from the sources in this checkout;
3. kernel phase: each kernel against its plain PyTorch version at the shapes
   the serving path gives it (NestedUNet full width, batch 16, 96x96) and at
   ragged shapes, in float32 and bfloat16, with its time, the plain version's,
   one library call's as a yardstick, and the card's bound for the same work;
4. path phase: full-width NestedUNet with deep supervision served through
   `Predictor` (8 requests of 16 uint8 96x96 images, fp32 then bf16), with the
   launch counts of every kernel read around each run, a torch.profiler
   breakdown of a few more batches by kernel, and the fp32 probabilities held
   against the same weights on the CPU;
5. a JSON line of the kernels, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

import json
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
RAGGED = [("single_part", (2, 13, 10), (7,), 5), ("three_part", (2, 13, 10), (5, 3, 8), 6)]


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


def conv_bound_ms(b, h, w, cps, co, dtype):
    """Least time for conv3x3 over the parts: each input and weight read once,
    the output written once, 2*9*cin*co operations per output pixel."""
    esz = torch.finfo(dtype).bits // 8
    cin = sum(cps)
    nbytes = (b * h * w * (cin + co) + 9 * cin * co) * esz + co * 4
    flops = 2.0 * b * h * w * 9 * cin * co
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def kernel_phase(df, dev):
    """K4 against its plain version; returns {dtype: summary} over the nodes."""
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
            ms = time_ms(lambda: df.multipart_conv3x3(parts, kernel, bias), flush)
            plain_ms = time_ms(lambda: df.reference_multipart_conv3x3(parts, kernel, bias),
                               flush)
            w_oihw = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib_bias = bias.to(dtype)
            lib_ms = time_ms(lambda: F.conv2d(torch.cat(parts, -1).permute(0, 3, 1, 2),
                                              w_oihw, lib_bias, padding=1), flush)
            bound, by = conv_bound_ms(b, h, w, cps, co, dtype)
            print(f"K4 {DTYPE_NAME[dtype]} {name:11s} B={b} {h}x{w} parts={cps} co={co}: "
                  f"max_abs_err {err:.3g} (tol {tol}) | kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | library {lib_ms:.4f} ms | bound {bound:.4g} ms "
                  f"({by})", flush=True)
            if name in node_names:  # the serving path's work: one forward
                agg["ms"] += ms
                agg["plain_ms"] += plain_ms
                agg["library_ms"] += lib_ms
                agg["bound_ms"] += bound
                agg[by] += bound
        agg["bound_by"] = "bytes" if agg.pop("bytes") > agg.pop("operations") else "operations"
        out[dtype] = agg
    return out


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from pytorch_nested_unet_tpu_torch.ops import _build
    from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df

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

    k4 = kernel_phase(df, dev)
    launches = path_phase(df, card)

    kernels = []
    for dtype, agg in k4.items():
        kernels.append({
            "name": f"multipart_conv3x3[{DTYPE_NAME[dtype]}]", "route": "cuda",
            "source": "pytorch_nested_unet_tpu_torch/ops/csrc/decoder_fusion.cu",
            "replaces": "pytorch_nested_unet_tpu/ops/decoder_fusion.py:209",
            "launches": launches[DTYPE_NAME[dtype]],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": agg["bound_by"], "library_ms": agg["library_ms"]})
    print("times: sums over the 10 decoder nodes of one batch-16 forward; card:")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
