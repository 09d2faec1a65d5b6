"""Serving mixes: requests of `batch` uint8 images to the port's
`infer.Predictor.predict_u8`, served one at a time by one client.

Two ways requests come, by the mix:
- a folder (no `arrivals_per_s`): every request is there from the start, as
  in `infer.py`'s folder job, so the offered load is above what the card
  serves; the next request is sent when the previous one's probabilities are
  on the host. Its end-to-end metric is the images answered a second.
- a fixed rate (`arrivals_per_s`): request i arrives i / rate seconds after
  the window opens, the same for every seed; each is served when it has
  arrived and the one before is answered, and timed from its arrival until
  its probabilities are on the host, so a wait in the queue counts. Those
  that arrived in the window are all served, the last ones after its close.
  Its end-to-end metric is the tail of those times.

Set-up makes the seeded weights and a pool of `pool_requests` requests on the
card, sets every BN's running statistics to the batch moments of
`calibration_images` of them (the plain reference's train-mode forward: a
served model's statistics, not the init's 0 and 1), builds the port's
`Predictor` on those weights, copies the pool to the host and sends
`warmup_requests` requests. Requests take the pool's in turn. Every answer of
the window is kept, and once the window has closed the plain reference
(float64) computes each pool request's probabilities: the check is the
widest gap of any answer.
"""

import gc
import time

import numpy as np
import torch

from cardbench import reference
from cardbench.lib import card, checks, inputs, trace
from cardbench.lib.spec import Cell
from cardbench.reference.common import Numerics, plain_math


def make_inputs(cfg, tr, seed, device):
    """The calibrated seeded weights and the request pool (on the card)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sd0 = inputs.state_dict(cfg, gen)
    images, _ = inputs.synthetic_set(tr["pool_requests"] * tr["batch"], cfg["input_hw"], gen)
    with plain_math():
        sd = reference.calibrate(cfg, sd0, images[:tr["calibration_images"]])
    return sd, images


class Client:
    """The port's Predictor and the requests one client sends it."""

    def __init__(self, cell: Cell, seed: int, device):
        from pytorch_nested_unet_tpu_torch.infer import Predictor

        cfg, tr = cell.config, cell.traffic
        self.tr = tr
        self.sd, self.images = sd, images = make_inputs(cfg, tr, seed, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)  # the calibration is not the program's
        self.predictor = Predictor(
            cfg["arch"], cfg["num_classes"], cfg["input_channels"], cfg["deep_supervision"],
            precision=cfg["precision"], batch_size=tr["batch"], weights=sd, device=device,
            arch_kwargs={k: cfg[k] for k in cfg["arch_kwargs"]})
        h, w = cfg["input_hw"]
        self.pool = images.cpu().numpy().reshape(tr["pool_requests"], tr["batch"], h, w, 3)
        self.sent = 0
        self.answers = {}  # pool index -> the answers to it

    def send(self, keep=True):
        """One request, answered (its answer kept for the check)."""
        i = self.sent % len(self.pool)
        probs = self.predictor.predict_u8(self.pool[i])
        self.sent += 1
        if keep:
            self.answers.setdefault(i, []).append(probs)

    def for_seconds(self, seconds, keep=True):
        """A window of `seconds` as the mix has its requests come: (each
        request's seconds, the window's seconds). A folder's window closes
        with the first answer at or after `seconds`; a fixed rate's with the
        last answer to a request that arrived in it."""
        rate = self.tr.get("arrivals_per_s")
        lat = []
        t0 = time.perf_counter()
        while True:
            if rate:
                arrival = t0 + len(lat) / rate
                if arrival >= t0 + seconds:
                    return lat, time.perf_counter() - t0
                delay = arrival - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            else:
                arrival = time.perf_counter()
            self.send(keep)
            lat.append(time.perf_counter() - arrival)
            if not rate and time.perf_counter() - t0 >= seconds:
                return lat, time.perf_counter() - t0

    def close(self):
        self.predictor = None


def answer_gaps(cfg, tr, sd, images, answers, numerics="exact"):
    """(widest gap of any answer to the reference's probabilities, answers
    that are malformed or not finite): the reference in `numerics` on the
    weights `sd` and the pool `images` the answers were made from."""
    b, h, w = tr["batch"], *cfg["input_hw"]
    widest, failed = 0.0, 0
    for i, got in sorted(answers.items()):
        with plain_math():
            want = reference.predict(cfg, sd, images[i * b:(i + 1) * b], Numerics(numerics))
        want = want.cpu().numpy()
        for a in got:
            if a.shape != (b, h, w, cfg["num_classes"]) or not np.isfinite(a).all():
                failed += 1
                continue
            widest = max(widest, float(np.abs(a - want).max()))
    return widest, failed


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell, opts: dict, t0: float, device=None):
    """One run of a serving cell: opts = {seed, seconds, trace}."""
    device = device or torch.device("cuda", 0)
    tr = cell.traffic
    stages = {"started": time.perf_counter() - t0}
    c = Client(cell, opts["seed"], device)
    stages["built"] = time.perf_counter() - t0
    for _ in range(tr["warmup_requests"]):
        c.send(keep=False)
    setup_s = time.perf_counter() - t0
    lat, seconds = c.for_seconds(opts["seconds"])
    out = {}
    if opts["trace"]:
        rate = len(lat) * tr["batch"] / seconds
        with trace.profiled() as held:
            c.send(keep=False)  # the profiler's own warm-up, outside the window
            with trace.window():
                n = len(c.for_seconds(tr["trace_seconds"], keep=False)[0])
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        ctx = trace.Context(trace=held.trace, cell=cell, steps=n, images=n * tr["batch"],
                            rate=rate, chips=1)
        out["metrics"] = trace.read_layers(cell, ctx)
        out["busy_s"], out["window_s"] = held.trace.busy_s, held.trace.window_s
        out["breakdown"] = {"device_ops": held.trace.top_ops(),
                            "idle_gaps": held.trace.top_gaps()}
    else:
        e2e = {"serve_img_per_s": len(lat) * tr["batch"] / seconds,
               "serve_batch_ms_p95": float(np.percentile(lat, 95)) * 1e3, "setup_s": setup_s}
        out["metrics"] = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out["forbidden"] = card.forbidden_modules()
    c.close()
    _free(device)
    t_check = time.perf_counter()
    widest, failed = answer_gaps(cell.config, tr, c.sd, c.images, c.answers)
    nums = {"prob_gap": widest}
    ok, rows = checks.verdict(nums, cell.limits)
    out.update(correct=bool(ok and failed == 0), attempted=len(lat), failed=failed,
               numbers=nums, rows=rows,
               phases={"setup_s": setup_s, "setup_stages": stages, "window_s": seconds,
                       "check_s": time.perf_counter() - t_check})
    return out


def readings(cell: Cell, seeds, device=None, seconds=1.0):
    """Per seed, the widest answer gap of the program over a short window at
    the cell's load, and of the control (the reference in fp8) in its place
    over the same requests."""
    device = device or torch.device("cuda", 0)
    out = {}
    for seed in seeds:
        c = Client(cell, seed, device)
        for _ in range(cell.traffic["warmup_requests"]):
            c.send(keep=False)
        c.for_seconds(seconds)
        c.close()
        _free(device)
        prog, failed = answer_gaps(cell.config, cell.traffic, c.sd, c.images, c.answers)
        b = cell.traffic["batch"]
        with plain_math():
            control = {i: [reference.predict(cell.config, c.sd, c.images[i * b:(i + 1) * b],
                                             Numerics("fp8")).cpu().numpy()]
                       for i in c.answers}
        ctrl, _ = answer_gaps(cell.config, cell.traffic, c.sd, c.images, control)
        out[seed] = {"program": {"prob_gap": prog, "failed": failed},
                     "control_fp8": {"prob_gap": ctrl}}
        _free(device)
    return out
