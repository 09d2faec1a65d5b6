"""Device activity of a traced stretch, from a torch.profiler trace (CPU and
CUDA activities), reduced to what the per-layer readers take.

The stretch is the host span `WINDOW` (a record_function range that ends
after a synchronize, so every kernel it launched has ended inside it). Busy
time is the union of the device's kernel, memcpy and memset intervals
clipped to it, not their sum: work overlapping on several streams counts
once. An idle gap is a stretch of the window with no device activity,
labelled by the innermost host operation running at its start (on any
thread: backward runs on autograd's own).
"""

import bisect
import contextlib
import types
from dataclasses import dataclass, field
from typing import List, Tuple

WINDOW = "cardbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """A traced stretch: device intervals (name, kind, start_ns, end_ns)
    clipped to the window, busy and window seconds, idle gaps
    (label, seconds)."""
    window_s: float
    busy_s: float
    device: List[Tuple[str, str, int, int]] = field(default_factory=list)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, match) -> float:
        """Summed seconds of the kernels whose name `match` accepts."""
        return sum(e - s for n, k, s, e in self.device if k == "kernel" and match(n)) / 1e9

    def kind_seconds(self, kind: str) -> float:
        return sum(e - s for _, k, s, e in self.device if k == kind) / 1e9

    def top_ops(self, n=10):
        """The n device operations (by name) that took the most summed time."""
        tot = {}
        for name, _, s, e in self.device:
            tot[name] = tot.get(name, 0) + (e - s)
        return [[k[:160], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n=10):
        """Idle seconds summed by what the host was doing, the n largest."""
        tot = {}
        for label, sec in self.gaps:
            tot[label] = tot.get(label, 0.0) + sec
        return [[k[:160], v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(host, starts, t):
    """The innermost host event (latest start) covering time t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, -1), -1):
        name, s, e = host[j]
        if e >= t:
            return name
    return "host (no traced op)"


def activity(e) -> str:
    """A kineto event's activity kind. Where the event does not say (older
    torch), a device event is told apart by its name (Memcpy / Memset, or a
    user annotation mirrored onto the device's timeline)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    import torch

    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "user_annotation" if e.is_user_annotation() else "cpu_op"
    if e.is_user_annotation():
        return "gpu_user_annotation"
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def reduce(events) -> Trace:
    """A Trace from the profiler's kineto events."""
    win = [e for e in events if e.name() == WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    device, host = [], []
    for e in events:
        kind = activity(e)
        s, t = e.start_ns(), e.end_ns()
        if kind in DEVICE_KINDS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                device.append((e.name(), kind, s, t))
        elif kind in HOST_KINDS and e.name() != WINDOW:
            host.append((e.name(), s, t))
    busy = _union([(s, e) for _, _, s, e in device])
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((_label(host, starts, prev), (s - prev) / 1e9))
        prev = max(prev, e)
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=sum(e - s for s, e in busy) / 1e9,
                 device=device, gaps=gaps)


@contextlib.contextmanager
def profiled():
    """Profile CPU and CUDA activity inside; yields a holder whose `trace`
    is set on exit. The body opens the window itself (`window()`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    holder = types.SimpleNamespace(trace=None)
    with profile(activities=activities) as prof:
        yield holder
    holder.trace = reduce(prof.profiler.kineto_results.events())


def window():
    """The traced stretch's span (end it after a synchronize)."""
    from torch.profiler import record_function
    return record_function(WINDOW)


@dataclass
class Context:
    """What a per-layer reader reads: the traced stretch, the cell, the
    steps (training steps or served requests) and images (this card's) in
    the stretch, and the rate of the untraced window (images a second, all
    cards)."""
    trace: Trace
    cell: object
    steps: int
    images: int
    rate: float
    chips: int


def read_layers(cell, ctx: Context) -> dict:
    """{metric: value} of every per-layer metric of the cell whose reader
    finds something to read."""
    from cardbench.lib.spec import reader

    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], cell.repo)(ctx)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def mean_layers(per_card) -> dict:
    """The cards' readings averaged, metric by metric (those every card has)."""
    names = set.intersection(*(set(r) for r in per_card))
    return {n: sum(r[n] for r in per_card) / len(per_card) for n in sorted(names)}
