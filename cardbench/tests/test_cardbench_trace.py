"""The traced stretch's reduction: busy time as the union of the device's
intervals, idle gaps labelled by the host's innermost operation."""

import pytest

from cardbench.lib import trace


class Event:
    def __init__(self, name, kind, start, end, thread=1):
        self._n, self._k, self._s, self._e, self._t = name, kind, start, end, thread

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return self._t


def test_union_not_sum_and_gaps():
    events = [
        Event(trace.WINDOW, "user_annotation", 100, 1100),
        Event("gemm", "kernel", 50, 300),           # clipped to the window at 100
        Event("nccl_allreduce", "kernel", 200, 400),  # overlaps gemm on another stream
        Event("Memcpy HtoD", "gpu_memcpy", 600, 700),
        Event("annotation", "gpu_user_annotation", 100, 1100),  # not device work
        Event("aten::copy_", "cpu_op", 400, 650),
        Event("cudaStreamSynchronize", "cuda_runtime", 700, 1100),
        Event("autograd thread", "cpu_op", 800, 900, thread=2),
    ]
    t = trace.reduce(events)
    assert t.window_s == pytest.approx(1000e-9)
    # [100, 400) and [600, 700): 300 + 100, not the sum 200 + 200 + 100
    assert t.busy_s == pytest.approx((300 + 100) * 1e-9)
    assert t.kernel_seconds(lambda n: True) == pytest.approx((200 + 200) * 1e-9)
    assert t.kind_seconds("gpu_memcpy") == pytest.approx(100e-9)
    assert [g[0] for g in t.gaps] == ["aten::copy_", "cudaStreamSynchronize"]
    assert [g[1] for g in t.gaps] == pytest.approx([200e-9, 400e-9])
    assert t.top_gaps()[0][0] == "cudaStreamSynchronize"
    assert [n for n, _ in t.top_ops()] == ["gemm", "nccl_allreduce", "Memcpy HtoD"]
