"""The reduction of a device trace, on a made-up trace shaped as the
profiler's events are when the event type is not given (as on the card's
PyTorch): kinds from the device and the name."""
from __future__ import annotations

import types

from harness import trace

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"


class Ev:
    def __init__(self, name, dev, t0, t1, tid=1, corr=0):
        self._v = (name, dev, t0, t1, tid, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return 0


def _results(events):
    return types.SimpleNamespace(events=lambda: events)


def test_reduce_a_made_up_trace():
    k = "void (anonymous namespace)::vel_fused_kernel<float>(float const*)"
    events = [
        Ev(trace.WINDOW_MARK, CPU, 0, 1000),
        Ev(trace.WINDOW_MARK, CUDA, 0, 1000),      # its mirror: not an op
        Ev(trace.FRAME_MARK, CPU, 0, 500),
        Ev(trace.FRAME_MARK, CPU, 500, 950),
        Ev("aten::item", CPU, 100, 400),
        Ev("cudaStreamSynchronize", CPU, 150, 390, tid=9),
        Ev("cudaLaunchKernel", CPU, 20, 25, corr=1),
        Ev(k, CUDA, 50, 100, corr=1),
        Ev("Memcpy DtoH (Device -> Pinned)", CUDA, 390, 400, corr=2),
        Ev(k, CUDA, 600, 700, corr=3),
        Ev(trace.ROWS_MARK, CPU, 955, 990),
        Ev("cudaLaunchKernel", CPU, 960, 965, corr=4),
        Ev("void reduce_kernel", CUDA, 970, 980, corr=4),   # the benchmark's
    ]
    trace.SHORT_GAP_NS, short = 10, trace.SHORT_GAP_NS
    try:
        out = trace.reduce(_results(events))
    finally:
        trace.SHORT_GAP_NS = short
    assert abs(out["window_s"] - 1000e-9) < 1e-15
    assert out["device_events"] == 3
    assert abs(out["busy_s"] - 160e-9) < 1e-15
    assert out["frames"] == 2
    assert out["kernels"]["solve_iteration_fused"] == [(0, 50), (1, 100)]
    assert out["kernels"]["segment_sum"] == []
    idle = dict(out["idle_gaps"])
    assert abs(idle["cudaStreamSynchronize"] - 290e-9) < 1e-15  # 100..390
    assert abs(out["device_ops"][0][1] - 150e-9) < 1e-15


def test_launches_take_their_frames_from_the_program_counts():
    """Device and host clocks that disagree move a launch out of its
    frame's annotation; the program's counts after each frame place it
    all the same."""
    k = "void (anonymous namespace)::vel_fused_kernel<float>(float const*)"
    events = [
        Ev(trace.WINDOW_MARK, CPU, 0, 1000),
        Ev(trace.FRAME_MARK, CPU, 0, 500),
        Ev(trace.FRAME_MARK, CPU, 500, 950),
        Ev(k, CUDA, 505, 540, corr=2),    # frame 0's, read 10 ns late
        Ev(k, CUDA, 50, 100, corr=1),
        Ev(k, CUDA, 960, 990, corr=3),    # frame 1's, read 20 ns late
    ]
    plain = trace.reduce(_results(events))
    assert plain["kernels"]["solve_iteration_fused"] == [
        (0, 50), (1, 35), (None, 30)]
    marks = [{"solve_iteration_fused": 2}, {"solve_iteration_fused": 3}]
    out = trace.reduce(_results(events), marks)
    assert out["kernels"]["solve_iteration_fused"] == [(0, 50), (0, 35),
                                                       (1, 30)]
    assert out["kernels"]["segment_sum"] == []
    # a launch the program did not count has no frame
    out = trace.reduce(_results(events), marks[:1])
    assert out["kernels"]["solve_iteration_fused"] == [(0, 50), (0, 35),
                                                       (None, 30)]
