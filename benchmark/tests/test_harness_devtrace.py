"""The trace reduction on a hand-made trace: busy time as a union, idle
gaps labelled by the host's calls, kernels per graph launch."""

import pytest

from harness import devtrace


class Ev:
    def __init__(self, name, cuda, start, end, corr=0, user=False):
        self._n, self._c, self._s, self._e = name, cuda, start, end
        self._corr, self._u = corr, user

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._u


class Prof:
    def __init__(self, events):
        class K:
            def events(_):
                return events

        class P:
            kineto_results = K()
        self.profiler = P()


def trace():
    ms = 1_000_000
    return Prof([
        Ev(devtrace.WINDOW, False, 0, 100 * ms, user=True),
        Ev(devtrace.WINDOW, True, 0, 100 * ms, user=True),
        Ev("cudaGraphLaunch", False, 9 * ms, 10 * ms, corr=7),
        Ev("void maxsim_int8_kernel<4>(...)", True, 10 * ms, 30 * ms, corr=7),
        Ev("ampere_sgemm_128x64_nn", True, 25 * ms, 40 * ms, corr=7),
        Ev("cudaGraphLaunch", False, 59 * ms, 60 * ms, corr=9),
        Ev("Memcpy DtoH (Device -> Pinned)", True, 60 * ms, 70 * ms,
           corr=9),
        Ev("void at::native::elementwise_kernel<1>", True, 200 * ms,
           210 * ms, corr=9),
    ])


def test_reduce_trace():
    red = devtrace.reduce_trace(trace(), calls=[(1.005, 1.045)], anchor=1.0)
    assert red["window_s"] == pytest.approx(0.1)
    assert red["busy_s"] == pytest.approx(0.040)      # 10-40 and 60-70 ms
    assert red["op_s"] == pytest.approx(0.045)
    assert red["launches"] == [2, 1]
    assert red["by_name"]["maxsim_int8"] == pytest.approx(0.02)
    assert red["by_name"]["copy out"] == pytest.approx(0.01)
    labels = dict((round(s, 3), lab) for lab, s in red["gaps"])
    assert labels == {0.01: "in a call", 0.02: "between calls",
                      0.03: "between calls"}
    red2 = devtrace.reduce_trace(trace(), calls=[(1.0, 1.1)], anchor=1.0)
    assert {lab for lab, _ in red2["gaps"]} == {"in a call"}
    assert devtrace.launches_consistent(red, [2, 1])
    assert not devtrace.launches_consistent(red, [2])
    b = devtrace.breakdown(red)
    assert b["device_ops"][0] == ["maxsim_int8", pytest.approx(0.02)]
    assert len(b["idle_gaps"]) == 3


def test_launch_kernel_counts():
    assert devtrace.launch_kernel_counts(trace()) == [2, 2]
