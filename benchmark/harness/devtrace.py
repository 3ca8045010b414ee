"""Reduction of a ``torch.profiler`` trace of the served path.

The traced window is a user annotation (``WINDOW``) on the thread that
drives the load; the ``retrieve_batch`` calls come from the harness's
own host-clock spans (annotations on the batcher's threads are not
recorded), placed on the trace's clock by an anchor taken inside the
window's annotation. A graph replay's kernels carry the correlation id
of its ``cudaGraphLaunch``. From these: the device ops in the window
(kernels and copies), their time by kernel, the union of their intervals
(busy), the idle gaps labelled by what the host was doing, and per graph
launch its kernel count, so a trace that lost records of a replay can be
found and taken again.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

WINDOW = "bench_window"

# harness names of device ops, first match wins
OP_NAMES = (
    (r"maxsim_int8_doc", "maxsim_int8_doc"),
    (r"maxsim_int8", "maxsim_int8"),
    (r"maxsim_int4", "maxsim_int4_group"),
    (r"maxsim", "maxsim"),
    (r"[Mm]emcpy HtoD", "copy in"),
    (r"[Mm]emcpy DtoH", "copy out"),
    (r"[Mm]emcpy|memcpy", "copy on device"),
    (r"[Mm]emset", "memset"),
    (r"gemm|gemv|xmma|cutlass|sm90_|sm80_", "gemm"),
    (r"[Ss]ort|radix", "sort"),
    (r"softmax", "softmax"),
    (r"layer_norm|LayerNorm", "layer norm"),
    (r"reduce_kernel|Reduce", "reduce"),
    (r"index|gather|scatter", "gather/scatter"),
    (r"elementwise", "elementwise"),
)


def op_name(kernel: str) -> str:
    for pat, name in OP_NAMES:
        if re.search(pat, kernel):
            return name
    return "other"


def _is_cuda(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def reduce_trace(prof, calls: Sequence[Tuple[float, float]],
                 anchor: float) -> Dict:
    """``calls``: the window's ``retrieve_batch`` calls on the host clock
    (perf_counter), ``anchor`` the host clock just inside the window's
    annotation. -> window_s, busy_s (union of device-op intervals in the
    window), op_s (sum of device-op durations), by_kernel {symbol:
    (seconds, count)}, by_name {harness name: seconds}, gaps [(label,
    seconds)] longest first, launches [kernels per graph launch]."""
    evs = list(prof.profiler.kineto_results.events())
    win = [e for e in evs if e.name() == WINDOW and not _is_cuda(e)]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    launches = []       # correlation ids of graph launches in the window
    dev = []            # (start, end, name, corr)
    for e in evs:
        name = e.name()
        if _is_cuda(e):
            if e.is_user_annotation() or name == WINDOW:
                continue
            s, t = e.start_ns(), e.end_ns()
            if t <= w0 or s >= w1:
                continue
            dev.append((max(s, w0), min(t, w1), name, e.correlation_id()))
        elif name == "cudaGraphLaunch" and w0 <= e.start_ns() <= w1:
            launches.append(e.correlation_id())
    dev.sort()
    op_ns = sum(t - s for s, t, _, _ in dev)
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name, _ in dev:
        by_kernel[name][0] += (t - s) / 1e9
        by_kernel[name][1] += 1
        by_name[op_name(name)] += (t - s) / 1e9
    busy, gaps, cur_s, cur_t = 0, [], None, w0
    for s, t, _, _ in dev:
        if cur_s is None or s > cur_t:
            if s > cur_t:
                gaps.append((cur_t, s))
            if cur_s is not None:
                busy += cur_t - cur_s
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_s is not None:
        busy += cur_t - cur_s
    if cur_t < w1:
        gaps.append((cur_t, w1))
    host = [(w0 + (a - anchor) * 1e9, w0 + (b - anchor) * 1e9)
            for a, b in calls]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [(label_gap(a, b, host), (b - a) / 1e9) for a, b in gaps[:10]]
    kernels_of = Counter(corr for _, _, _, corr in dev)
    return dict(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                op_s=op_ns / 1e9,
                by_kernel={k: tuple(v) for k, v in by_kernel.items()},
                by_name=dict(by_name), gaps=labelled,
                launches=[kernels_of.get(c, 0) for c in launches])


def launch_kernel_counts(prof) -> List[int]:
    """Kernels per graph launch, in launch order, over a whole trace."""
    evs = list(prof.profiler.kineto_results.events())
    kernels_of = Counter(e.correlation_id() for e in evs
                         if _is_cuda(e) and not e.is_user_annotation())
    starts = sorted((e.start_ns(), e.correlation_id()) for e in evs
                    if not _is_cuda(e) and e.name() == "cudaGraphLaunch")
    return [kernels_of.get(c, 0) for _, c in starts]


def label_gap(a: float, b: float, calls: Sequence[Tuple]) -> str:
    """What the host was doing in the middle of an idle gap: inside a
    ``retrieve_batch`` call (host work of the call: tokenizing, the copy
    in, the launch, the copy out) or between calls (no query to serve)."""
    mid = (a + b) / 2
    return ("in a call" if any(c[0] <= mid <= c[1] for c in calls)
            else "between calls")


def launches_consistent(red: Dict, expected: Sequence[int]) -> bool:
    """A graph replay runs all its nodes: every launch in the window ran
    as many kernels as one of the captured shapes does (``expected``,
    counted from replays of each shape alone), and there was a launch."""
    want = set(expected)
    return bool(red["launches"]) and all(n in want for n in red["launches"])


def breakdown(red: Dict) -> Dict[str, List]:
    ops = sorted(red["by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in red["gaps"][:10]]}
