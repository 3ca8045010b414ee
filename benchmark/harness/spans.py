"""Readings of the program's own spans (``utils/profiling.py``'s
``record_spans``) in a window of the served path, and of a traced
window's device timeline against them.

A span is the program's ``Span`` (``name``, ``id``, ``parent``,
``thread``, ``t0_ns``, ``t1_ns``, ``attrs``) on ``perf_counter_ns``'s
clock. A traced window's host clock is placed on the trace's by the
anchor ``devtrace`` uses: ``anchor`` (``perf_counter`` seconds) taken
just inside the window's annotation, which starts at ``w0``. Each
function returns None where it finds nothing to read.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from . import devtrace

TILE_NS = 50_000        # a hole or an overlap a query's tiling may have
QUERY_SPANS = ("mb.submit", "mb.queued")
BATCHER_SPANS = ("mb.slot_wait", "mb.collect", "mb.handoff")


def named(spans: Sequence, name: str) -> List:
    return [s for s in spans if s.name == name]


def batcher_queue_ms(spans: Sequence) -> Optional[float]:
    """Median over the answered queries of ``mb.submit``'s start -> the
    start of the ``mb.call`` that carried the query, ms."""
    calls = {s.id: s for s in named(spans, "mb.call")}
    waits = [calls[s.parent].t0_ns - s.t0_ns
             for s in named(spans, "mb.submit") if s.parent in calls]
    return statistics.median(waits) / 1e6 if waits else None


def batch_fill_pct(spans: Sequence) -> Optional[float]:
    """Real queries over padded rows of the window's calls, %."""
    calls = named(spans, "mb.call")
    padded = sum(s.attrs["padded"] for s in calls)
    if not padded:
        return None
    return 100.0 * sum(s.attrs["n_real"] for s in calls) / padded


def entry_lock_ms(spans: Sequence) -> Optional[float]:
    """Mean wait for the fused entry's lock per call, ms."""
    locks = named(spans, "fused.lock")
    if not locks:
        return None
    return statistics.fmean(s.t1_ns - s.t0_ns for s in locks) / 1e6


def tiling(spans: Sequence, tol_ns: int = TILE_NS) -> Optional[Dict]:
    """Does each answered query's time in ``submit`` split into its
    spans with no hole or overlap over ``tol_ns``: its own entry,
    ``mb.queued``, its part of the call's ``mb.collect``, ``mb.handoff``,
    ``mb.call``, its own return? -> queries, the share that tile, the
    largest miss (us), and the medians of the entry and the return (us:
    the condition's lock, a waiter's wake-up)."""
    by = {n: {s.id: s for s in named(spans, n)}
          for n in ("mb.queued", "mb.collect", "mb.handoff", "mb.call")}
    worst, heads, tails = [], [], []
    for sub in named(spans, "mb.submit"):
        cid = sub.parent
        q = by["mb.queued"].get(sub.id)
        col, hand, call = (by[n].get(cid) for n in
                           ("mb.collect", "mb.handoff", "mb.call"))
        if q is None or col is None or hand is None or call is None:
            continue
        cuts = [sub.t0_ns, q.t0_ns, q.t1_ns, col.t1_ns, hand.t1_ns,
                call.t1_ns, sub.t1_ns]
        ends = [(q.t1_ns, max(q.t1_ns, col.t0_ns)), (col.t1_ns, hand.t0_ns),
                (hand.t1_ns, call.t0_ns)]
        miss = max([abs(a - b) for a, b in ends]
                   + [max(0, a - b) for a, b in zip(cuts, cuts[1:])])
        worst.append(miss)
        heads.append(q.t0_ns - sub.t0_ns)
        tails.append(sub.t1_ns - call.t1_ns)
    if not worst:
        return None
    return dict(queries=len(worst),
                tiled_share=sum(w <= tol_ns for w in worst) / len(worst),
                worst_us=max(worst) / 1e3,
                entry_us_p50=statistics.median(heads) / 1e3,
                return_us_p50=statistics.median(tails) / 1e3,
                return_us_p99=_quantile(tails, 0.99) / 1e3)


def _quantile(xs: Sequence[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


# ---------------------------------------------------------------------
# a traced window


def device_timeline(prof) -> Dict:
    """The traced window's device timeline from a ``torch.profiler``
    trace: ``w0`` / ``w1`` (ns), ``idle`` [(start, end, host ns of the
    runtime call that launched the op ending the gap, or None)],
    ``graph_launches`` (host ns of each ``cudaGraphLaunch``) and
    ``copy_to_launch`` (ns from the end of the ``cudaMemcpyAsync`` before
    each, on its thread: the copy-in, to the launch)."""
    evs = list(prof.profiler.kineto_results.events())
    win = [e for e in evs if e.name() == devtrace.WINDOW
           and not devtrace._is_cuda(e)]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    ops, host_of, launches, copies = [], {}, [], defaultdict(list)
    for e in evs:
        if devtrace._is_cuda(e):
            if e.is_user_annotation() or e.name() == devtrace.WINDOW:
                continue
            s, t = e.start_ns(), e.end_ns()
            if t > w0 and s < w1:
                ops.append((max(s, w0), min(t, w1), e.correlation_id()))
        elif e.correlation_id() and e.name().startswith("cu"):
            # the runtime call (cudaGraphLaunch, cudaMemcpyAsync, ...)
            host_of[e.correlation_id()] = e.start_ns()
            if e.name() == "cudaGraphLaunch" and w0 <= e.start_ns() <= w1:
                launches.append((e.start_ns(), e.start_thread_id()))
            elif e.name() == "cudaMemcpyAsync":
                copies[e.start_thread_id()].append(e.end_ns())
    ops.sort()
    idle, cur = [], w0
    for s, t, corr in ops:
        if s > cur:
            idle.append((cur, s, host_of.get(corr)))
        cur = max(cur, t)
    if cur < w1:
        idle.append((cur, w1, None))
    to_launch = []
    for ends in copies.values():
        ends.sort()
    for t, tid in launches:
        i = bisect.bisect_right(copies[tid], t) - 1
        if i >= 0:
            to_launch.append(t - copies[tid][i])
    return dict(w0=w0, w1=w1, idle=idle,
                graph_launches=sorted(t for t, _ in launches),
                copy_to_launch=to_launch)


def on_trace(spans: Sequence, anchor: float, w0: int) -> List[Tuple]:
    """Spans on the trace's clock: [(name, id, t0, t1, span)]."""
    off = w0 - round(anchor * 1e9)
    return [(s.name, s.id, s.t0_ns + off, s.t1_ns + off, s) for s in spans]


def _call_key(m: Tuple):
    """The call a mapped span belongs to: its id, or its thread where it
    has none (a caller that calls ``retrieve_batch`` itself)."""
    return m[1] if m[1] is not None else ("thread", m[4].thread)


def _innermost(open_: List[Tuple]) -> str:
    return max(open_, key=lambda x: (x[2], -x[3]))[0]


def gap_labels(tl: Dict, spans: Sequence, anchor: float,
               calls: Sequence[Tuple[float, float]]) -> List[Tuple]:
    """Each idle gap of ``tl`` -> (label, seconds), longest first. The
    label is ``devtrace.label_gap``'s ("in a call" / "between calls", by
    the harness's ``calls`` at the gap's middle) and the program span
    that held the call ending the gap there: the innermost open span of
    that call (the call whose last ``fused.launch`` began before the
    runtime call that launched the op ending the gap). Where none of its
    spans was open, the batcher's: a collector span, else ``mb.queued``,
    else ``mb.submit``; with no ``mb.submit`` open, "no query". With no
    spans, the old label."""
    w0 = tl["w0"]
    host = [(w0 + (a - anchor) * 1e9, w0 + (b - anchor) * 1e9)
            for a, b in calls]
    mapped = on_trace(spans, anchor, w0)
    by_call = defaultdict(list)
    for m in mapped:
        if m[0] not in QUERY_SPANS:
            by_call[_call_key(m)].append(m)
    launches = sorted(((m[2], _call_key(m)) for m in mapped
                       if m[0] == "fused.launch"), key=lambda x: x[0])
    starts = [t for t, _ in launches]
    out = []
    for a, b, launched in tl["idle"]:
        label = devtrace.label_gap(a, b, host)
        if mapped:
            label += ": " + _held(mapped, by_call, launches, starts,
                                  (a + b) / 2, launched)
        out.append((label, (b - a) / 1e9))
    out.sort(key=lambda g: -g[1])
    return out


def _held(mapped, by_call, launches, starts, mid, launched) -> str:
    if launched is not None:
        i = bisect.bisect_right(starts, launched) - 1
        if i >= 0:
            open_ = [m for m in by_call[launches[i][1]]
                     if m[2] <= mid < m[3]]
            if open_:
                return _innermost(open_)
    for names in (BATCHER_SPANS, ("mb.queued",), ("mb.submit",)):
        open_ = [m for m in mapped if m[0] in names and m[2] <= mid < m[3]]
        if open_:
            return _innermost(open_)
    return "no query"


def idle_by_label(labels: Sequence[Tuple]) -> Dict[str, float]:
    """Idle seconds by label, largest first."""
    out: Dict[str, float] = defaultdict(float)
    for label, s in labels:
        out[label] += s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def device_idle_queued_pct(tl: Dict, spans: Sequence,
                           anchor: float) -> Optional[float]:
    """Share of the traced window in which no device op ran while some
    query was in ``MicroBatcher.submit``, %."""
    w0, w1 = tl["w0"], tl["w1"]
    subs = _union([(max(t0, w0), min(t1, w1))
                   for n, _, t0, t1, _ in on_trace(spans, anchor, w0)
                   if n == "mb.submit" and t1 > w0 and t0 < w1])
    if not subs or w1 <= w0:
        return None
    both, j = 0.0, 0
    for a, b, _ in tl["idle"]:
        while j < len(subs) and subs[j][1] <= a:
            j += 1
        k = j
        while k < len(subs) and subs[k][0] < b:
            both += min(b, subs[k][1]) - max(a, subs[k][0])
            k += 1
    return 100.0 * both / (w1 - w0)


def launches_in_spans(tl: Dict, spans: Sequence,
                      anchor: float) -> Optional[Dict]:
    """The clock check: each ``cudaGraphLaunch`` of the traced window
    against the program's ``fused.launch`` spans placed by the anchor.
    -> launches, the share inside a span, the median offset of a launch
    from the start of the last span begun before it (us), and the
    launches outside (ns on the trace)."""
    spans_ = sorted((t0, t1) for n, _, t0, t1, _ in
                    on_trace(spans, anchor, tl["w0"]) if n == "fused.launch")
    if not tl["graph_launches"] or not spans_:
        return None
    starts = [a for a, _ in spans_]
    inside, offsets, outside = 0, [], []
    for t in tl["graph_launches"]:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans_[i][1]:
            inside += 1
        else:
            outside.append(t)
        if i >= 0:
            offsets.append(t - spans_[i][0])
    n = len(tl["graph_launches"])
    return dict(launches=n, inside_share=inside / n,
                median_offset_us=(statistics.median(offsets) / 1e3
                                  if offsets else None),
                outside=outside)
