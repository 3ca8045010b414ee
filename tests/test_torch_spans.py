"""The port's spans (``utils/profiling.py``): ``record_spans`` is the one
switch, ``annotate`` the one span site, ``StageTimer`` stages and the
micro-batcher's boundaries are spans, and a query's spans tile its time
in ``MicroBatcher.submit``."""

import json
import threading
import time
from collections import defaultdict

import pytest
import torch

from hybrid_rag_colbertv2_tpu_torch.app.server import MicroBatcher
from hybrid_rag_colbertv2_tpu_torch.utils import profiling
from hybrid_rag_colbertv2_tpu_torch.utils.logging import StageTimer

TOL_NS = 50_000         # a hole or an overlap in a query's tiling


def fake_fn_batch(seen):
    """A ``fn_batch`` that sleeps 5 ms under a stage of its own and
    notes each padded batch it ran."""
    timer = StageTimer()

    def fn_batch(queries, top_k):
        seen.append(list(queries))
        with timer.stage("tokenize"):
            time.sleep(0.005)
        return [[{"q": q, "rank": 1}] for q in queries]
    return fn_batch


def serve(mb, n, stagger_s=0.0015):
    """``n`` distinct queries from their own threads, one every
    ``stagger_s``: -> each query's answer."""
    out = {}
    threads = []
    for i in range(n):
        t = threading.Thread(
            target=lambda i=i: out.update({i: mb.submit(f"query {i}")}))
        t.start()
        threads.append(t)
        time.sleep(stagger_s)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return out


def by_id(spans, name):
    return {s.id: s for s in spans if s.name == name}


def test_batcher_spans_tile_each_query():
    seen = []
    mb = MicroBatcher(fake_fn_batch(seen), max_batch=4, window_s=0.002,
                      inflight=2)
    try:
        with profiling.record_spans() as rec:
            out = serve(mb, 24)
    finally:
        mb.close()
    assert all(out[i][0]["q"] == f"query {i}" for i in range(24))
    submits = [s for s in rec.spans if s.name == "mb.submit"]
    queued = by_id(rec.spans, "mb.queued")
    waits, collects = (by_id(rec.spans, "mb.slot_wait"),
                       by_id(rec.spans, "mb.collect"))
    handoffs, calls = (by_id(rec.spans, "mb.handoff"),
                       by_id(rec.spans, "mb.call"))
    stages = by_id(rec.spans, "tokenize")
    assert len(submits) == 24 and len(queued) == 24
    assert len(calls) == len(seen) == len(collects) == len(handoffs)
    assert set(calls) == set(collects) == set(handoffs) == set(stages) \
        == set(waits)
    for sub in submits:
        q = queued[sub.id]
        cid = sub.parent
        assert q.parent == cid and cid in calls
        col, hand, call = collects[cid], handoffs[cid], calls[cid]
        # the query's pieces, in order: its own entry, queued, its part
        # of the collect window, the hand-off to the pool, the call, its
        # own return
        pieces = [(q.t0_ns, q.t1_ns), (q.t1_ns, col.t1_ns),
                  (hand.t0_ns, hand.t1_ns), (call.t0_ns, call.t1_ns)]
        assert sub.t0_ns <= q.t0_ns and call.t1_ns <= sub.t1_ns
        assert col.t0_ns - TOL_NS <= q.t1_ns <= col.t1_ns
        for (_, end), (start, _) in zip(pieces, pieces[1:]):
            assert abs(start - end) <= TOL_NS, (sub, pieces)
        assert waits[cid].t1_ns <= col.t0_ns
        # a span inside the call carries the call's id, on its thread
        assert stages[cid].thread == call.thread
        assert call.t0_ns <= stages[cid].t0_ns <= stages[cid].t1_ns \
            <= call.t1_ns


def test_batch_fill_inputs_equal_the_batches_run():
    seen = []
    mb = MicroBatcher(fake_fn_batch(seen), max_batch=8, window_s=0.004,
                      inflight=2)
    try:
        with profiling.record_spans() as rec:
            serve(mb, 30, stagger_s=0.0005)
    finally:
        mb.close()
    ran = sorted((b.index(b[-1]) + 1, len(b)) for b in seen)
    calls = [s for s in rec.spans if s.name == "mb.call"]
    got = sorted((s.attrs["n_real"], s.attrs["padded"]) for s in calls)
    assert got == ran
    assert sum(n for n, _ in got) == 30 == mb.requests_served
    collects = sorted((s.attrs["n_real"], s.attrs["padded"])
                      for s in rec.spans if s.name == "mb.collect")
    assert collects == ran
    members = defaultdict(int)
    for s in rec.spans:
        if s.name == "mb.submit":
            members[s.parent] += 1
    assert {c.id: c.attrs["n_real"] for c in calls} == dict(members)


def test_nothing_is_recorded_without_a_recorder():
    assert profiling.recorder() is None
    with profiling.annotate("off", x=1) as a:
        pass
    assert a is None
    seen = []
    timer = StageTimer()
    with profiling.record_spans() as rec:
        with timer.stage("on"):
            pass
    n = len(rec.spans)
    mb = MicroBatcher(fake_fn_batch(seen), max_batch=4, window_s=0.001)
    try:
        serve(mb, 6)
        with timer.stage("after"):
            pass
    finally:
        mb.close()
    assert len(rec.spans) == n == 1
    assert profiling.recorder() is None and len(seen) >= 1
    with profiling.record_spans():
        with pytest.raises(RuntimeError, match="already"):
            with profiling.record_spans():
                pass


def test_stage_timer_stages_are_spans_with_unchanged_dicts():
    timer, plain = StageTimer(), StageTimer()
    out = {}
    with profiling.record_spans() as rec:
        with profiling.annotate("call", id=7):
            for name in ("tokenize", "encode+cascade", "tokenize"):
                with timer.stage(name, out=out):
                    time.sleep(0.001)
    for name in ("tokenize", "encode+cascade", "tokenize"):
        with plain.stage(name, out={}):
            pass
    assert set(timer.timings) == set(plain.timings) == set(out) \
        == {"tokenize", "encode+cascade"}
    assert timer.timings == out
    spans = [s for s in rec.spans if s.name != "call"]
    assert [s.name for s in spans] == ["tokenize", "encode+cascade",
                                       "tokenize"]
    assert all(s.id == 7 for s in spans)
    for name in ("tokenize", "encode+cascade"):
        span_s = sum(s.t1_ns - s.t0_ns for s in spans if s.name == name)
        assert 0 < span_s / 1e9 <= timer.timings[name]
        assert timer.timings[name] - span_s / 1e9 < 5e-3


def test_annotate_lands_in_a_chrome_trace_and_the_recorder(tmp_path):
    with profiling.record_spans() as rec:
        with profiling.trace(tmp_path / "t"):
            with profiling.annotate("both-span", id=3, k=2):
                torch.randn(16, 16).sum()
    events = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
    assert "both-span" in {e.get("name") for e in events["traceEvents"]}
    [span] = rec.spans
    assert (span.name, span.id, span.attrs) == ("both-span", 3, {"k": 2})
    assert profiling.annotate("after") is profiling.annotate("again")
