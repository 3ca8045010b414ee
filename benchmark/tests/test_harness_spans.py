"""The readings of the program's spans on hand-made spans and a hand-made
trace, with known answers; and ``trace_spans.py``'s path on a small CPU
cell."""

import pytest
from conftest import small
from test_harness_devtrace import Ev, trace

import trace_spans
from harness import devtrace, runner
from harness import spans as hs
from hybrid_rag_colbertv2_tpu_torch.utils.profiling import Span

MS = 1_000_000
T0 = 1_000_000_000          # the anchor, 1.0 s on perf_counter_ns


def sp(name, id_, t0_ms, t1_ms, parent=None, thread=1, **attrs):
    return Span(name, id_, parent, thread, T0 + round(t0_ms * MS),
                T0 + round(t1_ms * MS), attrs)


def two_calls():
    """Call 1 launches at 9 ms, call 2 at 59 ms (``trace()``'s two
    ``cudaGraphLaunch``); one query each."""
    return [
        sp("mb.submit", 11, 2, 46, parent=1, thread=7),
        sp("mb.queued", 11, 2.1, 4, parent=1),
        sp("mb.call", 1, 5, 45, thread=2, n_real=1, padded=1),
        sp("tokenize", 1, 5, 8, thread=2),
        sp("fused.lock", 1, 8, 8.5, thread=2),
        sp("fused.launch", 1, 8.5, 10.5, thread=2),
        sp("fused.sync", 1, 10.5, 40, thread=2),
        sp("fused.copy_out", 1, 40, 45, thread=2),
        sp("mb.submit", 12, 41, 76, parent=2, thread=8),
        sp("mb.queued", 12, 41, 41, parent=2),
        sp("mb.collect", 2, 41, 50, thread=3, n_real=3, padded=4),
        sp("mb.handoff", 2, 50, 52, thread=3),
        sp("mb.call", 2, 52, 75, thread=4, n_real=3, padded=4),
        sp("tokenize", 2, 52, 58.5, thread=4),
        sp("fused.lock", 2, 58.5, 58.8, thread=4),
        sp("fused.launch", 2, 58.8, 60.5, thread=4),
        sp("fused.sync", 2, 60.5, 70, thread=4),
        sp("fused.copy_out", 2, 70, 75, thread=4),
    ]


CALLS = [(1.005, 1.045), (1.052, 1.075)]


def test_the_readers():
    spans = two_calls()
    assert hs.batcher_queue_ms(spans) == pytest.approx(7.0)   # 3 and 11
    assert hs.batch_fill_pct(spans) == pytest.approx(80.0)    # 4 of 5
    assert hs.entry_lock_ms(spans) == pytest.approx(0.4)      # 0.5, 0.3
    assert hs.batcher_queue_ms([]) is None
    assert hs.batch_fill_pct([]) is None
    assert hs.entry_lock_ms([]) is None


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """The hand-made trace's host events run on one thread."""
    monkeypatch.setattr(Ev, "start_thread_id", lambda self: 1,
                        raising=False)


def test_device_timeline():
    ev = trace()
    tl = hs.device_timeline(ev)
    assert (tl["w0"], tl["w1"]) == (0, 100 * MS)
    assert tl["idle"] == [(0, 10 * MS, 9 * MS), (40 * MS, 60 * MS, 59 * MS),
                          (70 * MS, 100 * MS, None)]
    assert tl["graph_launches"] == [9 * MS, 59 * MS]
    assert tl["copy_to_launch"] == []
    copy = Ev("cudaMemcpyAsync", False, 8 * MS, 8.2 * MS, corr=5)
    events = list(ev.profiler.kineto_results.events()) + [copy]
    tl = hs.device_timeline(type(ev)(events))
    assert tl["copy_to_launch"] == [pytest.approx(0.8 * MS),
                                    pytest.approx(50.8 * MS)]


def test_gap_labels_name_the_span_that_held_the_call():
    tl = hs.device_timeline(trace())
    labels = hs.gap_labels(tl, two_calls(), 1.0, CALLS)
    assert [(lab, round(s, 3)) for lab, s in labels] == [
        ("between calls: no query", 0.03),      # 70-100 ms: nobody asked
        ("between calls: mb.handoff", 0.02),    # call 2 not yet begun
        ("in a call: tokenize", 0.01)]          # call 1 tokenizing
    assert hs.idle_by_label(labels) == {
        "between calls: no query": pytest.approx(0.03),
        "between calls: mb.handoff": pytest.approx(0.02),
        "in a call: tokenize": pytest.approx(0.01)}


def test_gap_labels_fall_back_without_spans():
    tl = hs.device_timeline(trace())
    old = devtrace.reduce_trace(trace(), CALLS, 1.0)["gaps"]
    new = hs.gap_labels(tl, [], 1.0, CALLS)
    assert [(lab, round(s, 6)) for lab, s in new] == \
        [(lab, round(s, 6)) for lab, s in old]


def test_a_gap_inside_a_query_with_no_call_reads_queued():
    tl = dict(w0=0, w1=100 * MS, idle=[(0, 100 * MS, None)],
              graph_launches=[])
    spans = [sp("mb.submit", 1, 10, 90), sp("mb.queued", 1, 10, 80)]
    assert hs.gap_labels(tl, spans, 1.0, []) == [
        ("between calls: mb.queued", 0.1)]
    spans = [sp("mb.submit", 1, 10, 90)]
    assert hs.gap_labels(tl, spans, 1.0, [])[0][0] == \
        "between calls: mb.submit"


def test_device_idle_queued_pct():
    tl = hs.device_timeline(trace())
    # idle 0-10, 40-60, 70-100 ms; a query open 2-76 ms: 8 + 20 + 6 ms
    assert hs.device_idle_queued_pct(tl, two_calls(), 1.0) == \
        pytest.approx(34.0)
    assert hs.device_idle_queued_pct(tl, [], 1.0) is None


def test_the_clock_check_reports_a_launch_outside():
    tl = hs.device_timeline(trace())
    got = hs.launches_in_spans(tl, two_calls(), 1.0)
    assert got["launches"] == 2 and got["inside_share"] == 1.0
    assert got["median_offset_us"] == pytest.approx(350.0)   # 500 and 200
    assert got["outside"] == []
    ev = trace()
    events = list(ev.profiler.kineto_results.events())
    planted = Ev("cudaGraphLaunch", False, 80 * MS, 81 * MS, corr=12)
    tl2 = hs.device_timeline(type(ev)(events + [planted]))
    got = hs.launches_in_spans(tl2, two_calls(), 1.0)
    assert got["launches"] == 3
    assert got["inside_share"] == pytest.approx(2 / 3)
    assert got["outside"] == [80 * MS]
    # the anchor off by 5 ms: the launches leave their spans
    assert hs.launches_in_spans(tl, two_calls(), 1.005)["inside_share"] \
        == 0.0


def test_tiling():
    def query(qid, cid, hole_ms):
        return [sp("mb.submit", qid, 0, 20, parent=cid),
                sp("mb.queued", qid, 0.01, 1, parent=cid),
                sp("mb.collect", cid, 1, 3), sp("mb.handoff", cid, 3, 4),
                sp("mb.call", cid, 4 + hole_ms, 19.99, n_real=1, padded=1)]
    got = hs.tiling(query(1, 1, 0.0) + query(2, 2, 0.1))
    assert got["queries"] == 2 and got["tiled_share"] == 0.5
    assert got["worst_us"] == pytest.approx(100.0)
    assert got["entry_us_p50"] == pytest.approx(10.0)
    assert got["return_us_p50"] == pytest.approx(10.0)
    assert hs.tiling([]) is None


def test_the_probe_on_a_small_cpu_cell():
    name = "colbertv2.msmarco-open"
    bench, cell, arch = small(name, n_docs=300)
    orig = runner.run_cell
    with trace_spans.spans_recorded() as state:
        out = runner.run_cell(name, 3, 1.0, False, "cpu", bench=bench,
                              cell=cell, arch=arch)
    assert runner.run_cell is orig                      # restored
    assert out["correct"] and state["out"] is out
    got = trace_spans.readings(state)
    assert got["tiling"]["queries"] == out["attempted"] - out["failed"]
    assert got["tiling"]["tiled_share"] >= 0.99
    assert 0 < got["batch_fill_pct"] <= 100
    assert got["batcher_queue_ms"] > 0 and got["client_share_ms"] >= 0
    assert got["entry_lock_ms"] is None         # the CPU runs no graph
    names = {s.name for s in state["windows"][0].spans}
    assert {"mb.submit", "mb.queued", "mb.collect", "mb.handoff", "mb.call",
            "retrieve.bind", "tokenize", "encode+cascade"} <= names


def test_on_off_alternates_the_recorder():
    name = "jina.trec-covid-open"
    bench, cell, arch = small(name, n_docs=300)
    got = trace_spans.on_off(name, 5, 0.5, 4, "cpu", bench, cell, arch)
    assert len(got["on"]) == len(got["off"]) == 2
    assert len(got["spans"]) == 2 and min(got["spans"]) > 0
    assert all(0 < p50 <= p95 for p50, p95 in got["on"] + got["off"])
    assert got["p50_ratio"] > -1
