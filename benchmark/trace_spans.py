"""One run of a cell as ``run.py`` makes it, with the program's spans
recorded (``profiling.record_spans``) around the measured window and
around each traced window, and what they say.

    python3 benchmark/trace_spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--out FILE] [--record 0]

``run.py``'s result line comes first, as it prints it; with ``--trace
1`` the idle gaps in its ``breakdown`` carry the program span that held
them (``harness/spans.py``'s ``gap_labels``). Then one JSON line
``{"spans": ...}``: from the measured window ``batcher_queue_ms``,
``batch_fill_pct``, ``entry_lock_ms``, the tiling of each query's time in
``MicroBatcher.submit`` and the harness's latency less that time (the
load generator's and the client threads' share, ms); from the traced
window ``device_idle_queued_pct``, the clock check (``cudaGraphLaunch``
inside ``fused.launch``), the median time from the copy-in's
``cudaMemcpyAsync`` to the ``cudaGraphLaunch`` and the idle time by
label. ``--out`` keeps that line with every gap's label. With ``--trace
0`` the result line is the recorder's cost when on, beside ``--record
0``'s (the same process with the recorder off) with the same seed;
``--on-off N`` measures that cost inside one process (``on_off``).
"""

import run  # first: its clock starts the run's set-up

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import Dict, Iterator  # noqa: E402

import numpy as np  # noqa: E402

import time  # noqa: E402

from harness import devtrace, gen, runner, serve, spec  # noqa: E402
from harness import spans as hs  # noqa: E402


def client_share_ms(rec, submits) -> float:
    """Median over the answered queries of the harness's latency (due ->
    done) less the query's ``mb.submit`` (the one that returned last
    before ``done`` on the thread that took the answer), ms."""
    by_thread = {}
    for s in submits:
        by_thread.setdefault(s.thread, []).append(s)
    for v in by_thread.values():
        v.sort(key=lambda s: s.t1_ns)
    out = []
    for i, tid in rec.thread_of.items():
        done_ns = round(rec.done[i] * 1e9)
        mine = [s for s in by_thread.get(tid, ()) if s.t1_ns <= done_ns]
        if mine and rec.ok[i]:
            s = mine[-1]
            out.append((rec.done[i] - rec.due[i]) * 1e3
                       - (s.t1_ns - s.t0_ns) / 1e6)
    return statistics.median(out) if out else None


@contextlib.contextmanager
def spans_recorded() -> Iterator[Dict]:
    """While open, each window the harness drives runs inside
    ``profiling.record_spans()`` (its recorder appended to
    ``windows``), each traced window's gaps are labelled by its spans
    (``traced``), and ``run_cell``'s result is kept (``out``)."""
    serve.port()        # the program on the path
    from hybrid_rag_colbertv2_tpu_torch.utils import profiling
    state: Dict = dict(windows=[], recorders=[], traced=[], out=None)
    saved = [(serve, "open_loop"), (serve, "closed_loop"),
             (serve.Recorder, "answered"), (devtrace, "reduce_trace"),
             (runner, "run_cell")]
    orig = [getattr(o, n) for o, n in saved]

    def with_spans(fn):
        def wrapped(system, texts, load, rec, **kw):
            with profiling.record_spans() as spans:
                out = fn(system, texts, load, rec, **kw)
            state["windows"].append(spans)
            state["recorders"].append(rec)
            return out
        return wrapped

    def answered(self, i, t, ids, scores, _orig=serve.Recorder.answered):
        self.__dict__.setdefault("thread_of", {})[i] = threading.get_ident()
        _orig(self, i, t, ids, scores)

    def reduce_trace(prof, calls, anchor, _orig=devtrace.reduce_trace):
        red = _orig(prof, calls, anchor)
        tl = hs.device_timeline(prof)
        spans = state["windows"][-1].spans
        labels = hs.gap_labels(tl, spans, anchor, calls)
        red["gaps"] = labels[:10]
        state["traced"].append(dict(tl=tl, spans=spans, anchor=anchor,
                                    labels=labels))
        return red

    def run_cell(*a, _orig=runner.run_cell, **kw):
        state["out"] = _orig(*a, **kw)
        return state["out"]

    for (o, n), f in zip(saved, (with_spans(serve.open_loop),
                                 with_spans(serve.closed_loop), answered,
                                 reduce_trace, run_cell)):
        setattr(o, n, f)
    try:
        yield state
    finally:
        for (o, n), f in zip(saved, orig):
            setattr(o, n, f)


def readings(state: Dict) -> Dict:
    """What the spans of ``spans_recorded``'s measured window (the one
    that filled the run's recorder; set-up's warm load comes first) and
    of its last traced window say."""
    rec = state["out"]["ctx"]["rec"]
    spans = state["windows"][[r is rec for r in
                              state["recorders"]].index(True)].spans
    line = dict(
        batcher_queue_ms=hs.batcher_queue_ms(spans),
        batch_fill_pct=hs.batch_fill_pct(spans),
        entry_lock_ms=hs.entry_lock_ms(spans),
        tiling=hs.tiling(spans),
        client_share_ms=(client_share_ms(rec, hs.named(spans, "mb.submit"))
                         if hasattr(rec, "thread_of") else None),
        n_spans=len(spans))
    if state["traced"]:
        t = state["traced"][-1]
        clock = hs.launches_in_spans(t["tl"], t["spans"], t["anchor"])
        if clock is not None:
            clock["outside"] = len(clock["outside"])
        gaps = t["tl"]["copy_to_launch"]
        line.update(
            device_idle_queued_pct=hs.device_idle_queued_pct(
                t["tl"], t["spans"], t["anchor"]),
            clock=clock, idle_by_label=hs.idle_by_label(t["labels"]),
            copy_to_launch_us_p50=(statistics.median(gaps) / 1e3
                                   if gaps else None),
            longest_gaps=t["labels"][:10])
    return json.loads(json.dumps(line, default=_plain))


def on_off(name: str, seed: int, seconds: float, windows: int,
           device="cuda", bench=None, cell=None, arch=None) -> Dict:
    """The recorder's cost in one process: after one set-up, ``windows``
    open-loop windows of ``seconds`` at the cell's rate, each with its
    own queries and arrivals, the recorder on in the second and third of
    every four (ABBA). -> each window's p50 / p95 (ms) by side, the
    spans of each window with the recorder on, and the on/off ratio of
    their medians less 1."""
    serve.port()        # the program on the path
    from hybrid_rag_colbertv2_tpu_torch.utils import profiling
    t_start = time.perf_counter()
    bench = bench or spec.load_benchmark()
    cell = cell or spec.load_cell(bench, name)
    if cell["load"]["loop"] != "open":
        raise ValueError(f"{name}: on_off runs open-loop cells")
    n = max(1, round(cell["load"]["rate_qps"] * seconds))
    cell, _, _, inputs, system = runner.setup(
        name, seed, device, lambda c: n * windows, t_start, bench, cell, arch)
    pool = inputs.texts[runner.WARM_POOL:]
    top_k = cell["queries"]["top_k"]
    out: Dict = {"on": [], "off": [], "spans": []}
    for w in range(windows):
        texts = pool[w * n:(w + 1) * n]
        rec = serve.Recorder(texts, top_k)
        offs = gen.arrival_offsets(n, seconds, seed, f"on_off.{w}")
        on = w % 4 in (1, 2)
        if on:
            with profiling.record_spans() as spans:
                serve.open_loop(system, texts, offs, rec)
            out["spans"].append(len(spans.spans))
        else:
            serve.open_loop(system, texts, offs, rec)
        lat = np.where(rec.ok, rec.done - rec.due, np.inf) * 1e3
        out["on" if on else "off"].append(
            (runner.percentile(lat, 50), runner.percentile(lat, 95)))
    system.free()
    med = {k: [statistics.median(x[i] for x in out[k]) for i in (0, 1)]
           for k in ("on", "off")}
    out["p50_ratio"] = med["on"][0] / med["off"][0] - 1
    out["p95_ratio"] = med["on"][1] / med["off"][1] - 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    ap.add_argument("--record", type=int, choices=(0, 1), default=1,
                    help="0: the same process with the recorder off")
    ap.add_argument("--on-off", type=int, default=0, metavar="N",
                    help="N windows, the recorder on in every other pair")
    args = ap.parse_args(argv)
    if args.on_off:
        print(json.dumps({"on_off": on_off(args.workload, args.seed,
                                           args.seconds, args.on_off)}),
              flush=True)
        return 0
    run_argv = ["--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace)]
    if not args.record:
        serve.port()
        return run.main(run_argv)
    with spans_recorded() as state:
        rc = run.main(run_argv)
    if rc != 0 or not state["windows"]:
        return rc or 1
    line = readings(state)
    print(json.dumps({"spans": line}), flush=True)
    if args.out:
        all_gaps = state["traced"][-1]["labels"] if state["traced"] else []
        with open(args.out, "w") as f:
            json.dump(dict(line, all_gaps=all_gaps), f)
    return 0


def _plain(x):
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(type(x))


if __name__ == "__main__":
    sys.exit(main())
