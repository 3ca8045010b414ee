"""One run of one cell: set-up, the measured window, with ``trace`` the
traced window and the per-layer readings, then the check against the
plain reference. -> the result line's fields."""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import (compare, devtrace, gen, host, reference, serve, spec,
               yardstick)

WARM_POOL = 512         # queries kept apart for warm-up
CLOSED_POOL = 4096      # queries a closed loop cycles through
TRACE_SECONDS = 2.0     # the traced window, after the measured one
TRACE_ATTEMPTS = 3      # traced windows taken while records are lost
WARM_LOAD_SECONDS = 1.0  # an open cell's own load before its window


def card_info(device) -> Dict:
    """The card's name and power limit (nvidia-smi), beside every share."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": "n/a"}
    name = torch.cuda.get_device_name(dev)
    limit = bus = "not read"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,pci.bus_id",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30)
        limit, bus = [x.strip() for x in out.stdout.split(",")]
    except (OSError, subprocess.SubprocessError, ValueError):
        pass
    _log(host.numa_line(bus))
    return {"name": name, "power_limit": limit}


def calls_line(calls) -> str:
    """The window's calls by padded batch: how many, and the mean ms of
    the whole call and of its ``encode+cascade`` stage (on stderr, to
    tell a slow host or card from a shift in batch sizes)."""
    out = []
    for b in sorted({c["b"] for c in calls}):
        mine = [c for c in calls if c["b"] == b]
        call = np.mean([c["t1"] - c["t0"] for c in mine]) * 1e3
        stage = np.mean([c["cascade_s"] for c in mine]) * 1e3
        out.append(f"B={b}: {len(mine)} x {call:.2f} ms ({stage:.2f} in "
                   "the graph)")
    return "calls " + ", ".join(out)


def blocks_line(lat: np.ndarray, due: np.ndarray, t0: float,
                seconds: float, n: int = 5) -> str:
    """p50 / p95 of the queries due in each of ``n`` equal parts of the
    window (on stderr: a slow start or a drift shows against a run that
    is slow throughout)."""
    part = np.minimum(((due - t0) / seconds * n).astype(int), n - 1)
    return "window by parts (p50 / p95 ms): " + ", ".join(
        f"{percentile(lat[part == i], 50):.2f} / "
        f"{percentile(lat[part == i], 95):.2f}" for i in range(n))


def percentile(x: np.ndarray, q: float) -> float:
    """The q-th percentile (linear), a missing answer (inf) counting as
    slowest; an inf result is reported as the clients' timeout."""
    v = float(np.percentile(x, q)) if x.size else math.inf
    return v if math.isfinite(v) else 120.0e3


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def setup(name: str, seed: int, device, n_queries, t_start: float,
          bench: Optional[Dict] = None, cell: Optional[Dict] = None,
          arch: Optional[Dict] = None):
    """Inputs, weights, the system under test and every shape warmed up.
    ``n_queries(cell)`` is how many queries to make besides the warm-up
    pool. -> (cell, arch, model, inputs, system); ``model`` is the
    configuration's plain reference module."""
    bench = spec.load_benchmark() if bench is None else bench
    cell = spec.load_cell(bench, name) if cell is None else cell
    arch = spec.load_config(bench, cell["config"]) if arch is None else arch
    model = spec.load_model(bench, cell["config"])
    dev = torch.device(device)
    reference.exact_fp32()
    h0 = host.counters()

    def mark(what: str) -> None:
        serve._sync(dev)
        mem = (f"; {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
               f"allocated, {torch.cuda.memory_reserved(dev) / 1e9:.3f} GB "
               f"reserved" if dev.type == "cuda" else "")
        _log(f"[{time.perf_counter() - t_start:7.2f} s] {what}{mem}")

    mark("imports and the card")
    inputs = serve.build_inputs(cell, arch, seed, dev,
                                WARM_POOL + n_queries(cell))
    weights = gen.make_weights(model.param_specs(arch), seed, dev)
    mark(f"inputs {inputs.timings} and weights")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    system = serve.System(cell, arch, inputs, weights, dev)
    del weights
    mark("system (encoder, indexes, retriever, pooled proxies)")
    system.warm(inputs.texts[:WARM_POOL])
    mark(f"warm-up of {len(system.shapes())} shapes, "
         f"{system.captures()} captures")
    if cell["load"]["loop"] == "open":
        n = warm_load(system, inputs.texts[:WARM_POOL], seed)
        mark(f"warm load of {n} queries")
    _log(f"set-up {host.line(host.since(h0))}")
    # the set-up's objects (the harness's inputs and query pools, the
    # program's vocabulary) leave the collector's generations, so a full
    # collection inside the window does not walk them
    gc.collect()
    gc.freeze()
    return cell, arch, model, inputs, system


def warm_load(system, pool, seed: int) -> int:
    """Up to ``WARM_LOAD_SECONDS`` of the cell's own load, unmeasured:
    queries of the warm-up pool sent once more through the served path
    at the cell's rate (arrivals drawn from ``seed``), so that the window
    opens on a batcher, dispatch threads and client threads that have
    served this load, not on their first bursts. -> queries sent."""
    rate = system.cell["load"]["rate_qps"]
    texts = pool[:max(1, min(len(pool), round(rate * WARM_LOAD_SECONDS)))]
    offs = gen.arrival_offsets(len(texts), len(texts) / rate, seed, "warm")
    serve.open_loop(system, texts, offs,
                    serve.Recorder(texts, system.cell["queries"]["top_k"]))
    system.rec = None
    return len(texts)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             bench: Optional[Dict] = None, cell: Optional[Dict] = None,
             arch: Optional[Dict] = None,
             fault: Optional[Callable] = None) -> Dict:
    """``cell`` / ``arch`` replace the cell's and configuration's files
    (tests run small copies); ``fault(system)`` breaks the timed path
    underneath (tests of the check)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)

    def n_queries(c):
        ld = c["load"]
        if ld["loop"] != "open":
            return CLOSED_POOL
        return (max(1, round(ld["rate_qps"] * seconds))
                + (TRACE_ATTEMPTS * max(1, round(ld["rate_qps"]
                                                 * TRACE_SECONDS))
                   if trace else 0))

    cell, arch, model, inputs, system = setup(name, seed, dev, n_queries,
                                              t_start, bench, cell, arch)
    card = card_info(dev)
    load = cell["load"]
    top_k = cell["queries"]["top_k"]
    pool = inputs.texts[WARM_POOL:]
    n_win = max(1, round(load.get("rate_qps", 0) * seconds))
    if fault is not None:
        fault(system)
    caps = system.captures()

    # -- the measured window --------------------------------------------
    if load["loop"] == "open":
        texts = pool[:n_win]
        rec = serve.Recorder(texts, top_k)
        offs = gen.arrival_offsets(n_win, seconds, seed)
        h0 = host.counters()
        t_win = time.perf_counter() + 0.01
        setup_s = t_win - t_start
        info = serve.open_loop(system, texts, offs, rec, t0=t_win)
        lat = np.where(rec.ok, rec.done - rec.due, math.inf) * 1e3
        e2e = {"query_p50_ms": percentile(lat, 50),
               "query_p95_ms": percentile(lat, 95)}
        attempted, failed = n_win, int((~rec.ok).sum())
        _log(f"window: {n_win} queries due over {seconds} s at "
             f"{load['rate_qps']} queries/s, generator late by at most "
             f"{info['late_s'] * 1e3:.3f} ms, {len(rec.calls)} calls, "
             f"{failed} failed; {host.line(host.since(h0))}")
        _log(calls_line(rec.calls))
        _log(blocks_line(lat, rec.due, t_win, seconds))
    else:
        texts = pool[:CLOSED_POOL]
        rec = serve.Recorder(texts, top_k)
        t_win = time.perf_counter()
        setup_s = t_win - t_start
        h0 = host.counters()
        info = serve.closed_loop(system, texts, seconds, rec, t0=t_win)
        served = sum(c["n_real"] for c in rec.calls)
        e2e = {"qps": served / max(info["end"] - info["t0"], 1e-9)}
        attempted, failed = served, 0
        _log(f"window: {len(rec.calls)} calls of {load['batch']} in "
             f"{info['end'] - info['t0']:.3f} s; "
             f"{host.line(host.since(h0))}")
    e2e["setup_s"] = setup_s
    system.rec = None
    if system.captures() != caps:
        raise RuntimeError(f"{system.captures() - caps} graph captures in "
                           "the measured window: a shape was not warmed up")

    # -- the traced window ------------------------------------------------
    ctx = dict(cell=cell, arch=arch, model=model, rec=rec, calls=rec.calls,
               seconds=seconds, peaks=yardstick.peaks_for(card["name"]),
               card=card, index=index_shape(inputs, cell),
               route=cell["retrieval"])
    breakdown = None
    if trace:
        red = traced_window(system, pool[n_win:] if load["loop"] == "open"
                            else texts, cell, seed, launch_counts(system))
        ctx["trace"] = red
        ctx["encoder_ms"] = encoder_ms(system)
        breakdown = devtrace.breakdown(red)
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    system.rec = None

    # -- the check ----------------------------------------------------------
    done = np.nonzero(rec.ok)[0]
    if done.size == 0:
        raise RuntimeError("no query was answered")
    longest = int(done[np.argmax([len(inputs.terms[WARM_POOL + i])
                                  for i in done])])
    pick = compare.sample_indices(done.size, cell["check"]["sample"],
                                  int(np.searchsorted(done, longest)),
                                  gen.np_rng(seed, "check"))
    sample = done[pick]
    served_ids, served_scores = rec.ids[sample], rec.scores[sample]
    s_texts = [texts[i] for i in sample]
    s_terms = [inputs.terms[WARM_POOL + i] for i in sample]
    system.free()
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    values = check(make_reference(cell, arch, model, inputs, seed, dev),
                   s_texts, s_terms, served_ids, served_scores)
    _log(f"reference over {len(sample)} answers: "
         f"{time.perf_counter() - t0:.2f} s")
    limits = cell["check"]["limits"]
    correct = compare.judge(values, limits)
    return dict(correct=correct, attempted=attempted, failed=failed,
                e2e=e2e, ctx=ctx, breakdown=breakdown, card=card,
                memory_peak_bytes=int(mem),
                check=compare.check_lines(values, limits))


def check(ref, texts, terms, served_ids, served_scores) -> Dict[str, float]:
    """The reference's answers to ``texts`` against the served ones."""
    k = served_ids.shape[1]
    q, ids, scores = ref.answers(texts, terms, k)
    return compare.numbers(served_ids, served_scores, ids.numpy(),
                           scores.numpy(), compare.score_fn(ref, q))


def make_reference(cell, arch, model, inputs, seed, dev, precision="fp32",
                   dense=None, encoder=None) -> reference.Reference:
    """The reference over the cell's inputs: the weights and the lexical
    pairs made again from ``seed``, the index rows as generated.
    ``precision`` (the matmuls), ``encoder`` (the encoder's matmuls, else
    ``precision``) and ``dense`` lower it for a control."""
    subs = [reference.SubIndex(s["rows"], s["scales"], s["lengths"],
                               s["doc_len"], s["gid"]) for s in inputs.subs]
    return reference.Reference(
        model, arch, gen.make_weights(model.param_specs(arch), seed, dev),
        subs, inputs.n_docs,
        serve.lexical_pairs(inputs, cell, seed), cell["retrieval"],
        reference.Precision(precision), dense,
        reference.Precision(encoder or precision))


def index_shape(inputs, cell) -> Dict:
    return dict(dim=inputs.subs[0]["rows"].shape[-1],
                k_fuse=min(cell["retrieval"]["fusion_candidates"],
                           inputs.n_docs),
                subs=[dict(n_pad=s["lengths"].shape[0], doc_len=s["doc_len"],
                           valid_rows=s["valid_rows"]) for s in inputs.subs])


def launch_counts(system) -> list:
    """Kernels per replay of each captured shape, each replayed alone
    twice under the profiler (the larger count of the two, should one
    trace lose records)."""
    from torch.profiler import ProfilerActivity, profile
    top_k = system.cell["queries"]["top_k"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in system.warm_batches * 2:
            system.call(batch, top_k, len(batch))
        torch.cuda.synchronize()
    counts = devtrace.launch_kernel_counts(prof)
    n = len(system.warm_batches)
    if len(counts) != 2 * n:
        raise RuntimeError(f"{len(counts)} graph launches traced for "
                           f"{2 * n} calls")
    return [max(a, b) for a, b in zip(counts[:n], counts[n:])]


def traced_window(system, texts, cell, seed, expected) -> Dict:
    """The same load for ``TRACE_SECONDS`` under torch.profiler, taken
    again (up to ``TRACE_ATTEMPTS`` times) while a graph launch in it ran
    fewer or other kernels than every captured shape does (``expected``):
    the trace lost records."""
    from torch.profiler import ProfilerActivity, profile, record_function
    load, secs = cell["load"], TRACE_SECONDS
    top_k = cell["queries"]["top_k"]
    for attempt in range(TRACE_ATTEMPTS):
        if load["loop"] == "open":
            n = max(1, round(load["rate_qps"] * secs))
            part = texts[attempt * n:(attempt + 1) * n]
            rec = serve.Recorder(part, top_k)
            offs = gen.arrival_offsets(n, secs, seed, f"trace.{attempt}")
        else:
            rec = serve.Recorder(texts, top_k)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(devtrace.WINDOW):
                anchor = time.perf_counter()
                if load["loop"] == "open":
                    serve.open_loop(system, part, offs, rec)
                else:
                    serve.closed_loop(system, texts, secs, rec)
            torch.cuda.synchronize()
        red = devtrace.reduce_trace(prof, [(c["t0"], c["t1"])
                                           for c in rec.calls], anchor)
        red["recorder"] = rec
        _log(f"trace attempt {attempt + 1}: {len(rec.calls)} calls, "
             f"{len(red['launches'])} graph launches, busy "
             f"{red['busy_s']:.4f} of {red['window_s']:.4f} s; kernels per "
             f"launch {sorted(set(red['launches']))}, per shape {expected}")
        if devtrace.launches_consistent(red, expected):
            return red
    raise RuntimeError("the traced window lost records on every attempt")


def encoder_ms(system, reps: int = 50) -> float:
    """ms per replay of the query encoder alone, captured as its own
    graph at B = 16, Lq = 32 (CUDA events over ``reps`` replays)."""
    enc = system.encoder
    texts = system.inputs.texts[:16]
    lq = system.arch["query_maxlen"]
    ids = torch.as_tensor(np.stack([enc.tokenizer.encode_query(t, lq)
                                    for t in texts]),
                          device=system.device).long()
    mask = torch.ones_like(ids)
    model = enc.model
    side = torch.cuda.Stream(system.device)
    side.wait_stream(torch.cuda.current_stream(system.device))
    with torch.cuda.stream(side), torch.inference_mode():
        model(ids, mask)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side), torch.inference_mode():
        model(ids, mask)
    torch.cuda.current_stream(system.device).wait_stream(side)
    for _ in range(3):
        graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize(system.device)
    ms = a.elapsed_time(b) / reps
    del graph
    return ms
