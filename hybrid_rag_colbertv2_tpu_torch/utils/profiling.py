"""Profiling and tracing hooks — port of
``hybrid_rag_colbertv2_tpu/utils/profiling.py``.

(a) Spans: ``annotate(name)`` marks a span of host work. Inside
``record_spans()`` it is recorded into the process's one
``SpanRecorder``; inside ``trace`` it is also a ``record_function`` in
the profiler's trace and an NVTX range on the card; with neither active
it costs one global read. ``StageTimer.stage`` (utils/logging.py), the
micro-batcher (app/server.py), ``HybridRetriever.retrieve_batch`` and
the fused entry (retrieval/cascade.py) name their spans through it. (b)
``trace`` wraps ``torch.profiler`` (CUPTI on the card) so any retrieval
or training call can be traced to a Chrome trace (``chrome://tracing``,
Perfetto). (c) Device memory introspection for index-capacity planning.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

TRACE_FILE = "trace.json"


class Span(NamedTuple):
    """One span on ``time.perf_counter_ns``'s clock. ``id`` is the work
    it belongs to: a query's id for a query's spans, the call's id for a
    batch's spans and every span nested in them; ``parent`` is the id of
    the call that carried a query (None where there is none)."""

    name: str
    id: Optional[int]
    parent: Optional[int]
    thread: int
    t0_ns: int
    t1_ns: int
    attrs: Dict


class SpanRecorder:
    """Spans in memory, appended from any thread. Each is kept as a plain
    tuple (``attrs`` None where empty), which the garbage collector stops
    tracking, so a long window's spans add nothing to its passes."""

    def __init__(self) -> None:
        self._raw: List[tuple] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    @property
    def spans(self) -> List[Span]:
        return [Span(n, i, p, th, t0, t1, a or {})
                for n, i, p, th, t0, t1, a in self._raw]

    def new_id(self) -> int:
        return next(self._ids)

    def add(self, name: str, id: Optional[int], parent: Optional[int],
            t0_ns: int, t1_ns: int, **attrs) -> None:
        """A span whose ends the caller took (``time.perf_counter_ns``)."""
        self._raw.append((name, id, parent, threading.get_ident(), t0_ns,
                          t1_ns, attrs or None))

    def _open(self) -> List["_Annotation"]:
        """This thread's open ``annotate`` spans, innermost last."""
        try:
            return self._local.open
        except AttributeError:
            self._local.open = []
            return self._local.open


# (the recorder or None, inside ``trace``) while either is on, else None:
# the one global ``annotate`` reads
_ON: Optional[Tuple[Optional[SpanRecorder], bool]] = None
_tracing = 0            # ``trace`` blocks open
_state_lock = threading.Lock()


def _set(rec: Optional[SpanRecorder], tracing: int) -> None:
    global _ON, _tracing
    _tracing = tracing
    _ON = (rec, tracing > 0) if rec is not None or tracing else None


def recorder() -> Optional[SpanRecorder]:
    """The active ``SpanRecorder``, or None."""
    on = _ON
    return None if on is None else on[0]


@contextlib.contextmanager
def record_spans() -> Iterator[SpanRecorder]:
    """Record the process's spans into a new ``SpanRecorder`` while the
    block runs; they stay in its ``spans`` after it. One at a time::

        with profiling.record_spans() as rec:
            batcher.submit("a query")
        rec.spans
    """
    rec = SpanRecorder()
    with _state_lock:
        if recorder() is not None:
            raise RuntimeError("spans are already being recorded")
        _set(rec, _tracing)
    try:
        yield rec
    finally:
        with _state_lock:
            _set(None, _tracing)


@contextlib.contextmanager
def trace(trace_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """torch.profiler around a block, CPU and (with a card) CUDA
    activity, with the block's ``annotate`` spans in it; the Chrome trace
    is written to ``trace_dir/trace.json``::

        with profiling.trace("build/trace") as prof:
            retriever.retrieve_batch(queries)
        prof.key_averages()
    """
    from .logging import get_logger
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with _state_lock:
            _set(recorder(), _tracing + 1)
        try:
            yield prof
        finally:
            with _state_lock:
                _set(recorder(), _tracing - 1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))
    get_logger(__name__).info("profiler trace written to %s",
                              out / TRACE_FILE)


class _Annotation:
    """An ``annotate`` span while spans are recorded or traced."""

    __slots__ = ("rec", "tracing", "name", "id", "parent", "attrs", "t0",
                 "fn")

    def __init__(self, rec, tracing, name, id, parent, attrs):
        self.rec, self.tracing, self.name = rec, tracing, name
        self.id, self.parent, self.attrs = id, parent, attrs
        self.t0 = 0

    def __enter__(self) -> "_Annotation":
        if self.tracing:
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(self.name)
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        if self.rec is not None:
            stack = self.rec._open()
            if stack and self.id is None:
                self.id, self.parent = stack[-1].id, stack[-1].parent
            stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.rec is not None:
            t1 = time.perf_counter_ns()
            self.rec._open().pop()
            self.rec._raw.append((self.name, self.id, self.parent,
                                  threading.get_ident(), self.t0, t1,
                                  self.attrs or None))
        if self.tracing:
            self.fn.__exit__(*exc)
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_pop()


_OFF = contextlib.nullcontext()


def annotate(name: str, id: Optional[int] = None,
             parent: Optional[int] = None, **attrs):
    """A span of the block: recorded inside ``record_spans`` (``id`` and
    ``parent`` default to the enclosing span's on this thread; ``attrs``
    are kept with it), a ``record_function`` and an NVTX range inside
    ``trace``; otherwise nothing. ``with annotate(...) as a``: ``a`` is
    None when off, else ``a.t0`` is the span's start."""
    on = _ON
    if on is None:
        return _OFF
    return _Annotation(on[0], on[1], name, id, parent, attrs)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per visible CUDA device: bytes the caching allocator has handed out
    (``bytes_in_use``) and the card's total memory (``bytes_limit``);
    empty without a card."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory),
        }
    return out


def index_capacity_estimate(n_docs: int, doc_len: int, dim: int = 128,
                            dtype_bytes: int = 1,
                            n_devices: Optional[int] = None) -> Dict:
    """How much device memory an index needs and whether it fits the
    devices: the JAX formula and its 80% margin (as ``config.py``'s
    ``auto`` sizing); ``fits`` is None where no device reports a limit
    (the CPU). ``n_devices`` defaults to the visible cards (1 without)."""
    n_devices = n_devices or max(1, torch.cuda.device_count())
    emb = n_docs * doc_len * dim * dtype_bytes
    scales = n_docs * doc_len * 4 if dtype_bytes == 1 else 0
    total = emb + scales + n_docs * 4
    mem = device_memory_stats()
    limits = [v["bytes_limit"] for v in mem.values() if v["bytes_limit"] > 0]
    per_device = total / n_devices
    return {
        "index_bytes": total,
        "per_device_bytes": int(per_device),
        "devices": n_devices,
        "fits": (per_device < min(limits) * 0.8) if limits else None,
    }
