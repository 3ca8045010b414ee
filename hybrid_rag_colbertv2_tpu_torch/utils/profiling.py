"""Profiling and tracing hooks — port of
``hybrid_rag_colbertv2_tpu/utils/profiling.py``.

(a) ``StageTimer`` (utils/logging.py) gives per-stage wall times; (b)
``trace`` wraps ``torch.profiler`` (CUPTI on the card) so any retrieval
or training call can be traced to a Chrome trace (``chrome://tracing``,
Perfetto); ``annotate`` names a span in it (and an NVTX range on the
card); (c) device memory introspection for index-capacity planning.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from .logging import get_logger

log = get_logger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(trace_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """torch.profiler around a block, CPU and (with a card) CUDA
    activity; the Chrome trace is written to ``trace_dir/trace.json``::

        with profiling.trace("build/trace") as prof:
            retriever.retrieve_batch(queries)
        prof.key_averages()
    """
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))
    log.info("profiler trace written to %s", out / TRACE_FILE)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-span in the trace (``record_function``), and an NVTX
    range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
