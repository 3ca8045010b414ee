"""Structured logging + per-stage timing.

The reference instruments every stage with ``time.time()`` brackets and raw
``print`` lines (retrieval stages local_rag_complete.py:901-933, indexing
steps :618-706). Here the same per-stage timing is a reusable ``StageTimer``
that records structured metrics (name -> seconds) instead of scattered
prints; each stage is also a span (``profiling.annotate``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

from . import profiling


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("HRAG_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger


class StageTimer:
    """Accumulates wall-clock timings per named stage.

    Mirrors the reference's per-stage timing surface (BM25s / ColBERT /
    Fusion / Fetch / Rerank lines, local_rag_complete.py:901-933) as
    structured data.
    """

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}
        # the server's double-buffered micro-batcher (app/server.py,
        # inflight=2) runs two retrieve_batch calls concurrently on ONE
        # retriever: the cumulative accumulate must not lose updates
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str, out: Optional[Dict[str, float]] = None
              ) -> Iterator[None]:
        """Time a stage into the cumulative totals, and optionally into
        ``out`` — a caller-local dict that yields a PER-CALL split safe
        under concurrent callers (snapshot()/delta() on the shared
        totals would attribute the other in-flight call's stages to
        this one). The stage is a span of its name."""
        t0 = time.perf_counter()
        try:
            with profiling.annotate(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timings[name] = self.timings.get(name, 0.0) + dt
            if out is not None:
                out[name] = out.get(name, 0.0) + dt

    @property
    def total(self) -> float:
        return sum(self.timings.values())

    def summary(self) -> str:
        lines = [f"  - {k}: {v:.4f}s" for k, v in self.timings.items()]
        lines.append(f"  = total: {self.total:.4f}s")
        return "\n".join(lines)
