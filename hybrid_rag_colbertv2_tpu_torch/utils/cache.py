"""Small bounded LRU for compiled-function caches — the port's copy of
``hybrid_rag_colbertv2_tpu/utils/cache.py``.

The fused cascade (retrieval/cascade.py) keeps one entry per distinct
``top_k_final`` and binding, and each entry holds CUDA graphs and the
device tensors they read. A serving process probing many k values would
otherwise grow one entry per k forever; the LRU keeps the common ks hot
and evicts the rest, and dropping an entry releases its graphs.

Thread safety: the module-wide cache is hit from concurrent serving
threads. ``get_or_build`` holds a lock around the map but runs ``build()``
OUTSIDE it, with a per-key in-flight event, so a second thread asking for
the same key waits for the first build instead of duplicating it, while
builds for different keys proceed concurrently.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable


class JitCache:
    """Bounded key -> compiled-fn map with LRU eviction.

    ``get_or_build(key, build)`` returns the cached value for ``key`` or
    builds, caches, and returns a new one, evicting the least recently
    used entry beyond ``max_entries``.
    """

    def __init__(self, max_entries: int = 8):
        assert max_entries >= 1
        self.max_entries = max_entries
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._inflight: Dict[Hashable, threading.Event] = {}
        self.builds = 0      # observability: how many builds happened

    def get_or_build(self, key: Hashable, build: Callable):
        while True:
            with self._lock:
                if key in self._d:
                    self._d.move_to_end(key)
                    return self._d[key]
                ev = self._inflight.get(key)
                if ev is None:
                    # we own the build for this key
                    ev = self._inflight[key] = threading.Event()
                    break
            # another thread is building this key — wait, then re-check
            # (that build may have failed, in which case we take over)
            ev.wait()
        try:
            fn = build()
        except BaseException:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()
            raise
        with self._lock:
            self.builds += 1
            self._d[key] = fn
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)
            self._inflight.pop(key, None)
        ev.set()
        return fn

    def drop_where(self, pred: Callable[[Hashable, Any], bool]) -> int:
        """Drop every entry for which ``pred(key, value)`` is true (the
        retriever's rebind evicts the entries bound to a replaced
        index). -> the number dropped."""
        with self._lock:
            stale = [k for k, v in self._d.items() if pred(k, v)]
            # released after the lock, when this list goes
            dropped = [self._d.pop(k) for k in stale]
        return len(dropped)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d
