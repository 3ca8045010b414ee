"""The load the harness offers: what it starts before the window, and
how the clients share the open loop's schedule."""

import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from conftest import small

from harness import runner, serve


def test_every_client_thread_exists_before_the_first_due_query():
    """The client pool's threads all run once set-up ends, so none is
    started by the window's first bursts (``fault`` is handed the system
    after set-up, before the first query is due)."""
    name = "jina.trec-covid-open"
    bench, cell, arch = small(name, n_docs=600)
    seen = {}

    def count(system):
        seen["clients"] = sum(t.name.startswith("client_")
                              for t in threading.enumerate())
        seen["pool"] = len(system.clients._threads)

    runner.run_cell(name, 5, 0.5, False, "cpu", bench=bench, cell=cell,
                    arch=arch, fault=count)
    want = cell["load"]["clients"]
    assert seen == {"clients": want, "pool": want}


class Batcher:
    """Answers each query at once with ids made from its text, and logs
    every submit: (text, time, thread)."""

    def __init__(self, k):
        self.k, self.log, self.lock = k, [], threading.Lock()

    def submit(self, text, top_k):
        t = time.perf_counter()
        with self.lock:
            self.log.append((text, t, threading.get_ident()))
        base = int(text.split("-")[1]) * 1000
        return np.arange(base, base + self.k), np.ones(self.k, np.float32)


def test_the_clients_send_every_query_once_and_never_early():
    """More clients than cores share one schedule under a switch interval
    of a microsecond: every query is sent once, by one of the clients, no
    earlier than its due time, and answered into its own row."""
    n, k, clients = 3000, 4, 64
    texts = [f"q-{i}" for i in range(n)]
    offsets = np.sort(np.random.default_rng(0).uniform(0, 0.6, n))
    offsets[0] = 0.0
    pool = ThreadPoolExecutor(max_workers=clients,
                              thread_name_prefix="client")
    system = types.SimpleNamespace(
        rec=None, batcher=Batcher(k), clients=pool,
        cell={"queries": {"top_k": k}, "load": {"clients": clients}})
    rec = serve.Recorder(texts, k)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        info = serve.open_loop(system, texts, offsets, rec,
                               t0=time.perf_counter() + 0.02)
    finally:
        sys.setswitchinterval(old)
        pool.shutdown(wait=True)
    sent = system.batcher.log
    assert sorted(t for t, _, _ in sent) == sorted(texts)
    when = {t: s for t, s, _ in sent}
    assert all(when[t] >= rec.due[i] for i, t in enumerate(texts))
    assert rec.ok.all() and info["late_s"] >= 0
    assert (rec.ids[:, 0] == np.arange(n) * 1000).all()
    assert len({th for _, _, th in sent}) > 1
