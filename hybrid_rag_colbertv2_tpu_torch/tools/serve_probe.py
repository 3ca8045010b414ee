"""HTTP serving probe: measured end-to-end QPS/latency through the server —
port of ``hybrid_rag_colbertv2_tpu/tools/serve_probe.py``, against the
port's ``app/server.py`` on ``--device`` (default the card).

The kernel-path numbers (bench.py, tools/stage_probe.py) measure the fused
cascade dispatch; this probe measures what a CLIENT of the HTTP layer
(app/server.py) actually experiences — stdlib HTTP stack + JSON + the
micro-batcher's merge window + retrieval + store text fetch — under real
concurrency. New capability vs the reference, whose only interface is a
terminal REPL (local_rag_complete.py:1189-1227).

For each concurrency level C it runs C client threads issuing sequential
``POST /query`` requests and reports achieved QPS, latency percentiles,
and the micro-batcher's merge efficiency (requests per device dispatch —
the number that shows batching is actually riding one fused call).

    python -m hybrid_rag_colbertv2_tpu_torch.tools.serve_probe \
        [--n-docs 112] [--concurrency 1,4,8,16,32] [--requests 64]
        [--window-ms 2.0] [--max-batch 16] [--inflight 2] [--train-steps 0]
        [--device cuda] [--json]

``--chat`` probes ``POST /chat`` instead: C clients each own a NAMED
session and a mock Ollama sidecar answers ``/api/generate`` after a
fixed artificial latency (``--gen-latency-ms``, default 300 — the
reference reports 1.9 s real generations, README.md:184; a smaller
constant keeps the probe fast while still dominating retrieval). The
number that matters is ``x_serial_ceiling``: achieved QPS divided by
the 1/latency ceiling a single global generation lock would impose —
values ~C show distinct sessions really do generate concurrently
(app/server.py::ChatSessions, VERDICT r3 weak #6).

Corpus: tools/sample_corpus (real markdown through the full app pipeline).
The dense leg is left untrained by default — serving cost does not depend
on weight values, and training is not what this probe measures.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_app(td: str, n_docs: int, train_steps: int,
              ollama_url: str | None = None, device=None):
    from hybrid_rag_colbertv2_tpu_torch.app.application import RAGApplication
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.tools.sample_corpus import write_corpus

    paths = write_corpus(f"{td}/docs", n_docs=n_docs, seed=0)
    cfg = RAGConfig(
        db_path=f"{td}/rag.db", bm25_index_path=f"{td}/idx/bm25",
        colbert_index_path=f"{td}/idx/colbert",
        tokenizer_path=f"{td}/idx/tok.json", images_dir=f"{td}/img",
        min_chunk_size=48, max_chunk_size=96, doc_max_tokens=128,
        encoder_train_steps=train_steps,
        final_fusion="rerank",          # fixed: no gate measurement — the
        # probe measures the serving stack, not retrieval quality
    )
    if ollama_url:
        cfg.ollama_url = ollama_url
    app = RAGApplication(cfg, use_ollama=bool(ollama_url), device=device)
    app.index_documents([str(p) for p in paths])
    app.initialize_chatbot()
    return app


def mock_ollama(latency_ms: float):
    """Threaded mock generation sidecar: /api/tags liveness + a fixed
    artificial latency per /api/generate (must be THREADED — a serial
    sidecar would itself serialize the generations this probe exists to
    show overlapping)."""
    import http.server

    class _H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # noqa: N802
            pass

        def do_GET(self):  # noqa: N802
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b'{"models": []}')

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            time.sleep(latency_ms / 1e3)
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b'{"response": "mock generated answer"}')

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def run_chat_level(url: str, queries: List[str], concurrency: int,
                   n_requests: int) -> Dict:
    """C clients, each owning a NAMED /chat session (distinct sessions
    generate concurrently; one session's turns stay ordered)."""
    lat: List[float] = []
    errs: List[str] = []
    lock = threading.Lock()

    def client(tid: int) -> None:
        for i in range(n_requests):
            q = queries[(tid * n_requests + i) % len(queries)]
            t0 = time.perf_counter()
            try:
                out = _post(url, {"query": q, "session": f"probe-{tid}"})
                ok = bool(out.get("response"))
            except Exception as e:   # noqa: BLE001 — recorded, not raised
                with lock:
                    errs.append(f"{type(e).__name__}: {e}")
                continue
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                if not ok:
                    errs.append("empty response")

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat.sort()
    n = len(lat)
    pct = (lambda p: lat[min(n - 1, int(p * n))] * 1e3) if n else (
        lambda p: float("nan"))
    return {
        "concurrency": concurrency,
        "requests": n,
        "errors": len(errs),
        "qps": round(n / wall, 2) if wall > 0 else 0.0,
        "p50_ms": round(pct(0.50), 2),
        "p95_ms": round(pct(0.95), 2),
        **({"first_error": errs[0]} if errs else {}),
    }


def _post(url: str, payload: Dict, timeout: float = 300.0) -> Dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def run_level(url: str, queries: List[str], concurrency: int,
              n_requests: int) -> Dict:
    """C client threads, each issuing sequential POST /query requests."""
    lat: List[float] = []
    errs: List[str] = []
    lock = threading.Lock()

    def client(tid: int) -> None:
        for i in range(n_requests):
            q = queries[(tid * n_requests + i) % len(queries)]
            t0 = time.perf_counter()
            try:
                out = _post(url, {"query": q})
                ok = bool(out.get("results", []))
            except Exception as e:   # noqa: BLE001 — recorded, not raised
                with lock:
                    errs.append(f"{type(e).__name__}: {e}")
                continue
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                if not ok:
                    errs.append("empty results")

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat.sort()
    n = len(lat)
    pct = (lambda p: lat[min(n - 1, int(p * n))] * 1e3) if n else (
        lambda p: float("nan"))
    return {
        "concurrency": concurrency,
        "requests": n,
        "errors": len(errs),
        "qps": round(n / wall, 1) if wall > 0 else 0.0,
        "p50_ms": round(pct(0.50), 2),
        "p95_ms": round(pct(0.95), 2),
        "p99_ms": round(pct(0.99), 2),
        **({"first_error": errs[0]} if errs else {}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=112)
    ap.add_argument("--concurrency", type=str, default="1,4,8,16,32")
    ap.add_argument("--requests", type=int, default=64,
                    help="requests PER CLIENT THREAD at each level")
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--inflight", type=int, default=2,
                    help="concurrent in-flight batches (double-buffering)")
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--chat", action="store_true",
                    help="probe POST /chat with per-client sessions and "
                         "a mock generation sidecar instead of /query")
    ap.add_argument("--gen-latency-ms", type=float, default=300.0,
                    help="mock sidecar's artificial /api/generate latency")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    from hybrid_rag_colbertv2_tpu_torch.app.server import make_server
    from hybrid_rag_colbertv2_tpu_torch.train.data import pseudo_query_pairs

    mock = None
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        ollama_url = None
        if args.chat:
            mock, ollama_url = mock_ollama(args.gen_latency_ms)
            log(f"mock ollama at {ollama_url} "
                f"({args.gen_latency_ms:.0f} ms/generate)")
        app = build_app(td, args.n_docs, args.train_steps,
                        ollama_url=ollama_url, device=args.device)
        n_chunks = app.store.stats()["chunks"]
        log(f"app built in {time.perf_counter() - t0:.0f}s "
            f"({n_chunks} chunks)")
        corpus = app.store.all_chunk_texts()
        queries = [q for q, _ in pseudo_query_pairs(
            corpus, n_pairs_per_doc=2, seed=7)][:256]

        httpd, batcher = make_server(app, port=0,
                                     max_batch=args.max_batch,
                                     batch_window_s=args.window_ms / 1e3,
                                     inflight=args.inflight)
        srv = threading.Thread(target=httpd.serve_forever, daemon=True)
        srv.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        results = []
        try:
            for c in [int(x) for x in args.concurrency.split(",") if x]:
                if args.chat:
                    row = run_chat_level(f"{base}/chat", queries, c,
                                         args.requests)
                    # QPS relative to the 1/latency ceiling ONE global
                    # generation lock would impose: ~C means distinct
                    # sessions really generate concurrently
                    row["x_serial_ceiling"] = round(
                        row["qps"] / (1e3 / args.gen_latency_ms), 2)
                    results.append(row)
                    log(f"C={c}: {row['qps']} QPS "
                        f"({row['x_serial_ceiling']}x the serialized "
                        f"ceiling), p50 {row['p50_ms']} ms, "
                        f"p95 {row['p95_ms']} ms, {row['errors']} errors")
                    continue
                b0, r0 = batcher.batches_run, batcher.requests_served
                row = run_level(f"{base}/query", queries, c,
                                args.requests)
                db, dr = (batcher.batches_run - b0,
                          batcher.requests_served - r0)
                row["req_per_dispatch"] = round(dr / db, 2) if db else 0.0
                results.append(row)
                log(f"C={c}: {row['qps']} QPS, p50 {row['p50_ms']} ms, "
                    f"p95 {row['p95_ms']} ms, "
                    f"{row['req_per_dispatch']} req/dispatch, "
                    f"{row['errors']} errors")
        finally:
            httpd.shutdown()
            batcher.close()
            httpd.server_close()
            if mock is not None:
                mock.shutdown()
                mock.server_close()
        out = {"chunks": n_chunks,
               "max_batch": args.max_batch,
               "inflight": args.inflight,
               "window_ms": args.window_ms,
               **({"mode": "chat",
                   "gen_latency_ms": args.gen_latency_ms}
                  if args.chat else {}),
               "levels": results}
        if args.as_json:
            print(json.dumps(out))
        else:
            print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
