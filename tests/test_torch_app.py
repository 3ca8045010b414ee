"""The port's application layer against the JAX package's, on the CPU:
``RAGApplication``, the CLI, the HTTP server and the Ollama client.

The JAX app indexes ``write_corpus(n_docs=6)`` once (``tiny`` encoder,
``encoder_train_steps=0``) and resolves its fusion gate; the port serves
that directory with the tokenizer and ``encoder_params.npz`` JAX wrote,
and the other way round. Ids must be equal; scores within rtol 1e-5,
atol 1e-5 (fp32 sums in other orders). The gate verdict and the index
files each package writes must load in the other without re-measuring.
No test needs the network: the Ollama cases run on a localhost stub.
"""

import base64
import io
import json
import shutil
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.app import cli as jax_cli
from hybrid_rag_colbertv2_tpu.app.application import (
    RAGApplication as JaxApp)
from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.retrieval import gate as jax_gate
from hybrid_rag_colbertv2_tpu.tools.sample_corpus import write_corpus
from hybrid_rag_colbertv2_tpu_torch.app import cli
from hybrid_rag_colbertv2_tpu_torch.app.application import RAGApplication
from hybrid_rag_colbertv2_tpu_torch.app.ollama import OllamaClient
from hybrid_rag_colbertv2_tpu_torch.app.server import (
    ChatSessions, MicroBatcher, make_handler, make_server)
from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
from hybrid_rag_colbertv2_tpu_torch.models.colbert import params_to_jax
from hybrid_rag_colbertv2_tpu_torch.retrieval import gate

QUERIES = ["galaxy telescope observations", "ocean tide current",
           "compiler kernel memory", "court contract verdict"]
RTOL = ATOL = 1e-5


def _kw(root: Path, **over):
    kw = dict(
        db_path=str(root / "rag.db"),
        bm25_index_path=str(root / "idx/bm25"),
        colbert_index_path=str(root / "idx/colbert"),
        tokenizer_path=str(root / "idx/tok.json"),
        images_dir=str(root / "img"),
        min_chunk_size=48, max_chunk_size=96, doc_max_tokens=128,
        encoder_preset="tiny", tokenizer_vocab_size=1024,
        encoder_train_steps=0, gate_queries=40)
    kw.update(over)
    return kw


def _ids(rows):
    return [[r["chunk_id"] for r in b] for b in rows]


def _same_rows(got, want):
    assert _ids(got) == _ids(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([r["score"] for r in g],
                                   [r["score"] for r in w],
                                   rtol=RTOL, atol=ATOL)
        assert [r["text"] for r in g] == [r["text"] for r in w]


def _copy(src: Path, dst: Path, gate_file: bool = True) -> Path:
    shutil.copytree(src / "idx", dst / "idx")
    for f in src.glob("rag.db*"):      # the database and its WAL files
        shutil.copy(f, dst / f.name)
    if not gate_file:
        (dst / "idx/colbert/fusion_gate.json").unlink()
    return dst


def _forbid_gate(monkeypatch, module):
    def boom(*a, **k):
        raise AssertionError("the gate re-measured a persisted verdict")
    monkeypatch.setattr(module, "resolve_final_fusion", boom)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("app")
    docs = write_corpus(root / "docs", n_docs=6, seed=0)
    japp = JaxApp(JaxConfig(**_kw(root)), use_ollama=False)
    out = japp.index_documents([str(p) for p in docs])
    assert out["total_chunks"] >= gate.MIN_GATE_CHUNKS
    japp.initialize_chatbot(use_mesh=False)
    assert japp.fusion_gate.get("queries") == 40
    return root, docs, japp, japp.query_batch(QUERIES)


def _counting_gate(monkeypatch, module):
    calls = []
    real = module.resolve_final_fusion

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(module, "resolve_final_fusion", counted)
    return calls


def test_port_gate_and_ids_equal_jax(world, tmp_path, monkeypatch):
    """The JAX gate picked a ``union`` entry. JAX's loader accepts only
    ``rerank`` and ``rrf`` verdicts, so it re-measures a persisted union
    verdict in every process; the port keeps that rule. Its measurement
    over JAX's index and params equals JAX's, and so do its ids."""
    root, _, japp, want = world
    assert japp.fusion_gate["picked"] == "union"
    _copy(root, tmp_path)
    calls = _counting_gate(monkeypatch, gate)
    app = RAGApplication(RAGConfig(**_kw(tmp_path)), use_ollama=False,
                         device="cpu")
    app.initialize_chatbot()
    assert len(calls) == 1
    assert app.fusion_gate == japp.fusion_gate
    assert (app.config.final_fusion, app.config.fusion_weight_bm25) == (
        japp.config.final_fusion, japp.config.fusion_weight_bm25)
    assert json.loads(app._gate_path().read_text()) == json.loads(
        japp._gate_path().read_text())
    _same_rows(app.query_batch(QUERIES), want)
    single = app.query(QUERIES[0])
    assert [r["chunk_id"] for r in single] == _ids(want)[0]
    assert {"chunk_id", "text", "score", "rank"} <= set(single[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_persisted_verdict_loads_across_packages(writer, world, tmp_path,
                                                 monkeypatch):
    """A pinned BM25 weight restricts the gate to (rerank, w) and
    (rrf, w), verdicts both loaders accept: the file one package writes
    serves the other without re-measuring, with equal details and ids."""
    root, _, _, _ = world
    _copy(root, tmp_path, gate_file=False)
    kw = _kw(tmp_path, fusion_weight_bm25=0.75, fusion_weight_pinned=True)
    make = {"jax": lambda: JaxApp(JaxConfig(**kw), use_ollama=False),
            "port": lambda: RAGApplication(RAGConfig(**kw), use_ollama=False,
                                           device="cpu")}
    first = make[writer]()
    first.initialize_chatbot(use_mesh=False)
    assert first.fusion_gate["picked"] in ("rerank", "rrf")
    other = "port" if writer == "jax" else "jax"
    _forbid_gate(monkeypatch, gate if other == "port" else jax_gate)
    second = make[other]()
    second.initialize_chatbot(use_mesh=False)
    assert second.fusion_gate == first.fusion_gate
    _same_rows(second.query_batch(QUERIES), first.query_batch(QUERIES))


def test_port_built_index_serves_from_jax(world, tmp_path):
    """The port indexes the same documents with JAX's tokenizer and
    encoder params; the JAX app serves the port's directory with the ids
    the port serves, which are the ids JAX serves from its own index."""
    root, docs, japp, _ = world
    (tmp_path / "idx/colbert").mkdir(parents=True)
    shutil.copy(root / "idx/tok.json", tmp_path / "idx/tok.json")
    for f in ("encoder_params.npz", "encoder_config.json"):
        shutil.copy(root / "idx/colbert" / f, tmp_path / "idx/colbert" / f)
    pinned = dict(final_fusion="rrf", fusion_weight_bm25=0.75)
    app = RAGApplication(RAGConfig(**_kw(tmp_path, **pinned)),
                         use_ollama=False, device="cpu")
    out = app.index_documents([str(p) for p in docs])
    assert out["total_chunks"] == japp.store.stats()["chunks"]
    app.initialize_chatbot()
    got = app.query_batch(QUERIES)
    japp2 = JaxApp(JaxConfig(**_kw(tmp_path, **pinned)), use_ollama=False)
    japp2.initialize_chatbot(use_mesh=False)
    _same_rows(japp2.query_batch(QUERIES), got)
    japp3 = JaxApp(JaxConfig(**_kw(root, **pinned)), use_ollama=False)
    japp3.initialize_chatbot(use_mesh=False)
    _same_rows(japp3.query_batch(QUERIES), got)


def test_port_trained_params_load_in_jax(world, tmp_path):
    """A 2-step trained port index: ``encoder_params.npz`` loads in the
    JAX app (the same arrays), ``encoder_trained.json`` has JAX's keys,
    and the JAX app serves the port's ids from it."""
    root, docs, japp, _ = world
    kw = _kw(tmp_path, encoder_train_steps=2, final_fusion="rrf",
             fusion_weight_bm25=0.75)
    app = RAGApplication(RAGConfig(**kw), use_ollama=False, device="cpu")
    app.index_documents([str(p) for p in docs])
    marker = json.loads((tmp_path / "idx/colbert/encoder_trained.json")
                        .read_text())
    assert set(marker) == {"steps", "pairs", "final_loss", "chunks"}
    assert marker["steps"] == 2
    app.initialize_chatbot()
    got = app.query_batch(QUERIES)
    japp2 = JaxApp(JaxConfig(**kw), use_ollama=False)
    japp2.initialize_chatbot(use_mesh=False)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(japp2.encoder.params)
    mine = params_to_jax(app.encoder.model)
    assert set(flat) == set(mine)
    for k, v in mine.items():
        np.testing.assert_array_equal(flat[k], v)
    _same_rows(japp2.query_batch(QUERIES), got)
    # the marker stops JAX's auto mode from training this index again
    corpus = japp2.store.all_chunk_texts()
    assert len(corpus) >= JaxApp.MIN_AUTO_TRAIN_CHUNKS
    auto = JaxApp(JaxConfig(**dict(kw, encoder_train_steps=-1)),
                  use_ollama=False)
    assert not auto._should_train(corpus)
    port_auto = RAGApplication(RAGConfig(**dict(kw, encoder_train_steps=-1)),
                               use_ollama=False, device="cpu")
    assert not port_auto._should_train(corpus)
    (tmp_path / "idx/colbert/encoder_trained.json").unlink()
    assert auto._should_train(corpus) and port_auto._should_train(corpus)


def test_upload_outputs_and_incremental_path(world, tmp_path, monkeypatch):
    """``index_documents``' result dict has JAX's keys; a no-op upload
    keeps the verdict; a second upload appends (the incremental path) and
    drops it, and the bound retriever re-measures at its rebind;
    ``convert_index`` requantizes and re-measures likewise."""
    root, docs, japp, _ = world
    calls = _counting_gate(monkeypatch, gate)
    app = RAGApplication(RAGConfig(**_kw(tmp_path)), use_ollama=False,
                         device="cpu")
    out = app.index_documents([str(p) for p in docs[:4]])
    assert set(out) == {"documents", "total_chunks", "timings"}
    assert set(out["documents"][0]) == {"path", "document_id", "chunks"}
    n4 = out["total_chunks"]
    app.initialize_chatbot()
    assert len(calls) == 1
    gp = app._gate_path()
    saved = gp.read_text()
    app.index_documents([])
    assert gp.read_text() == saved and len(calls) == 1
    out = app.index_documents([str(p) for p in docs[4:]])
    assert out["total_chunks"] > n4 and "colbert_append" in out["timings"]
    assert len(calls) == 2
    assert json.loads(gp.read_text())["n_chunks"] == out["total_chunks"]
    assert app.retriever.indexes.dense.n_docs == out["total_chunks"]
    res = app.convert_index("int8-doc")
    assert res == {"from": "int8", "to": "int8-doc",
                   "docs": out["total_chunks"]}
    assert len(calls) == 3
    assert app.indexes.dense.quant == "int8-doc"
    assert app.query(QUERIES[1])


def test_chat_and_stats(world, tmp_path):
    root, _, japp, _ = world
    _copy(root, tmp_path)
    app = RAGApplication(RAGConfig(**_kw(tmp_path)), use_ollama=False,
                         device="cpu")
    app.initialize_chatbot()
    out = app.chat("what do telescopes observe?", generate=False)
    assert out["response"] == "" and out["retrieved_chunks"] >= 1
    assert out["sources"][0]["source_id"] == 1
    assert set(out) == set(japp.chat("what do telescopes observe?",
                                      generate=False))
    app.chat("and the ocean?", generate=False)
    assert len(app.chatbot.conversation_history) == 4
    s = app.stats()
    assert set(s) == set(japp.stats())
    assert s["devices"] == ["cpu"] and s["indexes_built"] is True


def test_unported_parts_raise(tmp_path, monkeypatch):
    # an encoder_checkpoint is ported (models/convert.py): a directory
    # without the checkpoint's tokenizer.json raises as JAX's app does
    cfg = RAGConfig(**_kw(tmp_path, encoder_checkpoint=str(tmp_path)))
    app = RAGApplication(cfg, use_ollama=False, device="cpu")
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        app._make_encoder(["some text"])
    # sharded serving is ported (parallel/): on a CUDA device without a
    # card the mesh's device query raises, as every entry point does
    app.config.final_fusion = "rrf"
    app.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app._bind_retriever(use_mesh=True)


def test_sharded_app_equals_jax_sharded_app(world, tmp_path, monkeypatch):
    """With 8 visible devices (``[cpu] * 8``) the port's app binds the
    sharded adapter, as JAX's does over the conftest's 8 devices, and
    ``query_batch`` returns the JAX sharded app's rows."""
    from hybrid_rag_colbertv2_tpu_torch.app.application import (
        _ShardedAdapter)
    from hybrid_rag_colbertv2_tpu_torch.parallel import mesh as pmesh
    from hybrid_rag_colbertv2_tpu_torch.parallel.sharded import (
        ShardedRetriever)
    root, _, japp, _ = world
    pinned = dict(final_fusion=japp.config.final_fusion,
                  fusion_weight_bm25=japp.config.fusion_weight_bm25)
    jroot = _copy(root, tmp_path / "jax")
    jsh = JaxApp(JaxConfig(**_kw(jroot, **pinned)), use_ollama=False)
    jsh.initialize_chatbot()
    assert type(jsh.retriever).__name__ == "_ShardedAdapter"
    want = jsh.query_batch(QUERIES)
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    proot = _copy(root, tmp_path / "port")
    app = RAGApplication(RAGConfig(**_kw(proot, **pinned)),
                         use_ollama=False, device="cpu")
    app.initialize_chatbot()
    assert isinstance(app.retriever, _ShardedAdapter)
    assert isinstance(app.retriever._r, ShardedRetriever)
    assert app.retriever._r.mesh.shape == {"data": 8, "model": 1}
    _same_rows(app.query_batch(QUERIES), want)
    single = app.query(QUERIES[0])
    assert [r["chunk_id"] for r in single] == _ids(want)[0]
    assert set(app.stats()["last_query_timings"]) == {"tokenize", "cascade"}


def test_default_mesh_keeps_one_card_while_the_index_fits(world, tmp_path,
                                                          monkeypatch):
    """``use_mesh=None`` on the card keeps the single-device CUDA graph
    while the dense index fits under 80% of the card's memory, and
    shards once it does not; on the CPU it shards whenever several
    devices are visible (JAX's rule)."""
    root, _, japp, _ = world
    pinned = dict(final_fusion=japp.config.final_fusion,
                  fusion_weight_bm25=japp.config.fusion_weight_bm25)
    app = RAGApplication(RAGConfig(**_kw(_copy(root, tmp_path), **pinned)),
                         use_ollama=False, device="cpu")
    app.initialize_chatbot(use_mesh=False)
    assert not app._index_fits_card()
    need = app.indexes.dense.memory_bytes()
    app.device = torch.device("cuda", 0)
    for total, fits in ((2 * need, True), (need, False)):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device=None, t=total: (0, t))
        assert app._index_fits_card() is fits


def _run_cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_query_json_equals_jax(world, tmp_path):
    root, _, _, _ = world
    cfg_path = tmp_path / "cfg.json"
    RAGConfig(**_kw(root)).save(cfg_path)
    argv = ["--config", str(cfg_path), "--query", QUERIES[2], "--json",
            "--no-generate"]
    rc, out = _run_cli(cli.main, argv + ["--device", "cpu"])
    assert rc == 0
    rc_j, out_j = _run_cli(jax_cli.main, argv)
    assert rc_j == 0
    got, want = json.loads(out), json.loads(out_j)
    assert [r["chunk_id"] for r in got] == [r["chunk_id"] for r in want]
    assert [r["text"] for r in got] == [r["text"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want],
                               rtol=RTOL, atol=ATOL)


def test_cli_upload_then_query(world, tmp_path):
    _, docs, _, _ = world
    cfg_path = tmp_path / "cfg.json"
    RAGConfig(**_kw(tmp_path)).save(cfg_path)
    base = ["--config", str(cfg_path), "--device", "cpu", "--no-generate",
            "--json"]
    rc, out = _run_cli(cli.main, base + ["--upload", str(docs[0]),
                                         "--upload", str(docs[1])])
    assert rc == 0
    up = json.loads(out)
    assert len(up["documents"]) == 2 and up["total_chunks"] > 0
    rc, out = _run_cli(cli.main, base + ["--query", "galaxy", "--top-k",
                                         "3"])
    rows = json.loads(out)
    assert rc == 0 and [r["rank"] for r in rows] == [1, 2, 3]
    rc, out = _run_cli(cli.main, base + ["--stats"])
    assert rc == 0 and json.loads(out)["chunks"] == up["total_chunks"]


@pytest.mark.parametrize("flag", [["--eval", "4"]])
def test_cli_unported_flags_exit_naming_the_item(flag, tmp_path, capsys):
    """``--eval`` is ported (tools/eval_recall.py): on an empty store it
    runs and fails on what is missing, not on ROADMAP's item 9
    (tests/test_torch_tools.py runs it on an indexed corpus).
    ``--bench`` is ported too (test_cli_bench_runs_the_port_bench)."""
    cfg_path = tmp_path / "cfg.json"
    RAGConfig(**_kw(tmp_path)).save(cfg_path)
    assert cli.main(["--config", str(cfg_path), "--device", "cpu"]
                    + flag) == 2
    err = capsys.readouterr().err
    assert "item 9" not in err and "nothing indexed" in err


def test_cli_bench_runs_the_port_bench(monkeypatch, capfd):
    """``--bench`` spawns the port's bench on ``--device`` as the JAX CLI
    spawns bench.py, with the switches from the environment, and returns
    its exit code; its last stdout line is the bench's JSON line."""
    for env in ("RECALL", "1M", "2M", "REALDATA", "PRETRAINED", "ORGANIC"):
        monkeypatch.setenv(f"HRAG_BENCH_{env}", "0")
    assert cli.main(["--bench", "--device", "cpu"]) == 0
    cap = capfd.readouterr()
    res = json.loads(cap.out.strip().splitlines()[-1])
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert "(cpu)" in res["metric"] and res["value"] > 0
    assert "recall pass disabled via HRAG_BENCH_RECALL=0" in cap.err


def test_demo_finds_the_uploaded_chunk(monkeypatch, tmp_path, capsys):
    """The port's quickstart (examples/demo.py) on the CPU: two documents
    indexed, three queries, a third document uploaded incrementally and
    retrieved."""
    import tempfile

    from hybrid_rag_colbertv2_tpu_torch.examples import demo

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    hit = demo.main("cpu")
    assert "XLA compiles" in hit["text"] and 1 <= hit["rank"] <= 5
    out = capsys.readouterr().out
    assert out.count("\nQ: ") == 3
    assert f"new chunk {hit['chunk_id']} retrievable" in out


# -- server (mirrors tests/test_server.py) ------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def server(world, tmp_path_factory):
    root, _, _, _ = world
    d = _copy(root, tmp_path_factory.mktemp("srv"))
    app = RAGApplication(RAGConfig(**_kw(d)), use_ollama=False,
                         device="cpu")
    app.initialize_chatbot()
    httpd, batcher = make_server(app, port=0, max_batch=4,
                                 batch_window_s=0.005)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield app, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    batcher.close()
    httpd.server_close()


def test_server_health_and_stats(server):
    app, url = server
    code, body = _get(url + "/health")
    assert code == 200 and body == {"status": "ok", "ollama": False}
    code, body = _get(url + "/stats")
    assert code == 200 and body["chunks"] == app.stats()["chunks"]


def test_server_query_equals_app(server):
    app, url = server
    code, body = _post(url + "/query", {"query": QUERIES[0], "top_k": 5})
    assert code == 200
    assert [r["chunk_id"] for r in body["results"]] == \
        [r["chunk_id"] for r in app.query(QUERIES[0], 5)]


def test_server_chat_and_bad_requests(server):
    _, url = server
    code, body = _post(url + "/chat", {"query": "what is a tide?",
                                       "generate": False, "session": "s1"})
    assert code == 200 and body["response"] == "" and body["sources"]
    assert _post(url + "/query", {"nope": 1})[0] == 400
    assert _post(url + "/query", {"query": "   "})[0] == 400
    assert _post(url + "/elsewhere", {"query": "x"})[0] == 404
    assert _get(url + "/nothing")[0] == 404


def test_server_query_under_concurrency(server):
    _, url = server
    outs = {}

    def worker(i):
        outs[i] = _post(url + "/query", {"query": QUERIES[i], "top_k": 1})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(outs[i][0] == 200 and outs[i][1]["results"][0]["rank"] == 1
               for i in range(4))


def test_handler_without_batcher(server):
    app, _ = server
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, body = _post(f"http://127.0.0.1:{httpd.server_address[1]}"
                           "/query", {"query": QUERIES[3], "top_k": 3})
        assert code == 200 and len(body["results"]) == 3
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_microbatcher_merges_and_propagates_errors():
    calls = []

    def fn_batch(queries, top_k):
        calls.append(list(queries))
        if queries[0] == "boom":
            raise ValueError("kernel exploded")
        time.sleep(0.01)
        return [[{"chunk_id": j, "q": q, "rank": j + 1}
                 for j in range(top_k or 5)] for q in queries]

    mb = MicroBatcher(fn_batch, max_batch=8, window_s=0.05)
    try:
        results = {}
        threads = [threading.Thread(
            target=lambda i=i: results.update({i: mb.submit(f"query {i}")}))
            for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(results[i][0]["q"] == f"query {i}" for i in range(6))
        assert mb.batches_run < 6 and mb.requests_served == 6
        assert all(len(c) in (1, 2, 4, 8) for c in calls), calls
        assert len(mb.submit("fine", top_k=2)) == 2
        with pytest.raises(ValueError, match="kernel exploded"):
            mb.submit("boom")
        assert len(mb.submit("fine again", top_k=1)) == 1
    finally:
        mb.close()


def test_microbatcher_double_buffers():
    lock = threading.Lock()
    active, peak = [0], [0]

    def fn_batch(queries, top_k):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.05)
        with lock:
            active[0] -= 1
        return [[{"chunk_id": i, "rank": 1}] for i, _ in enumerate(queries)]

    for inflight, want in ((2, 2), (1, 1)):
        peak[0] = 0
        mb = MicroBatcher(fn_batch, max_batch=4, window_s=0.001,
                          inflight=inflight)
        try:
            threads = [threading.Thread(target=mb.submit, args=(f"q{i}",))
                       for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert peak[0] == want
        finally:
            mb.close()


def test_chat_sessions_are_separate_and_bounded(server):
    app, _ = server
    sessions = ChatSessions(app, max_sessions=3)
    bot_a, lock_a = sessions.get("a")
    assert sessions.get("a") == (bot_a, lock_a)
    bot_a.chat("tide", generate=False)
    assert len(bot_a.conversation_history) == 2
    assert sessions.get("b")[0].conversation_history == []
    for i in range(5):
        sessions.get(f"s{i}")
    assert len(sessions) == 3


# -- Ollama client on a localhost stub (mirrors tests/test_ollama.py) ---------

class _Stub(BaseHTTPRequestHandler):
    seen = []
    response_text = "hello from mock"
    fail_times = 0

    def log_message(self, *a):
        pass

    def do_GET(self):
        self.send_response(200 if self.path == "/api/tags" else 404)
        self.end_headers()
        if self.path == "/api/tags":
            self.wfile.write(b'{"models": []}')

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        _Stub.seen.append((self.path, body))
        if _Stub.fail_times > 0:
            _Stub.fail_times -= 1
            self.send_response(500)
            self.end_headers()
            return
        self.send_response(200)
        self.end_headers()
        self.wfile.write(json.dumps({"response": _Stub.response_text})
                         .encode())


@pytest.fixture()
def ollama():
    srv = HTTPServer(("127.0.0.1", 0), _Stub)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    _Stub.seen, _Stub.fail_times = [], 0
    _Stub.response_text = "hello from mock"
    yield OllamaClient(RAGConfig(
        ollama_url=f"http://127.0.0.1:{srv.server_port}",
        ollama_timeout_s=5), retries=1)
    srv.shutdown()
    srv.server_close()


def test_ollama_alive_and_down(ollama):
    assert ollama.is_alive()
    assert not OllamaClient(RAGConfig(ollama_url="http://127.0.0.1:1",
                                      ollama_timeout_s=1)).is_alive()


def test_ollama_generate_payload_and_retries(ollama):
    assert ollama.generate("llama3.2:3b", "What is a TPU?",
                           system="be brief") == "hello from mock"
    path, body = _Stub.seen[-1]
    assert path == "/api/generate"
    assert body == {"model": "llama3.2:3b", "prompt": "What is a TPU?",
                    "stream": False, "system": "be brief"}
    _Stub.fail_times = 1
    assert ollama.generate("m", "p") == "hello from mock"
    _Stub.fail_times = 5
    with pytest.raises(RuntimeError, match="Ollama generation failed"):
        ollama.generate("m", "p")


def test_ollama_analyze_image(ollama, tmp_path):
    img = tmp_path / "fig.png"
    img.write_bytes(b"\x89PNG fake image bytes")
    _Stub.response_text = ("TYPE: diagram\nDESCRIPTION: A block diagram "
                           "of a systolic array.\nTEXT: MXU 128x128")
    assert ollama.analyze_image(str(img)) == {
        "type": "diagram",
        "description": "A block diagram of a systolic array.",
        "ocr_text": "MXU 128x128"}
    _, body = _Stub.seen[-1]
    assert body["images"] == [base64.b64encode(
        b"\x89PNG fake image bytes").decode()]
    _Stub.response_text = "this model ignored the format"
    assert ollama.analyze_image(str(img))["type"] == "unknown"


def test_ollama_chat_prompt(ollama):
    ollama.chat([{"role": "user", "content": "hi"},
                 {"role": "assistant", "content": "hello"},
                 {"role": "user", "content": "what is RRF?"}],
                context="[Source 1] RRF combines rankings.")
    _, body = _Stub.seen[-1]
    assert body["prompt"] == "user: hi\nassistant: hello\nuser: what is RRF?"
    assert "Context from documents:" in body["system"]
    ollama.chat([{"role": "user", "content": "hi"}])
    assert _Stub.seen[-1][1]["system"] == "You are a helpful AI assistant."
