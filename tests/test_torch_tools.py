"""The port's tools and utilities against the JAX package's, on the CPU.

``tools/eval_recall.py`` (and the CLI's ``--eval``), ``organic_questions``,
``serve_probe``, ``stage_probe``, ``check_env`` (its kernel probes must
fail without a card), its ``--convert``, and ``utils/{timing,profiling}``.
The apps of both packages serve one index directory that the JAX app
wrote (its tokenizer, params and indexes), so their results compare
exactly: every hit/agreement/leg key of ``evaluate`` is equal.
"""

import io
import json
import math
import threading
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.app import cli as jax_cli
from hybrid_rag_colbertv2_tpu.app.application import (
    RAGApplication as JaxApp)
from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.ingest.chunker import (
    ChunkerConfig as JaxChunkerConfig, MarkdownChunker as JaxChunker)
from hybrid_rag_colbertv2_tpu.tools import check_env as jax_check_env
from hybrid_rag_colbertv2_tpu.tools import eval_recall as jax_eval
from hybrid_rag_colbertv2_tpu.tools import organic_questions as jax_organic
from hybrid_rag_colbertv2_tpu.utils import profiling as jax_profiling
from hybrid_rag_colbertv2_tpu_torch.app import cli
from hybrid_rag_colbertv2_tpu_torch.app.application import RAGApplication
from hybrid_rag_colbertv2_tpu_torch.app.server import make_server
from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
from hybrid_rag_colbertv2_tpu_torch.ingest.chunker import (
    ChunkerConfig, MarkdownChunker)
from hybrid_rag_colbertv2_tpu_torch.tools import (
    check_env, eval_recall, organic_questions, serve_probe, stage_probe)
from hybrid_rag_colbertv2_tpu_torch.utils import profiling, timing

REPO = Path(__file__).resolve().parents[1]
# tests/test_app.py::test_eval_recall_tool's document and config, with
# the final fusion pinned (no gate: both packages' gates are held equal
# in tests/test_torch_app.py)
EVAL_DOC = "# T\n\n" + "\n\n".join(
    f"## S{i}\n\nunique topic{i} words alpha{i} beta{i} gamma{i} "
    f"delta{i} epsilon{i} zeta{i}" for i in range(12))
# tests/test_organic_questions.py's documents, two of them
ORGANIC_DOCS = ["docs/architecture.md", "docs/scaling.md"]
# tools/stage_probe.py of the JAX package: every stage name it prints for
# the cascade probe with both layouts, brute and pruned, --prefilter 1024
STAGES = [
    "encode_query", "bm25", "bm25_topk", "dense_scan_brute_int8",
    "dense_scan_brute_int8doc", "dense_scan_brute_int4doc",
    "dense_pruned_C1024", "dense_pruned_int4_C1024",
    "pruned_A_proxy_topk_C1024", "pruned_B_exact_C1024",
    "pruned_B_exact_int4_C1024", "rerank_exact_64cand",
    "rerank_exact_int4_64cand", "topk100_over_N", "rrf_fuse",
    "cascade_brute", "cascade_pruned_C1024", "cascade_brute_int4",
    "cascade_pruned_int4_C1024",
]


def _kw(root: Path, **over):
    kw = dict(db_path=str(root / "s.db"),
              bm25_index_path=str(root / "i/b"),
              colbert_index_path=str(root / "i/c"),
              images_dir=str(root / "im"),
              tokenizer_path=str(root / "i/t.json"),
              min_chunk_size=2, max_chunk_size=32,
              encoder_preset="tiny", tokenizer_vocab_size=256,
              dense_prefilter=16, final_fusion="rerank")
    kw.update(over)
    return kw


def _stdout(fn, *a):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def eval_world(tmp_path_factory):
    """The JAX app indexes tests/test_app.py's eval document; the port app
    serves the same directory on the CPU."""
    root = tmp_path_factory.mktemp("eval")
    (root / "d.md").write_text(EVAL_DOC)
    JaxConfig(**_kw(root)).save(root / "cfg.json")
    japp = JaxApp(JaxConfig.load(root / "cfg.json"), use_ollama=False)
    japp.index_documents([str(root / "d.md")])
    japp.initialize_chatbot(use_mesh=False)
    app = RAGApplication(RAGConfig.load(root / "cfg.json"),
                         use_ollama=False, device="cpu")
    app.initialize_chatbot(use_mesh=False)
    return root, japp, app


LATENCY = ("encode_batch_ms", "retrieve_batch_ms")


def _same_eval(got, want):
    assert set(got) == set(want)
    for key in set(want) - set(LATENCY):
        assert got[key] == want[key], key
    for key in LATENCY:
        assert got[key] > 0 and math.isfinite(got[key])


@pytest.mark.parametrize("source", ["ict", "paraphrase"])
def test_evaluate_equals_jax(eval_world, source):
    """hit@k configured and exact, agreement@k and both legs, on the same
    queries (seed 101), equal to JAX's; the exact leg is route 0 over the
    uncapped lexical rebuild (bm25_postings_cap=512 is set). Paraphrase
    queries need a sample-corpus document: both raise alike."""
    _, japp, app = eval_world
    kw = dict(n_queries=8, k=3, batch=4, query_source=source)
    if source == "paraphrase":
        with pytest.raises(RuntimeError, match="no paraphrase queries"):
            jax_eval.evaluate(japp, **kw)
        with pytest.raises(RuntimeError, match="no paraphrase queries"):
            eval_recall.evaluate(app, **kw)
        return
    want = jax_eval.evaluate(japp, **kw)
    got = eval_recall.evaluate(app, **kw)
    _same_eval(got, want)
    assert got["queries"] == 8 and got["hit@3_exact"] >= 0.5
    assert {"hit@3_bm25_only", "hit@3_dense_only", "agreement@3"} <= set(got)


def test_eval_main_passes_the_query_source(eval_world):
    """A known difference: JAX's ``main`` parses ``--query-source`` and
    evaluates ICT queries whatever it says; the port's passes it on, so
    paraphrase queries on a corpus without them raise."""
    root, _, _ = eval_world
    argv = ["--config", str(root / "cfg.json"), "--n-queries", "4",
            "--query-source", "paraphrase"]
    assert _stdout(jax_eval.main, argv)[0] == 0
    with pytest.raises(RuntimeError, match="no paraphrase queries"):
        _stdout(eval_recall.main, argv + ["--device", "cpu"])


def test_eval_main_and_cli_eval_equal_jax(eval_world, capsys):
    """``eval_recall.main`` and the CLI's ``--eval`` (lifted from its
    exit 2) print JAX's results for the same config file."""
    root, _, _ = eval_world
    argv = ["--config", str(root / "cfg.json"), "--n-queries", "8",
            "--k", "3", "--batch", "4"]
    rc, out = _stdout(eval_recall.main, argv + ["--device", "cpu"])
    assert rc == 0
    got = json.loads(out.strip().splitlines()[-1])
    rc, out = _stdout(jax_eval.main, argv)
    assert rc == 0
    _same_eval(got, json.loads(out.strip().splitlines()[-1]))
    cli_argv = ["--config", str(root / "cfg.json"), "--eval", "8"]
    rc, out = _stdout(cli.main, cli_argv + ["--device", "cpu"])
    assert rc == 0
    got = json.loads(out.strip().splitlines()[-1])
    rc, out = _stdout(jax_cli.main, cli_argv)
    assert rc == 0
    want = json.loads(out.strip().splitlines()[-1])
    _same_eval(got, want)
    assert got["queries"] == 8 and got["k"] == 10


def _chunks(chunker_cls, cfg_cls):
    ch = chunker_cls(cfg_cls(min_tokens=48, max_tokens=96))
    out = []
    for p in ["README.md", "SURVEY.md", "PARITY.md", "BASELINE.md",
              "docs/architecture.md", "docs/performance.md",
              "docs/scaling.md"]:
        f = REPO / p
        if f.exists():
            out += [c["text"] for c in ch.chunk(f.read_text())]
    return out


def test_organic_questions_equal_jax(tmp_path):
    """The question set is JAX's, as it is; resolve_gold over the repo's
    chunked docs equals JAX's; evaluate_questions on an app over two of
    them (JAX's index, served by both packages) equals JAX's."""
    assert organic_questions.QUESTIONS == jax_organic.QUESTIONS
    corpus = _chunks(MarkdownChunker, ChunkerConfig)
    assert corpus == _chunks(JaxChunker, JaxChunkerConfig)
    assert organic_questions.resolve_gold(corpus) == \
        jax_organic.resolve_gold(corpus)
    kw = _kw(tmp_path, min_chunk_size=48, max_chunk_size=96,
             tokenizer_vocab_size=1024, encoder_train_steps=0,
             dense_prefilter=0)
    japp = JaxApp(JaxConfig(**kw), use_ollama=False)
    japp.index_documents([str(REPO / p) for p in ORGANIC_DOCS])
    japp.initialize_chatbot(use_mesh=False)
    app = RAGApplication(RAGConfig(**kw), use_ollama=False, device="cpu")
    app.initialize_chatbot(use_mesh=False)
    want = jax_organic.evaluate_questions(japp)
    got = organic_questions.evaluate_questions(app)
    assert got == want
    assert got["n"] > 0


def test_serve_probe_run_level(eval_world):
    """tests/test_server.py:293 on the port's server: run_level drives it
    over a real socket, every request answered, the batcher merging."""
    _, _, app = eval_world
    httpd, batcher = make_server(app, port=0, max_batch=4,
                                 batch_window_s=0.005)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/query"
        row = serve_probe.run_level(url, ["topic3 alpha3", "beta7 words"],
                                    concurrency=3, n_requests=2)
        assert row["requests"] == 6 and row["errors"] == 0
        assert row["qps"] > 0 and row["p50_ms"] > 0
        assert row["p99_ms"] >= row["p95_ms"] >= row["p50_ms"]
        assert batcher.requests_served >= 6
    finally:
        httpd.shutdown()
        batcher.close()
        httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_serve_probe_chat_main():
    """``main --chat``: the app built from the sample corpus, the mock
    generation sidecar, named sessions at two levels; every request
    answered by the mock."""
    rc, out = _stdout(serve_probe.main, [
        "--n-docs", "2", "--concurrency", "1,2", "--requests", "2",
        "--chat", "--gen-latency-ms", "20", "--device", "cpu", "--json"])
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert res["mode"] == "chat" and res["chunks"] > 0
    assert [r["concurrency"] for r in res["levels"]] == [1, 2]
    for r in res["levels"]:
        assert r["errors"] == 0 and r["requests"] == 2 * r["concurrency"]
        assert r["p50_ms"] >= 20


def test_stage_probe_prints_jax_stage_names(tmp_path):
    """The cascade probe at 256 docs, one iteration: JAX's stage names in
    JAX's order, every time positive and finite, and the --profile
    trace written."""
    rc, out = _stdout(stage_probe.main, [
        "--n-docs", "256", "--iters", "1", "--device", "cpu",
        "--profile", str(tmp_path / "trace")])
    assert rc == 0
    rows = [json.loads(line) for line in out.strip().splitlines()]
    assert [r["stage"] for r in rows] == STAGES
    for r in rows:
        assert r["n_docs"] == 256 and r["backend"] == "cpu"
        assert 0 < r["p50_ms"] <= r["p90_ms"] < math.inf
    assert (tmp_path / "trace" / profiling.TRACE_FILE).stat().st_size > 0


def test_check_env_kernel_probes_fail_without_a_card():
    """On the CPU the five kernel probes FAIL with the port's "no CUDA
    device" error (they never pass on a plain version), the rest pass on
    the CPU, and main returns 1."""
    rc, out = _stdout(check_env.main, ["--device", "cpu"])
    assert rc == 1
    lines = {ln.split(":")[0].split("]")[1].strip(): ln
             for ln in out.splitlines() if ln.startswith("  [")}
    assert set(lines) == {name for name, _ in check_env.TESTS}
    assert len(check_env.KERNEL_TESTS) == 5
    for name, line in lines.items():
        if name in check_env.KERNEL_TESTS:
            assert line.startswith("  [FAIL]") and "no CUDA device" in line
        else:
            assert line.startswith("  [ok]"), line
    assert "6/11 checks passed" in out


def test_check_env_convert_equals_jax(tmp_path):
    """``--convert <hf_dir> <out.npz>``: the port's encoder_params.npz is
    JAX's, array for array."""
    from test_torch_convert import DIM, _write_dir

    for layout in ("flash", "xlmr"):
        ckpt = tmp_path / layout
        _write_dir(ckpt, layout, "F32")
        hf = json.loads((ckpt / "config.json").read_text())
        hf["dim"] = DIM
        (ckpt / "config.json").write_text(json.dumps(hf))
        out_p, out_j = tmp_path / f"{layout}.p.npz", tmp_path / f"{layout}.j.npz"
        assert _stdout(check_env.main,
                       ["--convert", str(ckpt), str(out_p)])[0] == 0
        assert _stdout(jax_check_env.main,
                       ["--convert", str(ckpt), str(out_j)])[0] == 0
        with np.load(out_p) as p, np.load(out_j) as j:
            assert set(p.files) == set(j.files)
            for k in j.files:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert check_env.main(["--convert", "only-one"]) == 2


def test_queued_timeit_positive_and_finite():
    x = torch.randn(64, 64)
    p50, worst = timing.queued_timeit(lambda: x @ x, 4)
    assert 0 < p50 <= worst < math.inf
    p50, worst = timing.queued_timeit(lambda: (x @ x, None), 2, reps=2)
    assert 0 < p50 <= worst < math.inf
    with pytest.raises(TypeError, match="tensor"):
        timing.queued_timeit(lambda: 1.0, 1)
    assert timing.measure_rtt_ms(force=True) == 0.0     # no card here


@pytest.mark.parametrize("n_docs,doc_len,dtype_bytes,n_devices", [
    (100_000, 128, 1, 1), (1_000_000, 64, 1, 8), (5000, 256, 2, 4),
    (3, 32, 4, 8)])
def test_index_capacity_estimate_equals_jax(n_docs, doc_len, dtype_bytes,
                                            n_devices):
    got = profiling.index_capacity_estimate(
        n_docs, doc_len, dtype_bytes=dtype_bytes, n_devices=n_devices)
    want = jax_profiling.index_capacity_estimate(
        n_docs, doc_len, dtype_bytes=dtype_bytes, n_devices=n_devices)
    assert got == want
    assert got["fits"] is None          # no device reports a limit here
    assert profiling.index_capacity_estimate(10, 32)["devices"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t") as prof:
        with profiling.annotate("probe-span"):
            torch.randn(32, 32).sum()
    trace = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "probe-span" in names
    assert any(e.key == "probe-span" for e in prof.key_averages())
    assert profiling.device_memory_stats() == {}
