"""The port's bench (``hybrid_rag_colbertv2_tpu_torch/bench.py``) on the
CPU, against the JAX package on the same numpy inputs.

The two recall functions are held against the computation the
repository's ``bench.py`` builds from the JAX package (``hybrid_cascade``
+ ``maxsim_scores_exact`` + ``lax.top_k``; for int4-doc
``quantize_int4_groups`` + ``pooled_doc_embeddings`` + ``hybrid_cascade``)
at 1,024 docs: recall exactly equal, the exact top-10 ids equal except
swaps between exact scores tied within rtol 1e-5. The topic generator
keeps its contract (unit-norm rows before quantization, zero rows and
scales past each length, codes in [-127, 127]) and quantizes as JAX's
formula does. ``main`` prints one JSON line, last, with the JAX bench's
headline and recall keys, and exits 1 when a pass raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.ops.maxsim import (
    maxsim_scores_exact as jax_exact)
from hybrid_rag_colbertv2_tpu.ops.prefilter import (
    pooled_doc_embeddings as jax_pooled)
from hybrid_rag_colbertv2_tpu.ops.quant import (
    quantize_int4_groups as jax_int4)
from hybrid_rag_colbertv2_tpu.retrieval.cascade import (
    hybrid_cascade as jax_cascade)
from hybrid_rag_colbertv2_tpu_torch import bench
from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
from hybrid_rag_colbertv2_tpu_torch.ops.prefilter import (
    pooled_doc_embeddings)
from hybrid_rag_colbertv2_tpu_torch.ops.quant import quantize_int8_rows

N, L, D, B, LQ = 1024, 128, 128, 8, 32
PREFILTER, CHUNK = 1024, bench.EXACT_CHUNK
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
RECALL_KEYS = {"recall10_vs_exact", "recall10_vs_exact_int4"}
# every pass but the headline and recall
OFF = ("HRAG_BENCH_1M", "HRAG_BENCH_2M", "HRAG_BENCH_REALDATA",
       "HRAG_BENCH_PRETRAINED", "HRAG_BENCH_ORGANIC")


@pytest.fixture(scope="module")
def inputs():
    """bench.py's recall inputs at 1,024 docs, as numpy: topic-clustered
    int8 rows, a lexical index over a 1,024-doc corpus, its term ids for
    8 queries and 8 topic-aligned query embeddings."""
    rng = np.random.default_rng(0)
    topics = rng.standard_normal((64, D)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=-1, keepdims=True)
    lens = rng.integers(L // 2, L + 1, N).astype(np.int32)
    x = (topics[rng.integers(0, 64, N)][:, None, :]
         + 0.35 * rng.standard_normal((N, L, D)).astype(np.float32))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x *= (np.arange(L)[None, :] < lens[:, None])[..., None]
    q8, sc = quantize_int8_rows(torch.from_numpy(x.reshape(N * L, D)))
    vocab = np.array([f"term{i}" for i in range(500)])
    corpus = [" ".join(r) for r in vocab[rng.integers(0, 500, (N, 12))]]
    lex = LexicalIndex.build(corpus, postings_cap=512)
    qt = np.stack([lex.encode_query(" ".join(rng.choice(vocab, 6)), 32)
                   for _ in range(B)]).astype(np.int32)
    q = (topics[rng.integers(0, 64, B)][:, None, :]
         + 0.3 * rng.standard_normal((B, LQ, D)).astype(np.float32))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(q=q, qt=qt, csr=(lex.indptr, lex.post_docs,
                                 lex.post_weights),
                max_postings=lex.max_postings, q8=q8.numpy(),
                sc=sc.numpy(), lens=lens)


def _jax_cascade_ids(a, emb, scales, pooled, dsc, is_int8):
    return jax_cascade(
        jnp.asarray(a["q"]), jnp.asarray(a["qt"]),
        *map(jnp.asarray, a["csr"]), emb, scales, jnp.asarray(a["lens"]),
        pooled, dsc, prefilter=PREFILTER, n_docs=N,
        max_postings=a["max_postings"], doc_len=L, is_int8=is_int8,
        k_each=100, k_fuse=50, k_final=10)[0]


def _jax_recall(ids, e_top):
    hits = (ids[:, :, None] == e_top[:, None, :]).any(-1) & (ids >= 0)
    return float(jnp.mean(jnp.sum(hits, axis=1) / 10.0))


@pytest.fixture(scope="module")
def jax_int8(inputs):
    """bench.py's ``recall_on_device`` from the JAX package: -> (recall,
    exact top-10 ids, exact scores)."""
    a = inputs
    q8, sc, lens = map(jnp.asarray, (a["q8"], a["sc"], a["lens"]))
    pooled = jax_pooled(q8, sc, lens, doc_len=L)
    ids = _jax_cascade_ids(a, q8, sc, pooled, None, True)
    e4 = q8.reshape(N // CHUNK, CHUNK, L, D)
    s4 = sc.reshape(N // CHUNK, CHUNK, L)
    parts = jax.lax.map(
        lambda c: jax_exact(jnp.asarray(a["q"]),
                            c[0].astype(jnp.float32) * c[1][..., None],
                            c[2]),
        (e4, s4, lens.reshape(N // CHUNK, CHUNK)))
    exact = parts.transpose(1, 0, 2).reshape(B, N)
    _, e_top = jax.lax.top_k(exact, 10)
    return _jax_recall(ids, e_top), np.array(e_top), np.asarray(exact)


def _port_args(a):
    t = torch.from_numpy
    return (t(a["q"]), t(a["qt"]), *map(t, a["csr"]), t(a["q8"]),
            t(a["sc"]), t(a["lens"]))


def test_recall_int8_equals_jax(inputs, jax_int8):
    want, want_top, exact = jax_int8
    args = _port_args(inputs)
    pooled = pooled_doc_embeddings(args[5], args[6], args[7], doc_len=L)
    got, got_top = bench.recall_int8(
        *args, pooled, max_postings=inputs["max_postings"], doc_len=L,
        prefilter=PREFILTER)
    assert 0.0 < got <= 1.0
    assert got == want
    got_top = got_top.numpy()
    rows = np.arange(B)[:, None]
    # ids equal, or swapped only between exact scores tied within 1e-5
    np.testing.assert_allclose(exact[rows, got_top],
                               exact[rows, want_top], rtol=1e-5)


def test_recall_int4_equals_jax(inputs, jax_int8):
    a = inputs
    _, e_top, _ = jax_int8
    q8, sc, lens = map(jnp.asarray, (a["q8"], a["sc"], a["lens"]))
    packed, dsc = jax_int4(
        (q8.astype(jnp.float32) * sc[:, None]).reshape(N, L, D), lens)
    pooled4 = jax_pooled(packed, None, lens, doc_len=L, doc_scales=dsc,
                         packed_int4=True)
    want = _jax_recall(_jax_cascade_ids(a, packed, None, pooled4, dsc,
                                        False), jnp.asarray(e_top))
    got = bench.recall_int4(*_port_args(a), torch.from_numpy(e_top),
                            max_postings=a["max_postings"], doc_len=L,
                            prefilter=PREFILTER)
    assert 0.0 < got <= 1.0
    assert got == want


def test_topic_generator_contract():
    topics = bench.unit_topics(bench.N_TOPICS, D, "cpu")
    np.testing.assert_allclose(torch.linalg.vector_norm(topics, dim=-1),
                               1.0, rtol=1e-6)
    n, dl = 300, 64                     # three blocks, the last partial
    lens = torch.from_numpy(np.random.default_rng(1).integers(
        0, dl + 1, n).astype(np.int32))
    lens[:3] = torch.tensor([0, 1, dl])
    rows, scales = bench.topic_index(topics, lens, dl, seed=0, block=128)
    assert rows.dtype == torch.int8 and rows.shape == (n * dl, D)
    valid = (torch.arange(dl)[None, :] < lens[:, None]).reshape(-1)
    assert int(rows.to(torch.int32).abs().max()) <= 127
    assert not rows[~valid].any() and not scales[~valid].any()
    assert bool((scales[valid] > 0).all())
    deq = rows[valid].to(torch.float32) * scales[valid][:, None]
    np.testing.assert_allclose(torch.linalg.vector_norm(deq, dim=-1), 1.0,
                               atol=2e-2)
    # the first block again, from the same generator: unit-norm fp32 rows,
    # zero past each length; the quantizer is JAX's formula on it
    g = torch.Generator().manual_seed(0)
    assign = torch.randint(0, bench.N_TOPICS, (n,), generator=g)
    x = bench.topic_rows(topics, assign[:128], lens[:128], dl, g)
    xv = x[torch.arange(dl)[None, :] < lens[:128, None]]
    np.testing.assert_allclose(torch.linalg.vector_norm(xv, dim=-1), 1.0,
                               rtol=1e-5)
    assert not x[torch.arange(dl)[None, :] >= lens[:128, None]].any()

    @jax.jit
    def jax_quant(x):                   # bench.py:110-113
        scale = jnp.max(jnp.abs(x), axis=-1) / 127.0
        qv = jnp.round(x / jnp.maximum(scale, 1e-9)[..., None])
        return qv.astype(jnp.int8), scale.astype(jnp.float32)

    jq, js = jax_quant(jnp.asarray(x.numpy()))
    pq, ps = quantize_int8_rows(x.reshape(-1, D))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq).reshape(-1, D))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js).reshape(-1))
    np.testing.assert_array_equal(rows[:128 * dl].numpy(), pq.numpy())
    np.testing.assert_array_equal(scales[:128 * dl].numpy(), ps.numpy())


def _last_json(out):
    lines = out.strip().splitlines()
    return json.loads(lines[-1])


def test_main_on_cpu_prints_one_line_last(monkeypatch, capsys):
    for env in OFF:
        monkeypatch.setenv(env, "0")
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    res = _last_json(out)
    assert out.strip().count("\n") == 0          # the one stdout line
    assert HEADLINE_KEYS | RECALL_KEYS == set(res)
    assert res["unit"] == "ms" and res["value"] > 0
    assert "2000 chunks" in res["metric"] and "(cpu)" in res["metric"]
    assert res["vs_baseline"] == round(
        bench.BASELINE_MS / (res["value"] / 8), 1)
    assert all(0.0 <= res[k] <= 1.0 for k in RECALL_KEYS)


@pytest.mark.parametrize("failing", ["headline", "recall"])
def test_failed_pass_exits_1_with_the_line_last(failing, monkeypatch,
                                                capsys):
    """A pass that raises is logged with its traceback, the later passes
    still run, the JSON line is still printed last, and main returns 1."""
    for env in OFF:
        monkeypatch.setenv(env, "0")
    monkeypatch.setenv("HRAG_BENCH_ORGANIC", "1")

    def boom(result, ctx):
        raise RuntimeError("planted failure")

    def headline(result, dev):
        result.update(metric="m", value=1.0, unit="ms", vs_baseline=2568.0)
        return {"cuda": False}

    monkeypatch.setattr(bench, "run_headline",
                        boom if failing == "headline" else headline)
    monkeypatch.setattr(bench, "run_recall", boom)
    monkeypatch.setattr(bench, "run_organic",
                        lambda result, ctx: result.update(organic={}))
    assert bench.main(["--device", "cpu"]) == 1
    cap = capsys.readouterr()
    res = _last_json(cap.out)
    assert f"{failing} pass FAILED" in cap.err
    assert "RuntimeError: planted failure" in cap.err
    if failing == "headline":
        assert res == {}
    else:
        assert set(res) == HEADLINE_KEYS | {"organic"}


def test_bench_and_demo_need_cuda_unless_cpu(monkeypatch, tmp_path):
    import tempfile

    from hybrid_rag_colbertv2_tpu_torch.examples import demo

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main()
