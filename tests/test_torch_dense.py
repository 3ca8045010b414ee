"""The port's DenseTokenIndex against the JAX package's, layout by layout.

The same numpy token embeddings go to both ``DenseTokenIndex.build``s.
Stored rows, scales and lengths must be bit-equal. The bf16 proxies are
equal up to the order of their fp32 token sums, which XLA's CPU compiler
picks by shape (FMA contraction, windowed sums; see
``test_pruned_route_matches_jax_on_layout`` in test_torch_maxsim.py).
Directories saved by either package load in the other, and
``gather_docs``, ``rerank_scores``, ``search_scores`` and ``search_topk``
agree (the JAX side runs its Pallas scans in interpret mode). The scans'
tolerance is rtol 1e-5, atol 1e-4: exact fp32 products summed in other
orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.index.dense import (
    DenseTokenIndex as JaxDenseTokenIndex)
from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig, RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
    ColBERTConfig, ColBERTEncoder)
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer

LAYOUTS = ["int8", "int8-doc", "int4-doc", "bfloat16", "float32"]
TOL = dict(rtol=1e-5, atol=1e-4)
N, DOC_LEN, DIM = 45, 32, 32


def _embs(seed=0, n=N, l_in=DOC_LEN + 4, dim=DIM):
    """Unit-norm token rows, longer than DOC_LEN (the build truncates);
    lengths 0, 1, full and past full included."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l_in, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    lengths = rng.integers(1, l_in + 1, n).astype(np.int32)
    lengths[:4] = [0, 1, DOC_LEN, l_in]
    return x, lengths


def _pair(dtype):
    x, lengths = _embs()
    j = JaxDenseTokenIndex.build(jnp.asarray(x), jnp.asarray(lengths),
                                 doc_len=DOC_LEN, dtype=dtype)
    t = DenseTokenIndex.build(torch.from_numpy(x), torch.from_numpy(lengths),
                              doc_len=DOC_LEN, dtype=dtype)
    return j, t


def _np(t):
    """Raw bits of a port tensor (bf16 as uint16)."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _queries(b=3, lq=16, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, -3:] = 0.0
    return q


def test_build_defaults_to_bfloat16_as_jax():
    x, lengths = _embs()
    t = DenseTokenIndex.build(torch.from_numpy(x), torch.from_numpy(lengths),
                              doc_len=DOC_LEN)
    j = JaxDenseTokenIndex.build(jnp.asarray(x), jnp.asarray(lengths),
                                 doc_len=DOC_LEN)
    assert t.quant == j.quant == "bfloat16"


@pytest.mark.parametrize("dtype", LAYOUTS)
def test_build_matches_jax_bytes(dtype):
    j, t = _pair(dtype)
    assert t.quant == j.quant == dtype
    assert (t.n_docs, t.doc_len, t.dim, t.n_pad) == (j.n_docs, j.doc_len,
                                                     j.dim, j.n_pad)
    assert t.is_int4 == j.is_int4 and t.is_int8 == j.is_int8
    assert np.array_equal(_np(t.emb_flat), _jnp(j.emb_flat))
    assert np.array_equal(_np(t.doc_lengths), np.asarray(j.doc_lengths))
    for a, b in ((t.scales, j.scales), (t.doc_scales, j.doc_scales)):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(_np(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))
    pt, pj = t.pooled.float().numpy(), np.asarray(j.pooled, np.float32)
    np.testing.assert_allclose(pt, pj, rtol=2.0**-7, atol=1e-6)
    assert (pt != pj).mean() <= 0.01
    assert t.memory_bytes() == j.memory_bytes()


@pytest.mark.parametrize("dtype", LAYOUTS)
def test_directories_cross_load(dtype, tmp_path):
    """A JAX-saved directory loads in the port, a port-saved one in JAX,
    every array intact."""
    j, t = _pair(dtype)
    j.save(tmp_path / "jax")
    t.save(tmp_path / "port")
    for d in ("jax", "port"):
        a = DenseTokenIndex.load(tmp_path / d, device="cpu")
        b = JaxDenseTokenIndex.load(tmp_path / d)
        src = j if d == "jax" else t
        assert a.quant == b.quant == src.quant == dtype
        assert (a.n_docs, a.doc_len, a.dim) == (b.n_docs, b.doc_len, b.dim)
        assert np.array_equal(_np(a.emb_flat), _jnp(b.emb_flat))
        assert np.array_equal(_np(a.emb_flat), _np(t.emb_flat))
        assert np.array_equal(_np(a.doc_lengths), np.asarray(b.doc_lengths))
        for x, y in ((a.scales, b.scales), (a.doc_scales, b.doc_scales)):
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(_np(x), np.asarray(y))
        # the pooled vectors persist as fp16 and load as bf16 alike
        assert np.array_equal(a.pooled.float().numpy(),
                              np.asarray(b.pooled, np.float32))


@pytest.mark.parametrize("dtype", LAYOUTS)
def test_gather_and_rerank_match_jax(dtype):
    j, t = _pair(dtype)
    ids = np.array([[0, 1, 2, 3, 44, -1], [7, 3, -1, 20, 2, 1],
                    [5, 6, 7, 8, 9, 10]], np.int32)
    jg, jl = j.gather_docs(jnp.asarray(ids))
    tg, tl = t.gather_docs(torch.from_numpy(ids))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    # rows past a doc's length hold the doc-scale layouts' copies; the
    # lengths mask them, so compare the valid rows
    valid = np.arange(DOC_LEN)[None, None, :] < np.asarray(jl)[..., None]
    assert np.array_equal(tg.numpy()[valid], np.asarray(jg)[valid])
    q = _queries()
    np.testing.assert_allclose(
        t.rerank_scores(torch.from_numpy(q), torch.from_numpy(ids)).numpy(),
        np.asarray(j.rerank_scores(jnp.asarray(q), jnp.asarray(ids))), **TOL)


@pytest.mark.parametrize("dtype", LAYOUTS)
def test_search_matches_jax(dtype):
    """The full scan (the float32 index is scanned as bf16 here, as in
    the JAX package) and both search_topk routes."""
    j, t = _pair(dtype)
    q = _queries()
    js = np.asarray(j.search_scores(jnp.asarray(q)))
    ts = t.search_scores(torch.from_numpy(q)).numpy()
    assert ts.shape == (3, N)
    np.testing.assert_allclose(ts, js, **TOL)
    for prefilter in (0, 200):
        jv, ji = j.search_topk(jnp.asarray(q), 10, prefilter=prefilter,
                               approx_recall=1.0)
        tv, ti = t.search_topk(torch.from_numpy(q), 10, prefilter=prefilter)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_auto_resolves_to_int4_where_int8_does_not_fit(monkeypatch):
    """``auto`` picks int4-doc when the int8 index exceeds 80% of the
    card's memory, int8 below, as the JAX package's capacity rule."""
    mesh = MeshConfig(index_dtype="auto")
    int8_bytes = 1000 * 128 * 128 + 1000 * 128 * 4 + 1000 * 4
    for total, want in ((int8_bytes, "int4-doc"), (2 * int8_bytes, "int8")):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda device=None, t=total: (t, t))
        assert mesh.resolve_index_dtype(1000, 128, device="cuda") == want
    assert mesh.resolve_index_dtype(1000, 128, device="cpu") == "int8"
    assert MeshConfig(index_dtype="int8-doc").resolve_index_dtype(
        1000, 128, device="cuda") == "int8-doc"


def test_manager_builds_and_serves_resolved_int4(monkeypatch, tmp_path):
    """A manager whose ``auto`` resolves to int4-doc (a card too small
    for int8) builds that index, logs the resolution, and serves it."""
    from hybrid_rag_colbertv2_tpu_torch.index import manager as mgr_mod
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)
    logged = []
    monkeypatch.setattr(mgr_mod.log, "info",
                        lambda msg, *a: logged.append(msg % a))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 10, 1 << 10))
    resolve = MeshConfig.resolve_index_dtype
    # the CPU manager asks as the card would (a CPU device always gets
    # int8, to keep the other tests deterministic)
    monkeypatch.setattr(
        MeshConfig, "resolve_index_dtype",
        lambda self, *a, device=None, **kw: resolve(self, *a, device="cuda",
                                                    **kw))
    cfg = RAGConfig(bm25_index_path=str(tmp_path / "bm25"),
                    colbert_index_path=str(tmp_path / "colbert"))
    cfg.mesh.index_dtype = "auto"
    enc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=256),
                         HashTokenizer(256), device="cpu")
    corpus = [f"doc {i} alpha{i % 7} beta{i % 5} gamma{i}" for i in range(40)]
    mgr = IndexManager(cfg, enc, device="cpu")
    mgr.build_all(corpus)
    assert mgr.dense.quant == "int4-doc"
    assert any(m.startswith("index_dtype=auto -> int4-doc") for m in logged)
    ids, scores = HybridRetriever(cfg, mgr, enc,
                                  device="cpu").retrieve_batch(corpus[:3], 5)
    assert ids.shape == (3, 5) and np.isfinite(scores).all()
    assert ((ids >= 0) & (ids < len(corpus))).all()
    reloaded = IndexManager(cfg, enc, device="cpu")
    reloaded.load()
    assert reloaded.dense.quant == "int4-doc"


def test_legacy_per_doc_int4_scales_load_as_jax(tmp_path):
    """An int4-doc directory with the older per-doc (N,) scale vector
    loads as (G, N) group scales, broadcast with ``ops/quant.py``'s
    ``int4_group_size``, as the JAX loader does."""
    j, _ = _pair("int4-doc")
    j.save(tmp_path)
    with np.load(tmp_path / "dense.npz") as f:
        arrs = dict(f)
    arrs["doc_scales"] = arrs["doc_scales"][0]            # legacy (N,)
    np.savez(tmp_path / "dense.npz", **arrs)
    t = DenseTokenIndex.load(tmp_path, device="cpu")
    jl = JaxDenseTokenIndex.load(tmp_path)
    assert tuple(t.doc_scales.shape) == (DOC_LEN // 8, t.n_pad)
    assert np.array_equal(t.doc_scales.numpy(), np.asarray(jl.doc_scales))
    q = _queries()
    np.testing.assert_allclose(
        t.search_scores(torch.from_numpy(q)).numpy(),
        np.asarray(jl.search_scores(jnp.asarray(q))), **TOL)
