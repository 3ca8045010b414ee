"""The port's length-bucketed layout against the JAX package's, on the CPU.

``BucketedDenseIndex`` case for case as ``tests/test_bucketed.py`` holds
JAX's (the sharded case waits for the port of parallel/), then the
same seeded inputs through both packages: every layout's codes, routing
arrays, top-k ids and scores; directories saved by either package
served by the other; the fused bucketed cascade against its composed
oracle and against JAX's ``retrieve_batch``; the tie order of the merged
top-k; the fused cache's keys and eviction; the app and the gate over a
bucketed index. Scores within atol 1e-4 (fp32 sums in other orders), as
``test_torch_cascade.py`` holds them; ids equal.
"""

import gc
import json
import shutil
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hybrid_rag_colbertv2_tpu.retrieval.cascade as jax_cascade
from hybrid_rag_colbertv2_tpu.app.application import RAGApplication as JaxApp
from hybrid_rag_colbertv2_tpu.config import MeshConfig as JaxMesh
from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.index.bucketed import (
    BucketedDenseIndex as JaxBucketed)
from hybrid_rag_colbertv2_tpu.index.lexical import (
    LexicalIndex as JaxLexicalIndex)
from hybrid_rag_colbertv2_tpu.index.manager import IndexManager as JaxManager
from hybrid_rag_colbertv2_tpu.models.colbert import (
    ColBERTConfig as JaxColCfg, ColBERTEncoder as JaxEncoder)
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer)
from hybrid_rag_colbertv2_tpu.retrieval import gate as jax_gate
from hybrid_rag_colbertv2_tpu.retrieval.cascade import (
    HybridRetriever as JaxRetriever)
from hybrid_rag_colbertv2_tpu.tools.sample_corpus import (
    generate_corpus as jax_generate_corpus, write_corpus)
from hybrid_rag_colbertv2_tpu.utils.cache import JitCache as JaxJitCache
import hybrid_rag_colbertv2_tpu_torch.retrieval.cascade as cascade
from hybrid_rag_colbertv2_tpu_torch.app.application import RAGApplication
from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig, RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.bucketed import BucketedDenseIndex
from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
    ColBERTConfig, ColBERTEncoder)
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import ColBERTTokenizer
from hybrid_rag_colbertv2_tpu_torch.ops.maxsim import maxsim_scores_exact
from hybrid_rag_colbertv2_tpu_torch.retrieval import gate
from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
    HybridRetriever, encode_query_terms)
from hybrid_rag_colbertv2_tpu_torch.utils.cache import JitCache

LAYOUTS = ("int8", "int8-doc", "int4-doc", "bfloat16", "float32")
ATOL = 1e-4
CORPUS = ([f"short doc {i} topic {i % 7}" for i in range(40)]
          + [" ".join(f"word{j} topic {i % 7} filler" for j in range(20))
             + f" long doc {i}" for i in range(40, 80)])
QUERIES = ["topic 3 long doc", "short doc 7", "word5 filler topic"]


@pytest.fixture(scope="module")
def data():
    """tests/test_bucketed.py's inputs: 96 unit-norm docs of 96 x 128
    tokens, lengths spread over three buckets, padding rows zero."""
    rng = np.random.default_rng(3)
    n, l, d = 96, 96, 128
    docs = rng.standard_normal((n, l, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    lengths = np.concatenate([
        rng.integers(4, 33, n // 3),
        rng.integers(33, 65, n // 3),
        rng.integers(65, l + 1, n - 2 * (n // 3)),
    ]).astype(np.int32)
    rng.shuffle(lengths)
    docs *= np.arange(l)[None, :, None] < lengths[:, None, None]
    q = rng.standard_normal((2, 32, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q, docs, lengths


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# -- tests/test_bucketed.py, case for case --------------------------------

def test_search_matches_exact(data):
    q, docs, lengths = _t(*data)
    idx = BucketedDenseIndex.build(docs, lengths, bucket_sizes=(32, 64, 96),
                                   dtype="float32")
    assert len(idx.buckets) == 3
    got = idx.search_scores(q)
    ref = maxsim_scores_exact(q, docs, lengths)
    torch.testing.assert_close(got, ref, rtol=3e-3, atol=3e-3)


def test_memory_smaller_than_single_bucket(data):
    q, docs, lengths = _t(*data)
    bucketed = BucketedDenseIndex.build(docs, lengths,
                                        bucket_sizes=(32, 64, 96),
                                        dtype="int8", docs_pad_multiple=8)
    single = DenseTokenIndex.build(docs, lengths, doc_len=96, dtype="int8",
                                   docs_pad_multiple=8)
    assert bucketed.memory_bytes() < 0.8 * single.memory_bytes()
    jax_b = JaxBucketed.build(*map(jnp.asarray, data[1:]),
                              bucket_sizes=(32, 64, 96), dtype="int8",
                              docs_pad_multiple=8)
    assert bucketed.memory_bytes() == jax_b.memory_bytes()


def test_rerank_and_gather(data):
    q, docs, lengths = _t(*data)
    idx = BucketedDenseIndex.build(docs, lengths, bucket_sizes=(32, 64, 96),
                                   dtype="float32")
    ids = torch.tensor([[5, 40, 90, -1], [0, 1, 2, 3]], dtype=torch.int32)
    got = idx.rerank_scores(q, ids)
    ref_all = maxsim_scores_exact(q, docs, lengths)
    for b in range(2):
        for j, cid in enumerate(ids[b].tolist()):
            if cid < 0:
                assert float(got[b, j]) < -1e20
            else:
                assert float(got[b, j]) == pytest.approx(
                    float(ref_all[b, cid]), rel=2e-4)


def test_save_load_roundtrip(data, tmp_path):
    q, docs, lengths = _t(*data)
    idx = BucketedDenseIndex.build(docs, lengths, bucket_sizes=(32, 96),
                                   dtype="int8")
    idx.save(tmp_path / "bidx")
    idx2 = BucketedDenseIndex.load(tmp_path / "bidx", device="cpu")
    assert torch.equal(idx.search_scores(q), idx2.search_scores(q))
    for a, b in zip(idx.global_ids, idx2.global_ids):
        assert torch.equal(a, b)


def test_single_bucket_degenerates(data):
    q, docs, lengths = _t(*data)
    idx = BucketedDenseIndex.build(docs, lengths, bucket_sizes=(96,),
                                   dtype="float32")
    assert len(idx.buckets) == 1
    torch.testing.assert_close(idx.search_scores(q),
                               maxsim_scores_exact(q, docs, lengths),
                               rtol=3e-3, atol=3e-3)


def test_dense_append_matches_full_build():
    rng = np.random.default_rng(3)
    n1, n2, L, D = 150, 90, 16, 32
    toks = rng.normal(size=(n1 + n2, L, D)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    lens = rng.integers(L // 2, L + 1, n1 + n2).astype(np.int32)
    toks, lens = _t(toks, lens)
    for dtype in ("float32", "int8"):
        full = DenseTokenIndex.build(toks, lens, doc_len=L, dtype=dtype)
        inc = DenseTokenIndex.build(toks[:n1], lens[:n1], doc_len=L,
                                    dtype=dtype).append(toks[n1:], lens[n1:])
        assert (inc.n_docs, inc.n_pad) == (full.n_docs, full.n_pad)
        assert torch.equal(inc.doc_lengths, full.doc_lengths)
        assert torch.equal(inc.emb_flat, full.emb_flat)
        if dtype == "int8":
            torch.testing.assert_close(inc.scales, full.scales, rtol=1e-6,
                                       atol=0)
        torch.testing.assert_close(inc.pooled.float(), full.pooled.float(),
                                   rtol=0, atol=1e-2)


def test_bucketed_append_matches_full_build(data):
    """build(A).append(B) scores every doc as build(A+B) does, through
    existing buckets and through a NEW bucket (opened at the end of the
    list); the routing arrays equal JAX's append."""
    q, docs, lengths = _t(*data)
    n = docs.shape[0]
    split = n - 5
    kw = dict(bucket_sizes=(16, 64), docs_pad_multiple=16)
    full = BucketedDenseIndex.build(docs, lengths, dtype="int8", **kw)
    inc = BucketedDenseIndex.build(docs[:split], lengths[:split],
                                   dtype="int8", **kw)
    inc = inc.append(docs[split:], lengths[split:], **kw)
    assert inc.n_docs == full.n_docs == n
    torch.testing.assert_close(inc.search_scores(q), full.search_scores(q),
                               rtol=1e-5, atol=1e-5)
    v1, i1 = full.search_topk(q, 8)
    v2, i2 = inc.search_topk(q, 8)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(v1, v2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inc.rerank_scores(q, i2),
                               full.rerank_scores(q, i1), rtol=1e-4,
                               atol=1e-4)

    short = (lengths <= 16).numpy()
    assert short.any() and (~short).any()
    sel_s = torch.from_numpy(np.nonzero(short)[0])
    sel_l = torch.from_numpy(np.nonzero(~short)[0])
    inc2 = BucketedDenseIndex.build(docs[sel_s], lengths[sel_s],
                                    dtype="int8", **kw)
    assert len(inc2.buckets) == 1
    inc2 = inc2.append(docs[sel_l], lengths[sel_l], **kw)
    assert len(inc2.buckets) == 2
    perm = torch.cat([sel_s, sel_l])
    torch.testing.assert_close(inc2.search_scores(q),
                               full.search_scores(q)[:, perm], rtol=1e-5,
                               atol=1e-5)
    jd, jl = jnp.asarray(data[1]), jnp.asarray(data[2])
    j2 = JaxBucketed.build(jd[sel_s.numpy()], jl[sel_s.numpy()],
                           dtype="int8", **kw).append(
        jd[sel_l.numpy()], jl[sel_l.numpy()], **kw)
    for name in ("bucket_of", "row_of"):
        np.testing.assert_array_equal(getattr(inc2, name).numpy(),
                                      np.asarray(getattr(j2, name)))
    for a, b in zip(inc2.global_ids, j2.global_ids):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_layout_switch_save_clears_stale_artifacts(data, tmp_path):
    q, docs, lengths = _t(*data)
    path = tmp_path / "idx"
    bucketed = BucketedDenseIndex.build(docs, lengths, bucket_sizes=(32, 96),
                                        dtype="float32")
    bucketed.save(path)
    assert (path / "mapping.npz").exists()
    flat = DenseTokenIndex.build(docs, lengths, doc_len=96, dtype="float32")
    flat.save(path)
    assert not (path / "mapping.npz").exists()
    assert not list(path.glob("bucket_*"))
    cfg = RAGConfig(colbert_index_path=str(path),
                    bm25_index_path=str(tmp_path / "bm25"))
    LexicalIndex.build(["alpha beta"] * 4).save(cfg.bm25_index_path)
    mgr = IndexManager(cfg, device="cpu")
    mgr.load()
    assert isinstance(mgr.dense, DenseTokenIndex)
    assert torch.equal(mgr.dense.search_scores(q), flat.search_scores(q))
    # a wider bucketed save, then a narrower one: the extra bucket goes
    BucketedDenseIndex.build(docs, lengths, bucket_sizes=(32, 64, 96),
                             dtype="float32").save(path)
    bucketed.save(path)
    assert not (path / "dense.npz").exists()
    assert sorted(p.name for p in path.glob("bucket_*")) == ["bucket_0",
                                                             "bucket_1"]
    mgr2 = IndexManager(cfg, device="cpu")
    mgr2.load()
    assert isinstance(mgr2.dense, BucketedDenseIndex)
    assert torch.equal(mgr2.dense.search_scores(q), bucketed.search_scores(q))


# -- against the JAX package, every layout --------------------------------

@pytest.mark.parametrize("dtype", LAYOUTS)
def test_layout_equals_jax(dtype, data):
    """JAX's buckets (32, 64) over the same inputs: codes, scales,
    routing and lengths bit-equal; the bf16 proxies within one bf16 ulp
    (fp32 token sums in other orders); search top-k ids equal and scores
    within ATOL on the scan and the pruned routes; gather and rerank;
    memory_bytes equal."""
    q_np, docs_np, lengths_np = data
    q, docs, lengths = _t(*data)
    kw = dict(bucket_sizes=(32, 64), dtype=dtype)
    idx = BucketedDenseIndex.build(docs, lengths, **kw)
    jidx = JaxBucketed.build(jnp.asarray(docs_np), jnp.asarray(lengths_np),
                             **kw)
    assert idx.quant == jidx.quant == dtype
    assert idx.memory_bytes() == jidx.memory_bytes()
    assert idx.max_doc_len == jidx.max_doc_len == 64
    for name in ("bucket_of", "row_of"):
        np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                      np.asarray(getattr(jidx, name)))
    for sub, jsub, gid, jgid in zip(idx.buckets, jidx.buckets,
                                    idx.global_ids, jidx.global_ids):
        np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
        emb = sub.emb_flat
        if emb.dtype == torch.bfloat16:
            emb = emb.view(torch.int16)
        jemb = np.asarray(jsub.emb_flat)
        np.testing.assert_array_equal(
            emb.numpy(), jemb.view(np.int16) if jemb.dtype.itemsize == 2
            and dtype == "bfloat16" else jemb)
        for name in ("doc_lengths", "scales", "doc_scales"):
            a, b = getattr(sub, name), getattr(jsub, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(
            sub.pooled.float().numpy(),
            np.asarray(jsub.pooled.astype(jnp.float32)), rtol=2.0**-7,
            atol=1e-6)
    for prefilter in (0, 16):
        v, i = idx.search_topk(q, 10, prefilter)
        jv, ji = jidx.search_topk(jnp.asarray(q_np), 10, prefilter)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL,
                                   rtol=0)
    ids = np.array([[5, 40, 90, -1], [0, 1, 2, 95]], np.int32)
    for row in ids:
        d, ln = idx.gather_docs(torch.from_numpy(row))
        jd, jl = jidx.gather_docs(jnp.asarray(row))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    got = idx.rerank_scores(q, torch.from_numpy(ids)).numpy()
    want = np.asarray(jidx.rerank_scores(jnp.asarray(q_np),
                                         jnp.asarray(ids)))
    live = ids >= 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)
    assert (got[~live] < -1e20).all() and (want[~live] < -1e20).all()


def test_directories_cross_packages(data, tmp_path):
    """A bucketed directory saved by JAX loads and serves in the port,
    and one the port saves (from that load) holds the same arrays and
    loads in JAX."""
    q_np, docs_np, lengths_np = data
    jidx = JaxBucketed.build(jnp.asarray(docs_np), jnp.asarray(lengths_np),
                             bucket_sizes=(32, 64, 96), dtype="int4-doc")
    jidx.save(tmp_path / "jax")
    idx = BucketedDenseIndex.load(tmp_path / "jax", device="cpu")
    assert idx.quant == "int4-doc" and len(idx.buckets) == 3
    want = np.asarray(jidx.search_scores(jnp.asarray(q_np)))
    np.testing.assert_allclose(idx.search_scores(torch.from_numpy(q_np))
                               .numpy(), want, atol=ATOL, rtol=0)
    idx.save(tmp_path / "port")
    for name in ("meta.json", "bucket_0/meta.json", "bucket_2/meta.json"):
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text())
    for i in range(3):
        assert (tmp_path / f"port/bucket_{i}/global_ids.npy").read_bytes() \
            == (tmp_path / f"jax/bucket_{i}/global_ids.npy").read_bytes()
        with np.load(tmp_path / f"port/bucket_{i}/dense.npz") as a, \
                np.load(tmp_path / f"jax/bucket_{i}/dense.npz") as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    back = JaxBucketed.load(tmp_path / "port")
    np.testing.assert_array_equal(
        np.asarray(back.search_scores(jnp.asarray(q_np))), want)
    # a save from before global_ids were padded loads padded with -1
    short = np.load(tmp_path / "port/bucket_0/global_ids.npy")
    n0 = idx.buckets[0].n_docs
    np.save(tmp_path / "port/bucket_0/global_ids.npy", short[:n0])
    again = BucketedDenseIndex.load(tmp_path / "port", device="cpu")
    np.testing.assert_array_equal(again.global_ids[0].numpy(), short)


def test_merged_topk_ties_follow_bucket_order():
    """Two docs with equal scores in different buckets: the merged top-k
    puts the one from the earlier bucket first even though its global id
    is larger (concatenation order, as ``lax.top_k`` over JAX's
    concatenated lists), on both packages."""
    rng = np.random.default_rng(7)
    d = 128
    rows = rng.standard_normal((10, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    docs = np.zeros((6, 64, d), np.float32)
    lengths = np.array([40, 10, 8, 8, 50, 8], np.int32)
    docs[0, :40] = np.tile(rows, (4, 1))       # the same rows, repeated
    docs[1, :10] = rows
    noise = rng.standard_normal((4, 64, d)).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=-1, keepdims=True)
    docs[2:] = noise * (np.arange(64)[None, :, None]
                        < lengths[2:, None, None])
    q = rows[None, :8].copy()
    for dtype in ("float32", "int8"):
        idx = BucketedDenseIndex.build(*_t(docs, lengths),
                                       bucket_sizes=(32, 64), dtype=dtype)
        jidx = JaxBucketed.build(jnp.asarray(docs), jnp.asarray(lengths),
                                 bucket_sizes=(32, 64), dtype=dtype)
        v, i = idx.search_topk(torch.from_numpy(q), 3)
        jv, ji = jidx.search_topk(jnp.asarray(q), 3)
        assert float(v[0, 0]) == float(v[0, 1])
        assert i[0, :2].tolist() == [1, 0]
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# -- the cascade ------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX indexes CORPUS once per layout (bucketed, buckets (32, 64),
    tiny encoder); the port loads each directory with JAX's tokenizer and
    params."""
    root = tmp_path_factory.mktemp("bucketed")
    tok = JaxTokenizer.train_bpe(CORPUS, vocab_size=512)
    tok.save(root / "tok.json")
    jenc = JaxEncoder(JaxColCfg.tiny(vocab_size=tok.vocab_size), tok)
    jenc.save_params(str(root / "params.npz"))
    ptok = ColBERTTokenizer.load(root / "tok.json")
    penc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=ptok.vocab_size),
                          ptok, params=ColBERTEncoder.load_params(
                              str(root / "params.npz")), device="cpu")
    embs, lengths = jenc.encode_docs(CORPUS)
    lex = JaxLexicalIndex.build(CORPUS)
    jmgrs = {}
    for dtype in LAYOUTS:
        cfg = JaxConfig(**_paths(root / dtype))
        jmgrs[dtype] = mgr = JaxManager(cfg, jenc)
        mgr.lexical, mgr.corpus = lex, CORPUS
        mgr.dense = JaxBucketed.build(embs, lengths,
                                      bucket_sizes=(32, 64), dtype=dtype)
        assert len(mgr.dense.buckets) == 2
        lex.save(cfg.bm25_index_path)
        mgr.dense.save(cfg.colbert_index_path)
    return root, jenc, jmgrs, penc


def _paths(root, **kw):
    return dict(bm25_index_path=str(root / "bm25"),
                colbert_index_path=str(root / "colbert"), **kw)


def _port_retriever(root, dtype, penc, **kw):
    cfg = RAGConfig(**_paths(root / dtype, fusion_candidates=16,
                             final_top_k=8, **kw),
                    mesh=MeshConfig(index_layout="bucketed",
                                    doc_token_buckets=(32, 64),
                                    index_dtype=dtype))
    mgr = IndexManager(cfg, penc, device="cpu")
    mgr.load()
    assert isinstance(mgr.dense, BucketedDenseIndex)
    return HybridRetriever(cfg, mgr, penc, device="cpu")


@pytest.mark.parametrize("dtype", LAYOUTS)
def test_cascade_equals_jax_and_composed(dtype, served):
    """Both dense routes (scan, pruned with final rrf): the port's fused
    bucketed cascade gives JAX's ``retrieve_batch`` ids (scores within
    ATOL) and its own composed oracle's ids (scores within 1e-5)."""
    root, jenc, jmgrs, penc = served
    for kw in (dict(dense_prefilter=0),
               dict(dense_prefilter=32, final_fusion="rrf",
                    fusion_weight_bm25=0.75)):
        r = _port_retriever(root, dtype, penc, **kw)
        jr = JaxRetriever(JaxConfig(**_paths(root / dtype,
                                             fusion_candidates=16,
                                             final_top_k=8, **kw)),
                          jmgrs[dtype], jenc)
        ids, scores = r.retrieve_batch(QUERIES, 8)
        assert isinstance(r.build_entry(8), cascade.FusedBucketedCascade)
        jids, jscores = jr.retrieve_batch(QUERIES, 8)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(scores, np.asarray(jscores), atol=ATOL,
                                   rtol=0)
        q_emb = penc.encode_queries(QUERIES)
        q_terms = torch.as_tensor(encode_query_terms(
            r.indexes.lexical, QUERIES, r.config.query_max_terms,
            r.config.query_term_buckets))
        cids, cscores = r._cascade_bucketed_composed(q_emb, q_terms, 8)
        np.testing.assert_array_equal(ids, cids)
        np.testing.assert_allclose(scores, cscores, rtol=1e-5, atol=1e-5)


@pytest.fixture
def fresh_caches(monkeypatch):
    jc, pc = JaxJitCache(max_entries=4), JitCache(max_entries=4)
    monkeypatch.setattr(jax_cascade, "_FUSED_CACHE", jc)
    monkeypatch.setattr(cascade, "_FUSED_CACHE", pc)
    return jc, pc


def test_fused_cache_keys_and_eviction(fresh_caches, tmp_path):
    """A bucketed index of short docs only (one bucket) grows by
    ``add_documents`` with long docs: the append opens a second bucket
    and reuses the first bucket's tensors untouched; the next call builds
    a new entry keyed by the new geometries (as JAX's key does) and the
    rebind evicts every entry reading a tensor the new index dropped
    (the routing tensors), which then die."""
    jc, pc = fresh_caches
    tok = JaxTokenizer.train_bpe(CORPUS, vocab_size=512)
    tok.save(tmp_path / "tok.json")
    ptok = ColBERTTokenizer.load(tmp_path / "tok.json")
    enc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=ptok.vocab_size),
                         ptok, seed=2, device="cpu")
    mesh = dict(index_layout="bucketed", doc_token_buckets=(32, 64))
    cfg = RAGConfig(**_paths(tmp_path, dense_prefilter=0),
                    mesh=MeshConfig(**mesh))
    mgr = IndexManager(cfg, enc, device="cpu")
    mgr.build_all(CORPUS[:40])
    assert len(mgr.dense.buckets) == 1
    r = HybridRetriever(cfg, mgr, enc, device="cpu")
    r.retrieve_batch(QUERIES, 3)
    HybridRetriever(RAGConfig(**_paths(tmp_path, dense_prefilter=64),
                              mesh=MeshConfig(**mesh)), mgr, enc,
                    device="cpu").retrieve_batch(QUERIES, 3)
    assert (pc.builds, len(pc)) == (2, 2)
    (entry,) = [e for e in pc._d.values()
                if e.statics["prefilter"] == 0]
    assert len(entry.geoms) == 1
    old = [mgr.dense.bucket_of, mgr.dense.row_of, *mgr.dense.global_ids]
    old_ids = {id(t) for t in old}
    alive = weakref.ref(mgr.dense.bucket_of)
    kept = mgr.dense.buckets[0].emb_flat
    mgr.add_documents(CORPUS)
    assert len(mgr.dense.buckets) == 2
    assert mgr.dense.buckets[0].emb_flat is kept
    ids, _ = r.retrieve_batch(QUERIES, 3)
    assert (pc.builds, len(pc)) == (3, 1)
    (entry,) = pc._d.values()
    assert [g[1] for g in entry.geoms] == [32, 64]
    assert not any(e.reads_any(old_ids) for e in pc._d.values())
    del old, entry
    gc.collect()
    assert alive() is None
    # JAX keys the same way: a new bucket geometry is a new entry
    jenc = JaxEncoder(JaxColCfg.tiny(vocab_size=tok.vocab_size), tok)
    jcfg = JaxConfig(**_paths(tmp_path / "jax", dense_prefilter=0),
                     mesh=JaxMesh(**mesh))
    jmgr = JaxManager(jcfg, jenc)
    jmgr.build_all(CORPUS[:40])
    jr = JaxRetriever(jcfg, jmgr, jenc)
    jr._build_fused_bucketed(3)
    jmgr.add_documents(CORPUS)
    jr._check_binding()
    jr._build_fused_bucketed(3)
    assert jc.builds == 2


# -- the app and the gate ----------------------------------------------------

def _app_kw(root, **over):
    kw = dict(db_path=str(root / "rag.db"),
              bm25_index_path=str(root / "idx/bm25"),
              colbert_index_path=str(root / "idx/colbert"),
              tokenizer_path=str(root / "idx/tok.json"),
              images_dir=str(root / "img"),
              min_chunk_size=48, max_chunk_size=96, doc_max_tokens=128,
              encoder_preset="tiny", tokenizer_vocab_size=1024,
              encoder_train_steps=0, final_fusion="rerank")
    kw.update(over)
    return kw


def _ids(rows):
    return [[r["chunk_id"] for r in b] for b in rows]


def test_app_bucketed_upload_append_convert_equal_jax(tmp_path):
    """An app over ``index_layout="bucketed"`` with the JAX app's
    tokenizer and encoder params (copied in before its first upload):
    the upload, a second upload on the incremental ``add_documents``
    path and ``convert_index`` each give the JAX app's ids; ``stats``
    has JAX's keys and ``memory_bytes`` equals JAX's."""
    docs = write_corpus(tmp_path / "docs", n_docs=6, seed=0)
    mesh = dict(index_layout="bucketed", doc_token_buckets=(32, 64, 128))
    japp = JaxApp(JaxConfig(**_app_kw(tmp_path / "jax"),
                            mesh=JaxMesh(**mesh)), use_ollama=False)
    app = RAGApplication(RAGConfig(**_app_kw(tmp_path / "port"),
                                   mesh=MeshConfig(**mesh)),
                         use_ollama=False, device="cpu")
    queries = ["galaxy telescope observations", "ocean tide current",
               "compiler kernel memory"]

    def same():
        got, want = app.query_batch(queries), japp.query_batch(queries)
        assert _ids(got) == _ids(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose([r["score"] for r in g],
                                       [r["score"] for r in w], atol=ATOL)
        assert app.indexes.dense.memory_bytes() == \
            japp.indexes.dense.memory_bytes()

    japp.index_documents([str(p) for p in docs[:4]])
    japp.initialize_chatbot(use_mesh=False)
    (tmp_path / "port/idx/colbert").mkdir(parents=True)
    for name in ("tok.json", "colbert/encoder_params.npz",
                 "colbert/encoder_config.json"):
        shutil.copy(tmp_path / "jax/idx" / name, tmp_path / "port/idx" / name)
    app.index_documents([str(p) for p in docs[:4]])
    app.initialize_chatbot()
    assert isinstance(app.indexes.dense, BucketedDenseIndex)
    assert len(app.indexes.dense.buckets) >= 2
    same()
    outs = [a.index_documents([str(p) for p in docs[4:]])
            for a in (japp, app)]
    assert all("colbert_append" in o["timings"] for o in outs)
    assert outs[0]["total_chunks"] == outs[1]["total_chunks"]
    same()
    assert japp.convert_index("int8-doc") == app.convert_index("int8-doc")
    assert app.indexes.dense.quant == "int8-doc"
    same()
    assert set(app.stats()) == set(japp.stats())


def test_gate_over_bucketed_equals_jax(tmp_path):
    """The measured gate over a bucketed index JAX built and the port
    loaded, with the fusion weight pinned (the two-entry menu; the full
    menu's selection is held in test_torch_gate.py): the same verdict
    and details; its retrievers' entries are bucketed ones."""
    corpus = []
    for doc in jax_generate_corpus(5, seed=0):
        corpus += [p.strip() for p in doc.split("\n\n") if len(p) > 40]
    assert len(corpus) >= gate.MIN_GATE_CHUNKS
    paths = _paths(tmp_path)
    mesh = dict(index_layout="bucketed", doc_token_buckets=(32, 64, 128))
    jtok = JaxTokenizer.train_bpe(corpus, vocab_size=1024)
    jtok.save(tmp_path / "tok.json")
    jenc = JaxEncoder(JaxColCfg.tiny(vocab_size=jtok.vocab_size), jtok,
                      seed=1)
    jenc.save_params(str(tmp_path / "params.npz"))
    jcfg = JaxConfig(**paths, mesh=JaxMesh(**mesh))
    jmgr = JaxManager(jcfg, jenc)
    jmgr.build_all(corpus)
    assert len(jmgr.dense.buckets) >= 2
    ttok = ColBERTTokenizer.load(tmp_path / "tok.json")
    tenc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=ttok.vocab_size),
                          ttok, params=ColBERTEncoder.load_params(
                              str(tmp_path / "params.npz")), device="cpu")
    tcfg = RAGConfig(**paths, mesh=MeshConfig(**mesh))
    tmgr = IndexManager(tcfg, tenc, device="cpu")
    tmgr.load()
    want = jax_gate.resolve_final_fusion(jcfg, jmgr, jenc, corpus,
                                         n_queries=40, fixed_weight=0.75)
    before = cascade._FUSED_CACHE.builds
    got = gate.resolve_final_fusion(tcfg, tmgr, tenc, corpus, n_queries=40,
                                    fixed_weight=0.75)
    assert got == want
    assert cascade._FUSED_CACHE.builds > before
    assert any(isinstance(e, cascade.FusedBucketedCascade)
               for e in cascade._FUSED_CACHE._d.values())
