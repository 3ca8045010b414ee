"""The port's fused cascade cache against the JAX package's.

``fused_cascade_fn`` memoizes encoder forward + cascade in the bounded
``_FUSED_CACHE`` (a ``JitCache``), one entry per (model geometry, query
length, statics) as in JAX, plus the identities of the tensors a CUDA
graph would read: the encoder's parameters and the bound index. On the
CPU an entry runs eagerly, so these tests exercise the keying, the LRU
and the eviction on a rebind; ``chip_smoke.py`` drives the graphs.

The JAX side's cache is driven through ``HybridRetriever._build_fused``,
the call its ``retrieve_batch`` makes once per batch: it builds the jit
object without compiling it, so the cache counts are JAX's exactly at
the cost of no compile.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import hybrid_rag_colbertv2_tpu.retrieval.cascade as jax_cascade
from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.index.manager import IndexManager as JaxManager
from hybrid_rag_colbertv2_tpu.models.colbert import (
    ColBERTConfig as JaxColCfg, ColBERTEncoder as JaxEncoder)
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer)
from hybrid_rag_colbertv2_tpu.retrieval.cascade import (
    HybridRetriever as JaxRetriever)
from hybrid_rag_colbertv2_tpu.utils.cache import JitCache as JaxJitCache
import hybrid_rag_colbertv2_tpu_torch.retrieval.cascade as cascade
from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
    ColBERTConfig, ColBERTEncoder)
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import ColBERTTokenizer
from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import HybridRetriever
from hybrid_rag_colbertv2_tpu_torch.utils.cache import JitCache

CORPUS = [f"document {i} about topic {i % 5} item {i}" for i in range(40)]
QUERIES = ["topic 3 item 7", "document 12", "item 30 about topic 0"]


def test_jit_cache_lru_semantics():
    c = JitCache(max_entries=3)
    calls = []

    def mk(k):
        def build():
            calls.append(k)
            return f"fn{k}"
        return build

    for k in (1, 2, 3):
        assert c.get_or_build(k, mk(k)) == f"fn{k}"
    assert calls == [1, 2, 3] and len(c) == 3
    # hit: no rebuild, refreshes recency
    assert c.get_or_build(1, mk(1)) == "fn1"
    assert calls == [1, 2, 3]
    # overflow evicts the least recently used (2, not 1)
    c.get_or_build(4, mk(4))
    assert len(c) == 3 and 2 not in c and 1 in c
    # re-requesting the evicted key rebuilds once
    c.get_or_build(2, mk(2))
    assert calls == [1, 2, 3, 4, 2]
    # drop_where removes exactly the selected entries
    assert c.drop_where(lambda k, v: v in ("fn1", "fn2")) == 2
    assert len(c) == 1 and 4 in c and c.builds == 5


def test_jit_cache_concurrent_single_build():
    """Concurrent get_or_build for the SAME key builds once; a failed
    build releases the key so a waiter can retry."""
    c = JitCache(max_entries=8)
    n_builds = [0]
    results = []

    def build():
        n_builds[0] += 1
        time.sleep(0.05)
        return "fn"

    threads = [threading.Thread(
        target=lambda: results.append(c.get_or_build("k", build)))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert n_builds[0] == 1 and results == ["fn"] * 8

    def boom():
        raise RuntimeError("compile failed")

    with pytest.raises(RuntimeError):
        c.get_or_build("bad", boom)
    assert c.get_or_build("bad", lambda: "ok") == "ok"


def _paths(root, cls, **kw):
    return cls(bm25_index_path=str(root / "bm25"),
               colbert_index_path=str(root / "colbert"), **kw)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One corpus indexed by the JAX package (tiny encoder, seed 0,
    float32 layout) and loaded by the port; JAX encoders of seeds 0 and 1
    and the port encoders on their saved params."""
    root = tmp_path_factory.mktemp("fused")
    tok = JaxTokenizer.train_bpe(CORPUS, vocab_size=256)
    tok.save(root / "tokenizer.json")
    jencs = [JaxEncoder(JaxColCfg.tiny(vocab_size=tok.vocab_size), tok,
                        seed=s) for s in (0, 1)]
    jcfg = _paths(root, JaxConfig, fusion_candidates=24, final_top_k=4)
    jcfg.mesh.index_dtype = "float32"
    jmgr = JaxManager(jcfg, jencs[0])
    jmgr.build_all(CORPUS)
    ptok = ColBERTTokenizer.load(root / "tokenizer.json")
    pencs = []
    for s, jenc in enumerate(jencs):
        jenc.save_params(str(root / f"params{s}.npz"))
        pencs.append(ColBERTEncoder(
            ColBERTConfig.tiny(vocab_size=ptok.vocab_size), ptok,
            params=ColBERTEncoder.load_params(str(root / f"params{s}.npz")),
            device="cpu"))
    pcfg = _paths(root, RAGConfig, fusion_candidates=24, final_top_k=4)
    pmgr = IndexManager(pcfg, pencs[0], device="cpu")
    pmgr.load()
    pmgr.corpus = list(CORPUS)
    return jcfg, jmgr, jencs, pcfg, pmgr, pencs


@pytest.fixture
def fresh_caches(monkeypatch):
    """Both packages' module caches replaced by empty 4-entry ones."""
    jc, pc = JaxJitCache(max_entries=4), JitCache(max_entries=4)
    monkeypatch.setattr(jax_cascade, "_FUSED_CACHE", jc)
    monkeypatch.setattr(cascade, "_FUSED_CACHE", pc)
    return jc, pc


def test_k_cache_bounded_like_jax(pair, fresh_caches):
    """20 distinct top_k_final values through a 4-entry cache: the port's
    builds and length equal JAX's after every call, and a hot k never
    rebuilds."""
    jcfg, jmgr, jencs, pcfg, pmgr, pencs = pair
    jc, pc = fresh_caches
    jr = JaxRetriever(jcfg, jmgr, jencs[0])
    pr = HybridRetriever(pcfg, pmgr, pencs[0], device="cpu")
    n = jmgr.dense.n_docs
    for k in range(1, 21):
        jr._build_fused(min(k, jcfg.fusion_candidates, n))
        ids, _ = pr.retrieve_batch(QUERIES[:1], top_k_final=k)
        assert ids.shape == (1, min(k, pcfg.fusion_candidates))
        assert (pc.builds, len(pc)) == (jc.builds, len(jc))
    assert len(pc) == 4 and pc.builds == 20
    pr.retrieve_batch(QUERIES[:1], top_k_final=20)
    assert pc.builds == 20


def test_fresh_retriever_reuses_entry(pair, fresh_caches):
    _, _, _, pcfg, pmgr, pencs = pair
    _, pc = fresh_caches
    HybridRetriever(pcfg, pmgr, pencs[0], device="cpu").retrieve_batch(
        QUERIES)
    assert pc.builds == 1
    HybridRetriever(pcfg, pmgr, pencs[0], device="cpu").retrieve_batch(
        QUERIES)
    assert pc.builds == 1 and len(pc) == 1


def test_equal_geometry_encoders_get_their_own_entries(pair, fresh_caches):
    """Deliberately unlike JAX: two encoders of one geometry with other
    weights make two port entries (a CUDA graph reads the weights at
    fixed addresses), where JAX makes one (its params are jit
    arguments). Each serves JAX's ids for its own params."""
    jcfg, jmgr, jencs, pcfg, pmgr, pencs = pair
    jc, pc = fresh_caches
    for jenc, penc in zip(jencs, pencs):
        jids, jscores = JaxRetriever(jcfg, jmgr, jenc).retrieve_batch(
            QUERIES)
        ids, scores = HybridRetriever(pcfg, pmgr, penc,
                                      device="cpu").retrieve_batch(QUERIES)
        assert np.array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(scores, np.asarray(jscores), atol=1e-4,
                                   rtol=0)
    assert (jc.builds, len(jc)) == (1, 1)
    assert (pc.builds, len(pc)) == (2, 2)


def test_rebind_evicts_old_binding_and_frees_it(fresh_caches, tmp_path):
    """A retriever that sees a new index (IndexManager.add_documents)
    evicts every entry that reads the old index's tensors, so the old
    index's memory is freed: no entry refers to them, and a weakref to
    the old ``emb_flat`` dies after ``gc.collect()``."""
    _, pc = fresh_caches
    tok = JaxTokenizer.train_bpe(CORPUS, vocab_size=256)
    tok.save(tmp_path / "tokenizer.json")
    ptok = ColBERTTokenizer.load(tmp_path / "tokenizer.json")
    enc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=ptok.vocab_size),
                         ptok, seed=2, device="cpu")
    cfg = _paths(tmp_path, RAGConfig, dense_prefilter=0)
    mgr = IndexManager(cfg, enc, device="cpu")
    mgr.build_all(CORPUS[:30])
    r = HybridRetriever(cfg, mgr, enc, device="cpu")
    for k in (3, 5):
        r.retrieve_batch(QUERIES, top_k_final=k)
    # another route over the same index: its entry reads pooled as well
    HybridRetriever(_paths(tmp_path, RAGConfig, dense_prefilter=128), mgr,
                    enc, device="cpu").retrieve_batch(QUERIES)
    assert len(pc) == 3
    old = [t for t in (mgr.dense.emb_flat, mgr.dense.doc_lengths,
                       mgr.dense.pooled, *mgr.lexical_csr().values())]
    old_ids = {id(t) for t in old}
    alive = weakref.ref(mgr.dense.emb_flat)
    mgr.add_documents(CORPUS)
    ids, _ = r.retrieve_batch(QUERIES, top_k_final=5)   # rebinds
    assert ids.shape == (3, 5)
    assert len(pc) == 1 and pc.builds == 4
    assert not any(e.reads_any(old_ids) for e in pc._d.values())
    assert alive() is not None
    del old
    gc.collect()
    assert alive() is None
