"""The port's sharded serving (parallel/mesh.py, parallel/sharded.py)
against the JAX package's, on the CPU.

JAX runs on the conftest's 8 virtual CPU devices; the port runs the same
mesh shape over ``[cpu] * S`` (a mesh may repeat a device). On the corpus
and queries of ``tests/test_sharded.py`` (its tiny encoder, carried
across through ``encoder_params.npz``; its index saved by JAX and loaded
by the port, bytes intact), port ``ShardedRetriever`` must return JAX
``ShardedRetriever``'s ids, scores within rtol 1e-4, atol 1e-4 (the JAX
tests' own), for every flat layout, both dense routes, union mode,
``shard_bm25``, meshes of 2, 4 and 8 shards and a ``top_k_final`` above
the config's; then port ``ShardedBucketedRetriever`` against JAX's on
``tests/test_bucketed.py``'s bucketed case. Then the port alone: sharded
against single-device, the slicing rules, ties across shards, and
``resolve_index_dtype("auto")`` counting the data-axis extent as JAX does.
"""

import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.config import MeshConfig as JaxMesh
from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.index.bucketed import (
    BucketedDenseIndex as JaxBucketed)
from hybrid_rag_colbertv2_tpu.index.dense import (
    DenseTokenIndex as JaxDense)
from hybrid_rag_colbertv2_tpu.index.lexical import LexicalIndex as JaxLex
from hybrid_rag_colbertv2_tpu.models.colbert import (
    ColBERTConfig as JaxColCfg, ColBERTEncoder as JaxEncoder)
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer)
from hybrid_rag_colbertv2_tpu.parallel import mesh as jax_mesh
from hybrid_rag_colbertv2_tpu.parallel import sharded as jax_sharded
from hybrid_rag_colbertv2_tpu.utils import profiling as jax_profiling
from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig, RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.bucketed import BucketedDenseIndex
from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
    ColBERTConfig, ColBERTEncoder)
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import ColBERTTokenizer
from hybrid_rag_colbertv2_tpu_torch.parallel import mesh as pmesh
from hybrid_rag_colbertv2_tpu_torch.parallel import sharded
from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import HybridRetriever

RTOL = ATOL = 1e-4
CPU = torch.device("cpu")
# tests/test_sharded.py's corpus and queries
CORPUS = [
    f"document {i} talks about topic {i % 7} and subject {i % 5} "
    f"with details on item {i}"
    for i in range(96)
] + [
    "TPUs multiply matrices using a systolic array called the MXU",
    "JAX compiles numerical programs with XLA for TPUs and GPUs",
    "Information retrieval ranks documents by relevance to a query",
    "Reciprocal rank fusion combines rankings from multiple retrievers",
]
QUERIES = [
    "systolic array matrix multiplication on TPU",
    "topic 3 subject 2 details",
    "rank fusion retrievers",
    "document 42",
]
LAYOUTS = ("float32", "int8", "int8-doc", "int4-doc", "bfloat16")


def _port_encoder(root, tok, enc, **cfg):
    """The port's encoder with the JAX encoder's tokenizer and params."""
    tok.save(root / "tokenizer.json")
    enc.save_params(str(root / "encoder_params.npz"))
    ptok = ColBERTTokenizer.load(root / "tokenizer.json")
    return ColBERTEncoder(
        ColBERTConfig.tiny(vocab_size=ptok.vocab_size, **cfg), ptok,
        params=ColBERTEncoder.load_params(str(root / "encoder_params.npz")),
        device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_sharded.py's setup in both packages, and each layout's
    index built by JAX and loaded by the port (on demand, once)."""
    root = tmp_path_factory.mktemp("sharded")
    tok = JaxTokenizer.train_bpe(CORPUS, vocab_size=512)
    enc = JaxEncoder(JaxColCfg.tiny(vocab_size=tok.vocab_size), tok, seed=0)
    lex = JaxLex.build(CORPUS)
    lex.save(root / "bm25")
    embs, lengths = enc.encode_docs(CORPUS, doc_len=64)
    w = SimpleNamespace(root=root, enc=enc, lex=lex, penc=_port_encoder(
        root, tok, enc), plex=LexicalIndex.load(root / "bm25"), dense={})

    def dense(dtype):
        if dtype not in w.dense:
            jd = JaxDense.build(embs, lengths, doc_len=64, dtype=dtype)
            jd.save(root / dtype)
            w.dense[dtype] = (jd, DenseTokenIndex.load(root / dtype,
                                                       device="cpu"))
        return w.dense[dtype]
    w.get = dense
    return w


def _cpu_mesh(n, **kw):
    return pmesh.make_mesh(MeshConfig(mesh_shape=(n, 1), **kw),
                           devices=[CPU] * n)


# (layout, dense_prefilter, shards, config overrides)
CASES = [
    ("float32", 0, 8, {}),
    ("int8", 0, 8, {}),
    ("int8", 32, 8, {}),
    ("int8-doc", 0, 8, {}),
    ("int8-doc", 32, 8, {}),
    ("int4-doc", 0, 8, {}),
    ("bfloat16", 0, 8, {}),
    ("float32", 0, 8, {"final_fusion": "union"}),
    ("float32", 0, 8, {"shard_bm25": True}),
    ("int8", 0, 8, {"shard_bm25": True}),
    ("float32", 0, 2, {}),
    ("float32", 0, 4, {}),
]


def _configs(prefilter, over):
    over = dict(over)
    shard_bm25 = over.pop("shard_bm25", False)
    jcfg = JaxConfig(dense_prefilter=prefilter, **over)
    pcfg = RAGConfig(dense_prefilter=prefilter, **over)
    jcfg.mesh.shard_bm25 = pcfg.mesh.shard_bm25 = shard_bm25
    return jcfg, pcfg


@pytest.mark.parametrize("dtype,prefilter,n_shards,over", CASES,
                         ids=[f"{d}-p{p}-s{s}" + "".join(f"-{k}" for k in o)
                              for d, p, s, o in CASES])
def test_port_sharded_equals_jax_sharded(world, dtype, prefilter, n_shards,
                                         over):
    jd, pd = world.get(dtype)
    jcfg, pcfg = _configs(prefilter, over)
    jm = jax_mesh.make_mesh(JaxMesh(mesh_shape=(n_shards, 1)))
    want = jax_sharded.ShardedRetriever(
        jcfg, jm, world.lex, jax_mesh.shard_dense_index(jd, jm),
        world.enc).retrieve_batch(QUERIES)
    pm = _cpu_mesh(n_shards)
    r = sharded.ShardedRetriever(pcfg, pm, world.plex,
                                 pmesh.shard_dense_index(pd, pm), world.penc)
    got = r.retrieve_batch(QUERIES)
    assert got[0].shape == (len(QUERIES), pcfg.final_top_k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert set(r.last_timings) == {"tokenize", "cascade"}


def test_top_k_final_larger_than_config(world):
    """retrieve_batch(top_k_final > config.final_top_k) returns the
    requested width, JAX's ids (tests/test_sharded.py:275)."""
    jd, pd = world.get("float32")
    jm = jax_mesh.make_mesh(JaxMesh(mesh_shape=(8, 1)))
    want = jax_sharded.ShardedRetriever(
        JaxConfig(), jm, world.lex, jax_mesh.shard_dense_index(jd, jm),
        world.enc).retrieve_batch(["systolic array"], top_k_final=20)
    pm = _cpu_mesh(8)
    r = sharded.ShardedRetriever(RAGConfig(), pm, world.plex,
                                 pmesh.shard_dense_index(pd, pm), world.penc)
    assert r.config.final_top_k == 10
    ids, scores = r.retrieve_batch(["systolic array"], top_k_final=20)
    assert ids.shape == (1, 20) and scores.shape == (1, 20)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(scores, want[1], rtol=RTOL, atol=ATOL)


# -- bucketed x sharded: tests/test_bucketed.py:96 -------------------------

BUCKET_CORPUS = ([f"short doc {i} topic {i % 7}" for i in range(80)]
                 + [f"long document {i} about topic {i % 7} "
                    + " ".join(f"w{j}" for j in range(40))
                    for i in range(48)])
BUCKET_QUERIES = ["topic 3 w12", "short doc 41"]


@pytest.fixture(scope="module")
def bucket_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("bucketed_sharded")
    tok = JaxTokenizer.train_bpe(BUCKET_CORPUS, vocab_size=512)
    enc = JaxEncoder(JaxColCfg.tiny(vocab_size=tok.vocab_size,
                                    colbert_dim=128), tok, seed=0)
    lex = JaxLex.build(BUCKET_CORPUS)
    lex.save(root / "bm25")
    embs, lengths = enc.encode_docs(BUCKET_CORPUS, doc_len=64)
    return SimpleNamespace(
        root=root, enc=enc, lex=lex, embs=embs, lengths=lengths,
        penc=_port_encoder(root, tok, enc, colbert_dim=128),
        plex=LexicalIndex.load(root / "bm25"))


@pytest.mark.parametrize("dtype,prefilter", [("int8", 0), ("int8", 32),
                                             ("int4-doc", 0)])
def test_port_sharded_bucketed_equals_jax(bucket_world, dtype, prefilter):
    w = bucket_world
    # buckets of 80 and 48 docs padded to 16: 10 and 6 docs per shard
    jb = JaxBucketed.build(w.embs, w.lengths, bucket_sizes=(32, 64),
                           dtype=dtype, docs_pad_multiple=16)
    assert len(jb.buckets) == 2
    jb.save(w.root / f"{dtype}-{prefilter}")
    pb = BucketedDenseIndex.load(w.root / f"{dtype}-{prefilter}",
                                 device="cpu")
    kw = dict(final_top_k=5, fusion_candidates=16, dense_prefilter=prefilter)
    jm = jax_mesh.make_mesh(JaxMesh(mesh_shape=(8, 1)))
    want = jax_sharded.ShardedBucketedRetriever(
        JaxConfig(**kw), jm, w.lex, jax_mesh.shard_bucketed_index(jb, jm),
        w.enc).retrieve_batch(BUCKET_QUERIES)
    pm = _cpu_mesh(8)
    sb = pmesh.shard_bucketed_index(pb, pm)
    assert [b.n_local for b in sb.buckets] == [10, 6]
    got = sharded.ShardedBucketedRetriever(
        RAGConfig(**kw), pm, w.plex, sb, w.penc).retrieve_batch(
            BUCKET_QUERIES)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


# -- the port alone --------------------------------------------------------

@pytest.mark.parametrize("dtype", LAYOUTS)
def test_sharded_equals_single_device_route0(world, dtype):
    """Route 0 over 8 shards of 16 docs (below colbert_top_k = 100, the
    prefilter's 128 and the kernels' 64-row chunks): the single-device
    HybridRetriever's ids. Its rerank rounds differently
    (``candidate_sims`` against ``maxsim_scores_exact``): scores within
    the tolerance."""
    _, pd = world.get(dtype)
    cfg = RAGConfig()
    mgr = IndexManager(cfg, world.penc, device="cpu")
    mgr.lexical, mgr.dense = world.plex, pd
    want = HybridRetriever(cfg, mgr, world.penc,
                           device="cpu").retrieve_batch(QUERIES)
    pm = _cpu_mesh(8)
    r = sharded.ShardedRetriever(cfg, pm, world.plex,
                                 pmesh.shard_dense_index(pd, pm), world.penc)
    fn = r._fn_for(cfg.final_top_k)
    assert (fn.n_local, fn.ke) == (16, 16) and fn.ke < cfg.colbert_top_k
    got = r.retrieve_batch(QUERIES)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    # the cascade is memoised module-wide, keyed as JAX keys it
    r2 = sharded.ShardedRetriever(cfg, _cpu_mesh(8), world.plex, r.dense,
                                  world.penc)
    assert r2._fn_for(cfg.final_top_k) is fn


def test_cache_entry_keeps_no_encoder_alive(world):
    """An entry of the module-wide ``_SHARDED_CACHE`` holds no weights:
    the key carries the encoder's geometry and the retriever passes its
    model on each call. Once a retriever and its encoder are dropped, a
    weakref to the model dies while the entry stays, and an encoder of
    the same geometry with other weights reuses the entry with its own
    weights (route 0: the single-device retriever's ids)."""
    _, pd = world.get("int8")
    cfg = RAGConfig()
    pm = _cpu_mesh(2)
    sd = pmesh.shard_dense_index(pd, pm)
    geom, tok = world.penc.cfg, world.penc.tokenizer
    enc = ColBERTEncoder(geom, tok, seed=3, device="cpu")
    r = sharded.ShardedRetriever(cfg, pm, world.plex, sd, enc)
    r.retrieve_batch(QUERIES)
    fn = r._fn_for(cfg.final_top_k)
    model = weakref.ref(enc.model)
    del r, enc
    gc.collect()
    assert model() is None
    assert any(e is fn for e in sharded._SHARDED_CACHE._d.values())
    enc2 = ColBERTEncoder(geom, tok, seed=4, device="cpu")
    r2 = sharded.ShardedRetriever(cfg, pm, world.plex, sd, enc2)
    assert r2._fn_for(cfg.final_top_k) is fn
    mgr = IndexManager(cfg, enc2, device="cpu")
    mgr.lexical, mgr.dense = world.plex, pd
    want = HybridRetriever(cfg, mgr, enc2,
                           device="cpu").retrieve_batch(QUERIES)
    got = r2.retrieve_batch(QUERIES)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)


def test_shard_slicing_rules(world):
    """Views where the shard's device is the source's; int4 group scales
    (G, N) cut on their minor axis and made contiguous; ``full()``
    restores the index; ``n_pad % S != 0`` raises with JAX's message."""
    for dtype in ("int8", "int4-doc"):
        _, pd = world.get(dtype)
        sd = pmesh.shard_dense_index(pd, _cpu_mesh(8))
        assert sd.n_local == 16 and sd.devices == [CPU] * 8
        for s, sh in enumerate(sd.shards):
            assert sh.emb_flat.untyped_storage().data_ptr() == \
                pd.emb_flat.untyped_storage().data_ptr()
            assert sh.n_docs == min(16, max(0, pd.n_docs - 16 * s))
            if dtype == "int4-doc":
                assert sh.doc_scales.shape == (pd.doc_scales.shape[0], 16)
                assert sh.doc_scales.is_contiguous()
                assert torch.equal(sh.doc_scales,
                                   pd.doc_scales[:, 16 * s:16 * (s + 1)])
        back = sd.full()
        for name in ("emb_flat", "doc_lengths", "scales", "pooled",
                     "doc_scales"):
            a, b = getattr(back, name), getattr(pd, name)
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b), name
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        pmesh.shard_dense_index(pd, _cpu_mesh(3))
    with pytest.raises(ValueError, match="needs more than 2 devices"):
        pmesh.make_mesh(MeshConfig(mesh_shape=(4, 1)), devices=[CPU] * 2)
    m = pmesh.make_mesh(MeshConfig(mesh_shape=(2, 2)), devices=[CPU] * 4)
    assert m.shape == {"data": 2, "model": 2}
    same = pmesh.make_mesh(MeshConfig(mesh_shape=(2, 2)), devices=[CPU] * 4)
    assert m == same and hash(m) == hash(same) and m != _cpu_mesh(4)
    assert pmesh.visible_devices("cpu") == [CPU]


def test_identical_docs_on_two_shards_lower_id_first():
    """Two copies of one doc on shards 0 and 3 tie on every score: the
    merge returns the lower global id first, as one device does."""
    rng = np.random.default_rng(5)
    n, L, d = 120, 32, 32
    embs = rng.standard_normal((n, L, d)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    embs[53] = embs[5]
    lengths = np.full(n, L, np.int32)
    words = [f"w{i}" for i in range(n)]
    lex = LexicalIndex.build([f"{w} {w}x" for w in words])
    dense = DenseTokenIndex.build(torch.from_numpy(embs),
                                  torch.from_numpy(lengths), doc_len=L,
                                  dtype="float32")
    q = torch.from_numpy(embs[5][None, :8].copy())
    q_terms = np.full((1, 4), -1, np.int64)
    cfg = RAGConfig(final_fusion="rerank")
    pm = _cpu_mesh(8)
    r = sharded.ShardedRetriever(cfg, pm, lex,
                                 pmesh.shard_dense_index(dense, pm), None)
    ids, scores = r.retrieve_embedded(q, q_terms)
    assert list(ids[0, :2]) == [5, 53] and scores[0, 0] == scores[0, 1]
    v, g = sharded.merge_shard_topk(
        [torch.tensor([[1.0, 0.5]]), torch.tensor([[1.0, 0.75]])],
        [torch.tensor([[3, 1]]), torch.tensor([[20, 17]])], 3, CPU)
    assert g.tolist() == [[3, 20, 17]] and v.tolist() == [[1.0, 1.0, 0.75]]


def test_auto_dtype_counts_the_data_axis_like_jax(monkeypatch):
    """``index_dtype="auto"`` sizes the index per shard of the data axis
    of the mesh the app will serve on (JAX ``config.py:89-96``): with 8
    cards the port picks what JAX picks for the same card memory, where
    it used to count one shard."""
    limit = 80 * 2**30
    monkeypatch.setattr(jax_profiling, "device_memory_stats",
                        lambda: {"d": {"bytes_limit": limit}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pmesh, "visible_devices", lambda device=None: [
        torch.device("cuda", i) for i in range(8)])
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (0, limit))
    seen = set()
    for shape in (None, (2, 4), (8, 1)):
        for n_docs in (1_000_000, 5_000_000, 40_000_000):
            want = JaxMesh(index_dtype="auto", mesh_shape=shape
                           ).resolve_index_dtype(n_docs, 128)
            got = MeshConfig(index_dtype="auto", mesh_shape=shape
                             ).resolve_index_dtype(n_docs, 128,
                                                   device="cuda:0")
            assert got == want, (shape, n_docs)
            seen.add((shape, n_docs, got))
    assert (None, 5_000_000, "int8") in seen          # 8 shards: fits
    assert ((2, 4), 40_000_000, "int4-doc") in seen
    assert MeshConfig(index_dtype="auto").resolve_index_dtype(
        5_000_000, 128, device="cpu") == "int8"
