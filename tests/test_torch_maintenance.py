"""Index maintenance and the encoder's remaining surface, port vs JAX.

* ``DenseTokenIndex.append`` and ``convert`` in every layout: the same
  numpy token embeddings go to both packages. Codes, lengths and padding
  must be bit-equal, scales within rtol 1e-6, and the bf16 proxies within
  the one-bf16-ulp bound pinned in tests/test_torch_dense.py (XLA's CPU
  compiler orders their fp32 token sums by shape).
* ``IndexManager.add_documents`` under a live retriever (the port's
  version of tests/test_cascade.py::test_retriever_rebinds_after_...).
* ``ColBERTEncoder.save_params`` / ``params_to_jax``: files either
  package writes load in the other and give the same forward (fp32,
  atol 1e-5: sums in other orders).
* bf16 activations against the JAX package's bf16 forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.index.dense import (
    DenseTokenIndex as JaxDenseTokenIndex)
from hybrid_rag_colbertv2_tpu.index.manager import IndexManager as JaxManager
from hybrid_rag_colbertv2_tpu.models import colbert as jc
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer, HashTokenizer as JaxHash)
from hybrid_rag_colbertv2_tpu.retrieval.cascade import (
    HybridRetriever as JaxRetriever)
from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models import colbert as tc
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import (
    ColBERTTokenizer, HashTokenizer)
from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import HybridRetriever

LAYOUTS = ["int8", "int8-doc", "int4-doc", "bfloat16", "float32"]
DOC_LEN, DIM = 32, 32


def _embs(n, seed, l_in=DOC_LEN + 4):
    """Unit-norm token rows, longer than DOC_LEN (the build truncates);
    lengths 0, 1, full and past full included."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l_in, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    lengths = rng.integers(1, l_in + 1, n).astype(np.int32)
    lengths[:4] = [0, 1, DOC_LEN, l_in]
    return x, lengths


def _bits(t):
    """Raw bits of a port tensor or a JAX array (bf16 as uint16)."""
    a = t.cpu() if isinstance(t, torch.Tensor) else np.asarray(t)
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _same_index(t, j):
    """Port index ``t`` against JAX index ``j`` at the stated tolerances."""
    assert t.quant == j.quant
    assert (t.n_docs, t.doc_len, t.dim, t.n_pad) == (j.n_docs, j.doc_len,
                                                     j.dim, j.n_pad)
    assert np.array_equal(_bits(t.emb_flat), _bits(j.emb_flat))
    assert np.array_equal(_bits(t.doc_lengths), _bits(j.doc_lengths))
    for a, b in ((t.scales, j.scales), (t.doc_scales, j.doc_scales)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(_bits(a), _bits(b), rtol=1e-6, atol=0)
    pt, pj = t.pooled.float().numpy(), np.asarray(j.pooled, np.float32)
    np.testing.assert_allclose(pt, pj, rtol=2.0**-7, atol=1e-6)
    assert (pt != pj).mean() <= 0.01


def _pair(dtype, n=45, seed=0):
    x, lengths = _embs(n, seed)
    j = JaxDenseTokenIndex.build(jnp.asarray(x), jnp.asarray(lengths),
                                 doc_len=DOC_LEN, dtype=dtype)
    t = DenseTokenIndex.build(torch.from_numpy(x), torch.from_numpy(lengths),
                              doc_len=DOC_LEN, dtype=dtype)
    return j, t


@pytest.mark.parametrize("dtype", LAYOUTS)
def test_append_matches_jax(dtype):
    """Old rows untouched, new docs after row n_docs, padding to 128:
    the appended index equals JAX's, and a second append crosses the
    padding multiple (45 + 50 + 40 docs: 128 -> 256 rows)."""
    j, t = _pair(dtype)
    old_rows = _bits(t.emb_flat).copy()
    for n, seed in ((50, 1), (40, 2)):
        x, lengths = _embs(n, seed)
        j = j.append(jnp.asarray(x), jnp.asarray(lengths))
        t = t.append(torch.from_numpy(x), torch.from_numpy(lengths))
        _same_index(t, j)
    assert t.n_docs == 135 and t.n_pad == 256
    rpd = DOC_LEN // 2 if dtype == "int4-doc" else DOC_LEN
    assert np.array_equal(_bits(t.emb_flat)[:45 * rpd], old_rows[:45 * rpd])


@pytest.mark.parametrize("src,dst", [(a, b) for a in LAYOUTS for b in LAYOUTS
                                     if a != b])
def test_convert_matches_jax(src, dst):
    """Every (from, to) pair of the five layouts, block by block (64-doc
    blocks of the 128 padded docs: two blocks), equals JAX's convert."""
    j, t = _pair(src, n=100)
    jc_ = j.convert(dst, block=64)
    tc_ = t.convert(dst, block=64)
    _same_index(tc_, jc_)
    assert tc_.convert(dst) is tc_


def test_add_documents_rebinds_live_retriever(tmp_path):
    """A live port retriever serves the index that add_documents grew —
    the new doc comes back — and returns the JAX retriever's ids before
    and after."""
    base = [f"document number {i} about topic{i % 5}" for i in range(12)]
    new_doc = "zyzzyva glossolalia xylophone unique marker text"
    tok = JaxTokenizer.train_bpe(base + [new_doc], vocab_size=512)
    tok.save(tmp_path / "tokenizer.json")
    jenc = jc.ColBERTEncoder(jc.ColBERTConfig.tiny(
        vocab_size=tok.vocab_size), tok)
    jenc.save_params(str(tmp_path / "params.npz"))
    ptok = ColBERTTokenizer.load(tmp_path / "tokenizer.json")
    penc = tc.ColBERTEncoder(
        tc.ColBERTConfig.tiny(vocab_size=ptok.vocab_size), ptok,
        params=tc.ColBERTEncoder.load_params(str(tmp_path / "params.npz")),
        device="cpu")
    kw = dict(doc_max_tokens=32, dense_prefilter=0, bm25_postings_cap=0)
    jmgr = JaxManager(JaxConfig(bm25_index_path=str(tmp_path / "jb"),
                                colbert_index_path=str(tmp_path / "jc"),
                                **kw), jenc)
    pmgr = IndexManager(RAGConfig(bm25_index_path=str(tmp_path / "pb"),
                                  colbert_index_path=str(tmp_path / "pc"),
                                  **kw), penc, device="cpu")
    jmgr.build_all(base)
    pmgr.build_all(base)
    jr = JaxRetriever(jmgr.config, jmgr, jenc)
    pr = HybridRetriever(pmgr.config, pmgr, penc, device="cpu")
    q = ["zyzzyva glossolalia", "document number 3"]
    ids0, _ = pr.retrieve_batch(q, 5)
    assert np.array_equal(ids0, np.asarray(jr.retrieve_batch(q, 5)[0]))
    assert 12 not in ids0[0]
    old_n_pad = pmgr.dense.n_pad
    jmgr.add_documents(base + [new_doc])
    pmgr.add_documents(base + [new_doc])
    assert pmgr.dense.n_docs == 13 and pmgr.dense.n_pad == old_n_pad
    ids1, scores1 = pr.retrieve_batch(q, 5)
    jids1, jscores1 = jr.retrieve_batch(q, 5)
    assert 12 in ids1[0], ids1
    assert np.array_equal(ids1, np.asarray(jids1))
    np.testing.assert_allclose(scores1, np.asarray(jscores1), atol=1e-4,
                               rtol=0)
    # the appended index persisted: a fresh manager loads it
    again = IndexManager(pmgr.config, penc, device="cpu")
    again.load()
    assert again.dense.n_docs == 13


def test_add_documents_rebuilds_when_corpus_shrinks(tmp_path):
    enc = tc.ColBERTEncoder(tc.ColBERTConfig.tiny(vocab_size=128),
                            HashTokenizer(128), device="cpu")
    mgr = IndexManager(RAGConfig(bm25_index_path=str(tmp_path / "b"),
                                 colbert_index_path=str(tmp_path / "c")),
                       enc, device="cpu")
    corpus = [f"chunk {i} alpha beta" for i in range(10)]
    mgr.add_documents(corpus)                # nothing loaded: a build
    assert mgr.dense.n_docs == 10
    mgr.add_documents(corpus[:6])            # shrank: a rebuild
    assert mgr.dense.n_docs == 6 and mgr.lexical.n_docs == 6
    mgr.config.mesh.index_layout = "bucketed"
    with pytest.raises(NotImplementedError, match="bucketed"):
        mgr.add_documents(corpus)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def test_save_params_loads_in_jax_and_back(tmp_path):
    """Port-saved params drive JAX's encoder to the port's embeddings,
    and JAX-saved params the port's, within 1e-5; the file holds JAX's
    keys and shapes."""
    cfg = dict(vocab_size=512, lexical_anchor=0.4)
    penc = tc.ColBERTEncoder(tc.ColBERTConfig.tiny(**cfg), HashTokenizer(512),
                             seed=7, device="cpu")
    penc.save_params(str(tmp_path / "port.npz"))
    jenc = jc.ColBERTEncoder(jc.ColBERTConfig.tiny(**cfg), JaxHash(512),
                             params=jc.ColBERTEncoder.load_params(
                                 str(tmp_path / "port.npz")))
    ref = jc.ColBERTEncoder(jc.ColBERTConfig.tiny(**cfg), JaxHash(512),
                            seed=1)
    with np.load(tmp_path / "port.npz") as f:
        saved = {k: f[k] for k in f.files}
    want = _flat(ref.params)
    assert {k: v.shape for k, v in saved.items()} == {
        k: v.shape for k, v in want.items()}
    texts = ["systolic arrays multiply matrices", "a fox", ""]
    np.testing.assert_allclose(penc.encode_queries(texts).numpy(),
                               np.asarray(jenc.encode_queries(texts)),
                               atol=1e-5, rtol=0)
    ref.save_params(str(tmp_path / "jax.npz"))
    back = tc.ColBERTEncoder(
        tc.ColBERTConfig.tiny(**cfg), HashTokenizer(512),
        params=tc.ColBERTEncoder.load_params(str(tmp_path / "jax.npz")),
        device="cpu")
    te, tl = back.encode_docs(texts, doc_len=32)
    je, jl = ref.encode_docs(texts, doc_len=32)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=0)
    assert tc.params_to_jax(back.model).keys() == want.keys()


BF16_CASES = {
    "tiny-learned-anchor": ("tiny", dict(lexical_anchor=0.5)),
    "small2-rope": ("small", dict(num_layers=2, vocab_size=512)),
}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_forward_matches_jax(name):
    """bf16 activations, fp32 parameters, JAX's casts. Outputs are
    unit-norm rows, so one bf16 ulp of an element is at most 2^-8; the
    two frameworks round bf16 at different places (where a product or
    a sum is rounded, fused or not), which costs up to about one ulp per
    layer: atol = 2^-8 per encoder layer, and the mean difference stays
    below 2^-10. JAX runs jitted, as its encoder does."""
    preset, kw = BF16_CASES[name]
    jcfg = getattr(jc.ColBERTConfig, preset)(dtype=jnp.bfloat16, **kw)
    tcfg = getattr(tc.ColBERTConfig, preset)(dtype=torch.bfloat16, **kw)
    jmodel = jc.ColBERTModel(jcfg)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32))["params"]
    tmodel = tc.ColBERTModel(tcfg)
    tmodel.load_state_dict(tc.params_from_jax(_flat(params)))
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (3, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 25:] = 0
    mask[2, 7:] = 0
    je = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask))
    assert je.dtype == jnp.bfloat16
    with torch.no_grad():
        te = tmodel.eval()(torch.from_numpy(ids).long(),
                           torch.from_numpy(mask))
    assert te.dtype == torch.bfloat16
    te, je = te.float().numpy(), np.asarray(je, np.float32)
    diff = np.abs(te - je)
    assert diff.max() <= 2.0**-8 * jcfg.num_layers, diff.max()
    assert diff.mean() < 2.0**-10, diff.mean()
    assert (te[1, 25:] == 0).all()
    # the layers ran in bf16: more than the fp32 output rounded once
    tmodel32 = tc.ColBERTModel(getattr(tc.ColBERTConfig, preset)(**kw))
    tmodel32.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        t32 = tmodel32.eval()(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask))
    assert not np.array_equal(t32.to(torch.bfloat16).float().numpy(), te)


def test_bf16_cascade_returns_jax_ids(tmp_path):
    """A JAX-built int8 index of a bf16 encoder, served by the port.
    On the JAX encoder's bf16 query embeddings the port's cascade gives
    JAX's final ids exactly (scores atol 1e-4). Through the port's own
    bf16 encoder (same params) the planted doc ranks first and every
    slot holds JAX's id except where two docs' JAX scores lie within the
    bf16 bound of each other: 32 query rows, each max moved by at most
    about one bf16 ulp (2^-8) of a unit similarity, so 32 * 2^-8."""
    from hybrid_rag_colbertv2_tpu.retrieval.cascade import (
        hybrid_cascade as jax_cascade)
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        hybrid_cascade, pack_query_batch)
    words = [f"w{i}q{i * 7 % 13}" for i in range(400)]
    rng = np.random.default_rng(5)
    corpus = [" ".join(rng.choice(words, 9, replace=False))
              for _ in range(48)]
    tok = JaxTokenizer.train_bpe(corpus, vocab_size=512)
    tok.save(tmp_path / "tokenizer.json")
    jenc = jc.ColBERTEncoder(jc.ColBERTConfig.tiny(
        vocab_size=tok.vocab_size, dtype=jnp.bfloat16), tok, seed=2)
    jenc.save_params(str(tmp_path / "params.npz"))
    paths = dict(bm25_index_path=str(tmp_path / "bm25"),
                 colbert_index_path=str(tmp_path / "colbert"))
    jcfg = JaxConfig(dense_prefilter=0, **paths)
    jcfg.mesh.index_dtype = "int8"
    jmgr = JaxManager(jcfg, jenc)
    jmgr.build_all(corpus)
    ptok = ColBERTTokenizer.load(tmp_path / "tokenizer.json")
    penc = tc.ColBERTEncoder(
        tc.ColBERTConfig.tiny(vocab_size=ptok.vocab_size,
                              dtype=torch.bfloat16), ptok,
        params=tc.ColBERTEncoder.load_params(str(tmp_path / "params.npz")),
        device="cpu")
    pmgr = IndexManager(RAGConfig(dense_prefilter=0, **paths), device="cpu")
    pmgr.load()
    pr = HybridRetriever(pmgr.config, pmgr, penc, device="cpu")
    queries = [corpus[9], " ".join(corpus[30].split()[:4]),
               " ".join(words[:3])]

    # the cascade alone, on JAX's bf16 query embeddings
    packed = pack_query_batch(penc, pmgr.lexical, queries)
    lq = penc.cfg.query_max_tokens
    jq = jenc.encode_queries(queries)
    assert jq.dtype == jnp.bfloat16
    statics = pr._statics(10)
    csr = pmgr.lexical_csr()
    d = pmgr.dense
    ids, scores, _ = hybrid_cascade(
        torch.from_numpy(np.array(jq).view(np.int16)).view(torch.bfloat16),
        torch.from_numpy(packed[:, lq:]), csr["indptr"], csr["post_docs"],
        csr["post_weights"], d.emb_flat, d.scales, d.doc_lengths, None,
        d.doc_scales, **statics)
    jd = jmgr.dense
    jids, jscores, _ = jax_cascade(
        jq, jnp.asarray(packed[:, lq:]), jnp.asarray(pmgr.lexical.indptr),
        jnp.asarray(pmgr.lexical.post_docs),
        jnp.asarray(pmgr.lexical.post_weights), jd.emb_flat, jd.scales,
        jd.doc_lengths, None, jd.doc_scales, **statics)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-4, rtol=0)

    # end to end, the port's bf16 encoder
    jids, jscores = map(np.asarray, JaxRetriever(jcfg, jmgr, jenc)
                        .retrieve_batch(queries))
    ids, scores = pr.retrieve_batch(queries)
    tol = 32 * 2.0**-8
    np.testing.assert_allclose(scores, jscores, atol=tol, rtol=0)
    assert ids[0, 0] == jids[0, 0] == 9
    for row, j in np.argwhere(ids != jids):
        hit = np.flatnonzero(jids[row] == ids[row, j])
        jax_score = jscores[row, hit[0]] if hit.size else jscores[row, -1]
        assert abs(jax_score - jscores[row, j]) <= tol, (row, j)
