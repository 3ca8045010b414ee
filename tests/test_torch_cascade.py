"""The slice as a whole: the port serves an index directory the JAX
package built, and returns the JAX retriever's final ids, for every flat
index layout (int8, int8-doc, int4-doc, bfloat16, float32).

The JAX ``IndexManager.build_all`` indexes a corpus of 64 distinct chunks
with a tiny JAX encoder (BPE tokenizer and encoder params saved beside
it). The port loads the lexical and dense directories, the tokenizer and
the params, and its ``HybridRetriever.retrieve_batch`` must give the same
final ids for both dense routes and all three final-fusion modes; scores
within atol=1e-4 (fp32 sums in other orders). Every chunk is distinct, so
no two docs tie on MaxSim; fused-score ties resolve by ascending id in
both packages (bit-equal fusion, tests/test_torch_fusion.py).
"""

import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.index.manager import IndexManager as JaxManager
from hybrid_rag_colbertv2_tpu.models.colbert import (
    ColBERTConfig as JaxColCfg, ColBERTEncoder as JaxEncoder)
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer)
from hybrid_rag_colbertv2_tpu.retrieval.cascade import (
    HybridRetriever as JaxRetriever)
from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
    ColBERTConfig, ColBERTEncoder)
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import ColBERTTokenizer
from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as tm
from hybrid_rag_colbertv2_tpu_torch.ops.maxsim import maxsim_scores_int8
from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import HybridRetriever
from hybrid_rag_colbertv2_tpu_torch.utils import profiling

_RNG = np.random.default_rng(11)
# 300 distinct pseudo-words, 9 per chunk: chunks share few words
_WORDS = np.array(sorted({"".join(_RNG.choice(list("abcdefghiklmnoprstuvy"),
                                              _RNG.integers(4, 8)))
                          for _ in range(300)}))
CORPUS = [" ".join(_WORDS[_RNG.choice(len(_WORDS), 9, replace=False)])
          for _ in range(64)]
PLANTED = 17
QUERIES = [" ".join(CORPUS[3].split()[:3]), " ".join(_WORDS[:4]),
           CORPUS[PLANTED], " ".join(CORPUS[40].split()[2:7])]


def _paths(root, cls):
    return cls(bm25_index_path=str(root / "bm25"),
               colbert_index_path=str(root / "colbert"),
               tokenizer_path=str(root / "tokenizer.json"))


def _build(root, dtype):
    """A JAX-built index of layout ``dtype`` under ``root``, and the
    port's manager and encoder loaded from its files."""
    tok = JaxTokenizer.train_bpe(CORPUS, vocab_size=512)
    tok.save(root / "tokenizer.json")
    enc = JaxEncoder(JaxColCfg.tiny(vocab_size=tok.vocab_size), tok, seed=0)
    enc.save_params(str(root / "encoder_params.npz"))
    cfg = _paths(root, JaxConfig)
    cfg.mesh.index_dtype = dtype
    mgr = JaxManager(cfg, enc)
    mgr.build_all(CORPUS)

    pcfg = _paths(root, RAGConfig)
    ptok = ColBERTTokenizer.load(root / "tokenizer.json")
    penc = ColBERTEncoder(
        ColBERTConfig.tiny(vocab_size=ptok.vocab_size), ptok,
        params=ColBERTEncoder.load_params(str(root / "encoder_params.npz")),
        device="cpu")
    pmgr = IndexManager(pcfg, device="cpu")
    pmgr.load()
    pmgr.corpus = list(CORPUS)
    return root, enc, mgr, penc, pmgr


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("jax_index"), "int8")


@pytest.fixture(scope="module", params=["int8-doc", "int4-doc", "bfloat16",
                                        "float32"])
def built_layout(request, tmp_path_factory):
    return request.param, _build(tmp_path_factory.mktemp(request.param),
                                 request.param)


def _launch_counts():
    return (tm.maxsim_scores.launches, tm.maxsim_scores_int8.launches,
            tm.maxsim_scores_int8_doc.launches,
            tm.maxsim_scores_int4_doc.launches)


@pytest.mark.parametrize("final_fusion", ["rerank", "rrf", "union"])
@pytest.mark.parametrize("prefilter", [0, 1024])
def test_port_serves_jax_index_with_jax_ids(built, prefilter, final_fusion):
    root, enc, mgr, penc, pmgr = built
    kw = dict(dense_prefilter=prefilter, final_fusion=final_fusion)
    jcfg = _paths(root, JaxConfig)
    pcfg = _paths(root, RAGConfig)
    for c in (jcfg, pcfg):
        for k, v in kw.items():
            setattr(c, k, v)
    jids, jscores = JaxRetriever(jcfg, mgr, enc).retrieve_batch(QUERIES)
    before = maxsim_scores_int8.launches
    retr = HybridRetriever(pcfg, pmgr, penc, device="cpu")
    ids, scores = retr.retrieve_batch(QUERIES)
    assert maxsim_scores_int8.launches == before   # CPU: plain version
    assert ids.shape == (len(QUERIES), 10)
    assert np.array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), atol=1e-4,
                               rtol=0)
    assert ids[2, 0] == PLANTED                    # verbatim text: rank 1
    assert set(retr.last_timings) == {"tokenize", "encode+cascade"}


@pytest.mark.parametrize("final_fusion", ["rerank", "rrf", "union"])
@pytest.mark.parametrize("prefilter", [0, 1024])
def test_port_serves_jax_layouts_with_jax_ids(built_layout, prefilter,
                                              final_fusion):
    """The int8-doc, int4-doc, bfloat16 and float32 layouts: the port
    loads the JAX-built directory and returns the JAX retriever's final
    ids on both dense routes."""
    dtype, (root, enc, mgr, penc, pmgr) = built_layout
    assert pmgr.dense.quant == mgr.dense.quant == dtype
    jcfg = _paths(root, JaxConfig)
    pcfg = _paths(root, RAGConfig)
    for c in (jcfg, pcfg):
        c.dense_prefilter, c.final_fusion = prefilter, final_fusion
    jids, jscores = JaxRetriever(jcfg, mgr, enc).retrieve_batch(QUERIES)
    before = _launch_counts()
    ids, scores = HybridRetriever(pcfg, pmgr, penc,
                                  device="cpu").retrieve_batch(QUERIES)
    assert _launch_counts() == before              # CPU: plain versions
    assert np.array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), atol=1e-4,
                               rtol=0)
    assert ids[2, 0] == PLANTED


def test_retrieve_batch_spans_carry_the_call(built):
    """Inside a call's span, ``retrieve_batch`` leaves ``retrieve.bind``,
    ``tokenize`` and ``encode+cascade`` under the call's id, in order,
    and its per-call split as before."""
    root, enc, mgr, penc, pmgr = built
    retr = HybridRetriever(_paths(root, RAGConfig), pmgr, penc,
                           device="cpu")
    lt = {}
    with profiling.record_spans() as rec:
        with profiling.annotate("mb.call", id=5):
            retr.retrieve_batch(QUERIES, timings_out=lt)
    names = [s.name for s in rec.spans]
    assert names == ["retrieve.bind", "tokenize", "encode+cascade",
                     "mb.call"]
    assert all(s.id == 5 for s in rec.spans)
    spans = rec.spans[:3]
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(spans, spans[1:]))
    assert set(lt) == set(retr.last_timings) == {"tokenize",
                                                  "encode+cascade"}


def test_retrieve_returns_planted_text(built):
    root, _, _, penc, pmgr = built
    retr = HybridRetriever(_paths(root, RAGConfig), pmgr, penc,
                           device="cpu")
    rows = retr.retrieve(CORPUS[PLANTED])
    assert rows[0]["chunk_id"] == PLANTED and rows[0]["rank"] == 1
    assert rows[0]["text"] == CORPUS[PLANTED]
    assert "fetch" in retr.last_timings


def test_port_saves_byte_identical_files(built, tmp_path):
    """The same inputs saved by the port give the JAX package's bytes."""
    root, enc, mgr, _, _ = built
    lex = LexicalIndex.build(CORPUS, postings_cap=512)
    lex.save(tmp_path / "bm25")
    embs, lengths = enc.encode_docs(CORPUS)
    dense = DenseTokenIndex.build(
        torch.from_numpy(np.array(embs)), torch.from_numpy(
            np.array(lengths)), doc_len=mgr.dense.doc_len, dtype="int8")
    dense.save(tmp_path / "colbert")
    for sub, names in (("bm25", ("postings.npz", "meta.json", "vocab.json")),
                       ("colbert", ("dense.npz", "meta.json"))):
        for name in names:
            assert ((tmp_path / sub / name).read_bytes()
                    == (root / sub / name).read_bytes()), f"{sub}/{name}"
