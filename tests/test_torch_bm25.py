"""Port BM25 scorers vs the JAX ones: bit-equal values, equal ids.

Capped and uncapped postings CSR, term widths 8/16/32 (the patterns of
tests/test_bm25.py and tests/test_term_buckets.py). The corpus draws 12
words per chunk from a small vocabulary, so docs repeat query terms and
equal-id runs in the sorted postings are long.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.index.lexical import LexicalIndex as JaxLex
from hybrid_rag_colbertv2_tpu.ops.bm25 import (
    bm25_scores_device as jax_scores, bm25_topk_device as jax_topk)
from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
from hybrid_rag_colbertv2_tpu_torch.ops.bm25 import (
    bm25_scores_device, bm25_topk_device)

_RNG = np.random.default_rng(7)
_VOCAB = np.array([f"word{i}" for i in range(60)])
CORPUS = [" ".join(r) for r in _VOCAB[_RNG.integers(0, 60, (800, 12))]]
QUERIES = [" ".join(_VOCAB[_RNG.integers(0, 60, n)]) for n in
           (1, 3, 6, 8, 12, 20, 30, 40)]


@pytest.fixture(scope="module", params=[0, 100], ids=["uncapped", "cap100"])
def lex_pair(request):
    cap = request.param
    jl = JaxLex.build(CORPUS, postings_cap=cap)
    tl = LexicalIndex.build(CORPUS, postings_cap=cap)
    return jl, tl


def test_port_lexical_index_matches_jax(lex_pair):
    jl, tl = lex_pair
    assert tl.vocab == jl.vocab
    assert tl.max_postings == jl.max_postings
    for name in ("indptr", "post_docs", "post_weights"):
        a, b = getattr(jl, name), getattr(tl, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("width", [8, 16, 32])
def test_bm25_topk_bit_equal(lex_pair, width):
    jl, tl = lex_pair
    terms = np.stack([jl.encode_query(q, width) for q in QUERIES])
    kw = dict(n_docs=jl.n_docs, max_postings=jl.max_postings, k=100)
    jv, ji = jax_topk(jnp.asarray(terms), jnp.asarray(jl.indptr),
                      jnp.asarray(jl.post_docs), jnp.asarray(jl.post_weights),
                      **kw)
    tv, ti = bm25_topk_device(
        torch.from_numpy(terms), torch.from_numpy(tl.indptr),
        torch.from_numpy(tl.post_docs), torch.from_numpy(tl.post_weights),
        **kw)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv).view(np.uint32),
                          tv.numpy().view(np.uint32))


@pytest.mark.parametrize("width", [8, 16, 32])
def test_bm25_scores_bit_equal(lex_pair, width):
    jl, tl = lex_pair
    terms = np.stack([jl.encode_query(q, width) for q in QUERIES])
    kw = dict(n_docs=jl.n_docs, max_postings=jl.max_postings)
    js = jax_scores(jnp.asarray(terms), jnp.asarray(jl.indptr),
                    jnp.asarray(jl.post_docs), jnp.asarray(jl.post_weights),
                    **kw)
    ts = bm25_scores_device(
        torch.from_numpy(terms), torch.from_numpy(tl.indptr),
        torch.from_numpy(tl.post_docs), torch.from_numpy(tl.post_weights),
        **kw)
    assert np.array_equal(np.asarray(js).view(np.uint32),
                          ts.numpy().view(np.uint32))


def test_bm25_topk_tiny_index_pads_to_k():
    """k beyond Q*P on a tiny index keeps the (B, k) contract, as JAX."""
    corpus = ["alpha beta", "beta gamma", "gamma delta"]
    jl, tl = JaxLex.build(corpus), LexicalIndex.build(corpus)
    terms = np.stack([jl.encode_query("beta gamma", 1)])
    kw = dict(n_docs=3, max_postings=jl.max_postings, k=200)
    jv, ji = jax_topk(jnp.asarray(terms), jnp.asarray(jl.indptr),
                      jnp.asarray(jl.post_docs), jnp.asarray(jl.post_weights),
                      **kw)
    tv, ti = bm25_topk_device(
        torch.from_numpy(terms), torch.from_numpy(tl.indptr),
        torch.from_numpy(tl.post_docs), torch.from_numpy(tl.post_weights),
        **kw)
    assert ti.shape == (1, 200)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
