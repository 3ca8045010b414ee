"""Port MaxSim vs the JAX one.

``maxsim_scores_int8`` on CPU tensors runs the plain version of the CUDA
kernel; the JAX side runs the Pallas kernel in interpret mode (conftest
keeps JAX on the CPU). Tolerance rtol=1e-5, atol=1e-4: both sides take
exact fp32 products of a bf16 query and int8 rows, but sum them (over D,
and over the query's Lq rows) in different orders. Top-k ids must be
equal: the random unit-norm embeddings leave no ties.

The pruned route (ops/prefilter.py) is compared the same way, since it is
the plain-torch half of the dense stage on the main path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.ops import maxsim as jm
from hybrid_rag_colbertv2_tpu.ops import prefilter as jp
from hybrid_rag_colbertv2_tpu.ops.quant import quantize_int8_rows as jax_q8
from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as tm
from hybrid_rag_colbertv2_tpu_torch.ops import prefilter as tp
from hybrid_rag_colbertv2_tpu_torch.ops.topk import top_k

TOL = dict(rtol=1e-5, atol=1e-4)


def _index(seed, n, doc_len, dim):
    """Unit-norm token rows, padding rows zeroed, int8 per-row quantized.
    Docs 1 and 3 are zero-length; doc 2 has a valid row set to zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, doc_len, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    lengths = rng.integers(1, doc_len + 1, n).astype(np.int32)
    lengths[[1, 3]] = 0
    lengths[2] = doc_len
    x *= (np.arange(doc_len)[None, :] < lengths[:, None])[..., None]
    x[2, 5] = 0.0
    q8, sc = jax_q8(jnp.asarray(x.reshape(n * doc_len, dim)))
    return np.array(q8), np.array(sc), lengths, x


def _queries(seed, b, lq, dim, pad_rows=4):
    rng = np.random.default_rng(seed + 100)
    q = rng.standard_normal((b, lq, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, lq - pad_rows:] = 0.0          # padded query rows are zero
    return q


@pytest.mark.parametrize("b,doc_len,n,dim", [
    (1, 64, 37, 32),      # ragged N: no tile divides it
    (3, 64, 130, 32),
    (3, 128, 21, 32),
    (1, 128, 16, 128),    # the main path's widths
])
def test_int8_plain_version_matches_pallas(b, doc_len, n, dim):
    q8, sc, lengths, _ = _index(b * 7 + n, n, doc_len, dim)
    q = _queries(n, b, 32, dim)
    js = np.array(jm.maxsim_scores_int8(
        jnp.asarray(q), jnp.asarray(q8), jnp.asarray(sc),
        jnp.asarray(lengths), doc_len=doc_len))
    before = tm.maxsim_scores_int8.launches
    ts = tm.maxsim_scores_int8(
        torch.from_numpy(q), torch.from_numpy(q8), torch.from_numpy(sc),
        torch.from_numpy(lengths), doc_len=doc_len).numpy()
    assert tm.maxsim_scores_int8.launches == before   # CPU: no kernel
    assert ts.shape == (b, n)
    np.testing.assert_allclose(ts, js, **TOL)
    # zero-length docs score -1e30 * (Lq) exactly as the JAX kernel
    assert (ts[:, [1, 3]] < -1e31).all()
    k = min(10, n)
    assert np.array_equal(top_k(torch.from_numpy(js), k)[1].numpy(),
                          top_k(torch.from_numpy(ts), k)[1].numpy())


def test_int8_reference_blocking_is_invisible():
    q8, sc, lengths, _ = _index(5, 50, 64, 32)
    args = (torch.from_numpy(_queries(5, 2, 32, 32)), torch.from_numpy(q8),
            torch.from_numpy(sc), torch.from_numpy(lengths))
    whole = tm.maxsim_scores_int8_reference(*args, doc_len=64)
    blocked = tm.maxsim_scores_int8_reference(*args, doc_len=64,
                                              block_docs=7)
    assert torch.equal(whole, blocked)


def test_cuda_wrapper_rejects_bad_operands():
    """The operand checks run before any launch (no card needed)."""
    q8, sc, lengths, _ = _index(6, 8, 64, 32)
    q = torch.from_numpy(_queries(6, 1, 32, 32))
    with pytest.raises(ValueError, match="L % 64"):
        tm._check_int8_operands(q, torch.from_numpy(q8[: 8 * 32]),
                                torch.from_numpy(sc[: 8 * 32]),
                                torch.from_numpy(lengths), 32)
    with pytest.raises(ValueError, match="int8"):
        tm._check_int8_operands(q, torch.from_numpy(q8).float(),
                                torch.from_numpy(sc),
                                torch.from_numpy(lengths), 64)


@pytest.mark.parametrize("b", [1, 3])
def test_exact_oracle_matches_jax(b):
    _, _, lengths, x = _index(11, 40, 64, 32)
    q = _queries(11, b, 32, 32)
    js = np.asarray(jm.maxsim_scores_exact(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(lengths)))
    ts = tm.maxsim_scores_exact(torch.from_numpy(q), torch.from_numpy(x),
                                torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(ts, js, **TOL)


@pytest.mark.parametrize("n_candidates", [128, 256])
def test_pruned_route_matches_jax(n_candidates):
    n, doc_len, dim = 256, 64, 32
    q8, sc, lengths, _ = _index(13, n, doc_len, dim)
    q = _queries(13, 3, 32, dim)
    pooled_j = jp.pooled_doc_embeddings(
        jnp.asarray(q8), jnp.asarray(sc), jnp.asarray(lengths),
        doc_len=doc_len)
    pooled_t = tp.pooled_doc_embeddings(
        torch.from_numpy(q8), torch.from_numpy(sc),
        torch.from_numpy(lengths), doc_len=doc_len)
    # the token sums run in the same order: the bf16 proxies are equal
    assert np.array_equal(pooled_t.float().numpy(),
                          np.asarray(pooled_j, np.float32))
    kw = dict(doc_len=doc_len, n_docs=n - 5, n_candidates=n_candidates,
              k=20)
    # approx_max_k is off on the JAX side: the port's top-k is exact
    jv, ji = jp.maxsim_topk_pruned(
        jnp.asarray(q), jnp.asarray(q8), jnp.asarray(sc),
        jnp.asarray(lengths), pooled_j, approx_recall=1.0, **kw)
    tv, ti = tp.maxsim_topk_pruned(
        torch.from_numpy(q), torch.from_numpy(q8), torch.from_numpy(sc),
        torch.from_numpy(lengths), pooled_t, **kw)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
