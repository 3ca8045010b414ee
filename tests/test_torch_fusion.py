"""Port fusion vs the JAX one: bit-equal scores, equal ids.

``rrf_from_topk`` with and without ``floor_m`` and ``final_topk_select``
over every entry of the gate's menu (copied from
hybrid_rag_colbertv2_tpu/retrieval/gate.py:132-133), on id lists with
overlaps, ``-1`` holes and ties (tied rerank scores, tied fused scores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.ops import fusion as jf
from hybrid_rag_colbertv2_tpu_torch.ops import fusion as tf

GATE_MENU = (("rerank", 0.5), ("rrf", 0.25), ("rrf", 0.5), ("rrf", 0.75),
             ("rrf", 0.9), ("rrf", 1.0), ("union", 0.5), ("union", 0.9))


def _legs(seed, b=4, ka=40, kb=40, n=60):
    """Two rank-ordered id lists per row, overlapping, with -1 holes."""
    rng = np.random.default_rng(seed)
    a = np.stack([rng.permutation(n)[:ka] for _ in range(b)]).astype(np.int32)
    bb = np.stack([rng.permutation(n)[:kb] for _ in range(b)]).astype(np.int32)
    a[0, -7:] = -1              # short BM25 list
    bb[1, 5] = -1               # hole inside the dense list
    a[2, :] = -1                # all-OOV BM25 leg
    return a, bb


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("floor_m", [0, 3, (4, 1), (0, 2)])
@pytest.mark.parametrize("weights", [(1.0, 1.0), (1.5, 0.5), (1.8, 0.2)])
def test_rrf_from_topk_bit_equal(floor_m, weights):
    a, b = _legs(0)
    kw = dict(k=50, rrf_k=60, weights=weights, floor_m=floor_m)
    js, ji = jf.rrf_from_topk(jnp.asarray(a), jnp.asarray(b), **kw)
    ts, ti = tf.rrf_from_topk(torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(_bits(js), _bits(ts.numpy()))


def test_rrf_ties_by_ascending_id_and_oracle():
    """Mirror-image lists give every id the same fused score: the order
    is then ascending id, as the reference dict sort's stable order."""
    a = np.array([[3, 1, 2, 0]], np.int32)
    b = np.array([[0, 2, 1, 3]], np.int32)
    ts, ti = tf.rrf_from_topk(torch.from_numpy(a), torch.from_numpy(b), k=6)
    js, ji = jf.rrf_from_topk(jnp.asarray(a), jnp.asarray(b), k=6)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(_bits(js), _bits(ts.numpy()))
    ref = tf.rrf_reference_py([3, 1, 2, 0], [0, 2, 1, 3])
    assert sorted(ti[0, :4].tolist()) == sorted(c for c, _ in ref)
    assert ti[0, 4:].tolist() == [-1, -1]


@pytest.mark.parametrize("mode,weight", GATE_MENU)
@pytest.mark.parametrize("k_final", [10, 1])
def test_final_topk_select_bit_equal(mode, weight, k_final):
    a, b = _legs(1)
    w = weight
    fm = jf.union_floor_split(k_final, w) if mode == "union" else (0, 0)
    assert tf.union_floor_split(k_final, w) == jf.union_floor_split(
        k_final, w)
    kw = dict(k=50, rrf_k=60, weights=(2.0 * w, 2.0 * (1.0 - w)), floor_m=fm)
    _, fused = jf.rrf_from_topk(jnp.asarray(a), jnp.asarray(b), **kw)
    fused = np.array(fused)
    rng = np.random.default_rng(2)
    rerank = rng.standard_normal(fused.shape).astype(np.float32)
    rerank[:, 10:14] = rerank[:, 3:4]            # tied rerank scores
    sel_kw = dict(rrf_k=60, final_fusion=mode, weight_cand=w)
    ji, jv = jf.final_topk_select(
        jnp.asarray(rerank), jnp.asarray(fused), k_final,
        bm25_ids=jnp.asarray(a), dense_ids=jnp.asarray(b), **sel_kw)
    ti, tv = tf.final_topk_select(
        torch.from_numpy(rerank), torch.from_numpy(fused), k_final,
        bm25_ids=torch.from_numpy(a), dense_ids=torch.from_numpy(b),
        **sel_kw)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(_bits(jv), _bits(tv.numpy()))


def test_reciprocal_rank_fusion_matches_jax():
    rng = np.random.default_rng(3)
    sa = rng.standard_normal((3, 200)).astype(np.float32)
    sb = rng.standard_normal((3, 200)).astype(np.float32)
    sa[:, 50:60] = 0.0                           # ties in one leg
    js, ji = jf.reciprocal_rank_fusion(jnp.asarray(sa), jnp.asarray(sb))
    ts, ti = tf.reciprocal_rank_fusion(torch.from_numpy(sa),
                                       torch.from_numpy(sb))
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(_bits(js), _bits(ts.numpy()))
