"""The port's sharded index checkpoints (index/checkpoint.py), case for
case as ``tests/test_checkpoint.py`` holds JAX's, on the CPU.

The port writes one ``.npy`` per array per shard and a ``meta.json``
with the JAX ``meta.json`` keys (plus ``n_shards``); loading reads each
target shard's doc range through memory maps. Checks: every layout round
trips on one device bit for bit; an index saved at 8 shards reloads at 8,
4 and 1 bit for bit with equal ``search_scores``; the doc-scale layouts'
scales survive; a bucketed index restores into the mesh; the keys of
JAX's ``meta.json`` (orbax, saved from the same index) are all there; a
JAX orbax directory given to the port's loader raises.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.index import checkpoint as jax_checkpoint
from hybrid_rag_colbertv2_tpu.index.bucketed import (
    BucketedDenseIndex as JaxBucketed)
from hybrid_rag_colbertv2_tpu.index.dense import DenseTokenIndex as JaxDense
from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig
from hybrid_rag_colbertv2_tpu_torch.index.bucketed import BucketedDenseIndex
from hybrid_rag_colbertv2_tpu_torch.index.checkpoint import (
    load_sharded, load_sharded_bucketed, save_sharded, save_sharded_bucketed)
from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
from hybrid_rag_colbertv2_tpu_torch.parallel.mesh import (
    ShardedBucketedIndex, ShardedDenseIndex, make_mesh, shard_dense_index)

LAYOUTS = ("int8", "int8-doc", "int4-doc", "bfloat16", "float32")
ARRAYS = ("emb_flat", "doc_lengths", "scales", "pooled", "doc_scales")
CPU = torch.device("cpu")


def _data(n=200, L=32, D=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.normal(size=(n, L, D)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    lens = rng.integers(L // 2, L + 1, n).astype(np.int32)
    return toks, lens


def _make_index(dtype, n=200, L=32, D=32):
    toks, lens = _data(n, L, D)
    return DenseTokenIndex.build(torch.from_numpy(toks),
                                 torch.from_numpy(lens), doc_len=L,
                                 dtype=dtype)


def _mesh(n):
    return make_mesh(MeshConfig(mesh_shape=(n, 1)), devices=[CPU] * n)


def _assert_same(a: DenseTokenIndex, b: DenseTokenIndex):
    assert (a.n_docs, a.doc_len, a.dim, a.n_pad) == (
        b.n_docs, b.doc_len, b.dim, b.n_pad)
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name


def _queries(D=32):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 4, D)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))


@pytest.mark.parametrize("dtype", LAYOUTS)
def test_roundtrip_single_device(tmp_path, dtype):
    dense = _make_index(dtype)
    save_sharded(dense, tmp_path / "ck")
    back = load_sharded(tmp_path / "ck", device="cpu")
    assert isinstance(back, DenseTokenIndex) and back.quant == dtype
    _assert_same(back, dense)


@pytest.mark.parametrize("dtype", ("int8", "int4-doc"))
def test_save_8_shards_load_8_4_1(tmp_path, dtype):
    """Saved from 8 shards, restored onto 8, 4 and 1: the same bytes and
    the same search scores; each shard holds its doc range."""
    dense = _make_index(dtype, n=250)
    save_sharded(shard_dense_index(dense, _mesh(8)), tmp_path / "ck")
    meta = json.loads((tmp_path / "ck/shards/meta.json").read_text())
    assert meta["n_shards"] == 8 and meta["n_pad"] == 256
    assert len(list((tmp_path / "ck/shards").glob("emb_flat.*.npy"))) == 8
    q = _queries()
    want = dense.search_scores(q)
    for n in (8, 4):
        back = load_sharded(tmp_path / "ck", mesh=_mesh(n))
        assert isinstance(back, ShardedDenseIndex) and back.n_shards == n
        assert back.n_local == 256 // n
        for s, sh in enumerate(back.shards):
            _assert_same(sh, shard_dense_index(dense, _mesh(n)).shards[s])
        _assert_same(back.full(), dense)
        torch.testing.assert_close(back.full().search_scores(q), want,
                                   rtol=0, atol=0)
    one = load_sharded(tmp_path / "ck", device="cpu")
    _assert_same(one, dense)
    torch.testing.assert_close(one.search_scores(q), want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ("int8-doc", "int4-doc"))
def test_roundtrip_doc_scales(tmp_path, dtype):
    """The doc-scale layouts' scales survive (per doc for int8-doc;
    (G, N) per token group, doc axis minor, for int4-doc)."""
    dense = _make_index(dtype)
    assert dense.doc_scales is not None
    save_sharded(shard_dense_index(dense, _mesh(4)), tmp_path / "ck")
    back = load_sharded(tmp_path / "ck", mesh=_mesh(2))
    n = back.n_local
    for s, sh in enumerate(back.shards):
        want = dense.doc_scales[..., s * n:(s + 1) * n]
        assert sh.doc_scales.is_contiguous()
        assert torch.equal(sh.doc_scales, want)
    q = _queries()
    torch.testing.assert_close(back.full().search_scores(q),
                               dense.search_scores(q), rtol=0, atol=0)


def test_bucketed_roundtrip_into_mesh(tmp_path):
    """A bucketed index saved on one device restores onto the 8-shard
    mesh: routing arrays, every bucket's bytes and the search results."""
    rng = np.random.default_rng(0)
    n, L, D = 300, 32, 32
    toks = rng.normal(size=(n, L, D)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    lens = rng.integers(4, L + 1, n).astype(np.int32)
    bidx = BucketedDenseIndex.build(torch.from_numpy(toks),
                                    torch.from_numpy(lens),
                                    bucket_sizes=(16, 32), dtype="int8")
    save_sharded_bucketed(bidx, tmp_path / "bk")
    back = load_sharded_bucketed(tmp_path / "bk", mesh=_mesh(8))
    assert isinstance(back, ShardedBucketedIndex)
    assert back.n_docs == bidx.n_docs and back.n_shards == 8
    assert len(back.buckets) == len(bidx.buckets)
    assert torch.equal(back.bucket_of, bidx.bucket_of)
    assert torch.equal(back.row_of, bidx.row_of)
    full = back.full()
    for b0, b1, g0, g1 in zip(bidx.buckets, full.buckets, bidx.global_ids,
                              full.global_ids):
        _assert_same(b1, b0)
        assert torch.equal(g1, g0)
    q = _queries()
    v0, i0 = bidx.search_topk(q, 10)
    v1, i1 = full.search_topk(q, 10)
    assert torch.equal(i0, i1) and torch.equal(v0, v1)
    one = load_sharded_bucketed(tmp_path / "bk", device="cpu")
    assert isinstance(one, BucketedDenseIndex)
    assert torch.equal(one.search_scores(q), bidx.search_scores(q))


@pytest.mark.parametrize("dtype", ("int8", "int4-doc"))
def test_meta_keys_cover_jax_and_orbax_raises(tmp_path, dtype):
    """The port's ``meta.json`` carries every key of the JAX one saved
    (orbax) from the same index, with JAX's values; JAX's orbax
    directories, flat or bucketed, raise in the port's loaders."""
    toks, lens = _data()
    jd = JaxDense.build(jnp.asarray(toks), jnp.asarray(lens), doc_len=32,
                        dtype=dtype)
    jax_checkpoint.save_sharded(jd, tmp_path / "jax")
    jmeta = json.loads((tmp_path / "jax/orbax/meta.json").read_text())
    save_sharded(_make_index(dtype), tmp_path / "port")
    pmeta = json.loads((tmp_path / "port/shards/meta.json").read_text())
    assert set(jmeta) <= set(pmeta)
    assert {k: pmeta[k] for k in jmeta if k != "dtype"} == {
        k: v for k, v in jmeta.items() if k != "dtype"}
    with pytest.raises(ValueError, match="reads no orbax checkpoint"):
        load_sharded(tmp_path / "jax", device="cpu")
    jb = JaxBucketed.build(jnp.asarray(toks), jnp.asarray(lens),
                           bucket_sizes=(16, 32), dtype=dtype)
    jax_checkpoint.save_sharded_bucketed(jb, tmp_path / "jaxb")
    with pytest.raises(ValueError, match="dense.npz"):
        load_sharded_bucketed(tmp_path / "jaxb", device="cpu")
