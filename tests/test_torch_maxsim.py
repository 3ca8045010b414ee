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
    (2, 32, 29, 32),      # L % 64 == 32: the kernel's 32-row last chunk
    (2, 96, 23, 32),
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
    with pytest.raises(ValueError, match="L % 32"):
        tm._check_int8_operands(q, torch.from_numpy(q8[: 8 * 48]),
                                torch.from_numpy(sc[: 8 * 48]),
                                torch.from_numpy(lengths), 48)
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


# --- bf16 / f32, int8-doc and int4-doc scans ----------------------------

from hybrid_rag_colbertv2_tpu.ops import quant as jq  # noqa: E402
from hybrid_rag_colbertv2_tpu_torch.ops import quant as tq  # noqa: E402


def _float_docs(seed, n, doc_len, dim):
    """Unit-norm rows, padding zeroed; docs 1 and 3 zero-length, doc 2
    full with a valid row set to zero."""
    _, _, lengths, x = _index(seed, n, doc_len, dim)
    return x, lengths


def _launch_counts():
    return (tm.maxsim_scores.launches, tm.maxsim_scores_int8.launches,
            tm.maxsim_scores_int8_doc.launches,
            tm.maxsim_scores_int4_doc.launches)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,doc_len,n,dim", [
    (1, 64, 37, 32),      # ragged N
    (3, 64, 70, 32),
    (3, 32, 21, 16),
    (2, 96, 23, 32),      # L % 64 == 32: the kernels' 32-row last chunk
])
def test_float_plain_version_matches_pallas(dtype, b, doc_len, n, dim):
    x, lengths = _float_docs(b * 5 + n, n, doc_len, dim)
    q = _queries(n, b, 16, dim)
    flat_j = jnp.asarray(x.reshape(n * doc_len, dim)).astype(dtype)
    js = np.array(jm.maxsim_scores(jnp.asarray(q), flat_j,
                                   jnp.asarray(lengths), doc_len=doc_len))
    flat_t = torch.from_numpy(x.reshape(n * doc_len, dim)).to(
        getattr(torch, dtype))
    before = _launch_counts()
    ts = tm.maxsim_scores(torch.from_numpy(q), flat_t,
                          torch.from_numpy(lengths), doc_len=doc_len).numpy()
    assert _launch_counts() == before                 # CPU: no kernel
    assert ts.shape == (b, n)
    np.testing.assert_allclose(ts, js, **TOL)
    assert (ts[:, [1, 3]] < -1e31).all()              # zero-length docs
    k = min(10, n)
    assert np.array_equal(top_k(torch.from_numpy(js), k)[1].numpy(),
                          top_k(torch.from_numpy(ts), k)[1].numpy())


def test_float_plain_masks_zeroed_valid_row():
    """A valid row of zeros is masked by content: a doc whose only
    valid row is zero scores -1e30 per query row, as in the TPU kernel."""
    x = np.zeros((2, 32, 16), np.float32)
    x[1, 0] = 1.0
    lengths = np.array([1, 1], np.int32)
    q = _queries(0, 1, 8, 16, pad_rows=0)
    js = np.array(jm.maxsim_scores(jnp.asarray(q), jnp.asarray(
        x.reshape(64, 16)), jnp.asarray(lengths), doc_len=32))
    ts = tm.maxsim_scores(torch.from_numpy(q), torch.from_numpy(
        x.reshape(64, 16)), torch.from_numpy(lengths), doc_len=32).numpy()
    np.testing.assert_allclose(ts, js, **TOL)
    assert ts[0, 0] < -1e30 and ts[0, 1] > -1e3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_plain_scores_rows_past_length(dtype):
    """The float scan masks by content, never by length: a nonzero row
    past a doc's length is scored, and a zero row inside it is masked,
    as in the TPU kernel. The fp32 CUDA kernel skips row groups by the
    same content test, so its plain version pins this contract."""
    n, doc_len, dim = 6, 64, 32
    x, lengths = _float_docs(21, n, doc_len, dim)
    q = _queries(21, 2, 8, dim, pad_rows=2)
    lengths[:] = [9, 0, 64, 0, 17, 40]
    x *= (np.arange(doc_len)[None, :] < lengths[:, None])[..., None]
    x[0, 63] = q[0, 0]          # past the length, in the last row group
    x[1, 10] = q[0, 1]          # a zero-length doc with one nonzero row
    x[4, 16] = x[4, 8] = 0.0    # zero rows inside the length
    x[5, 0:8] = 0.0             # a whole zero row group inside the length
    flat = x.reshape(n * doc_len, dim)
    js = np.array(jm.maxsim_scores(
        jnp.asarray(q), jnp.asarray(flat).astype(dtype),
        jnp.asarray(lengths), doc_len=doc_len))
    ts = tm.maxsim_scores(
        torch.from_numpy(q), torch.from_numpy(flat).to(getattr(torch, dtype)),
        torch.from_numpy(lengths), doc_len=doc_len).numpy()
    np.testing.assert_allclose(ts, js, **TOL)
    assert (ts[:, 3] < -1e30).all()                   # all-zero doc
    # the rows past the length count: above the length-masked oracle
    oracle = tm.maxsim_scores_exact(torch.from_numpy(q), torch.from_numpy(x),
                                    torch.from_numpy(lengths)).numpy()
    assert ts[0, 0] > oracle[0, 0] + 0.5
    assert ts[0, 1] > -1e3 and oracle[0, 1] < -1e30


def _doc_layout(seed, n, doc_len, dim, int4):
    x, lengths = _float_docs(seed, n, doc_len, dim)
    lengths[4 % n] = 1
    quant = jq.quantize_int4_groups if int4 else jq.quantize_int8_docs
    flat, sc = quant(jnp.asarray(x), jnp.asarray(lengths))
    return np.array(flat), np.array(sc), lengths


@pytest.mark.parametrize("b,doc_len,n,dim", [
    (1, 64, 37, 32), (3, 32, 64, 32), (3, 64, 21, 16), (2, 96, 23, 32)])
def test_int8_doc_plain_version_matches_pallas(b, doc_len, n, dim):
    flat, sc, lengths = _doc_layout(b + n, n, doc_len, dim, int4=False)
    q = _queries(n, b, 16, dim)
    js = np.array(jm.maxsim_scores_int8_doc(
        jnp.asarray(q), jnp.asarray(flat), jnp.asarray(sc),
        jnp.asarray(lengths), doc_len=doc_len))
    before = _launch_counts()
    ts = tm.maxsim_scores_int8_doc(
        torch.from_numpy(q), torch.from_numpy(flat), torch.from_numpy(sc),
        torch.from_numpy(lengths), doc_len=doc_len).numpy()
    assert _launch_counts() == before
    assert ts.shape == (b, n)
    np.testing.assert_allclose(ts, js, **TOL)
    assert (ts[:, [1, 3]] == 0.0).all()               # zero-length docs
    k = min(10, n)
    assert np.array_equal(top_k(torch.from_numpy(js), k)[1].numpy(),
                          top_k(torch.from_numpy(ts), k)[1].numpy())


@pytest.mark.parametrize("b,doc_len,n,dim", [
    (1, 16, 37, 32), (3, 32, 64, 32), (3, 12, 21, 16),
    # the CUDA kernel's own shapes: whole 64-row chunks (32 rows in a
    # doc's last one where L % 64 == 32), every stored row multiplied, so
    # fully padded groups must not change the score
    (2, 64, 37, 64), (1, 128, 37, 64), (2, 96, 23, 64)])
def test_int4_doc_plain_version_matches_pallas(b, doc_len, n, dim):
    flat, gs, lengths = _doc_layout(7 * b + n, n, doc_len, dim, int4=True)
    if doc_len % 32 == 0 and doc_len > 32:
        group = doc_len // gs.shape[0]
        assert lengths[4] == 1 and (
            (lengths > 0) & (lengths <= doc_len - group)).sum() >= 5
    q = _queries(n, b, 8, dim, pad_rows=2)
    js = np.array(jm.maxsim_scores_int4_doc(
        jnp.asarray(q), jnp.asarray(flat), jnp.asarray(gs),
        jnp.asarray(lengths), doc_len=doc_len))
    before = _launch_counts()
    ts = tm.maxsim_scores_int4_doc(
        torch.from_numpy(q), torch.from_numpy(flat), torch.from_numpy(gs),
        torch.from_numpy(lengths), doc_len=doc_len).numpy()
    assert _launch_counts() == before
    assert ts.shape == (b, n)
    np.testing.assert_allclose(ts, js, **TOL)
    assert (ts[:, [1, 3]] == 0.0).all()
    # the same as the exact oracle over the dequantized rows, masked by
    # length: the dup-row contract makes the unmasked scan exact
    deq = tq.dequantize_int4_groups(torch.from_numpy(flat),
                                    torch.from_numpy(gs))
    oracle = tm.maxsim_scores_exact(
        torch.from_numpy(q).to(torch.bfloat16),
        deq.reshape(n, doc_len, dim), torch.from_numpy(lengths)).numpy()
    live = lengths > 0
    np.testing.assert_allclose(ts[:, live], oracle[:, live], **TOL)


@pytest.mark.parametrize("doc_len", [96, 128, 160])
def test_int8_doc_live_chunks_by_length_match_pallas(doc_len):
    """The rule the CUDA int8-doc kernel scans by: only the 64-row chunks
    that start before a doc's length are multiplied (the rest hold copies
    of row 0), a 32-row last chunk (L % 64 == 32) fills both halves of
    its 64-column product, and the doc scale multiplies the finished sum.
    On lengths at every chunk edge that equals the Pallas kernel, which
    takes every stored row, and zero-length docs score exactly 0."""
    edges = (0, 1, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129, 159,
             160)
    ends = [e for e in edges if e <= doc_len]
    n, dim, b, lq = len(ends) + 3, 32, 2, 16
    rng = np.random.default_rng(doc_len)
    x = rng.standard_normal((n, doc_len, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    lengths = np.array([ends[i % len(ends)] for i in range(n)], np.int32)
    x *= (np.arange(doc_len)[None, :] < lengths[:, None])[..., None]
    flat, sc = jq.quantize_int8_docs(jnp.asarray(x), jnp.asarray(lengths))
    flat, sc = np.array(flat), np.array(sc)
    q = _queries(doc_len, b, lq, dim)
    qb = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    rows = flat.reshape(n, doc_len, dim).astype(np.float32)
    want = np.zeros((b, n), np.float32)
    dead = 0
    for d in range(n):
        run = np.full(b * lq, -1e30, np.float32)
        for c in range(0, doc_len, 64):
            if c >= lengths[d]:
                dead += 1
                continue
            tile = rows[d, c:c + 64]
            if len(tile) == 32:
                tile = np.concatenate([tile, tile])
            run = np.maximum(run, (tile @ qb.reshape(-1, dim).T).max(axis=0))
        if lengths[d] > 0:
            want[:, d] = run.reshape(b, lq).sum(axis=1) * sc[d]
    assert dead > n // 2
    js = np.array(jm.maxsim_scores_int8_doc(
        jnp.asarray(q), jnp.asarray(flat), jnp.asarray(sc),
        jnp.asarray(lengths), doc_len=doc_len))
    np.testing.assert_allclose(want, js, **TOL)
    zero = lengths == 0
    assert zero.any() and (want[:, zero] == 0.0).all()
    assert (js[:, zero] == 0.0).all()


@pytest.mark.parametrize("name", ["float", "int8_doc", "int4_doc"])
def test_new_references_blocking_is_invisible(name):
    q = torch.from_numpy(_queries(5, 2, 16, 32))
    if name == "float":
        x, lengths = _float_docs(5, 50, 32, 32)
        args = (q, torch.from_numpy(x.reshape(-1, 32)).to(torch.bfloat16),
                torch.from_numpy(lengths))
        fn = tm.maxsim_scores_reference
    else:
        flat, sc, lengths = _doc_layout(5, 50, 32, 32,
                                        int4=name == "int4_doc")
        args = (q, torch.from_numpy(flat), torch.from_numpy(sc),
                torch.from_numpy(lengths))
        fn = (tm.maxsim_scores_int4_doc_reference if name == "int4_doc"
              else tm.maxsim_scores_int8_doc_reference)
    assert torch.equal(fn(*args, doc_len=32),
                       fn(*args, doc_len=32, block_docs=7))


def test_new_cuda_wrappers_reject_bad_operands():
    """The operand checks of the float, int8-doc and int4-doc wrappers
    run before any launch (no card needed)."""
    q = torch.from_numpy(_queries(6, 1, 32, 32))
    x, lengths = _float_docs(6, 8, 64, 32)
    lens = torch.from_numpy(lengths)
    rows = torch.from_numpy(x.reshape(-1, 32))
    with pytest.raises(ValueError, match="bfloat16/float32"):
        tm._check_float_operands(q, rows.to(torch.float16), lens, 64)
    with pytest.raises(ValueError, match="L % 32"):
        tm._check_float_operands(q, rows[: 8 * 48], lens, 48)
    with pytest.raises(ValueError, match="D % 16"):
        tm._check_float_operands(q[..., :24], rows[:, :24].contiguous(),
                                 lens, 64)
    flat, sc, _ = _doc_layout(6, 8, 64, 32, int4=False)
    with pytest.raises(ValueError, match="doc_scales"):
        tm._check_int8_doc_operands(q, torch.from_numpy(flat),
                                    torch.from_numpy(sc).double(), lens, 64)
    with pytest.raises(ValueError, match="doc_lengths"):
        tm._check_int8_doc_operands(q, torch.from_numpy(flat),
                                    torch.from_numpy(sc), lens.long(), 64)
    packed, gs, _ = _doc_layout(6, 8, 64, 32, int4=True)
    with pytest.raises(ValueError, match="int8"):
        tm._check_int4_operands(q, torch.from_numpy(packed).float(),
                                torch.from_numpy(gs), lens, 64)
    with pytest.raises(ValueError, match="group_scales"):
        tm._check_int4_operands(q, torch.from_numpy(packed),
                                torch.from_numpy(gs[:4]), lens, 64)
    with pytest.raises(ValueError, match="Lq"):
        tm._check_int4_operands(torch.zeros(1, 300, 32),
                                torch.from_numpy(packed),
                                torch.from_numpy(gs), lens, 64)
    # well-formed operands pass
    tm._check_int4_operands(q, torch.from_numpy(packed),
                            torch.from_numpy(gs), lens, 64)
    tm._check_int8_doc_operands(q, torch.from_numpy(flat),
                                torch.from_numpy(sc), lens, 64)
    tm._check_float_operands(q, rows, lens, 64)


def _operands_at(check, doc_len, n=4, dim=32):
    """Well-formed CPU operands of one wrapper's operand check, at any
    ``doc_len``: (queries, emb_flat, *others, doc_len)."""
    q = torch.zeros(2, 8, dim)
    lengths = torch.full((n,), doc_len // 2, dtype=torch.int32)
    rows = n * doc_len
    if check == "float":
        return q, torch.zeros(rows, dim, dtype=torch.bfloat16), lengths, doc_len
    if check == "int8":
        return (q, torch.zeros(rows, dim, dtype=torch.int8),
                torch.zeros(rows), lengths, doc_len)
    if check == "int8_doc":
        return (q, torch.zeros(rows, dim, dtype=torch.int8), torch.zeros(n),
                lengths, doc_len)
    return (q, torch.zeros(rows // 2, dim, dtype=torch.int8),
            torch.zeros(doc_len // 8, n), lengths, doc_len)


@pytest.mark.parametrize("check", ["float", "int8", "int8_doc", "int4"])
@pytest.mark.parametrize("doc_len", [32, 96, 160, 48])
def test_operand_checks_take_doc_len_multiple_of_32(check, doc_len):
    """Every CUDA wrapper takes any L that is a multiple of 32, as the JAX
    scans and ``RAGConfig.validate``'s doc-token buckets do (a doc's last
    64-row chunk is then 32 rows), and raises before any launch on other
    lengths."""
    fn = getattr(tm, f"_check_{check}_operands")
    args = _operands_at(check, doc_len)
    if doc_len % 32:
        with pytest.raises(ValueError, match="L % 32"):
            fn(*args)
    else:
        fn(*args)


@pytest.mark.parametrize("layout", ["int8-doc", "int4-doc", "bfloat16",
                                    "float32"])
def test_pruned_route_matches_jax_on_layout(layout):
    """The doc-scale and packed branches: bf16 proxies equal to JAX's up
    to the fp32 sum's order, and the pruned route's ids equal JAX's
    (exact candidate top-k on both; 40 candidates of 61 docs round up to
    every doc, so the ids do not hang on a proxy ulp).

    The port keeps the JAX order of operations (``e * (s * valid)``,
    then the sum over L), but XLA's CPU compiler does not: by shape it
    contracts the multiply into the sum as FMAs (L <= 32 here) or splits
    the sum over L into windows of 32 (L >= 64), so a few fp32 sums
    differ in their last bits. After the L2 normalization that is at
    most ~1e-6 absolute, and a bf16 element differs by one ulp where its
    fp32 value lies next to a rounding boundary (well under 1% of
    elements). At this shape the float layouts' proxies, summed without
    a multiply, come out bit-equal; at others XLA reorders their sums too
    (test_torch_dense.py)."""
    n, doc_len, dim = 64, 32, 32
    x, lengths = _float_docs(17, n, doc_len, dim)
    if layout in ("int8-doc", "int4-doc"):
        flat, dsc, lengths = _doc_layout(17, n, doc_len, dim,
                                         int4=layout == "int4-doc")
        flat_j, dsc_j = jnp.asarray(flat), jnp.asarray(dsc)
        flat_t, dsc_t = torch.from_numpy(flat), torch.from_numpy(dsc)
    else:
        flat_j = jnp.asarray(x.reshape(-1, dim)).astype(layout)
        flat_t = torch.from_numpy(x.reshape(-1, dim)).to(getattr(torch, layout))
        dsc_j = dsc_t = None
    packed = layout == "int4-doc"
    q = _queries(17, 3, 16, dim)
    pooled_j = jp.pooled_doc_embeddings(
        flat_j, None, jnp.asarray(lengths), doc_len=doc_len,
        doc_scales=dsc_j, packed_int4=packed)
    pooled_t = tp.pooled_doc_embeddings(
        flat_t, None, torch.from_numpy(lengths), doc_len=doc_len,
        doc_scales=dsc_t, packed_int4=packed, block=24)
    pt, pj = pooled_t.float().numpy(), np.asarray(pooled_j, np.float32)
    if dsc_t is None:
        assert np.array_equal(pt, pj)
    else:
        np.testing.assert_allclose(pt, pj, rtol=2.0**-7, atol=1e-6)
        assert (pt != pj).mean() <= 0.01
    kw = dict(doc_len=doc_len, n_docs=n - 3, n_candidates=40, k=16)
    jv, ji = jp.maxsim_topk_pruned(
        jnp.asarray(q), flat_j, None, jnp.asarray(lengths), pooled_j,
        doc_scales=dsc_j, approx_recall=1.0, **kw)
    tv, ti = tp.maxsim_topk_pruned(
        torch.from_numpy(q), flat_t, None, torch.from_numpy(lengths),
        pooled_t, doc_scales=dsc_t, block=24, **kw)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_packed_candidate_sims_interleave_tokens():
    flat, _, _ = _doc_layout(3, 4, 16, 16, int4=True)
    docs = torch.from_numpy(flat).reshape(4, 8, 16)
    q = torch.from_numpy(_queries(3, 1, 8, 16))[0]
    sims = tp.candidate_sims(q, docs, packed_pairs=True)
    full = tq.unpack_int4_pairs(docs).float()
    assert torch.equal(sims, tp.candidate_sims(q, full))


# --- subnormal values count as zero, as in XLA -------------------------

@pytest.mark.parametrize("case,want", [
    ("repro", -64.0),          # row 0 1e-40, row 1 0.5: row 1 alone counts
    ("all_subnormal", None),   # every row subnormal: -1e30 per query row
    ("mixed_row", -2.0),       # one normal value among subnormals counts
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_plain_counts_subnormals_as_zero(dtype, case, want):
    """A row whose elements are all subnormal is masked like a zero row
    (XLA counts subnormal values as zero: the TPU kernel's L1 norm is 0),
    in bf16 rows (the same exponent range) and fp32 rows; a row with one
    normal value counts. Doc 1 is ordinary."""
    dim, doc_len, lq = 16, 32, 8
    x = np.zeros((2, doc_len, dim), np.float32)
    sub = np.where(np.arange(dim) % 2 == 0, 1e-40, -3e-40).astype(np.float32)
    if case == "repro":
        x[0, 0] = 1e-40
        x[0, 1] = 0.5
    elif case == "all_subnormal":
        x[0, :20] = sub
    else:
        x[0, 0:4] = sub
        x[0, 5] = sub
        x[0, 5, 3] = 0.25
    rng = np.random.default_rng(3)
    x[1, :24] = rng.standard_normal((24, dim))
    lengths = np.array([doc_len, 24], np.int32)
    q = -np.ones((1, lq, dim), np.float32)
    flat = x.reshape(2 * doc_len, dim)
    js = np.array(jm.maxsim_scores(jnp.asarray(q), jnp.asarray(flat).astype(
        dtype), jnp.asarray(lengths), doc_len=doc_len))
    ts = tm.maxsim_scores(torch.from_numpy(q), torch.from_numpy(flat).to(
        getattr(torch, dtype)), torch.from_numpy(lengths),
        doc_len=doc_len).numpy()
    np.testing.assert_allclose(ts, js, **TOL)
    if want is None:
        np.testing.assert_allclose(ts[0, 0], -1e30 * lq, rtol=1e-6)
    else:
        assert ts[0, 0] == want
