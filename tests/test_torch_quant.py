"""Port int8 row quantization vs the JAX one: bit-equal bytes and scales,
including all-zero rows (scale 0), tiny rows and exact .5 ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.ops.quant import (
    dequantize_int8_rows as jax_dq, quantize_int8_rows as jax_q)
from hybrid_rag_colbertv2_tpu_torch.ops.quant import (
    dequantize_int8_rows, quantize_int8_rows)


def _rows(seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2048, 128)) * scale).astype(np.float32)
    x[3] = 0.0                                  # padding row
    x[9, :] = 1e-30                             # tiny, uniform row
    x[17, :4] = [127.0, 0.5, -0.5, 1.5]         # absmax 127: .5 ties
    x[17, 4:] = 0.0
    return x


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 50.0)])
def test_quantize_int8_rows_bit_equal(seed, scale):
    x = _rows(seed, scale)
    jq, js = jax_q(jnp.asarray(x))
    tq, ts = quantize_int8_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js).view(np.uint32),
                          ts.numpy().view(np.uint32))
    assert ts[3].item() == 0.0 and (tq[3] == 0).all()
    jd = np.asarray(jax_dq(jq, js))
    td = dequantize_int8_rows(tq, ts).numpy()
    assert np.array_equal(jd.view(np.uint32), td.view(np.uint32))


# --- int8-doc and int4-doc layouts --------------------------------------

from hybrid_rag_colbertv2_tpu.ops import quant as jq  # noqa: E402
from hybrid_rag_colbertv2_tpu_torch.ops import quant as tq  # noqa: E402


def _docs(seed, n, doc_len, dim, scale=1.0):
    """Token rows with ragged lengths (0, 1 and full included), padding
    rows zeroed, doc-wide magnitudes spread over 1e-3 .. 50."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, doc_len, dim)).astype(np.float32)
    x *= rng.uniform(1e-3, 50, (n, 1, 1)).astype(np.float32) * scale
    lengths = rng.integers(0, doc_len + 1, n).astype(np.int32)
    lengths[:3] = [0, 1, doc_len]
    x *= (np.arange(doc_len)[None, :] < lengths[:, None])[..., None]
    return x, lengths


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("doc_len", [8, 32, 64, 12])
def test_quantize_int8_docs_bit_equal(doc_len):
    x, lengths = _docs(doc_len, 40, doc_len, 16)
    jqv, jsc = jq.quantize_int8_docs(jnp.asarray(x), jnp.asarray(lengths))
    tqv, tsc = tq.quantize_int8_docs(torch.from_numpy(x),
                                     torch.from_numpy(lengths))
    assert tqv.dtype == torch.int8 and tqv.shape == (40 * doc_len, 16)
    assert np.array_equal(np.asarray(jqv), tqv.numpy())
    assert np.array_equal(_bits(jsc), _bits(tsc.numpy()))
    rows = tqv.reshape(40, doc_len, 16)
    # padding rows copy row 0; the zero-length doc is all zero, scale 0
    assert torch.equal(rows[1, 1:], rows[1, :1].expand(doc_len - 1, 16))
    assert tsc[0].item() == 0.0 and (rows[0] == 0).all()


@pytest.mark.parametrize("doc_len,gsize", [(8, 8), (32, 8), (64, 8),
                                           (12, 4), (6, 2)])
def test_int4_group_size_matches_jax(doc_len, gsize):
    assert tq.int4_group_size(doc_len) == jq.int4_group_size(doc_len) == gsize


def test_int4_group_size_rejects_odd():
    with pytest.raises(ValueError):
        tq.int4_group_size(7)


@pytest.mark.parametrize("doc_len", [8, 32, 64, 12, 6])
def test_quantize_int4_groups_bit_equal(doc_len):
    x, lengths = _docs(100 + doc_len, 40, doc_len, 16)
    lengths[3] = 3                     # a partly valid first group
    lengths[4] = doc_len - 1           # a partly valid last group
    x *= (np.arange(doc_len)[None, :] < lengths[:, None])[..., None]
    jp_, js_ = jq.quantize_int4_groups(jnp.asarray(x), jnp.asarray(lengths))
    tp_, ts_ = tq.quantize_int4_groups(torch.from_numpy(x),
                                       torch.from_numpy(lengths))
    g = tq.int4_group_size(doc_len)
    assert tp_.dtype == torch.int8 and tp_.shape == (40 * doc_len // 2, 16)
    assert ts_.shape == (doc_len // g, 40) and ts_.is_contiguous()
    assert np.array_equal(np.asarray(jp_), tp_.numpy())
    assert np.array_equal(_bits(js_), _bits(ts_.numpy()))
    # unpack and dequantize agree with the JAX helpers bit for bit
    jlo, jhi = jq.unpack_int4(jp_)
    tlo, thi = tq.unpack_int4(tp_)
    assert np.array_equal(np.asarray(jlo), tlo.numpy())
    assert np.array_equal(np.asarray(jhi), thi.numpy())
    pairs = tp_.reshape(40, doc_len // 2, 16)
    assert np.array_equal(np.asarray(jq.unpack_int4_pairs(jnp.asarray(
        pairs.numpy()))), tq.unpack_int4_pairs(pairs).numpy())
    jd = np.asarray(jq.dequantize_int4_groups(jp_, js_))
    td = tq.dequantize_int4_groups(tp_, ts_).numpy()
    assert np.array_equal(_bits(jd), _bits(td))
    # the legacy per-doc (N,) scale vector dequantizes alike
    jd1 = np.asarray(jq.dequantize_int4_groups(jp_, js_[0]))
    td1 = tq.dequantize_int4_groups(tp_, ts_[0]).numpy()
    assert np.array_equal(_bits(jd1), _bits(td1))
    # the dup-row contract: a fully padded group copies row 0 and takes
    # group 0's scale; the zero-length doc is all zero with scales 0
    full = tq.unpack_int4_pairs(pairs)                     # (N, L, D)
    assert (full[0] == 0).all() and (ts_[:, 0] == 0).all()
    if doc_len // g > 1:
        assert torch.equal(full[1, g:], full[1, :1].expand(doc_len - g, 16))
        assert (ts_[1:, 1] == ts_[0, 1]).all()
    assert full.min() >= -7 and full.max() <= 7


# --- subnormal values count as zero, as in XLA -------------------------

def _subnormal_docs(case):
    """(4, 16, 16) fp32 docs, lengths (16, 16, 9, 16): docs 0-2 hold the
    case's values (rows past a length zero), doc 3 ordinary values.
    ``all_subnormal``: every value +-1e-40; ``scale_subnormal``: +-3e-38,
    normal, but absmax / 127 and / 7 are subnormal; ``mixed``: subnormal
    values beside small normal ones whose scale is subnormal."""
    rng = np.random.default_rng(7)
    sign = np.where(rng.random((4, 16, 16)) < 0.5, -1.0, 1.0)
    if case == "all_subnormal":
        mag = np.full((4, 16, 16), 1e-40)
    elif case == "scale_subnormal":
        mag = np.full((4, 16, 16), 3e-38)
    else:
        tiny = rng.uniform(1e-41, 1e-39, (4, 16, 16))
        small = rng.uniform(1.2e-38, 5e-38, (4, 16, 16))
        mag = np.where(np.arange(16) % 2 == 0, tiny, small)
    x = (sign * mag).astype(np.float32)
    x[3] = rng.standard_normal((16, 16)).astype(np.float32)
    lengths = np.array([16, 16, 9, 16], np.int32)
    x *= (np.arange(16)[None, :] < lengths[:, None])[..., None]
    return x, lengths


@pytest.mark.parametrize("case", ["all_subnormal", "scale_subnormal",
                                  "mixed"])
@pytest.mark.parametrize("quantizer", ["int8_rows", "int8_docs",
                                       "int4_groups"])
def test_quantizers_count_subnormals_as_zero(quantizer, case):
    """The three quantizers equal XLA's bit for bit where a value or a
    scale is subnormal: both are zero there, so such a row, doc or group
    gets scale 0 and codes 0."""
    x, lengths = _subnormal_docs(case)
    if quantizer == "int8_rows":
        jv, js = jq.quantize_int8_rows(jnp.asarray(x.reshape(-1, 16)))
        tv, ts = tq.quantize_int8_rows(torch.from_numpy(x.reshape(-1, 16)))
    else:
        args = (x, lengths)
        jv, js = getattr(jq, f"quantize_{quantizer}")(
            *(jnp.asarray(a) for a in args))
        tv, ts = getattr(tq, f"quantize_{quantizer}")(
            *(torch.from_numpy(a) for a in args))
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(_bits(js), _bits(ts.numpy()))
    # docs 0-2 hold no normal scale: their scales and codes are all 0
    per_doc = ts.reshape(4, -1) if quantizer == "int8_rows" else ts.reshape(
        -1, 4).T
    assert (per_doc[:3] == 0).all() and (per_doc[3] > 0).all()
    codes = tv.reshape(4, -1)
    assert (codes[:3] == 0).all() and (codes[3] != 0).any()


def test_flush_subnormal():
    tiny = torch.finfo(torch.float32).tiny
    x = torch.tensor([1e-40, -1e-40, -0.0, tiny, -tiny, 3e-38, 0.5,
                      float("inf")])
    y = tq.flush_subnormal(x)
    assert torch.equal(y, torch.cat([torch.zeros(3), x[3:]]))
    assert not torch.signbit(y[:3]).any()          # +0 throughout
