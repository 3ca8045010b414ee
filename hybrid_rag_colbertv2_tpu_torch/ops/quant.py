"""Quantization of the dense token-embedding index — port of
``hybrid_rag_colbertv2_tpu/ops/quant.py``.

Three layouts, all searched by a CUDA MaxSim kernel (ops/maxsim.py):

  * ``int8``      per-token-row absmax scales (``quantize_int8_rows``);
  * ``int8-doc``  one scale per document; padding rows copy the doc's
                  row 0, so the scan needs no mask (``quantize_int8_docs``);
  * ``int4-doc``  per-token-group scales, two tokens nibble-packed into
                  one full-width row (``quantize_int4_groups``).

The bytes and scales are bit-equal to the JAX version: the same fp32
arithmetic, rounding half to even (``jnp.round`` / ``torch.round``), and
the clips. XLA folds the JAX version's ``absmax / 127.0`` and
``absmax / 7.0`` into a multiply by the fp32 reciprocal; the port does
the same (``x / safe`` stays a true division on both sides). XLA also
counts subnormal values as zero; the port flushes the input and the
scale (``flush_subnormal``), so a row whose absmax / 127 is subnormal
gets scale 0 and codes 0 on both sides.
"""

from __future__ import annotations

from typing import Tuple

import torch


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` with every element of magnitude below 2**-126 (the
    subnormals, and -0) set to +0.

    XLA, which runs the JAX package, treats subnormal fp32 inputs as zero
    and flushes subnormal results to zero: on the CPU its quantizers give
    a row of 1e-40, or of 3e-38 (absmax / 127 is subnormal), scale 0 and
    codes 0, and its float scan masks a row of subnormals like a row of
    zeros (tests/test_torch_quant.py, tests/test_torch_maxsim.py). The
    port applies it where those results depend on it."""
    tiny = torch.finfo(torch.float32).tiny      # the least normal fp32
    return torch.where(x.abs() < tiny, torch.zeros_like(x), x)


def quantize_int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (rows, D) -> int8 values + per-row fp32 scales.

    Symmetric absmax quantization: v = round(x / scale), scale = absmax/127.
    All-zero rows (padding tokens) get scale 0 so they dequantize to 0.
    """
    x = flush_subnormal(x.to(torch.float32))
    absmax = x.abs().amax(dim=-1)                               # (rows,)
    scale = flush_subnormal(absmax * (1.0 / 127.0))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    return q.to(torch.float32) * scale[:, None]


def quantize_int8_docs(
    embs3: torch.Tensor,       # (N, L, D) fp — padded token rows zero
    lengths: torch.Tensor,     # (N,) int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-document absmax int8 (index dtype ``int8-doc``):
    -> ((N * L, D) int8, (N,) f32 scales).

    Padded token rows are stored as copies of the doc's row 0, so the
    max over all L rows equals the max over the valid ones; zero-length
    docs stay all-zero with scale 0 and score exactly 0."""
    x = flush_subnormal(embs3.to(torch.float32))
    n, l, d = x.shape
    absmax = x.abs().amax(dim=(1, 2))                           # (N,)
    scale = flush_subnormal(absmax * (1.0 / 127.0))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None, None]), -127, 127)
    tok = torch.arange(l, device=x.device)
    valid = tok[None, :, None] < lengths.to(x.device)[:, None, None]
    q = torch.where(valid, q, q[:, 0:1, :])                     # dup row 0
    return q.to(torch.int8).reshape(n * l, d), scale


def int4_group_size(doc_len: int, group: int = 8) -> int:
    """Token rows per int4 quantization group: the largest of
    (group, group/2, …, 2) dividing ``doc_len``. Even, so group
    boundaries align with the nibble-packed pair-rows."""
    g = group
    while g > 2 and doc_len % g != 0:
        g //= 2
    if doc_len % g != 0 or g % 2 != 0:
        raise ValueError(f"no even int4 group divides doc_len={doc_len}")
    return g


def quantize_int4_groups(
    embs3: torch.Tensor,       # (N, L, D) fp — padded token rows zero
    lengths: torch.Tensor,     # (N,) int
    *,
    group: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-group absmax int4, nibble-packed (index dtype
    ``int4-doc``): -> ((N * L/2, D) int8 packed, (G, N) f32 scales).

    ``int4_group_size(L, group)`` consecutive rows share one scale
    (group absmax / 7); values lie in [-7, 7]. Storage row ``s`` of a
    doc packs token rows ``2s`` (low nibble) and ``2s + 1`` (high
    nibble), feature ``j`` in byte ``j``. Padding contract: a padded row
    in a partly valid group copies the group's first row; a fully padded
    group copies the doc's row 0 and takes group 0's scale; zero-length
    docs stay all-zero with all scales 0. The scales keep the doc axis
    minor, as the JAX package stores them."""
    x = flush_subnormal(embs3.to(torch.float32))
    n, l, d = x.shape
    g = int4_group_size(l, group)
    ng = l // g
    lengths = lengths.to(x.device)
    xg = x.reshape(n, ng, g, d)
    absmax = xg.abs().amax(dim=(2, 3))                          # (N, G)
    scale = flush_subnormal(absmax * (1.0 / 7.0))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xg / safe[:, :, None, None]), -7, 7
                    ).to(torch.int32)                           # (N,G,g,D)
    gstart = torch.arange(ng, device=x.device) * g              # (G,)
    g_live = gstart[None, :] < lengths[:, None]                 # (N, G)
    fill = torch.where(g_live[:, :, None], q[:, :, 0, :],
                       q[:, 0:1, 0, :])                         # (N, G, D)
    scale = torch.where(g_live, scale, scale[:, 0:1])           # (N, G)
    tok = torch.arange(l, device=x.device).reshape(ng, g)
    valid = tok[None] < lengths[:, None, None]                  # (N, G, g)
    q = torch.where(valid[..., None], q, fill[:, :, None, :])
    q = q.reshape(n, l, d)
    lo = q[:, 0::2, :]                                          # even rows
    hi = q[:, 1::2, :]                                          # odd rows
    # fits int8 exactly: hi << 4 in [-112, 112], the low nibble adds < 16
    packed = (lo & 0xF) | (hi << 4)
    return (packed.to(torch.int8).reshape(n * (l // 2), d),
            scale.T.contiguous())                               # (G, N)


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int4 bytes -> (lo, hi) sign-extended int32 values in
    [-8, 7], same shape as ``packed``; lo is the even token row of the
    pair, hi the odd one (arithmetic shifts)."""
    p = packed.to(torch.int32)
    return (p << 28) >> 28, p >> 4


def unpack_int4_pairs(packed: torch.Tensor) -> torch.Tensor:
    """(..., L/2, D) packed pair-rows -> (..., L, D) int32 values in
    token order."""
    lo, hi = unpack_int4(packed)
    st = torch.stack([lo, hi], dim=-2)                          # (..., L/2, 2, D)
    return st.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                      packed.shape[-1])


def doc_row_scales(doc_scales: torch.Tensor,  # (N,) int8-doc; (G, N) int4-doc
                   ids: torch.Tensor,         # (...) doc ids
                   doc_len: int) -> torch.Tensor:  # (..., L) f32
    """Per-token-row scales of docs ``ids`` from the int8-doc per-doc
    vector or the int4-doc per-group array (``doc_len / G`` rows per
    group)."""
    if doc_scales.dim() == 2:
        sc = torch.movedim(doc_scales[:, ids], 0, -1)           # (..., G)
        return sc.repeat_interleave(doc_len // doc_scales.shape[0], dim=-1)
    return doc_scales[ids][..., None].expand(*ids.shape, doc_len)


def dequantize_int4_groups(packed_flat: torch.Tensor,   # (N * L/2, D) int8
                           group_scales: torch.Tensor,  # (G, N), or (N,)
                           ) -> torch.Tensor:           # (N * L, D) f32
    """Full fp32 reconstruction of an int4-doc index (tests and
    oracles only; the kernels read the packed pair-rows). A 1-D
    ``group_scales`` is a legacy per-doc vector, uniform over groups."""
    rows, d = packed_flat.shape
    if group_scales.dim() == 1:
        n = group_scales.shape[0]
        sc_rows = group_scales[:, None]                         # (N, 1)
    else:
        ng, n = group_scales.shape
        g = (rows // n) * 2 // ng                               # rows per group
        sc_rows = group_scales.T.repeat_interleave(g, dim=1)    # (N, L)
    lh = rows // n
    full = unpack_int4_pairs(packed_flat.reshape(n, lh, d)).to(torch.float32)
    return (full * sc_rows[:, :, None]).reshape(n * lh * 2, d)
