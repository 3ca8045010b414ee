"""Pruned (two-stage) dense search — port of
``hybrid_rag_colbertv2_tpu/ops/prefilter.py``.

  stage A  proxy = (sum_i q_i) . pooled_doc — one (B, D) x (D, N) matmul
           over the (N, D) pooled embeddings, top-C candidates;
  stage B  exact fp32 MaxSim only on the C gathered candidates.

With C >= N the result equals the full scan. Candidate selection is
always exact top-k (``jax.lax.approx_max_k`` has no torch counterpart).
Every flat layout is served: int8 (row scales), int8-doc (doc scales),
int4-doc (nibble-packed pair-rows, group scales) and the float dtypes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .maxsim import NEG_INF
from .quant import doc_row_scales, unpack_int4, unpack_int4_pairs
from .topk import top_k


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def candidate_sims(q: torch.Tensor,     # (..., Lq, D) f32 query tokens
                   docs: torch.Tensor,  # (..., C, L, D) raw — or (..., C, L/2, D) packed
                   packed_pairs: bool = False,
                   ) -> torch.Tensor:   # (..., C, Lq, L) f32, before dequant
    """Per-candidate token similarity block from raw gathered index rows
    (int8 and int4 values are exact in fp32; dequantization follows on
    the sims). Nibble-packed int4 pair-rows are consumed as two products
    whose sims interleave back to token order, so the gather moves the
    packed bytes. Leading dims broadcast, so a whole query batch is one
    call. ``packed_pairs`` is the caller's: a packed array has a raw
    one's width."""
    q = q.to(torch.float32)
    if packed_pairs:
        lo, hi = unpack_int4(docs)                        # (..., C, L/2, D)
        s_lo = torch.einsum("...qd,...cld->...cql", q, lo.to(torch.float32))
        s_hi = torch.einsum("...qd,...cld->...cql", q, hi.to(torch.float32))
        # [even0, odd0, even1, ...]: the original token order
        return torch.stack([s_lo, s_hi], dim=-1).flatten(-2)
    return torch.einsum("...qd,...cld->...cql", q, docs.to(torch.float32))


def pooled_doc_embeddings(
    emb_flat: torch.Tensor,             # (N_pad * L, D) — or (N_pad * L/2, D) packed
    scales: Optional[torch.Tensor],     # (N_pad * L,) f32 when int8
    doc_lengths: torch.Tensor,          # (N_pad,) int
    *,
    doc_len: int,
    doc_scales: Optional[torch.Tensor] = None,  # (N_pad,) int8-doc;
    # (G, N_pad) int4-doc group scales
    packed_int4: bool = False,
    block: int = 1024,
) -> torch.Tensor:                      # (N_pad, D) bf16, L2-normalized
    """Per-document L2-normalized mean token embedding (the proxy
    vectors). Padded token rows are zeros in the int8 and float layouts,
    so a plain sum over the token axis is the sum over valid tokens; the
    doc-scale layouts copy valid rows into padding, so they mask by
    ``doc_lengths``, in the JAX package's order of operations
    (``e * (s * valid)``, then the sum over L) so the bf16 proxies are
    bit-equal. Blocked over docs so a large index never materializes in
    fp32."""
    n_pad = doc_lengths.shape[0]
    d = emb_flat.shape[-1]
    embs = emb_flat.reshape(n_pad, doc_len // 2 if packed_int4 else doc_len,
                            d)
    scs = scales.reshape(n_pad, doc_len) if scales is not None else None
    tok = torch.arange(doc_len, device=emb_flat.device)
    summed = torch.empty((n_pad, d), dtype=torch.float32,
                         device=emb_flat.device)
    for s in range(0, n_pad, block):
        e = embs[s:s + block]
        if packed_int4:
            e = unpack_int4_pairs(e)                      # (nb, L, D)
        e = e.to(torch.float32)
        if doc_scales is not None:
            valid = (tok[None, :] < doc_lengths[s:s + block, None]).to(
                torch.float32)
            ids = torch.arange(s, min(s + block, n_pad),
                               device=emb_flat.device)
            sc = doc_row_scales(doc_scales, ids, doc_len)
            e = e * (sc * valid)[..., None]
        elif scs is not None:
            e = e * scs[s:s + block, :, None]
        summed[s:s + block] = e.sum(dim=1)
    denom = torch.clamp(doc_lengths.to(torch.float32), min=1.0)[:, None]
    mean = summed / denom
    norm = torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
    return (mean / torch.clamp(norm, min=1e-9)).to(torch.bfloat16)


def pooled_proxy_topk(
    queries: torch.Tensor,              # (B, Lq, D) — padded rows zero
    pooled: torch.Tensor,               # (N_pad, D) bf16
    doc_lengths: torch.Tensor,          # (N_pad,)
    *,
    n_docs: int,
    c: int,
    approx_recall: float = 0.95,        # accepted for parity; exact top-k
) -> torch.Tensor:                      # (B, C) candidate ids int32
    """Stage A: pooled-cosine proxy over the whole corpus + top-C. The
    bf16 operands are exact in fp32, so the fp32 product equals the JAX
    bf16 dot with fp32 accumulation up to summation order."""
    n_pad = doc_lengths.shape[0]
    qbar = queries.to(torch.float32).sum(dim=1)                  # (B, D)
    proxy = qbar.to(torch.bfloat16).to(torch.float32) @ \
        pooled.to(torch.float32).T                               # (B, N_pad)
    col = torch.arange(n_pad, device=pooled.device)
    keep = (col[None, :] < n_docs) & (doc_lengths[None, :] > 0)
    proxy = torch.where(keep, proxy, NEG_INF)
    _, cand = top_k(proxy, c)
    return cand.to(torch.int32)


def exact_maxsim_on_candidates(
    queries: torch.Tensor,              # (B, Lq, D)
    emb_flat: torch.Tensor,             # (N_pad * L, D) — or (N_pad * L/2, D) packed
    scales: Optional[torch.Tensor],     # (N_pad * L,) f32 when int8
    doc_lengths: torch.Tensor,          # (N_pad,)
    cand: torch.Tensor,                 # (B, C) candidate ids (>= 0)
    doc_scales: Optional[torch.Tensor] = None,
    *,
    doc_len: int,
    block: int = 256,
) -> torch.Tensor:                      # (B, C) exact fp32 MaxSim scores
    """Stage B: gather candidate rows in the stored dtype, fp32 MaxSim
    with dequantization on the (Lq, L) sims (sim(q, s*e) = s*(q.e)), in
    blocks of ``block`` candidates to bound the fp32 working set."""
    n_pad = doc_lengths.shape[0]
    d = emb_flat.shape[-1]
    b, c = cand.shape
    q32 = queries.to(torch.float32)
    # nibble-packed int4 pair-rows carry L/2 stored rows per doc at full
    # width: detected by the row count, not the width
    packed = emb_flat.shape[0] * 2 == n_pad * doc_len
    embs3 = emb_flat.reshape(n_pad, doc_len // 2 if packed else doc_len, d)
    scs2 = scales.reshape(n_pad, doc_len) if scales is not None else None
    tok = torch.arange(doc_len, device=emb_flat.device)
    out = torch.empty((b, c), dtype=torch.float32, device=emb_flat.device)
    for s in range(0, c, block):
        ib = cand[:, s:s + block].long()                   # (B, cb)
        sims = candidate_sims(q32, embs3[ib], packed_pairs=packed)
        if scs2 is not None:
            sims = sims * scs2[ib][:, :, None, :]
        elif doc_scales is not None:
            # the doc-scale layouts' copied padding rows are masked by
            # the lengths below
            sc = doc_row_scales(doc_scales, ib, doc_len)   # (B, cb, L)
            sims = sims * sc[:, :, None, :]
        valid = tok < doc_lengths[ib][..., None]           # (B, cb, L)
        sims = torch.where(valid[:, :, None, :], sims, NEG_INF)
        out[:, s:s + block] = sims.amax(dim=-1).sum(dim=-1)
    return out


def maxsim_topk_pruned(
    queries: torch.Tensor,              # (B, Lq, D) — padded rows zero
    emb_flat: torch.Tensor,             # (N_pad * L, D)
    scales: Optional[torch.Tensor],     # (N_pad * L,) f32 when int8
    doc_lengths: torch.Tensor,          # (N_pad,)
    pooled: torch.Tensor,               # (N_pad, D)
    doc_scales: Optional[torch.Tensor] = None,
    *,
    doc_len: int,
    n_docs: int,
    n_candidates: int,
    k: int,
    block: int = 256,
    approx_recall: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:  # (B, k) scores f32, ids int32
    """Two-stage dense top-k: pooled-cosine top-C, exact MaxSim rerank.
    C is ``n_candidates`` rounded up to 128, at most N_pad."""
    n_pad = doc_lengths.shape[0]
    c = min(_round_up(n_candidates, 128), n_pad)
    cand = pooled_proxy_topk(queries, pooled, doc_lengths, n_docs=n_docs,
                             c=c, approx_recall=approx_recall)
    exact = exact_maxsim_on_candidates(
        queries, emb_flat, scales, doc_lengths, cand,
        doc_scales=doc_scales, doc_len=doc_len, block=block)
    kk = min(k, c)
    vals, pos = top_k(exact, kk)
    ids = torch.gather(cand, 1, pos)
    ids = torch.where(vals > NEG_INF / 2, ids, -1)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return vals, ids.to(torch.int32)
