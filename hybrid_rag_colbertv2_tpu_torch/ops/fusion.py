"""Reciprocal-rank fusion + top-k selection — port of
``hybrid_rag_colbertv2_tpu/ops/fusion.py``.

Each source list contributes ``weight / (k + rank)`` with rank starting
at 1; a document in both lists accumulates both; results are ordered by
fused score descending, ties by ascending doc id. As in the JAX version
the merge is a sort over the ~Ka+Kb candidate ids (stable argsort, then a
segment sum over equal-id runs), so no (B, N) vector is ever built.
``jnp.argsort`` is stable, so every argsort here is too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .topk import top_k

_BIG = torch.iinfo(torch.int32).max


def union_floor_split(k_final: int, weight_bm25: float,
                      union_m: int = 0) -> Tuple[int, int]:
    """Weight-tied asymmetric union floors -> (m_bm25, m_dense).

    The floor budget is 2m (m = ``union_m`` or k_final // 2) split by the
    BM25 leg weight: m_bm25 = round(2m * w), clamped to [1, 2m-1] so
    neither floor drops to zero for 0 < w < 1; w = 0.5 gives (m, m).
    k_final = 1 (m = 0) gives (0, 0): union degenerates to the blend.
    See the JAX version for the measurement behind the weight tie."""
    m = union_m if union_m > 0 else k_final // 2
    if m <= 0:
        return 0, 0
    tot = 2 * m
    mb = int(tot * weight_bm25 + 0.5)
    mb = max(1, min(tot - 1, mb))
    return mb, tot - mb


def _rank_weights(n: int, weight: float, rrf_k: int, floor: int,
                  device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)
    # the weight rounded to fp32 first, as in JAX; a fill, not a copy
    # from the host, so the cascade stays capturable in a CUDA graph
    w = torch.full((), weight, dtype=torch.float32, device=device) / (
        rrf_k + 1.0 + pos)
    if floor > 0:
        # tier gap 1e3 >> max possible sum (weights sum <= ~4/(rrf_k+1))
        w = w + torch.where(pos < floor, 1e3 * (floor - pos), 0.0)
    return w


def rrf_from_topk(
    ids_a: torch.Tensor,      # (B, Ka) int doc ids, rank-ordered
    ids_b: torch.Tensor,      # (B, Kb) int
    *,
    k: int,                   # number of fused candidates to keep
    rrf_k: int = 60,
    weights: Tuple[float, float] = (1.0, 1.0),
    floor_m=0,                # int (symmetric) or (m_a, m_b)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse two ranked id lists -> (fused_scores (B,k), fused_ids (B,k)).

    Ids < 0 are missing and ignored; a short fused list pads with score
    0 / id -1. ``weights`` scales each list's rank contributions;
    ``floor_m`` puts each leg's live top-m in a bonus tier that survives
    the cut (the ``final_fusion="union"`` contract)."""
    b, ka = ids_a.shape
    kb = ids_b.shape[1]
    kt = ka + kb
    dev = ids_a.device
    fa, fb = (floor_m, floor_m) if isinstance(floor_m, int) else floor_m
    wa = _rank_weights(ka, weights[0], rrf_k, fa, dev)
    wb = _rank_weights(kb, weights[1], rrf_k, fb, dev)

    ids = torch.cat([ids_a, ids_b], dim=1).long()             # (B, Kt)
    w = torch.cat([torch.where(ids_a >= 0, wa, 0.0),
                   torch.where(ids_b >= 0, wb, 0.0)], dim=1)
    sid = torch.where(ids >= 0, ids, _BIG)                    # missing last
    order = torch.argsort(sid, dim=1, stable=True)
    s_ids = torch.gather(sid, 1, order)
    s_w = torch.gather(w, 1, order)
    # contiguous equal-id runs -> segments; sum each run's weights
    start = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                       s_ids[:, 1:] != s_ids[:, :-1]], dim=1)
    seg = torch.cumsum(start.long(), dim=1) - 1
    # a run holds at most one id per list, so each sum adds <= 2 terms to
    # 0 and is exact in any order (CUDA scatter_add_ uses atomics)
    sums = torch.zeros((b, kt), dtype=torch.float32, device=dev)
    sums.scatter_add_(1, seg, s_w)
    uids = torch.full((b, kt), torch.iinfo(torch.int32).min,
                      dtype=torch.long, device=dev)
    uids.scatter_reduce_(1, seg, torch.where(start, s_ids, -1),
                         reduce="amax")

    kk = min(k, kt)
    scores, pos = top_k(sums, kk)
    out_ids = torch.gather(uids, 1, pos)
    # zero fused score = empty/missing segment — mark id -1
    out_ids = torch.where(scores > 0.0, out_ids, -1)
    if kk < k:
        scores = torch.nn.functional.pad(scores, (0, k - kk))
        out_ids = torch.nn.functional.pad(out_ids, (0, k - kk), value=-1)
    return scores, out_ids.to(torch.int32)


def reciprocal_rank_fusion(
    scores_a: torch.Tensor,   # (B, N) e.g. BM25 scores
    scores_b: torch.Tensor,   # (B, N) e.g. MaxSim scores
    *,
    k_each: int = 100,
    k_out: int = 50,
    rrf_k: int = 60,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-source top-k -> RRF -> top-k_out (the reference cascade's
    fusion; zero-score ids are not masked, see the JAX version)."""
    n = scores_a.shape[-1]
    ke = min(k_each, n)
    _, ids_a = top_k(scores_a, ke)
    _, ids_b = top_k(scores_b, ke)
    return rrf_from_topk(ids_a.to(torch.int32), ids_b.to(torch.int32),
                         k=min(k_out, n), rrf_k=rrf_k)


def _rank_of(x: torch.Tensor) -> torch.Tensor:
    """Descending rank of each entry (0 = best), ties by position."""
    order = torch.argsort(-x, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True).to(torch.float32)


def final_topk_select(
    rerank: torch.Tensor,     # (B, C) exact MaxSim rerank scores
    fused_ids: torch.Tensor,  # (B, C) candidate ids in RRF order, -1 missing
    k_final: int,
    *,
    rrf_k: int = 60,
    final_fusion: str = "rerank",
    weight_cand: float = 0.5,
    bm25_ids: Optional[torch.Tensor] = None,   # (B, >=m) ("union")
    dense_ids: Optional[torch.Tensor] = None,  # (B, >=m) ("union")
    union_m: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final top-k over the fused candidates -> (ids (B,k), scores (B,k)).

    ``"rerank"``: order by the exact MaxSim rerank (reference parity).
    ``"rrf"``: order by RRF(rerank rank, candidate-RRF rank), tilted by
    ``weight_cand``. ``"union"``: the same blend, with every live id of
    BM25's top-m_b and dense's top-m_d (``union_floor_split``) hoisted
    above the rest; the candidate term uses the true leg ranks. Reported
    scores are always the exact MaxSim values; ids < 0 never surface."""
    live = fused_ids >= 0
    rerank = torch.where(live, rerank, -torch.inf)
    if final_fusion in ("rrf", "union"):
        kc = rerank.shape[1]
        rr_rank = _rank_of(rerank)
        wc, wr = 2.0 * weight_cand, 2.0 * (1.0 - weight_cand)
        if final_fusion == "union":
            if bm25_ids is None or dense_ids is None:
                raise ValueError(
                    "final_fusion='union' needs bm25_ids and dense_ids")
            mb, md = union_floor_split(k_final, weight_cand, union_m)

            def leg_rank(leg):
                eq = ((fused_ids[:, :, None] == leg[:, None, :])
                      & (leg[:, None, :] >= 0))
                pos = torch.arange(leg.shape[1], dtype=torch.float32,
                                   device=leg.device)[None, None, :]
                return torch.where(eq, pos, torch.inf).amin(dim=-1)

            ra = leg_rank(bm25_ids)              # (B, C) inf = absent
            rb = leg_rank(dense_ids)
            rrf_true = (wc / (rrf_k + 1.0 + ra)
                        + (2.0 - wc) / (rrf_k + 1.0 + rb))
            cand_rank = _rank_of(rrf_true)
            guaranteed = (ra < mb) | (rb < md)
            sel = (wr / (rrf_k + 1.0 + rr_rank)
                   + wc / (rrf_k + 1.0 + cand_rank)
                   + torch.where(guaranteed, 1e3, 0.0))
        else:
            pos = torch.arange(kc, dtype=torch.float32, device=rerank.device)
            sel = (wr / (rrf_k + 1.0 + rr_rank)
                   + wc / (rrf_k + 1.0 + pos))
        sel = torch.where(live, sel, -torch.inf)
    elif final_fusion == "rerank":
        sel = rerank
    else:
        raise ValueError(f"unknown final_fusion: {final_fusion!r}")
    sel_vals, top_pos = top_k(sel, min(k_final, sel.shape[1]))
    final_ids = torch.gather(fused_ids, 1, top_pos)
    final_ids = torch.where(torch.isfinite(sel_vals), final_ids, -1)
    top_vals = torch.gather(rerank, 1, top_pos)
    return final_ids.to(torch.int32), top_vals


def rrf_reference_py(ranked_a, ranked_b, rrf_k: int = 60):
    """Pure-Python RRF oracle mirroring local_rag_complete.py:960-978
    (dict accumulate, sort by fused score desc). For tests only."""
    scores = {}
    for rank, cid in enumerate(ranked_a, 1):
        scores[cid] = scores.get(cid, 0.0) + 1.0 / (rrf_k + rank)
    for rank, cid in enumerate(ranked_b, 1):
        scores[cid] = scores.get(cid, 0.0) + 1.0 / (rrf_k + rank)
    return sorted(scores.items(), key=lambda x: -x[1])
