"""The comparison that decides ``correct``.

The served answer of a query is its final id list and the exact scores
beside the ids. Three numbers compare a sample of served answers with
the reference's (each number's limit lives in the cell's file):

- ``score_err``: the widest gap between a served score and the
  reference's exact MaxSim of the same doc, over |that score| (at least
  1). The encoder, the gather, the dequantization and the rerank.
- ``missing_ids``: the share of the reference's answer ids that the
  served answer lacks. BM25, the dense top-k, the fusion.
- ``order_gap``: the widest rise of the reference's exact score from
  one served doc to the next, over |the first| (at least 1): the served
  order must follow the scores (a served -1 before a doc reads 1). It
  reads the order alone, so a sound near-tie that swaps one doc in or
  out at the fusion's cut (``missing_ids``) does not move it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch

NUMBERS = ("score_err", "missing_ids", "order_gap")


def numbers(served_ids: np.ndarray, served_scores: np.ndarray,
            ref_ids: np.ndarray, ref_scores: np.ndarray,
            ref_score_of: Callable[[int, np.ndarray], np.ndarray]
            ) -> Dict[str, float]:
    """``served_*`` and ``ref_*``: (S, k); ``ref_score_of(s, ids)`` the
    reference's exact score of query s with docs ``ids`` (-1 -> -inf)."""
    score_err = order_gap = 0.0
    missing = total = 0
    for s in range(served_ids.shape[0]):
        sid = served_ids[s].astype(np.int64)
        ref_of_served = ref_score_of(s, sid)
        for r in range(sid.shape[0]):
            if sid[r] < 0:
                continue
            ref = float(ref_of_served[r])
            err = (abs(float(served_scores[s, r]) - ref)
                   / max(abs(ref), 1.0)) if math.isfinite(ref) else 1.0
            score_err = max(score_err, err)
            if r > 0:
                prev = float(ref_of_served[r - 1])
                rise = ((ref - prev) / max(abs(prev), 1.0)
                        if math.isfinite(prev) and math.isfinite(ref)
                        else 1.0)
                order_gap = max(order_gap, min(rise, 1.0))
        ref_set = {int(i) for i in ref_ids[s] if i >= 0}
        missing += len(ref_set - {int(i) for i in sid if i >= 0})
        total += len(ref_set)
    return {"score_err": score_err,
            "missing_ids": missing / max(total, 1),
            "order_gap": order_gap}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit."""
    return all(values[n] <= limits[n] for n in NUMBERS)


def check_lines(values: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, Dict[str, float]]:
    return {n: {"value": values[n], "limit": limits[n]} for n in NUMBERS}


def sample_indices(n: int, size: int, longest: int,
                   rng: np.random.Generator) -> Sequence[int]:
    """``size`` of ``n`` answers drawn by ``rng``, with ``longest``
    always among them."""
    pick = set(rng.choice(n, size=min(size, n), replace=False).tolist())
    if longest not in pick:
        pick.discard(next(iter(pick)))
        pick.add(longest)
    return sorted(pick)


def score_fn(reference, q_emb: torch.Tensor):
    """``ref_score_of`` over the reference's query embeddings."""
    def f(s: int, ids: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(ids, device=q_emb.device)
        with torch.no_grad():
            return reference.exact_scores(q_emb[s], t).cpu().numpy()
    return f
