"""On-device sparse BM25 scoring — port of
``hybrid_rag_colbertv2_tpu/ops/bm25.py``.

The lexical index is a term-major CSR of precomputed BM25 term-document
weights (index/lexical.py). Scoring gathers each query term's postings
window. ``bm25_scores_device`` scatter-adds it into a dense per-document
vector; ``bm25_topk_device`` sorts the (doc, weight) pairs by doc id and
sums equal-id runs, independent of corpus size.

Layout:
  indptr       (V + 1,) int32 — postings offsets per term id
  post_docs    (nnz_pad,) int32 — document ids (global), padded
  post_weights (nnz_pad,) f32  — BM25 weight of (term, doc), padded with 0

A query is a fixed-size vector of term ids (padded with -1). Each query
token occurrence contributes its term's postings once. Values are
bit-equal to the JAX version: the windows, the stable sort and the
bounded run-relative scan are the same operations in the same order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .topk import top_k

_BIG_DOC = 2**30    # sentinel doc id: sorts after every real doc


def _postings_windows(query_terms, indptr, post_docs, post_weights,
                      max_postings):
    """-> (docs (B, Q, P), weights (B, Q, P), valid (B, Q, P)).

    Each term's postings are one contiguous window of ``max_postings``
    entries; a window that would run past nnz is shifted left and its
    validity range shifts with it (the JAX version's dynamic_slice)."""
    nnz = post_docs.shape[0]
    if max_postings > nnz:
        raise ValueError(f"max_postings {max_postings} > nnz {nnz}")
    terms = query_terms.long()
    t = terms.clamp(0, indptr.shape[0] - 2)
    start = indptr[t].long()                               # (B, Q)
    length = indptr[t + 1].long() - start
    offs = torch.arange(max_postings, device=post_docs.device)
    start_c = torch.clamp(torch.minimum(start, torch.full_like(
        start, nnz - max_postings)), min=0)
    shift = start - start_c                                # (B, Q) >= 0
    idx = start_c[..., None] + offs                        # (B, Q, P)
    valid = ((offs >= shift[..., None])
             & (offs < (shift + length)[..., None])
             & (terms >= 0)[..., None])
    return post_docs[idx], post_weights[idx], valid


def bm25_scores_device(
    query_terms: torch.Tensor,   # (B, Q) int, -1 padded
    indptr: torch.Tensor,        # (V + 1,) int32
    post_docs: torch.Tensor,     # (nnz_pad,) int32
    post_weights: torch.Tensor,  # (nnz_pad,) float32
    *,
    n_docs: int,
    max_postings: int,
) -> torch.Tensor:               # (B, n_docs) float32
    docs_w, w_w, valid = _postings_windows(
        query_terms, indptr, post_docs, post_weights, max_postings)
    b = query_terms.shape[0]
    docs = torch.where(valid, docs_w.long(), n_docs).reshape(b, -1)
    w = torch.where(valid, w_w, 0.0).reshape(b, -1)
    dense = torch.zeros((b, n_docs + 1), dtype=torch.float32,
                        device=post_weights.device)
    dense.scatter_add_(1, docs, w)                         # dump slot n_docs
    return dense[:, :n_docs]


def bm25_topk_device(
    query_terms: torch.Tensor,   # (B, Q) int, -1 padded
    indptr: torch.Tensor,
    post_docs: torch.Tensor,
    post_weights: torch.Tensor,
    *,
    n_docs: int,
    max_postings: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:   # vals (B, k) f32, ids (B, k) int32
    """Exact BM25 top-k without the (B, N)-wide scatter: sort the
    gathered (doc, weight) pairs by doc id (stable), total each equal-id
    run with the bounded segmented scan, top-k the run totals. Missing
    slots (score <= 0) are id -1."""
    b, q_width = query_terms.shape
    qp = q_width * max_postings
    kk = min(k, qp)
    docs_w, w_w, valid = _postings_windows(
        query_terms, indptr, post_docs, post_weights, max_postings)
    docs = torch.where(valid, docs_w.long(), _BIG_DOC).reshape(b, qp)
    w = torch.where(valid, w_w, 0.0).reshape(b, qp)

    docs_s, order = torch.sort(docs, dim=1, stable=True)
    w_s = torch.gather(w, 1, order)
    boundary = docs_s[:, 1:] != docs_s[:, :-1]
    ones = torch.ones((b, 1), dtype=torch.bool, device=docs.device)
    run_start = torch.cat([ones, boundary], dim=1)
    run_end = torch.cat([boundary, ones], dim=1)
    # Bounded segmented scan, kept as written in the JAX version: no run
    # is longer than Q, so ceil(log2(Q)) masked shift-add passes reach
    # every run total, and each element combines only its own run's
    # weights in a tree fixed by run-relative offsets (a cumsum
    # difference would give other ulps).
    acc, flag, step = w_s, run_start, 1
    while step < q_width:
        prev_acc = torch.cat([torch.zeros_like(acc[:, :step]),
                              acc[:, :-step]], dim=1)
        prev_flag = torch.cat([torch.ones_like(flag[:, :step]),
                               flag[:, :-step]], dim=1)
        acc = acc + torch.where(flag, 0.0, prev_acc)
        flag = flag | prev_flag
        step *= 2
    totals = torch.where(run_end & (docs_s < _BIG_DOC), acc, 0.0)

    vals, pos = top_k(totals, kk)
    ids = torch.gather(docs_s, 1, pos)
    ids = torch.where((vals > 0) & (ids < n_docs), ids, -1)
    if kk < k:   # honor the (B, k) contract on tiny indexes
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=0.0)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return vals, ids.to(torch.int32)
