"""The hybrid retrieval cascade — port of
``hybrid_rag_colbertv2_tpu/retrieval/cascade.py`` (flat layout).

Behavioral contract (reference ``HybridRetriever.retrieve``,
local_rag_complete.py:894-935):

    Stage 1  BM25 top-100            (ops/bm25.py)
    Stage 2  ColBERT top-100         (pruned route, or the full int8 scan
                                      through the CUDA kernel)
    Fusion   weighted RRF -> top-50  (ops/fusion.py)
    Stage 3  exact fp32 rerank over the gathered int8 rows -> top-10

Everything after tokenization stays on the device; the host packs query
token ids and BM25 term ids into one int32 array and moves it once. The
JAX package jit-compiles encoder + cascade into one executable and
memoizes it; PyTorch runs eagerly, so there is no such cache here.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RAGConfig, effective_final_fusion
from ..index.dense import DenseTokenIndex
from ..index.manager import IndexManager
from ..ops.bm25 import bm25_topk_device
from ..ops.fusion import final_topk_select, rrf_from_topk, union_floor_split
from ..ops.maxsim import (maxsim_scores, maxsim_scores_int4_doc,
                          maxsim_scores_int8, maxsim_scores_int8_doc)
from ..ops.prefilter import candidate_sims, maxsim_topk_pruned
from ..ops.quant import doc_row_scales
from ..ops.topk import top_k
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import StageTimer, get_logger

log = get_logger(__name__)


def pack_query_batch(encoder, lexical, queries: Sequence[str],
                     query_max_terms: Optional[int] = None,
                     term_buckets: Optional[Sequence[int]] = None
                     ) -> np.ndarray:
    """Host tokenization: query token ids (B, Lq) ‖ BM25 term ids (B, Q)
    in ONE int32 numpy array, moved to the device once by the caller.
    The split is at ``encoder.cfg.query_max_tokens``. ``term_buckets``
    trims the term axis to the smallest covering bucket (-1 padding is
    inert, so scores are identical across widths)."""
    lq = encoder.cfg.query_max_tokens
    q_ids = np.stack([encoder.tokenizer.encode_query(q, lq)
                      for q in queries])
    q_terms = np.stack([lexical.encode_query(q, query_max_terms)
                        for q in queries])
    q_terms = _trim_terms(q_terms, term_buckets)
    return np.concatenate(
        [q_ids.astype(np.int32), q_terms.astype(np.int32)], axis=1)


def _trim_terms(q_terms: np.ndarray,
                term_buckets: Optional[Sequence[int]]) -> np.ndarray:
    """Trim the (B, Q) term-id array's -1 padding columns down to the
    smallest covering bucket width (see pack_query_batch)."""
    if not term_buckets or q_terms.size == 0:
        return q_terms
    # encode_query left-packs real ids: the max per-row count is the width
    need = int((q_terms >= 0).sum(axis=1).max())
    width = q_terms.shape[1]
    for b in sorted(term_buckets):
        if b >= need and b < width:
            width = b
            break
    return q_terms[:, :width]


def encode_query_terms(lexical, queries: Sequence[str],
                       query_max_terms: Optional[int] = None,
                       term_buckets: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
    """Batch BM25 term-id encoding with optional width bucketing."""
    q_terms = np.stack([lexical.encode_query(q, query_max_terms)
                        for q in queries])
    return _trim_terms(q_terms, term_buckets)


def hybrid_cascade(
    q_emb: torch.Tensor,          # (B, Lq, D) query token embeddings
    q_terms: torch.Tensor,        # (B, Q) BM25 term ids, -1 padded
    indptr: torch.Tensor,
    post_docs: torch.Tensor,
    post_weights: torch.Tensor,
    emb_flat: torch.Tensor,       # (N_pad * L, D), or (N_pad * L/2, D) packed
    scales: Optional[torch.Tensor],
    doc_lengths: torch.Tensor,    # (N_pad,)
    pooled: Optional[torch.Tensor] = None,     # (N_pad, D), if prefilter
    doc_scales: Optional[torch.Tensor] = None,  # (N_pad,) for "int8-doc";
                                                # (G, N_pad) for "int4-doc"
    *,
    n_docs: int,
    max_postings: int,
    doc_len: int,
    is_int8: bool,
    k_each: int = 100,            # BM25 candidate depth (bm25_top_k)
    k_dense: Optional[int] = None,  # dense depth (colbert_top_k)
    k_fuse: int = 50,
    k_final: int = 10,
    rrf_k: int = 60,
    prefilter: int = 0,           # > 0: pruned dense stage
    approx_recall: float = 0.95,  # accepted for parity; top-k is exact
    final_fusion: str = "rerank",
    fusion_weight_bm25: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (final_ids (B, k_final), final_scores, debug dict)."""
    n_pad = doc_lengths.shape[0]
    # nibble-packed int4-doc pair-rows: detected by the row count (their
    # width equals the raw layouts')
    packed4 = emb_flat.shape[0] * 2 == n_pad * doc_len

    # Stage 2: dense top-k — pruned two-stage search or full MaxSim scan
    ke = min(k_dense if k_dense is not None else k_each, n_docs)
    if prefilter > 0:
        ms_vals, ms_ids = maxsim_topk_pruned(
            q_emb, emb_flat, scales if is_int8 else None, doc_lengths,
            pooled, doc_scales=doc_scales, doc_len=doc_len, n_docs=n_docs,
            n_candidates=prefilter, k=ke, approx_recall=approx_recall)
    else:
        if doc_scales is not None and packed4:
            ms = maxsim_scores_int4_doc(q_emb, emb_flat, doc_scales,
                                        doc_lengths, doc_len=doc_len)
        elif doc_scales is not None:
            ms = maxsim_scores_int8_doc(q_emb, emb_flat, doc_scales,
                                        doc_lengths, doc_len=doc_len)
        elif is_int8:
            ms = maxsim_scores_int8(q_emb, emb_flat, scales, doc_lengths,
                                    doc_len=doc_len)
        else:       # a float32 index is scanned in float32 here
            ms = maxsim_scores(q_emb, emb_flat, doc_lengths, doc_len=doc_len)
        ms_vals, ms_ids = top_k(ms[:, :n_docs], ke)
        ms_ids = ms_ids.to(torch.int32)

    # Stage 1: BM25 top-k — sort-based, no (B, N) scatter; missing = -1
    bm25_vals, bm25_ids = bm25_topk_device(
        q_terms, indptr, post_docs, post_weights,
        n_docs=n_docs, max_postings=max_postings, k=min(k_each, n_docs))

    # Fusion: weighted RRF -> k_fuse candidates; union floors both legs
    w = fusion_weight_bm25
    kf = min(k_final, k_fuse, n_docs)
    fm = union_floor_split(kf, w) if final_fusion == "union" else (0, 0)
    fused_scores, fused_ids = rrf_from_topk(
        bm25_ids, ms_ids, k=min(k_fuse, n_docs), rrf_k=rrf_k,
        weights=(2.0 * w, 2.0 * (1.0 - w)), floor_m=fm)

    # Stage 3: exact fp32 rerank over the gathered stored rows (packed
    # int4 stays packed through the gather), dequantized on the (Lq, L)
    # sims after the matmul (sim(q, s*e) = s * (q . e)); the doc-scale
    # layouts' copied padding rows are masked by the lengths
    live = fused_ids >= 0
    safe = torch.where(live, fused_ids, n_pad - 1).long()   # (B, k_fuse)
    embs3 = emb_flat.reshape(n_pad, doc_len // 2 if packed4 else doc_len, -1)
    sims = candidate_sims(q_emb.to(torch.float32), embs3[safe],
                          packed_pairs=packed4)             # (B, k, Lq, L)
    if is_int8:
        sims = sims * scales.reshape(n_pad, doc_len)[safe][:, :, None, :]
    elif doc_scales is not None:
        sc = doc_row_scales(doc_scales, safe, doc_len)      # (B, k_fuse, L)
        sims = sims * sc[:, :, None, :]
    lens = torch.where(live, doc_lengths[safe], 0)
    tok = torch.arange(doc_len, device=emb_flat.device)
    valid = tok < lens[..., None]                           # (B, k_fuse, L)
    sims = torch.where(valid[:, :, None, :], sims, -1e30)
    rerank = sims.amax(dim=-1).sum(dim=-1)                  # (B, k_fuse)

    final_ids, top_vals = final_topk_select(
        rerank, fused_ids, kf, rrf_k=rrf_k, final_fusion=final_fusion,
        weight_cand=fusion_weight_bm25, bm25_ids=bm25_ids, dense_ids=ms_ids)
    debug = {
        "bm25_ids": bm25_ids, "bm25_vals": bm25_vals,
        "ms_ids": ms_ids, "ms_vals": ms_vals,
        "fused_ids": fused_ids, "fused_scores": fused_scores,
        "rerank": rerank,
    }
    return final_ids, top_vals, debug


class HybridRetriever:
    """Host-side wrapper: tokenize -> encoder + cascade on the device ->
    result dicts. The result dict schema is the reference's retrieve()
    output (local_rag_complete.py:1004-1013)."""

    def __init__(
        self,
        config: RAGConfig,
        indexes: IndexManager,
        encoder,
        chunk_store=None,          # optional: get_chunk(id) -> dict
        device: DeviceLike = None,
    ):
        self.config = config
        self.indexes = indexes
        self.encoder = encoder
        self.store = chunk_store
        self.device = resolve_device(device)
        self.timer = StageTimer()
        # per-call stage split of the most recent retrieve/retrieve_batch
        self.last_timings: Dict[str, float] = {}
        if indexes.lexical is None or indexes.dense is None:
            raise RuntimeError("indexes not built/loaded")
        self._bind_index()

    def _bind_index(self) -> None:
        """(Re)capture the current index: the lexical CSR moves to the
        device once per index build, and the dense index must be on the
        retriever's device."""
        lex = self.indexes.lexical
        dense = self.indexes.dense
        if not isinstance(dense, DenseTokenIndex):
            raise NotImplementedError(
                "the bucketed layout comes with the port of "
                "index/bucketed.py (ROADMAP.md)")
        if dense.device != self.device:
            raise ValueError(f"dense index is on {dense.device}, the "
                             f"retriever on {self.device}")
        self._lex_dev = dict(
            indptr=torch.as_tensor(lex.indptr, device=self.device),
            post_docs=torch.as_tensor(lex.post_docs, device=self.device),
            post_weights=torch.as_tensor(lex.post_weights,
                                         device=self.device),
        )
        self._bound_key = (id(lex.indptr), id(lex.post_docs), id(dense),
                           dense.n_docs)

    def _check_binding(self) -> None:
        lex = self.indexes.lexical
        dense = self.indexes.dense
        key = (id(lex.indptr), id(lex.post_docs), id(dense), dense.n_docs)
        if key != self._bound_key:
            log.info("index changed since binding — rebinding retriever")
            self._bind_index()

    def _statics(self, k_final: int) -> Dict:
        cfg = self.config
        dense = self.indexes.dense
        return dict(
            prefilter=getattr(cfg, "dense_prefilter", 0),
            n_docs=dense.n_docs,
            max_postings=self.indexes.lexical.max_postings,
            doc_len=dense.doc_len,
            is_int8=dense.is_int8,
            k_each=min(cfg.bm25_top_k, dense.n_docs),
            k_dense=min(cfg.colbert_top_k, dense.n_docs),
            k_fuse=min(cfg.fusion_candidates, dense.n_docs),
            k_final=min(k_final, cfg.fusion_candidates, dense.n_docs),
            rrf_k=cfg.rrf_k,
            approx_recall=getattr(cfg, "approx_topk_recall", 0.95),
            final_fusion=effective_final_fusion(cfg),
            fusion_weight_bm25=getattr(cfg, "fusion_weight_bm25", 0.5),
        )

    # ------------------------------------------------------------------
    def retrieve_batch(
        self, queries: Sequence[str], top_k_final: Optional[int] = None,
        *, timings_out: Optional[Dict[str, float]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids (B, k), scores (B, k)) as numpy.

        ``timings_out``: optional caller-local dict the per-call stage
        split is accumulated into (safe under concurrent callers)."""
        cfg = self.config
        k = top_k_final or cfg.final_top_k
        self._check_binding()
        lt: Dict[str, float] = {} if timings_out is None else timings_out
        lex = self.indexes.lexical
        dense = self.indexes.dense
        with self.timer.stage("tokenize", out=lt):
            packed = pack_query_batch(
                self.encoder, lex, queries,
                getattr(cfg, "query_max_terms", None),
                getattr(cfg, "query_term_buckets", None))
        statics = self._statics(min(k, cfg.fusion_candidates, dense.n_docs))
        lq = self.encoder.cfg.query_max_tokens
        with self.timer.stage("encode+cascade", out=lt):
            packed_dev = torch.as_tensor(packed, device=self.device)
            q_emb = self.encoder.encode_query_ids(packed_dev[:, :lq].long())
            with torch.inference_mode():
                ids, scores, _ = hybrid_cascade(
                    q_emb, packed_dev[:, lq:],
                    self._lex_dev["indptr"], self._lex_dev["post_docs"],
                    self._lex_dev["post_weights"],
                    dense.emb_flat, dense.scales, dense.doc_lengths,
                    dense.ensure_pooled() if statics["prefilter"] > 0
                    else None,
                    dense.doc_scales, **statics)
            ids = ids.cpu().numpy()
            scores = scores.cpu().numpy()
        self.last_timings = {n: round(v, 6) for n, v in lt.items()}
        return ids, scores

    def retrieve(self, query: str, top_k_final: Optional[int] = None
                 ) -> List[Dict]:
        """Single-query API with text fetch (reference retrieve())."""
        lt: Dict[str, float] = {}
        ids, scores = self.retrieve_batch([query], top_k_final,
                                          timings_out=lt)
        results: List[Dict] = []
        with self.timer.stage("fetch", out=lt):
            for rank, (cid, score) in enumerate(zip(ids[0], scores[0]), 1):
                if cid < 0:
                    continue
                row = dict(chunk_id=int(cid), score=float(score), rank=rank)
                if self.store is not None:
                    meta = self.store.get_chunk(int(cid))
                    if meta:
                        row.update(meta)
                elif self.indexes.corpus is not None:
                    row["text"] = self.indexes.corpus[int(cid)]
                results.append(row)
        self.last_timings = {n: round(v, 6) for n, v in lt.items()}
        log.debug("retrieve timings: %s", json.dumps(self.last_timings))
        return results
