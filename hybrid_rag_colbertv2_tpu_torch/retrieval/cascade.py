"""The hybrid retrieval cascade — port of
``hybrid_rag_colbertv2_tpu/retrieval/cascade.py``.

Behavioral contract (reference ``HybridRetriever.retrieve``,
local_rag_complete.py:894-935):

    Stage 1  BM25 top-100            (ops/bm25.py)
    Stage 2  ColBERT top-100         (pruned route, or the full int8 scan
                                      through the CUDA kernel)
    Fusion   weighted RRF -> top-50  (ops/fusion.py)
    Stage 3  exact fp32 rerank over the gathered int8 rows -> top-10

Everything after tokenization stays on the device; the host packs query
token ids and BM25 term ids into one int32 array and moves it once. As
the JAX package jit-compiles encoder + cascade into one executable and
memoizes it (``fused_cascade_fn``, ``_FUSED_CACHE``), the port captures
them, once per (batch, term width), as a CUDA graph and replays it: one
dispatch per batch in place of some 400-700 eager launches. A graph reads
the encoder's parameters and the index tensors at fixed addresses, so
the cache keys on those tensors' identities as well as the JAX key, each
entry holds them, and a retriever that sees a new index evicts the
entries bound to the old one. On the CPU the same entries run eagerly.

A length-bucketed index (index/bucketed.py) is served the same way by
``bucketed_cascade`` / ``fused_bucketed_cascade_fn``: per bucket the
pruned top-k or the layout's kernel scan, the global-id merge, BM25, RRF
and a rerank that gathers each candidate from its home bucket, in one
graph.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RAGConfig, effective_final_fusion
from ..index.bucketed import BucketedDenseIndex
from ..index.dense import DenseTokenIndex
from ..index.manager import IndexManager
from ..ops.bm25 import bm25_topk_device
from ..ops.fusion import final_topk_select, rrf_from_topk, union_floor_split
from ..ops.maxsim import (NEG_INF, maxsim_scores, maxsim_scores_int4_doc,
                          maxsim_scores_int8, maxsim_scores_int8_doc)
from ..ops.prefilter import candidate_sims, maxsim_topk_pruned
from ..ops.quant import doc_row_scales
from ..ops.topk import top_k
from ..utils.cache import JitCache
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import StageTimer, get_logger
from ..utils.profiling import annotate

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


# per bucket, the operands ``bucketed_cascade`` reads (an empty tensor
# where a layout has none)
BUCKET_OPERANDS = ("emb_flat", "scales", "doc_lengths", "pooled",
                   "doc_scales", "global_ids")


def bucketed_cascade(
    q_emb: torch.Tensor,          # (B, Lq, D) query token embeddings
    q_terms: torch.Tensor,        # (B, Q) BM25 term ids, -1 padded
    indptr: torch.Tensor,
    post_docs: torch.Tensor,
    post_weights: torch.Tensor,
    bucket_of: torch.Tensor,      # (N,) home bucket of each doc
    row_of: torch.Tensor,         # (N,) row within its bucket
    flat: Sequence[torch.Tensor],  # BUCKET_OPERANDS for each bucket
    *,
    geoms: Sequence[Tuple[int, int, str]],   # (n_pad, doc_len, quant)
    n_docs: int,
    max_postings: int,
    k_each: int,
    k_dense: int,
    k_fuse: int,
    k_final: int,
    rrf_k: int,
    prefilter: int,
    approx_recall: float,         # accepted for parity; top-k is exact
    final_fusion: str,
    fusion_weight_bm25: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cascade over a length-bucketed index (JAX
    ``fused_bucketed_cascade_fn``): per-bucket dense top-k (pruned, or
    the layout's kernel scan) -> global ids (padding rows -1, -1e30) ->
    a merged top-k over the concatenated lists (ties in bucket order,
    then rank) -> BM25 -> RRF -> an exact fp32 rerank that reads each
    candidate from its home bucket, in the stored dtype, dequantized on
    the sims after the products -> ``final_topk_select``.
    -> (final_ids (B, k_final) int32, final scores)"""
    n_ops = len(BUCKET_OPERANDS)
    assert len(flat) == n_ops * len(geoms)
    kd = k_dense
    lv_all, gi_all = [], []
    for bi, (n_b, dl, quant) in enumerate(geoms):
        emb, sc, lens, pooled, dsc, gid = flat[n_ops * bi:n_ops * (bi + 1)]
        keb = min(kd, n_b)
        if prefilter > 0:
            lv, li = maxsim_topk_pruned(
                q_emb, emb, sc if quant == "int8" else None, lens, pooled,
                doc_scales=(dsc if quant in ("int8-doc", "int4-doc")
                            else None),
                doc_len=dl, n_docs=n_b, n_candidates=prefilter, k=keb,
                approx_recall=approx_recall)
        else:
            if quant == "int4-doc":
                ms = maxsim_scores_int4_doc(q_emb, emb, dsc, lens,
                                            doc_len=dl)
            elif quant == "int8-doc":
                ms = maxsim_scores_int8_doc(q_emb, emb, dsc, lens,
                                            doc_len=dl)
            elif quant == "int8":
                ms = maxsim_scores_int8(q_emb, emb, sc, lens, doc_len=dl)
            else:   # a float32 bucket is scanned in float32
                ms = maxsim_scores(q_emb, emb, lens, doc_len=dl)
            lv, li = top_k(ms, keb)
        safe = torch.clamp(li, 0, n_b - 1).long()
        g = torch.where(li >= 0, gid[safe], -1)        # padding rows: -1
        lv_all.append(torch.where(g >= 0, lv, NEG_INF))
        gi_all.append(g.to(torch.int32))
    lv = torch.cat(lv_all, dim=1)
    gi = torch.cat(gi_all, dim=1)
    ms_vals, pos = top_k(lv, min(kd, n_docs, lv.shape[1]))
    ms_ids = torch.gather(gi, 1, pos)
    ms_ids = torch.where(ms_vals > -1e29, ms_ids, -1)

    bm25_vals, bm25_ids = bm25_topk_device(
        q_terms, indptr, post_docs, post_weights,
        n_docs=n_docs, max_postings=max_postings, k=min(k_each, n_docs))

    w = fusion_weight_bm25
    fm = union_floor_split(k_final, w) if final_fusion == "union" else (0, 0)
    _, fused_ids = rrf_from_topk(
        bm25_ids, ms_ids, k=k_fuse, rrf_k=rrf_k,
        weights=(2.0 * w, 2.0 * (1.0 - w)), floor_m=fm)

    # routed rerank: each candidate's home bucket and row; per bucket the
    # fp32 sims of the gathered stored rows, the dequantization after the
    # products (sim(q, s*e) = s * (q . e)); non-live candidates keep 0
    # and final_topk_select masks them
    q32 = q_emb.to(torch.float32)
    live = fused_ids >= 0
    safe_c = torch.clamp(fused_ids, 0, n_docs - 1).long()
    cand_bucket = bucket_of[safe_c]
    cand_row = row_of[safe_c]
    rerank = torch.zeros(fused_ids.shape, dtype=torch.float32,
                         device=q_emb.device)
    for bi, (n_b, dl, quant) in enumerate(geoms):
        emb, sc, lens, _, dsc, _ = flat[n_ops * bi:n_ops * (bi + 1)]
        own = live & (cand_bucket == bi)
        rows = torch.clamp(cand_row, 0, n_b - 1).long()      # (B, kf)
        packed4 = quant == "int4-doc"
        docs = emb.reshape(n_b, dl // 2 if packed4 else dl, -1)[rows]
        sims = candidate_sims(q32, docs, packed_pairs=packed4)
        if quant == "int8":
            sims = sims * sc.reshape(n_b, dl)[rows][:, :, None, :]
        elif quant in ("int8-doc", "int4-doc"):
            sims = sims * doc_row_scales(dsc, rows, dl)[:, :, None, :]
        lb = torch.where(own, lens[rows], 0)
        tok = torch.arange(dl, device=emb.device)
        valid = tok < lb[..., None]                          # (B, kf, L)
        sims = torch.where(valid[:, :, None, :], sims, NEG_INF)
        rerank = torch.where(own, sims.amax(dim=-1).sum(dim=-1), rerank)

    final_ids, top_vals = final_topk_select(
        rerank, fused_ids, k_final, rrf_k=rrf_k, final_fusion=final_fusion,
        weight_cand=w, bm25_ids=bm25_ids, dense_ids=ms_ids)
    return final_ids.to(torch.int32), top_vals


# (model geometry, query_len, statics, binding) -> FusedCascade.
# Bounded LRU: serving processes probing many distinct k values get the
# hot ks cached and the rest evicted, and fresh retriever instances over
# one encoder and index share entries instead of capturing again.
_FUSED_CACHE = JitCache(max_entries=16)
# one capture at a time in the process: a capture must not see another
# thread's work on its stream's pool
_CAPTURE_LOCK = threading.Lock()


def _identity(t: Optional[torch.Tensor]):
    """A tensor's identity in a cache key: the object and the storage it
    points at (a graph reads the address). The entry holds the tensor, so
    neither can be reused while the key lives."""
    return None if t is None else (id(t), t.data_ptr())


class _Graph:
    """One captured (B, Lq+Q) shape of a ``FusedCascade``: static device
    input, pinned host buffers on both sides, static outputs."""

    def __init__(self, entry: "FusedCascade", packed: np.ndarray):
        dev = entry.device
        self.host_in = torch.empty(packed.shape, dtype=torch.int32,
                                   pin_memory=True)
        self.host_in.numpy()[...] = packed
        self.dev_in = self.host_in.to(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # eager warm-up: builds and loads the kernels, first-use
            # allocations, library handles and workspaces for this stream
            entry.forward(self.dev_in)
        self.graph = torch.cuda.CUDAGraph()
        # its own memory pool (the default); "thread_local": another
        # thread's unrelated CUDA calls do not invalidate the capture
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.ids, self.scores = entry.forward(self.dev_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.host_ids = torch.empty(self.ids.shape, dtype=self.ids.dtype,
                                    pin_memory=True)
        self.host_scores = torch.empty(self.scores.shape,
                                       dtype=self.scores.dtype,
                                       pin_memory=True)

    def run(self, packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Copy in, replay, copy out, on the current stream; the caller
        holds the entry's lock from the copy-in to the copy-out. Spans:
        ``fused.launch`` (the copy-in, the replay and the copies out
        enqueued), ``fused.sync``, ``fused.copy_out``."""
        with annotate("fused.launch"):
            self.host_in.numpy()[...] = packed
            self.dev_in.copy_(self.host_in, non_blocking=True)
            self.graph.replay()
            self.host_ids.copy_(self.ids, non_blocking=True)
            self.host_scores.copy_(self.scores, non_blocking=True)
        with annotate("fused.sync"):
            torch.cuda.current_stream(self.dev_in.device).synchronize()
        with annotate("fused.copy_out"):
            return (self.host_ids.numpy().copy(),
                    self.host_scores.numpy().copy())


class FusedCascade:
    """Encoder forward + ``hybrid_cascade`` over one binding: the callable
    ``packed (B, Lq+Q) int32 numpy -> (ids, scores) numpy`` of
    ``fused_cascade_fn``, split at ``query_len`` as the JAX package's
    fused executable is.

    On CUDA each (B, Q) it sees is captured once as a CUDA graph (the
    way ``jax.jit`` keeps one executable per shape) and replayed after;
    a capture or replay that fails raises. On the CPU it runs eagerly.
    It holds the model and every tensor the graphs read. Spans:
    ``fused.lock`` (waiting for the entry's lock), ``fused.capture``
    (``shape``), and ``_Graph.run``'s."""

    captures = 0        # graphs captured in this process, every entry

    def __init__(self, model, query_len: int, statics: Dict,
                 binding: Dict[str, Optional[torch.Tensor]]):
        self.model = model
        self.query_len = query_len
        self.statics = dict(statics)
        self.binding = dict(binding)
        # the parameters the graphs read, kept even if the model's own
        # attributes are later replaced
        self.params = tuple(model.parameters())
        self.device = binding["indptr"].device
        self._lock = threading.Lock()
        self._graphs: Dict[Tuple[int, ...], _Graph] = {}

    def reads_any(self, ids) -> bool:
        """Does this entry read a tensor whose ``id`` is in ``ids``?"""
        return any(id(t) in ids for t in self.binding.values()
                   if t is not None)

    def forward(self, packed: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device work on a (B, Lq+Q) int32 tensor: what a graph
        captures, and the eager path."""
        lq = self.query_len
        t = self.binding
        with torch.inference_mode():
            q_ids = packed[:, :lq].long()
            q_emb = self.model(q_ids, torch.ones_like(q_ids))
            ids, scores, _ = hybrid_cascade(
                q_emb, packed[:, lq:], t["indptr"], t["post_docs"],
                t["post_weights"], t["emb_flat"], t["scales"],
                t["doc_lengths"], t["pooled"], t["doc_scales"],
                **self.statics)
        return ids, scores

    def eager(self, packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ids, scores = self.forward(torch.as_tensor(packed,
                                                   device=self.device))
        return ids.cpu().numpy(), scores.cpu().numpy()

    def __call__(self, packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.device.type != "cuda":
            return self.eager(packed)
        packed = np.ascontiguousarray(packed, dtype=np.int32)
        with annotate("fused.lock"):
            self._lock.acquire()
        try:
            with torch.cuda.device(self.device):
                g = self._graphs.get(packed.shape)
                if g is None:
                    with annotate("fused.capture", shape=packed.shape), \
                            _CAPTURE_LOCK:
                        g = _Graph(self, packed)
                        FusedCascade.captures += 1
                    self._graphs[packed.shape] = g
                return g.run(packed)
        finally:
            self._lock.release()


def fused_cascade_fn(model, query_len: int, statics: Dict,
                     binding: Dict[str, Optional[torch.Tensor]]
                     ) -> FusedCascade:
    """Memoized encoder forward + hybrid_cascade in ONE dispatch per
    batch. ``statics`` are hybrid_cascade's static kwargs; ``binding``
    names the lexical CSR and dense index tensors it reads (None where a
    layout has none). The key is the JAX package's (model geometry,
    query length, statics) plus the identities of the model's parameters
    and of the bound tensors: equal-geometry encoders with other weights
    get entries of their own (JAX passes params as jit arguments)."""
    key = (model.cfg, query_len, tuple(sorted(statics.items())),
           tuple(_identity(p) for p in model.parameters()),
           tuple((name, _identity(t)) for name, t in binding.items()))
    return _FUSED_CACHE.get_or_build(
        key, lambda: FusedCascade(model, query_len, statics, binding))


class FusedBucketedCascade(FusedCascade):
    """``FusedCascade`` over a length-bucketed index: encoder forward +
    ``bucketed_cascade`` (the callable of JAX's
    ``fused_bucketed_cascade_fn``), captured and replayed the same way.
    ``binding`` names the lexical CSR, ``bucket_of``, ``row_of`` and each
    bucket's ``BUCKET_OPERANDS`` as ``b{i}.{name}``."""

    def __init__(self, model, query_len: int, bucket_geoms, statics: Dict,
                 binding: Dict[str, torch.Tensor]):
        super().__init__(model, query_len, statics, binding)
        self.geoms = tuple(bucket_geoms)
        self.flat = [binding[f"b{i}.{name}"] for i in range(len(self.geoms))
                     for name in BUCKET_OPERANDS]

    def forward(self, packed: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        lq = self.query_len
        t = self.binding
        with torch.inference_mode():
            q_ids = packed[:, :lq].long()
            q_emb = self.model(q_ids, torch.ones_like(q_ids))
            return bucketed_cascade(
                q_emb, packed[:, lq:], t["indptr"], t["post_docs"],
                t["post_weights"], t["bucket_of"], t["row_of"], self.flat,
                geoms=self.geoms, **self.statics)


def fused_bucketed_cascade_fn(model, query_len: int, bucket_geoms,
                              statics: Dict,
                              binding: Dict[str, torch.Tensor]
                              ) -> FusedBucketedCascade:
    """Memoized encoder forward + the whole bucketed cascade in ONE
    dispatch per batch. ``bucket_geoms``: (n_pad, doc_len, quant) per
    bucket. The key is JAX's (model geometry, query length, bucket
    geometries, statics, "bucketed") plus the identities of the model's
    parameters and of the bound tensors, as in ``fused_cascade_fn``."""
    key = (model.cfg, query_len, tuple(bucket_geoms),
           tuple(sorted(statics.items())),
           tuple(_identity(p) for p in model.parameters()),
           tuple((name, _identity(t)) for name, t in binding.items()),
           "bucketed")
    return _FUSED_CACHE.get_or_build(
        key, lambda: FusedBucketedCascade(model, query_len, bucket_geoms,
                                          statics, binding))


class HybridRetriever:
    """Host-side wrapper: tokenize -> encoder + cascade on the device
    (``fused_cascade_fn``: one CUDA graph replay per batch on the card)
    -> result dicts. The result dict schema is the reference's retrieve()
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
        self._bind_lock = threading.Lock()
        self._bound: Tuple = ()
        # every tensor the current binding's fused entries read
        self._reads: Tuple = ()
        self._lex_dev: Dict[str, torch.Tensor] = {}
        self._bind_index()

    def _index_objects(self) -> Tuple:
        """The manager's current lexical index, dense index and the
        dense tensors a fused entry reads."""
        lex, dense = self.indexes.lexical, self.indexes.dense
        if isinstance(dense, BucketedDenseIndex):
            return (lex, dense, dense.bucket_of, dense.row_of,
                    *(t for b, gid in zip(dense.buckets, dense.global_ids)
                      for t in (b.emb_flat, b.scales, b.doc_lengths,
                                b.pooled, b.doc_scales, gid)))
        return (lex, dense, dense.emb_flat, dense.scales, dense.doc_lengths,
                dense.pooled, dense.doc_scales)

    def _bind_index(self) -> None:
        """(Re)capture the current index: the lexical CSR on the device
        (moved once per lexical index by the manager), the prefilter
        vectors if this retriever's route reads them, and for a bucketed
        index each bucket's ``BUCKET_OPERANDS`` (JAX ``_bucketed_flat``:
        an empty tensor where a layout has no such tensor) and the bucket
        geometries.
        Entries of ``_FUSED_CACHE`` that read a tensor of the old binding
        which the new one dropped are evicted, so the old index's memory
        is freed once its other holders let go
        (IndexManager.add_documents replaces both indexes)."""
        dense = self.indexes.dense
        if dense.device != self.device:
            raise ValueError(f"dense index is on {dense.device}, the "
                             f"retriever on {self.device}")
        lex_dev = self.indexes.lexical_csr()
        if lex_dev["indptr"].device != self.device:
            raise ValueError(f"the lexical CSR is on "
                             f"{lex_dev['indptr'].device}, the retriever "
                             f"on {self.device}")
        prefilter = getattr(self.config, "dense_prefilter", 0)
        bucketed = isinstance(dense, BucketedDenseIndex)
        subs = dense.buckets if bucketed else [dense]
        if prefilter > 0:
            for b in subs:
                b.ensure_pooled()
        old = [t for t in self._reads if t is not None]
        self._lex_dev = lex_dev
        # b{i}.{name} -> the tensor the fused bucketed entry reads
        self._bucketed_ops: Dict[str, torch.Tensor] = {}
        if bucketed:
            empty = torch.empty((0,), dtype=torch.float32,
                                device=self.device)
            for i, (b, gid) in enumerate(zip(dense.buckets,
                                             dense.global_ids)):
                ops = (b.emb_flat, empty if b.scales is None else b.scales,
                       b.doc_lengths, b.pooled if prefilter > 0 else empty,
                       empty if b.doc_scales is None else b.doc_scales, gid)
                self._bucketed_ops.update(
                    (f"b{i}.{name}", t)
                    for name, t in zip(BUCKET_OPERANDS, ops))
            self._bucketed_geoms = tuple(
                (b.n_pad, b.doc_len, b.quant) for b in dense.buckets)
        # strong references: the ids compared in _check_binding stay
        # unique while bound
        self._bound = self._index_objects()
        self._bound_key = tuple(map(id, self._bound)) + (dense.n_docs,)
        self._reads = (*self._bound[2:], *self._bucketed_ops.values(),
                       *lex_dev.values())
        keep = {id(t) for t in self._reads if t is not None}
        stale = {id(t) for t in old} - keep
        if stale:
            n = _FUSED_CACHE.drop_where(lambda _k, e: e.reads_any(stale))
            log.info("rebound to a new index: %d fused entries evicted", n)

    def _check_binding(self) -> None:
        objs = self._index_objects()
        key = tuple(map(id, objs)) + (objs[1].n_docs,)
        if key != self._bound_key:
            log.info("index changed since binding — rebinding retriever")
            self._bind_index()

    def _statics(self, k_final: int) -> Dict:
        """The cascade's static kwargs; a bucketed index has no single
        ``doc_len`` / ``is_int8`` (its geometries key the entry)."""
        cfg = self.config
        lex, dense = self._bound[:2]
        flat = (dict(doc_len=dense.doc_len, is_int8=dense.is_int8)
                if isinstance(dense, DenseTokenIndex) else {})
        return dict(
            prefilter=getattr(cfg, "dense_prefilter", 0),
            n_docs=dense.n_docs,
            max_postings=lex.max_postings,
            **flat,
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
    def _build_fused(self, k_final: int) -> FusedCascade:
        """ONE dispatch per batch: query encoder forward + full cascade,
        the query token ids and BM25 term ids in one packed transfer.

        Entries are memoized MODULE-wide (``_FUSED_CACHE``): fresh
        retriever instances over the same encoder and index (eval and
        gate harnesses build many) reuse the captured graphs."""
        statics = self._statics(k_final)
        dense = self._bound[1]
        binding = dict(
            self._lex_dev, emb_flat=dense.emb_flat, scales=dense.scales,
            doc_lengths=dense.doc_lengths,
            pooled=dense.pooled if statics["prefilter"] > 0 else None,
            doc_scales=dense.doc_scales)
        return fused_cascade_fn(self.encoder.model,
                                self.encoder.cfg.query_max_tokens, statics,
                                binding)

    def _build_fused_bucketed(self, k_final: int) -> FusedBucketedCascade:
        """The bucketed counterpart of ``_build_fused``: encoder forward +
        per-bucket dense top-k + BM25 + fusion + routed rerank in ONE
        dispatch with ONE packed transfer."""
        dense = self._bound[1]
        binding = dict(self._lex_dev, bucket_of=dense.bucket_of,
                       row_of=dense.row_of, **self._bucketed_ops)
        return fused_bucketed_cascade_fn(
            self.encoder.model, self.encoder.cfg.query_max_tokens,
            self._bucketed_geoms, self._statics(k_final), binding)

    def _cascade_bucketed_composed(self, q_emb: torch.Tensor,
                                   q_terms: torch.Tensor, k_final: int
                                   ) -> Tuple[np.ndarray, np.ndarray]:
        """The cascade over a bucketed index composed from the index's own
        methods (``search_topk``, ``rerank_scores``) — several separate
        dispatches. Kept, as in JAX, as the equality oracle for the fused
        path; ``retrieve_batch`` uses the fused path."""
        cfg = self.config
        lex, dense = self._bound[:2]
        n = dense.n_docs
        with torch.inference_mode():
            _, bi = bm25_topk_device(
                q_terms, self._lex_dev["indptr"], self._lex_dev["post_docs"],
                self._lex_dev["post_weights"], n_docs=n,
                max_postings=lex.max_postings, k=min(cfg.bm25_top_k, n))
            mv, mi = dense.search_topk(
                q_emb, min(cfg.colbert_top_k, n),
                getattr(cfg, "dense_prefilter", 0),
                getattr(cfg, "approx_topk_recall", 0.95))
            mi = torch.where(mv > -1e29, mi, -1).to(torch.int32)
            w = getattr(cfg, "fusion_weight_bm25", 0.5)
            mode = effective_final_fusion(cfg)
            kfin = min(k_final, cfg.fusion_candidates, n)
            fm = union_floor_split(kfin, w) if mode == "union" else (0, 0)
            _, fused_ids = rrf_from_topk(
                bi, mi, k=min(cfg.fusion_candidates, n), rrf_k=cfg.rrf_k,
                weights=(2.0 * w, 2.0 * (1.0 - w)), floor_m=fm)
            rerank = dense.rerank_scores(q_emb, fused_ids)
            final_ids, tv = final_topk_select(
                rerank, fused_ids, min(kfin, rerank.shape[1]),
                rrf_k=cfg.rrf_k, final_fusion=mode, weight_cand=w,
                bm25_ids=bi, dense_ids=mi)
        return final_ids.cpu().numpy(), tv.cpu().numpy()

    def build_entry(self, k_final: int) -> FusedCascade:
        """The fused entry ``retrieve_batch`` replays for ``k_final``, by
        the bound index's layout."""
        if isinstance(self._bound[1], BucketedDenseIndex):
            return self._build_fused_bucketed(k_final)
        return self._build_fused(k_final)

    def retrieve_batch(
        self, queries: Sequence[str], top_k_final: Optional[int] = None,
        *, timings_out: Optional[Dict[str, float]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids (B, k), scores (B, k)) as numpy.

        ``timings_out``: optional caller-local dict the per-call stage
        split is accumulated into (safe under concurrent callers: a
        fused entry serializes its replays). Spans: ``retrieve.bind``
        (the binding's lock, its check, the entry), then the stages
        ``tokenize`` and ``encode+cascade``."""
        cfg = self.config
        k = top_k_final or cfg.final_top_k
        # one consistent binding per call
        with annotate("retrieve.bind"), self._bind_lock:
            self._check_binding()
            lex, dense = self._bound[:2]
            fused = self.build_entry(
                min(k, cfg.fusion_candidates, dense.n_docs))
        lt: Dict[str, float] = {} if timings_out is None else timings_out
        with self.timer.stage("tokenize", out=lt):
            packed = pack_query_batch(
                self.encoder, lex, queries,
                getattr(cfg, "query_max_terms", None),
                getattr(cfg, "query_term_buckets", None))
        with self.timer.stage("encode+cascade", out=lt):
            ids, scores = fused(packed)
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
