"""Sharded hybrid cascade: the single-device cascade over a device mesh —
port of ``hybrid_rag_colbertv2_tpu/parallel/sharded.py``.

Algorithm (SURVEY.md section 5, 'Distributed communication backend'):

  1. queries + BM25 CSR on the lead device; dense index cut on the doc
     axis, one shard per data-axis device (parallel/mesh.py);
  2. each shard runs its layout's MaxSim scan (the CUDA kernel on the
     card) over its local docs and takes a *full-k* local top-k (k, not
     k/shards — exactness requires it);
  3. JAX's ``all_gather`` of (score, global-id) candidates becomes a copy
     of each shard's (B, k) pair to the lead device, concatenated in shard
     order -> global top-k (ties by ascending global id, as on one
     device: each local top-k breaks ties by ascending local id);
  4. BM25 + RRF fusion, once, on the lead device;
  5. rerank: each shard exact-rescores (``maxsim_scores_exact`` on the
     gathered, dequantized fp32 docs) the fused candidates IT OWNS, the
     others contribute 0; JAX's ``psum`` becomes a sum of the (B, k_fuse)
     partials on the lead device, in shard order; final top-k there.

One process drives every shard. Each shard's work is enqueued on its
device's current stream and no host sync (``.item()``, ``.cpu()``,
``nonzero``) happens inside a per-shard loop, so shards on distinct cards
overlap. The call runs eagerly, op by op (no CUDA graph yet).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RAGConfig, effective_final_fusion
from ..index.lexical import LexicalIndex
from ..ops.bm25 import bm25_topk_device
from ..ops.fusion import final_topk_select, rrf_from_topk, union_floor_split
from ..ops.maxsim import (NEG_INF, maxsim_scores, maxsim_scores_exact,
                          maxsim_scores_int4_doc, maxsim_scores_int8,
                          maxsim_scores_int8_doc)
from ..ops.prefilter import maxsim_topk_pruned
from ..ops.quant import doc_row_scales, unpack_int4_pairs
from ..ops.topk import top_k
from ..retrieval.cascade import encode_query_terms, pack_query_batch
from ..utils.cache import JitCache
from ..utils.logging import StageTimer, get_logger
from .mesh import Mesh, ShardedBucketedIndex, ShardedDenseIndex

log = get_logger(__name__)

# (kind, mesh, geometry, knobs) -> ShardedCascade. Bounded module-wide LRU:
# fresh retriever instances over the same sharded geometry (the eval and
# gate harnesses build several) reuse one entry, and per-k growth is
# bounded. An entry holds no weights and no index: the encoder's geometry
# is in the key, and the caller passes the model (as JAX passes params)
# and the index on each call, so an entry keeps neither alive.
_SHARDED_CACHE = JitCache(max_entries=16)


def make_sharded_cascade(mesh: Mesh, **kw) -> "ShardedCascade":
    """Memoizing constructor of ``ShardedCascade`` (JAX's key)."""
    key = ("flat", mesh, tuple(sorted(kw.items())))
    return _SHARDED_CACHE.get_or_build(key, lambda: ShardedCascade(mesh, **kw))


def make_sharded_bucketed_cascade(mesh: Mesh, *, bucket_geoms, **kw
                                  ) -> "ShardedBucketedCascade":
    """Memoizing constructor of ``ShardedBucketedCascade``."""
    geoms_key = tuple(tuple(sorted(g.items())) for g in bucket_geoms)
    key = ("bucketed", mesh, geoms_key, tuple(sorted(kw.items())))
    return _SHARDED_CACHE.get_or_build(
        key, lambda: ShardedBucketedCascade(mesh, bucket_geoms=bucket_geoms,
                                            **kw))


def _on(dev: torch.device):
    """Make ``dev`` current for the ops of one shard (CUDA), else nothing."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def merge_shard_topk(vals: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
                     k: int, lead: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``all_gather`` + ``top_k`` merge: each shard's (B, k_s)
    candidates copied to ``lead``, concatenated in shard order, the top
    ``k`` (stable: ties by position), ids set to -1 under NEG_INF / 2."""
    av = torch.cat([v.to(lead, non_blocking=True) for v in vals], dim=1)
    ai = torch.cat([i.to(lead, non_blocking=True) for i in ids], dim=1)
    v, pos = top_k(av, min(k, av.shape[1]))
    g = torch.gather(ai, 1, pos)
    return v, torch.where(v > NEG_INF / 2, g, -1)


def sum_partials(parts: Sequence[torch.Tensor], lead: torch.device
                 ) -> torch.Tensor:
    """JAX's ``psum``: the shards' partials added on ``lead`` in shard
    order (each candidate has one owner, the rest add 0: exact)."""
    total = parts[0].to(lead, non_blocking=True)
    for p in parts[1:]:
        total = total + p.to(lead, non_blocking=True)
    return total


def rerank_exact(q: torch.Tensor, docs: torch.Tensor, lens: torch.Tensor
                 ) -> torch.Tensor:
    """JAX's ``vmap(rerank_one)``: per query b, ``maxsim_scores_exact``
    of q (Lq, D) against its own candidates docs[b] (K, L, D) fp32 with
    lengths lens[b] (K,). -> (B, K)"""
    return torch.func.vmap(
        lambda qi, di, li: maxsim_scores_exact(qi[None], di, li)[0])(
            q, docs, lens)


def _scan(q, emb, scales, lens, doc_scales, *, doc_len: int, quant: str):
    """The layout's full scan of one shard (its CUDA kernel on the card).
    A float32 shard is scanned in float32, as the JAX sharded body does."""
    if quant == "int4-doc":
        return maxsim_scores_int4_doc(q, emb, doc_scales, lens,
                                      doc_len=doc_len)
    if quant == "int8-doc":
        return maxsim_scores_int8_doc(q, emb, doc_scales, lens,
                                      doc_len=doc_len)
    if quant == "int8":
        return maxsim_scores_int8(q, emb, scales, lens, doc_len=doc_len)
    return maxsim_scores(q, emb, lens, doc_len=doc_len)


def _gather_dequant(emb, scales, doc_scales, rows, *, n_local: int,
                    doc_len: int, quant: str) -> torch.Tensor:
    """Stored rows of docs ``rows`` (B, K) -> (B, K, L, D) fp32,
    dequantized before the products (JAX's sharded rerank)."""
    packed4 = quant == "int4-doc"
    embs3 = emb.reshape(n_local, doc_len // 2 if packed4 else doc_len, -1)
    docs = embs3[rows]
    if packed4:
        docs = unpack_int4_pairs(docs)
    docs = docs.to(torch.float32)
    if quant == "int8":
        docs = docs * scales.reshape(n_local, doc_len)[rows][..., None]
    elif quant in ("int8-doc", "int4-doc"):
        docs = docs * doc_row_scales(doc_scales, rows, doc_len)[..., None]
    return docs


class _CascadeBase:
    """What both sharded cascades share: the encoder head and the fusion."""

    def __init__(self, mesh: Mesh, *, n_docs: int, k_each: int,
                 k_dense: Optional[int], k_fuse: int, k_final: int,
                 rrf_k: int, prefilter: int, approx_recall: float,
                 final_fusion: str, fusion_weight_bm25: float, axis: str,
                 encoder_cfg, query_len: Optional[int]):
        self.mesh = mesh
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        self.n_shards = len(self.devices)
        self.lead = mesh.lead
        self.n_docs = n_docs
        self.k_each = k_each
        self.kd = k_dense if k_dense is not None else k_each
        self.kf = min(k_fuse, n_docs)
        self.kfin = min(k_final, self.kf)
        self.rrf_k = rrf_k
        self.prefilter = prefilter
        self.approx_recall = approx_recall
        self.final_fusion = final_fusion
        self.fw = fusion_weight_bm25
        self.encoder_cfg = encoder_cfg
        self.query_len = query_len

    def __call__(self, *args):
        """fn(q_emb, q_terms, *operands), or with an encoder geometry
        fn(model, packed, *operands): ``model`` an encoder of that
        geometry, ``packed`` (B, query_len + Q) int32 query token ids ‖
        BM25 term ids, moved to the lead device once; the encoder forward
        runs there once. -> (ids, scores) on the lead"""
        if self.encoder_cfg is None:
            return self.run(*args)
        model, packed, *rest = args
        packed = torch.as_tensor(packed, device=self.lead)
        lq = self.query_len
        with torch.inference_mode():
            q_ids = packed[:, :lq].long()
            q_emb = model(q_ids, torch.ones_like(q_ids))
        return self.run(q_emb, packed[:, lq:], *rest)

    def _fuse(self, bm_ids, ms_ids, rerank_fn):
        """RRF on the lead device, the rerank partials summed there, the
        final top-k."""
        fm = (union_floor_split(self.kfin, self.fw)
              if self.final_fusion == "union" else (0, 0))
        _, fused_ids = rrf_from_topk(
            bm_ids, ms_ids, k=self.kf, rrf_k=self.rrf_k,
            weights=(2.0 * self.fw, 2.0 * (1.0 - self.fw)), floor_m=fm)
        rerank = sum_partials(rerank_fn(fused_ids), self.lead)
        ids, scores = final_topk_select(
            rerank, fused_ids, self.kfin, rrf_k=self.rrf_k,
            final_fusion=self.final_fusion, weight_cand=self.fw,
            bm25_ids=bm_ids, dense_ids=ms_ids)
        return ids.to(torch.int32), scores


class ShardedCascade(_CascadeBase):
    """The sharded cascade of a flat index for a fixed geometry
    (JAX ``_make_sharded_cascade_impl``).

    ``run(q_emb, q_terms, lex, index)``: ``lex`` is the replicated CSR
    (indptr, post_docs, post_weights) on the lead device, or with
    ``bm25_sharded`` one such triple per shard from
    ``LexicalIndex.shard_postings`` on the shard's device (local ids,
    ``max_postings_local`` the postings cap), merged like the dense leg;
    ``index`` a ``ShardedDenseIndex``. ``prefilter`` > 0 runs the pruned
    two-stage search per shard; the merge, fusion and rerank are the
    same."""

    def __init__(self, mesh: Mesh, *, n_docs: int, n_pad: int, doc_len: int,
                 max_postings: int, is_int8: bool,
                 has_doc_scales: bool = False,
                 has_group_scales: bool = False, k_each: int = 100,
                 k_dense: Optional[int] = None, k_fuse: int = 50,
                 k_final: int = 10, rrf_k: int = 60, prefilter: int = 0,
                 approx_recall: float = 0.95, final_fusion: str = "rerank",
                 fusion_weight_bm25: float = 0.5, axis: str = "data",
                 encoder_cfg=None, query_len: Optional[int] = None,
                 bm25_sharded: bool = False, max_postings_local: int = 0):
        super().__init__(
            mesh, n_docs=n_docs, k_each=k_each, k_dense=k_dense,
            k_fuse=k_fuse, k_final=k_final, rrf_k=rrf_k, prefilter=prefilter,
            approx_recall=approx_recall, final_fusion=final_fusion,
            fusion_weight_bm25=fusion_weight_bm25, axis=axis,
            encoder_cfg=encoder_cfg, query_len=query_len)
        if n_pad % self.n_shards:
            raise ValueError(
                f"n_pad={n_pad} not divisible by {self.n_shards} shards")
        self.n_pad = n_pad
        self.n_local = n_pad // self.n_shards
        self.doc_len = doc_len
        self.max_postings = max_postings
        self.quant = ("int4-doc" if has_group_scales
                      else "int8-doc" if has_doc_scales
                      else "int8" if is_int8 else "float")
        # full DENSE k per shard (exactness), capped by the shard
        self.ke = min(self.kd, self.n_local)
        self.bm25_sharded = bm25_sharded
        self.max_postings_local = max_postings_local

    def dense_topk(self, q_emb: torch.Tensor, index: ShardedDenseIndex
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense leg: every shard's full-k local top-k, merged on the
        lead device. -> (values, global ids) (B, min(kd, n_docs, S*ke))"""
        if (index.n_pad, index.n_shards, index.doc_len) != (
                self.n_pad, self.n_shards, self.doc_len):
            raise ValueError("the index does not match the cascade's "
                             "geometry")
        with torch.inference_mode():
            lvs, gis = [], []
            for s, (dev, sh) in enumerate(zip(self.devices, index.shards)):
                with _on(dev):
                    lv, gi = self._local_dense(q_emb.to(dev), sh,
                                               s * self.n_local)
                lvs.append(lv)
                gis.append(gi)
            return merge_shard_topk(
                lvs, gis, min(self.kd, self.n_docs, self.n_shards * self.ke),
                self.lead)

    def run(self, q_emb: torch.Tensor, q_terms: torch.Tensor, lex,
            index: ShardedDenseIndex) -> Tuple[torch.Tensor, torch.Tensor]:
        n_local, n_docs, lead = self.n_local, self.n_docs, self.lead
        with torch.inference_mode():
            q_terms = torch.as_tensor(q_terms, device=lead)
            _, ms_ids = self.dense_topk(q_emb, index)

            if self.bm25_sharded:
                kb = min(self.k_each, n_local)
                bvs, gbs = [], []
                for s, (dev, (ip, pd, pw)) in enumerate(
                        zip(self.devices, lex)):
                    with _on(dev):
                        bv, bi = bm25_topk_device(
                            q_terms.to(dev), ip, pd, pw, n_docs=n_local,
                            max_postings=self.max_postings_local, k=kb)
                        gb = torch.where(bi >= 0, bi + s * n_local, -1)
                        bvs.append(torch.where((gb >= 0) & (gb < n_docs),
                                               bv, NEG_INF))
                        gbs.append(gb)
                _, bm_ids = merge_shard_topk(
                    bvs, gbs, min(self.k_each, n_docs, self.n_shards * kb),
                    lead)
            else:
                indptr, post_docs, post_weights = lex
                _, bm_ids = bm25_topk_device(
                    q_terms, indptr, post_docs, post_weights, n_docs=n_docs,
                    max_postings=self.max_postings,
                    k=min(self.k_each, n_docs))
            return self._fuse(bm_ids, ms_ids,
                              lambda fused: self._rerank(q_emb, fused, index))

    def _local_dense(self, q, sh, offset: int):
        """One shard's full-k dense top-k -> (values, global ids), the
        padding docs masked to NEG_INF (JAX ``sharded.py:143-175``)."""
        if self.prefilter > 0:
            lv, li = maxsim_topk_pruned(
                q, sh.emb_flat, sh.scales if self.quant == "int8" else None,
                sh.doc_lengths, sh.pooled,
                doc_scales=(sh.doc_scales if self.quant in
                            ("int8-doc", "int4-doc") else None),
                doc_len=self.doc_len, n_docs=self.n_local,
                n_candidates=self.prefilter, k=self.ke,
                approx_recall=self.approx_recall)
            gi = torch.where(li >= 0, li + offset, -1).to(torch.int32)
            lv = torch.where(li >= 0, lv, NEG_INF)
        else:
            ms = _scan(q, sh.emb_flat, sh.scales, sh.doc_lengths,
                       sh.doc_scales, doc_len=self.doc_len, quant=self.quant)
            lv, li = top_k(ms, self.ke)
            gi = (li + offset).to(torch.int32)
        lv = torch.where((gi >= 0) & (gi < self.n_docs), lv, NEG_INF)
        return lv, gi

    def _rerank(self, q_emb, fused_ids, index) -> List[torch.Tensor]:
        """Each shard's exact fp32 scores of the fused candidates it owns,
        0 elsewhere (JAX ``sharded.py:216-246``)."""
        n_local = self.n_local
        q32 = q_emb.to(torch.float32)
        parts = []
        for s, (dev, sh) in enumerate(zip(self.devices, index.shards)):
            with _on(dev):
                fid = fused_ids.to(dev, non_blocking=True)
                local = fid - s * n_local
                owned = (local >= 0) & (local < n_local) & (fid >= 0)
                rows = torch.clamp(local, 0, n_local - 1).long()
                docs = _gather_dequant(
                    sh.emb_flat, sh.scales, sh.doc_scales, rows,
                    n_local=n_local, doc_len=self.doc_len, quant=self.quant)
                lens = torch.where(owned, sh.doc_lengths[rows], 0)
                sc = rerank_exact(q32.to(dev, non_blocking=True), docs, lens)
                parts.append(torch.where(owned, sc, 0.0))
        return parts


class ShardedBucketedCascade(_CascadeBase):
    """Bucketed x sharded (JAX ``_make_sharded_bucketed_cascade_impl``):
    per shard, each bucket scans (or prunes) ITS local rows and
    contributes a full-k candidate list mapped to global ids through its
    local ``global_ids`` slice; the buckets merge locally, then the
    shards merge on the lead device -> BM25 + RRF -> the owned-candidate
    rerank, routed per bucket by ``bucket_of`` / ``row_of`` and padded
    to the longest bucket -> the partials summed.

    ``run(q_emb, q_terms, lex, index)``: ``lex`` the CSR on the lead
    device, ``index`` a ``ShardedBucketedIndex``."""

    def __init__(self, mesh: Mesh, *, n_docs: int, bucket_geoms,
                 max_postings: int, k_each: int = 100,
                 k_dense: Optional[int] = None, k_fuse: int = 50,
                 k_final: int = 10, rrf_k: int = 60, prefilter: int = 0,
                 approx_recall: float = 0.95, final_fusion: str = "rerank",
                 fusion_weight_bm25: float = 0.5, axis: str = "data",
                 encoder_cfg=None, query_len: Optional[int] = None):
        super().__init__(
            mesh, n_docs=n_docs, k_each=k_each, k_dense=k_dense,
            k_fuse=k_fuse, k_final=k_final, rrf_k=rrf_k, prefilter=prefilter,
            approx_recall=approx_recall, final_fusion=final_fusion,
            fusion_weight_bm25=fusion_weight_bm25, axis=axis,
            encoder_cfg=encoder_cfg, query_len=query_len)
        for g in bucket_geoms:
            if g["n_pad"] % self.n_shards:
                raise ValueError(f"bucket {g} not divisible by "
                                 f"{self.n_shards} shards")
        self.geoms = [dict(g) for g in bucket_geoms]
        self.l_max = max(g["doc_len"] for g in bucket_geoms)
        self.max_postings = max_postings

    def dense_topk(self, q_emb: torch.Tensor, index: ShardedBucketedIndex
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense leg: per shard every bucket's full-k top-k merged
        locally, then the shards merged on the lead device. -> (values,
        global ids)"""
        if [(b.n_pad, b.doc_len, b.quant) for b in index.buckets] != [
                (g["n_pad"], g["doc_len"], g["quant"]) for g in self.geoms]:
            raise ValueError("the index does not match the cascade's "
                             "bucket geometries")
        kd = self.kd
        with torch.inference_mode():
            lvs, gis = [], []
            for s, dev in enumerate(self.devices):
                with _on(dev):
                    q = q_emb.to(dev)
                    lv_all, gi_all = [], []
                    for bi, geom in enumerate(self.geoms):
                        sh = index.buckets[bi].shards[s]
                        gid = index.global_ids[bi][s]
                        lv, g = self._local_bucket(q, sh, gid, geom)
                        lv_all.append(lv)
                        gi_all.append(g)
                    lv = torch.cat(lv_all, dim=1)
                    gi = torch.cat(gi_all, dim=1)
                    # local merged top-k across the buckets
                    lv, pos = top_k(lv, min(kd, lv.shape[1]))
                    lvs.append(lv)
                    gis.append(torch.gather(gi, 1, pos))
            width = sum(x.shape[1] for x in lvs)
            return merge_shard_topk(lvs, gis, min(kd, self.n_docs, width),
                                    self.lead)

    def run(self, q_emb: torch.Tensor, q_terms: torch.Tensor, lex,
            index: ShardedBucketedIndex) -> Tuple[torch.Tensor, torch.Tensor]:
        n_docs, lead = self.n_docs, self.lead
        with torch.inference_mode():
            q_terms = torch.as_tensor(q_terms, device=lead)
            _, ms_ids = self.dense_topk(q_emb, index)
            indptr, post_docs, post_weights = lex
            _, bm_ids = bm25_topk_device(
                q_terms, indptr, post_docs, post_weights, n_docs=n_docs,
                max_postings=self.max_postings, k=min(self.k_each, n_docs))
            return self._fuse(bm_ids, ms_ids,
                              lambda fused: self._rerank(q_emb, fused, index))

    def _local_bucket(self, q, sh, gid, geom):
        """One bucket's full-k top-k on one shard -> (values, global ids)
        (JAX ``sharded.py:327-363``)."""
        n_local = geom["n_pad"] // self.n_shards
        dl, quant = geom["doc_len"], geom["quant"]
        keb = min(self.kd, n_local)
        if self.prefilter > 0:
            lv, li = maxsim_topk_pruned(
                q, sh.emb_flat, sh.scales if quant == "int8" else None,
                sh.doc_lengths, sh.pooled,
                doc_scales=(sh.doc_scales if quant in ("int8-doc",
                                                       "int4-doc") else None),
                doc_len=dl, n_docs=n_local, n_candidates=self.prefilter,
                k=keb, approx_recall=self.approx_recall)
        else:
            ms = _scan(q, sh.emb_flat, sh.scales, sh.doc_lengths,
                       sh.doc_scales, doc_len=dl, quant=quant)
            lv, li = top_k(ms, keb)
        safe = torch.clamp(li, 0, n_local - 1).long()
        g = torch.where(li >= 0, gid[safe], -1)        # local gid slice
        return torch.where(g >= 0, lv, NEG_INF), g.to(torch.int32)

    def _rerank(self, q_emb, fused_ids, index) -> List[torch.Tensor]:
        """Each shard's exact fp32 scores of the candidates it owns, each
        gathered from its home bucket and padded to the longest bucket
        (JAX ``sharded.py:390-436``)."""
        q32 = q_emb.to(torch.float32)
        safe_c = torch.clamp(fused_ids, 0, self.n_docs - 1).long()
        cand_bucket = index.bucket_of[safe_c]          # (B, kf)
        cand_row = index.row_of[safe_c]
        live = fused_ids >= 0
        parts = []
        for s, dev in enumerate(self.devices):
            with _on(dev):
                cb = cand_bucket.to(dev, non_blocking=True)
                cr = cand_row.to(dev, non_blocking=True)
                lv = live.to(dev, non_blocking=True)
                docs = lens_out = owned_any = None
                for bi, geom in enumerate(self.geoms):
                    sh = index.buckets[bi].shards[s]
                    n_local = geom["n_pad"] // self.n_shards
                    dl = geom["doc_len"]
                    local_row = cr - s * n_local
                    own = (lv & (cb == bi) & (local_row >= 0)
                           & (local_row < n_local))
                    rows = torch.clamp(local_row, 0, n_local - 1).long()
                    g = _gather_dequant(sh.emb_flat, sh.scales,
                                        sh.doc_scales, rows, n_local=n_local,
                                        doc_len=dl, quant=geom["quant"])
                    if dl < self.l_max:
                        g = torch.nn.functional.pad(
                            g, (0, 0, 0, self.l_max - dl))
                    ln = sh.doc_lengths[rows]
                    if docs is None:
                        docs = torch.where(own[..., None, None], g, 0.0)
                        lens_out = torch.where(own, ln, 0)
                        owned_any = own
                    else:
                        docs = torch.where(own[..., None, None], g, docs)
                        lens_out = torch.where(own, ln, lens_out)
                        owned_any = owned_any | own
                sc = rerank_exact(q32.to(dev, non_blocking=True), docs,
                                  torch.where(owned_any, lens_out, 0))
                parts.append(torch.where(owned_any, sc, 0.0))
        return parts


class _RetrieverBase:
    """Tokenize -> the sharded cascade -> numpy, with the per-call stage
    split of the most recent call in ``last_timings`` (``tokenize``,
    ``cascade``). Subclasses give ``_fn_for(k_final)`` and
    ``_operands()``, the cascade's arguments after the queries."""

    def _setup(self, config, mesh, lexical, encoder, chunk_store):
        self.config = config
        self.mesh = mesh
        self.lexical = lexical
        self.encoder = encoder
        self.store = chunk_store
        self.timer = StageTimer()
        self.last_timings = {}
        # encoder forward on the lead device in the same call when a real
        # encoder is bound; stubs without .model encode separately
        self._model = getattr(encoder, "model", None)
        self._lq = (encoder.cfg.query_max_tokens
                    if self._model is not None else None)
        # k_final -> cascade, bounded LRU (a caller may ask for more than
        # config.final_top_k)
        self._fns = JitCache(max_entries=8)

    def _statics(self, kfin: int, n: int) -> dict:
        cfg = self.config
        return dict(
            n_docs=n, max_postings=self.lexical.max_postings,
            k_each=min(cfg.bm25_top_k, n), k_dense=min(cfg.colbert_top_k, n),
            k_fuse=min(cfg.fusion_candidates, n), k_final=kfin,
            rrf_k=cfg.rrf_k, prefilter=getattr(cfg, "dense_prefilter", 0),
            approx_recall=getattr(cfg, "approx_topk_recall", 0.95),
            final_fusion=effective_final_fusion(cfg),
            fusion_weight_bm25=getattr(cfg, "fusion_weight_bm25", 0.5),
            encoder_cfg=(self._model.cfg if self._model is not None
                         else None),
            query_len=self._lq)

    def _ensure_pooled(self, subs) -> None:
        """Pruned route: each shard's prefilter vectors, computed from its
        own embeddings when the index has none (zeros would silently
        collapse the pruned search's recall)."""
        if getattr(self.config, "dense_prefilter", 0) > 0:
            for sub in subs:
                for sh in sub.shards:
                    sh.ensure_pooled()

    def retrieve_batch(self, queries: Sequence[str],
                       top_k_final: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids (B, k), scores (B, k)) as numpy."""
        k = top_k_final or self.config.final_top_k
        fn = self._fn_for(min(k, self.config.fusion_candidates, self._n))
        lt = {}  # per-call split; see retrieval/cascade.py retrieve_batch
        with self.timer.stage("tokenize", out=lt):
            cfg_t = getattr(self.config, "query_max_terms", None)
            cfg_b = getattr(self.config, "query_term_buckets", None)
            if self._model is not None:
                head = (self._model,
                        pack_query_batch(self.encoder, self.lexical, queries,
                                         cfg_t, cfg_b))
            else:
                head = (self.encoder.encode_queries(list(queries)),
                        encode_query_terms(self.lexical, queries, cfg_t,
                                           cfg_b))
        with self.timer.stage("cascade", out=lt):
            ids, scores = fn(*head, *self._operands())
            ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        self.last_timings = {n: round(v, 6) for n, v in lt.items()}
        return ids[:, :k], scores[:, :k]

    def retrieve_embedded(self, q_emb: torch.Tensor, q_terms,
                          top_k_final: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """The cascade from query token embeddings (B, Lq, D) and BM25
        term ids (B, Q), skipping tokenization and the encoder (the
        cascade's stub-encoder form in JAX). -> numpy (ids, scores)"""
        k = top_k_final or self.config.final_top_k
        fn = self._fn_for(min(k, self.config.fusion_candidates, self._n))
        ids, scores = fn.run(torch.as_tensor(q_emb).to(fn.lead), q_terms,
                             *self._operands())
        return ids.cpu().numpy()[:, :k], scores.cpu().numpy()[:, :k]


class ShardedRetriever(_RetrieverBase):
    """Multi-device counterpart of retrieval.cascade.HybridRetriever over
    a flat index cut by ``parallel.mesh.shard_dense_index``."""

    def __init__(self, config: RAGConfig, mesh: Mesh, lexical: LexicalIndex,
                 dense: ShardedDenseIndex, encoder, chunk_store=None):
        self._setup(config, mesh, lexical, encoder, chunk_store)
        self.dense = dense
        self._n = dense.n_docs
        lead = mesh.lead
        self._bm25_sharded = bool(getattr(config.mesh, "shard_bm25", False))
        self._max_postings_local = 0
        if self._bm25_sharded:
            # doc-axis sharded CSR, the dense index's ownership layout
            # (see LexicalIndex.shard_postings)
            ip, pd, pw, mpl = lexical.shard_postings(dense.n_shards,
                                                     dense.n_pad)
            self._lex_dev = [
                tuple(torch.as_tensor(a[s], device=dev) for a in (ip, pd, pw))
                for s, dev in enumerate(dense.devices)]
            self._max_postings_local = mpl
        else:
            self._lex_dev = tuple(
                torch.as_tensor(getattr(lexical, name), device=lead)
                for name in ("indptr", "post_docs", "post_weights"))
        self._fn_for(min(config.final_top_k, config.fusion_candidates,
                         dense.n_docs))

    def _fn_for(self, kfin: int) -> ShardedCascade:
        dense = self.dense
        return self._fns.get_or_build(kfin, lambda: make_sharded_cascade(
            self.mesh, n_pad=dense.n_pad, doc_len=dense.doc_len,
            is_int8=dense.is_int8, has_doc_scales=dense.has_doc_scales,
            has_group_scales=dense.has_group_scales,
            bm25_sharded=self._bm25_sharded,
            max_postings_local=self._max_postings_local,
            **self._statics(kfin, dense.n_docs)))

    def _operands(self) -> tuple:
        self._ensure_pooled([self.dense])
        return self._lex_dev, self.dense


class ShardedBucketedRetriever(_RetrieverBase):
    """Bucketed index counterpart of ShardedRetriever, over an index cut
    by ``parallel.mesh.shard_bucketed_index``."""

    def __init__(self, config: RAGConfig, mesh: Mesh, lexical: LexicalIndex,
                 bucketed: ShardedBucketedIndex, encoder, chunk_store=None):
        assert isinstance(bucketed, ShardedBucketedIndex)
        self._setup(config, mesh, lexical, encoder, chunk_store)
        self.bucketed = bucketed
        self._n = bucketed.n_docs
        self._geoms = [dict(n_pad=b.n_pad, doc_len=b.doc_len, quant=b.quant)
                       for b in bucketed.buckets]
        self._lex_dev = tuple(
            torch.as_tensor(getattr(lexical, name), device=mesh.lead)
            for name in ("indptr", "post_docs", "post_weights"))
        self._fn_for(min(config.final_top_k, config.fusion_candidates,
                         bucketed.n_docs))

    def _fn_for(self, kfin: int) -> ShardedBucketedCascade:
        return self._fns.get_or_build(
            kfin, lambda: make_sharded_bucketed_cascade(
                self.mesh, bucket_geoms=self._geoms,
                **self._statics(kfin, self._n)))

    def _operands(self) -> tuple:
        self._ensure_pooled(self.bucketed.buckets)
        return self._lex_dev, self.bucketed
