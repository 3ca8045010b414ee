"""Length-bucketed dense index — port of
``hybrid_rag_colbertv2_tpu/index/bucketed.py``.

Several padded sub-indexes, one id space. A flat index pads every
document to the longest bucket (256 tokens by default); most corpora are
dominated by shorter chunks, so bucketing by token count (e.g.
64/128/256) cuts the stored rows and the full scan's products.

Each bucket is a ``DenseTokenIndex`` over ITS docs plus a ``global_ids``
vector mapping bucket rows back to the global corpus-id space (-1 in
padding rows). Per-bucket scans go through each layout's CUDA kernel on
the card; rerank gathers each candidate from its home bucket
(``bucket_of``, ``row_of``). Every tensor lives on the index's device.

The on-disk format is the JAX package's byte for byte: ``bucket_i/``
directories in the flat format plus ``global_ids.npy``, ``mapping.npz``
and ``meta.json`` (``n_docs``, ``n_buckets``), so a directory saved by
either package loads in the other.
"""

from __future__ import annotations

import json
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.maxsim import NEG_INF, maxsim_scores_exact
from ..ops.quant import doc_row_scales, unpack_int4_pairs
from ..ops.topk import top_k
from ..utils.device import DeviceLike, resolve_device
from .dense import DenseTokenIndex


@dataclass
class BucketedDenseIndex:
    buckets: List[DenseTokenIndex]      # one per length bucket
    # per bucket: (n_pad_b,) int32 corpus ids, -1 in padding rows
    global_ids: List[torch.Tensor]
    bucket_of: torch.Tensor             # (N,) int32 bucket index per doc
    row_of: torch.Tensor                # (N,) int32 row within its bucket
    n_docs: int

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        token_embs: torch.Tensor,   # (N, L_in, D)
        lengths: torch.Tensor,      # (N,)
        *,
        bucket_sizes: Sequence[int] = (64, 128, 256),
        dtype: str = "int8",
        docs_pad_multiple: int = 128,
    ) -> "BucketedDenseIndex":
        """Each doc goes to the smallest bucket that holds it (docs longer
        than the largest bucket are truncated into it); empty buckets are
        dropped. On the device of ``token_embs``."""
        dev = token_embs.device
        n = int(lengths.shape[0])
        lengths_np = lengths.cpu().numpy()
        sizes = sorted(bucket_sizes)
        assign = np.full((n,), len(sizes) - 1, np.int32)
        for bi in reversed(range(len(sizes))):
            assign[lengths_np <= sizes[bi]] = bi

        buckets: List[DenseTokenIndex] = []
        gids: List[torch.Tensor] = []
        bucket_of = np.zeros((n,), np.int32)
        row_of = np.zeros((n,), np.int32)
        for bi, size in enumerate(sizes):
            rows = np.nonzero(assign == bi)[0]
            if rows.size == 0:
                continue
            sel = torch.as_tensor(rows, device=dev)
            sub = DenseTokenIndex.build(
                token_embs[sel], lengths.to(dev)[sel], doc_len=size,
                dtype=dtype, docs_pad_multiple=docs_pad_multiple)
            bucket_of[rows] = len(buckets)
            row_of[rows] = np.arange(rows.size, dtype=np.int32)
            buckets.append(sub)
            gid = np.full((sub.n_pad,), -1, np.int32)
            gid[: rows.size] = rows.astype(np.int32)
            gids.append(torch.as_tensor(gid, device=dev))
        return cls(buckets=buckets, global_ids=gids,
                   bucket_of=torch.as_tensor(bucket_of, device=dev),
                   row_of=torch.as_tensor(row_of, device=dev), n_docs=n)

    # ------------------------------------------------------------------
    def append(
        self,
        token_embs: torch.Tensor,   # (M, L_in, D) new docs' token embeddings
        lengths: torch.Tensor,      # (M,)
        *,
        bucket_sizes: Sequence[int] = (64, 128, 256),
        docs_pad_multiple: int = 128,
    ) -> "BucketedDenseIndex":
        """A new index with documents added. Each new doc routes to the
        smallest configured bucket that holds it: existing buckets append
        (``DenseTokenIndex.append``; their rows are reused untouched), a
        length with no existing bucket opens a NEW one at the end of the
        bucket list (consumers never assume a size order). Old docs keep
        their ids, new docs follow."""
        m = int(lengths.shape[0])
        if m == 0:
            return self
        dev = self.device
        token_embs = token_embs.to(dev)
        lengths = lengths.to(dev)
        lengths_np = lengths.cpu().numpy()
        sizes = sorted(bucket_sizes)
        assign_size = np.full((m,), sizes[-1], np.int64)
        for s in reversed(sizes):
            assign_size[lengths_np <= s] = s

        buckets = list(self.buckets)
        gids = [g.cpu().numpy() for g in self.global_ids]
        bucket_of = np.concatenate(
            [self.bucket_of.cpu().numpy(), np.zeros((m,), np.int32)])
        row_of = np.concatenate(
            [self.row_of.cpu().numpy(), np.zeros((m,), np.int32)])
        size_to_bucket = {b.doc_len: i for i, b in enumerate(buckets)}
        quant = buckets[0].quant
        for size in sorted(set(assign_size.tolist())):
            rows = np.nonzero(assign_size == size)[0]
            new_gids = (self.n_docs + rows).astype(np.int32)
            sel = torch.as_tensor(rows, device=dev)
            bi = size_to_bucket.get(size)
            if bi is None:
                sub = DenseTokenIndex.build(
                    token_embs[sel], lengths[sel], doc_len=size,
                    dtype=quant, docs_pad_multiple=docs_pad_multiple)
                bi = len(buckets)
                size_to_bucket[size] = bi
                buckets.append(sub)
                gid = np.full((sub.n_pad,), -1, np.int32)
                gid[: rows.size] = new_gids
                gids.append(gid)
                row_of[self.n_docs + rows] = np.arange(rows.size,
                                                       dtype=np.int32)
            else:
                old = buckets[bi]
                sub = old.append(token_embs[sel], lengths[sel],
                                 docs_pad_multiple=docs_pad_multiple)
                buckets[bi] = sub
                gid = np.full((sub.n_pad,), -1, np.int32)
                gid[: old.n_docs] = gids[bi][: old.n_docs]
                gid[old.n_docs: sub.n_docs] = new_gids
                gids[bi] = gid
                row_of[self.n_docs + rows] = old.n_docs + np.arange(
                    rows.size, dtype=np.int32)
            bucket_of[self.n_docs + rows] = bi
        return BucketedDenseIndex(
            buckets=buckets,
            global_ids=[torch.as_tensor(g, device=dev) for g in gids],
            bucket_of=torch.as_tensor(bucket_of, device=dev),
            row_of=torch.as_tensor(row_of, device=dev),
            n_docs=self.n_docs + m)

    # ------------------------------------------------------------------
    @property
    def max_doc_len(self) -> int:
        return max(b.doc_len for b in self.buckets)

    @property
    def is_int8(self) -> bool:
        return self.buckets[0].is_int8

    @property
    def quant(self) -> str:
        return self.buckets[0].quant

    @property
    def device(self) -> torch.device:
        return self.bucket_of.device

    def memory_bytes(self) -> int:
        return sum(b.memory_bytes() for b in self.buckets)

    # ------------------------------------------------------------------
    def search_scores(self, queries: torch.Tensor) -> torch.Tensor:
        """(B, Lq, D) -> (B, n_docs): per-bucket scans (each layout's
        kernel on the card) scattered into the global score matrix."""
        out = torch.full((queries.shape[0], self.n_docs), NEG_INF,
                         dtype=torch.float32, device=queries.device)
        for sub, gid in zip(self.buckets, self.global_ids):
            out[:, gid[: sub.n_docs].long()] = sub.search_scores(queries)
        return out

    def search_topk(self, queries: torch.Tensor, k: int, prefilter: int = 0,
                    approx_recall: float = 0.95
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, Lq, D) -> (scores (B, k), global ids (B, k)); ids < 0
        missing. Per-bucket top-k (pruned when ``prefilter`` > 0) merged
        by a global top-k over the concatenated per-bucket lists, so ties
        fall in bucket order, then rank within the bucket (``lax.top_k``
        over the same concatenation). Exact: each bucket contributes its
        best k, so the global best k lie in the union."""
        vals_all, ids_all = [], []
        for sub, gid in zip(self.buckets, self.global_ids):
            v, i = sub.search_topk(queries, min(k, sub.n_docs), prefilter,
                                   approx_recall)
            safe = torch.clamp(i, 0, gid.shape[0] - 1).long()
            ids_all.append(torch.where(i >= 0, gid[safe], -1))
            vals_all.append(torch.where(i >= 0, v, NEG_INF))
        v = torch.cat(vals_all, dim=1)
        g = torch.cat(ids_all, dim=1)
        tv, tp = top_k(v, min(k, v.shape[1]))
        ti = torch.gather(g, 1, tp)
        return tv, torch.where(tv > -1e29, ti, -1).to(torch.int32)

    # ------------------------------------------------------------------
    def gather_docs(self, ids: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (K,) global -> fp32 (K, L_max, D) + lengths (K,); ids < 0
        give zero-length docs."""
        k = ids.shape[0]
        l_max = self.max_doc_len
        d = self.buckets[0].dim
        dev = self.device
        safe_ids = torch.clamp(ids, 0, self.n_docs - 1).long()
        my_bucket = self.bucket_of[safe_ids]            # (K,)
        my_row = self.row_of[safe_ids]
        docs = torch.zeros((k, l_max, d), dtype=torch.float32, device=dev)
        lens = torch.zeros((k,), dtype=torch.int32, device=dev)
        for bi, sub in enumerate(self.buckets):
            rows = torch.clamp(my_row, 0, sub.n_pad - 1).long()
            rpd = sub.doc_len // 2 if sub.is_int4 else sub.doc_len
            g = sub.emb_flat.reshape(sub.n_pad, rpd, -1)[rows]  # (K, rpd, D)
            if sub.is_int4:                               # nibble-packed
                g = unpack_int4_pairs(g)                  # (K, L_b, D)
            g = g.to(torch.float32)
            if sub.is_int8:
                g = g * sub.scales.reshape(sub.n_pad, sub.doc_len)[rows][
                    ..., None]
            elif sub.doc_scales is not None:
                # int8-doc and int4-doc: copied padding rows are masked by
                # the lengths downstream
                g = g * doc_row_scales(sub.doc_scales, rows,
                                       sub.doc_len)[..., None]
            if sub.doc_len < l_max:
                g = torch.nn.functional.pad(g, (0, 0, 0, l_max - sub.doc_len))
            sel = (my_bucket == bi) & (ids >= 0)
            docs = torch.where(sel[:, None, None], g, docs)
            lens = torch.where(sel, sub.doc_lengths[rows], lens)
        return docs, lens

    def rerank_scores(self, queries: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
        """Exact fp32 MaxSim over gathered candidates:
        queries (B, Lq, D), ids (B, K) -> (B, K)."""
        q32 = queries.to(torch.float32)
        return torch.stack([
            maxsim_scores_exact(q[None], *self.gather_docs(cand))[0]
            for q, cand in zip(q32, ids)])

    # ------------------------------------------------------------------
    def convert(self, dtype: str, *, block: int = 4096
                ) -> "BucketedDenseIndex":
        """Requantize every length bucket into another layout without
        re-encoding (``DenseTokenIndex.convert`` per bucket); the routing
        tensors are layout-independent and shared."""
        return BucketedDenseIndex(
            buckets=[b.convert(dtype, block=block) for b in self.buckets],
            global_ids=self.global_ids, bucket_of=self.bucket_of,
            row_of=self.row_of, n_docs=self.n_docs)

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        for i, (sub, gid) in enumerate(zip(self.buckets, self.global_ids)):
            sub.save(path / f"bucket_{i}")
            np.save(path / f"bucket_{i}" / "global_ids.npy", gid.cpu().numpy())
        np.savez(path / "mapping.npz", bucket_of=self.bucket_of.cpu().numpy(),
                 row_of=self.row_of.cpu().numpy())
        (path / "meta.json").write_text(json.dumps({
            "n_docs": self.n_docs, "n_buckets": len(self.buckets)}))
        # clear the other layout's / a wider save's stale artifacts, so a
        # layout switch never leaves a misdetectable mixed directory
        (path / "dense.npz").unlink(missing_ok=True)
        for sub in path.glob("bucket_*"):
            if sub.is_dir() and not (
                    sub.name.removeprefix("bucket_").isdigit()
                    and int(sub.name.removeprefix("bucket_"))
                    < len(self.buckets)):
                shutil.rmtree(sub)

    @classmethod
    def load(cls, path: str | Path, device: DeviceLike = None
             ) -> "BucketedDenseIndex":
        """Load a bucketed index directory onto ``device`` (default the
        card)."""
        dev = resolve_device(device)
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "mapping.npz") as arrs:
            bucket_of, row_of = arrs["bucket_of"], arrs["row_of"]
        buckets, gids = [], []
        for i in range(meta["n_buckets"]):
            sub = DenseTokenIndex.load(path / f"bucket_{i}", device=dev)
            buckets.append(sub)
            gid = np.load(path / f"bucket_{i}" / "global_ids.npy")
            if gid.size < sub.n_pad:   # saves from before the padding
                gid = np.pad(gid, (0, sub.n_pad - gid.size),
                             constant_values=-1)
            gids.append(torch.as_tensor(gid, device=dev))
        return cls(buckets=buckets, global_ids=gids,
                   bucket_of=torch.as_tensor(bucket_of, device=dev),
                   row_of=torch.as_tensor(row_of, device=dev),
                   n_docs=meta["n_docs"])
