"""Dense ColBERT token-embedding index — port of
``hybrid_rag_colbertv2_tpu/index/dense.py`` (flat layout).

Every document's token embeddings, padded to a static ``doc_len`` and
stored token-major on the device, in one of five layouts (ops/quant.py):
``float32`` / ``bfloat16`` raw rows; ``int8`` rows with per-token-row fp32
scales; ``int8-doc`` rows with one scale per document; ``int4-doc``
nibble-packed pair-rows ``(N_pad * doc_len / 2, D)`` with per-token-group
scales. Each layout's full scan is a CUDA kernel on the card
(ops/maxsim.py).

The on-disk format is the JAX package's byte for byte (``dense.npz`` +
``meta.json``; bf16 persists as uint16 bits, the pooled vectors as fp16),
so an index saved by either package loads in the other.
"""

from __future__ import annotations

import json
import math
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.maxsim import (maxsim_scores, maxsim_scores_exact,
                          maxsim_scores_int4_doc, maxsim_scores_int8,
                          maxsim_scores_int8_doc)
from ..ops.prefilter import maxsim_topk_pruned, pooled_doc_embeddings
from ..ops.quant import (doc_row_scales, int4_group_size,
                         quantize_int4_groups, quantize_int8_docs,
                         quantize_int8_rows, unpack_int4_pairs)
from ..ops.topk import top_k
from ..utils.device import DeviceLike, resolve_device

_NP_NAMES = {torch.int8: "int8", torch.bfloat16: "bfloat16",
             torch.float32: "float32"}
_FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_bucket(max_len: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket covering max_len (largest bucket if none)."""
    for b in sorted(buckets):
        if max_len <= b:
            return b
    return max(buckets)


@dataclass
class DenseTokenIndex:
    """Padded token-embedding index over one global doc-id space."""

    emb_flat: torch.Tensor          # (N_pad * L, D) bf16/f32 or int8
    doc_lengths: torch.Tensor       # (N_pad,) int32 (0 for padding docs)
    n_docs: int
    doc_len: int                    # L — static padded token count
    dim: int
    scales: Optional[torch.Tensor] = None      # (N_pad * L,) f32 when int8
    pooled: Optional[torch.Tensor] = None      # (N_pad, D) bf16 prefilter
    # (N_pad,) f32 per-document scales of "int8-doc" (padding rows copy
    # the doc's row 0); (G, N_pad) f32 per-token-group scales of
    # "int4-doc", doc axis minor (ops/quant.py::quantize_int4_groups)
    doc_scales: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        token_embs: torch.Tensor,   # (N, L_in, D) padded doc token embeddings
        lengths: torch.Tensor,      # (N,) true token counts
        *,
        doc_len: int,
        dtype: str = "bfloat16",
        docs_pad_multiple: int = 128,
    ) -> "DenseTokenIndex":
        """Lay encoder output into the padded index of layout ``dtype``
        ("float32", "bfloat16", "int8", "int8-doc" or "int4-doc"), on
        the device of ``token_embs``."""
        n, l_in, d = token_embs.shape
        dev = token_embs.device
        lengths = torch.clamp(lengths.to(device=dev, dtype=torch.int32),
                              max=doc_len)
        if l_in < doc_len:
            token_embs = torch.nn.functional.pad(
                token_embs, (0, 0, 0, doc_len - l_in))
        elif l_in > doc_len:
            token_embs = token_embs[:, :doc_len, :]
        # zero out padding token rows so quantization scales are 0 there
        tok = torch.arange(doc_len, device=dev)
        mask = (tok[None, :] < lengths[:, None]).to(token_embs.dtype)
        token_embs = token_embs * mask[:, :, None]
        n_pad = _round_up(max(n, 1), docs_pad_multiple)
        if n_pad > n:
            token_embs = torch.nn.functional.pad(
                token_embs, (0, 0, 0, 0, 0, n_pad - n))
            lengths = torch.nn.functional.pad(lengths, (0, n_pad - n))
        scales = doc_scales = None
        if dtype == "int8":
            flat, scales = quantize_int8_rows(
                token_embs.reshape(n_pad * doc_len, d))
        elif dtype == "int8-doc":
            flat, doc_scales = quantize_int8_docs(token_embs, lengths)
        elif dtype == "int4-doc":
            flat, doc_scales = quantize_int4_groups(token_embs, lengths)
        elif dtype in ("float32", "bfloat16"):
            flat = token_embs.reshape(n_pad * doc_len, d).to(
                getattr(torch, dtype))
        else:
            raise ValueError(f"unknown index dtype {dtype!r}")
        pooled = pooled_doc_embeddings(flat, scales, lengths, doc_len=doc_len,
                                       doc_scales=doc_scales,
                                       packed_int4=dtype == "int4-doc")
        return cls(emb_flat=flat.contiguous(), doc_lengths=lengths,
                   n_docs=n, doc_len=doc_len, dim=d, scales=scales,
                   pooled=pooled, doc_scales=doc_scales)

    # ------------------------------------------------------------------
    @property
    def is_int8(self) -> bool:
        return self.scales is not None

    @property
    def is_int4(self) -> bool:
        return (self.doc_scales is not None
                and self.emb_flat.shape[0] * 2 == self.n_pad * self.doc_len)

    @property
    def quant(self) -> str:
        """"int8", "int8-doc", "int4-doc", or the float dtype name."""
        if self.scales is not None:
            return "int8"
        if self.doc_scales is not None:
            return "int4-doc" if self.is_int4 else "int8-doc"
        return _NP_NAMES[self.emb_flat.dtype]

    @property
    def n_pad(self) -> int:
        return self.doc_lengths.shape[0]

    @property
    def device(self) -> torch.device:
        return self.emb_flat.device

    def memory_bytes(self) -> int:
        total = self.emb_flat.numel() * self.emb_flat.element_size()
        total += self.doc_lengths.numel() * 4
        for t in (self.scales, self.doc_scales, self.pooled):
            if t is not None:
                total += t.numel() * t.element_size()
        return total

    def append(self, token_embs: torch.Tensor, lengths: torch.Tensor,
               *, docs_pad_multiple: int = 128) -> "DenseTokenIndex":
        """A new index with documents added after row ``n_docs``: the new
        docs are laid out in the SAME doc_len and layout, the existing
        rows, scales and proxies are reused untouched, and the padding
        goes to ``docs_pad_multiple``. Old docs keep their ids, new docs
        follow (global ids stay corpus row order)."""
        new = DenseTokenIndex.build(
            token_embs.to(self.device), lengths, doc_len=self.doc_len,
            dtype=self.quant, docs_pad_multiple=docs_pad_multiple)
        n1, n2 = self.n_docs, new.n_docs
        ld = self.doc_len
        rpd = ld // 2 if self.is_int4 else ld    # storage rows per doc
        n_pad = _round_up(max(n1 + n2, 1), docs_pad_multiple)
        pad = n_pad - (n1 + n2)

        def cat(a, b, rows, dim=0):
            """a[:n1 * rows] ‖ b[:n2 * rows] ‖ zero padding, on ``dim``."""
            parts = [a.narrow(dim, 0, n1 * rows), b.narrow(dim, 0, n2 * rows)]
            shape = list(a.shape)
            shape[dim] = pad * rows
            parts.append(a.new_zeros(shape))
            return torch.cat(parts, dim=dim)

        scales = doc_scales = None
        if self.scales is not None:
            scales = cat(self.scales, new.scales, ld)
        if self.doc_scales is not None:      # int4 (G, N) on the doc axis
            doc_scales = cat(self.doc_scales, new.doc_scales, 1,
                             dim=self.doc_scales.dim() - 1)
        return DenseTokenIndex(
            emb_flat=cat(self.emb_flat, new.emb_flat, rpd),
            doc_lengths=cat(self.doc_lengths, new.doc_lengths, 1),
            n_docs=n1 + n2, doc_len=ld, dim=self.dim, scales=scales,
            pooled=cat(self.ensure_pooled(), new.pooled, 1),
            doc_scales=doc_scales)

    def convert(self, dtype: str, *, block: int = 4096
                ) -> "DenseTokenIndex":
        """Requantize into layout ``dtype`` WITHOUT re-encoding the
        corpus: block by block (``math.gcd(n_pad, block)`` docs each, the
        JAX package's ``lax.map`` blocks), dequantize, zero the rows past
        each length (the doc-scale layouts' copied padding rows), quantize
        with ops/quant.py, then recompute the proxies. The fp32 working
        set stays one block. Lossy layouts compose: int8 -> int4-doc is
        quantize_int4(dequantize_int8(x)), not quantize_int4(original)."""
        if dtype == self.quant:
            return self
        if dtype not in ("int8", "int8-doc", "int4-doc", *_FLOATS):
            raise ValueError(f"unknown index dtype {dtype!r}")
        n_pad, ld, d = self.n_pad, self.doc_len, self.dim
        dev = self.device
        rpd = ld // 2 if self.is_int4 else ld
        blk = math.gcd(n_pad, max(1, block))
        embs = self.emb_flat.reshape(n_pad, rpd, d)
        tok = torch.arange(ld, device=dev)
        out_rpd = ld // 2 if dtype == "int4-doc" else ld
        flat = torch.empty((n_pad * out_rpd, d),
                           dtype=_FLOATS.get(dtype, torch.int8), device=dev)
        scales = doc_scales = None
        if dtype == "int8":
            scales = torch.empty((n_pad * ld,), dtype=torch.float32,
                                 device=dev)
        elif dtype == "int8-doc":
            doc_scales = torch.empty((n_pad,), dtype=torch.float32,
                                     device=dev)
        elif dtype == "int4-doc":
            doc_scales = torch.empty((ld // int4_group_size(ld), n_pad),
                                     dtype=torch.float32, device=dev)
        for s in range(0, n_pad, blk):
            e = s + blk
            ln = self.doc_lengths[s:e]
            if self.is_int4:
                x = unpack_int4_pairs(embs[s:e]).to(torch.float32)
            else:
                x = embs[s:e].to(torch.float32)
            if self.scales is not None:
                x = x * self.scales[s * ld:e * ld].reshape(blk, ld, 1)
            elif self.doc_scales is not None:
                ids = torch.arange(s, e, device=dev)
                x = x * doc_row_scales(self.doc_scales, ids, ld)[..., None]
            x = x * (tok[None, :, None] < ln[:, None, None])
            if dtype == "int8":
                q, scales[s * ld:e * ld] = quantize_int8_rows(
                    x.reshape(blk * ld, d))
            elif dtype == "int8-doc":
                q, doc_scales[s:e] = quantize_int8_docs(x, ln)
            elif dtype == "int4-doc":
                q, doc_scales[:, s:e] = quantize_int4_groups(x, ln)
            else:
                q = x.reshape(blk * ld, d)
            flat[s * out_rpd:e * out_rpd] = q
        pooled = pooled_doc_embeddings(
            flat, scales, self.doc_lengths, doc_len=ld,
            doc_scales=doc_scales, packed_int4=dtype == "int4-doc")
        return DenseTokenIndex(
            emb_flat=flat, doc_lengths=self.doc_lengths, n_docs=self.n_docs,
            doc_len=ld, dim=d, scales=scales, pooled=pooled,
            doc_scales=doc_scales)

    def ensure_pooled(self) -> torch.Tensor:
        """Compute (and cache) the prefilter vectors if absent."""
        if self.pooled is None:
            self.pooled = pooled_doc_embeddings(
                self.emb_flat, self.scales, self.doc_lengths,
                doc_len=self.doc_len, doc_scales=self.doc_scales,
                packed_int4=self.is_int4)
        return self.pooled

    # ------------------------------------------------------------------
    def search_topk(self, queries: torch.Tensor, k: int, prefilter: int = 0,
                    approx_recall: float = 0.95
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, Lq, D) -> (scores (B, k), ids (B, k)); ids < 0 = missing.
        ``prefilter`` > 0 takes the pruned two-stage route."""
        if prefilter > 0:
            return maxsim_topk_pruned(
                queries, self.emb_flat, self.scales, self.doc_lengths,
                self.ensure_pooled(), doc_scales=self.doc_scales,
                doc_len=self.doc_len, n_docs=self.n_docs,
                n_candidates=prefilter, k=k, approx_recall=approx_recall)
        vals, ids = top_k(self.search_scores(queries), min(k, self.n_docs))
        return vals, ids.to(torch.int32)

    def search_scores(self, queries: torch.Tensor) -> torch.Tensor:
        """(B, Lq, D) query token embeddings -> (B, n_docs) MaxSim scores:
        the layout's full scan (its CUDA kernel on the card). A float32
        index is scanned as bf16 here, as the JAX package does; the
        cascade scans it in float32."""
        if self.is_int4:
            s = maxsim_scores_int4_doc(queries, self.emb_flat,
                                       self.doc_scales, self.doc_lengths,
                                       doc_len=self.doc_len)
        elif self.doc_scales is not None:
            s = maxsim_scores_int8_doc(queries, self.emb_flat,
                                       self.doc_scales, self.doc_lengths,
                                       doc_len=self.doc_len)
        elif self.is_int8:
            s = maxsim_scores_int8(queries, self.emb_flat, self.scales,
                                   self.doc_lengths, doc_len=self.doc_len)
        else:
            s = maxsim_scores(queries, self.emb_flat.to(torch.bfloat16),
                              self.doc_lengths, doc_len=self.doc_len)
        return s[:, : self.n_docs]

    def gather_docs(self, ids: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather (ids…, L, D) fp32 embeddings + lengths for reranking.
        ``ids`` < 0 read a padding slot and get length 0; the doc-scale
        layouts' copied padding rows are masked by the lengths
        downstream."""
        safe = torch.where(ids >= 0, ids, self.n_pad - 1).long()
        rpd = self.doc_len // 2 if self.is_int4 else self.doc_len
        gathered = self.emb_flat.reshape(self.n_pad, rpd, -1)[safe]
        if self.is_int4:         # packed stays packed through the gather
            gathered = unpack_int4_pairs(gathered)    # (…, L, D) token order
        gathered = gathered.to(torch.float32)
        if self.is_int8:
            sc = self.scales.reshape(self.n_pad, self.doc_len)[safe]
            gathered = gathered * sc[..., None]
        elif self.doc_scales is not None:
            gathered = gathered * doc_row_scales(
                self.doc_scales, safe, self.doc_len)[..., None]
        lens = torch.where(ids >= 0, self.doc_lengths[safe], 0)
        return gathered, lens

    def rerank_scores(self, queries: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
        """Exact fp32 MaxSim over gathered candidates:
        queries (B, Lq, D), ids (B, K) -> (B, K)."""
        return torch.stack([
            maxsim_scores_exact(q[None], *self.gather_docs(cand))[0]
            for q, cand in zip(queries, ids)])

    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        emb = self.emb_flat.cpu()
        if emb.dtype == torch.bfloat16:
            # npz has no bf16: persist the raw bits as uint16, as JAX does
            emb_np = emb.view(torch.int16).numpy().view(np.uint16)
        else:
            emb_np = emb.numpy()
        arrs = {"emb_flat": emb_np,
                "doc_lengths": self.doc_lengths.cpu().numpy()}
        if self.scales is not None:
            arrs["scales"] = self.scales.cpu().numpy()
        if self.doc_scales is not None:
            arrs["doc_scales"] = self.doc_scales.cpu().numpy()
        if self.pooled is not None:
            # npz has no bf16; persist prefilter vectors as fp16
            arrs["pooled"] = self.pooled.cpu().to(torch.float16).numpy()
        np.savez(path / "dense.npz", **arrs)
        meta = {
            "n_docs": self.n_docs,
            "doc_len": self.doc_len,
            "dim": self.dim,
            "dtype": self.quant,
            "emb_dtype": _NP_NAMES[self.emb_flat.dtype],
        }
        (path / "meta.json").write_text(json.dumps(meta))
        # a flat save over a bucketed directory clears that layout's files
        (path / "mapping.npz").unlink(missing_ok=True)
        for sub in path.glob("bucket_*"):
            if sub.is_dir():
                shutil.rmtree(sub)

    @classmethod
    def load(cls, path: str | Path, device: DeviceLike = None
             ) -> "DenseTokenIndex":
        """Load a flat index directory onto ``device`` (default the card)."""
        dev = resolve_device(device)
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "dense.npz") as arrs:
            emb_np = arrs["emb_flat"]
            if meta.get("emb_dtype") == "bfloat16":
                emb = torch.from_numpy(emb_np.view(np.int16)).view(
                    torch.bfloat16)
            else:
                emb = torch.from_numpy(emb_np)
            if emb_np.shape[-1] != meta["dim"] and meta.get(
                    "dtype") == "int4-doc":
                raise ValueError(
                    "index uses the retired feature-halves int4 layout "
                    f"(width {emb_np.shape[-1]} < dim {meta['dim']}) — "
                    f"rebuild it from the chunk store ({path})")

            def opt(name):
                return (torch.from_numpy(arrs[name]).to(dev)
                        if name in arrs.files else None)

            scales, doc_scales = opt("scales"), opt("doc_scales")
            pooled = (torch.from_numpy(arrs["pooled"]).to(
                dev, torch.bfloat16) if "pooled" in arrs.files else None)
            lengths = torch.from_numpy(arrs["doc_lengths"]).to(dev)
        if (doc_scales is not None and doc_scales.dim() == 1
                and meta.get("dtype") == "int4-doc"):
            # legacy per-DOC int4 scales: broadcast over the group axis
            # (exact under the group kernel, see the JAX loader)
            ng = meta["doc_len"] // int4_group_size(meta["doc_len"])
            doc_scales = doc_scales[None, :].repeat(ng, 1)
        return cls(emb_flat=emb.to(dev), doc_lengths=lengths,
                   n_docs=meta["n_docs"], doc_len=meta["doc_len"],
                   dim=meta["dim"], scales=scales, pooled=pooled,
                   doc_scales=doc_scales)

