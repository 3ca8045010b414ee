"""The plain reference: the same retrieval semantics as the served path,
written from the configuration and the generated inputs in plain PyTorch,
with TF32 off. It imports nothing of the program and reads nothing the
program made: it works out again the query token ids (the hash
tokenizer's rule), the encoder forward, the BM25 weights and their
per-term cap, the pooled proxies, both dense routes, the fusion, the
rerank and the final order.

Precision: fp32 everywhere the configuration says float32 (the encoder,
stage B, the rerank). The dense scoring's inputs (the full scan's query,
stage A's query sum and the pooled proxies) are rounded to the
configuration file's ``compute_dtype`` (fp32 accumulation), read there.
The controls round matmul inputs one precision step down:
``Precision("tf32")`` to TF32 (10 explicit mantissa bits), one step
below fp32 with TF32 off; ``Precision("e4m3")`` to float8 e4m3 (3
mantissa bits) with one scale per tensor, as an fp8 product takes its
inputs, one step below bfloat16. ``LOWER_MATMUL`` names the encoder's
step below the configuration's ``encoder_dtype`` (the reference's
encoder is fp32 whatever that says); ``LOWER_DENSE`` the dense control's
dtype below its ``compute_dtype``.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import gen

NEG = -1e30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}
# the controls: one precision step below the stated encoder dtype (a
# Precision) and below the stated dense compute dtype (a DTYPES key)
LOWER_MATMUL = {"float32": "tf32", "bfloat16": "e4m3"}
LOWER_DENSE = {"bfloat16": "float8_e4m3fn"}


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, as fp32."""
    return x.to(dtype).to(torch.float32)


def exact_fp32() -> None:
    """fp32 matmuls in fp32 on the card, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest value with TF32's 10 mantissa bits (ties to
    even), still stored as fp32."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> float8 e4m3 as a scaled fp8 product takes its inputs: the
    tensor scaled so that its largest magnitude is e4m3's largest (448),
    rounded to the nearest e4m3 value (ties to even), scaled back, still
    stored as fp32."""
    scale = 448.0 / x.abs().amax().clamp_min(1e-30)
    return rounded(x * scale, DTYPES["float8_e4m3fn"]) / scale


class Precision:
    """The rounding applied to matmul inputs: "fp32" (none), "tf32" or
    "e4m3"."""

    ROUND = {"fp32": lambda x: x, "tf32": round_tf32, "e4m3": round_e4m3}

    def __init__(self, name: str = "fp32"):
        if name not in self.ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.ROUND[self.name](x.to(torch.float32))


# ---------------------------------------------------------------------
# query token ids


def query_token_ids(texts: Sequence[str], vocab_size: int, lq: int
                    ) -> torch.Tensor:
    """The hash tokenizer's query ids: [BOS] [Q] words [EOS], [MASK]
    padded to ``lq``; a word's id is 7 + (first 32 bits of its md5) mod
    (vocab - 7)."""
    out = np.full((len(texts), lq), gen.MASK, np.int64)
    for r, text in enumerate(texts):
        ids = [gen.N_SPECIAL + int(hashlib.md5(w.encode()).hexdigest()[:8],
                                   16) % (vocab_size - gen.N_SPECIAL)
               for w in text.lower().split()]
        row = [gen.BOS, gen.QMARK] + ids[:lq - 3] + [gen.EOS]
        out[r, :len(row)] = row
    return torch.as_tensor(out)


# ---------------------------------------------------------------------
# BM25


def bm25_topk(term: torch.Tensor, doc: torch.Tensor, tf: torch.Tensor,
              lex_lens: torch.Tensor, n_docs: int, vocab: int, cap: int,
              queries: Sequence[Sequence[int]], k: int) -> torch.Tensor:
    """BM25 top-k from the (term, doc, tf) pairs (sorted by term, then
    doc): Lucene idf, k1 = 1.5, b = 0.75, each weight rounded to float32,
    each term's postings cut to its ``cap`` best weights (ties by doc),
    every occurrence of a query term counted, the totals in float64;
    score > 0 only, ties by ascending doc. -> (S, k) ids, -1 padded."""
    dev = term.device
    dl = lex_lens.to(torch.float64)
    avgdl = max(float(dl.mean()), 1e-9)
    df = torch.bincount(term, minlength=vocab).to(torch.float64)
    out = torch.full((len(queries), k), -1, dtype=torch.int64, device=dev)
    for r, q in enumerate(queries):
        uniq, mult = np.unique(np.asarray(q, np.int64), return_counts=True)
        docs, ws = [], []
        for t, m in zip(uniq.tolist(), mult.tolist()):
            lo = int(torch.searchsorted(term, torch.tensor(t, device=dev)))
            hi = int(torch.searchsorted(term, torch.tensor(t, device=dev),
                                        right=True))
            if hi == lo:
                continue
            d, f = doc[lo:hi], tf[lo:hi].to(torch.float64)
            idf = math.log(1.0 + (n_docs - float(df[t]) + 0.5)
                           / (float(df[t]) + 0.5))
            w = (idf * f * (gen.K1 + 1.0)
                 / (f + gen.K1 * (1.0 - gen.B + gen.B * dl[d] / avgdl))
                 ).to(torch.float32)
            if cap and w.shape[0] > cap:
                best = torch.argsort(-w, stable=True)[:cap]
                d, w = d[best], w[best]
            docs.append(d)
            ws.append(w.to(torch.float64) * m)
        if not docs:
            continue
        d = torch.cat(docs)
        u, inv = torch.unique(d, return_inverse=True)
        tot = torch.zeros(u.shape, dtype=torch.float64, device=dev)
        tot.index_add_(0, inv, torch.cat(ws))
        live = tot > 0
        u, tot = u[live], tot[live]
        order = torch.argsort(-tot, stable=True)[:k]   # u ascending
        out[r, :order.shape[0]] = u[order]
    return out


# ---------------------------------------------------------------------
# dense


def pooled_proxies(rows: torch.Tensor, scales: torch.Tensor,
                   lengths: torch.Tensor, doc_len: int, dtype: torch.dtype,
                   block: int = 1024) -> torch.Tensor:
    """Each doc's mean dequantized token row, L2-normalized, in the dense
    compute ``dtype``."""
    n_pad, d = lengths.shape[0], rows.shape[-1]
    r3, s2 = rows.view(n_pad, doc_len, d), scales.view(n_pad, doc_len)
    out = torch.empty((n_pad, d), dtype=dtype, device=rows.device)
    for s in range(0, n_pad, block):
        e = r3[s:s + block].to(torch.float32) * s2[s:s + block, :, None]
        mean = e.sum(dim=1) / torch.clamp(
            lengths[s:s + block].to(torch.float32), min=1.0)[:, None]
        nrm = torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
        out[s:s + block] = (mean / torch.clamp(nrm, min=1e-9)).to(dtype)
    return out


def maxsim(q: torch.Tensor, rows: torch.Tensor, scales: torch.Tensor,
           lengths: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Exact MaxSim of one query (Lq, D) against C docs: rows (C, L, D)
    int8, scales (C, L), lengths (C,) -> (C,) fp32, the dequantization
    on the products, rows past each length left out."""
    sims = torch.einsum("qd,cld->cql", prec(q), prec(rows.to(torch.float32)))
    sims = sims * scales[:, None, :]
    tok = torch.arange(rows.shape[1], device=rows.device)
    valid = tok[None, :] < lengths[:, None]
    sims = torch.where(valid[:, None, :], sims, NEG)
    return sims.amax(dim=-1).sum(dim=-1)


def _desc(values: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` largest values, ties by position."""
    return torch.argsort(values, descending=True, stable=True)[:k]


class SubIndex:
    """One flat int8 index (or one bucket of a bucketed one): rows
    (n_pad * L, D), scales (n_pad * L,), lengths (n_pad,) and the global
    id of each row (``gid``, -1 for padding)."""

    def __init__(self, rows, scales, lengths, doc_len, gid):
        self.rows, self.scales, self.lengths = rows, scales, lengths
        self.doc_len, self.gid = doc_len, gid
        self.n_pad = lengths.shape[0]
        self._pooled: Dict[torch.dtype, torch.Tensor] = {}

    def pooled(self, dtype: torch.dtype) -> torch.Tensor:
        if dtype not in self._pooled:
            self._pooled[dtype] = pooled_proxies(
                self.rows, self.scales, self.lengths, self.doc_len, dtype)
        return self._pooled[dtype]

    def docs(self, local: torch.Tensor):
        d = self.rows.shape[-1]
        return (self.rows.view(self.n_pad, self.doc_len, d)[local],
                self.scales.view(self.n_pad, self.doc_len)[local],
                self.lengths[local])

    def topk_pruned(self, q: torch.Tensor, prefilter: int, k: int,
                    prec: Precision, dense: torch.dtype):
        """Stage A (the query sum and the proxies in the dense ``dense``
        dtype, top C) then stage B (exact MaxSim of the C candidates) for
        one query -> (values, local ids)."""
        c = min(gen.round_up(prefilter, 128), self.n_pad)
        qbar = rounded(q.sum(dim=0), dense)
        proxy = self.pooled(dense).to(torch.float32) @ qbar
        proxy = torch.where(self.lengths > 0, proxy, NEG)
        cand = _desc(proxy, c)
        ex = maxsim(q, *self.docs(cand), prec)
        top = _desc(ex, min(k, c))
        return ex[top], cand[top]

    def scan(self, qs: torch.Tensor, prec: Precision, dense: torch.dtype,
             block: int = 512) -> torch.Tensor:
        """The full scan of every doc for a batch of queries (S, Lq, D),
        the queries rounded to the dense ``dense`` dtype -> (S, n_pad)
        fp32."""
        s_, lq, d = qs.shape
        qt = prec(rounded(qs, dense).reshape(-1, d)).T
        out = torch.empty((s_, self.n_pad), dtype=torch.float32,
                          device=qs.device)
        r3 = self.rows.view(self.n_pad, self.doc_len, d)
        s2 = self.scales.view(self.n_pad, self.doc_len)
        for s in range(0, self.n_pad, block):
            e = min(s + block, self.n_pad)
            sims = (prec(r3[s:e].to(torch.float32)).reshape(-1, d) @ qt)
            sims = sims.view(e - s, self.doc_len, s_, lq)
            sims.mul_(s2[s:e, :, None, None])
            # rows that hold no token (scale 0) are left out
            sims.masked_fill_((s2[s:e] == 0)[:, :, None, None], NEG)
            out[:, s:e] = sims.amax(dim=1).sum(dim=-1).T
        return out


def dense_topk(q: torch.Tensor, subs: List[SubIndex], n_docs: int,
               prefilter: int, k: int, prec: Precision,
               dense: torch.dtype) -> torch.Tensor:
    """The dense top-k of one query over one or more sub-indexes: per
    sub-index the pruned top-k (or the full scan's), mapped to global ids,
    then the best ``k`` of the concatenated lists (ties in sub-index
    order, then rank). -> (k,) global ids, -1 padded."""
    vals, ids = [], []
    for sub in subs:
        if prefilter > 0:
            v, local = sub.topk_pruned(q, prefilter, k, prec, dense)
        else:
            sc = sub.scan(q[None], prec, dense)[0]
            sc = torch.where(sub.gid >= 0, sc, NEG)
            local = _desc(sc, min(k, sub.n_pad))
            v = sc[local]
        g = sub.gid[local]
        vals.append(torch.where(g >= 0, v, NEG))
        ids.append(g)
    v, g = torch.cat(vals), torch.cat(ids)
    top = _desc(v, min(k, n_docs, v.shape[0]))
    out = torch.full((k,), -1, dtype=torch.int64, device=q.device)
    out[:top.shape[0]] = torch.where(v[top] > NEG / 2, g[top], -1)
    return out


def dense_topk_scan_batch(qs: torch.Tensor, sub: SubIndex, n_docs: int,
                          k: int, prec: Precision, dense: torch.dtype
                          ) -> torch.Tensor:
    """Route 0 on one flat index for a batch of queries at once (the scan
    is the costly part) -> (S, k) global ids."""
    sc = sub.scan(qs, prec, dense)[:, :n_docs]
    top = torch.argsort(sc, dim=1, descending=True, stable=True)[:, :k]
    return sub.gid[top]


# ---------------------------------------------------------------------
# fusion, rerank, final order


def rrf(bm25_ids: Sequence[int], dense_ids: Sequence[int], k: int,
        rrf_k: int = 60, weight_bm25: float = 0.5) -> List[int]:
    """Weighted reciprocal-rank fusion of two ranked lists (-1 = none):
    list weight 2w (BM25) or 2(1-w) (dense) over rrf_k + 1 + position,
    in float32; ties by ascending id; the best ``k`` with a score > 0."""
    f32 = np.float32
    wa = f32(2.0 * weight_bm25)
    wb = f32(2.0 * (1.0 - weight_bm25))
    score: Dict[int, np.float32] = {}
    for lst, wl in ((bm25_ids, wa), (dense_ids, wb)):
        for pos, i in enumerate(lst):
            if i >= 0:
                score[i] = f32(score.get(i, f32(0.0))
                               + f32(wl / f32(rrf_k + 1.0 + pos)))
    ranked = sorted(score.items(), key=lambda kv: (-float(kv[1]), kv[0]))
    return [i for i, s in ranked[:k] if s > 0]


class Reference:
    """The reference over one cell's generated inputs."""

    def __init__(self, model, arch: Dict, weights: Dict[str, torch.Tensor],
                 subs: List[SubIndex], n_docs: int, lexical: Dict,
                 retrieval: Dict, prec: Optional[Precision] = None,
                 dense: Optional[str] = None,
                 encoder_prec: Optional[Precision] = None):
        """``model``: the configuration's plain reference module (its
        ``encode_queries``), found beside its file. ``prec``: the
        rounding of stage B's and the rerank's matmul inputs;
        ``encoder_prec``: of the encoder's, else ``prec``. ``dense``: the
        dense scoring's dtype, else the configuration's
        ``compute_dtype``."""
        self.model = model
        self.arch, self.weights, self.subs = arch, weights, subs
        self.n_docs, self.lex, self.ret = n_docs, lexical, retrieval
        self.prec = prec or Precision("fp32")
        self.encoder_prec = encoder_prec or self.prec
        self.dense = DTYPES[dense or arch["compute_dtype"]]
        # global id -> (sub-index, local row)
        dev = subs[0].rows.device
        self.home = torch.full((n_docs,), -1, dtype=torch.int64, device=dev)
        self.row = torch.full((n_docs,), -1, dtype=torch.int64, device=dev)
        for si, sub in enumerate(subs):
            live = torch.nonzero(sub.gid >= 0).squeeze(1)
            self.home[sub.gid[live]] = si
            self.row[sub.gid[live]] = live

    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        ids = query_token_ids(texts, self.arch["vocab_size"],
                              self.arch["query_maxlen"])
        dev = self.subs[0].rows.device
        with torch.no_grad():
            return self.model.encode_queries(self.weights, self.arch,
                                             ids.to(dev), self.encoder_prec)

    def exact_scores(self, q: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
        """The rerank's exact fp32 MaxSim of one query (Lq, D) with the
        docs ``ids`` (C,) (-1 -> -inf)."""
        out = torch.full(ids.shape, -math.inf, dtype=torch.float32,
                         device=q.device)
        live = ids >= 0
        for si, sub in enumerate(self.subs):
            own = live & (self.home[torch.clamp(ids, min=0)] == si)
            if bool(own.any()):
                rows = self.row[ids[own]]
                out[own] = maxsim(q, *sub.docs(rows), self.prec)
        return out

    def answers(self, texts: Sequence[str], terms: Sequence[Sequence[int]],
                k_final: int):
        """The served answer of each query: -> (q_emb (S, Lq, D), ids
        (S, k_final) -1 padded, scores (S, k_final))."""
        r = self.ret
        lex = self.lex
        q = self.encode(texts)
        bm = bm25_topk(lex["term"], lex["doc"], lex["tf"], lex["lex_lens"],
                       self.n_docs, lex["vocab"], r["bm25_postings_cap"],
                       terms, r["bm25_top_k"]).cpu().numpy()
        kd = min(r["colbert_top_k"], self.n_docs)
        with torch.no_grad():
            if r["dense_prefilter"] == 0 and len(self.subs) == 1:
                dn = dense_topk_scan_batch(q, self.subs[0], self.n_docs, kd,
                                           self.prec, self.dense)
            else:
                dn = torch.stack([dense_topk(qi, self.subs, self.n_docs,
                                             r["dense_prefilter"], kd,
                                             self.prec, self.dense)
                                  for qi in q])
        dn = dn.cpu().numpy()
        ids = torch.full((len(texts), k_final), -1, dtype=torch.int64)
        scores = torch.full((len(texts), k_final), -math.inf)
        for s in range(len(texts)):
            fused = rrf(bm[s].tolist(), dn[s].tolist(),
                        r["fusion_candidates"], r["rrf_k"],
                        r["fusion_weight_bm25"])
            if not fused:
                continue
            f = torch.as_tensor(fused, device=q.device)
            ex = self.exact_scores(q[s], f)
            top = _desc(ex, min(k_final, f.shape[0]))
            ids[s, :top.shape[0]] = f[top].cpu()
            scores[s, :top.shape[0]] = ex[top].cpu()
        return q, ids, scores
