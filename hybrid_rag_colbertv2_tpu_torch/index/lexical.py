"""Lexical (BM25) index: host-side build, device-side scoring arrays.

Copy of ``hybrid_rag_colbertv2_tpu/index/lexical.py`` for the PyTorch
port: numpy only, the same on-disk files byte for byte, and the
pure-Python tokenizer path (index/textproc.py) in place of the JAX
package's optional native one.

Replaces the reference's ``bm25s`` index (built in
``DualIndexer.build_bm25_index``, local_rag_complete.py:846-864; queried in
``HybridRetriever._bm25_search``, :937-950). Where bm25s keeps scipy sparse
matrices on CPU, this index precomputes the full BM25 weight of every
(term, document) pair at build time and lays it out as a term-major CSR
that lives in device HBM; query scoring is the gather + scatter-add kernel
in ops/bm25.py, composable into the jitted cascade.

Scoring model (matching bm25s defaults k1=1.5, b=0.75 with the Lucene/ATIRE
idf so weights are always >= 0):

    idf(t)  = ln(1 + (N - df + 0.5) / (df + 0.5))
    w(t, d) = idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl/avgdl))

Document ids are *corpus row indices* — one global id space shared with the
dense index and the SQLite chunk store, fixing the reference's 0-based
corpus-position vs 1-based DB-id mismatch (SURVEY.md section 2, latent bugs).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from .textproc import tokenize_lexical


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class LexicalIndex:
    vocab: Dict[str, int]
    indptr: np.ndarray        # (V + 1,) int32
    post_docs: np.ndarray     # (nnz_pad,) int32
    post_weights: np.ndarray  # (nnz_pad,) float32
    n_docs: int
    avgdl: float
    k1: float = 1.5
    b: float = 0.75
    max_postings: int = 0     # longest postings list, rounded up to 128
    query_max_terms: int = 64
    stemmer: str = "snowball"  # persisted: queries must tokenize like the
                               # corpus did ("snowball" = reference parity,
                               # local_rag_complete.py:854; "porter" opt-in)

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        corpus: Sequence[str],
        *,
        k1: float = 1.5,
        b: float = 0.75,
        query_max_terms: int = 64,
        postings_cap: int = 0,
        stemmer: str = "snowball",
    ) -> "LexicalIndex":
        """``postings_cap`` > 0 truncates each term's postings list to its
        ``cap`` highest-weight entries (idf stays computed from the TRUE
        document frequency). The device scorer's cost is
        O(B * Q * max_postings), so very common terms — which carry the
        least idf — otherwise dominate scan time at large corpus scale.
        This is the standard impact-ordered truncation; exact when every
        term's df <= cap."""
        n = len(corpus)
        # pure-Python tokenization only: the JAX package's optional C++
        # fast path (utils/native.py) loads a library built for that
        # package, and its output is bit-identical to this path anyway
        all_toks = [tokenize_lexical(t, stemmer=stemmer) for t in corpus]
        doc_lens_i = np.array([len(t) for t in all_toks], np.int64)
        # vectorized vocab + postings: np.unique over all tokens, then
        # over (term, doc) pairs — the pairs come out sorted by
        # (term, doc), which IS the term-major CSR order
        flat = np.array([t for toks in all_toks for t in toks],
                        dtype=object)
        if flat.size:
            doc_of_tok = np.repeat(np.arange(n, dtype=np.int64),
                                   doc_lens_i)
            uniq, inv = np.unique(flat.astype(str), return_inverse=True)
            vocab: Dict[str, int] = {t: i for i, t in enumerate(uniq)}
            v = len(uniq)
            pair_key = inv.astype(np.int64) * n + doc_of_tok
            uk, tf = np.unique(pair_key, return_counts=True)
            tids = (uk // n).astype(np.int64)
            dids = (uk % n).astype(np.int64)
        else:
            vocab = {}
            v = 0
            tids = dids = np.zeros((0,), np.int64)
            tf = np.zeros((0,), np.int64)
        doc_lens = doc_lens_i.astype(np.float64)
        avgdl = float(doc_lens.mean()) if n else 1.0
        avgdl = max(avgdl, 1e-9)

        df = np.bincount(tids, minlength=v).astype(np.int64)
        idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        denom_norm = k1 * (1.0 - b + b * doc_lens[dids] / avgdl) if n else 0
        post_weights = (idf[tids] * tf * (k1 + 1.0)
                        / (tf + denom_norm)).astype(np.float32)
        if postings_cap and v:
            # stable tid-major, weight-descending order; keep each term's
            # first `cap` entries, then RESTORE (term, doc) order so the
            # capped CSR keeps the same within-term doc-ascending
            # invariant as the uncapped one (the device scorers are
            # order-insensitive, but a uniform layout keeps persisted
            # indexes canonical and diffable)
            order = np.lexsort((-post_weights, tids))
            tids_s = tids[order]
            seg_start = np.searchsorted(tids_s, np.arange(v))
            rank = np.arange(tids_s.size, dtype=np.int64) - seg_start[tids_s]
            keep = rank < postings_cap
            tids = tids_s[keep]
            dids = dids[order][keep]
            post_weights = post_weights[order][keep]
            df = np.bincount(tids, minlength=v).astype(np.int64)
            reorder = np.lexsort((dids, tids))
            tids = tids[reorder]
            dids = dids[reorder]
            post_weights = post_weights[reorder]

        post_docs = dids.astype(np.int32)
        indptr = np.zeros((v + 1,), np.int64)
        np.cumsum(df, out=indptr[1:])
        nnz = int(indptr[-1])

        max_post = int(df.max()) if v else 0
        max_post = max(_round_up(max_post, 128), 128)
        nnz_pad = max(_round_up(nnz, 128), 128)
        post_docs = np.pad(post_docs, (0, nnz_pad - nnz), constant_values=n)
        post_weights = np.pad(post_weights, (0, nnz_pad - nnz))
        return cls(
            vocab=vocab,
            indptr=indptr.astype(np.int32),
            post_docs=post_docs,
            post_weights=post_weights,
            n_docs=n,
            avgdl=avgdl,
            k1=k1,
            b=b,
            max_postings=max_post,
            query_max_terms=query_max_terms,
            stemmer=stemmer,
        )

    # ------------------------------------------------------------------
    def encode_query(self, query: str,
                     q_max: Optional[int] = None) -> np.ndarray:
        """Query text -> fixed-size int32 term-id vector, -1 padded.

        Out-of-vocabulary terms are dropped (they can't score anything),
        duplicates are kept (each occurrence accumulates, see ops/bm25.py).
        """
        q_max = q_max or self.query_max_terms
        ids = [self.vocab[t]
               for t in tokenize_lexical(query, stemmer=self.stemmer)
               if t in self.vocab]
        ids = ids[:q_max]
        out = np.full((q_max,), -1, np.int32)
        out[: len(ids)] = ids
        return out

    def score_host(self, query: str) -> np.ndarray:
        """Reference CPU scorer over the same CSR (tests compare the device
        kernel against this)."""
        scores = np.zeros((self.n_docs,), np.float64)
        for tid in self.encode_query(query):
            if tid < 0:
                continue
            s, e = self.indptr[tid], self.indptr[tid + 1]
            scores[self.post_docs[s:e]] += self.post_weights[s:e]
        return scores.astype(np.float32)

    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez(
            path / "postings.npz",
            indptr=self.indptr,
            post_docs=self.post_docs,
            post_weights=self.post_weights,
        )
        meta = {
            "n_docs": self.n_docs,
            "avgdl": self.avgdl,
            "k1": self.k1,
            "b": self.b,
            "max_postings": self.max_postings,
            "query_max_terms": self.query_max_terms,
            "stemmer": self.stemmer,
        }
        (path / "meta.json").write_text(json.dumps(meta))
        (path / "vocab.json").write_text(
            json.dumps(self.vocab, ensure_ascii=False)
        )

    @classmethod
    def load(cls, path: str | Path) -> "LexicalIndex":
        path = Path(path)
        arrs = np.load(path / "postings.npz")
        meta = json.loads((path / "meta.json").read_text())
        # indexes persisted before the stemmer was recorded were built
        # with the Porter-1980 stemmer — defaulting the missing key to
        # the current "snowball" would stem queries differently from the
        # stored postings and silently drop matching terms
        meta.setdefault("stemmer", "porter")
        vocab = json.loads((path / "vocab.json").read_text())
        return cls(
            vocab=vocab,
            indptr=arrs["indptr"],
            post_docs=arrs["post_docs"],
            post_weights=arrs["post_weights"],
            **meta,
        )

    # ------------------------------------------------------------------
    def shard_postings(self, n_shards: int, n_pad: Optional[int] = None):
        """Split the CSR by document range for doc-axis BM25 sharding.

        Shard ``s`` owns docs ``[s*n_local, (s+1)*n_local)`` where
        ``n_local = n_pad // n_shards`` — the SAME ownership layout as the
        doc-sharded dense index (parallel/mesh.shard_dense_index), so one
        mesh axis shards both legs consistently.

        -> (indptr (S, V+1) int32, post_docs (S, nnz_max) int32 with
            LOCAL doc ids (pad slots = n_local), post_weights
            (S, nnz_max) f32, max_postings_local int) — stacked so the
            leading axis can carry a jax.sharding doc-axis spec; every
            shard padded to the widest shard's nnz (static shapes).
        """
        if n_pad is None:
            n_pad = _round_up(max(self.n_docs, 1), 128)
        assert n_pad % n_shards == 0, (n_pad, n_shards)
        n_local = n_pad // n_shards
        v = len(self.vocab)
        nnz = int(self.indptr[-1])
        docs = self.post_docs[:nnz].astype(np.int64)
        weights = self.post_weights[:nnz]
        # reconstruct term ids from the CSR offsets
        counts = np.diff(self.indptr.astype(np.int64))
        tids = np.repeat(np.arange(v, dtype=np.int64), counts)
        shard_of = docs // n_local

        indptrs, pdocs, pweights = [], [], []
        max_post_local = 0
        for s in range(n_shards):
            m = shard_of == s
            t_s = tids[m]
            df_s = np.bincount(t_s, minlength=v).astype(np.int64)
            ip = np.zeros((v + 1,), np.int64)
            np.cumsum(df_s, out=ip[1:])
            # within-term doc order is preserved by the boolean mask
            # (canonical doc-ascending CSR), so this IS a valid CSR
            indptrs.append(ip)
            pdocs.append((docs[m] - s * n_local).astype(np.int32))
            pweights.append(weights[m])
            if df_s.size:
                max_post_local = max(max_post_local, int(df_s.max()))
        nnz_max = max(_round_up(max((p.size for p in pdocs), default=0),
                                128), 128)
        out_docs = np.full((n_shards, nnz_max), n_local, np.int32)
        out_w = np.zeros((n_shards, nnz_max), np.float32)
        out_ip = np.zeros((n_shards, v + 1), np.int64)
        for s in range(n_shards):
            out_docs[s, : pdocs[s].size] = pdocs[s]
            out_w[s, : pweights[s].size] = pweights[s]
            out_ip[s] = indptrs[s]
        max_post_local = max(_round_up(max_post_local, 128), 128)
        return (out_ip.astype(np.int32), out_docs, out_w, max_post_local)

    # ------------------------------------------------------------------
    def memory_bytes(self) -> int:
        return (
            self.indptr.nbytes + self.post_docs.nbytes
            + self.post_weights.nbytes
        )
