"""Index manager — port of ``hybrid_rag_colbertv2_tpu/index/manager.py``
(flat layout).

Owns the lexical (BM25 CSR) and dense (ColBERT token-embedding) indexes
over one chunk corpus: builds both from the corpus, persists both in the
JAX package's formats, reloads them, and appends new chunks without
re-encoding the old ones. One global chunk-id space: the corpus row
index.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Protocol, Sequence, Tuple

import torch

from ..config import RAGConfig
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import StageTimer, get_logger
from .dense import DenseTokenIndex, pick_bucket
from .lexical import LexicalIndex

log = get_logger(__name__)


class DocEncoder(Protocol):
    """What the manager needs from an encoder (models/colbert.py)."""

    def encode_docs(self, texts: Sequence[str],
                    doc_len: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (token_embs (N, L, D), lengths (N,))"""
        ...


class IndexManager:
    """Builds / persists / serves the lexical + dense index pair on
    ``device`` (default the card)."""

    def __init__(self, config: RAGConfig,
                 encoder: Optional[DocEncoder] = None,
                 device: DeviceLike = None):
        self.config = config
        self.encoder = encoder
        self.device = resolve_device(device)
        self.lexical: Optional[LexicalIndex] = None
        self.dense: Optional[DenseTokenIndex] = None
        self.corpus: Optional[list] = None
        self.timer = StageTimer()
        self._csr: Tuple = (None, {})

    def _require_flat(self) -> None:
        if self.config.mesh.index_layout != "single":
            raise NotImplementedError(
                "the bucketed index layout comes with the port of "
                "index/bucketed.py (ROADMAP.md)")

    def lexical_csr(self) -> Dict[str, torch.Tensor]:
        """The lexical CSR arrays (indptr, post_docs, post_weights) on the
        manager's device, moved once per lexical index and shared by
        every retriever over this manager (the fused cascade's cache keys
        on their identities)."""
        lex = self.lexical
        if self._csr[0] is not lex:
            self._csr = (lex, {
                name: torch.as_tensor(getattr(lex, name), device=self.device)
                for name in ("indptr", "post_docs", "post_weights")})
        return self._csr[1]

    # ------------------------------------------------------------------
    def build_lexical(self, corpus: Sequence[str]) -> LexicalIndex:
        with self.timer.stage("bm25_build"):
            self.lexical = LexicalIndex.build(
                list(corpus),
                postings_cap=getattr(self.config, "bm25_postings_cap", 0))
            self.lexical.save(self.config.bm25_index_path)
        log.info("BM25 index: %d docs, %d terms, %.2f MB (%.2fs)",
                 self.lexical.n_docs, len(self.lexical.vocab),
                 self.lexical.memory_bytes() / 2**20,
                 self.timer.timings["bm25_build"])
        return self.lexical

    def build_dense(self, corpus: Sequence[str]) -> DenseTokenIndex:
        """Encode the corpus and lay the token embeddings into the padded
        flat index at the smallest covering length bucket."""
        self._require_flat()
        if self.encoder is None:
            raise RuntimeError(
                "IndexManager needs an encoder to build the dense index")
        with self.timer.stage("colbert_encode"):
            embs, lengths = self.encoder.encode_docs(list(corpus))
        with self.timer.stage("colbert_build"):
            max_len = int(lengths.max()) if lengths.shape[0] else 1
            bucket = pick_bucket(max_len, self.config.mesh.doc_token_buckets)
            dtype = self.config.mesh.resolve_index_dtype(
                len(corpus), bucket, dim=int(embs.shape[-1]),
                device=self.device)
            if dtype != self.config.mesh.index_dtype:
                log.info("index_dtype=auto -> %s (%d docs x %d tokens)",
                         dtype, len(corpus), bucket)
            self.dense = DenseTokenIndex.build(
                embs.to(self.device), lengths, doc_len=bucket, dtype=dtype)
            self.dense.save(self.config.colbert_index_path)
        log.info("Dense index: %d docs, %.2f MB (encode %.2fs, build %.2fs)",
                 self.dense.n_docs, self.dense.memory_bytes() / 2**20,
                 self.timer.timings["colbert_encode"],
                 self.timer.timings["colbert_build"])
        return self.dense

    def build_all(self, corpus: Sequence[str]) -> None:
        self.corpus = list(corpus)
        self.build_lexical(self.corpus)
        self.build_dense(self.corpus)

    def add_documents(self, full_corpus: Sequence[str]) -> None:
        """Incremental update: ``full_corpus`` is the WHOLE corpus in
        global-id order with the new chunks appended at the end. Only the
        new chunks are encoded, at the index's ``doc_len``, and appended
        (``DenseTokenIndex.append``); the lexical CSR is rebuilt on the
        host. Rebuilds everything when nothing is loaded or the corpus
        shrank. A live retriever rebinds on its next call."""
        self._require_flat()
        full_corpus = list(full_corpus)
        if self.dense is None or self.dense.n_docs > len(full_corpus):
            self.build_all(full_corpus)
            return
        new_texts = full_corpus[self.dense.n_docs:]
        self.corpus = full_corpus
        self.build_lexical(full_corpus)
        if not new_texts:
            return
        if self.encoder is None:
            raise RuntimeError("IndexManager needs an encoder to add docs")
        with self.timer.stage("colbert_encode_new"):
            embs, lengths = self.encoder.encode_docs(
                new_texts, doc_len=self.dense.doc_len)
        with self.timer.stage("colbert_append"):
            self.dense = self.dense.append(embs, lengths)
            self.dense.save(self.config.colbert_index_path)
        log.info("Dense index +%d docs -> %d total (encode %.2fs, "
                 "append %.2fs)", len(new_texts), self.dense.n_docs,
                 self.timer.timings["colbert_encode_new"],
                 self.timer.timings["colbert_append"])

    # ------------------------------------------------------------------
    def load(self) -> None:
        """Load both indexes. The layout is read from ``meta.json``
        (written last by both save paths), not from which files exist."""
        self.lexical = LexicalIndex.load(self.config.bm25_index_path)
        meta = json.loads(
            (Path(self.config.colbert_index_path) / "meta.json").read_text())
        if "n_buckets" in meta:
            raise NotImplementedError(
                f"{self.config.colbert_index_path} holds a bucketed index; "
                "that layout comes with the port of index/bucketed.py "
                "(ROADMAP.md)")
        self.dense = DenseTokenIndex.load(self.config.colbert_index_path,
                                          device=self.device)

    def is_built(self) -> bool:
        return (Path(self.config.bm25_index_path, "meta.json").exists()
                and Path(self.config.colbert_index_path,
                         "meta.json").exists())
