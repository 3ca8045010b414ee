"""Index manager — port of ``hybrid_rag_colbertv2_tpu/index/manager.py``
(flat layout).

Owns the lexical (BM25 CSR) and dense (ColBERT token-embedding) indexes
over one chunk corpus: builds both from the corpus, persists both in the
JAX package's formats, and reloads them. One global chunk-id space: the
corpus row index.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Protocol, Sequence, Tuple

import torch

from ..config import RAGConfig
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import StageTimer, get_logger
from .dense import DenseTokenIndex, pick_bucket
from .lexical import LexicalIndex

log = get_logger(__name__)


class DocEncoder(Protocol):
    """What the manager needs from an encoder (models/colbert.py)."""

    def encode_docs(self, texts: Sequence[str]
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

    def _require_flat(self) -> None:
        if self.config.mesh.index_layout != "single":
            raise NotImplementedError(
                "the bucketed index layout comes with the port of "
                "index/bucketed.py (ROADMAP.md)")

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
