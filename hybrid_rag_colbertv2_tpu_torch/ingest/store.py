"""Durable chunk/document/image store — stdlib sqlite3.

Port copy of ``hybrid_rag_colbertv2_tpu/ingest/store.py``, its imports pointed at
the port's modules.

Replaces the reference's SQLAlchemy ORM layer (``Document``/``Image``/
``Chunk`` declarative models, local_rag_complete.py:93-125, engine/session
in :1117-1122) with direct sqlite3 (the SQLAlchemy wheel is not a given,
and the reference's ``Chunk.metadata`` column name is a latent SQLAlchemy
crash anyway — SURVEY.md section 2).

Schema parity: documents(filename, upload_date, total_pages, status),
images(document_id, page_number, image_path, description, image_type,
ocr_text), chunks(document_id, chunk_index, text, heading_path,
token_count, has_images, meta). One addition fixes the reference's id-space
bug: ``chunks.corpus_index`` is the global retrieval id (corpus row index,
shared with both device indexes); fetches go through it, not the SQLite
autoincrement.

The reference's 50 sequential SELECTs per query (the N+1 pattern,
local_rag_complete.py:980-994) becomes one batched ``IN`` query.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    filename TEXT NOT NULL,
    upload_date TEXT,
    total_pages INTEGER,
    status TEXT
);
CREATE TABLE IF NOT EXISTS images (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    document_id INTEGER NOT NULL,
    page_number INTEGER NOT NULL,
    image_path TEXT NOT NULL,
    description TEXT,
    image_type TEXT,
    ocr_text TEXT
);
CREATE TABLE IF NOT EXISTS chunks (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    corpus_index INTEGER UNIQUE,
    document_id INTEGER NOT NULL,
    chunk_index INTEGER NOT NULL,
    text TEXT NOT NULL,
    heading_path TEXT,
    token_count INTEGER,
    has_images INTEGER DEFAULT 0,
    meta TEXT
);
CREATE INDEX IF NOT EXISTS idx_chunks_corpus ON chunks(corpus_index);
CREATE INDEX IF NOT EXISTS idx_chunks_doc ON chunks(document_id);
"""


class ChunkStore:
    def __init__(self, db_path: str | Path):
        self.db_path = str(db_path)
        if self.db_path != ":memory:":
            Path(self.db_path).parent.mkdir(parents=True, exist_ok=True)
        self._local = threading.local()
        self._conn().executescript(_SCHEMA)
        self._conn().commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.db_path)
            conn.row_factory = sqlite3.Row
            # WAL + NORMAL: one fsync per checkpoint instead of per
            # commit. The ingest pipeline commits several times per
            # document (doc row, images, chunks, status); with FULL
            # sync each commit costs ~1 s on slow-fsync filesystems,
            # dominating ingest wall-clock (~4 s/doc measured). WAL is
            # process-crash-safe; the store is rebuildable from source
            # documents in the power-loss window (SURVEY §5 recovery
            # model: indexes rebuild from the store, the store from
            # the PDFs).
            if self.db_path != ":memory:":
                conn.execute("PRAGMA journal_mode=WAL")
                conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    # -- documents ---------------------------------------------------------
    def add_document(self, filename: str, total_pages: Optional[int] = None,
                     status: str = "processing") -> int:
        cur = self._conn().execute(
            "INSERT INTO documents(filename, upload_date, total_pages, status)"
            " VALUES (?, ?, ?, ?)",
            (filename, datetime.now(timezone.utc).isoformat(), total_pages,
             status),
        )
        self._conn().commit()
        return cur.lastrowid

    def set_document_status(self, doc_id: int, status: str) -> None:
        self._conn().execute("UPDATE documents SET status=? WHERE id=?",
                             (status, doc_id))
        self._conn().commit()

    # -- images --------------------------------------------------------------
    def add_image(self, document_id: int, page_number: int, image_path: str,
                  description: str = "", image_type: str = "unknown",
                  ocr_text: str = "") -> int:
        cur = self._conn().execute(
            "INSERT INTO images(document_id, page_number, image_path,"
            " description, image_type, ocr_text) VALUES (?, ?, ?, ?, ?, ?)",
            (document_id, page_number, image_path, description, image_type,
             ocr_text),
        )
        self._conn().commit()
        return cur.lastrowid

    def get_images(self, document_id: int) -> List[Dict]:
        rows = self._conn().execute(
            "SELECT * FROM images WHERE document_id=?", (document_id,)
        ).fetchall()
        return [dict(r) for r in rows]

    # -- chunks ----------------------------------------------------------------
    def next_corpus_index(self) -> int:
        row = self._conn().execute(
            "SELECT MAX(corpus_index) AS m FROM chunks").fetchone()
        return (row["m"] + 1) if row["m"] is not None else 0

    def add_chunks(self, document_id: int, chunks: Sequence[Dict]) -> List[int]:
        """Persist chunk dicts; returns their corpus indexes (global ids)."""
        conn = self._conn()
        # BEGIN IMMEDIATE takes the writer lock before reading MAX(..), so
        # two concurrent writers cannot compute the same base and collide
        # on the UNIQUE corpus_index constraint mid-batch.
        conn.execute("BEGIN IMMEDIATE")
        try:
            return self._add_chunks_locked(conn, document_id, chunks)
        except BaseException:
            conn.rollback()
            raise

    def _add_chunks_locked(self, conn, document_id: int,
                           chunks: Sequence[Dict]) -> List[int]:
        base = self.next_corpus_index()
        ids = []
        for i, c in enumerate(chunks):
            corpus_index = base + i
            meta = {k: v for k, v in c.items()
                    if k not in ("text", "heading_path", "token_count",
                                 "has_images")}
            conn.execute(
                "INSERT INTO chunks(corpus_index, document_id, chunk_index,"
                " text, heading_path, token_count, has_images, meta)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                (corpus_index, document_id, i, c["text"],
                 c.get("heading_path", ""), c.get("token_count", 0),
                 int(bool(c.get("has_images", False))),
                 json.dumps(meta, default=str)),
            )
            ids.append(corpus_index)
        conn.commit()
        return ids

    def get_chunk(self, corpus_index: int) -> Optional[Dict]:
        r = self._conn().execute(
            "SELECT * FROM chunks WHERE corpus_index=?", (corpus_index,)
        ).fetchone()
        return self._chunk_row(r) if r else None

    def get_chunks(self, corpus_indexes: Iterable[int]) -> List[Dict]:
        """Batched fetch (one query — not the reference's N+1 loop)."""
        idx = list(corpus_indexes)
        if not idx:
            return []
        q = ",".join("?" * len(idx))
        rows = self._conn().execute(
            f"SELECT * FROM chunks WHERE corpus_index IN ({q})", idx
        ).fetchall()
        by_id = {r["corpus_index"]: self._chunk_row(r) for r in rows}
        return [by_id[i] for i in idx if i in by_id]

    def all_chunk_texts(self) -> List[str]:
        """Corpus in corpus_index order — index rebuild source of truth."""
        rows = self._conn().execute(
            "SELECT text FROM chunks ORDER BY corpus_index").fetchall()
        return [r["text"] for r in rows]

    @staticmethod
    def _chunk_row(r: sqlite3.Row) -> Dict:
        return {
            "chunk_id": r["corpus_index"],
            "text": r["text"],
            "document_id": r["document_id"],
            "heading_path": r["heading_path"],
            "has_images": bool(r["has_images"]),
            "metadata": json.loads(r["meta"]) if r["meta"] else {},
        }

    # -- stats ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Counts for print_stats parity (local_rag_complete.py:1229-1238)."""
        c = self._conn()
        return {
            "documents": c.execute("SELECT COUNT(*) FROM documents").fetchone()[0],
            "chunks": c.execute("SELECT COUNT(*) FROM chunks").fetchone()[0],
            "images": c.execute("SELECT COUNT(*) FROM images").fetchone()[0],
        }

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
