"""Document ingestion pipeline.

Port copy of ``hybrid_rag_colbertv2_tpu/ingest/processor.py``, its imports pointed at
the port's modules.

TPU-side-aware equivalent of the reference's ``DocumentProcessor``
(local_rag_complete.py:472-708) — the same 5-step contract with structured
timing instead of prints:

  1. document -> markdown (:483-486; here any of pdf/md/txt, pdf.py)
  2. image extraction + vision analysis -> store (:488-556; vision client
     optional — ingestion proceeds without a sidecar)
  3. markdown-aware semantic chunking (:662-669; chunker.py)
  4. image-context enrichment (:671-683 — same keyword heuristic the
     reference ships, kept intentionally: chunks mentioning visual content
     get the document's image descriptions appended + has_images flag)
  5. persist chunks to the store (:685-706), returning their global corpus
     indexes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import RAGConfig
from ..utils.logging import StageTimer, get_logger
from .chunker import ChunkerConfig, MarkdownChunker
from .pdf import document_to_markdown_pages, extract_pdf_images
from .store import ChunkStore

log = get_logger(__name__)

# reference keyword list (local_rag_complete.py:579-580)
_VISUAL_KEYWORDS = (
    "figure", "image", "diagram", "chart", "screenshot",
    "see below", "shown in",
)


class DocumentProcessor:
    def __init__(
        self,
        config: RAGConfig,
        store: ChunkStore,
        vision_client=None,          # app/ollama.OllamaClient (optional)
        count_tokens=None,           # tokenizer hook for the chunker
    ):
        self.config = config
        self.store = store
        self.vision = vision_client
        self.chunker = MarkdownChunker(
            ChunkerConfig(
                min_tokens=config.min_chunk_size,
                max_tokens=config.max_chunk_size,
                overlap_tokens=config.chunk_overlap,
                level1_standalone=getattr(
                    config, "chunk_level1_standalone", True),
            ),
            count_tokens=count_tokens,
        )
        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def _analyze_images(self, images: List[Dict], document_id: int
                        ) -> List[Dict]:
        """Vision analysis per image (reference analyze_images :522-556);
        skipped gracefully when no vision client is configured."""
        out: List[Dict] = []
        for info in images:
            analysis = {"description": "", "type": "unknown", "ocr_text": ""}
            if self.vision is not None:
                try:
                    analysis = self.vision.analyze_image(info["image_path"])
                except Exception as e:  # sidecar down — keep ingesting
                    log.warning("vision analysis failed for %s: %s",
                                info["image_path"], e)
            self.store.add_image(
                document_id=document_id,
                page_number=info["page_number"],
                image_path=info["image_path"],
                description=analysis["description"],
                image_type=analysis["type"],
                ocr_text=analysis["ocr_text"],
            )
            out.append({**info, **analysis})
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _attach_images(c: Dict, imgs: List[Dict]) -> None:
        """Append image descriptions to a chunk (text format parity with
        the reference, local_rag_complete.py:583-597)."""
        lines = ["", "", "[Images in this section]:"]
        c["image_paths"] = []
        c["image_metadata"] = []
        for img in imgs:
            typ = (img.get("type") or "unknown").capitalize()
            lines.append(f"- {typ}: {img.get('description', '')}")
            c["image_paths"].append(img["image_path"])
            c["image_metadata"].append({
                "path": img["image_path"],
                "description": img.get("description", ""),
                "type": img.get("type", "unknown"),
            })
        c["text"] = c["text"] + "\n".join(lines) + "\n"
        c["has_images"] = True

    @classmethod
    def enrich_chunks_with_images(cls, chunks: List[Dict],
                                  images: List[Dict],
                                  mode: str = "document") -> List[Dict]:
        """Image->chunk association.

        ``mode="document"``: reference parity (enrich_chunks_with_images,
        local_rag_complete.py:558-605) — EVERY document image attaches to
        every chunk containing a visual keyword (all-or-nothing).

        ``mode="page"`` (the config default): an image attaches to the
        chunks whose source-page span [page_start, page_end] contains the
        image's page_number — proximity replaces the keyword heuristic
        (SURVEY.md section 7's 'implementation to discard'; VERDICT r3
        next #5). Chunks without page info (page_start absent/-1, e.g.
        non-paginated sources) fall back to keyword matching over all
        images, so nothing silently loses its figures.
        """
        if not images:
            for c in chunks:
                c["has_images"] = False
            return chunks
        out = []
        for chunk in chunks:
            c = dict(chunk)
            c["has_images"] = False
            if mode == "page":
                ps, pe = c.get("page_start", -1), c.get("page_end", -1)
                if ps >= 1:
                    near = [im for im in images
                            if ps <= im.get("page_number", 1) <= pe]
                    if near:
                        cls._attach_images(c, near)
                    out.append(c)
                    continue
                # no page info: keyword fallback over all images (below)
            lower = c["text"].lower()
            if any(k in lower for k in _VISUAL_KEYWORDS):
                cls._attach_images(c, images)
            out.append(c)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _assign_pages(chunks: List[Dict], page_lines: List[int]) -> None:
        """Map each chunk's source line span (chunker.py Section tracking)
        to 1-based page_start/page_end via the per-page first-line table
        (pdf.py document_to_markdown_pages)."""
        import bisect

        if not page_lines:
            page_lines = [0]
        for c in chunks:
            ls, le = c.get("line_start", -1), c.get("line_end", -1)
            if ls < 0:
                continue
            c["page_start"] = bisect.bisect_right(page_lines, ls)
            c["page_end"] = bisect.bisect_right(page_lines, max(le, ls))

    # ------------------------------------------------------------------
    def process_document(self, path: str | Path
                         ) -> Tuple[List[Dict], int, List[int]]:
        """-> (chunks, document_id, corpus_indexes).

        Reference: process_document (local_rag_complete.py:607-708).
        """
        path = Path(path)
        log.info("Processing %s", path)

        with self.timer.stage("to_markdown"):
            markdown, page_lines = document_to_markdown_pages(path)
        pages = max(1, len(page_lines))
        doc_id = self.store.add_document(path.name, total_pages=pages)

        with self.timer.stage("images"):
            raw_images = extract_pdf_images(path, self.config.images_dir,
                                            doc_id)
            images = self._analyze_images(raw_images, doc_id)

        with self.timer.stage("chunking"):
            doc_context = f"Document: {path.name}\n\n{markdown[:500]}"
            chunks = self.chunker.chunk(markdown, doc_context)
            self._assign_pages(chunks, page_lines)

        with self.timer.stage("enrich"):
            mode = getattr(self.config, "image_association", "page")
            if pages <= 1:
                # a single-page source has no proximity signal — the
                # keyword heuristic is strictly more informative there
                mode = "document"
            elif any(im.get("page_number", 0) < 1 for im in images):
                # the extractor could not resolve which page an image
                # lives on (minimal reader, unresolvable object graph):
                # proximity association would mis-attach, so degrade to
                # the reference's document-wide keyword mode
                mode = "document"
            chunks = self.enrich_chunks_with_images(chunks, images, mode)

        with self.timer.stage("persist"):
            corpus_indexes = self.store.add_chunks(doc_id, chunks)
            self.store.set_document_status(doc_id, "indexed")

        log.info(
            "Processed %s: %d pages, %d images, %d chunks\n%s",
            path.name, pages, len(images), len(chunks), self.timer.summary(),
        )
        return chunks, doc_id, corpus_indexes
