"""Markdown-aware semantic chunker.

Port copy of ``hybrid_rag_colbertv2_tpu/ingest/chunker.py``, its imports pointed at
the port's modules.

Behavioral parity with the reference's ``MarkdownSemanticChunker``
(local_rag_complete.py:240-465) unified with its standalone twin
(markdown_chunking_strategy.py:26-355), which adds overlap metadata and a
"level-1 headings always stand alone" rule. Contract preserved:

  * parse the heading hierarchy into sections carrying ``parent_path`` /
    ``full_path`` breadcrumbs (heading stack, :254-302);
  * sections over ``max_tokens`` split at paragraph boundaries, each part
    re-carrying the heading + parent context (:371-414);
  * sections in [min, max] become standalone chunks; smaller ones
    accumulate until the budget is hit (:304-369);
  * a final pass merges still-undersized neighbors (:416-446);
  * chunk text is rendered as ``[Context: parent path]`` + ``## heading`` +
    content (:448-461);
  * optional overlap: a tail preview of the previous chunk stored in
    metadata (markdown_chunking_strategy.py:314-333 — metadata only, never
    concatenated into indexed text).

Differences (deliberate): token counting goes through ONE injected counter
(the framework tokenizer) with an internal cache — the reference re-runs a
HF tokenizer on every merge candidate (its chunking hot loop, SURVEY.md
call stack 3.1); and the reference's unused ``chunk_overlap`` config field
actually works here.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

_HEADING_RE = re.compile(r"^(#{1,6})\s+(.+?)\s*$")
_PARA_SPLIT_RE = re.compile(r"\n\n+")


@dataclass
class ChunkerConfig:
    min_tokens: int = 256
    max_tokens: int = 1024
    overlap_tokens: int = 0           # 0 disables overlap metadata
    level1_standalone: bool = False   # standalone-variant rule (:142)


@dataclass
class Section:
    level: int
    title: str
    content: str
    parent_path: str
    full_path: str
    # source line span (0-based, inclusive) in the parsed markdown —
    # carried into chunk dicts so the processor can map chunks to source
    # PAGES for proximity-based image association (VERDICT r3 next #5;
    # the reference has no notion of where a chunk came from)
    line_start: int = -1
    line_end: int = -1


def _default_counter(text: str) -> int:
    return len(text.split())


class MarkdownChunker:
    """Structure-aware chunking of markdown text."""

    def __init__(
        self,
        config: Optional[ChunkerConfig] = None,
        count_tokens: Optional[Callable[[str], int]] = None,
    ):
        self.cfg = config or ChunkerConfig()
        self._raw_count = count_tokens or _default_counter
        self._cache: Dict[str, int] = {}

    # the cache keeps every counted string alive (sections, split/merge
    # candidates), so an app-lifetime chunker would grow with cumulative
    # corpus size — bound it; within one document re-counts dominate, so
    # a flush between documents costs almost nothing
    _CACHE_MAX = 65536

    # ------------------------------------------------------------------
    def _count(self, text: str) -> int:
        # keyed on the string itself (not hash(text)): a hash collision
        # would silently return a wrong token count
        n = self._cache.get(text)
        if n is None:
            if len(self._cache) >= self._CACHE_MAX:
                self._cache.clear()
            n = self._raw_count(text)
            self._cache[text] = n
        return n

    # ------------------------------------------------------------------
    def parse_sections(self, text: str) -> List[Section]:
        """Heading-stack parse; leading text before any heading becomes an
        'Introduction' level-0 section (reference :288-295)."""
        sections: List[Section] = []
        stack: List[tuple] = []       # (level, title)
        cur: Optional[Section] = None

        def flush():
            nonlocal cur
            if cur is not None:
                sections.append(cur)
                cur = None

        for li, line in enumerate(text.split("\n")):
            m = _HEADING_RE.match(line)
            if m:
                flush()
                level = len(m.group(1))
                title = m.group(2)
                while stack and stack[-1][0] >= level:
                    stack.pop()
                parent = " > ".join(t for _, t in stack)
                stack.append((level, title))
                full = " > ".join(t for _, t in stack)
                cur = Section(level, title, "", parent, full,
                              line_start=li, line_end=li)
            elif cur is not None:
                cur.content += line + "\n"
                cur.line_end = li
            else:
                if sections and sections[-1].level == 0:
                    sections[-1].content += line + "\n"
                    sections[-1].line_end = li
                else:
                    sections.append(
                        Section(0, "Introduction", line + "\n", "",
                                "Introduction", line_start=li, line_end=li))
        flush()
        return sections

    # ------------------------------------------------------------------
    def render_section(self, s: Section) -> str:
        """[Context: parent] + heading + content (reference :448-461)."""
        parts = []
        if s.parent_path:
            parts.append(f"[Context: {s.parent_path}]")
        if s.title and s.title != "Introduction":
            parts.append(f"{'#' * max(s.level, 1)} {s.title}")
        parts.append(s.content.strip())
        return "\n\n".join(p for p in parts if p)

    # ------------------------------------------------------------------
    def _split_large(self, s: Section, doc_context: str) -> List[Dict]:
        """Paragraph-boundary split with re-carried heading context
        (reference :371-414)."""
        head = f"# {s.title}\n\n"
        ctx = f"Context: {s.parent_path}\n\n" if s.parent_path else ""
        prefix = head + ctx
        span = dict(line_start=s.line_start, line_end=s.line_end)
        out: List[Dict] = []
        buf = prefix
        buf_tokens = self._count(buf)
        paragraphs: List[str] = []
        for para in _PARA_SPLIT_RE.split(s.content.strip()):
            # a single paragraph larger than the budget gets hard-split at
            # word boundaries (the reference leaks oversized chunks here —
            # its paragraph split is the only mechanism, :376-414)
            if self._count(para) > self.cfg.max_tokens:
                words = para.split()
                step = max(self.cfg.max_tokens // 2, 16)
                for i in range(0, len(words), step):
                    paragraphs.append(" ".join(words[i : i + step]))
            else:
                paragraphs.append(para)
        for para in paragraphs:
            ptok = self._count(para)
            if buf_tokens + ptok <= self.cfg.max_tokens:
                buf += para + "\n\n"
                buf_tokens += ptok
            else:
                if buf.strip() != prefix.strip():
                    out.append(self._mk(buf.strip(), s.full_path, s.level,
                                        buf_tokens, doc_context,
                                        "split_section", part=len(out) + 1,
                                        **span))
                buf = prefix + para + "\n\n"
                buf_tokens = self._count(buf)
        if buf.strip():
            out.append(self._mk(buf.strip(), s.full_path, s.level,
                                buf_tokens, doc_context, "split_section",
                                part=len(out) + 1, **span))
        return out

    @staticmethod
    def _mk(text, heading_path, level, tokens, doc_context, kind, **extra):
        d = dict(text=text, heading_path=heading_path, level=level,
                 token_count=tokens, doc_context=doc_context, type=kind)
        d.update(extra)
        return d

    # ------------------------------------------------------------------
    def _assemble(self, sections: List[Section], doc_context: str
                  ) -> List[Dict]:
        """Standalone / accumulate / split decisions (reference :304-369)."""
        chunks: List[Dict] = []
        acc: Optional[Dict] = None

        def flush_acc():
            nonlocal acc
            if acc is not None:
                chunks.append(acc)
                acc = None

        for s in sections:
            text = self.render_section(s)
            ntok = self._count(text)
            standalone = (
                ntok >= self.cfg.min_tokens
                or (self.cfg.level1_standalone and s.level == 1)
            )
            if ntok > self.cfg.max_tokens:
                flush_acc()
                chunks.extend(self._split_large(s, doc_context))
            elif standalone:
                flush_acc()
                chunks.append(self._mk(text, s.full_path, s.level, ntok,
                                       doc_context, "section",
                                       line_start=s.line_start,
                                       line_end=s.line_end))
            else:
                if acc is None:
                    acc = self._mk(text, s.parent_path or s.title, s.level,
                                   ntok, doc_context, "accumulated",
                                   sections=[s.title],
                                   line_start=s.line_start,
                                   line_end=s.line_end)
                else:
                    combined = acc["text"] + "\n\n" + text
                    ctok = self._count(combined)
                    if ctok <= self.cfg.max_tokens:
                        acc["text"] = combined
                        acc["token_count"] = ctok
                        acc["sections"].append(s.title)
                        acc["line_end"] = max(acc["line_end"], s.line_end)
                    else:
                        flush_acc()
                        acc = self._mk(text, s.parent_path or s.title,
                                       s.level, ntok, doc_context,
                                       "accumulated", sections=[s.title],
                                       line_start=s.line_start,
                                       line_end=s.line_end)
        flush_acc()
        return chunks

    # ------------------------------------------------------------------
    def _merge_small(self, chunks: List[Dict]) -> List[Dict]:
        """Forward-merge undersized chunks (reference :416-446)."""
        out: List[Dict] = []
        i = 0
        while i < len(chunks):
            c = chunks[i]
            if (c["token_count"] < self.cfg.min_tokens
                    and i + 1 < len(chunks)):
                combined = c["text"] + "\n\n" + chunks[i + 1]["text"]
                ctok = self._count(combined)
                if ctok <= self.cfg.max_tokens:
                    nxt = chunks[i + 1]
                    out.append(self._mk(
                        combined, c["heading_path"], c.get("level", 0),
                        ctok, c["doc_context"], "merged",
                        line_start=c.get("line_start", -1),
                        line_end=max(c.get("line_end", -1),
                                     nxt.get("line_end", -1))))
                    i += 2
                    continue
            out.append(c)
            i += 1
        return out

    def _add_overlap(self, chunks: List[Dict]) -> List[Dict]:
        """Overlap as metadata preview of the previous chunk's tail
        (standalone-variant behavior, markdown_chunking_strategy.py:314-333)."""
        if self.cfg.overlap_tokens <= 0:
            return chunks
        for i in range(1, len(chunks)):
            prev_words = chunks[i - 1]["text"].split()
            tail = " ".join(prev_words[-self.cfg.overlap_tokens:])
            chunks[i]["overlap_preview"] = tail
        return chunks

    # ------------------------------------------------------------------
    def chunk(self, markdown_text: str, doc_context: str = "") -> List[Dict]:
        """markdown -> list of chunk dicts (text, heading_path, level,
        token_count, doc_context, type[, part, sections, overlap_preview])."""
        if not markdown_text.strip():
            return []
        sections = self.parse_sections(markdown_text)
        sections = [s for s in sections if s.content.strip() or s.title]
        chunks = self._assemble(sections, doc_context)
        chunks = [c for c in chunks if c["text"].strip()]
        chunks = self._merge_small(chunks)
        return self._add_overlap(chunks)
