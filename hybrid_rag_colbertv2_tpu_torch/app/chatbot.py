"""RAG chatbot: retrieve -> context -> generate, with citations.

Port copy of ``hybrid_rag_colbertv2_tpu/app/chatbot.py``, its imports pointed at
the port's modules.

Behavioral parity with the reference ``RAGChatbot``
(local_rag_complete.py:1021-1104): numbered ``[Source i (heading) [Contains
N image(s)]]`` context blocks (:1069-1084), conversation history threaded
through generation (:1042-1058), source-citation formatting with 200-char
previews (:1086-1099), ``clear_history`` (:1101-1104). Generation is
optional here: with no LLM sidecar the chatbot still answers with the
retrieved sources (`generate=False`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..config import RAGConfig
from ..utils.logging import StageTimer, get_logger

log = get_logger(__name__)


class RAGChatbot:
    def __init__(self, config: RAGConfig, retriever, ollama_client=None):
        self.config = config
        self.retriever = retriever
        self.ollama = ollama_client
        self.conversation_history: List[Dict[str, str]] = []
        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def chat(self, query: str, generate: bool = True) -> Dict:
        with self.timer.stage("retrieve"):
            retrieved = self.retriever.retrieve(query)

        context = self._build_context(retrieved)

        # generate against history + the new turn, but only COMMIT both
        # turns after generation succeeds — a raising generate would
        # otherwise leave an orphan user message in the history, and each
        # retry would stack another, corrupting every later prompt
        response = ""
        if generate and self.ollama is not None:
            with self.timer.stage("generate"):
                response = self.ollama.chat(
                    messages=self.conversation_history
                    + [{"role": "user", "content": query}],
                    context=context)
        self.conversation_history.append({"role": "user", "content": query})
        self.conversation_history.append(
            {"role": "assistant", "content": response})

        return {
            "response": response,
            "sources": self._format_sources(retrieved),
            "retrieved_chunks": len(retrieved),
            "context": context,
            "timings": dict(self.timer.timings),
        }

    # ------------------------------------------------------------------
    @staticmethod
    def _build_context(chunks: List[Dict]) -> str:
        """Reference _build_context (local_rag_complete.py:1069-1084)."""
        parts = []
        for i, chunk in enumerate(chunks, 1):
            heading = (f" ({chunk['heading_path']})"
                       if chunk.get("heading_path") else "")
            image_info = ""
            meta = chunk.get("metadata", {}) or {}
            if chunk.get("has_images") and meta.get("image_paths"):
                image_info = f" [Contains {len(meta['image_paths'])} image(s)]"
            parts.append(
                f"[Source {i}{heading}{image_info}]\n{chunk.get('text', '')}\n")
        return "\n".join(parts)

    @staticmethod
    def _format_sources(chunks: List[Dict]) -> List[Dict]:
        """Reference _format_sources (local_rag_complete.py:1086-1099)."""
        return [
            {
                "source_id": i + 1,
                "chunk_id": chunk["chunk_id"],
                "document_id": chunk.get("document_id"),
                "heading": chunk.get("heading_path", ""),
                "score": chunk["score"],
                "has_images": chunk.get("has_images", False),
                "preview": (chunk.get("text", "")[:200] + "..."),
            }
            for i, chunk in enumerate(chunks)
        ]

    def clear_history(self) -> None:
        self.conversation_history = []
        log.info("Conversation history cleared")
