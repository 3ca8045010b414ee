"""Ollama HTTP client — generation sidecar (host-side, off the device path).

Behavioral parity with the reference ``OllamaClient``
(local_rag_complete.py:132-233): blocking POST /api/generate with the same
payload shape and timeout; ``analyze_image`` sends the same structured
TYPE/DESCRIPTION/TEXT LLaVA prompt (:178-186) and parses the same response
lines (:194-208); ``chat`` builds the same context-stuffed system prompt
and role-prefixed flattened history (:211-233). Generation stays a host
HTTP call because it is outside the retrieval hot path (SURVEY.md #3).

Differences: errors raise or return a structured failure rather than
print-and-return-"" (:161-167), and there is a bounded retry.

Port copy of ``hybrid_rag_colbertv2_tpu/app/ollama.py`` on the standard
library's ``urllib.request`` in place of ``requests``: the same paths,
JSON payloads, timeouts and retries, the same parsed responses.
"""

from __future__ import annotations

import base64
import json
import urllib.request
from typing import Dict, List, Optional

from ..config import RAGConfig
from ..utils.logging import get_logger

log = get_logger(__name__)

_IMAGE_PROMPT = """Analyze this image and provide:
1. TYPE: What type of visual is this? (diagram, chart, table, screenshot, photo, etc.)
2. DESCRIPTION: A detailed description of what the image shows (2-3 sentences)
3. TEXT: Any visible text in the image (transcribe exactly)

Format your response as:
TYPE: [type]
DESCRIPTION: [description]
TEXT: [extracted text]"""


def _post_json(url: str, payload: Dict, timeout: float) -> Dict:
    """POST ``payload`` as JSON; the decoded JSON reply. A status of 400
    or more raises (``urllib.error.HTTPError``)."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class OllamaClient:
    def __init__(self, config: RAGConfig, retries: int = 1):
        self.config = config
        self.base_url = config.ollama_url.rstrip("/")
        self.timeout = config.ollama_timeout_s
        self.retries = retries

    # ------------------------------------------------------------------
    def is_alive(self) -> bool:
        """Health probe (reference check_ollama, local_rag_complete.py:1133)."""
        try:
            with urllib.request.urlopen(f"{self.base_url}/api/tags",
                                        timeout=5) as r:
                return r.status == 200
        except Exception:
            return False

    def generate(
        self,
        model: str,
        prompt: str,
        system: Optional[str] = None,
        images: Optional[List[str]] = None,
    ) -> str:
        payload: Dict = {"model": model, "prompt": prompt, "stream": False}
        if system:
            payload["system"] = system
        if images:
            payload["images"] = images
        last_err: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                return _post_json(f"{self.base_url}/api/generate", payload,
                                  self.timeout)["response"]
            except Exception as e:
                last_err = e
                log.warning("Ollama generate failed (attempt %d): %s",
                            attempt + 1, e)
        raise RuntimeError(f"Ollama generation failed: {last_err}")

    # ------------------------------------------------------------------
    def analyze_image(self, image_path: str) -> Dict[str, str]:
        with open(image_path, "rb") as f:
            image_data = base64.b64encode(f.read()).decode("utf-8")
        response = self.generate(
            model=self.config.vision_model,
            prompt=_IMAGE_PROMPT,
            images=[image_data],
        )
        result = {"description": "", "type": "unknown", "ocr_text": ""}
        for line in response.split("\n"):
            if line.startswith("TYPE:"):
                result["type"] = line[len("TYPE:"):].strip().lower()
            elif line.startswith("DESCRIPTION:"):
                result["description"] = line[len("DESCRIPTION:"):].strip()
            elif line.startswith("TEXT:"):
                result["ocr_text"] = line[len("TEXT:"):].strip()
        return result

    # ------------------------------------------------------------------
    def chat(self, messages: List[Dict[str, str]],
             context: Optional[str] = None) -> str:
        system_msg = "You are a helpful AI assistant."
        if context:
            system_msg += (
                f"\n\nContext from documents:\n{context}\n\n"
                "Use this context to answer questions accurately."
            )
        prompt = "\n".join(f"{m['role']}: {m['content']}" for m in messages)
        return self.generate(model=self.config.chat_model, prompt=prompt,
                             system=system_msg)
