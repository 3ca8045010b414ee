"""Subword tokenizer for the ColBERT encoder + chunker token counting.

The reference uses two HF tokenizers downloaded from the hub: bert-base
-uncased for chunk token counting (local_rag_complete.py:245) and the
jina-colbert-v2 sentencepiece model inside sentence-transformers. This
environment has no network access, so the framework owns its tokenizer:

  * if a pretrained ``tokenizer.json`` (HF *fast* format) is available, load
    it — this is the path for real jina-colbert-v2 checkpoints;
  * otherwise TRAIN a byte-level BPE on the corpus being indexed (the HF
    ``tokenizers`` wheel trains fully offline) — the self-contained mode
    used by tests and local corpora;
  * a last-resort hash tokenizer keeps the framework importable even
    without the ``tokenizers`` wheel.

Special-token protocol (ColBERT): ``[Q]`` / ``[D]`` marker tokens right
after BOS; queries are [MASK]-padded to the fixed query length (query
augmentation); docs are <pad>-padded and masked.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

try:
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers, decoders
    HAVE_TOKENIZERS = True
except Exception:  # pragma: no cover
    HAVE_TOKENIZERS = False

SPECIAL_TOKENS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>", "[Q]", "[D]"]
BOS, PAD, EOS, UNK, MASK, QMARK, DMARK = range(7)


class ColBERTTokenizer:
    """Thin wrapper with the encoder's query/doc protocols baked in."""

    def __init__(self, tok=None, vocab_size: int = 0,
                 fold_numeric: bool = False):
        self._tok = tok
        self.vocab_size = vocab_size
        # numeric/unit canonicalization (utils/textfold.py): ON for
        # corpus-trained tokenizers (the self-contained encoder needs
        # slot values to match across surface forms), OFF for pretrained
        # checkpoints (their vocab/embeddings already carry it)
        self.fold_numeric = fold_numeric
        if tok is not None:
            # special ids as actually assigned by the loaded/trained model
            self.bos = tok.token_to_id("<s>")
            self.pad = tok.token_to_id("<pad>")
            self.eos = tok.token_to_id("</s>")
            self.mask = tok.token_to_id("<mask>")
            self.qmark = tok.token_to_id("[Q]")
            self.dmark = tok.token_to_id("[D]")
            for name, tid in [("<s>", self.bos), ("<pad>", self.pad),
                              ("</s>", self.eos), ("<mask>", self.mask)]:
                if tid is None:
                    raise ValueError(f"tokenizer missing special token {name}")
            # pretrained checkpoints name their markers differently: try
            # the known conventions before falling back to <mask> (official
            # BERT ColBERT uses [unused0/1]; some XLM-R ColBERTs add
            # explicit marker tokens)
            if self.qmark is None:
                for name in ("[QueryMarker]", "[unused0]", "[Q] "):
                    tid = tok.token_to_id(name)
                    if tid is not None:
                        self.qmark = tid
                        break
            if self.dmark is None:
                for name in ("[DocumentMarker]", "[unused1]", "[D] "):
                    tid = tok.token_to_id(name)
                    if tid is not None:
                        self.dmark = tid
                        break
            if self.qmark is None:
                self.qmark = self.mask
            if self.dmark is None:
                self.dmark = self.mask
        else:
            self.bos, self.pad, self.eos = BOS, PAD, EOS
            self.mask, self.qmark, self.dmark = MASK, QMARK, DMARK

    # ------------------------------------------------------------------
    @classmethod
    def train_bpe(cls, corpus: Sequence[str], vocab_size: int = 8192,
                  fold_numeric: bool = False) -> "ColBERTTokenizer":
        """Train a byte-level BPE on the corpus (fully offline).

        ``fold_numeric``: canonicalize number words / unit variants
        (utils/textfold.py) in the training corpus AND at every later
        encode — persisted with the tokenizer so doc and query sides
        always agree."""
        if not HAVE_TOKENIZERS:
            return HashTokenizer(vocab_size)
        if fold_numeric:
            from ..utils.textfold import fold_text
            corpus = [fold_text(t) for t in corpus]
        tok = Tokenizer(models.BPE(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
        tok.decoder = decoders.ByteLevel()
        trainer = trainers.BpeTrainer(
            vocab_size=vocab_size,
            special_tokens=SPECIAL_TOKENS,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False,
        )
        tok.train_from_iterator(iter(corpus), trainer=trainer)
        return cls(tok, tok.get_vocab_size(), fold_numeric=fold_numeric)

    @classmethod
    def load(cls, path: str | Path) -> "ColBERTTokenizer":
        # a HashTokenizer session may have persisted its stub here; it
        # must load back as a HashTokenizer (same ids) in EVERY session —
        # with or without the tokenizers wheel — or the app built with it
        # is permanently unusable
        try:
            import json as _json

            head = _json.loads(Path(path).read_text())
            if isinstance(head, dict) and head.get("type") == "hash":
                return HashTokenizer(head.get("vocab_size", 8192))
            # fold-flag wrapper around a standard HF tokenizer.json (the
            # HF loader rejects unknown top-level keys, so the flag rides
            # in a wrapper; bare pretrained tokenizer.json files load
            # below with folding OFF)
            if isinstance(head, dict) and head.get("type") == "folded_bpe":
                if not HAVE_TOKENIZERS:
                    raise RuntimeError("tokenizers wheel unavailable")
                tok = Tokenizer.from_str(_json.dumps(head["hf"]))
                return cls(tok, tok.get_vocab_size(),
                           fold_numeric=bool(head.get("fold_numeric", True)))
        except (KeyError, RuntimeError):
            raise
        except Exception:
            pass
        if not HAVE_TOKENIZERS:
            raise RuntimeError("tokenizers wheel unavailable")
        tok = Tokenizer.from_file(str(path))
        return cls(tok, tok.get_vocab_size())

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        if self.fold_numeric:
            import json as _json

            Path(path).write_text(_json.dumps({
                "type": "folded_bpe", "fold_numeric": True,
                "hf": _json.loads(self._tok.to_str())}))
        else:
            self._tok.save(str(path))

    # ------------------------------------------------------------------
    def _ids(self, text: str) -> List[int]:
        if self.fold_numeric:
            from ..utils.textfold import fold_text
            text = fold_text(text)
        return self._tok.encode(text).ids

    def count_tokens(self, text: str) -> int:
        """Subword token count (chunker budget, reference
        local_rag_complete.py:463-465)."""
        return len(self._ids(text))

    def encode_query(self, text: str, max_len: int) -> np.ndarray:
        """[BOS] [Q] tokens [EOS], then [MASK]-augmented to max_len."""
        ids = [self.bos, self.qmark] + self._ids(text)[: max_len - 3] + [self.eos]
        out = np.full((max_len,), self.mask, np.int32)
        out[: len(ids)] = ids
        return out

    def encode_doc(self, text: str, max_len: int):
        """[BOS] [D] tokens [EOS], <pad>-padded. -> (ids (max_len,), n)."""
        ids = [self.bos, self.dmark] + self._ids(text)[: max_len - 3] + [self.eos]
        out = np.full((max_len,), self.pad, np.int32)
        out[: len(ids)] = ids
        return out, len(ids)

    def encode_docs(self, texts: Sequence[str], max_len: int):
        """Batch encode_doc -> (ids (B, max_len) int32, lengths (B,) int32).

        Host tokenization is the corpus-indexing bottleneck on natural
        text (~1.1k docs/s single-threaded vs ~5.7k docs/s device encode,
        measured). The HF tokenizers wheel's ``encode_batch`` fans out
        across host cores (rayon) — a real win on multi-core TPU VMs; on
        tiny hosts (<4 cores) the rayon overhead loses ~20%, so fall back
        to the sequential loop there.
        """
        import os

        if self.fold_numeric:
            from ..utils.textfold import fold_text
            texts = [fold_text(t) for t in texts]
        if self._tok is not None and (os.cpu_count() or 1) >= 4:
            id_lists = [e.ids for e in self._tok.encode_batch(list(texts))]
        else:
            id_lists = [self._ids(t) for t in texts]
        out = np.full((len(texts), max_len), self.pad, np.int32)
        lens = np.zeros((len(texts),), np.int32)
        for i, ids in enumerate(id_lists):
            row = [self.bos, self.dmark] + ids[: max_len - 3] + [self.eos]
            out[i, : len(row)] = row
            lens[i] = len(row)
        return out, lens


class HashTokenizer(ColBERTTokenizer):
    """Deterministic hash-bucket tokenizer — emergency fallback only."""

    def __init__(self, vocab_size: int = 8192):
        super().__init__(None, vocab_size)
        self._n_special = len(SPECIAL_TOKENS)

    def _ids(self, text: str) -> List[int]:
        out = []
        for w in text.lower().split():
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            out.append(self._n_special
                       + h % (self.vocab_size - self._n_special))
        return out

    def count_tokens(self, text: str) -> int:
        return len(text.split())

    def save(self, path) -> None:  # nothing to persist
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text('{"type": "hash", "vocab_size": %d}'
                              % self.vocab_size)
