"""Runtime configuration (copy of ``hybrid_rag_colbertv2_tpu/config.py``).

The PyTorch port keeps its own copy so it imports nothing of the JAX
package; only ``MeshConfig.resolve_index_dtype`` differs (it reads the
card's memory through torch instead of JAX). Field names, defaults and
the JSON format are the JAX package's, so configs load in either.

TPU-native replacement for the reference's flat ``RAGConfig`` dataclass
(local_rag_complete.py:56-86). Behavioral parity: same retrieval depths
(bm25_top_k=100, colbert_top_k=100, fusion -> 50 candidates, final_top_k=10,
RRF k=60), same chunking bounds (min 256 / max 1024 tokens, overlap 128),
same model-name / path / Ollama knobs. The reference's single ``device``
string (mps-or-cpu, local_rag_complete.py:86) is replaced by ``MeshConfig``:
a device-mesh + sharding + dtype/quantization spec.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple


@dataclass
class MeshConfig:
    """Device mesh / sharding / numerics spec (new in the TPU build).

    The dense index's document axis is sharded over the ``data`` mesh axis
    (SURVEY.md section 5: 'index sharding across ICI ... per-shard top-k +
    allgather-of-candidates before fusion').
    """

    # Mesh shape: (data/doc-shard axis, model/tensor axis). ``None`` -> use
    # all visible devices on the doc axis.
    mesh_shape: Optional[Tuple[int, int]] = None
    axis_names: Tuple[str, str] = ("data", "model")

    # Numerics for the dense index + scoring kernels.
    # "int8": per-token-row scales (default). "int8-doc": per-document
    # scales — ~2x faster exact scan, slightly coarser quantization
    # (ops/maxsim.py). "int4-doc": nibble-packed 4-bit + per-document
    # scales — HALF the HBM of int8 (2x chunks per chip) and half the
    # candidate-gather bytes; coarsest quantization, measured recall in
    # docs/performance.md. Also "bfloat16" | "float32", and "auto" —
    # int8 unless the projected index exceeds the per-device HBM comfort
    # margin, then int4-doc (resolve_index_dtype; resolved at build
    # time and persisted with the index).
    index_dtype: str = "int8"
    compute_dtype: str = "bfloat16"    # kernel accumulate is always fp32
    # Padding buckets for document token counts (static XLA shapes).
    doc_token_buckets: Tuple[int, ...] = (64, 128, 256)
    # "single": one padded index at the smallest covering bucket.
    # "bucketed": one sub-index per length bucket (index/bucketed.py) —
    # smaller HBM + faster scans on mixed-length corpora.
    index_layout: str = "single"
    # Shard the BM25 postings CSR on the doc axis too (flat layout;
    # LexicalIndex.shard_postings + the sharded cascade's allgather
    # merge). Default False: replicating the CSR is exact and avoids a
    # collective at single-host scale; enable at pod scale where the
    # postings no longer fit comfortably per chip — HBM and scan cost
    # divide by the shard count.
    shard_bm25: bool = False

    def resolved_mesh_shape(self, n_devices: int) -> Tuple[int, int]:
        if self.mesh_shape is not None:
            return self.mesh_shape
        return (n_devices, 1)

    def resolve_index_dtype(self, n_docs: int, doc_len: int,
                            dim: int = 128,
                            n_devices: Optional[int] = None,
                            device=None) -> str:
        """Resolve ``index_dtype="auto"`` by projected device residency.

        "int8" when the int8 index (embeddings + per-row scales +
        lengths) fits under 80% of the card's total memory per shard
        (``torch.cuda.mem_get_info``; the same margin as the JAX
        package's ``utils/profiling.py::index_capacity_estimate``), else
        the nibble-packed "int4-doc" (half the bytes). The shards are
        the DOC-axis extent of the mesh the app will serve on, as in
        JAX: ``dp`` of ``resolved_mesh_shape`` over the visible cards
        (``parallel/mesh.py::visible_devices``). A CPU ``device``
        resolves to "int8" so behavior is deterministic in tests.
        Concrete dtypes pass through unchanged.
        """
        if self.index_dtype != "auto":
            return self.index_dtype
        import torch

        device = torch.device("cuda" if device is None else device)
        if device.type != "cuda":
            return "int8"
        if n_devices is None:
            from .parallel import mesh as _mesh

            # one shard where no card is visible to count
            cards = (_mesh.visible_devices(device)
                     if torch.cuda.is_available() else [device])
            n_devices = max(1, self.resolved_mesh_shape(len(cards))[0])
        n = max(n_docs, 1)
        total = n * doc_len * dim + n * doc_len * 4 + n * 4
        _, limit = torch.cuda.mem_get_info(device)
        return "int8" if total / n_devices < limit * 0.8 else "int4-doc"


@dataclass
class RAGConfig:
    """Flat runtime config — parity with reference RAGConfig
    (local_rag_complete.py:56-86) plus TPU-specific fields."""

    # Database (reference: db_path, local_rag_complete.py:60)
    db_path: str = "rag_local.db"

    # Chunking (local_rag_complete.py:63-65)
    min_chunk_size: int = 256
    max_chunk_size: int = 1024
    chunk_overlap: int = 128
    # Level-1 headings always become standalone chunks — the documented
    # behavior of the reference's standalone chunker variant
    # (markdown_chunking_strategy.py:142); exposed here so the app-level
    # pipeline applies it by default instead of silently dropping it.
    chunk_level1_standalone: bool = True
    # Image->chunk association (ingest/processor.py). "page" (default):
    # images attach to the chunks whose source-page span contains the
    # image's page — proximity is the signal (SURVEY.md section 7 lists
    # the reference's all-or-nothing heuristic as implementation to
    # discard). "document": reference parity — EVERY document image
    # attaches to every chunk containing a visual keyword
    # (local_rag_complete.py:558-605), kept for parity audits.
    image_association: str = "page"

    # Retrieval (local_rag_complete.py:68-70; candidate depth of 50 is
    # hard-coded at local_rag_complete.py:916 — here it's a config field)
    bm25_top_k: int = 100
    colbert_top_k: int = 100
    fusion_candidates: int = 50
    final_top_k: int = 10
    rrf_k: int = 60  # reference hard-codes k=60 (local_rag_complete.py:964)
    # Final top-k ordering: "rerank" = exact MaxSim alone (reference
    # parity, local_rag_complete.py:928); "rrf" = fuse the rerank ranking
    # with the candidate-RRF ranking — keeps lexical evidence in the final
    # cut, hedging dense-rerank misses (measured on the 90-chunk real-text
    # corpus: hit@10 0.906 -> see docs/performance.md); "union" =
    # guaranteed-floor ordering — the final top-k provably contains
    # BM25's top-m_b AND dense's top-m_d, where the k-slot floor budget
    # splits by fusion_weight_bm25 (w=0.5 -> symmetric k/2 each; w=0.9,
    # k=10 -> 9+1; ops/fusion.union_floor_split has the measurement),
    # making "hybrid >= max(leg)@floor" structural
    # (ops/fusion.final_topk_select). Reported scores stay exact-MaxSim
    # in every mode. "auto" (default): the APPLICATION decides by a
    # measured gate — it evaluates a (mode, leg-weight) menu on held-out
    # pseudo-queries over the indexed corpus and picks per the minimax-
    # regret rule documented in retrieval/gate.py. Components used
    # standalone (a bare HybridRetriever) treat an unresolved "auto" as
    # "rerank".
    final_fusion: str = "auto"
    # Calibrated-hybrid leg weight for the candidate RRF (and, in
    # final_fusion="rrf", the final blend): 0.5 = the reference's
    # unweighted RRF (parity). The "auto" gate searches a small menu and
    # raises this when the measured dense leg is weak — a BM25-lean
    # hybrid can then never lose to its own lexical leg while the dense
    # leg still breaks ties and rescues queries BM25 misses.
    fusion_weight_bm25: float = 0.5
    # True = the user pinned fusion_weight_bm25 explicitly (CLI
    # --fusion-weight-bm25); the "auto" gate then only decides the final
    # ORDERING mode and never overrides the pinned weight.
    fusion_weight_pinned: bool = False
    # >0: two-stage pruned dense search (ops/prefilter.py) — pooled-cosine
    # prefilter to this many candidates, exact MaxSim only on those.
    # 0 = brute-force full MaxSim scan (exact). Rule of thumb: 8-16x the
    # dense top-k (colbert_top_k) keeps recall ~1.0 while cutting the dense
    # stage's HBM traffic by ~doc_len. DEFAULT IS THE PRODUCTION CASCADE
    # (the benched path): at corpora <= this value the prefilter covers
    # every document, so the search degenerates to the exact scan — small
    # corpora lose nothing, large ones get the fast path out of the box.
    # Measured quality-neutral on real text: agreement@10 = 1.0 vs the
    # exact cascade (bench.py real-data eval).
    dense_prefilter: int = 1024
    # >0: truncate each term's postings to its N highest-weight entries at
    # build time (idf from true df). The device BM25 scan is
    # O(B*Q*max_postings); common low-idf terms otherwise dominate it at
    # large corpus scale. 0 = exact. Exact whenever every term's document
    # frequency <= the cap (always true for small corpora).
    bm25_postings_cap: int = 512
    # Per-element recall target for candidate top-k selection
    # (jax.lax.approx_max_k — 30x faster than full top_k at (8, 1M) on
    # TPU). Applies only when k <= n/8; exact fp32 rerank always follows,
    # so final recall@10 is unaffected (measured 1.000). 1.0 = exact top_k
    # everywhere.
    approx_topk_recall: float = 0.95

    # Models (local_rag_complete.py:73-75)
    chat_model: str = "llama3.2:3b"
    vision_model: str = "llava:7b"
    embedding_model: str = "jinaai/jina-colbert-v2"

    # Ollama / generation sidecar (local_rag_complete.py:78)
    ollama_url: str = "http://localhost:11434"
    ollama_timeout_s: float = 120.0

    # Paths (local_rag_complete.py:81-83)
    bm25_index_path: str = "indexes/bm25"
    colbert_index_path: str = "indexes/colbert"
    images_dir: str = "extracted_images"
    tokenizer_path: str = "indexes/tokenizer.json"

    # Encoder limits (ColBERT-style: fixed query length w/ augmentation).
    query_max_tokens: int = 32
    doc_max_tokens: int = 256
    # BM25 query term slots. The lexical stage costs
    # O(B * query_max_terms * max_postings) regardless of how many terms a
    # query actually has — keep this at the realistic ceiling, not the
    # worst case (the index-side default is 64).
    query_max_terms: int = 32
    # Static width menu for the BM25 term axis: per batch the dispatch
    # width rounds DOWN to the smallest bucket covering the real term
    # count (pack_query_batch). Typical queries carry ~4-10 terms, so the
    # 8-wide program runs a 4x smaller lexical sort than the 32 ceiling;
    # -1 padding is inert, so results are identical across widths. One
    # compile per used width. Empty tuple = always query_max_terms.
    query_term_buckets: Tuple[int, ...] = (8, 16, 32)

    # Encoder selection: "tiny" | "small" | "base" | "jina-colbert-v2". With
    # ``encoder_checkpoint`` pointing at a local HF checkpoint dir, weights
    # are converted (models/convert.py); otherwise deterministic random
    # init (self-contained mode) persisted alongside the index.
    encoder_preset: str = "small"
    encoder_checkpoint: Optional[str] = None
    # Encoder activation dtype: "bfloat16" ~doubles MXU throughput for the
    # corpus-encoding hot loop; embeddings are L2-normalized so retrieval
    # quality is insensitive. "float32" = reference-exact numerics.
    encoder_dtype: str = "float32"
    encoder_seed: int = 0
    tokenizer_vocab_size: int = 8192
    # Contrastive ICT training of the (random-init) encoder at index time
    # (train/). -1 = AUTO (default): a fresh index with no checkpoint and
    # no previously-trained encoder trains a bounded number of steps
    # (min(300, encoder_max_epochs); VERDICT r3 weak #2 — an untrained
    # random-init dense leg's only signal is shared-token overlap, and
    # shipping that by default misrepresents the framework's quality).
    # Auto-training runs ONCE per index (a marker persists next to the
    # encoder); incremental uploads reuse the trained weights. 0 =
    # explicitly off; >0 = always train this many steps (epoch-capped).
    # Ignored when a checkpoint is provided.
    encoder_train_steps: int = -1
    # BM25-mined hard negatives per training pair (train/data.py::
    # mine_hard_negatives). The cascade's final top-k is a dense rerank
    # over BM25-surfaced candidates, so the encoder must out-rank exactly
    # the chunks BM25 confuses with the source; in-batch-only negatives
    # (0) never show it those.
    encoder_hard_negatives: int = 4
    # ICT training-query word dropout: non-verbatim training queries teach
    # ranking under partial lexical overlap (the paraphrase-query regime).
    # Applied only when the corpus has >= 16 chunks — on tiny corpora the
    # lexical prior is the whole signal and noisy spans destabilize the
    # few-batch training (see encoder_max_epochs note).
    encoder_word_dropout: float = 0.15
    # Synonym-substitution probability for the synonym-augmented share of
    # ICT training pairs (train/lexicon.py): the query says "60"/"rapid"
    # while the chunk says "sixty"/"fast", teaching the encoder the
    # synonym invariance a pretrained checkpoint has built in — the
    # regime the lexically-adversarial eval measures. 0 disables the
    # augmented pairs entirely. Gated on >= 16 chunks like word dropout.
    # 0.7 measured best on the r4 sweep (dense-only adversarial 0.45 vs
    # 0.42 at 0.5, 491 chunks / 1800 steps).
    encoder_synonym_prob: float = 0.7
    # Synonym-augmented pairs per chunk (the share drawn with
    # encoder_synonym_prob substitution and 4-14-word spans). More pairs
    # = more substitution rolls per chunk (coverage of the lexicon's
    # alternatives) AND a higher encoder_max_epochs step ceiling (the cap
    # scales with the pair count). Gated on >= 16 chunks like the prob.
    # 8 measured over 4 on the r4 bench corpus (491 chunks, 1800 steps,
    # seed 0): dense-only adversarial 0.57 vs 0.44, dense-only ICT 0.695
    # vs 0.63 (above BM25-only's 0.617), and the measured gate moves from
    # (rrf, 0.75) to (rrf, 0.5) — the dense leg earns equal weight.
    encoder_synonym_pairs: int = 8
    # Compositional-rewording pairs per chunk (train/data.py::
    # reworded_query_pairs): long/two-span shuffled bag-of-content-word
    # queries with rarity-aware dropout of corpus-common (sentence-frame)
    # words. This is the training half of the round-5 paraphrase fix —
    # the template paraphrase slice's dense failures are sibling-chunk
    # confusion (shared frames, rare slot words) which verbatim/dropout
    # spans never teach; these queries force ranking by the surviving
    # rare anchors under full word-order invariance. Gated on >= 16
    # chunks like the other augmentations.
    encoder_reworded_pairs: int = 6
    # Interrogative-framed reworded pairs per chunk (train/data.py::
    # question_query_pairs): the reworded queries above wrapped in
    # question scaffolding ("how does ... ?"). Real user queries are
    # questions, and the hand-written-questions eval slice
    # (tools/organic_questions.py) measured the self-trained encoder's
    # dense-only hit@10 at 0.275 vs BM25's 0.500 — a query-token
    # DISTRIBUTION mismatch a 4-layer backbone is sensitive to. Gated on
    # >= 16 chunks like the other augmentations.
    encoder_question_pairs: int = 0
    # Total gate calibration queries, split evenly over the gate's query
    # regimes (retrieval/gate.py resolve_final_fusion; 5 regimes -> 32
    # queries per regime at the default). Small corpora bound each
    # regime at one query per chunk regardless.
    gate_queries: int = 160
    # Epoch ceiling on encoder_train_steps: overtraining tiny corpora
    # collapses the representation into per-batch clusters and destroys
    # the fresh encoder's lexical prior (measured in app/application.py
    # _train_encoder; 6 is the safe point for in-batch-only training).
    encoder_max_epochs: int = 6
    # Peak LR for index-time encoder training. 0 = auto by preset depth:
    # 3e-4 for tiny/small, 1e-4 for base and larger (the 8L base preset
    # diverges at 3e-4 — loss flat at ln(16) with acc 0, measured on the
    # r4 sweep — while small trains fine there).
    encoder_learning_rate: float = 0.0
    # Synonym-embedding tie regularizer weight (train/trainer.py
    # TrainConfig.tie_weight). The synonym-tied init makes lexicon
    # (key, synonym) embedding rows EQUAL at step 0, but contrastive
    # updates drift them apart (each row only sees gradient from batches
    # its own word appears in); this keeps them close for the whole run.
    # 0 disables. Only meaningful with encoder_synonym_prob > 0.
    encoder_tie_weight: float = 0.0
    # Lexical-anchor gate init for self-contained (non-checkpoint)
    # encoders (models/colbert.py ColBERTConfig.lexical_anchor): adds a
    # learnable-gated per-token-id embedding to the projection output so
    # an exact token match always contributes similarity, even when the
    # backbone's contextual mixing collapses sibling-chunk slot tokens
    # (the round-5 miss diagnosis: 86-89% of dense top-1 misses were
    # sibling chunks). 0 disables; ignored when encoder_checkpoint is
    # set (pretrained backbones already carry exact-match affinity).
    encoder_lexical_anchor: float = 0.0
    # Numeric/unit canonicalization in the corpus-trained dense tokenizer
    # (utils/textfold.py): "sixty"->"60", "gigabytes"->"gb" on BOTH doc
    # and query side, so slot values match across surface forms — the
    # dense analyzer's counterpart of the lexical side's stemmer.
    # Persisted inside tokenizer.json; ignored for pretrained-checkpoint
    # tokenizers (their embeddings already carry the equivalence).
    tokenizer_fold_numeric: bool = True

    # TPU mesh / numerics.
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RAGConfig":
        d = json.loads(s)
        mesh = d.pop("mesh", None)
        cfg = cls(**{k: v for k, v in d.items() if k in _FIELD_NAMES})
        cfg.query_term_buckets = tuple(cfg.query_term_buckets)
        # a NON-DEFAULT fusion_weight_bm25 in a config FILE is a pin, same
        # as the CLI flag — the auto gate must not override a value the
        # user chose (it may still pick the ordering mode). The default
        # 0.5 does NOT pin: full round-tripped dumps (cfg.save()) always
        # carry the field, and inferring a pin from a machine-serialized
        # default would silently restrict the gate menu. To pin exactly
        # 0.5, set "fusion_weight_pinned": true explicitly.
        if ("fusion_weight_bm25" in d and "fusion_weight_pinned" not in d
                and d["fusion_weight_bm25"] != 0.5):
            cfg.fusion_weight_pinned = True
        if mesh:
            if mesh.get("mesh_shape") is not None:
                mesh["mesh_shape"] = tuple(mesh["mesh_shape"])
            mesh["axis_names"] = tuple(mesh.get("axis_names", ("data", "model")))
            mesh["doc_token_buckets"] = tuple(
                mesh.get("doc_token_buckets", (64, 128, 256))
            )
            cfg.mesh = MeshConfig(**mesh)
        return cfg

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "RAGConfig":
        return cls.from_json(Path(path).read_text())

    def validate(self) -> None:
        if self.min_chunk_size >= self.max_chunk_size:
            raise ValueError("min_chunk_size must be < max_chunk_size")
        if self.final_top_k > self.fusion_candidates:
            raise ValueError("final_top_k must be <= fusion_candidates")
        if self.query_max_tokens % 32 != 0:
            raise ValueError("query_max_tokens must be a multiple of 32 (TPU lanes)")
        if self.final_fusion not in ("rerank", "rrf", "union", "auto"):
            raise ValueError(
                "final_fusion must be 'rerank', 'rrf', 'union', or 'auto'")
        if not 0.0 <= self.fusion_weight_bm25 <= 1.0:
            raise ValueError("fusion_weight_bm25 must be in [0, 1]")
        for b in self.mesh.doc_token_buckets:
            if b % 32 != 0:
                raise ValueError("doc token buckets must be multiples of 32")
        if self.mesh.index_dtype not in ("auto", "int8", "int8-doc",
                                         "int4-doc", "bfloat16", "float32"):
            raise ValueError(
                "index_dtype must be one of auto | int8 | int8-doc | "
                "int4-doc | bfloat16 | float32 ('auto' picks int8 unless "
                "the projected index exceeds the per-device HBM comfort "
                "margin, then the half-size int4-doc)")


_FIELD_NAMES = {f.name for f in dataclasses.fields(RAGConfig)}


def effective_final_fusion(config) -> str:
    """The final-fusion mode a retriever should bake into its jit.

    "auto" is an application-level setting: RAGApplication resolves it via
    the measured gate (retrieval/gate.py) before retrievers are built.
    Retrievers constructed directly with an unresolved "auto" fall back to
    reference parity ("rerank", local_rag_complete.py:928)."""
    v = getattr(config, "final_fusion", "rerank")
    return "rerank" if v == "auto" else v
