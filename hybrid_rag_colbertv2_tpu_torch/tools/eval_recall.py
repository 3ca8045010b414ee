"""Retrieval quality evaluation over a REAL indexed corpus — port of
``hybrid_rag_colbertv2_tpu/tools/eval_recall.py``.

The reference publishes no accuracy numbers at all (SURVEY.md section 6).
This tool measures, on whatever corpus the app has indexed:

  * hit@k        — fraction of ICT pseudo-queries (a sentence sampled from
                   a chunk, train/data.py) whose SOURCE chunk is retrieved;
  * agreement@k  — overlap between the CONFIGURED cascade (prefilter /
                   postings cap / approx top-k as set) and the exact one
                   (prefilter=0, approx_topk_recall=1.0) — quantifies what
                   the approximation knobs actually cost on YOUR data;
  * retrieval p50 per batch (utils/timing.py: CUDA events on the card).

Each configuration gets a FRESH retriever bound to the app's indexes —
configs are never mutated on a live retriever, because retrievers bake
their knobs into their cached cascades at construction. The exact leg is
route 0 (``dense_prefilter=0``), the full scan through the index
layout's CUDA kernel on the card. Quality is mesh-invariant (sharded ==
single-device is covered by tests/test_torch_sharded.py), so evaluation
runs single-device, on the app's device.

Usage:
  python -m hybrid_rag_colbertv2_tpu_torch.tools.eval_recall \
      [--config cfg.json] [--device cpu] [--n-queries 32] [--k 10] [--batch 8]

Prints one JSON object to stdout.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from typing import Dict


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _locate_pairs(corpus, query_sentence_pairs) -> list:
    """[(query, sentence)] -> [(query, chunk_index)] for every sentence
    found intact in exactly one corpus chunk (unique-substring match)."""
    import bisect

    # one find() over a concatenated corpus per sentence (C-level), then
    # offset -> chunk via bisect; a second find() rejects ambiguity
    big = chr(0).join(corpus)   # NUL never occurs in text -> a
    # sentence can never match across a chunk boundary
    offsets = []
    pos = 0
    for c in corpus:
        offsets.append(pos)
        pos += len(c) + 1
    out = []
    for query, sentence in query_sentence_pairs:
        i = big.find(sentence)
        if i < 0 or big.find(sentence, i + 1) >= 0:
            continue          # not in corpus / straddles or repeats
        out.append((query, bisect.bisect_right(offsets, i) - 1))
    return out


def paraphrase_eval_pairs(corpus) -> list:
    """-> [(paraphrase_query, chunk_index)] for every template-generated
    corpus sentence (tools/sample_corpus.paraphrase_pairs) found intact in
    exactly one indexed chunk.

    Paraphrase queries restate a chunk sentence with different wording but
    the same concrete facts — unlike verbatim ICT spans (BM25's best
    case), they leave a semantic gap only the dense leg can close, so
    hybrid-vs-single-leg comparisons on them measure what fusion actually
    buys (VERDICT r2 next #2a). Only meaningful on corpora built from
    tools/sample_corpus; returns [] elsewhere."""
    from hybrid_rag_colbertv2_tpu_torch.tools.sample_corpus import \
        paraphrase_pairs

    return _locate_pairs(corpus, paraphrase_pairs())


def adversarial_eval_pairs(corpus) -> list:
    """-> [(adversarial_query, chunk_index)]: the lexically-adversarial
    slice (tools/sample_corpus.adversarial_pairs — every lexicon-covered
    query word synonym-substituted, removing BM25's anchors). Measures
    whether the dense leg carries semantic matching the lexical leg
    cannot (VERDICT r3 next #1a); BM25-only is expected to score LOW
    here by construction."""
    from hybrid_rag_colbertv2_tpu_torch.tools.sample_corpus import \
        adversarial_pairs

    return _locate_pairs(corpus, adversarial_pairs())


def evaluate(app, n_queries: int = 32, k: int = 10, batch: int = 8,
             measure_latency: bool = True, seed: int = 101,
             config_overrides: Dict = None,
             query_source: str = "ict",
             measure_exact: bool = True,
             measure_legs: bool = True) -> Dict:
    """Measure hit@k / agreement@k (+ optional latency) on the app's
    indexed corpus. Returns the result dict (see module docstring).

    ``query_source``: "ict" (default) samples verbatim ICT spans;
    "paraphrase" uses non-verbatim paraphrase queries from the sample-
    corpus templates (see paraphrase_eval_pairs — requires a
    tools/sample_corpus-generated corpus).

    The default seed (101) is deliberately distinct from the training-pair
    seed (config.encoder_seed, default 0): with ``encoder_train_steps`` the
    app trains the encoder on ICT pairs from the SAME corpus, and an eval
    drawn with the training seed would partially measure training-pair
    recall instead of generalization."""
    import numpy as np

    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import HybridRetriever
    from hybrid_rag_colbertv2_tpu_torch.train.data import pseudo_query_pairs

    corpus = app.store.all_chunk_texts()
    if len(corpus) < 2:
        raise RuntimeError("index at least 2 chunks first (--upload)")
    cfg = app.config
    if config_overrides:
        cfg = copy.deepcopy(cfg)
        for key, val in config_overrides.items():
            if not hasattr(cfg, key):
                raise AttributeError(f"unknown config field: {key}")
            setattr(cfg, key, val)

    if query_source in ("paraphrase", "adversarial"):
        pairs = (paraphrase_eval_pairs(corpus)
                 if query_source == "paraphrase"
                 else adversarial_eval_pairs(corpus))
        if not pairs:
            raise RuntimeError(
                f"no {query_source} queries match this corpus (requires "
                "a tools/sample_corpus-generated corpus)")
    elif query_source == "ict":
        pairs = pseudo_query_pairs(corpus, n_pairs_per_doc=2, seed=seed)
    else:
        raise ValueError(f"unknown query_source: {query_source!r}")
    rng = np.random.default_rng(seed)
    rng.shuffle(pairs)
    pairs = pairs[:n_queries]
    queries = [q for q, _ in pairs]
    sources = np.array([i for _, i in pairs])

    def run_all(cfg_used, indexes):
        # fresh retriever per config — knobs are baked at construction
        r = HybridRetriever(cfg_used, indexes, app.encoder,
                            chunk_store=app.store, device=app.device)
        ids = []
        for i in range(0, len(queries), batch):
            got, _ = r.retrieve_batch(queries[i:i + batch], k)
            ids.append(got[: len(queries[i:i + batch])])
        return np.concatenate(ids, axis=0), r

    ids_cfg, retr = run_all(cfg, app.indexes)
    ids_exact = None
    if not measure_exact:
        # the exact-cascade comparison costs a separate captured graph
        # per distinct (final_fusion, weight) config — harnesses sweeping
        # many configs over ONE index (bench realdata) measure it once
        # on the primary config and skip it elsewhere
        exact_cfg = None
    else:
        exact_cfg = copy.deepcopy(cfg)
        exact_cfg.dense_prefilter = 0
        exact_cfg.approx_topk_recall = 1.0
        exact_cfg.bm25_postings_cap = 0
    exact_indexes = app.indexes
    if exact_cfg is not None and getattr(cfg, "bm25_postings_cap", 0):
        # the postings cap is a BUILD-time truncation baked into the
        # persisted CSR — zeroing the config knob alone would leave the
        # "exact" leg scoring the same capped postings. Rebuild the
        # lexical index uncapped (host-side, eval-only cost) so
        # agreement@k really is configured-vs-exact.
        from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex

        exact_indexes = copy.copy(app.indexes)
        exact_indexes.lexical = LexicalIndex.build(
            list(corpus), stemmer=app.indexes.lexical.stemmer)
    if exact_cfg is not None:
        ids_exact, _ = run_all(exact_cfg, exact_indexes)

    def hit_at_k(ids):
        return float(np.mean([
            sources[i] in set(ids[i].tolist()) for i in range(len(pairs))]))

    out = {
        "chunks": len(corpus),
        "queries": len(pairs),
        "query_source": query_source,
        "k": k,
        f"hit@{k}_configured": round(hit_at_k(ids_cfg), 3),
    }
    if ids_exact is not None:
        agree = float(np.mean([
            len(set(a.tolist()) & set(b.tolist())) / max(1, (b >= 0).sum())
            for a, b in zip(ids_cfg, ids_exact)]))
        out[f"hit@{k}_exact"] = round(hit_at_k(ids_exact), 3)
        out[f"agreement@{k}"] = round(agree, 3)

    if measure_legs:
        # per-leg diagnostics: where do cascade misses come from?
        # bm25-only uses the host CSR scorer (exact, index/lexical.py:161);
        # dense-only uses the dense index's top-k with configured knobs.
        lex = app.indexes.lexical
        bm_ids = np.stack([
            np.argsort(-lex.score_host(q))[:k] for q in queries])
        d_ids_list = []
        for i in range(0, len(queries), batch):
            qb = queries[i:i + batch]
            qe = app.encoder.encode_queries(qb)
            _, di = app.indexes.dense.search_topk(
                qe, k, getattr(cfg, "dense_prefilter", 0),
                getattr(cfg, "approx_topk_recall", 0.95))
            d_ids_list.append(di.cpu().numpy()[: len(qb)])
        dn_ids = np.concatenate(d_ids_list, axis=0)
        out[f"hit@{k}_bm25_only"] = round(hit_at_k(bm_ids), 3)
        out[f"hit@{k}_dense_only"] = round(hit_at_k(dn_ids), 3)
    if measure_latency:
        from hybrid_rag_colbertv2_tpu_torch.utils.timing import queued_timeit

        bq = queries[:batch]
        p50, _ = queued_timeit(
            lambda: app.encoder.encode_queries(bq), 4, 2)
        retr.retrieve_batch(bq, k)  # warm
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            retr.retrieve_batch(bq, k)
        out["encode_batch_ms"] = round(p50, 2)
        out["retrieve_batch_ms"] = round(
            (time.perf_counter() - t0) / reps * 1e3, 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--n-queries", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--query-source", type=str, default="ict",
                    choices=["ict", "paraphrase", "adversarial"])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from hybrid_rag_colbertv2_tpu_torch.app.application import RAGApplication
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig

    cfg = RAGConfig.load(args.config) if args.config else RAGConfig()
    app = RAGApplication(cfg, use_ollama=False, device=args.device)
    app.initialize_chatbot(use_mesh=False)
    log(f"config: prefilter={cfg.dense_prefilter}, "
        f"approx={cfg.approx_topk_recall}, cap={cfg.bm25_postings_cap}")
    result = evaluate(app, args.n_queries, args.k, args.batch,
                      query_source=args.query_source)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
