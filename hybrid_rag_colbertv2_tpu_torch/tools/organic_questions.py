"""Hand-written natural questions over the repo's own documentation —
port of ``hybrid_rag_colbertv2_tpu/tools/organic_questions.py`` (the
questions and anchors copied as they are).

The ORGANIC bench pass (bench.py::run_organic) guards the quality claim
against "the corpus generator flatters the system", but its query slices
were still TEMPLATE-generated (ICT spans / word-dropout / synonym
substitution) — span perturbations whose vocabulary is sampled from the
gold chunk itself, which is BM25's best case and saturates at 0.85-0.95
(VERDICT r4 weak #3: "the organic eval family is too easy to prove the
dense leg's value on real text"). This module is the generator-DISJOINT
slice: ~40 questions written by hand the way a user would actually ask
them — paraphrased, compositional, often sharing few or no content words
with the chunk that answers them.

Gold labels are resolved at EVAL time by anchoring: each question names a
short distinctive substring (``anchor``) that must appear in the answering
chunk's text; every chunk containing the anchor (case-insensitive) is
gold. Anchors are chosen to be stable technical phrases, not sentence
copies, so routine doc edits don't orphan them — and ``resolve_gold``
DROPS questions whose anchor no longer matches (the bench logs coverage,
so silent corpus drift is visible, not miscounted).

No counterpart exists in the reference (it publishes no accuracy numbers
at all, SURVEY.md section 6); this is the framework's own quality
regression harness.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# Each entry: q = the natural question (vocabulary deliberately disjoint
# from the doc text where possible), anchor = substring of the answering
# chunk (case-insensitive). Written 2026-08-19 against README.md,
# SURVEY.md, PARITY.md, BASELINE.md, docs/{architecture,performance,
# scaling}.md.
QUESTIONS: List[Dict[str, str]] = [
    # --- capacity / memory -------------------------------------------------
    {"q": "What numbers do I plug in to work out how much accelerator "
          "memory my document collection will need?",
     "anchor": "bytes per chunk"},
    {"q": "Roughly how many passages can a single accelerator hold "
          "before the index has to be split across devices?",
     "anchor": "Single-chip capacity"},
    {"q": "Which storage format packs two token vectors into every byte, "
          "and what does that do to capacity?",
     "anchor": "nibble-packed"},
    {"q": "Why did the first attempt at the 4-bit layout crawl once the "
          "collection grew past half a million entries?",
     "anchor": "feature-halves"},
    {"q": "Is there a way to move an existing index to a smaller numeric "
          "format without redoing all the embedding work?",
     "anchor": "without re-encoding"},
    # --- timing / measurement ----------------------------------------------
    {"q": "My latency readings look way too good when I just stopwatch "
          "the Python call — what is going on and what is the honest "
          "protocol?",
     "anchor": "queue N executions"},
    {"q": "Which tool breaks a single query's milliseconds down stage by "
          "stage so I can see where the time goes?",
     "anchor": "stage_probe"},
    {"q": "What latency target at the million-passage mark was this "
          "system built to beat, and on how many chips?",
     "anchor": "10 ms"},
    {"q": "How fast can one accelerator answer queries when they arrive "
          "in groups of eight?",
     "anchor": "QPS/chip"},
    # --- scoring / kernels ---------------------------------------------
    {"q": "The original project advertises late-interaction scoring — "
          "does its code actually compute that?",
     "anchor": "mean-pool"},
    {"q": "How do the lexical and neural candidate lists get merged "
          "before the final rescoring step?",
     "anchor": "reciprocal-rank"},
    {"q": "What cheap first pass whittles a million candidates down "
          "before the expensive exact scoring runs?",
     "anchor": "pooled-cosine"},
    {"q": "Instead of embedding the shortlisted passages again like the "
          "original code does, what does this system do?",
     "anchor": "re-encodes all 50"},
    {"q": "When is the hardware's approximate top-k primitive used, and "
          "what is the speedup?",
     "anchor": "approx_max_k"},
    {"q": "Is the stage that rescores the shortlisted candidates limited "
          "by arithmetic or by memory movement?",
     "anchor": "gather-bound"},
    {"q": "What constants and formula flavor does the sparse scoring "
          "stage use?",
     "anchor": "k1=1.5"},
    # --- distribution / sharding -----------------------------------------
    {"q": "When every device only sees a slice of the collection, how "
          "does the merged answer stay exactly right?",
     "anchor": "full-k"},
    {"q": "How are checkpoints written when the index lives spread over "
          "many hosts?",
     "anchor": "tensorstore"},
    {"q": "Can the sparse postings be split across devices too, and why "
          "do the scores come out identical either way?",
     "anchor": "shard_bm25"},
    # --- encoder / training ------------------------------------------------
    {"q": "What transformer family is the text encoder built on, and how "
          "wide are the vectors it emits per token?",
     "anchor": "XLM-RoBERTa"},
    {"q": "Queries get padded to a fixed width — is that padding just an "
          "engineering hack?",
     "anchor": "[MASK]"},
    {"q": "Where do the difficult contrasting examples used during "
          "training come from?",
     "anchor": "BM25-mined"},
    {"q": "Can this run completely offline with no downloaded weights "
          "and still understand word meaning shifts?",
     "anchor": "synonym lexicon"},
    {"q": "How are pretrained weights from the hub brought into this "
          "framework's parameter format?",
     "anchor": "torch checkpoint"},
    # --- ingestion / storage -----------------------------------------------
    {"q": "What database holds the passage texts, and which journaling "
          "tweak made bulk loading dramatically faster?",
     "anchor": "WAL"},
    {"q": "How do pictures extracted from a source file end up attached "
          "to the right passages?",
     "anchor": "page-proximity"},
    {"q": "What single identifier ties the text database rows to the "
          "on-device arrays?",
     "anchor": "corpus row index"},
    {"q": "What does the splitter do with sections too short to stand "
          "on their own?",
     "anchor": "merge small"},
    {"q": "What does the vision model produce when it looks at an "
          "extracted figure?",
     "anchor": "TYPE/DESCRIPTION"},
    # --- serving -----------------------------------------------------------
    {"q": "Why does the HTTP front end wait to group incoming requests "
          "into specific sizes before hitting the accelerator?",
     "anchor": "micro-batcher"},
    {"q": "How do several people chat at the same time without their "
          "slow text generations blocking each other?",
     "anchor": "ChatSessions"},
    # --- fusion gate ---------------------------------------------------
    {"q": "How does the system decide whether to trust the rescoring "
          "stage alone or to blend both orderings, and with what "
          "weight?",
     "anchor": "worst-case regret"},
    {"q": "What guarantees the combined retriever does not end up worse "
          "than just using its stronger half?",
     "anchor": "measured gate"},
    # --- reference facts (SURVEY) ----------------------------------------
    {"q": "How big is the original implementation this framework "
          "replaces, and in what language?",
     "anchor": "2,039"},
    {"q": "On what machine were the original project's speed numbers "
          "reported?",
     "anchor": "16 GB RAM"},
    {"q": "How long does the original pipeline spend on each embedded "
          "picture during indexing?",
     "anchor": "s/image"},
    {"q": "What long-standing identifier confusion in the original code "
          "could silently fetch the wrong rows?",
     "anchor": "1-based"},
    # --- quantization details ---------------------------------------------
    {"q": "What keeps one oversized token from wrecking the 4-bit "
          "precision of a whole passage?",
     "anchor": "per-token-group"},
    {"q": "Why is it safe to apply the per-document dequantization "
          "factor after taking the maximum instead of before?",
     "anchor": "commutes"},
    {"q": "Why must the innermost array dimension never drop below the "
          "hardware's native lane count?",
     "anchor": "relayout"},
]


def resolve_gold(corpus: Sequence[str]
                 ) -> Tuple[List[Tuple[str, List[int]]], List[str]]:
    """Match every question's anchor against the chunked corpus.

    -> ([(question, gold_chunk_ids)], [dropped_anchors]). A question is
    dropped (never silently counted) when its anchor matches no chunk —
    the corpus drifted or the doc was edited; the bench logs the list.
    """
    lowered = [c.lower() for c in corpus]
    resolved: List[Tuple[str, List[int]]] = []
    dropped: List[str] = []
    for item in QUESTIONS:
        a = item["anchor"].lower()
        gold = [i for i, c in enumerate(lowered) if a in c]
        if gold:
            resolved.append((item["q"], gold))
        else:
            dropped.append(item["anchor"])
    return resolved, dropped


def evaluate_questions(app, k: int = 10, batch: int = 8) -> Dict:
    """hit@k of the app's CONFIGURED retriever, its BM25-only leg, and
    its dense-only leg on the hand-written questions over whatever is
    currently indexed. Returns a dict ready for the bench JSON."""
    import numpy as np

    corpus = app.store.all_chunk_texts()
    resolved, dropped = resolve_gold(corpus)
    if not resolved:
        return {"n": 0, "dropped": len(dropped)}
    queries = [q for q, _ in resolved]
    golds = [set(g) for _, g in resolved]

    hits_cfg, hits_bm, hits_dn = [], [], []
    lex = app.indexes.lexical
    dense = app.indexes.dense
    for i0 in range(0, len(queries), batch):
        qs = queries[i0:i0 + batch]
        rows_b = app.query_batch(qs, top_k=k)
        # dense leg batched like the configured leg: one encode + one
        # search dispatch per slice, not one per question
        qe = app.encoder.encode_queries(qs)
        _, di_b = dense.search_topk(qe, k)
        di_b = di_b.cpu().numpy()
        for j, q in enumerate(qs):
            g = golds[i0 + j]
            got = {r["chunk_id"] for r in rows_b[j]}
            hits_cfg.append(bool(g & got))
            bm = np.argsort(-lex.score_host(q))[:k]
            hits_bm.append(bool(g & set(int(x) for x in bm)))
            hits_dn.append(bool(g & set(int(x) for x in di_b[j]
                                        if x >= 0)))
    return {
        "n": len(queries),
        "dropped": len(dropped),
        "dropped_anchors": dropped,
        "hit10": round(float(np.mean(hits_cfg)), 3),
        "hit10_bm25_only": round(float(np.mean(hits_bm)), 3),
        "hit10_dense_only": round(float(np.mean(hits_dn)), 3),
    }
