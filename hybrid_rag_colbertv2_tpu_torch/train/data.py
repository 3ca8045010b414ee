"""Training-pair generation for self-contained encoder adaptation.

Port copy of ``hybrid_rag_colbertv2_tpu/train/data.py``, its imports pointed at
the port's modules.

The reference never trains anything — it downloads a fixed checkpoint. In a
zero-network environment the framework can still get a *semantically useful*
encoder by contrastively training the small backbone on the corpus itself:
pseudo-queries are sampled spans of each chunk (ICT-style inverse cloze),
the source chunk is the positive, and in-batch chunks are negatives.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def pseudo_query_pairs(
    corpus: Sequence[str],
    *,
    n_pairs_per_doc: int = 2,
    query_words: Tuple[int, int] = (3, 8),
    seed: int = 0,
    word_dropout: float = 0.0,
    synonym_prob: float = 0.0,
    with_mine_text: bool = False,
) -> List[Tuple[str, int]]:
    """-> list of (pseudo_query_text, positive_corpus_index).

    ``with_mine_text=True`` returns (query, idx, mine_text) triples where
    ``mine_text`` is the span BEFORE synonym substitution. BM25-mined
    hard negatives for a substituted query must be mined on the original
    words: the substituted text has no lexical anchors left, so mining on
    it degenerates to random padding, while the original span surfaces
    the chunks the cascade actually confuses with the source
    (mine_hard_negatives consumes the third element when present).

    ``word_dropout`` > 0 drops each span word with that probability
    (always keeping at least query_words[0] words): queries stop being
    verbatim substrings, which (a) trains the encoder to rank under
    partial lexical overlap instead of memorizing exact spans and (b)
    makes held-out evaluation less of a best case for BM25.

    ``synonym_prob`` > 0 replaces each span word with that probability by
    a synonym from the built-in lexicon (train/lexicon.py, sampled
    uniformly): the query says "60"/"rapid" while the chunk says
    "sixty"/"fast". This teaches the encoder synonym invariance — the
    capability a pretrained checkpoint gets for free and the
    lexically-adversarial eval slice measures (VERDICT r3 next #1b).
    Substituted words are no longer source-chunk words, so synonym
    queries are lexically adversarial by construction."""
    from .lexicon import substitute_words

    rng = np.random.default_rng(seed)
    pairs: List[Tuple[str, int]] = []
    for idx, text in enumerate(corpus):
        words = text.split()
        if len(words) < query_words[0]:
            continue
        for _ in range(n_pairs_per_doc):
            n = int(rng.integers(query_words[0],
                                 min(query_words[1], len(words)) + 1))
            start = int(rng.integers(0, max(len(words) - n, 0) + 1))
            span = words[start: start + n]
            # mine_span is the VERBATIM source span, captured BEFORE any
            # perturbation: mine_hard_negatives' duplicate-positive
            # filter tests `mine_q in corpus[i]`, which is only
            # meaningful for a verbatim substring (a post-dropout span
            # is no longer a substring of anything, silently disabling
            # the filter and re-admitting the ~10pp-label-noise
            # alternative-positive negatives it exists to block).
            mine_span = list(span)
            if word_dropout > 0.0 and len(span) > query_words[0]:
                keep = rng.random(len(span)) >= word_dropout
                # never drop below the minimum query length
                while keep.sum() < query_words[0]:
                    keep[int(rng.integers(0, len(span)))] = True
                span = [w for w, k in zip(span, keep) if k]
            if synonym_prob > 0.0:
                span = substitute_words(span, prob=synonym_prob, rng=rng,
                                        pick="random")
            if with_mine_text:
                pairs.append((" ".join(span), idx, " ".join(mine_span)))
            else:
                pairs.append((" ".join(span), idx))
    rng.shuffle(pairs)
    return pairs


def corpus_word_df(corpus: Sequence[str]) -> Dict[str, int]:
    """Surface-word document frequencies over the chunk corpus: word
    (lowercased, punctuation-stripped) -> number of chunks containing it.
    One host pass; feeds the rarity-aware dropout of
    ``reworded_query_pairs`` (words shared by many chunks are sentence-
    frame vocabulary; words in few chunks are the discriminating
    anchors)."""
    from ..index.textproc import _WORD_RE

    df: Dict[str, int] = {}
    for text in corpus:
        for w in set(_WORD_RE.findall(text.lower())):
            df[w] = df.get(w, 0) + 1
    return df


def _keep_prob(df: int, keep_common: float) -> float:
    """Rarity-scaled survival probability for a query word: df=1 (unique
    to its chunk) always survives; the probability decays quadratically
    toward ``keep_common`` as the word appears in more chunks (df ~7+ is
    sentence-frame vocabulary on template-sibling corpora)."""
    return keep_common + (1.0 - keep_common) / (1.0 + ((df - 1) / 3.0) ** 2)


def reworded_query_pairs(
    corpus: Sequence[str],
    *,
    n_pairs_per_doc: int = 2,
    query_words: Tuple[int, int] = (10, 24),
    seed: int = 0,
    keep_common: float = 0.35,
    two_span_prob: float = 0.5,
    synonym_prob: float = 0.0,
    df: Dict[str, int] = None,
    with_mine_text: bool = False,
) -> List[Tuple]:
    """Compositional-rewording pseudo-queries mined from the corpus
    itself (VERDICT r4 next #1/#4). Each query is built to look like a
    real reworded question about its chunk — the regime the template
    paraphrase slice measures and span perturbations cannot reproduce
    (docs/architecture.md, round-4 rejection: a fifth span-perturbation
    regime saturates; the dense failures are sibling-chunk confusion on
    shared sentence frames with rare slot words):

      * sample a LONG span (default 10-24 words — long spans cross
        sentence boundaries, composing facts), or, with
        ``two_span_prob``, TWO disjoint short spans of the same chunk
        joined (explicit two-fact composition);
      * drop stopwords always (paraphrases replace function words);
      * drop each remaining word with a probability that grows with its
        corpus document frequency (``corpus_word_df``): words shared by
        many chunks (the sentence frame — exactly what siblings share)
        usually vanish, rare anchors always survive;
      * SHUFFLE the survivors (full order invariance — paraphrases
        reorder clauses; BM25 is order-blind, so this only moves the
        dense leg);
      * optionally synonym-substitute survivors (``synonym_prob``).

    Returns (query, positive_idx) pairs, or (query, positive_idx,
    mine_text) with ``with_mine_text`` where mine_text is the longest
    verbatim source span — BM25 hard-negative mining and the duplicate-
    positive filter need a verbatim substring (see pseudo_query_pairs).
    """
    from ..index.textproc import _WORD_RE, ENGLISH_STOPWORDS
    from .lexicon import substitute_words

    if df is None:
        df = corpus_word_df(corpus)
    rng = np.random.default_rng(seed)
    lo, hi = query_words
    min_keep = 4
    pairs: List[Tuple] = []
    for idx, text in enumerate(corpus):
        words = text.split()
        if len(words) < max(lo, 2 * min_keep):
            continue
        for _ in range(n_pairs_per_doc):
            if rng.random() < two_span_prob and len(words) >= 2 * lo:
                # two disjoint spans = compose two facts from one chunk
                n1 = int(rng.integers(lo // 2, hi // 2 + 1))
                n2 = int(rng.integers(lo // 2, hi // 2 + 1))
                s1 = int(rng.integers(0, max(len(words) - n1 - n2, 0) + 1))
                s2 = int(rng.integers(s1 + n1,
                                      max(len(words) - n2, s1 + n1) + 1))
                span_a = words[s1: s1 + n1]
                span_b = words[s2: s2 + n2]
                span = span_a + span_b
                mine_span = span_a if len(span_a) >= len(span_b) else span_b
            else:
                n = int(rng.integers(lo, min(hi, len(words)) + 1))
                start = int(rng.integers(0, max(len(words) - n, 0) + 1))
                span = words[start: start + n]
                mine_span = list(span)
            # rarity-aware content filter: stopwords out, frame words
            # (high df) mostly out, anchors (low df) kept
            keys = [(w, next(iter(_WORD_RE.findall(w.lower())), ""))
                    for w in span]
            keep = []
            for w, k in keys:
                if not k or k in ENGLISH_STOPWORDS:
                    continue
                if rng.random() <= _keep_prob(df.get(k, 1), keep_common):
                    keep.append(w)
            if len(keep) < min_keep:
                # too aggressive for this span — fall back to all
                # content words (still stopword-free)
                keep = [w for w, k in keys
                        if k and k not in ENGLISH_STOPWORDS]
            if len(keep) < min_keep:
                continue
            rng.shuffle(keep)
            if synonym_prob > 0.0:
                keep = substitute_words(keep, prob=synonym_prob, rng=rng,
                                        pick="random")
            if with_mine_text:
                pairs.append((" ".join(keep), idx, " ".join(mine_span)))
            else:
                pairs.append((" ".join(keep), idx))
    rng.shuffle(pairs)
    return pairs


# Interrogative frames for question_query_pairs. Heads/tails are
# deliberately generic English question scaffolding — the point is the
# DISTRIBUTION (queries that start with frame words and end with "?"),
# not any particular phrasing. A (head, tail) pair composes as
# "<head> <content words><tail>?".
_QUESTION_HEADS = (
    "what is", "what does", "what happens to", "which", "how does",
    "how do", "how is", "why does", "why is", "where does", "when is",
    "can", "is there a way to", "does", "what keeps", "what makes",
)
_QUESTION_TAILS = ("", "", "", " work", " mean", " matter",
                   " come from", " used for", " happen")


def question_query_pairs(
    corpus: Sequence[str],
    *,
    n_pairs_per_doc: int = 2,
    seed: int = 0,
    synonym_prob: float = 0.0,
    df: Dict[str, int] = None,
    with_mine_text: bool = False,
) -> List[Tuple]:
    """Interrogative-framed reworded pseudo-queries (round-5/6: the
    natural-questions gap).

    The generator-disjoint hand-written-questions eval slice
    (tools/organic_questions.py) measured dense-only hit@10 0.275 vs
    BM25-only 0.500 on an encoder trained only on span/reworded
    templates: real user queries are QUESTIONS — they open with frame
    words ("what is", "how does"), close with "?", and interleave
    content words with interrogative scaffolding — a token distribution
    the encoder never saw at train time, and a 4-layer self-trained
    backbone is strongly distribution-sensitive (frame tokens perturb
    the content tokens' contextual mixing).

    Each pair is a rarity-aware reworded query (reworded_query_pairs:
    stopword-free, frame-vocabulary-dropped, shuffled content words of a
    long or two-span sample) wrapped in a sampled interrogative frame.
    Mining text stays the verbatim source span (the frame words carry no
    lexical anchor). The reference needs nothing like this — its
    pretrained checkpoint saw billions of real questions
    (local_rag_complete.py:718-724); this is the self-contained
    analogue.

    MEASURED (2026-08-19, TPU A/B on the organic docs corpus, 2 seeds,
    default auto-train): n_pairs_per_doc=6 does NOT move the hand-
    written-questions slice — dense-only hit@10 0.300/0.325 vs control
    0.325/0.275 (±2 questions = the seed noise band), hybrid likewise;
    ICT guard slice unchanged. The questions gap is vocabulary
    ABSTRACTION ("accelerator memory" -> "HBM"), not frame-token
    distribution — scaffolding around corpus words cannot teach words
    the corpus pairs never connect. Kept available (config
    encoder_question_pairs, default 0) for corpora whose prose does
    connect question vocabulary to answer vocabulary, and as the
    starting point if a future pretrained backbone wants question-form
    fine-tuning.
    """
    base = reworded_query_pairs(
        corpus, n_pairs_per_doc=n_pairs_per_doc, seed=seed,
        query_words=(8, 18), synonym_prob=synonym_prob, df=df,
        with_mine_text=with_mine_text)
    rng = np.random.default_rng(seed + 0x5EED)
    out: List[Tuple] = []
    for entry in base:
        head = _QUESTION_HEADS[int(rng.integers(len(_QUESTION_HEADS)))]
        tail = (_QUESTION_TAILS[int(rng.integers(len(_QUESTION_TAILS)))]
                if rng.random() < 0.5 else "")
        q = f"{head} {entry[0]}{tail}?"
        out.append((q, *entry[1:]))
    return out


def mine_hard_negatives(
    corpus: Sequence[str],
    pairs: Sequence[Tuple[str, int]],
    *,
    n_negatives: int = 4,
    seed: int = 0,
    lexical=None,
) -> List[Tuple[str, int, List[int]]]:
    """Attach BM25-mined hard negatives to (query, positive_idx) pairs.

    For each pseudo-query, the negatives are the top-BM25-scoring chunks
    that are NOT the positive — exactly the documents the retrieval cascade
    will confuse with the source at query time (the final top-k is chosen
    by the dense rerank over BM25-surfaced candidates, retrieval/cascade.py
    stage 3), so these are the discriminations the encoder must learn.
    In-batch-only negatives are mostly random chunks and teach topic
    separation but not within-topic ranking.

    ``pairs`` entries may be (query, positive_idx) or (query,
    positive_idx, mine_text); when mine_text is present BM25 scores IT
    instead of the query (synonym-substituted queries mine on their
    pre-substitution span — see pseudo_query_pairs ``with_mine_text``).

    ``lexical``: an existing index/lexical.LexicalIndex to reuse; when
    None one is built over ``corpus`` (uncapped postings — mining wants
    exact scores). Scoring runs on host (LexicalIndex.score_host): mining
    is a one-time build-phase cost, not a serving-path op.

    -> list of (query, positive_idx, [negative_idx, ...]); every entry
    carries min(n_negatives, len(corpus) - 1) negatives — BM25-mined
    first, padded with random non-positive chunks when the query matches
    too few documents.
    """
    from ..index.lexical import LexicalIndex

    if lexical is None:
        lexical = LexicalIndex.build(list(corpus))
    rng = np.random.default_rng(seed)
    n = len(corpus)
    # a corpus of n chunks has only n-1 possible negatives per pair
    target = min(n_negatives, max(n - 1, 0))
    out: List[Tuple[str, int, List[int]]] = []
    for entry in pairs:
        q, pos = entry[0], entry[1]
        # (query, pos, mine_text) triples: mine on the pre-substitution
        # span (see pseudo_query_pairs ``with_mine_text``)
        mine_q = entry[2] if len(entry) > 2 else q
        scores = lexical.score_host(mine_q)
        order = np.argsort(-scores)
        # candidates CONTAINING the original span verbatim are alternative
        # true positives (the same sentence recurs across chunks), not
        # negatives — training against them is label noise (measured:
        # unfiltered span-mined negatives cost ~10pp dense hit@10 on every
        # eval slice). Only applicable for triples, where mine_q is a
        # verbatim source span.
        is_dup = ((lambda i: mine_q in corpus[i])
                  if len(entry) > 2 else (lambda i: False))
        negs = []
        for i in order[: 4 * (target + 1)]:
            i = int(i)
            if scores[i] <= 0.0 or len(negs) >= target:
                break
            if i != pos and not is_dup(i):
                negs.append(i)
        if len(negs) < target:
            # pad from a permutation — bounded, unlike rejection sampling
            for cand in rng.permutation(n):
                if len(negs) >= target:
                    break
                cand = int(cand)
                if cand != pos and cand not in negs:
                    negs.append(cand)
        out.append((q, pos, negs))
    return out
