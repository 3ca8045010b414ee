"""Lexical text processing: word tokenization, stopwords, Porter stemming.

The reference relies on the ``bm25s`` wheel for tokenization with English
stopwords + a Snowball stemmer (local_rag_complete.py:851-858; note the
reference's ``bm25s.stemmer.Stemmer.Stemmer`` call is a latent import bug,
SURVEY.md section 2). Neither wheel is a TPU citizen, so this module owns
the host-side half of the lexical pipeline: a deterministic tokenizer +
Porter (1980) stemmer implemented from the published algorithm. Corpus and
query must be processed identically — both go through ``tokenize_lexical``.

Copy of ``hybrid_rag_colbertv2_tpu/index/textproc.py`` for the PyTorch
port. The port's native C++ library (utils/native.py, its own copy of
``csrc/textproc.cpp``) is used when it builds; this pure-Python
implementation is the always-available fallback and the oracle the
native path is tested against.
"""

from __future__ import annotations

import re
from typing import List

# >= 2 chars, matching the reference's bm25s tokenizer (\b\w\w+\b):
# apostrophes split words, and the 1-char fragments ("t" from "don't",
# "s" from "it's") are dropped by the length requirement instead of
# leaking into the vocabulary as scoring terms.
_WORD_RE = re.compile(r"[a-z0-9]{2,}")

# Standard English stopword list (the usual ~170-word set used by most IR
# toolkits; matches the *behavior* of the reference's stopwords="en").
ENGLISH_STOPWORDS = frozenset(
    """a about above after again against all am an and any are aren't as at
    be because been before being below between both but by can't cannot
    could couldn't did didn't do does doesn't doing don't down during each
    few for from further had hadn't has hasn't have haven't having he he'd
    he'll he's her here here's hers herself him himself his how how's i i'd
    i'll i'm i've if in into is isn't it it's its itself let's me more most
    mustn't my myself no nor not of off on once only or other ought our ours
    ourselves out over own same shan't she she'd she'll she's should
    shouldn't so some such than that that's the their theirs them themselves
    then there there's these they they'd they'll they're they've this those
    through to too under until up very was wasn't we we'd we'll we're we've
    were weren't what what's when when's where where's which while who who's
    whom why why's with won't would wouldn't you you'd you'll you're you've
    your yours yourself yourselves
    ain aren couldn didn doesn don hadn hasn haven isn ll ma mightn mustn
    needn re shan shouldn ve wasn weren won wouldn""".split()
)
# The last line holds the apostrophe-stripped contraction fragments the
# tokenizer actually produces ("don't" -> "don"), mirroring nltk/bm25s's
# English list which carries both forms; without them the apostrophe
# entries above are unreachable dead data.

_VOWELS = set("aeiou")


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences in the stem."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (
        len(word) >= 2
        and word[-1] == word[-2]
        and _is_cons(word, len(word) - 1)
    )


def _ends_cvc(word: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    if len(word) < 3:
        return False
    i = len(word) - 1
    return (
        _is_cons(word, i)
        and not _is_cons(word, i - 1)
        and _is_cons(word, i - 2)
        and word[i] not in "wxy"
    )


class PorterStemmer:
    """Porter (1980) stemming algorithm, implemented from the paper's rules."""

    def stem(self, word: str) -> str:
        if len(word) <= 2:
            return word
        w = self._step1a(word)
        w = self._step1b(w)
        w = self._step1c(w)
        w = self._step2(w)
        w = self._step3(w)
        w = self._step4(w)
        w = self._step5(w)
        return w

    # -- step 1a: plurals ------------------------------------------------
    def _step1a(self, w: str) -> str:
        if w.endswith("sses"):
            return w[:-2]
        if w.endswith("ies"):
            return w[:-2]
        if w.endswith("ss"):
            return w
        if w.endswith("s"):
            return w[:-1]
        return w

    # -- step 1b: -ed / -ing ---------------------------------------------
    def _step1b(self, w: str) -> str:
        if w.endswith("eed"):
            if _measure(w[:-3]) > 0:
                return w[:-1]
            return w
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                return w + "e"
            if _ends_double_cons(w) and w[-1] not in "lsz":
                return w[:-1]
            if _measure(w) == 1 and _ends_cvc(w):
                return w + "e"
        return w

    # -- step 1c: y -> i --------------------------------------------------
    def _step1c(self, w: str) -> str:
        if w.endswith("y") and _has_vowel(w[:-1]):
            return w[:-1] + "i"
        return w

    _STEP2 = (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
        ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
        ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    )

    def _step2(self, w: str) -> str:
        for suf, rep in self._STEP2:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if _measure(stem) > 0:
                    return stem + rep
                return w
        return w

    _STEP3 = (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    )

    def _step3(self, w: str) -> str:
        for suf, rep in self._STEP3:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if _measure(stem) > 0:
                    return stem + rep
                return w
        return w

    _STEP4 = (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    )

    def _step4(self, w: str) -> str:
        for suf in self._STEP4:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    continue
                if _measure(stem) > 1:
                    return stem
                return w
        return w

    def _step5(self, w: str) -> str:
        # 5a
        if w.endswith("e"):
            stem = w[:-1]
            m = _measure(stem)
            if m > 1 or (m == 1 and not _ends_cvc(stem)):
                w = stem
        # 5b
        if _measure(w) > 1 and w.endswith("ll"):
            w = w[:-1]
        return w


# ---------------------------------------------------------------------------
# Snowball "english" (Porter2) — the stemmer the reference actually intends
# (``stemmer="english"`` via PyStemmer, local_rag_complete.py:854,942; used
# correctly at model_downloader_simplified.py:118). Implemented from the
# published algorithm with the official fixed R1/R2 positions; validated
# token-for-token against nltk's SnowballStemmer("english") in
# tests/test_native.py. Porter (1980) above is kept for explicit opt-in.
# ---------------------------------------------------------------------------

_SB_VOWELS = frozenset("aeiouy")
_SB_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_SB_LI = frozenset("cdeghkmnrt")
_SB_SPECIAL = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    # invariants (incl. the post-step-1a exception list and its plurals)
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
    "inning": "inning", "innings": "inning", "outing": "outing",
    "outings": "outing", "canning": "canning", "cannings": "canning",
    "herring": "herring", "herrings": "herring", "earring": "earring",
    "earrings": "earring", "proceed": "proceed", "proceeds": "proceed",
    "proceeded": "proceed", "proceeding": "proceed", "exceed": "exceed",
    "exceeds": "exceed", "exceeded": "exceed", "exceeding": "exceed",
    "succeed": "succeed", "succeeds": "succeed", "succeeded": "succeed",
    "succeeding": "succeed",
}

_SB_STEP2 = (
    ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
    ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
    ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"),
    ("ation", "ate"), ("alism", "al"), ("aliti", "al"), ("ousli", "ous"),
    ("iviti", "ive"), ("fulli", "ful"), ("enci", "ence"), ("anci", "ance"),
    ("abli", "able"), ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
    ("bli", "ble"), ("ogi", "og"), ("li", ""),
)
_SB_STEP3 = (
    ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
    ("icate", "ic"), ("iciti", "ic"), ("ative", ""), ("ical", "ic"),
    ("ness", ""), ("ful", ""),
)
_SB_STEP4 = (
    "ement", "ance", "ence", "able", "ible", "ment", "ant", "ent", "ism",
    "ate", "iti", "ous", "ive", "ize", "ion", "al", "er", "ic",
)


def _sb_is_vowel(w: str, i: int) -> bool:
    return w[i] in _SB_VOWELS  # y already rewritten to Y where consonant


def _sb_short_syllable_at_end(w: str) -> bool:
    """Ends in a short syllable: non-vowel (not w/x/Y) after a vowel after a
    non-vowel; or a 2-letter word of vowel + non-vowel."""
    n = len(w)
    if n >= 3:
        return (w[-1] not in _SB_VOWELS and w[-1] not in "wxY"
                and w[-2] in _SB_VOWELS and w[-3] not in _SB_VOWELS)
    if n == 2:
        return w[0] in _SB_VOWELS and w[1] not in _SB_VOWELS
    return False


class SnowballStemmer:
    """Snowball English (Porter2) stemmer, official fixed-R1/R2 semantics."""

    def stem(self, word: str) -> str:
        if len(word) <= 2:
            return word
        sp = _SB_SPECIAL.get(word)
        if sp is not None:
            return sp
        if word[0] == "'":
            word = word[1:]
            if len(word) <= 2:
                return word

        # mark consonant-y as Y: at the start, or right after a vowel
        chars = list(word)
        if chars[0] == "y":
            chars[0] = "Y"
        for i in range(1, len(chars)):
            if chars[i] == "y" and chars[i - 1] in _SB_VOWELS:
                chars[i] = "Y"
        w = "".join(chars)

        # R1/R2 start positions (fixed; regions are w[p1:], w[p2:])
        p1 = self._region_after_prefix(w)
        p2 = len(w)
        for i in range(p1 + 1, len(w)):
            if w[i] not in _SB_VOWELS and w[i - 1] in _SB_VOWELS:
                p2 = i + 1
                break

        w = self._step0(w)
        w = self._step1a(w)
        w = self._step1b(w, p1)
        w = self._step1c(w)
        w = self._step2(w, p1)
        w = self._step3(w, p1, p2)
        w = self._step4(w, p2)
        w = self._step5(w, p1, p2)
        return w.replace("Y", "y")

    @staticmethod
    def _region_after_prefix(w: str) -> int:
        if w.startswith(("gener", "arsen")):
            return 5
        if w.startswith("commun"):
            return 6
        for i in range(1, len(w)):
            if w[i] not in _SB_VOWELS and w[i - 1] in _SB_VOWELS:
                return i + 1
        return len(w)

    @staticmethod
    def _step0(w: str) -> str:
        for suf in ("'s'", "'s", "'"):
            if w.endswith(suf):
                return w[: -len(suf)]
        return w

    @staticmethod
    def _step1a(w: str) -> str:
        if w.endswith("sses"):
            return w[:-2]
        if w.endswith(("ied", "ies")):
            return w[:-2] if len(w) > 4 else w[:-1]
        if w.endswith(("us", "ss")):
            return w
        if w.endswith("s"):
            # delete if a vowel exists before the penultimate position
            if any(c in _SB_VOWELS for c in w[:-2]):
                return w[:-1]
        return w

    @staticmethod
    def _step1b(w: str, p1: int) -> str:
        for suf in ("eedly", "eed"):
            if w.endswith(suf):
                if len(w) - len(suf) >= p1:
                    return w[: -len(suf)] + "ee"
                return w
        for suf in ("ingly", "edly", "ing", "ed"):
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if not any(c in _SB_VOWELS for c in stem):
                    return w
                if stem.endswith(("at", "bl", "iz")):
                    return stem + "e"
                if stem.endswith(_SB_DOUBLES):
                    return stem[:-1]
                if p1 >= len(stem) and _sb_short_syllable_at_end(stem):
                    return stem + "e"
                return stem
        return w

    @staticmethod
    def _step1c(w: str) -> str:
        if (len(w) > 2 and w[-1] in "yY" and w[-2] not in _SB_VOWELS):
            return w[:-1] + "i"
        return w

    @staticmethod
    def _step2(w: str, p1: int) -> str:
        for suf, rep in _SB_STEP2:
            if w.endswith(suf):
                if len(w) - len(suf) < p1:
                    return w
                if suf == "ogi":
                    return w[:-1] if w[-4] == "l" else w
                if suf == "li":
                    return w[:-2] if w[-3] in _SB_LI else w
                return w[: -len(suf)] + rep
        return w

    @staticmethod
    def _step3(w: str, p1: int, p2: int) -> str:
        for suf, rep in _SB_STEP3:
            if w.endswith(suf):
                if len(w) - len(suf) < p1:
                    return w
                if suf == "ative":
                    return w[:-5] if len(w) - 5 >= p2 else w
                return w[: -len(suf)] + rep
        return w

    @staticmethod
    def _step4(w: str, p2: int) -> str:
        for suf in _SB_STEP4:
            if w.endswith(suf):
                if len(w) - len(suf) < p2:
                    return w
                if suf == "ion":
                    return w[:-3] if w[-4] in "st" else w
                return w[: -len(suf)]
        return w

    @staticmethod
    def _step5(w: str, p1: int, p2: int) -> str:
        if w.endswith("e"):
            if len(w) - 1 >= p2:
                return w[:-1]
            if (len(w) - 1 >= p1
                    and not _sb_short_syllable_at_end(w[:-1])):
                return w[:-1]
            return w
        if w.endswith("ll") and len(w) - 1 >= p2:
            return w[:-1]
        return w


_STEMMERS = {"porter": PorterStemmer(), "snowball": SnowballStemmer()}
_STEM_CACHES: dict = {"porter": {}, "snowball": {}}


def _stem_cached(tok: str, algo: str = "snowball") -> str:
    cache = _STEM_CACHES[algo]
    s = cache.get(tok)
    if s is None:
        s = _STEMMERS[algo].stem(tok)
        cache[tok] = s
    return s


def tokenize_lexical(text: str, *, stopwords=ENGLISH_STOPWORDS,
                     stem: bool = True,
                     stemmer: str = "snowball") -> List[str]:
    """Lowercase word tokens, stopword-filtered, Snowball-stemmed.

    Deterministic and used identically for corpus and query (the reference
    applies the same bm25s tokenization on both sides,
    local_rag_complete.py:851-855 and :939-943). The default stemmer is
    Snowball English (Porter2), matching the reference's
    ``stemmer="english"`` intent (local_rag_complete.py:854);
    ``stemmer="porter"`` keeps the Porter-1980 behavior."""
    toks = _WORD_RE.findall(text.lower())
    out = []
    for t in toks:
        if t in stopwords:
            continue
        out.append(_stem_cached(t, stemmer) if stem else t)
    return out


def tokenize_corpus(corpus: List[str], stem: bool = True,
                    stemmer: str = "snowball") -> List[List[str]]:
    """Batch tokenization — the port's native C++ library
    (utils/native.py) when it builds, with this module's pure-Python
    implementation as the tested-identical fallback."""
    from ..utils.native import tokenize_corpus_native

    native = tokenize_corpus_native(corpus, stem=stem, stemmer=stemmer)
    if native is not None:
        return native
    return [tokenize_lexical(t, stem=stem, stemmer=stemmer) for t in corpus]
