"""Numeric / unit-abbreviation text folding for the dense analyzer.

A pretrained multilingual encoder (the reference's jina-colbert-v2,
local_rag_complete.py:718-724) embeds "sixty" and "60", "gigabytes" and
"gb" near each other — number/unit surface forms are identity-equivalent
and the checkpoint has learned that. A corpus-trained encoder has to
learn it from a few hundred augmented pairs, and slot-value matching is
exactly what discriminates near-duplicate chunks from the same template
family (measured: adversarial queries over an 83-sibling family ranked
the true chunk 300-450 deep because "2 100 50 6" and "two hundred fifty
six" shared no tokens).

Folding canonicalizes those identity-equivalent surface forms BEFORE
subword tokenization, on both the doc and query side, so slot values
match exactly at the token level. This mirrors the LEXICAL side's
stemmer (index/textproc.py): each analyzer normalizes the variation its
scorer cannot absorb. True synonyms ("fast"/"quick") are deliberately
NOT folded — meaning-bearing distinctions stay learnable (see
train/lexicon.py for the training-time half).

Scope: number words -> digits, and unit-abbreviation/spelling variants
-> one canonical form. Deterministic, case-insensitive on the token
core, punctuation preserved.
"""

from __future__ import annotations

import re
from typing import Dict, List

# number word -> digit string (single whitespace-delimited words only;
# compositional forms like "twenty-one" pass through untouched)
NUMERIC_FOLDS: Dict[str, str] = {
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "ten": "10", "eleven": "11", "twelve": "12", "thirteen": "13",
    "fourteen": "14", "fifteen": "15", "sixteen": "16",
    "seventeen": "17", "eighteen": "18", "nineteen": "19",
    "twenty": "20", "thirty": "30", "forty": "40", "fifty": "50",
    "sixty": "60", "seventy": "70", "eighty": "80", "ninety": "90",
    "hundred": "100", "thousand": "1000", "million": "1000000",
    "1e6": "1000000",
}

# unit / abbreviation / spelling variants -> canonical form. Only
# identity-semantics pairs belong here (an abbreviation IS its
# expansion); anything with meaning drift stays in the synonym lexicon.
UNIT_FOLDS: Dict[str, str] = {
    "gigabytes": "gb", "gigabyte": "gb",
    "teraflops": "tflops",
    "milliseconds": "ms", "millisecond": "ms",
    "milligrams": "mg", "milligram": "mg",
    "kilograms": "kg", "kilogram": "kg",
    "metres": "meters", "metre": "meter",
    "litres": "liters", "litre": "liter",
    "percent": "pct",
    "hours": "hr", "hrs": "hr", "hour": "hr",
    "years": "yr", "yrs": "yr", "year": "yr",
    "seconds": "sec", "secs": "sec", "second": "sec",
}

FOLDS: Dict[str, str] = {**NUMERIC_FOLDS, **UNIT_FOLDS}

# (leading punctuation, alphanumeric core, trailing punctuation)
_CORE_RE = re.compile(r"^([^A-Za-z0-9]*)([A-Za-z0-9]+)([^A-Za-z0-9]*)$")


def fold_words(words: List[str]) -> List[str]:
    out: List[str] = []
    for w in words:
        m = _CORE_RE.match(w)
        if m is None:
            out.append(w)
            continue
        repl = FOLDS.get(m.group(2).lower())
        out.append(w if repl is None
                   else m.group(1) + repl + m.group(3))
    return out


def fold_text(text: str) -> str:
    """Fold number words and unit variants to canonical forms.

    Whitespace-token level; punctuation around a token is preserved;
    tokens without a whole-core match pass through unchanged. Idempotent
    (canonical forms are fixed points).
    """
    return " ".join(fold_words(text.split()))
