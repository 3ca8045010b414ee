"""The port's native text library (utils/native.py, its own copy of
``csrc/textproc.cpp`` built with g++ into ``build/native/``) against the
pure-Python oracles, on the CPU.

``tests/test_native.py``'s cases against the port's library and the port's
Python path; then the port's native output against the JAX package's
Python path byte for byte, ``LexicalIndex`` equal with and without the
library (and to JAX's), ``HRAG_NO_NATIVE``, and a failed build that is
logged, not quiet.
"""

import logging

import numpy as np
import pytest

from hybrid_rag_colbertv2_tpu.index import lexical as jax_lexical
from hybrid_rag_colbertv2_tpu.index import textproc as jax_textproc
from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
from hybrid_rag_colbertv2_tpu_torch.index.textproc import (
    PorterStemmer, SnowballStemmer, tokenize_corpus, tokenize_lexical)
from hybrid_rag_colbertv2_tpu_torch.utils import native


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "the port's native library did not build"
    assert native.library_path().exists()
    return lib


# tests/test_native.py's words and corpora
WORDS = [
    "caresses", "ponies", "cats", "feed", "agreed", "plastered", "motoring",
    "sing", "happy", "sky", "relational", "conditional", "rational",
    "valenci", "hesitanci", "digitizer", "conformabli", "radicalli",
    "differentli", "vileli", "analogousli", "vietnamization", "predication",
    "operator", "feudalism", "decisiveness", "hopefulness", "callousness",
    "formaliti", "sensitiviti", "sensibiliti", "triplicate", "formative",
    "formalize", "electriciti", "electrical", "hopeful", "goodness",
    "revival", "allowance", "inference", "airliner", "gyroscopic",
    "adjustable", "defensible", "irritant", "replacement", "adjustment",
    "dependent", "adoption", "homologou", "communism", "activate",
    "angulariti", "homologous", "effective", "bowdlerize", "probate",
    "rate", "cease", "controll", "roll", "a", "be", "run", "flying",
    "dying", "tied", "agreeing", "x1", "2025", "don't",
]
SMALL = [
    "The quick brown foxes were running quickly over the lazy dogs!",
    "TPUs multiply matrices; systolic arrays stream operands (fast).",
    "",
    "   ",
    "UPPER lower MiXeD 123abc abc123 --- ***",
    "Stopwords only: the and of to a in is it",
    "don't can't won't o'clock it's",
    "unicode café naïve 中文 words",
]
SEPARATOR = [
    "clean document one",
    "dirty\x1edocument with a separator byte",
    "\x1e leading and trailing \x1e",
    "clean document two",
]
POSTINGS = [
    "The quick brown foxes were running quickly over the lazy dogs!",
    "",
    "systolic arrays multiply matrices\x1e with MXU units",
    "café résumé Kelvin 123 ab",
    "don't it's won't apples apples apples",
    "Repeating repeated repeats repetition repetitive",
] * 17 + [f"unique document {i} speaks about topic {i % 9}"
          for i in range(50)]


def _random_corpus(seed):
    rng = np.random.default_rng(seed)
    vocab = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                size=rng.integers(2, 12)))
             for _ in range(300)]
    sufs = ["", "s", "es", "ed", "ing", "ly", "ness", "ful", "ation",
            "ization", "ator", "alism", "ality", "ously", "iveness",
            "ivity", "bility", "ance", "ence", "ement", "ism", "ate",
            "ity", "ous", "ive", "ize", "ion", "al", "er", "ic", "y",
            "ies", "ied", "eed", "ingly", "edly"]
    vocab = vocab + [v + s for v in vocab[:50] for s in sufs]
    return [" ".join(rng.choice(vocab, size=30)) for _ in range(200)]


def test_stem_matches_python(lib):
    porter, snow = PorterStemmer(), SnowballStemmer()
    jporter, jsnow = jax_textproc.PorterStemmer(), \
        jax_textproc.SnowballStemmer()
    for w in WORDS:
        assert native.stem_native(w, "porter") == porter.stem(w) == \
            jporter.stem(w), w
        assert native.stem_native(w, "snowball") == snow.stem(w) == \
            jsnow.stem(w), w


@pytest.mark.parametrize("stemmer", ["snowball", "porter"])
@pytest.mark.parametrize("corpus", ["small", "separator", "random"])
def test_tokenize_corpus_matches_python(lib, corpus, stemmer):
    """The port's native tokens == the port's Python tokens == the JAX
    package's Python tokens, document for document (the separator byte
    never splits a document)."""
    docs = {"small": SMALL, "separator": SEPARATOR,
            "random": _random_corpus(0)}[corpus]
    got = native.tokenize_corpus_native(docs, stemmer=stemmer)
    assert len(got) == len(docs)
    assert got == [tokenize_lexical(t, stemmer=stemmer) for t in docs]
    assert got == [jax_textproc.tokenize_lexical(t, stemmer=stemmer)
                   for t in docs]
    assert tokenize_corpus(docs, stemmer=stemmer) == got


def test_unicode_lower_parity_and_empty_corpus(lib):
    t = "Kelvin scale measurement"
    assert native.tokenize_corpus_native([t]) == [tokenize_lexical(t)]
    assert native.tokenize_corpus_native([]) == []


@pytest.mark.parametrize("cap", [0, 3])
def test_lexical_index_same_with_and_without_native(lib, monkeypatch, cap):
    """Bit-identical LexicalIndex from the native build, the port's Python
    build and the JAX package's Python build."""
    a = LexicalIndex.build(POSTINGS, postings_cap=cap)
    monkeypatch.setenv("HRAG_NO_NATIVE", "1")
    assert native.get_lib() is None
    b = LexicalIndex.build(POSTINGS, postings_cap=cap)
    j = jax_lexical.LexicalIndex.build(POSTINGS, postings_cap=cap)
    for other in (b, j):
        assert a.vocab == other.vocab
        np.testing.assert_array_equal(a.indptr, other.indptr)
        np.testing.assert_array_equal(a.post_docs, other.post_docs)
        np.testing.assert_array_equal(a.post_weights, other.post_weights)
        assert a.avgdl == other.avgdl
        assert a.max_postings == other.max_postings
        assert a.n_docs == other.n_docs == len(POSTINGS)


def test_build_postings_native_edge_cases(lib):
    terms, tids, dids, tfs, lens = native.build_postings_native([])
    assert terms == [] and len(tids) == 0 and len(lens) == 0
    # all-stopword / empty docs keep their slots (doc ids stay aligned)
    terms, tids, dids, tfs, lens = native.build_postings_native(
        ["the and of", "", "alpha beta", "alpha"])
    assert list(lens) == [0, 0, 2, 1]
    assert terms == ["alpha", "beta"]
    assert list(tids) == [0, 0, 1] and list(dids) == [2, 3, 2]
    assert list(tfs) == [1, 1, 1]


def test_no_native_forces_python(lib, monkeypatch):
    """HRAG_NO_NATIVE=1 makes every entry point take the Python path,
    each call, with the library already loaded."""
    calls = []
    monkeypatch.setattr(native, "_joined",
                        lambda c: calls.append(c) or b"")
    monkeypatch.setenv("HRAG_NO_NATIVE", "1")
    assert native.tokenize_corpus_native(SMALL) is None
    assert native.build_postings_native(SMALL) is None
    assert native.stem_native("running") is None
    assert tokenize_corpus(SMALL) == [tokenize_lexical(t) for t in SMALL]
    LexicalIndex.build(SMALL)
    assert calls == []


def test_failed_build_is_logged_not_quiet(tmp_path, monkeypatch):
    """A source the compiler rejects: get_lib() returns None, logs the
    compiler's error at warning level, leaves no library, and the Python
    path serves."""
    bad = tmp_path / "textproc.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = seen.append
    native.log.addHandler(handler)
    try:
        assert native.get_lib() is None
    finally:
        native.log.removeHandler(handler)
    assert len(seen) == 1 and seen[0].levelname == "WARNING"
    msg = seen[0].getMessage()
    assert "native build failed" in msg
    assert "error: expected" in msg          # the compiler's own words
    assert not native.library_path().exists()
    assert not list((tmp_path / "out").glob("*.tmp"))
    assert native.tokenize_corpus_native(SMALL) is None
    assert tokenize_corpus(SMALL) == [tokenize_lexical(t) for t in SMALL]


def test_library_path_keys_the_source(tmp_path, monkeypatch):
    src = tmp_path / "textproc.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    first = native.library_path()
    src.write_bytes(native.SOURCE.read_bytes() + b"\n// edited\n")
    assert native.library_path() != first
    assert first.parent == native.BUILD_DIR
