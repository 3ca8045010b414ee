"""The port's measured fusion gate against the JAX package's, on the CPU.

The selection rule (``select_entry_regimes``, ``select_entry``,
``paired_in_band``) is held to JAX's on the menus that
``tests/test_gate.py`` records and on seeded random menus. The whole
gate (``resolve_final_fusion``) runs in both packages over the same
index directory and encoder params: the picked entry and the details
dict must be equal (hit rates are counts of equal ids, so no tolerance).
"""

import numpy as np
import pytest

from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.index.manager import IndexManager as JaxManager
from hybrid_rag_colbertv2_tpu.models.colbert import (
    ColBERTConfig as JaxColCfg, ColBERTEncoder as JaxEncoder)
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer)
from hybrid_rag_colbertv2_tpu.retrieval import gate as jax_gate
from hybrid_rag_colbertv2_tpu.tools.sample_corpus import (
    generate_corpus as jax_generate_corpus)
from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
    ColBERTConfig, ColBERTEncoder)
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import ColBERTTokenizer
from hybrid_rag_colbertv2_tpu_torch.retrieval import gate
from hybrid_rag_colbertv2_tpu_torch.tools.sample_corpus import (
    generate_corpus)

MENU = gate.GATE_MENU


def _menu(values):
    return dict(zip(MENU, values))


# the menus tests/test_gate.py records: (hits by regime, n_per_regime)
RECORDED = {
    "lexical_only_tie": ({"all": _menu(
        [0.3, 0.35, 0.4, 0.5, 0.7, 0.7, 0.4, 0.6])}, 64),
    "lexical_only_in_band": ({"all": _menu(
        [0.3, 0.35, 0.4, 0.5, 0.7, 0.7 + 1 / 64, 0.4, 0.6])}, 64),
    "lexical_only_outright": ({"all": _menu(
        [0.3, 0.35, 0.4, 0.5, 0.7, 0.9, 0.4, 0.6])}, 64),
    "flat": ({"all": _menu([0.5] * 8)}, 64),
    "parity_outright": ({"all": _menu([0.8] + [0.5] * 7)}, 64),
    "dense_lean_tie": ({"all": _menu([0.3] + [0.5] * 7)}, 64),
    "dense_lean_outright": ({"all": _menu([0.3, 0.6] + [0.5] * 6)}, 64),
    "regime_collapse": ({
        "verbatim": _menu([0.69, 0.69, 0.67, 0.66, 0.62, 0.53, 0.67, 0.62]),
        "long_verbatim": _menu([0.48, 0.62, 0.88, 0.95, 0.97, 0.98, 0.88,
                                0.95]),
        "dropout": _menu([0.60, 0.60, 0.62, 0.62, 0.60, 0.55, 0.62, 0.60]),
        "synonym": _menu([0.51, 0.50, 0.46, 0.44, 0.36, 0.30, 0.46, 0.36]),
    }, 16),
    "seed1_strictly_smaller_regret": ({
        "verbatim": _menu([0.688, 0.75, 0.812, 0.812, 0.812, 0.812, 0.812,
                           0.812]),
        "long_verbatim": _menu([1.0, 1.0, 1.0, 1.0, 0.875, 0.875, 1.0,
                                0.875]),
        "dropout": _menu([0.375, 0.375, 0.438, 0.625, 0.625, 0.625, 0.438,
                          0.625]),
        "synonym": _menu([0.75, 0.75, 0.812, 0.688, 0.625, 0.625, 0.812,
                          0.625]),
    }, 16),
    "degenerate_band": ({"all": _menu(
        [0.70, 0.55, 0.58, 0.60, 0.62, 0.70 - 1 / 32, 0.58, 0.61])}, 16),
    "smallest_regime_band": ({
        "verbatim": _menu([0.9] * 8),
        "long_verbatim": _menu([1.0] + [0.8] * 7),
    }, {"verbatim": 16, "long_verbatim": 5}),
    "smallest_regime_int": ({
        "verbatim": _menu([0.9] * 8),
        "long_verbatim": _menu([1.0] + [0.8] * 7),
    }, 16),
}


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_select_entry_regimes_equals_jax(name):
    hits, n = RECORDED[name]
    got = gate.select_entry_regimes(MENU, hits, n)
    assert got == jax_gate.select_entry_regimes(jax_gate.GATE_MENU, hits, n)
    if len(hits) == 1:
        assert gate.select_entry(MENU, hits["all"], n) == got


@pytest.mark.parametrize("seed", range(4))
def test_select_entry_regimes_random_menus_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(150):
        n_min = int(rng.integers(4, 33))
        hits = {r: {e: round(float(rng.integers(0, n_min + 1)) / n_min, 6)
                    for e in MENU}
                for r in "abcde"[:int(rng.integers(1, 6))]}
        pinned = tuple(MENU[:2])
        for menu in (MENU, pinned):
            sub = {r: {e: h[e] for e in menu} for r, h in hits.items()}
            assert gate.select_entry_regimes(menu, sub, n_min) == \
                jax_gate.select_entry_regimes(menu, sub, n_min)
    assert gate.GATE_MENU == jax_gate.GATE_MENU
    assert [gate._drops_leg(e) for e in MENU] == \
        [jax_gate._drops_leg(e) for e in MENU]


def _vec(n, ones):
    v = np.zeros(n)
    v[list(ones)] = 1.0
    return v


PAIRED = {
    "identical": {("rrf", 0.75): _vec(24, range(12)),
                  ("rerank", 0.5): _vec(24, range(12)),
                  ("rrf", 0.5): _vec(24, range(12))},
    "consistent_sweep": {("rrf", 0.75): _vec(24, range(12)),
                         ("rrf", 0.5): _vec(24, range(15))},
    "noisy_net_one": {("rrf", 0.75): _vec(24, range(12)),
                      ("rrf", 0.5): _vec(24, range(4, 17))},
    "single_query": {("rrf", 0.75): _vec(1, []),
                     ("rrf", 0.5): _vec(1, [0])},
}


@pytest.mark.parametrize("name", sorted(PAIRED))
def test_paired_in_band_equals_jax(name):
    vecs = PAIRED[name]
    picked = ("rrf", 0.75)
    assert gate.paired_in_band(vecs, picked) == \
        jax_gate.paired_in_band(vecs, picked)


def test_sample_corpus_equals_jax():
    assert generate_corpus(12, seed=3) == jax_generate_corpus(12, seed=3)


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """One index directory built by the JAX package (tiny encoder,
    seeded), served by both."""
    root = tmp_path_factory.mktemp("gate")
    corpus = []
    for doc in jax_generate_corpus(5, seed=0):
        corpus += [p.strip() for p in doc.split("\n\n") if len(p) > 40]
    assert len(corpus) >= gate.MIN_GATE_CHUNKS
    paths = dict(bm25_index_path=str(root / "bm25"),
                 colbert_index_path=str(root / "colbert"))
    jtok = JaxTokenizer.train_bpe(corpus, vocab_size=1024)
    jtok.save(root / "tok.json")
    jenc = JaxEncoder(JaxColCfg.tiny(vocab_size=jtok.vocab_size), jtok,
                      seed=1)
    jenc.save_params(str(root / "params.npz"))
    jcfg = JaxConfig(**paths)
    jmgr = JaxManager(jcfg, jenc)
    jmgr.build_all(corpus)
    ttok = ColBERTTokenizer.load(root / "tok.json")
    tenc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=ttok.vocab_size),
                          ttok, params=ColBERTEncoder.load_params(
                              str(root / "params.npz")), device="cpu")
    tcfg = RAGConfig(**paths)
    tmgr = IndexManager(tcfg, tenc, device="cpu")
    tmgr.load()
    return corpus, (jcfg, jmgr, jenc), (tcfg, tmgr, tenc)


@pytest.mark.parametrize("fixed_weight", [None, 0.75])
def test_resolve_final_fusion_equals_jax(index, fixed_weight):
    corpus, jax_side, port_side = index
    want = jax_gate.resolve_final_fusion(*jax_side, corpus, n_queries=40,
                                         fixed_weight=fixed_weight)
    got = gate.resolve_final_fusion(*port_side, corpus, n_queries=40,
                                    fixed_weight=fixed_weight)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1]["queries"] == 40


def test_tiny_corpus_fallback_equals_jax(index):
    corpus, jax_side, port_side = index
    for fixed in (None, 0.6):
        assert gate.resolve_final_fusion(*port_side, corpus[:5],
                                         fixed_weight=fixed) == \
            jax_gate.resolve_final_fusion(*jax_side, corpus[:5],
                                          fixed_weight=fixed)


def test_validate_transfer_equals_jax(index):
    corpus, jax_side, port_side = index
    pairs = [(" ".join(corpus[i].split()[2:9]), i) for i in range(0, 20, 2)]
    picked = ("rrf", 0.9)
    menu = (("rrf", 0.5), ("rrf", 0.9), ("union", 0.9))
    assert gate.validate_transfer(*port_side, pairs, picked, menu=menu) == \
        jax_gate.validate_transfer(*jax_side, pairs, picked, menu=menu)
