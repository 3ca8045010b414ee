"""The seeded inputs: reproducible from the seed, the same sizes for every
seed, and the lexical index the port would build from the same text."""

import numpy as np
import pytest
import torch
from conftest import small

from harness import gen, serve, spec

SEED = 2**40 + 12345          # seeds may exceed 32 bits


def _inputs(cell_name, seed, n_docs=600):
    _, cell, arch = small(cell_name, n_docs=n_docs)
    return cell, arch, serve.build_inputs(cell, arch, seed, "cpu", 200)


@pytest.mark.parametrize("cell_name", ["colbertv2.msmarco-open",
                                       "jina.trec-covid-open"])
def test_inputs_repeat_from_the_seed(cell_name):
    _, _, a = _inputs(cell_name, SEED)
    _, _, b = _inputs(cell_name, SEED)
    for sa, sb in zip(a.subs, b.subs):
        for key in ("rows", "scales", "lengths", "gid"):
            assert torch.equal(sa[key], sb[key])
    for key in ("indptr", "post_docs", "post_weights"):
        assert np.array_equal(a.csr[key], b.csr[key])
    assert a.texts == b.texts and a.terms == b.terms


@pytest.mark.parametrize("cell_name", ["colbertv2.msmarco-open",
                                       "jina.trec-covid-open"])
def test_other_seeds_shuffle_the_same_sizes(cell_name):
    _, _, a = _inputs(cell_name, SEED)
    _, _, b = _inputs(cell_name, SEED + 1)
    assert a.texts != b.texts
    assert [s["lengths"].shape for s in a.subs] == \
        [s["lengths"].shape for s in b.subs]
    assert [s["valid_rows"] for s in a.subs] == \
        [s["valid_rows"] for s in b.subs]
    assert sorted(map(len, a.terms)) == sorted(map(len, b.terms))
    assert torch.equal(torch.sort(a.lex_lens).values,
                       torch.sort(b.lex_lens).values)
    assert len(set(a.texts)) == len(a.texts)


def test_arrivals_are_a_fixed_multiset_over_the_window():
    a = gen.arrival_offsets(1000, 10.0, SEED)
    b = gen.arrival_offsets(1000, 10.0, SEED + 7)
    assert a[0] == 0.0 and np.all(np.diff(a) > 0) and a[-1] < 10.0
    ga = np.sort(np.diff(np.append(a, 10.0)))
    gb = np.sort(np.diff(np.append(b, 10.0)))
    assert np.allclose(ga, gb) and not np.allclose(a, b)
    assert np.diff(np.append(a, 10.0)).sum() == pytest.approx(10.0)


def test_size_distributions():
    ms = gen.quantile_sizes({"kind": "lognormal", "median": 70,
                             "sigma": 0.4, "min": 16, "max": 128}, 10001)
    assert ms.min() >= 16 and ms.max() == 128
    assert abs(np.median(ms) - 70) <= 1
    pw = gen.quantile_sizes({"kind": "piecewise", "segments": [
        [0.15, 16, 64], [0.25, 65, 128], [0.60, 129, 256]]}, 10000)
    assert np.mean(pw <= 64) == pytest.approx(0.15, abs=1e-3)
    assert np.mean(pw > 128) == pytest.approx(0.60, abs=1e-3)
    assert pw.min() == 16 and pw.max() == 256


@pytest.mark.parametrize("v", [65536, 131072])
def test_vocabulary_words_are_their_own_terms(v):
    from hybrid_rag_colbertv2_tpu_torch.index.textproc import tokenize_lexical
    words = gen.vocab_words(v)
    assert len(set(words)) == v
    text = " ".join(words)
    assert tokenize_lexical(text) == words


def test_lexical_csr_is_the_ports_build_over_the_same_text(monkeypatch):
    """The CSR the harness builds on the device equals LexicalIndex.build
    over the documents written out as text, with the same cap."""
    monkeypatch.setenv("HRAG_NO_NATIVE", "1")
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    n, vocab, cap = 400, 300, 16
    lens = torch.as_tensor(gen.shuffled_sizes(
        {"kind": "lognormal", "median": 20, "sigma": 0.5, "min": 1,
         "max": 60}, n, SEED, "t"))
    tokens = gen.lexical_tokens(lens, vocab, 1.0, SEED)
    term, doc, tf = gen.postings(tokens, lens, n)
    mine = gen.bm25_csr(term, doc, tf, lens, n, vocab, cap)
    words = gen.vocab_words(vocab)
    offs = np.concatenate([[0], np.cumsum(lens.numpy())])
    tok = tokens.numpy()
    texts = [" ".join(words[t] for t in tok[offs[i]:offs[i + 1]])
             for i in range(n)]
    lex = LexicalIndex.build(texts, postings_cap=cap)
    # the port numbers terms by sorted word; map ours onto them
    remap = np.array([lex.vocab.get(w, -1) for w in words])
    used = np.nonzero(np.diff(mine["indptr"]))[0]
    for t in used:
        a, b = mine["indptr"][t], mine["indptr"][t + 1]
        pt = remap[t]
        c, d = lex.indptr[pt], lex.indptr[pt + 1]
        assert np.array_equal(mine["post_docs"][a:b], lex.post_docs[c:d])
        assert np.array_equal(mine["post_weights"][a:b],
                              lex.post_weights[c:d])
    assert mine["nnz"] == int(lex.indptr[-1])
    assert mine["max_postings"] == lex.max_postings
    assert mine["avgdl"] == pytest.approx(lex.avgdl, rel=1e-12)


def test_weights_follow_the_configuration():
    bench, cell, arch = small("jina.trec-covid-open")
    specs = spec.load_model(bench, cell["config"]).param_specs(arch)
    w = gen.make_weights(specs, SEED, "cpu")
    w2 = gen.make_weights(specs, SEED, "cpu")
    assert all(torch.equal(w[k], w2[k]) for k in w)
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import ColBERTModel
    P = serve.port()
    with torch.device("meta"):
        model = ColBERTModel(serve.encoder_config(P, arch))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in w.items()} == want
