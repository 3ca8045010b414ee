"""The plain reference against the port at CPU size, and whole runs of
each cell on the CPU with the check passing."""

import numpy as np
import pytest
import torch
from conftest import small

from harness import gen, reference, runner, serve, spec

SEED = 3 * 2**33 + 5


@pytest.mark.parametrize("cell_name", ["colbertv2.msmarco-open",
                                       "jina.trec-covid-open"])
def test_encoder_matches_the_port(cell_name):
    bench, cell, arch = small(cell_name)
    model = spec.load_model(bench, cell["config"])
    P = serve.port()
    w = gen.make_weights(model.param_specs(arch), SEED, "cpu")
    enc = P["ColBERTEncoder"](serve.encoder_config(P, arch),
                              P["HashTokenizer"](arch["vocab_size"]),
                              params=w, device="cpu")
    texts = ["bakok dabuk", " ".join(gen.vocab_words(40)[5:21])]
    ids = reference.query_token_ids(texts, arch["vocab_size"],
                                    arch["query_maxlen"])
    port_ids = np.stack([enc.tokenizer.encode_query(t, arch["query_maxlen"])
                         for t in texts])
    assert np.array_equal(ids.numpy(), port_ids)
    got = enc.encode_queries(texts)
    want = model.encode_queries(w, arch, ids, reference.Precision("fp32"))
    assert torch.allclose(got, want, atol=2e-6, rtol=0)
    tf32 = model.encode_queries(w, arch, ids, reference.Precision("tf32"))
    assert (tf32 - want).abs().max() > 1e-5


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.14159, 0.0])
    r = reference.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0                      # a tie goes to even
    assert r[3] == 1.0 + 2 * 2**-10
    assert abs(r[4] - x[4]) <= 2**-11 * 4 and r[5] == 0.0


@pytest.mark.parametrize("cell_name", ["colbertv2.msmarco-open",
                                       "jina.trec-covid-open",
                                       "colbertv2.msmarco-exact"])
def test_a_run_is_correct_on_the_cpu(cell_name):
    bench, cell, arch = small(cell_name)
    out = runner.run_cell(cell_name, SEED, 1.0, False, "cpu", bench=bench,
                          cell=cell, arch=arch)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert {n: c["value"] for n, c in out["check"].items()} == {
        "score_err": pytest.approx(0.0, abs=1e-5), "missing_ids": 0.0,
        "order_gap": pytest.approx(0.0, abs=1e-5)}
    assert out["e2e"]["setup_s"] > 0
    if cell["load"]["loop"] == "open":
        assert 0 < out["e2e"]["query_p50_ms"] <= out["e2e"]["query_p95_ms"]
    else:
        assert out["e2e"]["qps"] > 0
