"""The check fails where it must: the control (the reference one
precision step below the configuration's, put in the program's place)
and the faults a served cell can have, planted under the timed path."""

import numpy as np
import pytest
import torch
from conftest import small

import control
from harness import compare, reference, runner

CELLS = ["colbertv2.msmarco-open", "jina.trec-covid-open",
         "colbertv2.msmarco-exact"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails(cell_name):
    bench, cell, arch = small(cell_name)
    vals = control.control_numbers(cell_name, 5, "cpu", 16, bench, cell,
                                   arch)
    limits = cell["check"]["limits"]
    assert not compare.judge(vals, limits), vals
    assert vals["score_err"] > limits["score_err"]


# The matmul control's numbers on one small seed, pinned from the harness
# as it stood before the control's step followed the configuration's
# encoder_dtype (TF32 for every matmul).
TF32_CONTROL = {
    "colbertv2.msmarco-open": dict(score_err=0.00033867563582678996,
                                   missing_ids=0.0025,
                                   order_gap=0.00011584758288155731),
    "jina.trec-covid-open": dict(score_err=0.0007940787285320698,
                                 missing_ids=0.0,
                                 order_gap=0.0004221507793230665),
    "colbertv2.msmarco-exact": dict(score_err=0.00033867563582678996,
                                    missing_ids=0.0,
                                    order_gap=0.00011584758288155731),
}


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_float32_control_is_unchanged(cell_name):
    bench, cell, arch = small(cell_name)
    assert arch["encoder_dtype"] == "float32"
    got = control.control_numbers(cell_name, 5, "cpu", 16, bench, cell, arch)
    assert got == TF32_CONTROL[cell_name]


@pytest.mark.parametrize("encoder_dtype, step", [("float32", "tf32"),
                                                 ("bfloat16", "e4m3")])
def test_the_matmul_control_steps_below_the_encoder_dtype(
        encoder_dtype, step, monkeypatch):
    """The control's encoder rounds its matmul inputs one step below the
    configuration's encoder_dtype (fp32 -> TF32, bf16 -> e4m3 with one
    scale per tensor); stage B and the rerank, fp32 in the program
    whatever the encoder's dtype, to TF32; the reference stays fp32."""
    name = "jina.trec-covid-open"
    bench, cell, arch = small(name)
    arch["encoder_dtype"] = encoder_dtype
    made = []
    make = runner.make_reference

    def spy(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]

    monkeypatch.setattr(runner, "make_reference", spy)
    control.control_numbers(name, 5, "cpu", 16, bench, cell, arch)
    ref, ctl = made
    assert (ref.encoder_prec.name, ref.prec.name) == ("fp32", "fp32")
    assert (ctl.encoder_prec.name, ctl.prec.name) == (step, "tf32")
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) / 32
    r = ctl.encoder_prec(x)
    if step == "e4m3":
        s = 448.0 / x.abs().max()
        assert torch.equal(r, (x * s).to(torch.float8_e4m3fn).float() / s)
    else:
        assert torch.equal(r, reference.round_tf32(x))
    # the mantissa bits each step keeps (e4m3: 3, TF32: 10), relative
    # to the tensor's largest magnitude
    keep = {"e4m3": 2.0 ** -4, "tf32": 2.0 ** -11}[step]
    big = x.abs() >= x.abs().max() * 2 ** -6
    assert float(((r - x).abs() / x.abs())[big].max()) <= keep
    assert float(((r - x).abs() / x.abs())[big].max()) > keep / 4


def test_the_dense_control_fails_the_scan():
    """The scan's query one step below the configuration's compute dtype
    (bf16 -> fp8) moves the dense top-k of route 0, which the fused
    answer's ids show."""
    name = "colbertv2.msmarco-exact"
    bench, cell, arch = small(name)
    vals = control.control_numbers(name, 5, "cpu", 16, bench, cell, arch,
                                   lower="dense")
    assert vals["missing_ids"] > cell["check"]["limits"]["missing_ids"], vals


def altered_answer(system):
    """One id of every answer is changed where it is produced."""
    orig = system.retriever.retrieve_batch

    def f(queries, k, **kw):
        ids, scores = orig(queries, k, **kw)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % system.inputs.n_docs
        return ids, scores
    system.retriever.retrieve_batch = f


def half_the_batch(system):
    """Half of each batch is left out; its answers are the rest's."""
    orig = system.retriever.retrieve_batch

    def f(queries, k, **kw):
        h = max(1, (len(queries) + 1) // 2)
        ids, scores = orig(queries[:h], k, **kw)
        rep = np.resize(np.arange(h), len(queries))
        return ids[rep], scores[rep]
    system.retriever.retrieve_batch = f


def altered_score(system):
    """A score changed where it is produced, the ids left right."""
    orig = system.retriever.retrieve_batch

    def f(queries, k, **kw):
        ids, scores = orig(queries, k, **kw)
        scores = scores.copy()
        scores[:, 3] *= 1.001
        return ids, scores
    system.retriever.retrieve_batch = f


@pytest.mark.parametrize("fault", [altered_answer, half_the_batch,
                                   altered_score],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_planted_fault_is_not_correct(cell_name, fault):
    bench, cell, arch = small(cell_name)
    if cell["load"]["loop"] == "open":
        # a batching window long enough that batches hold several
        # queries however fast the CPU answers, so half of one can go
        cell["load"]["window_ms"] = 100.0
    out = runner.run_cell(cell_name, 11, 1.0, False, "cpu", bench=bench,
                          cell=cell, arch=arch, fault=fault)
    assert not out["correct"], out["check"]


def test_the_control_on_the_card(cuda_device):
    """At a cell's own size on the card (run there: the check's upper
    readings come from this)."""
    vals = control.control_numbers("jina.trec-covid-open", 21, cuda_device)
    assert vals["score_err"] > 1e-3
