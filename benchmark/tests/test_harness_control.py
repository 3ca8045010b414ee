"""The check fails where it must: the control (the reference one
precision step below the configuration's, put in the program's place)
and the faults a served cell can have, planted under the timed path."""

import numpy as np
import pytest
from conftest import small

import control
from harness import compare, runner

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
