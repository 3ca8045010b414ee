"""The harness's tests run on the CPU at small sizes; what needs the card
skips, deciding inside the test."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def small(cell_name: str, n_docs: int = 1500, layers: int = 2):
    """A cell and its configuration cut to CPU size: every width but the
    vocabulary as published is kept where it is cheap; the corpus, the
    depth and the load are small."""
    from harness import spec
    bench = spec.load_benchmark(ROOT)
    cell = copy.deepcopy(spec.load_cell(bench, cell_name))
    arch = copy.deepcopy(spec.load_config(bench, cell["config"], ROOT))
    arch.update(num_hidden_layers=layers, hidden_size=64,
                num_attention_heads=4, intermediate_size=128,
                vocab_size=min(arch["vocab_size"], 4096))
    cell["corpus"].update(n_docs=n_docs, n_topics=16)
    cell["corpus"]["lexical"].update(vocab=2048)
    cell["check"]["sample"] = 16
    if cell["load"]["loop"] == "open":
        cell["load"].update(rate_qps=40, clients=8)
    return bench, cell, arch


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
