"""The frozen operation and byte counts on known shapes."""

import types

import pytest
from conftest import ROOT

from harness import spec, yardstick

H100 = yardstick.PEAKS["H100"]


def test_the_100k_int8_scan_bound():
    """The port's 100k x 128 int8 index at B = 8 (9,591,136 rows that
    hold a token of 12,812,288 stored): 0.636 ms, bound by operations."""
    b, lq, d, n_pad, valid = 8, 32, 128, 100_096, 9_591_136
    flops = yardstick.scan_flops(b, lq, d, valid)
    nbytes = yardstick.scan_int8_bytes(b, lq, d, valid, n_pad * 128, n_pad)
    assert flops == 2 * 8 * 32 * 128 * 9_591_136
    assert nbytes == 8 * 32 * 128 * 4 + 8 * n_pad * 4 + valid * 128 \
        + n_pad * 128 * 4
    bound = yardstick.roofline_bound_s(flops, nbytes, H100)
    assert bound == pytest.approx(0.6355e-3, rel=1e-3)
    assert flops / H100["bf16_flops"] > nbytes / H100["hbm_bytes"]


def test_bytes_bound_when_few_products():
    # one query token against many rows: the bytes dominate
    flops = yardstick.scan_flops(1, 1, 128, 10_000_000)
    nbytes = yardstick.scan_int8_bytes(1, 1, 128, 10_000_000,
                                       10_000_000, 100_000)
    assert yardstick.roofline_bound_s(flops, nbytes, H100) == \
        pytest.approx(nbytes / 3.35e12)


def test_encoder_flops_bert_base():
    arch = dict(hidden_size=768, intermediate_size=3072,
                num_hidden_layers=12, dim=128)
    b, s = 16, 32
    t = b * s
    per_layer = 2 * t * 4 * 768 ** 2 + 4 * b * s * s * 768 \
        + 2 * t * 2 * 768 * 3072
    assert yardstick.encoder_flops(arch, b, s) == \
        12 * per_layer + 2 * t * 768 * 128
    # ~2 x 85M weights per token, plus the small attention term
    assert yardstick.encoder_flops(arch, 1, 32) / 32 == pytest.approx(
        2 * 85.1e6, rel=0.05)


def test_call_flops_routes():
    arch = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                dim=128)
    index = dict(dim=128, k_fuse=50, subs=[
        dict(n_pad=2048, doc_len=128, valid_rows=100_000)])
    enc = yardstick.encoder_flops(arch, 4, 32)
    rerank = yardstick.candidate_flops(4, 50, 32, 128, 128)
    pruned = yardstick.call_flops(arch, {"dense_prefilter": 1000}, index,
                                  4, 32)
    assert pruned == enc + yardstick.proxy_flops(4, 2048, 128) \
        + yardstick.candidate_flops(4, 1024, 32, 128, 128) + rerank
    scan = yardstick.call_flops(arch, {"dense_prefilter": 0}, index, 4, 32)
    assert scan == enc + yardstick.scan_flops(4, 32, 128, 100_000) + rerank


def test_peaks_by_name():
    assert yardstick.peaks_for("NVIDIA H100 80GB HBM3") == H100
    assert yardstick.peaks_for("NVIDIA H100 PCIe") is None
    assert yardstick.peaks_for("cpu") is None


# The index each cell builds (the same for every seed: the generator
# draws one set of lengths and shuffles it) and the FLOPs of one call at
# every count of real queries the cell reaches, pinned from the counts as
# they stood before a configuration's .py could bring its own encoder
# count.
MSMARCO_INDEX = dict(dim=128, k_fuse=50, subs=[
    dict(n_pad=2210560, doc_len=128, valid_rows=163781195)])
CELL_FLOPS = {
    "colbertv2.msmarco-open": (MSMARCO_INDEX, range(1, 17), [
        7171932160.0, 14343864320.0, 21515796480.0, 28687728640.0,
        35859660800.0, 43031592960.0, 50203525120.0, 57375457280.0,
        64547389440.0, 71719321600.0, 78891253760.0, 86063185920.0,
        93235118080.0, 100407050240.0, 107578982400.0, 114750914560.0]),
    "jina.trec-covid-open": (dict(dim=128, k_fuse=50, subs=[
        dict(n_pad=25728, doc_len=64, valid_rows=1028007),
        dict(n_pad=42880, doc_len=128, valid_rows=4133397),
        dict(n_pad=102912, doc_len=256, valid_rows=19788820)]),
        range(1, 17), [
        23343267840.0, 46686535680.0, 70029803520.0, 93373071360.0,
        116716339200.0, 140059607040.0, 163402874880.0, 186746142720.0,
        210089410560.0, 233432678400.0, 256775946240.0, 280119214080.0,
        303462481920.0, 326805749760.0, 350149017600.0, 373492285440.0]),
    "colbertv2.msmarco-exact": (MSMARCO_INDEX, [16], [21555645382656.0]),
}


@pytest.mark.parametrize("cell_name", sorted(CELL_FLOPS))
def test_call_flops_of_the_cells_are_pinned(cell_name):
    """Bit for bit, with no .py and with the configuration's own (which
    brings no encoder count of its own)."""
    bench = spec.load_benchmark(ROOT)
    cell = spec.load_cell(bench, cell_name)
    arch = spec.load_config(bench, cell["config"], ROOT)
    model = spec.load_model(bench, cell["config"], ROOT)
    assert not hasattr(model, "encoder_flops")
    index, batches, want = CELL_FLOPS[cell_name]
    lq = arch["query_maxlen"]
    for m in (None, model):
        got = [yardstick.call_flops(arch, cell["retrieval"], index, b, lq, m)
               for b in batches]
        assert got == want


def test_a_configurations_encoder_flops_is_used():
    """A .py that defines ``encoder_flops`` counts the encoder; the
    rest of the call is counted as before."""
    arch = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                dim=128)
    index = dict(dim=128, k_fuse=50, subs=[
        dict(n_pad=2048, doc_len=128, valid_rows=100_000)])
    model = types.SimpleNamespace(
        encoder_flops=lambda a, batch, seq: 1.0e9 * batch * seq)
    for route in ({"dense_prefilter": 1000}, {"dense_prefilter": 0}):
        plain = yardstick.call_flops(arch, route, index, 4, 32)
        own = yardstick.call_flops(arch, route, index, 4, 32, model)
        assert own == plain - yardstick.encoder_flops(arch, 4, 32) \
            + 1.0e9 * 4 * 32
