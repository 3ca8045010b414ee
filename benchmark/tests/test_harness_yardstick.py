"""The frozen operation and byte counts on known shapes."""

import pytest

from harness import yardstick

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
