"""Frozen operation and byte counts, and the chip's peaks.

The counts are functions of shapes (and, for the full scan, of the rows
that hold a token), never of what the program reports, so a change to
the program cannot move its own yardstick. Tests hold them on known
shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA's data sheet for the H100 SXM part, dense rates: bf16 tensor
# cores, HBM3 bandwidth, fp32 outside the tensor cores
PEAKS = {"H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12,
                  "fp32_flops": 67e12}}


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    """The peaks of a card by its name, or None for a card not listed
    (its shares are then not reported)."""
    for key, p in PEAKS.items():
        if key in device_name and "PCIe" not in device_name:
            return p
    return None


def encoder_flops(arch: Dict, batch: int, seq: int) -> float:
    """Matmul and attention FLOPs of one encoder forward over ``batch``
    sequences of ``seq`` tokens: per layer the q/k/v/out projections, the
    two attention products and the MLP, then the projection head
    (2 FLOPs per multiply-add; no norms, softmax or elementwise work)."""
    h, f = arch["hidden_size"], arch["intermediate_size"]
    layers = arch["num_hidden_layers"]
    tokens = batch * seq
    per_layer = (2 * tokens * 4 * h * h           # q, k, v, out
                 + 2 * 2 * batch * seq * seq * h  # QK^T and PV
                 + 2 * tokens * 2 * h * f)        # intermediate, output
    return float(layers * per_layer + 2 * tokens * h * arch["dim"])


def proxy_flops(batch: int, n_pad: int, dim: int) -> float:
    """Stage A: the (B, D) x (D, N_pad) pooled-proxy product."""
    return 2.0 * batch * n_pad * dim


def candidate_flops(batch: int, cands: int, lq: int, doc_len: int,
                    dim: int) -> float:
    """Stage B or the rerank: fp32 MaxSim over ``cands`` gathered
    candidates of ``doc_len`` rows each (every stored row is multiplied
    by the plain einsum)."""
    return 2.0 * batch * cands * lq * doc_len * dim


def scan_flops(batch: int, lq: int, dim: int, valid_rows: int) -> float:
    """The full MaxSim scan: products for the rows that hold a token."""
    return 2.0 * batch * lq * dim * valid_rows


def scan_int8_bytes(batch: int, lq: int, dim: int, valid_rows: int,
                    stored_rows: int, n_pad: int) -> float:
    """Bytes the int8 scan must move, each once: the fp32 query, the
    int8 rows that hold a token, every row's fp32 scale, and the (B,
    N_pad) fp32 scores."""
    return float(batch * lq * dim * 4 + batch * n_pad * 4
                 + valid_rows * dim + stored_rows * 4)


def roofline_bound_s(flops: float, nbytes: float, peaks: Dict[str, float]
                     ) -> float:
    """The least time the chip could take: the larger of the bf16 tensor
    core time and the HBM time."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"])


def call_flops(arch: Dict, route: Dict, index: Dict, batch: int,
               lq: int, model=None) -> float:
    """FLOPs of one ``retrieve_batch`` call for ``batch`` real queries:
    the encoder, then per sub-index (one flat index, or each bucket)
    stage A and stage B on the pruned route or the full scan on route 0,
    then the rerank of the fused candidates. ``index`` holds ``dim``,
    ``k_fuse`` and ``subs``: [{"n_pad", "doc_len", "valid_rows"}].
    ``model``, the configuration's own ``.py``, counts the encoder with
    its ``encoder_flops(arch, batch, seq)`` where it defines one (a block
    other than BERT's); else ``encoder_flops`` above does."""
    dim = index["dim"]
    count = getattr(model, "encoder_flops", encoder_flops)
    total = float(count(arch, batch, lq))
    for sub in index["subs"]:
        if route["dense_prefilter"] > 0:
            c = min(-(-route["dense_prefilter"] // 128) * 128, sub["n_pad"])
            total += proxy_flops(batch, sub["n_pad"], dim)
            total += candidate_flops(batch, c, lq, sub["doc_len"], dim)
        else:
            total += scan_flops(batch, lq, dim, sub["valid_rows"])
    # the rerank, once per candidate at the longest sub-index's rows
    doc_len = max(sub["doc_len"] for sub in index["subs"])
    total += candidate_flops(batch, index["k_fuse"], lq, doc_len, dim)
    return total
