#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # exits 0 on success; one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop
    python3 chip_smoke.py --variant KERNEL:NAME=DIR ...  # + time other builds

Drives the port's main path (``hybrid_rag_colbertv2_tpu_torch``), never
JAX: builds every CUDA kernel from ``csrc/`` (one nvcc per source, all at
once), holds each kernel against its plain PyTorch version on the card
at doc lengths L = 32, 64, 96, 128, 160 and 256 (every multiple of 32
is taken: a doc's last 64-row chunk is then 32 rows), the float kernels
also on docs with nonzero rows past their length, which their content
mask must score; the int4 and int8-doc kernels also at doc lengths on
every edge of their chunks and groups; the float kernels on docs whose
rows are subnormal, which their mask must drop as XLA does; the int8,
int8-doc, int4 and bf16 kernels 300 times over on an index that stays in
L2), then serves
batches of 8
queries through ``HybridRetriever.retrieve_batch`` with the ``small``
encoder preset (random weights from a seed), on both
dense routes of every flat index layout:

  * ``int8``, ``int8-doc``, ``bfloat16``, ``float32``: one 100,000-chunk x
    128-token x 128-dim corpus (the size of the JAX package's bench.py
    headline), laid out four ways; routes ``dense_prefilter=1024`` (pruned)
    and ``0`` (full scan through the layout's CUDA MaxSim kernel);
  * ``int4-doc``: 1,000,000 chunks x 64 tokens x 128 dims (the JAX
    package's one-chip capacity configuration, bench.py ``run_1m``);
    routes ``2048`` and ``0``.

Token rows are generated on the card in doc blocks and laid out by the
port's own quantizers, so each layout's padding contract holds. Any failed
check raises and exits non-zero.

``retrieve_batch`` serves each batch through ``fused_cascade_fn``: the
encoder and the cascade captured once per (batch, term width) as a CUDA
graph and replayed. The counted run of each route drops its cached
entries first, so the wrappers count the warm-up and the capture of each
graph (two per graph); the profiler counts the kernels each replay
launches. Every layout and route must give the eager path's ids and
scores (bit-equal, or the largest difference held to RTOL, ATOL); two
threads on one retriever must get what each gets alone; a mid-size int8
index grown by ``IndexManager.add_documents`` under a live retriever must
serve the new doc first through a new graph and release the old index's
memory; ``append`` and ``convert`` on a 600-doc index must give the CPU's
results on the card; the 100k int8 index is converted to int4-doc and to
bfloat16 (seconds); the bf16 encoder is held against the CPU.

It also prints the p50 and p90 latency of each layout and route through
the graphs and eagerly (interleaved, with the captures during the timed
calls, which must be 0), each kernel's time beside its bound and its
plain version's time, and (last, so tracing does not touch the timings)
each route's device time by kernel, busy share and host-side launches
per call from torch.profiler, graph and eager. Stdout ends with the ``{"kernels": [...]}`` summary
line, the card's ``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

``--variant KERNEL:NAME=DIR`` (repeatable) names a directory laid out
like ``csrc/`` that holds another version of KERNEL's source (a key of
``KERNELS``: ``maxsim_int8:parent=build/parent/.../csrc`` names that
directory's ``maxsim_int8.cu``) and the headers it includes. Each is
built beside the port's kernels (a failed build is reported, not fatal),
takes the stress launches where its kernel has them (its failures
counted, not fatal), is held against the plain version on the main
path's index of its layout and is timed there beside the port's own
build, in two passes.
"""

from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

REPO = Path(__file__).resolve().parent
PORT = "hybrid_rag_colbertv2_tpu_torch"
JAX_MAXSIM = "hybrid_rag_colbertv2_tpu/ops/maxsim.py"

N_DOCS, DOC_LEN, DIM, BATCH, LQ = 100_000, 128, 128, 8, 32
N_DOCS_INT4, DOC_LEN_INT4 = 1_000_000, 64
N_TOPICS, TOPIC_NOISE = 512, 0.35
PLANTED_DOC = 4242
N_TIMED_CALLS = 40
# launches of each kernel at the main shape that must agree bit for bit
# (the first is held against the plain version)
N_REPEATS = 50
# launches of each bulk- or tensor-copy kernel on a small index that stays
# in L2
N_STRESS = 300
STRESS_KERNELS = ("maxsim_int8", "maxsim_int4_group", "maxsim_int8_doc",
                  "maxsim_bf16")
# kernel vs plain version: fp32 sums in other orders (products are exact)
RTOL, ATOL = 1e-5, 1e-3
# published dense peaks: (bf16 tensor FLOP/s, HBM bytes/s, fp32 FLOP/s on
# the CUDA cores) — NVIDIA data sheets
PEAKS = {"H100 PCIe": (756e12, 2.0e12, 51e12),
         "H100 NVL": (835e12, 3.9e12, 60e12),
         "H200": (989e12, 4.8e12, 67e12),
         "H100": (989e12, 3.35e12, 67e12)}

# name -> (index layout, wrapper, plain version, source, Pallas kernel line);
# each source's C entry point is <name>_launch
KERNELS = {
    "maxsim_int8": ("int8", "maxsim_scores_int8",
                    "maxsim_scores_int8_reference", "maxsim_int8.cu", 231),
    "maxsim_int8_doc": ("int8-doc", "maxsim_scores_int8_doc",
                        "maxsim_scores_int8_doc_reference",
                        "maxsim_int8_doc.cu", 262),
    "maxsim_int4_group": ("int4-doc", "maxsim_scores_int4_doc",
                          "maxsim_scores_int4_doc_reference",
                          "maxsim_int4_group.cu", 294),
    "maxsim_bf16": ("bfloat16", "maxsim_scores", "maxsim_scores_reference",
                    "maxsim.cu", 120),
    "maxsim_f32": ("float32", "maxsim_scores", "maxsim_scores_reference",
                   "maxsim_f32.cu", 120),
}
LAYOUT_KERNEL = {v[0]: k for k, v in KERNELS.items()}
# each kernel's __global__ function, as the profiler names its launches
KERNEL_SYMBOL = {"maxsim_int8": "maxsim_int8_kernel",
                 "maxsim_int8_doc": "maxsim_int8_doc_kernel",
                 "maxsim_int4_group": "maxsim_int4_kernel",
                 "maxsim_bf16": "maxsim_bf16_kernel",
                 "maxsim_f32": "maxsim_f32_kernel"}
# the mid-size int8 index that add_documents grows under a live retriever
N_DOCS_ADD = 20_000
# bf16 activations against fp32 parameters on the CPU: about one bf16 ulp
# (2^-8 of a unit-norm row's element) per encoder layer, as in the tests
BF16_ATOL_PER_LAYER = 2.0**-8
FLOAT_KERNELS = ("maxsim_bf16", "maxsim_f32")
WRAPPERS = ("maxsim_scores", "maxsim_scores_int8", "maxsim_scores_int8_doc",
            "maxsim_scores_int4_doc")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak table entry for {name!r}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def compare(kernel, plain, k: int):
    """-> (max |err| over finite-score docs, ids agree). Checks the
    tolerance, and that the top-k ids agree except where the plain
    version's scores of the swapped ids are within the tolerance."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops.topk import top_k
    if not torch.allclose(kernel, plain, rtol=RTOL, atol=ATOL):
        bad = (kernel - plain).abs().max().item()
        raise AssertionError(f"kernel disagrees with plain version: {bad}")
    live = plain > -1e29
    err = (kernel - plain).abs()[live].max().item() if live.any() else 0.0
    _, ik = top_k(kernel, k)
    _, ip = top_k(plain, k)
    same = bool(torch.equal(ik, ip))
    if not same:
        sk = torch.gather(plain, 1, ik)
        sp = torch.gather(plain, 1, ip)
        if not torch.allclose(sk, sp, rtol=RTOL, atol=ATOL):
            raise AssertionError("kernel top-k ids disagree beyond ties")
    return err, same


def launch_counts():
    from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as ms
    return {w: getattr(ms, w).launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as ms
    for w in WRAPPERS:
        getattr(ms, w).launches = 0


def random_layouts(gen, n, doc_len, dim, device, layouts, plants=None,
                   n_topics=N_TOPICS, n_valid=None, zero_docs=(),
                   zero_rows=(), block=1024):
    """Topic-clustered unit-norm token rows (bench.py's generator),
    lengths in [doc_len/2, doc_len], padding rows zeroed, generated on the
    card in doc blocks and laid out in each of ``layouts`` by the port's
    quantizers. ``plants`` {doc: (rows, D) unit rows} overwrite a doc's
    first rows; docs from ``n_valid`` on, and ``zero_docs``, have length
    0; ``zero_rows`` (doc, row) are valid rows set to zero.
    -> (lengths, {layout: (emb_flat, scales, doc_scales)})"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops.quant import (
        int4_group_size, quantize_int4_groups, quantize_int8_docs,
        quantize_int8_rows)
    n_valid = n if n_valid is None else n_valid
    topics = torch.randn(n_topics, dim, generator=gen, device=device)
    topics = topics / topics.norm(dim=-1, keepdim=True)
    assign = torch.randint(0, n_topics, (n,), generator=gen, device=device)
    lengths = torch.randint(doc_len // 2, doc_len + 1, (n,), generator=gen,
                            device=device, dtype=torch.int32)
    lengths[n_valid:] = 0
    lengths[list(zero_docs)] = 0
    for doc, rows in (plants or {}).items():
        lengths[doc] = max(int(lengths[doc]), rows.shape[0])
    out = {}
    for layout in layouts:
        rows = n * doc_len // 2 if layout == "int4-doc" else n * doc_len
        dtype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}.get(layout, torch.int8)
        emb = torch.empty((rows, dim), dtype=dtype, device=device)
        scales = (torch.empty((n * doc_len,), dtype=torch.float32,
                              device=device) if layout == "int8" else None)
        doc_scales = None
        if layout == "int8-doc":
            doc_scales = torch.empty((n,), dtype=torch.float32, device=device)
        elif layout == "int4-doc":
            doc_scales = torch.empty((doc_len // int4_group_size(doc_len), n),
                                     dtype=torch.float32, device=device)
        out[layout] = (emb, scales, doc_scales)
    tok = torch.arange(doc_len, device=device)
    for s in range(0, n, block):
        e = min(n, s + block)
        x = topics[assign[s:e]][:, None, :] + TOPIC_NOISE * torch.randn(
            e - s, doc_len, dim, generator=gen, device=device)
        x = x / x.norm(dim=-1, keepdim=True)
        for doc, rows in (plants or {}).items():
            if s <= doc < e:
                x[doc - s, :rows.shape[0]] = rows
        for doc, row in zero_rows:
            if s <= doc < e:
                x[doc - s, row] = 0.0
        ln = lengths[s:e]
        x = x * (tok[None, :] < ln[:, None])[..., None]
        for layout, (emb, scales, doc_scales) in out.items():
            if layout == "int8":
                q8, sc = quantize_int8_rows(x.reshape(-1, dim))
                emb[s * doc_len:e * doc_len] = q8
                scales[s * doc_len:e * doc_len] = sc
            elif layout == "int8-doc":
                q8, sc = quantize_int8_docs(x, ln)
                emb[s * doc_len:e * doc_len] = q8
                doc_scales[s:e] = sc
            elif layout == "int4-doc":
                q4, gs = quantize_int4_groups(x, ln)
                emb[s * doc_len // 2:e * doc_len // 2] = q4
                doc_scales[:, s:e] = gs
            else:
                emb[s * doc_len:e * doc_len] = x.reshape(-1, dim).to(
                    emb.dtype)
    return lengths, out


def scan(kernel: str, which: str, q, emb, scales, doc_scales, lengths,
         doc_len: int):
    """Run ``kernel``'s wrapper (``which="kernel"``) or its plain version
    (``"plain"``) over one index."""
    from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as ms
    _, wrapper, plain, _, _ = KERNELS[kernel]
    fn = getattr(ms, wrapper if which == "kernel" else plain)
    if kernel == "maxsim_int8":
        return fn(q, emb, scales, lengths, doc_len=doc_len)
    if doc_scales is not None:
        return fn(q, emb, doc_scales, lengths, doc_len=doc_len)
    return fn(q, emb, lengths, doc_len=doc_len)


def phase_kernel_small(device):
    """Every kernel vs its plain version at small shapes: ragged N,
    zero-length docs, a zeroed valid row, B in {1, 8, 64}, L in {32, 64,
    96, 128, 160, 256} (at 32, 96 and 160 a doc's last chunk is 32 rows);
    the float and int8 kernels also at D = 256 (B = 9: the fp32 kernel's
    query spread over blocks; Lq = 200: in column segments) and D = 16;
    the int8 kernel also at N = 20,000 with D in {192, 208, 256}, a few
    hundred docs per block, so that its transform warps cycle through the
    shallower rings of the wide rows many times."""
    import torch
    gen = torch.Generator(device=device).manual_seed(1)
    every, wide = tuple(KERNELS), FLOAT_KERNELS + ("maxsim_int8",)
    cases = [(1, 64, 1037, 128, LQ, every), (8, 128, 3001, 128, LQ, every),
             (64, 256, 515, 128, LQ, every), (9, 128, 700, 128, LQ, every),
             (3, 64, 77, 32, LQ, every), (8, 32, 1001, 128, LQ, every),
             (9, 96, 515, 128, LQ, every), (3, 160, 301, 64, LQ, every),
             (64, 96, 99, 32, LQ, every), (9, 128, 300, 256, LQ, wide),
             (2, 64, 150, 256, 200, wide), (2, 96, 151, 256, 200, wide),
             (5, 64, 333, 16, LQ, wide), (5, 160, 133, 16, LQ, wide),
             (8, 96, 20_000, 256, LQ, ("maxsim_int8",)),
             (9, 128, 20_011, 208, LQ, ("maxsim_int8",)),
             (8, 32, 20_000, 192, LQ, ("maxsim_int8",))]
    for b, doc_len, n, dim, lq, kernels in cases:
        zero = (0, n // 2)
        lengths, stores = random_layouts(
            gen, n, doc_len, dim, device,
            sorted({KERNELS[k][0] for k in kernels}), n_topics=16,
            zero_docs=zero, zero_rows=((5, 1),), block=256)
        q = torch.randn(b, lq, dim, generator=gen, device=device)
        q = q / q.norm(dim=-1, keepdim=True)
        q[:, lq - 3:] = 0.0                           # padded query rows
        for kernel in kernels:
            emb, scales, doc_scales = stores[KERNELS[kernel][0]]
            out = scan(kernel, "kernel", q, emb, scales, doc_scales,
                       lengths, doc_len)
            torch.cuda.synchronize()
            ref = scan(kernel, "plain", q, emb, scales, doc_scales, lengths,
                       doc_len)
            err, same = compare(out, ref, min(100, n))
            zl = out[:, list(zero)]
            if doc_scales is not None:
                if not (zl == 0).all():
                    raise AssertionError(
                        f"{kernel}: zero-length docs must score exactly 0")
            elif not (zl < -1e31).all():
                raise AssertionError(
                    f"{kernel}: zero-length docs must score -1e30 * Lq")
            log(f"kernel {kernel} B={b} Lq={lq} L={doc_len} N={n} D={dim}: "
                f"max_abs_err={err:.3e} top100_ids_equal={same}")


# doc lengths on the edges of each length-skipping kernel's design (those
# up to L are taken), and its cases (B, L, N, D, Lq)
EDGE_LENGTHS = {
    "maxsim_int4_group": (0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 56, 63, 64,
                          65, 95, 96, 97, 127, 128, 129, 159, 160, 161, 191,
                          192),
    "maxsim_int8_doc": (0, 1, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128,
                        129, 159, 160),
}
EDGE_CASES = {
    "maxsim_int4_group": [
        (1, 64, 1037, 64, LQ), (9, 128, 515, 128, LQ), (64, 64, 301, 16, LQ),
        (2, 64, 150, 256, 200), (9, 128, 333, 256, LQ), (3, 64, 77, 128, 200),
        (1, 192, 131, 64, LQ), (8, 64, 20_000, 256, LQ),
        (9, 128, 20_011, 208, LQ), (8, 64, 20_000, 192, LQ),
        (8, 32, 1001, 128, LQ), (9, 96, 515, 128, LQ), (3, 160, 333, 64, LQ),
        (2, 96, 150, 256, 200), (8, 160, 20_000, 208, LQ)],
    "maxsim_int8_doc": [
        (1, 128, 1037, 64, LQ), (9, 160, 515, 128, LQ),
        (64, 128, 301, 16, LQ), (2, 128, 150, 256, 200),
        (9, 160, 333, 256, LQ), (3, 160, 77, 128, 200),
        (8, 128, 3001, 128, LQ), (8, 160, 20_000, 256, LQ),
        (9, 128, 20_011, 208, LQ), (8, 160, 20_000, 192, LQ)],
}


def phase_length_edges(device):
    """The kernels that skip 64-row chunks by doc length
    (``maxsim_int4_group``, ``maxsim_int8_doc``) vs their plain versions
    where that design has edges: doc lengths on every 64-row chunk edge,
    every 32-row half chunk (at L = 32, 96 and 160 a doc's last chunk is
    32 rows) and, for int4, every 8-row group (partly and fully padded
    groups); N a multiple of neither 4 nor the docs per block, D from 16
    to 256, B in {1, 9, 64} (query rows ending mid m-tile, several column
    tiles) and Lq = 200 (column segments at D = 256); and N = 20,000 at
    D in {192, 208, 256}, a few hundred docs per block, so that the
    transform warps cycle through the shallower tile rings of the wide
    rows many times. Zero-length docs must score exactly 0; five launches
    must agree bit for bit."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops.quant import (
        quantize_int4_groups, quantize_int8_docs)
    gen = torch.Generator(device=device).manual_seed(3)
    quantize = {"maxsim_int4_group": quantize_int4_groups,
                "maxsim_int8_doc": quantize_int8_docs}
    for kernel, cases in EDGE_CASES.items():
        for b, doc_len, n, dim, lq in cases:
            ends = tuple(e for e in EDGE_LENGTHS[kernel] if e <= doc_len)
            lengths = torch.tensor([ends[i % len(ends)] for i in range(n)],
                                   dtype=torch.int32, device=device)
            x = torch.randn(n, doc_len, dim, generator=gen, device=device)
            x = x / x.norm(dim=-1, keepdim=True)
            x *= (torch.arange(doc_len, device=device)[None, :]
                  < lengths[:, None])[..., None]
            emb, doc_scales = quantize[kernel](x, lengths)
            q = torch.randn(b, lq, dim, generator=gen, device=device)
            q = q / q.norm(dim=-1, keepdim=True)
            q[:, lq - 3:] = 0.0
            args = (q, emb, None, doc_scales, lengths, doc_len)
            out = scan(kernel, "kernel", *args)
            for _ in range(4):
                if not torch.equal(out, scan(kernel, "kernel", *args)):
                    raise AssertionError(f"{kernel}: launches differ")
            torch.cuda.synchronize()
            err, same = compare(out, scan(kernel, "plain", *args), min(100, n))
            if not (out[:, lengths == 0] == 0).all():
                raise AssertionError(f"{kernel}: zero-length docs must score "
                                     "exactly 0")
            log(f"kernel {kernel} edges B={b} Lq={lq} L={doc_len} N={n} "
                f"D={dim} lengths {ends}: max_abs_err={err:.3e} "
                f"top100_ids_equal={same}, 5 launches bit-equal")


def kernel_launcher(kernel, csrc, q, emb, scales, doc_scales, lengths,
                    doc_len):
    """-> run() that launches ``kernel`` built from ``csrc`` (the port's
    own, or a ``--variant``) on one index's operands, as its wrapper
    does; uncounted."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as ms
    layout, _, _, source, _ = KERNELS[kernel]
    b, lq, d = q.shape
    n = lengths.shape[0]
    qk = q.to(emb.dtype if layout in ("bfloat16", "float32")
              else torch.bfloat16).contiguous()
    lengths = lengths.to(torch.int32)
    operands = {"int8": (scales,), "int8-doc": (doc_scales, lengths),
                "int4-doc": (doc_scales, lengths)}.get(layout, ())

    def run():
        out = torch.empty((b, n), dtype=torch.float32, device=q.device)
        ms._launch(source[:-3], f"{kernel}_launch", q.device,
                   (qk, emb, *operands, out), (b, lq, d, n, doc_len),
                   csrc=csrc)
        return out
    return run


def stress_index(kernel, gen, device, b, doc_len, n, dim):
    """The stress phase's index of ``kernel``'s layout (rows past each
    length zero) and its queries. -> (q, emb, scales, doc_scales,
    lengths)"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops.quant import (
        quantize_int4_groups, quantize_int8_docs, quantize_int8_rows)
    lengths = torch.randint(doc_len // 2, doc_len + 1, (n,), generator=gen,
                            device=device, dtype=torch.int32)
    if kernel == "maxsim_int8_doc":
        lengths[::50] = 0              # no live chunk: scored exactly 0
    x = torch.randn(n, doc_len, dim, generator=gen, device=device)
    x = x / x.norm(dim=-1, keepdim=True)
    x *= (torch.arange(doc_len, device=device)[None, :]
          < lengths[:, None])[..., None]
    q = torch.randn(b, LQ, dim, generator=gen, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    if kernel == "maxsim_int8":
        emb, scales = quantize_int8_rows(x.reshape(-1, dim))
        return q, emb, scales, None, lengths
    if kernel == "maxsim_bf16":
        return q, x.reshape(-1, dim).to(torch.bfloat16), None, None, lengths
    quantize = (quantize_int8_docs if kernel == "maxsim_int8_doc"
                else quantize_int4_groups)
    emb, doc_scales = quantize(x, lengths)
    return q, emb, None, doc_scales, lengths


def phase_stress(device, variants):
    """Each bulk- or tensor-copy kernel (``STRESS_KERNELS``) N_STRESS
    times on a small index that stays in L2 (B=8, Lq=32, L=128, N=3001,
    D=128), where copies land fast: each launch must agree with the plain
    version and bit for bit with the first (the int8-doc index's
    zero-length docs exactly 0). Without a proxy fence between a warp's
    reads of a copied stage and the copy that refills it, most int4
    launches here scored wrong. Each ``--variant`` of these kernels takes the same
    launches; its failures are counted, not fatal."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops import _build
    gen = torch.Generator(device=device).manual_seed(4)
    b, doc_len, n, dim = 8, 128, 3001, 128
    for kernel in STRESS_KERNELS:
        q, emb, scales, doc_scales, lengths = stress_index(
            kernel, gen, device, b, doc_len, n, dim)
        ref = scan(kernel, "plain", q, emb, scales, doc_scales, lengths,
                   doc_len)
        for name, csrc in (("port", _build.CSRC), *variants.get(kernel, ())):
            run = kernel_launcher(kernel, csrc, q, emb, scales, doc_scales,
                                  lengths, doc_len)
            first = run()
            wrong = differ = 0
            for _ in range(N_STRESS):
                out = run()
                wrong += not torch.allclose(out, ref, rtol=RTOL, atol=ATOL)
                differ += not torch.equal(out, first)
            msg = (f"{N_STRESS} launches at B={b} L={doc_len} N={n} D={dim}:"
                   f" {wrong} disagree with the plain version, {differ} "
                   "differ from the first")
            if name != "port":
                log(f"{kernel} variant {name} stress: {msg}")
                continue
            err, _ = compare(first, ref, 100)
            if wrong or differ:
                raise AssertionError(f"{kernel} stress: {msg}")
            if doc_scales is not None and not (
                    first[:, lengths == 0] == 0).all():
                raise AssertionError(f"{kernel} stress: zero-length docs "
                                     "must score exactly 0")
            log(f"kernel {kernel} stress: {msg}; max_abs_err={err:.3e}")


def phase_float_skip(device):
    """The float kernels skip rows by content: each holds its plain
    version on docs whose last nonzero row sits at every offset around
    the 8-row groups and 64-row chunks, on docs with nonzero rows past
    their length (the plain version scores them: a skip by length would
    drop them), on docs with zero rows inside their length, and on docs
    whose rows inside their length are all subnormal (masked, as XLA
    counts subnormal values as zero) but for one row with one normal
    value among subnormals (which counts)."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as ms
    gen = torch.Generator(device=device).manual_seed(2)
    b, n, doc_len, dim = 3, 301, 192, 128
    q = torch.randn(b, LQ, dim, generator=gen, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    q[:, LQ - 3:] = 0.0
    x = torch.randn(n, doc_len, dim, generator=gen, device=device)
    x = x / x.norm(dim=-1, keepdim=True)
    ends = (0, 1, 2, 7, 8, 9, 15, 16, 17, 56, 57, 63, 64, 65, 71, 72, 73,
            127, 128, 129, 184, 185, 191, 192)
    lengths = torch.tensor([ends[i % len(ends)] for i in range(n)],
                           dtype=torch.int32, device=device)
    x *= (torch.arange(doc_len, device=device)[None, :]
          < lengths[:, None])[..., None]
    # rows past the length: a copy of query 0's first token, so it raises
    # that query's score by ~0.7 over the length-masked oracle's
    past = {(1, 70), (2, 191), (3, 9), (4, 64), (24, 130), (26, 63)}
    for doc, row in past:
        assert row >= int(lengths[doc]), (doc, row)
        x[doc, row] = q[0, 0]
    for doc, rows in ((20, range(0, 8)), (12, (63,)), (13, (64,)),
                      (18, range(8, 16)), (19, range(120, 128))):
        assert max(rows) < int(lengths[doc]), (doc, rows)
        x[doc, list(rows)] = 0.0
    # rows of subnormal values (+-1e-40 .. 1e-38) inside the length: masked
    # in docs 30, 40 and 43 (15, 72, 128 rows); doc 41 (73 rows) also
    # holds one normal value, in row 70, which counts
    sub_docs, mixed = (30, 40, 43), (41, 70)
    for doc in (*sub_docs, mixed[0]):
        ln = int(lengths[doc])
        mag = torch.rand(ln, dim, generator=gen, device=device) * 1e-38 + 1e-40
        x[doc, :ln] = torch.where(torch.rand(ln, dim, generator=gen,
                                             device=device) < 0.5, -mag, mag)
    x[mixed[0], mixed[1], 5] = 0.5
    docs_past = sorted({d for d, _ in past})
    zero_docs = [d for d in range(n)
                 if lengths[d] == 0 and d not in docs_past] + list(sub_docs)
    oracle = ms.maxsim_scores_exact(q, x, lengths)
    for kernel in FLOAT_KERNELS:
        dtype = torch.float32 if kernel == "maxsim_f32" else torch.bfloat16
        emb = x.reshape(n * doc_len, dim).to(dtype)
        out = scan(kernel, "kernel", q, emb, None, None, lengths, doc_len)
        torch.cuda.synchronize()
        ref = scan(kernel, "plain", q, emb, None, None, lengths, doc_len)
        err, same = compare(out, ref, 100)
        if not (out[:, zero_docs] < -1e31).all():
            raise AssertionError(f"{kernel}: all-zero and all-subnormal "
                                 "docs must score -1e30 * Lq")
        if not (out[:, mixed[0]] > -1e3).all():
            raise AssertionError(f"{kernel}: a normal value among "
                                 "subnormals must count")
        if not (out[0, docs_past] > oracle[0, docs_past] + 0.5).all():
            raise AssertionError(f"{kernel}: rows past a doc's length must "
                                 "count")
        log(f"kernel {kernel} skip by content, L={doc_len} N={n}: "
            f"max_abs_err={err:.3e} top100_ids_equal={same}; "
            f"{len(zero_docs)} all-zero or all-subnormal docs at "
            f"-1e30*Lq, a normal value among subnormals counted, rows past "
            f"the length counted in docs {docs_past}")


def build_lexical(n_docs: int, seed: int):
    import numpy as np
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    rng = np.random.default_rng(seed)
    vocab = np.array([f"term{i}" for i in range(5_000)])
    corpus = [" ".join(r) for r in vocab[rng.integers(0, 5_000,
                                                      (n_docs, 12))]]
    lex = LexicalIndex.build(corpus, postings_cap=512)
    queries = [" ".join(rng.choice(vocab, 6)) for _ in range(4 * BATCH)]
    return lex, corpus, queries


def make_paths(device, encoder, gen):
    """The five layouts' indexes, managers and retrievers.
    -> {layout: dict(dense, routes {prefilter: retriever}, batches, lex)}"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.ops.prefilter import (
        pooled_doc_embeddings)
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)
    specs = [(("int8", "int8-doc", "bfloat16", "float32"), N_DOCS, DOC_LEN,
              1024, 0), (("int4-doc",), N_DOCS_INT4, DOC_LEN_INT4, 2048, 1)]
    paths = {}
    for layouts, n_docs, doc_len, prefilter, seed in specs:
        t0 = time.perf_counter()
        lex, corpus, queries = build_lexical(n_docs, seed)
        log(f"lexical: {n_docs} docs, max_postings={lex.max_postings}, "
            f"{time.perf_counter() - t0:.1f}s")
        plant = encoder.encode_queries([queries[0]])[0].clone()  # (Lq, D)
        n_pad = ((n_docs + 127) // 128) * 128
        t0 = time.perf_counter()
        lengths, stores = random_layouts(
            gen, n_pad, doc_len, DIM, device, layouts, n_valid=n_docs,
            plants={PLANTED_DOC: plant})
        batches = [queries[i:i + BATCH] for i in range(0, 3 * BATCH, BATCH)]
        for layout in layouts:
            emb, scales, doc_scales = stores.pop(layout)
            pooled = pooled_doc_embeddings(
                emb, scales, lengths, doc_len=doc_len, doc_scales=doc_scales,
                packed_int4=layout == "int4-doc")
            dense = DenseTokenIndex(
                emb_flat=emb, doc_lengths=lengths, n_docs=n_docs,
                doc_len=doc_len, dim=DIM, scales=scales, pooled=pooled,
                doc_scales=doc_scales)
            assert dense.quant == layout, (dense.quant, layout)
            mgr = IndexManager(RAGConfig(), encoder, device=device)
            mgr.lexical, mgr.dense, mgr.corpus = lex, dense, corpus
            routes = {p: HybridRetriever(
                RAGConfig(dense_prefilter=p, final_fusion="rerank",
                          bm25_postings_cap=512), mgr, encoder,
                device=device) for p in (prefilter, 0)}
            paths[layout] = dict(dense=dense, routes=routes, lex=lex,
                                 batches=batches)
        torch.cuda.synchronize()
        log(f"dense indexes {', '.join(layouts)}: {n_pad} x {doc_len} x "
            f"{DIM}, "
            + ", ".join(f"{paths[lay]['dense'].memory_bytes() / 1e9:.2f}"
                        for lay in layouts)
            + f" GB on the card, {time.perf_counter() - t0:.1f}s")
    return paths


def drop_entries(dense) -> None:
    """Drop every cached fused entry (and its graphs) over ``dense``."""
    from hybrid_rag_colbertv2_tpu_torch.retrieval import cascade
    ids = {id(dense.emb_flat)}
    cascade._FUSED_CACHE.drop_where(lambda _k, e: e.reads_any(ids))


def run_path(layout, path) -> int:
    """The counted run of one layout's main path: 3 batches per route,
    the counts set to 0 just before each route and read just after. The
    layout's fused entries are dropped first, so the run captures its
    graph: the route-0 wrapper counts the eager warm-up and the capture
    of its kernel, two per graph, and the replays launch it from the
    graph (the profiler counts those, ``profile_calls``).
    -> launches of the layout's kernel on route 0."""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import FusedCascade
    wrapper = KERNELS[LAYOUT_KERNEL[layout]][1]
    n_docs = path["dense"].n_docs
    launches = 0
    for p, r in path["routes"].items():
        drop_entries(path["dense"])
        reset_launch_counts()
        caps = FusedCascade.captures
        outs = [r.retrieve_batch(b) for b in path["batches"]]
        torch.cuda.synchronize()
        counts = launch_counts()
        caps = FusedCascade.captures - caps
        want = {w: (2 * caps if p == 0 and w == wrapper else 0)
                for w in WRAPPERS}
        if caps < 1 or counts != want:
            raise AssertionError(f"{layout} route {p}: launches {counts} "
                                 f"over {caps} captures, want {want}")
        if p == 0:
            launches = counts[wrapper]
        for ids, scores in outs:
            if ids.shape != (BATCH, 10) or not (
                    (ids >= -1) & (ids < n_docs)).all():
                raise AssertionError(f"bad ids on {layout} route {p}: {ids}")
            if not np.isfinite(scores[ids >= 0]).all():
                raise AssertionError(f"non-finite scores on {layout} "
                                     f"route {p}")
        rank1 = int(outs[0][0][0, 0])
        log(f"{layout} dense_prefilter={p}: {caps} graph(s) captured over "
            f"{len(outs)} batches, {counts[wrapper]} counted launches of "
            f"{wrapper} (warm-up and capture); planted doc {PLANTED_DOC} "
            f"-> rank-1 id {rank1}")
        if rank1 != PLANTED_DOC:
            raise AssertionError("planted query must return its doc first")
    return launches


def eager_batch(r, batch):
    """``retrieve_batch``'s work with its fused entry run eagerly, op by
    op: tokenize, then encoder + cascade. -> (ids, scores) numpy"""
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        pack_query_batch)
    cfg = r.config
    fused = r._build_fused(min(cfg.final_top_k, cfg.fusion_candidates,
                               r.indexes.dense.n_docs))
    packed = pack_query_batch(r.encoder, r.indexes.lexical, batch,
                              cfg.query_max_terms, cfg.query_term_buckets)
    return fused.eager(packed)


def phase_graph_vs_eager(paths) -> None:
    """Every layout and route: the graph replay and the eager run of the
    same entry give equal ids and bit-equal scores (else the largest
    difference, held to RTOL, ATOL: an algorithm that cuBLAS picks under
    capture may sum in another order)."""
    import numpy as np
    for lay, path in paths.items():
        for p, r in path["routes"].items():
            worst, bit_equal = 0.0, True
            for b in path["batches"]:
                gi, gs = r.retrieve_batch(b)
                ei, es = eager_batch(r, b)
                if not np.array_equal(gi, ei):
                    raise AssertionError(f"{lay} route {p}: graph ids "
                                         f"{gi} vs eager {ei}")
                if not np.allclose(gs, es, rtol=RTOL, atol=ATOL):
                    raise AssertionError(f"{lay} route {p}: graph scores "
                                         "disagree with eager")
                worst = max(worst, float(np.abs(gs - es).max()))
                bit_equal &= bool(np.array_equal(gs, es))
            log(f"graph vs eager {lay} dense_prefilter={p}: ids equal, "
                f"scores bit-equal={bit_equal}, max |diff| {worst:.3e}")


def phase_threads(path) -> None:
    """Two threads on one retriever (route 0), 20 calls each on their
    own batch, get the ids and scores each gets alone."""
    import numpy as np
    r = path["routes"][0]
    batches = path["batches"][:2]
    solo = [r.retrieve_batch(b) for b in batches]
    wrong = []

    def work(i):
        for _ in range(20):
            ids, scores = r.retrieve_batch(batches[i])
            if not (np.array_equal(ids, solo[i][0])
                    and np.array_equal(scores, solo[i][1])):
                wrong.append(i)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or wrong:
        raise AssertionError(f"concurrent calls on one retriever: "
                             f"{len(wrong)} of 40 differ from alone")
    log("threads: 2 x 20 concurrent retrieve_batch calls on one retriever "
        "give each batch's ids and scores alone, bit for bit")


def phase_add_documents(device, encoder, gen) -> None:
    """A live int8 retriever (route 0) over a mid-size index: after
    ``IndexManager.add_documents`` appends a new chunk, the next call
    rebinds, evicts the old binding's entries, captures a new graph and
    ranks the new chunk first; the old index's tensors die and its bytes
    leave ``torch.cuda.memory_allocated``."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.ops.prefilter import (
        pooled_doc_embeddings)
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        FusedCascade, HybridRetriever)
    n = N_DOCS_ADD
    n_pad = ((n + 127) // 128) * 128
    lex, corpus, queries = build_lexical(n, 2)
    lengths, stores = random_layouts(gen, n_pad, DOC_LEN, DIM, device,
                                     ("int8",), n_valid=n)
    emb, scales, _ = stores.pop("int8")
    pooled = pooled_doc_embeddings(emb, scales, lengths, doc_len=DOC_LEN)
    root = REPO / "build" / "smoke_add"
    cfg = RAGConfig(bm25_index_path=str(root / "bm25"),
                    colbert_index_path=str(root / "colbert"),
                    dense_prefilter=0, final_fusion="rerank",
                    bm25_postings_cap=512)
    mgr = IndexManager(cfg, encoder, device=device)
    mgr.lexical, mgr.corpus = lex, corpus
    mgr.dense = DenseTokenIndex(emb_flat=emb, doc_lengths=lengths, n_docs=n,
                                doc_len=DOC_LEN, dim=DIM, scales=scales,
                                pooled=pooled)
    del emb, scales, lengths, pooled
    r = HybridRetriever(cfg, mgr, encoder, device=device)
    batch = queries[:BATCH]
    r.retrieve_batch(batch)
    torch.cuda.synchronize()
    old_bytes = mgr.dense.memory_bytes()
    alive = weakref.ref(mgr.dense.emb_flat)
    before = torch.cuda.memory_allocated()
    new_doc = "zyzzyva glossolalia xylophone quixotic marker chunk"
    t0 = time.perf_counter()
    mgr.add_documents(corpus + [new_doc])
    t_add = time.perf_counter() - t0
    caps = FusedCascade.captures
    ids, _ = r.retrieve_batch([new_doc] + batch[1:])
    caps = FusedCascade.captures - caps
    torch.cuda.synchronize()
    gc.collect()
    after = torch.cuda.memory_allocated()
    new_bytes = mgr.dense.memory_bytes()
    log(f"add_documents: {n} -> {mgr.dense.n_docs} docs in {t_add:.2f}s "
        f"(lexical rebuild, encode 1, append, save); next call captured "
        f"{caps} graph(s), rank-1 id {int(ids[0, 0])}; memory_allocated "
        f"{(after - before) / 2**20:+.1f} MiB with the old index "
        f"{old_bytes / 2**20:.1f} MiB, the new {new_bytes / 2**20:.1f} MiB")
    if int(ids[0, 0]) != n or caps < 1:
        raise AssertionError("the appended chunk must rank first through a "
                             "new graph")
    if alive() is not None:
        raise AssertionError("the old index is still referenced")
    if after - before > new_bytes - old_bytes + 64 * 2**20:
        raise AssertionError("the old index's memory was not released")
    drop_entries(mgr.dense)


def phase_maintenance_small(device) -> None:
    """``append`` and ``convert`` of a 600-doc index (L = 64) in every
    layout on the card and on the CPU: codes and lengths bit-equal,
    scales within rtol 1e-6, the bf16 proxies within one bf16 ulp (fp32
    token sums in other orders)."""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    layouts = ("int8", "int8-doc", "int4-doc", "bfloat16", "float32")
    rng = np.random.default_rng(6)

    def embs(n):
        x = rng.standard_normal((n, 64, DIM)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        return x, rng.integers(0, 65, n).astype(np.int32)

    def same(card, cpu, what):
        for name in ("emb_flat", "doc_lengths", "scales", "doc_scales"):
            a, b = getattr(card, name), getattr(cpu, name)
            if (a is None) != (b is None):
                raise AssertionError(f"{what}: {name} present on one side")
            if a is None:
                continue
            a = a.cpu()
            ok = (torch.allclose(a, b, rtol=1e-6, atol=0)
                  if name.endswith("scales") else torch.equal(a, b))
            if not ok:
                raise AssertionError(f"{what}: {name} differs card vs CPU")
        if not torch.allclose(card.pooled.cpu().float(), cpu.pooled.float(),
                              rtol=2.0**-7, atol=1e-6):
            raise AssertionError(f"{what}: pooled differs card vs CPU")

    (x, ln), (x2, ln2) = embs(600), embs(77)
    for src in layouts:
        idx = {}
        for dev in (device, torch.device("cpu")):
            t = DenseTokenIndex.build(torch.from_numpy(x).to(dev),
                                      torch.from_numpy(ln), doc_len=64,
                                      dtype=src)
            idx[dev.type] = t.append(torch.from_numpy(x2),
                                     torch.from_numpy(ln2))
        same(idx["cuda"], idx["cpu"], f"append {src}")
        for dst in layouts:
            if dst != src:
                same(idx["cuda"].convert(dst, block=256),
                     idx["cpu"].convert(dst, block=256),
                     f"convert {src} -> {dst}")
    log("append (600 + 77 docs) and convert (20 layout pairs) on the card "
        "equal the CPU's: codes bit-equal, scales rtol 1e-6, proxies "
        "within one bf16 ulp")


def phase_convert_main(path) -> None:
    """Seconds to convert the main 100k int8 index to int4-doc and to
    bfloat16 on the card (4096-doc blocks, proxies included)."""
    import torch
    dense = path["dense"]
    for dst in ("int4-doc", "bfloat16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dense.convert(dst)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"convert {dense.n_docs} docs x {dense.doc_len} int8 -> {dst} "
            f"on the card: {secs:.3f} s ({out.memory_bytes() / 1e9:.2f} GB "
            f"out)")
        del out


def phase_bf16_encoder(device) -> None:
    """The ``small`` encoder with bf16 activations (fp32 parameters from
    one seed) on the card against the CPU: queries and docs within
    BF16_ATOL_PER_LAYER per layer."""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    cfg = ColBERTConfig.small(vocab_size=8192, dtype=torch.bfloat16)
    texts = [" ".join(f"term{(i * 37 + j) % 997}" for j in range(5 + i % 40))
             for i in range(64)]
    out = {}
    for dev in (device, torch.device("cpu")):
        enc = ColBERTEncoder(cfg, HashTokenizer(8192), seed=0, device=dev)
        q = enc.encode_queries(texts[:BATCH])
        d, ln = enc.encode_docs(texts, doc_len=64)
        if q.dtype != torch.bfloat16 or d.dtype != torch.bfloat16:
            raise AssertionError("bf16 encoder must emit bf16")
        out[dev.type] = (q.float().cpu().numpy(), d.float().cpu().numpy(),
                         ln.cpu().numpy())
    tol = BF16_ATOL_PER_LAYER * cfg.num_layers
    errs = [float(np.abs(a - b).max())
            for a, b in zip(out["cuda"][:2], out["cpu"][:2])]
    if max(errs) > tol or not np.array_equal(out["cuda"][2], out["cpu"][2]):
        raise AssertionError(f"bf16 encoder card vs CPU: {errs} > {tol}")
    log(f"bf16 encoder (small, {cfg.num_layers} layers) card vs CPU: max "
        f"|diff| queries {errs[0]:.3e}, docs {errs[1]:.3e} (limit {tol:.3e})")


def check_dense_top100(layout, path, encoder, device):
    """The scan route's dense top-100 (from the cascade) vs the plain
    version + top-k over the same index."""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops.topk import top_k
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        hybrid_cascade)
    dense, r0 = path["dense"], path["routes"][0]
    batch = path["batches"][0]
    q_emb = encoder.encode_queries(batch)
    q_terms = torch.as_tensor(
        np.stack([path["lex"].encode_query(q, 32) for q in batch]),
        device=device)
    with torch.inference_mode():
        _, _, dbg = hybrid_cascade(
            q_emb, q_terms, r0._lex_dev["indptr"], r0._lex_dev["post_docs"],
            r0._lex_dev["post_weights"], dense.emb_flat, dense.scales,
            dense.doc_lengths, None, dense.doc_scales, **r0._statics(10))
    plain = scan(LAYOUT_KERNEL[layout], "plain", q_emb, dense.emb_flat,
                 dense.scales, dense.doc_scales, dense.doc_lengths,
                 dense.doc_len)[:, :dense.n_docs]
    pv, pi = top_k(plain, 100)
    kv, ki = dbg["ms_vals"], dbg["ms_ids"].long()
    if not torch.allclose(kv, pv, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{layout}: dense top-100 values differ")
    ids_equal = bool(torch.equal(ki, pi))
    if not ids_equal and not torch.allclose(
            torch.gather(plain, 1, ki), pv, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{layout}: dense top-100 ids differ beyond "
                             "ties")
    log(f"{layout} scan route dense top-100 vs plain: ids_equal={ids_equal}")
    return q_emb


def kernel_numbers(kernel, path, q_emb, peaks, variants=()):
    """Kernel vs plain at the main shape (N_REPEATS launches bit-equal),
    their times by CUDA events, the
    bf16 (fp32 for the fp32 kernel) matmul of the product alone where it
    fits in memory, and the bound from this run's inputs: products only
    for valid rows (the rest are masked or copies); bytes of what the
    function must read (the float scan masks by content, so it reads
    every row) and of its output."""
    import torch
    dense = path["dense"]
    layout = KERNELS[kernel][0]
    args = (q_emb, dense.emb_flat, dense.scales, dense.doc_scales,
            dense.doc_lengths, dense.doc_len)
    full = scan(kernel, "kernel", *args)
    for _ in range(N_REPEATS - 1):
        if not torch.equal(full, scan(kernel, "kernel", *args)):
            raise AssertionError(f"{kernel}: launches differ")
    ref = scan(kernel, "plain", *args)
    err, same = compare(full, ref, 100)
    if variants:
        variant_numbers(kernel, variants, dense, q_emb, ref)
    del full, ref
    k_ms = cuda_ms(lambda: scan(kernel, "kernel", *args), 20)
    p_ms = cuda_ms(lambda: scan(kernel, "plain", *args), 3, warmup=1)
    b, lq, d = q_emb.shape
    n_pad, doc_len = dense.n_pad, dense.doc_len
    rows = n_pad * doc_len
    mm_ms = None
    if rows * b * lq * 4 < 20e9:   # the (rows, B*Lq) fp32 product fits
        if layout == "float32":
            a = dense.emb_flat
            qt = q_emb.reshape(-1, d).T.contiguous()
        else:
            a = (dense.emb_flat if layout == "bfloat16"
                 else dense.emb_flat.to(torch.bfloat16))
            qt = q_emb.reshape(-1, d).to(torch.bfloat16).T.contiguous()
        mm_ms = cuda_ms(lambda: torch.matmul(a, qt), 10)
        del a
    if layout == "int8":
        valid_rows = int((dense.scales > 0).sum())
    else:
        valid_rows = int(dense.doc_lengths.sum())
    flops = 2.0 * b * lq * d * valid_rows
    nbytes = q_emb.numel() * q_emb.element_size() + b * n_pad * 4
    if layout == "int8":
        nbytes += valid_rows * d + dense.scales.numel() * 4
    elif layout == "int8-doc":
        nbytes += valid_rows * d + n_pad * 4 + n_pad * 4
    elif layout == "int4-doc":
        nbytes += valid_rows * d // 2 + dense.doc_scales.numel() * 4 + n_pad * 4
    else:
        nbytes += dense.emb_flat.numel() * dense.emb_flat.element_size()
    peak_ops = peaks[2] if layout == "float32" else peaks[0]
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / peaks[1] * 1e3
    bound = max(t_ops, t_bytes)
    log(f"{kernel} at B={b} Lq={lq} N={n_pad} L={doc_len} D={d}: "
        f"max_abs_err={err:.3e} top100_ids_equal={same}, {N_REPEATS} "
        f"launches bit-equal; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({flops / 1e12:.3f} TFLOP at "
        f"{peak_ops / 1e12:.0f} TFLOP/s, {nbytes / 1e9:.3f} GB; "
        f"{valid_rows} of {rows} rows valid), matmul of the product alone "
        f"{'n/a' if mm_ms is None else f'{mm_ms:.3f} ms'}")
    log(f"{kernel}: {flops / k_ms / 1e9:.2f} TFLOP/s over valid rows, "
        f"{flops / k_ms * 1e3 / peak_ops:.1%} of the "
        f"{'fp32 FFMA' if layout == 'float32' else 'bf16 tensor'} peak; "
        f"time / bound {k_ms / bound:.2f}")
    if layout in ("int8", "int8-doc", "int4-doc"):
        # these kernels multiply every stored row of a 64-row chunk that
        # holds a valid row (int8: a nonzero scale; int8-doc: a chunk that
        # starts before the length, always 64 columns wide)
        if layout == "int8":
            live = (dense.scales.reshape(-1, 64) > 0).any(dim=1)
            stored_rows = int(live.sum()) * 64
        elif layout == "int8-doc":
            chunks = (dense.doc_lengths.long() + 63) // 64
            stored_rows = int(chunks.clamp(0, (doc_len + 63) // 64).sum()) * 64
        else:
            stored_rows = rows
        stored = 2.0 * b * lq * d * stored_rows
        log(f"{kernel}: {stored / k_ms / 1e9:.2f} TFLOP/s over the "
            f"{stored_rows} stored rows of live chunks ({stored / 1e12:.3f} "
            f"TFLOP), {stored / k_ms * 1e3 / peak_ops:.1%} of the bf16 "
            "tensor peak")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, matmul_only_ms=mm_ms)


def variant_numbers(kernel, variants, dense, q_emb, ref) -> None:
    """Each ``--variant`` build of ``kernel`` and the port's own, on the
    main path's index of its layout: held against the plain version (a
    variant that disagrees is reported and not timed), then timed by CUDA
    events over 20 launches, in two passes (in the order given, then
    reversed). Its launches are not counted."""
    from hybrid_rag_colbertv2_tpu_torch.ops import _build
    runs = {}
    for name, csrc in (("port", _build.CSRC), *variants):
        run = kernel_launcher(kernel, csrc, q_emb, dense.emb_flat,
                              dense.scales, dense.doc_scales,
                              dense.doc_lengths, dense.doc_len)
        try:
            err, _ = compare(run(), ref, 100)
        except AssertionError as e:
            log(f"{kernel} variant {name}: {e}; not timed")
            continue
        log(f"{kernel} variant {name}: agrees with the plain version, "
            f"max_abs_err={err:.3e}")
        runs[name] = run
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(cuda_ms(runs[name], 20))
    for name, ts in times.items():
        log(f"{kernel} variant {name}: {' / '.join(f'{t:.3f}' for t in ts)}"
            " ms")


def parse_variants(argv):
    """``--variant KERNEL:NAME=DIR`` flags -> {kernel: [(name, DIR)]}"""
    out = {}
    for flag, val in zip(argv, argv[1:]):
        if flag == "--variant":
            kernel, _, rest = val.partition(":")
            name, _, d = rest.partition("=")
            if kernel not in KERNELS:
                raise SystemExit(f"--variant {val}: no kernel {kernel!r}")
            source = KERNELS[kernel][3]
            if not (Path(d) / source).is_file():
                raise SystemExit(f"--variant {val}: no {source} there")
            out.setdefault(kernel, []).append((name, Path(d).resolve()))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / PORT / "csrc").is_dir():
        print(f"chip_smoke: {PORT}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from concurrent.futures import ThreadPoolExecutor
    from hybrid_rag_colbertv2_tpu_torch.ops import _build
    from hybrid_rag_colbertv2_tpu_torch.utils.device import (
        set_fp32_matmul_exact)
    set_fp32_matmul_exact()
    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    variants = parse_variants(sys.argv[1:])

    # -- phase 1: build the kernels from csrc/, one nvcc each, at once ---
    t0 = time.perf_counter()
    sources = sorted({KERNELS[k][3][:-3] for k in KERNELS})
    jobs = [(k, vname, d) for k, vs in variants.items() for vname, d in vs]
    with ThreadPoolExecutor(1 + len(jobs)) as pool:
        built = [pool.submit(_build.build_many, [KERNELS[k][3][:-3]], d)
                 for k, _, d in jobs]
        libs = _build.build_many(sources)
        for (k, vname, d), job in zip(jobs, built):
            try:
                libs[f"{k} variant {vname}"] = job.result()[
                    KERNELS[k][3][:-3]]
            except RuntimeError as e:              # a variant only
                log(f"{k} variant {vname}: {str(e)[:2000]}")
                variants[k].remove((vname, d))
    n_var = sum(map(len, variants.values()))
    log(f"build: {', '.join(sources)}"
        f"{f' and {n_var} variants' if n_var else ''} "
        f"{time.perf_counter() - t0:.1f}s")
    for src, lib in libs.items():
        ptxas = lib.with_suffix(".log").read_text()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
        spills = []   # (the kernel's first template argument, bytes)
        for fn, n in re.findall(r"Function properties for (\S+)\n\s*\d+ "
                                r"bytes stack frame, ([1-9]\d*) bytes spill "
                                r"stores", ptxas):
            k = re.search(r"Li(\d+)E", fn)
            spills.append((k.group(1) if k else fn[:40], n))
        serial = re.findall(r"(?m)^.*wgmma.*serialized.*$", ptxas)
        log(f"ptxas {src}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, spills: {spills or 'none'}"
            + (f"; {len(serial)} wgmma serialised: {serial[0][:200]}"
               if serial else ""))

    # -- phase 2: each kernel vs its plain version at small shapes ------
    phase_kernel_small(device)
    phase_length_edges(device)
    phase_stress(device, variants)
    phase_float_skip(device)
    if "--kernels-only" in sys.argv[1:]:
        log("kernels-only: stopping after the kernel checks")
        return 0

    # -- phase 3: the main path of every layout, both routes -------------
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import FusedCascade
    encoder = ColBERTEncoder(ColBERTConfig.small(vocab_size=8192),
                             HashTokenizer(8192), seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    paths = make_paths(device, encoder, gen)
    launches = {LAYOUT_KERNEL[lay]: run_path(lay, path)
                for lay, path in paths.items()}
    q_embs = {lay: check_dense_top100(lay, path, encoder, device)
              for lay, path in paths.items()}

    # small-input reference: the same cascade on the CPU's plain versions
    for layout, n in check_small_cascade(device, list(paths)).items():
        log(f"small {layout} index, card vs CPU plain versions: final ids "
            f"agree ({n} slots swapped between tied scores)")
    phase_graph_vs_eager(paths)
    phase_threads(paths["int8"])
    phase_maintenance_small(device)
    phase_bf16_encoder(device)

    # -- phase 4: numbers (tracing off; the profile comes last) ----------
    routes = [(lay, p) for lay, path in paths.items() for p in path["routes"]]
    for lay, p in routes:                      # every graph captured
        paths[lay]["routes"][p].retrieve_batch(paths[lay]["batches"][0])
    times = {(lay, p, how): [] for lay, p in routes
             for how in ("graph", "eager")}
    stages = {(lay, p): [] for lay, p in routes}   # the graph calls' split
    caps = FusedCascade.captures
    for i in range(N_TIMED_CALLS):      # layouts, routes, paths interleaved
        for lay, p in routes:
            path = paths[lay]
            r, batch = path["routes"][p], path["batches"][i % 3]
            for how, call in (("graph", r.retrieve_batch),
                              ("eager", lambda b, r=r: eager_batch(r, b))):
                t0 = time.perf_counter()
                call(batch)
                times[(lay, p, how)].append(
                    (time.perf_counter() - t0) * 1e3)
            stages[(lay, p)].append(r.last_timings)
    caps = FusedCascade.captures - caps
    log(f"graph captures during the {N_TIMED_CALLS * len(routes)} timed "
        f"graph calls: {caps}")
    if caps:
        raise AssertionError("the fused cache re-captured in the timed loop")
    lat = {}
    for (lay, p, how), ts in times.items():
        q = statistics.quantiles(ts, n=10)
        lat.setdefault(f"{lay}/{p}", {})[how] = {
            "p50": statistics.median(ts), "p90": q[-1]}
        log(f"retrieve_batch {lay} dense_prefilter={p} {how}: p50 "
            f"{statistics.median(ts):.3f} ms, p90 {q[-1]:.3f} ms (batch "
            f"{BATCH}, {paths[lay]['dense'].n_docs} chunks, host clock, "
            f"{len(ts)} calls)")
    for (lay, p), split in stages.items():
        med = {n: statistics.median(t[n] for t in split) * 1e3
               for n in ("tokenize", "encode+cascade")}
        lat[f"{lay}/{p}"]["graph"].update(
            tokenize_ms=med["tokenize"], replay_ms=med["encode+cascade"])
        log(f"retrieve_batch {lay} dense_prefilter={p} graph, median "
            f"stages: tokenize {med['tokenize']:.3f} ms, encode+cascade "
            f"(copy in, replay, copy out) {med['encode+cascade']:.3f} ms")
    nums = {kernel: kernel_numbers(kernel, paths[KERNELS[kernel][0]],
                                   q_embs[KERNELS[kernel][0]], peaks,
                                   variants.get(kernel, ()))
            for kernel in KERNELS}
    phase_convert_main(paths["int8"])
    phase_add_documents(device, encoder, gen)
    for lay, p in routes:                      # every graph captured
        paths[lay]["routes"][p].retrieve_batch(paths[lay]["batches"][0])
    graph_launches = {}
    for lay, p in routes:
        path = paths[lay]
        r = path["routes"][p]
        kernel = LAYOUT_KERNEL[lay]
        prof = {how: profile_calls(f"{lay} dense_prefilter={p} {how}", fn,
                                   path["batches"])
                for how, fn in (("graph", r.retrieve_batch),
                                ("eager", lambda b, r=r: eager_batch(r, b)))}
        for how, pr in prof.items():
            want = {k: (1.0 if p == 0 and k == kernel else 0.0)
                    for k in KERNELS}
            if pr["kernels"] != want:
                raise AssertionError(f"{lay} route {p} {how}: kernel "
                                     f"launches per call {pr['kernels']}, "
                                     f"want {want}")
            cell = lat[f"{lay}/{p}"][how]
            # the busy share of the untraced p50 (tracing slows the host)
            cell.update(device_ms=pr["device_ms"], span_ms=pr["span_ms"],
                        busy=pr["device_ms"] / cell["p50"],
                        device_ops=pr["device_ops"],
                        host_launches=pr["host_launches"])
            log(f"{lay} dense_prefilter={p} {how}: device "
                f"{cell['device_ms']:.3f} ms/call, busy {cell['busy']:.1%} "
                f"of the p50 {cell['p50']:.3f} ms, "
                f"{cell['host_launches']:.0f} host-side launches/call")
        if p == 0:
            graph_launches[kernel] = prof["graph"]["kernels"][kernel]
    rows = [{"name": kernel, "route": "cuda",
             "source": f"{PORT}/csrc/{src}",
             "replaces": f"{JAX_MAXSIM}:{line}",
             "launches": launches[kernel],
             "graph_launches_per_call": graph_launches[kernel],
             **nums[kernel]}
            for kernel, (_, _, _, src, line) in KERNELS.items()]
    print(json.dumps({"retrieve_batch_ms": lat, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


# runtime calls that put work on the device: kernel and graph launches
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def profile_calls(label, fn, batches, calls: int = 5) -> dict:
    """``fn(batch)`` over ``calls`` batches under torch.profiler: device
    time per call by kernel name, the device span of a call (first to
    last op), device ops per call, host-side launches per call (kernel
    and graph launches from the host), and launches per call of each
    port kernel by its symbol."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    # one traced warm-up call, discarded: a replay right at the start of
    # tracing lost some of its kernels' records (int4-doc / 0 showed 0.8
    # launches of its scan per call without it)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        fn(batches[0])
        prof.step()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(batches[i % len(batches)])
            prof.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = prof.key_averages()
    # device-side entries only (kernels, copies): an operator's entry
    # repeats the device time of the kernels it launched
    rows = [(e.self_device_time_total / 1e3 / calls, e.count / calls, e.key)
            for e in events if e.device_type == cuda]
    # a step's annotation on the device timeline: first to last op of a
    # call, gaps included
    span = sum(r[0] for r in rows if r[2].startswith("ProfilerStep"))
    rows = sorted((r for r in rows
                   if r[0] > 0 and not r[2].startswith("ProfilerStep")),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    ops = sum(r[1] for r in rows)
    host = sum(e.count for e in events
               if e.device_type != cuda and e.key in LAUNCH_CALLS) / calls
    kernels = {k: sum(e.count for e in events if e.device_type == cuda
                      and re.search(rf"\b{sym}\b", e.key)) / calls
               for k, sym in KERNEL_SYMBOL.items()}
    log(f"profile {label}: traced wall {wall_ms:.3f} ms/call, device "
        f"{busy:.3f} ms/call over a device span of {span:.3f} ms/call, "
        f"{ops:.0f} device ops/call, {host:.0f} host-side launches/call")
    for ms_, n, key in rows[:8]:
        log(f"  {ms_:8.3f} ms  x{n:<6.1f} {key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=busy, span_ms=span,
                device_ops=ops, host_launches=host, kernels=kernels)


def check_small_cascade(device, layouts) -> dict:
    """A 600-doc index of each of ``layouts`` served on the card
    (kernels) and on the CPU (plain versions) must give the same final
    scores and ids on both routes. Its closest final scores lie inside
    the tolerance, so two ids may swap, but only where their CPU scores
    tie within the tolerance. -> {layout: swapped slots}"""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)
    rng = np.random.default_rng(3)
    vocab = np.array([f"w{i}" for i in range(900)])
    corpus = [" ".join(r) for r in vocab[rng.integers(0, 900, (600, 20))]]
    queries = [" ".join(rng.choice(vocab, 5)) for _ in range(8)]
    queries[1] = corpus[77]
    lex = LexicalIndex.build(corpus, postings_cap=512)
    out = {}
    for dev in (device, torch.device("cpu")):
        enc = ColBERTEncoder(
            ColBERTConfig.small(vocab_size=4096, num_layers=2),
            HashTokenizer(4096), seed=5, device=dev)
        embs, lengths = enc.encode_docs(corpus, doc_len=64)
        for layout in layouts:
            mgr = IndexManager(RAGConfig(), enc, device=dev)
            mgr.lexical = lex
            mgr.dense = DenseTokenIndex.build(embs, lengths, doc_len=64,
                                              dtype=layout)
            for p in (1024, 0):
                r = HybridRetriever(RAGConfig(dense_prefilter=p,
                                              final_fusion="rerank"),
                                    mgr, enc, device=dev)
                out[(dev.type, layout, p)] = r.retrieve_batch(queries)
    rtol, atol = 1e-4, 1e-3
    swaps = dict.fromkeys(layouts, 0)
    for layout in layouts:
        for p in (1024, 0):
            gi, gs = out[("cuda", layout, p)]
            ci, cs = out[("cpu", layout, p)]
            if not np.allclose(gs, cs, rtol=rtol, atol=atol):
                raise AssertionError(f"small {layout} cascade scores "
                                     f"differ, route {p}")
            for row, j in np.argwhere(gi != ci):
                # the card's doc in this slot, scored on the CPU: its slot
                # there, or below the CPU's last slot when it fell out
                hit = np.flatnonzero(ci[row] == gi[row, j])
                cpu_score = cs[row, hit[0]] if hit.size else cs[row, -1]
                if not np.isclose(cpu_score, cs[row, j], rtol=rtol,
                                  atol=atol):
                    raise AssertionError(
                        f"small {layout} cascade ids differ beyond ties, "
                        f"route {p}: {gi[row]} vs {ci[row]}")
                swaps[layout] += 1
    return swaps


if __name__ == "__main__":
    sys.exit(main())
