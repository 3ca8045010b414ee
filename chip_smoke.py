#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # exits 0 on success; one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop
    python3 chip_smoke.py --app-only      # build + the app phase, then stop
    python3 chip_smoke.py --bucketed-only # build + the checkpoint and
                                          # bucketed phases, then stop
    python3 chip_smoke.py --sharded-only  # build + the sharded phases
    python3 chip_smoke.py --train-sharded-only  # build + sharded training
    python3 chip_smoke.py --tools-only    # build + the app phase + the tools
    python3 chip_smoke.py --bench-only    # build + the bench phase
    python3 chip_smoke.py --stage-a-only  # build + stage A's kernel phase
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

Then the checkpoint encoder and the bucketed layout, on the same card:

  * a synthetic jinaai/jina-colbert-v2 checkpoint written under
    ``build/jina_ckpt/`` (config.json of the published geometry, one
    bf16 ``model.safetensors`` in the published flash layout and names
    with seeded weights, a BPE tokenizer.json trained on the app
    corpus), loaded through ``models/convert.py::convert_hf_dir``
    (~558M parameters), held card vs CPU and timed;
  * 100,000 docs with lengths uniform in [16, 256], int8, in the
    bucketed layout (buckets 64, 128, 256) beside the same docs flat at
    L = 256, served through the checkpoint encoder on routes 1024 and 0,
    graph vs eager vs the composed oracle, ``maxsim_int8`` once per
    bucket per route-0 replay, each bucket's scan against its plain
    version, both layouts timed and profiled;
  * ~3,000 docs in every layout bucketed (and a variant whose 64-row
    bucket holds 3 real docs), card vs CPU, fused vs composed, each
    layout's kernel once per non-empty bucket per route-0 call, then
    append, convert and save -> load;
  * the app on the checkpoint over the bucketed layout: upload (no
    training), the gate, both routes, an incremental upload, a
    conversion and ``--query`` through the CLI.

Then sharded serving (``parallel/``), with SHARDS = 4 shards on the one
card (a mesh of ``[card] * 4``; the shards are views of the index):

  * every flat main index cut 4 ways and served eagerly by
    ``ShardedRetriever`` on both routes: the layout's kernel once per
    shard per route-0 call and never on the pruned one (the wrappers'
    counts, per call), the planted doc first, route 0 against the
    single-device retriever and the pruned route against the CPU port on
    4 CPU shards (ids swapped only between tied scores), one shard
    against one device on both routes; timed beside the single-device
    graph and profiled; then ``index/checkpoint.py``: the 100k int8
    index saved from 4 shards and loaded at 4, 2 and 1, the 1M int4-doc
    index at 4 (bytes and route-0 ids equal, seconds and GB/s);
  * the bucketed 100k index on the checkpoint encoder, sharded 4 ways:
    ``maxsim_int8`` once per bucket per shard per route-0 call, route 0
    against the single-device bucketed route 0;
  * the app with ``visible_devices`` patched to 4 devices: it binds the
    sharded adapter, and its ids equal the unsharded app's.

Then the rest of the port, on the same card:

  * the tools (after the app phase, on its app): ``check_env`` (the five
    kernel probes against their plain versions), ``eval_recall`` (card
    vs CPU, and the CLI's ``--eval`` in a subprocess), the organic
    questions over the repo's markdown, ``stage_probe`` at 100,000 docs
    with a profile and ``--flagship``, ``serve_probe`` at concurrency
    1/4/8 and ``--chat`` with its mock sidecar, and the native text
    library timed against the Python path on the app's corpus;
  * the training side of sharding: the tiny ``__graft_entry__`` flow on
    a (4, 2) mesh of the card (TP-sharded encoder, 3 DP x TP steps,
    sharded retrieval over int8 and int4-doc) held against the same flow
    on the CPU; at jina-colbert-v2 width on the synthetic checkpoint the
    TP forward at model extents 2 and 4 against the unsharded one, and
    3 DP x TP steps on a (2, 2) mesh against 3 unsharded steps, both
    timed.

Last, the port's bench and the quickstart: ``--bench`` through the CLI
in a subprocess at the card's full sizes (bench.py's headline, recall,
1M, throughput and 2M passes; its realdata and organic passes switched
off), its one JSON line checked; one realdata seed in this process (the
app trained 300 steps, the gate, 9 evals whose exact baseline is the
int8 kernel); ``examples/demo.py`` in a subprocess.

Copies between cards are not exercised: the machine has one card.

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
# stage A (csrc/proxy_topk.cu) at the shapes of the benchmark's
# colbertv2.msmarco-open cell: its corpus, D and C; batches of 8 and 16
STAGE_A_N, STAGE_A_C, STAGE_A_BATCHES = 2_210_456, 1024, (8, 16)
STAGE_A_BUCKETS = (25_700, 42_800, 102_800)
STAGE_A_SYMBOL = "proxy_scan_kernel"
STAGE_A_PARTS = (STAGE_A_SYMBOL, "select_round_kernel", "sort_chunk_kernel",
                 "merge_rank_kernel", "reduce_kernel", "elementwise_kernel")
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
                   zero_rows=(), block=1024, min_len=None):
    """Topic-clustered unit-norm token rows (bench.py's generator),
    lengths in [min_len, doc_len] (default [doc_len/2, doc_len]), padding
    rows zeroed, generated on the
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
    lengths = torch.randint(doc_len // 2 if min_len is None else min_len,
                            doc_len + 1, (n,), generator=gen,
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
                                 batches=batches, corpus=corpus,
                                 queries=queries)
        torch.cuda.synchronize()
        log(f"dense indexes {', '.join(layouts)}: {n_pad} x {doc_len} x "
            f"{DIM}, "
            + ", ".join(f"{paths[lay]['dense'].memory_bytes() / 1e9:.2f}"
                        for lay in layouts)
            + f" GB on the card, {time.perf_counter() - t0:.1f}s")
    return paths


def main_paths(device) -> tuple:
    """The main path's encoder (the ``small`` preset, random weights from
    seed 0), the generator of its corpora and ``make_paths``' indexes.
    -> (encoder, generator, paths)"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    encoder = ColBERTEncoder(ColBERTConfig.small(vocab_size=8192),
                             HashTokenizer(8192), seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    return encoder, gen, make_paths(device, encoder, gen)


def drop_entries(dense) -> None:
    """Drop every cached fused entry (and its graphs) over ``dense``, flat
    or bucketed."""
    from hybrid_rag_colbertv2_tpu_torch.retrieval import cascade
    ids = {id(b.emb_flat) for b in getattr(dense, "buckets", [dense])}
    cascade._FUSED_CACHE.drop_where(lambda _k, e: e.reads_any(ids))


def counted_route(label, r, dense, batches, want_kernel, per_call
                  ) -> tuple:
    """The counted run of one route: its entries dropped, the counts set
    to 0, ``batches`` served, the counts read. The wrapper of
    ``want_kernel`` counts 2 launches (warm-up and capture) per graph
    and ``per_call`` launches per replay of it; no other wrapper runs.
    -> outputs, captures and the counted launches"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import FusedCascade
    drop_entries(dense)
    reset_launch_counts()
    caps = FusedCascade.captures
    outs = [r.retrieve_batch(b) for b in batches]
    torch.cuda.synchronize()
    counts = launch_counts()
    caps = FusedCascade.captures - caps
    want = {w: (2 * caps * per_call if w == want_kernel else 0)
            for w in WRAPPERS}
    if caps < 1 or counts != want:
        raise AssertionError(f"{label}: launches {counts} over {caps} "
                             f"captures, want {want}")
    return outs, caps, counts


def check_outputs(label, outs, n_docs, planted=None) -> int:
    """Ids in range, finite scores, and the planted doc first where one
    is given. -> the first batch's rank-1 id"""
    import numpy as np
    for ids, scores in outs:
        if not ((ids >= -1) & (ids < n_docs)).all():
            raise AssertionError(f"bad ids on {label}: {ids}")
        if not np.isfinite(scores[ids >= 0]).all():
            raise AssertionError(f"non-finite scores on {label}")
    rank1 = int(outs[0][0][0, 0])
    if planted is not None and rank1 != planted:
        raise AssertionError(f"{label}: planted doc {planted} must rank "
                             f"first, got {rank1}")
    return rank1


def run_path(layout, path) -> int:
    """The counted run of one layout's main path: 3 batches per route,
    the counts set to 0 just before each route and read just after. The
    layout's fused entries are dropped first, so the run captures its
    graph: the route-0 wrapper counts the eager warm-up and the capture
    of its kernel, two per graph, and the replays launch it from the
    graph (the profiler counts those, ``profile_calls``).
    -> launches of the layout's kernel on route 0."""
    wrapper = KERNELS[LAYOUT_KERNEL[layout]][1]
    launches = 0
    for p, r in path["routes"].items():
        outs, caps, counts = counted_route(
            f"{layout} route {p}", r, path["dense"], path["batches"],
            wrapper if p == 0 else None, 1)
        if p == 0:
            launches = counts[wrapper]
        if any(ids.shape != (BATCH, 10) for ids, _ in outs):
            raise AssertionError(f"{layout} route {p}: ids of shape "
                                 f"{outs[0][0].shape}")
        rank1 = check_outputs(f"{layout} route {p}", outs,
                              path["dense"].n_docs, PLANTED_DOC)
        log(f"{layout} dense_prefilter={p}: {caps} graph(s) captured over "
            f"{len(outs)} batches, {counts[wrapper]} counted launches of "
            f"{wrapper} (warm-up and capture); planted doc {PLANTED_DOC} "
            f"-> rank-1 id {rank1}")
    return launches


def eager_batch(r, batch):
    """``retrieve_batch``'s work with its fused entry run eagerly, op by
    op: tokenize, then encoder + cascade. -> (ids, scores) numpy"""
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        pack_query_batch)
    cfg = r.config
    fused = r.build_entry(min(cfg.final_top_k, cfg.fusion_candidates,
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
    hold_top100(f"{layout} scan route", dbg["ms_vals"], dbg["ms_ids"],
                plain)
    return q_emb


def hold_top100(label, kv, ki, plain) -> bool:
    """A dense top-k (values ``kv``, ids ``ki``) from the kernels against
    ``top_k`` of the plain version's (B, n_docs) scores at RTOL / ATOL:
    the values equal, the ids equal or swapped only between docs whose
    plain scores tie. -> whether the ids are equal"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops.topk import top_k
    pv, pi = top_k(plain, kv.shape[1])
    ki = ki.long()
    if not torch.allclose(kv, pv, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{label}: dense top-{kv.shape[1]} values "
                             "differ")
    ids_equal = bool(torch.equal(ki, pi))
    if not ids_equal and not torch.allclose(
            torch.gather(plain, 1, ki), pv, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{label}: dense top-{kv.shape[1]} ids differ "
                             "beyond ties")
    log(f"{label} dense top-{kv.shape[1]} vs plain: ids_equal={ids_equal}")
    return ids_equal


def timed_interleaved(calls) -> dict:
    """{name: (fn, batches)}: fn(batches[i % len(batches)]) for i <
    N_TIMED_CALLS, the names in turns, host clock (each call ends in its
    results on the host). -> {name: {"p50", "p90"}} ms"""
    times = {k: [] for k in calls}
    for i in range(N_TIMED_CALLS):
        for k, (fn, batches) in calls.items():
            t0 = time.perf_counter()
            fn(batches[i % len(batches)])
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: {"p50": statistics.median(ts),
                "p90": statistics.quantiles(ts, n=10)[-1]}
            for k, ts in times.items()}


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
            stored_rows = live_chunk_rows(dense)
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
    t_main = time.perf_counter()

    def stamp(what: str) -> None:
        log(f"[{time.perf_counter() - t_main:.1f}s] {what}")
    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    variants = parse_variants(sys.argv[1:])

    # -- phase 1: build the kernels from csrc/, one nvcc each, at once ---
    t0 = time.perf_counter()
    sources = sorted({KERNELS[k][3][:-3] for k in KERNELS} | {"proxy_topk"})
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

    if "--app-only" in sys.argv[1:]:
        app = phase_app(device)
        print(json.dumps({"app": app, "card": card}))
        log("app-only: stopping after the app phase")
        return 0
    if "--bucketed-only" in sys.argv[1:]:
        bucketed = phase_bucketed_all(device, *build_lexical(N_DOCS, 0))
        print(json.dumps({"bucketed": bucketed, "card": card}))
        log("bucketed-only: stopping after the checkpoint and bucketed "
            "phases")
        return 0
    if "--sharded-only" in sys.argv[1:]:
        sharded = phase_sharded(device)
        print(json.dumps({"sharded": sharded, "card": card}))
        log("sharded-only: stopping after the sharded phase")
        return 0
    if "--train-sharded-only" in sys.argv[1:]:
        train = phase_train_sharded(device)
        print(json.dumps({"train_sharded": train, "card": card}))
        log("train-sharded-only: stopping after the sharded training phase")
        return 0
    if "--bench-only" in sys.argv[1:]:
        bench = phase_bench(device, peaks)
        print(json.dumps({"bench": bench, "card": card}))
        log("bench-only: stopping after the bench phase")
        return 0
    if "--stage-a-only" in sys.argv[1:]:
        stage_a = phase_stage_a(device, peaks)
        print(json.dumps({"stage_a": stage_a, "card": card}))
        log("stage-a-only: stopping after the stage A phase")
        return 0
    if "--tools-only" in sys.argv[1:]:
        app = phase_app(device, then=lambda a, r: phase_tools(device, a, r))
        print(json.dumps({"tools": app.pop("then"), "card": card}))
        log("tools-only: stopping after the app and the tools phases")
        return 0

    # -- phase 2: each kernel vs its plain version at small shapes ------
    stamp("kernels at small shapes")
    phase_kernel_small(device)
    phase_length_edges(device)
    phase_stress(device, variants)
    phase_float_skip(device)
    stamp("stage A's kernel")
    stage_a = phase_stage_a(device, peaks)
    if "--kernels-only" in sys.argv[1:]:
        log("kernels-only: stopping after the kernel checks")
        return 0

    # -- the app's default path (its own counted run), then the tools on
    # -- its app (their own counted run) ---------------------------------
    stamp("the app's default path, then the tools")
    app = phase_app(device, then=lambda a, r: phase_tools(device, a, r))
    tools = app.pop("then")

    # -- phase 3: the main path of every layout, both routes -------------
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import FusedCascade
    stamp("the flat main paths")
    encoder, gen, paths = main_paths(device)
    launches = {LAYOUT_KERNEL[lay]: run_path(lay, path)
                for lay, path in paths.items()}
    q_embs = {lay: check_dense_top100(lay, path, encoder, device)
              for lay, path in paths.items()}

    # small-input reference: the same cascade on the CPU's plain versions
    stamp("small cascades card vs CPU, graph vs eager, maintenance")
    for layout, n in check_small_cascade(device, list(paths)).items():
        log(f"small {layout} index, card vs CPU plain versions: final ids "
            f"agree ({n} slots swapped between tied scores)")
    phase_graph_vs_eager(paths)
    phase_threads(paths["int8"])
    phase_maintenance_small(device)
    phase_bf16_encoder(device)

    # -- phase 4: numbers (tracing off; the profile comes last) ----------
    stamp("timed flat routes, kernel numbers, profiles")
    routes = [(lay, p) for lay, path in paths.items() for p in path["routes"]]
    for lay, p in routes:                      # every graph captured
        paths[lay]["routes"][p].retrieve_batch(paths[lay]["batches"][0])
    stages = {(lay, p): [] for lay, p in routes}   # the graph calls' split

    def graph_call(b, lay, p):
        r = paths[lay]["routes"][p]
        r.retrieve_batch(b)
        stages[(lay, p)].append(r.last_timings)

    calls = {}
    for lay, p in routes:               # layouts, routes, paths interleaved
        r, batches = paths[lay]["routes"][p], paths[lay]["batches"]
        calls[(lay, p, "graph")] = (
            lambda b, lay=lay, p=p: graph_call(b, lay, p), batches)
        calls[(lay, p, "eager")] = (lambda b, r=r: eager_batch(r, b), batches)
    caps = FusedCascade.captures
    times = timed_interleaved(calls)
    caps = FusedCascade.captures - caps
    log(f"graph captures during the {N_TIMED_CALLS * len(routes)} timed "
        f"graph calls: {caps}")
    if caps:
        raise AssertionError("the fused cache re-captured in the timed loop")
    lat = {}
    for (lay, p, how), t in times.items():
        lat.setdefault(f"{lay}/{p}", {})[how] = t
        log(f"retrieve_batch {lay} dense_prefilter={p} {how}: p50 "
            f"{t['p50']:.3f} ms, p90 {t['p90']:.3f} ms (batch "
            f"{BATCH}, {paths[lay]['dense'].n_docs} chunks, host clock, "
            f"{N_TIMED_CALLS} calls)")
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
        want = {k: (1.0 if p == 0 and k == kernel else 0.0)
                for k in KERNELS}
        prof = {how: profile_calls(f"{lay} dense_prefilter={p} {how}", fn,
                                   path["batches"], want,
                                   stage_a=float(p != 0))
                for how, fn in (("graph", r.retrieve_batch),
                                ("eager", lambda b, r=r: eager_batch(r, b)))}
        for how, pr in prof.items():
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
    # -- the flat indexes sharded on the card, and their checkpoints -----
    stamp("sharded serving over the flat indexes")
    sharded = {"flat": phase_sharded_flat(device, paths, encoder)}
    # -- the checkpoint encoder and the bucketed layout -----------------
    main_lex = tuple(paths["int8"][k] for k in ("lex", "corpus", "queries"))
    for path in paths.values():
        drop_entries(path["dense"])
    del paths, q_embs
    gc.collect()
    torch.cuda.empty_cache()
    stamp("the checkpoint encoder and the bucketed layout")
    bucketed = phase_bucketed_all(device, *main_lex)
    sharded["bucketed"] = bucketed.pop("sharded")
    stamp("the app sharded")
    sharded["app"] = phase_sharded_app(device)
    stamp("the training side of sharding")
    train_sharded = phase_train_sharded(device)
    # after every phase that held a big index, so the bench's subprocess
    # has the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    stamp("the port's bench, a realdata seed, the demo")
    bench = phase_bench(device, peaks)
    stamp("whole run")
    rows = [{"name": kernel, "route": "cuda",
             "source": f"{PORT}/csrc/{src}",
             "replaces": f"{JAX_MAXSIM}:{line}",
             "launches": launches[kernel],
             "graph_launches_per_call": graph_launches[kernel],
             "app_launches": app["app_launches"][KERNELS[kernel][1]]
             if kernel == "maxsim_int8" else 0,
             "bucketed_launches": bucketed["launches"][layout],
             "bucketed_graph_launches_per_call":
                 bucketed["graph_launches_per_call"][layout],
             "sharded_launches": sharded["flat"]["layouts"][layout]["0"][
                 "launches"],
             "sharded_launches_per_call": sharded["flat"]["layouts"][layout][
                 "0"]["kernel_per_call"],
             "sharded_bucketed_launches": sharded["bucketed"]["0"]["launches"]
             if kernel == "maxsim_int8" else 0,
             "sharded_bucketed_launches_per_call":
                 sharded["bucketed"]["0"]["kernel_per_call"]
                 if kernel == "maxsim_int8" else 0,
             # the tools phase's count of the kernel's wrapper (the bf16
             # and fp32 kernels share maxsim_scores), and the sharded
             # training flow's route-0 retrieval
             "tools_launches": tools["launches"][KERNELS[kernel][1]],
             "train_sharded_launches": sum(
                 n for k, n in train_sharded["graft"]["launches"].items()
                 if k.startswith(layout + "/")),
             # the bench subprocess and the realdata seed (the wrapper's
             # count; bf16 and fp32 share it)
             "bench_launches": bench["launches"][KERNELS[kernel][1]],
             **nums[kernel]}
            for kernel, (layout, _, _, src, line) in KERNELS.items()]
    print(json.dumps({"app": app, "card": card}))
    print(json.dumps({"bucketed": bucketed, "card": card}))
    print(json.dumps({"sharded": sharded, "card": card}))
    print(json.dumps({"tools": tools, "card": card}))
    print(json.dumps({"train_sharded": train_sharded, "card": card}))
    print(json.dumps({"bench": bench, "card": card}))
    print(json.dumps({"stage_a": stage_a, "card": card}))
    print(json.dumps({"retrieve_batch_ms": lat, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


# -- the app's default path: upload, training, the gate, serving ----------

# the JAX package's app-path corpus (bench.py:754) and its config
# (bench.py:_seed_eval, :647-661); everything else at RAGConfig's defaults
APP_DOCS = 112
APP_CONFIG = dict(min_chunk_size=48, max_chunk_size=96, doc_max_tokens=128)
APP_BATCHES = 40
# training steps traced by torch.profiler (left out of the step times)
TRAIN_PROFILED = range(100, 105)
# the trainer card against CPU: fp32 sums in other orders (TF32 off);
# attention key biases excepted (a zero gradient in exact arithmetic, so
# Adam turns rounding noise into steps of up to lr on either side)
TRAIN_RTOL_LOSS, TRAIN_ATOL_PARAM = 1e-5, 1e-5
# ties between final scores, card against CPU (as check_small_cascade)
TIE_RTOL, TIE_ATOL = 1e-4, 1e-3


class StepProbe:
    """Wraps ``train/trainer.py::make_train_step`` for one training run:
    CUDA events around every step, torch.profiler over the steps in
    TRAIN_PROFILED. -> numbers()"""

    def __init__(self):
        self.events = []
        self.prof = None
        self.prof_wall = 0.0
        self.prof_events = None

    def wrap(self, make):
        import torch
        from torch.profiler import ProfilerActivity, profile

        def make_timed(*a, **k):
            step = make(*a, **k)

            def timed(batch, count):
                i = len(self.events)
                if i == TRAIN_PROFILED.start:
                    torch.cuda.synchronize()
                    self.prof = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                    self.prof.__enter__()
                    self.prof_wall = time.perf_counter()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = step(batch, count)
                e1.record()
                self.events.append((e0, e1))
                if i == TRAIN_PROFILED[-1]:
                    torch.cuda.synchronize()
                    self.prof_wall = time.perf_counter() - self.prof_wall
                    self.prof.__exit__(None, None, None)
                    self.prof_events = self.prof.key_averages()
                return out
            return timed
        return make_timed

    def numbers(self) -> dict:
        import torch
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        timed = [t for i, t in enumerate(ms)
                 if i > 0 and i not in TRAIN_PROFILED]
        n = len(TRAIN_PROFILED)
        cuda = torch.autograd.DeviceType.CUDA
        ev = self.prof_events
        device_ms = sum(e.self_device_time_total for e in ev
                        if e.device_type == cuda) / 1e3 / n
        host = sum(e.count for e in ev if e.device_type != cuda
                   and e.key in LAUNCH_CALLS) / n
        med = statistics.median(timed)
        return {"steps": len(ms), "first_step_ms": ms[0],
                "step_ms_p50": med, "step_ms_mean": statistics.fmean(timed),
                "step_ms_p90": statistics.quantiles(timed, n=10)[-1],
                "traced_wall_ms_per_step": self.prof_wall * 1e3 / n,
                "device_ms_per_step": device_ms, "busy": device_ms / med,
                "host_launches_per_step": host}


class CallTimer:
    """Wall time (the device synchronized) of methods patched for one
    run, summed by label; ``with CallTimer({label: (cls, name)}) as t``."""

    def __init__(self, targets):
        self.targets = targets
        self.total = dict.fromkeys(targets, 0.0)
        self.saved = []

    def __enter__(self):
        import torch
        for label, (owner, name) in self.targets.items():
            raw = owner.__dict__[name]
            fn = raw.__func__ if isinstance(raw, classmethod) else raw

            def timed(*a, _fn=fn, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    self.total[_label] += time.perf_counter() - t0
            setattr(owner, name, classmethod(timed)
                    if isinstance(raw, classmethod) else timed)
            self.saved.append((owner, name, raw))
        return self

    def __exit__(self, *exc):
        for owner, name, raw in reversed(self.saved):
            setattr(owner, name, raw)


def app_config(root: Path, **over):
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    kw = dict(db_path=str(root / "rag.db"),
              bm25_index_path=str(root / "idx/bm25"),
              colbert_index_path=str(root / "idx/colbert"),
              tokenizer_path=str(root / "idx/tok.json"),
              images_dir=str(root / "img"), **APP_CONFIG)
    kw.update(over)
    return RAGConfig(**kw)


def app_upload(root: Path, docs) -> tuple:
    """``index_documents`` on the card with the parts timed and the
    training steps probed. -> (app, result, parts, steps, metrics)"""
    from hybrid_rag_colbertv2_tpu_torch.app.application import (
        RAGApplication)
    from hybrid_rag_colbertv2_tpu_torch.ingest.processor import (
        DocumentProcessor)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import (
        ColBERTTokenizer)
    from hybrid_rag_colbertv2_tpu_torch.train import data as data_mod
    from hybrid_rag_colbertv2_tpu_torch.train import trainer as trainer_mod
    app = RAGApplication(app_config(root), use_ollama=False)
    probe = StepProbe()
    runs = []
    real_make, real_train = (trainer_mod.make_train_step,
                             trainer_mod.ColBERTTrainer.train)

    def train(self, pairs, steps=None):
        runs.append((self.cfg, real_train(self, pairs, steps)))
        return runs[-1][1]
    trainer_mod.make_train_step = probe.wrap(real_make)
    trainer_mod.ColBERTTrainer.train = train
    try:
        with CallTimer({
                "ingest": (DocumentProcessor, "process_document"),
                "bpe": (ColBERTTokenizer, "train_bpe"),
                "encoder_init": (RAGApplication, "_make_encoder"),
                "train_total": (RAGApplication, "_train_encoder"),
                # the host pairs + mining, split by function
                "pairs": (data_mod, "pseudo_query_pairs"),
                "reworded": (data_mod, "reworded_query_pairs"),
                "mining": (data_mod, "mine_hard_negatives"),
                "trainer_init": (trainer_mod.ColBERTTrainer, "__init__"),
                "train_steps": (trainer_mod.ColBERTTrainer, "train")}) as t:
            t0 = time.perf_counter()
            out = app.index_documents([str(p) for p in docs])
            total = time.perf_counter() - t0
    finally:
        trainer_mod.make_train_step = real_make
        trainer_mod.ColBERTTrainer.train = real_train
    if len(runs) != 1:
        raise AssertionError(f"the upload trained {len(runs)} times, want 1")
    cfg, metrics = runs[0]
    parts = {"total_s": total, "ingest_s": t.total["ingest"],
             "bpe_s": t.total["bpe"],
             "encoder_init_s": t.total["encoder_init"] - t.total["bpe"],
             "pairs_and_mining_s": (t.total["train_total"]
                                    - t.total["train_steps"]),
             "pairs_s": t.total["pairs"], "reworded_s": t.total["reworded"],
             "mining_s": t.total["mining"],
             "trainer_init_s": t.total["trainer_init"],
             "train_steps_s": t.total["train_steps"],
             **{f"index_{k}_s": v for k, v in out["timings"].items()}}
    steps = probe.numbers()
    steps.update(batch_size=cfg.batch_size, doc_len=cfg.doc_len,
                 learning_rate=cfg.learning_rate)
    return app, out, parts, steps, metrics


def app_query_batches(corpus) -> list:
    """APP_BATCHES batches of 8 held-out span queries over the corpus."""
    import numpy as np
    from hybrid_rag_colbertv2_tpu_torch.train.data import pseudo_query_pairs
    pairs = pseudo_query_pairs(corpus, n_pairs_per_doc=1, seed=2024,
                               query_words=(4, 12))
    np.random.default_rng(2024).shuffle(pairs)
    qs = [q for q, _ in pairs][:APP_BATCHES * BATCH]
    if len(qs) < APP_BATCHES * BATCH:
        raise AssertionError(f"only {len(qs)} app queries")
    return [qs[i:i + BATCH] for i in range(0, len(qs), BATCH)]


def time_query_batches(app, batches) -> dict:
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import FusedCascade
    app.query_batch(batches[0])                  # every shape captured
    for b in batches:
        app.query_batch(b)
    caps = FusedCascade.captures
    ts, split = [], []
    for b in batches:
        t0 = time.perf_counter()
        rows = app.query_batch(b)
        ts.append((time.perf_counter() - t0) * 1e3)
        split.append(app.retriever.last_timings)
        if len(rows) != BATCH or not all(rows):
            raise AssertionError("query_batch returned empty rows")
    caps = FusedCascade.captures - caps
    if caps:
        raise AssertionError(f"{caps} captures in the timed app calls")
    # the median of each stage; "rest" is the chunk-store fetch and the
    # result rows (query_batch around retrieve_batch)
    stages = {n: statistics.median(t[n] for t in split) * 1e3
              for n in ("tokenize", "encode+cascade")}
    rest = statistics.median(t - (s["tokenize"] + s["encode+cascade"]) * 1e3
                             for t, s in zip(ts, split))
    return {"p50_ms": statistics.median(ts),
            "p90_ms": statistics.quantiles(ts, n=10)[-1], "calls": len(ts),
            "tokenize_ms": stages["tokenize"],
            "replay_ms": stages["encode+cascade"], "fetch_rows_ms": rest}


def app_train_card_vs_cpu(root: Path, corpus, device) -> dict:
    """The trainer's 3 steps (warmup 1, the app's batch 16, 4 hard
    negatives, doc_len 128) from the app's trained params on both
    devices, on equal batches: losses, accuracies and params."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import (
        ColBERTTokenizer)
    from hybrid_rag_colbertv2_tpu_torch.train.data import (
        mine_hard_negatives, pseudo_query_pairs)
    from hybrid_rag_colbertv2_tpu_torch.train.trainer import (
        ColBERTTrainer, TrainConfig)
    tok = ColBERTTokenizer.load(root / "idx/tok.json")
    params = str(root / "idx/colbert/encoder_params.npz")
    idx = pseudo_query_pairs(corpus, n_pairs_per_doc=1, seed=77)[:48]
    mined = mine_hard_negatives(corpus, idx, n_negatives=4, seed=77)
    pairs = [(q, corpus[i], [corpus[j] for j in negs])
             for q, i, negs in mined]
    kw = dict(batch_size=16, doc_len=128, steps=3, warmup_steps=1)
    runs = {}
    for dev in (device, torch.device("cpu")):
        enc = ColBERTEncoder(ColBERTConfig.small(vocab_size=tok.vocab_size,
                                                 doc_max_tokens=128),
                             tok, params=ColBERTEncoder.load_params(params),
                             device=dev)
        tr = ColBERTTrainer(enc, TrainConfig(**kw))
        losses, accs = [], []
        states = []
        for s in range(3):
            m = tr.step_fn(tr._make_batch(pairs[16 * s:16 * s + 16]),
                           tr.updates)
            tr.updates += 1
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
            states.append({k: v.detach().cpu().clone()
                           for k, v in enc.model.state_dict().items()})
        runs[dev.type] = (losses, accs, states, tr)
    (gl, ga, gs, gtr), (cl, ca, cs, _) = runs["cuda"], runs["cpu"]
    worst, worst_bias = 0.0, 0.0
    bound = 0.0
    for s in range(3):
        bound += 2 * gtr.schedule(s) * 1.02
        if abs(gl[s] - cl[s]) > TRAIN_RTOL_LOSS * abs(cl[s]) or ga[s] != ca[s]:
            raise AssertionError(f"train step {s} card vs CPU: loss "
                                 f"{gl[s]} vs {cl[s]}, acc {ga[s]} vs "
                                 f"{ca[s]}")
        for k in gs[s]:
            d = float((gs[s][k] - cs[s][k]).abs().max())
            if k.endswith("attention.key.bias"):
                worst_bias = max(worst_bias, d)
                if d > bound:
                    raise AssertionError(f"step {s} {k}: {d} > {bound}")
            else:
                worst = max(worst, d)
                if d > TRAIN_ATOL_PARAM:
                    raise AssertionError(f"train step {s} card vs CPU: "
                                         f"{k} differs by {d}")
    log(f"app trainer card vs CPU, 3 steps (batch 16 + 64 negatives, "
        f"doc_len 128): losses {gl} vs {cl}; max |param diff| {worst:.3e} "
        f"(limit {TRAIN_ATOL_PARAM:g}), key biases {worst_bias:.3e} (limit "
        f"{bound:.3e})")
    return {"losses_card": gl, "losses_cpu": cl, "max_param_diff": worst,
            "max_key_bias_diff": worst_bias}


def app_graph_after_training(root: Path, corpus, device) -> None:
    """A route-0 retriever captures its graph, its encoder trains two
    steps in place, and the same graph then serves the trained weights:
    equal to a fresh retriever over a fresh encoder with those params."""
    import numpy as np
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import (
        ColBERTTokenizer)
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        FusedCascade, HybridRetriever)
    from hybrid_rag_colbertv2_tpu_torch.train.data import pseudo_query_pairs
    from hybrid_rag_colbertv2_tpu_torch.train.trainer import (
        ColBERTTrainer, TrainConfig)
    tok = ColBERTTokenizer.load(root / "idx/tok.json")
    cfg = app_config(root, dense_prefilter=0, final_fusion="rerank")
    params = str(root / "idx/colbert/encoder_params.npz")

    def encoder(path):
        return ColBERTEncoder(ColBERTConfig.small(
            vocab_size=tok.vocab_size, doc_max_tokens=128), tok,
            params=ColBERTEncoder.load_params(path), device=device)
    enc = encoder(params)
    mgr = IndexManager(cfg, enc, device=device)
    mgr.load()
    r = HybridRetriever(cfg, mgr, enc, device=device)
    queries = [q for q, _ in pseudo_query_pairs(corpus, n_pairs_per_doc=1,
                                                seed=5)][:BATCH]
    caps = FusedCascade.captures
    before = r.retrieve_batch(queries)
    pairs = [(q, corpus[i]) for q, i in
             pseudo_query_pairs(corpus, n_pairs_per_doc=1, seed=6)]
    ColBERTTrainer(enc, TrainConfig(batch_size=16, doc_len=128, steps=2,
                                    warmup_steps=1, learning_rate=1e-3)
                   ).train(pairs)
    after = r.retrieve_batch(queries)
    if FusedCascade.captures - caps != 1:
        raise AssertionError("training must not re-capture the graph")
    trained = root / "trained_params.npz"
    enc.save_params(str(trained))
    fresh = encoder(str(trained))
    want = HybridRetriever(cfg, mgr, fresh, device=device).retrieve_batch(
        queries)
    if not (np.array_equal(after[0], want[0])
            and np.array_equal(after[1], want[1])):
        raise AssertionError("a graph captured before training must serve "
                             "the trained weights")
    if np.array_equal(after[1], before[1]):
        raise AssertionError("two training steps left the scores unchanged")
    log("app graph after 2 training steps: the graph captured before "
        "training serves the trained weights (ids and scores equal to a "
        "fresh retriever's)")


def app_gate_card_vs_cpu(app, corpus) -> dict:
    """The port on the CPU over the same index directory and
    ``encoder_params.npz`` runs the same gate; the picked entry must be
    the card's. Details differing by a query are allowed only where the
    flipped query's source chunk ties the hit cut within TIE_RTOL/ATOL
    on one of the devices, which this shows query by query."""
    import copy
    import numpy as np
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.retrieval import gate
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)
    cfg = copy.deepcopy(app.config)
    cfg.final_fusion = "auto"
    enc = ColBERTEncoder(
        ColBERTConfig.small(vocab_size=app.encoder.cfg.vocab_size,
                            doc_max_tokens=cfg.doc_max_tokens),
        app.encoder.tokenizer, params=ColBERTEncoder.load_params(
            str(Path(cfg.colbert_index_path) / "encoder_params.npz")),
        device="cpu")
    mgr = IndexManager(cfg, enc, device="cpu")
    mgr.load()
    t0 = time.perf_counter()
    picked, det = gate.resolve_final_fusion(
        cfg, mgr, enc, corpus, chunk_store=app.store,
        n_queries=cfg.gate_queries)
    cpu_s = time.perf_counter() - t0
    card = app.fusion_gate
    if (det["picked"], det["picked_weight"]) != (card["picked"],
                                                 card["picked_weight"]):
        raise AssertionError(f"gate on the CPU picked {picked}, the card "
                             f"{card['picked']}/{card['picked_weight']}")
    flips = 0
    if det != card:
        # the regimes as gate.resolve_final_fusion builds them
        from hybrid_rag_colbertv2_tpu_torch.train.data import (
            pseudo_query_pairs, reworded_query_pairs)
        seed = cfg.encoder_seed + gate._GATE_SEED_OFFSET
        regimes = {"verbatim": (dict(seed=seed), 10),
                   "long_verbatim": (dict(seed=seed + 1,
                                          query_words=(12, 24)), 3),
                   "dropout": (dict(seed=seed + 2, word_dropout=0.25), 10),
                   "synonym": (dict(seed=seed + 3, synonym_prob=1.0), 10),
                   "reworded": (dict(seed=seed + 4, reworded=True), 10)}
        n_per = max(1, cfg.gate_queries // len(regimes))
        rng = np.random.default_rng(seed)
        sides = {"card": (app.indexes, app.encoder), "cpu": (mgr, enc)}
        for name, (kw, top) in regimes.items():
            gen = (reworded_query_pairs if kw.pop("reworded", False)
                   else pseudo_query_pairs)
            pairs = gen(corpus, n_pairs_per_doc=1, **kw)
            rng.shuffle(pairs)
            pairs = pairs[:n_per]
            if card["regimes"].get(name) == det["regimes"].get(name):
                continue
            for mode, w in gate.GATE_MENU:
                key = f"{mode}_w{w}"
                if card["regimes"][name][key] == det["regimes"][name][key]:
                    continue
                c2 = copy.deepcopy(cfg)
                c2.final_fusion, c2.fusion_weight_bm25 = mode, w
                out = {}
                for side, (m, e) in sides.items():
                    r = HybridRetriever(c2, m, e, device=e.device)
                    out[side] = r.retrieve_batch([q for q, _ in pairs], 10)
                for j, (q, src) in enumerate(pairs):
                    hit = {s: src in o[0][j][:top] for s, o in out.items()}
                    if hit["card"] == hit["cpu"]:
                        continue
                    side = "card" if hit["card"] else "cpu"
                    ids, sc = out[side][0][j], out[side][1][j]
                    s_src = sc[list(ids).index(src)]
                    s_cut = sc[min(top, len(sc) - 1)]
                    log(f"gate flip {name} {key}: query {j} source {src} "
                        f"a hit on the {side} only; its score there "
                        f"{s_src:.6f}, the score at the cut {s_cut:.6f}")
                    if abs(s_src - s_cut) > TIE_ATOL + TIE_RTOL * abs(s_cut):
                        raise AssertionError("gate flip beyond a tie")
                    flips += 1
    log(f"gate on the CPU over the same index and params: picked "
        f"{det['picked']}/{det['picked_weight']} as on the card, details "
        f"{'equal' if det == card else 'equal but for ' + str(flips) + ' tied flips'} "
        f"({cpu_s:.1f}s on the CPU)")
    return {"cpu_picked": [det["picked"], det["picked_weight"]],
            "details_equal": det == card, "tied_flips": flips,
            "cpu_gate_s": cpu_s}


def app_cli_and_server(app, root: Path, docs, query: str) -> dict:
    """The CLI in subprocesses on the default device (the card): an upload
    into a fresh directory, then ``--query --json`` over the app's index,
    whose ids must be ``app.query``'s; the HTTP server on port 0: one
    /query, whose ids must be ``app.query``'s too."""
    import threading
    import urllib.request
    from hybrid_rag_colbertv2_tpu_torch.app.server import make_server
    want = [r["chunk_id"] for r in app.query(query)]
    app.config.save(root / "app.json")
    fresh = root / "cli"
    app_config(fresh).save(root / "cli.json")
    cmd = [sys.executable, "-m", f"{PORT}.app.cli", "--json",
           "--no-generate"]
    t0 = time.perf_counter()
    up = subprocess.run(cmd + ["--config", str(root / "cli.json"),
                               "--upload", str(docs[0])], cwd=REPO,
                        capture_output=True, text=True, timeout=300)
    up_s = time.perf_counter() - t0
    if up.returncode != 0:
        raise AssertionError(f"CLI --upload failed: {up.stderr[-2000:]}")
    up_out = json.loads(up.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    qr = subprocess.run(cmd + ["--config", str(root / "app.json"),
                               "--query", query], cwd=REPO,
                        capture_output=True, text=True, timeout=300)
    q_s = time.perf_counter() - t0
    if qr.returncode != 0:
        raise AssertionError(f"CLI --query failed: {qr.stderr[-2000:]}")
    got = [r["chunk_id"] for r in json.loads(qr.stdout.strip()
                                             .splitlines()[-1])]
    if got != want:
        raise AssertionError(f"CLI --query ids {got}, app.query {want}")
    log(f"CLI: --upload {docs[0].name} -> {up_out['total_chunks']} chunks "
        f"({up_s:.1f}s); --query --json ids equal app.query's ({q_s:.1f}s, "
        f"process start included)")
    httpd, batcher = make_server(app, port=0, max_batch=8,
                                 batch_window_s=0.002)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/query",
            data=json.dumps({"query": query}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            rows = json.loads(resp.read())["results"]
    finally:
        httpd.shutdown()
        batcher.close()
        httpd.server_close()
    if [r["chunk_id"] for r in rows] != want:
        raise AssertionError("server /query ids differ from app.query's")
    log("server on port 0: /query ids equal app.query's")
    return {"cli_upload_s": up_s, "cli_query_s": q_s}


def phase_app(device, then=None) -> dict:
    """The app's default path on the card, as a user runs it: upload the
    JAX bench's app-path corpus (ingest, BPE, pairs and mining, 300
    training steps, index build), then query (reload, the gate, serving),
    both dense routes; the trainer and the gate held against the CPU; the
    CLI and the server. ``then(app, root)``, if given, runs last, on the
    app and its directory (the tools phase). -> the phase's numbers"""
    import tempfile
    import torch
    from hybrid_rag_colbertv2_tpu_torch.app.application import (
        RAGApplication)
    from hybrid_rag_colbertv2_tpu_torch.retrieval import cascade, gate
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import FusedCascade
    from hybrid_rag_colbertv2_tpu_torch.tools.sample_corpus import (
        write_corpus)
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        docs = write_corpus(root / "docs", n_docs=APP_DOCS, seed=0)
        reset_launch_counts()
        app, out, parts, steps, metrics = app_upload(root, docs)
        corpus = app.store.all_chunk_texts()
        log(f"app upload: {len(docs)} docs -> {out['total_chunks']} chunks "
            f"on {app.device}; " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in parts.items()))
        log(f"app training: {steps['steps']} steps at batch "
            f"{steps['batch_size']} (+4 negatives each), doc_len "
            f"{steps['doc_len']}, lr {steps['learning_rate']}; loss "
            f"{metrics[0]['loss']:.4f} -> {metrics[-1]['loss']:.4f}; step "
            f"p50 {steps['step_ms_p50']:.3f} ms (mean "
            f"{steps['step_ms_mean']:.3f}, first {steps['first_step_ms']:.1f}"
            f"), device {steps['device_ms_per_step']:.3f} ms/step, busy "
            f"{steps['busy']:.1%}, {steps['host_launches_per_step']:.0f} "
            f"host-side launches/step")

        # query: reload, then the gate before the retriever binds
        real_gate, seen = gate.resolve_final_fusion, {}

        def timed_gate(*a, **k):
            # the first capture empties the allocator's cache
            # (torch.cuda.graph): empty it first, so that the reserved
            # bytes before and after differ by what the gate holds
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            seen.update(reserved_before=torch.cuda.memory_reserved(),
                        allocated_before=torch.cuda.memory_allocated(),
                        captures=FusedCascade.captures,
                        entries_before=len(cascade._FUSED_CACHE))
            t0 = time.perf_counter()
            res = real_gate(*a, **k)
            torch.cuda.synchronize()
            seen.update(gate_s=time.perf_counter() - t0,
                        reserved_after=torch.cuda.memory_reserved(),
                        allocated_after=torch.cuda.memory_allocated(),
                        captures=FusedCascade.captures - seen["captures"],
                        entries_after=len(cascade._FUSED_CACHE))
            return res
        gate.resolve_final_fusion = timed_gate
        try:
            t0 = time.perf_counter()
            app.initialize_chatbot()
            bind_s = time.perf_counter() - t0
        finally:
            gate.resolve_final_fusion = real_gate
        verdict = [app.config.final_fusion, app.config.fusion_weight_bm25]
        log(f"app gate: {seen['gate_s']:.2f}s of {bind_s:.2f}s to bind, "
            f"{seen['captures']} graph captures, fused entries "
            f"{seen['entries_before']} -> {seen['entries_after']}, "
            f"memory_reserved {seen['reserved_before'] / 2**20:.1f} -> "
            f"{seen['reserved_after'] / 2**20:.1f} MiB (allocated "
            f"{seen['allocated_before'] / 2**20:.1f} -> "
            f"{seen['allocated_after'] / 2**20:.1f} MiB); verdict {verdict}")

        batches = app_query_batches(corpus)
        caps = FusedCascade.captures
        pruned = time_query_batches(app, batches)
        pruned["captures"] = FusedCascade.captures - caps
        log(f"app query_batch (int8, dense_prefilter=1024, {verdict}): p50 "
            f"{pruned['p50_ms']:.3f} ms, p90 {pruned['p90_ms']:.3f} ms over "
            f"{pruned['calls']} batches of {BATCH} (host clock; median "
            f"tokenize {pruned['tokenize_ms']:.3f}, copy in + replay + copy "
            f"out {pruned['replay_ms']:.3f}, store fetch and rows "
            f"{pruned['fetch_rows_ms']:.3f}); {pruned['captures']} captures "
            f"while warming")
        # the forced-exact route, pinned to the verdict (no second gate)
        exact_app = RAGApplication(app_config(
            root, dense_prefilter=0, final_fusion=verdict[0],
            fusion_weight_bm25=verdict[1]), use_ollama=False)
        exact_app.initialize_chatbot()
        caps = FusedCascade.captures
        exact = time_query_batches(exact_app, batches)
        exact["captures"] = FusedCascade.captures - caps
        counts = launch_counts()
        if counts["maxsim_scores_int8"] < 1 or any(
                n for w, n in counts.items() if w != "maxsim_scores_int8"):
            raise AssertionError(f"app path launches {counts}: maxsim_int8 "
                                 "must run, no other kernel")
        # the kernel at the app's shape against its plain version (after
        # the counts were read: these launches are not the path's)
        dense = exact_app.indexes.dense
        q = exact_app.encoder.encode_queries(batches[0])
        args = (q, dense.emb_flat, dense.scales, None, dense.doc_lengths,
                dense.doc_len)
        got = scan("maxsim_int8", "kernel", *args)
        torch.cuda.synchronize()
        err, same = compare(got, scan("maxsim_int8", "plain", *args),
                            min(100, dense.n_docs))
        log(f"kernel maxsim_int8 at the app's shape (B={BATCH}, "
            f"{dense.n_docs} docs x {dense.doc_len}): max_abs_err="
            f"{err:.3e} top100_ids_equal={same}")
        exact["kernel_max_abs_err"] = err
        log(f"app query_batch (int8, dense_prefilter=0): p50 "
            f"{exact['p50_ms']:.3f} ms, p90 {exact['p90_ms']:.3f} ms (median "
            f"tokenize {exact['tokenize_ms']:.3f}, replay "
            f"{exact['replay_ms']:.3f}, fetch and rows "
            f"{exact['fetch_rows_ms']:.3f}); "
            f"counted launches over the app path {counts}")
        prof = {}
        for label, a in (("1024", app), ("0", exact_app)):
            want = {k: (1.0 if label == "0" and k == "maxsim_int8" else 0.0)
                    for k in KERNELS}
            pr = profile_calls(f"app int8 dense_prefilter={label}",
                               a.query_batch, batches, want,
                               stage_a=float(label != "0"))
            prof[label] = {"device_ms": pr["device_ms"],
                           "host_launches": pr["host_launches"],
                           "device_ops": pr["device_ops"]}
        pruned.update(prof["1024"])
        exact.update(prof["0"])
        pruned["busy"] = pruned["device_ms"] / pruned["p50_ms"]
        exact["busy"] = exact["device_ms"] / exact["p50_ms"]
        log(f"app route 0 graph: maxsim_int8 launched once per call; "
            f"device {exact['device_ms']:.3f} ms/call (busy "
            f"{exact['busy']:.1%}), route 1024 device "
            f"{pruned['device_ms']:.3f} ms/call (busy {pruned['busy']:.1%})")

        train_cmp = app_train_card_vs_cpu(root, corpus, device)
        app_graph_after_training(root, corpus, device)
        gate_cmp = app_gate_card_vs_cpu(app, corpus)
        cli = app_cli_and_server(app, root, docs, batches[0][0])
        del exact_app
        gc.collect()
        after = then(app, root) if then is not None else None
        del app
        gc.collect()
    return {"chunks": out["total_chunks"], "upload": parts,
            "train": steps, "loss_first": metrics[0]["loss"],
            "loss_last": metrics[-1]["loss"],
            "gate": {k: v for k, v in seen.items()}, "verdict": verdict,
            "bind_s": bind_s, "route_1024": pruned, "route_0": exact,
            "app_launches": counts, "train_card_vs_cpu": train_cmp,
            "gate_card_vs_cpu": gate_cmp, **cli,
            **({"then": after} if then is not None else {})}


# runtime calls that put work on the device: kernel and graph launches
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


PROFILE_ATTEMPTS = 4


def stage_a_inputs(device, n, b, seed):
    """Unit bf16 pooled rows (a tenth duplicated, so proxies tie), some
    zero-length docs, and a (b, LQ, 128) query batch with padded rows."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    pooled = torch.randn((n, DIM), generator=gen, device=device)
    pooled[1::10] = pooled[0::10][: pooled[1::10].shape[0]]
    pooled = (pooled / pooled.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    lengths = torch.randint(16, DOC_LEN + 1, (n,), generator=gen,
                            device=device, dtype=torch.int32)
    lengths[7::1000] = 0
    q = torch.randn((b, LQ, DIM), generator=gen, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    q[:, LQ - 4:] = 0.0
    return q, pooled.contiguous(), lengths


def stage_a_hold(label, q, pooled, lengths, n_docs, c) -> int:
    """The kernel's candidates: exactly ``top_k`` of its own proxies, and
    the plain version's but for swaps of proxies within 4 tolerances
    (D ulps of each proxy's sum of magnitudes) of each other.
    -> positions where the two lists differ"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops import prefilter
    from hybrid_rag_colbertv2_tpu_torch.ops.topk import top_k
    cand, proxy = prefilter.proxy_topk_kernel(q, pooled, lengths,
                                              n_docs=n_docs, c=c)
    _, want = top_k(proxy, c)
    if not torch.equal(cand, want.to(torch.int32)):
        raise AssertionError(f"{label}: candidates are not top_k of the "
                             "kernel's own proxies")
    plain = prefilter.pooled_proxy_topk_reference(q, pooled, lengths,
                                                  n_docs=n_docs, c=c)
    qbar = q.sum(dim=1).to(torch.bfloat16).to(torch.float64)
    p64 = pooled.to(torch.float64)
    exact = qbar @ p64.T
    tol = DIM * 2.0**-23 * (qbar.abs() @ p64.abs().T)
    keep = (torch.arange(pooled.shape[0], device=q.device) < n_docs) & (
        lengths > 0)
    err = (proxy.to(torch.float64) - exact).abs()[:, keep]
    if not bool((err <= tol[:, keep]).all()):
        raise AssertionError(f"{label}: proxies off the fp64 product by "
                             f"{float(err.max())}")
    exact = torch.where(keep[None, :], exact, -1e30)
    ek = torch.gather(exact, 1, cand.long())
    ep = torch.gather(exact, 1, plain.long())
    if not bool(((ek - ep).abs() <= 4 * tol.max()).all()):
        raise AssertionError(f"{label}: candidates differ from the plain "
                             "version's beyond ties")
    return int((cand != plain).sum())


def phase_stage_a(device, peaks) -> dict:
    """Stage A's kernel (csrc/proxy_topk.cu, ``pooled_proxy_topk`` on the
    card) at the colbertv2.msmarco-open cell's shapes (N = 2,210,456,
    D = 128, C = 1024, B = 8 and 16): held against its plain version,
    timed by CUDA events beside its bound (one read of the bf16 table),
    the plain version and, as the library's yardstick the port never
    calls, ``torch.topk`` on a ready proxy row; one call profiled by
    kernel. -> {B: numbers}"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hybrid_rag_colbertv2_tpu_torch.ops import prefilter
    n, c = STAGE_A_N, STAGE_A_C
    bound_ms = n * DIM * 2 / peaks[1] * 1e3
    out = {}
    for b in STAGE_A_BATCHES:
        q, pooled, lengths = stage_a_inputs(device, n, b, 19 + b)
        n_docs = n - 1000
        swaps = stage_a_hold(f"stage A B={b}", q, pooled, lengths, n_docs, c)
        before = prefilter.pooled_proxy_topk.launches

        def kernel():
            return prefilter.pooled_proxy_topk(q, pooled, lengths,
                                               n_docs=n_docs, c=c)

        def plain():
            return prefilter.pooled_proxy_topk_reference(
                q, pooled, lengths, n_docs=n_docs, c=c)
        proxy = prefilter.proxy_topk_kernel(q, pooled, lengths,
                                            n_docs=n_docs, c=c)[1].clone()
        times = {"kernel": [], "plain": []}
        for name in ("kernel", "plain", "plain", "kernel"):
            times[name].append(cuda_ms(kernel if name == "kernel" else plain,
                                       50 if name == "kernel" else 10))
        library_ms = cuda_ms(lambda: torch.topk(proxy, c), 50)
        launched = prefilter.pooled_proxy_topk.launches - before
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kernel()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    e.self_device_time_total > 0:
                key = next((k for k in STAGE_A_PARTS if k in e.key),
                           e.key[:60])
                parts[key] = parts.get(key, 0.0) + \
                    e.self_device_time_total / 1e3 / 5
        kernel_ms = min(times["kernel"])
        out[b] = dict(kernel_ms=times["kernel"], plain_ms=times["plain"],
                      library_ms=library_ms, bound_ms=bound_ms,
                      roofline=bound_ms / kernel_ms, swaps_vs_plain=swaps,
                      launches=launched, parts_ms=parts)
        log(f"stage A B={b} N={n} C={c}: kernel {times['kernel']} ms, "
            f"bound {bound_ms:.4f} ms ({bound_ms / kernel_ms:.1%}), plain "
            f"{times['plain']} ms, torch.topk on a ready row "
            f"{library_ms:.4f} ms; {swaps} positions differ from the plain "
            f"version (tied within tolerance); {launched} launches counted")
        for key, ms_ in sorted(parts.items(), key=lambda kv: -kv[1]):
            log(f"  {ms_:8.4f} ms/call  {key}")
        if launched != 1 + 2 * (50 + 2):     # cuda_ms warms up twice
            raise AssertionError(f"stage A B={b}: {launched} launches "
                                 "counted")
        del q, pooled, lengths, proxy
        torch.cuda.empty_cache()
    # the bucket sizes of the jina.trec-covid-open cell: one level above
    # the proxies, against the plain version's sort of a shorter row
    for n_b in STAGE_A_BUCKETS:
        q, pooled, lengths = stage_a_inputs(device, n_b, 8, n_b)
        swaps = stage_a_hold(f"stage A N={n_b}", q, pooled, lengths, n_b, c)
        k_ms = cuda_ms(lambda: prefilter.pooled_proxy_topk(
            q, pooled, lengths, n_docs=n_b, c=c), 50)
        p_ms = cuda_ms(lambda: prefilter.pooled_proxy_topk_reference(
            q, pooled, lengths, n_docs=n_b, c=c), 50)
        out[f"N{n_b}"] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                              swaps_vs_plain=swaps)
        log(f"stage A B=8 N={n_b} C={c}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms; {swaps} positions differ from the plain "
            "version (tied within tolerance)")
        if k_ms > p_ms:
            raise AssertionError(f"stage A N={n_b}: the kernel is slower "
                                 "than the plain version")
    return out


def profile_calls(label, fn, batches, want, calls: int = 5,
                  stage_a=None) -> dict:
    """``traced_calls`` until each port kernel's launches per call equal
    ``want`` ({kernel: launches per call}), at most PROFILE_ATTEMPTS
    times; raises if the last attempt still disagrees. Every call
    launches each kernel a fixed number of times (a graph replays all its
    nodes), so a trace that disagrees may have lost records: an app
    route-0 graph once showed 0.4 launches and 183 of its 448 device ops
    per call, and a small bucketed int8-doc graph once none of its 3
    launches per call. A path that really launches other counts
    disagrees on every attempt and fails. ``stage_a``, where given: the
    launches per call of stage A's kernel (one per bucket of a pruned
    route)."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        pr = traced_calls(label, fn, batches, calls)
        if pr["kernels"] == want and stage_a in (None, pr["stage_a"]):
            return pr
        log(f"profile {label}: launches per call {pr['kernels']}, stage A "
            f"{pr['stage_a']}, over {pr['device_ops']:.1f} device ops per "
            f"call, want {want}, stage A {stage_a}, attempt {attempt} of "
            f"{PROFILE_ATTEMPTS}")
    raise AssertionError(f"{label}: kernel launches per call "
                         f"{pr['kernels']}, stage A {pr['stage_a']}, want "
                         f"{want}, stage A {stage_a}")


def traced_calls(label, fn, batches, calls: int) -> dict:
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
        torch.cuda.synchronize()
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
    stage_a = sum(e.count for e in events if e.device_type == cuda
                  and re.search(rf"\b{STAGE_A_SYMBOL}\b", e.key)) / calls
    log(f"profile {label}: traced wall {wall_ms:.3f} ms/call, device "
        f"{busy:.3f} ms/call over a device span of {span:.3f} ms/call, "
        f"{ops:.0f} device ops/call, {host:.0f} host-side launches/call")
    for ms_, n, key in rows[:8]:
        log(f"  {ms_:8.3f} ms  x{n:<6.1f} {key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=busy, span_ms=span,
                device_ops=ops, host_launches=host, kernels=kernels,
                stage_a=stage_a)


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
    swaps = dict.fromkeys(layouts, 0)
    for layout in layouts:
        for p in (1024, 0):
            swaps[layout] += tie_swaps(f"small {layout} cascade, route {p}",
                                       out[("cuda", layout, p)],
                                       out[("cpu", layout, p)])
    return swaps


# -- a checkpoint encoder at the jina-colbert-v2 width ---------------------

# the published jinaai/jina-colbert-v2 geometry (config.json of its
# jina-xlm-roberta flash backbone)
JINA = dict(vocab_size=250002, hidden_size=1024, num_hidden_layers=24,
            num_attention_heads=16, intermediate_size=4096,
            max_position_embeddings=8194, type_vocab_size=1,
            layer_norm_eps=1e-5, pad_token_id=1, rotary_emb_base=10000.0)
JINA_DIM = 128
JINA_SEED = 11
# the full-width encoder card vs CPU, both fp32 with TF32 off, on the
# L2-normalised embeddings
ENCODER_ATOL = 1e-4
N_ENCODER_TIMED = 20
ST_NAMES = {"torch.float32": "F32", "torch.float16": "F16",
            "torch.bfloat16": "BF16"}


def flash_manifest(h=1024, i_=4096, n_layers=24, v=250002, dim=128):
    """[(key, shape)] of the published jina-colbert-v2 state_dict: the
    flash backbone under ``bert.`` and the ``linear.weight`` head (the
    key list ``tests/test_convert_manifest.py`` pins)."""
    m = [("bert.embeddings.word_embeddings.weight", (v, h)),
         ("bert.embeddings.token_type_embeddings.weight", (1, h)),
         ("bert.emb_ln.weight", (h,)), ("bert.emb_ln.bias", (h,)),
         ("linear.weight", (dim, h))]
    for li in range(n_layers):
        pre = f"bert.encoder.layers.{li}"
        m += [(f"{pre}.mixer.Wqkv.weight", (3 * h, h)),
              (f"{pre}.mixer.Wqkv.bias", (3 * h,)),
              (f"{pre}.mixer.out_proj.weight", (h, h)),
              (f"{pre}.mixer.out_proj.bias", (h,)),
              (f"{pre}.norm1.weight", (h,)), (f"{pre}.norm1.bias", (h,)),
              (f"{pre}.norm2.weight", (h,)), (f"{pre}.norm2.bias", (h,)),
              (f"{pre}.mlp.fc1.weight", (i_, h)),
              (f"{pre}.mlp.fc1.bias", (i_,)),
              (f"{pre}.mlp.fc2.weight", (h, i_)),
              (f"{pre}.mlp.fc2.bias", (h,))]
    return m


def write_safetensors(path: Path, shapes, make, dtype) -> int:
    """Write a ``.safetensors`` file (the format, without the package):
    a little-endian u64 header length, the JSON header (padded to 8
    bytes), then each tensor's raw bytes in header order. ``make(name,
    shape)`` yields each tensor (any device) as it is written, so only
    one is held at a time. -> bytes written"""
    import struct
    import torch
    item = torch.empty((), dtype=dtype).element_size()
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, shape in shapes:
        n = item * int(torch.Size(shape).numel())
        header[name] = {"dtype": ST_NAMES[str(dtype)], "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, shape in shapes:
            t = make(name, shape).to(dtype).contiguous().cpu()
            f.write(t.view(torch.uint8).numpy().tobytes())
    return 8 + len(raw) + off


def app_corpus_texts(root: Path) -> list:
    """The app corpus's paragraphs (``write_corpus(n_docs=APP_DOCS)``)."""
    from hybrid_rag_colbertv2_tpu_torch.tools.sample_corpus import (
        write_corpus)
    docs = write_corpus(root / "docs", n_docs=APP_DOCS, seed=0)
    return [p.strip() for d in docs for p in d.read_text().split("\n\n")
            if len(p.strip()) > 40]


def write_jina_checkpoint(ckpt: Path, device) -> dict:
    """config.json of the jina geometry, model.safetensors in the
    published flash layout (bf16, 0.02 * N(0, 1) from a seeded
    generator, LayerNorms at 1 / 0), and a BPE tokenizer.json trained by
    the port's tokenizer on the app corpus. -> seconds and bytes"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import (
        ColBERTTokenizer)
    ckpt.mkdir(parents=True, exist_ok=True)
    (ckpt / "config.json").write_text(json.dumps(
        {"architectures": ["JinaBertModel"], "dim": JINA_DIM, **JINA}))
    t0 = time.perf_counter()
    tok = ColBERTTokenizer.train_bpe(app_corpus_texts(ckpt.parent / "tok"))
    tok.save(ckpt / "tokenizer.json")
    tok_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(JINA_SEED)

    def make(name, shape):
        if name.endswith(("emb_ln.weight", "norm1.weight", "norm2.weight")):
            return torch.ones(shape)
        if name.endswith(("emb_ln.bias", "norm1.bias", "norm2.bias")):
            return torch.zeros(shape)
        return 0.02 * torch.randn(shape, generator=gen, device=device)
    t0 = time.perf_counter()
    nbytes = write_safetensors(
        ckpt / "model.safetensors",
        flash_manifest(JINA["hidden_size"], JINA["intermediate_size"],
                       JINA["num_hidden_layers"], JINA["vocab_size"],
                       JINA_DIM), make, torch.bfloat16)
    write_s = time.perf_counter() - t0
    log(f"checkpoint: {ckpt.name}/model.safetensors {nbytes / 1e9:.3f} GB "
        f"bf16 written in {write_s:.2f}s; tokenizer.json (vocab "
        f"{tok.vocab_size}) trained in {tok_s:.2f}s")
    return {"bytes": nbytes, "write_s": write_s, "tokenizer_s": tok_s,
            "tokenizer_vocab": tok.vocab_size}


def phase_checkpoint(device) -> tuple:
    """The synthetic jina-colbert-v2 checkpoint: written, loaded through
    ``convert_hf_dir`` (~560M parameters), a query batch (8 x 32) and 16
    doc chunks (256 tokens) card vs CPU within ENCODER_ATOL, the query
    forward and a 32 x 256-token doc batch timed by CUDA events.
    -> (card encoder, checkpoint dir, numbers)"""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import ColBERTEncoder
    from hybrid_rag_colbertv2_tpu_torch.models.convert import (
        colbert_config_from_hf, convert_hf_dir)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import (
        ColBERTTokenizer)
    ckpt = REPO / "build" / "jina_ckpt"
    out = write_jina_checkpoint(ckpt, device)
    t0 = time.perf_counter()
    cfg = colbert_config_from_hf(str(ckpt), query_max_tokens=LQ,
                                 doc_max_tokens=256)
    params = convert_hf_dir(str(ckpt), cfg)
    load_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.values())
    if not 5.5e8 < n_params < 5.7e8 or cfg.colbert_dim != JINA_DIM:
        raise AssertionError(f"jina checkpoint: {n_params} parameters")
    tok = ColBERTTokenizer.load(ckpt / "tokenizer.json")
    t0 = time.perf_counter()
    enc = ColBERTEncoder(cfg, tok, params=params, device=device)
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t0
    # the host-to-card copy rate behind "to the card": the word
    # embeddings table (1.02 GB fp32) from pageable and from pinned memory
    table = params["word_embeddings.weight"]
    h2d = {}
    for kind, src in (("pageable", table), ("pinned", table.pin_memory())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst = src.to(device, non_blocking=kind == "pinned")
        torch.cuda.synchronize()
        h2d[kind] = table.numel() * 4 / (time.perf_counter() - t0) / 1e9
        del dst
    del table, src
    texts = app_corpus_texts(ckpt.parent / "tok")
    queries = [" ".join(t.split()[3:11]) for t in texts[:BATCH]]
    docs = texts[BATCH:BATCH + 16]
    cpu = ColBERTEncoder(cfg, tok, params=params, device="cpu")
    del params
    t0 = time.perf_counter()
    want_q = cpu.encode_queries(queries).numpy()
    want_d, want_l = cpu.encode_docs(docs, doc_len=256)
    cpu_s = time.perf_counter() - t0
    del cpu
    got_q = enc.encode_queries(queries).cpu().numpy()
    got_d, got_l = enc.encode_docs(docs, doc_len=256)
    err_q = float(np.abs(got_q - want_q).max())
    err_d = float(np.abs(got_d.cpu().numpy() - want_d.numpy()).max())
    if max(err_q, err_d) > ENCODER_ATOL or not torch.equal(got_l.cpu(),
                                                            want_l):
        raise AssertionError(f"jina encoder card vs CPU: queries {err_q}, "
                             f"docs {err_d} > {ENCODER_ATOL}")
    q_ids = torch.as_tensor(np.stack([tok.encode_query(q, LQ)
                                      for q in queries]), device=device)
    d_ids, d_len = tok.encode_docs((docs * 2)[:32], 256)
    d_ids = torch.as_tensor(d_ids, device=device)
    d_mask = torch.as_tensor(
        (np.arange(256)[None, :] < d_len[:, None]).astype(np.int32),
        device=device)

    def p50(fn):
        ts = []
        with torch.inference_mode():
            fn()
            for _ in range(N_ENCODER_TIMED):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                ts.append(e0.elapsed_time(e1))
        return statistics.median(ts)
    q_ms = p50(lambda: enc.model(q_ids, torch.ones_like(q_ids)))
    d_ms = p50(lambda: enc.model(d_ids, d_mask))
    out.update(n_params=n_params, load_s=load_s, to_card_s=to_card_s,
               h2d_gb_s=h2d,
               cpu_forward_s=cpu_s, max_err_queries=err_q,
               max_err_docs=err_d, query_forward_ms_p50=q_ms,
               doc_forward_ms_p50=d_ms)
    log(f"jina checkpoint encoder: {n_params} parameters ({cfg.num_layers}"
        f"L x {cfg.hidden_size}, FFN {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}, rope base {cfg.rope_base:g}); safetensors read "
        f"+ convert {load_s:.2f}s, to the card {to_card_s:.2f}s (host to "
        f"card {h2d['pageable']:.2f} GB/s pageable, {h2d['pinned']:.2f} "
        f"GB/s pinned); card vs "
        f"CPU max |diff| queries {err_q:.3e}, docs {err_d:.3e} (limit "
        f"{ENCODER_ATOL:g}; CPU forward {cpu_s:.1f}s); query forward "
        f"({BATCH} x {LQ}) p50 {q_ms:.3f} ms, doc forward (32 x 256) p50 "
        f"{d_ms:.3f} ms (CUDA events, {N_ENCODER_TIMED} calls, fp32, TF32 "
        f"off)")
    return enc, ckpt, out


# -- the bucketed layout -----------------------------------------------------

BUCKETS = (64, 128, 256)
BUCKET_MIN_LEN = 16
N_SMALL_BUCKETED = 3000


def bucketed_from_flat(flat, sizes=BUCKETS):
    """The int8 bucketed index over a flat int8 index's docs: each doc's
    rows (quantized row by row, so the same as ``BucketedDenseIndex.build``
    would make from the same rows) moved into the smallest bucket that
    holds it, each bucket padded to 128 docs, the proxies gathered."""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.index.bucketed import (
        BucketedDenseIndex)
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    n, L, d, dev = flat.n_docs, flat.doc_len, flat.dim, flat.device
    emb3 = flat.emb_flat.reshape(flat.n_pad, L, d)
    sc2 = flat.scales.reshape(flat.n_pad, L)
    lens = flat.doc_lengths[:n].cpu().numpy()
    assign = np.searchsorted(np.asarray(sizes), np.minimum(lens, sizes[-1]))
    buckets, gids = [], []
    bucket_of = np.zeros(n, np.int32)
    row_of = np.zeros(n, np.int32)
    for bi, size in enumerate(sizes):
        rows = np.nonzero(assign == bi)[0]
        if rows.size == 0:
            continue
        n_b = rows.size
        n_pad = ((n_b + 127) // 128) * 128
        sel = torch.as_tensor(rows, device=dev)
        e = torch.zeros((n_pad, size, d), dtype=torch.int8, device=dev)
        s = torch.zeros((n_pad, size), dtype=torch.float32, device=dev)
        ln = torch.zeros((n_pad,), dtype=torch.int32, device=dev)
        pooled = torch.zeros((n_pad, d), dtype=flat.pooled.dtype, device=dev)
        e[:n_b] = emb3[sel, :size]
        s[:n_b] = sc2[sel, :size]
        ln[:n_b] = flat.doc_lengths[sel]
        pooled[:n_b] = flat.pooled[sel]
        bucket_of[rows] = len(buckets)
        row_of[rows] = np.arange(n_b, dtype=np.int32)
        buckets.append(DenseTokenIndex(
            emb_flat=e.reshape(-1, d), doc_lengths=ln, n_docs=n_b,
            doc_len=size, dim=d, scales=s.reshape(-1), pooled=pooled))
        gid = np.full(n_pad, -1, np.int32)
        gid[:n_b] = rows
        gids.append(torch.as_tensor(gid, device=dev))
    return BucketedDenseIndex(
        buckets=buckets, global_ids=gids,
        bucket_of=torch.as_tensor(bucket_of, device=dev),
        row_of=torch.as_tensor(row_of, device=dev), n_docs=n)


def composed_vs_fused(label, r, batch, got) -> float:
    """The fused bucketed entry's result against the composed oracle
    (``_cascade_bucketed_composed``) on the same batch: ids equal, scores
    bit-equal or within RTOL, ATOL. -> the largest difference"""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        encode_query_terms)
    cfg = r.config
    q_emb = r.encoder.encode_queries(batch)
    q_terms = torch.as_tensor(encode_query_terms(
        r.indexes.lexical, batch, cfg.query_max_terms,
        cfg.query_term_buckets), device=r.device)
    ids, scores = r._cascade_bucketed_composed(q_emb, q_terms,
                                               cfg.final_top_k)
    if not np.array_equal(ids, got[0]) or not np.allclose(
            scores, got[1], rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{label}: fused {got[0]} vs composed {ids}")
    return float(np.abs(scores - got[1]).max())


def live_chunk_rows(sub) -> int:
    """Rows in the 64-row chunks of an int8 index that hold a valid row
    (the chunks the int8 kernel multiplies)."""
    return int((sub.scales.reshape(-1, 64) > 0).any(dim=1).sum()) * 64


def build_bucketed_100k(device, encoder, queries) -> tuple:
    """100,000 docs x 128 dims, lengths uniform in [16, 256], int8, in
    the bucketed layout (buckets 64, 128, 256) and flat at L = 256, the
    planted doc made from ``encoder``'s embeddings of ``queries[0]``.
    -> (bucketed, flat, seconds)"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.ops.prefilter import (
        pooled_doc_embeddings)
    n, L = N_DOCS, BUCKETS[-1]
    n_pad = ((n + 127) // 128) * 128
    t0 = time.perf_counter()
    plant = encoder.encode_queries([queries[0]])[0].clone()
    gen = torch.Generator(device=device).manual_seed(7)
    lengths, stores = random_layouts(
        gen, n_pad, L, DIM, device, ("int8",), n_valid=n,
        plants={PLANTED_DOC: plant}, min_len=BUCKET_MIN_LEN)
    emb, scales, _ = stores.pop("int8")
    flat = DenseTokenIndex(
        emb_flat=emb, doc_lengths=lengths, n_docs=n, doc_len=L, dim=DIM,
        scales=scales, pooled=pooled_doc_embeddings(emb, scales, lengths,
                                                    doc_len=L))
    bk = bucketed_from_flat(flat)
    torch.cuda.synchronize()
    return bk, flat, time.perf_counter() - t0


def phase_bucketed_100k(device, encoder, lex, corpus, queries,
                        keep=None) -> dict:
    """The full-size bucketed path (``build_bucketed_100k``), queries
    through the full-width checkpoint encoder. Routes 1024 and 0 on both
    layouts, through the graph and eagerly. ``keep``: a dict that gets
    the bucketed index. -> numbers"""
    import numpy as np
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        FusedCascade, HybridRetriever)
    n, L = N_DOCS, BUCKETS[-1]
    n_pad = ((n + 127) // 128) * 128
    bk, flat, build_s = build_bucketed_100k(device, encoder, queries)
    pops = [b.n_docs for b in bk.buckets]
    stored = {"bucketed": sum(b.n_pad * b.doc_len for b in bk.buckets),
              "flat256": n_pad * L}
    live = {"bucketed": sum(live_chunk_rows(b) for b in bk.buckets),
            "flat256": live_chunk_rows(flat)}
    mem = {"bucketed": bk.memory_bytes(), "flat256": flat.memory_bytes()}
    log(f"bucketed 100k: {n} docs, lengths [{BUCKET_MIN_LEN}, {L}], "
        f"buckets {BUCKETS} hold {pops} docs; stored rows "
        f"{stored['bucketed']} vs {stored['flat256']} flat at L={L}; rows "
        f"in live 64-row chunks {live['bucketed']} vs {live['flat256']}; "
        f"memory_bytes {mem['bucketed'] / 1e9:.3f} vs "
        f"{mem['flat256'] / 1e9:.3f} GB; built in {build_s:.1f}s")
    batches = [queries[i:i + BATCH] for i in range(0, 3 * BATCH, BATCH)]
    routes = {}
    for name, dense in (("bucketed", bk), ("flat256", flat)):
        mgr = IndexManager(RAGConfig(), encoder, device=device)
        mgr.lexical, mgr.dense, mgr.corpus = lex, dense, corpus
        for p in (1024, 0):
            routes[(name, p)] = HybridRetriever(
                RAGConfig(dense_prefilter=p, final_fusion="rerank",
                          bm25_postings_cap=512), mgr, encoder,
                device=device)
    nb = len(bk.buckets)
    out = {"bucket_docs": pops, "stored_rows": stored,
           "live_chunk_rows": live, "memory_bytes": mem, "build_s": build_s}
    launches = 0
    for (name, p), r in routes.items():
        dense = bk if name == "bucketed" else flat
        outs, caps, counts = counted_route(
            f"{name} route {p}", r, dense, batches,
            "maxsim_scores_int8" if p == 0 else None,
            nb if name == "bucketed" else 1)
        check_outputs(f"{name} route {p}", outs, n, PLANTED_DOC)
        if name == "bucketed" and p == 0:
            launches = counts["maxsim_scores_int8"]
        worst = 0.0
        bit_equal = True
        for b, got in zip(batches, outs):
            ei, es = eager_batch(r, b)
            if not np.array_equal(got[0], ei) or not np.allclose(
                    got[1], es, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{name} route {p}: graph vs eager")
            bit_equal &= bool(np.array_equal(got[1], es))
            if name == "bucketed":
                worst = max(worst, composed_vs_fused(
                    f"{name} route {p}", r, b, got))
        log(f"{name} 100k dense_prefilter={p}: {caps} graph(s) over "
            f"{len(batches)} batches, counted launches {counts}; planted "
            f"doc {PLANTED_DOC} at rank 1; graph vs eager ids equal, "
            f"scores bit-equal={bit_equal}"
            + (f"; fused vs composed ids equal, max |diff| {worst:.3e}"
               if name == "bucketed" else ""))
        out[f"{name}/{p}"] = {"graph_eq_eager_bits": bit_equal,
                              "fused_vs_composed_max_diff": worst}
    # each bucket's scan top-100 (and flat-256's) against its plain version
    q_emb = encoder.encode_queries(batches[0])
    scans = []
    for label, sub in [(f"bucket L={b.doc_len}", b) for b in bk.buckets] + [
            ("flat L=256", flat)]:
        args = (q_emb, sub.emb_flat, sub.scales, None, sub.doc_lengths,
                sub.doc_len)
        got = scan("maxsim_int8", "kernel", *args)[:, :sub.n_docs]
        err, same = compare(got, scan("maxsim_int8", "plain", *args)
                            [:, :sub.n_docs], 100)
        k_ms = cuda_ms(lambda a=args: scan("maxsim_int8", "kernel", *a), 20)
        scans.append({"scan": label, "n_pad": sub.n_pad,
                      "max_abs_err": err, "top100_ids_equal": same,
                      "kernel_ms": k_ms})
        log(f"maxsim_int8 {label} N_pad={sub.n_pad}: max_abs_err={err:.3e} "
            f"top100_ids_equal={same}; {k_ms:.3f} ms (CUDA events, 20 "
            "launches)")
    out["scans"] = scans
    # timed: interleaved, 0 captures
    keys = list(routes)
    for key in keys:
        routes[key].retrieve_batch(batches[0])
    caps = FusedCascade.captures
    times = timed_interleaved({
        (key, how): (call, batches) for key, r in routes.items()
        for how, call in (("graph", r.retrieve_batch),
                          ("eager", lambda x, r=r: eager_batch(r, x)))})
    if FusedCascade.captures != caps:
        raise AssertionError("bucketed 100k: captures in the timed loop")
    for ((name, p), how), t in times.items():
        cell = out[f"{name}/{p}"].setdefault(how, {})
        cell.update(t)
        log(f"retrieve_batch {name} 100k dense_prefilter={p} {how}: p50 "
            f"{cell['p50']:.3f} ms, p90 {cell['p90']:.3f} ms "
            f"({N_TIMED_CALLS} calls, host clock, jina encoder)")
    graph_launches = 0.0
    for (name, p), r in routes.items():
        for how, fn in (("graph", r.retrieve_batch),
                        ("eager", lambda x, r=r: eager_batch(r, x))):
            want = {k: (float(nb if name == "bucketed" else 1)
                        if p == 0 and k == "maxsim_int8" else 0.0)
                    for k in KERNELS}
            pr = profile_calls(f"{name} 100k dense_prefilter={p} {how}", fn,
                               batches, want, stage_a=float(
                                   (nb if name == "bucketed" else 1)
                                   if p != 0 else 0))
            if how == "graph" and pr["host_launches"] != 1.0:
                raise AssertionError(f"{name} route {p}: "
                                     f"{pr['host_launches']} host-side "
                                     "launches per call, want 1")
            cell = out[f"{name}/{p}"][how]
            cell.update(device_ms=pr["device_ms"],
                        busy=pr["device_ms"] / cell["p50"],
                        host_launches=pr["host_launches"])
            log(f"{name} 100k dense_prefilter={p} {how}: device "
                f"{cell['device_ms']:.3f} ms/call, busy {cell['busy']:.1%}, "
                f"{cell['host_launches']:.0f} host-side launches/call")
            if name == "bucketed" and p == 0 and how == "graph":
                graph_launches = pr["kernels"]["maxsim_int8"]
    out["launches"] = launches
    out["graph_launches_per_call"] = graph_launches
    for r in routes.values():
        drop_entries(r.indexes.dense)
    if keep is not None:
        keep["bucketed"] = bk
    return out


def phase_bucketed_small(device) -> dict:
    """~3,000 docs (lengths 1-256) in every layout, buckets (64, 128,
    256), and a sparse variant whose 64-row bucket holds 3 real docs
    among its 128 padding slots: per layout and route the card's fused
    entry against its composed oracle and against the CPU's (plain
    versions; scores within TIE_RTOL / TIE_ATOL, ids swapped only
    between tied scores), each bucket's kernel against its plain version,
    and the layout's kernel once per non-empty bucket per route-0 call
    (2 counted launches per bucket per graph: warm-up and capture; the
    profiler on the replays). Then ``append`` into a populated and into
    an empty bucket, ``convert`` and save -> load, card vs CPU.
    -> {"launches": {wrapper: n}, ...}"""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.bucketed import (
        BucketedDenseIndex)
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)
    layouts = ("int8", "int8-doc", "int4-doc", "bfloat16", "float32")
    rng = np.random.default_rng(12)
    n, L = N_SMALL_BUCKETED, BUCKETS[-1]
    vocab = np.array([f"w{i}" for i in range(900)])
    corpus = [" ".join(r) for r in vocab[rng.integers(0, 900, (n, 20))]]
    queries = [" ".join(rng.choice(vocab, 5)) for _ in range(8)]
    queries[1] = corpus[77]
    lex = LexicalIndex.build(corpus, postings_cap=512)
    topics = rng.standard_normal((64, DIM)).astype(np.float32)
    x = (topics[rng.integers(0, 64, n)][:, None, :]
         + 0.35 * rng.standard_normal((n, L, DIM)).astype(np.float32))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    full_len = rng.integers(1, L + 1, n).astype(np.int32)
    sparse_len = np.maximum(full_len, 65).astype(np.int32)
    sparse_len[[5, 500, 2999]] = [1, 33, 64]
    encs = {dev: ColBERTEncoder(ColBERTConfig.small(vocab_size=4096,
                                                    num_layers=2),
                                HashTokenizer(4096), seed=5, device=dev)
            for dev in ("cuda", "cpu")}
    wrapper_of = {lay: KERNELS[LAYOUT_KERNEL[lay]][1] for lay in layouts}
    counted = dict.fromkeys(layouts, 0)
    per_call = dict.fromkeys(layouts, 0.0)
    swaps = 0
    for variant, lens in (("full", full_len), ("sparse", sparse_len)):
        xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
        for layout in layouts:
            idx = {}
            for dev in ("cuda", "cpu"):
                idx[dev] = BucketedDenseIndex.build(
                    xt.to(dev), lt, bucket_sizes=BUCKETS, dtype=layout)
            nb = len(idx["cuda"].buckets)
            pops = [b.n_docs for b in idx["cuda"].buckets]
            if variant == "sparse" and pops[0] != 3:
                raise AssertionError(f"sparse variant buckets {pops}")
            q = encs["cuda"].encode_queries(queries)
            kernel = LAYOUT_KERNEL[layout]
            for sub in idx["cuda"].buckets:
                args = (q, sub.emb_flat, sub.scales, sub.doc_scales,
                        sub.doc_lengths, sub.doc_len)
                if layout == "bfloat16":
                    args = (q, sub.emb_flat, None, None, sub.doc_lengths,
                            sub.doc_len)
                compare(scan(kernel, "kernel", *args)[:, :sub.n_docs],
                        scan(kernel, "plain", *args)[:, :sub.n_docs],
                        min(10, sub.n_docs))
            outs = {}
            for p in (1024, 0):
                for dev in ("cuda", "cpu"):
                    mgr = IndexManager(RAGConfig(), encs[dev], device=dev)
                    mgr.lexical, mgr.dense = lex, idx[dev]
                    r = HybridRetriever(RAGConfig(dense_prefilter=p,
                                                  final_fusion="rerank"),
                                        mgr, encs[dev], device=dev)
                    if dev == "cuda":
                        got, caps, counts = counted_route(
                            f"small {variant} {layout} route {p}", r,
                            idx[dev], [queries],
                            wrapper_of[layout] if p == 0 else None, nb)
                        counted[layout] += sum(counts.values())
                        outs[dev] = got[0]
                        composed_vs_fused(f"small {variant} {layout} "
                                          f"route {p}", r, queries, got[0])
                        if p == 0 and variant == "full":
                            want = {k: float(nb if k == kernel else 0)
                                    for k in KERNELS}
                            pr = profile_calls(
                                f"small {layout} route 0 graph",
                                r.retrieve_batch, [queries], want, calls=2)
                            per_call[layout] = pr["kernels"][kernel]
                        drop_entries(idx[dev])
                    else:
                        outs[dev] = r.retrieve_batch(queries)
                swaps += tie_swaps(f"small {variant} {layout} route {p}",
                                   outs["cuda"], outs["cpu"])
            log(f"small bucketed {variant} {layout}: buckets {pops}; card "
                f"vs CPU, fused vs composed and each bucket's kernel vs "
                f"plain agree on both routes")
    # maintenance on the card vs the CPU: append into a populated bucket
    # (L=256) and into an empty one (L=128), convert, save -> load
    base = (full_len <= 64) | (full_len > 128)
    new = np.nonzero(~base)[0][:40].tolist() + np.nonzero(
        full_len > 128)[0][-20:].tolist()
    keep = np.nonzero(base)[0][:2000]
    res = {}
    for dev in ("cuda", "cpu"):
        xt = torch.from_numpy(x).to(dev)
        lt = torch.from_numpy(full_len)
        b = BucketedDenseIndex.build(xt[keep], lt[keep],
                                     bucket_sizes=BUCKETS, dtype="int8")
        before = [s.doc_len for s in b.buckets]
        b = b.append(xt[new], lt[new], bucket_sizes=BUCKETS)
        c = b.convert("int4-doc", block=256)
        root = REPO / "build" / f"smoke_bucketed_{dev}"
        c.save(root)
        back = BucketedDenseIndex.load(root, device=dev)
        q = encs[dev].encode_queries(queries)
        res[dev] = (before, [s.doc_len for s in b.buckets], b, c,
                    c.search_topk(q, 10), back.search_topk(q, 10))
    if res["cuda"][:2] != res["cpu"][:2] or res["cuda"][1] != [64, 256, 128]:
        raise AssertionError(f"append buckets {res['cuda'][:2]} vs "
                             f"{res['cpu'][:2]}")
    for i in (2, 3):
        for sc, sp in zip(res["cuda"][i].buckets, res["cpu"][i].buckets):
            for name in ("emb_flat", "doc_lengths", "scales", "doc_scales"):
                a, bb = getattr(sc, name), getattr(sp, name)
                if a is None:
                    continue
                ok = (torch.allclose(a.cpu(), bb, rtol=1e-6, atol=0)
                      if name.endswith("scales") else torch.equal(a.cpu(), bb))
                if not ok:
                    raise AssertionError(f"bucketed maintenance: {name} "
                                         "differs card vs CPU")
    for dev in ("cuda", "cpu"):
        (v1, i1), (v2, i2) = res[dev][4:6]
        if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
            raise AssertionError("bucketed save -> load changed results")
    (gv, gi), (cv, ci) = res["cuda"][4], res["cpu"][4]
    tie_swaps("converted bucketed top-10", (gi.cpu().numpy(),
                                            gv.cpu().numpy()),
              (ci.numpy(), cv.numpy()))
    log(f"bucketed maintenance: append into buckets {res['cuda'][0]} opened "
        f"{res['cuda'][1]}, convert int8 -> int4-doc and save -> load: card "
        f"equals CPU (codes bit-equal, scales rtol 1e-6), loaded results "
        f"bit-equal; {swaps} final slots swapped between tied scores over "
        f"the small checks")
    # the 100k phase builds its buckets by moving rows of a flat int8
    # index: the same codes as BucketedDenseIndex.build from the rows
    t = torch.from_numpy(x[:600]).to(device)
    ln = torch.from_numpy(full_len[:600])
    moved = bucketed_from_flat(DenseTokenIndex.build(t, ln, doc_len=L,
                                                     dtype="int8"))
    built = BucketedDenseIndex.build(t, ln, bucket_sizes=BUCKETS,
                                     dtype="int8")
    for a, bb in zip(moved.buckets, built.buckets):
        if not (torch.equal(a.emb_flat, bb.emb_flat)
                and torch.equal(a.scales, bb.scales)
                and torch.equal(a.doc_lengths, bb.doc_lengths)):
            raise AssertionError("bucketed_from_flat differs from build")
    return {"launches": counted, "graph_launches_per_call": per_call,
            "tie_swaps": swaps}


def tie_swaps(label, card, cpu) -> int:
    """Card (kernels) vs CPU (plain versions) final results: scores within
    TIE_RTOL / TIE_ATOL, ids equal but where the two swapped docs' CPU
    scores tie within it. -> swapped slots"""
    import numpy as np
    (gi, gs), (ci, cs) = card, cpu
    if not np.allclose(gs, cs, rtol=TIE_RTOL, atol=TIE_ATOL):
        raise AssertionError(f"{label}: scores card vs CPU")
    n = 0
    for row, j in np.argwhere(gi != ci):
        hit = np.flatnonzero(ci[row] == gi[row, j])
        cpu_score = cs[row, hit[0]] if hit.size else cs[row, -1]
        if not np.isclose(cpu_score, cs[row, j], rtol=TIE_RTOL,
                          atol=TIE_ATOL):
            raise AssertionError(f"{label}: ids differ beyond ties: "
                                 f"{gi[row]} vs {ci[row]}")
        n += 1
    return n


# the app on the checkpoint over the bucketed layout: the app phase's
# corpus and chunking (two buckets populated: the chunks run 30-130 BPE
# tokens), the checkpoint's geometry, doc_max_tokens 256
CKPT_APP_CONFIG = dict(min_chunk_size=48, max_chunk_size=96,
                       doc_max_tokens=256)


def phase_checkpoint_app(device, ckpt: Path) -> dict:
    """The app over ``encoder_checkpoint`` (the synthetic jina directory)
    and ``index_layout="bucketed"``, ``final_fusion="auto"``: upload (no
    training), the gate, ``query_batch`` on routes 1024 and 0 with
    ``maxsim_int8`` once per non-empty bucket per route-0 call, a second
    upload of one doc on the incremental ``add_documents`` path,
    ``convert_index("int8-doc")``, and ``--query`` through the CLI.
    -> numbers"""
    import tempfile
    import torch
    from hybrid_rag_colbertv2_tpu_torch.app.application import (
        RAGApplication)
    from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig
    from hybrid_rag_colbertv2_tpu_torch.index.bucketed import (
        BucketedDenseIndex)
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.ingest.processor import (
        DocumentProcessor)
    from hybrid_rag_colbertv2_tpu_torch.retrieval import cascade, gate
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import FusedCascade
    from hybrid_rag_colbertv2_tpu_torch.tools.sample_corpus import (
        write_corpus)
    from hybrid_rag_colbertv2_tpu_torch.train import trainer as trainer_mod

    def config(root, **over):
        kw = dict(CKPT_APP_CONFIG, encoder_checkpoint=str(ckpt),
                  mesh=MeshConfig(index_layout="bucketed",
                                  doc_token_buckets=BUCKETS))
        kw.update(over)
        return app_config(root, **kw)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        docs = write_corpus(root / "docs", n_docs=APP_DOCS, seed=0)
        app = RAGApplication(config(root), use_ollama=False)
        with CallTimer({
                "ingest": (DocumentProcessor, "process_document"),
                "encoder_init": (RAGApplication, "_make_encoder"),
                "train_total": (RAGApplication, "_train_encoder"),
                "train_steps": (trainer_mod.ColBERTTrainer, "train")}) as t:
            t0 = time.perf_counter()
            up = app.index_documents([str(p) for p in docs])
            total = time.perf_counter() - t0
        parts = {"total_s": total, "ingest_s": t.total["ingest"],
                 "encoder_init_s": t.total["encoder_init"],
                 "train_s": t.total["train_total"] + t.total["train_steps"],
                 **{f"index_{k}_s": v for k, v in up["timings"].items()}}
        dense = app.indexes.dense
        if (not isinstance(dense, BucketedDenseIndex) or parts["train_s"]
                or app._trained_marker_path().exists()):
            raise AssertionError("checkpoint app: a bucketed index and no "
                                 "training expected")
        pops = {b.doc_len: b.n_docs for b in dense.buckets}
        if len(pops) < 2:
            raise AssertionError(f"checkpoint app: buckets {pops}, want two "
                                 "or more non-empty")
        log(f"checkpoint app upload: {len(docs)} docs -> {up['total_chunks']}"
            f" chunks, buckets {pops} (doc_len: docs), "
            f"{dense.memory_bytes() / 2**20:.2f} MiB; "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
            + " (0 training steps)")
        real_gate, seen = gate.resolve_final_fusion, {}

        def timed_gate(*a, **k):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            seen.update(reserved_before=torch.cuda.memory_reserved(),
                        captures=FusedCascade.captures)
            t0 = time.perf_counter()
            res = real_gate(*a, **k)
            torch.cuda.synchronize()
            seen.update(gate_s=time.perf_counter() - t0,
                        reserved_after=torch.cuda.memory_reserved(),
                        captures=FusedCascade.captures - seen["captures"],
                        bucketed_entries=sum(
                            isinstance(e, cascade.FusedBucketedCascade)
                            for e in cascade._FUSED_CACHE._d.values()))
            return res
        gate.resolve_final_fusion = timed_gate
        try:
            app.initialize_chatbot()
        finally:
            gate.resolve_final_fusion = real_gate
        verdict = [app.config.final_fusion, app.config.fusion_weight_bm25]
        if not seen or not seen["bucketed_entries"]:
            raise AssertionError("the gate must measure bucketed entries")
        log(f"checkpoint app gate: {seen['gate_s']:.2f}s, "
            f"{seen['captures']} graph captures, memory_reserved "
            f"{seen['reserved_before'] / 2**20:.1f} -> "
            f"{seen['reserved_after'] / 2**20:.1f} MiB; verdict {verdict}")
        corpus = app.store.all_chunk_texts()
        batches = app_query_batches(corpus)
        nb = len(dense.buckets)
        routes = {"1024": app}
        exact = RAGApplication(config(root, dense_prefilter=0,
                                      final_fusion=verdict[0],
                                      fusion_weight_bm25=verdict[1]),
                               use_ollama=False)
        exact.initialize_chatbot()
        routes["0"] = exact
        for label, a in routes.items():
            cell = time_query_batches(a, batches)
            want = {k: (float(nb) if label == "0" and k == "maxsim_int8"
                        else 0.0) for k in KERNELS}
            pr = profile_calls(f"checkpoint app bucketed route {label}",
                               a.query_batch, batches, want,
                               stage_a=float(nb if label != "0" else 0))
            cell.update(device_ms=pr["device_ms"],
                        busy=pr["device_ms"] / cell["p50_ms"],
                        host_launches=pr["host_launches"])
            out[f"route_{label}"] = cell
            log(f"checkpoint app query_batch (bucketed int8, "
                f"dense_prefilter={label}, {verdict}): p50 "
                f"{cell['p50_ms']:.3f} ms, p90 {cell['p90_ms']:.3f} ms "
                f"(tokenize {cell['tokenize_ms']:.3f}, replay "
                f"{cell['replay_ms']:.3f}, fetch and rows "
                f"{cell['fetch_rows_ms']:.3f}); device "
                f"{cell['device_ms']:.3f} ms/call, busy {cell['busy']:.1%}"
                f"; maxsim_int8 {pr['kernels']['maxsim_int8']:.0f} per "
                "call")
        # the CLI in a subprocess over this index returns app.query's ids
        query = batches[0][0]
        want = [r["chunk_id"] for r in app.query(query)]
        app.config.save(root / "app.json")
        t0 = time.perf_counter()
        qr = subprocess.run(
            [sys.executable, "-m", f"{PORT}.app.cli", "--json",
             "--no-generate", "--config", str(root / "app.json"), "--query",
             query], cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if qr.returncode != 0:
            raise AssertionError(f"CLI --query failed: {qr.stderr[-2000:]}")
        got = [r["chunk_id"] for r in json.loads(
            qr.stdout.strip().splitlines()[-1])]
        if got != want:
            raise AssertionError(f"CLI --query ids {got}, app.query {want}")
        log(f"checkpoint app CLI --query --json: ids equal app.query's "
            f"({cli_s:.1f}s, process start and checkpoint load included)")
        # one more doc: the incremental path appends into the bucketed index
        extra = root / "docs_extra" / "extra.md"
        extra.parent.mkdir()
        extra.write_text("# Zyzzyva\n\nzyzzyva glossolalia xylophone "
                         "quixotic marker chunk about the appended "
                         "document and its incremental upload.\n")
        n_before = dense.n_docs
        t0 = time.perf_counter()
        up2 = app.index_documents([str(extra)])
        add_s = time.perf_counter() - t0
        timings = up2["timings"]
        if ("colbert_append" not in timings or "colbert_build" in timings
                or app.indexes.dense.n_docs <= n_before
                or not isinstance(app.indexes.dense, BucketedDenseIndex)):
            raise AssertionError(f"second upload: {timings}, want the "
                                 "incremental add_documents path")
        hit = app.query("zyzzyva glossolalia xylophone quixotic")
        log(f"checkpoint app second upload: +"
            f"{app.indexes.dense.n_docs - n_before} chunk(s) by "
            f"add_documents in {add_s:.2f}s ({', '.join(sorted(timings))}); "
            f"the new chunk ranks {1 + [r['chunk_id'] for r in hit].index(n_before) if n_before in [r['chunk_id'] for r in hit] else 'absent'}")
        t0 = time.perf_counter()
        conv = app.convert_index("int8-doc")
        conv_s = time.perf_counter() - t0
        rows = app.query_batch(batches[0])
        if app.indexes.dense.quant != "int8-doc" or not all(rows):
            raise AssertionError("convert_index to int8-doc must serve")
        log(f"checkpoint app convert_index: {conv} in {conv_s:.2f}s; "
            "query_batch serves from the converted index")
        out.update(chunks=up["total_chunks"], upload=parts,
                   bucket_docs=pops, gate=seen, verdict=verdict,
                   cli_query_s=cli_s, add_documents_s=add_s,
                   convert_s=conv_s)
        del app, exact, routes
        gc.collect()
    return out



def check_freed(label, model, mem0: int) -> float:
    """After the caller dropped its last references: the module behind
    the weakref ``model`` must be collected (no cache entry, of the
    sharded cascades or the fused ones, may keep an encoder alive).
    -> GB freed since ``memory_allocated`` read ``mem0``"""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    freed = (mem0 - torch.cuda.memory_allocated()) / 1e9
    if model() is not None:
        raise AssertionError(f"{label}: the encoder outlived its "
                             "retrievers")
    log(f"{label}: {freed:.2f} GB freed, the encoder's module collected")
    return freed


def phase_bucketed_all(device, lex, corpus, queries) -> dict:
    """The checkpoint encoder, the bucketed 100k path on it and that
    index sharded (``phase_sharded_bucketed``), the small five-layout
    bucketed checks and the app on the checkpoint over the bucketed
    layout. -> numbers, with each layout's counted launches and per-call
    graph launches on the bucketed paths"""
    import torch
    t0 = time.perf_counter()
    enc, ckpt, encoder = phase_checkpoint(device)
    keep = {}
    big = phase_bucketed_100k(device, enc, lex, corpus, queries, keep)
    sharded = phase_sharded_bucketed(device, enc, keep.pop("bucketed"), lex,
                                     corpus, queries)
    model, mem = weakref.ref(enc.model), torch.cuda.memory_allocated()
    del enc
    sharded["freed_gb"] = check_freed("jina encoder and bucketed index "
                                      "dropped", model, mem)
    small = phase_bucketed_small(device)
    app = phase_checkpoint_app(device, ckpt)
    launches = dict(small["launches"])
    launches["int8"] += big["launches"]
    per_call = dict(small["graph_launches_per_call"])
    per_call["int8"] = big["graph_launches_per_call"]
    secs = time.perf_counter() - t0
    log(f"checkpoint and bucketed phases: {secs:.1f}s")
    return {"encoder": encoder, "bucketed_100k": big, "small": small,
            "checkpoint_app": app, "launches": launches,
            "graph_launches_per_call": per_call, "sharded": sharded,
            "seconds": secs}


# -- sharded serving: several shards of one index on the one card ----------

# shards of every sharded phase: a mesh of [card] * SHARDS (a mesh may
# repeat a device; the shards are views of the index)
SHARDS = 4


def sharded_mesh(device, n: int):
    from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig
    from hybrid_rag_colbertv2_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(mesh_shape=(n, 1)), devices=[device] * n)


def route_config(prefilter: int):
    """The flat main path's retriever config (``make_paths``)."""
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    return RAGConfig(dense_prefilter=prefilter, final_fusion="rerank",
                     bm25_postings_cap=512)


def sharded_call_counted(label, r, batch, wrapper, per_call):
    """One eager sharded call with the counts set to 0 just before it and
    read just after: ``wrapper`` launched ``per_call`` times, no other
    wrapper. -> ((ids, scores), the wrapper's count)"""
    import torch
    reset_launch_counts()
    out = r.retrieve_batch(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {w: (per_call if w == wrapper else 0) for w in WRAPPERS}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, want {want}")
    return out, counts[wrapper]




def dense_on(dense, dev):
    """A copy of a flat index on ``dev``."""
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    return DenseTokenIndex(**{
        k: (None if getattr(dense, k) is None else getattr(dense, k).to(dev))
        for k in ("emb_flat", "doc_lengths", "scales", "pooled",
                  "doc_scales")},
        n_docs=dense.n_docs, doc_len=dense.doc_len, dim=dense.dim)


def profile_sharded(label, fn, batches, kernel, per_call) -> dict:
    """``profile_calls`` of an eager sharded route: ``kernel`` launched
    ``per_call`` times per call on the device, no other port kernel."""
    return profile_calls(label, fn, batches, {
        k: (float(per_call) if k == kernel else 0.0) for k in KERNELS})


def phase_sharded_flat(device, paths, encoder) -> dict:
    """Every flat layout's main index cut into SHARDS shards on the card
    (``shard_dense_index``: views, the int4 group scales copied) and
    served eagerly by ``ShardedRetriever`` on its pruned route and on
    route 0: the layout's kernel once per shard per route-0 call and
    never on the pruned one (counted per call); the planted doc first;
    route 0's merged dense top-100 (the kernel on every shard's operands)
    against the plain scan of the whole index, at RTOL / ATOL;
    route 0 against the single-device ``HybridRetriever`` and the pruned
    route (one batch) against the CPU port on SHARDS CPU shards, ids
    swapped only between scores tied within TIE_RTOL / TIE_ATOL; one
    shard (S = 1) on both routes against the single-device retriever;
    both routes timed beside the single-device graph and profiled. Then
    the sharded checkpoints. -> numbers"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.parallel.mesh import (
        shard_dense_index)
    from hybrid_rag_colbertv2_tpu_torch.parallel.sharded import (
        ShardedRetriever)
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        encode_query_terms)
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    mesh, mesh1 = sharded_mesh(device, SHARDS), sharded_mesh(device, 1)
    mesh_cpu = sharded_mesh(cpu, SHARDS)
    out = {"layouts": {}}
    for layout, path in paths.items():
        dense, lex, batches = path["dense"], path["lex"], path["batches"]
        kernel = LAYOUT_KERNEL[layout]
        wrapper = KERNELS[kernel][1]
        pruned = max(path["routes"])
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        sd = shard_dense_index(dense, mesh)
        torch.cuda.synchronize()
        cell = {"shard_bytes_allocated": torch.cuda.memory_allocated() - mem0,
                "memory_allocated": torch.cuda.memory_allocated()}
        routes = {p: ShardedRetriever(route_config(p), mesh, lex, sd, encoder)
                  for p in (pruned, 0)}
        for p, r in routes.items():
            label = f"sharded S={SHARDS} {layout} route {p}"
            outs, counted = zip(*(sharded_call_counted(
                label, r, b, wrapper, SHARDS if p == 0 else 0)
                for b in batches))
            check_outputs(label, outs, dense.n_docs, PLANTED_DOC)
            single = [path["routes"][p].retrieve_batch(b) for b in batches]
            one = ShardedRetriever(route_config(p), mesh1, lex,
                                   shard_dense_index(dense, mesh1), encoder)
            cell[str(p)] = {"launches": sum(counted), "s1_tie_swaps": sum(
                tie_swaps(f"{label} S=1 vs one device", one.retrieve_batch(b),
                          s) for b, s in zip(batches, single))}
            if p == 0:
                cell["0"]["tie_swaps_vs_one_device"] = sum(
                    tie_swaps(f"{label} vs one device", o, s)
                    for o, s in zip(outs, single))
        # route 0's dense leg: the kernel on every shard's operands, the
        # shards merged, against the plain scan of the whole index
        batch = batches[0]
        q_emb = encoder.encode_queries(batch)
        plain = scan(kernel, "plain", q_emb, dense.emb_flat, dense.scales,
                     dense.doc_scales, dense.doc_lengths,
                     dense.doc_len)[:, :dense.n_docs]
        fn0 = routes[0]._fn_for(routes[0].config.final_top_k)
        cell["0"]["top100_ids_equal"] = hold_top100(
            f"sharded S={SHARDS} {layout} route 0, shards merged",
            *fn0.dense_topk(q_emb, sd), plain)
        del plain
        # the pruned route, one batch: the card against the CPU port
        cfg = route_config(pruned)
        q_terms = encode_query_terms(lex, batch, cfg.query_max_terms,
                                     cfg.query_term_buckets)
        card = routes[pruned].retrieve_embedded(q_emb, q_terms)
        t0 = time.perf_counter()
        host = dense_on(dense, cpu)
        cpu_r = ShardedRetriever(cfg, mesh_cpu, lex,
                                 shard_dense_index(host, mesh_cpu), None)
        want = cpu_r.retrieve_embedded(q_emb.cpu(), q_terms)
        cell[str(pruned)].update(
            cpu_tie_swaps=tie_swaps(f"sharded {layout} route {pruned} card "
                                    "vs CPU", card, want),
            cpu_s=time.perf_counter() - t0)
        del host, cpu_r
        gc.collect()
        # times: sharded (eager) beside the single-device graph, in turns
        t = timed_interleaved(
            {**{("sharded", p): (r.retrieve_batch, batches)
                for p, r in routes.items()},
             **{("graph", p): (path["routes"][p].retrieve_batch, batches)
                for p in routes}})
        for p, r in routes.items():
            pr = profile_sharded(f"sharded S={SHARDS} {layout} route {p}",
                                 r.retrieve_batch, batches, kernel,
                                 SHARDS if p == 0 else 0)
            c = cell[str(p)]
            c.update(p50=t[("sharded", p)]["p50"],
                     p90=t[("sharded", p)]["p90"],
                     device_ms=pr["device_ms"], span_ms=pr["span_ms"],
                     host_launches=pr["host_launches"],
                     device_ops=pr["device_ops"],
                     busy=pr["device_ms"] / t[("sharded", p)]["p50"],
                     kernel_per_call=pr["kernels"][kernel],
                     one_device_graph_p50=t[("graph", p)]["p50"])
            log(f"sharded S={SHARDS} {layout} dense_prefilter={p} eager: p50 "
                f"{c['p50']:.3f} ms, p90 {c['p90']:.3f} ms (one device, "
                f"graph: p50 {c['one_device_graph_p50']:.3f} ms); device "
                f"{c['device_ms']:.3f} ms/call, busy {c['busy']:.1%}, "
                f"{c['host_launches']:.0f} host-side launches/call, "
                f"{kernel} {c['kernel_per_call']:.0f}/call; route "
                f"vs one device: {c.get('tie_swaps_vs_one_device', '-')} "
                f"tie swaps, S=1: {c['s1_tie_swaps']}"
                + (f"; card vs CPU ({SHARDS} CPU shards, "
                   f"{c['cpu_s']:.1f}s): {c['cpu_tie_swaps']} tie swaps"
                   if p == pruned else ""))
        log(f"sharded {layout}: {SHARDS} shards of {sd.n_local} docs, "
            f"{cell['shard_bytes_allocated']} bytes allocated by the "
            f"sharding, memory_allocated {cell['memory_allocated'] / 1e9:.2f}"
            " GB")
        out["layouts"][layout] = cell
        del routes, sd, one
        gc.collect()
    out["checkpoints"] = phase_sharded_checkpoints(device, paths, encoder)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_sharded_checkpoints(device, paths, encoder) -> dict:
    """``index/checkpoint.py`` at the main path's sizes: the 100k int8
    index saved from SHARDS shards and loaded at SHARDS, 2 and 1 shards
    (route-0 ids equal, the bytes equal), the 1M int4-doc index saved and
    loaded at SHARDS shards (the bytes equal, route-0 ids equal); seconds
    and GB/s of each save and load (card to disk and back)."""
    import shutil
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.index.checkpoint import (
        load_sharded, save_sharded)
    from hybrid_rag_colbertv2_tpu_torch.parallel.mesh import (
        shard_dense_index)
    from hybrid_rag_colbertv2_tpu_torch.parallel.sharded import (
        ShardedRetriever)
    root = REPO / "build" / "sharded_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    try:
        for layout, loads in (("int8", (SHARDS, 2, 1)), ("int4-doc",
                                                         (SHARDS,))):
            path = paths[layout]
            dense, lex, batch = path["dense"], path["lex"], path["batches"][0]
            gb = dense.memory_bytes() / 1e9
            mesh = sharded_mesh(device, SHARDS)
            sd = shard_dense_index(dense, mesh)
            want = ShardedRetriever(route_config(0), mesh, lex, sd,
                                    encoder).retrieve_batch(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_sharded(sd, root / layout)
            cell = {"gb": gb, "save_s": time.perf_counter() - t0}
            for n in loads:
                m = sharded_mesh(device, n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                back = load_sharded(root / layout, mesh=m)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                ref = shard_dense_index(dense, m)
                for a, b in zip(back.shards, ref.shards):
                    for k in ("emb_flat", "doc_lengths", "scales", "pooled",
                              "doc_scales"):
                        x, y = getattr(a, k), getattr(b, k)
                        if (x is None) != (y is None) or (
                                x is not None and not torch.equal(x, y)):
                            raise AssertionError(f"checkpoint {layout} at "
                                                 f"{n} shards: {k} differs")
                got = ShardedRetriever(route_config(0), m, lex, back,
                                       encoder).retrieve_batch(batch)
                if not np.array_equal(got[0], want[0]):
                    raise AssertionError(f"checkpoint {layout} at {n} "
                                         f"shards: ids {got[0]} vs {want[0]}")
                cell[f"load_s_at_{n}"] = load_s
                del back, ref
            shutil.rmtree(root / layout)
            log(f"sharded checkpoint {layout} ({gb:.2f} GB, {SHARDS} shards):"
                f" save {cell['save_s']:.2f}s ({gb / cell['save_s']:.2f} "
                "GB/s); load "
                + ", ".join(f"at {n} shards {cell[f'load_s_at_{n}']:.2f}s "
                            f"({gb / cell[f'load_s_at_{n}']:.2f} GB/s)"
                            for n in loads)
                + "; bytes and route-0 ids equal")
            out[layout] = cell
            del sd
            gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_sharded_bucketed(device, encoder, bk, lex, corpus, queries
                           ) -> dict:
    """The bucketed 100k int8 index on the full-width checkpoint encoder,
    cut into SHARDS shards (``shard_bucketed_index``) and served eagerly
    by ``ShardedBucketedRetriever`` on routes 1024 and 0: ``maxsim_int8``
    once per bucket per shard per route-0 call, the planted doc first,
    route 0 against the single-device bucketed route 0 (tie swaps only);
    route 0's merged dense top-100 against the plain scans; both timed
    beside the single-device graph and profiled. -> numbers"""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.ops.maxsim import NEG_INF
    from hybrid_rag_colbertv2_tpu_torch.parallel.mesh import (
        shard_bucketed_index)
    from hybrid_rag_colbertv2_tpu_torch.parallel.sharded import (
        ShardedBucketedRetriever)
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)
    t_phase = time.perf_counter()
    mesh = sharded_mesh(device, SHARDS)
    sb = shard_bucketed_index(bk, mesh)
    nb = len(bk.buckets)
    mgr = IndexManager(RAGConfig(), encoder, device=device)
    mgr.lexical, mgr.dense, mgr.corpus = lex, bk, corpus
    batches = [queries[i:i + BATCH] for i in range(0, 3 * BATCH, BATCH)]
    out = {"buckets": nb, "shards": SHARDS}
    single, routes = {}, {}
    for p in (1024, 0):
        single[p] = HybridRetriever(route_config(p), mgr, encoder,
                                    device=device)
        routes[p] = r = ShardedBucketedRetriever(route_config(p), mesh, lex,
                                                 sb, encoder)
        label = f"sharded bucketed 100k S={SHARDS} route {p}"
        outs, counted = zip(*(sharded_call_counted(
            label, r, b, "maxsim_scores_int8", nb * SHARDS if p == 0 else 0)
            for b in batches))
        check_outputs(label, outs, bk.n_docs, PLANTED_DOC)
        out[str(p)] = {"launches": sum(counted)}
        if p == 0:
            out["0"]["tie_swaps_vs_one_device"] = sum(
                tie_swaps(f"{label} vs one device", o,
                          single[p].retrieve_batch(b))
                for o, b in zip(outs, batches))
    # route 0's dense leg: every bucket's kernel on every shard, merged,
    # against the plain scans of the whole bucketed index
    q_emb = encoder.encode_queries(batches[0])
    plain = torch.full((q_emb.shape[0], bk.n_docs), NEG_INF,
                       dtype=torch.float32, device=device)
    for sub, gid in zip(bk.buckets, bk.global_ids):
        plain[:, gid[:sub.n_docs].long()] = scan(
            "maxsim_int8", "plain", q_emb, sub.emb_flat, sub.scales, None,
            sub.doc_lengths, sub.doc_len)[:, :sub.n_docs]
    fn0 = routes[0]._fn_for(routes[0].config.final_top_k)
    out["0"]["top100_ids_equal"] = hold_top100(
        f"sharded bucketed 100k S={SHARDS} route 0, shards merged",
        *fn0.dense_topk(q_emb, sb), plain)
    del plain
    t = timed_interleaved(
        {**{("sharded", p): (r.retrieve_batch, batches)
            for p, r in routes.items()},
         **{("graph", p): (r.retrieve_batch, batches)
            for p, r in single.items()}})
    for p, r in routes.items():
        label = f"sharded bucketed 100k S={SHARDS} route {p}"
        pr = profile_sharded(label, r.retrieve_batch, batches, "maxsim_int8",
                             nb * SHARDS if p == 0 else 0)
        c = out[str(p)]
        c.update(p50=t[("sharded", p)]["p50"], p90=t[("sharded", p)]["p90"],
                 device_ms=pr["device_ms"], host_launches=pr["host_launches"],
                 busy=pr["device_ms"] / t[("sharded", p)]["p50"],
                 kernel_per_call=pr["kernels"]["maxsim_int8"],
                 one_device_graph_p50=t[("graph", p)]["p50"])
        log(f"{label} eager: p50 {c['p50']:.3f} ms, p90 {c['p90']:.3f} ms "
            f"(one device, graph: p50 {c['one_device_graph_p50']:.3f} ms); "
            f"device {c['device_ms']:.3f} ms/call, busy {c['busy']:.1%}, "
            f"{c['host_launches']:.0f} host-side launches/call, maxsim_int8 "
            f"{c['kernel_per_call']:.0f}/call ({nb} buckets x {SHARDS} "
            f"shards on route 0); vs one device: "
            f"{c.get('tie_swaps_vs_one_device', '-')} tie swaps")
    drop_entries(bk)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_sharded_app(device) -> dict:
    """The app-path corpus (``write_corpus(n_docs=112)``, no training,
    route 0) uploaded once; an app that sees SHARDS devices
    (``visible_devices`` patched to ``[card] * SHARDS``) keeps the
    single-device graph by default (the index fits the card) and binds
    the sharded adapter with ``use_mesh=True``; its ids equal the
    unsharded app's (tie swaps only), ``maxsim_int8`` once per shard per
    call. -> numbers"""
    import tempfile
    import torch
    from hybrid_rag_colbertv2_tpu_torch.app.application import (
        RAGApplication, _ShardedAdapter)
    from hybrid_rag_colbertv2_tpu_torch.parallel import mesh as pmesh
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)
    from hybrid_rag_colbertv2_tpu_torch.tools.sample_corpus import (
        write_corpus)
    t_phase = time.perf_counter()
    kw = dict(encoder_train_steps=0, final_fusion="rerank",
              dense_prefilter=0)
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        docs = write_corpus(root / "docs", n_docs=APP_DOCS, seed=0)
        one = RAGApplication(app_config(root, **kw), use_ollama=False,
                             device=device)
        up = one.index_documents([str(p) for p in docs])
        one.initialize_chatbot(use_mesh=False)
        batches = app_query_batches(one.store.all_chunk_texts())[:3]
        real = pmesh.visible_devices
        pmesh.visible_devices = lambda dev=None: [torch.device(dev)] * SHARDS
        try:
            app = RAGApplication(app_config(root, **kw), use_ollama=False,
                                 device=device)
            # by default the index, which fits the card, keeps the graph
            app.initialize_chatbot()
            if not isinstance(app.retriever, HybridRetriever):
                raise AssertionError("use_mesh=None sharded an index that "
                                     "fits the card")
            app.initialize_chatbot(use_mesh=True)
        finally:
            pmesh.visible_devices = real
        if not isinstance(app.retriever, _ShardedAdapter):
            raise AssertionError("use_mesh=True did not bind the sharded "
                                 "adapter")
        shape = app.retriever._r.mesh.shape
        swaps = 0
        for b in batches:
            got, _ = sharded_call_counted("sharded app", app.retriever._r,
                                          b, "maxsim_scores_int8", SHARDS)
            swaps += tie_swaps("sharded app route 0", got,
                               one.retriever.retrieve_batch(b))
        rows = app.query_batch(batches[0])
        if len(rows) != BATCH or not all(rows):
            raise AssertionError("sharded app query_batch: empty rows")
        n_pad = app.indexes.dense.n_pad
        log(f"sharded app: {up['total_chunks']} chunks (n_pad {n_pad}), "
            "initialize_chatbot() kept HybridRetriever (the index fits "
            f"the card), initialize_chatbot(use_mesh=True) bound "
            f"{type(app.retriever).__name__} over {shape}; query_batch "
            "ids equal the unsharded app's over "
            f"{len(batches)} batches ({swaps} tie swaps), maxsim_int8 "
            f"{SHARDS}/call")
        out = {"chunks": up["total_chunks"], "mesh": shape,
               "tie_swaps": swaps}
        del app, one
        gc.collect()
    out["seconds"] = time.perf_counter() - t_phase
    return out



def phase_sharded(device) -> dict:
    """``--sharded-only``: the flat main paths built as the whole run
    builds them, then every sharded phase (flat and checkpoints, the
    bucketed 100k index on the checkpoint encoder, the app). -> numbers"""
    import torch
    t0 = time.perf_counter()
    encoder, _, paths = main_paths(device)
    for lay, path in paths.items():         # the single-device graphs
        for r in path["routes"].values():
            r.retrieve_batch(path["batches"][0])
    out = {"flat": phase_sharded_flat(device, paths, encoder)}
    lex, corpus, queries = (paths["int8"][k]
                            for k in ("lex", "corpus", "queries"))
    for path in paths.values():
        drop_entries(path["dense"])
    del paths, path, r, encoder
    gc.collect()
    torch.cuda.empty_cache()
    enc, _, _ = phase_checkpoint(device)
    bk, flat, _ = build_bucketed_100k(device, enc, queries)
    del flat
    out["bucketed"] = phase_sharded_bucketed(device, enc, bk, lex, corpus,
                                             queries)
    model, mem = weakref.ref(enc.model), torch.cuda.memory_allocated()
    del enc, bk
    out["freed_gb"] = check_freed("jina encoder and bucketed index dropped",
                                  model, mem)
    out["app"] = phase_sharded_app(device)
    out["seconds"] = time.perf_counter() - t0
    log(f"sharded phases: {out['seconds']:.1f}s")
    return out


# -- the training side of sharding (parallel/params.py, the trainer's mesh) --

# __graft_entry__.py's full training step: its corpus and its encoder (two
# layers of the `small` preset: rope), on a (data=4, model=2) mesh
GRAFT_MESH = (4, 2)
GRAFT_DOCS = 64
# the jina-width checks: TP forward over model extents 2 and 4, DP x TP
# steps on (data=2, model=2) against the unsharded trainer, same card
JINA_TP_EXTENTS = (2, 4)
JINA_TRAIN_MESH = (2, 2)
JINA_TRAIN_BATCH, JINA_TRAIN_DOC_LEN = 8, 128
N_TRAIN_COMPARED, N_TRAIN_TIMED = 3, 8
# TP forward vs unsharded (fp32, TF32 off; partial products summed in
# another order); the steps as the CPU tests hold them (losses rtol,
# parameters atol; attention key biases by the schedule, see
# tests/test_torch_train.py). The first step's gradients (of equal
# parameters: its update is zero) within GRAD_RTOL of each tensor's
# largest. At jina width Adam also turns the rounding noise of a few
# single elements' near-zero gradients into steps of up to the learning
# rate (4 of 558,445,568 elements past 1e-5 on the first H100 run, their
# first gradients ~1e-3 of their tensor's median): at most
# NOISE_ELEMENTS of the elements may pass the atol, each within the
# schedule's bound.
TP_ATOL = 1e-4
SHARDED_TRAIN_RTOL_LOSS, SHARDED_TRAIN_ATOL_PARAM = 1e-4, 1e-5
GRAD_RTOL = 1e-4
NOISE_ELEMENTS = 1e-7


def card_mesh(device, shape):
    from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig
    from hybrid_rag_colbertv2_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(MeshConfig(mesh_shape=shape),
                     devices=[device] * (shape[0] * shape[1]))


def graft_flow(device, count: bool) -> dict:
    """__graft_entry__.py:174-225 on ``device``: TP-shard the encoder over
    a GRAFT_MESH mesh of it, 3 DP x TP steps (warmup 1: the first update
    is zero), then ``ShardedRetriever`` with the same encoder over int8
    and int4-doc, with and without ``shard_bm25``, on the pruned route
    (JAX's ``dense_prefilter=8``) and route 0 (the layout's kernel in
    every shard; with ``count``, the wrapper counts set to 0 just before
    each call and read just after). -> losses, results, launches"""
    import numpy as np
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import (
        ColBERTTokenizer)
    from hybrid_rag_colbertv2_tpu_torch.parallel.mesh import (
        shard_dense_index)
    from hybrid_rag_colbertv2_tpu_torch.parallel.params import (
        shard_encoder_params)
    from hybrid_rag_colbertv2_tpu_torch.parallel.sharded import (
        ShardedRetriever)
    from hybrid_rag_colbertv2_tpu_torch.train.data import pseudo_query_pairs
    from hybrid_rag_colbertv2_tpu_torch.train.trainer import (
        ColBERTTrainer, TrainConfig)
    corpus = [f"sample document {i} about topic {i % 7}"
              for i in range(GRAFT_DOCS)]
    tok = ColBERTTokenizer.train_bpe(corpus, vocab_size=512)
    enc = ColBERTEncoder(ColBERTConfig.small(
        vocab_size=tok.vocab_size, num_layers=2, hidden_size=128,
        intermediate_size=256, num_heads=4), tok, seed=0, device=device)
    mesh = card_mesh(device, GRAFT_MESH)
    shard_encoder_params(enc.model, mesh)
    pairs = [(q, corpus[i]) for q, i in
             pseudo_query_pairs(corpus, n_pairs_per_doc=1, seed=0)]
    metrics = ColBERTTrainer(enc, TrainConfig(
        batch_size=2 * GRAFT_MESH[0], doc_len=32, steps=3, warmup_steps=1,
        learning_rate=1e-3), mesh=mesh).train(pairs)
    lex = LexicalIndex.build(corpus)
    embs, lengths = enc.encode_docs(corpus, doc_len=32)
    out, launches = {}, {}
    queries = ["sample topic 3", "document 5"]
    for dtype in ("int8", "int4-doc"):
        dense = shard_dense_index(DenseTokenIndex.build(
            embs, lengths, doc_len=32, dtype=dtype, docs_pad_multiple=128),
            mesh)
        wrapper = KERNELS[LAYOUT_KERNEL[dtype]][1]
        for sb in (False, True):
            for p in (8, 0):
                cfg = RAGConfig(final_top_k=5, fusion_candidates=8,
                                dense_prefilter=p)
                cfg.mesh.shard_bm25 = sb
                r = ShardedRetriever(cfg, mesh, lex, dense, enc)
                key = f"{dtype}/bm25_sharded={sb}/prefilter={p}"
                if count:
                    # route 0: the kernel once per data shard
                    (ids, scores), n = sharded_call_counted(
                        key, r, queries, wrapper,
                        GRAFT_MESH[0] if p == 0 else 0)
                    launches[key] = n
                else:
                    ids, scores = r.retrieve_batch(queries)
                if not ((ids >= 0).all() and np.isfinite(scores).all()):
                    raise AssertionError(f"graft flow {key}: {ids}")
                out[key] = (ids, scores)
    return {"losses": [m["loss"] for m in metrics], "results": out,
            "launches": launches}


def jina_checkpoint_dir(device) -> Path:
    """The synthetic jina-colbert-v2 checkpoint, written if absent."""
    ckpt = REPO / "build" / "jina_ckpt"
    if not (ckpt / "model.safetensors").exists():
        write_jina_checkpoint(ckpt, device)
    return ckpt


def step_numbers(label, trainer, batches) -> dict:
    """N_TRAIN_TIMED steps of ``trainer`` timed by CUDA events (p50), the
    step's peak memory above what was allocated before it, and host-side
    launches per step from torch.profiler over 2 more steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ts = []
    for i in range(N_TRAIN_TIMED):
        b = batches[i % len(batches)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        trainer.step_fn(b, trainer.updates)
        e1.record()
        trainer.updates += 1
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
        peak = torch.cuda.max_memory_allocated() - base
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[:2]:
            trainer.step_fn(b, trainer.updates)
            trainer.updates += 1
        torch.cuda.synchronize()
    ev = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    host = sum(e.count for e in ev if e.device_type != cuda
               and e.key in LAUNCH_CALLS) / 2
    device_ms = sum(e.self_device_time_total for e in ev
                    if e.device_type == cuda) / 1e3 / 2
    out = {"step_ms_p50": statistics.median(ts), "step_ms_min": min(ts),
           "step_peak_bytes": peak, "host_launches_per_step": host,
           "device_ms_per_step": device_ms,
           "allocated_bytes": torch.cuda.memory_allocated()}
    log(f"{label}: step p50 {out['step_ms_p50']:.3f} ms (CUDA events, "
        f"{N_TRAIN_TIMED} steps), device {device_ms:.3f} ms/step, "
        f"{host:.0f} host-side launches/step, step peak "
        f"{peak / 2**30:.2f} GiB above {base / 2**30:.2f} GiB allocated")
    return out


def jina_train_sharded(device) -> dict:
    """At jina-colbert-v2 width, on the synthetic checkpoint: the TP
    forward at model extents JINA_TP_EXTENTS against the unsharded
    forward (within TP_ATOL, queries and docs), then N_TRAIN_COMPARED
    DP x TP steps on a JINA_TRAIN_MESH mesh of the card against as many
    unsharded steps from the same weights (losses within
    SHARDED_TRAIN_RTOL_LOSS, every parameter within
    SHARDED_TRAIN_ATOL_PARAM but the key biases), then both timed."""
    import numpy as np
    import torch
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import ColBERTEncoder
    from hybrid_rag_colbertv2_tpu_torch.models.convert import (
        colbert_config_from_hf, convert_hf_dir)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import (
        ColBERTTokenizer)
    from hybrid_rag_colbertv2_tpu_torch.parallel.params import (
        shard_encoder_params)
    from hybrid_rag_colbertv2_tpu_torch.train.data import pseudo_query_pairs
    from hybrid_rag_colbertv2_tpu_torch.train.trainer import (
        ColBERTTrainer, TrainConfig)
    ckpt = jina_checkpoint_dir(device)
    cfg = colbert_config_from_hf(str(ckpt), query_max_tokens=LQ,
                                 doc_max_tokens=JINA_TRAIN_DOC_LEN)
    params = convert_hf_dir(str(ckpt), cfg)
    tok = ColBERTTokenizer.load(ckpt / "tokenizer.json")
    plain = ColBERTEncoder(cfg, tok, params=params, device=device)
    texts = app_corpus_texts(ckpt.parent / "tok")
    queries = [" ".join(t.split()[3:11]) for t in texts[:BATCH]]
    docs = texts[BATCH:BATCH + 16]
    ref_q = plain.encode_queries(queries)
    ref_d, _ = plain.encode_docs(docs, doc_len=JINA_TRAIN_DOC_LEN)
    q_ids = torch.as_tensor(np.stack([tok.encode_query(q, LQ)
                                      for q in queries]), device=device)

    def fwd_ms():
        with torch.inference_mode():
            return cuda_ms(lambda: plain.model(q_ids, torch.ones_like(q_ids)),
                           10)
    out = {"tp_forward": {"unsharded_query_ms": fwd_ms()}}
    for n in JINA_TP_EXTENTS:
        shard_encoder_params(plain.model, card_mesh(device, (1, n)))
        try:
            got_q = plain.encode_queries(queries)
            got_d, _ = plain.encode_docs(docs, doc_len=JINA_TRAIN_DOC_LEN)
            ms = fwd_ms()
        finally:
            plain.model.tp_plan = None
        err = max(float((got_q - ref_q).abs().max()),
                  float((got_d - ref_d).abs().max()))
        out["tp_forward"][f"model_{n}"] = {"max_abs_err": err,
                                           "query_ms": ms}
        log(f"jina TP forward, model extent {n}: max |diff| vs unsharded "
            f"{err:.3e} (limit {TP_ATOL:g}; 8 queries, 16 docs x "
            f"{JINA_TRAIN_DOC_LEN}); query forward {ms:.3f} ms against "
            f"{out['tp_forward']['unsharded_query_ms']:.3f} unsharded "
            f"(CUDA events)")
        if err > TP_ATOL:
            raise AssertionError(f"jina TP forward at {n}: {err}")
    del ref_q, ref_d

    sharded = ColBERTEncoder(cfg, tok, params=params, device=device)
    del params
    mesh = card_mesh(device, JINA_TRAIN_MESH)
    shard_encoder_params(sharded.model, mesh)
    kw = dict(batch_size=JINA_TRAIN_BATCH, doc_len=JINA_TRAIN_DOC_LEN,
              steps=100, warmup_steps=1)
    t_plain = ColBERTTrainer(plain, TrainConfig(**kw))
    t_tp = ColBERTTrainer(sharded, TrainConfig(**kw), mesh=mesh)
    pairs = [(q, texts[i]) for q, i in
             pseudo_query_pairs(texts, n_pairs_per_doc=1, seed=0)]
    groups = [pairs[i:i + JINA_TRAIN_BATCH] for i in
              range(0, JINA_TRAIN_BATCH * (N_TRAIN_COMPARED + 2),
                    JINA_TRAIN_BATCH)]
    losses = []
    grad_err, g0 = {}, {}
    for s in range(N_TRAIN_COMPARED):
        a = t_tp.step_fn(t_tp._make_batch(groups[s]), t_tp.updates)
        b = t_plain.step_fn(t_plain._make_batch(groups[s]), t_plain.updates)
        t_tp.updates += 1
        t_plain.updates += 1
        losses.append((float(a["loss"]), float(b["loss"])))
        if not np.isclose(*losses[-1], rtol=SHARDED_TRAIN_RTOL_LOSS,
                          atol=0.0):
            raise AssertionError(f"jina DP x TP step {s} loss {losses[-1]}")
        if s == 0:
            # the first update is zero: both gradients are of equal
            # parameters, the TP backward against the plain one
            for (name, p), q in zip(sharded.model.named_parameters(),
                                    plain.model.parameters()):
                scale = float(q.grad.abs().max())
                grad_err[name] = (float((p.grad - q.grad).abs().max())
                                  / max(scale, 1e-30))
                g0[name] = q.grad.detach().abs().clone()
    moved = sum(2 * t_plain.schedule(s) * (1 + 2 * t_plain.cfg.weight_decay)
                for s in range(N_TRAIN_COMPARED))
    worst, worst_key_bias, over = 0.0, 0.0, []
    for (name, p), q in zip(sharded.model.named_parameters(),
                            plain.model.parameters()):
        diff = (p.detach() - q.detach()).abs()
        d = float(diff.max())
        if name.endswith("attention.key.bias"):
            worst_key_bias = max(worst_key_bias, d)
            continue
        worst = max(worst, d)
        bad = diff > SHARDED_TRAIN_ATOL_PARAM
        if bad.any():
            g = g0[name]
            over.append((d, name, int(bad.sum()), diff.numel(),
                         float(g[bad].median()), float(g.median()),
                         float(g.max()), grad_err[name]))
    over.sort(reverse=True)
    worst_grad = max((v, k) for k, v in grad_err.items()
                     if not k.endswith("attention.key.bias"))
    n_elems = sum(p.numel() for p in plain.model.parameters())
    n_over = sum(o[2] for o in over)
    log(f"jina DP x TP step 0 gradients vs unsharded: worst max |diff| / "
        f"max |grad| {worst_grad[0]:.3e} ({worst_grad[1]}); parameters "
        f"over {SHARDED_TRAIN_ATOL_PARAM:g} after {N_TRAIN_COMPARED} steps "
        f"in {len(over)} tensors, {n_over} of {n_elems} elements; worst "
        "(max diff, name, over, size, median |g0| over, median |g0|, "
        f"max |g0|, grad rel err): {over[:8]}")
    if worst_grad[0] > GRAD_RTOL:
        raise AssertionError(f"jina DP x TP gradients: {worst_grad}")
    if (n_over > NOISE_ELEMENTS * n_elems or max(worst, worst_key_bias)
            > moved):
        raise AssertionError(f"jina DP x TP parameters: {n_over} elements "
                             f"over {SHARDED_TRAIN_ATOL_PARAM}, max |diff| "
                             f"{worst} (key biases {worst_key_bias}), bound "
                             f"{moved}")
    log(f"jina DP x TP ({JINA_TRAIN_MESH[0]} x {JINA_TRAIN_MESH[1]} on the "
        f"card) vs unsharded, {N_TRAIN_COMPARED} steps at batch "
        f"{JINA_TRAIN_BATCH}, doc_len {JINA_TRAIN_DOC_LEN}: losses "
        f"{[f'{a:.6f}/{b:.6f}' for a, b in losses]} (rtol "
        f"{SHARDED_TRAIN_RTOL_LOSS:g}); step-0 gradients within "
        f"{worst_grad[0]:.2e} of each tensor's largest (limit "
        f"{GRAD_RTOL:g}); parameters within {SHARDED_TRAIN_ATOL_PARAM:g} "
        f"but {n_over} elements (limit {NOISE_ELEMENTS * n_elems:.0f}), "
        f"max |diff| {worst:.3e}, key biases {worst_key_bias:.3e} (bound "
        f"{moved:.3e})")
    timed = [t_plain._make_batch(g) for g in groups[:2]]
    out["steps"] = {"losses": losses, "max_param_diff": worst,
                    "elements_over_atol": n_over, "elements": n_elems,
                    "max_grad_rel_err": worst_grad[0],
                    "max_key_bias_diff": worst_key_bias,
                    "key_bias_bound": moved,
                    "unsharded": step_numbers("jina unsharded step", t_plain,
                                              timed),
                    "dp_tp": step_numbers(
                        f"jina DP x TP step ({JINA_TRAIN_MESH[0]} x "
                        f"{JINA_TRAIN_MESH[1]})", t_tp, timed)}
    return out


def phase_train_sharded(device) -> dict:
    """The training side of sharding on the card: the tiny __graft_entry__
    flow (its retrieval counted, each kernel once per data shard on route
    0) held against the same flow on the CPU, then the jina-width checks.
    -> numbers"""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    card = graft_flow(device, count=True)
    cpu = graft_flow(torch.device("cpu"), count=False)
    if not np.allclose(card["losses"], cpu["losses"],
                       rtol=SHARDED_TRAIN_RTOL_LOSS, atol=0.0):
        raise AssertionError(f"graft flow losses card {card['losses']} vs "
                             f"CPU {cpu['losses']}")
    swaps = {k: tie_swaps(f"graft flow {k}", v, cpu["results"][k])
             for k, v in card["results"].items()}
    log(f"graft flow on a {GRAFT_MESH[0]} x {GRAFT_MESH[1]} mesh of the "
        f"card: losses {[f'{x:.6f}' for x in card['losses']]} (CPU "
        f"{[f'{x:.6f}' for x in cpu['losses']]}); sharded retrieval over "
        f"{len(card['results'])} cases equal to the CPU's "
        f"({sum(swaps.values())} tie swaps); route-0 launches "
        f"{card['launches']}")
    out = {"graft": {"losses": card["losses"], "cpu_losses": cpu["losses"],
                     "tie_swaps": swaps, "launches": card["launches"]}}
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    out["jina"] = jina_train_sharded(device)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"train-sharded phase: {out['seconds']:.1f}s")
    return out


# -- the tools and utilities (tools/, utils/{timing,profiling,native}) -------

# the repo's own markdown (the JAX bench's organic pass, bench.py:936-940)
ORGANIC_DOCS = ("README.md", "SURVEY.md", "PARITY.md", "BASELINE.md",
                "docs/architecture.md", "docs/performance.md",
                "docs/scaling.md")
EVAL_QUERIES = 32
SERVE_LEVELS = "1,4,8"
N_NATIVE_REPS = 3


def run_main(label, main_fn, argv) -> list:
    """A tool's ``main(argv)`` in this process, its stdout captured:
    -> the JSON objects it printed, one per line."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    text = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"{label} returned {rc}:\n{text[-3000:]}")
    log(f"{label} ({time.perf_counter() - t0:.1f}s):\n"
        + "\n".join(f"  {ln}" for ln in text.strip().splitlines()))
    return [json.loads(ln) for ln in text.strip().splitlines()
            if ln.startswith("{")]


def tools_eval(app, root: Path) -> dict:
    """``eval_recall.evaluate`` on the app phase's app (the exact leg is
    route 0: its kernel), the same on the CPU over the same index (the
    gate's verdict pinned), and the CLI's ``--eval`` in a subprocess on
    the card, whose keys must be ``evaluate``'s."""
    import copy
    from hybrid_rag_colbertv2_tpu_torch.app.application import (
        RAGApplication)
    from hybrid_rag_colbertv2_tpu_torch.tools.eval_recall import evaluate
    got = evaluate(app, n_queries=EVAL_QUERIES)
    cpu_app = RAGApplication(copy.deepcopy(app.config), use_ollama=False,
                             device="cpu")
    cpu_app.initialize_chatbot(use_mesh=False)
    cpu = evaluate(cpu_app, n_queries=EVAL_QUERIES, measure_latency=False)
    del cpu_app
    quality = [k for k in cpu if k.startswith(("hit@", "agreement@"))]
    # one query's hit may move where card and CPU swap tied scores
    off = {k: abs(got[k] - cpu[k]) for k in quality}
    if any(v > 1.0 / EVAL_QUERIES + 1e-9 for v in off.values()):
        raise AssertionError(f"eval_recall card {got} vs CPU {cpu}")
    app.config.save(root / "eval.json")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"{PORT}.app.cli", "--config",
                        str(root / "eval.json"), "--eval",
                        str(EVAL_QUERIES), "--no-generate"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"CLI --eval failed: {r.stderr[-2000:]}")
    cli = json.loads(r.stdout.strip().splitlines()[-1])
    if {k: cli[k] for k in quality} != {k: got[k] for k in quality}:
        raise AssertionError(f"CLI --eval {cli} vs evaluate {got}")
    log(f"eval_recall on the app's {got['chunks']} chunks ({app.device}): "
        f"{json.dumps(got)}; CPU {json.dumps(cpu)}; CLI --eval equal "
        f"({cli_s:.1f}s, process start included)")
    return {"card": got, "cpu": cpu, "cli_eval_s": cli_s}


def tools_organic(device) -> dict:
    """``organic_questions.evaluate_questions`` on an app over the repo's
    markdown, the JAX bench's organic config (auto-train, the gate)."""
    import tempfile
    from hybrid_rag_colbertv2_tpu_torch.app.application import (
        RAGApplication)
    from hybrid_rag_colbertv2_tpu_torch.tools.organic_questions import (
        evaluate_questions)
    docs = [str(REPO / p) for p in ORGANIC_DOCS if (REPO / p).exists()]
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        t0 = time.perf_counter()
        app = RAGApplication(app_config(root, doc_max_tokens=192),
                             use_ollama=False, device=device)
        app.index_documents(docs)
        app.initialize_chatbot()
        build_s = time.perf_counter() - t0
        res = evaluate_questions(app)
        if not res["n"] or not 0.0 <= res["hit10"] <= 1.0:
            raise AssertionError(f"organic questions: {res}")
        res.update(docs=len(docs), chunks=app.store.stats()["chunks"],
                   build_s=build_s, verdict=[app.config.final_fusion,
                                             app.config.fusion_weight_bm25])
        del app
    log(f"organic questions over {res['docs']} repo docs ({res['chunks']} "
        f"chunks, built, trained and gated in {build_s:.1f}s): "
        f"{json.dumps(res)}")
    return res


def tools_native(app) -> dict:
    """The native text library against the Python path on the app's
    corpus: tokenization, the lexical build, and the upload's host pairs +
    mining (``_train_encoder`` with the steps left out), equal outputs,
    the native path asserted in use, each timed (median of
    N_NATIVE_REPS, pairs + mining once each)."""
    import os
    import numpy as np
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    from hybrid_rag_colbertv2_tpu_torch.index.textproc import tokenize_corpus
    from hybrid_rag_colbertv2_tpu_torch.train import trainer as trainer_mod
    from hybrid_rag_colbertv2_tpu_torch.utils import native
    if native.get_lib() is None:
        raise AssertionError("the native text library did not build")
    corpus = app.store.all_chunk_texts()
    used = []
    real = native.build_postings_native, native.tokenize_corpus_native

    def counted(fn):
        def wrapped(*a, **k):
            r = fn(*a, **k)
            used.append(r is not None)
            return r
        return wrapped
    native.build_postings_native = counted(real[0])
    native.tokenize_corpus_native = counted(real[1])
    real_train = trainer_mod.ColBERTTrainer.train
    seen_pairs = {}

    def no_steps(self, pairs, steps=None):
        seen_pairs[mode] = pairs
        return []
    out, results = {}, {}
    try:
        trainer_mod.ColBERTTrainer.train = no_steps
        for mode in ("native", "python", "native", "python", "native",
                     "python"):
            if mode == "python":
                os.environ["HRAG_NO_NATIVE"] = "1"
            else:
                os.environ.pop("HRAG_NO_NATIVE", None)
            used.clear()
            t = {}
            t0 = time.perf_counter()
            toks = tokenize_corpus(corpus)
            t["tokenize_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            lex = LexicalIndex.build(corpus)
            t["lexical_build_s"] = time.perf_counter() - t0
            if mode not in seen_pairs:
                t0 = time.perf_counter()
                app._train_encoder(corpus)
                t["pairs_and_mining_s"] = time.perf_counter() - t0
            if any(used) != (mode == "native") or (
                    mode == "native" and not all(used)):
                raise AssertionError(f"{mode} run: native calls {used}")
            for k, v in t.items():
                out.setdefault(mode, {}).setdefault(k, []).append(v)
            results.setdefault(mode, (toks, lex))
    finally:
        os.environ.pop("HRAG_NO_NATIVE", None)
        trainer_mod.ColBERTTrainer.train = real_train
        native.build_postings_native, native.tokenize_corpus_native = real
    (tn, ln), (tp, lp) = results["native"], results["python"]
    if tn != tp or ln.vocab != lp.vocab or not all(
            np.array_equal(getattr(ln, a), getattr(lp, a))
            for a in ("indptr", "post_docs", "post_weights")):
        raise AssertionError("native and Python lexical outputs differ")
    if seen_pairs["native"] != seen_pairs["python"]:
        raise AssertionError("native and Python training pairs differ")
    med = {m: {k: statistics.median(v) for k, v in d.items()}
           for m, d in out.items()}
    log(f"native text library ({native.library_path().name}) vs Python on "
        f"the app's {len(corpus)} chunks (host clock, median of "
        f"{N_NATIVE_REPS}; pairs + mining once each): " + "; ".join(
            f"{k} {med['native'][k]:.3f} s vs {med['python'][k]:.3f} s"
            for k in med["native"]) + f"; {len(seen_pairs['native'])} "
        "training pairs equal")
    return {"chunks": len(corpus), **med}


def phase_tools(device, app, root: Path) -> dict:
    """The port's tools on the card, after the app phase (whose app and
    directory they use): check_env (the five kernel probes against their
    plain versions), eval_recall and the CLI's --eval, the organic
    questions, stage_probe at N_DOCS (with a profile and 4,096 docs
    encoded) and --flagship, serve_probe at
    SERVE_LEVELS and --chat with the mock sidecar, and the native text
    library timed against the Python path. The wrapper counts are set to
    0 just before and read just after; every kernel must have run."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.tools import (
        check_env, serve_probe, stage_probe)
    t0 = time.perf_counter()
    reset_launch_counts()
    out = {}
    run_main("check_env", check_env.main, [])
    out["check_env_launches"] = launch_counts()
    if any(out["check_env_launches"][w] < (2 if w == "maxsim_scores" else 1)
           for w in WRAPPERS):
        raise AssertionError(f"check_env launches "
                             f"{out['check_env_launches']}")
    out["eval"] = tools_eval(app, root)
    out["native"] = tools_native(app)
    out["stage_probe"] = run_main(
        "stage_probe", stage_probe.main,
        ["--n-docs", str(N_DOCS), "--encode-docs", "4096", "--profile",
         str(REPO / "build" / "stage_probe_trace")])
    out["stage_probe_flagship"] = run_main(
        "stage_probe --flagship", stage_probe.main,
        ["--flagship", "--iters", "8"])
    out["serve"] = run_main(
        "serve_probe", serve_probe.main,
        ["--concurrency", SERVE_LEVELS, "--requests", "32", "--json"])[-1]
    out["serve_chat"] = run_main(
        "serve_probe --chat", serve_probe.main,
        ["--n-docs", "16", "--concurrency", SERVE_LEVELS, "--requests", "4",
         "--chat", "--gen-latency-ms", "100", "--json"])[-1]
    out["launches"] = launch_counts()
    if any(n == 0 for n in out["launches"].values()):
        raise AssertionError(f"tools phase launches {out['launches']}")
    for res in (out["serve"], out["serve_chat"]):
        if any(lv["errors"] for lv in res["levels"]):
            raise AssertionError(f"serve_probe errors: {res}")
    trace = REPO / "build" / "stage_probe_trace" / "trace.json"
    if not trace.stat().st_size:
        raise AssertionError("stage_probe --profile wrote no trace")
    torch.cuda.synchronize()
    out["organic"] = tools_organic(device)
    out["seconds"] = time.perf_counter() - t0
    log(f"tools phase: {out['seconds']:.1f}s; wrapper launches "
        f"{out['launches']}")
    return out


# -- the port's bench (bench.py's passes) and the quickstart demo -----------

# the bench line's numeric keys of the headline, recall, 1M (with the
# throughput fields) and 2M passes; realdata and organic are switched off
# in the subprocess (the seed below runs the realdata path here)
BENCH_KEYS = ("value", "vs_baseline", "recall10_vs_exact",
              "recall10_vs_exact_int4", "p50_ms_1m", "vs_baseline_1m",
              "p50_ms_1m_int4", "qps_chip_1m_int4", "scan_p50_ms_1m_int4",
              "scan_tflops_1m_int4", "scan_gbps_1m_int4",
              "encoder_p50_ms_b8", "encoder_tflops", "p50_ms_2m_int4",
              "vs_baseline_2m")
BENCH_SEED_STEPS = 300          # the app phase's training steps
BENCH_TIMEOUT = 600
SEED_SOURCES = ("paraphrase", "ict", "adversarial")


def phase_bench(device, peaks) -> dict:
    """``--bench`` through the CLI in a subprocess (the card's full sizes,
    realdata and organic switched off by the JAX bench's own switches):
    rc 0, the last stdout line one JSON object with every ``BENCH_KEYS``
    finite, both recalls in [0, 1], the int4 scan below the card's dense
    bf16 peak, ``maxsim_int4_group`` launched. Then one realdata seed in
    this process (``bench._seed_eval``, seed 0, BENCH_SEED_STEPS steps:
    the app, the gate, its transfer check and 9 evals, whose exact
    baseline is route 0, ``maxsim_int8``), counted from 0; then the
    quickstart demo in a subprocess on the card. -> numbers"""
    import math
    import os
    import tempfile
    from hybrid_rag_colbertv2_tpu_torch import bench
    t0 = time.perf_counter()
    env = dict(os.environ, HRAG_BENCH_REALDATA="0", HRAG_BENCH_ORGANIC="0")
    r = subprocess.run([sys.executable, "-m", f"{PORT}.app.cli", "--bench"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT)
    out = {"cli_bench_s": time.perf_counter() - t0}
    out["pass_s"] = {k: float(v) for k, v in re.findall(
        r"(?m)^\[pass (\S+): ([\d.]+)s\]$", r.stderr)}
    log(f"--bench (subprocess, {out['cli_bench_s']:.1f}s): rc "
        f"{r.returncode}; stderr tail:\n{r.stderr[-6000:]}")
    if r.returncode != 0:
        raise AssertionError(f"--bench returned {r.returncode}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    bad = [k for k in BENCH_KEYS if not isinstance(line.get(k), (int, float))
           or not math.isfinite(line[k])]
    if bad or line.get("unit") != "ms" or "metric" not in line:
        raise AssertionError(f"bench line lacks finite {bad}: {line}")
    if not all(0.0 <= line[k] <= 1.0 for k in ("recall10_vs_exact",
                                               "recall10_vs_exact_int4")):
        raise AssertionError(f"bench recall outside [0, 1]: {line}")
    if line["scan_tflops_1m_int4"] >= peaks[0] / 1e12:
        raise AssertionError(f"int4 scan {line['scan_tflops_1m_int4']} "
                             f"TFLOP/s at or above the bf16 peak")
    out["line"] = line
    out["bench_launches"] = json.loads(re.search(
        r"(?m)^kernel launches: (\{.*\})$", r.stderr).group(1))
    if out["bench_launches"]["maxsim_scores_int4_doc"] < 1:
        raise AssertionError(f"bench launches {out['bench_launches']}")

    t0 = time.perf_counter()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as td:
        seed = bench._seed_eval(td, APP_DOCS, BENCH_SEED_STEPS, 0, 1024, 512,
                                Path(td) / "cache", device)
    out["seed_launches"] = launch_counts()
    out["seed_s"] = time.perf_counter() - t0
    if out["seed_launches"]["maxsim_scores_int8"] < 1:
        raise AssertionError(f"realdata seed launches "
                             f"{out['seed_launches']}")
    want = {"hit10", "hit10_parity", "hit10_rrf", "hit10_bm25_only",
            "hit10_dense_only", "agreement10_vs_exact", "queries"}
    if ({"gate", "chunks", "gate_transfer", *SEED_SOURCES} - set(seed)
            or any(set(seed[s]) != want for s in SEED_SOURCES)
            or not all(0.0 <= seed[s][k] <= 1.0 for s in SEED_SOURCES
                       for k in want - {"queries"})):
        raise AssertionError(f"realdata seed result {seed}")
    out["seed"] = {s: seed[s] for s in SEED_SOURCES}
    out["seed"].update(chunks=seed["chunks"], gate=seed["gate"]["picked"],
                       transfer=seed["gate_transfer"]["transfer_hit@10"])
    log(f"realdata seed 0 at {BENCH_SEED_STEPS} steps ({out['seed_s']:.1f}s,"
        f" {seed['chunks']} chunks): {json.dumps(out['seed'])}; launches "
        f"{out['seed_launches']}")
    out["launches"] = {w: out["bench_launches"][w] + out["seed_launches"][w]
                       for w in WRAPPERS}

    t0 = time.perf_counter()
    d = subprocess.run([sys.executable, "-m", f"{PORT}.examples.demo"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    out["demo_s"] = time.perf_counter() - t0
    if d.returncode != 0 or "retrievable" not in d.stdout:
        raise AssertionError(f"demo returned {d.returncode}: "
                             f"{d.stdout[-2000:]}{d.stderr[-2000:]}")
    log(f"demo (subprocess, {out['demo_s']:.1f}s):\n{d.stdout[-1500:]}")
    return out


if __name__ == "__main__":
    sys.exit(main())
