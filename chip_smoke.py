#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py         # exits 0 on success; needs one card

Drives the port's main path (``hybrid_rag_colbertv2_tpu_torch``), never
JAX: builds every CUDA kernel from ``csrc/``, holds each kernel against
its plain PyTorch version on the card, then serves batches of 8 queries
through ``HybridRetriever.retrieve_batch`` over a 100,000-chunk x 128-token
int8 index (the size of the JAX package's bench.py headline) with the
``small`` encoder preset (random weights from a seed), on both dense
routes: ``dense_prefilter=1024`` (pruned) and ``0`` (full scan through the
CUDA int8 MaxSim kernel). Any failed check raises and exits non-zero.

It also prints the p50 and p90 latency of each route, each kernel's time
beside its bound and its plain version's time, and (last, so tracing
does not touch the timings) each route's device time by kernel from
torch.profiler. Stdout ends with the ``{"kernels": [...]}`` summary line,
the card's ``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PORT = "hybrid_rag_colbertv2_tpu_torch"

N_DOCS, DOC_LEN, DIM, BATCH, LQ = 100_000, 128, 128, 8, 32
N_TOPICS, TOPIC_NOISE = 512, 0.35
PLANTED_DOC = 4242
# kernel vs plain version: fp32 sums in other orders (products are exact)
RTOL, ATOL = 1e-5, 1e-3
# published dense peaks: (bf16 FLOP/s, HBM bytes/s) — NVIDIA data sheets
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}


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


def random_index(gen, n, doc_len, dim, device, plants=None,
                 n_topics=N_TOPICS, n_valid=None, zero_docs=(), block=1024):
    """Topic-clustered unit-norm token rows (bench.py's generator),
    lengths in [doc_len/2, doc_len], padding rows zeroed, quantized by the
    port's quantize_int8_rows, generated on the card in doc blocks.
    ``plants`` {doc: (rows, D) unit rows} overwrite a doc's first rows;
    docs from ``n_valid`` on, and ``zero_docs``, have length 0."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops.quant import quantize_int8_rows
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
    emb = torch.empty((n * doc_len, dim), dtype=torch.int8, device=device)
    scales = torch.empty((n * doc_len,), dtype=torch.float32, device=device)
    tok = torch.arange(doc_len, device=device)
    for s in range(0, n, block):
        e = min(n, s + block)
        x = topics[assign[s:e]][:, None, :] + TOPIC_NOISE * torch.randn(
            e - s, doc_len, dim, generator=gen, device=device)
        x = x / x.norm(dim=-1, keepdim=True)
        for doc, rows in (plants or {}).items():
            if s <= doc < e:
                x[doc - s, :rows.shape[0]] = rows
        x = x * (tok[None, :] < lengths[s:e, None])[..., None]
        q8, sc = quantize_int8_rows(x.reshape(-1, dim))
        emb[s * doc_len:e * doc_len] = q8
        scales[s * doc_len:e * doc_len] = sc
    return emb, scales, lengths


def phase_kernel_small(device):
    """Kernel vs plain version at small shapes: ragged N, zero-length
    docs, a zeroed valid row, B in {1, 8, 64}, L in {64, 128, 256}."""
    import torch
    from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as ms
    gen = torch.Generator(device=device).manual_seed(1)
    cases = [(1, 64, 1037, 128), (8, 128, 3001, 128), (64, 256, 515, 128),
             (9, 128, 700, 128), (3, 64, 77, 32)]
    for b, doc_len, n, dim in cases:
        emb, scales, lengths = random_index(
            gen, n, doc_len, dim, device, n_topics=16,
            zero_docs=(0, n // 2), block=256)
        scales[5 * doc_len + 1] = 0.0                 # a zeroed valid row
        emb[5 * doc_len + 1] = 0
        q = torch.randn(b, LQ, dim, generator=gen, device=device)
        q = q / q.norm(dim=-1, keepdim=True)
        q[:, LQ - 3:] = 0.0                           # padded query rows
        out = ms.maxsim_scores_int8(q, emb, scales, lengths, doc_len=doc_len)
        torch.cuda.synchronize()
        ref = ms.maxsim_scores_int8_reference(q, emb, scales, lengths,
                                              doc_len=doc_len)
        torch.cuda.synchronize()
        err, same = compare(out, ref, min(100, n))
        if not (out[:, [0, n // 2]] < -1e31).all():
            raise AssertionError("zero-length docs must score -1e30 * Lq")
        log(f"kernel maxsim_int8 B={b} L={doc_len} N={n} D={dim}: "
            f"max_abs_err={err:.3e} top100_ids_equal={same}")


def build_lexical():
    import numpy as np
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    rng = np.random.default_rng(0)
    vocab = np.array([f"term{i}" for i in range(5_000)])
    corpus = [" ".join(r) for r in vocab[rng.integers(0, 5_000,
                                                      (N_DOCS, 12))]]
    lex = LexicalIndex.build(corpus, postings_cap=512)
    queries = [" ".join(rng.choice(vocab, 6)) for _ in range(4 * BATCH)]
    return lex, corpus, queries


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / PORT / "csrc").is_dir():
        print(f"chip_smoke: {PORT}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hybrid_rag_colbertv2_tpu_torch.ops import _build
    from hybrid_rag_colbertv2_tpu_torch.utils.device import (
        set_fp32_matmul_exact)
    set_fp32_matmul_exact()
    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build the kernel from csrc/ ----------------------------
    t0 = time.perf_counter()
    lib = _build.build("maxsim_int8")
    log(f"build: maxsim_int8 {time.perf_counter() - t0:.1f}s")
    ptxas = lib.with_suffix(".log").read_text()
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
    spills = re.findall(r"([1-9]\d*) bytes spill", ptxas)
    log(f"ptxas maxsim_int8: {len(regs)} kernels, {min(regs)}-{max(regs)} "
        f"registers, spills: {spills or 'none'}")

    # -- phase 2: kernel vs plain version at small shapes ----------------
    phase_kernel_small(device)

    # -- phase 3: the main path at full size -----------------------------
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    from hybrid_rag_colbertv2_tpu_torch.ops import maxsim as ms
    from hybrid_rag_colbertv2_tpu_torch.ops.prefilter import (
        pooled_doc_embeddings)
    from hybrid_rag_colbertv2_tpu_torch.ops.topk import top_k
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever, hybrid_cascade)

    t0 = time.perf_counter()
    lex, corpus, queries = build_lexical()
    log(f"lexical: {N_DOCS} docs, max_postings={lex.max_postings}, "
        f"{time.perf_counter() - t0:.1f}s")
    tok = HashTokenizer(8192)
    encoder = ColBERTEncoder(ColBERTConfig.small(vocab_size=8192), tok,
                             seed=0, device=device)
    planted_q = queries[0]
    plant_rows = encoder.encode_queries([planted_q])[0].clone()  # (Lq, D)

    t0 = time.perf_counter()
    n_pad = ((N_DOCS + 127) // 128) * 128
    gen = torch.Generator(device=device).manual_seed(0)
    emb, scales, lengths = random_index(
        gen, n_pad, DOC_LEN, DIM, device, n_valid=N_DOCS,
        plants={PLANTED_DOC: plant_rows})
    pooled = pooled_doc_embeddings(emb, scales, lengths, doc_len=DOC_LEN)
    dense = DenseTokenIndex(emb_flat=emb, doc_lengths=lengths,
                            n_docs=N_DOCS, doc_len=DOC_LEN, dim=DIM,
                            scales=scales, pooled=pooled)
    torch.cuda.synchronize()
    log(f"dense index: {n_pad} x {DOC_LEN} x {DIM} int8, "
        f"{dense.memory_bytes() / 1e9:.2f} GB on the card, "
        f"{time.perf_counter() - t0:.1f}s")
    mgr = IndexManager(RAGConfig(), encoder, device=device)
    mgr.lexical, mgr.dense, mgr.corpus = lex, dense, corpus
    routes = {p: HybridRetriever(
        RAGConfig(dense_prefilter=p, final_fusion="rerank",
                  bm25_postings_cap=512), mgr, encoder, device=device)
        for p in (1024, 0)}
    batches = [queries[i:i + BATCH] for i in range(0, 3 * BATCH, BATCH)]
    for r in routes.values():                 # first-use allocations
        r.retrieve_batch(batches[0])
    torch.cuda.synchronize()

    # the counted run of the main path: both routes, 3 batches each
    ms.maxsim_scores_int8.launches = 0
    results = {p: [r.retrieve_batch(b) for b in batches]
               for p, r in routes.items()}
    torch.cuda.synchronize()
    launches = ms.maxsim_scores_int8.launches
    log(f"main path: launches maxsim_int8={launches} over "
        f"{len(batches)} batches per route")
    if launches != len(batches):
        raise AssertionError("dense_prefilter=0 must launch the int8 kernel "
                             "once per retrieve_batch")
    for p, outs in results.items():
        for ids, scores in outs:
            if ids.shape != (BATCH, 10) or not (
                    (ids >= -1) & (ids < N_DOCS)).all():
                raise AssertionError(f"bad ids on route {p}: {ids}")
            if not np.isfinite(scores[ids >= 0]).all():
                raise AssertionError(f"non-finite scores on route {p}")
        planted_rank1 = int(outs[0][0][0, 0])
        log(f"route dense_prefilter={p}: planted doc {PLANTED_DOC} -> "
            f"rank-1 id {planted_rank1}")
        if planted_rank1 != PLANTED_DOC:
            raise AssertionError("planted query must return its doc first")

    # dense top-100 of the scan route vs the plain version + top-k
    q_emb = encoder.encode_queries(batches[0])
    lex_dev = routes[0]._lex_dev
    q_terms = torch.as_tensor(
        np.stack([lex.encode_query(q, 32) for q in batches[0]]),
        device=device)
    with torch.inference_mode():
        _, _, dbg = hybrid_cascade(
            q_emb, q_terms, lex_dev["indptr"], lex_dev["post_docs"],
            lex_dev["post_weights"], emb, scales, lengths, None, None,
            **routes[0]._statics(10))
    plain = ms.maxsim_scores_int8_reference(q_emb, emb, scales, lengths,
                                            doc_len=DOC_LEN)[:, :N_DOCS]
    pv, pi = top_k(plain, 100)
    kv, ki = dbg["ms_vals"], dbg["ms_ids"].long()
    if not torch.allclose(kv, pv, rtol=RTOL, atol=ATOL):
        raise AssertionError("dense top-100 values differ from plain")
    ids_equal = bool(torch.equal(ki, pi))
    if not ids_equal and not torch.allclose(
            torch.gather(plain, 1, ki), pv, rtol=RTOL, atol=ATOL):
        raise AssertionError("dense top-100 ids differ beyond ties")
    log(f"scan route dense top-100 vs plain: ids_equal={ids_equal}")

    # small-input reference: the same cascade on the CPU's plain versions
    swaps = check_small_cascade(device)
    log(f"small index, card vs CPU plain versions: final ids agree "
        f"({swaps} slots swapped between tied scores)")

    # -- phase 4: numbers (tracing off; the profile comes last) ----------
    times = {p: [] for p in routes}
    for i in range(100):                       # routes interleaved
        for p, r in routes.items():
            t0 = time.perf_counter()
            r.retrieve_batch(batches[i % len(batches)])
            times[p].append((time.perf_counter() - t0) * 1e3)
    lat = {}
    for p, ts in times.items():
        q = statistics.quantiles(ts, n=10)
        lat[p] = {"p50": statistics.median(ts), "p90": q[-1]}
        log(f"retrieve_batch dense_prefilter={p}: p50 {lat[p]['p50']:.3f} "
            f"ms, p90 {lat[p]['p90']:.3f} ms (batch {BATCH}, {N_DOCS} "
            f"chunks, host clock, {len(ts)} calls)")
    full = ms.maxsim_scores_int8(q_emb, emb, scales, lengths,
                                 doc_len=DOC_LEN)
    torch.cuda.synchronize()
    ref_full = ms.maxsim_scores_int8_reference(q_emb, emb, scales, lengths,
                                               doc_len=DOC_LEN)
    err, same = compare(full, ref_full, 100)
    log(f"kernel maxsim_int8 main shape: max_abs_err={err:.3e} "
        f"top100_ids_equal={same}")
    k_ms = cuda_ms(lambda: ms.maxsim_scores_int8(
        q_emb, emb, scales, lengths, doc_len=DOC_LEN), 20)
    p_ms = cuda_ms(lambda: ms.maxsim_scores_int8_reference(
        q_emb, emb, scales, lengths, doc_len=DOC_LEN), 3, warmup=1)
    emb_bf = emb.to(torch.bfloat16)
    q_bf = q_emb.reshape(-1, DIM).to(torch.bfloat16).T.contiguous()
    mm_ms = cuda_ms(lambda: torch.matmul(emb_bf, q_bf), 10)
    del emb_bf
    # the work this run's data needs: products and int8 reads only for
    # rows with a nonzero scale (the rest are masked to -1e30); every
    # scale, the query and the output once
    valid_rows = int((scales > 0).sum())
    flops = 2.0 * BATCH * LQ * DIM * valid_rows
    nbytes = (valid_rows * DIM + scales.numel() * 4 + q_emb.numel() * 4
              + BATCH * n_pad * 4)
    peak_flops, peak_bw = peaks_for(name)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    log(f"maxsim_int8 at B={BATCH} Lq={LQ} N={n_pad} L={DOC_LEN} D={DIM}: "
        f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
        f"{max(t_ops, t_bytes):.3f} ms ({flops / 1e12:.3f} TFLOP, "
        f"{nbytes / 1e9:.3f} GB; {valid_rows} of {scales.numel()} rows "
        f"valid), bf16 matmul of the product alone {mm_ms:.3f} ms")
    for p, r in routes.items():
        profile_route(p, r, batches)
    print(json.dumps({"retrieve_batch_ms": {str(p): v for p, v in lat.items()},
                      "card": card}))
    print(json.dumps({"kernels": [{
        "name": "maxsim_int8", "route": "cuda",
        "source": f"{PORT}/csrc/maxsim_int8.cu",
        "replaces": "hybrid_rag_colbertv2_tpu/ops/maxsim.py:231",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "matmul_only_ms": mm_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def profile_route(prefilter, retriever, batches, calls: int = 5) -> None:
    """Device time per retrieve_batch by kernel name, and the device's
    busy share of the wall time (torch.profiler, CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            retriever.retrieve_batch(batches[i % len(batches)])
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # device-side entries only (kernels, copies): an operator's entry
    # repeats the device time of the kernels it launched
    rows = [(e.self_device_time_total / 1e3 / calls, e.count // calls, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile dense_prefilter={prefilter}: wall {wall_ms:.3f} ms/call, "
        f"device {busy:.3f} ms/call (busy share {busy / wall_ms:.1%}), "
        f"{sum(r[1] for r in rows)} device ops/call")
    for ms_, n, key in rows[:12]:
        log(f"  {ms_:8.3f} ms  x{n:<4d} {key[:90]}")


def check_small_cascade(device) -> int:
    """A 600-doc index served on the card (kernel) and on the CPU (plain
    versions) must give the same final scores and ids on both routes.
    Its closest two final scores are ~2e-4 apart, inside the tolerance,
    so two ids may swap, but only where their CPU scores tie within the
    tolerance. Returns the number of swapped slots."""
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
        mgr = IndexManager(RAGConfig(), enc, device=dev)
        mgr.lexical = lex
        embs, lengths = enc.encode_docs(corpus, doc_len=64)
        mgr.dense = DenseTokenIndex.build(embs, lengths, doc_len=64,
                                          dtype="int8")
        for p in (1024, 0):
            r = HybridRetriever(RAGConfig(dense_prefilter=p,
                                          final_fusion="rerank"),
                                mgr, enc, device=dev)
            out[(dev.type, p)] = r.retrieve_batch(queries)
    rtol, atol = 1e-4, 1e-3
    swaps = 0
    for p in (1024, 0):
        gi, gs = out[("cuda", p)]
        ci, cs = out[("cpu", p)]
        if not np.allclose(gs, cs, rtol=rtol, atol=atol):
            raise AssertionError(f"small cascade scores differ, route {p}")
        for row, j in np.argwhere(gi != ci):
            # the card's doc in this slot, scored on the CPU: its slot
            # there, or below the CPU's last slot when it fell out
            hit = np.flatnonzero(ci[row] == gi[row, j])
            cpu_score = cs[row, hit[0]] if hit.size else cs[row, -1]
            if not np.isclose(cpu_score, cs[row, j], rtol=rtol, atol=atol):
                raise AssertionError(
                    f"small cascade ids differ beyond ties, route {p}: "
                    f"{gi[row]} vs {ci[row]}")
            swaps += 1
    return swaps


if __name__ == "__main__":
    sys.exit(main())
