"""Per-stage retrieval latency probe (observability tool) — port of
``hybrid_rag_colbertv2_tpu/tools/stage_probe.py``.

Times each stage of the hybrid cascade in isolation and end-to-end, brute
vs pruned dense search, int8 and int4, on ``--device`` (default the
card). The brute stages are the full scans, each the layout's CUDA kernel
on the card. The JSON lines carry the JAX probe's stage names, so the two
probes read side by side; times are utils/timing.py's (CUDA events on the
card, the host clock on the CPU).

Usage:
  python -m hybrid_rag_colbertv2_tpu_torch.tools.stage_probe \
      [--n-docs 100000] [--doc-len 128] [--batch 8] [--prefilter 1024] \
      [--iters 20] [--skip-brute] [--profile DIR] [--device cuda]
  ... --flagship       # the jina-colbert-v2 width, seeded random weights
  ... --encode-docs N  # also corpus-encoding throughput over N docs

Prints one JSON object per measurement line to stdout.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.timing import measure_rtt_ms, queued_timeit as _timeit


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _mem_mb(dev):
    if dev.type != "cuda":
        return None
    return round(torch.cuda.memory_allocated(dev) / 2**20)


def probe_flagship(args, dev) -> int:
    """The full jina-colbert-v2 geometry (24L/1024H, ~558M params) with
    seeded random weights: query-encode latency, corpus-encode throughput
    and device memory."""
    from ..models.colbert import ColBERTConfig, ColBERTModel
    from ..utils.device import set_fp32_matmul_exact

    set_fp32_matmul_exact()
    cfg = ColBERTConfig.jina_colbert_v2(
        dtype=getattr(torch, args.encoder_dtype))
    log(f"flagship: {cfg.num_layers}L H={cfg.hidden_size} vocab="
        f"{cfg.vocab_size} act-dtype={args.encoder_dtype} device={dev}")
    t0 = time.perf_counter()
    with torch.device(dev):
        model = ColBERTModel(cfg)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    log(f"init: {time.perf_counter() - t0:.1f}s  params="
        f"{n_params / 1e6:.0f}M ({param_bytes / 2**30:.2f} GiB)")
    g = torch.Generator(device=dev).manual_seed(0)

    def apply(ids, mask):
        with torch.inference_mode():
            return model(ids, mask)

    # query path: (batch, 32) with all-live masks (ColBERT augmentation)
    qids = torch.randint(4, cfg.vocab_size, (args.batch,
                                             cfg.query_max_tokens),
                         generator=g, device=dev)
    qmask = torch.ones_like(qids)
    p50, p90 = _timeit(lambda: apply(qids, qmask), args.iters)
    print(json.dumps({
        "stage": "flagship_encode_query", "p50_ms": round(p50, 2),
        "p90_ms": round(p90, 2), "batch": args.batch,
        "params_m": round(n_params / 1e6), "dtype": args.encoder_dtype,
        "backend": dev.type, "hbm_mb": _mem_mb(dev)}), flush=True)

    # doc path: (doc_batch, doc_len); throughput = docs/s
    dlen = args.doc_len if args.doc_len is not None else cfg.doc_max_tokens
    dbatch = args.flagship_doc_batch
    dids = torch.randint(4, cfg.vocab_size, (dbatch, dlen), generator=g,
                         device=dev)
    dmask = torch.ones_like(dids)
    p50, p90 = _timeit(lambda: apply(dids, dmask), max(2, args.iters // 4))
    toks = dbatch * dlen
    flops = 2.0 * n_params * toks  # dense-matmul estimate (excl. attention)
    print(json.dumps({
        "stage": "flagship_encode_docs", "p50_ms": round(p50, 2),
        "p90_ms": round(p90, 2), "doc_batch": dbatch, "doc_len": dlen,
        "docs_per_sec": round(dbatch / (p50 / 1e3), 1),
        "tokens_per_sec": round(toks / (p50 / 1e3)),
        "approx_tflops": round(flops / (p50 / 1e3) / 1e12, 1),
        "dtype": args.encoder_dtype, "backend": dev.type,
        "hbm_mb": _mem_mb(dev)}), flush=True)
    return 0


def gen_index(n_pad, doc_len, dim, lengths, want_int8, dev, seed=0):
    """Random index bytes on ``dev``: int8 rows (n_pad * L, D), or, for
    int4 alone, the nibble-packed pair-rows (n_pad * L/2, D) directly (for
    a latency probe only the byte layout matters; any int8 array is a
    valid packed-nibble array), and per-row scales zero past each doc's
    length. -> (rows, scales)"""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = n_pad * doc_len if want_int8 else n_pad * doc_len // 2
    q8 = torch.randint(-127, 128, (rows, dim), generator=g, device=dev,
                       dtype=torch.int8)
    sc = (0.9 + 0.2 * torch.rand((n_pad * doc_len,), generator=g,
                                 device=dev)) / (127.0 * math.sqrt(dim))
    tok = torch.arange(doc_len, device=dev)
    valid = (tok[None, :] < lengths[:, None]).reshape(-1)
    return q8, torch.where(valid, sc, 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flagship", action="store_true",
                    help="measure the full 560M jina-colbert-v2 geometry "
                         "(random weights) instead of the cascade probe")
    ap.add_argument("--flagship-doc-batch", type=int, default=32)
    ap.add_argument("--n-docs", type=int, default=None,
                    help="default 100000 on the card, 2000 on the CPU")
    ap.add_argument("--doc-len", type=int, default=None,
                    help="tokens per doc (default: 128 for the cascade "
                         "probe, the preset's doc_max_tokens for "
                         "--flagship)")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prefilter", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--skip-brute", action="store_true")
    ap.add_argument("--index-dtype", choices=["both", "int8", "int4"],
                    default="both",
                    help="which token-embedding layout(s) to generate and "
                         "probe. 'both' holds the int8 index AND a packed "
                         "int4 view of its first half at once")
    ap.add_argument("--postings-cap", type=int, default=512)
    ap.add_argument("--q-max", type=int, default=32,
                    help="BM25 query term slots (kernel cost ~ B*Q*P)")
    ap.add_argument("--encode-docs", type=int, default=0, metavar="N",
                    help="ALSO measure corpus-encoding throughput over N "
                         "docs (the indexing hot loop)")
    ap.add_argument("--encoder-dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="also write a torch.profiler trace of one cascade "
                         "batch to DIR (utils/profiling.py)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.flagship:
        return probe_flagship(args, dev)

    from ..index.lexical import LexicalIndex
    from ..models.colbert import ColBERTConfig, ColBERTEncoder
    from ..models.tokenizer import ColBERTTokenizer
    from ..ops.bm25 import bm25_scores_device, bm25_topk_device
    from ..ops.fusion import rrf_from_topk
    from ..ops.maxsim import (maxsim_scores_int4_doc, maxsim_scores_int8,
                              maxsim_scores_int8_doc)
    from ..ops.prefilter import (exact_maxsim_on_candidates,
                                 maxsim_topk_pruned, pooled_doc_embeddings,
                                 pooled_proxy_topk)
    from ..ops.quant import int4_group_size
    from ..ops.topk import top_k
    from ..retrieval.cascade import hybrid_cascade

    backend = dev.type
    n_docs = args.n_docs or (100_000 if backend == "cuda" else 2_000)
    doc_len = args.doc_len if args.doc_len is not None else 128
    dim, batch = args.dim, args.batch
    log(f"device={dev} n_docs={n_docs} doc_len={doc_len} batch={batch}")

    rng = np.random.default_rng(0)
    vocab = np.array([f"term{i}" for i in range(5_000)])
    corpus = [" ".join(r) for r in vocab[
        rng.integers(0, len(vocab), size=(min(n_docs, 20_000), 12))]]
    full_corpus = (corpus * max(1, n_docs // len(corpus) + 1)
                   if len(corpus) < n_docs else corpus)[:n_docs]
    t0 = time.perf_counter()
    lex = LexicalIndex.build(full_corpus, postings_cap=args.postings_cap)
    log(f"bm25 build: {time.perf_counter() - t0:.1f}s "
        f"max_post={lex.max_postings}")

    n_pad = ((n_docs + 127) // 128) * 128
    lengths = np.zeros((n_pad,), np.int32)
    lengths[:n_docs] = rng.integers(doc_len // 2, doc_len + 1, n_docs)
    lens_dev = torch.as_tensor(lengths, device=dev)

    want_int8 = args.index_dtype in ("both", "int8")
    want_int4 = args.index_dtype in ("both", "int4")
    t0 = time.perf_counter()
    base, scales = gen_index(n_pad, doc_len, dim, lens_dev, want_int8, dev)
    q8 = base if want_int8 else None
    if want_int4:
        # packed pair-row view: the int8 index's first half of ROWS when
        # both layouts are probed together (a view, no copy)
        q4 = base[: n_pad * doc_len // 2] if want_int8 else base
        gsz = int4_group_size(doc_len)
        # per-token-GROUP scales, (G, n_pad) doc-axis-minor layout
        dscales4 = scales.reshape(n_pad, doc_len // gsz, gsz).amax(
            dim=2).T.contiguous()
    if want_int8:
        pooled = pooled_doc_embeddings(q8, scales, lens_dev, doc_len=doc_len)
    else:
        pooled = pooled_doc_embeddings(q4, None, lens_dev, doc_len=doc_len,
                                       doc_scales=dscales4, packed_int4=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"index gen+pool: {time.perf_counter() - t0:.1f}s "
        f"({base.numel() / 2**30:.2f} GiB {args.index_dtype}, pooled "
        f"{pooled.numel() * 2 / 2**20:.0f} MiB)")

    tok = ColBERTTokenizer.train_bpe(corpus[:2000], vocab_size=8192)
    encoder = ColBERTEncoder(
        ColBERTConfig.small(vocab_size=tok.vocab_size,
                            dtype=getattr(torch, args.encoder_dtype)),
        tok, seed=0, device=dev)

    if args.encode_docs:
        # corpus-encoding throughput (the indexing hot loop; reference:
        # 12.87 s for 287 chunks, README.md:160)
        texts = (full_corpus * (args.encode_docs // len(full_corpus) + 1)
                 )[: args.encode_docs]
        encoder.encode_docs(texts, doc_len=doc_len)      # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, lens = encoder.encode_docs(texts, doc_len=doc_len)
        lens.cpu()                                       # force completion
        dt = time.perf_counter() - t0
        print(json.dumps({
            "stage": f"encode_docs_{args.encoder_dtype}",
            "docs": args.encode_docs, "seconds": round(dt, 2),
            "docs_per_sec": round(args.encode_docs / dt, 1),
            "backend": backend}), flush=True)
    queries = [" ".join(rng.choice(vocab, size=6)) for _ in range(batch)]
    q_emb = encoder.encode_queries(queries)
    q_terms = torch.as_tensor(np.stack(
        [lex.encode_query(q, args.q_max) for q in queries]), device=dev)
    lexd = tuple(torch.as_tensor(a, device=dev)
                 for a in (lex.indptr, lex.post_docs, lex.post_weights))

    results = []

    def emit(name, p50, p90):
        row = {"stage": name, "p50_ms": round(p50, 3),
               "p90_ms": round(p90, 3), "batch": batch, "n_docs": n_docs,
               "backend": backend}
        results.append(row)
        print(json.dumps(row), flush=True)

    # --- isolated stages ---------------------------------------------------
    log(f"host-device rtt: {measure_rtt_ms():.3f}ms")
    emit("encode_query", *_timeit(
        lambda: encoder.encode_queries(queries), args.iters))
    emit("bm25", *_timeit(
        lambda: bm25_scores_device(
            q_terms, *lexd, n_docs=n_docs, max_postings=lex.max_postings),
        args.iters))
    # the scorer the cascade uses (sort-based top-k); the dense-scatter
    # scorer above is the comparison baseline
    emit("bm25_topk", *_timeit(
        lambda: bm25_topk_device(
            q_terms, *lexd, n_docs=n_docs, max_postings=lex.max_postings,
            k=100)[0],
        args.iters))

    if not args.skip_brute:
        if want_int8:
            emit("dense_scan_brute_int8", *_timeit(
                lambda: maxsim_scores_int8(
                    q_emb, q8, scales, lens_dev, doc_len=doc_len),
                args.iters))
            # per-document-scale layout ("int8-doc"): same embedding
            # bytes, (N,) scales; the dup-row contract doesn't change cost
            dscales = scales.reshape(n_pad, doc_len).amax(dim=1)
            emit("dense_scan_brute_int8doc", *_timeit(
                lambda: maxsim_scores_int8_doc(
                    q_emb, q8, dscales, lens_dev, doc_len=doc_len),
                args.iters))
        if want_int4:
            # nibble-packed "int4-doc" layout: HALF the embedding bytes
            emit("dense_scan_brute_int4doc", *_timeit(
                lambda: maxsim_scores_int4_doc(
                    q_emb, q4, dscales4, lens_dev, doc_len=doc_len),
                args.iters))
    # pruned two-stage top-k — the served path, per requested layout
    if want_int8:
        emit(f"dense_pruned_C{args.prefilter}", *_timeit(
            lambda: maxsim_topk_pruned(
                q_emb, q8, scales, lens_dev, pooled, doc_len=doc_len,
                n_docs=n_docs, n_candidates=args.prefilter, k=100)[0],
            args.iters))
    if want_int4:
        emit(f"dense_pruned_int4_C{args.prefilter}", *_timeit(
            lambda: maxsim_topk_pruned(
                q_emb, q4, None, lens_dev, pooled, doc_scales=dscales4,
                doc_len=doc_len, n_docs=n_docs,
                n_candidates=args.prefilter, k=100)[0],
            args.iters))

    # pruned-path sub-stages + final-rerank geometry, isolated so batch
    # scaling can be attributed stage by stage: stage A amortizes across
    # the batch (matmul over N), stage B and the rerank gather are
    # O(batch) with no cross-query reuse
    c_pad = min(((args.prefilter + 127) // 128) * 128, n_pad)
    emit(f"pruned_A_proxy_topk_C{args.prefilter}", *_timeit(
        lambda: pooled_proxy_topk(q_emb, pooled, lens_dev, n_docs=n_docs,
                                  c=c_pad),
        args.iters))
    cand = pooled_proxy_topk(q_emb, pooled, lens_dev, n_docs=n_docs,
                             c=c_pad)
    if want_int8:
        emit(f"pruned_B_exact_C{args.prefilter}", *_timeit(
            lambda: exact_maxsim_on_candidates(
                q_emb, q8, scales, lens_dev, cand, doc_len=doc_len),
            args.iters))
    if want_int4:
        # stage B on the packed int4 layout: the stage is gather-bound,
        # so halving the gathered bytes is the one lever that moves it
        emit(f"pruned_B_exact_int4_C{args.prefilter}", *_timeit(
            lambda: exact_maxsim_on_candidates(
                q_emb, q4, None, lens_dev, cand, doc_scales=dscales4,
                doc_len=doc_len),
            args.iters))
    if want_int8:
        emit("rerank_exact_64cand", *_timeit(
            lambda: exact_maxsim_on_candidates(
                q_emb, q8, scales, lens_dev, cand[:, :64], doc_len=doc_len),
            args.iters))
    if want_int4:
        emit("rerank_exact_int4_64cand", *_timeit(
            lambda: exact_maxsim_on_candidates(
                q_emb, q4, None, lens_dev, cand[:, :64],
                doc_scales=dscales4, doc_len=doc_len),
            args.iters))

    # --- isolated suspects: top-k over N and RRF fusion ---------------------
    g = torch.Generator(device=dev).manual_seed(2)
    fake_scores = torch.randn((batch, n_docs), generator=g, device=dev)
    emit("topk100_over_N", *_timeit(lambda: top_k(fake_scores, 100)[0],
                                    args.iters))
    ids_a = torch.randint(0, n_docs, (batch, 100), generator=g, device=dev,
                          dtype=torch.int32)
    ids_b = torch.randint(0, n_docs, (batch, 100), generator=g, device=dev,
                          dtype=torch.int32)
    emit("rrf_fuse", *_timeit(
        lambda: rrf_from_topk(ids_a, ids_b, k=50)[0], args.iters))

    # --- end-to-end cascade, per requested layout ---------------------------
    def run_cascade(prefilter, int4):
        if int4:
            ids, _, _ = hybrid_cascade(
                q_emb, q_terms, *lexd, q4, None, lens_dev,
                pooled if prefilter else None, dscales4,
                prefilter=prefilter, n_docs=n_docs,
                max_postings=lex.max_postings, doc_len=doc_len,
                is_int8=False, k_each=100, k_fuse=50, k_final=10)
        else:
            ids, _, _ = hybrid_cascade(
                q_emb, q_terms, *lexd, q8, scales, lens_dev,
                pooled if prefilter else None, prefilter=prefilter,
                n_docs=n_docs, max_postings=lex.max_postings,
                doc_len=doc_len, is_int8=True,
                k_each=100, k_fuse=50, k_final=10)
        return ids

    for int4, tag in ((False, ""), (True, "_int4")):
        if (int4 and not want_int4) or (not int4 and not want_int8):
            continue
        if not args.skip_brute:
            emit(f"cascade_brute{tag}", *_timeit(
                lambda: run_cascade(0, int4), args.iters))
        emit(f"cascade_pruned{tag}_C{args.prefilter}", *_timeit(
            lambda: run_cascade(args.prefilter, int4), args.iters))

    if args.profile:
        from ..utils import profiling

        with profiling.trace(args.profile):
            run_cascade(args.prefilter, not want_int8)
        log(f"profiler trace written to {args.profile}")

    log("summary: " + ", ".join(
        f"{r['stage']}={r['p50_ms']}ms" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
