"""Retrieval benchmark of the port — port of the repository's ``bench.py``.
Prints ONE JSON line, LAST on stdout; every log line goes to stderr.

    python -m hybrid_rag_colbertv2_tpu_torch.bench [--device cuda|cpu]

The passes, in ``bench.py``'s order and with its result keys:

  * headline         — p50 of one batch of 8 queries through the fused
                       encoder + hybrid cascade (BM25 -> pruned MaxSim ->
                       RRF -> exact rerank -> top-10) over a 100k-chunk
                       x 128-token int8 index (``metric``, ``value``,
                       ``unit``, ``vs_baseline``);
  * recall           — the pruned cascade's recall@10 against exact fp32
                       MaxSim over 8,192 docs, int8 and int4-doc;
  * 1M               — the fused p50 over 1M chunks x 64 tokens, int8
                       then int4-doc, and the throughput of the full int4
                       scan (the ``maxsim_int4_group`` kernel) and of the
                       query encoder;
  * 2M-int4          — the fused p50 over 2M chunks x 64 tokens int4-doc;
  * realdata         — quality through the app on the sample corpus, 3
                       training seeds;
  * pretrained       — the same with a local checkpoint (HRAG_CHECKPOINT);
  * organic          — quality on the repository's own documentation.

The card gets the full sizes; ``--device cpu`` gets ``bench.py``'s
off-TPU sizes (2,000 / 1,024 / 10,000 docs, 8 training steps, 1 seed) and
skips the 2M pass.

Timing: a fused call (``FusedCascade``) packs the batch on the host,
replays a CUDA graph and copies the ids and scores back to numpy, so it
is timed by the host clock around the whole call: ``N_FUSED_CALLS``
calls after the capture (``N_FUSED_CALLS_CPU`` on the CPU), p50
reported, 0 captures allowed among them.
The scan and the encoder return device tensors and are timed by CUDA
events (utils/timing.py).

A pass that raises is logged with its traceback and the others still
run; the JSON line is printed last all the same, and the process exits 1.

Env switches (each pass is also watchdogged): HRAG_BENCH_RECALL=0 |
HRAG_BENCH_1M=0 | HRAG_BENCH_2M=0 | HRAG_BENCH_REALDATA=0 |
HRAG_BENCH_PRETRAINED=0 | HRAG_BENCH_ORGANIC=0
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import math
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .utils.device import resolve_device

BASELINE_MS = 321.0     # reference total retrieval (README.md:182)
CACHE_VERSION = 5       # bench.py's, so the key follows its training
# marks the port's trained-encoder cache, so it never reads the JAX
# bench's entries
CACHE_MARK = "torch"
REPO = Path(__file__).resolve().parents[1]
N_TOPICS, TOPIC_NOISE = 512, 0.35
# timed fused calls on the card; the CPU's eager cascade takes ~0.3 s a
# call at its sizes, so it times a few
N_FUSED_CALLS = 40
N_FUSED_CALLS_CPU = 4
EXACT_CHUNK = 128       # docs per exact fp32 MaxSim block (recall pass)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class _watchdog:
    """SIGALRM-scoped pass: a stuck pass must not eat the whole bench.
    Signals are the main thread's alone; elsewhere the pass runs
    unguarded."""

    def __init__(self, seconds):
        self.seconds = seconds
        self.armed = False

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGALRM, self._raise)
            signal.alarm(self.seconds)
            self.armed = True

    @staticmethod
    def _raise(signum, frame):
        raise TimeoutError("pass watchdog")

    def __exit__(self, *exc):
        if self.armed:
            signal.alarm(0)
        return False


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def unit_topics(n_topics: int, dim: int, device, seed: int = 42
                ) -> torch.Tensor:
    """(n_topics, dim) unit-norm topic centres, normal from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn((n_topics, dim), generator=g, device=device)
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def topic_rows(topics: torch.Tensor, assign: torch.Tensor,
               lengths: torch.Tensor, doc_len: int, g: torch.Generator,
               noise: float = TOPIC_NOISE) -> torch.Tensor:
    """One block of fp32 token rows (n, L, D): doc i's rows are topic
    ``assign[i]`` + ``noise`` x normal (from ``g``), L2-normalized, and
    zero past ``lengths[i]`` (``bench.py::_make_topic_gen``'s recipe)."""
    dev = topics.device
    x = topics[assign][:, None, :] + noise * torch.randn(
        (assign.shape[0], doc_len, topics.shape[1]), generator=g,
        device=dev)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    tok = torch.arange(doc_len, device=dev)
    return x * (tok[None, :] < lengths[:, None])[..., None]


def topic_index(topics: torch.Tensor, lengths: torch.Tensor, doc_len: int,
                seed: int, block: int = 1024):
    """Topic-clustered unit-norm int8 token rows on the topics' device:
    each doc draws a topic, its rows come from ``topic_rows`` in blocks of
    ``block`` docs (so no multi-GB fp32 tensor exists) and are quantized
    per row (``ops/quant.quantize_int8_rows``: the absmax / 127 scale,
    zero rows scale 0). Clustered rows, as an encoder's are, give the
    pooled prefilter's recall a meaning.
    -> (rows (N_pad * L, D) int8, scales (N_pad * L,) f32)"""
    from .ops.quant import quantize_int8_rows

    dev = topics.device
    n_pad, dim = lengths.shape[0], topics.shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    assign = torch.randint(0, topics.shape[0], (n_pad,), generator=g,
                           device=dev)
    rows = torch.empty((n_pad * doc_len, dim), dtype=torch.int8, device=dev)
    scales = torch.empty((n_pad * doc_len,), dtype=torch.float32,
                         device=dev)
    for s in range(0, n_pad, block):
        e = min(s + block, n_pad)
        x = topic_rows(topics, assign[s:e], lengths[s:e], doc_len, g)
        rows[s * doc_len:e * doc_len], scales[s * doc_len:e * doc_len] = \
            quantize_int8_rows(x.reshape(-1, dim))
    return rows, scales


def _lex_csr(lex, dev):
    return {name: torch.as_tensor(getattr(lex, name), device=dev)
            for name in ("indptr", "post_docs", "post_weights")}


def time_fused(run_once, label, calls):
    """Host-clock ms of ``calls`` calls of ``run_once`` (pack + replay +
    copy-out) after one first call that captures the graph.
    -> (p50, worst). Raises if a timed call captured."""
    from .retrieval.cascade import FusedCascade

    t0 = time.perf_counter()
    run_once()
    log(f"{label} capture+first run: {time.perf_counter() - t0:.1f}s")
    caps = FusedCascade.captures
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        run_once()
        ts.append((time.perf_counter() - t0) * 1e3)
    if FusedCascade.captures != caps:
        raise RuntimeError(f"{label}: {FusedCascade.captures - caps} "
                           "captures during the timed calls")
    return max(float(np.median(ts)), 1e-3), float(np.max(ts))


def _release(*tensors):
    """Drop the fused-cascade entries that read ``tensors`` (each holds
    the tensors and its graphs' memory pool)."""
    from .retrieval.cascade import _FUSED_CACHE

    ids = {id(t) for t in tensors if t is not None}
    _FUSED_CACHE.drop_where(lambda _k, e: e.reads_any(ids))


def run_headline(result, dev):
    """100k-chunk fused-cascade p50 -> metric/value/unit/vs_baseline.
    Returns the context the later passes read."""
    from .index.dense import DenseTokenIndex
    from .index.lexical import LexicalIndex
    from .models.colbert import ColBERTConfig, ColBERTEncoder
    from .models.tokenizer import ColBERTTokenizer
    from .ops.prefilter import pooled_doc_embeddings

    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    n_docs = 100_000 if cuda else 2_000
    doc_len, dim, batch = 128, 128, 8
    prefilter, postings_cap = 1024, 512
    log(f"device={dev} ({name}) n_docs={n_docs}")

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    vocab = np.array([f"term{i}" for i in range(5_000)])
    word_idx = rng.integers(0, len(vocab), size=(n_docs, 12))
    corpus = [" ".join(row) for row in vocab[word_idx]]
    log(f"corpus gen: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    lex = LexicalIndex.build(corpus, postings_cap=postings_cap)
    log(f"bm25 build: {time.perf_counter() - t0:.1f}s "
        f"({lex.memory_bytes() / 2**20:.0f} MB, max_post={lex.max_postings})")

    # the int8 index generated on the device in doc blocks; values do not
    # change the work timed, and the build path is the tests' and the app's
    t0 = time.perf_counter()
    n_pad = ((n_docs + 127) // 128) * 128
    lengths = rng.integers(doc_len // 2, doc_len + 1, n_docs).astype(np.int32)
    lengths_pad = np.zeros((n_pad,), np.int32)
    lengths_pad[:n_docs] = lengths
    topics = unit_topics(N_TOPICS, dim, dev)
    lens_dev = torch.as_tensor(lengths_pad, device=dev)
    q8, scales = topic_index(topics, lens_dev, doc_len, seed=0)
    pooled = pooled_doc_embeddings(q8, scales, lens_dev, doc_len=doc_len)
    dense = DenseTokenIndex(
        emb_flat=q8, doc_lengths=lens_dev, n_docs=n_docs,
        doc_len=doc_len, dim=dim, scales=scales, pooled=pooled)
    _sync(dev)
    log(f"dense index gen(int8)+pool: {time.perf_counter() - t0:.1f}s "
        f"({dense.memory_bytes() / 2**30:.2f} GiB)")

    # query encoder (small preset, random weights: the latency is what
    # is measured)
    tok = ColBERTTokenizer.train_bpe(corpus[:2000], vocab_size=8192)
    enc_cfg = ColBERTConfig.small(vocab_size=tok.vocab_size)
    encoder = ColBERTEncoder(enc_cfg, tok, seed=0, device=dev)

    calls = N_FUSED_CALLS if cuda else N_FUSED_CALLS_CPU
    ctx = dict(device=dev, cuda=cuda, calls=calls, doc_len=doc_len,
               dim=dim, batch=batch, prefilter=prefilter,
               postings_cap=postings_cap, vocab=vocab, rng=rng,
               topics=topics, big=dense, encoder=encoder, corpus=corpus)
    fix = dict(n_docs=n_docs, doc_len=doc_len, lex=lex,
               lex_dev=_lex_csr(lex, dev), lens_dev=lens_dev,
               queries=[" ".join(rng.choice(vocab, size=6))
                        for _ in range(batch)])
    result["metric"] = (
        f"hybrid retrieval p50 latency (host clock around pack + graph "
        f"replay + copy-out, {calls} calls), batch={batch} queries, "
        f"{n_docs} chunks, int8 index, prefilter={prefilter} ({name})")
    p50 = _measure_fused(result, ctx, fix, q8, scales, None, pooled,
                         prefilter=prefilter, is_int8=True,
                         result_key="value", label="headline")
    result["unit"] = "ms"
    result["vs_baseline"] = round(BASELINE_MS / (p50 / batch), 1)
    return ctx


def _hits(cascade_ids, e_top):
    """Mean share of each query's exact top-10 in its cascade top-10."""
    hits = (cascade_ids[:, :, None] == e_top[:, None, :]).any(-1)
    hits = hits & (cascade_ids >= 0)
    return float(torch.mean(hits.sum(dim=1) / 10.0))


def recall_int8(q, q_terms, indptr, post_docs, post_weights, emb_flat,
                scales, lengths, pooled, *, max_postings, doc_len,
                prefilter):
    """recall@10 of the pruned int8 cascade against exact fp32 MaxSim on
    the dequantized rows (in chunks of ``EXACT_CHUNK`` docs).
    -> (recall, the exact top-10 ids (B, 10))"""
    from .ops.maxsim import maxsim_scores_exact
    from .ops.topk import top_k
    from .retrieval.cascade import hybrid_cascade

    n, dim = lengths.shape[0], emb_flat.shape[1]
    with torch.inference_mode():
        cascade_ids, _, _ = hybrid_cascade(
            q, q_terms, indptr, post_docs, post_weights, emb_flat, scales,
            lengths, pooled, prefilter=prefilter, n_docs=n,
            max_postings=max_postings, doc_len=doc_len, is_int8=True,
            k_each=100, k_fuse=50, k_final=10)
        docs = emb_flat.reshape(n, doc_len, dim)
        rows = scales.reshape(n, doc_len, 1)
        c = EXACT_CHUNK
        exact = torch.cat([
            maxsim_scores_exact(
                q, docs[s:s + c].to(torch.float32) * rows[s:s + c],
                lengths[s:s + c])
            for s in range(0, n, c)], dim=1)
        _, e_top = top_k(exact, 10)
        return _hits(cascade_ids, e_top), e_top


def recall_int4(q, q_terms, indptr, post_docs, post_weights, emb_flat,
                scales, lengths, e_top, *, max_postings, doc_len,
                prefilter):
    """recall@10 of the pruned cascade over the int4-doc requantization
    of the same int8 rows (``quantize_int4_groups``) against the int8
    pass's exact top-10 ``e_top``."""
    from .ops.prefilter import pooled_doc_embeddings
    from .ops.quant import quantize_int4_groups
    from .retrieval.cascade import hybrid_cascade

    n, dim = lengths.shape[0], emb_flat.shape[1]
    with torch.inference_mode():
        embs3 = (emb_flat.to(torch.float32) * scales[:, None]).reshape(
            n, doc_len, dim)
        packed, dsc = quantize_int4_groups(embs3, lengths)
        pooled4 = pooled_doc_embeddings(packed, None, lengths,
                                        doc_len=doc_len, doc_scales=dsc,
                                        packed_int4=True)
        cascade_ids, _, _ = hybrid_cascade(
            q, q_terms, indptr, post_docs, post_weights, packed, None,
            lengths, pooled4, dsc, prefilter=prefilter, n_docs=n,
            max_postings=max_postings, doc_len=doc_len, is_int8=False,
            k_each=100, k_fuse=50, k_final=10)
        return _hits(cascade_ids, e_top)


def run_recall(result, ctx):
    """recall@10 of the full pruned cascade vs exact fp32 MaxSim on a
    sub-index, int8 and int4-doc against the same truth."""
    from .index.lexical import LexicalIndex
    from .ops.prefilter import pooled_doc_embeddings

    dev, doc_len, dim = ctx["device"], ctx["doc_len"], ctx["dim"]
    batch, prefilter = ctx["batch"], ctx["prefilter"]
    rng, vocab, topics = ctx["rng"], ctx["vocab"], ctx["topics"]

    nr = 8192 if ctx["cuda"] else 1024
    lens_r = rng.integers(doc_len // 2, doc_len + 1, nr).astype(np.int32)
    lens_r_dev = torch.as_tensor(lens_r, device=dev)
    q8r, scr = topic_index(topics, lens_r_dev, doc_len, seed=7)
    pooled_r = pooled_doc_embeddings(q8r, scr, lens_r_dev, doc_len=doc_len)
    # the BM25 arm over the SAME nr-doc sub-corpus (the 100k index would
    # mask the candidates past nr and leave the cascade dense-only)
    lex_r = LexicalIndex.build(ctx["corpus"][:nr],
                               postings_cap=ctx["postings_cap"])
    lex_r_dev = _lex_csr(lex_r, dev)
    qt_r = torch.as_tensor(np.stack([
        lex_r.encode_query(" ".join(rng.choice(vocab, size=6)), 32)
        for _ in range(batch)]), device=dev)
    # topic-aligned queries (what a trained encoder produces)
    g = torch.Generator(device=dev).manual_seed(3)
    qa = torch.randint(0, topics.shape[0], (batch,), generator=g,
                       device=dev)
    qe_r = topics[qa][:, None, :] + 0.3 * torch.randn(
        (batch, 32, dim), generator=g, device=dev)
    qe_r = qe_r / torch.linalg.vector_norm(qe_r, dim=-1, keepdim=True)
    kw = dict(max_postings=lex_r.max_postings, doc_len=doc_len,
              prefilter=prefilter)
    r, e_top = recall_int8(qe_r, qt_r, *lex_r_dev.values(), q8r, scr,
                           lens_r_dev, pooled_r, **kw)
    log(f"recall@10 vs exact fp32 MaxSim (pruned int8 cascade, {nr} "
        f"docs): {r:.3f}")
    result["recall10_vs_exact"] = round(r, 3)
    r4 = recall_int4(qe_r, qt_r, *lex_r_dev.values(), q8r, scr, lens_r_dev,
                     e_top, **kw)
    log(f"recall@10 vs exact fp32 MaxSim (pruned int4-doc cascade, "
        f"{nr} docs): {r4:.3f}")
    result["recall10_vs_exact_int4"] = round(r4, 3)


def _scale_fixture(ctx, n_docs, doc_len, tag):
    """Shared set-up of the large fused passes: the headline's base corpus
    tiled up -> lexical index -> device CSR + lengths + a query batch."""
    from .index.lexical import LexicalIndex

    dev, rng, vocab = ctx["device"], ctx["rng"], ctx["vocab"]
    t0 = time.perf_counter()
    base = ctx["corpus"][:20_000]
    full_corpus = (base * (n_docs // len(base) + 1))[:n_docs]
    lex = LexicalIndex.build(full_corpus, postings_cap=ctx["postings_cap"])
    log(f"{tag} bm25 build: {time.perf_counter() - t0:.1f}s "
        f"max_post={lex.max_postings}")
    n_pad = ((n_docs + 127) // 128) * 128
    lengths = np.zeros((n_pad,), np.int32)
    lengths[:n_docs] = rng.integers(doc_len // 2, doc_len + 1, n_docs)
    return dict(
        n_docs=n_docs, doc_len=doc_len, n_pad=n_pad, lex=lex,
        lex_dev=_lex_csr(lex, dev),
        lens_dev=torch.as_tensor(lengths, device=dev),
        queries=[" ".join(rng.choice(vocab, size=6))
                 for _ in range(ctx["batch"])],
    )


def _measure_fused(result, ctx, fix, emb, scales, dsc, pooled, *,
                   prefilter, is_int8, result_key, label):
    """Capture and time ONE fused encoder + cascade (the memoized entry
    the retrievers serve, ``fused_cascade_fn``: one graph replay per
    batch) over the fixture's corpus, the batch packed on the host at
    RAGConfig's term width and buckets; records the p50 under
    ``result_key``."""
    from .config import RAGConfig
    from .retrieval.cascade import fused_cascade_fn, pack_query_batch

    encoder, batch, lex = ctx["encoder"], ctx["batch"], fix["lex"]
    fused = fused_cascade_fn(
        encoder.model, encoder.cfg.query_max_tokens,
        dict(prefilter=prefilter, n_docs=fix["n_docs"],
             max_postings=lex.max_postings, doc_len=fix["doc_len"],
             is_int8=is_int8, k_each=100, k_fuse=50, k_final=10),
        dict(fix["lex_dev"], emb_flat=emb, scales=scales,
             doc_lengths=fix["lens_dev"], pooled=pooled, doc_scales=dsc))

    def run_once():
        packed = pack_query_batch(encoder, lex, fix["queries"],
                                  RAGConfig.query_max_terms,
                                  RAGConfig.query_term_buckets)
        return fused(packed)

    p50, worst = time_fused(run_once, label, ctx["calls"])
    log(f"{label} fused cascade: p50={p50:.2f}ms worst={worst:.2f}ms "
        f"batch={batch} ({p50 / batch:.2f} ms/query)")
    result[result_key] = round(p50, 3)
    return p50


def _gen_packed_int4(fix, dim, dev, seed=1):
    """Random nibble-packed pair-rows (n_pad * L/2, D) and per-token-group
    scales in the (G, n_pad) doc-axis-minor layout
    (ops/quant.quantize_int4_groups), 0 for padding docs."""
    from .ops.quant import int4_group_size

    n_pad, doc_len = fix["n_pad"], fix["doc_len"]
    ng = doc_len // int4_group_size(doc_len)
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(-127, 128, (n_pad * doc_len // 2, dim),
                           generator=g, device=dev, dtype=torch.int8)
    dsc = (0.9 + 0.2 * torch.rand((ng, n_pad), generator=g, device=dev)) / (
        7.0 * math.sqrt(dim))
    return packed, torch.where(fix["lens_dev"][None, :] > 0, dsc, 0.0)


def run_1m(result, ctx):
    """Fused-cascade p50 over 1M chunks x 64 tokens on one card, int8
    then int4-doc, then the throughput fields. Uniform-random index: the
    latency does not depend on the values."""
    from .ops.prefilter import pooled_doc_embeddings
    from .tools.stage_probe import gen_index

    dev, dim, batch = ctx["device"], ctx["dim"], ctx["batch"]
    n_docs = 1_000_000 if ctx["cuda"] else 10_000
    doc_len, prefilter = 64, 2048
    fix = _scale_fixture(ctx, n_docs, doc_len, "1M")

    t0 = time.perf_counter()
    q8, scales = gen_index(fix["n_pad"], doc_len, dim, fix["lens_dev"], True,
                           dev)
    pooled = pooled_doc_embeddings(q8, scales, fix["lens_dev"],
                                   doc_len=doc_len)
    _sync(dev)
    log(f"1M index gen+pool: {time.perf_counter() - t0:.1f}s "
        f"({q8.numel() / 2**30:.2f} GiB int8)")
    p50 = _measure_fused(result, ctx, fix, q8, scales, None, pooled,
                         prefilter=prefilter, is_int8=True,
                         result_key="p50_ms_1m", label="1M")
    result["vs_baseline_1m"] = round(BASELINE_MS / (p50 / batch), 1)

    # int4-doc at the same scale, after the int8 index is freed; the
    # (N, D) bf16 proxies do not depend on the layout and are kept
    _release(q8, scales)
    del q8, scales
    if ctx["cuda"]:
        torch.cuda.empty_cache()
    q4, dsc = _gen_packed_int4(fix, dim, dev)
    p50_4 = _measure_fused(result, ctx, fix, q4, None, dsc, pooled,
                           prefilter=prefilter, is_int8=False,
                           result_key="p50_ms_1m_int4", label="1M int4")
    result["qps_chip_1m_int4"] = round(batch / (p50_4 / 1e3), 1)
    _throughput_fields(result, ctx, fix, q4, dsc)
    _release(q4, dsc, pooled)


def _encoder_graph(model, q_ids, mask):
    """The forward captured as one CUDA graph (the counterpart of JAX's
    jitted forward): -> a callable that replays it and returns its
    static output."""
    dev = q_ids.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), torch.inference_mode():
        model(q_ids, mask)                       # warm-up off the graph
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side), torch.inference_mode():
        out = model(q_ids, mask)
    torch.cuda.current_stream(dev).wait_stream(side)

    def replay():
        graph.replay()
        return out
    return replay


def _throughput_fields(result, ctx, fix, q4, dsc):
    """Two primitives that bracket the system: the full-corpus int4 MaxSim
    scan (the bandwidth-bound kernel the pruned cascade replaces) and the
    query-encoder forward (compute-bound)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .ops.maxsim import maxsim_scores_int4_doc
    from .retrieval.cascade import pack_query_batch
    from .utils.timing import queued_timeit

    encoder, batch = ctx["encoder"], ctx["batch"]
    doc_len, n_pad, dim = fix["doc_len"], fix["n_pad"], ctx["dim"]
    lq = encoder.cfg.query_max_tokens
    q_emb = encoder.encode_queries(fix["queries"])         # (B, Lq, D)

    def scan_once():
        return maxsim_scores_int4_doc(q_emb, q4, dsc, fix["lens_dev"],
                                      doc_len=doc_len)

    iters = 8 if ctx["cuda"] else 2
    p50s, _ = queued_timeit(scan_once, iters, 3)
    # the pair-row trick runs the same MACs as an unpacked scan:
    # 2 * B * N * L * D * Lq
    flops = 2.0 * batch * n_pad * doc_len * dim * lq
    gb = (q4.numel() + dsc.numel() * 4) / 1e9
    result["scan_p50_ms_1m_int4"] = round(p50s, 3)
    result["scan_tflops_1m_int4"] = round(flops / (p50s / 1e3) / 1e12, 1)
    result["scan_gbps_1m_int4"] = round(gb / (p50s / 1e3), 1)
    log(f"1M int4 full scan: p50={p50s:.2f}ms "
        f"{result['scan_tflops_1m_int4']} TFLOPS "
        f"{result['scan_gbps_1m_int4']} GB/s")

    model = encoder.model
    packed = pack_query_batch(encoder, fix["lex"], fix["queries"])
    q_ids = torch.as_tensor(packed[:, :lq], device=ctx["device"]).long()
    mask = torch.ones_like(q_ids)

    def eager_once():
        with torch.inference_mode():
            return model(q_ids, mask)

    # FlopCounterMode counts the matmuls and attention products only (no
    # elementwise, norm or softmax work), unlike XLA's cost analysis: the
    # TFLOPS below are not comparable with the JAX bench's
    with FlopCounterMode(display=False) as fc:
        eager_once()
    enc_flops = float(fc.get_total_flops())
    p50_eager, _ = queued_timeit(eager_once, iters, 3)
    # the captured forward, as JAX times its jitted one: eager dispatch
    # measures the host's launches
    enc_once = (_encoder_graph(model, q_ids, mask) if ctx["cuda"]
                else eager_once)
    p50e, _ = queued_timeit(enc_once, iters, 3)
    result["encoder_p50_ms_b8"] = round(p50e, 3)
    if enc_flops > 0:
        result["encoder_tflops"] = round(
            enc_flops / (p50e / 1e3) / 1e12, 1)
    log(f"encoder fwd (B={batch}): p50={p50e:.2f}ms (eager "
        f"{p50_eager:.2f}ms) ~{result.get('encoder_tflops', 'n/a')} TFLOPS "
        f"(matmul flops={enc_flops:.3g})")


def run_2m_int4(result, ctx):
    """Fused-cascade p50 over 2M chunks x 64 tokens on one card — the
    capacity the nibble-packed int4-doc layout exists for."""
    from .ops.prefilter import pooled_doc_embeddings

    if not ctx["cuda"]:
        log("2M pass: CPU device — skipping (card-scale capacity demo)")
        return
    dev, dim, batch = ctx["device"], ctx["dim"], ctx["batch"]
    fix = _scale_fixture(ctx, 2_000_000, 64, "2M")

    t0 = time.perf_counter()
    q4, dsc = _gen_packed_int4(fix, dim, dev)
    pooled = pooled_doc_embeddings(q4, None, fix["lens_dev"], doc_len=64,
                                   doc_scales=dsc, packed_int4=True)
    _sync(dev)
    log(f"2M index gen+pool: {time.perf_counter() - t0:.1f}s "
        f"({q4.numel() / 2**30:.2f} GiB int4 packed)")
    p50 = _measure_fused(result, ctx, fix, q4, None, dsc, pooled,
                         prefilter=2048, is_int8=False,
                         result_key="p50_ms_2m_int4", label="2M int4")
    result["vs_baseline_2m"] = round(BASELINE_MS / (p50 / batch), 1)
    _release(q4, dsc, pooled)


def _seed_eval(td, n_docs, steps, seed, prefilter, postings_cap,
               cache_root, device):
    """One training seed of the real-data pass: corpus -> the app
    (chunk -> store -> ICT training with BM25-mined hard negatives ->
    dual index) -> the measured fusion gate -> its transfer check ->
    paraphrase, ICT and adversarial evals. The trained encoder and its
    tokenizer are cached under ``cache_root``, keyed by the corpus, the
    training config, the seed and ``CACHE_MARK``."""
    from .app.application import RAGApplication
    from .config import RAGConfig
    from .retrieval.gate import validate_transfer
    from .tools.eval_recall import (adversarial_eval_pairs, evaluate,
                                    paraphrase_eval_pairs)
    from .tools.sample_corpus import write_corpus

    paths = write_corpus(f"{td}/docs", n_docs=n_docs, seed=0)
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(p.read_bytes())
    cfg = RAGConfig(
        db_path=f"{td}/rag.db",
        bm25_index_path=f"{td}/idx/bm25",
        colbert_index_path=f"{td}/idx/colbert",
        tokenizer_path=f"{td}/idx/tok.json",
        images_dir=f"{td}/img",
        min_chunk_size=48, max_chunk_size=96,
        doc_max_tokens=128,
        encoder_train_steps=steps,
        encoder_seed=seed,
        dense_prefilter=prefilter,
        bm25_postings_cap=postings_cap,
    )
    h.update(f"|{steps}|{seed}|{cfg.encoder_preset}|"
             f"{cfg.encoder_hard_negatives}|{cfg.tokenizer_vocab_size}|"
             f"{cfg.encoder_word_dropout}|{cfg.encoder_max_epochs}|"
             f"{cfg.encoder_synonym_prob}|{cfg.encoder_synonym_pairs}|"
             f"{cfg.encoder_tie_weight}|{cfg.encoder_reworded_pairs}|"
             f"{cfg.encoder_lexical_anchor}|"
             f"{CACHE_VERSION}|{CACHE_MARK}".encode())
    cdir = Path(cache_root) / h.hexdigest()[:16]
    c_params, c_tok = cdir / "encoder_params.npz", cdir / "tokenizer.json"
    warm = c_params.exists() and c_tok.exists()
    if warm:
        log(f"seed {seed}: cached encoder {cdir.name} (skipping training)")
        Path(cfg.tokenizer_path).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(c_tok, cfg.tokenizer_path)
        enc_dir = Path(cfg.colbert_index_path)
        enc_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(c_params, enc_dir / "encoder_params.npz")
        cfg.encoder_train_steps = 0
    t0 = time.perf_counter()
    app = RAGApplication(cfg, use_ollama=False, device=device)
    app.index_documents([str(p) for p in paths])
    if not warm:
        cdir.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(cfg.colbert_index_path) / "encoder_params.npz",
                    c_params)
        shutil.copy(cfg.tokenizer_path, c_tok)
    app.resolve_final_fusion()
    log(f"seed {seed}: indexed+trained in {time.perf_counter() - t0:.0f}s, "
        f"gate={app.fusion_gate}")

    out = {"gate": app.fusion_gate, "chunks": None}
    # the gate calibrates on ICT-span queries; its pick is re-measured on
    # the generator-disjoint template family (paraphrase + adversarial)
    corpus = app.store.all_chunk_texts()
    fam = paraphrase_eval_pairs(corpus) + adversarial_eval_pairs(corpus)
    rng = np.random.default_rng(31)
    rng.shuffle(fam)
    picked = (app.config.final_fusion, app.config.fusion_weight_bm25)
    out["gate_transfer"] = validate_transfer(
        app.config, app.indexes, app.encoder, fam[:96], picked,
        chunk_store=app.store)
    log(f"seed {seed} gate transfer: {json.dumps(out['gate_transfer'])}")
    # "gated" = the gate's (final_fusion, fusion_weight_bm25); "parity" =
    # the reference's settings; "rrf" = the equal-weight blended order
    configs = {
        "gated": None,
        "parity": {"final_fusion": "rerank", "fusion_weight_bm25": 0.5},
        "rrf": {"final_fusion": "rrf", "fusion_weight_bm25": 0.5},
    }
    for source in ("paraphrase", "ict", "adversarial"):
        per = {}
        for name, overrides in configs.items():
            # the exact comparison (route 0: the int8 scan kernel) and the
            # per-leg numbers are index properties: once per source
            r = evaluate(app, n_queries=128, k=10, batch=8,
                         measure_latency=False, query_source=source,
                         config_overrides=overrides,
                         measure_exact=(name == "gated"),
                         measure_legs=(name == "gated"))
            per[name] = r
            log(f"seed {seed} {source} {name}: {json.dumps(r)}")
        conf = per["gated"]
        out["chunks"] = conf["chunks"]
        out[source] = {
            "hit10": conf["hit@10_configured"],          # calibrated
            "hit10_parity": per["parity"]["hit@10_configured"],
            "hit10_rrf": per["rrf"]["hit@10_configured"],
            "hit10_bm25_only": conf["hit@10_bm25_only"],
            "hit10_dense_only": conf["hit@10_dense_only"],
            "agreement10_vs_exact": conf["agreement@10"],
            "queries": conf["queries"],
        }
    return out


def run_realdata(result, ctx):
    """Real-data quality: the ~500-chunk sample corpus through the app,
    3 training seeds, paraphrase / ICT / adversarial evals, the measured
    gate; mean and max-min spread across seeds."""
    cuda = ctx["cuda"]
    n_docs = 112 if cuda else 12
    # bench.py's depth: ~4 epochs over 14 pairs per chunk at 491 chunks
    steps = 1800 if cuda else 8
    seeds = (0, 1, 2) if cuda else (0,)
    cache_root = REPO / "build" / "bench_cache"
    cache_root.mkdir(parents=True, exist_ok=True)

    per_seed = []
    for i, seed in enumerate(seeds):
        # the first seed pays the first captures and imports
        with _watchdog(1800 if i == 0 else 1080):
            with tempfile.TemporaryDirectory() as td:
                per_seed.append(_seed_eval(
                    td, n_docs, steps, seed, ctx["prefilter"],
                    ctx["postings_cap"], cache_root, ctx["device"]))

    rd = {"chunks": per_seed[0]["chunks"], "seeds": len(per_seed),
          "train_steps": steps, "gate": per_seed[0]["gate"]}
    transfers = [s["gate_transfer"] for s in per_seed]
    rd["gate_transfer"] = {
        "transfer_hit@10": round(float(np.mean(
            [t["transfer_hit@10"] for t in transfers])), 3),
        "transfer_best": round(float(np.mean(
            [t["transfer_best"] for t in transfers])), 3),
        "in_band_all_seeds": all(t["in_band"] for t in transfers),
        "per_entry": transfers[0]["per_entry"],
    }
    slices = ("paraphrase", "ict", "adversarial")
    for source in slices:
        rows = [s[source] for s in per_seed]
        agg = {}
        for key in rows[0]:
            vals = [r[key] for r in rows]
            if isinstance(vals[0], (int, float)):
                agg[key] = round(float(np.mean(vals)), 3)
                if len(vals) > 1 and key.startswith("hit10"):
                    agg[f"{key}_spread"] = round(
                        float(np.max(vals) - np.min(vals)), 3)
            else:
                agg[key] = vals[0]
        rd[source] = agg
    result["realdata"] = rd
    # the headline quality claim: gated hybrid vs its own BM25 leg on
    # non-verbatim queries
    result["hit10_paraphrase"] = rd["paraphrase"]["hit10"]
    result["hit10_paraphrase_bm25_only"] = rd["paraphrase"]["hit10_bm25_only"]
    deltas = {s: round(rd[s]["hit10"] - rd[s]["hit10_bm25_only"], 3)
              for s in slices}
    result["hit10_mean_all"] = round(
        float(np.mean([rd[s]["hit10"] for s in slices])), 3)
    result["hit10_mean_all_bm25_only"] = round(
        float(np.mean([rd[s]["hit10_bm25_only"] for s in slices])), 3)
    # kept for comparison with bench.py's older rounds
    result["hit10_mean_both"] = round(
        (rd["paraphrase"]["hit10"] + rd["ict"]["hit10"]) / 2, 3)
    result["hit10_mean_both_bm25_only"] = round(
        (rd["paraphrase"]["hit10_bm25_only"]
         + rd["ict"]["hit10_bm25_only"]) / 2, 3)
    result["hit10_adversarial_dense_only"] = \
        rd["adversarial"]["hit10_dense_only"]
    mean_delta = round(float(np.mean(list(deltas.values()))), 3)
    result["quality_note"] = (
        "calibrated hybrid minus bm25-only: "
        + ", ".join(f"{s} {deltas[s]:+.3f}" for s in slices)
        + f", mean {mean_delta:+.3f} over {len(slices)} slices "
        "(paraphrase keeps concrete slot words = BM25's best case; "
        "adversarial replaces them via the synonym lexicon = only "
        "semantics works). The (final_fusion, bm25 leg weight) "
        "setting is measured per index on held-out queries "
        "(retrieval/gate.py); parity (rerank, unweighted) scores "
        + "/".join(str(rd[s]["hit10_parity"]) for s in slices)
        + " on the same evals.")


def run_pretrained(result, ctx):
    """Pretrained-checkpoint quality: the three real-data slices through a
    converted local checkpoint (no training), as ``pretrained_*`` fields.
    Needs a local jinaai/jina-colbert-v2 directory:

        HRAG_CHECKPOINT=ckpt python -m hybrid_rag_colbertv2_tpu_torch.bench

    Skipped with a log line when HRAG_CHECKPOINT is unset or invalid."""
    ckpt = os.environ.get("HRAG_CHECKPOINT", "")
    if not ckpt:
        log("pretrained pass skipped: HRAG_CHECKPOINT not set "
            "(offline container — see docstring for the one-command "
            "recipe once a checkpoint is available)")
        return
    if not Path(ckpt).is_dir():
        log(f"pretrained pass skipped: HRAG_CHECKPOINT={ckpt} is not a "
            "directory")
        return
    from .app.application import RAGApplication
    from .config import RAGConfig
    from .tools.eval_recall import evaluate
    from .tools.sample_corpus import write_corpus

    n_docs = 112 if ctx["cuda"] else 12
    with tempfile.TemporaryDirectory() as td:
        paths = write_corpus(f"{td}/docs", n_docs=n_docs, seed=0)
        cfg = RAGConfig(
            db_path=f"{td}/rag.db",
            bm25_index_path=f"{td}/idx/bm25",
            colbert_index_path=f"{td}/idx/colbert",
            tokenizer_path=f"{td}/idx/tok.json",
            images_dir=f"{td}/img",
            min_chunk_size=48, max_chunk_size=96,
            doc_max_tokens=128,
            encoder_checkpoint=ckpt,
            encoder_train_steps=0,
            dense_prefilter=ctx["prefilter"],
            bm25_postings_cap=ctx["postings_cap"],
        )
        t0 = time.perf_counter()
        app = RAGApplication(cfg, use_ollama=False, device=ctx["device"])
        app.index_documents([str(p) for p in paths])
        app.resolve_final_fusion()
        log(f"pretrained: indexed in {time.perf_counter() - t0:.0f}s, "
            f"gate={app.fusion_gate}")
        pre = {"gate": app.fusion_gate}
        n_eval = 128 if ctx["cuda"] else 16
        for source in ("paraphrase", "ict", "adversarial"):
            r = evaluate(app, n_queries=n_eval, k=10, batch=8,
                         measure_latency=False, query_source=source,
                         measure_exact=False, measure_legs=True)
            pre[source] = {"hit10": r["hit@10_configured"],
                           "hit10_bm25_only": r["hit@10_bm25_only"],
                           "hit10_dense_only": r["hit@10_dense_only"]}
            log(f"pretrained {source}: {json.dumps(pre[source])}")
        result["pretrained"] = pre
        result["hit10_mean_pretrained"] = round(float(np.mean(
            [pre[s]["hit10"] for s in
             ("paraphrase", "ict", "adversarial")])), 3)


def run_organic(result, ctx):
    """Organic-corpus quality: the repository's own documentation through
    the default config (auto-train, auto gate). Slices: verbatim ICT
    spans, 30% word dropout, full synonym substitution, ~40 hand-written
    questions, and the dense hit@10 lost by truncating docs to 64
    tokens."""
    from .app.application import RAGApplication
    from .config import RAGConfig
    from .index.dense import DenseTokenIndex
    from .retrieval.gate import measure_menu
    from .tools.eval_recall import evaluate
    from .tools.organic_questions import evaluate_questions
    from .train.data import pseudo_query_pairs

    docs = [p for p in (
        REPO / "README.md", REPO / "SURVEY.md", REPO / "PARITY.md",
        REPO / "BASELINE.md", REPO / "docs" / "architecture.md",
        REPO / "docs" / "performance.md", REPO / "docs" / "scaling.md",
    ) if p.exists()]
    if len(docs) < 3:
        log("organic pass skipped: repo docs not found")
        return
    with tempfile.TemporaryDirectory() as td:
        cfg = RAGConfig(
            db_path=f"{td}/rag.db", bm25_index_path=f"{td}/idx/bm25",
            colbert_index_path=f"{td}/idx/colbert",
            tokenizer_path=f"{td}/idx/tok.json", images_dir=f"{td}/img",
            min_chunk_size=48, max_chunk_size=96, doc_max_tokens=192,
        )
        t0 = time.perf_counter()
        app = RAGApplication(cfg, use_ollama=False, device=ctx["device"])
        app.index_documents([str(p) for p in docs])
        app.resolve_final_fusion()
        corpus = app.store.all_chunk_texts()
        log(f"organic: {len(corpus)} chunks indexed+gated in "
            f"{time.perf_counter() - t0:.0f}s, gate="
            f"({app.config.final_fusion}, w={app.config.fusion_weight_bm25})")
        org = {"chunks": len(corpus),
               "gate_picked": app.config.final_fusion,
               "gate_weight": app.config.fusion_weight_bm25}
        n_eval = 96 if ctx["cuda"] else 16
        r = evaluate(app, n_queries=n_eval, k=10, batch=8,
                     measure_latency=False, query_source="ict",
                     measure_exact=False, measure_legs=True)
        org["ict"] = {"hit10": r["hit@10_configured"],
                      "hit10_bm25_only": r["hit@10_bm25_only"],
                      "hit10_dense_only": r["hit@10_dense_only"]}
        log(f"organic ict: {json.dumps(org['ict'])}")
        picked = (app.config.final_fusion, app.config.fusion_weight_bm25)
        lex = app.indexes.lexical
        for name, kw in (("dropout", dict(word_dropout=0.3, seed=211)),
                         ("synonym", dict(synonym_prob=1.0, seed=313))):
            pairs = pseudo_query_pairs(corpus, n_pairs_per_doc=1, **kw)
            rng = np.random.default_rng(kw["seed"])
            rng.shuffle(pairs)
            pairs = pairs[:n_eval]
            queries = [q for q, _ in pairs]
            sources = np.array([i for _, i in pairs])
            hits = measure_menu(app.config, app.indexes, app.encoder,
                                [picked], queries, sources,
                                chunk_store=app.store)
            bm = np.stack([np.argsort(-lex.score_host(q))[:10]
                           for q in queries])
            bm_hit = float(np.mean([sources[i] in set(bm[i].tolist())
                                    for i in range(len(pairs))]))
            org[name] = {"hit10": round(float(hits[tuple(picked)]), 3),
                         "hit10_bm25_only": round(bm_hit, 3)}
            log(f"organic {name}: {json.dumps(org[name])}")
        slices = ("ict", "dropout", "synonym")
        org["hit10_mean"] = round(float(np.mean(
            [org[s]["hit10"] for s in slices])), 3)
        org["hit10_mean_bm25_only"] = round(float(np.mean(
            [org[s]["hit10_bm25_only"] for s in slices])), 3)
        # hand-written questions with keyphrase-anchored gold chunks: their
        # vocabulary is not sampled from the gold chunk
        nat = evaluate_questions(app, k=10)
        org["questions"] = nat
        log(f"organic hand-written questions: {json.dumps(nat)}")
        if nat.get("n"):
            result["organic_q_hit10"] = nat["hit10"]
            result["organic_q_bm25_only"] = nat["hit10_bm25_only"]
        # truncation cost: the dense index scores a chunk's first
        # doc_max_tokens only; re-encode at 64 tokens and compare the
        # dense-only ICT hit@10 with the full-length (192) index
        embs64, lens64 = app.encoder.encode_docs(corpus, doc_len=64)
        idx64 = DenseTokenIndex.build(embs64, lens64, doc_len=64,
                                      dtype="int8")
        pairs = pseudo_query_pairs(corpus, n_pairs_per_doc=1, seed=97)
        rng = np.random.default_rng(97)
        rng.shuffle(pairs)
        pairs = pairs[:n_eval]
        qs = [q for q, _ in pairs]
        srcs = np.array([i for _, i in pairs])

        def dense_hit(idx):
            hits = []
            for i0 in range(0, len(qs), 8):
                qe = app.encoder.encode_queries(qs[i0:i0 + 8])
                _, di = idx.search_topk(qe, 10)
                di = di.cpu().numpy()
                for j in range(di.shape[0]):
                    hits.append(srcs[i0 + j] in set(di[j].tolist()))
            return round(float(np.mean(hits)), 3)

        trunc = {"dense_hit10_full": dense_hit(app.indexes.dense),
                 "dense_hit10_len64": dense_hit(idx64),
                 "pct_docs_truncated_at_64": round(float(
                     (lens64 >= 64).float().mean()), 3)}
        trunc["delta"] = round(
            trunc["dense_hit10_len64"] - trunc["dense_hit10_full"], 3)
        org["truncation"] = trunc
        result["trunc64_dense_delta"] = trunc["delta"]
        log(f"organic truncation probe: {json.dumps(trunc)}")
        result["organic"] = org


def _launch_counts():
    from .ops import maxsim as ms
    return {w: getattr(ms, w).launches
            for w in ("maxsim_scores", "maxsim_scores_int8",
                      "maxsim_scores_int8_doc", "maxsim_scores_int4_doc")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the port's retrieval benchmark: one JSON line, last")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions at the small sizes)")
    dev = resolve_device(ap.parse_args(argv).device)
    result, failed = {}, []

    def _die():
        log("headline watchdog: device wedged for 2400 s — aborting")
        os._exit(3)

    # a daemon timer, not SIGALRM: a signal cannot interrupt a thread
    # blocked inside one device call
    killer = threading.Timer(2400, _die)
    killer.daemon = True
    killer.start()
    # realdata has no outer watchdog: its per-seed alarms would clash
    # with a nested one (signal.alarm is process-wide)
    passes = [
        ("HRAG_BENCH_RECALL", 150, run_recall, "recall"),
        ("HRAG_BENCH_1M", 660, run_1m, "1M"),
        ("HRAG_BENCH_2M", 600, run_2m_int4, "2M-int4"),
        ("HRAG_BENCH_REALDATA", None, run_realdata, "realdata"),
        ("HRAG_BENCH_PRETRAINED", None, run_pretrained, "pretrained"),
        ("HRAG_BENCH_ORGANIC", 1500, run_organic, "organic"),
    ]
    t_all = time.perf_counter()
    try:
        t0 = time.perf_counter()
        try:
            ctx = run_headline(result, dev)
        finally:
            killer.cancel()
        log(f"[pass headline: {time.perf_counter() - t0:.1f}s]")
        for env, budget, fn, name in passes:
            if os.environ.get(env, "1") == "0":
                log(f"{name} pass disabled via {env}=0")
                continue
            if name in ("1M", "2M-int4", "realdata") and "big" in ctx:
                # free the 100k headline index before the big allocations
                _release(ctx.pop("big").emb_flat)
                gc.collect()
                if ctx["cuda"]:
                    torch.cuda.empty_cache()
            t0 = time.perf_counter()
            try:
                if budget is None:
                    fn(result, ctx)
                else:
                    with _watchdog(budget):
                        fn(result, ctx)
            except Exception:
                failed.append(name)
                log(f"{name} pass FAILED:\n{traceback.format_exc()}")
            log(f"[pass {name}: {time.perf_counter() - t0:.1f}s]")
    except Exception:
        failed.append("headline")
        log(f"headline pass FAILED:\n{traceback.format_exc()}")
    finally:
        log(f"kernel launches: {json.dumps(_launch_counts())}")
        log(f"[bench: {time.perf_counter() - t_all:.1f}s"
            f"{'; failed: ' + ', '.join(failed) if failed else ''}]")
        # THE contract: exactly one JSON line, LAST on stdout
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
