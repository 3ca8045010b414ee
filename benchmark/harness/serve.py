"""The system under test, set up from a cell's generated inputs, and the
loads that drive it.

The served path is ``app/server.py::MicroBatcher`` over
``HybridRetriever.retrieve_batch`` (the open-loop cells), or
``retrieve_batch`` alone from one caller (the closed-loop cells). The
harness's adapter between the two records the spans the per-layer
metrics read: for each call its host interval, batch, real queries,
term width and the ``tokenize`` stage; for each query its due time, the
start of the call that carries it, and its answer.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import gen
from .spec import ROOT


def port():
    """The program's modules (the PyTorch port); ImportError without it."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from hybrid_rag_colbertv2_tpu_torch.app.server import MicroBatcher
    from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig, RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.bucketed import (
        BucketedDenseIndex)
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    from hybrid_rag_colbertv2_tpu_torch.retrieval import cascade
    return dict(MicroBatcher=MicroBatcher, MeshConfig=MeshConfig,
                RAGConfig=RAGConfig, BucketedDenseIndex=BucketedDenseIndex,
                DenseTokenIndex=DenseTokenIndex, LexicalIndex=LexicalIndex,
                IndexManager=IndexManager, ColBERTConfig=ColBERTConfig,
                ColBERTEncoder=ColBERTEncoder, HashTokenizer=HashTokenizer,
                cascade=cascade)


def term_width(n_terms: int, buckets: Sequence[int], q_max: int) -> int:
    """The BM25 term width a batch is packed at: the smallest configured
    bucket that covers its longest query, else ``q_max``."""
    for b in sorted(buckets):
        if n_terms <= b < q_max:
            return b
    return q_max


# ---------------------------------------------------------------------
# inputs


@dataclass
class Inputs:
    """A cell's generated inputs, handed alike to the program and to the
    reference."""
    n_docs: int
    subs: List[Dict]            # rows, scales, lengths, doc_len, gid
    bucket_of: Optional[torch.Tensor]
    row_of: Optional[torch.Tensor]
    lex_lens: torch.Tensor      # (n_docs,) lexical tokens per doc
    csr: Dict                   # the BM25 CSR (numpy) and its scalars
    texts: List[str]
    terms: List[List[int]]
    vocab: int
    timings: Dict[str, float] = field(default_factory=dict)


def lexical_lengths(dense_lens: torch.Tensor, per_token: float
                    ) -> torch.Tensor:
    return torch.clamp(torch.round(dense_lens.to(torch.float64) * per_token),
                       min=1).to(torch.int64)


def build_inputs(cell: Dict, arch: Dict, seed: int, device,
                 n_queries: int) -> Inputs:
    """Dense token rows (per bucket for a bucketed layout), the lexical
    postings and ``n_queries`` queries, all from ``seed``."""
    t = {}
    t0 = time.perf_counter()
    corpus = cell["corpus"]
    n = corpus["n_docs"]
    dim = arch["dim"]
    lens = torch.as_tensor(gen.shuffled_sizes(corpus["lengths"], n, seed,
                                              "doc_lengths"), device=device)
    if corpus["layout"] == "flat":
        groups = [(corpus["doc_len"], torch.arange(n, device=device))]
        bucket_of = row_of = None
    else:
        sizes = sorted(corpus["buckets"])
        home = torch.full((n,), len(sizes) - 1, dtype=torch.int64,
                          device=device)
        for bi in reversed(range(len(sizes))):
            home = torch.where(lens <= sizes[bi], bi, home)
        groups, bucket_of, row_of = [], torch.zeros_like(home), \
            torch.zeros_like(home)
        for bi, size in enumerate(sizes):
            ids = torch.nonzero(home == bi).squeeze(1)
            if ids.numel():
                bucket_of[ids] = len(groups)
                row_of[ids] = torch.arange(ids.numel(), device=device)
                groups.append((size, ids))
        bucket_of, row_of = bucket_of.to(torch.int32), row_of.to(torch.int32)
    topics = gen.unit_topics(corpus["n_topics"], dim,
                             gen.torch_gen(seed, "topics", device), device)
    subs = []
    for si, (doc_len, ids) in enumerate(groups):
        n_b = ids.numel()
        n_pad = gen.round_up(max(n_b, 1), 128)
        lengths = torch.zeros((n_pad,), dtype=torch.int32, device=device)
        lengths[:n_b] = torch.clamp(lens[ids], max=doc_len).to(torch.int32)
        rows, scales = gen.topic_index(lengths, doc_len, topics,
                                       corpus["topic_noise"], seed,
                                       f"rows.{si}")
        gid = torch.full((n_pad,), -1, dtype=torch.int64, device=device)
        gid[:n_b] = ids
        subs.append(dict(rows=rows, scales=scales, lengths=lengths,
                         doc_len=doc_len, gid=gid, n_docs=n_b,
                         valid_rows=int(lengths.sum())))
    _sync(device)
    t["rows_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lx = corpus["lexical"]
    lex_lens = lexical_lengths(lens, lx["terms_per_token"])
    tokens = gen.lexical_tokens(lex_lens, lx["vocab"], lx["zipf_s"], seed)
    term, doc, tf = gen.postings(tokens, lex_lens, n)
    csr = gen.bm25_csr(term, doc, tf, lex_lens, n, lx["vocab"],
                       cell["retrieval"]["bm25_postings_cap"])
    del term, doc, tf
    t["lexical_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = cell["queries"]
    texts, terms = gen.make_queries(n_queries, q["words"], q["doc_share"],
                                    tokens, lex_lens, lx["vocab"], seed,
                                    "queries")
    del tokens
    t["queries_s"] = time.perf_counter() - t0
    return Inputs(n_docs=n, subs=subs, bucket_of=bucket_of, row_of=row_of,
                  lex_lens=lex_lens, csr=csr, texts=texts, terms=terms,
                  vocab=lx["vocab"], timings=t)


def lexical_pairs(inputs: Inputs, cell: Dict, seed: int) -> Dict:
    """The (term, doc, tf) pairs again from ``seed``, for the reference."""
    lx = cell["corpus"]["lexical"]
    tokens = gen.lexical_tokens(inputs.lex_lens, lx["vocab"], lx["zipf_s"],
                                seed)
    term, doc, tf = gen.postings(tokens, inputs.lex_lens, inputs.n_docs)
    return dict(term=term, doc=doc, tf=tf, lex_lens=inputs.lex_lens,
                vocab=lx["vocab"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------
# the system under test


def rag_config(P, cell: Dict, arch: Dict):
    r, c = cell["retrieval"], cell["corpus"]
    mesh = P["MeshConfig"](
        index_dtype="int8", compute_dtype=arch["compute_dtype"],
        index_layout="single" if c["layout"] == "flat" else "bucketed",
        doc_token_buckets=tuple(c.get("buckets", (64, 128, 256))))
    return P["RAGConfig"](
        bm25_top_k=r["bm25_top_k"], colbert_top_k=r["colbert_top_k"],
        fusion_candidates=r["fusion_candidates"], rrf_k=r["rrf_k"],
        fusion_weight_bm25=r["fusion_weight_bm25"],
        dense_prefilter=r["dense_prefilter"],
        bm25_postings_cap=r["bm25_postings_cap"],
        query_max_terms=r["query_max_terms"],
        query_term_buckets=tuple(r["query_term_buckets"]),
        query_max_tokens=arch["query_maxlen"], mesh=mesh)


# the activations of the port's encoder, by the file's ``encoder_dtype``
ENCODER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def encoder_config(P, arch: Dict):
    """The port's ``ColBERTConfig`` from a configuration file: the keys
    every file states, mapped to the port's names; the activations in
    the file's ``encoder_dtype``; then every key of the file's optional
    ``"encoder"`` object, by the port's own field name (a JSON list as a
    tuple), for what a block needs beyond the mapped keys. A key there
    that ``ColBERTConfig`` lacks, or that a mapped key already sets,
    stops set-up with its name."""
    dtype = arch["encoder_dtype"]
    if dtype not in ENCODER_DTYPES:
        raise ValueError(f"encoder_dtype {dtype!r}: the port's encoder runs "
                         f"in {' or '.join(ENCODER_DTYPES)}")
    kw = dict(
        vocab_size=arch["vocab_size"], hidden_size=arch["hidden_size"],
        num_layers=arch["num_hidden_layers"],
        num_heads=arch["num_attention_heads"],
        intermediate_size=arch["intermediate_size"],
        max_position_embeddings=arch["max_position_embeddings"],
        type_vocab_size=arch["type_vocab_size"],
        layer_norm_eps=arch["layer_norm_eps"], colbert_dim=arch["dim"],
        position_embedding=arch["position_embedding"],
        rope_base=float(arch.get("rotary_emb_base", 10000.0)),
        pad_token_id=arch["pad_token_id"],
        query_max_tokens=arch["query_maxlen"],
        doc_max_tokens=arch["doc_maxlen"], dtype=ENCODER_DTYPES[dtype])
    extra = arch.get("encoder", {})
    fields = {f.name for f in dataclasses.fields(P["ColBERTConfig"])}
    for key in sorted(extra):
        if key in kw:
            raise ValueError(f"encoder.{key}: a mapped key of the "
                             "configuration file sets it already")
        if key not in fields:
            raise ValueError(f"encoder.{key}: the port's ColBERTConfig has "
                             "no such field")
    kw.update((k, tuple(v) if isinstance(v, list) else v)
              for k, v in extra.items())
    return P["ColBERTConfig"](**kw)


class System:
    """The port's retriever over the cell's inputs, its micro-batcher,
    and the spans the adapter between them records."""

    def __init__(self, cell: Dict, arch: Dict, inputs: Inputs,
                 weights: Dict[str, torch.Tensor], device):
        P = self.P = port()
        self.cell, self.arch, self.inputs = cell, arch, inputs
        self.device = torch.device(device)
        enc = P["ColBERTEncoder"](encoder_config(P, arch),
                                  P["HashTokenizer"](arch["vocab_size"]),
                                  params=weights, device=device)
        cfg = rag_config(P, cell, arch)
        csr = inputs.csr
        words = gen.vocab_words(inputs.vocab)
        lex = P["LexicalIndex"](
            vocab={w: i for i, w in enumerate(words)}, indptr=csr["indptr"],
            post_docs=csr["post_docs"], post_weights=csr["post_weights"],
            n_docs=inputs.n_docs, avgdl=csr["avgdl"], k1=gen.K1, b=gen.B,
            max_postings=csr["max_postings"])
        flat = [P["DenseTokenIndex"](
            emb_flat=s["rows"], doc_lengths=s["lengths"], n_docs=s["n_docs"],
            doc_len=s["doc_len"], dim=arch["dim"], scales=s["scales"])
            for s in inputs.subs]
        if inputs.bucket_of is None:
            dense = flat[0]
        else:
            dense = P["BucketedDenseIndex"](
                buckets=flat,
                global_ids=[s["gid"].to(torch.int32) for s in inputs.subs],
                bucket_of=inputs.bucket_of, row_of=inputs.row_of,
                n_docs=inputs.n_docs)
        mgr = P["IndexManager"](cfg, device=device)
        mgr.lexical, mgr.dense = lex, dense
        self.retriever = P["cascade"].HybridRetriever(cfg, mgr, enc,
                                                      device=device)
        self.encoder = enc
        self.cfg = cfg
        self.n_terms = {t: len(tr) for t, tr in zip(inputs.texts,
                                                    inputs.terms)}
        self.rec: Optional[Recorder] = None
        self.batcher = None
        load = cell["load"]
        if load["loop"] == "open":
            self.batcher = P["MicroBatcher"](
                self._fn_batch, max_batch=load["max_batch"],
                window_s=load["window_ms"] / 1e3, timeout_s=120.0,
                default_top_k=cell["queries"]["top_k"],
                inflight=load["inflight"])
            self.clients = ThreadPoolExecutor(
                max_workers=load["clients"], thread_name_prefix="client")

    # -- one call -------------------------------------------------------
    def call(self, queries: List[str], top_k: int, n_real: int):
        """``retrieve_batch`` with the spans recorded: -> (ids, scores)."""
        lt: Dict[str, float] = {}
        t0 = time.perf_counter()
        ids, scores = self.retriever.retrieve_batch(queries, top_k,
                                                    timings_out=lt)
        t1 = time.perf_counter()
        if self.rec is not None:
            self.rec.call(t0, t1, len(queries), n_real, lt)
        return ids, scores

    def _fn_batch(self, queries: List[str], top_k: int):
        """MicroBatcher's ``fn_batch``: the padded batch repeats its last
        query, and query texts are distinct, so the real ones lead."""
        n_real = queries.index(queries[-1]) + 1
        rec = self.rec
        if rec is not None:
            t = time.perf_counter()
            for q in queries[:n_real]:
                rec.dispatched(q, t)
        ids, scores = self.call(queries, top_k, n_real)
        return [(ids[i], scores[i]) for i in range(len(queries))]

    # -- set-up ---------------------------------------------------------
    def shapes(self) -> List[tuple]:
        """The (batch, term width) shapes the cell's traffic can reach."""
        load, r = self.cell["load"], self.cell["retrieval"]
        words = self.cell["queries"]["words"]
        widths = sorted({term_width(n, r["query_term_buckets"],
                                    r["query_max_terms"])
                         for n in range(words["min"], words["max"] + 1)})
        if load["loop"] == "open":
            pads, b = [], 1
            while True:
                pads.append(b)
                if b >= load["max_batch"]:
                    break
                b = min(2 * b, load["max_batch"])
        else:
            pads = [load["batch"]]
        return [(b, w) for b in pads for w in widths]

    def warm(self, pool: Sequence[str]) -> None:
        """One call of every reachable shape (each captures its graph),
        then, for an open loop, every client thread started; the batches
        are kept in ``warm_batches``."""
        top_k = self.cell["queries"]["top_k"]
        r = self.cell["retrieval"]
        self.warm_batches = []
        for b, w in self.shapes():
            fit = [q for q in pool if term_width(
                self.n_terms[q], r["query_term_buckets"],
                r["query_max_terms"]) <= w]
            top = [q for q in fit if term_width(
                self.n_terms[q], r["query_term_buckets"],
                r["query_max_terms"]) == w]
            if not top or len(fit) < b:
                raise RuntimeError(f"no warm-up batch of shape B={b} Q={w}")
            batch = [top[0]] + [q for q in fit if q != top[0]][:b - 1]
            self.call(batch, top_k, b)
            self.warm_batches.append(batch)
        if self.batcher is not None:
            self.start_clients()

    def start_clients(self) -> None:
        """Every client thread started before the window: one task per
        worker, each held at a barrier until all of them run (an executor
        starts a thread only at a submit that finds none idle, so it would
        otherwise start them inside the window, at its first bursts)."""
        gate = threading.Barrier(self.cell["load"]["clients"])
        for f in [self.clients.submit(gate.wait, 60.0)
                  for _ in range(gate.parties)]:
            f.result()

    def captures(self) -> int:
        return self.P["cascade"].FusedCascade.captures

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()
            self.clients.shutdown(wait=True)

    def free(self) -> None:
        """Drop the program's state: the retriever, the encoder, the
        captured graphs and their pools (the inputs stay)."""
        self.close()
        self.P["cascade"]._FUSED_CACHE.drop_where(lambda _k, _e: True)
        self.retriever = self.encoder = self.batcher = None


# ---------------------------------------------------------------------
# spans


class Recorder:
    """Per-call and per-query spans of one window."""

    def __init__(self, texts: Sequence[str], k: int):
        n = len(texts)
        self.index = {q: i for i, q in enumerate(texts)}
        self.due = np.full(n, np.nan)
        self.dispatch = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.ok = np.zeros(n, bool)
        self.ids = np.full((n, k), -1, np.int64)
        self.scores = np.full((n, k), np.nan, np.float32)
        self.calls: List[Dict] = []
        self._lock = threading.Lock()

    def call(self, t0, t1, b, n_real, lt) -> None:
        with self._lock:
            self.calls.append(dict(t0=t0, t1=t1, b=b, n_real=n_real,
                                   tokenize_s=lt.get("tokenize", 0.0),
                                   cascade_s=lt.get("encode+cascade", 0.0)))

    def dispatched(self, q: str, t: float) -> None:
        i = self.index.get(q)
        if i is not None:
            self.dispatch[i] = t

    def answered(self, i, t, ids, scores) -> None:
        k = min(len(ids), self.ids.shape[1])
        self.ids[i, :k] = ids[:k]
        self.scores[i, :k] = scores[:k]
        self.done[i] = t
        self.ok[i] = True


# ---------------------------------------------------------------------
# loads


def open_loop(system: System, texts: Sequence[str], offsets: np.ndarray,
              rec: Recorder, t0: Optional[float] = None) -> Dict:
    """Send ``texts[i]`` through ``MicroBatcher.submit`` at ``t0 +
    offsets[i]``, whatever came back before; each query is timed from its
    due time. The cell's clients share the schedule: a free client takes
    the next query in due order and sends it when it is due, so a query
    waits for a client only when every client is waiting for an answer.
    No thread hands queries to the clients and nothing is kept per query
    but the recorder's arrays. Waits for every answer. -> t0 and the
    worst lateness (s) of a send behind its due time."""
    system.rec = rec
    top_k = system.cell["queries"]["top_k"]
    t0 = time.perf_counter() if t0 is None else t0
    rec.due[:] = t0 + np.asarray(offsets, np.float64)
    due = rec.due.tolist()
    order = itertools.count()       # next() on it is atomic under the GIL

    def client() -> float:
        worst = 0.0
        for i in order:
            if i >= len(due):
                return worst
            wait = due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            worst = max(worst, time.perf_counter() - due[i])
            try:
                ids, scores = system.batcher.submit(texts[i], top_k)
                rec.answered(i, time.perf_counter(), ids, scores)
            except Exception as e:      # a failed query counts as missing
                print(f"query {i} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
        return worst

    clients = [system.clients.submit(client)
               for _ in range(system.cell["load"]["clients"])]
    return dict(late_s=max(f.result() for f in clients), t0=t0)


def closed_loop(system: System, texts: Sequence[str], seconds: float,
                rec: Recorder, t0: Optional[float] = None) -> Dict:
    """One caller sends full batches back to back for ``seconds``; the
    calls that start in the window count. -> t0 and the last answer."""
    system.rec = rec
    b = system.cell["load"]["batch"]
    top_k = system.cell["queries"]["top_k"]
    t0 = time.perf_counter() if t0 is None else t0
    i, end = 0, t0
    n = len(texts)
    while time.perf_counter() - t0 < seconds:
        sel = [(i + j) % n for j in range(b)]
        batch = [texts[j] for j in sel]
        t_send = time.perf_counter()
        ids, scores = system.call(batch, top_k, b)
        end = time.perf_counter()
        for r, j in enumerate(sel):
            if np.isnan(rec.due[j]):
                rec.due[j] = rec.dispatch[j] = t_send
                rec.answered(j, end, ids[r], scores[r])
        i += b
    return dict(t0=t0, end=end, late_s=0.0)
