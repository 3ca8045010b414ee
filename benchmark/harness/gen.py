"""Seeded inputs: encoder weights, corpora (dense token rows and lexical
postings), queries and arrival schedules.

Every input is a function of ``--seed`` and the cell's data files. Sizes
are fixed multisets (quantiles of the cell's distributions) that the seed
only shuffles, so every seed gives the same amount of work in another
order. Large inputs are made on the device from a ``torch.Generator`` in
a few large calls. Nothing here imports the system under test.

``topic_rows`` / ``topic_index`` / ``quantize_int8_rows`` are copies of
``hybrid_rag_colbertv2_tpu_torch/bench.py``'s generator and of the port's
``ops/quant.py`` formula, frozen here so that a change to the program
cannot change the yardstick.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# BM25 parameters of the port's lexical index (bm25s defaults)
K1, B = 1.5, 0.75
# the query and document markers of the port's hash tokenizer
N_SPECIAL = 7
BOS, PAD, EOS, UNK, MASK, QMARK, DMARK = range(N_SPECIAL)


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of inputs, from any integer
    ``seed`` (seeds may exceed 32 bits)."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def torch_gen(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, stream))
    return g


def np_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------
# fixed multisets of sizes


def _std_normal_ppf(u: np.ndarray) -> np.ndarray:
    """Inverse of the standard normal CDF (Acklam's rational
    approximation, relative error < 1.2e-9; no scipy needed)."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    u = np.asarray(u, np.float64)
    out = np.empty_like(u)
    lo, hi = u < 0.02425, u > 1 - 0.02425
    mid = ~(lo | hi)
    q = np.sqrt(-2 * np.log(u[lo]))
    out[lo] = ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    q = np.sqrt(-2 * np.log(1 - u[hi]))
    out[hi] = -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                 + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q
                            + 1))
    q = u[mid] - 0.5
    r = q * q
    out[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
                 + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3])
                                 * r + b[4]) * r + 1))
    return out


def quantile_sizes(spec: Dict, n: int) -> np.ndarray:
    """``n`` integer sizes at the quantiles (i + 0.5) / n of ``spec``,
    in ascending order:

    - ``{"kind": "lognormal", "median", "sigma", "min", "max"}``: a
      right-skewed size, rounded and clipped to [min, max];
    - ``{"kind": "piecewise", "segments": [[share, lo, hi], ...]}``:
      uniform over [lo, hi] within each segment, shares summing to 1.
    """
    u = (np.arange(n, dtype=np.float64) + 0.5) / max(n, 1)
    kind = spec["kind"]
    if kind == "lognormal":
        x = spec["median"] * np.exp(spec["sigma"] * _std_normal_ppf(u))
        x = np.clip(np.rint(x), spec["min"], spec["max"])
    elif kind == "piecewise":
        segs = spec["segments"]
        shares = np.array([s[0] for s in segs], np.float64)
        if abs(shares.sum() - 1.0) > 1e-9:
            raise ValueError(f"piecewise shares sum to {shares.sum()}")
        edges = np.concatenate([[0.0], np.cumsum(shares)])
        x = np.empty_like(u)
        for i, (share, lo, hi) in enumerate(segs):
            m = (u >= edges[i]) & (u < edges[i + 1] if i + 1 < len(segs)
                                   else u <= 1.0)
            w = (u[m] - edges[i]) / share
            x[m] = np.floor(lo + w * (hi - lo + 1))
        x = np.clip(x, min(s[1] for s in segs), max(s[2] for s in segs))
    else:
        raise ValueError(f"unknown size distribution {kind!r}")
    return x.astype(np.int64)


def shuffled_sizes(spec: Dict, n: int, seed: int, stream: str) -> np.ndarray:
    """``quantile_sizes`` in an order drawn from ``seed``."""
    return quantile_sizes(spec, n)[np_rng(seed, stream).permutation(n)]


def arrival_offsets(n: int, seconds: float, seed: int,
                    stream: str = "arrivals") -> np.ndarray:
    """Poisson arrivals of ``n`` queries over ``seconds``: the ``n``
    quantiles of the exponential gap, scaled to sum to ``seconds`` and
    shuffled by ``seed``. -> due offsets (n,) from the window's start,
    the first at 0, all below ``seconds``."""
    u = (np.arange(n, dtype=np.float64) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps *= seconds / gaps.sum()
    gaps = gaps[np_rng(seed, stream).permutation(n)]
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


# ---------------------------------------------------------------------
# encoder weights


def make_weights(specs: Sequence[Tuple[str, Tuple[int, ...], str, float]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """The encoder's fp32 weights from ``seed``, per the configuration's
    ``param_specs`` (name, shape, init, std): one normal draw on the
    device for all of them, cut into views and scaled per parameter
    ("normal": std x N(0,1); "one": 1 + std x N(0,1); "bias": std x
    N(0,1))."""
    total = sum(math.prod(s) for _, s, _, _ in specs)
    flat = torch.randn((total,), generator=torch_gen(seed, "weights", device),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, init, std in specs:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        t.mul_(std)
        if init == "one":
            t.add_(1.0)
        out[name] = t
        off += n
    return out


# ---------------------------------------------------------------------
# dense token rows (a copy of the port bench's topic generator)


def unit_topics(n_topics: int, dim: int, g: torch.Generator, device
                ) -> torch.Tensor:
    """(n_topics, dim) unit-norm topic centres."""
    t = torch.randn((n_topics, dim), generator=g, device=device)
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def topic_rows(topics: torch.Tensor, assign: torch.Tensor,
               lengths: torch.Tensor, doc_len: int, g: torch.Generator,
               noise: float) -> torch.Tensor:
    """One block of fp32 token rows (n, L, D): doc i's rows are topic
    ``assign[i]`` + ``noise`` x normal, L2-normalized, and zero past
    ``lengths[i]``."""
    dev = topics.device
    x = topics[assign][:, None, :] + noise * torch.randn(
        (assign.shape[0], doc_len, topics.shape[1]), generator=g,
        device=dev)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    tok = torch.arange(doc_len, device=dev)
    return x * (tok[None, :] < lengths[:, None])[..., None]


def quantize_int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, D) fp32 -> int8 values and per-row fp32 scales: symmetric
    absmax / 127, subnormal inputs and scales flushed to 0, zero rows
    scale 0."""
    tiny = torch.finfo(torch.float32).tiny
    x = x.to(torch.float32)
    x = torch.where(x.abs() < tiny, torch.zeros_like(x), x)
    absmax = x.abs().amax(dim=-1)
    scale = absmax * (1.0 / 127.0)
    scale = torch.where(scale.abs() < tiny, torch.zeros_like(scale), scale)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127)
    return q.to(torch.int8), scale


def topic_index(lengths: torch.Tensor, doc_len: int, topics: torch.Tensor,
                noise: float, seed: int, stream: str,
                block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Topic-clustered unit-norm int8 token rows for docs of ``lengths``
    ((n_pad,) on the device; 0 for padding docs): each doc draws one of
    ``topics``; made in blocks of ``block`` docs so no multi-GB fp32
    tensor exists. -> (rows (n_pad * L, D) int8, scales (n_pad * L,) f32)"""
    dev = lengths.device
    g = torch_gen(seed, stream, dev)
    n_topics, dim = topics.shape
    n_pad = lengths.shape[0]
    assign = torch.randint(0, n_topics, (n_pad,), generator=g, device=dev)
    rows = torch.empty((n_pad * doc_len, dim), dtype=torch.int8, device=dev)
    scales = torch.empty((n_pad * doc_len,), dtype=torch.float32,
                         device=dev)
    for s in range(0, n_pad, block):
        e = min(s + block, n_pad)
        x = topic_rows(topics, assign[s:e], lengths[s:e], doc_len, g, noise)
        rows[s * doc_len:e * doc_len], scales[s * doc_len:e * doc_len] = \
            quantize_int8_rows(x.reshape(-1, dim))
    return rows, scales


# ---------------------------------------------------------------------
# lexical side

_CONS, _VOWELS = "bdfgkmprtvz", "aou"
_SYLLABLES = [c + v for c in _CONS for v in _VOWELS]


def vocab_words(v: int) -> List[str]:
    """``v`` distinct pseudo-words, the same for every seed: fixed-width
    base-33 syllable codes ending in "k". No English stopword, and every
    word is its own Snowball stem (no English suffix ends in "k"), so
    the lexical analyzer keeps each word as one term."""
    width = 1
    while len(_SYLLABLES) ** width < v:
        width += 1
    words = []
    for i in range(v):
        digits = []
        for _ in range(width):
            i, r = divmod(i, len(_SYLLABLES))
            digits.append(_SYLLABLES[r])
        words.append("".join(reversed(digits)) + "k")
    return words


def zipf_cdf(v: int, s: float, device) -> torch.Tensor:
    """CDF over term ranks 0..v-1 with P(r) proportional to (r+1)^-s."""
    r = torch.arange(1, v + 1, dtype=torch.float64, device=device)
    p = r ** (-s)
    return torch.cumsum(p / p.sum(), dim=0)


def lexical_tokens(lex_lens: torch.Tensor, vocab: int, zipf_s: float,
                   seed: int) -> torch.Tensor:
    """Each doc's lexical tokens (term ids by Zipf rank), concatenated in
    doc order: (sum(lex_lens),) int64 on the lengths' device."""
    dev = lex_lens.device
    total = int(lex_lens.sum())
    u = torch.rand((total,), generator=torch_gen(seed, "lexical", dev),
                   device=dev, dtype=torch.float64)
    cdf = zipf_cdf(vocab, zipf_s, dev)
    return torch.clamp(torch.searchsorted(cdf, u), max=vocab - 1)


def postings(tokens: torch.Tensor, lex_lens: torch.Tensor, n_docs: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(term, doc) pairs with their term frequency, sorted by term then
    doc. -> (term int64, doc int64, tf int64)"""
    dev = tokens.device
    doc_of = torch.repeat_interleave(
        torch.arange(n_docs, device=dev), lex_lens)
    key = tokens * n_docs + doc_of
    key, _ = torch.sort(key)
    uk, tf = torch.unique_consecutive(key, return_counts=True)
    return uk // n_docs, uk % n_docs, tf


def bm25_csr(term: torch.Tensor, doc: torch.Tensor, tf: torch.Tensor,
             lex_lens: torch.Tensor, n_docs: int, vocab: int, cap: int
             ) -> Dict:
    """The BM25 postings CSR that ``LexicalIndex.build`` lays out from
    these (term, doc, tf) pairs, computed on the device: Lucene idf from
    the true df, weights in float64 rounded to float32, each term's
    postings cut to its ``cap`` highest weights (ties by doc) and kept in
    doc order, padded to multiples of 128 with doc ``n_docs``, weight 0.
    -> numpy arrays and the scalars the index stores."""
    dev = term.device
    dl = lex_lens.to(torch.float64)
    avgdl = max(float(dl.mean()), 1e-9)
    df = torch.bincount(term, minlength=vocab).to(torch.float64)
    idf = torch.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    tf64 = tf.to(torch.float64)
    w = (idf[term] * tf64 * (K1 + 1.0)
         / (tf64 + K1 * (1.0 - B + B * dl[doc] / avgdl))).to(torch.float32)
    if cap:
        # term-major, weight-descending, doc-ascending (the pairs are in
        # doc order within each term, and both sorts are stable)
        o1 = torch.argsort(-w, stable=True)
        o2 = torch.argsort(term[o1], stable=True)
        order = o1[o2]
        t_s = term[order]
        starts = torch.searchsorted(t_s, torch.arange(vocab, device=dev))
        rank = torch.arange(t_s.shape[0], device=dev) - starts[t_s]
        keep = order[rank < cap]
        keep, _ = torch.sort(keep)          # back to (term, doc) order
        term, doc, w = term[keep], doc[keep], w[keep]
    cnt = torch.bincount(term, minlength=vocab)
    indptr = torch.zeros((vocab + 1,), dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(cnt, dim=0)
    nnz = int(indptr[-1])
    max_post = max(round_up(int(cnt.max()) if vocab else 0, 128), 128)
    nnz_pad = max(round_up(nnz, 128), 128)
    post_docs = torch.full((nnz_pad,), n_docs, dtype=torch.int32, device=dev)
    post_docs[:nnz] = doc.to(torch.int32)
    post_w = torch.zeros((nnz_pad,), dtype=torch.float32, device=dev)
    post_w[:nnz] = w
    return dict(indptr=indptr.to(torch.int32).cpu().numpy(),
                post_docs=post_docs.cpu().numpy(),
                post_weights=post_w.cpu().numpy(),
                max_postings=max_post, avgdl=avgdl, nnz=nnz)


def make_queries(n: int, words_spec: Dict, doc_share: float,
                 tokens: torch.Tensor, lex_lens: torch.Tensor,
                 vocab: int, seed: int, stream: str
                 ) -> Tuple[List[str], List[List[int]]]:
    """``n`` distinct query texts and their term ids. Word counts are the
    fixed multiset of ``words_spec`` in a seeded order; each word comes,
    with probability ``doc_share``, from a random position of one target
    document (so the query finds it lexically), else uniformly from the
    vocabulary."""
    words = vocab_words(vocab)
    counts = shuffled_sizes(words_spec, n, seed, stream + ".words")
    dev = tokens.device
    g = torch_gen(seed, stream, dev)
    n_docs = lex_lens.shape[0]
    offs = torch.zeros((n_docs,), dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(lex_lens, dim=0)[:-1]
    total = int(counts.sum())
    target = torch.randint(0, n_docs, (n,), generator=g, device=dev)
    tgt = torch.repeat_interleave(
        target, torch.as_tensor(counts, device=dev))
    pos = offs[tgt] + (torch.rand((total,), generator=g, device=dev)
                       * lex_lens[tgt]).long()
    from_doc = torch.rand((total,), generator=g, device=dev) < doc_share
    uniform = torch.randint(0, vocab, (total,), generator=g, device=dev)
    ids = torch.where(from_doc, tokens[pos], uniform).cpu().numpy()
    rng = np_rng(seed, stream + ".dedupe")
    texts, terms, seen, o = [], [], set(), 0
    for c in counts:
        t = [int(x) for x in ids[o:o + c]]
        o += c
        text = " ".join(words[x] for x in t)
        while text in seen:      # distinct texts: redraw one word
            t[int(rng.integers(len(t)))] = int(rng.integers(vocab))
            text = " ".join(words[x] for x in t)
        seen.add(text)
        texts.append(text)
        terms.append(t)
    return texts, terms
