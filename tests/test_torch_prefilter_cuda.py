"""Stage A's kernel (csrc/proxy_topk.cu) against ``top_k`` and against
its plain version (``ops/prefilter.py``).

The tests marked ``cuda`` need an NVIDIA card and skip without one; on
the card: ``python -m pytest tests/test_torch_prefilter_cuda.py -m cuda``.
The CPU tests hold the kernel's selection scheme, written out here in
plain PyTorch (the maxima of 16 and 256 entries, then rounds of top-C
over the children of the last round's winners that reach the smallest
winner's value), against ``top_k`` on rows full of ties, and the
wrapper's operand checks.

Tolerance of a proxy: D ulps (2^-23 relative) of the sum of its products'
magnitudes, against the product of the same bf16 operands in fp64. Any
fp32 summation of D exact products, in any order and with truncating
tensor-core accumulation, lands inside it; a sum rounded to bf16 does
not.
"""

from __future__ import annotations

import pytest
import torch

from hybrid_rag_colbertv2_tpu_torch.ops import prefilter
from hybrid_rag_colbertv2_tpu_torch.ops.maxsim import NEG_INF
from hybrid_rag_colbertv2_tpu_torch.ops.topk import top_k

FAN = 16
TOP_CAP = 16384


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the proxy_topk kernel is CUDA "
                    "only")
    return torch.device("cuda")


# -- the selection scheme, in plain PyTorch ------------------------------

def _order_key(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 of fp32 values (-0.0 as +0.0, NaN above
    +inf), as the kernel's ``order_key``."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(torch.isnan(v), 0x7FFFFFFF, b)
    b = torch.where(b == 0x80000000, 0, b)
    return torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)


def _group_max(keys: torch.Tensor) -> torch.Tensor:
    m = -(-keys.shape[0] // FAN)
    pad = torch.full((m * FAN - keys.shape[0],), -1, dtype=keys.dtype)
    return torch.cat([keys, pad]).view(m, FAN).amax(dim=1)


def _best(cand: torch.Tensor, keys: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` entries of ``cand`` with the largest keys, ties by
    ascending index, in that order."""
    cand = cand.sort().values
    order = torch.argsort(keys[cand], descending=True, stable=True)
    return cand[order[:k]]


def level_select(row: torch.Tensor, c: int) -> torch.Tensor:
    """The kernel's top-C of one proxy row, step by step."""
    levels = [_order_key(row)]
    levels.append(_group_max(levels[0]))
    levels.append(_group_max(levels[1]))
    top = 0 if levels[0].shape[0] <= TOP_CAP else (
        1 if levels[1].shape[0] <= TOP_CAP else 2)
    win = torch.arange(levels[top].shape[0])
    for lvl in range(top, -1, -1):
        m = levels[lvl].shape[0]
        if lvl < top:
            parents = win
            win = (win[:, None] * FAN + torch.arange(FAN)).flatten()
            win = win[win < m]
            if parents.shape[0] == c:
                # below the C-th parent's value no child can win
                floor = levels[lvl + 1][parents].min()
                win = win[levels[lvl][win] >= floor]
        win = _best(win, levels[lvl], min(c, m))
    return win


def _tie_row(n: int, seed: int, n_docs: int) -> torch.Tensor:
    """Proxies with the kernel's hard cases: few distinct values (so
    values tie across tiles), runs of equal values, -0.0 beside +0.0,
    the -1e30 fill past ``n_docs`` and on zero-length docs."""
    g = torch.Generator().manual_seed(seed)
    vals = torch.randint(-4, 5, (n,), generator=g).to(torch.float32) / 4
    vals[torch.randint(0, n, (n // 7,), generator=g)] = -0.0
    runs = torch.randint(0, n, (8,), generator=g)
    for r in runs.tolist():
        vals[r:r + 300] = 0.75
    vals[n_docs:] = NEG_INF
    vals[torch.randint(0, n, (n // 50,), generator=g)] = NEG_INF
    return vals


@pytest.mark.parametrize("n, c, n_docs", [
    (1_000, 1_000, 1_000),        # C = N_pad: one round, every entry
    (1_000, 640, 900),            # fill past n_docs
    (5_000, 1_024, 400),          # C > valid docs: -1e30 fill by id
    (25_700, 1_024, 25_700),      # two rounds (jina's first bucket)
    (102_800, 1_024, 102_790),    # two rounds, a partial last tile
    (300_001, 2_048, 300_000),    # three rounds
    (300_001, 300_001, 300_001),  # C = N_pad through three rounds
])
def test_level_select_matches_top_k_on_ties(n, c, n_docs):
    row = _tie_row(n, n + c, n_docs)
    _, want = top_k(row, c)
    assert torch.equal(level_select(row, c), want)


@pytest.mark.parametrize("n, c", [(2_210_456, 1_024), (40_000, 128)])
def test_level_select_matches_top_k_on_continuous_values(n, c):
    g = torch.Generator().manual_seed(n)
    row = torch.randn(n, generator=g)
    row[::97] = NEG_INF
    _, want = top_k(row, c)
    assert torch.equal(level_select(row, c), want)


def test_order_key_orders_as_the_stable_sort():
    v = torch.tensor([1.0, -0.0, 0.0, float("nan"), -float("inf"), NEG_INF,
                      3e38, -1.5, float("inf"), 0.0, -0.0])
    key = _order_key(v)
    assert int(key.min()) > 0     # 0 marks a missing candidate
    assert key[1] == key[2] == key[9] == key[10]
    order = torch.argsort(key, descending=True, stable=True)
    assert order.tolist() == [3, 8, 6, 0, 1, 2, 9, 10, 7, 5, 4]


# -- the wrapper ---------------------------------------------------------

def _inputs(b, lq, d, n_pad, device, seed=0, dup=True, zero_rows=True):
    """Queries with padded (zero) rows, unit bf16 pooled rows with
    duplicates (exact ties), all-zero rows, and zero-length docs."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, lq, d), generator=g, device=device)
    q[:, lq - 3:] = 0.0
    pooled = torch.randn((n_pad, d), generator=g, device=device)
    pooled = pooled / pooled.norm(dim=1, keepdim=True)
    if dup:
        pooled[1::5] = pooled[0::5][: pooled[1::5].shape[0]]
        pooled[n_pad // 2:n_pad // 2 + 40] = pooled[7]
    if zero_rows:
        pooled[3::97] = 0.0
    lengths = torch.randint(1, 129, (n_pad,), generator=g, device=device,
                            dtype=torch.int32)
    lengths[5::89] = 0
    return q, pooled.to(torch.bfloat16).contiguous(), lengths


def test_cpu_tensors_take_the_plain_version():
    q, pooled, lengths = _inputs(3, 8, 32, 700, torch.device("cpu"))
    before = prefilter.pooled_proxy_topk.launches
    got = prefilter.pooled_proxy_topk(q, pooled, lengths, n_docs=650, c=256)
    want = prefilter.pooled_proxy_topk_reference(q, pooled, lengths,
                                                 n_docs=650, c=256)
    assert torch.equal(got, want) and got.dtype == torch.int32
    assert prefilter.pooled_proxy_topk.launches == before


@pytest.mark.parametrize("d, c, n_docs, pooled_dtype, match", [
    (36, 64, 100, torch.bfloat16, "D % 8"),
    (264, 64, 100, torch.bfloat16, "D % 8"),
    (32, 129, 100, torch.bfloat16, "C <= N_pad"),
    (32, 0, 100, torch.bfloat16, "C <= N_pad"),
    (32, 64, 129, torch.bfloat16, "n_docs <= N_pad"),
    (32, 64, 100, torch.float32, "bfloat16"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(
        d, c, n_docs, pooled_dtype, match):
    q = torch.zeros((2, 4, d))
    pooled = torch.zeros((128, d), dtype=pooled_dtype)
    with pytest.raises(ValueError, match=match):
        prefilter.proxy_topk_kernel(q, pooled, torch.ones(128), n_docs=n_docs,
                                    c=c)


# -- on the card ---------------------------------------------------------

def _exact(q, pooled, lengths, n_docs):
    """fp64 proxies of the same bf16 operands (masked to -1e30 as fp32
    rounds it) and each proxy's tolerance."""
    qbar = q.to(torch.float32).sum(dim=1).to(torch.bfloat16).to(torch.float64)
    p64 = pooled.to(torch.float64)
    exact = qbar @ p64.T
    mag = qbar.abs() @ p64.abs().T
    keep = (torch.arange(pooled.shape[0], device=q.device) < n_docs) & (
        lengths > 0)
    neg = torch.tensor(NEG_INF, dtype=torch.float32).item()
    exact = torch.where(keep[None, :], exact, neg)
    tol = pooled.shape[1] * 2.0**-23 * mag
    return exact, tol, keep


def _check(q, pooled, lengths, n_docs, c):
    before = prefilter.pooled_proxy_topk.launches
    cand, proxy = prefilter.proxy_topk_kernel(q, pooled, lengths,
                                              n_docs=n_docs, c=c)
    assert prefilter.pooled_proxy_topk.launches == before + 1
    assert cand.shape == (q.shape[0], c) and cand.dtype == torch.int32
    # exactly top_k of its own proxies, ids and order
    _, want = top_k(proxy, c)
    assert torch.equal(cand, want.to(torch.int32))
    # the proxies: the bf16 product within tolerance, the mask exact
    exact, tol, keep = _exact(q, pooled, lengths, n_docs)
    err = (proxy.to(torch.float64) - exact).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    assert bool((proxy[:, ~keep] == NEG_INF).all())
    # the plain version: the same ids but for swaps of proxies tied within
    # the tolerance; the -1e30 fill identical
    plain = prefilter.pooled_proxy_topk_reference(q, pooled, lengths,
                                                  n_docs=n_docs, c=c)
    ek = torch.gather(exact, 1, cand.long())
    ep = torch.gather(exact, 1, plain.long())
    slack = 4 * tol.max(dim=1, keepdim=True).values
    assert bool(((ek - ep).abs() <= slack).all())
    fill = (ek < -1e29) & (ep < -1e29)
    assert torch.equal(cand[fill], plain[fill])
    return cand, proxy


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000, 25_700, 2_210_456])
@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("b", [1, 7, 16, 17])
def test_stage_a_kernel_against_top_k_and_plain(card, b, d, n):
    q, pooled, lengths = _inputs(b, 32, d, n, card, seed=b * d + n)
    c = min(1024, n)
    _check(q, pooled, lengths, n_docs=n - 17, c=c)


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, n_docs, note", [
    (1_000, 1_000, 1_000, "C = N_pad"),
    (3_000, 1_024, 500, "C > valid docs: -1e30 fill by id"),
    (20_000, 20_000, 19_000, "C = N_pad above one block's sort"),
    (300_032, 2_048, 300_000, "candidates beyond shared memory"),
    (2_210_456, 1_024, 2_210_456, "cell 1's corpus"),
])
def test_stage_a_kernel_c_edges(card, n, c, n_docs, note):
    q, pooled, lengths = _inputs(8, 32, 128, n, card, seed=n + c)
    _check(q, pooled, lengths, n_docs=n_docs, c=c)


@pytest.mark.cuda
def test_stage_a_kernel_zero_query_ties_by_id(card):
    """A query of padding only: every valid proxy is 0, so the top-C is
    the first C valid docs by id."""
    q, pooled, lengths = _inputs(4, 32, 128, 50_000, card)
    q[2] = 0.0
    cand, proxy = _check(q, pooled, lengths, n_docs=50_000, c=1024)
    valid = torch.nonzero(lengths > 0).flatten()[:1024].to(torch.int32)
    assert torch.equal(cand[2], valid)


@pytest.mark.cuda
def test_stage_a_kernel_replays_in_a_cuda_graph(card):
    q, pooled, lengths = _inputs(16, 32, 128, 300_000, card)
    eager = prefilter.pooled_proxy_topk(q, pooled, lengths, n_docs=299_990,
                                        c=1024)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        prefilter.pooled_proxy_topk(q, pooled, lengths, n_docs=299_990,
                                    c=1024)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = prefilter.pooled_proxy_topk(q, pooled, lengths, n_docs=299_990,
                                          c=1024)
    launches = prefilter.pooled_proxy_topk.launches
    q.copy_(torch.flip(q, dims=[0]))
    graph.replay()
    torch.cuda.synchronize()
    assert prefilter.pooled_proxy_topk.launches == launches
    assert torch.equal(out, torch.flip(eager, dims=[0]))
