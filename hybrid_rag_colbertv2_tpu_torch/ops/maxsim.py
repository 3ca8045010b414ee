"""True MaxSim (late-interaction) scoring — port of
``hybrid_rag_colbertv2_tpu/ops/maxsim.py``.

    score(q, d) = sum_i  max_j  q_i . d_j

over the document's valid token rows, fp32 accumulation. The fp32 oracle
(``maxsim_scores_exact``) and one full scan per index layout, each the
hand-written CUDA kernel that replaces its Pallas kernel:

  ``maxsim_scores``           bf16 rows          csrc/maxsim.cu (wgmma,
                                                 TMA, on csrc/sm90.cuh)
                              f32 rows           csrc/maxsim_f32.cu
                              (``_maxsim_kernel``)
  ``maxsim_scores_int8``      int8, row scales   csrc/maxsim_int8.cu
                              (``_maxsim_int8_kernel``; wgmma, on
                              csrc/sm90.cuh)
  ``maxsim_scores_int8_doc``  int8, doc scales   csrc/maxsim_int8_doc.cu
                              (``_maxsim_int8_doc_kernel``; wgmma,
                              on csrc/sm90.cuh)
  ``maxsim_scores_int4_doc``  packed int4 pairs, csrc/maxsim_int4_group.cu
                              group scales       (``_maxsim_int4_group_kernel``;
                                                 wgmma, on csrc/sm90.cuh)

Each takes any doc length L that is a multiple of 32 (a doc's last
64-row chunk is then 32 rows), has its plain PyTorch version beside it
(``*_reference``) and a ``launches`` count. CUDA tensors launch the kernel on the current stream
(operand checks first) or raise; CPU tensors run the plain version.

Masking convention (shared with the JAX package):
  * the int8 scan masks a token row by its scale (padding rows are
    all-zero, so their scale is 0), the float scan by its content (a row
    whose elements all lie below 2**-126: zeros, and subnormals, which
    XLA counts as zero); both give it -1e30 before the max.
    Zero-length docs score -1e30 * Lq and never enter top-k;
  * the int8-doc and int4-doc layouts store padding rows as copies of a
    valid row (ops/quant.py), so their scans need no mask; zero-length
    docs have scale 0 and score exactly 0;
  * padded query rows are all-zero, so their max over a doc is 0 (or the
    doc's -1e30 where every row is masked).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .quant import flush_subnormal, unpack_int4_pairs

NEG_INF = -1e30


def maxsim_scores_exact(
    queries: torch.Tensor,      # (B, Lq, D) — padded query rows must be zero
    doc_embs: torch.Tensor,     # (N, L, D)
    doc_lengths: torch.Tensor,  # (N,) int
) -> torch.Tensor:              # (B, N) float32
    """Brute-force MaxSim (einsum), fp32 throughout."""
    q = queries.to(torch.float32)
    d = doc_embs.to(torch.float32)
    sims = torch.einsum("bqd,nld->bnql", q, d)           # (B, N, Lq, L)
    tok = torch.arange(d.shape[1], device=d.device)
    valid = tok[None, :] < doc_lengths.to(d.device)[:, None]   # (N, L)
    sims = torch.where(valid[None, :, None, :], sims,
                       torch.tensor(NEG_INF, dtype=sims.dtype,
                                    device=sims.device))
    return sims.amax(dim=-1).sum(dim=-1)                 # (B, N)


def _block_docs(doc_len: int, blq: int, d: int,
                block_docs: Optional[int]) -> int:
    """Docs per block of a plain version: the fp32 (rows, B*Lq) sims
    stay about 256 MiB."""
    return block_docs or max(1, (1 << 26) // (doc_len * max(blq, d)))


def _sum_per_query(per_col: torch.Tensor, b: int, lq: int) -> torch.Tensor:
    """(docs, B*Lq) column maxima -> (docs, B) sums over each query."""
    return per_col.reshape(per_col.shape[0], b, lq).sum(dim=-1)


def maxsim_scores_reference(
    queries: torch.Tensor,      # (B, Lq, D) float/bf16
    emb_flat: torch.Tensor,     # (N * L, D) bf16 or float32
    doc_lengths: torch.Tensor,  # (N,) — only its length is read
    *,
    doc_len: int,
    block_docs: Optional[int] = None,
) -> torch.Tensor:              # (B, N) float32
    """The plain PyTorch version of the bf16/f32 scan kernel.

    Same arithmetic as ``_maxsim_kernel``: the query is cast to the index
    dtype (``ops/maxsim.py:196`` of the JAX package); products and sums in
    fp32, subnormal row elements counted as zero as XLA does; a row whose
    elements are then all zero (zero L1 norm: none has |x| >= 2**-126)
    gets -1e30 added before the max over L; then the sum over each
    query's Lq rows.
    fp32 matmuls must not run in TF32 (``utils/device.set_fp32_matmul_exact``)."""
    b, lq, d = queries.shape
    n = doc_lengths.shape[0]
    blq = b * lq
    q = queries.to(emb_flat.dtype).to(torch.float32).reshape(blq, d)
    out = torch.empty((n, b), dtype=torch.float32, device=emb_flat.device)
    nb = _block_docs(doc_len, blq, d, block_docs)
    for s in range(0, n, nb):
        e = min(n, s + nb)
        rows = flush_subnormal(
            emb_flat[s * doc_len:e * doc_len].to(torch.float32))
        sims = rows @ q.T                                 # (rows, B*Lq)
        live = (rows != 0).any(dim=1, keepdim=True)
        sims = sims + torch.where(live, 0.0, NEG_INF)
        out[s:e] = _sum_per_query(
            sims.reshape(e - s, doc_len, blq).amax(dim=1), b, lq)
    return out.T.contiguous()


def maxsim_scores_int8_reference(
    queries: torch.Tensor,      # (B, Lq, D) float/bf16
    emb_flat: torch.Tensor,     # (N * L, D) int8
    scales: torch.Tensor,       # (N * L,) float32 per-row dequant scale
    doc_lengths: torch.Tensor,  # (N,) — only its length is read
    *,
    doc_len: int,
    block_docs: Optional[int] = None,
) -> torch.Tensor:              # (B, N) float32
    """The plain PyTorch version of the int8 scan kernel.

    Same arithmetic as ``_maxsim_int8_kernel``: the query is rounded to
    bf16 first (``ops/maxsim.py:525`` of the JAX package); int8 and the
    products are exact in fp32; sims are dequantized by the row scale
    and masked where the scale is 0; max over L, then the sum over each
    query's Lq rows."""
    b, lq, d = queries.shape
    n = doc_lengths.shape[0]
    blq = b * lq
    q = queries.to(torch.bfloat16).to(torch.float32).reshape(blq, d)
    out = torch.empty((n, b), dtype=torch.float32, device=emb_flat.device)
    nb = _block_docs(doc_len, blq, d, block_docs)
    for s in range(0, n, nb):
        e = min(n, s + nb)
        rows = emb_flat[s * doc_len:e * doc_len].to(torch.float32)
        sims = rows @ q.T                                 # (rows, B*Lq)
        sc = scales[s * doc_len:e * doc_len, None]
        sims = sims * sc + torch.where(sc > 0.0, 0.0, NEG_INF)
        out[s:e] = _sum_per_query(
            sims.reshape(e - s, doc_len, blq).amax(dim=1), b, lq)
    return out.T.contiguous()


def maxsim_scores_int8_doc_reference(
    queries: torch.Tensor,      # (B, Lq, D) float/bf16
    emb_flat: torch.Tensor,     # (N * L, D) int8, "int8-doc" layout
    doc_scales: torch.Tensor,   # (N,) float32 per-document scale
    doc_lengths: torch.Tensor,  # (N,) — unused: the layout has no mask
    *,
    doc_len: int,
    block_docs: Optional[int] = None,
) -> torch.Tensor:              # (B, N) float32
    """The plain PyTorch version of the int8-doc scan kernel.

    Same arithmetic as ``_maxsim_int8_doc_kernel`` and its wrapper: the
    query rounded to bf16, exact fp32 products, max over all L stored
    rows (padding rows copy row 0), the sum over Lq, then times the
    doc's scale (``ops/maxsim.py:492`` of the JAX package)."""
    b, lq, d = queries.shape
    n = doc_scales.shape[0]
    blq = b * lq
    q = queries.to(torch.bfloat16).to(torch.float32).reshape(blq, d)
    out = torch.empty((n, b), dtype=torch.float32, device=emb_flat.device)
    nb = _block_docs(doc_len, blq, d, block_docs)
    for s in range(0, n, nb):
        e = min(n, s + nb)
        rows = emb_flat[s * doc_len:e * doc_len].to(torch.float32)
        sims = rows @ q.T                                 # (rows, B*Lq)
        out[s:e] = _sum_per_query(
            sims.reshape(e - s, doc_len, blq).amax(dim=1), b, lq)
    return (out.T * doc_scales[None, :]).contiguous()


def maxsim_scores_int4_doc_reference(
    queries: torch.Tensor,      # (B, Lq, D) float/bf16
    emb_flat: torch.Tensor,     # (N * L/2, D) int8 nibble-packed pairs
    group_scales: torch.Tensor,  # (G, N) float32, doc axis minor
    doc_lengths: torch.Tensor,  # (N,) — unused: the layout has no mask
    *,
    doc_len: int,
    block_docs: Optional[int] = None,
) -> torch.Tensor:              # (B, N) float32
    """The plain PyTorch version of the int4-doc scan kernel.

    Same arithmetic as ``_maxsim_int4_group_kernel``: the query rounded
    to bf16; pair-rows unpacked to token order (values exact in fp32);
    exact fp32 products; max within each of the G token groups, times
    the group's scale, max over groups, then the sum over Lq."""
    b, lq, d = queries.shape
    ng, n = group_scales.shape
    blq = b * lq
    gsz = doc_len // ng
    q = queries.to(torch.bfloat16).to(torch.float32).reshape(blq, d)
    out = torch.empty((n, b), dtype=torch.float32, device=emb_flat.device)
    nb = _block_docs(doc_len, blq, d, block_docs)
    half = doc_len // 2
    for s in range(0, n, nb):
        e = min(n, s + nb)
        rows = unpack_int4_pairs(
            emb_flat[s * half:e * half].reshape(e - s, half, d))
        sims = rows.to(torch.float32).reshape(-1, d) @ q.T  # (rows, B*Lq)
        gmax = sims.reshape(e - s, ng, gsz, blq).amax(dim=2)  # (nb, G, B*Lq)
        per_col = (gmax * group_scales[:, s:e].T[:, :, None]).amax(dim=1)
        out[s:e] = _sum_per_query(per_col, b, lq)
    return out.T.contiguous()


def _check_operands(kernel: str, queries, emb_flat, emb_dtypes, n, rows,
                    doc_len, operands=()):
    """Raise on what a kernel does not take, before any launch: ``n``
    docs of ``doc_len`` tokens in ``rows`` stored rows; ``operands``:
    (name, tensor, dtype, shape) of the index's other arrays."""
    dev = emb_flat.device
    for name, t, _, _ in (("queries", queries, None, None), *operands):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, emb_flat on {dev}")
    if queries.dim() != 3:
        raise ValueError(f"queries must be (B, Lq, D), got {tuple(queries.shape)}")
    b, lq, d = queries.shape
    names = "/".join(str(t).removeprefix("torch.") for t in emb_dtypes)
    if emb_flat.dtype not in emb_dtypes or emb_flat.shape != (rows, d):
        raise ValueError(f"emb_flat must be {names} ({rows}, {d}), got "
                         f"{emb_flat.dtype} {tuple(emb_flat.shape)}")
    for name, t, dtype, shape in operands:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not emb_flat.is_contiguous():
        raise ValueError("emb_flat must be contiguous")
    if emb_flat.data_ptr() % 16:
        raise ValueError("emb_flat must be 16-byte aligned")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"the {kernel} kernel takes D % 16 == 0, D <= 256; D={d}")
    if doc_len <= 0 or doc_len % 32:
        raise ValueError(f"the {kernel} kernel takes L % 32 == 0; L={doc_len}")
    if not 0 < lq <= 256:
        raise ValueError(f"the {kernel} kernel takes 0 < Lq <= 256; Lq={lq}")
    if n * doc_len >= 2**31 or b * n >= 2**31:
        raise ValueError("index too large for 32-bit kernel indexing")


def _check_int8_operands(queries, emb_flat, scales, doc_lengths, doc_len):
    n = doc_lengths.shape[0]
    _check_operands("int8", queries, emb_flat, (torch.int8,), n, n * doc_len,
                    doc_len, (("scales", scales, torch.float32, (n * doc_len,)),))
    if scales.data_ptr() % 16:          # copied in bulk beside the rows
        raise ValueError("scales must be 16-byte aligned")


def _check_float_operands(queries, emb_flat, doc_lengths, doc_len):
    n = doc_lengths.shape[0]
    _check_operands("maxsim", queries, emb_flat,
                    (torch.bfloat16, torch.float32), n, n * doc_len, doc_len)


def _check_int8_doc_operands(queries, emb_flat, doc_scales, lengths,
                             doc_len):
    n = doc_scales.shape[0]
    _check_operands("int8-doc", queries, emb_flat, (torch.int8,),
                    n, n * doc_len, doc_len,
                    (("doc_scales", doc_scales, torch.float32, (n,)),
                     ("doc_lengths", lengths, torch.int32, (n,))))


def _check_int4_operands(queries, emb_flat, group_scales, lengths, doc_len):
    n = group_scales.shape[-1]
    _check_operands("int4-doc", queries, emb_flat, (torch.int8,),
                    n, n * doc_len // 2, doc_len,
                    (("group_scales", group_scales, torch.float32,
                      (doc_len // 8, n)),
                     ("doc_lengths", lengths, torch.int32, (n,))))


def _launch(lib: str, fn: str, device: torch.device, ptrs, ints,
            csrc=_build.CSRC) -> None:
    """Call ``fn`` of library ``lib`` (built from ``csrc``) as
    fn(*ptrs, *ints, stream) on the current stream of ``device``; raise on
    a nonzero CUDA error."""
    f = getattr(_build.load(lib, csrc), fn)
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
                  + [ctypes.c_void_p])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = f(*(t.data_ptr() for t in ptrs), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")


def _on_card(emb_flat: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA; raise else."""
    if emb_flat.device.type == "cpu":
        return False
    if emb_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {emb_flat.device}")
    return True


def maxsim_scores(
    queries: torch.Tensor,      # (B, Lq, D)
    emb_flat: torch.Tensor,     # (N * L, D) bf16 or float32, token-major
    doc_lengths: torch.Tensor,  # (N,) — only its length is read
    *,
    doc_len: int,
) -> torch.Tensor:              # (B, N) float32
    """Full scan of an unquantized index; the query is cast to the index
    dtype. CUDA tensors launch csrc/maxsim.cu (bf16 rows) or
    csrc/maxsim_f32.cu (fp32 rows); CPU tensors run the plain version."""
    if not _on_card(emb_flat):
        return maxsim_scores_reference(queries, emb_flat, doc_lengths,
                                       doc_len=doc_len)
    _check_float_operands(queries, emb_flat, doc_lengths, doc_len)
    n = doc_lengths.shape[0]
    b, lq, d = queries.shape
    q = queries.to(emb_flat.dtype).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=emb_flat.device)
    lib, fn = (("maxsim", "maxsim_bf16_launch")
               if emb_flat.dtype == torch.bfloat16
               else ("maxsim_f32", "maxsim_f32_launch"))
    _launch(lib, fn, emb_flat.device, (q, emb_flat, out),
            (b, lq, d, n, doc_len))
    maxsim_scores.launches += 1
    return out


def maxsim_scores_int8(
    queries: torch.Tensor,      # (B, Lq, D) float/bf16
    emb_flat: torch.Tensor,     # (N * L, D) int8
    scales: torch.Tensor,       # (N * L,) float32 per-row dequant scale
    doc_lengths: torch.Tensor,  # (N,) — only its length is read
    *,
    doc_len: int,
) -> torch.Tensor:              # (B, N) float32
    """Full int8 MaxSim scan (csrc/maxsim_int8.cu on the card)."""
    if not _on_card(emb_flat):
        return maxsim_scores_int8_reference(
            queries, emb_flat, scales, doc_lengths, doc_len=doc_len)
    _check_int8_operands(queries, emb_flat, scales, doc_lengths, doc_len)
    b, lq, d = queries.shape
    n = doc_lengths.shape[0]
    q = queries.to(torch.bfloat16).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=emb_flat.device)
    _launch("maxsim_int8", "maxsim_int8_launch", emb_flat.device,
            (q, emb_flat, scales, out), (b, lq, d, n, doc_len))
    maxsim_scores_int8.launches += 1
    return out


def maxsim_scores_int8_doc(
    queries: torch.Tensor,      # (B, Lq, D) float/bf16
    emb_flat: torch.Tensor,     # (N * L, D) int8, "int8-doc" layout
    doc_scales: torch.Tensor,   # (N,) float32 per-document scale
    doc_lengths: torch.Tensor,  # (N,) int32 — chunks past it are skipped
    *,
    doc_len: int,
) -> torch.Tensor:              # (B, N) float32
    """Full int8-doc scan (csrc/maxsim_int8_doc.cu on the card). The
    kernel multiplies every stored row of each 64-row chunk that starts
    before the doc's length and skips the rest: the layout holds the rows
    past the length as copies of row 0, so the result is the plain
    version's, and a zero-length doc scores exactly 0."""
    if not _on_card(emb_flat):
        return maxsim_scores_int8_doc_reference(
            queries, emb_flat, doc_scales, doc_lengths, doc_len=doc_len)
    lengths = doc_lengths.to(torch.int32)
    _check_int8_doc_operands(queries, emb_flat, doc_scales, lengths, doc_len)
    n = doc_scales.shape[0]
    b, lq, d = queries.shape
    q = queries.to(torch.bfloat16).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=emb_flat.device)
    _launch("maxsim_int8_doc", "maxsim_int8_doc_launch", emb_flat.device,
            (q, emb_flat, doc_scales, lengths, out), (b, lq, d, n, doc_len))
    maxsim_scores_int8_doc.launches += 1
    return out


def maxsim_scores_int4_doc(
    queries: torch.Tensor,      # (B, Lq, D) float/bf16
    emb_flat: torch.Tensor,     # (N * L/2, D) int8 nibble-packed pairs
    group_scales: torch.Tensor,  # (G, N) float32, doc axis minor
    doc_lengths: torch.Tensor,  # (N,) int32 — chunks past it are skipped
    *,
    doc_len: int,
) -> torch.Tensor:              # (B, N) float32
    """Full int4-doc scan (csrc/maxsim_int4_group.cu on the card), with
    G = L / 8 token groups (``ops/quant.py::int4_group_size`` for
    L % 32 == 0). The kernel multiplies every stored row of each 64-row
    chunk (32 at a doc's end where L % 64 == 32) that holds a valid row,
    as the plain version does: the padding
    rows there copy valid rows of their group, and a fully padded group
    carries group 0's scale and row 0, so the result is exact. Chunks
    wholly past a doc's length are skipped, and a zero-length doc scores
    exactly 0."""
    if not _on_card(emb_flat):
        return maxsim_scores_int4_doc_reference(
            queries, emb_flat, group_scales, doc_lengths, doc_len=doc_len)
    lengths = doc_lengths.to(torch.int32)
    _check_int4_operands(queries, emb_flat, group_scales, lengths, doc_len)
    n = group_scales.shape[-1]
    b, lq, d = queries.shape
    q = queries.to(torch.bfloat16).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=emb_flat.device)
    _launch("maxsim_int4_group", "maxsim_int4_group_launch", emb_flat.device,
            (q, emb_flat, group_scales, lengths, out), (b, lq, d, n, doc_len))
    maxsim_scores_int4_doc.launches += 1
    return out


maxsim_scores.launches = 0
maxsim_scores_int8.launches = 0
maxsim_scores_int8_doc.launches = 0
maxsim_scores_int4_doc.launches = 0
