"""True MaxSim (late-interaction) scoring — port of
``hybrid_rag_colbertv2_tpu/ops/maxsim.py``.

    score(q, d) = sum_i  max_j  q_i . d_j

over the document's valid token rows, fp32 accumulation. This slice
ports the fp32 oracle (``maxsim_scores_exact``) and the full int8 scan
(``maxsim_scores_int8``), whose TPU kernel ``_maxsim_int8_kernel``
becomes the hand-written CUDA kernel ``csrc/maxsim_int8.cu``. The other
three Pallas scans (bf16/f32, int8-doc, int4-doc) wait for their slices
(ROADMAP.md).

Masking convention (shared with the JAX package):
  * the int8 scan masks a token row by its scale: padding rows are
    all-zero, so their scale is 0, and they get -1e30 before the max
    (``doc_lengths`` is not read). The oracle masks by ``doc_lengths``;
  * padded query rows are all-zero, so their max over valid doc rows is
    exactly 0; zero-length docs score -1e30 * Lq and never enter top-k.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

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
    query's Lq rows. Works in doc blocks so the fp32 (rows, B*Lq)
    working set stays bounded (about 256 MiB) at 100k docs. fp32 matmuls
    must not run in TF32 (``utils/device.set_fp32_matmul_exact``)."""
    b, lq, d = queries.shape
    n = doc_lengths.shape[0]
    blq = b * lq
    q = queries.to(torch.bfloat16).to(torch.float32).reshape(blq, d)
    out = torch.empty((n, b), dtype=torch.float32, device=emb_flat.device)
    nb = block_docs or max(1, (1 << 26) // (doc_len * max(blq, d)))
    for s in range(0, n, nb):
        e = min(n, s + nb)
        rows = emb_flat[s * doc_len:e * doc_len].to(torch.float32)
        sims = rows @ q.T                                 # (rows, B*Lq)
        sc = scales[s * doc_len:e * doc_len, None]
        sims = sims * sc + torch.where(sc > 0.0, 0.0, NEG_INF)
        per_q = sims.reshape(e - s, doc_len, blq).amax(dim=1)
        out[s:e] = per_q.reshape(e - s, b, lq).sum(dim=-1)
    return out.T.contiguous()


def _check_int8_operands(queries, emb_flat, scales, doc_lengths, doc_len):
    dev = emb_flat.device
    for name, t in (("queries", queries), ("scales", scales)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, emb_flat on {dev}")
    if queries.dim() != 3:
        raise ValueError(f"queries must be (B, Lq, D), got {tuple(queries.shape)}")
    b, lq, d = queries.shape
    n = doc_lengths.shape[0]
    if emb_flat.dtype != torch.int8 or emb_flat.shape != (n * doc_len, d):
        raise ValueError(f"emb_flat must be int8 ({n * doc_len}, {d}), got "
                         f"{emb_flat.dtype} {tuple(emb_flat.shape)}")
    if scales.dtype != torch.float32 or scales.shape != (n * doc_len,):
        raise ValueError(f"scales must be float32 ({n * doc_len},), got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if not (emb_flat.is_contiguous() and scales.is_contiguous()):
        raise ValueError("emb_flat and scales must be contiguous")
    if emb_flat.data_ptr() % 16:
        raise ValueError("emb_flat must be 16-byte aligned")
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"the int8 kernel takes D % 16 == 0, D <= 256; D={d}")
    if doc_len % 64:
        raise ValueError(f"the int8 kernel takes L % 64 == 0; L={doc_len}")
    if not 0 < lq <= 256:
        raise ValueError(f"the int8 kernel takes 0 < Lq <= 256; Lq={lq}")
    if n * doc_len >= 2**31 or b * n >= 2**31:
        raise ValueError("index too large for 32-bit kernel indexing")


def maxsim_scores_int8(
    queries: torch.Tensor,      # (B, Lq, D) float/bf16
    emb_flat: torch.Tensor,     # (N * L, D) int8
    scales: torch.Tensor,       # (N * L,) float32 per-row dequant scale
    doc_lengths: torch.Tensor,  # (N,) — only its length is read
    *,
    doc_len: int,
) -> torch.Tensor:              # (B, N) float32
    """Full int8 MaxSim scan.

    CUDA tensors launch the hand-written kernel (csrc/maxsim_int8.cu) on
    the current stream; CPU tensors run the plain version. A CUDA call
    launches or raises — there is no fallback. ``launches`` counts kernel
    launches."""
    if emb_flat.device.type == "cpu":
        return maxsim_scores_int8_reference(
            queries, emb_flat, scales, doc_lengths, doc_len=doc_len)
    if emb_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {emb_flat.device}")
    _check_int8_operands(queries, emb_flat, scales, doc_lengths, doc_len)
    b, lq, d = queries.shape
    n = doc_lengths.shape[0]
    q = queries.to(torch.bfloat16).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=emb_flat.device)
    lib = _build.load("maxsim_int8")
    fn = lib.maxsim_int8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(emb_flat.device):
        stream = torch.cuda.current_stream(emb_flat.device).cuda_stream
        rc = fn(q.data_ptr(), emb_flat.data_ptr(), scales.data_ptr(),
                out.data_ptr(), b, lq, d, n, doc_len, stream)
    if rc != 0:
        raise RuntimeError(f"maxsim_int8 kernel launch failed: CUDA error {rc}")
    maxsim_scores_int8.launches += 1
    return out


maxsim_scores_int8.launches = 0
