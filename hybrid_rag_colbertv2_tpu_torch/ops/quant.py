"""int8 row quantization for the dense token-embedding index.

Port of ``hybrid_rag_colbertv2_tpu/ops/quant.py`` (per-token-row layout
only; the int8-doc and int4-doc layouts come with their kernels). The
device-resident index is int8 with a per-token-row absmax scale,
dequantized inside the MaxSim kernel (ops/maxsim.py).

The bytes and scales are bit-equal to the JAX version: the same fp32
arithmetic, rounding half to even (``jnp.round`` / ``torch.round``), and
the clip to +-127.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (rows, D) -> int8 values + per-row fp32 scales.

    Symmetric absmax quantization: v = round(x / scale), scale = absmax/127.
    All-zero rows (padding tokens) get scale 0 so they dequantize to 0.
    """
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1)                               # (rows,)
    # XLA folds the JAX version's ``absmax / 127.0`` into a multiply by
    # the fp32 reciprocal; do the same so the scales are bit-equal
    scale = absmax * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    return q.to(torch.float32) * scale[:, None]
