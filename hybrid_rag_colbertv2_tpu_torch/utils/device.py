"""Device selection for the port's entry points.

Every class and entry point of the port takes an explicit ``device``. The
default is the card: with no card present the entry points raise rather
than carry on on the CPU, so a deployment that lost its GPU fails loudly.
Tests and CPU tools pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device, always with its index (so
    devices compare equal to ``tensor.device``); a CUDA device with no
    card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU (its plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_fp32_matmul_exact() -> None:
    """fp32 matmuls and convolutions in full fp32, never TF32.

    The JAX reference computes its fp32 paths in fp32; TF32 keeps about
    three decimal digits, which is enough to reorder close candidates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
