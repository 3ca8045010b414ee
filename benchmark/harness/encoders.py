"""Plain encoders of the ColBERT family that the configurations' own
reference files (``benchmark/configs/<name>.py``) take: a post-LayerNorm
BERT / XLM-RoBERTa encoder (learned or rotary positions, exact GELU),
the linear ColBERT head and the L2 norm, in plain PyTorch. Nothing of
the program; ``prec`` rounds every matmul input (identity for fp32).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def param_specs(arch: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every parameter of the ColBERT encoder of ``arch`` (a configuration
    file): (name, shape, init, std). ``init`` is "normal" (std x N(0,1)),
    "one" (1 + std x N(0,1), LayerNorm gains) or "bias" (std x N(0,1)).
    Names are the state-dict keys the system under test loads; the
    reference reads the same keys."""
    h, f = arch["hidden_size"], arch["intermediate_size"]
    specs = [("word_embeddings.weight", (arch["vocab_size"], h), "normal",
              h ** -0.5)]
    if arch["position_embedding"] == "learned":
        specs.append(("position_embeddings.weight",
                      (arch["max_position_embeddings"], h), "normal",
                      h ** -0.5))
    if arch["type_vocab_size"]:
        specs.append(("token_type_embeddings.weight",
                      (arch["type_vocab_size"], h), "normal", h ** -0.5))
    specs += [("embeddings_ln.weight", (h,), "one", 0.02),
              ("embeddings_ln.bias", (h,), "bias", 0.02)]
    for i in range(arch["num_hidden_layers"]):
        p = f"layers.{i}."
        for lin in ("query", "key", "value", "out"):
            specs += [(f"{p}attention.{lin}.weight", (h, h), "normal",
                       h ** -0.5),
                      (f"{p}attention.{lin}.bias", (h,), "bias", 0.02)]
        specs += [(f"{p}attention_ln.weight", (h,), "one", 0.02),
                  (f"{p}attention_ln.bias", (h,), "bias", 0.02),
                  (f"{p}intermediate.weight", (f, h), "normal", h ** -0.5),
                  (f"{p}intermediate.bias", (f,), "bias", 0.02),
                  (f"{p}output.weight", (h, f), "normal", f ** -0.5),
                  (f"{p}output.bias", (h,), "bias", 0.02),
                  (f"{p}output_ln.weight", (h,), "one", 0.02),
                  (f"{p}output_ln.bias", (h,), "bias", 0.02)]
    specs.append(("colbert_linear.weight", (arch["dim"], h), "normal",
                  h ** -0.5))
    return specs



def _linear(x, w, b, prec):
    y = prec(x) @ prec(w).T
    return y if b is None else y + b


def _rope(x: torch.Tensor, base: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on (B, S, H, Dh), rotating the two halves
    of the head dimension."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh))
    ang = torch.outer(torch.arange(s, dtype=torch.float32, device=x.device),
                      inv)
    c, sn = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def encode_queries(w: Dict[str, torch.Tensor], arch: Dict,
                   ids: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B, Lq) query ids, every position attended -> (B, Lq, dim) unit
    token embeddings. Post-LayerNorm blocks, exact GELU; learned
    positions count from the configuration's ``learned_position_start``,
    rotary ones from 0; type row 0 is added when the configuration has
    types."""
    h, nh = arch["hidden_size"], arch["num_attention_heads"]
    dh, eps = h // nh, arch["layer_norm_eps"]
    b, s = ids.shape
    x = w["word_embeddings.weight"][ids]
    if arch["position_embedding"] == "learned":
        pos = (torch.arange(s, device=ids.device)
               + arch["learned_position_start"])
        x = x + w["position_embeddings.weight"][pos][None]
    if arch["type_vocab_size"]:
        x = x + w["token_type_embeddings.weight"][0]
    x = F.layer_norm(x, (h,), w["embeddings_ln.weight"],
                     w["embeddings_ln.bias"], eps)
    for i in range(arch["num_hidden_layers"]):
        p = f"layers.{i}."

        def lin(name, t):
            return _linear(t, w[p + name + ".weight"], w[p + name + ".bias"],
                           prec)

        q = lin("attention.query", x).view(b, s, nh, dh)
        k = lin("attention.key", x).view(b, s, nh, dh)
        v = lin("attention.value", x).view(b, s, nh, dh)
        if arch["position_embedding"] == "rope":
            q, k = _rope(q, arch["rotary_emb_base"]), _rope(k, arch["rotary_emb_base"])
        att = torch.einsum("bqhd,bkhd->bhqk", prec(q), prec(k)) / math.sqrt(dh)
        att = torch.softmax(att, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", prec(att), prec(v)).reshape(b, s, h)
        x = F.layer_norm(x + lin("attention.out", o), (h,),
                         w[p + "attention_ln.weight"],
                         w[p + "attention_ln.bias"], eps)
        f = F.gelu(lin("intermediate", x))
        x = F.layer_norm(x + lin("output", f), (h,), w[p + "output_ln.weight"],
                         w[p + "output_ln.bias"], eps)
    e = _linear(x, w["colbert_linear.weight"], None, prec)
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                           min=1e-12)
