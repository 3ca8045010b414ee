"""HF checkpoint -> ``ColBERTModel`` state_dict — port of
``hybrid_rag_colbertv2_tpu/models/convert.py``.

Two source namings are supported, auto-detected by ``convert_state_dict``:

  * vanilla ``XLMRobertaModel`` naming (learned positions, separate
    query/key/value projections) — ``convert_xlmr_state_dict``;
  * the jina-xlm-roberta rotary flash layout of the published
    ``jinaai/jina-colbert-v2`` checkpoint: fused
    ``encoder.layers.{i}.mixer.Wqkv``, ``mixer.out_proj``,
    ``mlp.fc1/fc2``, ``norm1/norm2``, top-level ``emb_ln`` and no
    position-embedding table (rotary) — ``convert_flash_state_dict``.

Backbone prefixes ``roberta.`` / ``bert.`` / ``model.`` are stripped (the
ColBERT wrapper checkpoints keep the backbone under ``bert.`` beside the
``linear.weight`` head). HF weights are (out, in), as ``nn.Linear``'s are,
so nothing is transposed; every floating tensor is widened to fp32
(bf16 and fp16 values are exact in fp32). Meta tensors stay meta, so a
layout check at full width costs no memory.

``*.safetensors`` files are read by ``read_safetensors`` (the format,
without the ``safetensors`` package): an 8-byte little-endian header
length, the JSON header (name -> dtype, shape, data_offsets; an optional
``__metadata__`` entry), then the raw little-endian data, offsets counted
from the first byte after the header. ``pytorch_model*.bin`` files are
read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .colbert import ColBERTConfig

_PREFIXES = ("roberta.", "bert.", "model.")

# State-dict keys the converters deliberately ignore: rotary inverse-
# frequency buffers are recomputed from config (rope_base), and the
# pooler head plays no part in ColBERT token embeddings.
_IGNORED_SUBSTRINGS = ("rotary_emb.inv_freq",)
_IGNORED_PREFIXES = ("pooler.",)

# safetensors dtype names -> torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def _is_ignored(key: str) -> bool:
    return (any(s in key for s in _IGNORED_SUBSTRINGS)
            or any(key.startswith(p) for p in _IGNORED_PREFIXES))


class _TrackingDict(dict):
    """Dict recording which keys were actually READ (getitem/get) —
    membership tests don't count. Lets strict conversion prove the source
    layout was consumed exactly (golden-manifest tests)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.used.add(k)
        return super().get(k, default)


def _check_consumed(sd: "_TrackingDict", strict: bool) -> None:
    if not strict:
        return
    unused = {k for k in sd
              if k not in sd.used and not _is_ignored(k)}
    if unused:
        raise ValueError(
            f"strict conversion: {len(unused)} state_dict keys were not "
            f"consumed (layout drift?): {sorted(unused)[:8]}...")


def _t(x) -> torch.Tensor:
    """A source tensor (torch or numpy) as a detached torch tensor, floats
    widened to fp32."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    return t.to(torch.float32) if t.is_floating_point() else t


def _strip(key: str) -> str:
    for p in _PREFIXES:
        if key.startswith(p):
            return key[len(p):]
    return key


def _backbone(sd: _TrackingDict, cfg: ColBERTConfig, ln_key: str
              ) -> Dict[str, torch.Tensor]:
    """The embedding tables and their LayerNorm, shared by both layouts."""
    out = {"word_embeddings.weight": sd["embeddings.word_embeddings.weight"],
           "embeddings_ln.weight": sd[f"{ln_key}.weight"],
           "embeddings_ln.bias": sd[f"{ln_key}.bias"]}
    if cfg.type_vocab_size and "embeddings.token_type_embeddings.weight" in sd:
        out["token_type_embeddings.weight"] = sd[
            "embeddings.token_type_embeddings.weight"]
    return out


def _head(sd: _TrackingDict, out: Dict[str, torch.Tensor],
          projection_key: Optional[str]) -> None:
    if projection_key and projection_key in sd:
        out["colbert_linear.weight"] = sd[projection_key]


def convert_xlmr_state_dict(
    state: Mapping[str, "torch.Tensor | np.ndarray"],
    cfg: ColBERTConfig,
    projection_key: Optional[str] = None,
    strict: bool = False,
) -> Dict[str, torch.Tensor]:
    """state_dict in XLMRobertaModel naming (with or without a leading
    'roberta.' prefix) -> a ``ColBERTModel`` state_dict.

    projection_key: state_dict key of the ColBERT linear head weight (e.g.
    'linear.weight'); if absent the head must be initialized separately.
    strict: raise if any source key is left unconsumed (layout drift).
    """
    sd = _TrackingDict({_strip(k): _t(v) for k, v in state.items()})

    def dense(dst: str, src: str) -> Dict[str, torch.Tensor]:
        return {f"{dst}.weight": sd[f"{src}.weight"],
                f"{dst}.bias": sd[f"{src}.bias"]}

    out = _backbone(sd, cfg, "embeddings.LayerNorm")
    if cfg.position_embedding == "learned":
        out["position_embeddings.weight"] = sd[
            "embeddings.position_embeddings.weight"]
    for i in range(cfg.num_layers):
        pre, dst = f"encoder.layer.{i}", f"layers.{i}"
        for name, src in (("query", "attention.self.query"),
                          ("key", "attention.self.key"),
                          ("value", "attention.self.value"),
                          ("out", "attention.output.dense")):
            out.update(dense(f"{dst}.attention.{name}", f"{pre}.{src}"))
        out.update(dense(f"{dst}.attention_ln",
                         f"{pre}.attention.output.LayerNorm"))
        out.update(dense(f"{dst}.intermediate", f"{pre}.intermediate.dense"))
        out.update(dense(f"{dst}.output", f"{pre}.output.dense"))
        out.update(dense(f"{dst}.output_ln", f"{pre}.output.LayerNorm"))
    _head(sd, out, projection_key)
    _check_consumed(sd, strict)
    return out


def convert_flash_state_dict(
    state: Mapping[str, "torch.Tensor | np.ndarray"],
    cfg: ColBERTConfig,
    projection_key: Optional[str] = None,
    strict: bool = False,
) -> Dict[str, torch.Tensor]:
    """jina-xlm-roberta rotary flash state_dict -> ``ColBERTModel``
    state_dict.

    Layout (the real jinaai/jina-colbert-v2 backbone):
      embeddings.word_embeddings.weight      (V, H)
      embeddings.token_type_embeddings.weight  (T, H)   [when T > 0]
      emb_ln.{weight,bias}                   (H,)
      encoder.layers.{i}.mixer.Wqkv.{weight (3H, H), bias (3H,)}  fused q;k;v
      encoder.layers.{i}.mixer.out_proj.{weight (H, H), bias}
      encoder.layers.{i}.norm1.{weight,bias}   post-attention LayerNorm
      encoder.layers.{i}.norm2.{weight,bias}   post-MLP LayerNorm
      encoder.layers.{i}.mlp.fc1.{weight (I, H), bias}
      encoder.layers.{i}.mlp.fc2.{weight (H, I), bias}
    No position-embedding table: positions are rotary, applied inside the
    attention (``position_embedding="rope"``, rotate-halves convention,
    ``rope_interleaved=False``). ``rotary_emb.inv_freq`` buffers and the
    pooler are ignored.
    """
    sd = _TrackingDict({_strip(k): _t(v) for k, v in state.items()})
    h = cfg.hidden_size

    def dense(dst: str, src: str) -> Dict[str, torch.Tensor]:
        p = {f"{dst}.weight": sd[f"{src}.weight"]}
        if f"{src}.bias" in sd:
            p[f"{dst}.bias"] = sd[f"{src}.bias"]
        return p

    if cfg.position_embedding == "learned":
        raise ValueError(
            "flash checkpoints are rotary; cfg.position_embedding must be "
            "'rope' (got 'learned')")
    out = _backbone(sd, cfg, "emb_ln")
    for i in range(cfg.num_layers):
        pre, dst = f"encoder.layers.{i}", f"layers.{i}"
        wqkv = sd[f"{pre}.mixer.Wqkv.weight"]          # (3H, H) = [q; k; v]
        bqkv = sd.get(f"{pre}.mixer.Wqkv.bias")        # (3H,)
        for j, name in enumerate(("query", "key", "value")):
            out[f"{dst}.attention.{name}.weight"] = wqkv[j * h:(j + 1) * h]
            if bqkv is not None:
                out[f"{dst}.attention.{name}.bias"] = bqkv[j * h:(j + 1) * h]
        out.update(dense(f"{dst}.attention.out", f"{pre}.mixer.out_proj"))
        out.update(dense(f"{dst}.attention_ln", f"{pre}.norm1"))
        out.update(dense(f"{dst}.intermediate", f"{pre}.mlp.fc1"))
        out.update(dense(f"{dst}.output", f"{pre}.mlp.fc2"))
        out.update(dense(f"{dst}.output_ln", f"{pre}.norm2"))
    _head(sd, out, projection_key)
    _check_consumed(sd, strict)
    return out


def is_flash_layout(state: Mapping[str, object]) -> bool:
    return any(
        _strip(k).startswith("emb_ln.") or ".mixer.Wqkv." in k
        for k in state
    )


def convert_state_dict(
    state: Mapping[str, "torch.Tensor | np.ndarray"],
    cfg: ColBERTConfig,
    projection_key: Optional[str] = None,
    strict: bool = False,
) -> Dict[str, torch.Tensor]:
    """Auto-detect the source naming and convert.

    ``strict=True`` additionally requires every source key to be consumed
    (modulo deliberately-ignored rotary inv_freq buffers and the pooler)."""
    if is_flash_layout(state):
        return convert_flash_state_dict(state, cfg, projection_key, strict)
    return convert_xlmr_state_dict(state, cfg, projection_key, strict)


def colbert_config_from_hf(model_dir: str, **overrides) -> ColBERTConfig:
    """Build a ColBERTConfig from an HF checkpoint dir's config.json.

    Handles both vanilla XLM-RoBERTa configs (absolute positions) and the
    jina-xlm-roberta flash config (``rotary_emb_base`` /
    ``position_embedding_type: "rotary"``). ``overrides`` win over the
    file (e.g. colbert_dim, query/doc token budgets, dtype)."""
    hf = json.loads((Path(model_dir) / "config.json").read_text())
    rotary = ("rotary_emb_base" in hf
              or hf.get("position_embedding_type") in ("rotary", "rope"))
    kw = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf.get("num_hidden_layers", hf.get("num_layers", 24)),
        num_heads=hf.get("num_attention_heads", 16),
        intermediate_size=hf.get("intermediate_size", 4096),
        max_position_embeddings=hf.get("max_position_embeddings", 8194),
        type_vocab_size=hf.get("type_vocab_size", 1),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        pad_token_id=hf.get("pad_token_id", 1),
        position_embedding="rope" if rotary else "learned",
        rope_base=float(hf.get("rotary_emb_base", 10000.0)),
        rope_interleaved=bool(hf.get("rotary_emb_interleaved", False)),
        # ColBERT wrapper configs sometimes carry the projection dim
        colbert_dim=int(hf.get("dim", 128)),
    )
    kw.update(overrides)
    return ColBERTConfig(**kw)


def read_safetensors(path: "str | Path") -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU, in the
    file's dtypes (views of one buffer read from the file)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(Path(path).stat().st_size - 8 - n)
        f.readinto(data)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {info['dtype']!r}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - start != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - start} "
                             f"bytes, its shape {shape} needs "
                             f"{count * dtype.itemsize}")
        out[name] = (torch.frombuffer(data, dtype=dtype, count=count,
                                      offset=start).reshape(shape)
                     if count else torch.empty(shape, dtype=dtype))
    return out


def load_hf_state(model_dir: str) -> Dict[str, torch.Tensor]:
    """The raw state_dict of a local HF checkpoint directory: its
    ``*.safetensors`` shards in sorted order, else its
    ``pytorch_model*.bin`` files."""
    d = Path(model_dir)
    state: Dict[str, torch.Tensor] = {}
    st_files = sorted(d.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            state.update(read_safetensors(f))
        return state
    bins = sorted(d.glob("pytorch_model*.bin"))
    if not bins:
        raise FileNotFoundError(f"no checkpoint files in {model_dir}")
    for f in bins:
        state.update(torch.load(str(f), map_location="cpu",
                                weights_only=True))
    return state


def convert_hf_dir(model_dir: str, cfg: ColBERTConfig
                   ) -> Dict[str, torch.Tensor]:
    """Load a local HF checkpoint directory (safetensors or
    pytorch_model.bin) and convert. Works fully offline when the files
    are present."""
    state = load_hf_state(model_dir)
    proj = next((k for k in ("linear.weight", "colbert_linear.weight")
                 if k in state), None)
    return convert_state_dict(state, cfg, projection_key=proj)
