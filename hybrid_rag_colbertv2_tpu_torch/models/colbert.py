"""ColBERT late-interaction encoder — port of
``hybrid_rag_colbertv2_tpu/models/colbert.py`` as a PyTorch ``nn.Module``.

An XLM-RoBERTa-family transformer emitting token-level embeddings,
projected to ``colbert_dim`` and L2-normalized, with ColBERT query/doc
marker tokens and query [MASK]-augmentation:
  * post-LayerNorm blocks (attention -> add&norm -> exact-GELU MLP ->
    add&norm), LayerNorm eps from the config (1e-5);
  * positions ``"learned"`` (RoBERTa offset: cumsum(mask)*mask + pad id)
    or ``"rope"`` (both pairings);
  * ``token_type_embeddings`` row 0 is always added;
  * attention bias -1e30 on padded keys, softmax in fp32;
  * a no-bias projection head, the optional lexical anchor, then the L2
    norm with max(norm, 1e-12); padding rows are zeroed (the invariant
    the MaxSim kernels rely on).

Weights load from and save to the JAX package's ``encoder_params.npz``
(flat ``a/b/kernel`` keys) through ``params_from_jax`` and
``params_to_jax``. Activations run in ``ColBERTConfig.dtype``: float32,
or bfloat16 with the JAX package's casts (parameters stay fp32; every
Dense, Embed and LayerNorm yields bf16, LayerNorm computing in fp32; both
attention einsums accumulate in fp32; softmax in fp32, cast to bf16).
TF32 is turned off for matmuls and convolutions
(utils/device.set_fp32_matmul_exact).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device, set_fp32_matmul_exact
from ..utils.logging import get_logger

log = get_logger(__name__)

# maps a parameter to the device a product runs on (identity on one device)
Placer = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class ColBERTConfig:
    vocab_size: int = 250002
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 8194
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    colbert_dim: int = 128
    position_embedding: str = "rope"   # "rope" | "learned"
    rope_base: float = 10000.0
    # False = rotate the two HALVES of the head dim (GPT-NeoX, the
    # jina-xlm-roberta convention); True = even/odd PAIRS (GPT-J)
    rope_interleaved: bool = False
    pad_token_id: int = 1              # RoBERTa convention
    query_max_tokens: int = 32
    doc_max_tokens: int = 256
    dtype: torch.dtype = torch.float32     # activations (encoder_dtype)
    # > 0: gated per-token-id anchor added before the final L2 norm
    # (see the JAX ColBERTConfig.lexical_anchor)
    lexical_anchor: float = 0.0

    @classmethod
    def jina_colbert_v2(cls, **kw) -> "ColBERTConfig":
        """Shape of jinaai/jina-colbert-v2 (560M backbone, 128-d head)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ColBERTConfig":
        """Small config for tests / self-contained corpora."""
        base = dict(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=512,
            colbert_dim=32, position_embedding="learned",
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def small(cls, **kw) -> "ColBERTConfig":
        """Self-contained 'local' encoder: 4L x 256H, 128-d head, rope."""
        base = dict(
            vocab_size=32768, hidden_size=256, num_layers=4, num_heads=8,
            intermediate_size=1024, max_position_embeddings=1024,
            colbert_dim=128, position_embedding="rope",
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def base(cls, **kw) -> "ColBERTConfig":
        """2x-deeper self-contained encoder: 8L x 384H."""
        base = dict(
            vocab_size=32768, hidden_size=384, num_layers=8, num_heads=6,
            intermediate_size=1536, max_position_embeddings=1024,
            colbert_dim=128, position_embedding="rope",
        )
        base.update(kw)
        return cls(**base)


def _rope_cache(seq_len: int, head_dim: int, base: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv = 1.0 / (base ** exps)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                     # (S, head_dim/2)
    return torch.cos(freqs), torch.sin(freqs)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                interleaved: bool = False) -> torch.Tensor:
    """x: (B, S, H, Dh) — rotary position embedding."""
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    if interleaved:
        x1 = x[..., 0::2]
        x2 = x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                           dim=-1).reshape(x.shape)
    half = x.shape[-1] // 2
    x1 = x[..., :half]
    x2 = x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
           place: Placer = _same) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype``, the product in it. ``place`` maps each parameter to the
    device the product runs on (parallel/params.py; identity here)."""
    bias = None if layer.bias is None else place(layer.bias).to(dtype)
    return nn.functional.linear(x.to(dtype), place(layer.weight).to(dtype),
                                bias)


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype,
                place: Placer = _same) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: statistics and the affine in
    fp32, the result cast to ``dtype``."""
    return nn.functional.layer_norm(
        x.to(torch.float32), layer.normalized_shape, place(layer.weight),
        place(layer.bias), layer.eps).to(dtype)


def attend(cfg: "ColBERTConfig", q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Self-attention over the heads given: q, k, v (B, S, heads, Dh) in
    the activation dtype, ``mask`` (B, S) bool on the keys ->
    (B, S, heads * Dh). Every head is independent, so a tensor-parallel
    shard runs this on its own heads (parallel/params.py)."""
    dt = cfg.dtype
    b, s, nh, dh = q.shape
    if cfg.position_embedding == "rope":
        # fp32 tables: the rotated q, k come out fp32, as in JAX
        cos, sin = _rope_cache(s, dh, cfg.rope_base, q.device)
        q = _apply_rope(q, cos, sin, cfg.rope_interleaved)
        k = _apply_rope(k, cos, sin, cfg.rope_interleaved)
    # both einsums accumulate in fp32 (preferred_element_type): bf16
    # products are exact in fp32
    f32 = torch.float32
    att = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32))
    att = att / float(np.sqrt(dh))
    bias = torch.where(mask[:, None, None, :], 0.0, -1e30)
    att = torch.softmax(att + bias, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", att.to(f32), v.to(f32))
    return out.to(dt).reshape(b, s, nh * dh)


class SelfAttention(nn.Module):
    def __init__(self, cfg: ColBERTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, s, h = x.shape
        nh = cfg.num_heads
        dh = h // nh
        q = _dense(self.query, x, dt).reshape(b, s, nh, dh)
        k = _dense(self.key, x, dt).reshape(b, s, nh, dh)
        v = _dense(self.value, x, dt).reshape(b, s, nh, dh)
        return _dense(self.out, attend(cfg, q, k, v, mask), dt)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ColBERTConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.attention_ln = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.output_ln = nn.LayerNorm(cfg.hidden_size,
                                      eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = _layer_norm(self.attention_ln, x + self.attention(x, mask), dt)
        f = nn.functional.gelu(_dense(self.intermediate, x, dt),
                               approximate="none")
        return _layer_norm(self.output_ln, x + _dense(self.output, f, dt),
                           dt)


class ColBERTModel(nn.Module):
    """Backbone + projection head -> L2-normalized token embeddings with
    padding rows zeroed."""

    def __init__(self, cfg: ColBERTConfig):
        super().__init__()
        if cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"encoder activations run in float32 or "
                             f"bfloat16, not {cfg.dtype}")
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        if cfg.position_embedding == "learned":
            self.position_embeddings = nn.Embedding(
                cfg.max_position_embeddings, cfg.hidden_size)
        if cfg.type_vocab_size:
            self.token_type_embeddings = nn.Embedding(
                cfg.type_vocab_size, cfg.hidden_size)
        self.embeddings_ln = nn.LayerNorm(cfg.hidden_size,
                                          eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.colbert_linear = nn.Linear(cfg.hidden_size, cfg.colbert_dim,
                                        bias=False)
        if cfg.lexical_anchor > 0.0:
            self.anchor_embeddings = nn.Embedding(cfg.vocab_size,
                                                  cfg.colbert_dim)
            self.anchor_gate = nn.Parameter(
                torch.tensor(cfg.lexical_anchor, dtype=torch.float32))
        # a forward plan over these Parameters, or None
        # (parallel/params.py::shard_encoder_params)
        self.tp_plan = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (the JAX package's flax
        defaults in scale: N(0, 1/fan_in) kernels, zero biases,
        N(0, 1/H) embeddings, unit LayerNorm)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.normal_(m.weight, 0.0, m.in_features ** -0.5,
                                    generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.Embedding):
                    nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5,
                                    generator=generator)
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            if self.cfg.lexical_anchor > 0.0:
                self.anchor_gate.fill_(self.cfg.lexical_anchor)

    def embed(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
              place: Placer = _same) -> torch.Tensor:
        """Token + position + type embeddings and their LayerNorm."""
        cfg = self.cfg
        dt = cfg.dtype
        # flax Embed(dtype=dt) casts the table; the rows it gathers are
        # the same values
        emb = nn.functional.embedding
        x = emb(input_ids, place(self.word_embeddings.weight)).to(dt)
        if cfg.position_embedding == "learned":
            m = attention_mask.to(torch.int64)
            positions = torch.cumsum(m, dim=1) * m + cfg.pad_token_id
            x = x + emb(positions,
                        place(self.position_embeddings.weight)).to(dt)
        if cfg.type_vocab_size:
            x = x + place(self.token_type_embeddings.weight)[0].to(dt)
        return _layer_norm(self.embeddings_ln, x, dt, place)

    def project(self, x: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, place: Placer = _same
                ) -> torch.Tensor:
        """The projection head, the lexical anchor, the L2 norm and the
        zeroed padding rows."""
        cfg = self.cfg
        dt = cfg.dtype
        emb = _dense(self.colbert_linear, x, dt, place)
        if cfg.lexical_anchor > 0.0:
            emb = emb / torch.clamp(
                torch.linalg.vector_norm(emb, dim=-1, keepdim=True),
                min=1e-12)
            emb = emb + (place(self.anchor_gate).to(dt)
                         * nn.functional.embedding(
                             input_ids,
                             place(self.anchor_embeddings.weight)).to(dt))
        emb = emb / torch.clamp(
            torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
        return emb * attention_mask[..., None].to(emb.dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        if self.tp_plan is not None:
            # tensor-parallel forward over the same Parameters
            # (parallel/params.py::shard_encoder_params)
            return self.tp_plan.forward(self, input_ids, attention_mask)
        x = self.embed(input_ids, attention_mask)
        mask = attention_mask.to(torch.bool)
        for layer in self.layers:
            x = layer(x, mask)
        return self.project(x, input_ids, attention_mask)


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX ``encoder_params.npz`` keys -> a ``ColBERTModel`` state_dict.

    Flax ``Dense`` kernels are (in, out) and transpose into
    ``nn.Linear.weight`` (out, in); ``Embed/embedding`` and LayerNorm
    ``scale`` map to ``weight``; ``layer_{i}`` becomes ``layers.{i}``."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        leaf = parts[-1]
        mods = parts[:-1]
        if mods and mods[0].startswith("layer_"):
            mods = ["layers", mods[0][len("layer_"):]] + mods[1:]
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":
            name, t = "weight", t.T.contiguous()
        elif leaf in ("embedding", "scale"):
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        elif key == "anchor_gate":
            out["anchor_gate"] = t.reshape(())
            continue
        else:
            raise KeyError(f"unknown encoder parameter {key!r}")
        out[".".join(mods + [name])] = t
    return out


def jax_leaves(model: nn.Module):
    """-> [(JAX flat name, parameter)] in ``params_to_jax``'s order: an
    ``nn.Linear.weight`` is the Flax ``kernel`` (transposed there), an
    Embedding's weight ``embedding``, a LayerNorm's ``scale``;
    ``layers.{i}`` is ``layer_{i}``."""
    leaves = {nn.Linear: {"weight": "kernel", "bias": "bias"},
              nn.Embedding: {"weight": "embedding"},
              nn.LayerNorm: {"weight": "scale", "bias": "bias"}}
    out = []
    for name, mod in model.named_modules():
        names = leaves.get(type(mod))
        if names is None:
            continue
        path = name.split(".")
        if path[0] == "layers":
            path = [f"layer_{path[1]}"] + path[2:]
        for attr, leaf in names.items():
            t = getattr(mod, attr)
            if t is not None:
                out.append(("/".join(path + [leaf]), t))
    if hasattr(model, "anchor_gate"):
        out.append(("anchor_gate", model.anchor_gate))
    return out


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """A ``ColBERTModel``'s parameters -> the JAX ``encoder_params.npz``
    keys, the inverse of ``params_from_jax`` (names from ``jax_leaves``;
    kernels transposed to (in, out)); every array fp32."""
    out: Dict[str, np.ndarray] = {}
    for name, t in jax_leaves(model):
        a = t.detach().to(torch.float32).cpu().numpy()
        out[name] = a.T.copy() if name.endswith("/kernel") else a
    return out


class ColBERTEncoder:
    """Tokenization + the ColBERT protocol around ``ColBERTModel``.

      query: [CLS] [Q] q1..qn [SEP] [MASK]... padded to query_max_tokens,
             all positions attend (query augmentation);
      doc:   [CLS] [D] d1..dn [SEP], padded, padding masked out.

    Runs on ``device`` (default the card; raises without one). ``params``
    is a state_dict (``load_params`` / ``params_from_jax``); without it
    the weights are random from a ``torch.Generator`` seeded by ``seed``.
    """

    def __init__(
        self,
        config: ColBERTConfig,
        tokenizer,                      # models/tokenizer.ColBERTTokenizer
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        doc_batch_size: int = 32,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        set_fp32_matmul_exact()
        self.cfg = config
        self.tokenizer = tokenizer
        self.doc_batch_size = doc_batch_size
        if params is None:
            self.model = ColBERTModel(config)
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
            log.info("ColBERTEncoder: random-initialized params "
                     "(%d layers, H=%d)", config.num_layers,
                     config.hidden_size)
        else:
            # no default init of weights about to be overwritten (at the
            # jina width that init alone takes seconds on the host)
            with torch.device("meta"):
                self.model = ColBERTModel(config)
            self.model.to_empty(device=self.device)
            self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    # -- public API -------------------------------------------------------
    @torch.inference_mode()
    def encode_query_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, Lq) token ids on the device -> (B, Lq, D); every position
        attends (query augmentation)."""
        return self.model(ids, torch.ones_like(ids))

    def encode_queries(self, texts: Sequence[str]) -> torch.Tensor:
        """-> (B, Lq, D); every row L2-normalized."""
        lq = self.cfg.query_max_tokens
        ids = np.stack([self.tokenizer.encode_query(t, lq) for t in texts])
        ids = torch.as_tensor(ids, device=self.device)
        return self.encode_query_ids(ids)

    @torch.inference_mode()
    def encode_docs(self, texts: Sequence[str], doc_len: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (token_embs (N, L, D), lengths (N,) int32), on the device."""
        l = doc_len or self.cfg.doc_max_tokens
        all_embs, lengths = [], []
        for i in range(0, len(texts), self.doc_batch_size):
            batch = texts[i:i + self.doc_batch_size]
            ids, ns = self.tokenizer.encode_docs(batch, l)
            mask = (np.arange(l)[None, :] < ns[:, None]).astype(np.int32)
            lengths.extend(int(n) for n in ns)
            all_embs.append(self.model(
                torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device)))
        if not all_embs:
            return (torch.zeros((0, l, self.cfg.colbert_dim),
                                device=self.device),
                    torch.zeros((0,), dtype=torch.int32, device=self.device))
        full = sum(1 for n in lengths if n >= l)
        if full:
            log.warning(
                "%d/%d docs hit the doc token budget (doc_max_tokens=%d) — "
                "the dense index sees only their prefix", full, len(texts), l)
        return (torch.cat(all_embs, dim=0),
                torch.as_tensor(np.array(lengths, np.int32),
                                device=self.device))

    # -- persistence -------------------------------------------------------
    def save_params(self, path: str) -> None:
        """Write the JAX package's ``encoder_params.npz`` (flat ``a/b/c``
        keys, Dense kernels (in, out)): either package loads it."""
        np.savez(path, **params_to_jax(self.model))

    @staticmethod
    def load_params(path: str) -> Dict[str, torch.Tensor]:
        """The JAX package's ``encoder_params.npz`` -> a state_dict."""
        with np.load(path) as arrs:
            return params_from_jax({k: arrs[k] for k in arrs.files})

    def config_dict(self) -> Dict:
        d = dataclasses.asdict(self.cfg)
        d.pop("dtype", None)
        return d
