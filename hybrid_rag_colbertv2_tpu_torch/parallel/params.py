"""Tensor-parallel encoder forward — port of
``hybrid_rag_colbertv2_tpu/parallel/params.py``.

Megatron's layout over the mesh's ``model`` axis, as in JAX:

  * attention query/key/value and the MLP ``intermediate`` are
    column-parallel: model shard ``i`` computes the output features of its
    heads (its ffn columns) from the rows ``[i * w, (i + 1) * w)`` of the
    ``nn.Linear.weight`` (out, in), which are the columns of JAX's (in, out)
    kernel that ``PartitionSpec(None, 'model')`` gives that shard;
  * attention ``out`` and the MLP ``output`` are row-parallel
    (``PartitionSpec('model', None)``): each shard multiplies its slice of
    the input features, and the partial products are summed on the data
    shard's lead device in shard order 0..n-1 (JAX's psum), then the bias
    is added once;
  * embeddings, LayerNorms, biases and ``colbert_linear`` are replicated.

The port is single-controller, as parallel/sharded.py is. A plan holds no
weights: every shard reads a slice of the encoder's own ``Parameter``s (a
view on the parameter's device, a ``.to(dev)`` copy on another), so
autograd sums each shard's gradient into the one full ``Parameter`` and
an optimizer steps it once, in place. Whatever was bound to the encoder
before (a retriever, a captured CUDA graph) keeps seeing its weights.

Column blocks are head-major, so a shard takes whole heads, and RoPE runs
per shard on its own heads. The model axis must divide the heads and the
ffn width (jina-colbert-v2: 16 heads, ffn 4096: 2 or 4 shards).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..models.colbert import _layer_norm, attend, jax_leaves
from .mesh import Mesh


def _placer(dev: torch.device):
    """A parameter (or its slice) on ``dev``: itself where it lives there,
    else a differentiable copy."""
    return lambda t: t if t.device == dev else t.to(dev)


def _column(layer: nn.Linear, x: torch.Tensor, rows: slice,
            dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Column-parallel shard: the output features ``rows`` of ``layer``,
    bias included, cast as ``models/colbert.py::_dense`` casts."""
    put = _placer(dev)
    return nn.functional.linear(x.to(dev).to(dtype),
                                put(layer.weight[rows]).to(dtype),
                                put(layer.bias[rows]).to(dtype))


def _row_partial(layer: nn.Linear, x: torch.Tensor, cols: slice,
                 dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Row-parallel shard: ``x`` times the input features ``cols`` of
    ``layer``, no bias, accumulated in fp32 (bf16 products are exact in
    fp32, as JAX's ``preferred_element_type``)."""
    w = _placer(dev)(layer.weight[:, cols]).to(dtype)
    return nn.functional.linear(x.to(dtype).float(), w.float())


def _sum_then_bias(parts: List[torch.Tensor], bias: torch.Tensor,
                   lead: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """psum of the partial products on ``lead`` in shard order, then the
    bias once (adding it per shard would multiply it by the extent)."""
    acc = parts[0].to(lead)
    for p in parts[1:]:
        acc = acc + p.to(lead)
    return (acc + _placer(lead)(bias).to(dtype).float()).to(dtype)


class TensorParallelPlan:
    """The forward of a ``ColBERTModel`` over a (data, model) ``mesh``.

    Data row ``d`` (``mesh.devices[d]``) runs its rows of a batch with its
    ``model``-axis devices as the tensor-parallel shards, its first device
    as the lead that holds the activations between blocks. With
    ``tensor_parallel=False`` each data row runs the whole model on its
    lead (the trainer's data parallelism over replicated parameters)."""

    def __init__(self, mesh: Mesh, *, tensor_parallel: bool = True,
                 data_axis: str = "data", model_axis: str = "model"):
        self.mesh = mesh
        self.model_axis = model_axis
        a_data = mesh.axis_names.index(data_axis)
        a_model = mesh.axis_names.index(model_axis)
        grid = mesh.devices.transpose(a_data, a_model)
        self.rows: List[List[torch.device]] = [
            list(r) if tensor_parallel else [r[0]] for r in grid]

    @property
    def n_model(self) -> int:
        return len(self.rows[0])

    def check(self, cfg) -> None:
        """JAX's error where a sharded dimension does not divide the model
        axis; whole heads per shard besides."""
        n = self.n_model
        for what, size in (("num_heads", cfg.num_heads),
                           ("hidden_size", cfg.hidden_size),
                           ("intermediate_size", cfg.intermediate_size)):
            if size % n:
                raise ValueError(
                    f"{what}={size} is not divisible by the {n}-way "
                    f"'{self.model_axis}' mesh axis: the tensor-parallel "
                    f"layout shards it over that axis")

    def forward(self, model, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, row: int = 0) -> torch.Tensor:
        """-> (B, L, D) embeddings on data row ``row``'s lead device."""
        devs = self.rows[row]
        lead = devs[0]
        put = _placer(lead)
        ids = input_ids.to(lead)
        amask = attention_mask.to(lead)
        x = model.embed(ids, amask, put)
        mask = amask.to(torch.bool)
        for layer in model.layers:
            x = self._layer(model.cfg, layer, x, mask, devs)
        return model.project(x, ids, amask, put)

    def _layer(self, cfg, layer, x, mask, devs) -> torch.Tensor:
        dt = cfg.dtype
        lead = devs[0]
        n = len(devs)
        b, s, h = x.shape
        heads = cfg.num_heads // n
        dh = h // cfg.num_heads
        w = heads * dh
        att = layer.attention
        parts = []
        for i, dev in enumerate(devs):
            cols = slice(i * w, (i + 1) * w)
            q, k, v = (_column(lin, x, cols, dev, dt).reshape(b, s, heads, dh)
                       for lin in (att.query, att.key, att.value))
            o = attend(cfg, q, k, v, mask.to(dev))
            parts.append(_row_partial(att.out, o, cols, dev, dt))
        a = _sum_then_bias(parts, att.out.bias, lead, dt)
        x = _layer_norm(layer.attention_ln, x + a, dt, _placer(lead))
        wf = cfg.intermediate_size // n
        parts = []
        for i, dev in enumerate(devs):
            cols = slice(i * wf, (i + 1) * wf)
            f = nn.functional.gelu(
                _column(layer.intermediate, x, cols, dev, dt),
                approximate="none")
            parts.append(_row_partial(layer.output, f, cols, dev, dt))
        o = _sum_then_bias(parts, layer.output.bias, lead, dt)
        return _layer_norm(layer.output_ln, x + o, dt, _placer(lead))

    def encode_rows(self, model, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """A global batch split over the data axis (JAX's ``P(data,
        None)``: contiguous row blocks), each block encoded on its data
        row, the embeddings gathered to the mesh's lead in shard order."""
        n_data = len(self.rows)
        rows = input_ids.shape[0]
        if rows % n_data:
            raise ValueError(
                f"the global batch's {rows} rows are not divisible by the "
                f"{n_data}-way 'data' mesh axis")
        per = rows // n_data
        lead = self.rows[0][0]
        outs = [self.forward(model, input_ids[d * per:(d + 1) * per],
                             attention_mask[d * per:(d + 1) * per], row=d)
                for d in range(n_data)]
        return torch.cat([o.to(lead) for o in outs], dim=0)


def _spec_for(names: List[str], ndim: int) -> tuple:
    """JAX's ``_spec_for`` on a flat parameter name split on '/': the
    PartitionSpec entries of a leaf of ``ndim`` dims, Flax (in, out)
    kernels."""
    joined = "/".join(names)
    if ndim != 2:
        return ()
    if "attention" in joined:
        if names[-2] in ("query", "key", "value"):
            return (None, "model")
        if names[-2] == "out":
            return ("model", None)
    if names[-2] == "intermediate":
        return (None, "model")
    if names[-2] == "output":
        return ("model", None)
    return ()


def shard_encoder_params(model, mesh: Mesh):
    """Give ``model`` (a ``ColBERTModel``) the tensor-parallel forward over
    ``mesh``; -> the same model. Its Parameters stay where they are and
    stay the same objects. ``model.tp_plan = None`` undoes it."""
    plan = TensorParallelPlan(mesh)
    plan.check(model.cfg)
    model.tp_plan = plan
    return model


def describe_shardings(model) -> Dict[str, str]:
    """JAX flat parameter name (``models/colbert.py::params_to_jax``) ->
    the leaf's sharding in JAX's words, ``NamedSharding(mesh=Mesh('data':
    2, 'model': 4), spec=PartitionSpec(None, 'model'))``: the model axis
    where JAX's spec has it. A model without a plan is on one device."""
    plan: Optional[TensorParallelPlan] = model.tp_plan
    out = {}
    for name, t in jax_leaves(model):
        if plan is None:
            out[name] = f"SingleDeviceSharding(device={t.device})"
            continue
        spec = ", ".join("None" if a is None else repr(plan.model_axis)
                         for a in _spec_for(name.split("/"), t.dim()))
        mesh = ", ".join(f"{a!r}: {n}" for a, n in plan.mesh.shape.items())
        out[name] = (f"NamedSharding(mesh=Mesh({mesh}), "
                     f"spec=PartitionSpec({spec}))")
    return out
