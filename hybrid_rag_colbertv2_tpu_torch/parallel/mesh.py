"""Device mesh + index sharding layout — port of
``hybrid_rag_colbertv2_tpu/parallel/mesh.py``.

One process drives every shard (single-controller, as the JAX app does on
one host and as FAISS's ``IndexShards`` does on GPUs). A ``Mesh`` names
the devices of a (data, model) grid; the ``data`` axis shards the
*document* dimension of the dense index: shard ``s`` owns docs
``[s * n_local, (s + 1) * n_local)`` and lives on ``mesh.devices[s, 0]``.
Queries and the small BM25 CSR stay on the lead device (the mesh's first).
The model axis replicates, as JAX's ``shard_map`` over ``"data"`` does.

A mesh may repeat a device: ``[torch.device("cpu")] * 8`` is the port's
counterpart of ``--xla_force_host_platform_device_count=8``, and
``[cuda:0] * 4`` runs four shards on one card. Where a shard's device is
the source index's, its tensors are views of the source (no copy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MeshConfig
from ..index.bucketed import BucketedDenseIndex
from ..index.dense import DenseTokenIndex
from ..utils.device import DeviceLike, resolve_device


def visible_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices a mesh may span: every card for a CUDA ``device`` (the
    default; raises without one), the CPU alone for a CPU ``device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def _device_array(devices: Sequence[torch.device], shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr.reshape(shape)


@dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices (``jax.sharding.Mesh``'s shape and names).
    Hashable, so it keys the sharded cascade's cache."""

    devices: np.ndarray               # torch.device objects, mesh shape
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (tuple(self.devices.flat), self.devices.shape,
                tuple(self.axis_names))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The devices along ``axis``, index 0 on every other axis."""
        a = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for s in range(self.devices.shape[a]):
            idx[a] = s
            out.append(self.devices[tuple(idx)])
        return out

    @property
    def lead(self) -> torch.device:
        """The device that holds the queries, the merge and the fusion."""
        return self.devices.flat[0]


def make_mesh(mesh_cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh of ``mesh_cfg``'s shape over ``devices``
    (default ``visible_devices()``)."""
    mesh_cfg = mesh_cfg or MeshConfig()
    devices = list(devices if devices is not None else visible_devices())
    shape = mesh_cfg.resolved_mesh_shape(len(devices))
    if shape[0] * shape[1] > len(devices):
        raise ValueError(f"mesh {shape} needs more than {len(devices)} devices")
    return Mesh(_device_array(devices[: shape[0] * shape[1]], shape),
                tuple(mesh_cfg.axis_names))


def _slice(t: Optional[torch.Tensor], start: int, stop: int,
           dev: torch.device, dim: int = 0) -> Optional[torch.Tensor]:
    """``t``'s [start, stop) on ``dim``, on ``dev``: a view where ``dev``
    is ``t``'s device and ``dim`` is 0; a minor-axis slice is made
    contiguous (the kernels' operand check needs it)."""
    if t is None:
        return None
    part = t.narrow(dim, start, stop - start)
    if dim != 0:
        part = part.contiguous()
    return part.to(dev)


@dataclass
class ShardedDenseIndex:
    """A flat dense index cut on its doc axis: one ``DenseTokenIndex``
    per data-axis shard, each on its device, plus the global geometry."""

    shards: List[DenseTokenIndex]
    devices: List[torch.device]
    n_docs: int
    n_pad: int
    doc_len: int
    dim: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_local(self) -> int:
        return self.n_pad // self.n_shards

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def is_int8(self) -> bool:
        return self.shards[0].is_int8

    @property
    def quant(self) -> str:
        return self.shards[0].quant

    @property
    def has_doc_scales(self) -> bool:
        return self.shards[0].doc_scales is not None

    @property
    def has_group_scales(self) -> bool:
        return self.has_doc_scales and self.shards[0].doc_scales.dim() == 2

    def full(self) -> DenseTokenIndex:
        """The shards concatenated back into one index on the lead device."""
        lead = self.lead

        def cat(name, dim=0):
            parts = [getattr(s, name) for s in self.shards]
            if any(p is None for p in parts):
                return None
            return torch.cat([p.to(lead) for p in parts], dim=dim)
        ds = self.shards[0].doc_scales
        return DenseTokenIndex(
            emb_flat=cat("emb_flat"), doc_lengths=cat("doc_lengths"),
            n_docs=self.n_docs, doc_len=self.doc_len, dim=self.dim,
            scales=cat("scales"), pooled=cat("pooled"),
            doc_scales=cat("doc_scales",
                           dim=ds.dim() - 1 if ds is not None else 0))


def shard_dense_index(dense: DenseTokenIndex, mesh: Mesh,
                      axis: str = "data") -> ShardedDenseIndex:
    """Cut ``dense`` on its doc axis over ``axis``.

    The index builder pads n_docs to a multiple of 128, which divides
    evenly for any power-of-two shard count <= 128."""
    n_shards = mesh.shape[axis]
    if dense.n_pad % n_shards != 0:
        raise ValueError(
            f"n_pad={dense.n_pad} not divisible by {n_shards} shards")
    n_local = dense.n_pad // n_shards
    rpd = dense.doc_len // 2 if dense.is_int4 else dense.doc_len
    ds = dense.doc_scales
    shards = []
    devices = mesh.axis_devices(axis)
    for s, dev in enumerate(devices):
        a, b = s * n_local, (s + 1) * n_local
        shards.append(DenseTokenIndex(
            emb_flat=_slice(dense.emb_flat, a * rpd, b * rpd, dev),
            doc_lengths=_slice(dense.doc_lengths, a, b, dev),
            n_docs=max(0, min(n_local, dense.n_docs - a)),
            doc_len=dense.doc_len, dim=dense.dim,
            scales=_slice(dense.scales, a * dense.doc_len,
                          b * dense.doc_len, dev),
            pooled=_slice(dense.pooled, a, b, dev),
            # int4-doc group scales (G, N): the doc axis is MINOR (axis 1)
            doc_scales=_slice(ds, a, b, dev,
                              dim=ds.dim() - 1 if ds is not None else 0)))
    return ShardedDenseIndex(shards=shards, devices=devices,
                             n_docs=dense.n_docs, n_pad=dense.n_pad,
                             doc_len=dense.doc_len, dim=dense.dim)


@dataclass
class ShardedBucketedIndex:
    """A bucketed index with every bucket cut on its doc axis; each
    bucket's ``global_ids`` cut the same way, so a shard maps its local
    rows to corpus ids alone. ``bucket_of`` / ``row_of`` (N,) stay on the
    lead device."""

    buckets: List[ShardedDenseIndex]
    global_ids: List[List[torch.Tensor]]   # [bucket][shard] (n_local_b,)
    bucket_of: torch.Tensor
    row_of: torch.Tensor
    n_docs: int

    @property
    def devices(self) -> List[torch.device]:
        return self.buckets[0].devices

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def n_shards(self) -> int:
        return self.buckets[0].n_shards

    def full(self) -> BucketedDenseIndex:
        lead = self.lead
        return BucketedDenseIndex(
            buckets=[b.full() for b in self.buckets],
            global_ids=[torch.cat([g.to(lead) for g in gs])
                        for gs in self.global_ids],
            bucket_of=self.bucket_of, row_of=self.row_of,
            n_docs=self.n_docs)


def shard_bucketed_index(bidx: BucketedDenseIndex, mesh: Mesh,
                         axis: str = "data") -> ShardedBucketedIndex:
    """Shard every bucket's doc axis over ``axis`` (``shard_dense_index``
    per bucket) and each bucket's ``global_ids`` with it."""
    devices = mesh.axis_devices(axis)
    lead = mesh.lead
    subs = [shard_dense_index(b, mesh, axis) for b in bidx.buckets]
    gids = []
    for sub, g in zip(subs, bidx.global_ids):
        n_local = sub.n_local
        gids.append([_slice(g, s * n_local, (s + 1) * n_local, dev)
                     for s, dev in enumerate(devices)])
    return ShardedBucketedIndex(
        buckets=subs, global_ids=gids, bucket_of=bidx.bucket_of.to(lead),
        row_of=bidx.row_of.to(lead), n_docs=bidx.n_docs)
