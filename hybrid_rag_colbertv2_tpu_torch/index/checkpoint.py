"""Sharded index checkpoints — port of
``hybrid_rag_colbertv2_tpu/index/checkpoint.py``.

The npz persistence in dense.py moves every array through one host;
at scale the index exists only cut across devices, and a checkpoint
should be written and read per shard. JAX writes orbax/tensorstore
checkpoints; neither package is available to the port, so the port
writes its own torch-native layout under ``<path>/shards/``:

  * ``meta.json``: the JAX ``meta.json`` keys (n_docs, doc_len, dim,
    dtype, n_pad, has_scales, has_pooled, has_doc_scales,
    doc_scale_groups, emb_rows, emb_width) plus ``n_shards``;
  * ``<array>.<s>.npy`` for each array and each saved shard ``s``: the
    doc range ``[s * n_pad / S, (s + 1) * n_pad / S)`` of that array on
    its doc axis (axis 1 for the int4-doc group scales). bf16 is stored
    as its uint16 bits, as ``dense.npz`` stores it.

Loading reads only each target shard's doc range, through
``np.load(mmap_mode="r")``, so a checkpoint saved at S shards loads onto
a mesh of any shard count that divides ``n_pad``, or onto one device.

The port reads no orbax checkpoint (a directory holding only JAX's
``orbax/`` raises), so JAX's branches for orbax files of retired layouts
(the feature-halves int4 width and the round-4 per-doc int4 scales) have
no counterpart here.

Under ``torch.distributed`` with a world size above 1, every process
holds a whole replica of the index (JAX's DCN rule: only data
parallelism crosses hosts), so rank 0 alone writes and the others wait
at a barrier.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

from ..parallel.distributed import rank_and_world_size
from ..utils.device import DeviceLike, resolve_device
from .bucketed import BucketedDenseIndex
from .dense import DenseTokenIndex

_DIR = "shards"
_DTYPES = {torch.int8: "int8", torch.bfloat16: "bfloat16",
           torch.float32: "float32", torch.int32: "int32"}


def _ckpt_dir(path) -> Path:
    return Path(path).absolute() / _DIR


def _barrier() -> None:
    if rank_and_world_size()[1] > 1:
        torch.distributed.barrier()


def _check_not_orbax(path) -> None:
    root = Path(path).absolute()
    if not (root / _DIR / "meta.json").exists() and (root / "orbax").is_dir():
        raise ValueError(
            f"{root} holds a JAX orbax checkpoint; the PyTorch port reads "
            "no orbax checkpoint. Share the index through dense.npz "
            "(DenseTokenIndex.save / load, which both packages read) or "
            "rebuild it from the chunk store")


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_np(a: np.ndarray, dtype: str, dev: torch.device) -> torch.Tensor:
    a = np.array(a)     # read out of the memory map into owned memory
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _shards_of(index) -> List[DenseTokenIndex]:
    """A sharded index's shards, or a plain index as one shard."""
    return list(getattr(index, "shards", [index]))


def _arrays(shard: DenseTokenIndex) -> Dict[str, torch.Tensor]:
    """The arrays a shard holds, by name."""
    return {name: getattr(shard, name)
            for name in ("emb_flat", "doc_lengths", "scales", "pooled",
                         "doc_scales")
            if getattr(shard, name) is not None}


def save_sharded(dense, path) -> None:
    """Save a ``DenseTokenIndex`` (one shard) or a ``ShardedDenseIndex``
    (one file per array per shard)."""
    rank, _ = rank_and_world_size()
    shards = _shards_of(dense)
    d = _ckpt_dir(path)
    if rank == 0:
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        first = shards[0]
        ds = first.doc_scales
        n_pad = sum(s.n_pad for s in shards)
        meta = {
            "n_docs": dense.n_docs,
            "doc_len": first.doc_len,
            "dim": first.dim,
            "dtype": _DTYPES[first.emb_flat.dtype],
            "n_pad": n_pad,
            "has_scales": first.scales is not None,
            "has_pooled": first.pooled is not None,
            "has_doc_scales": ds is not None,
            # int4-doc group scales are (G, n_pad) with the doc axis MINOR
            "doc_scale_groups": (int(ds.shape[0])
                                 if ds is not None and ds.dim() == 2 else 0),
            # nibble-packed "int4-doc" stores L/2 full-width pair-rows
            # per doc (emb_rows < n_pad * doc_len)
            "emb_rows": sum(int(s.emb_flat.shape[0]) for s in shards),
            "emb_width": int(first.emb_flat.shape[-1]),
            "n_shards": len(shards),
            "arrays": {name: _DTYPES[t.dtype]
                       for name, t in _arrays(first).items()},
        }
        for s, shard in enumerate(shards):
            for name, t in _arrays(shard).items():
                np.save(d / f"{name}.{s}.npy", _to_np(t))
        # the metadata last: a directory without it is not a checkpoint
        (d / "meta.json").write_text(json.dumps(meta))
    _barrier()


def _read_range(d: Path, name: str, n_src: int, per_src: int, lo: int,
                hi: int, axis: int) -> np.ndarray:
    """Doc-axis units [lo, hi) of array ``name`` saved as ``n_src``
    files of ``per_src`` units each, read through memory maps."""
    parts = []
    for s in range(lo // per_src, (hi - 1) // per_src + 1):
        a = np.load(d / f"{name}.{s}.npy", mmap_mode="r")
        base = s * per_src
        a_lo, a_hi = max(lo, base) - base, min(hi, base + per_src) - base
        parts.append(a[a_lo:a_hi] if axis == 0 else a[:, a_lo:a_hi])
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)


def _load_range(d: Path, meta: dict, lo: int, hi: int, n_docs_local: int,
                dev: torch.device) -> DenseTokenIndex:
    """Docs [lo, hi) of the checkpoint in ``d`` as one index on ``dev``."""
    n_src, n_pad, doc_len = meta["n_shards"], meta["n_pad"], meta["doc_len"]
    per_src = n_pad // n_src
    rows_per_doc = meta["emb_rows"] // n_pad
    out = {}
    for name, dtype in meta["arrays"].items():
        # doc axis units per doc: stored rows, token rows, or one
        unit = {"emb_flat": rows_per_doc,
                "scales": doc_len}.get(name, 1)
        axis = 1 if name == "doc_scales" and meta["doc_scale_groups"] else 0
        arr = _read_range(d, name, n_src, per_src * unit, lo * unit,
                          hi * unit, axis)
        out[name] = _from_np(arr, dtype, dev)
    return DenseTokenIndex(
        emb_flat=out["emb_flat"], doc_lengths=out["doc_lengths"],
        n_docs=n_docs_local, doc_len=doc_len, dim=meta["dim"],
        scales=out.get("scales"), pooled=out.get("pooled"),
        doc_scales=out.get("doc_scales"))


def load_sharded(path, mesh=None, axis: str = "data",
                 device: DeviceLike = None):
    """Restore a dense index cut over ``mesh``'s ``axis`` (a
    ``ShardedDenseIndex``), or whole on ``device`` (default the card)
    when ``mesh`` is None (a ``DenseTokenIndex``). Each target shard
    reads only its doc range."""
    from ..parallel.mesh import ShardedDenseIndex

    _check_not_orbax(path)
    d = _ckpt_dir(path)
    meta = json.loads((d / "meta.json").read_text())
    n_docs, n_pad = meta["n_docs"], meta["n_pad"]
    if mesh is None:
        return _load_range(d, meta, 0, n_pad, n_docs, resolve_device(device))
    devices = mesh.axis_devices(axis)
    if n_pad % len(devices):
        raise ValueError(
            f"n_pad={n_pad} not divisible by {len(devices)} shards")
    n_local = n_pad // len(devices)
    shards = [_load_range(d, meta, s * n_local, (s + 1) * n_local,
                          max(0, min(n_local, n_docs - s * n_local)), dev)
              for s, dev in enumerate(devices)]
    return ShardedDenseIndex(shards=shards, devices=devices, n_docs=n_docs,
                             n_pad=n_pad, doc_len=meta["doc_len"],
                             dim=meta["dim"])


def save_sharded_bucketed(bidx, path) -> None:
    """Sharded checkpoint of a length-bucketed index (a
    ``BucketedDenseIndex`` or a ``ShardedBucketedIndex``): one sharded
    checkpoint per bucket under ``bucket<i>/``, each bucket's
    ``global_ids`` one file per shard beside its arrays, and the routing
    arrays (``bucket_of``, ``row_of``) under ``routing/``."""
    rank, _ = rank_and_world_size()
    root = Path(path).absolute()
    gids = [g if isinstance(g, list) else [g] for g in bidx.global_ids]
    for bi, b in enumerate(bidx.buckets):
        save_sharded(b, root / f"bucket{bi}")
        if rank == 0:
            d = _ckpt_dir(root / f"bucket{bi}")
            for s, g in enumerate(gids[bi]):
                np.save(d / f"global_ids.{s}.npy", _to_np(g))
    if rank == 0:
        routing = root / "routing"
        routing.mkdir(parents=True, exist_ok=True)
        np.save(routing / "bucket_of.npy", _to_np(bidx.bucket_of))
        np.save(routing / "row_of.npy", _to_np(bidx.row_of))
        (root / "meta.json").write_text(json.dumps(
            {"n_docs": bidx.n_docs, "n_buckets": len(bidx.buckets)}))
    _barrier()


def load_sharded_bucketed(path, mesh=None, axis: str = "data",
                          device: DeviceLike = None):
    """Restore a bucketed index with every bucket's doc axis cut over
    ``mesh``'s ``axis`` (a ``ShardedBucketedIndex``; the routing arrays
    on the lead device), or whole on ``device`` when ``mesh`` is None (a
    ``BucketedDenseIndex``)."""
    from ..parallel.mesh import ShardedBucketedIndex

    root = Path(path).absolute()
    meta = json.loads((root / "meta.json").read_text())
    buckets = [load_sharded(root / f"bucket{bi}", mesh=mesh, axis=axis,
                            device=device)
               for bi in range(meta["n_buckets"])]
    gids: List[Union[torch.Tensor, List[torch.Tensor]]] = []
    for bi, b in enumerate(buckets):
        d = _ckpt_dir(root / f"bucket{bi}")
        m = json.loads((d / "meta.json").read_text())
        per_src = m["n_pad"] // m["n_shards"]
        if mesh is None:
            gids.append(_from_np(_read_range(
                d, "global_ids", m["n_shards"], per_src, 0, m["n_pad"], 0),
                "int32", b.device))
        else:
            n_local = b.n_local
            gids.append([_from_np(_read_range(
                d, "global_ids", m["n_shards"], per_src, s * n_local,
                (s + 1) * n_local, 0), "int32", dev)
                for s, dev in enumerate(b.devices)])
    lead = mesh.lead if mesh is not None else resolve_device(device)
    routing = root / "routing"
    bucket_of = _from_np(np.load(routing / "bucket_of.npy"), "int32", lead)
    row_of = _from_np(np.load(routing / "row_of.npy"), "int32", lead)
    cls = BucketedDenseIndex if mesh is None else ShardedBucketedIndex
    return cls(buckets=buckets, global_ids=gids, bucket_of=bucket_of,
               row_of=row_of, n_docs=meta["n_docs"])

