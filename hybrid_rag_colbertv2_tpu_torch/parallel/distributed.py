"""Multi-host runtime: DCN x ICI meshes and process bootstrap — port of
``hybrid_rag_colbertv2_tpu/parallel/distributed.py``.

The layout rule is JAX's: the fast in-host fabric (NVLink here, ICI on
the TPU) carries the per-query merges of the sharded cascade
(parallel/sharded.py); the slow network between hosts (DCN) carries only
data parallelism — independent query batches, each process holding a
whole replica of the index — with no per-query merge crossing it.
``make_pod_mesh`` builds the corresponding (dcn, data, model) mesh with
the DCN axis outermost.

Nothing on a machine tells a program of its cluster here, so
``initialize_distributed`` takes the coordinator from its arguments or
the environment, and does nothing without one.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import get_logger
from .mesh import Mesh, _device_array, visible_devices

log = get_logger(__name__)


def rank_and_world_size() -> Tuple[int, int]:
    """(rank, world size) under an initialised torch.distributed, else
    (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group (one call per host process).

    The coordinator is ``coordinator_address`` (``host:port``, or an
    ``init_method`` URL such as ``tcp://...`` or ``file://...``), else
    ``COORDINATOR_ADDRESS`` from the environment, else ``MASTER_ADDR``
    (with ``MASTER_PORT``) when ``WORLD_SIZE`` > 1. The world size and
    rank come from the arguments, else ``WORLD_SIZE`` / ``RANK``. The
    backend is nccl on the card, gloo on the CPU. -> True when the group
    is (or already was) up; False, touching nothing, when there is no
    coordinator."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if addr is None and env.get("MASTER_ADDR") and int(
            env.get("WORLD_SIZE", "1")) > 1:
        addr = "env://"
    if not addr:
        return False
    init = addr if "://" in addr else f"tcp://{addr}"
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE", "1")))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    log.info("process group up (%s): process %d/%d, %d local devices",
             backend, dist.get_rank(), dist.get_world_size(),
             len(visible_devices("cuda" if backend == "nccl" else "cpu")))
    return True


def make_pod_mesh(
    dcn_axis: int = -1,              # -1: one DCN slot per process
    ici_shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ("dcn", "data", "model"),
    devices=None,
) -> Mesh:
    """Build a (dcn, data, model) mesh.

    ``dcn_axis`` — DCN (inter-host) partitions; default one per process.
    ``ici_shape`` — (data, model) split of each slot's devices; default
    (devices per slot, 1). ``devices`` default to ``visible_devices()``
    repeated once per process: device names are local to a host, so row
    ``r`` of the DCN axis names process ``r``'s own devices."""
    world = rank_and_world_size()[1]
    n_dcn = world if dcn_axis == -1 else dcn_axis
    if devices is None:
        devices = visible_devices() * (world if dcn_axis == -1 else 1)
    devices = list(devices)
    per_slice = len(devices) // n_dcn
    if ici_shape is None:
        ici_shape = (per_slice, 1)
    if ici_shape[0] * ici_shape[1] != per_slice:
        raise ValueError(
            f"ici_shape {ici_shape} != {per_slice} devices per DCN slot")
    arr = _device_array(devices[: n_dcn * per_slice],
                        (n_dcn, *ici_shape))
    return Mesh(arr, tuple(axis_names))
