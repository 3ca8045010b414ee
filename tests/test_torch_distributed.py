"""The port's pod-scale helpers (parallel/distributed.py), case for case
as ``tests/test_distributed.py`` holds JAX's, on the CPU: no process
group without a coordinator, the (dcn, data, model) mesh shapes, data
parallelism over the DCN axis with the merge only over ``data``, and a
2-process gloo group (a file store) in which rank 0 alone writes a
sharded checkpoint."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from hybrid_rag_colbertv2_tpu_torch.ops.topk import top_k
from hybrid_rag_colbertv2_tpu_torch.parallel.distributed import (
    initialize_distributed, make_pod_mesh)
from hybrid_rag_colbertv2_tpu_torch.parallel.sharded import merge_shard_topk

REPO = Path(__file__).resolve().parents[1]
CPU8 = [torch.device("cpu")] * 8


def test_single_host_initialize_is_noop(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    # MASTER_ADDR alone names no group to join
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert initialize_distributed() is False


def test_pod_mesh_shape_and_axes():
    mesh = make_pod_mesh(dcn_axis=2, ici_shape=(2, 2), devices=CPU8)
    assert mesh.devices.shape == (2, 2, 2)
    assert mesh.axis_names == ("dcn", "data", "model")


def test_pod_mesh_defaults_single_process():
    mesh = make_pod_mesh(devices=CPU8)     # 1 process -> dcn axis of 1
    assert mesh.devices.shape == (1, 8, 1)
    assert mesh.shape == {"dcn": 1, "data": 8, "model": 1}


def test_dcn_data_parallel_queries_merge_over_data_only():
    """DP over the dcn axis (independent query batches), the doc axis cut
    over ``data`` and merged over it alone — the pod layout rule."""
    mesh = make_pod_mesh(dcn_axis=2, ici_shape=(4, 1), devices=CPU8)
    n_local = 8
    scores = torch.arange(2 * 4 * n_local, dtype=torch.float32).reshape(
        2, 4 * n_local)                   # (dcn batch, docs)
    out = []
    for r in range(mesh.shape["dcn"]):     # each replica its own queries
        vals, ids = [], []
        for s in range(mesh.shape["data"]):
            dev = mesh.devices[r, s, 0]
            local = scores[r:r + 1, s * n_local:(s + 1) * n_local].to(dev)
            lv, li = top_k(local, 2)
            vals.append(lv)
            ids.append(li + s * n_local)
        out.append(merge_shard_topk(vals, ids, 2, mesh.devices[r, 0, 0])[1])
    out = torch.cat(out).numpy()
    # each dcn replica got the global argmax of ITS batch, no cross-dcn mix
    assert out.shape == (2, 2)
    np.testing.assert_array_equal(out[0], [31, 30])
    np.testing.assert_array_equal(out[1], [31, 30])


_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from hybrid_rag_colbertv2_tpu_torch.index import checkpoint
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.parallel.distributed import (
        initialize_distributed)

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    up = initialize_distributed(f"file://{store}", num_processes=2,
                                process_id=rank)
    again = initialize_distributed()
    writes = []
    real_save = np.save

    def counted(f, *a, **k):
        writes.append(str(f))
        return real_save(f, *a, **k)
    np.save = counted
    rng = np.random.default_rng(0)
    toks = rng.standard_normal((40, 32, 16)).astype(np.float32)
    lens = rng.integers(8, 33, 40).astype(np.int32)
    dense = DenseTokenIndex.build(torch.from_numpy(toks),
                                  torch.from_numpy(lens), doc_len=32,
                                  dtype="int8")
    checkpoint.save_sharded(dense, out)
    back = checkpoint.load_sharded(out, device="cpu")
    same = torch.equal(back.emb_flat, dense.emb_flat)
    world = torch.distributed.get_world_size()
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "up": up, "again": again,
                      "writes": len(writes), "world": world, "same": same}))
""")


def test_two_process_gloo_group_rank0_writes(tmp_path):
    """Two processes join one gloo group through a file store;
    ``save_sharded`` writes from rank 0 alone, and after its barrier both
    ranks read the checkpoint back."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for var in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(rank), str(tmp_path / "store"),
         str(tmp_path / "ck")], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-3000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    by_rank = {r["rank"]: r for r in results}
    assert all(r["up"] and r["again"] and r["world"] == 2 and r["same"]
               for r in results)
    assert by_rank[0]["writes"] > 0 and by_rank[1]["writes"] == 0
