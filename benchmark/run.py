"""The benchmark of hybrid_rag_colbertv2_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Sets up the cell from ``--seed`` (inputs and
weights made on the card, every shape the traffic reaches warmed up),
drives the served path for ``--seconds``, and with ``--trace 1`` also
reads the per-layer metrics from a traced window. Then it checks a
sample of the answers against the plain reference. The last line of
standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the line's last key.
Exits non-zero, with no result line, without a card, without the
program, or if the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# builds and kernel caches stay inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(HERE))

# compared by the whole top-level module name: the port's name begins
# with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "hybrid_rag_colbertv2_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import runner, spec

    bench = spec.load_benchmark(ROOT)
    entry = spec.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        out = runner.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, bench)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3

    card = out["card"]
    if args.trace:
        metrics = spec.read_metrics(
            spec.per_layer_for(bench, args.workload), out["ctx"])
    else:
        want = {m["name"]: m["unit"]
                for m in spec.end_to_end_for(bench, args.workload)}
        metrics = {n: {"value": float(out["e2e"][n]), "unit": u}
                   for n, u in want.items()}
    device = {"platform": "gpu", "kind": card["name"],
              "count": entry["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        red = out["ctx"]["trace"]
        device.update(busy_s=red["busy_s"], window_s=red["window_s"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = out["breakdown"]
    line["card"] = {"name": card["name"], "power_limit": card["power_limit"]}
    line["check"] = out["check"]
    for name, m in metrics.items():
        print(f"{name} = {m['value']} {m['unit']} (power limit "
              f"{card['power_limit']})", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
