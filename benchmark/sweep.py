"""The knee of an open-loop cell: one set-up, then windows at rising
rates. For each rate: the queries answered per second, p50 and p95,
whether the backlog grew (the last third's p95 over the first third's),
and what the host did (``harness/host.py``). The knee is the highest
rate answered in full with no growing backlog; the cell then runs at
four fifths of it. ``--busy-cores`` repeats the rates with that many
other processes each keeping a core busy, as another tenant of a shared
host does; ``--repeat`` takes every window again. Run once, when a cell
is defined, on the card:

    python3 benchmark/sweep.py --workload <cell> --seed <n> \
        --seconds 20 --rates 600 800 ... [--busy-cores 0 4] [--repeat 2]
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--busy-cores", type=int, nargs="+", default=[0])
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    from harness import host, runner

    total = (len(args.busy_cores) * args.repeat
             * sum(max(1, round(r * args.seconds)) for r in args.rates))
    cell, arch, _, inputs, system = runner.setup(
        args.workload, args.seed, "cuda", lambda c: total, T_START)
    top_k = cell["queries"]["top_k"]
    pool = inputs.texts[runner.WARM_POOL:]
    o = 0
    try:
        for busy in args.busy_cores:
            burners = host.busy_cores(busy)
            try:
                for rep in range(args.repeat):
                    for rate in args.rates:
                        o = window(system, pool, o, rate, args, top_k, busy,
                                   rep)
            finally:
                host.stop(burners)
    finally:
        system.close()
    return 0


def window(system, pool, o, rate, args, top_k, busy, rep) -> int:
    """One window at ``rate``; prints its line. -> the next pool offset."""
    import numpy as np
    from harness import gen, host, serve

    n = max(1, round(rate * args.seconds))
    texts = pool[o:o + n]
    o += n
    rec = serve.Recorder(texts, top_k)
    offs = gen.arrival_offsets(n, args.seconds, args.seed,
                               f"sweep.{rate}.{busy}.{rep}")
    t0 = time.perf_counter() + 0.01
    h0 = host.counters()
    info = serve.open_loop(system, texts, offs, rec, t0=t0)
    hw = host.since(h0)
    lat = np.where(rec.ok, rec.done - rec.due, np.inf) * 1e3
    third = n // 3
    first = float(np.percentile(lat[:third], 95))
    last = float(np.percentile(lat[-third:], 95))
    end = float(np.nanmax(rec.done)) - t0
    batches = [c["n_real"] for c in rec.calls]
    print(json.dumps({
        "rate": rate, "busy_cores": busy, "repeat": rep,
        "answered_per_s": int(rec.ok.sum()) / end,
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p95_first_third_ms": first, "p95_last_third_ms": last,
        "p99_ms": float(np.percentile(lat, 99)),
        "max_ms": float(np.max(lat)),
        "max_at_s": float(rec.due[int(np.argmax(lat))] - t0),
        "failed": int((~rec.ok).sum()), "calls": len(rec.calls),
        "mean_batch": float(np.mean(batches)) if batches else 0.0,
        "tokenize_ms": float(np.mean([c["tokenize_s"] for c in
                                      rec.calls]) * 1e3),
        "late_ms": info["late_s"] * 1e3, "host": hw}), flush=True)
    return o


if __name__ == "__main__":
    sys.exit(main())
