"""Sets of runs of the benchmark, each run a fresh process, and their
spreads: how far a cell's runs of one tree scatter, as a check of the
benchmark measures it. Also logs, for every run, what the host did
around it, read from outside the run's process (``/proc``, ``/sys``,
reading only): the cores each of its threads ran on and their CPU
seconds, the steal time of the machine's cores, and each core's speed
just before the run (a short loop pinned to it, in this process). Run
on the card:

    python3 benchmark/sets.py --workload <cell> [...] --seeds <n> [...] \
        --sets 2 --seconds 51 --out build/sets [--root <checkout>]

``--root`` runs another checkout's ``benchmark/run.py`` (a parent tree
unpacked beside this one). Writes ``<out>/runs.jsonl`` (one line a
run), each run's standard error as ``<out>/<cell>.<set>.<seed>.err``,
and prints the spreads last, as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from harness import host  # noqa: E402

HZ = os.sysconf("SC_CLK_TCK")
SAMPLE_S = 0.5
# the stderr line written when a run's measured window closes, and the
# lines kept in the log
WINDOW_CLOSES = "window:"
KEPT = ("window", "calls ", "set-up host", "card ", "[")


def core_speeds(seconds: float = 0.05) -> Dict[int, float]:
    """Loop iterations per microsecond on each core this process may run
    on, pinned to it in turn; the affinity is restored after."""
    cores = sorted(os.sched_getaffinity(0))
    out = {}
    try:
        for c in cores:
            os.sched_setaffinity(0, {c})
            n, t0 = 0, time.perf_counter()
            end = t0 + seconds
            while time.perf_counter() < end:
                n += 1
            out[c] = round(n / ((time.perf_counter() - t0) * 1e6), 4)
    finally:
        os.sched_setaffinity(0, cores)
    return out


def steal() -> Dict[int, float]:
    """Seconds of steal so far on each core (``/proc/stat``)."""
    out = {}
    for line in (host.read("/proc/stat") or "").splitlines():
        f = line.split()
        if f and f[0].startswith("cpu") and f[0] != "cpu" and len(f) > 8:
            out[int(f[0][3:])] = int(f[8]) / HZ
    return out


class Sampler(threading.Thread):
    """Samples a process's threads every ``SAMPLE_S`` while it runs, with
    the length of its standard error so far (to place each sample in a
    phase of the run afterwards)."""

    def __init__(self, pid: int, err: Path):
        super().__init__(daemon=True)
        self.pid, self.err, self.samples = pid, err, []
        self.done = threading.Event()

    def run(self) -> None:
        while not self.done.wait(SAMPLE_S):
            size = self.err.stat().st_size if self.err.exists() else 0
            self.samples.append((time.perf_counter(), size,
                                 host.tasks(self.pid),
                                 steal()))


def phase_offsets(err_text: str) -> tuple:
    """Offsets in a run's standard error of set-up's last line before the
    window and of the window's own line (None where absent)."""
    b = err_text.find(WINDOW_CLOSES)
    if b < 0:
        return None, None
    a = err_text.rfind("\n", 0, max(err_text.rfind("\n", 0, b), 0))
    return max(a, 0), b


def window_threads(samples, err_text: str) -> Dict:
    """The threads' CPU seconds and cores within the measured window (the
    samples taken after set-up's last mark and before the window's line
    was written), and each core's steal over it."""
    a, b = phase_offsets(err_text)
    if a is None or b is None:
        return {}
    inside = [s for s in samples if a < s[1] <= b]
    if len(inside) < 2:
        return {}
    first, last = inside[0], inside[-1]
    wall = last[0] - first[0]
    threads = []
    for tid, (name, _, cpu) in last[2].items():
        cpu0 = first[2].get(tid, (name, 0, 0.0))[2]
        cores = {}
        for s in inside:
            if tid in s[2]:
                c = s[2][tid][1]
                cores[c] = cores.get(c, 0) + 1
        busy = (cpu - cpu0) / wall
        if busy >= 0.02:
            threads.append(dict(tid=tid, name=name, busy=round(busy, 3),
                                cores=dict(sorted(cores.items()))))
    threads.sort(key=lambda t: -t["busy"])
    st = {c: round(last[3].get(c, 0) - v, 3) for c, v in first[3].items()}
    return dict(seconds=round(wall, 2), threads=threads, steal_s=st,
                process_cores=round(sum(t["busy"] for t in threads), 3))


def one_run(root: Path, out: Path, workload: str, set_no: int, seed: int,
            seconds: float, trace: int) -> Dict:
    speeds = core_speeds()
    err_path = out / f"{workload}.{set_no}.{seed}.err"
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        p = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                             stderr=err, text=True)
        sampler = Sampler(p.pid, err_path)
        sampler.start()
        try:
            stdout, _ = p.communicate(timeout=seconds + 600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        sampler.done.set()
        sampler.join()
    err_text = err_path.read_text()
    lines = [x for x in stdout.strip().splitlines() if x.startswith("{")]
    result = json.loads(lines[-1]) if lines else None
    return dict(
        workload=workload, set=set_no, seed=seed, rc=p.returncode,
        wall_s=round(time.perf_counter() - t0, 2), core_speed=speeds,
        correct=result and result["correct"],
        metrics={k: v["value"] for k, v in (result or {}).get(
            "metrics", {}).items()},
        window=window_threads(sampler.samples, err_text),
        log=[x for x in err_text.splitlines() if x.startswith(KEPT)])


def spread(values: List[float]) -> Dict:
    """IQR over the median (``statistics.quantiles``, n = 4), as read of
    all the runs and with the run farthest from the median left out
    where that narrows it."""
    if len(values) < 2:
        return {}
    med = statistics.median(values)

    def iqr(v):
        q = statistics.quantiles(v, n=4)
        return q[2] - q[0]

    whole = iqr(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = values[:far] + values[far + 1:]
    trimmed = min(whole, iqr(rest)) if len(rest) >= 2 else whole
    return dict(median=med, iqr_pct=100 * whole / med,
                trimmed_pct=100 * trimmed / med)


def summary(runs: List[Dict]) -> Dict:
    """Per cell and metric: each set's values and spreads, the mean of
    the sets' trimmed spreads over the median of all runs (what a bound
    has to hold twice over), and the spread of all runs pooled (what a
    bound may be at most eight times)."""
    out: Dict = {}
    for r in runs:
        cell = out.setdefault(r["workload"], {})
        for name, v in r["metrics"].items():
            cell.setdefault(name, {}).setdefault(r["set"], []).append(v)
    for cell in out.values():
        for name, sets in list(cell.items()):
            per = {s: dict(values=v, **spread(v)) for s, v in sets.items()}
            allv = [x for v in sets.values() for x in v]
            med = statistics.median(allv)
            trimmed = [p["trimmed_pct"] * p["median"] / med
                       for p in per.values() if "trimmed_pct" in p]
            cell[name] = dict(sets=per, median=med,
                              mean_trimmed_pct=(statistics.mean(trimmed)
                                                if trimmed else None),
                              pooled_iqr_pct=spread(allv).get("iqr_pct"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    with open(out / "runs.jsonl", "a") as log:
        for w in args.workload:
            for s in range(1, args.sets + 1):
                for seed in args.seeds:
                    r = one_run(Path(args.root), out, w, s, seed,
                                args.seconds, args.trace)
                    runs.append(r)
                    log.write(json.dumps(r) + "\n")
                    log.flush()
                    print(f"{w} set {s} seed {seed}: rc {r['rc']} correct "
                          f"{r['correct']} {r['metrics']} "
                          f"({r['wall_s']} s)", file=sys.stderr, flush=True)
    print(json.dumps(summary(runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
