"""What the host did during a window: the CPU cores this process kept
busy, logged beside each window and set-up, so a slow run shows whether
the process got less of the host. Nothing here is a metric. The sweep
also uses ``busy_cores`` to stand in for another tenant of the host."""

from __future__ import annotations

import resource
import subprocess
import sys
import time
from typing import Dict, List


def counters() -> Dict[str, float]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return dict(wall=time.perf_counter(), cpu=ru.ru_utime + ru.ru_stime)


def since(a: Dict[str, float]) -> Dict[str, float]:
    """The cores this process kept busy since ``a = counters()``."""
    b = counters()
    return dict(process_cores=(b["cpu"] - a["cpu"])
                / max(b["wall"] - a["wall"], 1e-9))


def line(d: Dict[str, float]) -> str:
    return f"host: this process {d['process_cores']:.2f} cores"


def busy_cores(n: int) -> List[subprocess.Popen]:
    """``n`` processes that each keep one core busy, as another tenant of
    a shared host does (the knee's sweep only). Stop them with ``stop``."""
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(n)]


def stop(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        p.kill()
    for p in procs:
        p.wait()
