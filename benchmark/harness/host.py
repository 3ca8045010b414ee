"""What the host did during a window: the CPU cores this process kept
busy, and each kind of thread's share of them and the cores it was seen
on, logged beside each window and set-up, so a slow run shows whether
the process got less of the host or spent it elsewhere; and where the
card sits (its NUMA node). Everything here only reads ``/proc`` and
``/sys``, and a machine may hide some of it. Nothing here is a metric.
The sweep also uses ``busy_cores`` to stand in for another tenant of
the host."""

from __future__ import annotations

import os
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional


def read(path) -> Optional[str]:
    try:
        return Path(path).read_text()
    except OSError:
        return None


def tasks(pid="self") -> Dict[int, tuple]:
    """tid -> (its name in the kernel, the core it ran on last, CPU
    seconds so far), for every thread of a process
    (``/proc/<pid>/task/*/stat``)."""
    hz = os.sysconf("SC_CLK_TCK")
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return {}
    out = {}
    for tid in tids:
        text = read(f"/proc/{pid}/task/{tid}/stat")
        if text is None:
            continue
        f = text[text.rindex(")") + 2:].split()
        out[int(tid)] = (text[text.index("(") + 1:text.rindex(")")],
                         int(f[36]), (int(f[11]) + int(f[12])) / hz)
    return out


def _group(name: str) -> str:
    """A thread's kind by its Python name: ``client_3`` -> ``client``;
    a thread Python does not know (CUDA's, OpenMP's) is ``native``."""
    return "main" if name == "MainThread" else name.rsplit("_", 1)[0]


def threads() -> Dict[int, tuple]:
    """tid -> (kind, the core it ran on last, CPU seconds so far), for
    every thread of this process."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    return {tid: (_group(names.get(tid, "native")), core, cpu)
            for tid, (_, core, cpu) in tasks().items()}


def counters() -> Dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return dict(wall=time.perf_counter(), cpu=ru.ru_utime + ru.ru_stime,
                threads=threads())


def since(a: Dict) -> Dict:
    """Since ``a = counters()``: the cores this process kept busy, and
    per kind of thread its count, busy cores and the cores its threads
    were last seen on (at ``a`` and now)."""
    b = counters()
    wall = max(b["wall"] - a["wall"], 1e-9)
    kinds: Dict[str, Dict] = {}
    for tid, (kind, core, cpu) in b["threads"].items():
        k = kinds.setdefault(kind, dict(n=0, cores=0.0, on=set()))
        k["n"] += 1
        k["cores"] += (cpu - a["threads"].get(tid, (0, 0, 0.0))[2]) / wall
        k["on"].add(core)
        if tid in a["threads"]:
            k["on"].add(a["threads"][tid][1])
    return dict(process_cores=(b["cpu"] - a["cpu"]) / wall,
                kinds={n: dict(n=k["n"], cores=round(k["cores"], 3),
                               on=sorted(k["on"]))
                       for n, k in sorted(kinds.items())})


def line(d: Dict) -> str:
    kinds = "; ".join(f"{n} x{k['n']} {k['cores']:.2f} cores on "
                      f"{','.join(map(str, k['on']))}"
                      for n, k in d["kinds"].items())
    return f"host: this process {d['process_cores']:.2f} cores; {kinds}"


def numa_line(pci_bus_id: str) -> str:
    """The card's NUMA node and its local cores (``/sys/bus/pci``), the
    machine's nodes, and the cores this process may run on."""
    dom, rest = (pci_bus_id.lower().split(":", 1) + [""])[:2]
    dev = Path("/sys/bus/pci/devices") / f"{dom[-4:]}:{rest}"
    node = (read(dev / "numa_node") or "?").strip()
    local = (read(dev / "local_cpulist") or "?").strip()
    nodes = sorted(Path("/sys/devices/system/node").glob("node[0-9]*"))
    listed = ", ".join(f"{p.name} {(read(p / 'cpulist') or '?').strip()}"
                       for p in nodes)
    return (f"card {pci_bus_id}: NUMA node {node}, local cores {local}; "
            f"machine: {listed or 'no NUMA nodes listed'}; this process "
            f"may run on {sorted(os.sched_getaffinity(0))}")


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
