"""``BENCHMARK.json`` and the data files it names.

A configuration, a cell and a per-layer metric are each a file of their
own, found by the name ``BENCHMARK.json`` gives it: configurations by
their ``file`` (the sizes) and the ``.py`` beside it (the plain
reference), cells as ``benchmark/workloads/<cell>.json`` and metric
readers as ``benchmark/metrics/<metric>.py``. Adding one edits no file
that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> Dict:
    """``BENCHMARK.json``; every per-layer metric has to list its cells."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if not m.get("workloads"):
            raise ValueError(f"per-layer metric {m.get('name')!r} lists no "
                             "workloads")
    return bench


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    entry = config_entry(bench, name)
    cfg = json.loads((root / entry["file"]).read_text())
    if cfg.get("name") != name:
        raise ValueError(f"{entry['file']} names {cfg.get('name')!r}, "
                         f"not {name!r}")
    return cfg


def load_model(bench: Dict, name: str, root: Optional[Path] = None):
    """The configuration's plain reference, the ``.py`` beside its file
    (under ``root``, else the checkout's root): ``param_specs(arch)`` and
    ``encode_queries(weights, arch, ids, prec)``, and optionally
    ``encoder_flops(arch, batch, seq)``, the encoder's FLOP count where
    the block is not the one ``yardstick.encoder_flops`` counts."""
    root = ROOT if root is None else root
    path = (root / config_entry(bench, name)["file"]).with_suffix(".py")
    return _load_module("bench_model_" + re.sub(r"\W", "_", name), path)


def _load_module(mod_name: str, path: Path):
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def cell_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "workloads" / f"{check_name(name)}.json"


def load_cell(bench: Dict, name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    """The cell's data file, which must agree with its entry."""
    entry = workload(bench, name)
    cell = json.loads(cell_path(name, bench_dir).read_text())
    for key in ("name", "config", "traffic"):
        if cell.get(key) != entry[key]:
            raise ValueError(f"cell file {name}: {key} {cell.get(key)!r} "
                             f"!= BENCHMARK.json's {entry[key]!r}")
    return cell


def end_to_end_for(bench: Dict, cell: str) -> List[Dict]:
    """End-to-end metrics of a cell: those with no list of cells
    (``setup_s``) and those that list it."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(bench: Dict, cell: str) -> List[Dict]:
    """Per-layer metrics of a cell: those that list it."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def metric_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{check_name(name)}.py"


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx) -> float | None`` of a per-layer metric's file."""
    return _load_module("bench_metric_" + re.sub(r"\W", "_", name),
                        metric_path(name, bench_dir)).read


def read_metrics(metrics: List[Dict], ctx: Dict,
                 bench_dir: Path = BENCH_DIR) -> Dict[str, Dict]:
    """Each reader's value with its unit; a reader that finds nothing
    (None) leaves its metric out."""
    out = {}
    for m in metrics:
        v: Optional[float] = load_reader(m["name"], bench_dir)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
