"""BENCHMARK.json and the data files it names: shape, names, and that a
new configuration, cell or metric file is found by name with no file
edited."""

import json
import shutil

import pytest
from conftest import BENCH, ROOT

from harness import spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAMES = ([c["name"] for c in BENCHMARK["configs"]]
         + [w["name"] for w in BENCHMARK["workloads"]]
         + [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]])


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_names_use_allowed_characters(name):
    assert spec.check_name(name) == name


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCHMARK[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCHMARK["end_to_end"]
               + BENCHMARK["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cfg", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_file_parses_and_is_used(cfg):
    data = spec.load_config(BENCHMARK, cfg["name"], ROOT)
    model = spec.load_model(BENCHMARK, cfg["name"], ROOT)
    assert callable(model.encode_queries) and model.param_specs(data)
    assert cfg["file"].startswith("benchmark/")
    assert set(cfg["reduced"]) == set(data["reduced"])
    assert data["source"] == cfg["source"]
    assert any(w["config"] == cfg["name"] for w in BENCHMARK["workloads"])
    for key in cfg["reduced"]:
        assert not (key.endswith("_dim") or key.endswith("_size")
                    or key in ("dim", "hidden_size", "intermediate_size"))


@pytest.mark.parametrize("cell", BENCHMARK["workloads"],
                         ids=lambda w: w["name"])
def test_cell_file_parses(cell):
    data = spec.load_cell(BENCHMARK, cell["name"])
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert spec.check_name(cell["traffic"]) == cell["traffic"]
    assert set(data["check"]["limits"]) == {"score_err", "missing_ids",
                                            "order_gap"}
    if data["load"]["loop"] == "open":
        assert data["load"]["rate_qps"] == pytest.approx(
            0.8 * data["load"]["knee_qps"], rel=0.05)
    e2e = spec.end_to_end_for(BENCHMARK, cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert spec.per_layer_for(BENCHMARK, cell["name"])


def test_metrics():
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert spec.UNIT_RE.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    layers = {}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
        assert spec.UNIT_RE.match(m["unit"])
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert spec.metric_path(m["name"]).exists()
        for w in m["workloads"]:
            moved = {x["name"] for x in spec.end_to_end_for(BENCHMARK, w)}
            assert m["moves"] in moved
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    assert all(len(v) == 1 for v in layers.values())


def test_new_files_are_found_by_name(tmp_path):
    """A later change adds a configuration, a cell and a metric as new
    files and entries; the harness finds them with no file edited."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench_dir / "configs" / "colbertv2.0.json").read_text())
    cfg["name"] = "colbertv2.0-copy"
    (bench_dir / "configs" / "colbertv2.0-copy.json").write_text(
        json.dumps(cfg))
    (bench_dir / "configs" / "colbertv2.0-copy.py").write_text(
        "def param_specs(arch):\n    return ['copy']\n")
    bench["configs"].append(dict(bench["configs"][0], name="colbertv2.0-copy",
                                 file="benchmark/configs/colbertv2.0-copy.json"))
    cell = json.loads(spec.cell_path("colbertv2.msmarco-open",
                                     bench_dir).read_text())
    cell.update(name="copy.msmarco-open", config="colbertv2.0-copy")
    spec.cell_path("copy.msmarco-open", bench_dir).write_text(json.dumps(cell))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="copy.msmarco-open",
                                   config="colbertv2.0-copy"))
    (bench_dir / "metrics" / "calls_seen.py").write_text(
        "def read(ctx):\n    return len(ctx['calls']) or None\n")
    bench["per_layer"].append(dict(name="calls_seen", unit="calls",
                                   better="higher", source="program_span",
                                   layer="batcher", moves="query_p50_ms",
                                   workloads=["copy.msmarco-open"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = spec.load_benchmark(tmp_path)
    assert spec.load_config(loaded, "colbertv2.0-copy",
                            tmp_path)["name"] == "colbertv2.0-copy"
    assert spec.load_model(loaded, "colbertv2.0-copy",
                           tmp_path).param_specs({}) == ["copy"]
    assert spec.load_cell(loaded, "copy.msmarco-open",
                          bench_dir)["config"] == "colbertv2.0-copy"
    mine = spec.per_layer_for(loaded, "copy.msmarco-open")
    assert [m["name"] for m in mine] == ["calls_seen"]
    out = spec.read_metrics(mine, {"calls": [1, 2, 3]}, bench_dir)
    assert out == {"calls_seen": {"value": 3.0, "unit": "calls"}}
    assert spec.read_metrics(mine, {"calls": []}, bench_dir) == {}


def test_a_per_layer_metric_must_list_its_cells(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    del bench["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        spec.load_benchmark(tmp_path)


def test_cell_file_must_agree_with_its_entry(tmp_path):
    bench_dir = tmp_path / "benchmark"
    (bench_dir / "workloads").mkdir(parents=True)
    cell = json.loads(spec.cell_path("colbertv2.msmarco-exact").read_text())
    cell["config"] = "jina-colbert-v2"
    spec.cell_path("colbertv2.msmarco-exact", bench_dir).write_text(
        json.dumps(cell))
    with pytest.raises(ValueError):
        spec.load_cell(BENCHMARK, "colbertv2.msmarco-exact", bench_dir)


@pytest.mark.parametrize("bad", ["a b", "a/b", "", "x" * 65, "-x", "é"])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)
