"""BENCHMARK.json and the data files it names: shape, names, and that a
new configuration, cell or metric file is found by name with no file
edited."""

import dataclasses
import json
import shutil
import time

import pytest
import torch
from conftest import BENCH, ROOT, small

from harness import gen, readers, runner, serve, spec, yardstick

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


# The port's ColBERTConfig of each configuration, pinned from the harness
# as it stood before a file's encoder_dtype and "encoder" object were
# read: both files state float32 and bring no "encoder" object.
ENCODER_CONFIGS = {
    "colbertv2.0": dict(
        vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
        intermediate_size=3072, max_position_embeddings=512,
        type_vocab_size=2, layer_norm_eps=1e-12, colbert_dim=128,
        position_embedding="learned", rope_base=10000.0,
        rope_interleaved=False, pad_token_id=0, query_max_tokens=32,
        doc_max_tokens=128, dtype=torch.float32, lexical_anchor=0.0),
    "jina-colbert-v2": dict(
        vocab_size=250002, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096, max_position_embeddings=8194,
        type_vocab_size=1, layer_norm_eps=1e-05, colbert_dim=128,
        position_embedding="rope", rope_base=10000.0,
        rope_interleaved=False, pad_token_id=1, query_max_tokens=32,
        doc_max_tokens=256, dtype=torch.float32, lexical_anchor=0.0),
}


@pytest.mark.parametrize("name", sorted(ENCODER_CONFIGS))
def test_encoder_config_is_pinned(name):
    arch = spec.load_config(BENCHMARK, name, ROOT)
    assert arch["encoder_dtype"] == "float32" and "encoder" not in arch
    got = dataclasses.asdict(serve.encoder_config(serve.port(), arch))
    assert got == ENCODER_CONFIGS[name]
    assert all(type(got[k]) is type(v)
               for k, v in ENCODER_CONFIGS[name].items())


def small_encoder(arch):
    P = serve.port()
    model = spec.load_model(BENCHMARK, "jina-colbert-v2", ROOT)
    return P["ColBERTEncoder"](
        serve.encoder_config(P, arch), P["HashTokenizer"](arch["vocab_size"]),
        params=gen.make_weights(model.param_specs(arch), 7, "cpu"),
        device="cpu")


def test_an_encoder_key_reaches_the_port():
    """``rope_interleaved``, a field of the port's ColBERTConfig that no
    mapped key sets, reaches it from the file's "encoder" object and
    changes what the encoder computes."""
    _, _, arch = small("jina.trec-covid-open")
    out = {}
    for interleaved in (True, False):
        enc = small_encoder(dict(arch,
                                 encoder={"rope_interleaved": interleaved}))
        assert enc.model.cfg.rope_interleaved is interleaved
        out[interleaved] = enc.encode_queries(["bakok dabuk tugal"])
    assert not torch.equal(out[True], out[False])


def test_encoder_dtype_bfloat16_builds_a_bf16_encoder():
    _, _, arch = small("jina.trec-covid-open")
    enc = small_encoder(dict(arch, encoder_dtype="bfloat16"))
    assert enc.model.cfg.dtype == torch.bfloat16
    fp32 = small_encoder(arch)
    a = enc.encode_queries(["bakok dabuk tugal"])
    b = fp32.encode_queries(["bakok dabuk tugal"])
    assert 0 < float((a.float() - b.float()).abs().max()) < 0.1


@pytest.mark.parametrize("setting, named", [
    ({"encoder": {"rope_interleave": True}}, "encoder.rope_interleave"),
    ({"encoder": {"num_heads": 8}}, "encoder.num_heads"),
    ({"encoder": {"dtype": "float32"}}, "encoder.dtype"),
    ({"encoder_dtype": "float16"}, "encoder_dtype")],
    ids=["unknown-key", "repeats-a-mapped-key", "repeats-the-dtype",
         "float16"])
def test_a_bad_encoder_setting_stops_set_up(setting, named):
    """Before any timing, with the key's name."""
    name = "colbertv2.msmarco-exact"
    bench, cell, arch = small(name, n_docs=300)
    arch.update(setting)
    with pytest.raises(ValueError, match=named):
        runner.setup(name, 3, "cpu", lambda c: 16, time.perf_counter(),
                     bench, cell, arch)


NEW_PY = """from harness.encoders import encode_queries, param_specs  # noqa: F401


def encoder_flops(arch, batch, seq):
    return 3.0e9 * batch * seq
"""


def test_a_new_configuration_is_new_files_alone(tmp_path, monkeypatch):
    """A configuration this benchmark does not have (a bf16 encoder with
    its own "encoder" key and its own FLOP count), added as a
    configuration file, its .py and a cell file beside a copy of the
    benchmark, runs through ``run_cell`` with no file that exists
    edited: the port's encoder is set up from the file and
    ``step_mfu_pct`` counts the encoder by the .py."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench_dir / "configs" / "jina-colbert-v2.json")
                     .read_text())
    cfg.update(name="tiny-new", encoder_dtype="bfloat16",
               encoder={"rope_interleaved": True})
    (bench_dir / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    (bench_dir / "configs" / "tiny-new.py").write_text(NEW_PY)
    bench["configs"].append(dict(bench["configs"][1], name="tiny-new",
                                 file="benchmark/configs/tiny-new.json"))
    cell = json.loads(spec.cell_path("jina.trec-covid-open",
                                     bench_dir).read_text())
    cell.update(name="tiny-new.open", config="tiny-new")
    spec.cell_path("tiny-new.open", bench_dir).write_text(json.dumps(cell))
    bench["workloads"].append(dict(bench["workloads"][1],
                                   name="tiny-new.open", config="tiny-new"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    monkeypatch.setattr(spec, "ROOT", tmp_path)
    loaded = spec.load_benchmark(tmp_path)
    cell = spec.load_cell(loaded, "tiny-new.open", bench_dir)
    arch = spec.load_config(loaded, "tiny-new", tmp_path)
    _, small_cell, small_arch = small("jina.trec-covid-open")
    arch.update({k: small_arch[k] for k in (
        "num_hidden_layers", "hidden_size", "num_attention_heads",
        "intermediate_size", "vocab_size")})
    cell["corpus"], cell["load"] = small_cell["corpus"], small_cell["load"]
    cell["check"]["sample"] = 8
    seen = {}
    out = runner.run_cell("tiny-new.open", 11, 1.0, False, "cpu",
                          bench=loaded, cell=cell, arch=arch,
                          fault=lambda s: seen.update(
                              cfg=s.encoder.model.cfg))
    assert (seen["cfg"].dtype, seen["cfg"].rope_interleaved) == (
        torch.bfloat16, True)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert 0 < out["check"]["score_err"]["value"] < 1
    ctx = dict(out["ctx"], peaks=yardstick.PEAKS["H100"])
    assert ctx["model"].encoder_flops(arch, 2, 32) == 3.0e9 * 64
    flops = sum(yardstick.call_flops(arch, ctx["route"], ctx["index"], n, 32)
                - yardstick.encoder_flops(arch, n, 32) + 3.0e9 * n * 32
                for n in [c["n_real"] for c in ctx["calls"]])
    secs = sum(c["t1"] - c["t0"] for c in ctx["calls"])
    assert readers.step_mfu_pct(ctx) == pytest.approx(
        100.0 * flops / secs / ctx["peaks"]["bf16_flops"], rel=1e-12)


def test_cell_1_tail_per_layer_is_the_end_to_end_p95():
    """``query_p95_ms.msmarco-open`` reads, from the measured window,
    the number ``query_p95_ms`` would be in that cell, and the cell's
    end-to-end line no longer carries ``query_p95_ms``."""
    name = "colbertv2.msmarco-open"
    bench, cell, arch = small(name, n_docs=600)
    assert "query_p95_ms" not in {
        m["name"] for m in spec.end_to_end_for(BENCHMARK, name)}
    assert "query_p95_ms.msmarco-open" in {
        m["name"] for m in spec.per_layer_for(BENCHMARK, name)}
    out = runner.run_cell(name, 7, 0.5, False, "cpu", bench=bench,
                          cell=cell, arch=arch)
    read = spec.load_reader("query_p95_ms.msmarco-open")(out["ctx"])
    assert read == out["e2e"]["query_p95_ms"] > 0
