"""No module under benchmark/ imports JAX, the JAX package or the
repo-root bench.py, compared by the whole top-level module name (the
port's name begins with the JAX package's); the reference and the other
yardstick modules import nothing of the port."""

import ast
from pathlib import Path

import pytest
from conftest import BENCH

import run

FORBIDDEN = {"jax", "jaxlib", "flax", "hybrid_rag_colbertv2_tpu", "bench"}
PORT = "hybrid_rag_colbertv2_tpu_torch"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported_top_names(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_repo_bench(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["gen", "reference", "compare", "yardstick",
                                  "devtrace", "readers", "spec"])
def test_the_yardstick_imports_nothing_of_the_port(name):
    assert PORT not in imported_top_names(BENCH / "harness" / f"{name}.py")


def test_whole_name_comparison(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, PORT, sys)
    monkeypatch.setitem(sys.modules, PORT + ".config", sys)
    assert "hybrid_rag_colbertv2_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hybrid_rag_colbertv2_tpu.ops", sys)
    assert run.forbidden_modules() == ["hybrid_rag_colbertv2_tpu"]


def test_a_cpu_run_loads_no_jax():
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = [%r, %r]; from conftest import small;"
            "from harness import runner; import run;"
            "b, c, a = small('colbertv2.msmarco-exact', n_docs=300);"
            "out = runner.run_cell('colbertv2.msmarco-exact', 3, 0.5, False,"
            " 'cpu', bench=b, cell=c, arch=a);"
            "assert out['correct'];"
            "assert not run.forbidden_modules(), run.forbidden_modules()"
            % (str(BENCH / "tests"), str(BENCH)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
