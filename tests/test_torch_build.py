"""The kernel library's cache key covers every ``csrc/`` file a source
includes, so an edited shared header rebuilds each kernel that uses it
(no nvcc needed: only the key is computed)."""

import pytest

from hybrid_rag_colbertv2_tpu_torch.ops import _build


def _write(csrc, files):
    for name, text in files.items():
        (csrc / name).write_text(text)


def test_library_key_covers_included_headers(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    _write(csrc, {
        "a.cu": '#include "shared.cuh"\n#include <cuda_runtime.h>\n',
        "b.cu": "// no includes\n",
        "shared.cuh": '#pragma once\n#include "inner.cuh"\n',
        "inner.cuh": "constexpr int kA = 1;\n",
    })
    key = {n: _build.library_path(n, csrc, tmp_path) for n in ("a", "b")}
    assert key["a"].name.startswith("liba-") and key["a"].suffix == ".so"
    assert _build.library_path("a", csrc, tmp_path) == key["a"]
    # an edit two includes deep changes the includer's key, not b's
    (csrc / "inner.cuh").write_text("constexpr int kA = 2;\n")
    assert _build.library_path("a", csrc, tmp_path) != key["a"]
    assert _build.library_path("b", csrc, tmp_path) == key["b"]
    # a system header (angle brackets) or a file outside csrc/ is not read
    assert [p.name for p in _build._sources("a", csrc)] == [
        "a.cu", "shared.cuh", "inner.cuh"]


@pytest.mark.parametrize("name", ["maxsim", "maxsim_int8", "maxsim_int8_doc",
                                  "maxsim_int4_group"])
def test_every_kernel_source_hashes_its_header(name):
    """The wgmma scans (bf16, int8, int8-doc, int4) each include the
    Hopper wrappers header and no other ``csrc/`` file."""
    names = [p.name for p in _build._sources(name, _build.CSRC)]
    assert names == [f"{name}.cu", "sm90.cuh"]


def test_copy_of_csrc_shares_the_key_until_edited(tmp_path):
    """A kernel version in another directory laid out like ``csrc/``
    (``chip_smoke.py --variant``) gets the port's library only while
    its source and headers are byte-equal to the port's."""
    name = "maxsim_int4_group"
    for path in _build._sources(name, _build.CSRC):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    assert _build.library_path(name, tmp_path) == _build.library_path(name)
    (tmp_path / "sm90.cuh").write_text("// another header\n")
    assert _build.library_path(name, tmp_path) != _build.library_path(name)
