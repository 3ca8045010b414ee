"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each kernel source is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. Libraries go to ``build/kernels/`` at the repository
root (listed in .gitignore), keyed by a hash of the source, of every
``csrc/`` header it includes (transitively), and of the flags, so a
checkout builds everything it needs from its own sources and a changed
source or shared header is never served a stale library. A failed build
raises; nothing falls back. ``prebuild`` starts a build in the background
where set-up knows a kernel will run, so the compile overlaps the rest of
the set-up; the first ``load`` waits for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

_lock = threading.Lock()
_loaded: Dict[Tuple[Path, str], ctypes.CDLL] = {}
_pending: Dict[Tuple[Path, str], threading.Thread] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the port's "
                       "CUDA kernels are built from csrc/ at first use")


def _sources(name: str, csrc: Path) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with
    quotes, transitively, in a fixed order."""
    seen: List[Path] = []
    todo = [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and csrc.resolve() in dep.parents:
                todo.append(dep)
    return seen


def library_path(name: str, csrc: Path = CSRC,
                 build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256()
    for path in _sources(name, csrc):
        data = path.read_bytes()
        h.update(f"{path.name}:{len(data)}:".encode())
        h.update(data)
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_many(names: Sequence[str], csrc: Path = CSRC) -> Dict[str, Path]:
    """Compile each ``<csrc>/<name>.cu`` whose hashed library is missing,
    one ``nvcc`` per source, all started together. ``csrc`` is the port's
    own by default; another directory laid out like it (a version of a
    kernel to compare) builds the same way. ``ptxas -v`` output
    (registers, shared memory, spills) is kept beside each library as
    ``.log``. -> {name: library path}"""
    outs = {name: library_path(name, csrc) for name in names}
    procs = {}
    for name, out in outs.items():
        if out.exists() or name in procs:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        outs[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, outs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def prebuild(name: str, csrc: Path = CSRC) -> None:
    """Start building kernel ``name`` in a background thread, unless its
    library is loaded, built or being built. A failure is left for
    ``load`` to raise: it builds again in the foreground."""
    key = (csrc, name)
    with _lock:
        if key in _loaded or key in _pending or \
                library_path(name, csrc).exists():
            return

        def run() -> None:
            try:
                build_many([name], csrc)
            except (OSError, RuntimeError):
                pass
        _pending[key] = threading.Thread(target=run, daemon=True,
                                         name=f"build {name}")
        _pending[key].start()


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (from ``csrc``), built if
    needed (after a ``prebuild`` of it has ended)."""
    pending = _pending.get((csrc, name))
    if pending is not None:
        pending.join()
    with _lock:
        lib = _loaded.get((csrc, name))
        if lib is None:
            lib = ctypes.CDLL(str(build_many([name], csrc)[name]))
            _loaded[(csrc, name)] = lib
        return lib
