"""ctypes loader for the port's native text-processing library — port of
``hybrid_rag_colbertv2_tpu/utils/native.py``.

The port keeps its own copy of the C++ source
(``hybrid_rag_colbertv2_tpu_torch/csrc/textproc.cpp``). At first use it is
built with ``g++ -O3 -std=c++17 -fPIC -shared`` into ``build/native/`` at
the repository root (listed in .gitignore), keyed by a hash of the source
and the flags, as ops/_build.py keys the CUDA kernels: a changed source is
never served a stale library. The compiler writes a temporary file that is
renamed into place under a file lock, so processes that start together
(test workers) build it once. When present, the lexical pipeline uses it
(index/lexical.py ``LexicalIndex.build``, index/textproc.py
``tokenize_corpus``); otherwise the pure-Python implementation in
index/textproc.py runs. Both are tested byte-identical
(tests/test_torch_native.py). A failed build logs the compiler's output
at warning level and the process keeps the Python path. Set
``HRAG_NO_NATIVE=1`` to force the Python path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from .logging import get_logger

log = get_logger(__name__)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "textproc.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
ABI_VERSION = 3

_lib = None
_load_failed = False


def library_path() -> Path:
    """``build/native/libhrag_textproc-<hash>.so`` for this source and
    these flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhrag_textproc-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless its hashed file exists; -> its path.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():            # another process built it
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            try:
                r = subprocess.run(
                    [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"native build failed: {e}") from e
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"native build failed ({cxx}, rc "
                                   f"{r.returncode}):\n{r.stderr}")
            os.replace(tmp, out)
            log.info("built %s in %.1fs", out.name, time.perf_counter() - t0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (once) and load (once) the native library, or None: with
    ``HRAG_NO_NATIVE`` set, or when the build or the load failed in this
    process (logged once, at warning level)."""
    global _lib, _load_failed
    if os.environ.get("HRAG_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    try:
        lib = ctypes.CDLL(str(build()))
        lib.hrag_tokenize_corpus.restype = ctypes.POINTER(ctypes.c_char)
        lib.hrag_tokenize_corpus.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        lib.hrag_stem.restype = ctypes.POINTER(ctypes.c_char)
        lib.hrag_stem.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.hrag_build_postings.restype = ctypes.POINTER(ctypes.c_char)
        lib.hrag_build_postings.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        lib.hrag_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.hrag_abi_version.restype = ctypes.c_int32
        if lib.hrag_abi_version() != ABI_VERSION:
            raise RuntimeError("native ABI mismatch")
    except (OSError, RuntimeError, AttributeError) as e:
        _load_failed = True
        log.warning("native text library unavailable, using the Python "
                    "path: %s", e)
        return None
    _lib = lib
    return _lib


_STEM_ALGOS = {"snowball": 1, "porter": 2}


def _joined(corpus: List[str]) -> bytes:
    # \x1e is the document separator in the C ABI; sanitize it out of the
    # texts (PDF-extracted text can contain control bytes) so the returned
    # doc count always matches len(corpus). The Python tokenizer treats
    # \x1e as a non-word delimiter, so replacing with a space is
    # token-identical to the fallback path. Lowercase HERE with Python's
    # str.lower() so Unicode chars whose lowercase is ASCII (e.g. U+212A
    # KELVIN SIGN -> 'k') tokenize identically to the pure-Python path —
    # the C side only ASCII-lowers.
    return "\x1e".join(t.lower().replace("\x1e", " ") for t in corpus
                       ).encode("utf-8", errors="replace")


def tokenize_corpus_native(corpus: List[str], stem: bool = True,
                           stemmer: str = "snowball"
                           ) -> Optional[List[List[str]]]:
    """Batch tokenize+stem via the native library; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not corpus:
        # ''.split(chr(30)) on the C side would yield one phantom empty
        # doc; the contract is len(result) == len(corpus)
        return []
    algo = _STEM_ALGOS[stemmer] if stem else 0
    joined = _joined(corpus)
    out_len = ctypes.c_int64()
    buf = lib.hrag_tokenize_corpus(joined, len(joined), algo,
                                   ctypes.byref(out_len))
    try:
        raw = ctypes.string_at(buf, out_len.value).decode("utf-8",
                                                          errors="replace")
    finally:
        lib.hrag_free(buf)
    docs = raw.split("\x1e")
    return [d.split(" ") if d else [] for d in docs]


def build_postings_native(corpus: List[str], stem: bool = True,
                          stemmer: str = "snowball"):
    """One-pass tokenize + (term, doc) -> tf aggregation in C++.

    -> (vocab_terms: List[str] lexicographically sorted,
        tids, dids, tfs: int32 arrays in (term, doc) order,
        doc_lens: int32 (n_docs,)) or None when the library is absent.

    Replaces the string-heavy half of LexicalIndex.build (tokenize,
    np.unique over all tokens, pair aggregation); the numeric half (idf,
    BM25 weights, postings cap, CSR assembly) stays in numpy, so the
    result is bit-identical to the pure-Python path by construction."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    if not corpus:
        return ([], np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    algo = _STEM_ALGOS[stemmer] if stem else 0
    joined = _joined(corpus)
    out_len = ctypes.c_int64()
    buf = lib.hrag_build_postings(joined, len(joined), algo,
                                  ctypes.byref(out_len))
    try:
        raw = ctypes.string_at(buf, out_len.value)
    finally:
        lib.hrag_free(buf)
    n_docs, n_terms, nnz, vocab_bytes = np.frombuffer(
        raw, np.int64, count=4)

    def pad8(x):
        return (int(x) + 7) & ~7

    off = 32
    vocab_blob = raw[off:off + vocab_bytes].decode("utf-8")
    vocab_terms = vocab_blob.split(" ") if vocab_bytes else []
    if len(vocab_terms) != n_terms:
        raise RuntimeError(f"native postings: {len(vocab_terms)} vocab "
                           f"terms, header says {n_terms}")
    off += pad8(vocab_bytes)
    doc_lens = np.frombuffer(raw, np.int32, count=int(n_docs),
                             offset=off).copy()
    off += pad8(n_docs * 4)
    tids = np.frombuffer(raw, np.int32, count=int(nnz), offset=off).copy()
    off += pad8(nnz * 4)
    dids = np.frombuffer(raw, np.int32, count=int(nnz), offset=off).copy()
    off += pad8(nnz * 4)
    tfs = np.frombuffer(raw, np.int32, count=int(nnz), offset=off).copy()
    return vocab_terms, tids, dids, tfs, doc_lens


def stem_native(word: str, stemmer: str = "snowball") -> Optional[str]:
    lib = get_lib()
    if lib is None:
        return None
    w = word.encode("utf-8", errors="replace")
    out_len = ctypes.c_int64()
    buf = lib.hrag_stem(w, len(w), _STEM_ALGOS[stemmer],
                        ctypes.byref(out_len))
    try:
        return ctypes.string_at(buf, out_len.value).decode("utf-8")
    finally:
        lib.hrag_free(buf)


if __name__ == "__main__":
    if "--build" in sys.argv:
        try:
            print(f"built {build()}")
        except RuntimeError as e:
            print(e, file=sys.stderr)
            sys.exit(1)
        sys.exit(0)
    print(f"native lib present: {library_path().exists()} at "
          f"{library_path()}")
