"""Environment smoke tests + checkpoint conversion CLI — port of
``hybrid_rag_colbertv2_tpu/tools/check_env.py``.

  * ``python -m hybrid_rag_colbertv2_tpu_torch.tools.check_env
    [--device cpu] [-v]`` runs behavioral smoke tests: the torch build and
    its card, each of the five CUDA MaxSim kernels launched at a small
    shape and held against its plain PyTorch version (JAX's Pallas
    probes), BM25 index + query, tokenizer training, encoder forward, the
    one-dispatch cascade and the native text library. The kernel probes
    need the card whatever ``--device`` says: without one they fail with
    the port's "no CUDA device" error (they never pass on a plain
    version), and ``main`` returns 1. The other probes run on
    ``--device`` (default the card).
  * ``... check_env --convert <hf_dir> <out.npz>`` converts a local HF
    checkpoint (models/convert.py) into the JAX package's
    ``encoder_params.npz``, which either package loads.
"""

from __future__ import annotations

import sys
import traceback
from typing import Callable, List, Tuple

import numpy as np
import torch

# kernel vs plain version: fp32 sums in other orders (products exact)
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-3


def _t_torch(device) -> str:
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return (f"torch {torch.__version__} (cuda {torch.version.cuda}), "
            f"{torch.cuda.device_count()} card(s); running on {name}")


def _kernel_probe(layout: str, wrapper: str, seed: int) -> str:
    """Build a 16-doc ``layout`` index on the card, launch the layout's
    kernel through ``ops/maxsim.py::<wrapper>`` and hold it against its
    plain version on the same operands."""
    from ..index.dense import DenseTokenIndex
    from ..ops import maxsim
    from ..utils.device import resolve_device

    dev = resolve_device(None)          # the card, or "no CUDA device"
    g = torch.Generator().manual_seed(seed)
    toks = torch.randn((16, 32, 128), generator=g)
    toks = toks / toks.norm(dim=-1, keepdim=True)
    lengths = torch.randint(16, 33, (16,), generator=g, dtype=torch.int32)
    q = torch.randn((2, 32, 128), generator=g)
    q = (q / q.norm(dim=-1, keepdim=True)).to(dev)
    idx = DenseTokenIndex.build(toks.to(dev), lengths.to(dev), doc_len=32,
                                dtype=layout)
    scales = {"int8": idx.scales, "int8-doc": idx.doc_scales,
              "int4-doc": idx.doc_scales}.get(layout)
    args = (q, idx.emb_flat) + ((scales,) if scales is not None else ()) \
        + (idx.doc_lengths,)
    fn = getattr(maxsim, wrapper)
    n0 = fn.launches
    got = fn(*args, doc_len=32)
    if fn.launches != n0 + 1:
        raise AssertionError(f"{wrapper} did not launch its kernel")
    ref = getattr(maxsim, wrapper + "_reference")(*args, doc_len=32)
    torch.cuda.synchronize(dev)
    err = float((got - ref).abs()[:, :16].max())
    if not torch.allclose(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise AssertionError(f"kernel vs plain version max|err|={err:.2e}")
    return (f"{layout} kernel ({torch.cuda.get_device_name(dev)}) vs plain "
            f"version max|err|={err:.2e}")


def _t_kernel_bf16(device) -> str:
    return _kernel_probe("bfloat16", "maxsim_scores", 0)


def _t_kernel_f32(device) -> str:
    return _kernel_probe("float32", "maxsim_scores", 4)


def _t_kernel_int8(device) -> str:
    return _kernel_probe("int8", "maxsim_scores_int8", 1)


def _t_kernel_int8_doc(device) -> str:
    return _kernel_probe("int8-doc", "maxsim_scores_int8_doc", 2)


def _t_kernel_int4_doc(device) -> str:
    return _kernel_probe("int4-doc", "maxsim_scores_int4_doc", 3)


def _t_bm25(device) -> str:
    # behavioral parity with the reference's Test 1
    # (model_downloader_simplified.py:118-127): 2-doc index + query
    from ..index.lexical import LexicalIndex
    from ..ops.bm25 import bm25_scores_device
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    idx = LexicalIndex.build(["a cat sits on the mat", "dogs chase cats"])
    s = bm25_scores_device(
        torch.as_tensor(np.stack([idx.encode_query("cat")]), device=dev),
        *(torch.as_tensor(a, device=dev)
          for a in (idx.indptr, idx.post_docs, idx.post_weights)),
        n_docs=2, max_postings=idx.max_postings)
    assert float(s[0, 0]) > 0 and float(s[0, 1]) > 0
    return "BM25 index+query round trip OK"


def _t_tokenizer(device) -> str:
    from ..models.tokenizer import ColBERTTokenizer

    tok = ColBERTTokenizer.train_bpe(["hello world"] * 8, vocab_size=300)
    ids = tok.encode_query("hello", 16)
    assert ids[0] == tok.bos
    return f"BPE trainable offline (vocab {tok.vocab_size})"


def _t_encoder(device) -> str:
    from ..models.colbert import ColBERTConfig, ColBERTEncoder
    from ..models.tokenizer import ColBERTTokenizer

    tok = ColBERTTokenizer.train_bpe(["quick brown fox"] * 4, vocab_size=300)
    enc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=tok.vocab_size), tok,
                         device=device)
    q = enc.encode_queries(["fox"])
    assert q.shape[-1] == 32
    return f"encoder forward OK {tuple(q.shape)} on {q.device}"


def _t_fused_cascade(device) -> str:
    """The production serving path: encoder forward + the whole hybrid
    cascade as one dispatch (retrieval/cascade.py ``HybridRetriever``,
    a CUDA graph replay on the card), route 0 through the int8 kernel,
    with the final_fusion selector."""
    from ..config import MeshConfig, RAGConfig
    from ..index.manager import IndexManager
    from ..models.colbert import ColBERTConfig, ColBERTEncoder
    from ..models.tokenizer import ColBERTTokenizer
    from ..retrieval.cascade import HybridRetriever

    corpus = [f"doc {i} about topic{i % 7} and topic{(i + 3) % 7}"
              for i in range(40)]
    tok = ColBERTTokenizer.train_bpe(corpus, vocab_size=300)
    enc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=tok.vocab_size), tok,
                         device=device)
    cfg = RAGConfig(dense_prefilter=0, final_fusion="rrf",
                    doc_max_tokens=32, bm25_top_k=20, colbert_top_k=20,
                    fusion_candidates=10, final_top_k=5,
                    mesh=MeshConfig(index_dtype="int8"))
    mgr = IndexManager(cfg, enc, device=device)
    mgr.build_all(corpus)
    ids, _ = HybridRetriever(cfg, mgr, enc, device=device).retrieve_batch(
        ["topic3 doc"])
    assert ids.shape == (1, 5) and (ids[0] >= 0).all()
    return f"one-dispatch retrieve OK (top ids {ids[0][:3].tolist()})"


def _t_native(device) -> str:
    from ..utils.native import get_lib, library_path, stem_native

    if get_lib() is None:
        return ("native lib NOT built (pure-Python fallback active): "
                "g++ failed or HRAG_NO_NATIVE is set")
    assert stem_native("running") == "run"
    return f"native textproc lib loaded ({library_path().name})"


TESTS: List[Tuple[str, Callable[[object], str]]] = [
    ("torch device", _t_torch),
    ("cuda maxsim bf16", _t_kernel_bf16),
    ("cuda maxsim f32", _t_kernel_f32),
    ("cuda maxsim int8", _t_kernel_int8),
    ("cuda maxsim int8-doc", _t_kernel_int8_doc),
    ("cuda maxsim int4-doc", _t_kernel_int4_doc),
    ("bm25 end-to-end", _t_bm25),
    ("tokenizer", _t_tokenizer),
    ("encoder", _t_encoder),
    ("fused one-dispatch cascade", _t_fused_cascade),
    ("native textproc", _t_native),
]
KERNEL_TESTS = tuple(n for n, _ in TESTS if n.startswith("cuda maxsim"))


def convert(hf_dir: str, out: str) -> None:
    """A local HF checkpoint -> the JAX package's ``encoder_params.npz``
    (geometry and rotary settings from its config.json, else
    jina-colbert-v2's)."""
    from ..models.colbert import ColBERTConfig, ColBERTModel, params_to_jax
    from ..models.convert import colbert_config_from_hf, convert_hf_dir

    try:
        cfg = colbert_config_from_hf(hf_dir)
    except FileNotFoundError:
        cfg = ColBERTConfig.jina_colbert_v2()
    state = convert_hf_dir(hf_dir, cfg)
    with torch.device("meta"):
        model = ColBERTModel(cfg)
    model.to_empty(device="cpu")
    model.load_state_dict(state)
    np.savez(out, **params_to_jax(model))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--convert"]:
        if len(argv) != 3:
            print("usage: check_env --convert <hf_checkpoint_dir> <out.npz>")
            return 2
        convert(argv[1], argv[2])
        print(f"converted {argv[1]} -> {argv[2]}")
        return 0
    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    failures = 0
    for name, fn in TESTS:
        try:
            msg = fn(device)
            print(f"  [ok]   {name}: {msg}")
        except Exception as e:       # noqa: BLE001 — reported per check
            failures += 1
            print(f"  [FAIL] {name}: {e}")
            if "-v" in argv:
                traceback.print_exc()
    print(f"\n{len(TESTS) - failures}/{len(TESTS)} checks passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
