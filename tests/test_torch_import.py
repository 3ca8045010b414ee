"""The port imports neither JAX nor the JAX package, and its entry
points run on the card unless asked for the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = "hybrid_rag_colbertv2_tpu_torch"
JAX_PKG = "hybrid_rag_colbertv2_tpu"


def _port_modules():
    return sorted(
        ".".join((PORT,) + p.relative_to(REPO / PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (REPO / PORT).rglob("*.py"))


def test_port_imports_no_jax():
    mods = _port_modules()
    assert f"{PORT}.ops.maxsim" in mods and f"{PORT}.retrieval.cascade" in mods
    assert f"{PORT}.utils.cache" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = [k for k in sys.modules
               if k in ("jax", "flax", "ml_dtypes", {JAX_PKG!r})
               or k.startswith(("jax.", "flax.", {JAX_PKG + "."!r}))]
        print(repr(bad))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RAGConfig(bm25_index_path=str(tmp_path / "bm25"),
                    colbert_index_path=str(tmp_path / "colbert"))
    enc_cfg = ColBERTConfig.tiny(vocab_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColBERTEncoder(enc_cfg, HashTokenizer(64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IndexManager(cfg)
    enc = ColBERTEncoder(enc_cfg, HashTokenizer(64), device="cpu")
    mgr = IndexManager(cfg, enc, device="cpu")
    mgr.build_all(["alpha beta gamma", "beta gamma delta", "delta epsilon"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseTokenIndex.load(cfg.colbert_index_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridRetriever(cfg, mgr, enc)
    ids, _ = HybridRetriever(cfg, mgr, enc, device="cpu").retrieve_batch(
        ["beta gamma"], 2)
    assert ids.shape == (1, 2)


def test_unported_layouts_raise(tmp_path):
    """Every flat layout builds and serves; what is still unported (the
    bucketed layout) raises; ``auto`` resolves to int8 on the CPU."""
    import jax.numpy as jnp
    import numpy as np
    from hybrid_rag_colbertv2_tpu.index.dense import (
        DenseTokenIndex as JaxDenseTokenIndex)
    from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig, RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager

    embs = np.random.default_rng(0).standard_normal((3, 64, 32), np.float32)
    lengths = np.array([5, 64, 0], np.int32)
    q = np.random.default_rng(1).standard_normal((1, 32, 32), np.float32)
    # a bf16 directory saved by the JAX package loads, bits intact, and
    # its search serves the JAX package's scores
    bf = JaxDenseTokenIndex.build(jnp.asarray(embs), jnp.asarray(lengths),
                                  doc_len=64, dtype="bfloat16")
    bf.save(tmp_path / "bf")
    loaded = DenseTokenIndex.load(tmp_path / "bf", device="cpu")
    assert loaded.quant == "bfloat16"
    np.testing.assert_array_equal(
        loaded.emb_flat.view(torch.int16).numpy().view(np.uint16),
        np.asarray(bf.emb_flat).view(np.uint16))
    np.testing.assert_allclose(
        loaded.search_scores(torch.from_numpy(q)).numpy(),
        np.asarray(bf.search_scores(jnp.asarray(q))), rtol=1e-5, atol=1e-4)
    for dtype in ("bfloat16", "int4-doc"):
        built = DenseTokenIndex.build(torch.from_numpy(embs),
                                      torch.from_numpy(lengths), doc_len=64,
                                      dtype=dtype)
        assert built.quant == dtype
        assert built.search_scores(torch.from_numpy(q)).shape == (1, 3)
    (tmp_path / "bk").mkdir()
    (tmp_path / "bk" / "meta.json").write_text('{"n_buckets": 2}')
    cfg = RAGConfig(bm25_index_path=str(tmp_path / "bm25"),
                    colbert_index_path=str(tmp_path / "bk"))
    LexicalIndex.build(["alpha beta"]).save(cfg.bm25_index_path)
    with pytest.raises(NotImplementedError, match="bucketed"):
        IndexManager(cfg, device="cpu").load()
    assert MeshConfig(index_dtype="auto").resolve_index_dtype(
        10, 128, device="cpu") == "int8"
