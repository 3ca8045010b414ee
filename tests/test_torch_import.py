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
    assert {f"{PORT}.app.application", f"{PORT}.app.cli",
            f"{PORT}.app.server", f"{PORT}.train.trainer",
            f"{PORT}.retrieval.gate", f"{PORT}.ingest.pdf",
            f"{PORT}.models.convert", f"{PORT}.index.bucketed",
            f"{PORT}.parallel", f"{PORT}.parallel.mesh",
            f"{PORT}.parallel.sharded", f"{PORT}.parallel.distributed",
            f"{PORT}.index.checkpoint", f"{PORT}.parallel.params",
            f"{PORT}.utils.timing", f"{PORT}.utils.profiling",
            f"{PORT}.utils.native", f"{PORT}.tools.check_env",
            f"{PORT}.tools.eval_recall", f"{PORT}.tools.organic_questions",
            f"{PORT}.tools.serve_probe", f"{PORT}.tools.stage_probe",
            f"{PORT}.bench", f"{PORT}.examples.demo"} <= set(mods)
    # neither JAX nor what the card's machine lacks (requests, PyMuPDF,
    # safetensors) nor the JAX trainer's optimizer and checkpoint
    # libraries
    banned = ("jax", "flax", "ml_dtypes", JAX_PKG, "requests", "fitz",
              "pymupdf4llm", "optax", "orbax", "safetensors")
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        banned = {banned!r}
        bad = [k for k in sys.modules
               if k in banned or k.startswith(tuple(b + "." for b in banned))]
        print(repr(bad))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    from hybrid_rag_colbertv2_tpu_torch.app.application import (
        RAGApplication)
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.bucketed import (
        BucketedDenseIndex)
    from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
    from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
    from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
        ColBERTConfig, ColBERTEncoder)
    from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer
    from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import (
        HybridRetriever)
    from hybrid_rag_colbertv2_tpu_torch.train.trainer import (
        ColBERTTrainer, TrainConfig)

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
    BucketedDenseIndex.build(
        torch.zeros((2, 8, 32)), torch.tensor([3, 8]), bucket_sizes=(32,),
        dtype="int8").save(tmp_path / "bucketed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BucketedDenseIndex.load(tmp_path / "bucketed")
    assert BucketedDenseIndex.load(tmp_path / "bucketed",
                                   device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridRetriever(cfg, mgr, enc)
    # the mesh spans the cards unless given devices; a checkpoint loads
    # onto the card unless asked for the CPU
    from hybrid_rag_colbertv2_tpu_torch.index.checkpoint import (
        load_sharded, save_sharded)
    from hybrid_rag_colbertv2_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(devices=[torch.device("cpu")] * 2).shape == {
        "data": 2, "model": 1}
    save_sharded(mgr.dense, tmp_path / "ck")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_sharded(tmp_path / "ck")
    assert load_sharded(tmp_path / "ck", device="cpu").device.type == "cpu"
    ids, _ = HybridRetriever(cfg, mgr, enc, device="cpu").retrieve_batch(
        ["beta gamma"], 2)
    assert ids.shape == (1, 2)
    # the app and the trainer: the app needs the card unless asked for
    # the CPU; the trainer runs on its encoder's device
    app_cfg = RAGConfig(db_path=str(tmp_path / "rag.db"),
                        bm25_index_path=str(tmp_path / "bm25"),
                        colbert_index_path=str(tmp_path / "colbert"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAGApplication(app_cfg, use_ollama=False)
    assert RAGApplication(app_cfg, use_ollama=False,
                          device="cpu").device.type == "cpu"
    trainer = ColBERTTrainer(enc, TrainConfig(batch_size=2, doc_len=8,
                                              steps=1))
    assert trainer.device.type == "cpu"
    batch = trainer._make_batch([("alpha", "alpha beta"),
                                 ("delta", "delta epsilon")])
    assert {t.device.type for t in batch.values()} == {"cpu"}


def test_unported_layouts_raise(tmp_path):
    """Every layout builds and serves, the bucketed one too: a bucketed
    directory the JAX package saved loads through the manager (it used to
    raise before index/bucketed.py was ported); ``auto`` resolves to int8
    on the CPU."""
    import jax.numpy as jnp
    import numpy as np
    from hybrid_rag_colbertv2_tpu.index.bucketed import (
        BucketedDenseIndex as JaxBucketedDenseIndex)
    from hybrid_rag_colbertv2_tpu.index.dense import (
        DenseTokenIndex as JaxDenseTokenIndex)
    from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig, RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.index.bucketed import (
        BucketedDenseIndex)
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
    bk = JaxBucketedDenseIndex.build(jnp.asarray(embs), jnp.asarray(lengths),
                                     bucket_sizes=(32, 64), dtype="int8")
    bk.save(tmp_path / "bk")
    cfg = RAGConfig(bm25_index_path=str(tmp_path / "bm25"),
                    colbert_index_path=str(tmp_path / "bk"))
    LexicalIndex.build(["alpha beta"]).save(cfg.bm25_index_path)
    mgr = IndexManager(cfg, device="cpu")
    mgr.load()
    assert isinstance(mgr.dense, BucketedDenseIndex)
    np.testing.assert_allclose(
        mgr.dense.search_scores(torch.from_numpy(q)).numpy(),
        np.asarray(bk.search_scores(jnp.asarray(q))), rtol=1e-5, atol=1e-4)
    assert MeshConfig(index_dtype="auto").resolve_index_dtype(
        10, 128, device="cpu") == "int8"


def test_tools_need_cuda_unless_cpu(monkeypatch, tmp_path, capsys):
    """The tools run on the card unless given the CPU: without one the
    stage probe, the eval and the serving probe raise the port's error,
    and check_env fails every device check (the kernel probes always)."""
    from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
    from hybrid_rag_colbertv2_tpu_torch.tools import (
        check_env, eval_recall, serve_probe, stage_probe)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_probe.main(["--n-docs", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_probe.main(["--flagship"])
    RAGConfig(db_path=str(tmp_path / "rag.db")).save(tmp_path / "cfg.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_recall.main(["--config", str(tmp_path / "cfg.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_probe.build_app(str(tmp_path / "sp"), 1, 0)
    capsys.readouterr()
    assert check_env.main([]) == 1
    out = capsys.readouterr().out
    ok = {ln.split(":")[0][9:] for ln in out.splitlines()
          if ln.startswith("  [ok]")}
    assert ok == {"tokenizer", "native textproc"}, out
