"""The port's checkpoint conversion against the JAX package's, on the CPU.

Synthetic HF checkpoint directories (tiny geometry, seeded weights) in
the jina-xlm-roberta rotary flash layout and the vanilla XLM-RoBERTa
layout, as ``pytorch_model.bin`` and as ``model.safetensors`` in F32,
F16 and BF16 (written with the ``safetensors`` package, which the port
never imports): the port's ``convert_hf_dir`` + forward must equal JAX's
``convert_hf_dir`` + forward within atol 1e-5 (fp32, as
``test_torch_encoder.py`` holds the encoders). The port's safetensors
reader must equal ``safetensors.numpy.load_file`` bit for bit. Strict
conversion is held at the full jina-colbert-v2 width on meta tensors,
which cost no memory.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (numpy learns bfloat16 for safetensors.numpy)
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.torch import save_file as st_save_torch

from hybrid_rag_colbertv2_tpu.app.application import RAGApplication as JaxApp
from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.models import colbert as jc
from hybrid_rag_colbertv2_tpu.models import convert as jconv
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer)
from hybrid_rag_colbertv2_tpu_torch.app.application import RAGApplication
from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
from hybrid_rag_colbertv2_tpu_torch.models import colbert as tc
from hybrid_rag_colbertv2_tpu_torch.models import convert as tconv
from hybrid_rag_colbertv2_tpu_torch.models.colbert import params_to_jax
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import ColBERTTokenizer
from test_convert_manifest import flash_manifest

H, NH, LAYERS, INTER, DIM, MAX_POS = 32, 4, 2, 64, 16, 128
CORPUS = ["the quick brown fox", "retrieval with token level matching",
          "systolic arrays multiply matrices"] * 8
TEXTS = ["quick brown fox jumps", "token level retrieval",
         "arrays of systolic matrices multiply quickly over the fox"]
ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
             "BF16": torch.bfloat16}


def _state(layout: str, vocab: int, head: bool = True, seed: int = 0):
    """A seeded torch state_dict of ``layout`` ("flash" or "xlmr") under
    the ColBERT wrapper's ``bert.`` / ``roberta.`` prefix."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * 0.08

    if layout == "flash":
        sd = {"bert.embeddings.word_embeddings.weight": w(vocab, H),
              "bert.embeddings.token_type_embeddings.weight": w(1, H),
              "bert.emb_ln.weight": 1 + w(H), "bert.emb_ln.bias": w(H)}
        for i in range(LAYERS):
            pre = f"bert.encoder.layers.{i}"
            sd.update({
                f"{pre}.mixer.Wqkv.weight": w(3 * H, H),
                f"{pre}.mixer.Wqkv.bias": w(3 * H),
                f"{pre}.mixer.out_proj.weight": w(H, H),
                f"{pre}.mixer.out_proj.bias": w(H),
                f"{pre}.norm1.weight": 1 + w(H), f"{pre}.norm1.bias": w(H),
                f"{pre}.norm2.weight": 1 + w(H), f"{pre}.norm2.bias": w(H),
                f"{pre}.mlp.fc1.weight": w(INTER, H),
                f"{pre}.mlp.fc1.bias": w(INTER),
                f"{pre}.mlp.fc2.weight": w(H, INTER),
                f"{pre}.mlp.fc2.bias": w(H),
                f"{pre}.mixer.rotary_emb.inv_freq": torch.ones(H // NH // 2),
            })
    else:
        sd = {"roberta.embeddings.word_embeddings.weight": w(vocab, H),
              "roberta.embeddings.position_embeddings.weight": w(MAX_POS, H),
              "roberta.embeddings.token_type_embeddings.weight": w(1, H),
              "roberta.embeddings.LayerNorm.weight": 1 + w(H),
              "roberta.embeddings.LayerNorm.bias": w(H),
              "roberta.pooler.dense.weight": w(H, H),
              "roberta.pooler.dense.bias": w(H)}
        for i in range(LAYERS):
            pre = f"roberta.encoder.layer.{i}"
            for name, shape in (("attention.self.query", (H, H)),
                                ("attention.self.key", (H, H)),
                                ("attention.self.value", (H, H)),
                                ("attention.output.dense", (H, H)),
                                ("intermediate.dense", (INTER, H)),
                                ("output.dense", (H, INTER))):
                sd[f"{pre}.{name}.weight"] = w(*shape)
                sd[f"{pre}.{name}.bias"] = w(shape[0])
            for name in ("attention.output.LayerNorm", "output.LayerNorm"):
                sd[f"{pre}.{name}.weight"] = 1 + w(H)
                sd[f"{pre}.{name}.bias"] = w(H)
    if head:
        sd["linear.weight"] = w(DIM, H)
    return sd


def _write_dir(path: Path, layout: str, fmt: str, head: bool = True,
               tokenizer: bool = True):
    """A checkpoint directory: config.json, weights as ``fmt`` ("bin" or
    a safetensors dtype), and a BPE tokenizer.json (JAX's)."""
    path.mkdir(parents=True, exist_ok=True)
    tok = JaxTokenizer.train_bpe(CORPUS, vocab_size=300)
    hf = {"vocab_size": tok.vocab_size, "hidden_size": H,
          "num_hidden_layers": LAYERS, "num_attention_heads": NH,
          "intermediate_size": INTER, "max_position_embeddings": MAX_POS,
          "type_vocab_size": 1, "layer_norm_eps": 1e-5, "pad_token_id": 1}
    if layout == "flash":
        hf["rotary_emb_base"] = 10000.0
    (path / "config.json").write_text(json.dumps(hf))
    sd = _state(layout, tok.vocab_size, head=head)
    if fmt == "bin":
        torch.save(sd, path / "pytorch_model.bin")
    else:
        st_save_torch({k: v.to(ST_DTYPES[fmt]).contiguous()
                       for k, v in sd.items()}, str(path / "model.safetensors"),
                      metadata={"format": "pt"})
    if tokenizer:
        tok.save(path / "tokenizer.json")
    return sd


def _jax_cfg(ckpt):
    return jconv.colbert_config_from_hf(str(ckpt), colbert_dim=DIM)


def _port_cfg(ckpt):
    return tconv.colbert_config_from_hf(str(ckpt), colbert_dim=DIM)


@pytest.mark.parametrize("layout", ["flash", "xlmr"])
@pytest.mark.parametrize("fmt", ["bin", "F32", "F16", "BF16"])
def test_converted_forward_equals_jax(layout, fmt, tmp_path):
    ckpt = tmp_path / "ckpt"
    _write_dir(ckpt, layout, fmt)
    jcfg, tcfg = _jax_cfg(ckpt), _port_cfg(ckpt)
    jparams = jconv.convert_hf_dir(str(ckpt), jcfg)
    state = tconv.convert_hf_dir(str(ckpt), tcfg)
    assert all(t.dtype == torch.float32 for t in state.values())
    jtok = JaxTokenizer.load(ckpt / "tokenizer.json")
    ptok = ColBERTTokenizer.load(ckpt / "tokenizer.json")
    jenc = jc.ColBERTEncoder(jcfg, jtok, params=jparams)
    penc = tc.ColBERTEncoder(tcfg, ptok, params=state, device="cpu")
    np.testing.assert_allclose(penc.encode_queries(TEXTS).numpy(),
                               np.asarray(jenc.encode_queries(TEXTS)),
                               atol=1e-5, rtol=0)
    pd, pl = penc.encode_docs(TEXTS, doc_len=32)
    jd, jl = jenc.encode_docs(TEXTS, doc_len=32)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-5, rtol=0)
    # the converted tree is JAX's, value for value (fp32 widening exact)
    flat = params_to_jax(penc.model)
    jflat = {"/".join(k): v for k, v in _flatten(jparams)}
    assert set(flat) == set(jflat)
    for k, v in flat.items():
        np.testing.assert_array_equal(
            v, np.asarray(jflat[k]).astype(np.float32), err_msg=k)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_safetensors_reader_equals_package(tmp_path):
    """Every dtype the reader knows, a 0-d and an empty tensor, and the
    ``__metadata__`` entry, bit for bit against safetensors.numpy; a
    two-shard directory reads as the union in sorted shard order."""
    g = torch.Generator().manual_seed(1)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
        "f64": torch.randn(4, generator=g).double(),
        "i64": torch.randint(-9, 9, (6,), generator=g),
        "i32": torch.randint(-9, 9, (2, 2), generator=g).int(),
        "i8": torch.randint(-9, 9, (5,), generator=g).to(torch.int8),
        "u8": torch.randint(0, 255, (3,), generator=g).to(torch.uint8),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }
    path = tmp_path / "one.safetensors"
    st_save_torch(tensors, str(path), metadata={"format": "pt", "x": "y"})
    got = tconv.read_safetensors(path)
    want = st_load_numpy(str(path))
    assert set(got) == set(want) == set(tensors)
    for k, arr in want.items():
        t = got[k]
        assert tuple(t.shape) == arr.shape, k
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert raw.numpy().tobytes() == arr.tobytes(), k
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    st_save_torch({"a": tensors["f32"], "b": tensors["i64"]},
                  str(shard_dir / "model-00001-of-00002.safetensors"))
    st_save_torch({"b": tensors["i32"].long(), "c": tensors["bf16"]},
                  str(shard_dir / "model-00002-of-00002.safetensors"))
    state = tconv.load_hf_state(str(shard_dir))
    assert set(state) == {"a", "b", "c"}
    # the later shard wins a repeated name, as JAX's dict.update does
    np.testing.assert_array_equal(state["b"].numpy(),
                                  tensors["i32"].long().numpy())
    assert torch.equal(state["c"], tensors["bf16"])
    with pytest.raises(FileNotFoundError):
        tconv.load_hf_state(str(tmp_path / "nothing"))


def _meta_state(manifest, extra=()):
    return {k: torch.empty(shape, dtype=torch.float16, device="meta")
            for k, shape in (*manifest, *extra)}


def test_strict_consumes_full_jina_manifest():
    """The published jina-colbert-v2 tensor set at full width, on meta
    tensors: consumed exactly, and the result is exactly the port
    model's state_dict, name for name and shape for shape."""
    cfg = tc.ColBERTConfig.jina_colbert_v2()
    state = _meta_state(flash_manifest())
    assert tconv.is_flash_layout(state)
    out = tconv.convert_state_dict(state, cfg, projection_key="linear.weight",
                                   strict=True)
    with torch.device("meta"):
        model = tc.ColBERTModel(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in out.items()} == want
    assert all(v.dtype == torch.float32 for v in out.values())
    assert sum(int(np.prod(s)) for s in want.values()) > 5.5e8
    # JAX's converter on the same names: the same tensors, transposed
    jout = jconv.convert_state_dict(
        {k: np.broadcast_to(np.float16(0), s) for k, s in flash_manifest(
            n_layers=1)}, jc.ColBERTConfig.jina_colbert_v2(num_layers=1),
        projection_key="linear.weight", strict=True)
    assert jout["layer_0"]["attention"]["query"]["kernel"].shape == tuple(
        out["layers.0.attention.query.weight"].shape[::-1])


def test_strict_flags_unconsumed_and_tolerates_ignored():
    cfg = tc.ColBERTConfig(vocab_size=96, hidden_size=H, num_layers=LAYERS,
                           num_heads=NH, intermediate_size=INTER,
                           colbert_dim=DIM)
    manifest = flash_manifest(h=H, i_=INTER, n_layers=LAYERS, v=96, dim=DIM)
    lora = [("bert.encoder.layers.0.mixer.Wqkv_lora.weight", (8, H))]
    with pytest.raises(ValueError, match="consumed"):
        tconv.convert_state_dict(_meta_state(manifest, lora), cfg,
                                 projection_key="linear.weight", strict=True)
    # not strict: the extra key is ignored, as in JAX
    tconv.convert_state_dict(_meta_state(manifest, lora), cfg,
                             projection_key="linear.weight")
    missing = _meta_state(manifest)
    del missing["bert.encoder.layers.1.mixer.Wqkv.weight"]
    with pytest.raises(KeyError):
        tconv.convert_state_dict(missing, cfg, projection_key="linear.weight",
                                 strict=True)
    extra = [(f"bert.encoder.layers.{i}.mixer.rotary_emb.inv_freq",
              (H // NH // 2,)) for i in range(LAYERS)]
    extra += [("bert.pooler.dense.weight", (H, H)),
              ("bert.pooler.dense.bias", (H,))]
    out = tconv.convert_state_dict(_meta_state(manifest, extra), cfg,
                                   projection_key="linear.weight", strict=True)
    assert "colbert_linear.weight" in out


@pytest.mark.parametrize("layout", ["flash", "xlmr"])
def test_colbert_config_from_hf_equals_jax(layout, tmp_path):
    _write_dir(tmp_path, layout, "F32", tokenizer=False)
    for over in ({}, dict(colbert_dim=DIM, query_max_tokens=16,
                          doc_max_tokens=64)):
        got = dataclasses.asdict(tconv.colbert_config_from_hf(
            str(tmp_path), **over))
        want = dataclasses.asdict(jconv.colbert_config_from_hf(
            str(tmp_path), **over))
        assert got.pop("dtype") == torch.float32
        assert want.pop("dtype") == jnp.float32
        assert got == want
    assert got["position_embedding"] == (
        "rope" if layout == "flash" else "learned")


def _app_kw(root: Path, ckpt: Path, **over):
    kw = dict(db_path=str(root / "rag.db"),
              bm25_index_path=str(root / "idx/bm25"),
              colbert_index_path=str(root / "idx/colbert"),
              images_dir=str(root / "img"),
              tokenizer_path=str(root / "idx/tok.json"),
              min_chunk_size=8, max_chunk_size=256,
              encoder_checkpoint=str(ckpt))
    kw.update(over)
    return kw


def _docs(root: Path):
    (root / "a.md").write_text(
        "# Animals\n\nthe quick brown fox jumps over the lazy dog " * 4)
    (root / "b.md").write_text(
        "# Chips\n\nsystolic arrays multiply matrices with high "
        "throughput " * 4)
    return [str(root / "a.md"), str(root / "b.md")]


def test_app_on_checkpoint_equals_jax(tmp_path):
    """An app with ``encoder_checkpoint`` (flash layout, BF16
    safetensors) gives the JAX app's ``query`` ids on the same directory
    and corpus; geometry, tokenizer and weights come from the checkpoint,
    nothing trains, and the converted params persist beside the index in
    JAX's ``encoder_params.npz``."""
    ckpt = tmp_path / "ckpt"
    _write_dir(ckpt, "flash", "BF16")
    docs = _docs(tmp_path)
    japp = JaxApp(JaxConfig(**_app_kw(tmp_path / "jax", ckpt)),
                  use_ollama=False)
    japp.index_documents(docs)
    app = RAGApplication(RAGConfig(**_app_kw(tmp_path / "port", ckpt)),
                         use_ollama=False, device="cpu")
    assert not app._should_train(["x"] * 64)
    app.index_documents(docs)
    assert not (tmp_path / "port/idx/colbert/encoder_trained.json").exists()
    assert app.encoder.cfg.position_embedding == "rope"
    assert app.encoder.cfg.num_layers == LAYERS
    assert app.encoder.cfg.lexical_anchor == 0.0
    assert app.encoder.tokenizer.vocab_size == japp.encoder.tokenizer.vocab_size
    with np.load(tmp_path / "port/idx/colbert/encoder_params.npz") as saved:
        jflat = {"/".join(k): np.asarray(v) for k, v in _flatten(
            japp.encoder.params)}
        assert set(saved.files) == set(jflat)
        for k in saved.files:
            np.testing.assert_array_equal(saved[k],
                                          jflat[k].astype(np.float32))
    for q in ("quick brown fox", "systolic matrices", "lazy dog throughput"):
        want = japp.query(q, top_k=3)
        got = app.query(q, top_k=3)
        assert [r["chunk_id"] for r in got] == [r["chunk_id"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], atol=1e-4)


def test_app_checkpoint_without_tokenizer_or_head(tmp_path):
    """No tokenizer.json raises FileNotFoundError (JAX's reason); a
    backbone-only checkpoint gets a random (hidden, dim) head at scale
    0.02 from the seed, and with that head loaded into JAX's converted
    params both packages encode alike."""
    bare = tmp_path / "bare"
    _write_dir(bare, "flash", "F32", tokenizer=False)
    app = RAGApplication(RAGConfig(**_app_kw(tmp_path / "a", bare)),
                         use_ollama=False, device="cpu")
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        app._make_encoder(["some text"])
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        JaxApp(JaxConfig(**_app_kw(tmp_path / "j", bare)),
               use_ollama=False)._make_encoder(["some text"])

    ckpt = tmp_path / "backbone"
    _write_dir(ckpt, "flash", "F32", head=False)
    app = RAGApplication(RAGConfig(**_app_kw(tmp_path / "b", ckpt)),
                         use_ollama=False, device="cpu")
    enc = app._make_encoder(CORPUS)
    kernel = params_to_jax(enc.model)["colbert_linear/kernel"]
    assert kernel.shape == (H, 128)
    assert 0.017 < float(kernel.std()) < 0.023 and abs(kernel.mean()) < 3e-3
    again = app._make_encoder(CORPUS)
    assert torch.equal(again.model.colbert_linear.weight,
                       enc.model.colbert_linear.weight)
    jcfg = jconv.colbert_config_from_hf(str(ckpt))
    jparams = jconv.convert_hf_dir(str(ckpt), jcfg)
    jparams["colbert_linear"] = {"kernel": jnp.asarray(kernel)}
    jenc = jc.ColBERTEncoder(jcfg, JaxTokenizer.load(ckpt / "tokenizer.json"),
                             params=jparams)
    np.testing.assert_allclose(enc.encode_queries(TEXTS).numpy(),
                               np.asarray(jenc.encode_queries(TEXTS)),
                               atol=1e-5, rtol=0)


def test_cli_and_server_on_checkpoint_over_bucketed(tmp_path):
    """``--upload`` and ``--query`` through the port's CLI, and the
    server's /query, with a config that sets ``encoder_checkpoint`` and
    ``index_layout="bucketed"``: the index is bucketed, nothing trains,
    and the CLI's and the server's ids are ``app.query``'s."""
    import io
    import threading
    import urllib.request
    from contextlib import redirect_stdout

    from hybrid_rag_colbertv2_tpu_torch.app import cli
    from hybrid_rag_colbertv2_tpu_torch.app.server import make_server
    from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig
    from hybrid_rag_colbertv2_tpu_torch.index.bucketed import (
        BucketedDenseIndex)

    ckpt = tmp_path / "ckpt"
    _write_dir(ckpt, "flash", "F16")
    docs = _docs(tmp_path)
    cfg = RAGConfig(**_app_kw(tmp_path, ckpt, final_fusion="rerank"),
                    mesh=MeshConfig(index_layout="bucketed",
                                    doc_token_buckets=(32, 64)))
    cfg.save(tmp_path / "cfg.json")
    base = ["--config", str(tmp_path / "cfg.json"), "--device", "cpu",
            "--no-generate", "--json"]

    def run(argv):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(base + argv) == 0
        return json.loads(buf.getvalue())

    up = run(["--upload", docs[0], "--upload", docs[1]])
    assert up["total_chunks"] > 0 and "train" not in str(up["timings"])
    got = [r["chunk_id"] for r in run(["--query", "quick brown fox"])]
    app = RAGApplication(RAGConfig.load(tmp_path / "cfg.json"),
                         use_ollama=False, device="cpu")
    want = [r["chunk_id"] for r in app.query("quick brown fox")]
    assert got == want and want
    assert isinstance(app.indexes.dense, BucketedDenseIndex)
    assert not (tmp_path / "idx/colbert/encoder_trained.json").exists()
    httpd, batcher = make_server(app, port=0, max_batch=4,
                                 batch_window_s=0.005)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/query",
            data=json.dumps({"query": "quick brown fox"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            rows = json.loads(resp.read())["results"]
    finally:
        httpd.shutdown()
        batcher.close()
        httpd.server_close()
    th.join(timeout=30)
    assert not th.is_alive()
    assert [r["chunk_id"] for r in rows] == want
