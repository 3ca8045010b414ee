"""The port's training side of sharding (parallel/params.py, the
trainer's ``mesh``) against the JAX package's, on the CPU.

JAX runs on the conftest's 8 virtual CPU devices; the port on a mesh of
the same shape over ``[cpu] * 8`` (one process drives every shard). Both
start from equal params (JAX's ``encoder_params.npz``) and tokenizers.

Tolerances: the TP forward rtol = atol = 2e-5 (JAX's own test,
``tests/test_sharded.py:226``); the DP x TP steps as
``tests/test_torch_train.py``: losses rtol 1e-5, parameters atol 1e-5,
the attention key biases (a zero gradient in exact arithmetic, which Adam
turns into steps of up to the learning rate) bounded by the schedule.
Three steps with ``warmup_steps=1``: the first update is zero.
"""

import logging
import re

import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.config import MeshConfig as JaxMesh
from hybrid_rag_colbertv2_tpu.config import RAGConfig as JaxConfig
from hybrid_rag_colbertv2_tpu.index.dense import DenseTokenIndex as JaxDense
from hybrid_rag_colbertv2_tpu.index.lexical import LexicalIndex as JaxLex
from hybrid_rag_colbertv2_tpu.models.colbert import (
    ColBERTConfig as JaxColCfg, ColBERTEncoder as JaxEncoder)
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer)
from hybrid_rag_colbertv2_tpu.parallel import mesh as jax_mesh
from hybrid_rag_colbertv2_tpu.parallel import params as jax_params
from hybrid_rag_colbertv2_tpu.parallel import sharded as jax_sharded
from hybrid_rag_colbertv2_tpu.train import trainer as jax_trainer
from hybrid_rag_colbertv2_tpu_torch.config import MeshConfig, RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.dense import DenseTokenIndex
from hybrid_rag_colbertv2_tpu_torch.index.lexical import LexicalIndex
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
    ColBERTConfig, ColBERTEncoder)
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import ColBERTTokenizer
from hybrid_rag_colbertv2_tpu_torch.parallel import mesh as pmesh
from hybrid_rag_colbertv2_tpu_torch.parallel import params
from hybrid_rag_colbertv2_tpu_torch.parallel import sharded
from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import HybridRetriever
from hybrid_rag_colbertv2_tpu_torch.train import data
from hybrid_rag_colbertv2_tpu_torch.train.trainer import (
    ColBERTTrainer, TrainConfig)

CPU = torch.device("cpu")
RTOL_TP = ATOL_TP = 2e-5
RTOL_LOSS, ATOL_PARAM = 1e-5, 1e-5
KEY_BIAS = "attention.key.bias"
# tests/test_sharded.py's corpus and queries
CORPUS = [
    f"document {i} talks about topic {i % 7} and subject {i % 5} "
    f"with details on item {i}"
    for i in range(96)
] + [
    "TPUs multiply matrices using a systolic array called the MXU",
    "JAX compiles numerical programs with XLA for TPUs and GPUs",
    "Information retrieval ranks documents by relevance to a query",
    "Reciprocal rank fusion combines rankings from multiple retrievers",
]
# __graft_entry__.py's tiny corpus and encoder (2 layers of `small`: rope)
GRAFT_CORPUS = [f"sample document {i} about topic {i % 7}"
                for i in range(64)]
GRAFT_QUERIES = ["sample topic 3", "document 5"]
PRESETS = {
    "tiny": (CORPUS, lambda v: dict(preset="tiny", vocab_size=v)),
    "graft": (GRAFT_CORPUS, lambda v: dict(
        preset="small", vocab_size=v, num_layers=2, hidden_size=128,
        intermediate_size=256, num_heads=4)),
}


def _geom(kind, vocab):
    kw = PRESETS[kind][1](vocab)
    preset = kw.pop("preset")
    return (getattr(JaxColCfg, preset)(**kw),
            getattr(ColBERTConfig, preset)(**kw))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Per preset: its tokenizer and seed-0 params, written by JAX."""
    root = tmp_path_factory.mktemp("params")
    for kind, (corpus, _) in PRESETS.items():
        tok = JaxTokenizer.train_bpe(corpus, vocab_size=512)
        tok.save(root / f"{kind}.tok.json")
        jcfg, _ = _geom(kind, tok.vocab_size)
        JaxEncoder(jcfg, tok, seed=0).save_params(str(root / f"{kind}.npz"))
    return root


def _pair(files, kind):
    """A JAX and a port encoder with equal params and tokenizers."""
    jtok = JaxTokenizer.load(files / f"{kind}.tok.json")
    ptok = ColBERTTokenizer.load(files / f"{kind}.tok.json")
    jcfg, pcfg = _geom(kind, jtok.vocab_size)
    jenc = JaxEncoder(jcfg, jtok, params=JaxEncoder.load_params(
        str(files / f"{kind}.npz")))
    penc = ColBERTEncoder(pcfg, ptok, params=ColBERTEncoder.load_params(
        str(files / f"{kind}.npz")), device="cpu")
    return jenc, penc


def _meshes(shape):
    return (jax_mesh.make_mesh(JaxMesh(mesh_shape=shape)),
            pmesh.make_mesh(MeshConfig(mesh_shape=shape),
                            devices=[CPU] * (shape[0] * shape[1])))


def _jax_state(jenc, tmp_path):
    jenc.save_params(str(tmp_path / "j.npz"))
    return ColBERTEncoder.load_params(str(tmp_path / "j.npz"))


@pytest.mark.parametrize("kind", ["tiny", "graft"])
def test_tp_forward_equals_jax(files, kind):
    """tests/test_sharded.py:226 on a (data=2, model=4) mesh: the port's
    TP forward against JAX's TP forward and its own unsharded one."""
    jenc, penc = _pair(files, kind)
    jm, pm = _meshes((2, 4))
    queries = ["systolic array", "fox", "topic 3 subject 2 details"]
    jenc.params = jax_params.shard_encoder_params(jenc.params, jm)
    want = np.asarray(jenc.encode_queries(queries))
    ref = penc.encode_queries(queries).numpy()
    assert params.shard_encoder_params(penc.model, pm) is penc.model
    got = penc.encode_queries(queries).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_TP, atol=ATOL_TP)
    np.testing.assert_allclose(got, ref, rtol=RTOL_TP, atol=ATOL_TP)
    embs, lens = penc.encode_docs(CORPUS[:5], doc_len=32)
    jembs, jlens = jenc.encode_docs(CORPUS[:5], doc_len=32)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_allclose(embs.numpy(), np.asarray(jembs),
                               rtol=RTOL_TP, atol=ATOL_TP)


def test_describe_shardings_equals_jax(files):
    """Same leaves; each TP leaf's spec names the model axis where JAX's
    PartitionSpec does; q/k/v and intermediate on the (in, out) kernel's
    out axis, attention out and MLP output on its in axis."""
    jenc, penc = _pair(files, "tiny")
    jm, pm = _meshes((2, 4))
    want = jax_params.describe_shardings(
        jax_params.shard_encoder_params(jenc.params, jm))
    unsharded = params.describe_shardings(penc.model)
    assert all(v.startswith("SingleDevice") for v in unsharded.values())
    got = params.describe_shardings(
        params.shard_encoder_params(penc.model, pm))
    assert set(got) == set(want)

    def spec(s):
        return re.search(r"spec=(PartitionSpec\([^)]*\))", s).group(1)
    assert {k: spec(v) for k, v in got.items()} == {
        k: spec(v) for k, v in want.items()}
    assert spec(got["layer_0/attention/query/kernel"]) == \
        "PartitionSpec(None, 'model')"
    assert spec(got["layer_1/output/kernel"]) == \
        "PartitionSpec('model', None)"
    assert spec(got["colbert_linear/kernel"]) == "PartitionSpec()"
    assert "'data': 2, 'model': 4" in got["colbert_linear/kernel"]


def test_shard_raises_where_jax_raises(files):
    """64 hidden features over a 3-way model axis: JAX's device_put
    raises ValueError, and so does the port (whole heads besides)."""
    jenc, penc = _pair(files, "tiny")
    jm, pm = _meshes((2, 3))
    with pytest.raises(ValueError, match="divisible by 3"):
        jax_params.shard_encoder_params(jenc.params, jm)
    with pytest.raises(ValueError, match="divisible by the 3-way"):
        params.shard_encoder_params(penc.model, pm)
    assert penc.model.tp_plan is None


def _pairs(corpus, n):
    idx = data.pseudo_query_pairs(corpus, n_pairs_per_doc=1, seed=0)
    return [(q, corpus[i]) for q, i in idx][:n]


def test_dp_tp_steps_equal_jax(files, tmp_path):
    """tests/test_sharded.py:253 for 3 steps on a (data=4, model=2) mesh:
    the DP x TP step of each package from equal params, each step on its
    own global batch of 8; loss, accuracy and every parameter."""
    jenc, penc = _pair(files, "tiny")
    jm, pm = _meshes((4, 2))
    lr = 3e-4
    kw = dict(batch_size=8, doc_len=32, steps=3, warmup_steps=1,
              learning_rate=lr)
    jenc.params = jax_params.shard_encoder_params(jenc.params, jm)
    params.shard_encoder_params(penc.model, pm)
    jtr = jax_trainer.ColBERTTrainer(jenc, jax_trainer.TrainConfig(**kw),
                                     mesh=jm)
    ptr = ColBERTTrainer(penc, TrainConfig(**kw), mesh=pm)
    pairs = _pairs(CORPUS, 24)
    p = jenc.params
    moved = 0.0
    for s in range(3):
        batch = pairs[8 * s:8 * s + 8]
        p, jtr.opt_state, jmet = jtr.step_fn(p, jtr.opt_state,
                                             jtr._make_batch(batch))
        pmet = ptr.step_fn(ptr._make_batch(batch), ptr.updates)
        ptr.updates += 1
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]),
                                   rtol=RTOL_LOSS)
        assert float(pmet["accuracy"]) == float(jmet["accuracy"])
        jenc.params = p
        ref = _jax_state(jenc, tmp_path)
        got = penc.model.state_dict()
        moved += 2 * ptr.schedule(s) * (1 + 0.01 * 2)
        for name, want in ref.items():
            tol = moved if name.endswith(KEY_BIAS) else ATOL_PARAM
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       rtol=0.0, atol=tol,
                                       err_msg=f"step {s} {name}")


def test_dp_tp_loss_is_the_global_batch(files):
    """The sharded loss scores every query against every doc row of the
    global batch: it equals the unsharded step's loss on the same batch
    (per-shard in-batch negatives would give another), and the update
    equals the unsharded update."""
    _, sharded_enc = _pair(files, "graft")
    _, plain_enc = _pair(files, "graft")
    _, pm = _meshes((2, 2))
    kw = dict(batch_size=8, doc_len=32, steps=3, warmup_steps=1,
              learning_rate=1e-3)
    params.shard_encoder_params(sharded_enc.model, pm)
    str_ = ColBERTTrainer(sharded_enc, TrainConfig(**kw), mesh=pm)
    plain = ColBERTTrainer(plain_enc, TrainConfig(**kw))
    pairs = _pairs(GRAFT_CORPUS, 24)
    for s in range(3):
        batch = pairs[8 * s:8 * s + 8]
        a = str_.step_fn(str_._make_batch(batch), s)
        b = plain.step_fn(plain._make_batch(batch), s)
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]),
                                   rtol=RTOL_LOSS)
    ref = plain_enc.model.state_dict()
    for name, t in sharded_enc.model.state_dict().items():
        if not name.endswith(KEY_BIAS):
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(),
                                       rtol=0.0, atol=ATOL_PARAM,
                                       err_msg=name)


# (distinct pairs, batch size, mesh shape): JAX train/trainer.py:263-274
TRIM_CASES = [(3, 16, (4, 1)), (6, 16, (4, 2)), (8, 16, (4, 1)),
              (5, 16, (2, 1)), (12, 8, (4, 1)), (10, 4, (4, 2))]


@pytest.mark.parametrize("n,bs,shape", TRIM_CASES,
                         ids=[f"{n}-bs{b}-{s[0]}x{s[1]}"
                              for n, b, s in TRIM_CASES])
def test_trim_rule_equals_jax(files, n, bs, shape):
    """Too few distinct pairs under a mesh: trim the batch to a multiple
    of the data extent, and where none is left skip training with the
    warning; the batches each package forms, case for case."""
    jenc, penc = _pair(files, "tiny")
    jm, pm = _meshes(shape)
    pairs = _pairs(CORPUS, n)
    kw = dict(batch_size=bs, doc_len=32, steps=3)
    jtr = jax_trainer.ColBERTTrainer(jenc, jax_trainer.TrainConfig(**kw),
                                     mesh=jm)
    ptr = ColBERTTrainer(penc, TrainConfig(**kw), mesh=pm)
    seen = {"jax": [], "port": []}
    jtr._make_batch = lambda b: seen["jax"].append([p[1] for p in b])
    jtr.step_fn = lambda p, o, b: (p, o, {"loss": 0.0, "accuracy": 0.0})
    ptr._make_batch = lambda b: seen["port"].append([p[1] for p in b])
    ptr.step_fn = lambda b, c: {"loss": torch.tensor(0.0),
                                "accuracy": torch.tensor(0.0)}
    warned = {"jax": [], "port": []}
    hs = {}
    for side, name in (("jax", jax_trainer.__name__),
                       ("port", "hybrid_rag_colbertv2_tpu_torch.train."
                                "trainer")):
        hs[name] = logging.Handler(logging.WARNING)
        hs[name].emit = (lambda r, side=side: warned[side].append(
            r.getMessage()))
        logging.getLogger(name).addHandler(hs[name])
    try:
        jm_out = jtr.train(pairs)
        pm_out = ptr.train(pairs)
    finally:
        for name, h in hs.items():
            logging.getLogger(name).removeHandler(h)
    n_jax_warn = sum("skipping training" in m for m in warned["jax"])
    n_port_warn = sum("skipping training" in m for m in warned["port"])
    assert seen["port"] == seen["jax"]
    assert len(pm_out) == len(jm_out)
    assert n_port_warn == n_jax_warn == (0 if seen["jax"] else 1)
    for b in seen["port"]:
        assert len(b) % shape[0] == 0


def test_training_reaches_bound_retriever_and_unsharded_encoder(files):
    """TP is a forward plan over the encoder's own Parameters: after DP x
    TP training the Parameter objects are the ones bound before, a
    retriever bound before training serves the trained weights (a fresh
    one's results), and the unsharded forward sees them too."""
    _, penc = _pair(files, "tiny")
    _, pm = _meshes((4, 2))
    cfg = RAGConfig(final_top_k=5, fusion_candidates=8)
    mgr = IndexManager(cfg, penc, device="cpu")
    mgr.build_all(CORPUS)
    bound = HybridRetriever(cfg, mgr, penc, device="cpu")
    queries = ["topic 3 subject 2 details", "systolic array"]
    bound.retrieve_batch(queries)
    before = [id(p) for p in penc.model.parameters()]
    q0 = penc.encode_queries(queries)
    params.shard_encoder_params(penc.model, pm)
    ColBERTTrainer(penc, TrainConfig(batch_size=8, doc_len=32, steps=3,
                                     warmup_steps=1, learning_rate=1e-3),
                   mesh=pm).train(_pairs(CORPUS, 24))
    assert [id(p) for p in penc.model.parameters()] == before
    assert all(p.grad is None for p in penc.model.parameters())
    q_tp = penc.encode_queries(queries)
    assert (q_tp - q0).abs().max() > 1e-4
    penc.model.tp_plan = None
    q_plain = penc.encode_queries(queries)
    np.testing.assert_allclose(q_plain.numpy(), q_tp.numpy(),
                               rtol=RTOL_TP, atol=ATOL_TP)
    got = bound.retrieve_batch(queries)
    want = HybridRetriever(cfg, mgr, penc, device="cpu").retrieve_batch(
        queries)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _graft_world(enc, lex_cls, dense_cls, mesh_mod, retr_cls, cfg_cls,
                 mesh, to_np):
    """__graft_entry__.py:190-225 after training: the sharded cascade over
    int8 and int4-doc, with and without shard_bm25 -> {case: ids}."""
    out = {}
    lex = lex_cls.build(GRAFT_CORPUS)
    embs, lengths = enc.encode_docs(GRAFT_CORPUS, doc_len=32)
    for dtype in ("int8", "int4-doc"):
        dense = mesh_mod.shard_dense_index(dense_cls.build(
            embs, lengths, doc_len=32, dtype=dtype, docs_pad_multiple=128),
            mesh)
        for sb in (False, True):
            cfg = cfg_cls(final_top_k=5, fusion_candidates=8,
                          dense_prefilter=8)
            cfg.mesh.shard_bm25 = sb
            ids, scores = retr_cls(cfg, mesh, lex, dense,
                                   enc).retrieve_batch(GRAFT_QUERIES)
            out[(dtype, sb)] = (to_np(ids), to_np(scores))
    return out


def test_graft_flow_equals_jax(files):
    """The JAX package's full training step (__graft_entry__.py:174-190)
    in both packages on a (data=4, model=2) mesh: TP-shard the encoder, 3
    DP x TP steps, then ShardedRetriever with the same encoder on int8 and
    int4-doc, with and without shard_bm25: JAX's ids; scores rtol 1e-4,
    atol 1e-4 (the trained params differ by up to 1e-5)."""
    jenc, penc = _pair(files, "graft")
    jm, pm = _meshes((4, 2))
    pairs = _pairs(GRAFT_CORPUS, 64)
    kw = dict(batch_size=8, doc_len=32, steps=3, warmup_steps=1,
              learning_rate=1e-3)
    jenc.params = jax_params.shard_encoder_params(jenc.params, jm)
    jm_ = jax_trainer.ColBERTTrainer(
        jenc, jax_trainer.TrainConfig(**kw), mesh=jm).train(pairs)
    params.shard_encoder_params(penc.model, pm)
    pm_ = ColBERTTrainer(penc, TrainConfig(**kw), mesh=pm).train(pairs)
    assert len(pm_) == len(jm_) == 3
    for a, b in zip(pm_, jm_):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=RTOL_LOSS)
    want = _graft_world(jenc, JaxLex, JaxDense, jax_mesh,
                        jax_sharded.ShardedRetriever, JaxConfig, jm,
                        np.asarray)
    got = _graft_world(penc, LexicalIndex, DenseTokenIndex, pmesh,
                       sharded.ShardedRetriever, RAGConfig, pm,
                       lambda a: np.asarray(a))
    for case in want:
        np.testing.assert_array_equal(got[case][0], want[case][0],
                                      err_msg=str(case))
        np.testing.assert_allclose(got[case][1], want[case][1], rtol=1e-4,
                                   atol=1e-4, err_msg=str(case))
        assert (got[case][0] >= 0).all()


def test_tp_needs_whole_heads(files):
    """A known difference: the tiny preset's 4 heads over an 8-way model
    axis divide JAX's kernels (64 and 128 columns), so GSPMD splits
    inside heads; the port's plan shards whole heads and raises."""
    jenc, penc = _pair(files, "tiny")
    jm, pm = _meshes((1, 8))
    jax_params.shard_encoder_params(jenc.params, jm)
    with pytest.raises(ValueError, match="num_heads=4 is not divisible"):
        params.shard_encoder_params(penc.model, pm)
