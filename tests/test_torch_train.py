"""The port's training stack against the JAX package's, on the CPU.

``train/trainer.py`` (loss, AdamW, schedule, batches, checkpoints),
``train/lexicon.py`` and ``train/data.py``. Both trainers start from the
same encoder params (the JAX encoder's ``encoder_params.npz`` loaded
through ``params_from_jax``) and the same tokenizer file.

Tolerances: losses rtol 1e-5; parameters atol 1e-5 after every step,
except the attention key biases. Those have a mathematically zero
gradient (q·(k + b) adds the same q·b to every key's logit, which the
softmax cancels), so what both frameworks compute there is rounding
noise of about 1e-10, and Adam scales noise up to the learning rate:
each package moves them by up to ``lr_t`` per step, in its own
directions. Their bound is the sum of both packages' steps; the test
below pins that the port's gradient there is noise.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybrid_rag_colbertv2_tpu.models.colbert import (
    ColBERTConfig as JaxColCfg, ColBERTEncoder as JaxEncoder)
from hybrid_rag_colbertv2_tpu.models.tokenizer import (
    ColBERTTokenizer as JaxTokenizer)
from hybrid_rag_colbertv2_tpu.train import data as jax_data
from hybrid_rag_colbertv2_tpu.train import lexicon as jax_lexicon
from hybrid_rag_colbertv2_tpu.train.trainer import (
    ColBERTTrainer as JaxTrainer, TrainConfig as JaxTrainConfig)
from hybrid_rag_colbertv2_tpu_torch.config import RAGConfig
from hybrid_rag_colbertv2_tpu_torch.index.manager import IndexManager
from hybrid_rag_colbertv2_tpu_torch.models.colbert import (
    ColBERTConfig, ColBERTEncoder)
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import ColBERTTokenizer
from hybrid_rag_colbertv2_tpu_torch.retrieval.cascade import HybridRetriever
from hybrid_rag_colbertv2_tpu_torch.train import data, lexicon
from hybrid_rag_colbertv2_tpu_torch.train.trainer import (
    ColBERTTrainer, TrainConfig, _maxsim_matrix,
    warmup_cosine_decay_schedule)

TOPICS = [
    ("astronomy", "telescope galaxy nebula star planet orbit cosmos"),
    ("cooking", "recipe sauce boil saute pan flavor ingredient spice"),
    ("hardware", "systolic array matrix multiply fast bandwidth chip"),
    ("music", "melody rhythm chord harmony tempo instrument song"),
    ("ocean", "coral reef tide current whale plankton salinity wave"),
    ("law", "statute contract liability court verdict clause appeal"),
]
CORPUS = [f"Chunk {i} about {name} moved sixty times: "
          + " ".join([words] * 2)
          for i, (name, words) in enumerate(TOPICS * 2)]
RTOL_LOSS, ATOL_PARAM = 1e-5, 1e-5
KEY_BIAS = "attention.key.bias"


@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    tok = JaxTokenizer.train_bpe(CORPUS + jax_lexicon.lexicon_sentences(),
                                 vocab_size=2048)
    tok.save(d / "tok.json")
    enc = JaxEncoder(JaxColCfg.tiny(vocab_size=tok.vocab_size), tok, seed=0)
    enc.save_params(str(d / "params.npz"))
    return d


def _pair(tok_files):
    """A JAX and a port encoder with equal params and tokenizers."""
    jtok = JaxTokenizer.load(tok_files / "tok.json")
    ttok = ColBERTTokenizer.load(tok_files / "tok.json")
    jenc = JaxEncoder(JaxColCfg.tiny(vocab_size=jtok.vocab_size), jtok,
                      params=JaxEncoder.load_params(
                          str(tok_files / "params.npz")))
    tenc = ColBERTEncoder(ColBERTConfig.tiny(vocab_size=ttok.vocab_size),
                          ttok, params=ColBERTEncoder.load_params(
                              str(tok_files / "params.npz")), device="cpu")
    return jenc, tenc


def _jax_state(jenc, tmp_path):
    jenc.save_params(str(tmp_path / "j.npz"))
    return ColBERTEncoder.load_params(str(tmp_path / "j.npz"))


def _pairs(kind):
    idx = data.pseudo_query_pairs(CORPUS, n_pairs_per_doc=2, seed=0)
    if kind == "hard_negatives":
        mined = data.mine_hard_negatives(CORPUS, idx, n_negatives=2, seed=0)
        return [(q, CORPUS[i], [CORPUS[j] for j in negs])
                for q, i, negs in mined]
    return [(q, CORPUS[i]) for q, i in idx]


@pytest.mark.parametrize("warmup,steps,lr", [
    (1, 3, 3e-4), (10, 300, 3e-4), (10, 5, 1e-3), (0, 4, 1e-4),
    (3, 3, 2e-3)])
def test_schedule_equals_optax(warmup, steps, lr):
    decay = max(steps, warmup + 1)
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay)
    mine = warmup_cosine_decay_schedule(0.0, lr, warmup, decay)
    # fp32 values; XLA's and numpy's fp32 cos may differ by an ulp, which
    # is up to 1e-7 of the peak after the 0.5 * (1 + cos) scaling
    for t in range(steps + 2):
        np.testing.assert_allclose(mine(t), float(ref(jnp.int32(t))),
                                   rtol=1e-6, atol=1e-7 * lr,
                                   err_msg=f"t={t}")
    if warmup:
        assert mine(0) == 0.0


@pytest.mark.parametrize("kind", ["plain", "hard_negatives", "tie"])
def test_train_steps_match_jax(kind, tok_files, tmp_path):
    """3 steps from equal params, warmup 1 (the first update is 0: optax
    reads the schedule before counting), each on its own batch; loss,
    accuracy and every parameter after each step."""
    jenc, tenc = _pair(tok_files)
    lr = 3e-4
    kw = dict(batch_size=4, doc_len=32, steps=3, warmup_steps=1,
              learning_rate=lr)
    if kind == "tie":
        pairs_ = lexicon.synonym_tie_pairs(tenc.tokenizer,
                                           tenc.cfg.vocab_size)
        assert len(pairs_) >= 5
        # the rows are not tied here, so the regularizer has a gradient
        kw.update(tie_weight=0.5, tie_pairs=tuple(pairs_))
    pairs = _pairs("hard_negatives" if kind == "hard_negatives" else "plain")
    jtr = JaxTrainer(jenc, JaxTrainConfig(**kw))
    ttr = ColBERTTrainer(tenc, TrainConfig(**kw))
    params = jenc.params
    moved = 0.0
    for s in range(3):
        batch = pairs[4 * s:4 * s + 4]
        params, jtr.opt_state, jm = jtr.step_fn(
            params, jtr.opt_state, jtr._make_batch(batch))
        tm = ttr.step_fn(ttr._make_batch(batch), ttr.updates)
        ttr.updates += 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL_LOSS)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        jenc.params = params
        ref = _jax_state(jenc, tmp_path)
        got = tenc.model.state_dict()
        assert set(got) == set(ref)
        moved += 2 * ttr.schedule(s) * (1 + 0.01 * 2)
        for name, want in ref.items():
            tol = moved if name.endswith(KEY_BIAS) else ATOL_PARAM
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       rtol=0.0, atol=tol,
                                       err_msg=f"step {s} {name}")
        if s == 0:      # lr = schedule(0) = 0: no parameter moved
            for name, want in ref.items():
                np.testing.assert_array_equal(got[name].numpy(),
                                              want.numpy())


def test_key_bias_gradient_is_rounding_noise(tok_files):
    _, tenc = _pair(tok_files)
    ttr = ColBERTTrainer(tenc, TrainConfig(batch_size=4, doc_len=32))
    batch = ttr._make_batch(_pairs("plain")[:4])
    m = tenc.model
    q = m(batch["q_ids"], batch["q_mask"])
    d = m(batch["d_ids"], batch["d_mask"])
    scores = _maxsim_matrix(q, d, batch["d_mask"])
    torch.nn.functional.cross_entropy(
        scores, torch.arange(4)).backward()
    for layer in m.layers:
        att = layer.attention
        assert att.key.bias.grad.abs().max() < (
            1e-5 * att.query.bias.grad.abs().max())
        assert att.value.bias.grad.abs().max() > (
            1e-2 * att.query.bias.grad.abs().max())


def test_train_loop_matches_jax(tok_files, tmp_path):
    """``train()`` end to end: the distinct-positive grouping with
    leftovers (duplicated positives below), the batch cache reused across
    epochs, per-step metrics and the final params."""
    jenc, tenc = _pair(tok_files)
    pairs = _pairs("plain")
    pairs = pairs[:6] + [(q + " again", d) for q, d in pairs[:3]]
    kw = dict(batch_size=4, doc_len=32, steps=5, warmup_steps=1,
              learning_rate=1e-4)
    jm = JaxTrainer(jenc, JaxTrainConfig(**kw)).train(pairs)
    tm = ColBERTTrainer(tenc, TrainConfig(**kw)).train(pairs)
    assert len(tm) == len(jm) == 5
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=RTOL_LOSS)
        assert a["accuracy"] == b["accuracy"]
    ref = _jax_state(jenc, tmp_path)
    for name, t in tenc.model.state_dict().items():
        if not name.endswith(KEY_BIAS):
            np.testing.assert_allclose(t.numpy(), ref[name].numpy(),
                                       rtol=0.0, atol=ATOL_PARAM)
    assert all(p.grad is None for p in tenc.model.parameters())


@pytest.mark.parametrize("kind", ["plain", "hard_negatives"])
def test_make_batch_equals_jax(kind, tok_files):
    jenc, tenc = _pair(tok_files)
    pairs = _pairs(kind)[:4]
    jb = JaxTrainer(jenc, JaxTrainConfig(doc_len=32))._make_batch(pairs)
    tb = ColBERTTrainer(tenc, TrainConfig(doc_len=32))._make_batch(pairs)
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert tb["d_ids"].shape[0] == (12 if kind == "hard_negatives" else 4)


def test_inconsistent_negative_counts_raise(tok_files):
    _, tenc = _pair(tok_files)
    trainer = ColBERTTrainer(tenc, TrainConfig(batch_size=2, doc_len=32,
                                               steps=1))
    bad = [("q one", CORPUS[0], [CORPUS[1]]),
           ("q two", CORPUS[2], [CORPUS[3], CORPUS[4]])]
    with pytest.raises(ValueError, match="inconsistent"):
        trainer.train(bad, steps=1)


def test_small_pair_set_trains_on_smaller_batch(tok_files):
    _, tenc = _pair(tok_files)
    pairs = [("about astronomy", CORPUS[0]), ("about cooking", CORPUS[1]),
             ("about hardware", CORPUS[2])]
    trainer = ColBERTTrainer(tenc, TrainConfig(batch_size=16, doc_len=32,
                                               steps=2))
    metrics = trainer.train(pairs)
    assert len(metrics) == 2 and all(np.isfinite(m["loss"])
                                     for m in metrics)


def test_checkpoint_two_plus_two_equals_four(tok_files, tmp_path):
    """2 steps, a torch checkpoint, a fresh trainer over a differently
    initialized encoder restored from it, 2 more steps: equal to 4
    steps straight (params, moments and the schedule's count)."""
    pairs = _pairs("plain")
    batches = [pairs[4 * i:4 * i + 4] for i in range(4)]
    kw = dict(batch_size=4, doc_len=32, steps=4, warmup_steps=1,
              learning_rate=1e-3)

    def run(trainer, bs):
        out = []
        for b in bs:
            out.append(float(trainer.step_fn(trainer._make_batch(b),
                                             trainer.updates)["loss"]))
            trainer.updates += 1
        return out

    _, straight = _pair(tok_files)
    ref = run(ColBERTTrainer(straight, TrainConfig(**kw)), batches)
    _, first = _pair(tok_files)
    t1 = ColBERTTrainer(first, TrainConfig(**kw))
    got = run(t1, batches[:2])
    t1.save_checkpoint(str(tmp_path / "ckpt" / "state.pt"), step=2)
    other = ColBERTEncoder(first.cfg, first.tokenizer, seed=99,
                           device="cpu")
    ids = [id(p) for p in other.model.parameters()]
    t2 = ColBERTTrainer(other, TrainConfig(**kw))
    assert t2.restore_checkpoint(str(tmp_path / "ckpt" / "state.pt")) == 2
    assert [id(p) for p in other.model.parameters()] == ids
    got += run(t2, batches[2:])
    assert got == ref
    for (n, a), b in zip(other.model.state_dict().items(),
                         straight.model.state_dict().values()):
        assert torch.equal(a, b), n


def test_training_updates_a_bound_retriever_in_place(tok_files, tmp_path):
    """Train two steps under a live retriever: the fused entry (keyed on
    the parameters' identities and storages, which in-place updates keep)
    serves the trained weights, as a fresh retriever over a fresh encoder
    with the trained params does."""
    _, tenc = _pair(tok_files)
    cfg = RAGConfig(bm25_index_path=str(tmp_path / "bm25"),
                    colbert_index_path=str(tmp_path / "colbert"),
                    final_fusion="rerank", dense_prefilter=0)
    mgr = IndexManager(cfg, tenc, device="cpu")
    mgr.build_all(CORPUS)
    r = HybridRetriever(cfg, mgr, tenc, device="cpu")
    queries = ["telescope galaxy orbit", "court verdict appeal"]
    before = r.retrieve_batch(queries)
    ptrs = [p.data_ptr() for p in tenc.model.parameters()]
    ColBERTTrainer(tenc, TrainConfig(batch_size=4, doc_len=32, steps=2,
                                     warmup_steps=1, learning_rate=3e-2)
                   ).train(_pairs("plain"))
    assert [p.data_ptr() for p in tenc.model.parameters()] == ptrs
    after = r.retrieve_batch(queries)
    tenc.save_params(str(tmp_path / "trained.npz"))
    fresh = ColBERTEncoder(tenc.cfg, tenc.tokenizer,
                           params=ColBERTEncoder.load_params(
                               str(tmp_path / "trained.npz")), device="cpu")
    want = HybridRetriever(cfg, mgr, fresh, device="cpu").retrieve_batch(
        queries)
    np.testing.assert_array_equal(after[0], want[0])
    np.testing.assert_array_equal(after[1], want[1])
    assert not np.array_equal(after[1], before[1])


@pytest.mark.parametrize("anchor", [0.0, 0.5])
def test_tie_synonym_embeddings_bit_equal_to_jax(anchor, tok_files):
    jtok = JaxTokenizer.load(tok_files / "tok.json")
    ttok = ColBERTTokenizer.load(tok_files / "tok.json")
    jenc = JaxEncoder(JaxColCfg.tiny(vocab_size=jtok.vocab_size,
                                     lexical_anchor=anchor), jtok, seed=4)
    jenc.save_params(str(tok_files / f"a{anchor}.npz"))
    tenc = ColBERTEncoder(
        ColBERTConfig.tiny(vocab_size=ttok.vocab_size,
                           lexical_anchor=anchor), ttok,
        params=ColBERTEncoder.load_params(str(tok_files / f"a{anchor}.npz")),
        device="cpu")
    weight = tenc.model.word_embeddings.weight
    n_j = jax_lexicon.tie_synonym_embeddings(jenc.params, jtok)
    n_t = lexicon.tie_synonym_embeddings(tenc.model, ttok)
    assert n_t == n_j and n_t >= 10
    assert tenc.model.word_embeddings.weight is weight
    np.testing.assert_array_equal(
        weight.detach().numpy(),
        np.asarray(jenc.params["word_embeddings"]["embedding"]))
    if anchor:
        np.testing.assert_array_equal(
            tenc.model.anchor_embeddings.weight.detach().numpy(),
            np.asarray(jenc.params["anchor_embeddings"]["embedding"]))


def test_synonym_tie_pairs_and_sentences_equal_jax(tok_files):
    jtok = JaxTokenizer.load(tok_files / "tok.json")
    ttok = ColBERTTokenizer.load(tok_files / "tok.json")
    assert lexicon.synonym_tie_pairs(ttok, ttok.vocab_size) == \
        jax_lexicon.synonym_tie_pairs(jtok, jtok.vocab_size)
    assert lexicon.lexicon_sentences() == jax_lexicon.lexicon_sentences()
    assert lexicon.SYNONYMS == jax_lexicon.SYNONYMS


GENERATORS = {
    "pseudo": ("pseudo_query_pairs", dict(n_pairs_per_doc=3, seed=1)),
    "pseudo_dropout": ("pseudo_query_pairs", dict(
        n_pairs_per_doc=3, seed=2, word_dropout=0.25)),
    "pseudo_synonym": ("pseudo_query_pairs", dict(
        n_pairs_per_doc=3, seed=3, synonym_prob=0.7, query_words=(4, 14),
        with_mine_text=True)),
    "reworded": ("reworded_query_pairs", dict(
        n_pairs_per_doc=2, seed=4, synonym_prob=0.15, with_mine_text=True)),
    "question": ("question_query_pairs", dict(
        n_pairs_per_doc=2, seed=5, synonym_prob=0.15, with_mine_text=True)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_pair_generators_equal_jax(name):
    fn, kw = GENERATORS[name]
    got = getattr(data, fn)(CORPUS, **copy.deepcopy(kw))
    want = getattr(jax_data, fn)(CORPUS, **copy.deepcopy(kw))
    assert got == want and len(got) > 0


def test_corpus_word_df_and_mining_equal_jax():
    assert data.corpus_word_df(CORPUS) == jax_data.corpus_word_df(CORPUS)
    idx = data.pseudo_query_pairs(CORPUS, n_pairs_per_doc=2, seed=0,
                                  synonym_prob=0.7, with_mine_text=True)
    for n_neg in (1, 4):
        assert data.mine_hard_negatives(CORPUS, idx, n_negatives=n_neg,
                                        seed=3) == \
            jax_data.mine_hard_negatives(CORPUS, idx, n_negatives=n_neg,
                                         seed=3)
