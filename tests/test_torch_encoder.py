"""Port encoder vs the JAX one, on the same weights.

The JAX ``ColBERTModel`` is initialized from a seed, its params are
flattened to the ``encoder_params.npz`` key layout, and ``params_from_jax``
loads them into the port's ``nn.Module``. fp32 throughout, atol=1e-5 (the
two frameworks sum matmuls and reductions in different orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.models import colbert as jc
from hybrid_rag_colbertv2_tpu.models.tokenizer import HashTokenizer as JaxHash
from hybrid_rag_colbertv2_tpu_torch.models import colbert as tc
from hybrid_rag_colbertv2_tpu_torch.models.tokenizer import HashTokenizer

CASES = {
    "tiny-learned": dict(preset="tiny", kw={}),
    "tiny-learned-anchor": dict(preset="tiny", kw=dict(lexical_anchor=0.5)),
    "small1-rope-halves": dict(preset="small", kw=dict(
        num_layers=1, vocab_size=512)),
    "small1-rope-interleaved": dict(preset="small", kw=dict(
        num_layers=1, vocab_size=512, rope_interleaved=True)),
    "small1-rope-anchor": dict(preset="small", kw=dict(
        num_layers=1, vocab_size=512, lexical_anchor=0.3)),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _pair(name):
    case = CASES[name]
    jcfg = getattr(jc.ColBERTConfig, case["preset"])(**case["kw"])
    tcfg = getattr(tc.ColBERTConfig, case["preset"])(**case["kw"])
    assert {k: v for k, v in dataclasses.asdict(tcfg).items()
            if k != "dtype"} == {k: v for k, v in dataclasses.asdict(
                jcfg).items() if k != "dtype"}
    jmodel = jc.ColBERTModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32))["params"]
    tmodel = tc.ColBERTModel(tcfg)
    tmodel.load_state_dict(tc.params_from_jax(_flat(params)))
    return jmodel, params, tmodel.eval(), jcfg


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name):
    jmodel, params, tmodel, cfg = _pair(name)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 25:] = 0                        # a padded doc
    mask[2, 7:] = 0
    je = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(mask)))
    with torch.no_grad():
        te = tmodel(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(te, je, atol=1e-5, rtol=0)
    assert (te[1, 25:] == 0).all()          # padding rows are zero


def test_encoder_load_params_and_protocol(tmp_path):
    """``ColBERTEncoder.load_params`` reads the JAX npz; query and doc
    encodes through the two encoders agree."""
    jcfg = jc.ColBERTConfig.tiny(vocab_size=512)
    jenc = jc.ColBERTEncoder(jcfg, JaxHash(512), seed=1)
    jenc.save_params(str(tmp_path / "encoder_params.npz"))
    tenc = tc.ColBERTEncoder(
        tc.ColBERTConfig.tiny(vocab_size=512), HashTokenizer(512),
        params=tc.ColBERTEncoder.load_params(
            str(tmp_path / "encoder_params.npz")), device="cpu")
    texts = ["systolic arrays multiply matrices", "a fox", ""]
    np.testing.assert_allclose(tenc.encode_queries(texts).numpy(),
                               np.asarray(jenc.encode_queries(texts)),
                               atol=1e-5, rtol=0)
    je, jl = jenc.encode_docs(texts, doc_len=64)
    te, tl = tenc.encode_docs(texts, doc_len=64)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=0)


def test_random_init_is_seeded():
    cfg = tc.ColBERTConfig.tiny(vocab_size=256)
    a = tc.ColBERTEncoder(cfg, HashTokenizer(256), seed=4, device="cpu")
    b = tc.ColBERTEncoder(cfg, HashTokenizer(256), seed=4, device="cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
