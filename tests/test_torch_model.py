"""Port model core (hetu_galvatron_tpu_torch.models) against the JAX one.

Weights come from the JAX initializer and cross over through the port's
``runtime.checkpoint.params_from_jax``; inputs come from seeded numpy. All
compute is fp32 on the CPU, so the two sides differ only by summation order:
forward values agree to 2e-5 and gradients to 1e-4 (relative and absolute).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.models import modules as JM
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import modules as TM
from hetu_galvatron_tpu_torch.runtime.checkpoint import (
    params_from_jax,
    params_to_jax,
)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

GPT = dict(model_type="gpt", hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, vocab_size=128, max_position_embeddings=64,
           seq_length=32, hidden_act="gelu", normalization="layernorm",
           position_embedding_type="learned", add_qkv_bias=True,
           make_vocab_size_divisible_by=1)
# GQA 4:2, rope, rmsnorm, gated MLP, untied head, padded vocab (120 -> 128)
LLAMA = dict(model_type="llama", hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             ffn_hidden_size=96, vocab_size=120, max_position_embeddings=64,
             seq_length=32, hidden_act="swiglu", normalization="rmsnorm",
             position_embedding_type="rope", tie_word_embeddings=False,
             add_bias_linear=False, make_vocab_size_divisible_by=64)
FAMILIES = {"gpt": GPT, "llama": LLAMA}
F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32)


def _setup(family, seed=0):
    jcfg, tcfg = JModelArgs(**FAMILIES[family]), ModelArgs(**FAMILIES[family])
    jparams, _ = JB.init_causal_lm(jax.random.key(seed), jcfg)
    npy = jax.tree.map(np.asarray, jparams)
    # non-zero biases/scales so every leaf matters
    rng = np.random.default_rng(seed)
    npy = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, npy)
    return jcfg, tcfg, npy, params_from_jax(npy)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_apply_norm_matches_jax(family):
    jcfg, tcfg, npy, tp = _setup(family)
    x = _x((2, 8, 64))
    _close(TM.apply_norm(tp["layers"][0]["ln1"], torch.from_numpy(x), tcfg),
           JM.apply_norm(npy["layers"][0]["ln1"], jnp.asarray(x), jcfg))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_apply_attention_matches_jax(family):
    jcfg, tcfg, npy, tp = _setup(family)
    x = _x((2, 32, 64))
    rope_t = rope_j = None
    if tcfg.position_embedding_type == "rope":
        rope_t = TM.rope_cos_sin(32, tcfg.head_dim, tcfg.rope_theta)
        rope_j = JM.rope_cos_sin(32, jcfg.head_dim, jcfg.rope_theta)
    got = TM.apply_attention(tp["layers"][0]["attn"], torch.from_numpy(x),
                             tcfg, rope=rope_t, **T32)
    want = JM.apply_attention(npy["layers"][0]["attn"], jnp.asarray(x), jcfg,
                              rope=rope_j, **F32)
    _close(got, want)


def test_torch_apply_attention_segments_match_jax():
    jcfg, tcfg, npy, tp = _setup("llama")
    x = _x((2, 32, 64))
    seg = np.repeat(np.array([[0, 1, 2, 2]], np.int32), 8, axis=1)
    seg = np.concatenate([seg, seg[:, ::-1]], axis=0)
    got = TM.apply_attention(tp["layers"][1]["attn"], torch.from_numpy(x),
                             tcfg, segment_ids=torch.from_numpy(seg), **T32)
    want = JM.apply_attention(npy["layers"][1]["attn"], jnp.asarray(x), jcfg,
                              segment_ids=jnp.asarray(seg), **F32)
    _close(got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_apply_mlp_matches_jax(family):
    jcfg, tcfg, npy, tp = _setup(family)
    x = _x((2, 8, 64))
    _close(TM.apply_mlp(tp["layers"][1]["mlp"], torch.from_numpy(x), tcfg,
                        **T32),
           JM.apply_mlp(npy["layers"][1]["mlp"], jnp.asarray(x), jcfg, **F32))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_decoder_layer_matches_jax(family):
    jcfg, tcfg, npy, tp = _setup(family)
    x = _x((2, 32, 64))
    rope_t = rope_j = None
    if tcfg.position_embedding_type == "rope":
        rope_t = TM.rope_cos_sin(32, tcfg.head_dim, tcfg.rope_theta)
        rope_j = JM.rope_cos_sin(32, jcfg.head_dim, jcfg.rope_theta)
    _close(TM.apply_decoder_layer(tp["layers"][0], torch.from_numpy(x), tcfg,
                                  rope=rope_t, **T32),
           JM.apply_decoder_layer(npy["layers"][0], jnp.asarray(x), jcfg,
                                  rope=rope_j, **F32))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_embedding_and_head_match_jax(family):
    jcfg, tcfg, npy, tp = _setup(family)
    tokens = np.random.default_rng(2).integers(0, 120, (2, 32)).astype(
        np.int32)
    emb_t = TM.apply_embedding(tp["embed"], torch.from_numpy(tokens).long(),
                               tcfg, **T32)
    emb_j = JM.apply_embedding(npy["embed"], jnp.asarray(tokens), jcfg, **F32)
    _close(emb_t, emb_j)
    x = _x((2, 32, 64))
    logits_t = TM.apply_lm_head(tp["head"], torch.from_numpy(x), tcfg,
                                wte=tp["embed"]["wte"], **T32)
    logits_j = JM.apply_lm_head(npy["head"], jnp.asarray(x), jcfg,
                                wte=jnp.asarray(npy["embed"]["wte"]), **F32)
    assert logits_t.shape == (2, 32, tcfg.padded_vocab_size)
    _close(logits_t, logits_j)


def test_torch_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = 3.0 * rng.standard_normal((2, 16, 128)).astype(np.float32)
    labels = rng.integers(0, 128, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.6).astype(np.float32)
    for m in (None, mask):
        for z in (0.0, 1e-3):
            got = TM.cross_entropy_loss(
                torch.from_numpy(logits), torch.from_numpy(labels).long(),
                None if m is None else torch.from_numpy(m), z_loss=z)
            want = JM.cross_entropy_loss(
                jnp.asarray(logits), jnp.asarray(labels),
                None if m is None else jnp.asarray(m), z_loss=z)
            _close(got, want)
    with pytest.raises(NotImplementedError, match="K4/K5"):
        TM.cross_entropy_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels).long(), fused=True)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_causal_lm_loss_and_grads_match_jax(family):
    jcfg, tcfg, npy, tp = _setup(family, seed=4)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 120, (2, 33)).astype(np.int32)
    mask = (rng.random((2, 32)) < 0.7).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens[:, :-1]),
              "labels": jnp.asarray(tokens[:, 1:]),
              "loss_mask": jnp.asarray(mask)}
    tbatch = {"tokens": torch.from_numpy(tokens[:, :-1]).long(),
              "labels": torch.from_numpy(tokens[:, 1:]).long(),
              "loss_mask": torch.from_numpy(mask)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JB.causal_lm_loss(p, jbatch, jcfg, **F32))(
            jax.tree.map(jnp.asarray, npy))
    tloss = TB.causal_lm_loss(tp, tbatch, tcfg, **T32)
    _close(tloss, jloss)
    names = [n for n, _ in TB.named_leaves(tp)]
    tgrads = torch.autograd.grad(tloss, [t for _, t in TB.named_leaves(tp)])
    jflat = dict(TB.named_leaves(params_from_jax(
        jax.tree.map(np.asarray, jgrads))))
    for name, g in zip(names, tgrads):
        np.testing.assert_allclose(g.numpy(), jflat[name].detach().numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_init_follows_jax_scheme(family):
    """Same tree, shapes and init statistics (std 0.02, residual
    projections scaled by 1/sqrt(2L)) as the JAX initializer."""
    jcfg, tcfg = JModelArgs(**FAMILIES[family]), ModelArgs(**FAMILIES[family])
    jparams, _ = JB.init_causal_lm(jax.random.key(0), jcfg)
    tparams = TB.init_causal_lm(tcfg, seed=0)
    jflat = dict(TB.named_leaves(params_from_jax(
        jax.tree.map(np.asarray, jparams))))
    tflat = dict(TB.named_leaves(tparams))
    assert sorted(jflat) == sorted(tflat)
    for name, t in tflat.items():
        assert t.shape == jflat[name].shape, name
        assert t.dtype == torch.float32 and t.requires_grad
    resid = 0.02 / np.sqrt(2 * tcfg.num_hidden_layers)
    assert abs(float(tflat["layers.0.mlp.wout"].detach().std()) - resid) < 0.15 * resid
    assert abs(float(tflat["layers.1.attn.wo"].detach().std()) - resid) < 0.15 * resid
    assert abs(float(tflat["embed.wte"].detach().std()) - 0.02) < 0.003
    assert TB.param_count(tparams) == JB.param_count(jparams)
    assert TB.model_flops_per_token(tcfg) == JB.model_flops_per_token(jcfg)
    assert TB.model_flops_per_token(tcfg, 17) == JB.model_flops_per_token(
        jcfg, 17)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_weight_bridge_round_trips_exactly(family):
    _, tcfg, npy, tp = _setup(family)
    back = params_to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(npy)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(npy)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # q | k | v stay in split order; padded vocab rows and the tied head
    # keep their place
    np.testing.assert_array_equal(tp["layers"][0]["attn"]["wqkv"].detach()
                                  .numpy(), npy["layers"][0]["attn"]["wqkv"])
    assert tp["embed"]["wte"].shape[0] == tcfg.padded_vocab_size
    assert ("whead" in tp["head"]) == (not tcfg.tie_word_embeddings)


def test_torch_weight_bridge_rejects_trees_outside_the_slice():
    _, _, npy, _ = _setup("gpt")
    npy = dict(npy)
    npy["layers"] = ({**npy["layers"][0], "moe": {}},) + npy["layers"][1:]
    with pytest.raises(ValueError, match="outside this slice"):
        params_from_jax(npy)


def test_torch_model_refuses_settings_outside_the_slice():
    cfg = ModelArgs(**GPT)
    params = TB.init_causal_lm(cfg, seed=0)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="remat"):
        TB.forward_causal_lm(params, tokens, cfg, remat_flags=[True, False])
    with pytest.raises(NotImplementedError, match="segment_ids"):
        TB.forward_causal_lm(params, tokens, cfg,
                             segment_ids=torch.zeros_like(tokens))
    for bad in (dict(num_experts=4), dict(model_type="bert"),
                dict(model_type="t5"),
                dict(rope_scaling={"rope_type": "linear", "factor": 2.0})):
        with pytest.raises(NotImplementedError):
            TB.init_causal_lm(ModelArgs(**{**GPT, **bad}), seed=0)


def test_torch_hidden_dropout_uses_the_explicit_generator():
    cfg = ModelArgs(**{**GPT, "hidden_dropout": 0.5})
    params = TB.init_causal_lm(cfg, seed=0)
    tokens = torch.zeros((2, 8), dtype=torch.long)

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return TB.forward_causal_lm(params, tokens, cfg, dropout_rng=gen,
                                    **T32)
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    # eval semantics: no generator, no dropout
    torch.testing.assert_close(run(None), TB.forward_causal_lm(
        params, tokens, ModelArgs(**GPT), **T32), rtol=0, atol=0)
