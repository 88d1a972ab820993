"""The port's rope scaling, multimodal rope and gemma numerics against the
JAX package, and a small llama3-scaled model's loss and gradients.

Inputs and weights are seeded numpy (weights through the port's
``params_from_jax``); everything runs in fp32 on the CPU. Tables built from
the same fp32 operations in the same order are held bit for bit; values
that go through products and sums of another order agree to 2e-5 (forward)
and 1e-4 (gradients), relative and absolute, as in ``test_torch_model.py``.
"""

import glob
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.models import modules as JM
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import modules as TM
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir,
                       "hetu_galvatron_tpu", "models", "configs")

LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
SCALINGS = {
    "none": None,
    "linear": {"rope_type": "linear", "factor": 4.0},
    # the legacy "type" key
    "linear_type_key": {"type": "linear", "factor": 2.5},
    "llama3": LLAMA3,
    # llama3.1-70b.yaml's recipe
    "llama3_70b": {"rope_type": "llama3", "factor": 8.0,
                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                   "original_max_position_embeddings": 8192},
}


def _inv_freq(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@pytest.mark.parametrize("name", sorted(SCALINGS))
@pytest.mark.parametrize("head_dim,theta", [(64, 10000.0), (128, 500000.0)])
def test_torch_scale_inv_freq_matches_jax_bit_for_bit(name, head_dim, theta):
    scaling = SCALINGS[name]
    inv = _inv_freq(head_dim, theta)
    got = TM._scale_inv_freq(torch.from_numpy(inv), scaling).numpy()
    want = np.asarray(JM._scale_inv_freq(jnp.asarray(inv), scaling))
    np.testing.assert_array_equal(got, want)
    if name.startswith("llama3"):
        # the recipe keeps the fastest band and divides the slowest
        assert got[0] == inv[0]
        assert got[-1] == pytest.approx(inv[-1] / scaling["factor"])


def test_torch_scale_inv_freq_refuses_other_types_like_jax():
    inv = torch.ones(4)
    for bad in ({"rope_type": "dynamic", "factor": 2.0},
                {"rope_type": "yarn", "factor": 4.0}):
        with pytest.raises(ValueError, match="unsupported rope_scaling"):
            TM._scale_inv_freq(inv, bad)
        with pytest.raises(ValueError, match="unsupported rope_scaling"):
            JM._scale_inv_freq(jnp.ones(4), bad)
        with pytest.raises(ValueError, match="unsupported rope_scaling"):
            TM.check_model_supported(ModelArgs(
                position_embedding_type="rope", rope_scaling=bad))


@pytest.mark.parametrize("name", sorted(SCALINGS))
def test_torch_scaled_rope_cos_sin_matches_jax(name):
    cos_t, sin_t = TM.rope_cos_sin(96, 32, 10000.0,
                                   scaling=SCALINGS[name])
    cos_j, sin_j = JM.rope_cos_sin(96, 32, 10000.0, scaling=SCALINGS[name])
    # the same fp32 frequencies; cos/sin of another libm agree to an ulp
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=0,
                               atol=1e-6)


def _mrope_positions(seed=0, b=2, s=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 40, (3, b, s)).astype(np.int32)


@pytest.mark.parametrize("scaling", [None, LLAMA3])
def test_torch_mrope_cos_sin_is_bit_identical_to_jax(scaling):
    """The angles are JAX's bits: its one-hot einsum over the position
    rows, rebuilt here from its own ``_scale_inv_freq``, against the
    port's gather. cos/sin of those angles then differ only by each
    library's libm (an ulp), so the tables are held to 1e-6 and the
    port's to torch's cos/sin of JAX's angles bit for bit."""
    pos = _mrope_positions()
    sections = (4, 6, 6)  # head_dim 32
    inv_j = JM._scale_inv_freq(jnp.asarray(_inv_freq(32, 10000.0)), scaling)
    freqs = jnp.asarray(pos).astype(jnp.float32)[..., None] * inv_j
    row = jnp.concatenate([jnp.full((s,), j, jnp.int32)
                           for j, s in enumerate(sections)])
    angles = torch.from_numpy(np.array(jnp.einsum(
        "rbsd,dr->bsd", freqs, jax.nn.one_hot(row, 3, dtype=jnp.float32))))
    got_cos, got_sin = TM.mrope_cos_sin(torch.from_numpy(pos), 32, 10000.0,
                                        sections, scaling=scaling)
    assert torch.equal(got_cos, torch.cos(angles))
    assert torch.equal(got_sin, torch.sin(angles))
    jc, js = JM.mrope_cos_sin(jnp.asarray(pos), 32, 10000.0, sections,
                              scaling=scaling)
    np.testing.assert_allclose(got_cos.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_sin.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)


def test_torch_mrope_with_equal_rows_is_rope():
    base = np.random.default_rng(3).integers(0, 64, (2, 10)).astype(np.int64)
    pos = torch.from_numpy(np.broadcast_to(base, (3, 2, 10)).copy())
    cos_m, sin_m = TM.mrope_cos_sin(pos, 32, 10000.0, (4, 6, 6),
                                    scaling=LLAMA3)
    cos, sin = TM.rope_cos_sin(64, 32, 10000.0, scaling=LLAMA3)
    idx = torch.from_numpy(base)
    assert torch.equal(cos_m, cos[idx]) and torch.equal(sin_m, sin[idx])


def test_torch_mrope_refuses_what_jax_refuses():
    pos = torch.zeros((3, 1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="must sum to"):
        TM.mrope_cos_sin(pos, 32, 10000.0, (4, 4, 4))
    with pytest.raises(ValueError, match="must be"):
        TM.mrope_cos_sin(pos[:2], 32, 10000.0, (4, 6, 6))
    with pytest.raises(ValueError, match="must sum to"):
        TM.check_model_supported(ModelArgs(
            hidden_size=64, num_attention_heads=2,
            position_embedding_type="rope", mrope_section=[8, 8, 8]))


# ---------------------------------------------------------------------------
# gemma numerics and models
# ---------------------------------------------------------------------------

SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, ffn_hidden_size=96, vocab_size=120,
             max_position_embeddings=64, seq_length=32,
             make_vocab_size_divisible_by=64, add_bias_linear=False)
MODELS = {
    # llama3 rope scaling, GQA, SwiGLU, untied head
    "llama3": dict(SMALL, model_type="llama", hidden_act="swiglu",
                   normalization="rmsnorm", position_embedding_type="rope",
                   tie_word_embeddings=False, rope_theta=500000.0,
                   rope_scaling=LLAMA3),
    # linear scaling over multimodal rope sections (head_dim 16)
    "mrope": dict(SMALL, model_type="llama", hidden_act="swiglu",
                  normalization="rmsnorm", position_embedding_type="rope",
                  mrope_section=[2, 3, 3],
                  rope_scaling={"rope_type": "linear", "factor": 2.0}),
    # gemma: zero-centered RMSNorm, sqrt(hidden)-scaled embeddings, GeGLU
    "gemma": dict(SMALL, model_type="llama", hidden_act="geglu",
                  normalization="rmsnorm", position_embedding_type="rope",
                  norm_zero_centered=True, scale_embeddings=True),
    # a zero-centered LayerNorm
    "gemma_ln": dict(SMALL, model_type="gpt", hidden_act="gelu",
                     normalization="layernorm",
                     position_embedding_type="learned",
                     norm_zero_centered=True, scale_embeddings=True),
}


def _setup(name, seed=0):
    jcfg, tcfg = JModelArgs(**MODELS[name]), ModelArgs(**MODELS[name])
    jparams, _ = JB.init_causal_lm(jax.random.key(seed), jcfg)
    npy = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(seed)
    npy = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, npy)
    return jcfg, tcfg, npy, params_from_jax(npy)


@pytest.mark.parametrize("normalization", ["rmsnorm", "layernorm"])
def test_torch_zero_centered_norm_matches_jax(normalization):
    spec = dict(MODELS["gemma"], normalization=normalization)
    jcfg, tcfg = JModelArgs(**spec), ModelArgs(**spec)
    # the init stores the offset from 1: a zero scale is the plain norm
    init = TM.init_norm(tcfg, "cpu")
    assert torch.equal(init["scale"], torch.zeros(64))
    np.testing.assert_array_equal(JM.init_norm(jcfg)[0]["scale"],
                                  np.zeros(64, np.float32))
    rng = np.random.default_rng(5)
    p = {k: rng.standard_normal(64).astype(np.float32) * 0.3
         for k in init}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    got = TM.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), tcfg)
    want = JM.apply_norm(p, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = ModelArgs(**dict(spec, norm_zero_centered=False))
    shifted = {k: torch.from_numpy(v + (1.0 if k == "scale" else 0.0))
               for k, v in p.items()}
    np.testing.assert_allclose(
        got.numpy(), TM.apply_norm(shifted, torch.from_numpy(x),
                                   plain).numpy(), **TOL)


def test_torch_scaled_embedding_matches_jax():
    jcfg, tcfg, npy, tp = _setup("gemma_ln")
    tokens = np.random.default_rng(2).integers(0, 120, (2, 16))
    got = TM.apply_embedding(tp["embed"], torch.from_numpy(tokens), tcfg,
                             compute_dtype=torch.float32)
    want = JM.apply_embedding(npy["embed"], jnp.asarray(tokens), jcfg,
                              compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    unscaled = TM.apply_embedding(
        tp["embed"], torch.from_numpy(tokens),
        ModelArgs(**dict(MODELS["gemma_ln"], scale_embeddings=False)),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(),
                               unscaled.detach().numpy() * math.sqrt(64),
                               rtol=1e-6, atol=0)


def _batch(seed=1, b=2, s=32, vocab=120):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_torch_zoo_model_loss_and_grads_match_jax(name):
    """A small model of each numerics family, with packed position ids
    (and per-axis multimodal positions for mrope): the fp32 loss and every
    leaf's gradient against the JAX loss's."""
    jcfg, tcfg, npy, tp = _setup(name)
    batch = _batch()
    rng = np.random.default_rng(4)
    pos = np.concatenate([np.arange(20), np.arange(12)])[None].repeat(2, 0)
    batch["position_ids"] = pos.astype(np.int32)
    if name == "mrope":
        batch["mrope_position_ids"] = rng.integers(
            0, 32, (3, 2, 32)).astype(np.int32)

    def jloss(p):
        return JB.causal_lm_loss(p, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcfg,
                                 compute_dtype=jnp.float32)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, npy))
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    tl = TB.causal_lm_loss(tp, tbatch, tcfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    names, leaves = zip(*TB.named_leaves(tp))
    grads = torch.autograd.grad(tl, leaves)
    jnamed = dict(_jax_named(jax.tree.map(np.asarray, jg)))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jnamed[n], err_msg=n,
                                   **GRAD_TOL)


def _jax_named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_named(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_named(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        yield prefix, tree


def test_torch_llama3_scaling_changes_the_logits_only_past_the_fast_band():
    """With the original context longer than every wavelength the llama3
    recipe is the identity; shorter, it moves the logits."""
    jcfg, tcfg, npy, tp = _setup("llama3")
    tokens = torch.from_numpy(_batch()["tokens"]).long()
    base = TB.forward_causal_lm(tp, tokens, tcfg,
                                compute_dtype=torch.float32)
    long_ctx = ModelArgs(**dict(MODELS["llama3"], rope_scaling=dict(
        LLAMA3, original_max_position_embeddings=10 ** 9)))
    plain = ModelArgs(**dict(MODELS["llama3"], rope_scaling=None))
    same = TB.forward_causal_lm(tp, tokens, long_ctx,
                                compute_dtype=torch.float32)
    unscaled = TB.forward_causal_lm(tp, tokens, plain,
                                    compute_dtype=torch.float32)
    assert torch.equal(same, unscaled)
    assert not torch.allclose(base, unscaled, atol=1e-4)


@pytest.mark.parametrize("path", sorted(
    p for p in glob.glob(os.path.join(CONFIGS, "*.yaml"))
    if not p.endswith("template.yaml")), ids=os.path.basename)
def test_torch_check_model_supported_passes_every_shipped_config(path):
    cfg = load_config(path, []).model
    TM.check_model_supported(cfg)
    if cfg.model_type == "t5":
        assert cfg.num_encoder_layers == 24
    if os.path.basename(path) == "llama3.1-70b.yaml":
        assert cfg.rope_scaling["rope_type"] == "llama3"
