"""The port's KV-cache generation (``models/generate.py``) against the JAX
package on the CPU.

Weights come from the port's initializer, with noise on every bias and
norm, and cross to JAX through ``params_to_jax``; inputs come from seeded
numpy; all compute is fp32. Two tiny decoder configs (a
Qwen-style one: rope, GQA 4:2, qkv bias, SwiGLU, RMSNorm, untied; a
GPT-2-style one: learned positions, LayerNorm, biases, a tied head) and a
tiny T5. ``prefill`` logits and the k/v it caches, and ``decode_step``
logits, hold every element within 1e-4 * (rms(want) + |want|), the repo's
fp32 rule; greedy streams are exact, with ragged left padding and eos
retirement. Sampled streams draw from a ``torch.Generator`` (JAX: threefry
keys), so they are held to their own contract: the same generator seed
gives the same stream, every token lies in the top-k set and vocab
padding is never drawn.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.models import generate as JG
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import generate as TG
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_to_jax

FP32_TOL = 1e-4

QWEN = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, ffn_hidden_size=128, vocab_size=128,
            max_position_embeddings=128, seq_length=32, hidden_act="swiglu",
            normalization="rmsnorm", position_embedding_type="rope",
            rope_theta=1000000.0, tie_word_embeddings=False,
            add_bias_linear=False, add_qkv_bias=True,
            make_vocab_size_divisible_by=1)
GPT2 = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            vocab_size=120, max_position_embeddings=64, seq_length=32,
            hidden_act="gelu", normalization="layernorm",
            position_embedding_type="learned", tie_word_embeddings=True,
            add_bias_linear=True, make_vocab_size_divisible_by=64)
T5 = dict(model_type="t5", hidden_size=64, num_hidden_layers=2,
          num_encoder_layers=2, num_attention_heads=4, num_key_value_heads=2,
          ffn_hidden_size=96, vocab_size=120, max_position_embeddings=64,
          seq_length=32, hidden_act="gelu", normalization="rmsnorm",
          position_embedding_type="rope", tie_word_embeddings=True,
          add_bias_linear=False, add_qkv_bias=False,
          make_vocab_size_divisible_by=64)


def close(got, want, tol=FP32_TOL):
    """Every element within tol * (rms(want) + |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    lim = tol * (rms + np.abs(want))
    assert (err <= lim).all(), float((err / lim).max())


def _models(spec, seed=0):
    """(JAX cfg, port cfg, the JAX tree, the port tree) of one model."""
    jcfg, tcfg = JModelArgs(**spec), ModelArgs(**spec)
    tparams = TB.init_causal_lm(tcfg, seed=seed)
    # non-zero biases and norm offsets, so every parameter matters
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, t in TB.named_leaves(tparams):
            if t.dim() == 1:
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
    return jcfg, tcfg, params_to_jax(tparams), tparams


def _ragged(rng, vocab, lens):
    """Left-padded [B, S0] prompts of the given lengths (pad 0)."""
    s0 = max(lens)
    toks = np.zeros((len(lens), s0), np.int32)
    for b, n in enumerate(lens):
        toks[b, s0 - n:] = rng.integers(0, vocab, n)
    return toks, np.asarray(lens, np.int32)


@pytest.fixture(scope="module", params=["qwen", "gpt2"])
def family(request):
    spec = {"qwen": QWEN, "gpt2": GPT2}[request.param]
    jcfg, tcfg, npy, tparams = _models(spec, seed=3)
    rng = np.random.default_rng(5)
    toks, lens = _ragged(rng, spec["vocab_size"], [7, 3, 11])
    full = rng.integers(0, spec["vocab_size"], (2, 9)).astype(np.int32)
    jax_out = {}
    s0 = toks.shape[1]
    rope = None
    if jcfg.position_embedding_type == "rope":
        from hetu_galvatron_tpu.models import modules as JM
        rope = JM.rope_cos_sin(16, jcfg.head_dim, jcfg.rope_theta)

    @jax.jit
    def prefill_and_step(p, t, n, nxt):
        cache, logits = JG.prefill(p, t, jcfg, 16, compute_dtype=jnp.float32,
                                   prompt_lens=n)
        kv = [(c["k"], c["v"]) for c in cache]
        _, dlogits = JG.decode_step(p, cache, nxt, jnp.int32(s0), jcfg,
                                    rope_full=rope, compute_dtype=jnp.float32,
                                    shift=s0 - n)
        return logits, kv, dlogits

    # the JAX oracles, once per family
    logits, kv, dlogits = prefill_and_step(
        npy, jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray([5, 9, 2], jnp.int32))
    jax_out["prefill"] = (np.asarray(logits),
                          [(np.asarray(k), np.asarray(v)) for k, v in kv])
    jax_out["decode"] = np.asarray(dlogits)
    jax_out["ragged"] = np.asarray(jax.jit(lambda p, t, n: JG.generate(
        p, t, jcfg, 8, prompt_lens=n, compute_dtype=jnp.float32))(
            npy, jnp.asarray(toks), jnp.asarray(lens)))
    free = TG.generate(tparams, torch.as_tensor(full), tcfg, 10,
                       compute_dtype=torch.float32)
    eos = int(free[0, 9 + 3])  # row 0's fourth new token
    jax_out["eos"] = (eos, np.asarray(jax.jit(lambda p, t: JG.generate(
        p, t, jcfg, 10, eos_id=eos, pad_id=0,
        compute_dtype=jnp.float32))(npy, jnp.asarray(full))))
    return dict(spec=spec, jcfg=jcfg, tcfg=tcfg, npy=npy, tparams=tparams,
                toks=toks, lens=lens, full=full, jax=jax_out)


def test_torch_prefill_logits_and_cache_match_jax(family):
    f = family
    cache, logits = TG.prefill(f["tparams"], torch.as_tensor(f["toks"]),
                               f["tcfg"], 16, compute_dtype=torch.float32,
                               prompt_lens=torch.as_tensor(f["lens"]))
    want_logits, want_cache = f["jax"]["prefill"]
    close(logits, want_logits)
    s0 = f["toks"].shape[1]
    for (wk, wv), c in zip(want_cache, cache):
        assert tuple(c["k"].shape) == wk.shape
        close(c["k"][:, :s0], wk[:, :s0])
        close(c["v"][:, :s0], wv[:, :s0])
        # past the prompt the cache is untouched
        assert not c["k"][:, s0:].any() and not c["v"][:, s0:].any()


def test_torch_decode_step_logits_match_jax(family):
    f = family
    cfg = f["tcfg"]
    cache, _ = TG.prefill(f["tparams"], torch.as_tensor(f["toks"]), cfg, 16,
                          compute_dtype=torch.float32,
                          prompt_lens=torch.as_tensor(f["lens"]))
    rope = TG._rope_full(cfg, 16, None)
    s0 = f["toks"].shape[1]
    shift = s0 - torch.as_tensor(f["lens"]).long()
    _, logits = TG.decode_step(f["tparams"], cache,
                               torch.tensor([5, 9, 2]), s0, cfg,
                               rope_full=rope, compute_dtype=torch.float32,
                               shift=shift)
    close(logits, f["jax"]["decode"])


def test_torch_greedy_generate_matches_jax_ragged_and_eos(family):
    f = family
    got = TG.generate(f["tparams"], torch.as_tensor(f["toks"]), f["tcfg"], 8,
                      prompt_lens=torch.as_tensor(f["lens"]),
                      compute_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), f["jax"]["ragged"])
    # each ragged row equals its unpadded single-row decode
    s0 = f["toks"].shape[1]
    for b, n in enumerate(f["lens"]):
        alone = TG.generate(f["tparams"],
                            torch.as_tensor(f["toks"][b:b + 1, s0 - n:]),
                            f["tcfg"], 8, compute_dtype=torch.float32)
        assert alone[0, n:].tolist() == got[b, s0:].tolist()
    eos, want = f["jax"]["eos"]
    out = TG.generate(f["tparams"], torch.as_tensor(f["full"]), f["tcfg"], 10,
                      eos_id=eos, pad_id=0, compute_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), want)
    row = out[0, 9:].tolist()
    k = row.index(eos)
    assert k <= 3 and row[k + 1:] == [0] * (len(row) - k - 1)


def test_torch_cast_once_gives_the_bits_of_cast_at_each_use():
    """The engine's weights in the compute dtype, cast once: the same
    bf16 logits and tokens as casting at every use."""
    _, cfg, _, params = _models(QWEN, seed=1)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 128, (2, 6)))
    seen = {}
    for tag, p in (("each", params),
                   ("once", TG.cast_for_compute(params, torch.bfloat16))):
        rows = []
        out = TG.generate(p, toks, cfg, 5, compute_dtype=torch.bfloat16,
                          on_logits=lambda i, lg: rows.append(lg.clone()))
        seen[tag] = (out, torch.stack(rows))
    assert torch.equal(seen["each"][0], seen["once"][0])
    assert torch.equal(seen["each"][1], seen["once"][1])
    cast = TG.cast_for_compute(params, torch.bfloat16)
    assert cast["layers"][0]["attn"]["wqkv"].dtype == torch.bfloat16
    assert cast["head"]["whead"].dtype == torch.bfloat16
    assert cast["embed"]["wte"].dtype == torch.float32  # used in fp32
    assert cast["layers"][0]["ln1"]["scale"].dtype == torch.float32


def test_torch_sampled_generate_contract():
    """Same generator seed, same stream; every token in the top-k set of
    its logits; the vocab padding (columns >= vocab_size) never drawn,
    even where the head favours it."""
    spec = dict(GPT2, tie_word_embeddings=False, vocab_size=100)
    _, cfg, _, params = _models(spec, seed=2)
    with torch.no_grad():
        params["head"]["whead"][:, 100:] += 5.0  # padding would win
    assert cfg.padded_vocab_size == 128
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 100, (3, 5)))

    def run(seed, **kw):
        rows = []
        out = TG.generate(params, toks, cfg, 12, temperature=0.9,
                          generator=torch.Generator().manual_seed(seed),
                          compute_dtype=torch.float32,
                          on_logits=lambda i, lg: rows.append(lg.clone()),
                          **kw)
        return out[:, 5:], torch.stack(rows, 1)

    a, _ = run(7)
    b, _ = run(7)
    c, _ = run(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < 100 and len(set(a.flatten().tolist())) > 3
    k, lg = run(3, top_k=4)
    assert int(k.max()) < 100
    valid = lg[..., :100]
    top = torch.topk(valid, 4, dim=-1).indices
    assert (top == k[..., None]).any(-1).all()


def test_torch_generate_encdec_matches_jax():
    jcfg, tcfg, npy, tparams = _models(T5, seed=4)
    src = np.random.default_rng(4).integers(0, 120, (3, 10)).astype(np.int32)
    free = TG.generate_encdec(tparams, torch.as_tensor(src), tcfg, 8,
                              compute_dtype=torch.float32)
    # eos retires a row: the rest of it repeats eos
    eos = int(free[1, 3])
    want = np.asarray(jax.jit(lambda p, t: JG.generate_encdec(
        p, t, jcfg, 8, eos_id=eos, compute_dtype=jnp.float32))(
            npy, jnp.asarray(src)))
    got = TG.generate_encdec(tparams, torch.as_tensor(src), tcfg, 8,
                             eos_id=eos, compute_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # before its eos, a row's tokens are the free run's
    np.testing.assert_array_equal(got[:, :4].numpy(), free[:, :4].numpy())


def test_torch_generate_refuses_what_it_does_not_decode():
    _, cfg, _, params = _models(QWEN, seed=0)
    toks = torch.zeros((1, 3), dtype=torch.long)
    bert = ModelArgs(**dict(QWEN, model_type="bert", norm_position="post"))
    with pytest.raises(NotImplementedError, match="causal decoder"):
        TG.generate(params, toks, bert, 2)
    moe = dict(params, layers=[dict(lp, moe={}) for lp in params["layers"]])
    with pytest.raises(NotImplementedError, match="dense layers only"):
        TG.generate(moe, toks, cfg, 2)
    t5 = ModelArgs(**T5)
    with pytest.raises(NotImplementedError, match="generate_encdec"):
        TG.generate(params, toks, t5, 2)
    with pytest.raises(ValueError, match="t5"):
        TG.generate_encdec(params, toks, cfg, 2)
    gpt = ModelArgs(**GPT2)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        TG.generate(TB.init_causal_lm(gpt), torch.zeros((1, 60),
                                                        dtype=torch.long),
                    gpt, 10)
