"""The port's T5 encoder-decoder against the JAX package: cross-attention,
the cross-decoder layer, ``forward_encdec`` logits, ``encdec_loss`` with
gradients (remat on both stacks, the encoder's gradients included), encoder
depths of 0 and unequal to the decoder's, the seq2seq batches, the
combined-stack remat flags, two training steps through ``cli/train_dist``
on the CPU, and the t5 tree through the weight bridge and save/resume.

Weights come from the JAX initializer through ``params_from_jax``, inputs
from seeded numpy; all compute is fp32. Forward values agree to 2e-5 and
gradients to 1e-4 (relative and absolute): only summation order differs.
Batches, flags and the bridge are exact, and so is remat against no remat
within the port.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core import arguments as JA
from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.data.indexed_dataset import write_indexed_dataset
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.models import encdec as JE
from hetu_galvatron_tpu.runtime import dataloader as JD
from hetu_galvatron_tpu.runtime import hybrid_config as JH
from hetu_galvatron_tpu.runtime import optimizer as JO
from hetu_galvatron_tpu.runtime import trainer as JT
from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import encdec as TE
from hetu_galvatron_tpu_torch.models import modules as TM
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime import dataloader as TD
from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH
from hetu_galvatron_tpu_torch.runtime import optimizer as TO
from hetu_galvatron_tpu_torch.runtime import trainer as TT

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
T5_YAML = os.path.join(os.path.dirname(__file__), "..", "hetu_galvatron_tpu",
                       "models", "configs", "t5-3b.yaml")
# t5-3b.yaml's family at a tiny width (RMSNorm, rope, GELU, tied head, no
# biases), with GQA 4:2 and 3 encoder layers over 2 decoder layers
T5 = dict(model_type="t5", hidden_size=64, num_hidden_layers=2,
          num_encoder_layers=3, num_attention_heads=4, num_key_value_heads=2,
          ffn_hidden_size=96, vocab_size=120, max_position_embeddings=64,
          seq_length=32, hidden_act="gelu", normalization="rmsnorm",
          position_embedding_type="rope", tie_word_embeddings=True,
          add_bias_linear=False, add_qkv_bias=False,
          make_vocab_size_divisible_by=64)
VARIANTS = {
    "enc3_dec2": T5,
    "enc0": dict(T5, num_encoder_layers=0),
    "enc_default": dict(T5, num_encoder_layers=None),
    # learned positions, LayerNorm, biases, an untied head
    "learned_biased_untied": dict(
        T5, position_embedding_type="learned", normalization="layernorm",
        add_bias_linear=True, add_qkv_bias=True, tie_word_embeddings=False),
}


def _setup(variant="enc3_dec2", seed=0):
    spec = VARIANTS[variant]
    jcfg, tcfg = JModelArgs(**spec), ModelArgs(**spec)
    jparams, _ = JB.init_causal_lm(jax.random.key(seed), jcfg)
    npy = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(seed)
    npy = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else a, npy)
    return jcfg, tcfg, npy, TK.params_from_jax(npy)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _tb(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else
            torch.from_numpy(v) for k, v in batch.items()}


def _batch(seed=2, b=2, s=10, t=12):
    rng = np.random.default_rng(seed)
    return {"enc_tokens": rng.integers(0, 120, (b, s)).astype(np.int32),
            "tokens": rng.integers(0, 120, (b, t)).astype(np.int32),
            "labels": rng.integers(0, 120, (b, t)).astype(np.int32),
            "loss_mask": (rng.random((b, t)) > 0.2).astype(np.float32)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_torch_t5_tree_has_the_jax_structure(variant):
    jcfg, tcfg, npy, _ = _setup(variant)
    tp = TB.init_causal_lm(tcfg, seed=0)
    want = {n: tuple(np.shape(a)) for n, a in TK._jax_named(npy)}
    got = {n: tuple(t.shape) for n, t in TB.named_leaves(tp)}
    assert got == want
    assert len(tp["enc_layers"]) == JE.encoder_layers(jcfg) \
        == TE.encoder_layers(tcfg)
    assert set(tp["layers"][0]) == {"ln1", "attn", "lnx", "cross", "ln2",
                                    "mlp"}


def test_torch_t5_cross_attention_matches_jax():
    """Decoder length 12 over an encoder memory of 10 (Sk != S), GQA."""
    jcfg, tcfg, npy, tp = _setup("learned_biased_untied")
    x, mem = _x((2, 12, 64)), _x((2, 10, 64), seed=3)
    p_t, p_j = tp["layers"][0]["cross"], npy["layers"][0]["cross"]
    got = TE.apply_cross_attention(p_t, torch.from_numpy(x),
                                   torch.from_numpy(mem), tcfg,
                                   compute_dtype=torch.float32)
    want = JE.apply_cross_attention(p_j, jnp.asarray(x), jnp.asarray(mem),
                                    jcfg, compute_dtype=jnp.float32)
    _close(got, want)
    k_t, v_t = TE.cross_kv(p_t, torch.from_numpy(mem), tcfg,
                           compute_dtype=torch.float32)
    k_j, v_j = JE.cross_kv(p_j, jnp.asarray(mem), jcfg,
                           compute_dtype=jnp.float32)
    _close(k_t, k_j)
    _close(v_t, v_j)
    # cached k/v give the same output
    cached = TE.apply_cross_attention(p_t, torch.from_numpy(x), None, tcfg,
                                      compute_dtype=torch.float32,
                                      cached_kv=(k_t, v_t))
    assert torch.equal(cached, got)


@pytest.mark.parametrize("variant", ["enc3_dec2", "learned_biased_untied"])
def test_torch_t5_cross_decoder_layer_matches_jax(variant):
    jcfg, tcfg, npy, tp = _setup(variant)
    x, mem = _x((2, 12, 64)), _x((2, 10, 64), seed=3)
    rope_t = rope_j = None
    if tcfg.position_embedding_type == "rope":
        rope_t = TM.rope_cos_sin(12, tcfg.head_dim, tcfg.rope_theta)
        rope_j = JE.M.rope_cos_sin(12, jcfg.head_dim, jcfg.rope_theta)
    got = TE.apply_cross_decoder_layer(
        tp["layers"][1], torch.from_numpy(x), torch.from_numpy(mem), tcfg,
        rope=rope_t, compute_dtype=torch.float32)
    want = JE.apply_cross_decoder_layer(
        npy["layers"][1], jnp.asarray(x), jnp.asarray(mem), jcfg,
        rope=rope_j, compute_dtype=jnp.float32)
    _close(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_torch_t5_forward_encdec_logits_match_jax(variant):
    jcfg, tcfg, npy, tp = _setup(variant)
    b = _batch()
    got = TE.forward_encdec(tp, torch.from_numpy(b["enc_tokens"]).long(),
                            torch.from_numpy(b["tokens"]).long(), tcfg,
                            compute_dtype=torch.float32)
    want = JE.forward_encdec(npy, jnp.asarray(b["enc_tokens"]),
                             jnp.asarray(b["tokens"]), jcfg,
                             compute_dtype=jnp.float32)
    assert got.shape == (2, 12, 128) and got.dtype == torch.float32
    _close(got, want)
    mem_t = TE.encode(tp, torch.from_numpy(b["enc_tokens"]).long(), tcfg,
                      compute_dtype=torch.float32)
    mem_j = JE.encode(npy, jnp.asarray(b["enc_tokens"]), jcfg,
                      compute_dtype=jnp.float32)
    _close(mem_t, mem_j)


def _grads(tp, loss):
    names, leaves = zip(*TB.named_leaves(tp))
    return dict(zip(names, torch.autograd.grad(loss, leaves)))


REMAT = {
    "none": dict(remat_flags=None, enc_remat_flags=None),
    "both_stacks": dict(remat_flags=[True, True],
                        enc_remat_flags=[True, True, True]),
    "mixed": dict(remat_flags=[False, True],
                  enc_remat_flags=[True, False, True]),
    # enc_remat_flags unset: the encoder takes remat_flags[0] on every layer
    "fallback": dict(remat_flags=[True, False], enc_remat_flags=None),
}


@pytest.mark.parametrize("variant", ["enc3_dec2", "enc0"])
@pytest.mark.parametrize("remat", sorted(REMAT))
def test_torch_t5_encdec_loss_and_grads_match_jax(variant, remat):
    """The loss and every leaf's gradient (encoder layers included) against
    JAX's; under remat the port's gradients equal its own without remat
    bit for bit, so each decoder layer's share of the encoder's gradient
    survives the recompute."""
    jcfg, tcfg, npy, tp = _setup(variant)
    flags = dict(REMAT[remat])
    if variant == "enc0" and flags["enc_remat_flags"]:
        flags["enc_remat_flags"] = []
    b = _batch()
    jl, jg = jax.value_and_grad(lambda p: JE.encdec_loss(
        p, jax.tree.map(jnp.asarray, b), jcfg, compute_dtype=jnp.float32,
        **flags))(jax.tree.map(jnp.asarray, npy))
    tl = TB.causal_lm_loss(tp, _tb(b), tcfg, compute_dtype=torch.float32,
                           **flags)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    grads = _grads(tp, tl)
    want = dict(TK._jax_named(jax.tree.map(np.asarray, jg)))
    assert set(grads) == set(want)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n], err_msg=n, **GRAD_TOL)
    plain = _grads(tp, TB.causal_lm_loss(tp, _tb(b), tcfg,
                                         compute_dtype=torch.float32))
    for n, g in grads.items():
        assert torch.equal(g, plain[n]), n
    if variant == "enc3_dec2":
        assert float(grads["enc_layers.0.attn.wqkv"].abs().max()) > 0


def test_torch_t5_enc_remat_flags_fall_back_like_jax(monkeypatch):
    """Without ``enc_remat_flags`` every encoder layer takes
    ``remat_flags[0]``; an explicit list is taken as given."""
    _, tcfg, _, tp = _setup()
    wrapped = []
    real = TM.remat

    def counting(fn, cfg):
        wrapped.append(fn)
        return real(fn, cfg)

    monkeypatch.setattr(TM, "remat", counting)
    b = _tb(_batch())
    for flags, want in (
            (dict(remat_flags=[True, False]), 3 + 1),
            (dict(remat_flags=[False, True]), 0 + 1),
            (dict(remat_flags=[False, False],
                  enc_remat_flags=[True, False, True]), 2)):
        wrapped.clear()
        TB.causal_lm_loss(tp, b, tcfg, compute_dtype=torch.float32, **flags)
        assert len(wrapped) == want, flags


def test_torch_t5_dropout_streams_repeat_under_remat():
    """With hidden and attention dropout, remat on both stacks gives the
    loss and gradients of no remat bit for bit (each layer redraws its
    masks from its own seed), and another step's generator gives another
    loss."""
    spec = dict(T5, hidden_dropout=0.1, attention_dropout=0.1)
    tcfg = ModelArgs(**spec)
    tp = TB.init_causal_lm(tcfg, seed=3)
    b = _tb(_batch())

    def run(seed, **flags):
        batch = dict(b, dropout_rng=torch.Generator().manual_seed(seed))
        loss = TB.causal_lm_loss(tp, batch, tcfg,
                                 compute_dtype=torch.float32, **flags)
        return loss, _grads(tp, loss)

    l0, g0 = run(5)
    l1, g1 = run(5, remat_flags=[True, True],
                 enc_remat_flags=[True, True, True])
    assert float(l0.detach()) == float(l1.detach())
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert float(run(6)[0].detach()) != float(l0.detach())
    with torch.no_grad():
        eval_loss = TB.causal_lm_loss(tp, b, tcfg,
                                      compute_dtype=torch.float32)
    assert float(eval_loss) != float(l0.detach())


# ---------------------------------------------------------------------------
# data and plan
# ---------------------------------------------------------------------------

EOD = 119


def _t5_corpus(tmp_path):
    rng = np.random.default_rng(0)
    prefix = str(tmp_path / "t5_corpus")
    write_indexed_dataset(prefix, [
        np.append(rng.integers(0, EOD, rng.integers(4, 30)), EOD)
        for _ in range(300)])
    with open(prefix + ".meta.json", "w") as f:
        json.dump({"vocab_size": 120, "eod_id": EOD}, f)
    return prefix


def _t5_overrides(prefix=None):
    over = ["model.hidden_size=64", "model.num_hidden_layers=2",
            "model.num_encoder_layers=3", "model.num_attention_heads=4",
            "model.num_key_value_heads=2", "model.ffn_hidden_size=96",
            "model.vocab_size=120", "model.seq_length=24",
            "model.max_position_embeddings=32",
            "model.make_vocab_size_divisible_by=64",
            "parallel.mixed_precision=fp32",
            "parallel.global_train_batch_size=4", "train.train_iters=2",
            "train.lr=1e-3", "train.seed=7"]
    if prefix is not None:
        over += ["data.dataset=indexed", f"data.data_path=['{prefix}']",
                 "data.split=98,1,1", "data.eod_mask_loss=true"]
    return over


@pytest.mark.parametrize("corpus", ["random", "indexed_eod"])
def test_torch_seq2seq_batches_through_the_loader_match_jax(tmp_path,
                                                           corpus):
    prefix = _t5_corpus(tmp_path) if corpus == "indexed_eod" else None
    over = _t5_overrides(prefix) + ["train.eval_interval=1",
                                    "train.eval_iters=1"]
    jits = JD.get_train_valid_test_data_iterators(
        JA.load_config(T5_YAML, over))
    tits = TD.get_train_valid_test_data_iterators(load_config(T5_YAML, over))
    for ji, ti in zip(jits, tits):
        for _ in range(3):
            jb, tb = next(ji), next(ti)
            assert sorted(tb) == sorted(jb) == [
                "enc_tokens", "labels", "loss_mask", "tokens"]
            assert tb["enc_tokens"].shape == tb["tokens"].shape == (4, 12)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    with pytest.raises(NotImplementedError, match="packing"):
        TD.get_data_iterator(load_config(T5_YAML, _t5_overrides() + [
            "data.reset_position_ids=true"]))


@pytest.mark.parametrize("n_enc", [None, 0, 3, 5])
@pytest.mark.parametrize("ckpt", [0, 1])
def test_torch_t5_combined_stack_flags_match_jax(n_enc, ckpt):
    over = _t5_overrides() + [f"parallel.global_checkpoint={ckpt}"]
    if n_enc is not None:
        over[2] = f"model.num_encoder_layers={n_enc}"
    else:
        over.pop(2)
    jh = JH.get_hybrid_parallel_config(JA.load_config(T5_YAML, over), 1)
    th = TH.get_hybrid_parallel_config(load_config(T5_YAML, over), 1)
    assert th.num_encoder_layers == jh.num_encoder_layers
    assert th.checkpoint_flags == [s.checkpoint for s in jh.layers]
    assert th.enc_flags == [s.checkpoint for s in jh.enc_strategies]
    assert th.dec_flags == [s.checkpoint for s in jh.dec_strategies]
    assert len(th.dec_flags) == 2


@pytest.mark.parametrize("n_enc", [3, 5])
def test_torch_t5_plan_fingerprint_matches_jax(n_enc):
    """A t5 checkpoint's plan fingerprint records the combined stack and
    its split point as JAX's does."""
    from hetu_galvatron_tpu.runtime import checkpoint as JK

    over = _t5_overrides() + ["parallel.global_checkpoint=1"]
    over[2] = f"model.num_encoder_layers={n_enc}"
    jh = JH.get_hybrid_parallel_config(JA.load_config(T5_YAML, over), 1)
    th = TH.get_hybrid_parallel_config(load_config(T5_YAML, over), 1)
    got, want = TK._plan_fingerprint(th), JK._plan_fingerprint(jh)
    assert got == want and got["num_encoder_layers"] == n_enc


def test_torch_t5_train_dist_two_steps_match_the_jax_trainer(tmp_path,
                                                            monkeypatch):
    """Two steps of ``train_dist.train(device=cpu)`` on ``t5-3b.yaml`` at a
    tiny width (3 encoder layers over 2 decoder layers) over an indexed
    corpus, remat on both stacks through the combined flags and fused CE,
    against two steps of the JAX trainer from the same weights: losses
    within 1e-5 relative and every parameter within 1e-5 relative, with an
    absolute floor of 1e-2 of the two steps' largest update (2 lr), as in
    ``test_torch_bert.py``."""
    prefix = _t5_corpus(tmp_path)
    over = _t5_overrides(prefix) + ["model.use_fused_ce=true",
                                    "parallel.global_checkpoint=1"]
    jargs = JA.load_config(T5_YAML, over)
    jparams, _ = JB.init_causal_lm(jax.random.key(5), jargs.model)
    npy = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(TB, "init_causal_lm",
                        lambda cfg, seed, device: TK.params_from_jax(npy))
    out = train_dist.train(load_config(T5_YAML, ["device=cpu", *over]))

    jtx = JO.make_optimizer(jargs.train)

    def jloss(p, b):
        return JB.causal_lm_loss(p, b, jargs.model, compute_dtype=jnp.float32,
                                 remat_flags=[True] * 2,
                                 enc_remat_flags=[True] * 3)

    jstep = jax.jit(JT.make_train_step(jloss, jtx))
    jopt = jtx.init(jparams)
    jit = JD.get_data_iterator(jargs, split="train")
    jlosses = []
    for _ in range(2):
        jparams, jopt, jm = jstep(jparams, jopt,
                                  jax.tree.map(jnp.asarray, next(jit)))
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
    want = dict(TB.named_leaves(TK.params_from_jax(
        jax.tree.map(np.asarray, jparams))))
    atol = 1e-2 * 2 * jargs.train.lr
    for name, t in TB.named_leaves(out["params"]):
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[name].detach().numpy(),
                                   rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("variant", ["enc3_dec2", "learned_biased_untied"])
def test_torch_t5_tree_through_the_bridge_and_save_resume_is_bit_exact(
        tmp_path, variant):
    _, tcfg, npy, tp = _setup(variant)
    back = TK.params_to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, npy))
    for (n, a), (_, b) in zip(TK._jax_named(npy), TK._jax_named(back)):
        np.testing.assert_array_equal(a, b, err_msg=n)
    # a decoder block with cross-attention outside a t5 tree is refused
    bad = dict(npy)
    bad.pop("enc_layers")
    bad.pop("enc_norm")
    with pytest.raises(ValueError, match="outside this slice"):
        TK.params_from_jax(bad)

    tx = TO.make_optimizer(load_config(None, ["train.lr=1e-3"]).train)
    step = TT.make_train_step(TT.make_loss_fn(
        tcfg, compute_dtype=torch.float32, remat_flags=[True, True],
        enc_remat_flags=[True, True, True]), tx)
    names, leaves = zip(*TB.named_leaves(tp))
    opt = tx.init(list(leaves), names)
    batches = [_tb(_batch(seed=s)) for s in (7, 8)]
    tp, opt, _ = step(tp, opt, batches[0])
    d = TK.save_checkpoint(str(tmp_path), 1, tp, opt)
    fresh = TK.params_from_jax(npy)
    fnames, fleaves = zip(*TB.named_leaves(fresh))
    rp, ro, _ = TK.load_checkpoint(d, fresh, tx.init(list(fleaves), fnames))
    for _, t in TB.named_leaves(rp):
        t.requires_grad_(True)
    tp, opt, m1 = step(tp, opt, batches[1])
    rp, ro, m2 = step(rp, ro, batches[1])
    assert float(m1["loss"]) == float(m2["loss"])
    for (n, a), (_, b) in zip(TB.named_leaves(tp), TB.named_leaves(rp)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("variant", ["enc3_dec2", "learned_biased_untied"])
def test_torch_t5_optimizer_state_crosses_the_bridge_exactly(variant):
    """The JAX optimizer's state after one step (optax's Adam moments over
    every leaf of the tree) -> the port's AdamState -> optax again: every
    count and moment survives bit for bit, by leaf name."""
    from hetu_galvatron_tpu.core.args_schema import TrainArgs as JTrainArgs

    jcfg, tcfg, npy, _ = _setup(variant)
    jtx = JO.make_optimizer(JTrainArgs(lr=1e-3, train_iters=4))
    jstep = JT.make_train_step(lambda p, b: JB.causal_lm_loss(
        p, b, jcfg, compute_dtype=jnp.float32), jtx)
    jp = jax.tree.map(jnp.asarray, npy)
    batch = _batch(seed=9)
    jp, jo, _ = jstep(jp, jtx.init(jp), jax.tree.map(jnp.asarray, batch))
    tparams = TK.params_from_jax(jax.tree.map(np.asarray, jp))
    st = TK.opt_state_from_jax(jax.tree.map(np.asarray, jo), tparams)
    assert st.count == 1 and len(st.mu) == len(list(TB.named_leaves(tparams)))
    back = TK.opt_state_to_jax(st, tparams, like=jtx.init(jp))
    leaves_a = jax.tree_util.tree_flatten_with_path(jo)[0]
    leaves_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in leaves_a] == [p for p, _ in leaves_b]
    for (path, a), (_, b) in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
