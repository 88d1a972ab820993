"""The port's BERT family against the JAX package: the post-norm block, the
embedding LayerNorm, the MLM head tied and untied, the masked-LM batches,
the loss and gradients, two training steps through ``cli/train_dist`` on
the CPU, and the bert tree through the weight bridge and save/resume.

Weights come from the JAX initializer through ``params_from_jax``, inputs
from seeded numpy; all compute is fp32. Forward values agree to 2e-5 and
gradients to 1e-4 (relative and absolute): only summation order differs.
The MLM masks and the bridge are exact.
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
from hetu_galvatron_tpu.models import modules as JM
from hetu_galvatron_tpu.runtime import dataloader as JD
from hetu_galvatron_tpu.runtime import optimizer as JO
from hetu_galvatron_tpu.runtime import trainer as JT
from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import modules as TM
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime import dataloader as TD
from hetu_galvatron_tpu_torch.runtime import optimizer as TO
from hetu_galvatron_tpu_torch.runtime import trainer as TT

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BERT_YAML = os.path.join(os.path.dirname(__file__), "..",
                         "hetu_galvatron_tpu", "models", "configs",
                         "bert-large.yaml")
# bert-large.yaml's family at a tiny width: post-norm LayerNorm blocks,
# learned positions, qkv and linear biases, GELU, the MLM head
BERT = dict(model_type="bert", hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, vocab_size=120, max_position_embeddings=32,
            seq_length=24, hidden_act="gelu", normalization="layernorm",
            position_embedding_type="learned", add_qkv_bias=True,
            add_bias_linear=True, make_vocab_size_divisible_by=64)
HEADS = {"tied": BERT, "untied": dict(BERT, tie_word_embeddings=False)}


def _setup(head="tied", seed=0):
    spec = HEADS[head]
    jcfg, tcfg = JModelArgs(**spec), ModelArgs(**spec)
    jparams, _ = JB.init_causal_lm(jax.random.key(seed), jcfg)
    npy = jax.tree.map(np.asarray, jparams)
    # non-zero biases and scales so every leaf matters
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


def test_torch_bert_tree_has_the_jax_structure():
    jcfg, tcfg, npy, _ = _setup("untied")
    tp = TB.init_causal_lm(tcfg, seed=0)
    want = {n: tuple(np.shape(a)) for n, a in TK._jax_named(npy)}
    got = {n: tuple(t.shape) for n, t in TB.named_leaves(tp)}
    assert got == want
    assert tp["prenorm"] == {} and "ln" in tp["embed"]
    assert set(tp["head"]) == {"wt", "bt", "ln", "bias", "whead"}
    assert tcfg.post_norm and jcfg.post_norm


def test_torch_bert_post_norm_block_matches_jax():
    jcfg, tcfg, npy, tp = _setup()
    x = _x((2, 24, 64))
    # bidirectional by family: a later token changes an earlier output
    got = TM.apply_decoder_layer(tp["layers"][0], torch.from_numpy(x), tcfg,
                                 compute_dtype=torch.float32)
    want = JM.apply_decoder_layer(npy["layers"][0], jnp.asarray(x), jcfg,
                                  compute_dtype=jnp.float32)
    _close(got, want)
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = TM.apply_decoder_layer(tp["layers"][0], torch.from_numpy(x2),
                                   tcfg, compute_dtype=torch.float32)
    assert not torch.allclose(moved[:, 0], got[:, 0])
    # post-norm: each block ends on its second LayerNorm's output
    ln2 = tp["layers"][0]["ln2"]
    normed = (got - ln2["bias"]) / ln2["scale"]
    np.testing.assert_allclose(normed.mean(-1).detach().numpy(), 0.0,
                               atol=1e-4)


def test_torch_bert_embedding_layernorm_matches_jax():
    jcfg, tcfg, npy, tp = _setup()
    tokens = np.random.default_rng(2).integers(0, 120, (2, 24))
    got = TM.apply_embedding(tp["embed"], torch.from_numpy(tokens), tcfg,
                             compute_dtype=torch.float32)
    want = JM.apply_embedding(npy["embed"], jnp.asarray(tokens), jcfg,
                              compute_dtype=jnp.float32)
    _close(got, want)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_torch_bert_mlm_head_matches_jax(head):
    jcfg, tcfg, npy, tp = _setup(head)
    x = _x((2, 24, 64))
    got = TM.apply_lm_head(tp["head"], torch.from_numpy(x), tcfg,
                           wte=tp["embed"]["wte"],
                           compute_dtype=torch.float32)
    want = JM.apply_lm_head(npy["head"], jnp.asarray(x), jcfg,
                            wte=jnp.asarray(npy["embed"]["wte"]),
                            compute_dtype=jnp.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 128)
    _close(got, want)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_torch_bert_loss_and_grads_match_jax(head):
    jcfg, tcfg, npy, tp = _setup(head)
    rng = np.random.RandomState(3)
    batch = TD.make_mlm_batch(rng.randint(0, 120, (2, 24)), 128, rng,
                              mask_prob=0.3)
    jl, jg = jax.value_and_grad(lambda p: JB.causal_lm_loss(
        p, jax.tree.map(jnp.asarray, batch), jcfg,
        compute_dtype=jnp.float32))(jax.tree.map(jnp.asarray, npy))
    for remat in (None, [True, False]):
        tl = TB.causal_lm_loss(tp, _tb(batch), tcfg,
                               compute_dtype=torch.float32,
                               remat_flags=remat)
        np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
        names, leaves = zip(*TB.named_leaves(tp))
        grads = torch.autograd.grad(tl, leaves)
        want = dict(TK._jax_named(jax.tree.map(np.asarray, jg)))
        assert set(names) == set(want)
        for n, g in zip(names, grads):
            np.testing.assert_allclose(g.numpy(), want[n], err_msg=n,
                                       **GRAD_TOL)


# ---------------------------------------------------------------------------
# masked-LM batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"mask_token": 7, "mask_prob": 0.4},
                                {"eligible": "odd"}], ids=str)
def test_torch_make_mlm_batch_is_bit_identical_to_jax(kw):
    samples = np.random.default_rng(0).integers(0, 500, (4, 64))
    if kw.get("eligible") == "odd":
        kw = dict(kw, eligible=(samples % 2).astype(np.int32))
    jrng, trng = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(3):  # the generator advances across batches alike
        want = JD.make_mlm_batch(samples, 512, jrng, **kw)
        got = TD.make_mlm_batch(samples, 512, trng, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # every selected position: masked, swapped or kept, label the original
    sel = got["loss_mask"] > 0
    assert sel.any() and (got["labels"] == samples).all()


EOD = 119


def _bert_corpus(tmp_path, vocab=EOD):
    rng = np.random.default_rng(0)
    prefix = str(tmp_path / "bert_corpus")
    write_indexed_dataset(prefix, [
        np.append(rng.integers(0, vocab, rng.integers(4, 30)), EOD)
        for _ in range(300)])
    with open(prefix + ".meta.json", "w") as f:
        json.dump({"vocab_size": 120, "eod_id": EOD}, f)
    return prefix


def _bert_overrides(prefix=None):
    over = ["model.hidden_size=64", "model.num_hidden_layers=2",
            "model.num_attention_heads=4", "model.vocab_size=120",
            "model.seq_length=24", "model.max_position_embeddings=32",
            "model.make_vocab_size_divisible_by=64",
            "parallel.mixed_precision=fp32",
            "parallel.global_train_batch_size=4", "train.train_iters=2",
            "train.lr=1e-3", "train.seed=7"]
    if prefix is not None:
        over += ["data.dataset=indexed", f"data.data_path=['{prefix}']",
                 "data.split=98,1,1", "data.eod_mask_loss=true"]
    return over


@pytest.mark.parametrize("corpus", ["random", "indexed_eod"])
def test_torch_mlm_batches_through_the_loader_match_jax(tmp_path, corpus):
    """The whole loader (dataset, split, eod exclusion, MLM masking) gives
    JAX's batches bit for bit, the eval splits too."""
    prefix = _bert_corpus(tmp_path) if corpus == "indexed_eod" else None
    over = _bert_overrides(prefix) + ["train.eval_interval=1",
                                      "train.eval_iters=1"]
    jits = JD.get_train_valid_test_data_iterators(
        JA.load_config(BERT_YAML, over))
    tits = TD.get_train_valid_test_data_iterators(
        load_config(BERT_YAML, over))
    for ji, ti in zip(jits, tits):
        for _ in range(3):
            jb, tb = next(ji), next(ti)
            assert sorted(jb) == ["labels", "loss_mask", "tokens"]
            assert sorted(tb) == sorted(jb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            if prefix is not None:
                # eod tokens are never selected
                assert not (tb["loss_mask"][tb["labels"] == EOD]).any()


def test_torch_mlm_batches_refuse_packing_flags_like_jax():
    for flag in ("data.reset_position_ids=true",
                 "data.reset_attention_mask=true"):
        over = _bert_overrides() + [flag]
        with pytest.raises(NotImplementedError, match="packing"):
            JD.get_data_iterator(JA.load_config(BERT_YAML, over))
        with pytest.raises(NotImplementedError, match="packing"):
            TD.get_data_iterator(load_config(BERT_YAML, over))


def test_torch_bert_train_dist_two_steps_match_the_jax_trainer(tmp_path,
                                                              monkeypatch):
    """Two steps of ``train_dist.train(device=cpu)`` on ``bert-large.yaml``
    at a tiny width over an indexed corpus with eod masking, remat on every
    layer, fused CE (the port's plain K4/K5, the JAX kernels in interpret
    mode), against two steps of the JAX trainer from the same weights:
    losses within 1e-5 relative and every parameter within 1e-5 relative,
    with an absolute floor of 1e-2 of the two steps' largest update (2 lr)
    for entries near zero: Adam's first step moves every entry by lr times
    the sign of its gradient, so the summation-order noise of a cancelling
    gradient entry is amplified up to the update's size."""
    prefix = _bert_corpus(tmp_path)
    over = _bert_overrides(prefix) + ["model.use_fused_ce=true",
                                      "parallel.global_checkpoint=1"]
    jargs = JA.load_config(BERT_YAML, over)
    jparams, _ = JB.init_causal_lm(jax.random.key(5), jargs.model)
    npy = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(TB, "init_causal_lm",
                        lambda cfg, seed, device: TK.params_from_jax(npy))
    out = train_dist.train(load_config(BERT_YAML, ["device=cpu", *over]))

    jtx = JO.make_optimizer(jargs.train)
    jstep = jax.jit(JT.make_train_step(JT.make_loss_fn(
        jargs.model, compute_dtype=jnp.float32, remat_flags=[True, True]),
        jtx))
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


@pytest.mark.parametrize("head", sorted(HEADS))
def test_torch_bert_tree_through_the_bridge_and_save_resume_is_bit_exact(
        tmp_path, head):
    """JAX tree -> port -> JAX is exact; a port checkpoint of the bert tree
    with its AdamW state resumes bit for bit: the next step's loss and
    every leaf equal the uninterrupted run's."""
    _, tcfg, npy, tp = _setup(head)
    back = TK.params_to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, npy))
    for (n, a), (_, b) in zip(TK._jax_named(npy), TK._jax_named(back)):
        np.testing.assert_array_equal(a, b, err_msg=n)

    tx = TO.make_optimizer(load_config(None, ["train.lr=1e-3"]).train)
    step = TT.make_train_step(TT.make_loss_fn(tcfg,
                                              compute_dtype=torch.float32),
                              tx)
    names, leaves = zip(*TB.named_leaves(tp))
    opt = tx.init(list(leaves), names)
    rng = np.random.RandomState(4)
    batches = [_tb(TD.make_mlm_batch(rng.randint(0, 120, (2, 24)), 128,
                                     rng)) for _ in range(2)]
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


@pytest.mark.parametrize("head", sorted(HEADS))
def test_torch_bert_optimizer_state_crosses_the_bridge_exactly(head):
    """The JAX optimizer's state after one step (optax's Adam moments over
    every leaf of the tree) -> the port's AdamState -> optax again: every
    count and moment survives bit for bit, by leaf name."""
    from hetu_galvatron_tpu.core.args_schema import TrainArgs as JTrainArgs

    jcfg, tcfg, npy, _ = _setup(head)
    jtx = JO.make_optimizer(JTrainArgs(lr=1e-3, train_iters=4))
    jstep = JT.make_train_step(lambda p, b: JB.causal_lm_loss(
        p, b, jcfg, compute_dtype=jnp.float32), jtx)
    jp = jax.tree.map(jnp.asarray, npy)
    rng = np.random.RandomState(9)
    batch = TD.make_mlm_batch(rng.randint(0, 120, (2, 24)), 128, rng)
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
