"""Port data, optimizer and train step against the JAX package.

* data: the same numpy batches for the same seed and position (exact);
* lr schedules: the five styles against the optax ones (1e-6 relative,
  float64 host arithmetic against float32 optax);
* train step: a 3-step trajectory of the port's ``make_train_step`` with
  its AdamW chain against the JAX ``make_train_step`` with optax
  ``make_optimizer`` on the same weights and batches, fp32 on the CPU. Loss
  and every parameter agree to 1e-4 relative (atol 1e-6 for entries near
  zero); the two differ only by summation order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import CoreArgs as JCoreArgs
from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.core.args_schema import TrainArgs as JTrainArgs
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.runtime import dataloader as JD
from hetu_galvatron_tpu.runtime import optimizer as JO
from hetu_galvatron_tpu.runtime import trainer as JT
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, TrainArgs
from hetu_galvatron_tpu_torch.models.builder import named_leaves
from hetu_galvatron_tpu_torch.runtime import dataloader as TD
from hetu_galvatron_tpu_torch.runtime import optimizer as TO
from hetu_galvatron_tpu_torch.runtime import trainer as TT
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_from_jax

MODEL = dict(model_type="gpt", hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, vocab_size=128, max_position_embeddings=32,
             seq_length=16, make_vocab_size_divisible_by=1)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_torch_synthetic_batches_equal_jax():
    jm, tm = JModelArgs(**MODEL), ModelArgs(**MODEL)
    for seed in (0, 1234):
        ji = JD.synthetic_batches(jm, 8, size=20, seed=seed)
        ti = TD.synthetic_batches(tm, 8, size=20, seed=seed)
        for _ in range(4):  # wraps around the 20-sample dataset
            jb, tb = next(ji), next(ti)
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])


def test_torch_data_iterators_equal_jax_per_split():
    over = [f"model.{k}={v}" for k, v in MODEL.items()] + [
        "train.eval_interval=2", "train.eval_iters=1",
        "parallel.global_train_batch_size=4"]
    jargs = JCoreArgs.model_validate(
        {"model": MODEL, "train": {"eval_interval": 2, "eval_iters": 1},
         "parallel": {"global_train_batch_size": 4}})
    targs = load_config(None, over)
    jits = JD.get_train_valid_test_data_iterators(jargs)
    tits = TD.get_train_valid_test_data_iterators(targs)
    for ji, ti in zip(jits, tits):
        for _ in range(2):
            jb, tb = next(ji), next(ti)
            for k in jb:
                np.testing.assert_array_equal(jb[k], tb[k])
    no_eval = TD.get_train_valid_test_data_iterators(
        load_config(None, over[:-3]))
    assert no_eval[1] is None and no_eval[2] is None
    # an indexed corpus needs a path, packed documents need its eod id, and
    # bert batches have no packed documents (JAX raises the same); bert's
    # masked-LM batches are held to JAX's in test_torch_bert.py
    for bad, err in ((["data.dataset=indexed"], "data_path"),
                     (["data.reset_attention_mask=true"], "eod")):
        with pytest.raises(ValueError, match=err):
            TD.get_data_iterator(load_config(None, over + bad))
    with pytest.raises(NotImplementedError):
        TD.get_data_iterator(load_config(None, over + [
            "model.model_type=bert", "data.reset_attention_mask=true"]))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": dict(lr_decay_style="constant", lr_warmup_iters=3),
    "linear": dict(lr_decay_style="linear", lr_warmup_iters=2),
    "cosine": dict(lr_decay_style="cosine", lr_warmup_iters=0),
    "cosine_warmup": dict(lr_decay_style="cosine", lr_warmup_iters=4,
                          lr_decay_iters=15),
    "inverse_sqrt": dict(lr_decay_style="inverse-square-root",
                         lr_warmup_iters=3),
    "wsd": dict(lr_decay_style="WSD", lr_warmup_iters=2,
                lr_wsd_decay_iters=5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_torch_lr_schedules_match_optax(name):
    kw = dict(lr=3e-3, min_lr=2e-4, train_iters=20, **SCHEDULES[name])
    ours = TO.make_lr_schedule(TrainArgs(**kw))
    theirs = JO.make_lr_schedule(JTrainArgs(**kw))
    for step in range(0, 26):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, atol=1e-12, err_msg=str(step))


def test_torch_global_grad_norm_matches_jax():
    rng = np.random.default_rng(0)
    gs = [rng.standard_normal(s).astype(np.float32)
          for s in ((3, 4), (5,), (2, 2, 2))]
    np.testing.assert_allclose(
        float(TO.global_grad_norm([torch.from_numpy(g) for g in gs])),
        float(JO.global_grad_norm([jnp.asarray(g) for g in gs])), rtol=1e-6)


# ---------------------------------------------------------------------------
# train step trajectory
# ---------------------------------------------------------------------------


def test_torch_microbatch_weights_match_jax():
    mask = np.random.default_rng(1).random((4, 2, 16)) < 0.5
    np.testing.assert_allclose(
        TT.microbatch_weights(torch.from_numpy(mask), 4).numpy(),
        np.asarray(JT.microbatch_weights(jnp.asarray(mask), 4)), rtol=1e-7)
    np.testing.assert_allclose(TT.microbatch_weights(None, 4).numpy(),
                               np.full(4, 0.25, np.float32))


def _batches(n, seed=7):
    """Synthetic batches with a non-uniform loss mask (whole rows and
    scattered tokens masked out, so microbatch token shares differ)."""
    it = TD.synthetic_batches(ModelArgs(**MODEL), 4, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = next(it)
        mask = (rng.random(b["loss_mask"].shape) < 0.6).astype(np.float32)
        mask[1] = 0.0
        b["loss_mask"] = mask
        out.append(b)
    return out


@pytest.mark.parametrize("chunks,warmup", [(1, 0), (2, 0), (1, 2), (2, 2)])
def test_torch_train_step_trajectory_matches_jax(chunks, warmup):
    # adam_eps 1e-5: Adam's m / sqrt(v) is ill-conditioned at entries whose
    # gradient is near fp32 noise, and a larger eps (outside the sqrt on
    # both sides, so its placement is tested) keeps those well-posed
    train = dict(lr=5e-3, min_lr=5e-4, weight_decay=0.1, clip_grad=0.5,
                 adam_eps=1e-5, train_iters=3, lr_warmup_iters=warmup,
                 lr_decay_style="cosine")
    jcfg, tcfg = JModelArgs(**MODEL), ModelArgs(**MODEL)
    jparams, _ = JB.init_causal_lm(jax.random.key(3), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))

    jtx = JO.make_optimizer(JTrainArgs(**train))
    jstep = jax.jit(JT.make_train_step(
        JT.make_loss_fn(jcfg, compute_dtype=jnp.float32), jtx,
        chunks=chunks))
    jopt = jtx.init(jparams)
    ttx = TO.make_optimizer(TrainArgs(**train))
    tstep = TT.make_train_step(
        TT.make_loss_fn(tcfg, compute_dtype=torch.float32), ttx,
        chunks=chunks)
    topt = ttx.init([t for _, t in named_leaves(tparams)])

    for it, b in enumerate(_batches(3)):
        jparams, jopt, jm = jstep(jparams, jopt,
                                  jax.tree.map(jnp.asarray, b))
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
        tparams, topt, tm = tstep(tparams, topt, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss at step {it}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    want = dict(named_leaves(params_from_jax(
        jax.tree.map(np.asarray, jparams))))
    for name, t in named_leaves(tparams):
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[name].detach().numpy(),
                                   err_msg=name, **TRAJ_TOL)
    assert topt.count == 3


def test_torch_first_update_is_zero_under_warmup():
    """optax's count starts at 0, so lr(0) = 0 with warmup: the first step
    changes nothing, the second does."""
    cfg = ModelArgs(**MODEL)
    params = params_from_jax(jax.tree.map(
        np.asarray, JB.init_causal_lm(jax.random.key(0),
                                      JModelArgs(**MODEL))[0]))
    before = {n: t.detach().clone() for n, t in named_leaves(params)}
    tx = TO.make_optimizer(TrainArgs(lr=1e-2, lr_warmup_iters=2,
                                     train_iters=4))
    step = TT.make_train_step(TT.make_loss_fn(cfg, compute_dtype=torch.float32),
                              tx)
    opt = tx.init([t for _, t in named_leaves(params)])
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    b["tokens"], b["labels"] = b["tokens"].long(), b["labels"].long()
    params, opt, _ = step(params, opt, b)
    for n, t in named_leaves(params):
        assert torch.equal(t.detach(), before[n]), n
    params, opt, _ = step(params, opt, b)
    assert not torch.equal(params["embed"]["wte"].detach(),
                           before["embed.wte"])


def test_torch_train_step_refuses_paths_outside_the_slice():
    tx = TO.make_optimizer(TrainArgs())
    with pytest.raises(NotImplementedError, match="hier"):
        TT.make_train_step(lambda p, b: None, tx, hier=object())
    # MoE aux statistics run now (test_torch_train_step_moe_stats_match_jax)
    TT.make_train_step(lambda p, b: None, tx, aux_stats=True)
    with pytest.raises(NotImplementedError, match="hier"):
        TT.make_train_step(lambda p, b: None, tx, aux_stats=True,
                           hier=object())


# ---------------------------------------------------------------------------
# MoE: aux statistics, the expert-bias partition, bounded AdamW groups
# ---------------------------------------------------------------------------

MOE_MODEL = dict(model_type="moe", hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
                 max_position_embeddings=32, seq_length=16,
                 hidden_act="swiglu", normalization="rmsnorm",
                 position_embedding_type="rope", tie_word_embeddings=False,
                 add_bias_linear=False, make_vocab_size_divisible_by=1,
                 ffn_hidden_size=48, num_experts=4, moe_topk=2,
                 moe_z_loss_coeff=1e-3, moe_router_enable_expert_bias=True,
                 moe_expert_bias_update_rate=1e-2)


def _torch_batch(b):
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    return tb


@pytest.mark.parametrize("chunks", [1, 2])
def test_torch_moe_train_step_trajectory_matches_jax(chunks):
    """Three aux-stats steps of a 2-layer MoE model with an expert bias,
    clipping on: loss, grad norm, every layer's ``metrics["moe"]``
    (tokens_per_expert exact, summed over microbatches; loss-like stats by
    token share) and every parameter against the JAX trainer within 1e-5
    relative, with atol 1e-6 (3e-4 of the three steps' update at lr 1e-3)
    for embedding entries of rare tokens, whose near-zero gradients Adam's
    m / sqrt(v) turns into full-size updates of summation-order noise."""
    train = dict(lr=1e-3, min_lr=1e-4, weight_decay=0.1, clip_grad=0.5,
                 adam_eps=1e-5, train_iters=3, lr_decay_style="cosine")
    jcfg, tcfg = JModelArgs(**MOE_MODEL), ModelArgs(**MOE_MODEL)
    jparams, _ = JB.init_causal_lm(jax.random.key(21), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jtx = JO.make_optimizer(JTrainArgs(**train))
    jstep = jax.jit(JT.make_train_step(
        lambda p, b: JB.causal_lm_loss(p, b, jcfg, compute_dtype=jnp.float32,
                                       with_moe_stats=True),
        jtx, chunks=chunks, aux_stats=True))
    jopt = jtx.init(jparams)
    ttx = TO.make_optimizer(TrainArgs(**train))
    tstep = TT.make_train_step(
        TT.make_loss_fn(tcfg, compute_dtype=torch.float32,
                        with_moe_stats=True),
        ttx, chunks=chunks, aux_stats=True)
    names, leaves = zip(*named_leaves(tparams))
    topt = ttx.init(list(leaves), names)
    assert [names[i] for i in topt.sgd] == [
        "layers.0.moe.expert_bias", "layers.1.moe.expert_bias"]

    for it, b in enumerate(_batches(3, seed=22)):
        jparams, jopt, jm = jstep(jparams, jopt,
                                  jax.tree.map(jnp.asarray, b))
        tparams, topt, tm = tstep(tparams, topt, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss at step {it}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert sorted(tm["moe"]) == sorted(jm["moe"]) == ["layer0", "layer1"]
        for layer, st in tm["moe"].items():
            tpe = st["tokens_per_expert"].numpy()
            np.testing.assert_array_equal(
                tpe, np.asarray(jm["moe"][layer]["tokens_per_expert"]))
            assert tpe.sum() == 4 * 16 * 2  # every slot of the batch
            for key in ("load_balance_loss", "z_loss"):
                np.testing.assert_allclose(
                    float(st[key]), float(jm["moe"][layer][key]),
                    rtol=1e-5, err_msg=f"{layer} {key} at step {it}")
    want = dict(named_leaves(params_from_jax(
        jax.tree.map(np.asarray, jparams))))
    for name, t in named_leaves(tparams):
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_torch_expert_bias_moves_by_the_rate_and_adam_clips_alone():
    """The SGD(1) partition applies the router's raw ±rate signal to each
    expert bias while the Adam leaves train; with a clip, the Adam leaves
    divide by their own global norm (optax clips inside the partition), and
    an update against optax's ``make_optimizer`` shows it."""
    cfg = ModelArgs(**{**MOE_MODEL, "moe_aux_loss_coeff": 0.0,
                       "moe_z_loss_coeff": 0.0})
    params = params_from_jax(jax.tree.map(np.asarray, JB.init_causal_lm(
        jax.random.key(7), JModelArgs(**MOE_MODEL))[0]))
    before = {n: t.detach().clone() for n, t in named_leaves(params)}
    tx = TO.make_optimizer(TrainArgs(lr=1e-3, clip_grad=0.0,
                                     lr_decay_style="constant"))
    step = TT.make_train_step(
        TT.make_loss_fn(cfg, compute_dtype=torch.float32), tx)
    names, leaves = zip(*named_leaves(params))
    params, _, _ = step(params, tx.init(list(leaves), names),
                        _torch_batch(_batches(1, seed=3)[0]))
    rate = cfg.moe_expert_bias_update_rate
    for i in range(2):
        name = f"layers.{i}.moe.expert_bias"
        delta = (params["layers"][i]["moe"]["expert_bias"].detach()
                 - before[name]).abs()
        assert delta.max() > 0, f"{name} did not move"
        assert torch.all((delta == 0) | ((delta - rate).abs() < 1e-9)), name
    assert not torch.equal(params["layers"][0]["attn"]["wqkv"].detach(),
                           before["layers.0.attn.wqkv"])
    # sinkhorn routing ignores the bias: its gradient is zero (as JAX's
    # grad gives for an unused leaf) and it stays where it is
    sink = dataclasses.replace(cfg, moe_router_type="sinkhorn")
    step = TT.make_train_step(
        TT.make_loss_fn(sink, compute_dtype=torch.float32), tx)
    bias = params["layers"][0]["moe"]["expert_bias"].detach().clone()
    params, _, _ = step(params, tx.init(list(leaves), names),
                        _torch_batch(_batches(1, seed=4)[0]))
    assert torch.equal(params["layers"][0]["moe"]["expert_bias"].detach(),
                       bias)

    # the clip against optax, with bias gradients large enough that the
    # all-leaf norm would clip the Adam leaves differently
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "moe": {"expert_bias": np.zeros(4, np.float32)}}
    grads = {"w": rng.standard_normal((6, 5)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32),
             "moe": {"expert_bias": np.full(4, -30.0, np.float32)}}
    train = dict(lr=0.1, clip_grad=0.5, adam_eps=1.0, weight_decay=0.1,
                 lr_decay_style="constant")
    jtx = JO.make_optimizer(JTrainArgs(**train))
    upd, _ = jtx.update(grads, jtx.init(tree), tree)
    want = jax.tree.map(lambda p, u: np.asarray(p + u), tree, upd)
    ttx = TO.make_optimizer(TrainArgs(**train))
    tparams = [torch.from_numpy(tree[k].copy()) for k in ("b", "w")] + [
        torch.from_numpy(tree["moe"]["expert_bias"].copy())]
    tgrads = [torch.from_numpy(grads[k].copy()) for k in ("b", "w")] + [
        torch.from_numpy(grads["moe"]["expert_bias"].copy())]
    state = ttx.init(tparams, ["b", "w", "moe.expert_bias"])
    ttx.update(tparams, tgrads, state, TO.global_grad_norm(tgrads))
    for t, w in zip(tparams, (want["b"], want["w"],
                              want["moe"]["expert_bias"])):
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tparams[2].numpy(), np.full(4, 30.0))


def test_torch_grouped_adamw_is_bit_identical(monkeypatch):
    """AdamW over groups of leaves (a 64-byte cap: many groups, a 96-byte
    leaf alone) equals the one-group update bit for bit over 3 steps, with
    clipping and weight decay on."""
    assert TO.leaf_groups([4, 30, 2, 2, 16, 1], 64) == [[0], [1], [2, 3],
                                                        [4], [5]]
    assert TO.leaf_groups([4, 30, 2], None) == [[0, 1, 2]]
    rng = np.random.default_rng(9)
    shapes = [(4,), (5, 6), (2,), (2,), (4, 4), (1,), (3, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    train = TrainArgs(lr=1e-2, weight_decay=0.1, clip_grad=0.3,
                      lr_warmup_iters=1, train_iters=3)
    runs = []
    for cap in (None, 64):
        monkeypatch.setattr(TO, "GROUP_BYTES", cap)
        tx = TO.AdamW(train)
        params = [torch.from_numpy(a.copy()) for a in init]
        state = tx.init(params)
        for g in grads:
            g = [torch.from_numpy(a.copy()) for a in g]
            tx.update(params, g, state, TO.global_grad_norm(g))
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    for a, b in zip(p1 + s1.mu + s1.nu, p2 + s2.mu + s2.nu):
        assert torch.equal(a, b)
    assert not torch.equal(p1[1], torch.from_numpy(init[1]))
