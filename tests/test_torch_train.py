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
    # an indexed corpus needs a path, packed documents need its eod id
    # (JAX raises the same); bert batches are not ported
    for bad, err in ((["data.dataset=indexed"], "data_path"),
                     (["data.reset_attention_mask=true"], "eod")):
        with pytest.raises(ValueError, match=err):
            TD.get_data_iterator(load_config(None, over + bad))
    with pytest.raises(NotImplementedError):
        TD.get_data_iterator(load_config(None, over + [
            "model.model_type=bert"]))


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
    with pytest.raises(NotImplementedError, match="aux"):
        TT.make_train_step(lambda p, b: None, tx, aux_stats=True)
