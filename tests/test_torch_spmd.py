"""The port's SPMD train step (``parallel/spmd.py``) on gloo ranks against
JAX's ``make_spmd_train_step`` on a slice of the virtual CPU mesh of the
same size, and against JAX's single-device step (JAX's own
``tests/core/test_parallel_spmd.py``), in fp32.

Every case trains the same weights (the port's seeded init, crossed over
with ``params_to_jax``) on the same global batches. Held: the loss of
every step within 2e-5 (JAX's ``test_strategy_matches_single_device``)
and every gathered parameter within rtol 5e-4, atol 3e-4 after the steps;
the 3-step trajectory at JAX's trajectory tolerances (5e-5; 1e-3). One
exception, counted: an element whose last gradient (JAX's, single device)
is non-zero and within 10x Adam's eps of zero, where ``g / (|g| + eps)`` turns the
summation-order noise of ``g`` into a change of the update of order one
(JAX's own SPMD step lands half its tolerance from its single-device step
on such an element of the GPT case). The sign of such a gradient may differ
between two summation orders, so two correct steps may move the element
apart by twice Adam's reach. Instead each side's own movement from the
shared initial weights is held to that reach (:func:`_adam_reach`), and
such elements must be under 1% of every leaf and under 0.1% of the tree.
The
cases: JAX's ``STRATEGIES`` this slice runs (pure TP, DP, ZeRO-3, ZeRO-2,
tp2 x ZeRO-3, tp x dp, remat, vtp != tp, chunks 2; at a world of 4 pure
TP is tp4 and tp4 x dp2 is tp2 x dp2, both also at 8), the mixed
per-layer plan of ``test_mixed_per_layer_strategies`` (its own world of 8
and a world-4 counterpart), the ``spmd_tp2zero3`` example plan, a masked
loss over two microbatches, GPT-2's leaves (biases, LayerNorm, learned
positions, a tied head) on packed documents under tp2 x vtp2 x ZeRO-2,
the trajectory, and attention dropout (``make_flash_sdpa``'s shard seed,
bit for bit with JAX's, through the flash kernels' plain versions against
the Pallas kernels in interpret mode). One spawned world a size runs
every case; each rank uses one torch thread."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hetu_galvatron_tpu.core.args_schema import CoreArgs as JCoreArgs
from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.core.args_schema import TrainArgs as JTrainArgs
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.ops.pallas import flash_attention as JF
from hetu_galvatron_tpu.parallel import spmd as JS
from hetu_galvatron_tpu.runtime import hybrid_config as JH
from hetu_galvatron_tpu.runtime import mesh as JM
from hetu_galvatron_tpu.runtime.optimizer import make_optimizer as jax_opt
from hetu_galvatron_tpu.utils import strategy as JU
from hetu_galvatron_tpu_torch.models.builder import init_causal_lm
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.parallel.launch import spawn_world
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_to_jax
from hetu_galvatron_tpu_torch.runtime.dataloader import packed_doc_fields

DENSE = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=64, seq_length=16,
             hidden_act="swiglu", normalization="rmsnorm",
             position_embedding_type="rope", tie_word_embeddings=False,
             add_bias_linear=False, add_qkv_bias=False,
             make_vocab_size_divisible_by=1, ffn_hidden_size=128)
GPT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64, seq_length=16,
           make_vocab_size_divisible_by=1)
TRAIN = dict(lr=1e-2, clip_grad=1.0, weight_decay=0.01,
             lr_decay_style="constant", lr_warmup_iters=0)
LOSS_TOL, RTOL, ATOL = 2e-5, 5e-4, 3e-4
NEAR_EPS = 10 * 1e-8  # 10x Adam's eps (TrainArgs.adam_eps)
TRAJ_LOSS_TOL, TRAJ_TOL = 5e-5, 1e-3
EOD = 7
PLAN_DIR = tempfile.mkdtemp(prefix="galvatron_spmd_plans_")
EXAMPLE = os.path.join(os.path.dirname(__file__), "..",
                       "hetu_galvatron_tpu_torch", "profiles",
                       "example_plans", "galvatron_config_spmd_tp2zero3.json")


def batch(seed=0, masked=False, packed=False, bsz=8):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, 128, (bsz, 17)).astype(np.int32)
    if packed:
        tok[:, 4], tok[:, 11] = EOD, EOD  # several documents a row
    b = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
         "loss_mask": np.ones((bsz, 16), np.float32)}
    if masked:
        b["loss_mask"] = (rs.rand(bsz, 16) > 0.3).astype(np.float32)
    if packed:
        b["loss_mask"] = (tok[:, 1:] != EOD).astype(np.float32)
        b.update(packed_doc_fields(b["tokens"], EOD, reset_position_ids=True,
                                   reset_attention_mask=True))
    return b


def plan_file(name, layers, vocab_tp, default="ddp", chunks=1):
    """A searched-style plan of ``layers`` (tp, dp, dp type) in JAX's
    format (the port reads the same file)."""
    strategies = [JU.LayerStrategy(pp_deg=1, tp_size=tp, dp_size=dp,
                                   dp_type=JU.DPType.from_name(t))
                  for tp, dp, t in layers]
    cfg = JU.strategy_list2config(
        strategies, global_bsz=8, chunks=chunks, default_dp_type=default,
        vocab=JU.EmbeddingLMHeadStrategy(vtp=vocab_tp))
    path = os.path.join(PLAN_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def json_mode(path):
    return dict(config_mode="json", galvatron_config_path=path)


# name -> (world, model, parallel settings, batches)
CASES = {
    "tp4": (4, DENSE, dict(global_tp_deg=4), [batch()]),
    "dp4": (4, DENSE, dict(default_dp_type="ddp"), [batch()]),
    "zero3": (4, DENSE, dict(sdp=1), [batch()]),
    "zero2": (4, DENSE, dict(default_dp_type="zero2"), [batch()]),
    "tp2_zero3": (4, DENSE, dict(global_tp_deg=2, default_dp_type="zero3"),
                  [batch()]),
    "tp2_dp2": (4, DENSE, dict(global_tp_deg=2), [batch()]),
    "remat": (4, DENSE, dict(global_tp_deg=2, global_checkpoint=1),
              [batch()]),
    "vtp4_tp2": (4, DENSE, dict(global_tp_deg=2, vocab_tp=4), [batch()]),
    "chunks2": (4, DENSE, dict(global_tp_deg=2, chunks=2), [batch()]),
    "mixed": (4, DENSE, json_mode(plan_file(
        "mixed4", [(4, 1, "ddp"), (2, 2, "zero3")], vocab_tp=2)),
        [batch()]),
    "example_tp2zero3": (4, dict(DENSE, num_hidden_layers=4),
                         json_mode(EXAMPLE), [batch()]),
    "masked_chunks2": (4, DENSE, dict(global_tp_deg=2, sdp=1, chunks=2),
                       [batch(masked=True)]),
    "gpt_packed": (4, GPT, dict(global_tp_deg=2, vocab_tp=2,
                                default_dp_type="zero2"),
                   [batch(packed=True)]),
    "trajectory": (4, DENSE, dict(global_tp_deg=2, default_dp_type="zero3"),
                   [batch(seed=i) for i in range(3)]),
    # JAX's test_mixed_per_layer_strategies, at its world of 8
    "mixed8": (8, DENSE, json_mode(plan_file(
        "mixed8", [(4, 2, "ddp"), (2, 4, "zero3")], vocab_tp=2)),
        [batch()]),
    "tp4_dp2": (8, DENSE, dict(global_tp_deg=4), [batch()]),
}


def _weights(model):
    return init_causal_lm(ModelArgs(**model), seed=0)


def _port_world(rank, world, names):
    from hetu_galvatron_tpu_torch.core.args_schema import (
        CoreArgs,
        TrainArgs,
    )
    from hetu_galvatron_tpu_torch.parallel.spmd import SpmdEngine
    from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH
    from hetu_galvatron_tpu_torch.runtime.checkpoint import (
        spmd_params_from_jax,
        spmd_params_to_jax,
    )
    from hetu_galvatron_tpu_torch.runtime.trainer import to_device

    out = {}
    for name in names:
        _, model, par, batches = CASES[name]
        args = CoreArgs(device="cpu", model=ModelArgs(**model),
                        train=TrainArgs(**TRAIN))
        for k, v in dict(par, global_train_batch_size=8).items():
            setattr(args.parallel, k, v)
        hpc = TH.get_hybrid_parallel_config(args, world)
        eng = SpmdEngine(args.model, hpc, args.train, rank,
                         torch.device("cpu"), compute_dtype=torch.float32)
        # the weight bridge: JAX's tree in, this rank's slices kept
        params = spmd_params_from_jax(params_to_jax(_weights(model)), eng)
        opt = eng.init_opt(params)
        losses = []
        for b in batches:
            _, _, m = eng.train_step(params, opt, to_device(b, "cpu"),
                                     chunks=hpc.chunks)
            losses.append(float(m["loss"]))
        full = spmd_params_to_jax(params, eng)  # every rank gathers
        out[name] = dict(losses=losses, params=_jax_named(full)
                         if rank == 0 else None)
    if world == 4:
        out["dropout"] = _port_dropout(rank)
    return out


@pytest.fixture(scope="module")
def port():
    """Both worlds' results; each world one spawn."""
    res = {}
    for world in (4, 8):
        names = [n for n, c in CASES.items() if c[0] == world]
        ranks = spawn_world(_port_world, world, names, timeout=240)
        res[world] = ranks
    return res


def _jax_args(model, par):
    args = JCoreArgs(model=JModelArgs(**model).model_dump(),
                     train=JTrainArgs(**TRAIN).model_dump())
    for k, v in dict(par, global_train_batch_size=8).items():
        setattr(args.parallel, k, v)
    return args


def _jax_axes(model):
    box = {}

    def init(k):
        p, box["axes"] = JB.init_causal_lm(k, JModelArgs(**model))
        return p

    jax.eval_shape(init, jax.random.key(0))
    return box["axes"]


def jax_spmd(name):
    """JAX's ``make_spmd_train_step`` on ``jax.devices()[:world]``."""
    world, model, par, batches = CASES[name]
    cfg = JModelArgs(**model)
    params = jax.tree.map(jnp.asarray, params_to_jax(_weights(model)))
    axes = _jax_axes(model)
    hpc = JH.get_hybrid_parallel_config(_jax_args(model, par), world)
    mesh = JM.build_mesh(world, 1, devices=jax.devices()[:world])
    tx = jax_opt(JTrainArgs(**TRAIN))
    step, ps, os_, bs = JS.make_spmd_train_step(
        cfg, hpc, mesh, axes, tx, params, compute_dtype=jnp.float32,
        donate=False)
    sp = JS.shard_params(params, ps, mesh)
    opt = jax.jit(tx.init, out_shardings=jax.tree.map(
        lambda s: jax.sharding.NamedSharding(mesh, s), os_,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))(sp)
    losses = []
    for b in batches:
        sp, opt, m = step(sp, opt, jax.device_put(
            jax.tree.map(jnp.asarray, b), bs))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, jax.device_get(sp))


def jax_single(name):
    """JAX's single-device fp32 step (``_reference_step``), step by step."""
    _, model, _, batches = CASES[name]
    cfg = JModelArgs(**model)
    p = jax.tree.map(jnp.asarray, params_to_jax(_weights(model)))
    tx = jax_opt(JTrainArgs(**TRAIN))
    o = tx.init(p)
    losses = []
    for b in batches:
        loss, g = jax.value_and_grad(lambda q: JB.causal_lm_loss(
            q, jax.tree.map(jnp.asarray, b), cfg,
            compute_dtype=jnp.float32))(p)
        u, o = tx.update(g, o, p)
        p = optax.apply_updates(p, u)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, g)


def _adam_reach(steps):
    """The most ``steps`` AdamW steps move an element, in units of lr,
    leaving out the weight decay: at step t the bias-corrected
    ``|m_t| / sqrt(v_t)`` is at most, by Cauchy-Schwarz over the gradient
    history, ``(1 - b1) / (1 - b1^t) * sqrt(sum_j<t (b1^2 / b2)^j)
    * sqrt((1 - b2^t) / (1 - b2))`` (1.001 at t = 3 under 0.9 / 0.95)."""
    b1, b2 = 0.9, 0.95  # TrainArgs.adam_beta1 / adam_beta2
    return sum((1 - b1) / (1 - b1 ** t)
               * np.sqrt(sum((b1 * b1 / b2) ** j for j in range(t)))
               * np.sqrt((1 - b2 ** t) / (1 - b2))
               for t in range(1, steps + 1))


def _jax_named(tree):
    from hetu_galvatron_tpu_torch.runtime.checkpoint import _jax_named

    return dict(_jax_named(tree))


def _check(name, port_res, want_losses, want_params, last_grads, loss_tol,
           rtol, atol):
    got = port_res[0][name]
    steps = len(want_losses)
    assert len(got["losses"]) == steps
    for r in port_res:  # every rank reports the global loss
        assert r[name]["losses"] == got["losses"]
    for a, b in zip(got["losses"], want_losses):
        assert abs(a - b) < loss_tol, (got["losses"], want_losses)
    want = _jax_named(want_params)
    grads = _jax_named(last_grads)
    init = _jax_named(params_to_jax(_weights(CASES[name][1])))
    assert sorted(got["params"]) == sorted(want)
    lr, wd = TRAIN["lr"], TRAIN["weight_decay"]
    n_near = n_all = 0
    for n, t in got["params"].items():
        # a zero gradient (a row no token used) is exact on both sides
        near = (np.abs(grads[n]) < NEAR_EPS) & (grads[n] != 0)
        assert near.mean() < 1e-2, n
        n_near, n_all = n_near + near.sum(), n_all + near.size
        np.testing.assert_allclose(t[~near], want[n][~near], rtol=rtol,
                                   atol=atol, err_msg=n)
        # |p| stays under |p0| + 2 lr a step on the way; 1e-6 is the fp32
        # rounding of weights under 1
        p0 = init[n][near]
        reach = lr * (_adam_reach(steps)
                      + steps * wd * (np.abs(p0) + 2 * lr * steps)) + 1e-6
        for side in (t, want[n]):
            assert np.all(np.abs(side[near] - p0) <= reach), n
    assert n_near < 1e-3 * n_all, (n_near, n_all)


@pytest.mark.parametrize("name", list(CASES))
def test_torch_spmd_step_matches_jax_spmd_and_single_device(name, port):
    world = CASES[name][0]
    traj = name == "trajectory"
    loss_tol = TRAJ_LOSS_TOL if traj else LOSS_TOL
    rtol, atol = (TRAJ_TOL, TRAJ_TOL) if traj else (RTOL, ATOL)
    single_losses, single_params, grads = jax_single(name)
    for losses, params in (jax_spmd(name), (single_losses, single_params)):
        _check(name, port[world], losses, params, grads, loss_tol, rtol,
               atol)


# -- attention dropout under the shard seed ---------------------------------

DB, DS, DN, DK, DD = 4, 16, 4, 2, 16
RATE = 0.25


def _dropout_data():
    rs = np.random.RandomState(5)
    q = rs.randn(DB, DS, DN, DD).astype(np.float32)
    k = rs.randn(DB, DS, DK, DD).astype(np.float32)
    v = rs.randn(DB, DS, DK, DD).astype(np.float32)
    g = rs.randn(DB, DS, DN, DD).astype(np.float32)
    seed = int(JF.seed_from_key(jax.random.key(11))[0])
    return q, k, v, g, seed


def _port_dropout(rank):
    """dp2 x tp2 over a world of 4: each rank's batch rows and heads
    through ``make_flash_sdpa`` (the plain K1-K3 on the CPU)."""
    from hetu_galvatron_tpu_torch.ops.flash_attention import make_flash_sdpa
    from hetu_galvatron_tpu_torch.runtime.mesh import build_mesh

    q, k, v, g, seed = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                        else x for x in _dropout_data())
    mesh = build_mesh(4)
    dp, tp = ("d0",), ("d1",)
    bi, hi = mesh.axis_index(rank, dp), mesh.axis_index(rank, tp)
    rows = slice(bi * DB // 2, (bi + 1) * DB // 2)

    def heads(t, n):
        return t[rows, :, hi * n // 2:(hi + 1) * n // 2].clone()

    ql, kl, vl = heads(q, DN), heads(k, DK), heads(v, DK)
    for t in (ql, kl, vl):
        t.requires_grad_(True)
    sdpa = make_flash_sdpa(mesh, rank, dp, tp)
    o = sdpa(ql, kl, vl, causal=True, dropout_rate=RATE, dropout_seed=seed)
    grads = torch.autograd.grad((o * heads(g, DN)).sum(), (ql, kl, vl))
    return dict(o=o.detach().numpy(), grads=[t.numpy() for t in grads],
                bi=bi, hi=hi)


def test_torch_spmd_flash_dropout_matches_jax_shard_seed(port):
    q, k, v, g, seed = _dropout_data()
    mesh = JM.build_mesh(4, 1, devices=jax.devices()[:4])
    sdpa = JF.make_flash_sdpa(mesh, dp_axes=("d0",), tp_axes=("d1",),
                              interpret=True)
    key = jax.random.key(11)

    def f(q, k, v):
        return sdpa(q, k, v, causal=True, dropout_rate=RATE,
                    dropout_rng=key)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(o)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]
    got = [np.zeros_like(w) for w in want]
    for r in port[4]:
        d = r["dropout"]
        rows = slice(d["bi"] * DB // 2, (d["bi"] + 1) * DB // 2)
        for i, (t, n) in enumerate(zip([d["o"]] + d["grads"],
                                       (DN, DN, DK, DK))):
            got[i][rows, :, d["hi"] * n // 2:(d["hi"] + 1) * n // 2] = t
    # the masks are equal bit for bit, so only summation order is left
    assert int(seed) == seed
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # a shard seed unlike JAX's would drop other pairs: far off
    assert np.abs(want[0]).max() > 0.1
