"""Port MoE layers (hetu_galvatron_tpu_torch.models.moe) against the JAX ones.

Weights come from the JAX initializers and cross over unchanged; inputs come
from seeded numpy. Everything runs in fp32 on the CPU, so the two sides
differ only by summation order. Tolerances: expert ids and
``tokens_per_expert`` exact; router weights, aux and z losses within 1e-6;
layer outputs within 1e-5; gradients within 1e-5 relative (atol 1e-5 of
the leaf's largest gradient, for entries that cancel to near zero).

Top-k order decides capacity positions (a cumsum over the slots in k order),
so every routing input here is checked to keep a gap of at least 1e-5
between the k-th and the (k+1)-th selection score: a flipped choice then
fails by name, not as noise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.models import modules as JM
from hetu_galvatron_tpu.models import moe as JMoE
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import modules as TM
from hetu_galvatron_tpu_torch.models import moe as TMoE
from hetu_galvatron_tpu_torch.runtime.checkpoint import (
    params_from_jax,
    params_to_jax,
)

MOE = dict(model_type="moe", hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, vocab_size=96,
           max_position_embeddings=64, seq_length=16, hidden_act="swiglu",
           normalization="rmsnorm", position_embedding_type="rope",
           tie_word_embeddings=False, add_bias_linear=False,
           make_vocab_size_divisible_by=1, ffn_hidden_size=48, num_experts=4,
           moe_topk=2, moe_aux_loss_coeff=1e-2, moe_z_loss_coeff=1e-3)
ROUTERS = {
    "topk": {},
    "topk_expert_bias": dict(moe_router_enable_expert_bias=True),
    "topk_no_z": dict(moe_z_loss_coeff=0.0),
    "sinkhorn": dict(moe_router_type="sinkhorn", moe_aux_loss_coeff=0.0),
}
F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
W_TOL = dict(rtol=1e-6, atol=1e-6)


def _cfgs(**kw):
    return JModelArgs(**{**MOE, **kw}), ModelArgs(**{**MOE, **kw})


def _moe_params(jcfg, seed=0, bias=None):
    """JAX init_moe_mlp params as numpy (and a non-zero expert bias when
    given), with the port's copy."""
    p, _ = JMoE.init_moe_mlp(jax.random.key(seed), jcfg)
    npy = jax.tree.map(np.asarray, p)
    if bias is not None:
        npy["expert_bias"] = np.asarray(bias, np.float32)
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), npy)
    return npy, tp


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _assert_gap(scores, k, where=""):
    """The k-th and (k+1)-th largest score of every row differ by 1e-5."""
    s = -np.sort(-np.asarray(scores, np.float64), axis=-1)
    gap = float((s[:, k - 1] - s[:, k]).min())
    assert gap >= 1e-5, f"{where}: top-{k} gap {gap:.2e} < 1e-5"


def _select_scores(npy, xt, jcfg):
    logits = xt @ npy["router"]
    if jcfg.moe_router_type == "sinkhorn":
        return np.asarray(JMoE.sinkhorn(jnp.asarray(logits)))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    return probs + npy.get("expert_bias", 0.0)


def test_torch_is_moe_layer_capacity_and_sinkhorn_match_jax():
    for freq in (1, 2, 3):
        jcfg, tcfg = _cfgs(moe_layer_freq=freq, num_hidden_layers=6)
        assert [TMoE.is_moe_layer(tcfg, i) for i in range(6)] == \
            [JMoE.is_moe_layer(jcfg, i) for i in range(6)]
    dense_j, dense_t = _cfgs(num_experts=0)
    assert not TMoE.is_moe_layer(dense_t, 0) and not JMoE.is_moe_layer(
        dense_j, 0)
    jcfg, tcfg = _cfgs()
    for tokens in (1, 7, 32, 8192):
        for cf in (None, 0.25, 1.0, 4.0):
            assert TMoE.moe_capacity(tcfg, tokens, cf) == \
                JMoE.moe_capacity(jcfg, tokens, cf)
    logits = _x((24, 4), seed=3, scale=2.0)
    np.testing.assert_allclose(
        TMoE.sinkhorn(torch.from_numpy(logits)).numpy(),
        np.asarray(JMoE.sinkhorn(jnp.asarray(logits))), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_torch_route_tokens_matches_jax(router):
    jcfg, tcfg = _cfgs(**ROUTERS[router])
    bias = ([0.03, -0.02, 0.0, 0.01]
            if jcfg.moe_router_enable_expert_bias else None)
    npy, tp = _moe_params(jcfg, seed=2, bias=bias)
    xt = _x((48, 32), seed=4, scale=4.0)
    _assert_gap(_select_scores(npy, xt, jcfg), jcfg.moe_topk, router)
    jidx, jw, jaux, jst = jax.jit(lambda p, x: JMoE.route_tokens(
        p, x, jcfg, **F32))(jax.tree.map(jnp.asarray, npy), jnp.asarray(xt))
    tidx, tw, taux, tst = TMoE.route_tokens(tp, torch.from_numpy(xt), tcfg,
                                            **T32)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), **W_TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **W_TOL)
    assert tst.keys() == jst.keys()
    np.testing.assert_array_equal(tst["tokens_per_expert"].numpy(),
                                  np.asarray(jst["tokens_per_expert"]))
    for key in ("load_balance_loss", "z_loss"):
        np.testing.assert_allclose(float(tst[key]), float(jst[key]),
                                   **W_TOL, err_msg=key)
    if jcfg.moe_router_enable_expert_bias:
        # the bias term is 0 in value, minus the balancing update in
        # gradient: d aux / d bias = -rate * sign(mean - count)
        (g,) = torch.autograd.grad(taux, tp["expert_bias"])
        jg = jax.jit(jax.grad(lambda b: JMoE.route_tokens(
            {**jax.tree.map(jnp.asarray, npy), "expert_bias": b},
            jnp.asarray(xt), jcfg, **F32)[2]))(jnp.asarray(npy["expert_bias"]))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        tpe = tst["tokens_per_expert"]
        want = -TMoE.update_expert_bias(torch.zeros(4), tpe,
                                        tcfg.moe_expert_bias_update_rate)
        torch.testing.assert_close(g, want, rtol=0, atol=0)


def _routed(npy, tp, jcfg, tcfg, xt):
    jp = jax.tree.map(jnp.asarray, npy)
    jidx, jw, _, _ = jax.jit(lambda p, x: JMoE.route_tokens(
        p, x, jcfg, **F32))(jp, jnp.asarray(xt))
    tidx, tw, _, _ = TMoE.route_tokens(tp, torch.from_numpy(xt), tcfg, **T32)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    return jp, (jidx, jw), (tidx, tw)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_torch_capacity_dispatch_matches_jax(capacity_factor):
    """At 0.25 most slots overflow: dropped slots give zero rows or weight
    renormalised over a token's survivors, as in JAX."""
    jcfg, tcfg = _cfgs()
    npy, tp = _moe_params(jcfg, seed=5)
    xt = _x((64, 32), seed=6, scale=4.0)
    _assert_gap(_select_scores(npy, xt, jcfg), 2)
    jp, (jidx, jw), (tidx, tw) = _routed(npy, tp, jcfg, tcfg, xt)
    want = jax.jit(lambda p, x, i, w: JMoE._capacity_dispatch(
        p, x, i, w, jcfg, jnp.float32, capacity_factor))(
        jp, jnp.asarray(xt), jidx, jw)
    got = TMoE._capacity_dispatch(tp, torch.from_numpy(xt), tidx, tw, tcfg,
                                  torch.float32, capacity_factor)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    C = TMoE.moe_capacity(tcfg, 64, capacity_factor)
    counts = np.bincount(tidx.numpy().ravel(), minlength=4)
    dropped = np.maximum(counts - C, 0).sum()
    assert (dropped > 0) == (capacity_factor < 1.0)
    if dropped:
        # a token whose slots all dropped gets a zero row
        assert np.any(np.all(got.detach().numpy() == 0.0, axis=-1))


def test_torch_dropless_dispatch_matches_jax_and_uncapped_capacity():
    jcfg, tcfg = _cfgs(moe_dispatcher="dropless")
    npy, tp = _moe_params(jcfg, seed=7)
    xt = _x((40, 32), seed=8, scale=4.0)
    _assert_gap(_select_scores(npy, xt, jcfg), 2)
    jp, (jidx, jw), (tidx, tw) = _routed(npy, tp, jcfg, tcfg, xt)
    want = jax.jit(lambda p, x, i, w: JMoE._dropless_dispatch(
        p, x, i, w, jcfg, jnp.float32))(jp, jnp.asarray(xt), jidx, jw)
    got = TMoE._dropless_dispatch(tp, torch.from_numpy(xt), tidx, tw, tcfg,
                                  torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    # a capacity large enough to drop nothing computes the same function
    uncapped = TMoE._capacity_dispatch(tp, torch.from_numpy(xt), tidx, tw,
                                       tcfg, torch.float32, 4.0)
    np.testing.assert_allclose(uncapped.detach().numpy(),
                               got.detach().numpy(), **OUT_TOL)


@pytest.mark.parametrize("k", [3, 4])
def test_torch_dropless_dispatch_top3_matches_jax_scatter_add(k):
    """Dropless at top-k > 2 (6 experts): each token row sums its k
    weighted expert outputs, the port with ``index_add`` and JAX with a
    scatter-add, in orders that may differ. Only the order of k fp32 adds
    separates them, so every element agrees within a few ULP of the row's
    largest addend: |got - want| <= 4e-7 x max |want| (fp32's epsilon is
    1.2e-7; the observed worst is 1.6e-7 x max |want|)."""
    jcfg, tcfg = _cfgs(moe_dispatcher="dropless", num_experts=6, moe_topk=k)
    npy, tp = _moe_params(jcfg, seed=11)
    xt = _x((48, 32), seed=12, scale=4.0)
    _assert_gap(_select_scores(npy, xt, jcfg), k)
    jp, (jidx, jw), (tidx, tw) = _routed(npy, tp, jcfg, tcfg, xt)
    assert tidx.shape == (48, k)
    want = np.asarray(jax.jit(lambda p, x, i, w: JMoE._dropless_dispatch(
        p, x, i, w, jcfg, jnp.float32))(jp, jnp.asarray(xt), jidx, jw))
    got = TMoE._dropless_dispatch(tp, torch.from_numpy(xt), tidx, tw, tcfg,
                                  torch.float32).detach().numpy()
    limit = 4e-7 * np.abs(want).max()
    assert np.abs(got - want).max() <= limit


@pytest.mark.parametrize("dispatcher", ["capacity", "dropless"])
def test_torch_moe_mlp_with_shared_experts_matches_jax(dispatcher):
    jcfg, tcfg = _cfgs(num_shared_experts=1, moe_dispatcher=dispatcher,
                       add_bias_linear=True)
    npy, tp = _moe_params(jcfg, seed=9)
    assert set(npy["shared"]) == {"win", "bin", "wout", "bout"}
    x = _x((2, 16, 32), seed=10, scale=4.0)
    _assert_gap(_select_scores(npy, x.reshape(32, 32), jcfg), 2)
    jy, jaux, jst = jax.jit(lambda p, x_: JMoE.apply_moe_mlp(
        p, x_, jcfg, **F32))(jax.tree.map(jnp.asarray, npy), jnp.asarray(x))
    ty, taux, tst = TMoE.apply_moe_mlp(tp, torch.from_numpy(x), tcfg, **T32)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **OUT_TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **W_TOL)
    np.testing.assert_array_equal(tst["tokens_per_expert"].numpy(),
                                  np.asarray(jst["tokens_per_expert"]))


def _grad_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


def test_torch_moe_decoder_layer_with_segments_and_remat_matches_jax():
    """One MoE block over packed documents, rematerialised on both sides:
    outputs, aux loss, and the gradients of router, experts, attention and
    norms against jax.grad."""
    jcfg, tcfg = _cfgs()
    jparams, _ = JB.init_causal_lm(jax.random.key(11), jcfg)
    npy = jax.tree.map(np.asarray, jparams)["layers"][0]
    npy["ln1"]["scale"] = 1.0 + _x((32,), seed=12, scale=0.1)
    tp = params_from_jax({"embed": {}, "layers": [npy], "prenorm": {},
                          "head": {}})["layers"][0]
    x = _x((2, 16, 32), seed=13)
    seg = np.repeat(np.array([[0, 0, 1, 2], [0, 1, 1, 1]], np.int32), 4,
                    axis=1)
    dy = _x((2, 16, 32), seed=14)
    rope = JM.rope_cos_sin(16, jcfg.head_dim, jcfg.rope_theta)
    h = jnp.asarray(x) + JM.apply_attention(
        npy["attn"], JM.apply_norm(npy["ln1"], jnp.asarray(x), jcfg), jcfg,
        rope=rope, segment_ids=jnp.asarray(seg), **F32)
    h = np.asarray(JM.apply_norm(npy["ln2"], h, jcfg)).reshape(32, 32)
    _assert_gap(_select_scores(npy["moe"], h, jcfg), 2)

    def jloss(p):
        fn = JM.remat(lambda p_, h: JMoE.apply_moe_decoder_layer(
            p_, h, jcfg, rope=rope, segment_ids=jnp.asarray(seg), **F32),
            jcfg)
        y, aux, _ = fn(p, jnp.asarray(x))
        return jnp.sum(y * dy) + aux, y

    (jl, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, npy))
    fn = TM.remat(lambda p_, h: TMoE.apply_moe_decoder_layer(
        p_, h, tcfg, rope=TM.rope_cos_sin(16, tcfg.head_dim, tcfg.rope_theta),
        segment_ids=torch.from_numpy(seg), **T32), tcfg)
    ty, taux, tst = fn(tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **OUT_TOL)
    tl = (ty * torch.from_numpy(dy)).sum() + taux
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert not tst["tokens_per_expert"].requires_grad
    names = [n for n, _ in TB.named_leaves(tp)]
    tg = torch.autograd.grad(tl, [t for _, t in TB.named_leaves(tp)])
    jflat = dict(TB.named_leaves(params_from_jax(
        {"embed": {}, "layers": [jax.tree.map(np.asarray, jg)],
         "prenorm": {}, "head": {}})["layers"][0]))
    assert {"moe.router", "moe.win", "moe.wout", "attn.wqkv", "attn.wo",
            "ln1.scale", "ln2.scale"} <= set(names)
    for name, g in zip(names, tg):
        _grad_close(g.numpy(), jflat[name].detach().numpy(), name)


def test_torch_causal_lm_loss_moe_stack_matches_jax():
    """A 4-layer stack with moe_layer_freq=2 (dense, MoE, dense, MoE):
    loss (CE + aux), every gradient and the per-layer stats."""
    jcfg, tcfg = _cfgs(num_hidden_layers=4, moe_layer_freq=2)
    jparams, _ = JB.init_causal_lm(jax.random.key(15), jcfg)
    npy = jax.tree.map(np.asarray, jparams)
    assert ["moe" in lp for lp in npy["layers"]] == [False, True, False, True]
    tp = params_from_jax(npy)
    tokens = np.random.default_rng(16).integers(0, 96, (2, 17)).astype(
        np.int32)
    jb = {"tokens": jnp.asarray(tokens[:, :-1]),
          "labels": jnp.asarray(tokens[:, 1:])}
    tb = {"tokens": torch.from_numpy(tokens[:, :-1]).long(),
          "labels": torch.from_numpy(tokens[:, 1:]).long()}
    (jl, jst), jg = jax.jit(jax.value_and_grad(
        lambda p: JB.causal_lm_loss(p, jb, jcfg, with_moe_stats=True, **F32),
        has_aux=True))(jax.tree.map(jnp.asarray, npy))
    tl, tst = TB.causal_lm_loss(tp, tb, tcfg, with_moe_stats=True, **T32)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert sorted(tst) == sorted(jst) == ["layer1", "layer3"]
    for layer in tst:
        np.testing.assert_array_equal(
            tst[layer]["tokens_per_expert"].numpy(),
            np.asarray(jst[layer]["tokens_per_expert"]))
        for key in ("load_balance_loss", "z_loss"):
            np.testing.assert_allclose(float(tst[layer][key]),
                                       float(jst[layer][key]), **W_TOL)
    # the aux losses are part of the loss: CE alone is lower
    logits = TB.forward_causal_lm(tp, tb["tokens"], tcfg, **T32)
    ce = TM.cross_entropy_loss(logits, tb["labels"])
    aux = sum(float(tst[k]["load_balance_loss"] + tst[k]["z_loss"])
              for k in tst)
    np.testing.assert_allclose(float(tl.detach()) - float(ce.detach()), aux,
                               rtol=1e-5)
    names = [n for n, _ in TB.named_leaves(tp)]
    tg = torch.autograd.grad(tl, [t for _, t in TB.named_leaves(tp)])
    jflat = dict(TB.named_leaves(params_from_jax(
        jax.tree.map(np.asarray, jg))))
    for name, g in zip(names, tg):
        _grad_close(g.numpy(), jflat[name].detach().numpy(), name)


def test_torch_moe_init_has_the_jax_layout():
    """Same tree, shapes and scales as the JAX init (another generator):
    expert wout at the residual std 0.02 / sqrt(2L)."""
    jcfg, tcfg = _cfgs(num_shared_experts=2, moe_ffn_hidden_size=40,
                       moe_router_enable_expert_bias=True,
                       num_hidden_layers=8)
    jparams = jax.eval_shape(lambda: JB.init_causal_lm(jax.random.key(0),
                                                       jcfg)[0])
    tp = TB.init_causal_lm(dataclasses.replace(tcfg), seed=0)
    want = dict(TB.named_leaves(jax.tree.map(
        lambda s: torch.empty(s.shape), jparams)))
    got = dict(TB.named_leaves(tp))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.shape == want[name].shape and t.requires_grad, name
    moe = tp["layers"][0]["moe"]
    assert moe["win"].shape == (4, 32, 80) and moe["wout"].shape == (4, 40, 32)
    assert torch.equal(moe["expert_bias"], torch.zeros(4))
    assert abs(float(moe["wout"].detach().std()) - 0.02 / 4) < 0.002 / 4
    assert abs(float(moe["win"].detach().std()) - 0.02) < 0.002


def test_torch_weight_bridge_round_trips_a_moe_tree():
    jcfg, _ = _cfgs(num_shared_experts=1, moe_router_enable_expert_bias=True,
                    add_bias_linear=True, moe_layer_freq=2)
    jparams, _ = JB.init_causal_lm(jax.random.key(17), jcfg)
    npy = jax.tree.map(np.asarray, jparams)
    npy["layers"][1]["moe"]["expert_bias"] = _x((4,), seed=18)
    tp = params_from_jax(npy)
    assert set(tp["layers"][1]["moe"]) == {"router", "win", "wout", "shared",
                                           "expert_bias"}
    assert "mlp" in tp["layers"][0]
    back = params_to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(npy)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(npy)):
        np.testing.assert_array_equal(a, b)
    bad = jax.tree.map(lambda a: a, npy)
    bad["layers"][1]["moe"]["gate_bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="outside this slice"):
        params_from_jax(bad)


def test_torch_iteration_log_moe_tracker_matches_jax(capsys):
    """The per-layer balance text of the iteration log equals JAX's."""
    from hetu_galvatron_tpu.core.args_schema import CoreArgs as JCoreArgs
    from hetu_galvatron_tpu.core.profiler.runtime_profiler import (
        RuntimeProfiler as JProfiler,
    )
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.core.profiler.runtime_profiler import (
        RuntimeProfiler as TProfiler,
    )

    stats = {f"layer{i}": {"load_balance_loss": 0.01 + 0.003 * i,
                           "z_loss": 1e-4 * i,
                           "tokens_per_expert": [10.0 + i, 30.0, 20.0, 4.0]}
             for i in (1, 3, 10)}
    metrics = dict(loss=2.5, grad_norm=0.75)
    jline = JProfiler(JCoreArgs(), rank=0).iteration_log(
        3, {**metrics, "moe": {k: {n: jnp.asarray(v) for n, v in st.items()}
                               for k, st in stats.items()}}, lr=1e-4)
    tline = TProfiler(load_config(None, ["device=cpu"]), "cpu").iteration_log(
        3, {**metrics, "moe": {k: {n: torch.tensor(v) for n, v in st.items()}
                               for k, st in stats.items()}}, lr=1e-4)
    assert tline == jline
    assert "moe[layer10] aux 4.000e-02 z 1.000e-03 imb 1.62" in tline
    capsys.readouterr()
