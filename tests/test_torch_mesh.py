"""The port's rank grid and per-layer lowering (``runtime/mesh.py``,
``parallel/spmd.py``'s spec trees) against JAX's ``runtime/mesh.py`` and
``parallel/spmd.py``: host arithmetic, held exactly. Every strategy of
JAX's ``tests/core/test_parallel_spmd.py::STRATEGIES`` and both example
plans, at JAX's world of 8: the axis tuples of every layer, each leaf's
param and optimizer specs, the activation and batch specs, the rank
coordinates and groups."""

import os
import types

import numpy as np
import pytest

import jax

from hetu_galvatron_tpu.core.args_schema import CoreArgs as JCoreArgs
from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.parallel import spmd as JS
from hetu_galvatron_tpu.runtime import hybrid_config as JH
from hetu_galvatron_tpu.runtime import mesh as JM
from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, ModelArgs
from hetu_galvatron_tpu_torch.models.builder import causal_lm_axes
from hetu_galvatron_tpu_torch.parallel import spmd as TS
from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH
from hetu_galvatron_tpu_torch.runtime import mesh as TM
from hetu_galvatron_tpu_torch.utils import strategy as TU

MODEL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=64, seq_length=16,
             hidden_act="swiglu", normalization="rmsnorm",
             position_embedding_type="rope", tie_word_embeddings=False,
             add_bias_linear=False, add_qkv_bias=False,
             make_vocab_size_divisible_by=1, ffn_hidden_size=128)
# GPT-2's leaves: biases, layernorm, learned positions, a tied head
GPT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=64, seq_length=16,
           make_vocab_size_divisible_by=1)
# JAX's tests/core/test_parallel_spmd.py::STRATEGIES, as they are there
STRATEGIES = [
    dict(global_tp_deg=8, global_train_batch_size=8),
    dict(default_dp_type="ddp", global_train_batch_size=8),
    dict(sdp=1, global_train_batch_size=8),
    dict(default_dp_type="zero2", global_train_batch_size=8),
    dict(global_tp_deg=2, default_dp_type="zero3",
         global_train_batch_size=8),
    dict(global_tp_deg=4, global_train_batch_size=8),
    dict(global_tp_deg=4, use_ulysses=True, global_train_batch_size=8),
    dict(global_cp_deg=2, global_train_batch_size=8),
    dict(global_tp_deg=2, global_checkpoint=1, global_train_batch_size=8),
    dict(global_tp_deg=2, vocab_tp=4, global_train_batch_size=8),
    dict(global_tp_deg=2, chunks=2, global_train_batch_size=8),
]
# strategies whose plans the port's runtime runs (the rest: item 11)
RUNS = [i for i, s in enumerate(STRATEGIES)
        if "use_ulysses" not in s and "global_cp_deg" not in s]
PLANS = os.path.join(os.path.dirname(__file__), "..",
                     "hetu_galvatron_tpu_torch", "profiles", "example_plans")
EXAMPLES = ["galvatron_config_spmd_tp2zero3.json",
            "galvatron_config_acceptance_tp2dp2pp2.json"]


def sid(d):
    return ",".join(f"{k}={v}" for k, v in d.items()
                    if k != "global_train_batch_size")


def norm(spec):
    """A JAX PartitionSpec (or the port's) as a tuple of None / tuples."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def jax_axes(model):
    box = {}

    def init(k):
        params, box["axes"] = JB.init_causal_lm(k, JModelArgs(**model))
        return params

    jax.eval_shape(init, jax.random.key(0))
    return box["axes"]


def jax_plan(pkw=None, plan=None, world=8, model=MODEL):
    args = JCoreArgs(model=JModelArgs(**model).model_dump())
    if plan:
        args.parallel.config_mode = "json"
        args.parallel.galvatron_config_path = os.path.join(PLANS, plan)
    for k, v in (pkw or {}).items():
        setattr(args.parallel, k, v)
    hpc = JH.get_hybrid_parallel_config(args, world)
    mesh = JM.build_mesh(world, hpc.pp_deg, devices=jax.devices()[:world])
    return hpc, mesh


def port_hpc(jhpc):
    """JAX's resolved plan in the port's types (the port's runtime refuses
    cp and Ulysses plans before lowering; the lowering itself is host
    arithmetic for every plan)."""
    layers = [TU.LayerStrategy(**{f: getattr(s, f) for f in (
        "pp_deg", "tp_size", "dp_size", "cp_size", "sp", "tp_consecutive",
        "checkpoint", "ep_size", "etp_size")},
        dp_type=TU.DPType(int(s.dp_type))) for s in jhpc.layers]
    v = jhpc.vocab
    return types.SimpleNamespace(
        layers=layers, default_dp_type=jhpc.default_dp_type.short,
        vocab=TU.EmbeddingLMHeadStrategy(v.vtp, v.vsp, v.vcp, v.embed_sdp))


def shardings_equal(jsh, tsh):
    for f in ("dp_axes", "cp_axes", "tp_axes", "ep_axes", "etp_axes"):
        assert tuple(getattr(jsh, f)) == getattr(tsh, f), f
    assert (jsh.ulysses, int(jsh.dp_type), jsh.checkpoint) == \
        (tsh.ulysses, int(tsh.dp_type), tsh.checkpoint)
    assert norm(jsh.act_spec()) == norm(tsh.act_spec())
    assert norm(jsh.batch_spec()) == norm(tsh.batch_spec())


def spec_leaves(tree, jax_side):
    if jax_side:
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return {jax.tree_util.keystr(p, simple=True, separator="."): norm(s)
                for p, s in flat[0]}
    return {n: norm(s) for n, s in TS.named_axes(tree)}


def check_specs(jhpc, jmesh, model):
    world = jmesh.size
    tmesh = TM.build_mesh(world, jhpc.pp_deg)
    jl, jv = JS.layer_shardings(jhpc, jmesh)
    tl, tv = TS.layer_shardings(port_hpc(jhpc), tmesh)
    for a, b in zip(jl + [jv], tl + [tv]):
        shardings_equal(a, b)
    axes = jax_axes(model)
    for opt in (False, True):
        want = spec_leaves(JS.param_specs(axes, jl, jv, opt=opt), True)
        got = spec_leaves(TS.param_specs(causal_lm_axes(ModelArgs(**model)),
                                         tl, tv, opt=opt), False)
        assert got == want


@pytest.mark.parametrize("pkw", STRATEGIES, ids=sid)
def test_torch_mesh_specs_match_jax_for_every_strategy(pkw):
    jhpc, jmesh = jax_plan(pkw)
    check_specs(jhpc, jmesh, MODEL)


@pytest.mark.parametrize("plan", EXAMPLES)
def test_torch_mesh_specs_match_jax_for_the_example_plans(plan):
    for model in (MODEL, GPT):  # the plans' four layers
        model = dict(model, num_hidden_layers=4)
        jhpc, jmesh = jax_plan(plan=plan, model=model)
        check_specs(jhpc, jmesh, model)


@pytest.mark.parametrize("i", RUNS, ids=lambda i: sid(STRATEGIES[i]))
def test_torch_global_mode_lowers_the_strategies_as_jax(i):
    """GLOBAL mode gives JAX's per-layer strategies and vocab strategy."""
    pkw = STRATEGIES[i]
    jhpc, _ = jax_plan(pkw)
    args = CoreArgs(device="cpu", model=ModelArgs(**MODEL))
    for k, v in pkw.items():
        setattr(args.parallel, k, v)
    hpc = TH.get_hybrid_parallel_config(args, 8)
    assert [s.key() for s in hpc.layers] == [s.key() for s in jhpc.layers]
    assert hpc.vocab.key() == jhpc.vocab.key()
    assert hpc.default_dp_type == jhpc.default_dp_type.short
    assert hpc.chunks == jhpc.chunks


@pytest.mark.parametrize("model", [MODEL, GPT], ids=["swiglu", "gpt"])
def test_torch_logical_axes_match_jax(model):
    want = {jax.tree_util.keystr(p, simple=True, separator="."): a
            for p, a in jax.tree_util.tree_flatten_with_path(
                jax_axes(model), is_leaf=lambda x: isinstance(x, tuple)
                and all(isinstance(s, str) for s in x))[0]}
    got = dict(TS.named_axes(causal_lm_axes(ModelArgs(**model))))
    assert got == want


@pytest.mark.parametrize("world,pp", [(8, 1), (4, 1), (2, 1), (8, 2)])
def test_torch_rank_grid_matches_jax_device_array(world, pp):
    """Rank r's coordinates are device r's place in JAX's array; a group
    over some axes is the ranks that differ only there, in JAX's order."""
    devs = jax.devices()[:world]
    jarr = JM.device_array(world, pp, devices=devs)
    mesh = TM.build_mesh(world, pp)
    jmesh = JM.build_mesh(world, pp, devices=devs)
    assert mesh.axis_names == jmesh.axis_names
    assert mesh.shape == dict(jmesh.shape)
    ids = np.vectorize(lambda d: devs.index(d))(jarr)
    assert np.array_equal(mesh.ranks, ids)
    axes = TM.stage_axes(mesh)
    for r in range(world):
        c = mesh.coords(r)
        assert tuple(c[n] for n in mesh.axis_names) == tuple(
            int(x) for x in np.argwhere(ids == r)[0])
        for k in range(len(axes) + 1):
            for sub in (axes[:k], axes[k:]):
                ranks = mesh.group_ranks(r, sub)
                assert len(ranks) == TM.axes_size(mesh, sub)
                assert [mesh.axis_index(q, sub) for q in ranks] == list(
                    range(len(ranks)))
                assert list(ranks) == sorted(ranks)


def test_torch_lowering_refuses_what_jax_refuses():
    mesh = TM.build_mesh(8)
    with pytest.raises(ValueError, match="!= stage world"):
        TM.lower_strategy(TU.LayerStrategy(tp_size=2, dp_size=2), mesh)
    with pytest.raises(ValueError, match="not a positive power of two"):
        TM.build_mesh(6)
    sh = TM.lower_strategy(
        TU.LayerStrategy(tp_size=4, dp_size=2, tp_consecutive=False), mesh)
    assert (sh.tp_axes, sh.dp_axes) == (("d0", "d1"), ("d2",))


def test_torch_shard_params_refuses_an_uneven_split():
    """Every dim a leaf's param or moment spec splits must divide evenly
    (a ZeRO dim of 6 over 4 ranks would drop or pad rows)."""
    import torch

    mesh = TM.build_mesh(4)
    plan = TS.LeafPlan("embed.wte", ("vocab", "embed"), TM.P(None, None),
                       TM.P(None, ("d0", "d1")), None, ("d0", "d1"))
    with pytest.raises(ValueError, match="does not split evenly"):
        TS.shard_params({"embed": {"wte": torch.zeros(8, 6)}}, [plan], mesh,
                        0)
    ok = TS.shard_params({"embed": {"wte": torch.zeros(8, 8)}}, [plan],
                         mesh, 0)
    assert tuple(ok["embed"]["wte"].shape) == (8, 8)
