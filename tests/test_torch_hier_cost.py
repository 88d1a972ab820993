"""The port's hierarchical dp pricing (``core/cost_model/cost.py``:
``hier_dp_reduce_ms``, ``hier_dp_best_bucket``, ``hier_dp_wins``,
``dp_schedule_rankings`` / ``dp_schedule_choice``) against the JAX
package's, exactly: the cases of ``tests/search_engine/test_algo_cost.py``
and ``test_dp_schedule_rankings.py`` computed on both sides and compared
with ``==`` (rankings in their key order), and ``search.hier_dp=1``
searches whose plan JSON equals JAX's byte for byte (the ``hier_dp``,
``hier_bucket_mb``, ``dp_schedule`` and ``dp_schedule_rankings`` keys, the
runner-ups and the search trace included)."""

import glob
import json
import os

import numpy as np
import pytest

from hetu_galvatron_tpu.core import args_schema as JA
from hetu_galvatron_tpu.core.cost_model import cost as JC
from hetu_galvatron_tpu.core.search_engine import engine as JE
from hetu_galvatron_tpu.core.search_engine import strategies as JST
from hetu_galvatron_tpu_torch.core import args_schema as TA
from hetu_galvatron_tpu_torch.core.cost_model import cost as TC
from hetu_galvatron_tpu_torch.core.search_engine import engine as TE
from hetu_galvatron_tpu_torch.core.search_engine import strategies as TST

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
SIDES = {"jax": (JC, JST), "port": (TC, TST)}


def _latency_table(per_mb=0.01):
    table = {mb: per_mb * mb for mb in (1, 2, 4, 8, 16, 32, 64, 128)}
    table["popt"] = np.array([per_mb, 0.0])
    return table


def _coe(v):
    return {"8_1": v, "8_0": v, "4_1": v, "4_0": v, "2_1": v, "2_0": v,
            "1": 0.0, "1_1": 0.0}


def _ctx(C, **kw):
    """test_algo_cost.py's context, built by package ``C``."""
    base = dict(
        parameter_size=48.0, seq_length=128, hidden_size=256, layer_num=4,
        mixed_precision=True, forward_computation_time=0.05,
        comm_coe_dict=_coe(0.01), dp_overlap_coe=1.1, bct_overlap_coe=1.1,
        allgather_latency={n: _latency_table() for n in (2, 4, 8)},
        all2all_latency={n: _latency_table() for n in (2, 4, 8)})
    base.update(kw)
    return C.CostContext(**base)


HIER = {"4_1": {"ring_ici": (0.1, 200.0), "tree_ici": (0.2, 100.0)},
        "2_0": {"ring_dcn": (1.0, 10.0)}, "2_1": {"ring_ici": (0.05, 300.0)},
        "8_1": {"ring_ici": (0.2, 150.0)}}
PIPE = {"4_1": {"ring_ici": (0.01, 5.0)}, "2_0": {"ring_dcn": (0.01, 1.0)},
        "2_1": {"ring_ici": (0.05, 300.0)}, "8_1": {"ring_ici": (0.2, 150.0)}}
SCHED = {"8_1": {"ring_ici": (0.05, 10.0)}, "4_1": {"ring_ici": (0.04, 8.0)},
         "2_0": {"ring_dcn": (0.5, 1.0)}}
CONTEXTS = {
    "hier": dict(hier_dp=True, dcn_slices=2, alpha_beta_algos=HIER),
    "hier_no_dcn_curve": dict(hier_dp=True, dcn_slices=2,
                              alpha_beta_algos={"4_1": HIER["4_1"]}),
    "hier_off": dict(hier_dp=False, alpha_beta_algos=HIER),
    "no_residual_curve": dict(hier_dp=True, dcn_slices=2, alpha_beta_algos={
        k: v for k, v in HIER.items() if k != "2_1"}),
    "pipe_mono": dict(hier_dp=True, dcn_slices=2, alpha_beta_algos=PIPE),
    "pipe_bucket8": dict(hier_dp=True, dcn_slices=2, alpha_beta_algos=PIPE,
                         hier_bucket_mb=8.0),
    "pipe_auto": dict(hier_dp=True, dcn_slices=2, alpha_beta_algos=PIPE,
                      hier_bucket_mb=-1.0),
    "pipe_bucket12_slow_dp": dict(hier_dp=True, dcn_slices=2,
                                  alpha_beta_algos=PIPE,
                                  hier_bucket_mb=12.0,
                                  comm_coe_dict=_coe(0.25)),
    "pipe_mono_slow_dp": dict(hier_dp=True, dcn_slices=2,
                              alpha_beta_algos=PIPE,
                              comm_coe_dict=_coe(0.25)),
    "hier_slow_dp": dict(hier_dp=True, dcn_slices=2, alpha_beta_algos=HIER,
                         comm_coe_dict=_coe(0.4)),
    "flat_slow_dp": dict(comm_coe_dict=_coe(0.4)),
    "pp_absorbs_slices": dict(hier_dp=True, dcn_slices=2, alpha_beta_algos={
        "4_1": {"ring_ici": (0.1, 200.0)}}),
    "sched": dict(hier_dp=True, dcn_slices=1, alpha_beta_algos=SCHED,
                  layer_num=4),
    "sched_two_slices": dict(hier_dp=True, dcn_slices=2,
                             alpha_beta_algos=SCHED),
    "sched_legacy": dict(hier_dp=True, alpha_beta_algos={}),
    "four_slices": dict(hier_dp=True, dcn_slices=4, alpha_beta_algos=dict(
        HIER, **{"4_0": {"ring_dcn": (0.7, 6.0)}})),
}
STRATEGIES = {
    "dp8": dict(pp=1, tp=1, dp=8), "tp2dp4": dict(pp=1, tp=2, dp=4),
    "tp4dp2": dict(pp=1, tp=4, dp=2), "tp8": dict(pp=1, tp=8, dp=1),
    "cp2dp4": dict(pp=1, tp=1, cp=2, dp=4),
    "sp2dp4": dict(pp=1, tp=1, sp=2, dp=4),
    "pp2cp2dp4": dict(pp=2, tp=1, cp=2, dp=4),
    "pp2dp4": dict(pp=2, tp=1, dp=4), "dp4ckpt": dict(pp=1, dp=4,
                                                      checkpoint=True),
}


def _both(fn):
    """``fn(C, ST)`` on both packages: the port's result must equal
    JAX's (the same exception text where JAX raises)."""
    out = {}
    for side, (C, ST) in SIDES.items():
        try:
            out[side] = fn(C, ST)
        except Exception as e:  # noqa: BLE001 — compared below
            out[side] = (type(e).__name__, str(e))
    assert out["port"] == out["jax"], out
    return out["port"]


@pytest.mark.parametrize("ctx", list(CONTEXTS))
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_torch_hier_dp_pricing_matches_jax(ctx, strategy):
    """Every hierarchical entry on every (context, strategy) pair: the
    reduce ms at three payloads, the best bucket, whether the
    hierarchical term wins, the layer cost and its decomposition, and
    the dp-schedule rankings and choice."""
    def run(C, ST):
        s = ST.SearchStrategy(**STRATEGIES[strategy])
        c = _ctx(C, **CONTEXTS[ctx])
        return dict(
            reduce=[C.hier_dp_reduce_ms(s, c, v) for v in (0.0005, 12.0,
                                                           96.0)],
            best=C.hier_dp_best_bucket(s, c, 96.0),
            wins=[C.hier_dp_wins(s, c, 64, k) for k in (1, 4)],
            cost=[C.layer_time_cost(s, c, 64, k) for k in (1, 4)],
            components=C.layer_time_components(s, c, 64, 1),
            ranks=[list(C.dp_schedule_rankings(s, c, v).items())
                   for v in (0.0005, 8.0, 64.0)],
            choice=[C.dp_schedule_choice(s, c, v) for v in (0.0005, 64.0)],
            payload=C.hier_grad_payload_mb(s, c))
    _both(run)


def test_torch_hier_dp_hand_math_and_flips():
    """test_algo_cost.py's pinned numbers, on the port: the monolithic
    and bucketed hand math, the auto sweep's argmin, and the plan flips
    (hierarchical beats tp4xdp2 on slow flat dp; bucketing flips
    ``hier_dp_wins``)."""
    C, ST = TC, TST
    dp8 = ST.SearchStrategy(pp=1, tp=1, dp=8)
    tp4 = ST.SearchStrategy(pp=1, tp=4, dp=2)
    V = 12.0
    assert C.hier_dp_reduce_ms(dp8, _ctx(C, **CONTEXTS["hier"]), V) == \
        pytest.approx((0.1 + V / 200.0) + (1.0 + (V / 4) / 10.0))
    V = 96.0
    t_ici, t_dcn = 0.01 + 8.0 / 5.0, 0.01 + 2.0 / 1.0
    assert C.hier_dp_reduce_ms(dp8, _ctx(C, **CONTEXTS["pipe_bucket8"]),
                               V) == pytest.approx(
        t_ici + t_dcn + 11 * max(t_ici, t_dcn))
    ms, bucket = C.hier_dp_best_bucket(dp8, _ctx(C, **CONTEXTS["pipe_auto"]),
                                       V)
    assert bucket > 0 and ms == C.hier_dp_reduce_ms(
        dp8, _ctx(C, **dict(CONTEXTS["pipe_mono"], hier_bucket_mb=bucket)),
        V)
    assert ms == min(C.hier_dp_reduce_ms(
        dp8, _ctx(C, **dict(CONTEXTS["pipe_mono"], hier_bucket_mb=b)), V)
        for b in C._BUCKET_SWEEP_MB)
    assert not C.hier_dp_wins(dp8, _ctx(C, **CONTEXTS["pipe_mono_slow_dp"]),
                              64, 1)
    assert C.hier_dp_wins(dp8, _ctx(C, **CONTEXTS["pipe_bucket12_slow_dp"]),
                          64, 1)
    flat, hier = (_ctx(C, **CONTEXTS[k]) for k in ("flat_slow_dp",
                                                   "hier_slow_dp"))
    cost = lambda s, c: C.layer_time_cost(s, c, 64, 1)[0]  # noqa: E731
    assert cost(tp4, flat) < cost(dp8, flat)
    assert cost(dp8, hier) < cost(tp4, hier)
    small, _ = C.dp_schedule_choice(dp8, _ctx(C, **CONTEXTS["sched"]),
                                    0.0005)
    bulk, ranks = C.dp_schedule_choice(dp8, _ctx(C, **CONTEXTS["sched"]),
                                       64.0)
    assert small in ("tree_hd", "tree_bcast") and bulk in ("ring", "torus2d")
    assert set(ranks) >= {"ring", "tree_hd", "tree_bcast", "torus2d"}
    assert "hier_rings" in C.dp_schedule_rankings(
        dp8, _ctx(C, **CONTEXTS["sched_two_slices"]), 8.0)
    assert C.dp_schedule_choice(dp8, _ctx(C, **CONTEXTS["sched_legacy"]),
                                8.0) is None


def test_torch_bucket_sweep_replaces_the_context_field():
    """``hier_dp_best_bucket`` sweeps with ``dataclasses.replace``: the
    port's ``CostContext`` is a dataclass with JAX's field names."""
    import dataclasses

    names = lambda C: [f.name for f in dataclasses.fields(  # noqa: E731
        C.CostContext)]
    assert names(TC) == names(JC)
    assert TC._BUCKET_SWEEP_MB == JC._BUCKET_SWEEP_MB


def _algo_bandwidth(tmp):
    """The fixture's bandwidth file with its flat bandwidths cut 20x (a
    slow flat dp ring) and fast per-algorithm ring/tree ici and ring dcn
    fits at every group size, so the hierarchical term wins."""
    with open(os.path.join(
            FIX, "allreduce_bandwidth_1nodes_8gpus_per_node.json")) as f:
        bw = {k: v * 0.05 for k, v in json.load(f).items()}
    for n in (2, 4, 8):
        for c in (0, 1):
            for alg, lvl in (("ring", "ici"), ("tree", "ici"),
                             ("ring", "dcn")):
                key = f"allreduce_size_{n}_consec_{c}_alg_{alg}_lvl_{lvl}"
                bw[f"{key}_alpha_ms"] = 0.002 * n + (alg == "tree") * 0.001
                bw[f"{key}_beta_mb_per_ms"] = (4000.0 + 30 * n
                                               - (lvl == "dcn") * 1000.0)
    path = os.path.join(tmp, "allreduce_algos.json")
    with open(path, "w") as f:
        json.dump(bw, f)
    return path


SEARCHES = {
    "mono": dict(hier_bucket_mb=0.0),
    "bucket8": dict(hier_bucket_mb=8.0),
    "auto": dict(hier_bucket_mb=-1.0),
    "one_node": dict(num_nodes=1, num_devices_per_node=8),
}


@pytest.fixture(scope="module")
def algo_bw(tmp_path_factory):
    return _algo_bandwidth(str(tmp_path_factory.mktemp("bw")))


def _search_both(case, algo_bw, tmp_path):
    """One ``search.hier_dp=1`` search on each side; their outputs must
    be equal. Returns the port's plan."""
    kw = dict(
        num_nodes=2, num_devices_per_node=4, memory_constraint=80,
        settle_bsz=64, settle_chunks=8, fine_grained_mode=0,
        default_dp_type="zero2", pipeline_type="pipedream_flush",
        async_grad_reduce=False, mixed_precision="bf16",
        time_profile_mode="sequence", memory_profile_mode="sequence",
        time_profiling_path=os.path.join(
            FIX, "computation_profiling_bf16_llama2-7b_all.json"),
        memory_profiling_path=os.path.join(
            FIX, "memory_profiling_bf16_llama2-7b_all.json"),
        allreduce_bandwidth_config_path=algo_bw,
        p2p_bandwidth_config_path=os.path.join(
            FIX, "p2p_bandwidth_1nodes_8gpus_per_node.json"),
        overlap_coe_path=os.path.join(FIX, "overlap_coefficient.json"),
        sp_time_path=os.path.join(FIX, "sp_time_1nodes_8gpus_per_node.json"),
        hier_dp=1)
    kw.update(SEARCHES[case])
    got = {}
    for side, (schema, engine) in (("jax", (JA, JE)), ("port", (TA, TE))):
        out = tmp_path / side
        eng = engine.SearchEngine(schema.SearchArgs(
            output_config_path=str(out),
            search_trace_path=str(tmp_path / f"{side}.jsonl"), **kw))
        eng.set_model_info([{"hidden_size": 4096, "seq_len": 8192,
                             "layer_num": 28}], "llama2-7b")
        eng.initialize()
        throughput = eng.optimize()
        (plan,) = glob.glob(os.path.join(str(out), "*.json"))
        trace = [json.loads(line) for line in open(tmp_path /
                                                    f"{side}.jsonl")]
        for rec in trace:
            rec.pop("t", None)
        got[side] = (throughput, os.path.basename(plan), open(plan).read(),
                     trace)
    assert got["port"] == got["jax"]
    plan = json.loads(got["port"][2])
    assert got["port"][0] > 0 and "hier_dp" in plan
    return plan


@pytest.mark.parametrize("case", list(SEARCHES))
def test_torch_hier_dp_search_matches_jax_bytes(case, algo_bw, tmp_path):
    """A ``search.hier_dp=1`` search over the golden fixtures with
    per-algorithm curves: the same throughput, the same plan JSON (its
    hierarchical keys and rankings), the same search trace."""
    _search_both(case, algo_bw, tmp_path)


def test_torch_hier_dp_search_records_the_schedule(algo_bw, tmp_path):
    """The monolithic search picks the hierarchical reduction and records
    its schedule family and rankings, as JAX's does."""
    plan = _search_both("mono", algo_bw, tmp_path)
    assert plan["hier_dp"] == 1 and "hier_bucket_mb" not in plan
    assert plan["dp_schedule"] == min(plan["dp_schedule_rankings"],
                                      key=plan["dp_schedule_rankings"].get)
