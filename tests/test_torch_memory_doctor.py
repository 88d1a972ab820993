"""The port's memory doctor (``analysis/memory_doctor.py``) against the JAX
package's, exactly: every stage component, the peak and the rendered
report of both example plans at several worlds, engine conventions and
precisions, serving mode included; the malformed-plan corpus of
``tests/analysis/test_memory_doctor.py``; the cost-model cross-check at
ratio 1.0; both sides of the budget boundary with the search's predicate
equal to the check's; the search engine's ``_hbm_gate`` on one task; the
KV-pool component against the pool tensors the port allocates; and
``search.hbm_budget_gb > 0`` searches whose plan JSON equals JAX's byte
for byte."""

import contextlib
import dataclasses
import glob
import io
import json
import os

import pytest

from hetu_galvatron_tpu.analysis import memory_doctor as JM
from hetu_galvatron_tpu.core import args_schema as JA
from hetu_galvatron_tpu.core.search_engine import engine as JE
from hetu_galvatron_tpu.core.search_engine import strategies as JST
from hetu_galvatron_tpu_torch.analysis import memory_doctor as TM
from hetu_galvatron_tpu_torch.core import args_schema as TA
from hetu_galvatron_tpu_torch.core.search_engine import engine as TE
from hetu_galvatron_tpu_torch.core.search_engine import strategies as TST
from hetu_galvatron_tpu_torch.observability import telemetry as TT
from hetu_galvatron_tpu_torch.utils import strategy as TU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PLANS = os.path.join(ROOT, "hetu_galvatron_tpu_torch", "profiles",
                          "example_plans")
JAX_PLANS = os.path.join(ROOT, "hetu_galvatron_tpu", "profiles",
                         "example_plans")
PLANS = sorted(glob.glob(os.path.join(PORT_PLANS, "*.json")))
ACCEPTANCE = os.path.join(PORT_PLANS,
                          "galvatron_config_acceptance_tp2dp2pp2.json")
SIDES = {"jax": (JM, JA), "port": (TM, TA)}
TINY = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            vocab_size=256, seq_length=16, max_position_embeddings=32,
            hidden_act="swiglu", normalization="rmsnorm",
            position_embedding_type="rope", tie_word_embeddings=False,
            add_bias_linear=False, add_qkv_bias=False,
            make_vocab_size_divisible_by=1, ffn_hidden_size=128)
MODELS = {
    "tiny": TINY,
    "gqa_learned_gelu": dict(TINY, num_key_value_heads=2, hidden_act="gelu",
                             normalization="layernorm",
                             position_embedding_type="learned"),
}


def model(side, name="tiny", **kw):
    return SIDES[side][1].ModelArgs(**dict(MODELS[name], **kw))


def good_plan(**kw):
    plan = {
        "pp_deg": 2, "tp_sizes_enc": "2,2,2,2",
        "tp_consecutive_flags": "1,1,1,1", "dp_types_enc": "0,0,0,0",
        "use_sp": "0,0,0,0", "cp_sizes_enc": "1,1,1,1",
        "checkpoint": "0,0,0,0", "global_bsz": 4, "chunks": 2,
        "pp_division": "2,2", "pipeline_type": "pipedream_flush",
        "default_dp_type": "ddp", "vtp": 2, "vsp": 0, "embed_sdp": 0,
    }
    plan.update(kw)
    return plan


def report(side, plan, world, name="tiny", **kw):
    rep = SIDES[side][0].diagnose_memory(plan, model(side, name), world,
                                         **kw)
    text = io.StringIO()
    rep.render(text)
    return dict(ok=rep.ok, errors=rep.errors, warnings=rep.warnings,
                notes=rep.notes, ratios=rep.ratios, peak=rep.peak_mb,
                stages=[(s.stage, s.components) for s in rep.stages],
                text=text.getvalue().replace(JAX_PLANS, PORT_PLANS))


def both(plan, world, **kw):
    """The port's report equals JAX's (the plan's path aside)."""
    jplan = plan.replace(PORT_PLANS, JAX_PLANS) if isinstance(plan, str) \
        else plan
    theirs = report("jax", jplan, world, **kw)
    ours = report("port", plan, world, **kw)
    assert ours == theirs
    return ours


def test_torch_example_plans_are_jax_bytes():
    names = sorted(os.path.basename(p) for p in PLANS)
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(JAX_PLANS, "*.json"))) and names
    for p in PLANS:
        assert open(p, "rb").read() == open(os.path.join(
            JAX_PLANS, os.path.basename(p)), "rb").read()


SERVING = dict(max_batch_size=2, kv_block_size=8, max_seq_len=32,
               num_kv_blocks=10, prefix_cache=True, spec_decode=True,
               spec_k=2)
CASES = [(os.path.basename(p), w, impl, mp, mname, srv)
         for p in PLANS for w in (8, 16, None)
         for impl in ("compiled", "host") for mp in (True, False)
         for mname in MODELS for srv in (False, True)]


@pytest.mark.parametrize("plan,world,impl,mp,mname,srv", CASES)
def test_torch_example_plan_components_match_jax(plan, world, impl, mp,
                                                 mname, srv):
    kw = dict(schedule_impl=impl, mixed_precision=mp, name=mname)
    if srv:
        jserv = JA.ServingArgs(**SERVING)
        tserv = TA.ServingArgs(**SERVING)
        theirs = report("jax", os.path.join(JAX_PLANS, plan), world,
                        serving=jserv, **kw)
        ours = report("port", os.path.join(PORT_PLANS, plan), world,
                      serving=tserv, **kw)
        assert ours == theirs
        assert all(c["kv_pool_mb"] > 0 for _, c in ours["stages"])
    else:
        ours = both(os.path.join(PORT_PLANS, plan), world, **kw)
    if world is not None:
        assert ours["ok"] and ours["stages"]


MUTATIONS = [
    {}, {"chunks": 4, "global_bsz": 8}, {"pipeline_type": "gpipe"},
    {"checkpoint": "1,0,1,0"}, {"dp_types_enc": "1,1,1,1"},
    {"default_dp_type": "zero2"}, {"use_sp": "1,1,1,1", "vsp": 1},
    {"pp_deg": 1, "pp_division": "4", "chunks": 1, "global_bsz": 8},
    {"tp_sizes_enc": "1,1,1,1", "cp_sizes_enc": "2,2,2,2", "vtp": 1},
    {"embed_sdp": 1}, {"pp_deg": 4, "pp_division": "1,1,1,1", "chunks": 4},
]


@pytest.mark.parametrize("mutation", MUTATIONS,
                         ids=[",".join(m) or "base" for m in MUTATIONS])
def test_torch_plan_mutations_match_jax_with_unit_ratios(mutation):
    """JAX's cross-check sweep: every component equal, every cost-model
    ratio 1.0 on both sides."""
    ours = both(good_plan(**mutation), 8)
    assert ours["ok"], ours["errors"]
    assert ours["ratios"] and all(r == pytest.approx(1.0, abs=1e-9)
                                  for r in ours["ratios"].values())


MALFORMED = {
    "zero_layer_stage": (good_plan(pp_division="0,4"), "zero-layer"),
    "missing_vocab_config": (good_plan(vtp=0), "vtp"),
    "missing_pp_deg": ({k: v for k, v in good_plan().items()
                        if k != "pp_deg"}, "pp_deg"),
    "wrong_length_vector": (good_plan(cp_sizes_enc="1,1"), "cp_sizes_enc"),
    "non_object_plan": (["not", "a", "plan"], "object"),
    "division_sum_mismatch": (good_plan(pp_division="3,2"), "pp_division"),
    "chunks_cannot_fill_pipeline": (good_plan(chunks=1, global_bsz=4),
                                    "chunks"),
    "layer_count": (good_plan(tp_sizes_enc="2,2", tp_consecutive_flags="1,1",
                              dp_types_enc="0,0", use_sp="0,0",
                              cp_sizes_enc="1,1", checkpoint="0,0",
                              pp_division="1,1"), "plan has 2 layers"),
    "world_mismatch": (good_plan(tp_sizes_enc="4,4,4,4"), "world"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_torch_malformed_plans_are_diagnosed_as_jax(case):
    plan, needle = MALFORMED[case]
    world = 6 if case == "world_mismatch" else 8
    ours = both(plan, world)
    assert not ours["ok"] and needle in " | ".join(ours["errors"]), ours


@pytest.mark.parametrize("hbm", [-4.0, 0.0])
def test_torch_non_positive_budget_is_a_diagnostic(hbm):
    ours = both(good_plan(), 8, hbm_gb=hbm)
    assert not ours["ok"] and "hbm-gb" in ours["errors"][0]


def test_torch_unreadable_plan_file_is_diagnosed(tmp_path):
    ours = report("port", str(tmp_path / "nope.json"), 8)
    assert not ours["ok"] and ours["errors"]
    assert ours["errors"] == report("jax", str(tmp_path / "nope.json"),
                                    8)["errors"]


@pytest.mark.parametrize("scale", [0.5, 0.999999, 1.0, 2.0])
def test_torch_budget_boundary_matches_jax(scale):
    """Both sides of the boundary, the boundary itself included: the
    doctor's verdict, its reason text, and the search's predicate on the
    same plan in ``SearchStrategy`` form agree on both packages."""
    peak_gb = TM.diagnose_memory(ACCEPTANCE, model("port"), 8).peak_mb / 1024
    budget = peak_gb * scale
    ours = both(ACCEPTANCE, 8, hbm_gb=budget)
    assert ours["ok"] == (scale >= 1.0)
    reasons = []
    for side, (M, _), ST in (("jax", SIDES["jax"], JST),
                             ("port", SIDES["port"], TST)):
        strategies = [ST.SearchStrategy(pp=2, tp=2, dp=2)] * 4
        reasons.append(M.search_result_hbm_reason(
            strategies, [2, 2], model(side), global_bsz=4, chunks=2,
            pipeline_type="pipedream_flush", schedule_impl="compiled",
            hbm_gb=budget, vocab_tp_sp=2))
    assert reasons[0] == reasons[1]
    assert (reasons[1] is None) == ours["ok"]
    if not ours["ok"]:
        assert reasons[1] == ours["errors"][-1]
    assert TM.hbm_budget_reason(1024.0 * budget, budget) is None


def test_torch_cross_check_names_a_drifted_component(monkeypatch):
    """A 10% drift of the doctor's activation model is named by the
    cross-check, as in JAX."""
    real = TM.activation_per_sample_mb
    calls = {"n": 0}

    def skewed(model_cfg, elem_bytes=2):
        calls["n"] += 1
        return real(model_cfg, elem_bytes) * (1.1 if calls["n"] >= 2 else 1)

    monkeypatch.setattr(TM, "activation_per_sample_mb", skewed)
    layers, vocab, _ = TU.config2strategy(good_plan(), world_size=8)
    _, problems = TM.cross_check_cost_model(
        layers, vocab, model("port"), global_bsz=4, chunks=2,
        pp_division=[2, 2], pipeline_type="pipedream_flush", world_size=8)
    assert problems and "activation" in problems[0]


def test_torch_layer_param_mb_matches_jax():
    from hetu_galvatron_tpu.observability import telemetry as JT

    for name in MODELS:
        assert TT.layer_param_mb(model("port", name)) == \
            JT.layer_param_mb(model("jax", name))


def test_torch_search_engine_hbm_gate_prunes_as_jax(capsys):
    """The engine-level hook on one task: pruned (and logged) above the
    budget, kept within it and with the gate off, on both sides."""
    peak_gb = TM.diagnose_memory(ACCEPTANCE, model("port"), 8).peak_mb / 1024
    out = {}
    for side, E, A, ST in (("jax", JE, JA, JST), ("port", TE, TA, TST)):
        r = E.TaskResult(throughput=1.0, time_cost=1.0,
                         strategy_list=[ST.SearchStrategy(pp=2, tp=2,
                                                          dp=2)] * 4,
                         pp_size=2, pp_stage_list=[2, 2], vocab_tp_sp=2,
                         bsz=4, chunks=2)
        res = []
        for budget in (peak_gb * 0.5, peak_gb * 2.0, 0.0):
            eng = E.SearchEngine(A.SearchArgs(
                num_nodes=1, num_devices_per_node=8, hbm_budget_gb=budget,
                pipeline_type="pipedream_flush",
                pipeline_schedule_impl="compiled"), model_cfg=model(side))
            kept = eng._hbm_gate(r)
            res.append((kept is r, kept.strategy_list is None,
                        capsys.readouterr().out))
        out[side] = res
    assert out["port"] == out["jax"]
    assert out["port"][0][1] and "hbm gate: pruned" in out["port"][0][2]
    assert out["port"][1][0] and out["port"][2][0]


def test_torch_kv_pool_component_is_the_pool_the_port_allocates():
    """``kv_pool_mb`` is the port's own sizing helper: the doctor's
    serving component equals the bytes of a ``PagedKVCache`` built from
    ``resolve_num_blocks`` for the same args, with a sized and a default
    pool."""
    from hetu_galvatron_tpu_torch.serving.kv_cache import (
        PagedKVCache,
        resolve_num_blocks,
    )

    cfg = model("port", "gqa_learned_gelu")
    plan = TU.strategy_list2config(
        [TU.LayerStrategy()] * cfg.num_hidden_layers, global_bsz=1,
        chunks=1, vocab=TU.EmbeddingLMHeadStrategy(),
        pp_division=[cfg.num_hidden_layers])
    for over in (dict(num_kv_blocks=10), dict(num_kv_blocks=0)):
        sv = TA.ServingArgs(**dict(SERVING, **over))
        rep = TM.diagnose_memory(plan, cfg, 1, serving=sv)
        kv = PagedKVCache(cfg, num_blocks=resolve_num_blocks(sv, cfg),
                          block_size=sv.kv_block_size,
                          max_seq_len=sv.max_seq_len)
        pool = sum(t.numel() * t.element_size()
                   for layer in kv.pools for t in layer.values())
        assert rep.ok and rep.stages[0].components["kv_pool_mb"] * 2 ** 20 \
            == pool


def test_torch_plan_file_and_dict_give_the_same_numbers(tmp_path):
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(good_plan()))
    a = report("port", good_plan(), 8)
    b = report("port", str(p), 8)
    assert a["ok"] and a["stages"] == b["stages"] and a["peak"] == b["peak"]


# the golden search's fixtures, with a Llama-2-7B-width model for the gate
LLAMA = dict(hidden_size=4096, num_hidden_layers=28, num_attention_heads=32,
             vocab_size=32000, seq_length=8192, max_position_embeddings=8192,
             hidden_act="swiglu", normalization="rmsnorm",
             ffn_hidden_size=11008, make_vocab_size_divisible_by=1)


@pytest.mark.parametrize("budget,outcome", [(30.0, "untouched"),
                                            (20.0, "another winner"),
                                            (15.0, "no plan")])
def test_torch_hbm_gated_search_matches_jax_bytes(budget, outcome,
                                                  tmp_path):
    """``search.hbm_budget_gb > 0`` on the coarse golden scenario: the
    same throughput, the same plan JSON (runner-ups and search trace
    included), the same gate log; at 30 GB the gate prunes nothing, at 20
    it prunes the winner and a pp2 x tp4 plan wins, at 15 no plan
    survives."""
    import test_torch_search_engine as S

    out = {}
    for side, (schema, engine) in (("jax", (JA, JE)), ("port", (TA, TE))):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = S.run("jax" if side == "jax" else "port",
                        tmp_path / side, layers=28,
                        model_cfg=schema.ModelArgs(**LLAMA),
                        hbm_budget_gb=budget, **S.COARSE)
        out[side] = (res, [line for line in printed.getvalue().splitlines()
                           if line.startswith("hbm gate")])
    assert out["port"] == out["jax"]
    (throughput, text, _), gate = out["port"]
    if outcome == "untouched":
        assert throughput == S.GOLDEN_COARSE and not gate
    elif outcome == "another winner":
        assert 0 < throughput < S.GOLDEN_COARSE and gate
        assert json.loads(text)["pp_deg"] == 2
    else:
        assert throughput == -1.0 and text is None and gate


def test_torch_doctor_dataclasses_match_jax_fields():
    for name in ("StageMemory", "MemoryDoctorReport"):
        assert [f.name for f in dataclasses.fields(getattr(TM, name))] == \
            [f.name for f in dataclasses.fields(getattr(JM, name))]
    assert TM.STAGE_COMPONENTS == JM.STAGE_COMPONENTS
