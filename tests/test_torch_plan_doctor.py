"""The port's plan doctor (``analysis/plan_doctor.py``) and the rest of
``analysis/eligibility.py`` against the JAX package's, exactly: the
malformed-plan corpus and the engine/kernel reports of
``tests/analysis/test_plan_doctor.py`` on both sides, compared field by
field and as rendered text, apart from the one warning the port adds
where its own runtime refuses the plan (``check_plan_width``, or a world
above one device); and the eligibility reasons the doctor and the cost
model read, over a sweep of plan shapes."""

import io
import json
import os

import pytest

from hetu_galvatron_tpu.analysis import eligibility as JEL
from hetu_galvatron_tpu.analysis import plan_doctor as JP
from hetu_galvatron_tpu.core import args_schema as JA
from hetu_galvatron_tpu_torch.analysis import eligibility as TEL
from hetu_galvatron_tpu_torch.analysis import plan_doctor as TP
from hetu_galvatron_tpu_torch.core import args_schema as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PLANS = os.path.join(ROOT, "hetu_galvatron_tpu_torch", "profiles",
                          "example_plans")
JAX_PLANS = os.path.join(ROOT, "hetu_galvatron_tpu", "profiles",
                         "example_plans")
TINY = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            vocab_size=256, seq_length=16, max_position_embeddings=32,
            hidden_act="swiglu", normalization="rmsnorm",
            position_embedding_type="rope", tie_word_embeddings=False,
            add_bias_linear=False, add_qkv_bias=False,
            make_vocab_size_divisible_by=1, ffn_hidden_size=128)
REFUSES = "warning: the port's runtime refuses this plan today: "


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


def one_device(n=4, **kw):
    ones = ",".join(["1"] * n)
    zeros = ",".join(["0"] * n)
    return good_plan(**dict(dict(
        pp_deg=1, tp_sizes_enc=ones, tp_consecutive_flags=ones,
        dp_types_enc=zeros, use_sp=zeros, cp_sizes_enc=ones,
        checkpoint=zeros, pp_division=str(n), vtp=1, global_bsz=2,
        chunks=2), **kw))


def report(side, plan, world, model_kw=None, **kw):
    mod, schema = (JP, JA) if side == "jax" else (TP, TA)
    cfg = schema.ModelArgs(**dict(TINY, **(model_kw or {})))
    rep = mod.diagnose_plan(plan, cfg, world, **kw)
    text = io.StringIO()
    rep.render(text)
    return rep, text.getvalue()


def both(plan, world=8, model_kw=None, jax_plan=None, **kw):
    """The port's report against JAX's: equal in every field and line but
    the port-refusal warning, which it carries exactly when the port's
    runtime refuses the plan. Returns (port report, refusal or None)."""
    theirs, ttext = report("jax", plan if jax_plan is None else jax_plan,
                           world, model_kw, **kw)
    ours, otext = report("port", plan, world, model_kw, **kw)
    refusal = [w for w in ours.warnings
               if w.startswith(REFUSES[len("warning: "):])]
    assert len(refusal) <= 1
    warnings = [w for w in ours.warnings if w not in refusal]
    assert warnings == theirs.warnings
    for f in ("ok", "errors", "engine", "engine_reason", "summary",
              "world_size", "plan"):
        want = getattr(theirs, f)
        if f == "plan" and jax_plan is not None:
            want = plan
        assert getattr(ours, f) == want, f
    assert [vars(d) for d in ours.layers] == [vars(d) for d in theirs.layers]
    lines = [x for x in otext.splitlines() if not x.startswith(REFUSES)]
    if jax_plan is not None:
        ttext = ttext.replace(jax_plan, plan)
    assert lines == ttext.splitlines()
    return ours, (refusal[0] if refusal else None)


MALFORMED = [
    ("missing_pp_deg",
     {k: v for k, v in good_plan().items() if k != "pp_deg"}, "pp_deg"),
    ("missing_tp_vector",
     {k: v for k, v in good_plan().items() if k != "tp_sizes_enc"},
     "tp_sizes_enc"),
    ("non_integer_pp_deg", good_plan(pp_deg="two"), "integer"),
    ("fractional_pp_deg", good_plan(pp_deg=2.5), "integer"),
    ("non_integer_vector", good_plan(cp_sizes_enc="1,x,1,1"),
     "cp_sizes_enc"),
    ("wrong_length_vector", good_plan(dp_types_enc="0,0"), "dp_types_enc"),
    ("zero_layers", good_plan(tp_sizes_enc=""), "zero layers"),
    ("negative_pp", good_plan(pp_deg=-2), "pp_deg"),
    ("non_pow2_tp", good_plan(tp_sizes_enc="3,6,3,3"), "not divisible"),
    ("bad_dp_type", good_plan(default_dp_type="zero9"), "default_dp_type"),
    ("tp_exceeds_world", good_plan(tp_sizes_enc="16,16,16,16"),
     "not divisible"),
    ("division_sum_mismatch", good_plan(pp_division="3,2"), "pp_division"),
    ("division_len_mismatch", good_plan(pp_division="1,1,2"),
     "pp_division"),
    ("bsz_not_multiple_of_chunks", good_plan(global_bsz=3), "chunks"),
    ("layer_count_mismatch", good_plan(
        tp_sizes_enc="2,2", tp_consecutive_flags="1,1",
        dp_types_enc="0,0", use_sp="0,0", cp_sizes_enc="1,1",
        checkpoint="0,0", pp_division="1,1"), "model has"),
    ("non_object_plan", ["not", "a", "plan"], "object"),
    ("world_mismatch", good_plan(), "not divisible"),
]


@pytest.mark.parametrize("name,plan,needle", MALFORMED,
                         ids=[m[0] for m in MALFORMED])
def test_torch_malformed_plans_are_diagnosed_as_jax(name, plan, needle):
    ours, _ = both(plan, 6 if name == "world_mismatch" else 8)
    assert not ours.ok and needle in " | ".join(ours.errors)


@pytest.mark.parametrize("text,needle", [("{ this is not json",
                                          "invalid JSON"),
                                         (None, "cannot read plan")])
def test_torch_unreadable_plan_files_are_diagnosed_as_jax(text, needle,
                                                          tmp_path):
    p = tmp_path / "plan.json"
    if text is not None:
        p.write_text(text)
    ours, _ = both(str(p), 8)
    assert not ours.ok and needle in ours.errors[0]


VALID = {
    "acceptance": (None, 8, {}, {}),
    "spmd_tp2zero3": (None, 8, {}, {}),
    "heterogeneous_division": (good_plan(
        tp_sizes_enc="2,2,2,2,2", tp_consecutive_flags="1,1,1,1,1",
        dp_types_enc="0,0,0,0,0", use_sp="0,0,0,0,0",
        cp_sizes_enc="1,1,1,1,1", checkpoint="0,0,0,0,0",
        pp_division="3,2"), 8, dict(num_hidden_layers=5), {}),
    "cp_and_ulysses": (good_plan(pp_deg=1, tp_sizes_enc="2,2,2,1",
                                 use_sp="0,1,0,0", cp_sizes_enc="1,1,2,1",
                                 pp_division="4", global_bsz=8, chunks=1),
                       8, {}, {}),
    "zigzag_host_no_overlap": (good_plan(pp_deg=1, cp_sizes_enc="2,2,2,2",
                                         tp_sizes_enc="1,1,1,1", vtp=1,
                                         pp_division="4", global_bsz=8,
                                         chunks=1), 8, {},
                               dict(cp_zigzag=True, tp_overlap=False)),
    "host_impl": (good_plan(), 8, {}, dict(schedule_impl="host")),
    "moe": (good_plan(), 8, dict(num_experts=4, moe_layer_freq=2), {}),
    "t5": (good_plan(tp_sizes_enc="2,2,2,2,2,2,2,2",
                     tp_consecutive_flags="1,1,1,1,1,1,1,1",
                     dp_types_enc="0,0,0,0,0,0,0,0",
                     use_sp="0,0,0,0,0,0,0,0",
                     cp_sizes_enc="1,1,1,1,1,1,1,1",
                     checkpoint="0,0,0,0,0,0,0,0", pp_division="4,4",
                     num_encoder_layers=4), 8,
           dict(model_type="t5", num_encoder_layers=4), {}),
    "no_flash": (good_plan(), 8, dict(use_flash_attn=False), {}),
    "integral_floats": (good_plan(pp_deg=2.0, vtp=2.0), 8, {}, {}),
    "smallest_world": (good_plan(), None, {}, {}),
    "gpipe": (good_plan(pipeline_type="gpipe"), 8, {}, {}),
    "indivisible_widths": (good_plan(pp_deg=1, pp_division="4",
                                     tp_sizes_enc="8,8,8,8", vtp=1,
                                     global_bsz=8, chunks=1), 8,
                           dict(ffn_hidden_size=132), {}),
    "one_device": (one_device(), 1, {}, {}),
    "one_device_remat_zero3": (one_device(checkpoint="1,0,1,0",
                                          default_dp_type="zero3"), 1, {},
                               {}),
    "dp8": (one_device(global_bsz=16), 8, {}, {}),
    "vpp": (good_plan(pp_division="1,1,1,1", vpp_deg=2, chunks=2), 8, {},
            {}),
}


@pytest.mark.parametrize("case", list(VALID))
def test_torch_plan_reports_match_jax(case):
    plan, world, model_kw, kw = VALID[case]
    jax_plan = None
    if plan is None:
        name = ("galvatron_config_acceptance_tp2dp2pp2.json"
                if case == "acceptance"
                else "galvatron_config_spmd_tp2zero3.json")
        plan = os.path.join(PORT_PLANS, name)
        jax_plan = os.path.join(JAX_PLANS, name)
    ours, refusal = both(plan, world, model_kw, jax_plan=jax_plan, **kw)
    if case in ("one_device", "one_device_remat_zero3", "spmd_tp2zero3",
                "indivisible_widths", "dp8"):
        # pp=1 plans of tp, dp and ZeRO run over ranks (parallel/spmd.py)
        assert ours.ok and refusal is None
    elif ours.ok:
        # pipelines of stages wider than one rank, cp, Ulysses: refused
        assert refusal is not None and "ROADMAP item" in refusal


def test_torch_refusal_warning_names_the_field_and_item(tmp_path):
    # pp=2 with tp=2: the stages would be wider than one rank
    ours, refusal = both(good_plan(), 8)
    assert ours.ok and "tp_sizes_enc: layer 0 has 2" in refusal and \
        "ROADMAP item 12c" in refusal
    _, refusal = both(one_device(global_bsz=16), 8)
    assert refusal is None  # dp8: the SPMD step runs it
    _, refusal = both(one_device(hier_dp=1), 1)
    assert "hier_dp=1" in refusal and "ROADMAP item 12d" in refusal
    p = tmp_path / "plan.json"
    p.write_text(json.dumps(good_plan()))
    _, refusal = both(str(p), 8)
    assert refusal.startswith(f"the port's runtime refuses this plan "
                              f"today: plan {p}: tp_sizes_enc")


@pytest.mark.parametrize("plan", [
    one_device(pp_deg=2, pp_division="2,2"),
    one_device(pp_deg=2, pp_division="1,3", pipeline_type="gpipe"),
    one_device(pp_deg=2, pp_division="1,1,1,1", vpp_deg=2),
    one_device(pp_deg=4, pp_division="1,1,1,1", global_bsz=4, chunks=4)])
def test_torch_pipeline_plans_of_one_rank_a_stage_get_no_warning(plan):
    """The port runs a pp plan whose stages are one rank each at a world
    of pp_deg (``runtime/pipeline.py``); at any other world it warns."""
    ours, refusal = both(plan, plan["pp_deg"])
    assert ours.ok and refusal is None
    _, refusal = both(plan, 2 * plan["pp_deg"])
    assert f"world size {2 * plan['pp_deg']} with pp_deg=" in refusal and \
        "ROADMAP item 12c" in refusal


OVERLAP_CASES = [dict(ulysses=u, has_cp=c, tp=t, seq_len=s)
                 for u in (False, True) for c in (False, True)
                 for t in (1, 2, 3, 4, 8) for s in (None, 12, 16)]


@pytest.mark.parametrize("model_kw", [{}, dict(ffn_hidden_size=132),
                                      dict(num_key_value_heads=2),
                                      dict(hidden_act="gelu")])
def test_torch_overlap_reasons_match_jax(model_kw):
    cfgs = [s.ModelArgs(**dict(TINY, **model_kw)) for s in (JA, TA)]
    for kw in OVERLAP_CASES:
        assert TEL.overlap_unsupported_reason(cfgs[1], **kw) == \
            JEL.overlap_unsupported_reason(cfgs[0], **kw), kw


HIER_KW = [dict(dp=d, cp=c, ulysses=u, tp=t, tp_consecutive=tc,
                uniform_strategies=us, model_type=mt, num_experts=e,
                dropout=dr, vtp=vt, vcp=1, cp_zigzag=z)
           for d in (1, 4) for c in (1, 2) for u in (False, True)
           for t in (1, 2) for tc in (True, False) for us in (True, False)
           for mt in ("gpt", "t5") for e in (0, 4) for dr in (0.0, 0.1)
           for vt in (1, 4) for z in (False, True)]


def test_torch_hier_dp_and_dp_schedule_reasons_match_jax():
    for kw in HIER_KW:
        assert TEL.hier_dp_unsupported_reason(**kw) == \
            JEL.hier_dp_unsupported_reason(**kw), kw
    for name in JEL.DP_SCHEDULE_FAMILIES + JEL.DP_SCHEDULE_HANDBUILT + (
            "nope",):
        for lanes in (1, 2, 4, 6, 8, 12):
            for cross in (1, 2, 3):
                for bucket in (0.0, 8.0):
                    args = (name, lanes, cross, bucket)
                    assert TEL.dp_schedule_unsupported_reason(*args) == \
                        JEL.dp_schedule_unsupported_reason(*args), args
    for c in ("T5_REASON", "MOE_REASON", "HIER_KERNEL_REASON",
              "HIER_DROPOUT_REASON", "HIER_ZIGZAG_REASON",
              "DP_SCHEDULE_FAMILIES", "DP_SCHEDULE_HANDBUILT"):
        assert getattr(TEL, c) == getattr(JEL, c), c


PLAN_VIEWS = ["acceptance", "cp_and_ulysses", "moe", "t5", "dp8",
              "heterogeneous_division", "zigzag_host_no_overlap"]


@pytest.mark.parametrize("case", PLAN_VIEWS)
def test_torch_plan_level_reasons_match_jax(case):
    """``plan_overlap_reasons``, ``plan_hier_dp_reason``,
    ``compiled_unsupported_reason`` and ``layer_overlap_reason`` over the
    doctor's duck-typed hpc view of each plan."""
    from hetu_galvatron_tpu.utils import strategy as JU
    from hetu_galvatron_tpu_torch.utils import strategy as TU

    plan, world, model_kw, _ = VALID[case]
    if plan is None:
        plan = json.load(open(os.path.join(
            PORT_PLANS, "galvatron_config_acceptance_tp2dp2pp2.json")))
    out = {}
    for side, EL, U, S in (("jax", JEL, JU, JA), ("port", TEL, TU, TA)):
        cfg = S.ModelArgs(**dict(TINY, **model_kw))
        layers, vocab, extras = U.config2strategy(plan, world_size=world)

        class Hpc:
            pass

        hpc = Hpc()
        hpc.layers, hpc.vocab, hpc.pp_deg = layers, vocab, layers[0].pp_deg
        hpc.pp_division = extras["pp_division"] or [len(layers)]
        hpc.pipeline_type = extras["pipeline_type"]
        hpc.cp_zigzag = case == "zigzag_host_no_overlap"

        class Data:
            reset_position_ids = True

        out[side] = (EL.plan_overlap_reasons(cfg, hpc),
                     EL.plan_hier_dp_reason(cfg, hpc),
                     EL.compiled_unsupported_reason(cfg, hpc),
                     EL.compiled_unsupported_reason(cfg, hpc, Data()),
                     [EL.layer_overlap_reason(cfg, s, s.tp_size)
                      for s in layers])
    assert out["port"] == out["jax"]
