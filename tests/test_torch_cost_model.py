"""The port's cost model (``core/cost_model/cost.py``) against the JAX
package's, exactly: every public cost function returns the same floats
(``==``) for every strategy of ``enumerate_strategies(8, ...)`` (cp
included), at several (global batch, chunks) points, under contexts built
by both packages' search engines from the same profile files: the repo's
fixtures (sequence-mode times and memory), and a variant with batch-mode
times fitted from a seeded profile, fitted α-β curves in the bandwidth
file, the overlapped-TP discount, the compiled pipeline schedule with a
dispatch cost, fp32 and gpipe. A case that raises must raise the same
error in both. ``model_flops_per_token`` is compared for every YAML."""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from hetu_galvatron_tpu.core import arguments as JA
from hetu_galvatron_tpu.core import args_schema as JS
from hetu_galvatron_tpu.core.cost_model import cost as JC
from hetu_galvatron_tpu.core.search_engine import engine as JE
from hetu_galvatron_tpu.core.search_engine import strategies as JST
from hetu_galvatron_tpu_torch.core import arguments as TA
from hetu_galvatron_tpu_torch.core import args_schema as TS
from hetu_galvatron_tpu_torch.core.cost_model import cost as TC
from hetu_galvatron_tpu_torch.core.search_engine import engine as TE
from hetu_galvatron_tpu_torch.core.search_engine import strategies as TST

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
CONFIGS = sorted(glob.glob(os.path.join(
    ROOT, "hetu_galvatron_tpu", "models", "configs", "*.yaml")))
LAYERS = 28
POINTS = ((64, 8), (16, 16), (8, 1), (64, 32))


def _variant_files(tmp):
    """A batch-mode computation profile (seeded) and a bandwidth file with
    fitted flat and per-algorithm α-β pairs."""
    rng = np.random.RandomState(0)
    comp = {}
    for b in range(1, 9):
        comp[f"layertype_0_bsz{b}_seq8192"] = float(30 + 2 * rng.rand())
        comp[f"layertype_other_bsz{b}_seq8192"] = float(9 + rng.rand())
    with open(os.path.join(tmp, "comp_batch.json"), "w") as f:
        json.dump(comp, f)
    with open(os.path.join(
            FIX, "allreduce_bandwidth_1nodes_8gpus_per_node.json")) as f:
        bw = json.load(f)
    for n in (2, 4, 8):
        for c in (0, 1):
            bw[f"allreduce_size_{n}_consec_{c}_alpha_ms"] = 0.01 * n + c
            bw[f"allreduce_size_{n}_consec_{c}_beta_mb_per_ms"] = 90.0 + n
            for alg, lvl in (("ring", "ici"), ("tree", "ici"),
                             ("ring", "dcn")):
                key = f"allreduce_size_{n}_consec_{c}_alg_{alg}_lvl_{lvl}"
                bw[f"{key}_alpha_ms"] = 0.02 * n + (alg == "tree") * 0.005
                bw[f"{key}_beta_mb_per_ms"] = 80.0 + 3 * n + (
                    lvl == "dcn") * -40.0
    with open(os.path.join(tmp, "allreduce_ab.json"), "w") as f:
        json.dump(bw, f)


def _search_kw(variant, tmp):
    kw = dict(
        num_nodes=1, num_devices_per_node=8, memory_constraint=36,
        settle_bsz=64, default_dp_type="zero2",
        pipeline_type="pipedream_flush", async_grad_reduce=False,
        time_profile_mode="sequence", memory_profile_mode="sequence",
        time_profiling_path=os.path.join(
            FIX, "computation_profiling_bf16_llama2-7b_all.json"),
        memory_profiling_path=os.path.join(
            FIX, "memory_profiling_bf16_llama2-7b_all.json"),
        allreduce_bandwidth_config_path=os.path.join(
            FIX, "allreduce_bandwidth_1nodes_8gpus_per_node.json"),
        p2p_bandwidth_config_path=os.path.join(
            FIX, "p2p_bandwidth_1nodes_8gpus_per_node.json"),
        overlap_coe_path=os.path.join(FIX, "overlap_coefficient.json"),
        sp_time_path=os.path.join(FIX, "sp_time_1nodes_8gpus_per_node.json"))
    if variant == "variant":
        kw.update(
            time_profile_mode="batch", memory_profile_mode="static",
            time_profiling_path=os.path.join(tmp, "comp_batch.json"),
            allreduce_bandwidth_config_path=os.path.join(
                tmp, "allreduce_ab.json"),
            tp_overlap=1, pipeline_schedule_impl="compiled",
            dispatch_us=40.0, pipeline_type="gpipe", mixed_precision="fp32",
            async_grad_reduce=True, default_dp_type="ddp",
            costmodel_coe=1.25)
    return kw


@pytest.fixture(scope="module", params=["fixtures", "variant"])
def engines(request, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cost"))
    _variant_files(tmp)
    out = []
    for schema, engine in ((TS, TE), (JS, JE)):
        args = schema.SearchArgs(**_search_kw(request.param, tmp))
        eng = engine.SearchEngine(args, mixed_precision=args.mixed_precision)
        eng.set_model_info([{"hidden_size": 4096, "seq_len": 8192,
                             "layer_num": LAYERS}], "llama2-7b")
        eng.initialize()
        out.append(eng)
    shutil.rmtree(tmp)
    return out


def _strategies():
    limits = dict(disable_cp=0)
    t = TST.enumerate_strategies(8, LAYERS, TST.SearchSpaceLimits(**limits))
    j = JST.enumerate_strategies(8, LAYERS, JST.SearchSpaceLimits(**limits))
    assert [s.sort_key() for s in t[0]] == [s.sort_key() for s in j[0]]
    assert [s.sort_key() for s in t[1]] == [s.sort_key() for s in j[1]]
    assert any(s.cp > 1 for s in t[0]) and any(s.sp > 1 for s in t[0])
    return list(zip(t[0], j[0])), list(zip(t[1], j[1]))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return ("raises", type(e).__name__, str(e))


def _same(fn_t, fn_j, where):
    ours, theirs = _outcome(fn_t), _outcome(fn_j)
    assert ours == theirs, (where, ours, theirs)
    return ours


def _layer_cases(engines):
    teng, jeng = engines
    layer, _ = _strategies()
    for gbsz, chunks in POINTS:
        for st, sj in layer:
            if gbsz // chunks < st.dp:
                continue
            yield teng.contexts[0], jeng.contexts[0], st, sj, gbsz, chunks


def test_torch_layer_time_cost_matches_jax(engines):
    n = 0
    for ct, cj, st, sj, gbsz, chunks in _layer_cases(engines):
        got = _same(lambda: TC.layer_time_cost(st, ct, gbsz, chunks),
                    lambda: JC.layer_time_cost(sj, cj, gbsz, chunks),
                    (st, gbsz, chunks))
        n += got[0] == "ok"
    assert n > 200


def test_torch_layer_time_components_match_jax(engines):
    for ct, cj, st, sj, gbsz, chunks in _layer_cases(engines):
        _same(lambda: TC.layer_time_components(st, ct, gbsz, chunks),
              lambda: JC.layer_time_components(sj, cj, gbsz, chunks),
              (st, gbsz, chunks))
        _same(lambda: TC.hier_grad_payload_mb(st, ct),
              lambda: JC.hier_grad_payload_mb(sj, cj), st)


def test_torch_layer_memory_matches_jax(engines):
    raised = 0
    for ct, cj, st, sj, gbsz, chunks in _layer_cases(engines):
        for stage in range(st.pp):
            for ptype in (None, "gpipe", "pipedream_flush"):
                got = _same(
                    lambda: TC.layer_memory_components(
                        st, ct, gbsz, chunks, stage, ptype),
                    lambda: JC.layer_memory_components(
                        sj, cj, gbsz, chunks, stage, ptype),
                    (st, gbsz, chunks, stage, ptype))
                raised += got[0] == "raises"
                _same(lambda: TC.layer_memory_cost(
                          st, ct, gbsz, chunks, stage, ptype),
                      lambda: JC.layer_memory_cost(
                          sj, cj, gbsz, chunks, stage, ptype),
                      (st, gbsz, chunks, stage, ptype))
    assert raised > 0  # chunks < pp raises in both


def test_torch_embed_costs_match_jax(engines):
    teng, jeng = engines
    _, vocab = _strategies()
    ct, cj = teng.contexts[0], jeng.contexts[0]
    for gbsz, chunks in POINTS:
        for st, sj in vocab:
            if gbsz // chunks < st.dp:
                continue
            where = (st, gbsz, chunks)
            _same(lambda: TC.embed_time_cost(st, ct, gbsz, chunks,
                                             teng.seqlen_list),
                  lambda: JC.embed_time_cost(sj, cj, gbsz, chunks,
                                             jeng.seqlen_list), where)
            for ptype in (None, "gpipe"):
                _same(lambda: TC.embed_memory_components(
                          st, ct, gbsz, chunks, ptype),
                      lambda: JC.embed_memory_components(
                          sj, cj, gbsz, chunks, ptype), where)
                _same(lambda: TC.embed_memory_cost(st, ct, gbsz, chunks,
                                                   ptype),
                      lambda: JC.embed_memory_cost(sj, cj, gbsz, chunks,
                                                   ptype), where)


def test_torch_pipeline_time_cost_matches_jax(engines):
    teng, jeng = engines
    layer, _ = _strategies()
    n = 0
    for gbsz, chunks in POINTS:
        for st, sj in layer:
            if gbsz // chunks < st.dp or st.pp > chunks:
                continue
            part = TST.pp_division_even([LAYERS], st.pp)
            assert part == JST.pp_division_even([LAYERS], sj.pp)
            # a uniform plan, and one that alternates checkpointing
            plans_t = [[st] * LAYERS, [st, st.vocab_variant()] * (
                LAYERS // 2)]
            plans_j = [[sj] * LAYERS, [sj, sj.vocab_variant()] * (
                LAYERS // 2)]
            other_t = TC.embed_time_cost(st.vocab_variant(),
                                         teng.contexts[0], gbsz, chunks,
                                         teng.seqlen_list)[1]
            other_j = JC.embed_time_cost(sj.vocab_variant(),
                                         jeng.contexts[0], gbsz, chunks,
                                         jeng.seqlen_list)[1]
            for pt, pj in zip(plans_t, plans_j):
                got = _same(lambda: TC.pipeline_time_cost(
                          [LAYERS], teng.contexts, pt, part, chunks, gbsz,
                          st.pp, other_t),
                      lambda: JC.pipeline_time_cost(
                          [LAYERS], jeng.contexts, pj, part, chunks, gbsz,
                          sj.pp, other_j), (st, gbsz, chunks))
                n += got[0] == "ok"
    assert n > 100


def test_torch_reprice_stored_plan_ms_matches_jax(engines):
    teng, _ = engines
    layer, _ = _strategies()
    ab = {f"{n}_{c}": (0.01 * n + c, 90.0 + n) for n in (2, 4, 8)
          for c in (0, 1)}
    algos = {f"{n}_1": {"ring_ici": (0.02 * n, 85.0), "tree_ici": (
        0.01, 40.0 + n), "ring_dcn": (0.3, 12.0)} for n in (2, 4, 8)}
    for i, (st, _) in enumerate(layer):
        rt = st.to_runtime()
        plan = {"pp": rt.pp_deg, "bsz": 64, "chunks": 8 if i % 2 else 1,
                "layers": [{"tp": rt.tp_size, "dp": rt.dp_size,
                            "cp": rt.cp_size, "sp": int(rt.sp),
                            "ckpt": int(rt.checkpoint),
                            "consec": int(rt.tp_consecutive)}] * 4}
        for kw in (dict(alpha_beta=ab), dict(alpha_beta_algos=algos),
                   dict(alpha_beta=ab, alpha_beta_algos=algos,
                        mixed_precision=False), {}):
            common = dict(seq_len=8192, hidden_size=4096, param_mb=973.0)
            assert TC.reprice_stored_plan_ms(plan, **common, **kw) == \
                JC.reprice_stored_plan_ms(plan, **common, **kw), (plan, kw)


def test_torch_hier_dp_pricing_raises_by_name(engines):
    """``search.hier_dp=1`` is priced now (it raised by name until the
    collective schedules were ported): the layer cost, the reduce ms and
    the dp-schedule rankings equal JAX's on the engines' contexts, with
    and without per-algorithm curves; a layer the hierarchical term does
    not price keeps its flat cost."""
    teng, jeng = engines
    layer, _ = _strategies()
    algos = {f"{n}_{c}": {"ring_ici": (0.02 * n, 85.0),
                          "tree_ici": (0.01, 40.0 + n),
                          "ring_dcn": (0.3, 12.0)}
             for n in (2, 4, 8) for c in (0, 1)}
    ctxs = (teng.contexts[0], jeng.contexts[0])
    saved = [(c.hier_dp, c.alpha_beta_algos, c.dcn_slices) for c in ctxs]
    try:
        for curves, slices in (({}, 1), (algos, 1), (algos, 2)):
            for c in ctxs:
                c.hier_dp, c.alpha_beta_algos, c.dcn_slices = (
                    True, curves, slices)
            for (st, jst) in layer:
                grad = TC.hier_grad_payload_mb(st, ctxs[0])
                assert grad == JC.hier_grad_payload_mb(jst, ctxs[1])
                _same(lambda: TC.layer_time_cost(st, ctxs[0], 64, 8),
                      lambda: JC.layer_time_cost(jst, ctxs[1], 64, 8), st)
                _same(lambda: TC.hier_dp_reduce_ms(st, ctxs[0], grad),
                      lambda: JC.hier_dp_reduce_ms(jst, ctxs[1], grad), st)
                _same(lambda: list(TC.dp_schedule_rankings(
                    st, ctxs[0], grad).items()),
                    lambda: list(JC.dp_schedule_rankings(
                        jst, ctxs[1], grad).items()), st)
        one = [st for st, _ in layer if st.dp == 1][0]
        assert TC.hier_dp_reduce_ms(one, ctxs[0], 100.0) is None
        assert TC.dp_schedule_rankings(one, ctxs[0], 100.0) == {}
        hier = TC.layer_time_cost(one, ctxs[0], 64, 8)
        ctxs[0].hier_dp = False
        assert TC.layer_time_cost(one, ctxs[0], 64, 8) == hier
        wide = [st for st, _ in layer if st.dp > 1][0]
        assert TC.hier_dp_reduce_ms(wide, ctxs[0], 100.0) is None
    finally:
        for c, (h, a, d) in zip(ctxs, saved):
            c.hier_dp, c.alpha_beta_algos, c.dcn_slices = h, a, d


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_torch_model_flops_per_token_matches_jax_cost_model(path):
    ours = TA.load_config(path).model
    theirs = JA.load_config(path).model
    for seq in (None, 512, 8192):
        assert TC.model_flops_per_token(ours, seq) == \
            JC.model_flops_per_token(theirs, seq)
