"""The port's plan JSON (``utils/strategy.py``) against the JAX package's:
``config2strategy`` and ``strategy_list2config`` on the example plans and
on searched plans, the malformed-plan errors, ``form_strategy`` /
``print_strategies`` and the validating writer. Exact: the plan JSON is
byte-compatible."""

import dataclasses
import glob
import json
import os

import pytest

from hetu_galvatron_tpu.core import args_schema as JS
from hetu_galvatron_tpu.core.search_engine import engine as JE
from hetu_galvatron_tpu.core.search_engine import strategies as JST
from hetu_galvatron_tpu.utils import strategy as J
from hetu_galvatron_tpu_torch.core.search_engine import (
    strategies as TST,
)
from hetu_galvatron_tpu_torch.utils import strategy as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(
    ROOT, "hetu_galvatron_tpu", "profiles", "example_plans", "*.json")))
FIX = os.path.join(ROOT, "tests", "fixtures")


def _fixture_search(tmp, *, world, memory, layers, **kw):
    """A JAX search on the repo's fixtures; returns the written plan."""
    args = JS.SearchArgs(
        num_nodes=1, num_devices_per_node=world, memory_constraint=memory,
        **kw,
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
        sp_time_path=os.path.join(FIX, "sp_time_1nodes_8gpus_per_node.json"),
        output_config_path=str(tmp))
    eng = JE.SearchEngine(args)
    eng.set_model_info([{"hidden_size": 4096, "seq_len": 8192,
                         "layer_num": layers}], "llama2-7b")
    eng.initialize()
    assert eng.optimize() > 0
    (path,) = glob.glob(os.path.join(str(tmp), "*.json"))
    return path, world


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """(path, world) of the example plans and of three searched plans: the
    coarse golden scenario on 8 devices, and two searches at world 1 (the
    second checkpoints some layers and not others)."""
    out = [(p, 8) for p in EXAMPLES]
    out.append(_fixture_search(
        tmp_path_factory.mktemp("coarse"), world=8, memory=36, layers=28,
        settle_bsz=64, settle_chunks=8, default_dp_type="zero2",
        fine_grained_mode=0, async_grad_reduce=False))
    for layers in (4, 8):
        out.append(_fixture_search(
            tmp_path_factory.mktemp("world1"), world=1, memory=80,
            layers=layers, min_bsz=1, max_bsz=8, bsz_scale=1))
    return out


def _norm(parsed):
    layers, vocab, extras = parsed
    rows = [{k: int(v) if isinstance(v, (bool, int)) else v
             for k, v in dataclasses.asdict(s).items()} for s in layers]
    return rows, dataclasses.asdict(vocab), extras


def test_torch_config2strategy_matches_jax(plans):
    assert len(plans) == len(EXAMPLES) + 3
    for path, world in plans:
        cfg = T.load_strategy_config(path)
        assert cfg == J.load_strategy_config(path)
        for ws in (None, world):
            assert _norm(T.config2strategy(cfg, world_size=ws)) == \
                _norm(J.config2strategy(cfg, world_size=ws)), (path, ws)


def test_torch_strategy_list2config_round_trips_like_jax(plans):
    for path, world in plans:
        cfg = T.load_strategy_config(path)
        tl, tv, tx = T.config2strategy(cfg, world_size=world)
        jl, jv, jx = J.config2strategy(cfg, world_size=world)
        kw = dict(global_bsz=tx["global_bsz"], chunks=tx["chunks"],
                  pipeline_type=tx["pipeline_type"],
                  default_dp_type=tx["default_dp_type"],
                  pp_division=tx["pp_division"],
                  num_encoder_layers=tx["num_encoder_layers"],
                  predicted_layer_compute_ms=tx["predicted_layer_compute_ms"])
        ours = T.strategy_list2config(tl, vocab=tv, **kw)
        theirs = J.strategy_list2config(jl, vocab=jv, **kw)
        assert json.dumps(ours) == json.dumps(theirs)
        # the plan's own keys survive the round trip
        for key, value in ours.items():
            if key in cfg:
                assert cfg[key] == value, (path, key)


def test_torch_save_strategy_config_writes_jax_bytes(plans, tmp_path):
    for i, (path, world) in enumerate(plans):
        cfg = T.load_strategy_config(path)
        T.save_strategy_config(str(tmp_path / f"t{i}.json"), cfg, world)
        J.save_strategy_config(str(tmp_path / f"j{i}.json"), cfg, world)
        assert (tmp_path / f"t{i}.json").read_bytes() == \
            (tmp_path / f"j{i}.json").read_bytes()
    bad = dict(T.load_strategy_config(EXAMPLES[0]))
    with pytest.raises(ValueError, match="not divisible"):
        T.save_strategy_config(str(tmp_path / "bad.json"), bad, 3)


GOOD = {"pp_deg": 1, "tp_sizes_enc": "1,1", "global_bsz": 4, "chunks": 1}
MALFORMED = [
    [1, 2],
    {"tp_sizes_enc": "1"},
    {"pp_deg": 0, "tp_sizes_enc": "1"},
    {"pp_deg": 2.5, "tp_sizes_enc": "1"},
    {"pp_deg": "two", "tp_sizes_enc": "1"},
    {"pp_deg": 1},
    {"pp_deg": 1, "tp_sizes_enc": ""},
    {"pp_deg": 1, "tp_sizes_enc": "1,x"},
    dict(GOOD, checkpoint="1"),
    dict(GOOD, default_dp_type="fsdp"),
    dict(GOOD, vtp="wide"),
    dict(GOOD, chunks=1.5),
]


@pytest.mark.parametrize("cfg", MALFORMED, ids=range(len(MALFORMED)))
def test_torch_malformed_plans_raise_jax_plan_format_error(cfg):
    with pytest.raises(T.PlanFormatError) as ours:
        T.config2strategy(cfg)
    with pytest.raises(J.PlanFormatError) as theirs:
        J.config2strategy(cfg)
    assert str(ours.value) == str(theirs.value)
    assert ours.value.key == theirs.value.key


def test_torch_unreadable_plan_files_raise_like_jax(tmp_path):
    (tmp_path / "bad.json").write_text("{not json")
    (tmp_path / "list.json").write_text("[1, 2]")
    for name in ("bad.json", "list.json", "missing.json"):
        path = str(tmp_path / name)
        with pytest.raises(T.PlanFormatError) as ours:
            T.load_strategy_config(path)
        with pytest.raises(J.PlanFormatError) as theirs:
            J.load_strategy_config(path)
        assert str(ours.value) == str(theirs.value)
        assert ours.value.path == path


def test_torch_form_strategy_strings_match_jax():
    layer_t, vocab_t = TST.enumerate_strategies(8, 28,
                                                TST.SearchSpaceLimits())
    layer_j, vocab_j = JST.enumerate_strategies(8, 28,
                                                JST.SearchSpaceLimits())
    assert [s.simple_string() for s in layer_t + vocab_t] == \
        [s.simple_string() for s in layer_j + vocab_j]
    ours = [s.to_runtime() for s in layer_t]
    theirs = [s.to_runtime() for s in layer_j]
    assert [T.form_strategy(s) for s in ours] == \
        [J.form_strategy(s) for s in theirs]
    assert T.print_strategies(ours) == J.print_strategies(theirs)
    wide = [T.LayerStrategy(pp_deg=2, tp_size=2, dp_size=1, cp_size=2,
                            sp=True, ep_size=2, etp_size=2, checkpoint=True,
                            tp_consecutive=False)] * 3
    jwide = [J.LayerStrategy(pp_deg=2, tp_size=2, dp_size=1, cp_size=2,
                             sp=True, ep_size=2, etp_size=2, checkpoint=True,
                             tp_consecutive=False)] * 3
    assert T.print_strategies(wide) == J.print_strategies(jwide)
