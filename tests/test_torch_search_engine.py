"""The port's search engine (``core/search_engine``) against the JAX
package's, exactly: the fine and coarse golden scenarios of
``tests/search_engine/test_search_golden.py`` (the same throughput and a
plan JSON equal byte for byte, runner-ups included), the thread pool,
world-1 searches on the repo's fixtures and on the hardware files a world-1
profile writes, the NumPy DP against the C++ core, the search-trace JSONL
(its timestamps aside), ``dp_solve`` on random tables, the failure of a
search for more devices than its profile measured, and searches with
``search.hier_dp=1`` and ``search.hbm_budget_gb > 0`` (equal to JAX's;
``tests/test_torch_hier_cost.py`` and ``test_torch_memory_doctor.py``
hold them on curves and budgets that change the plan). The JAX engine
runs once per scenario (module-scoped fixtures)."""

import copy
import glob
import json
import os

import numpy as np
import pytest

from hetu_galvatron_tpu.core import args_schema as JS
from hetu_galvatron_tpu.core.search_engine import dp as JDP
from hetu_galvatron_tpu.core.search_engine import engine as JE
from hetu_galvatron_tpu_torch.core import args_schema as TS
from hetu_galvatron_tpu_torch.core.search_engine import dp as TDP
from hetu_galvatron_tpu_torch.core.search_engine import engine as TE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
GOLDEN_FINE = 2.6485091403918064
GOLDEN_COARSE = 2.5246283459057333
HARDWARE = dict(
    allreduce_bandwidth_config_path=os.path.join(
        FIX, "allreduce_bandwidth_1nodes_8gpus_per_node.json"),
    p2p_bandwidth_config_path=os.path.join(
        FIX, "p2p_bandwidth_1nodes_8gpus_per_node.json"),
    overlap_coe_path=os.path.join(FIX, "overlap_coefficient.json"),
    sp_time_path=os.path.join(FIX, "sp_time_1nodes_8gpus_per_node.json"))
# the four files a world-1 hardware profile writes (either package)
WORLD1_HARDWARE = {"allreduce": {}, "p2p": {}, "sp_time": {},
                   "overlap": {"overlap_coe": 1.0}}
GOLDEN = dict(
    num_nodes=1, num_devices_per_node=8, memory_constraint=36,
    settle_bsz=64, default_dp_type="zero2", pipeline_type="pipedream_flush",
    sequence_parallel=True, async_grad_reduce=False, mixed_precision="bf16",
    time_profile_mode="sequence", memory_profile_mode="sequence",
    time_profiling_path=os.path.join(
        FIX, "computation_profiling_bf16_llama2-7b_all.json"),
    memory_profiling_path=os.path.join(
        FIX, "memory_profiling_bf16_llama2-7b_all.json"), **HARDWARE)
FINE = dict(GOLDEN, settle_chunks=32, fine_grained_mode=1)
COARSE = dict(GOLDEN, settle_chunks=8, fine_grained_mode=0)
WORLD1 = dict(GOLDEN, num_devices_per_node=1, settle_bsz=-1, min_bsz=1,
              max_bsz=8, bsz_scale=1, default_dp_type="ddp",
              async_grad_reduce=True)


def run(pkg, out_dir, layers=28, model_cfg=None, **kw):
    """One search; returns (throughput, plan JSON text or None)."""
    schema, engine = {"jax": (JS, JE), "port": (TS, TE)}[pkg]
    args = schema.SearchArgs(output_config_path=str(out_dir), **kw)
    eng = engine.SearchEngine(args, model_cfg=model_cfg)
    eng.set_model_info([{"hidden_size": 4096, "seq_len": 8192,
                         "layer_num": layers}], "llama2-7b")
    eng.initialize()
    throughput = eng.optimize()
    files = glob.glob(os.path.join(str(out_dir), "*.json"))
    assert len(files) == (1 if throughput > 0 else 0)
    text = open(files[0]).read() if files else None
    return throughput, text, [os.path.basename(f) for f in files]


@pytest.fixture(scope="module")
def fine(tmp_path_factory):
    return {pkg: run(pkg, tmp_path_factory.mktemp(pkg), **FINE)
            for pkg in ("jax", "port")}


def test_torch_fine_golden_search_matches_jax(fine):
    throughput, text, names = fine["port"]
    assert throughput == GOLDEN_FINE
    assert fine["port"] == fine["jax"]
    cfg = json.loads(text)
    assert len(cfg["runner_ups"]) == 3
    # the JAX golden test pins it to approx (its default 1e-6 relative)
    assert cfg["predicted_time_cost_ms"] == pytest.approx(24164.538105)


def test_torch_coarse_golden_search_and_thread_pool_match_jax(tmp_path):
    jax_res = run("jax", tmp_path / "j", **COARSE)
    assert jax_res[0] == GOLDEN_COARSE
    assert run("port", tmp_path / "p", **COARSE) == jax_res
    assert run("port", tmp_path / "pool", parallel_search=True,
               **COARSE) == jax_res


@pytest.mark.parametrize("layers,memory", [(4, 36), (4, 48), (4, 80),
                                           (8, 80)])
def test_torch_world1_search_matches_jax(layers, memory, tmp_path):
    """At world 1 the search still chooses the batch, the chunks and the
    layers to checkpoint: none fits 36 GB, all layers checkpointed at 48,
    none at 80, and 8 layers at 80 GB checkpoint some and not others."""
    kw = dict(WORLD1, memory_constraint=memory)
    ours = run("port", tmp_path / "p", layers=layers, **kw)
    assert ours == run("jax", tmp_path / "j", layers=layers, **kw)
    flags = {(4, 36): None, (4, 48): "1,1,1,1", (4, 80): "0,0,0,0",
             (8, 80): "1,1,1,0,0,0,0,0"}[(layers, memory)]
    if flags is None:
        assert ours[0] == -1.0
    else:
        assert json.loads(ours[1])["checkpoint"] == flags
    # the NumPy recurrence gives the C++ core's plan
    assert run("port", tmp_path / "np", layers=layers, use_cpp_core=False,
               **kw) == ours


def test_torch_world1_search_on_world1_hardware_files(tmp_path):
    """The four files a world-1 hardware profile writes are enough: the
    search gives the plan it gives on the 8-device fixtures."""
    paths = {}
    for key, content in WORLD1_HARDWARE.items():
        paths[key] = str(tmp_path / f"{key}.json")
        with open(paths[key], "w") as f:
            json.dump(content, f)
    kw = dict(WORLD1, allreduce_bandwidth_config_path=paths["allreduce"],
              p2p_bandwidth_config_path=paths["p2p"],
              overlap_coe_path=paths["overlap"],
              sp_time_path=paths["sp_time"], memory_constraint=80)
    ours = run("port", tmp_path / "p", layers=8, **kw)
    assert ours == run("jax", tmp_path / "j", layers=8, **kw)
    assert ours == run("port", tmp_path / "fix", layers=8,
                       **dict(WORLD1, memory_constraint=80))


def test_torch_search_trace_matches_jax(tmp_path):
    traces = {}
    for pkg in ("jax", "port"):
        path = tmp_path / f"{pkg}.jsonl"
        run(pkg, tmp_path / pkg, search_trace_path=str(path), **COARSE)
        recs = [json.loads(line) for line in open(path)]
        for r in recs:
            assert isinstance(r.pop("t"), float)
        traces[pkg] = recs
    assert traces["port"] == traces["jax"]
    assert traces["port"][-1]["name"] == "search_best"
    assert len(traces["port"]) > 10


@pytest.mark.parametrize("seed", range(6))
def test_torch_dp_solve_matches_jax(seed):
    rng = np.random.RandomState(seed)
    layers, strat = rng.randint(1, 7), rng.randint(1, 6)
    mem = rng.randint(0, 25, size=(layers, strat))
    intra = rng.rand(layers, strat)
    inter = rng.rand(layers, strat, strat) * 1e-3
    inter[0] = 0.0
    max_mem, other_mem = int(rng.randint(10, 90)), int(rng.randint(0, 20))
    other_time = float(rng.rand())
    want = JDP.dp_solve(mem, intra, inter, max_mem, other_mem, other_time,
                        use_cpp_core=True)
    assert want == JDP.dp_solve(mem, intra, inter, max_mem, other_mem,
                                other_time, use_cpp_core=False)
    for cpp in (True, False):
        got = TDP.dp_solve(mem, intra, inter, max_mem, other_mem, other_time,
                           use_cpp_core=cpp)
        assert got == want, (cpp, got, want)


def test_torch_dp_core_builds_into_the_cache():
    from hetu_galvatron_tpu_torch.ops import _build

    path = _build.build_host_library("dp_core.cpp")
    assert path.startswith(_build.BUILD_DIR) and os.path.exists(path)
    assert _build.build_host_library("dp_core.cpp") == path
    assert TDP.load_cpp_core() is TDP.load_cpp_core()


def test_torch_search_beyond_the_profiled_tp_fails_like_jax(tmp_path):
    """A memory profile written on one card holds tp 1 only: a search for
    8 devices from it fails as JAX's does, on the missing tp key."""
    with open(GOLDEN["memory_profiling_path"]) as f:
        mem = json.load(f)
    one_card = copy.deepcopy(mem)
    for table in one_card.values():
        for entry in table.values():
            for sub in ("tp_activation_per_bsz_dict", "model_states",
                        "activation"):
                if sub in entry:
                    entry[sub] = {k: v for k, v in entry[sub].items()
                                  if k in ("1", "checkpoint")}
    path = tmp_path / "mem_tp1.json"
    path.write_text(json.dumps(one_card))
    kw = dict(FINE, memory_profiling_path=str(path), settle_chunks=8)
    errors = []
    for pkg in ("jax", "port"):
        with pytest.raises(KeyError) as err:
            run(pkg, tmp_path / pkg, **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_torch_hier_dp_search_raises_by_name(tmp_path):
    """``search.hier_dp=1`` searches now (it raised by name until the
    collective schedules were ported): on the golden fixtures, which fit
    no per-algorithm curve, the hierarchical term prices nothing, so the
    plan equals JAX's and the golden plan, byte for byte."""
    outs = [run(pkg, tmp_path / pkg, hier_dp=1, **COARSE)
            for pkg in ("jax", "port")]
    assert outs[0] == outs[1] and outs[1][0] == GOLDEN_COARSE
    assert "hier_dp" not in json.loads(outs[1][1])


def test_torch_hbm_budget_gate_raises_by_name(tmp_path, capsys):
    """``search.hbm_budget_gb > 0`` runs the memory doctor's gate now (it
    raised by name until the doctor was ported): world-1 searches equal
    JAX's, with and without a feasible plan, and the gate logs as JAX's."""
    from hetu_galvatron_tpu.core.args_schema import ModelArgs as JM
    from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs

    for i, (budget, kw) in enumerate(((70, dict(WORLD1, memory_constraint=80)),
                                      (0.001, dict(WORLD1,
                                                   memory_constraint=80)),
                                      (70, dict(WORLD1)))):
        outs = []
        for pkg, M in (("jax", JM), ("port", ModelArgs)):
            res = run(pkg, tmp_path / f"{pkg}{i}", layers=4, model_cfg=M(),
                      hbm_budget_gb=budget, **kw)
            outs.append((res, capsys.readouterr().out.count(
                "hbm gate: pruned")))
        assert outs[0] == outs[1], (budget, outs)
        if budget == 0.001:
            assert outs[1][0][0] == -1.0 and outs[1][1] > 0
    # without a feasible plan the gate has nothing to judge, as in JAX
    assert outs[1][0][0] == -1.0 and outs[1][1] == 0


def _two_layertypes(tmp_path):
    """The fixtures with a second layertype (a t5-like encoder | decoder
    split): its time and memory rows are the first's, scaled."""
    with open(GOLDEN["time_profiling_path"]) as f:
        comp = json.load(f)
    comp.update({k.replace("layertype_0_", "layertype_1_"): v * 1.25
                 for k, v in comp.items() if k.startswith("layertype_0_")})
    with open(GOLDEN["memory_profiling_path"]) as f:
        mem = json.load(f)
    second = copy.deepcopy(mem["layertype_0_sp"])
    for entry in second.values():
        entry["parameter_size"] *= 1.5
    mem["layertype_1_sp"] = second
    (tmp_path / "comp2.json").write_text(json.dumps(comp))
    (tmp_path / "mem2.json").write_text(json.dumps(mem))
    return dict(COARSE, time_profiling_path=str(tmp_path / "comp2.json"),
                memory_profiling_path=str(tmp_path / "mem2.json"))


def test_torch_two_layertype_search_matches_jax(tmp_path):
    """pp_division_balanced and a coarse search over two layertypes (the
    t5 encoder-decoder path: num_encoder_layers in the plan) equal
    JAX's."""
    kw = _two_layertypes(tmp_path)
    engines = []
    for schema, engine in ((TS, TE), (JS, JE)):
        eng = engine.SearchEngine(schema.SearchArgs(
            output_config_path=str(tmp_path / schema.__name__), **kw))
        eng.set_model_info([{"hidden_size": 4096, "seq_len": 8192,
                             "layer_num": 12},
                            {"hidden_size": 4096, "seq_len": 8192,
                             "layer_num": 16}], "t5-like", model_type="t5")
        eng.initialize()
        engines.append(eng)
    ours, theirs = engines
    for pp in (1, 2, 4, 8):
        assert ours.pp_division_balanced(64, 8, pp) == \
            theirs.pp_division_balanced(64, 8, pp)
    assert ours.check_cost_model(64, 8) == theirs.check_cost_model(64, 8)
    got = (ours.optimize(), *(open(f).read() for f in glob.glob(
        os.path.join(ours.args.output_config_path, "*.json"))))
    want = (theirs.optimize(), *(open(f).read() for f in glob.glob(
        os.path.join(theirs.args.output_config_path, "*.json"))))
    assert got == want and got[0] > 0
    assert json.loads(got[1])["num_encoder_layers"] == 12
