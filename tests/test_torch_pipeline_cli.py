"""``cli/train_dist.train()`` under pp plans on the CPU (``device=cpu``).

A run in GLOBAL mode and one from a JSON plan each equal, bit for bit,
the losses of the pipeline engine driven directly over the same weights
and batches; a save at step 2 resumed to step 4 repeats the
uninterrupted run bit for bit, stage parameters and AdamW states
included; a pp checkpoint resumed under another plan raises with both
plans named; the launcher refuses by name what the port does not run
(``hier_dp``, ``tp_overlap``, ``dcn_slices > 1``, stages wider than one
rank, a world other than ``pp_deg``), and never falls back.

``pipeline.schedule_impl=compiled``: GLOBAL and JSON plans train through
the compiled engine with its losses, bit for bit, and within JAX's
tolerance of the host engine's; a plan it cannot express logs JAX's
reason and trains through the host engine; the same-plan resume is bit
for bit; the NaN drill saves the pre-fault state; the metrics stream
carries the ``pp/compiled_step`` span, the ``pp/bubble_frac`` gauge and
the step program's ``cost/flops``; a checkpoint of the host engine's
layout is refused.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.models.builder import init_causal_lm
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime.dataloader import (
    get_train_valid_test_data_iterators,
)
from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
    get_hybrid_parallel_config,
)
from hetu_galvatron_tpu_torch.runtime.compiled_pipeline import (
    CompiledPipelineEngine,
)
from hetu_galvatron_tpu_torch.runtime.pipeline import PipelineEngine
from hetu_galvatron_tpu_torch.runtime.trainer import to_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2 = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs",
                    "gpt2-small.yaml")
TINY = ["device=cpu", "model.hidden_size=32", "model.num_hidden_layers=4",
        "model.num_attention_heads=2", "model.vocab_size=64",
        "model.seq_length=8", "model.max_position_embeddings=16",
        "model.make_vocab_size_divisible_by=1", "train.train_iters=4",
        "parallel.mixed_precision=fp32", "parallel.global_train_batch_size=8",
        "train.lr=1e-2", "train.lr_decay_iters=4"]
PP2 = ["parallel.num_devices=2", "parallel.pp_deg=2", "parallel.chunks=2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tiny models run faster on one thread
    than on a pool contending with the other test workers, and torch's
    multi-threaded CPU kernels are not bit-reproducible run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def direct_losses(args, engine=PipelineEngine):
    """The engine driven by hand over train()'s weights and batches."""
    torch.manual_seed(args.train.seed)
    hpc = get_hybrid_parallel_config(args, args.parallel.num_devices)
    eng = engine(args.model, hpc, args.train,
                 [torch.device("cpu")] * hpc.world_size,
                 compute_dtype=torch.float32)
    sp = eng.split_params(init_causal_lm(args.model, seed=args.train.seed))
    so = eng.init_opt(sp)
    it = get_train_valid_test_data_iterators(
        args, global_batch_size=hpc.global_bsz)[0]
    return [eng.train_step(sp, so, to_device(next(it), "cpu"))[2]["loss"]
            for _ in range(args.train.train_iters)]


def plan_file(tmp_path, **kw):
    plan = {"pp_deg": 2, "tp_sizes_enc": "1,1,1,1",
            "tp_consecutive_flags": "1,1,1,1", "dp_types_enc": "0,0,0,0",
            "use_sp": "0,0,0,0", "cp_sizes_enc": "1,1,1,1",
            "checkpoint": "0,1,0,0", "global_bsz": 8, "chunks": 4,
            "pp_division": "1,3", "pipeline_type": "pipedream_flush",
            "default_dp_type": "ddp", "vtp": 1, "vsp": 0, "embed_sdp": 0}
    plan.update(kw)
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    return str(path)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("mode", ["global", "json", "global_vpp"])
def test_torch_train_dist_pp_plan_matches_the_engine(mode, tmp_path):
    over = {"global": PP2 + ["parallel.pipeline_type=pipedream_flush"],
            "json": ["parallel.num_devices=2", "parallel.config_mode=json",
                     f"parallel.galvatron_config_path={plan_file(tmp_path)}"],
            "global_vpp": PP2 + ["parallel.virtual_pp_deg=2",
                                 "parallel.chunks=4"]}[mode]
    args = load_config(GPT2, TINY + over)
    lines = _Lines()
    logger = logging.getLogger("hetu_galvatron_tpu_torch")
    logger.addHandler(lines)
    try:
        out = train_dist.train(args)
    finally:
        logger.removeHandler(lines)
    assert "2 ranks share 1 device(s) (cpu): the pipeline stages on one " \
        "device run one after another" in lines.lines
    assert out["losses"] == direct_losses(load_config(GPT2, TINY + over))
    assert all(np.isfinite(out["losses"]))
    # the run's state is the stage list
    assert isinstance(out["params"], list) and isinstance(
        out["opt_state"], list)


def test_torch_train_dist_pp_resume_is_bit_identical(tmp_path):
    """Save at step 2, resume in a fresh train() to step 4: the losses,
    every stage parameter and every AdamW moment equal the run that never
    stopped (tied GPT-2: the head copy rides in the last stage)."""
    full = train_dist.train(load_config(GPT2, TINY + PP2))
    ck = str(tmp_path / "ck")
    first = train_dist.train(load_config(
        GPT2, TINY + PP2 + ["train.train_iters=2", f"ckpt.save={ck}",
                            "ckpt.save_interval=2"]))
    rest = train_dist.train(load_config(
        GPT2, TINY + PP2 + [f"ckpt.load={ck}"]))
    assert rest["start_iter"] == 2
    assert first["losses"] + rest["losses"] == full["losses"]
    want = train_dist.run_summary(full, 0)["param_sha256"]
    assert train_dist.run_summary(rest, 0)["param_sha256"] == want
    assert any(k.endswith("head.whead") for k in want)
    for a, b in zip(full["opt_state"], rest["opt_state"]):
        assert a.count == b.count
        assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu,
                                                      b.mu + b.nu))
    meta = TK.read_checkpoint_meta(os.path.join(ck, "step_2"))
    plan = meta["hybrid_parallel_config"]
    assert (plan["pp_deg"], plan["pp_division"], plan["world_size"]) == (
        2, "2,2", 2)


def test_torch_pp_checkpoint_under_another_plan_raises(tmp_path):
    ck = str(tmp_path / "ck")
    train_dist.train(load_config(GPT2, TINY + PP2 + [
        "train.train_iters=2", f"ckpt.save={ck}", "ckpt.save_interval=2"]))
    # pp=1: another world
    with pytest.raises(TK.WorldSizeMismatchError, match="2-device world"):
        train_dist.train(load_config(GPT2, TINY + [f"ckpt.load={ck}"]))
    # the same world, another stage layout, even without the strict check
    plan = plan_file(tmp_path, chunks=2, checkpoint="0,0,0,0",
                     pipeline_type="gpipe")
    with pytest.raises(TK.PlanMismatchError) as err:
        train_dist.train(load_config(GPT2, TINY + [
            "parallel.num_devices=2", "parallel.config_mode=json",
            f"parallel.galvatron_config_path={plan}", f"ckpt.load={ck}",
            "ckpt.distributed_checkpoint=false"]))
    assert "'pp_division': '2,2'" in str(err.value)
    assert "'pp_division': '1,3'" in str(err.value)


REFUSED = {
    # the compiled schedule refuses the same flags
    "compiled": (PP2 + ["pipeline.schedule_impl=compiled",
                        "tp_overlap.enable=true"], "tp_overlap.enable"),
    "hier_dp": (PP2 + ["parallel.hier_dp=true"], "parallel.hier_dp"),
    "tp_overlap": (PP2 + ["tp_overlap.enable=true"], "tp_overlap.enable"),
    "dcn_slices": (PP2 + ["parallel.dcn_slices=2"], "parallel.dcn_slices"),
    "tp2": (PP2 + ["parallel.global_tp_deg=2", "parallel.num_devices=4"],
            "parallel.global_tp_deg=2"),
    "world": (["parallel.pp_deg=2", "parallel.num_devices=4"],
              "world size 4 with parallel.pp_deg=2"),
    "json_tp2": (["parallel.num_devices=2", "parallel.config_mode=json"],
                 "tp_sizes_enc: layer 0 has 2"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_torch_train_dist_refuses_what_the_pipeline_does_not_run(
        case, tmp_path):
    over, text = REFUSED[case]
    if case == "json_tp2":
        over = over + [f"parallel.galvatron_config_path="
                       f"{plan_file(tmp_path, tp_sizes_enc='2,2,2,2')}"]
    with pytest.raises(NotImplementedError, match=text):
        train_dist.main([GPT2, *TINY, *over])


def test_torch_pp_nan_drill_saves_the_pre_fault_state(tmp_path):
    """The rerun machine on a pp run: a transient NaN at step 2 re-runs
    the step's schedule on the untouched stages, saves the state before
    it and exits 16; the relaunch finishes on the uninterrupted
    trajectory, bit for bit."""
    rerun = ["rerun.enable=true", "rerun.mode=validate_results"]
    full = train_dist.train(load_config(GPT2, TINY + PP2 + rerun))
    out = train_dist.train(load_config(GPT2, TINY + PP2 + rerun + [
        f"ckpt.save={tmp_path}", "rerun.inject_kind=nan",
        "rerun.inject_at_iter=2"]))
    assert out["exit_code"] == 16 and out["rerun"]["transient"] == 1
    assert out["losses"][:2] == full["losses"][:2]
    assert TK.latest_checkpoint(str(tmp_path)).endswith("step_2")
    rest = train_dist.train(load_config(GPT2, TINY + PP2 + rerun + [
        f"ckpt.load={tmp_path}"]))
    assert rest["start_iter"] == 2
    assert rest["losses"] == full["losses"][2:]
    assert train_dist.run_summary(rest, 0)["param_sha256"] == \
        train_dist.run_summary(full, 0)["param_sha256"]


# with num_devices unset: (overrides, the world, the ranks' devices or the
# refusal); four cards are visible
WORLDS = {
    "pp1": ([], 1, [0]),
    "pp1_json": (["parallel.config_mode=json"], 1, [0]),
    "pp4": (["parallel.pp_deg=4", "parallel.chunks=4"], 4, [0, 1, 2, 3]),
    "pp2": (["parallel.pp_deg=2"], None, "world size 4 with parallel.pp_deg=2"),
    "pp2_num_devices": (PP2, 2, [0, 1]),
}


@pytest.mark.parametrize("case", list(WORLDS))
def test_torch_initialize_takes_its_world_from_the_plan(case, tmp_path,
                                                        monkeypatch):
    """On a host with several cards, a pp=1 plan runs on one of them
    whatever their number; a pp plan takes the visible cards unless
    ``parallel.num_devices`` says otherwise, and must then have as many
    stages."""
    from hetu_galvatron_tpu_torch.runtime.initialize import initialize

    over, world, want = WORLDS[case]
    if case == "pp1_json":
        over = over + [f"parallel.galvatron_config_path="
                       f"{plan_file(tmp_path, pp_deg=1, pp_division='4')}"]
    for name, value in (("is_available", True), ("device_count", 4),
                        ("current_device", 0),
                        ("get_device_name", "a card")):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _v=value: _v)
    args = load_config(GPT2, [a for a in TINY if a != "device=cpu"] + over)
    if world is None:
        with pytest.raises(NotImplementedError, match=want):
            initialize(args)
        return
    state = initialize(args)
    assert state.world_size == world
    assert state.devices == [torch.device("cuda", i) for i in want]


@pytest.mark.parametrize("case", ["telemetry", "ramp"])
def test_torch_pp_runs_the_observability_and_ramp_flags(case, tmp_path):
    stream = tmp_path / "m.jsonl"
    extra = {"telemetry": ["observability.enabled=true",
                           f"observability.metrics_path={stream}"],
             # the micro size global / chunks = 4: one microbatch, then two
             "ramp": ["train.rampup_batch_size=[4,4,8]"]}[case]
    out = train_dist.train(load_config(GPT2, TINY + PP2 + extra))
    assert out["exit_code"] is None and all(np.isfinite(out["losses"]))
    if case == "telemetry":
        names = {json.loads(line).get("name") for line in
                 stream.read_text().splitlines()}
        assert "train/tokens_per_sec" in names
    else:
        assert out["batch_sizes"] == [4, 4, 8, 8]


# -- pipeline.schedule_impl=compiled ------------------------------------------

COMPILED = ["pipeline.schedule_impl=compiled"]
ONE_F_ONE_B = PP2 + ["parallel.pipeline_type=pipedream_flush"]


def _logged_train(args):
    lines = _Lines()
    logger = logging.getLogger("hetu_galvatron_tpu_torch")
    logger.addHandler(lines)
    try:
        out = train_dist.train(args)
    finally:
        logger.removeHandler(lines)
    return out, lines.lines


@pytest.mark.parametrize("mode", ["global", "json"])
def test_torch_train_dist_compiled_plan_matches_the_engine(mode, tmp_path):
    """An expressible plan trains through the compiled engine: the losses
    of the engine driven by hand, bit for bit, and the host engine's
    within JAX's tolerance; one capture; the log gives ``bubble_frac``."""
    over = {"global": ONE_F_ONE_B,
            "json": ["parallel.num_devices=2", "parallel.config_mode=json",
                     f"parallel.galvatron_config_path="
                     f"{plan_file(tmp_path, checkpoint='1,1,1,1', pp_division='2,2')}"]
            }[mode]
    out, lines = _logged_train(load_config(GPT2, TINY + over + COMPILED))
    chunks = 2 if mode == "global" else 4
    bubble = 2 / (chunks + 2)
    assert any(line.startswith("pipeline schedule: compiled single-program "
                               f"1F1B (bubble_frac {bubble:.3f}")
               for line in lines), lines
    assert out["pipeline"] == {"schedule": "compiled", "compile_count": 1,
                               "bubble_frac": bubble, "program_costs": {}}
    args = load_config(GPT2, TINY + over + COMPILED)
    assert out["losses"] == direct_losses(args, CompiledPipelineEngine)
    host = direct_losses(load_config(GPT2, TINY + over))
    assert np.allclose(out["losses"], host, rtol=0, atol=2e-5)
    assert isinstance(out["params"], dict) and "stages" in out["params"]
    # the run released its graphs' static gradients
    assert all(t.grad is None for t in out["params"]["stages"][0].values()
               if isinstance(t, torch.Tensor))


def test_torch_train_dist_compiled_falls_back_with_the_reason():
    """A plan the compiled schedule cannot express logs JAX's reason and
    trains through the host engine, with its losses."""
    over = PP2 + ["parallel.pipeline_type=gpipe"]
    out, lines = _logged_train(load_config(GPT2, TINY + over + COMPILED))
    assert ("pipeline.schedule_impl=compiled cannot express this plan "
            "(compiled schedule implements 1F1B (pipedream_flush) only); "
            "falling back to the host engine") in lines
    assert out["pipeline"] == {"schedule": "host"}
    assert out["losses"] == direct_losses(load_config(GPT2, TINY + over))


def test_torch_compiled_resume_is_bit_identical(tmp_path):
    """Save at step 2 in the stacked layout, resume in a fresh train() to
    step 4: losses, every leaf and every AdamW moment equal the run that
    never stopped; the resumed run captures again."""
    full = train_dist.train(load_config(GPT2, TINY + ONE_F_ONE_B + COMPILED))
    ck = str(tmp_path / "ck")
    first = train_dist.train(load_config(
        GPT2, TINY + ONE_F_ONE_B + COMPILED + ["train.train_iters=2",
                                       f"ckpt.save={ck}",
                                       "ckpt.save_interval=2"]))
    rest = train_dist.train(load_config(
        GPT2, TINY + ONE_F_ONE_B + COMPILED + [f"ckpt.load={ck}"]))
    assert rest["start_iter"] == 2 and rest["pipeline"]["compile_count"] == 1
    assert first["losses"] + rest["losses"] == full["losses"]
    want = train_dist.run_summary(full, 0)["param_sha256"]
    assert train_dist.run_summary(rest, 0)["param_sha256"] == want
    assert any(k.startswith("stages.0.") for k in want)
    a, b = full["opt_state"], rest["opt_state"]
    assert a.count == b.count and a.decay == b.decay
    assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))


def test_torch_compiled_nan_drill_saves_the_pre_fault_state(tmp_path):
    """The rerun machine over the compiled step: a transient NaN at step
    2 re-runs the step (a replay) on the untouched leaves, saves the state
    before it and exits 16; the relaunch finishes on the uninterrupted
    trajectory, bit for bit."""
    rerun = ["rerun.enable=true", "rerun.mode=validate_results"]
    full = train_dist.train(load_config(GPT2, TINY + ONE_F_ONE_B + COMPILED + rerun))
    out = train_dist.train(load_config(GPT2, TINY + ONE_F_ONE_B + COMPILED + rerun + [
        f"ckpt.save={tmp_path}", "rerun.inject_kind=nan",
        "rerun.inject_at_iter=2"]))
    assert out["exit_code"] == 16 and out["rerun"]["transient"] == 1
    assert out["losses"][:2] == full["losses"][:2]
    assert TK.latest_checkpoint(str(tmp_path)).endswith("step_2")
    rest = train_dist.train(load_config(GPT2, TINY + ONE_F_ONE_B + COMPILED + rerun + [
        f"ckpt.load={tmp_path}"]))
    assert rest["start_iter"] == 2
    assert rest["losses"] == full["losses"][2:]
    assert train_dist.run_summary(rest, 0)["param_sha256"] == \
        train_dist.run_summary(full, 0)["param_sha256"]


def test_torch_compiled_span_gauge_and_cost_in_the_stream(tmp_path):
    """The metrics stream of a compiled run carries the ``pp/compiled_step``
    span under ``train/step``, the ``pp/bubble_frac`` gauge and, once, the
    step program's ``cost/flops`` with its ``program_cost`` event."""
    stream = tmp_path / "m.jsonl"
    out = train_dist.train(load_config(GPT2, TINY + ONE_F_ONE_B + COMPILED + [
        "observability.enabled=true", f"observability.metrics_path={stream}",
        "observability.flush_interval=1"]))
    recs = [json.loads(line) for line in stream.read_text().splitlines()]
    paths = {r.get("labels", {}).get("path") for r in recs
             if r.get("name") == "span_ms"}
    assert "train/step/pp/compiled_step" in paths
    assert not any(p and "pp/fwd_s" in p for p in paths)
    gauges = [r["value"] for r in recs if r.get("name") == "pp/bubble_frac"]
    assert gauges and gauges[-1] == pytest.approx(0.5)
    costs = [r for r in recs if r.get("name") == "program_cost"]
    assert len(costs) == 1 and costs[0]["data"]["program"] == \
        "pp/compiled_step_m2" and costs[0]["data"]["flops"] > 0
    assert out["pipeline"]["program_costs"] == {
        "pp/compiled_step_m2": {"flops": costs[0]["data"]["flops"]}}
    # the counted first step is the uncounted run's, bit for bit
    plain = train_dist.train(load_config(GPT2, TINY + ONE_F_ONE_B + COMPILED))
    assert out["losses"] == plain["losses"]
    assert train_dist.run_summary(out, 0)["param_sha256"] == \
        train_dist.run_summary(plain, 0)["param_sha256"]


def test_torch_compiled_run_refuses_a_host_layout_checkpoint(tmp_path):
    """A checkpoint of the host engine's stage layout does not resume a
    compiled run of the same plan (the reshard moves it): the error names
    both layouts."""
    ck = str(tmp_path / "ck")
    train_dist.train(load_config(GPT2, TINY + ONE_F_ONE_B + [
        "train.train_iters=2", f"ckpt.save={ck}", "ckpt.save_interval=2"]))
    with pytest.raises(TK.PlanMismatchError) as err:
        train_dist.train(load_config(GPT2, TINY + ONE_F_ONE_B + COMPILED + [
            f"ckpt.load={ck}"]))
    assert "(stages layout)" in str(err.value)
    assert "(stacked layout)" in str(err.value)
