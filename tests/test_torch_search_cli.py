"""The profile -> search -> train loop through the port's launchers on the
CPU (``cli/profiler.py``, ``cli/search_dist.py``, ``cli/train_dist.py``
with ``parallel.config_mode=json``), the JSON-plan half of
``runtime/hybrid_config.py`` against the JAX package's (the same per-layer
remat flags, global batch and chunks for the same world-1 plan, and the
same plan fingerprint), a plan whose remat flags are all equal training
bit for bit as the GLOBAL-mode run with the same batch, chunks and
``parallel.global_checkpoint``, and the refusal of every plan field that
needs more than one device, by name."""

import glob
import json
import logging
import os

import pytest
import torch

from hetu_galvatron_tpu.core import arguments as JA
from hetu_galvatron_tpu.runtime import checkpoint as JK
from hetu_galvatron_tpu.runtime import hybrid_config as JH
from hetu_galvatron_tpu_torch.cli import profiler as TCP
from hetu_galvatron_tpu_torch.cli import search_dist as TCS
from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.models.builder import named_leaves
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH
from hetu_galvatron_tpu_torch.utils.strategy import PlanFormatError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs")
GPT2 = os.path.join(CONFIGS, "gpt2-small.yaml")
T5 = os.path.join(CONFIGS, "t5-3b.yaml")
EXAMPLES = os.path.join(ROOT, "hetu_galvatron_tpu", "profiles",
                        "example_plans")
MODEL = ["device=cpu", "model.hidden_size=32", "model.num_hidden_layers=4",
         "model.num_attention_heads=2", "model.vocab_size=64",
         "model.seq_length=16", "model.max_position_embeddings=16",
         "model.make_vocab_size_divisible_by=1"]
TRAIN = ["train.train_iters=3", "parallel.mixed_precision=fp32",
         "train.lr=1e-3"]


def _plan(tmp_path, n=4, name="plan.json", **over):
    """A world-1 plan of ``n`` layers, fields overridden by ``over``."""
    cfg = {"pp_deg": 1, "tp_sizes_enc": ",".join(["1"] * n),
           "tp_consecutive_flags": ",".join(["1"] * n),
           "dp_types_enc": ",".join(["0"] * n),
           "use_sp": ",".join(["0"] * n),
           "cp_sizes_enc": ",".join(["1"] * n),
           "ep_sizes_enc": ",".join(["1"] * n),
           "tp_of_ep_sizes_enc": ",".join(["1"] * n),
           "checkpoint": ",".join(["0"] * n), "global_bsz": 4, "chunks": 2,
           "pp_division": str(n), "pipeline_type": "pipedream_flush",
           "default_dp_type": "ddp", "vtp": 1, "vsp": 0, "vcp": 1,
           "embed_sdp": 0}
    cfg.update(over)
    path = tmp_path / name
    path.write_text(json.dumps(cfg, indent=4))
    return str(path)


def test_torch_profile_search_train_loop_on_the_cpu(tmp_path, capsys):
    hw, prof, plans = (str(tmp_path / d) for d in ("hw", "prof", "plans"))
    assert TCP.main([GPT2, *MODEL, "mode=profile_hardware",
                     "hardware_profiler.num_devices_per_node=1",
                     f"hardware_profiler.output_dir={hw}"]) == 0
    common = [GPT2, *MODEL, "mode=model_profiler",
              "model_profiler.profile_seq_length_list=[16]",
              f"model_profiler.output_dir={prof}"]
    assert TCP.main(common + ["model_profiler.profile_type=computation",
                              "model_profiler.profile_mode=batch"]) == 0
    assert TCP.main(common + ["model_profiler.profile_type=memory"]) == 0
    (comp,) = glob.glob(os.path.join(prof, "computation_*.json"))
    (mem,) = glob.glob(os.path.join(prof, "memory_*.json"))
    tag = "1nodes_1gpus_per_node"
    search = [
        GPT2, *MODEL, "search.num_devices_per_node=1",
        "search.memory_constraint=2", "search.min_bsz=1", "search.max_bsz=8",
        "search.bsz_scale=1", "search.time_profile_mode=batch",
        f"search.time_profiling_path={comp}",
        f"search.memory_profiling_path={mem}",
        f"search.allreduce_bandwidth_config_path={hw}/"
        f"allreduce_bandwidth_{tag}.json",
        f"search.p2p_bandwidth_config_path={hw}/p2p_bandwidth_{tag}.json",
        f"search.overlap_coe_path={hw}/overlap_coefficient.json",
        f"search.sp_time_path={hw}/sp_time_{tag}.json",
        f"search.output_config_path={plans}"]
    assert TCS.main(search) == 0
    (plan,) = glob.glob(os.path.join(plans, "galvatron_config_*.json"))
    assert "search done: max throughput" in capsys.readouterr().out
    cfg = json.load(open(plan))
    args = load_config(GPT2, MODEL + TRAIN + [
        "parallel.config_mode=json", f"parallel.galvatron_config_path={plan}",
        "profile.profile=1", "profile.profile_warmup=1"])
    # the launcher's log lines, read from its logger: its stderr handler
    # keeps the stream of the first run in the process
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger, handler = logging.getLogger("hetu_galvatron_tpu_torch"), Lines()
    logger.addHandler(handler)
    try:
        out = train_dist.train(args)
    finally:
        logger.removeHandler(handler)
    assert len(out["losses"]) == 3
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    assert out["batch_sizes"] == [cfg["global_bsz"]] * 3
    assert out["predicted_time_cost_ms"] == cfg["predicted_time_cost_ms"]
    log = "\n".join(lines)
    assert "searched plan: predicted step" in log and "measured" in log
    assert f"searched plan {plan}" in log
    # below the context reserve no plan fits: exit 1
    assert TCS.main(search[:-1] + ["search.memory_constraint=1",
                                   f"search.output_config_path={plans}2"]
                    ) == 1
    # the search for a world at a settled batch, which overrides
    # search.settle_bsz
    args = load_config(GPT2, search[1:-1] + [
        "search.settle_bsz=2", "parallel.global_train_batch_size=4"],
        mode="search")
    notes = []
    path = TCS.search_plan_for_world(args, 1, str(tmp_path / "w1"),
                                     log=notes.append)
    assert json.load(open(path))["global_bsz"] == 4
    assert "ignoring search.settle_bsz=2" in notes[0]


@pytest.mark.parametrize("case", ["mixed", "zero3", "t5"])
def test_torch_json_plan_matches_jax_hybrid_config(case, tmp_path):
    if case == "t5":
        over = dict(checkpoint="1,0,0,1,1", num_encoder_layers=2)
        path = _plan(tmp_path, n=5, **over)
        argv = [T5, "model.num_hidden_layers=3",
                "model.num_encoder_layers=2",
                "parallel.config_mode=json",
                f"parallel.galvatron_config_path={path}"]
    else:
        over = (dict(checkpoint="1,0,1,1") if case == "mixed" else dict(
            dp_types_enc="1,0,1,0", default_dp_type="zero2",
            checkpoint="0,0,0,1", embed_sdp=1, global_bsz=6, chunks=3))
        path = _plan(tmp_path, **over)
        argv = [GPT2, "model.num_hidden_layers=4",
                f"parallel.galvatron_config_path={path}"]
    ours = TH.get_hybrid_parallel_config(load_config(argv[0], argv[1:]), 1)
    theirs = JH.get_hybrid_parallel_config(JA.load_config(argv[0], argv[1:]),
                                           1)
    assert ours.checkpoint_flags == [s.checkpoint for s in theirs.layers]
    assert (ours.global_bsz, ours.chunks, ours.num_encoder_layers) == (
        theirs.global_bsz, theirs.chunks, theirs.num_encoder_layers)
    assert ours.enc_flags == [s.checkpoint for s in theirs.enc_strategies]
    assert TK._plan_fingerprint(ours) == JK._plan_fingerprint(theirs)
    assert ours.plan_path == path and "searched plan" in ours.describe()


def test_torch_json_plan_with_equal_flags_trains_as_global_mode(tmp_path):
    """All-remat and no-remat plans against GLOBAL mode at the same batch,
    chunks and global_checkpoint: the same losses and parameters, bit for
    bit (the plan changes nothing but where the flags come from)."""
    for flag in (0, 1):
        path = _plan(tmp_path, n=2, name=f"p{flag}.json",
                     checkpoint=f"{flag},{flag}", dp_types_enc="1,1",
                     global_bsz=4, chunks=2)
        runs = []
        for mode in (["parallel.config_mode=json",
                      f"parallel.galvatron_config_path={path}"],
                     [f"parallel.global_checkpoint={flag}",
                      "parallel.global_train_batch_size=4",
                      "parallel.chunks=2"]):
            args = load_config(GPT2, MODEL + TRAIN + [
                "model.num_hidden_layers=2", *mode])
            runs.append(train_dist.train(args))
        (a, b) = runs
        assert a["losses"] == b["losses"]
        for (na, ta), (nb, tb) in zip(named_leaves(a["params"]),
                                      named_leaves(b["params"])):
            assert na == nb and torch.equal(ta, tb), na


WIDE = [
    # a pipeline runs one rank a stage, at a world of pp_deg: at world 1
    # a pp=2 plan, interleaved or not, is refused by its world
    (dict(pp_deg=2, pp_division="1,1"), "world size 1 with pp_deg=2"),
    ("spmd_tp2zero3", "tp_sizes_enc: layer 0 has 2"),
    (dict(cp_sizes_enc="1,2"), "cp_sizes_enc: layer 1 has 2"),
    (dict(use_sp="0,1"), "use_sp: layer 1 has 1"),
    (dict(ep_sizes_enc="2,1"), "ep_sizes_enc: layer 0 has 2"),
    (dict(tp_of_ep_sizes_enc="1,2"), "tp_of_ep_sizes_enc: layer 1 has 2"),
    (dict(vtp=2), "vtp=2"), (dict(vsp=1), "vsp=1"), (dict(vcp=2), "vcp=2"),
    (dict(pp_deg=2, vpp_deg=2, pp_division="1,1,1,1"),
     "world size 1 with pp_deg=2"), (dict(hier_dp=1), "hier_dp=1"),
]
WIDE_IDS = ["pp_deg=2", "tp_sizes_enc", "cp_sizes_enc", "use_sp",
            "ep_sizes_enc", "tp_of_ep_sizes_enc", "vtp=2", "vsp=1", "vcp=2",
            "vpp_deg=2", "hier_dp=1"]


@pytest.mark.parametrize("plan,field", WIDE, ids=WIDE_IDS)
def test_torch_plans_wider_than_one_device_are_refused(plan, field,
                                                       tmp_path):
    if isinstance(plan, str):
        path = os.path.join(EXAMPLES, f"galvatron_config_{plan}.json")
    else:
        path = _plan(tmp_path, n=2, **plan)
    args = load_config(GPT2, MODEL + ["model.num_hidden_layers=2",
                                      "parallel.config_mode=json",
                                      f"parallel.galvatron_config_path={path}"])
    with pytest.raises(NotImplementedError) as err:
        TH.get_hybrid_parallel_config(args, 1)
    # refused by its ROADMAP item, or (a pp=1 plan of tp or vtp, which the
    # SPMD step runs) by a world of one rank, naming the launcher
    assert field in str(err.value) and (
        "ROADMAP item" in str(err.value)
        or "torch.distributed.run" in str(err.value))


def test_torch_json_plan_errors_name_the_problem(tmp_path):
    args = load_config(GPT2, MODEL + ["parallel.config_mode=json"])
    with pytest.raises(PlanFormatError, match="galvatron_config_path"):
        TH.get_hybrid_parallel_config(args, 1)
    path = _plan(tmp_path, n=3)
    args = load_config(GPT2, MODEL + [f"parallel.galvatron_config_path={path}"])
    with pytest.raises(ValueError, match="plan has 3 layers, model has 4"):
        TH.get_hybrid_parallel_config(args, 1)
    pipe = _plan(tmp_path, n=4, name="pp2.json", pp_deg=2,
                 pp_division="2,2")
    args = load_config(GPT2, MODEL + [f"parallel.galvatron_config_path="
                                      f"{pipe}"])
    with pytest.raises(NotImplementedError, match="world size 4"):
        TH.get_hybrid_parallel_config(args, 4)


def test_torch_search_refuses_the_calibration_feed(tmp_path):
    argv = [GPT2, *MODEL, f"observability.calibration_dir={tmp_path}"]
    with pytest.raises(NotImplementedError, match="calibration_dir.*"
                       "ROADMAP item 10"):
        TCS.main(argv)
    args = load_config(GPT2, MODEL + ["search.use_calibrated=0",
                                      f"observability.calibration_dir="
                                      f"{tmp_path}"], mode="search")
    assert TCS.feed_calibrated_profile(args, 1) is False
