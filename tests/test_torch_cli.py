"""Port launcher (``hetu_galvatron_tpu_torch.cli.train_dist``), plan and
initialization: a tiny CPU run end to end, and every refusal of a setting
outside the single-device slice."""

import math
import os

import numpy as np
import pytest
import torch

from hetu_galvatron_tpu.runtime import hybrid_config as JH
from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.ops import flash_attention as TF
from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH
from hetu_galvatron_tpu_torch.runtime import initialize as TI

GPT2 = os.path.join(os.path.dirname(__file__), "..", "hetu_galvatron_tpu",
                    "models", "configs", "gpt2-small.yaml")
TINY = ["device=cpu", "model.hidden_size=64", "model.num_hidden_layers=2",
        "model.num_attention_heads=4", "model.vocab_size=128",
        "model.seq_length=16", "model.max_position_embeddings=32",
        "model.make_vocab_size_divisible_by=1", "train.train_iters=3",
        "parallel.mixed_precision=fp32", "parallel.global_train_batch_size=4",
        "train.lr=1e-3"]


def test_torch_train_dist_cpu_smoke(capsys):
    TF.reset_launch_counts()
    assert train_dist.main([GPT2, *TINY]) == 0
    out = capsys.readouterr().out
    assert "training done: 3 iters" in out
    assert out.count("iter ") >= 3
    # on the CPU the plain attention core runs: no kernel launches
    assert sum(TF.launch_counts.values()) == 0


def test_torch_train_dist_returns_finite_decreasing_losses():
    args = load_config(GPT2, TINY + ["train.train_iters=6", "train.lr=5e-3",
                                     "parallel.chunks=2",
                                     "train.eval_interval=3",
                                     "train.eval_iters=1",
                                     "profile.profile=1",
                                     "profile.profile_warmup=1"])
    out = train_dist.train(args)
    losses = out["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    # random-token data: step 0 sits near ln(V) and training moves it down
    assert abs(losses[0] - math.log(128)) < 0.5
    assert losses[-1] < losses[0]
    assert [v["iter"] for v in out["val_losses"]] == [3, 6]
    assert np.isfinite(out["test_loss"]) and out["iter_ms"] > 0


def test_torch_train_dist_calls_on_step_after_every_step():
    seen = []
    out = train_dist.train(load_config(GPT2, TINY),
                           on_step=lambda it, m: seen.append(
                               (it, float(m["loss"]))))
    # one call per step, in order, after the step's loss exists
    assert seen == list(enumerate(out["losses"]))


def test_torch_train_dist_with_dropout_runs_on_cpu():
    args = load_config(GPT2, TINY + ["model.hidden_dropout=0.1",
                                     "model.attention_dropout=0.1",
                                     "parallel.chunks=2"])
    assert all(np.isfinite(train_dist.train(args)["losses"]))


@pytest.mark.parametrize("flag", [
    "parallel.pp_deg=2", "ckpt.save=/tmp/x", "ckpt.load=/tmp/x",
    "rerun.enable=true", "chaos.enable=true", "observability.enabled=true",
    "tp_overlap.enable=true", "parallel.hier_dp=true",
    "train.rampup_batch_size=[2,2,8]", "supervisor.auto_restart=true",
    "model.use_fused_ce=true", "parallel.global_tp_deg=2",
    "parallel.num_devices=2", "parallel.num_processes=2",
    "parallel.config_mode=json", "parallel.sdp=1",
])
def test_torch_train_dist_refuses_flags_outside_the_slice(flag):
    name = flag.split("=")[0]
    with pytest.raises(NotImplementedError) as err:
        train_dist.main([GPT2, *TINY, flag])
    key = {"parallel.config_mode": "JSON plan", "parallel.sdp": "sdp",
           "parallel.num_processes": "num_processes"}.get(name, name)
    assert key in str(err.value)


def test_torch_train_dist_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cuda = [a for a in TINY if a != "device=cpu"]
    with pytest.raises(RuntimeError, match="device=cpu"):
        train_dist.main([GPT2, *cuda])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.resolve_device(load_config(GPT2, cuda))
    assert TI.resolve_device(load_config(GPT2, TINY)).type == "cpu"


def test_torch_attention_overrides_choose_flash_only_on_cuda():
    cfg = load_config(GPT2, TINY).model
    assert train_dist.attention_overrides(cfg, torch.device("cpu")) == {}
    over = train_dist.attention_overrides(cfg, torch.device("cuda", 0))
    assert sorted(over) == [0, 1]
    assert all(o["sdpa_fn"] is TF.flash_sdpa for o in over.values())
    cfg.use_flash_attn = False
    assert train_dist.attention_overrides(cfg, torch.device("cuda", 0)) == {}


def test_torch_resolve_chunks_matches_jax():
    for chunks in (-1, 0, 1, 3):
        for pp in (1, 2, 4):
            for bsz in (4, 8, 30):
                for world in (1, 4, 8):
                    assert TH.resolve_chunks(chunks, pp, bsz, world) == \
                        JH.resolve_chunks(chunks, pp, bsz, world)


def test_torch_hybrid_config_single_device_plan():
    hpc = TH.get_hybrid_parallel_config(
        load_config(GPT2, TINY + ["parallel.chunks=2"]), 1)
    assert (hpc.pp_deg, hpc.chunks, hpc.global_bsz) == (1, 2, 4)
    with pytest.raises(NotImplementedError, match="world size"):
        TH.get_hybrid_parallel_config(load_config(GPT2, TINY), 2)
    with pytest.raises(ValueError, match="divisible"):
        TH.get_hybrid_parallel_config(
            load_config(GPT2, TINY + ["parallel.chunks=3"]), 1)
