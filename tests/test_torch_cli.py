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
from hetu_galvatron_tpu_torch.observability import sinks as TSK
from hetu_galvatron_tpu_torch.ops import _build
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
    _build.reset_launch_counts()
    assert train_dist.main([GPT2, *TINY]) == 0
    out = capsys.readouterr().out
    assert "training done: 3 iters" in out
    assert out.count("iter ") >= 3
    # on the CPU the plain attention core runs: no kernel launches
    assert sum(_build.launch_counts.values()) == 0


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
    "parallel.pp_deg=2", "ckpt.load_format=hf",
    "observability.tensorboard=true", "logging.tensorboard_dir=/tmp/x",
    "logging.wandb_project=x", "profile.trace_dir=/tmp/x",
    "tp_overlap.enable=true", "parallel.hier_dp=true",
    "observability.audit_hardware_config=/tmp/x.json",
    "observability.calibration_dir=/tmp/x",
    "parallel.global_tp_deg=2", "parallel.global_ep_deg=2",
    "parallel.num_devices=2", "parallel.num_processes=2",
    "parallel.config_mode=json", "parallel.sdp=1",
])
def test_torch_train_dist_refuses_flags_outside_the_slice(flag):
    name = flag.split("=")[0]
    with pytest.raises(NotImplementedError) as err:
        train_dist.main([GPT2, *TINY, flag])
    # a trace window with the plan audit on (its default) names the audit
    key = {"parallel.config_mode": "JSON plan", "parallel.sdp": "sdp",
           "parallel.num_processes": "num_processes",
           "profile.trace_dir": "observability.audit"}.get(name, name)
    assert key in str(err.value)


@pytest.mark.parametrize("flag", [
    "observability.flight_dir", "observability.enabled",
    "train.rampup_batch_size=[2,2,8]", "supervisor.metrics_port=0",
])
def test_torch_train_dist_runs_flags_of_the_observability_slice(
        flag, tmp_path, capsys, monkeypatch):
    """Flags the slice refused before the batch-size ramp and
    observability were ported: each now runs a tiny CPU training."""
    extra = {"observability.flight_dir": [f"{flag}={tmp_path}"],
             "observability.enabled": [
                 f"{flag}=true",
                 f"observability.metrics_path={tmp_path / 'm.jsonl'}"],
             # the ramp keeps the micro size global_bsz / chunks = 2
             "train.rampup_batch_size=[2,2,8]": [flag, "parallel.chunks=2"],
             }.get(flag, [flag])
    sinks = []
    init = TSK.JsonlSink.__init__

    def track(self, path):
        init(self, path)
        sinks.append(self)

    monkeypatch.setattr(TSK.JsonlSink, "__init__", track)
    assert train_dist.main([GPT2, *TINY, "train.train_iters=4",
                            *extra]) == 0
    assert "training done: 4 iters" in capsys.readouterr().out
    if flag == "observability.enabled":
        assert (tmp_path / "m.jsonl").stat().st_size > 0
        assert sinks
    # the run closes the stream it opened
    assert all(s._fd is None for s in sinks)


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


QWEN_YAML = os.path.join(os.path.dirname(__file__), "..",
                         "hetu_galvatron_tpu", "models", "configs",
                         "qwen2.5-7b.yaml")
EOD = 151643 % 512  # Qwen's <|endoftext|>, folded into the tiny vocab


def _qwen_path_overrides(prefix):
    """The slice's Qwen2.5 path (fused CE, remat on every layer, packed
    indexed corpus with eod masking) at a tiny width, on the CPU in fp32."""
    return ["model.hidden_size=112", "model.num_hidden_layers=2",
            "model.num_attention_heads=7", "model.num_key_value_heads=1",
            "model.ffn_hidden_size=160", "model.vocab_size=512",
            "model.seq_length=32", "model.max_position_embeddings=64",
            "model.use_fused_ce=true", "parallel.global_checkpoint=1",
            "parallel.mixed_precision=fp32",
            "parallel.global_train_batch_size=2", "train.train_iters=3",
            "train.lr=1e-4", "train.adam_eps=1e-5", "data.dataset=indexed",
            f"data.data_path=[{prefix}]", "data.split=98,1,1",
            "data.reset_position_ids=true", "data.reset_attention_mask=true",
            "data.eod_mask_loss=true"]


def test_torch_train_dist_qwen_path_matches_the_jax_trainer(tmp_path,
                                                           monkeypatch):
    """Three steps of ``train_dist.train(device=cpu)`` against three steps
    of the JAX trainer: the same weights (moved over by params_from_jax),
    the same corpus (written by the JAX writer, read by each package's
    loader), remat on both layers and fused CE (the JAX Pallas kernels in
    interpret mode, the port's plain K4/K5). Losses and every parameter
    agree within 1e-5 relative, with atol 1e-7 (3e-4 of the three steps'
    update at lr 1e-4) for entries near zero, where Adam's m / sqrt(v)
    amplifies the summation-order noise of a cancelling gradient; only
    summation order differs."""
    import json

    import jax
    import jax.numpy as jnp

    from hetu_galvatron_tpu.core import arguments as JA
    from hetu_galvatron_tpu.data.indexed_dataset import write_indexed_dataset
    from hetu_galvatron_tpu.models import builder as JB
    from hetu_galvatron_tpu.runtime import dataloader as JD
    from hetu_galvatron_tpu.runtime import optimizer as JO
    from hetu_galvatron_tpu.runtime import trainer as JT
    from hetu_galvatron_tpu_torch.models import builder as TB
    from hetu_galvatron_tpu_torch.runtime.checkpoint import params_from_jax

    rng = np.random.default_rng(0)
    prefix = str(tmp_path / "corpus")
    write_indexed_dataset(prefix, [
        np.append(rng.integers(0, EOD, rng.integers(4, 40)), EOD)
        for _ in range(300)])
    with open(prefix + ".meta.json", "w") as f:
        json.dump({"vocab_size": 512, "eod_id": EOD}, f)
    over = _qwen_path_overrides(prefix)
    jargs = JA.load_config(QWEN_YAML, over)
    jparams, _ = JB.init_causal_lm(jax.random.key(5), jargs.model)
    npy = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(TB, "init_causal_lm",
                        lambda cfg, seed, device: params_from_jax(npy))
    out = train_dist.train(load_config(QWEN_YAML, ["device=cpu", *over]))

    L = jargs.model.num_hidden_layers
    jtx = JO.make_optimizer(jargs.train)
    jstep = jax.jit(JT.make_train_step(
        JT.make_loss_fn(jargs.model, compute_dtype=jnp.float32,
                        remat_flags=[True] * L), jtx))
    jopt = jtx.init(jparams)
    jit = JD.get_data_iterator(jargs, split="train")
    jlosses = []
    for _ in range(3):
        batch = jax.tree.map(jnp.asarray, next(jit))
        assert {"position_ids", "segment_ids"} <= set(batch)
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
    want = dict(TB.named_leaves(params_from_jax(
        jax.tree.map(np.asarray, jparams))))
    for name, t in TB.named_leaves(out["params"]):
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


MIXTRAL_YAML = os.path.join(os.path.dirname(__file__), "..",
                            "hetu_galvatron_tpu", "models", "configs",
                            "mixtral-8x7b.yaml")
MISTRAL_EOD = 2  # </s>


def test_torch_train_dist_mixtral_path_matches_the_jax_trainer(tmp_path,
                                                              monkeypatch):
    """Three steps of ``train_dist.train(device=cpu)`` on
    ``mixtral-8x7b.yaml`` at a tiny width (8 experts, top-2, capacity
    dispatch, GQA 4:2) over a packed corpus, with fused CE and remat on both
    layers, against three steps of the JAX trainer on the same weights and
    batches. Losses (CE + the MoE aux losses) and every parameter agree
    within 1e-5 relative, atol 1e-7 for entries near zero (as in the Qwen
    path's test); each step logs its per-layer MoE balance."""
    import json

    import jax
    import jax.numpy as jnp

    from hetu_galvatron_tpu.core import arguments as JA
    from hetu_galvatron_tpu.data.indexed_dataset import write_indexed_dataset
    from hetu_galvatron_tpu.models import builder as JB
    from hetu_galvatron_tpu.runtime import dataloader as JD
    from hetu_galvatron_tpu.runtime import optimizer as JO
    from hetu_galvatron_tpu.runtime import trainer as JT
    from hetu_galvatron_tpu_torch.models import builder as TB
    from hetu_galvatron_tpu_torch.runtime.checkpoint import params_from_jax

    rng = np.random.default_rng(1)
    prefix = str(tmp_path / "corpus")
    write_indexed_dataset(prefix, [
        np.append(rng.integers(3, 512, rng.integers(4, 40)), MISTRAL_EOD)
        for _ in range(300)])
    with open(prefix + ".meta.json", "w") as f:
        json.dump({"vocab_size": 512, "eod_id": MISTRAL_EOD}, f)
    over = ["model.hidden_size=64", "model.num_hidden_layers=2",
            "model.num_attention_heads=4", "model.num_key_value_heads=2",
            "model.ffn_hidden_size=96", "model.vocab_size=512",
            "model.seq_length=32", "model.max_position_embeddings=64",
            "model.use_fused_ce=true", "parallel.global_checkpoint=1",
            "parallel.mixed_precision=fp32",
            "parallel.global_train_batch_size=2", "train.train_iters=3",
            "train.lr=1e-4", "train.adam_eps=1e-5", "data.dataset=indexed",
            f"data.data_path=[{prefix}]", "data.split=98,1,1",
            "data.reset_position_ids=true", "data.reset_attention_mask=true",
            "data.eod_mask_loss=true"]
    jargs = JA.load_config(MIXTRAL_YAML, over)
    assert (jargs.model.num_experts, jargs.model.moe_topk,
            jargs.model.moe_dispatcher) == (8, 2, "capacity")
    jparams, _ = JB.init_causal_lm(jax.random.key(9), jargs.model)
    npy = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(TB, "init_causal_lm",
                        lambda cfg, seed, device: params_from_jax(npy))
    logged = []
    out = train_dist.train(load_config(MIXTRAL_YAML, ["device=cpu", *over]),
                           on_step=lambda it, m: logged.append(m["moe"]))

    jtx = JO.make_optimizer(jargs.train)
    jstep = jax.jit(JT.make_train_step(
        JT.make_loss_fn(jargs.model, compute_dtype=jnp.float32,
                        remat_flags=[True, True]), jtx))
    jopt = jtx.init(jparams)
    jit = JD.get_data_iterator(jargs, split="train")
    jlosses = []
    for _ in range(3):
        batch = jax.tree.map(jnp.asarray, next(jit))
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
    want = dict(TB.named_leaves(params_from_jax(
        jax.tree.map(np.asarray, jparams))))
    for name, t in TB.named_leaves(out["params"]):
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert [sorted(m) for m in logged] == [["layer0", "layer1"]] * 3
    for m in logged:
        for st in m.values():
            assert float(st["tokens_per_expert"].sum()) == 2 * 32 * 2
