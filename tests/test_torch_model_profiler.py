"""The port's profilers (``core/profiler/model_profiler.py``,
``hardware_profiler.py``) against the JAX package's. The same fake
measurements go into both model profilers (each class's two measuring
methods replaced, in this test only): the computation JSON in static,
batch and sequence modes and the memory JSON must be equal, byte for byte
as written, ``parameter_size`` included (both packages count their own
parameters). A real CPU run of the port's profiler on a tiny model writes
files the port's search reads. The world-1 hardware files equal JAX's on
one CPU device, and a world above 1 raises."""

import json
import os

import jax
import pytest

from hetu_galvatron_tpu.core import args_schema as JS
from hetu_galvatron_tpu.core.profiler.hardware_profiler import (
    HardwareProfiler as JHardwareProfiler,
)
from hetu_galvatron_tpu.core.profiler.model_profiler import (
    ModelProfiler as JModelProfiler,
)
from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs
from hetu_galvatron_tpu_torch.core.args_schema import HardwareProfileArgs
from hetu_galvatron_tpu_torch.core.profiler.hardware_profiler import (
    HardwareProfiler,
)
from hetu_galvatron_tpu_torch.core.profiler.model_profiler import (
    ModelProfiler,
)
from hetu_galvatron_tpu_torch.core.search_engine import profiles as TP
from hetu_galvatron_tpu_torch.models.builder import (
    init_causal_lm,
    named_leaves,
)

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            vocab_size=64, max_position_embeddings=64, seq_length=16,
            make_vocab_size_divisible_by=1)
QWEN_TINY = dict(TINY, model_type="llama", normalization="rmsnorm",
                 position_embedding_type="rope", hidden_act="swiglu",
                 num_key_value_heads=1, ffn_hidden_size=48,
                 tie_word_embeddings=False, add_bias_linear=False,
                 add_qkv_bias=True)
MOE_TINY = dict(QWEN_TINY, model_type="moe", num_experts=4, moe_topk=2,
                moe_layer_freq=2)
PROFILE = dict(profile_batch_size=2, profile_seq_length_list=[16, 32],
               profile_min_batch_size=1, profile_max_batch_size=8,
               profile_min_seq_length=16, profile_max_seq_length=64,
               profile_seq_length_step=16, layernum_min=1, layernum_max=3)


def fake_forward_ms(self, cfg, bsz, warmup=2, iters=None):
    """Linear in layers and batch, with one grid point where the extra
    layers run faster (the per-layer clamp) and one where the short model
    exceeds n_min layers' share (the other's clamp)."""
    n, s = cfg.num_hidden_layers, cfg.seq_length
    if bsz == 5:
        return 40.0 if n == 1 else 10.0
    if bsz == 7:
        return 0.1 * n if n == 1 else 50.0 * n
    return 0.37 * n * bsz * s / 16 + 1.3 * bsz + 0.011 * s


def fake_step_memory_mb(self, cfg, bsz, tp, checkpoint):
    n = cfg.num_hidden_layers
    temps = (0.75 if checkpoint else 3.5) * n * bsz / tp + 7.25 * bsz
    return {"arguments": 11.0, "outputs": 0.0, "temps": temps,
            "total": temps + 11.0}


def _profilers(monkeypatch, model, prof):
    monkeypatch.setattr(JModelProfiler, "_forward_ms", fake_forward_ms)
    monkeypatch.setattr(JModelProfiler, "_step_memory_mb",
                        fake_step_memory_mb)
    monkeypatch.setattr(ModelProfiler, "_forward_ms", fake_forward_ms)
    monkeypatch.setattr(ModelProfiler, "_step_memory_mb",
                        fake_step_memory_mb)
    tree = {"model": dict(model), "model_profiler": dict(prof)}
    ours = ModelProfiler(CoreArgs.from_tree(dict(tree, device="cpu")))
    theirs = JModelProfiler(JS.CoreArgs.model_validate(tree),
                            devices=jax.devices()[:1])
    return ours, theirs


def _written(profiler, tmp):
    paths = profiler.run(str(tmp))
    (path,) = paths.values()
    with open(path) as f:
        return os.path.basename(path), f.read()


@pytest.mark.parametrize("mode", ["static", "batch", "sequence"])
def test_torch_computation_profile_matches_jax(mode, monkeypatch, tmp_path):
    ours, theirs = _profilers(monkeypatch, TINY, dict(
        PROFILE, profile_type="computation", profile_mode=mode))
    got = _written(ours, tmp_path / "t")
    assert got == _written(theirs, tmp_path / "j")
    entries = json.loads(got[1])
    assert len(entries) == {"static": 4, "batch": 16, "sequence": 8}[mode]
    if mode == "batch":
        assert entries["layertype_0_bsz5_seq16"] == 0.0
        assert entries["layertype_other_bsz7_seq16"] == 0.0


@pytest.mark.parametrize("model", [TINY, QWEN_TINY, MOE_TINY],
                         ids=["gpt", "qwen", "moe"])
def test_torch_memory_profile_matches_jax(model, monkeypatch, tmp_path):
    ours, theirs = _profilers(monkeypatch, model, dict(
        PROFILE, profile_type="memory"))
    got = _written(ours, tmp_path / "t")
    assert got == _written(theirs, tmp_path / "j")
    layer = json.loads(got[1])["layertype_0_sp"]["16"]
    assert layer["parameter_size"] > 0
    assert set(layer["tp_activation_per_bsz_dict"]) == {"1", "checkpoint"}


def test_torch_profiler_on_the_cpu_writes_files_the_search_reads(tmp_path):
    """A real CPU run at a tiny size: batch-mode computation and the memory
    step, read back by the port's profile readers."""
    tree = {"device": "cpu", "model": dict(TINY, num_hidden_layers=4),
            "model_profiler": dict(PROFILE, profile_mode="batch",
                                   profile_batch_size=1,
                                   profile_seq_length_list=[16],
                                   layernum_min=2, layernum_max=4)}
    comp = ModelProfiler(CoreArgs.from_tree(dict(tree, model_profiler=dict(
        tree["model_profiler"], profile_type="computation")))).run(
        str(tmp_path))
    mem = ModelProfiler(CoreArgs.from_tree(dict(tree, model_profiler=dict(
        tree["model_profiler"], profile_type="memory")))).run(str(tmp_path))
    prof = TP.load_model_profile(
        time_path=comp["computation"], memory_path=mem["memory"],
        time_mode="batch", memory_mode="static", num_layertype=1,
        seqlen_list=[16], sequence_parallel=True)
    assert len(prof.time_profiled_list[0]) == 2  # the linear fit
    one = init_causal_lm(CoreArgs.from_tree(tree).model)["layers"][0]
    assert prof.param_sizes[0] == sum(
        t.numel() for _, t in named_leaves(one)) * 4 / 2 ** 20
    assert prof.act_sizes[0][1] > 0
    assert prof.other_memory_pp_off["model_states"][1] > 0


def test_torch_memory_step_counts_saved_activations_on_the_cpu():
    args = CoreArgs.from_tree({"device": "cpu", "model": TINY})
    prof = ModelProfiler(args)
    cfg = prof._cfg(2, 16)
    plain = prof._step_memory_mb(cfg, 2, 1, False)
    remat = prof._step_memory_mb(cfg, 2, 1, True)
    assert set(plain) == {"arguments", "outputs", "temps", "total", "peak"}
    # the forward saves activations for the backward; remat keeps fewer;
    # the step's peak adds the gradients (params, mu and nu are the
    # arguments: three fp32 copies)
    grads = plain["arguments"] / 3
    assert plain["temps"] > remat["temps"] > 0
    assert plain["peak"] == pytest.approx(plain["temps"] + grads)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        prof._step_memory_mb(cfg, 2, 2, False)


@pytest.mark.parametrize("devices_per_node", [1, 8])
def test_torch_world1_hardware_files_equal_jax(devices_per_node, tmp_path):
    kw = dict(num_devices_per_node=devices_per_node, start_mb=1, end_mb=4,
              warmup_iters=1, profile_iters=1)
    ours = HardwareProfiler(HardwareProfileArgs(**kw), devices=1).run_all(
        str(tmp_path / "t"))
    theirs = JHardwareProfiler(JS.HardwareProfileArgs(**kw),
                               devices=jax.devices()[:1]).run_all(
        str(tmp_path / "j"))
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        with open(ours[name]) as f, open(theirs[name]) as g:
            assert f.read() == g.read()
    with open(ours["overlap_coefficient.json"]) as f:
        assert json.load(f) == {"overlap_coe": 1.0}


def test_torch_hardware_profiler_above_world1_raises():
    args = HardwareProfileArgs(num_devices_per_node=8)
    with pytest.raises(NotImplementedError, match="world size 4.*ROADMAP "
                       "item 10"):
        HardwareProfiler(args, devices=4)
    prof = HardwareProfiler(args, devices=1)
    with pytest.raises(NotImplementedError, match="NCCL"):
        prof._collective_ms("allreduce", [0, 1], 1.0)
