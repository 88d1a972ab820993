"""Fault drills through the port's ``cli/train_dist.train`` on a tiny model,
on the CPU, mirroring the JAX package's ``tests/core/test_fault_tolerance.
py``: a real SIGTERM at a step boundary, an injected crash, a NaN the
rerun machine attributes (exit 16) or finds persistent (exit 17), and a
crash between a save's write and its commit. Every resumed trajectory and
the final parameters must equal the uninterrupted run's bit for bit, and
the losses must match the JAX trainer's on the same config and bridged
weights within 1e-5 relative (``tests/test_torch_train.py``'s tolerance;
only summation order differs)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core import arguments as JA
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.runtime import dataloader as JD
from hetu_galvatron_tpu.runtime import optimizer as JO
from hetu_galvatron_tpu.runtime import trainer as JT
from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models.builder import named_leaves
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_from_jax
from hetu_galvatron_tpu_torch.runtime.rerun_machine import InjectedCrash
from hetu_galvatron_tpu_torch.runtime.supervisor import run_with_restarts
from hetu_galvatron_tpu_torch.utils import retrying

GPT2 = os.path.join(os.path.dirname(__file__), "..", "hetu_galvatron_tpu",
                    "models", "configs", "gpt2-small.yaml")
TINY = ["model.hidden_size=32", "model.num_hidden_layers=2",
        "model.num_attention_heads=2", "model.vocab_size=64",
        "model.seq_length=8", "model.max_position_embeddings=16",
        "model.make_vocab_size_divisible_by=1", "train.train_iters=6",
        "parallel.mixed_precision=fp32", "parallel.global_train_batch_size=8",
        "logging.log_interval=100"]


def _args(extra):
    return args_from_cli([GPT2, "device=cpu", *TINY, *extra],
                         mode="train_dist")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: torch's multi-threaded CPU kernels are not
    bit-reproducible from run to run (two identical runs of a wider model
    differ in their last bits), while the card's are; and a tiny model runs
    faster on one thread than on a pool contending with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer on the tiny config: its initial weights (the init
    JAX's train_dist draws from train.seed) and 6 losses over its own
    loader's batches."""
    jargs = JA.args_from_cli([GPT2, *TINY], mode="train_dist")
    jparams, _ = JB.init_causal_lm(jax.random.key(jargs.train.seed),
                                   jargs.model)
    init = jax.tree.map(np.asarray, jparams)
    tx = JO.make_optimizer(jargs.train)
    step = jax.jit(JT.make_train_step(
        JT.make_loss_fn(jargs.model, compute_dtype=jnp.float32), tx))
    opt = tx.init(jparams)
    it = JD.get_data_iterator(jargs, split="train")
    losses = []
    for _ in range(6):
        jparams, opt, m = step(jparams, opt,
                               jax.tree.map(jnp.asarray, next(it)))
        losses.append(float(m["loss"]))
    return {"init": init, "losses": losses}


@pytest.fixture()
def bridged(jax_run, monkeypatch):
    """Every port attempt starts from the JAX initial weights."""
    monkeypatch.setattr(TB, "init_causal_lm",
                        lambda cfg, seed, device: params_from_jax(
                            jax_run["init"]))


@pytest.fixture()
def baseline(bridged):
    out = train_dist.train(_args([]))
    return {"losses": out["losses"], "params": out["params"]}


def supervised_train(args):
    """main()'s in-process auto-restart, inlined to keep every attempt."""
    outs = []

    def attempt():
        if args.ckpt.save and not args.ckpt.load:
            args.ckpt.load = args.ckpt.save
        out = train_dist.train(args)
        outs.append(out)
        return out.get("exit_code") or 0

    rc = run_with_restarts(attempt, max_restarts=3, base_delay=0.0,
                           sleep=lambda s: None, log=lambda m: None)
    return rc, outs


def _assert_params_equal(a, b):
    for (n, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        assert torch.equal(x.detach(), y.detach()), n


def test_torch_baseline_matches_the_jax_trainer(jax_run, baseline):
    np.testing.assert_allclose(baseline["losses"], jax_run["losses"],
                               rtol=1e-5)


def test_torch_sigterm_drill_resumes_step_for_step(tmp_path, jax_run,
                                                   baseline):
    """A REAL SIGTERM at iter 2 checkpoints at the step boundary, exits 18,
    and the resumed run reproduces the uninterrupted trajectory and final
    parameters exactly."""
    rc, outs = supervised_train(_args([
        f"ckpt.save={tmp_path}", "rerun.inject_kind=preempt",
        "rerun.inject_at_iter=2"]))
    assert rc == 0
    assert [o["exit_code"] for o in outs] == [18, None]
    assert [len(o["losses"]) for o in outs] == [3, 3]
    assert [o["start_iter"] for o in outs] == [0, 3]
    stitched = outs[0]["losses"] + outs[1]["losses"]
    assert stitched == baseline["losses"]
    _assert_params_equal(outs[1]["params"], baseline["params"])
    np.testing.assert_allclose(stitched, jax_run["losses"], rtol=1e-5)
    assert outs[0]["checkpoint"]["saves"][-1]["step"] == 3
    assert outs[1]["checkpoint"]["load"]["step"] == 3


def test_torch_crash_drill_restarts_from_last_commit(tmp_path, jax_run,
                                                     baseline):
    rc, outs = supervised_train(_args([
        f"ckpt.save={tmp_path}", "ckpt.save_interval=1",
        "rerun.inject_kind=crash", "rerun.inject_at_iter=3"]))
    assert rc == 0
    # the crashed attempt returns nothing; the resumed one re-ran 3..5
    assert len(outs) == 1 and outs[0]["start_iter"] == 3
    assert outs[0]["losses"] == baseline["losses"][3:]
    _assert_params_equal(outs[0]["params"], baseline["params"])
    np.testing.assert_allclose(outs[0]["losses"], jax_run["losses"][3:],
                               rtol=1e-5)
    assert os.path.isdir(tmp_path / "step_3")
    assert TK.latest_checkpoint(str(tmp_path)).endswith("step_6")


def test_torch_main_auto_restart_cli(tmp_path, capsys, bridged):
    rc = train_dist.main([GPT2, "device=cpu", *TINY,
                          f"ckpt.save={tmp_path}",
                          "supervisor.auto_restart=true",
                          "supervisor.backoff_base_s=0.0",
                          "rerun.inject_kind=preempt",
                          "rerun.inject_at_iter=1"])
    assert rc == 0
    assert "training done" in capsys.readouterr().out


def test_torch_nan_drill_exits_16_and_resumes(tmp_path, jax_run, baseline):
    """A transient NaN: the rerun machine re-runs the step on the
    untouched leaves, gets a clean loss, saves the PRE-fault state at step
    2 and exits 16; the relaunch re-runs iter 2 and finishes on the
    uninterrupted trajectory, carrying the fault history."""
    rc, outs = supervised_train(_args([
        f"ckpt.save={tmp_path}", "rerun.enable=true",
        "rerun.mode=validate_results", "rerun.inject_kind=nan",
        "rerun.inject_at_iter=2"]))
    assert rc == 0
    assert [o["exit_code"] for o in outs] == [16, None]
    assert outs[0]["rerun"]["transient"] == 1
    assert outs[1]["rerun"]["transient"] == 1  # full-state resume
    assert outs[1]["start_iter"] == 2 and len(outs[1]["losses"]) == 4
    first = outs[0]["losses"]
    assert np.isnan(first[2]) and first[:2] == baseline["losses"][:2]
    assert outs[1]["losses"] == baseline["losses"][2:]
    _assert_params_equal(outs[1]["params"], baseline["params"])
    np.testing.assert_allclose(first[:2] + outs[1]["losses"],
                               jax_run["losses"], rtol=1e-5)
    meta = TK.read_checkpoint_meta(str(tmp_path / "step_2"))
    assert meta["train_state"]["batches_consumed"] == 2


@pytest.mark.parametrize("extra,code,at", [
    # the re-run reproduces the fault: persistent, terminal
    (["rerun.error_injection_rate=1.0",
      "rerun.error_injection_type=persistent_error"], 17, 0),
    # a spike (over the loss EMA) the re-run clears: transient
    (["rerun.inject_kind=spike", "rerun.inject_at_iter=2"], 16, 2),
])
def test_torch_rerun_exit_codes(tmp_path, bridged, extra, code, at):
    args = _args([f"ckpt.save={tmp_path}", "rerun.enable=true",
                  "rerun.mode=validate_results", *extra])
    out = train_dist.train(args)
    assert out["exit_code"] == code
    assert len(out["losses"]) == at + 1
    # the state before the faulty iteration is on disk at its step
    assert TK.latest_checkpoint(str(tmp_path)).endswith(f"step_{at}")
    rc, _ = supervised_train(_args([f"ckpt.save={tmp_path}/sup",
                                    "rerun.enable=true",
                                    "rerun.mode=validate_results", *extra]))
    assert rc == (17 if code == 17 else 0)


def test_torch_report_stats_mode_reruns_every_step(bridged, baseline):
    out = train_dist.train(_args(["rerun.enable=true",
                                  "rerun.mode=report_stats"]))
    assert out["exit_code"] is None
    assert out["losses"] == baseline["losses"]
    det = out["rerun"]["determinism"]
    assert det["checked"] == 6 and det["mismatches"] == 0


def test_torch_crash_mid_save_never_selectable(tmp_path, monkeypatch,
                                               baseline):
    """A crash between the save of step_4 and its commit: the staging dir
    is never selected, the restart resumes from step_2, sweeps the torn
    dir with its own save of step_4, and ends on the baseline."""
    real_commit = TK._commit
    fired = []

    def exploding_commit(tmp_dir, final_dir):
        if final_dir.endswith("step_4") and not fired:
            fired.append(tmp_dir)
            raise RuntimeError("simulated crash between write and commit")
        real_commit(tmp_dir, final_dir)

    monkeypatch.setattr(TK, "_commit", exploding_commit)
    rc, outs = supervised_train(_args([f"ckpt.save={tmp_path}",
                                       "ckpt.save_interval=2"]))
    assert rc == 0 and fired
    assert len(outs) == 1 and outs[0]["start_iter"] == 2
    assert outs[0]["checkpoint"]["load"]["dir"].endswith("step_2")
    assert outs[0]["losses"] == baseline["losses"][2:]
    _assert_params_equal(outs[0]["params"], baseline["params"])
    assert not [e for e in os.listdir(tmp_path) if e.endswith(".tmp")]


def test_torch_resume_refuses_another_world(tmp_path, bridged):
    d = TK.save_checkpoint(str(tmp_path), 2, {"w": torch.zeros(1)})
    meta = TK.read_checkpoint_meta(d)
    meta["hybrid_parallel_config"] = {"world_size": 8}
    TK.ckpt_paths.atomic_write_json(os.path.join(d, "meta.json"), meta)
    with pytest.raises(TK.WorldSizeMismatchError, match="elastic"):
        train_dist.train(_args([f"ckpt.load={tmp_path}"]))
    # a failed resume leaves no chaos I/O injector installed behind it
    with pytest.raises(TK.WorldSizeMismatchError):
        train_dist.train(_args([f"ckpt.load={tmp_path}", "chaos.enable=true",
                                "chaos.plan=io_error@99",
                                f"chaos.state_dir={tmp_path}/chaos"]))
    assert retrying._FAULT_INJECTOR is None


def test_torch_resume_past_the_last_step_trains_nothing(tmp_path, bridged,
                                                        capsys):
    args = _args([f"ckpt.save={tmp_path}", "ckpt.save_interval=3"])
    assert train_dist._finish(train_dist.train(args)) == 0
    args.ckpt.load = str(tmp_path)
    out = train_dist.train(args)
    assert out["start_iter"] == 6 and out["losses"] == []
    assert train_dist._finish(out) == 0
    assert "0 iters" in capsys.readouterr().out


def test_torch_dropout_run_resumes_bit_for_bit(tmp_path, bridged):
    """The dropout streams come from (seed, it), so a resumed run draws the
    masks the uninterrupted run drew."""
    drop = ["model.hidden_dropout=0.1", "model.attention_dropout=0.1"]
    want = train_dist.train(_args(drop))["losses"]
    rc, outs = supervised_train(_args(drop + [
        f"ckpt.save={tmp_path}", "rerun.inject_kind=preempt",
        "rerun.inject_at_iter=3"]))
    assert rc == 0
    assert outs[0]["losses"] + outs[1]["losses"] == want


def test_torch_injected_crash_propagates_without_restarts(tmp_path, bridged):
    with pytest.raises(InjectedCrash, match="iteration 1"):
        train_dist.train(_args(["rerun.inject_kind=crash",
                                "rerun.inject_at_iter=1"]))
