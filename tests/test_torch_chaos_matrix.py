"""The chaos matrix through the port's training loop, mirroring the seven
cases of the JAX package's ``tools/chaos_drill.py``: crash, preempt,
kill_mid_save, corrupt_meta, transient_io, hung_save and budget. Each
fault fires through ``runtime/chaos.py`` against the real loop and
checkpoint code; each resumed run must end on the uninterrupted run's
losses and parameters bit for bit, and (with the JAX initial weights
bridged over) on the JAX trainer's losses within 1e-5. The in-process
restart loop (``run_with_restarts``) drives the cases a process survives;
``kill_mid_save`` SIGKILLs its process, so it runs under the real
``cli.supervise`` with ``cli.train_dist`` children."""

import json
import os
import subprocess
import sys
import time

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
from hetu_galvatron_tpu_torch.observability import registry as TG
from hetu_galvatron_tpu_torch.runtime import ckpt_paths as TP
from hetu_galvatron_tpu_torch.runtime.chaos import ChaosCrash
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_from_jax
from hetu_galvatron_tpu_torch.runtime.supervisor import run_with_restarts

ROOT = os.path.join(os.path.dirname(__file__), "..")
GPT2 = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs",
                    "gpt2-small.yaml")
TINY = ["device=cpu", "model.hidden_size=32", "model.num_hidden_layers=2",
        "model.num_attention_heads=2", "model.vocab_size=64",
        "model.seq_length=8", "model.max_position_embeddings=16",
        "model.make_vocab_size_divisible_by=1", "train.train_iters=6",
        "parallel.mixed_precision=fp32", "parallel.global_train_batch_size=8",
        "logging.log_interval=100"]


def _args(extra):
    return args_from_cli([GPT2, *TINY, *extra], mode="train_dist")


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
    jargs = JA.args_from_cli([GPT2, *TINY[1:]], mode="train_dist")
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
def registry():
    reg = TG.MetricsRegistry()
    prev = TG.set_registry(reg)
    yield reg
    TG.set_registry(prev)


@pytest.fixture()
def bridged(jax_run, monkeypatch, registry):
    monkeypatch.setattr(TB, "init_causal_lm",
                        lambda cfg, seed, device: params_from_jax(
                            jax_run["init"]))
    monkeypatch.setattr("hetu_galvatron_tpu_torch.utils.retrying."
                        "_default_sleep", lambda s: None)
    out = train_dist.train(_args([]))
    return {"losses": out["losses"], "params": out["params"]}


def _supervised(args, max_restarts=3):
    outs = []

    def attempt():
        if args.ckpt.save and not args.ckpt.load:
            args.ckpt.load = args.ckpt.save
        out = train_dist.train(args)
        outs.append(out)
        return out.get("exit_code") or 0

    rc = run_with_restarts(attempt, max_restarts=max_restarts,
                           base_delay=0.0, sleep=lambda s: None,
                           log=lambda m: None)
    return rc, outs


def _chaos(tmp_path, *extra):
    return _args([f"ckpt.save={tmp_path}", "ckpt.save_interval=2",
                  "chaos.enable=true", *extra])


def _check_tail(outs, base, jax_run, start):
    assert outs[-1]["start_iter"] == start
    assert outs[-1]["losses"] == base["losses"][start:]
    for (n, a), (_, b) in zip(named_leaves(outs[-1]["params"]),
                              named_leaves(base["params"])):
        assert torch.equal(a.detach(), b.detach()), n
    np.testing.assert_allclose(outs[-1]["losses"],
                               jax_run["losses"][start:], rtol=1e-5)


def test_torch_chaos_crash(tmp_path, bridged, jax_run):
    """An unhandled exception at step 3: the restart resumes from step_2
    (the commit at iter 1) and replays 2..5."""
    rc, outs = _supervised(_chaos(tmp_path, "chaos.plan=crash@3"))
    assert rc == 0 and len(outs) == 1
    assert os.path.exists(tmp_path / "CHAOS_FIRED_0_crash")
    _check_tail(outs, bridged, jax_run, 2)


def test_torch_chaos_preempt(tmp_path, bridged, jax_run):
    """A SIGTERM mid-step 3: the step finishes, the interval save of step_4
    covers the boundary, exit 18, and the relaunch finishes 4..5."""
    rc, outs = _supervised(_chaos(tmp_path, "chaos.kind=sigterm",
                                  "chaos.at_iter=3"))
    assert rc == 0
    assert [o["exit_code"] for o in outs] == [18, None]
    assert outs[0]["losses"] + outs[1]["losses"] == bridged["losses"]
    _check_tail(outs, bridged, jax_run, 4)


def test_torch_chaos_corrupt_meta(tmp_path, bridged, jax_run, registry):
    """The newest commit's meta.json is scribbled on, then the run crashes:
    the resume falls back to the previous committed step, never a
    traceback, and still replays bit for bit."""
    rc, outs = _supervised(_chaos(tmp_path,
                                  "chaos.plan=corrupt_meta@4,crash@5"))
    assert rc == 0 and len(outs) == 1
    assert registry.counter("checkpoint/corrupt_fallback").value == 1
    _check_tail(outs, bridged, jax_run, 2)
    # the replay re-saved step_4 over the corrupt one
    assert TP.try_read_meta(str(tmp_path / "step_4"))[1] is None


@pytest.mark.parametrize("kind", ["truncate_meta", "corrupt_meta"])
def test_torch_chaos_meta_fault_alone_leaves_training_intact(tmp_path,
                                                             bridged, kind):
    out = train_dist.train(_chaos(tmp_path, f"chaos.kind={kind}",
                                  "chaos.at_iter=4"))
    assert out["losses"] == bridged["losses"]
    assert os.path.exists(tmp_path / f"CHAOS_FIRED_0_{kind}")


def test_torch_chaos_transient_io(tmp_path, bridged, jax_run, registry):
    """Transient I/O errors on the checkpoint path are absorbed by the
    retry seam (no extra attempt), then a crash resumes bit for bit."""
    rc, outs = _supervised(_chaos(tmp_path, "chaos.plan=crash@3,io_error",
                                  "chaos.io_error_count=2",
                                  "chaos.io_error_op=checkpoint"))
    assert rc == 0 and len(outs) == 1
    assert registry.counter("chaos/injected", kind="io_error").value == 2
    assert registry.counter("retry/attempts",
                            op="checkpoint.write").value == 2
    assert registry.counter("supervisor/restarts",
                            reason="crash").value == 1
    _check_tail(outs, bridged, jax_run, 2)


def test_torch_chaos_hung_save(tmp_path, bridged, registry):
    """A background write hangs past ckpt.save_timeout_s: the watchdog
    counts it, the exit drain abandons it instead of wedging shutdown, and
    training completes on the baseline. (The abandoned daemon writer
    sleeps out its hang after the test, as it would in a process that
    exits.)"""
    t0 = time.monotonic()
    out = train_dist.train(_chaos(
        tmp_path, "chaos.kind=hung_save", "chaos.at_iter=4",
        "chaos.hang_s=60", "ckpt.snapshot_async=true",
        "ckpt.save_timeout_s=0.3"))
    assert time.monotonic() - t0 < 30.0  # did not wait out the hang
    assert out["exit_code"] is None
    assert out["losses"] == bridged["losses"]
    assert registry.counter("checkpoint/hung_saves").value >= 1
    latest = TP.latest_committed_step(str(tmp_path))
    assert latest is not None and latest[0] <= 4


def test_torch_chaos_budget(registry, bridged):
    """A crash loop with no progress (no checkpoints, so no markers and
    the fault re-fires): the restart budget runs out and the crash
    surfaces."""
    args = _args(["chaos.enable=true", "chaos.kind=crash",
                  "chaos.at_iter=1"])
    with pytest.raises(ChaosCrash):
        _supervised(args, max_restarts=2)
    assert registry.counter("supervisor/restarts",
                            reason="crash").value == 2
    assert registry.counter("supervisor/giveups", reason="crash").value == 1


def test_torch_chaos_kill_mid_save(tmp_path):
    """SIGKILL inside the commit window of the step_4 save: the staged
    payload has no COMMITTED marker. The supervisor sees a signal death,
    the relaunch resumes from step_2 (the torn step_4.tmp is never
    selected), replays bit for bit, and its own save sweeps the torn dir."""
    ck, summary = str(tmp_path / "ck"), str(tmp_path / "summary.jsonl")
    base = train_dist.train(_args([]))
    proc = subprocess.run(
        [sys.executable, "-m", "hetu_galvatron_tpu_torch.cli.supervise",
         GPT2, *TINY, f"ckpt.save={ck}", "ckpt.save_interval=2",
         "chaos.enable=true", "chaos.kind=kill_mid_save", "chaos.at_iter=3",
         "supervisor.auto_restart=true", "supervisor.mode=process",
         "supervisor.backoff_base_s=0", "supervisor.poll_interval_s=0.05",
         f"extra.summary_path={summary}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "supervisor: child exit -9;" in out
    kids = [json.loads(line) for line in open(summary)]
    assert len(kids) == 1  # the killed child wrote none
    kid = kids[0]
    assert kid["exit_code"] == 0 and kid["start_iter"] == 2
    assert kid["checkpoint"]["load"]["dir"].endswith(os.sep + "step_2")
    assert kid["losses"] == base["losses"][2:]
    assert kid["param_sha256"] == train_dist.run_summary(
        base, 0)["param_sha256"]
    assert not [e for e in os.listdir(ck) if e.endswith(".tmp")]
    state = json.load(open(os.path.join(ck, "SUPERVISOR_STATE.json")))
    assert state["attempt"] == 2 and state["last_commit_step"] == 6
