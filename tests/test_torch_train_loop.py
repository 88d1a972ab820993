"""The port's ``runtime/trainer.train_loop`` and the batch-size ramp of
``cli/train_dist.py`` against the JAX package, on tiny GPT-2 models in
fp32 on the CPU: the same weights (moved over by ``params_from_jax``),
the same batches. Losses agree within 1e-5 relative (only summation
order differs); the ramp's batch sizes, consumed samples, hook calls,
cadence saves and preemption stops are exact; a resume inside the ramp
repeats the uninterrupted run bit for bit. Last, ``cli.supervise`` with
its ``/healthz`` endpoint and the flight recorder over real CPU
children."""

import glob
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
GPT2 = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs",
                    "gpt2-small.yaml")
TINY = ["model.hidden_size=32", "model.num_hidden_layers=2",
        "model.num_attention_heads=2", "model.vocab_size=64",
        "model.seq_length=16", "model.max_position_embeddings=16",
        "model.make_vocab_size_divisible_by=1", "model.ffn_hidden_size=64",
        "parallel.mixed_precision=fp32", "train.lr=1e-3",
        "train.lr_decay_iters=8", "parallel.num_devices=1"]


def _jax_params(jcfg, seed):
    import jax

    from hetu_galvatron_tpu.models import builder as JB

    jparams, _ = JB.init_causal_lm(jax.random.key(seed), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


class _StopAfter:
    """A preemption flag that turns true at its ``n``-th poll."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    def requested(self):
        self.polls += 1
        return self.polls >= self.n


def test_torch_train_loop_matches_jax(tmp_path):
    """Five of six steps (a preemption at the step boundary after the
    fifth): the same losses, hook calls, goodput categories and cadence
    saves as JAX's ``train_loop``."""
    from hetu_galvatron_tpu.core import arguments as JA
    from hetu_galvatron_tpu.observability.goodput import (
        GoodputTracker as JGoodput,
    )
    from hetu_galvatron_tpu.runtime import checkpoint as JK
    from hetu_galvatron_tpu.runtime import trainer as JT
    from hetu_galvatron_tpu_torch.observability.goodput import GoodputTracker
    from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
    from hetu_galvatron_tpu_torch.runtime import trainer as TT

    over = TINY + ["train.train_iters=6", "parallel.chunks=2",
                   "parallel.global_train_batch_size=4",
                   "ckpt.save_interval=2"]
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(6):
        seqs = rng.integers(0, 64, (4, 17)).astype(np.int32)
        batches.append({"tokens": seqs[:, :-1], "labels": seqs[:, 1:]})
    runs = {}
    for pkg in ("jax", "torch"):
        ck = str(tmp_path / pkg)
        if pkg == "jax":
            args = JA.load_config(GPT2, over + [f"ckpt.save={ck}"])
            params, _ = _jax_params(args.model, 0)
            gp = JGoodput()
            cadence = JK.CheckpointCadence(args.ckpt, goodput=gp,
                                           log=lambda m: None)
            loop = JT.train_loop
        else:
            args = load_config(GPT2, ["device=cpu", *over, f"ckpt.save={ck}"])
            params = params_from_jax(_jax_params(args.model, 0)[1])
            gp = GoodputTracker()
            cadence = TK.CheckpointCadence(args.ckpt, goodput=gp,
                                           log=lambda m: None)
            loop = TT.train_loop
        calls = []
        stop = _StopAfter(5)
        _, _, losses = loop(args, params, iter(batches),
                            hooks=(lambda it, m: calls.append(it),),
                            preemption=stop, goodput=gp, checkpoint=cadence)
        runs[pkg] = dict(losses=losses, calls=calls, polls=stop.polls,
                         steps=sorted(os.listdir(ck)),
                         booked={k for k, v in gp.totals.items() if v > 0})
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    assert len(t["losses"]) == 5 and t["calls"] == j["calls"] == list(
        range(5))
    assert t["polls"] == j["polls"] == 5
    assert [s for s in t["steps"] if s.startswith("step_")] == [
        s for s in j["steps"] if s.startswith("step_")] == [
        "step_2", "step_4"]
    assert t["booked"] == j["booked"] == {"productive_step", "recompile",
                                          "checkpoint_save"}


def test_torch_train_loop_owns_its_telemetry(tmp_path):
    """``observability.enabled`` and no instance: the loop builds the
    telemetry, hands it the in-flight metrics and closes it; the stream
    holds the loop's spans and the telemetry's gauges."""
    from hetu_galvatron_tpu_torch.observability.registry import (
        get_registry,
        set_registry,
    )
    from hetu_galvatron_tpu_torch.runtime import trainer as TT

    stream = tmp_path / "m.jsonl"
    args = load_config(GPT2, ["device=cpu", *TINY, "train.train_iters=3",
                              "parallel.global_train_batch_size=2",
                              "observability.enabled=true",
                              f"observability.metrics_path={stream}"])
    params = TB.init_causal_lm(args.model, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    data = iter([{"tokens": rng.integers(0, 64, (2, 16)),
                  "labels": rng.integers(0, 64, (2, 16))}
                 for _ in range(3)])
    prev = get_registry()
    try:
        _, _, losses = TT.train_loop(args, params, data)
    finally:
        set_registry(prev)
    assert len(losses) == 3 and all(map(np.isfinite, losses))
    recs = [json.loads(l) for l in open(stream)]
    names = {r["name"] for r in recs}
    assert {"train/loss", "train/tokens_per_sec", "span_ms"} <= names
    spans = {r["labels"]["path"] for r in recs if r["name"] == "span_ms"}
    assert spans == {"train/fetch", "train/step"}
    loss = [r for r in recs if r["name"] == "train/loss"][-1]["value"]
    assert loss == pytest.approx(losses[-1], rel=1e-6)


RAMP = TINY + ["train.train_iters=8", "parallel.global_train_batch_size=8",
               "parallel.chunks=4", "train.rampup_batch_size=[4,4,8]"]


def test_torch_ramp_matches_the_jax_train_dist(tmp_path, monkeypatch):
    """Eight steps under ``train.rampup_batch_size=[4,4,8]`` (micro 2):
    per-step batch sizes from JAX's own calculator, ``consumed_samples``
    in both checkpoints' ``train_state``, and the losses within 1e-5."""
    from hetu_galvatron_tpu.cli import train_dist as JTD
    from hetu_galvatron_tpu.core import arguments as JA
    from hetu_galvatron_tpu.runtime.microbatches import MicroBatchCalculator

    jargs = JA.load_config(GPT2, RAMP + [f"ckpt.save={tmp_path / 'j'}",
                                         "ckpt.save_interval=8"])
    jout = JTD.train(jargs)
    npy = _jax_params(jargs.model, jargs.train.seed)[1]
    monkeypatch.setattr(TB, "init_causal_lm",
                        lambda cfg, seed, device: params_from_jax(npy))
    tout = train_dist.train(load_config(GPT2, [
        "device=cpu", *RAMP, f"ckpt.save={tmp_path / 't'}",
        "ckpt.save_interval=8"]))
    want = MicroBatchCalculator(8, 2, 1, [4, 4, 8]).schedule(
        8 * 8)[:8]
    assert tout["batch_sizes"] == want == [4, 4, 8, 8, 8, 8, 8, 8]
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-5)
    metas = []
    for pkg in ("j", "t"):
        with open(tmp_path / pkg / "step_8" / "meta.json") as f:
            metas.append(json.load(f)["train_state"])
    assert metas[1]["consumed_samples"] == metas[0]["consumed_samples"] \
        == sum(want) == tout["consumed_samples"]
    assert metas[1]["batches_consumed"] is metas[0]["batches_consumed"] \
        is None
    assert set(metas[1]["goodput"]) == set(metas[0]["goodput"])


def test_torch_ramp_resume_inside_the_ramp_is_bit_identical(tmp_path):
    """A ramp of 2, 2, 2, 2, 4, 4, 6, 6 samples, crashed in step 4 after a
    checkpoint at step 3 and resumed: the resume replays the schedule to
    skip 3 microbatches (6 samples) and restarts at batch 2, and the
    stitched losses and every parameter equal the uninterrupted run's bit
    for bit."""
    over = ["device=cpu", *TINY, "train.train_iters=8",
            "parallel.global_train_batch_size=8", "parallel.chunks=4",
            "train.rampup_batch_size=[2,2,24]", "model.hidden_dropout=0.1"]
    full = train_dist.train(load_config(GPT2, over))
    ck = str(tmp_path / "ck")
    # the run dies in step 4 after committing step_3
    from hetu_galvatron_tpu_torch.runtime.rerun_machine import InjectedCrash

    with pytest.raises(InjectedCrash):
        train_dist.train(load_config(GPT2, over + [
            f"ckpt.save={ck}", "ckpt.save_interval=3",
            "rerun.inject_kind=crash", "rerun.inject_at_iter=4"]))
    with open(os.path.join(ck, "step_3", "meta.json")) as f:
        ts = json.load(f)["train_state"]
    assert ts["consumed_samples"] == 6 and ts["batches_consumed"] is None
    rest = train_dist.train(load_config(GPT2, over + [f"ckpt.load={ck}"]))
    assert rest["start_iter"] == 3
    assert full["batch_sizes"] == [2, 2, 2, 2, 4, 4, 6, 6]
    assert rest["batch_sizes"] == full["batch_sizes"][3:]
    assert rest["losses"] == full["losses"][3:]
    assert rest["consumed_samples"] == full["consumed_samples"] == 28
    want = dict(TB.named_leaves(full["params"]))
    for name, t in TB.named_leaves(rest["params"]):
        assert torch.equal(t, want[name]), name
    assert rest["goodput"]["restarts_survived"] == 1
    assert rest["goodput"]["totals"]["resume_replay"] > 0


def test_torch_ramp_refuses_a_start_below_the_micro_size():
    args = load_config(GPT2, ["device=cpu", *TINY,
                              "parallel.global_train_batch_size=8",
                              "train.rampup_batch_size=[2,2,8]"])
    with pytest.raises(ValueError, match="below the fixed micro size"):
        train_dist.train(args)


def test_torch_rerun_reruns_the_rebatched_step(tmp_path):
    """A transient fault drill under the ramp: the rerun machine re-runs
    the step on the same rebatched batch, and the fault save records the
    position before the step's microbatches."""
    ck = str(tmp_path / "ck")
    out = train_dist.train(load_config(GPT2, [
        "device=cpu", *TINY, "train.train_iters=6",
        "parallel.global_train_batch_size=8", "parallel.chunks=4",
        "train.rampup_batch_size=[2,2,24]", "rerun.enable=true",
        "rerun.mode=validate_results", "rerun.inject_kind=nan",
        "rerun.inject_at_iter=4", f"ckpt.save={ck}"]))
    assert out["exit_code"] == 16  # transient: the re-run was finite
    assert out["batch_sizes"] == [2, 2, 2, 2, 4]
    with open(os.path.join(ck, "step_4", "meta.json")) as f:
        assert json.load(f)["train_state"]["consumed_samples"] == 8


def _healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=5) as r:
        return json.loads(r.read())


def test_torch_supervise_serves_healthz_and_dumps_flight_records(tmp_path):
    """``cli.supervise`` over real CPU children: a preemption drill at
    step 2 (the child saves step_3 and exits 18), a relaunch that resumes
    and finishes 4 steps; ``/healthz`` sees attempt 2 and exit 18 while the
    second child runs, the goodput survives one restart, the flight dumps
    carry JAX's reasons, and the stitched losses equal an uninterrupted
    run's."""
    over = ["device=cpu", *TINY, "train.train_iters=4",
            "parallel.global_train_batch_size=2"]
    summary = tmp_path / "summary.jsonl"
    full = train_dist.train(load_config(GPT2, over))
    flight = tmp_path / "flight"
    cmd = [sys.executable, "-m", "hetu_galvatron_tpu_torch.cli.supervise",
           GPT2, *over, f"ckpt.save={tmp_path / 'ck'}",
           "ckpt.save_interval=2", "supervisor.auto_restart=true",
           "supervisor.mode=process", "supervisor.metrics_port=0",
           "supervisor.backoff_base_s=0", "supervisor.backoff_max_s=0",
           "supervisor.poll_interval_s=0.05",
           "observability.enabled=true",
           f"observability.metrics_path={tmp_path / 'm.jsonl'}",
           f"observability.flight_dir={flight}",
           "rerun.inject_kind=preempt", "rerun.inject_at_iter=2",
           f"extra.summary_path={summary}"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    port, seen, lines = None, [], []
    try:
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"/healthz and /metrics on http://127\.0\.0\.1:"
                          r"(\d+)", line)
            if m:
                port = int(m.group(1))
            if port and "attempt 2" in line:
                seen.append(_healthz(port))
                break
        for line in proc.stdout:
            lines.append(line)
        rc = proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, "".join(lines[-30:])
    assert port and seen, "".join(lines[-30:])
    assert seen[0]["supervisor_attempt"] == 2
    assert seen[0]["last_child_exit_code"] == 18
    runs = [json.loads(l) for l in open(summary)]
    assert [r["exit_code"] for r in runs] == [18, 0]
    assert runs[0]["losses"] + runs[1]["losses"] == full["losses"]
    gp = runs[1]["goodput"]
    assert gp["restarts_survived"] == 1
    for cat in ("productive_step", "recompile", "checkpoint_save",
                "resume_replay", "restart_lost"):
        assert gp["totals"][cat] > 0, cat
    reasons = sorted(json.load(open(p))["reason"]
                     for p in glob.glob(str(flight / "flight_*.json")))
    assert reasons == ["child_exit_18", "signal:SIGTERM"]
    assert runs[0]["flight_dumps"] and not runs[1]["flight_dumps"]
