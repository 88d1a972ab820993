"""The port's checkpoint module (``runtime/checkpoint.py``): the atomic
save / commit / GC protocol, resume selection, the asynchronous writers and
the save cadence, the resilient resume past corrupt checkpoints, the plan
fingerprint against the JAX package's, and the optimizer-state bridge: a
JAX orbax checkpoint crosses over to the port and a port checkpoint crosses
back, for a dense model and a MoE model with expert biases (the SGD
partition), and both continue training within the tolerance of
``tests/test_torch_train.py``. The cases mirror the JAX package's
``tests/core/test_checkpoint.py`` (all but the HF interchange) and
``test_async_checkpoint.py``."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core import arguments as JA
from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.core.args_schema import TrainArgs as JTrainArgs
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.runtime import checkpoint as JK
from hetu_galvatron_tpu.runtime import hybrid_config as JH
from hetu_galvatron_tpu.runtime import optimizer as JO
from hetu_galvatron_tpu.runtime import trainer as JT
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, TrainArgs
from hetu_galvatron_tpu_torch.models.builder import (
    init_causal_lm,
    named_leaves,
)
from hetu_galvatron_tpu_torch.observability.registry import get_registry
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime import dataloader as TD
from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH
from hetu_galvatron_tpu_torch.runtime import optimizer as TO
from hetu_galvatron_tpu_torch.runtime import trainer as TT
from hetu_galvatron_tpu_torch.utils.retrying import set_fault_injector

GPT2 = os.path.join(os.path.dirname(__file__), "..", "hetu_galvatron_tpu",
                    "models", "configs", "gpt2-small.yaml")
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            vocab_size=64, max_position_embeddings=16, seq_length=8,
            make_vocab_size_divisible_by=1)


def _quiet(m):
    return None


def _trained(steps=1, seed=0):
    """A tiny model and its AdamW state after ``steps`` updates (moments
    non-zero, count > 0)."""
    cfg = ModelArgs(**TINY)
    params = init_causal_lm(cfg, seed=seed)
    tx = TO.make_optimizer(TrainArgs(lr=1e-2, lr_decay_style="constant"))
    names, leaves = zip(*named_leaves(params))
    opt = tx.init(list(leaves), names)
    step = TT.make_train_step(
        TT.make_loss_fn(cfg, compute_dtype=torch.float32), tx)
    it = TD.synthetic_batches(cfg, 4, seed=seed)
    for _ in range(steps):
        b = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else
             torch.from_numpy(v) for k, v in next(it).items()}
        params, opt, _ = step(params, opt, b)
    return cfg, params, opt, tx, step, it


def _zeros_like(params, opt):
    zp = {k: v for k, v in _map(params, torch.zeros_like).items()}
    zo = dataclasses.replace(opt, count=0,
                             mu=[torch.zeros_like(t) for t in opt.mu],
                             nu=[torch.zeros_like(t) for t in opt.nu])
    return zp, zo


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree.detach())
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return [_map(v, fn) for v in tree]


def _assert_same(a, b):
    la, lb = list(named_leaves(a)), list(named_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert torch.equal(x.detach(), y.detach()), n


def _tree(scale=1.0):
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
            "b": torch.ones(4) * scale}


def _target():
    return {"w": torch.zeros(3, 4), "b": torch.zeros(4)}


# -- save, load, select -------------------------------------------------------


def test_torch_save_load_roundtrip(tmp_path):
    _, params, opt, *_ = _trained(steps=2)
    d = TK.save_checkpoint(str(tmp_path), 7, params, opt)
    assert TK.latest_checkpoint(str(tmp_path)) == d
    assert sorted(os.listdir(d)) == ["COMMITTED", "meta.json",
                                     "opt_state.pt", "params.pt"]
    zp, zo = _zeros_like(params, opt)
    p2, o2, step = TK.load_checkpoint(d, zp, zo)
    assert step == 7 and p2 is zp and o2 is zo
    _assert_same(params, p2)
    assert (o2.count, o2.adam, o2.sgd) == (2, opt.adam, opt.sgd)
    for a, b in zip(opt.mu + opt.nu, o2.mu + o2.nu):
        assert torch.equal(a, b)
    # the payload is a flat dict of CPU tensors by leaf name
    raw = torch.load(os.path.join(d, "params.pt"), weights_only=True)
    assert list(raw) == [n for n, _ in named_leaves(params)]
    raw = torch.load(os.path.join(d, "opt_state.pt"), weights_only=True)
    assert raw["count"] == 2 and raw["adam"] == opt.adam
    assert get_registry().gauge("checkpoint/load_bytes").value == \
        os.path.getsize(os.path.join(d, "params.pt")) + \
        os.path.getsize(os.path.join(d, "opt_state.pt"))


def test_torch_latest_checkpoint_picks_max_and_skips_strays(tmp_path):
    d = TK.save_checkpoint(str(tmp_path), 3, _tree())
    assert TK.latest_checkpoint(str(tmp_path)) == d
    assert TK.save_checkpoint(str(tmp_path), 2, _tree()) and \
        TK.latest_checkpoint(str(tmp_path)) == d
    assert TK.latest_checkpoint(str(tmp_path / "nope")) is None
    for name in ("step_x", "step_5.partial", "step_9.tmp", "step_99"):
        (tmp_path / name).mkdir()
    (tmp_path / "step_4").write_text("a file, not a dir")
    assert TK.latest_checkpoint(str(tmp_path)) == d
    TK.gc_checkpoints(str(tmp_path))
    assert os.path.isdir(tmp_path / "step_x")
    assert os.path.isdir(tmp_path / "step_5.partial")
    assert not os.path.isdir(tmp_path / "step_9.tmp")
    assert not os.path.isdir(tmp_path / "step_99")
    assert TK.latest_checkpoint(str(tmp_path)) == d
    assert TK.committed_checkpoints(str(tmp_path)) == [
        d, str(tmp_path / "step_2")]


def _steps(root):
    return sorted(d for d in os.listdir(root) if d.startswith("step_"))


def test_torch_keep_last_retention_and_async_commit(tmp_path):
    root = str(tmp_path)
    for s in (1, 2, 3):
        TK.save_checkpoint(root, s, _tree())
    TK.save_checkpoint(root, 4, _tree(), keep_last=2)
    assert _steps(root) == ["step_3", "step_4"]
    # an async save is invisible until wait_for_checkpoints commits it,
    # and its own just-committed dir counts toward keep_last
    live = _tree(5.0)
    d5 = TK.save_checkpoint(root, 5, live, async_save=True, keep_last=2)
    live["w"].mul_(100.0)  # the host copy was taken before the return
    assert not os.path.isdir(d5)
    assert TK.latest_checkpoint(root).endswith("step_4")
    TK.wait_for_checkpoints()
    TK.wait_for_checkpoints()  # idempotent when drained
    assert _steps(root) == ["step_4", "step_5"]
    p, _, _ = TK.load_checkpoint(d5, _target())
    _assert_same(p, _tree(5.0))


def test_torch_wait_for_checkpoints_drains_despite_failure(tmp_path):
    class FakeWriter:
        def __init__(self, log, name, fail=False):
            self.log, self.name, self.fail = log, name, fail

        def wait_until_finished(self):
            self.log.append(self.name)
            if self.fail:
                raise IOError(f"flaky wait: {self.name}")

    log = []
    for i, fail in enumerate([False, True, False]):
        d = tmp_path / f"step_{i + 1}"
        TK._PENDING.append(TK._PendingSave(
            [FakeWriter(log, f"c{i}", fail)], str(d) + ".tmp", str(d),
            str(tmp_path)))
    (tmp_path / "step_1.tmp").mkdir()
    (tmp_path / "step_3.tmp").mkdir()
    with pytest.raises(IOError, match="flaky wait: c1"):
        TK.wait_for_checkpoints()
    assert log == ["c0", "c1", "c2"] and not TK._PENDING
    assert _steps(str(tmp_path)) == ["step_1", "step_3"]


def test_torch_train_state_rides_meta(tmp_path):
    ts = {"step": 4, "seed": 7, "batches_consumed": 4,
          "rerun": {"records": [], "ema": 2.5}}
    d = TK.save_checkpoint(str(tmp_path), 4, _tree(), train_state=ts)
    meta = TK.read_checkpoint_meta(d)
    assert meta == {"step": 4, "train_state": ts}
    # the JAX reader takes the port's meta.json as it is
    assert JK.read_checkpoint_meta(d) == meta
    assert TK.read_checkpoint_meta(str(tmp_path / "nowhere")) == {}


@pytest.mark.parametrize("over", [
    [], ["parallel.global_checkpoint=1"], ["parallel.chunks=2"],
    ["model.num_hidden_layers=3", "parallel.global_train_batch_size=16"]])
def test_torch_plan_fingerprint_matches_jax(over):
    base = ["model.hidden_size=32", "model.num_hidden_layers=2",
            "model.num_attention_heads=2", "model.vocab_size=64"] + over
    thpc = TH.get_hybrid_parallel_config(load_config(GPT2, base), 1)
    jhpc = JH.get_hybrid_parallel_config(JA.load_config(GPT2, base), 1)
    assert TK._plan_fingerprint(thpc) == JK._plan_fingerprint(jhpc)


def test_torch_plan_and_world_mismatch_raise_typed_errors(tmp_path):
    args = load_config(GPT2, ["model.hidden_size=32"])
    hpc = TH.get_hybrid_parallel_config(args, 1)
    d = TK.save_checkpoint(str(tmp_path), 1, _tree(), hpc=hpc)
    other = dataclasses.replace(hpc, chunks=2)
    with pytest.raises(TK.PlanMismatchError, match="plan mismatch"):
        TK.load_checkpoint(d, _target(), hpc=other, strict_plan=True)
    assert TK.load_checkpoint(d, _target(), hpc=other)[2] == 1
    assert TK.load_checkpoint(d, _target(), expected_world=1)[2] == 1
    wide = dataclasses.replace(hpc, world_size=2)
    d2 = TK.save_checkpoint(str(tmp_path / "w2"), 3, _tree(), hpc=wide)
    with pytest.raises(TK.WorldSizeMismatchError) as ei:
        TK.load_checkpoint(d2, _target(), expected_world=1)
    err = ei.value
    assert (err.stored_world, err.live_world) == (2, 1)
    assert "2-device" in str(err) and "elastic" in str(err)
    with pytest.raises(TK.WorldSizeMismatchError):
        # propagates through the resilient loop: not corruption
        TK.load_latest_resilient(str(tmp_path / "w2"), _target(),
                                 expected_world=1, log=_quiet)
    # no plan fingerprint: loads under any world
    d3 = TK.save_checkpoint(str(tmp_path / "legacy"), 1, _tree())
    assert TK.load_checkpoint(d3, _target(), expected_world=1)[2] == 1


def test_torch_load_checks_every_leaf_before_copying(tmp_path):
    d = TK.save_checkpoint(str(tmp_path), 1, _tree(2.0), _tree(3.0))
    target = {"w": torch.zeros(3, 4), "b": torch.zeros(5)}
    with pytest.raises(ValueError, match="b"):
        TK.load_checkpoint(d, target)
    assert not target["w"].any()  # nothing was copied
    with pytest.raises(ValueError, match="missing"):
        TK.load_checkpoint(d, {"w": torch.zeros(3, 4)})
    opt_target = {"w": torch.zeros(3, 4), "b": torch.zeros(4),
                  "extra": torch.zeros(1)}
    target = _target()
    with pytest.raises(ValueError, match="opt_state"):
        TK.load_checkpoint(d, target, opt_target)
    assert not target["w"].any()
    orbax = tmp_path / "jax" / "step_2"
    (orbax / "params").mkdir(parents=True)
    (orbax / "meta.json").write_text(json.dumps({"step": 2}))
    with pytest.raises(ValueError, match="orbax"):
        TK.load_checkpoint(str(orbax), _target())


def test_torch_resume_continues_training_bit_for_bit(tmp_path):
    cfg, params, opt, tx, step, it = _trained(steps=1)
    d = TK.save_checkpoint(str(tmp_path), 1, params, opt)
    b = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else
         torch.from_numpy(v) for k, v in next(it).items()}
    zp, zo = _zeros_like(params, opt)
    rp, ro, _ = TK.load_checkpoint(d, zp, zo)
    for n, t in named_leaves(rp):
        t.requires_grad_(True)
    params, opt, m1 = step(params, opt, b)
    rp, ro, m2 = step(rp, ro, b)
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_same(params, rp)


def test_torch_gc_never_reaps_live_resume_selection(tmp_path):
    root = str(tmp_path)
    for s in (1, 2, 3):
        TK.save_checkpoint(root, s, _tree())
    sel = TK.latest_checkpoint(root)
    assert sel.endswith("step_3")
    TK.save_checkpoint(root, 4, _tree(), keep_last=1)
    assert _steps(root) == ["step_3", "step_4"]  # the selection survived
    TK.load_checkpoint(sel, _target())
    assert TK.latest_checkpoint(root).endswith("step_4")
    TK.gc_checkpoints(root, keep_last=1)
    assert _steps(root) == ["step_4"]


def test_torch_crash_mid_save_is_never_selectable(tmp_path, monkeypatch):
    root = str(tmp_path)
    good = TK.save_checkpoint(root, 2, _tree())
    real_commit = TK._commit

    def exploding_commit(tmp_dir, final_dir):
        raise RuntimeError("simulated crash between write and commit")

    monkeypatch.setattr(TK, "_commit", exploding_commit)
    with pytest.raises(RuntimeError, match="simulated crash"):
        TK.save_checkpoint(root, 5, _tree())
    assert os.path.isdir(str(tmp_path / "step_5.tmp"))
    assert TK.latest_checkpoint(root) == good
    monkeypatch.setattr(TK, "_commit", real_commit)
    assert str(tmp_path / "step_5.tmp") in TK.gc_checkpoints(root)
    d5 = TK.save_checkpoint(root, 5, _tree())
    assert TK.latest_checkpoint(root) == d5
    # a crash mid-overwrite (between _commit's two renames) is rolled back
    os.replace(d5, d5 + ".old")
    assert TK.latest_checkpoint(root) == d5
    assert not os.path.isdir(d5 + ".old")
    assert TK.load_checkpoint(d5, _target())[2] == 5
    # a re-save of a committed step keeps a selectable copy throughout
    assert TK.save_checkpoint(root, 5, _tree(9.0)) == d5
    _assert_same(TK.load_checkpoint(d5, _target())[0], _tree(9.0))


# -- AsyncCheckpointer and CheckpointCadence ----------------------------------


def test_torch_snapshot_drain_commit_roundtrip(tmp_path):
    ac = TK.AsyncCheckpointer(str(tmp_path), log=_quiet)
    stall_ms = ac.snapshot(3, _tree(), _tree(2.0),
                           train_state={"consumed_samples": 24})
    assert stall_ms >= 0.0
    assert get_registry().gauge("checkpoint/snapshot_stall_ms").value == \
        stall_ms
    assert ac.drain()
    assert ac.last_commit["step"] == 3
    d = TK.latest_checkpoint(str(tmp_path))
    p, o, step = TK.load_checkpoint(d, _target(), _target())
    assert step == 3
    _assert_same(p, _tree())
    _assert_same(o, _tree(2.0))
    meta, err = TK.try_read_checkpoint_meta(d)
    assert err is None and meta["train_state"]["consumed_samples"] == 24
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    ac.close()


def test_torch_snapshot_isolates_from_in_place_updates(tmp_path):
    """The port's optimizer writes the leaves in place: what the writer
    commits must be the state at snapshot time, not a mixture with the
    next step's update."""
    gate = threading.Event()
    ac = TK.AsyncCheckpointer(str(tmp_path), log=_quiet,
                              hooks={"before_write": lambda s: gate.wait(30)})
    _, params, opt, *_ = _trained(steps=1)
    want_p = _map(params, torch.clone)
    want_mu = [t.clone() for t in opt.mu]
    ac.snapshot(1, params, opt)
    with torch.no_grad():
        for _, t in named_leaves(params):
            t.mul_(100.0)
        for t in opt.mu:
            t.add_(1.0)
    opt.count = 99
    gate.set()
    assert ac.drain(timeout_s=30)
    zp, zo = _zeros_like(params, opt)
    p, o, _ = TK.load_checkpoint(TK.latest_checkpoint(str(tmp_path)), zp, zo)
    _assert_same(p, want_p)
    assert o.count == 1
    assert all(torch.equal(a, b) for a, b in zip(o.mu, want_mu))
    ac.close()


def test_torch_new_snapshot_supersedes_unstarted_write(tmp_path):
    gate = threading.Event()
    logs = []
    ac = TK.AsyncCheckpointer(str(tmp_path), log=logs.append,
                              hooks={"before_write": lambda s: gate.wait(30)})
    ac.snapshot(1, _tree())
    deadline = time.monotonic() + 10
    while ac._inflight is None:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    ac.snapshot(2, _tree(2.0))
    ac.snapshot(3, _tree(3.0))  # supersedes step 2
    gate.set()
    assert ac.drain(timeout_s=30)
    assert _steps(str(tmp_path)) == ["step_1", "step_3"]
    assert any("supersedes" in m for m in logs)
    ac.close()


def test_torch_hung_save_watchdog_and_drain_give_up(tmp_path):
    gate = threading.Event()
    logs = []
    ac = TK.AsyncCheckpointer(str(tmp_path), save_timeout_s=0.2,
                              log=logs.append,
                              hooks={"before_write": lambda s: gate.wait(60)})
    ac.snapshot(5, _tree())
    t0 = time.monotonic()
    assert ac.drain(timeout_s=0.5) is False
    assert time.monotonic() - t0 < 10.0
    time.sleep(0.25)
    assert ac.check_watchdog() is True
    assert any("watchdog" in m for m in logs)
    gate.set()
    assert ac.drain(timeout_s=30)


def test_torch_writer_error_latches_and_reraises(tmp_path):
    def boom(step):
        raise OSError("disk on fire")

    ac = TK.AsyncCheckpointer(str(tmp_path), log=_quiet,
                              hooks={"before_write": boom})
    ac.snapshot(1, _tree())
    with pytest.raises(OSError, match="disk on fire"):
        ac.drain(timeout_s=30)
    ac.hooks.pop("before_write")
    ac.snapshot(2, _tree(2.0))
    assert ac.drain(timeout_s=30)
    assert TK.latest_checkpoint(str(tmp_path)).endswith("step_2")
    ac.close()


class _Ck:
    def __init__(self, **kw):
        self.save = kw.get("save")
        self.load = None
        self.save_interval = kw.get("save_interval", 0)
        self.interval_s = kw.get("interval_s", 0.0)
        self.snapshot_async = kw.get("snapshot_async", False)
        self.save_timeout_s = kw.get("save_timeout_s", 120.0)
        self.async_save = kw.get("async_save", False)
        self.keep_last = kw.get("keep_last", 0)


def test_torch_cadence_matches_jax():
    for K in (JK, TK):
        cad = K.CheckpointCadence(_Ck(save="/nope", save_interval=3),
                                  log=_quiet)
        assert [cad.due(it) for it in range(6)] == [
            False, False, True, False, False, True]
        now = [100.0]
        cad = K.CheckpointCadence(_Ck(save="/nope", interval_s=30.0),
                                  log=_quiet, clock=lambda: now[0])
        assert not cad.due(0)
        now[0] += 29.0
        assert not cad.due(1)
        now[0] += 2.0
        assert cad.due(2)
        assert not K.CheckpointCadence(_Ck(save=None, save_interval=1),
                                       log=_quiet).due(0)


@pytest.mark.parametrize("mode", ["sync", "async_save", "snapshot_async"])
def test_torch_cadence_saves_through_each_mode(tmp_path, mode):
    now = [0.0]
    ck = _Ck(save=str(tmp_path), interval_s=10.0, keep_last=2,
             **({mode: True} if mode != "sync" else {}))
    cad = TK.CheckpointCadence(ck, log=_quiet, clock=lambda: now[0])
    assert (cad.async_ckptr is not None) == (mode == "snapshot_async")
    now[0] = 11.0
    assert cad.due(0)
    for s in (1, 2, 3):
        cad.save(s, _tree(float(s)))
    assert not cad.due(1)  # the save re-based the clock
    now[0] = 22.0
    assert cad.due(2)
    cad.drain()
    assert _steps(str(tmp_path))[-1] == "step_3"
    _assert_same(TK.load_checkpoint(TK.latest_checkpoint(str(tmp_path)),
                                    _target())[0], _tree(3.0))


# -- resilient resume ---------------------------------------------------------


def _two_commits(root):
    TK.save_checkpoint(root, 1, _tree(), _tree(2.0))
    TK.save_checkpoint(root, 2, _tree(10.0), _tree(20.0))


def _truncate(path):
    txt = open(path).read()
    with open(path, "w") as f:
        f.write(txt[: len(txt) // 2])


def _garble(path):
    with open(path, "w") as f:
        f.write("{this is not json")


def _drop_params(d):
    os.remove(os.path.join(d, "params.pt"))


def _cut_params(d):
    p = os.path.join(d, "params.pt")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)


@pytest.mark.parametrize("corrupt", [
    lambda d: _truncate(os.path.join(d, "meta.json")),
    lambda d: _garble(os.path.join(d, "meta.json")),
    _drop_params, _cut_params,
], ids=["truncated_meta", "garbled_meta", "missing_params", "torn_params"])
def test_torch_resilient_resume_falls_back(tmp_path, corrupt):
    root = str(tmp_path)
    _two_commits(root)
    corrupt(os.path.join(root, "step_2"))
    logs = []
    got = TK.load_latest_resilient(root, _target(), _target(),
                                   log=logs.append)
    p, o, step, ckdir = got
    assert step == 1 and ckdir.endswith("step_1")
    _assert_same(p, _tree())
    _assert_same(o, _tree(2.0))
    assert any("falling back" in m for m in logs)


def test_torch_resilient_resume_edges(tmp_path):
    root = str(tmp_path)
    assert TK.load_latest_resilient(root, _target()) is None
    _two_commits(root)
    stray = os.path.join(root, "step_9")
    os.makedirs(stray)
    with open(os.path.join(stray, "COMMITTED"), "w") as f:
        f.write("committed\n")
    got = TK.load_latest_resilient(root, _target(), _target(), log=_quiet)
    assert got[2] == 2  # the newest real commit
    for s in (1, 2):
        _garble(os.path.join(root, f"step_{s}", "meta.json"))
        _drop_params(os.path.join(root, f"step_{s}"))
    with pytest.raises(RuntimeError, match="3 committed checkpoint"):
        TK.load_latest_resilient(root, _target(), log=_quiet)


def test_torch_try_read_meta_never_raises(tmp_path):
    d = str(tmp_path / "step_1")
    os.makedirs(d)
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write("{torn")
    meta, err = TK.try_read_checkpoint_meta(d)
    assert meta == {} and err is not None
    meta, err = TK.try_read_checkpoint_meta(str(tmp_path / "absent"))
    assert meta == {} and err is None
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"step": 1}, f)
    meta, err = TK.try_read_checkpoint_meta(d)
    assert err is None and meta["step"] == 1


@pytest.mark.parametrize("op", ["checkpoint.read_meta", "checkpoint.restore",
                                "checkpoint.write"])
def test_torch_checkpoint_io_absorbs_transient_faults(tmp_path, op,
                                                      monkeypatch):
    monkeypatch.setattr("hetu_galvatron_tpu_torch.utils.retrying."
                        "_default_sleep", lambda s: None)
    root = str(tmp_path)
    budget = [2]

    def inject(name):
        if name == op and budget[0] > 0:
            budget[0] -= 1
            return OSError("chaos: injected transient I/O error")
        return None

    prev = set_fault_injector(inject)
    try:
        TK.save_checkpoint(root, 1, _tree())
        got = TK.load_latest_resilient(root, _target(), log=_quiet)
    finally:
        set_fault_injector(prev)
    assert got is not None and got[2] == 1
    assert budget[0] == 0


# -- the bridge: JAX optimizer state and checkpoints, both ways ---------------


MOE = dict(model_type="moe", hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
           max_position_embeddings=32, seq_length=16, hidden_act="swiglu",
           normalization="rmsnorm", position_embedding_type="rope",
           tie_word_embeddings=False, add_bias_linear=False,
           make_vocab_size_divisible_by=1, ffn_hidden_size=48, num_experts=4,
           moe_topk=2, moe_z_loss_coeff=1e-3,
           moe_router_enable_expert_bias=True,
           moe_expert_bias_update_rate=1e-2)
DENSE = dict(TINY, vocab_size=128, max_position_embeddings=32, seq_length=16)
TRAIN = dict(lr=1e-3, min_lr=1e-4, weight_decay=0.1, clip_grad=0.5,
             adam_eps=1e-5, train_iters=6, lr_decay_style="cosine",
             lr_warmup_iters=1)
KINDS = {"dense": DENSE, "moe": MOE}


def _np_batches(model, n, seed):
    it = TD.synthetic_batches(ModelArgs(**model), 4, seed=seed)
    return [next(it) for _ in range(n)]


def _tb(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else
            torch.from_numpy(v) for k, v in b.items()}


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
def jax_runs(tmp_path_factory):
    """Per model kind, the JAX trainer's uninterrupted 6 steps, and its
    orbax checkpoint of step 3 with the optimizer state."""
    out = {}
    for kind, model in KINDS.items():
        jcfg = JModelArgs(**model)
        jparams0, _ = JB.init_causal_lm(jax.random.key(31), jcfg)
        jtx = JO.make_optimizer(JTrainArgs(**TRAIN))
        moe = kind == "moe"

        def loss(p, b, jcfg=jcfg, moe=moe):
            return JB.causal_lm_loss(p, b, jcfg, compute_dtype=jnp.float32,
                                     with_moe_stats=moe)

        jstep = jax.jit(JT.make_train_step(loss, jtx, aux_stats=moe))
        batches = _np_batches(model, 6, seed=32)
        jp, jo = jparams0, jtx.init(jparams0)
        losses, root = [], str(tmp_path_factory.mktemp(f"jax_{kind}"))
        for it, b in enumerate(batches):
            jp, jo, m = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
            if it == 2:
                JK.save_checkpoint(root, 3, jp, jo)
        out[kind] = dict(
            model=model, jcfg=jcfg, jtx=jtx, jstep=jstep, batches=batches,
            params0=jax.tree.map(np.asarray, jparams0), losses=losses,
            final=jax.tree.map(np.asarray, jp), ckpt=os.path.join(
                root, "step_3"))
    return out


def _port_step(model):
    cfg = ModelArgs(**model)
    tx = TO.make_optimizer(TrainArgs(**TRAIN))
    moe = bool(cfg.num_experts)
    return tx, TT.make_train_step(
        TT.make_loss_fn(cfg, compute_dtype=torch.float32,
                        with_moe_stats=moe), tx, aux_stats=moe)


def _assert_close_to_jax(tparams, jparams):
    want = dict(named_leaves(TK.params_from_jax(jparams)))
    for name, t in named_leaves(tparams):
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_torch_opt_state_bridge_roundtrip(jax_runs, kind):
    """optax's chain state after 3 JAX steps -> AdamState -> optax again:
    every count and moment survives; expert biases take SGD."""
    run = jax_runs[kind]
    jp = jax.tree.map(jnp.zeros_like, run["params0"])
    jo = run["jtx"].init(jp)
    jp, jo, _ = JK.load_checkpoint(run["ckpt"], jp, jo)
    tparams = TK.params_from_jax(jax.tree.map(np.asarray, jp))
    st = TK.opt_state_from_jax(jax.tree.map(np.asarray, jo), tparams)
    names = [n for n, _ in named_leaves(tparams)]
    assert st.count == 3
    assert [names[i] for i in st.sgd] == (
        ["layers.0.moe.expert_bias", "layers.1.moe.expert_bias"]
        if kind == "moe" else [])
    back = TK.opt_state_to_jax(st, tparams, like=run["jtx"].init(jp))
    leaves_a = jax.tree_util.tree_flatten_with_path(jo)[0]
    leaves_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in leaves_a] == [p for p, _ in leaves_b]
    for (path, a), (_, b) in zip(leaves_a, leaves_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    assert jax.tree.structure(back) == jax.tree.structure(jo)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_torch_jax_checkpoint_crosses_to_the_port(jax_runs, kind, tmp_path):
    """JAX trains 3 steps and saves (orbax); the JAX package restores it on
    the CPU, the bridge carries params and optimizer state over, the port
    saves and resumes it through its own format and trains steps 3-5: its
    losses and final parameters equal the JAX run's within 1e-5."""
    run = jax_runs[kind]
    target = jax.tree.map(jnp.zeros_like, run["params0"])
    jp, jo, step = JK.load_checkpoint(run["ckpt"], target,
                                      run["jtx"].init(target))
    assert step == 3
    tparams = TK.params_from_jax(jax.tree.map(np.asarray, jp))
    topt = TK.opt_state_from_jax(jax.tree.map(np.asarray, jo), tparams)
    d = TK.save_checkpoint(str(tmp_path), 3, tparams, topt)
    tx, step_fn = _port_step(run["model"])
    fresh = TK.params_from_jax(run["params0"])
    names, leaves = zip(*named_leaves(fresh))
    fresh_opt = tx.init(list(leaves), names)
    tparams, topt, _ = TK.load_checkpoint(d, fresh, fresh_opt)
    losses = []
    for b in run["batches"][3:]:
        tparams, topt, m = step_fn(tparams, topt, _tb(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, run["losses"][3:], rtol=1e-5)
    _assert_close_to_jax(tparams, run["final"])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_torch_port_checkpoint_crosses_to_jax(jax_runs, kind, tmp_path):
    """The port trains 3 steps from the JAX init and saves; it restores
    the checkpoint, the bridge carries it to the JAX trees
    (params_to_jax, opt_state_to_jax), and the JAX trainer's steps 3-5
    equal its uninterrupted run within 1e-5."""
    run = jax_runs[kind]
    tx, step_fn = _port_step(run["model"])
    tparams = TK.params_from_jax(run["params0"])
    names, leaves = zip(*named_leaves(tparams))
    topt = tx.init(list(leaves), names)
    for b in run["batches"][:3]:
        tparams, topt, _ = step_fn(tparams, topt, _tb(b))
    d = TK.save_checkpoint(str(tmp_path), 3, tparams, topt)
    fresh = TK.params_from_jax(run["params0"])
    fresh_opt = tx.init([t for _, t in named_leaves(fresh)],
                        [n for n, _ in named_leaves(fresh)])
    rp, ro, _ = TK.load_checkpoint(d, fresh, fresh_opt)
    jp = jax.tree.map(jnp.asarray, TK.params_to_jax(rp))
    jo = jax.tree.map(jnp.asarray, TK.opt_state_to_jax(
        ro, rp, like=run["jtx"].init(jp)))
    losses = []
    for b in run["batches"][3:]:
        jp, jo, m = run["jstep"](jp, jo, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, run["losses"][3:], rtol=1e-5)
    _assert_close_to_jax(TK.params_from_jax(jax.tree.map(np.asarray, jp)),
                         run["final"])
