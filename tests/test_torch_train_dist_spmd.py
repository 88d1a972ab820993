"""``cli/train_dist.py`` over several ranks on the CPU (gloo), one process a
rank: the launcher's whole path under a pp=1 plan wider than one rank,
and each refusal that remains, naming its ROADMAP item.

The runs go through ``parallel/launch.spawn_world`` (the environment a
``torch.distributed.run`` launch exports, a ``file://`` rendezvous), and
one through ``python -m torch.distributed.run --standalone`` itself. A
world-2 run of GLOBAL tp2 and a world-4 run of the ``spmd_tp2zero3``
example plan train the same weights on the same batches as the world-1
run: every step's loss within 2e-5 and the gathered parameters within
rtol 5e-4, atol 3e-4. Rank 0 alone logs and writes the metrics stream."""

import os
import subprocess
import sys

import numpy as np
import pytest

from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.parallel.launch import spawn_world
from hetu_galvatron_tpu_torch.runtime.initialize import (
    initialize,
    pick_backend,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2 = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs",
                    "gpt2-small.yaml")
PLAN = os.path.join(ROOT, "hetu_galvatron_tpu_torch", "profiles",
                    "example_plans", "galvatron_config_spmd_tp2zero3.json")
TINY = ["device=cpu", "model.hidden_size=64", "model.num_hidden_layers=4",
        "model.num_attention_heads=4", "model.vocab_size=128",
        "model.seq_length=16", "model.max_position_embeddings=32",
        "model.make_vocab_size_divisible_by=1", "train.train_iters=3",
        "parallel.mixed_precision=fp32", "parallel.global_train_batch_size=8",
        "train.lr=1e-3", "train.eval_interval=3", "train.eval_iters=1"]
RUNS = {"tp2": (2, ["parallel.global_tp_deg=2"]),
        "plan_tp2zero3": (4, [f"parallel.galvatron_config_path={PLAN}"]),
        "dp2_zero2_vtp2_chunks2": (2, ["parallel.default_dp_type=zero2",
                                       "parallel.vocab_tp=2",
                                       "parallel.chunks=2"])}


def _train(rank, world, argv, metrics_dir):
    from hetu_galvatron_tpu_torch.models.builder import named_leaves

    argv = argv + [f"observability.metrics_path="
                   f"{os.path.join(metrics_dir, f'm{world}.jsonl')}",
                   "observability.enabled=true"]
    out = train_dist.train(load_config(GPT2, argv))
    full = (out["engine"].gather_params(out["params"])
            if out["engine"] is not None else out["params"])
    return dict(losses=out["losses"], val=out["val_losses"],
                test=out["test_loss"], rank=out["rank"],
                params={n: t.detach().numpy().copy()
                        for n, t in named_leaves(full)} if rank == 0
                else None)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("w1")
    return _train(0, 1, TINY, str(d))


@pytest.mark.parametrize("case", list(RUNS))
def test_torch_train_dist_spmd_matches_world_1(case, reference, tmp_path):
    world, over = RUNS[case]
    ranks = spawn_world(_train, world, TINY + over, str(tmp_path),
                        timeout=180)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        assert r["val"] == ranks[0]["val"]
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], reference["losses"],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose([v["loss"] for v in got["val"]],
                               [v["loss"] for v in reference["val"]],
                               rtol=0, atol=2e-5)
    assert abs(got["test"] - reference["test"]) < 2e-5
    for n, t in got["params"].items():
        np.testing.assert_allclose(t, reference["params"][n], rtol=5e-4,
                                   atol=3e-4, err_msg=n)
    # rank 0 alone writes the stream, with the global loss
    streams = os.listdir(tmp_path)
    assert streams == [f"m{world}.jsonl"]
    text = (tmp_path / streams[0]).read_text()
    assert '"train/tokens_per_sec"' in text
    assert f'"value":{got["losses"][-1]}' in text.replace(" ", "")


def test_torch_train_dist_under_torchrun(tmp_path):
    """The entry point a user runs: ``torch.distributed.run`` with two
    processes on the CPU; rank 0 prints the log, the other rank nothing."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m",
           "hetu_galvatron_tpu_torch.cli.train_dist", GPT2, *TINY,
           "parallel.global_tp_deg=2"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                          cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("training done: 3 iters") == 1
    assert out.count("iter 2 |") == 1
    assert "backend gloo" in proc.stderr and "rank 0 of 2" in proc.stderr
    assert "rank 1 of 2" not in proc.stderr


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cuda", 4, 1, "gloo"), ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 8, "nccl")])
def test_torch_backend_follows_the_layout(device, local, cards, want):
    assert pick_backend(device, local, cards) == want


# (overrides, the launch's world, the text the refusal must hold)
REFUSALS = {
    "cp": (["parallel.global_cp_deg=2"], 2,
           "global_cp_deg=2 is not ported yet (ROADMAP item 11)"),
    "ulysses": (["parallel.global_tp_deg=2", "parallel.use_ulysses=true"],
                2, "use_ulysses=True is not ported yet (ROADMAP item 11)"),
    "vocab_sp": (["parallel.vocab_sp=1"], 2,
                 "vocab_sp=1 is not ported yet (ROADMAP item 11)"),
    "ep": (["parallel.global_ep_deg=2"], 2,
           "global_ep_deg=2 is not ported yet (ROADMAP item 10b)"),
    "moe": (["model.num_experts=4", "model.model_type=moe"], 2,
            "MoE layers under a plan wider than one rank (ROADMAP item "
            "10b)"),
    "t5": (["model.model_type=t5"], 2, "(ROADMAP item 10b)"),
    "pp": (["parallel.pp_deg=2"], 2,
           "pipeline engine runs every stage in one process; a pipeline "
           "stage wider than one rank is not ported yet (ROADMAP item 12c)"),
    "pp_tp": (["parallel.pp_deg=2", "parallel.global_tp_deg=2"], 1,
              "global_tp_deg=2 under parallel.pp_deg=2"),
    "single_process": (["parallel.global_tp_deg=2"], 1,
                       "torch.distributed.run --nproc_per_node 2"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_torch_train_dist_spmd_refusals_name_their_item(case, monkeypatch):
    over, world, text = REFUSALS[case]
    env = {"RANK": "0", "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": str(world)}
    for k in env:
        monkeypatch.delenv(k, raising=False)
    if world > 1:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError) as err:
        initialize(load_config(GPT2, TINY + over))
    assert text in str(err.value)


@pytest.mark.parametrize("flag", ["ckpt.save", "ckpt.load",
                                  "supervisor.auto_restart"])
def test_torch_train_dist_refuses_the_lifecycle_above_world_1(
        flag, monkeypatch, tmp_path):
    value = "true" if flag.startswith("supervisor") else str(tmp_path)
    for k, v in {"RANK": "0", "WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=f"{flag} .*ROADMAP item "
                       "15b"):
        train_dist.main([GPT2, *TINY, f"{flag}={value}"])
