"""The checkpoint module's CUDA paths, on the card: the asynchronous
snapshot (an on-card clone, a CUDA event, the writer's own stream) against
in-place updates enqueued right behind it, and a preempted run that saves
through the snapshot writer and resumes bit for bit.

This file imports torch and the port only; on a machine with a card run
``python -m pytest --noconftest tests/test_torch_checkpoint_cuda.py -q``
(``tests/conftest.py`` imports JAX). Without a CUDA device every test
skips. Tolerance: none; every comparison is bitwise.
"""

import os

import pytest
import torch

from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
from hetu_galvatron_tpu_torch.models.builder import (
    init_causal_lm,
    named_leaves,
)
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime.supervisor import run_with_restarts

pytestmark = pytest.mark.cuda

GPT2 = os.path.join(os.path.dirname(__file__), "..", "hetu_galvatron_tpu",
                    "models", "configs", "gpt2-small.yaml")
TINY = ["model.hidden_size=256", "model.num_hidden_layers=2",
        "model.num_attention_heads=4", "model.vocab_size=1024",
        "model.seq_length=128", "model.max_position_embeddings=256",
        "model.make_vocab_size_divisible_by=1", "train.train_iters=6",
        "parallel.mixed_precision=bf16",
        "parallel.global_train_batch_size=8", "logging.log_interval=100"]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def test_torch_snapshot_on_the_card_survives_in_place_updates(tmp_path):
    """Snapshot, then overwrite every leaf on the same stream at once (no
    host sync in between, as the next training step would): the commit
    holds the values at snapshot time."""
    _needs_card()
    cfg = args_from_cli([GPT2, *TINY], mode="train_dist").model
    params = init_causal_lm(cfg, seed=3, device="cuda")
    want = {n: t.detach().cpu().clone() for n, t in named_leaves(params)}
    ac = TK.AsyncCheckpointer(str(tmp_path), log=lambda m: None)
    ac.snapshot(1, params)
    with torch.no_grad():
        for _ in range(20):  # a long queue of work behind the snapshot
            for _, t in named_leaves(params):
                t.mul_(1.5).add_(1.0)
    assert ac.drain(timeout_s=120)
    ac.close()
    target = init_causal_lm(cfg, seed=4, device="cuda")
    TK.load_checkpoint(TK.latest_checkpoint(str(tmp_path)), target)
    for n, t in named_leaves(target):
        assert torch.equal(t.detach().cpu(), want[n]), n


@pytest.mark.parametrize("mode", ["sync", "ckpt.async_save=true",
                                  "ckpt.snapshot_async=true"])
def test_torch_preempted_run_on_the_card_resumes_bit_for_bit(tmp_path,
                                                             mode):
    _needs_card()
    base = ["model.use_flash_attn=false", *TINY]
    want = train_dist.train(args_from_cli([GPT2, *base],
                                          mode="train_dist"))
    extra = [] if mode == "sync" else [mode]
    args = args_from_cli([GPT2, *base, f"ckpt.save={tmp_path}",
                          "ckpt.save_interval=2", "rerun.inject_kind=preempt",
                          "rerun.inject_at_iter=2", *extra],
                         mode="train_dist")
    outs = []

    def attempt():
        if not args.ckpt.load:
            args.ckpt.load = args.ckpt.save
        out = train_dist.train(args)
        outs.append(out)
        return out.get("exit_code") or 0

    assert run_with_restarts(attempt, base_delay=0.0, sleep=lambda s: None,
                             log=lambda m: None) == 0
    assert [o["exit_code"] for o in outs] == [18, None]
    assert outs[0]["losses"] + outs[1]["losses"] == want["losses"]
    for (n, a), (_, b) in zip(named_leaves(outs[1]["params"]),
                              named_leaves(want["params"])):
        assert torch.equal(a.detach(), b.detach()), n
