"""Per-layer remat in the port (``models.modules.remat``, the
``remat_flags`` of ``models.builder``, ``parallel.global_checkpoint``).

``torch.utils.checkpoint`` restores only the global RNG state before it
recomputes a layer, while the port draws dropout from explicit
``torch.Generator``s. Each layer therefore builds its generators inside
itself from a seed drawn before the checkpointed region, so the recompute
draws the same masks. These tests hold remat against no remat with hidden
and attention dropout on, under every policy: the loss and every gradient
bit-equal (the same operations in the same order on the CPU).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import modules as TM
from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH

QWEN = dict(model_type="llama", hidden_size=112, num_hidden_layers=3,
            num_attention_heads=7, num_key_value_heads=1, ffn_hidden_size=160,
            vocab_size=512, max_position_embeddings=64, seq_length=32,
            hidden_act="swiglu", normalization="rmsnorm",
            position_embedding_type="rope", rope_theta=1e6,
            tie_word_embeddings=False, add_bias_linear=False,
            add_qkv_bias=True, hidden_dropout=0.1, attention_dropout=0.1,
            use_fused_ce=True)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (2, 33))
    seg = np.repeat(np.array([[0, 1, 2, 2]]), 8, axis=1)
    pos = np.concatenate([np.arange(8)] * 2 + [np.arange(16)])[None]
    return {"tokens": torch.from_numpy(tokens[:, :-1]),
            "labels": torch.from_numpy(tokens[:, 1:]),
            "loss_mask": torch.from_numpy(
                (rng.random((2, 32)) < 0.8).astype(np.float32)),
            "segment_ids": torch.from_numpy(np.repeat(seg, 2, axis=0)),
            "position_ids": torch.from_numpy(np.repeat(pos, 2, axis=0))}


def _loss_and_grads(cfg, params, flags, seed):
    batch = dict(_batch(), dropout_rng=torch.Generator().manual_seed(seed))
    loss = TB.causal_lm_loss(params, batch, cfg, remat_flags=flags,
                             compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, [t for _, t in TB.named_leaves(params)])
    return loss.detach(), grads


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_torch_remat_with_dropout_is_bit_equal_to_no_remat(policy):
    cfg = ModelArgs(**QWEN, remat_policy=policy)
    params = TB.init_causal_lm(cfg, seed=3)
    want_loss, want = _loss_and_grads(cfg, params, None, seed=11)
    for flags in ([True, True, True], [False, True, False]):
        loss, got = _loss_and_grads(cfg, params, flags, seed=11)
        assert torch.equal(loss, want_loss), (flags, loss, want_loss)
        for (name, _), g, w in zip(TB.named_leaves(params), got, want):
            assert torch.equal(g, w), (flags, name)
    # the dropout is live: another step's stream gives another loss
    other, _ = _loss_and_grads(cfg, params, [True] * 3, seed=12)
    assert not torch.equal(other, want_loss)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_torch_remat_recomputes_in_the_backward():
    """"full" runs the layer a second time in the backward, its two matrix
    products included; "dots" runs it again too but takes the products'
    outputs from the first pass. Under no_grad the layer runs once."""
    calls = {"layer": 0}
    w = torch.randn(8, 8, requires_grad=True)

    def layer(x):
        calls["layer"] += 1
        return torch.tanh(torch.tanh(x @ w) @ w)

    x = torch.randn(4, 8, requires_grad=True)
    want = torch.autograd.grad(layer(x).sum(), x)[0]
    backward_mms = {}
    for policy in ("full", "dots", "dots_no_batch"):
        calls["layer"] = 0
        out = TM.remat(layer, ModelArgs(remat_policy=policy))(x)
        assert calls["layer"] == 1
        with _CountMatmuls() as count:
            (got,) = torch.autograd.grad(out.sum(), x)
        assert calls["layer"] == 2
        backward_mms[policy] = count.n
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert backward_mms["full"] == backward_mms["dots"] + 2
    assert backward_mms["dots_no_batch"] == backward_mms["dots"]
    calls["layer"] = 0
    with torch.no_grad():
        TM.remat(layer, ModelArgs())(x)
    assert calls["layer"] == 1


def test_torch_remat_rejects_an_unknown_policy():
    cfg = ModelArgs()
    cfg.remat_policy = "offload"  # set after validation, as JAX's
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TM.remat(lambda x: x, cfg)
    with pytest.raises(ValueError, match="remat_policy"):
        load_config(None, ["model.remat_policy=offload"])


def test_torch_global_checkpoint_sets_every_layer():
    base = ["model.num_hidden_layers=5"]
    hpc = TH.get_hybrid_parallel_config(load_config(None, base), 1)
    assert hpc.checkpoint_flags == [False] * 5
    hpc = TH.get_hybrid_parallel_config(
        load_config(None, base + ["parallel.global_checkpoint=1"]), 1)
    assert hpc.checkpoint_flags == [True] * 5
    assert "remat 5/5 layers" in hpc.describe()
