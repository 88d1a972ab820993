"""Port fused cross-entropy (hetu_galvatron_tpu_torch.ops.cross_entropy)
against the JAX Pallas kernels K4/K5 run in interpret mode on the CPU.

On the CPU the port's wrappers take the plain versions of K4/K5, so these
tests hold the plain versions and the autograd composition around them
(``_CELseGold``, ``fused_ce_nll``) to the JAX ``_ce_fwd_call`` /
``_ce_bwd_call`` / ``fused_ce_nll``. All fp32: values agree to 1e-5 and
gradients to 1e-6 absolute (gradients are softmax entries of order 1/V,
their sums differ only by summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.models import modules as JM
from hetu_galvatron_tpu.ops.pallas import cross_entropy as JC
from hetu_galvatron_tpu_torch.models import modules as TM
from hetu_galvatron_tpu_torch.ops import _build
from hetu_galvatron_tpu_torch.ops import cross_entropy as TC

VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _data(T, V, seed=0, scale=3.0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(T, V) * scale).astype(np.float32)
    labels = rng.randint(0, V, (T,)).astype(np.int32)
    return logits, labels


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("V", [256, 1024])
def test_torch_ce_plain_kernels_match_jax_pallas(V):
    """ce_fwd_plain / ce_bwd_plain against the Pallas K4 / K5 calls, with
    labels inside and outside [0, V)."""
    T = 64
    logits, labels = _data(T, V, seed=V)
    labels[3], labels[10] = -1, V  # out of range: gold 0, no one-hot
    bv = JC.fit_vocab_block(V)
    jl, jg = JC._ce_fwd_call(jnp.asarray(logits),
                             jnp.asarray(labels)[:, None], block_t=32,
                             block_v=bv, interpret=True)
    lse, gold = TC.ce_fwd_plain(_t(logits), _t(labels).long())
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:, 0], **VAL_TOL)
    np.testing.assert_allclose(gold.numpy(), np.asarray(jg)[:, 0],
                               rtol=0, atol=0)
    assert gold[3] == 0 and gold[10] == 0
    rng = np.random.RandomState(1)
    a = rng.randn(T).astype(np.float32)
    b = rng.randn(T).astype(np.float32)
    jdx = JC._ce_bwd_call(jnp.asarray(logits), jnp.asarray(labels)[:, None],
                          jl, jnp.asarray(a)[:, None],
                          jnp.asarray(b)[:, None], block_t=32, block_v=bv,
                          interpret=True)
    dx = TC.ce_bwd_plain(_t(logits), _t(labels).long(), lse, _t(a), _t(b))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **GRAD_TOL)


@pytest.mark.parametrize("V", [256, 1024])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_torch_fused_nll_values_and_grads_match_jax(V, z_loss):
    logits, labels = _data(64, V, seed=3)
    logits = logits.reshape(2, 32, V)
    labels = labels.reshape(2, 32)
    g = np.random.RandomState(4).randn(2, 32).astype(np.float32)

    def jloss(x):
        return jnp.sum(JC.fused_ce_nll(x, jnp.asarray(labels), z_loss=z_loss,
                                       interpret=True) * g)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    nll = TC.fused_ce_nll(x, _t(labels).long(), z_loss=z_loss)
    assert nll.shape == (2, 32) and nll.dtype == torch.float32
    want_nll = JC.fused_ce_nll(jnp.asarray(logits), jnp.asarray(labels),
                               z_loss=z_loss, interpret=True)
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want_nll),
                               **VAL_TOL)
    val = (nll * _t(g)).sum()
    (grad,) = torch.autograd.grad(val, x)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_torch_fused_nll_out_of_range_labels_follow_the_plain_formula():
    """Out-of-range labels: nll = lse (+ z lse^2) and the gradient is the
    softmax times d_lse alone, as the JAX kernel's ``vpos == lab``."""
    logits, labels = _data(16, 300, seed=5)  # V = 300: no JAX tile fits
    labels[:4] = [-1, 300, 1000, -7]
    x = _t(logits).requires_grad_(True)
    z = 1e-3
    nll = TC.fused_ce_nll(x, _t(labels).long(), z_loss=z)
    lse = torch.logsumexp(_t(logits), dim=-1)
    gold = torch.gather(_t(logits), -1, _t(labels).long().clamp(0, 299)
                        [:, None])[:, 0]
    gold[:4] = 0.0
    torch.testing.assert_close(nll.detach(), lse - gold + z * lse.square(),
                               rtol=1e-6, atol=1e-5)
    (grad,) = torch.autograd.grad(nll.sum(), x)
    p = torch.softmax(_t(logits), dim=-1)
    want = p * (1 + 2 * z * lse)[:, None]
    ok = torch.arange(16) >= 4
    want[ok, _t(labels).long()[ok]] -= 1.0
    torch.testing.assert_close(grad, want, rtol=1e-5, atol=1e-6)


def test_torch_ce_equal_logits_give_log_v():
    V = 1000
    logits = torch.full((3, V), 2.5)
    lse, gold = TC.ce_fwd_plain(logits, torch.tensor([0, 999, 1000]))
    torch.testing.assert_close(lse, torch.full((3,), 2.5 + np.log(V)),
                               rtol=0, atol=1e-6)
    assert gold.tolist() == [2.5, 2.5, 0.0]


def test_torch_ce_takes_a_row_stride_larger_than_v():
    logits, labels = _data(12, 77, seed=6)
    wide = torch.zeros(12, 90)
    wide[:, :77] = _t(logits)
    view = wide[:, :77]
    assert view.stride(0) == 90
    for a, b in zip(TC.ce_fwd(view, _t(labels).long()),
                    TC.ce_fwd(_t(logits), _t(labels).long())):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_torch_cross_entropy_loss_fused_with_mask_matches_jax():
    rng = np.random.default_rng(7)
    logits = 2.0 * rng.standard_normal((2, 16, 256)).astype(np.float32)
    labels = rng.integers(0, 256, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.5).astype(np.float32)

    def jloss(x):
        return JM.cross_entropy_loss(x, jnp.asarray(labels),
                                     jnp.asarray(mask), z_loss=1e-4,
                                     fused=True)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    val = TM.cross_entropy_loss(x, _t(labels).long(), _t(mask), z_loss=1e-4,
                                fused=True)
    (grad,) = torch.autograd.grad(val, x)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_torch_ce_wrappers_never_fall_back_for_a_cuda_request(monkeypatch):
    """A wrapper that is told its tensor lies on a CUDA device launches its
    kernel or raises; here, with no card and no kernel library, it raises
    and counts no launch (a quiet fall-back to the plain version would
    return a result)."""
    def no_library(rebuild=False):
        raise RuntimeError("no CUDA kernel library on this machine")

    monkeypatch.setattr(TC, "_on_cuda", lambda name, logits: True)
    monkeypatch.setattr(_build, "load_library", no_library)
    _build.reset_launch_counts()
    logits, labels = _data(4, 64)
    x, lab = _t(logits), _t(labels).long()
    row = torch.zeros(4)
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        TC.ce_fwd(x, lab)
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        TC.ce_bwd(x, lab, row, row, row)
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        TC.fused_ce_nll(x, lab)
    assert sum(_build.launch_counts.values()) == 0


def test_torch_ce_wrappers_check_their_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        TC.ce_fwd(torch.zeros(4, 8, device="meta"),
                  torch.zeros(4, dtype=torch.long, device="meta"))
    with pytest.raises(ValueError, match=r"\[T, V\]"):
        TC.ce_fwd(torch.zeros(2, 4, 8), torch.zeros(2, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="labels"):
        TC.ce_fwd(x, torch.zeros(5, dtype=torch.long))
    # the CPU route runs the plain versions and launches nothing
    _build.reset_launch_counts()
    TC.fused_ce_nll(x.requires_grad_(True), torch.zeros(4, dtype=torch.long)
                    ).sum().backward()
    assert sum(_build.launch_counts.values()) == 0
