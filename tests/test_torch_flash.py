"""Port flash attention (hetu_galvatron_tpu_torch.ops.flash_attention)
against the JAX Pallas kernels in interpret mode and the dense XLA core.

On the CPU the wrappers run the plain versions of K1-K3; the CUDA kernels
themselves are compared with those plain versions on the card
(``tests/test_torch_flash_cuda.py`` and ``chip_smoke.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.models.modules import xla_sdpa as jax_xla_sdpa
from hetu_galvatron_tpu.ops.pallas import flash_attention as JF
from hetu_galvatron_tpu_torch.models.modules import xla_sdpa
from hetu_galvatron_tpu_torch.ops import _build
from hetu_galvatron_tpu_torch.ops import flash_attention as TF

# fp32 on the CPU, same inputs: the two sides differ only in summation order
# (tiled online softmax vs dense), so 2e-5 covers it with margin
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)


def _qkv(B=2, S=32, N=4, K=2, D=16, Sk=None, seed=0):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((B, S, N, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32))


def _segments(B, S):
    cut1, cut2 = S // 3, S // 3 + S // 2
    seg = np.zeros((B, S), np.int32)
    seg[:, cut1:cut2] = 1
    seg[:, cut2:] = 2
    return seg


def _hmajor(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _jax_fwd(q, k, v, seg, seed, causal, rate):
    qh, kh, vh = (jnp.asarray(_hmajor(x)) for x in (q, k, v))
    o, lse = JF.flash_attention_hmajor(
        qh, kh, vh, None if seg is None else jnp.asarray(seg),
        None if seed is None else jnp.asarray([seed], jnp.int32),
        causal=causal, block_q=q.shape[1], block_k=k.shape[1],
        interpret=True, dropout_rate=rate)
    return np.array(o), np.array(lse)[..., 0]


def test_torch_keep_mask_bits_match_jax():
    seeds = [0, 7, -1, -2_147_483_648, 2_147_483_647, 123_456_789]
    qpos = np.array([0, 1, 5, 65_535, 65_536, 70_001, 2 ** 20 + 3],
                    np.int32)
    kpos = np.array([0, 3, 64, 65_537, 131_072, 999_999], np.int32)
    bn = np.array([0, 1, 11, 95, 1000], np.int32)
    for seed in seeds:
        for rate in (0.1, 0.5, 0.0):
            want = np.asarray(JF.keep_mask(
                jnp.int32(seed), jnp.asarray(bn)[:, None, None],
                jnp.asarray(qpos)[None, :, None],
                jnp.asarray(kpos)[None, None, :], rate))
            got = TF.keep_mask(seed, torch.from_numpy(bn)[:, None, None],
                               torch.from_numpy(qpos)[None, :, None],
                               torch.from_numpy(kpos)[None, None, :], rate)
            np.testing.assert_array_equal(got.numpy(), want)


FWD_CASES = {
    "causal_mha": dict(N=4, K=4, causal=True),
    "causal_gqa": dict(N=4, K=2, causal=True),
    "noncausal_gqa": dict(N=4, K=2, causal=False),
    "segments": dict(N=4, K=2, causal=True, seg=True),
    "dropout": dict(N=4, K=2, causal=True, rate=0.25, seed=-12345),
    "noncausal_sk_ne_s": dict(N=4, K=2, causal=False, Sk=16),
    "segments_dropout_noncausal": dict(N=4, K=2, causal=False, seg=True,
                                       rate=0.1, seed=99),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_torch_flash_fwd_plain_matches_jax_interpret(case):
    c = FWD_CASES[case]
    q, k, v = _qkv(N=c["N"], K=c["K"], Sk=c.get("Sk"))
    seg = _segments(q.shape[0], q.shape[1]) if c.get("seg") else None
    rate, seed = c.get("rate", 0.0), c.get("seed")
    want_o, want_lse = _jax_fwd(q, k, v, seg, seed, c["causal"], rate)
    o, lse = TF.flash_attention_hmajor(
        *(torch.from_numpy(_hmajor(x)) for x in (q, k, v)),
        None if seg is None else torch.from_numpy(seg), seed,
        causal=c["causal"], dropout_rate=rate)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_torch_flash_sdpa_matches_xla_core_ragged(causal):
    """Any length runs (S=23 tiles no block); the [B,S,N,D] seam equals
    both packages' dense core."""
    q, k, v = _qkv(S=23, N=4, K=2, seed=3)
    seg = _segments(2, 23)
    want = np.asarray(jax_xla_sdpa(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   segment_ids=jnp.asarray(seg)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = TF.flash_sdpa(tq, tk, tv, causal=causal,
                        segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = xla_sdpa(tq, tk, tv, causal=causal,
                     segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


BWD_CASES = {
    "causal_gqa": dict(causal=True),
    "noncausal_segments": dict(causal=False, seg=True),
    "causal_dropout": dict(causal=True, rate=0.3, seed=2024),
    "noncausal_sk_ne_s": dict(causal=False, Sk=16),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_torch_flash_bwd_plain_matches_jax_grad(case):
    """Plain K2 (dk, dv) and K3 (dq) through the autograd Function equal
    jax.grad of the interpret-mode Pallas kernels."""
    c = BWD_CASES[case]
    q, k, v = _qkv(N=4, K=2, Sk=c.get("Sk"), seed=1)
    seg = _segments(2, q.shape[1]) if c.get("seg") else None
    rate, seed = c.get("rate", 0.0), c.get("seed")
    cot = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def jloss(a, b, d):
        out = JF._flash_with_vjp(
            a, b, d, None if seg is None else jnp.asarray(seg),
            None if seed is None else jnp.asarray([seed], jnp.int32),
            c["causal"], True, q.shape[1], k.shape[1], rate)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = TF.flash_sdpa(tq, tk, tv, causal=c["causal"],
                        segment_ids=None if seg is None
                        else torch.from_numpy(seg),
                        dropout_rate=rate, dropout_seed=seed)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("case", ["causal_gqa", "noncausal_segments_dropout"])
def test_torch_flash_bwd_entry_matches_jax_with_outside_lse(case):
    """``flash_attention_bwd_hmajor`` against the JAX entry of the same name
    (interpret mode) on one caller-supplied (o, lse), as ring attention
    replays it."""
    causal = case == "causal_gqa"
    seg = None if causal else _segments(2, 32)
    rate, seed = (0.0, None) if causal else (0.2, 77)
    q, k, v = (_hmajor(x) for x in _qkv(N=4, K=2, seed=6))
    rng = np.random.default_rng(8)
    do = rng.standard_normal(q.shape).astype(np.float32)
    o, lse = _jax_fwd(*(x.transpose(0, 2, 1, 3) for x in (q, k, v)), seg,
                      seed, causal, rate)
    want = JF.flash_attention_bwd_hmajor(
        *(jnp.asarray(x) for x in (q, k, v, o)), jnp.asarray(lse)[..., None],
        jnp.asarray(do), None if seg is None else jnp.asarray(seg),
        None if seed is None else jnp.asarray([seed], jnp.int32),
        causal=causal, block_q=32, block_k=32, interpret=True,
        dropout_rate=rate)
    got = TF.flash_attention_bwd_hmajor(
        *(torch.from_numpy(x) for x in (q, k, v, o, lse, do)),
        None if seg is None else torch.from_numpy(seg), seed, causal=causal,
        dropout_rate=rate)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_torch_flash_plain_grads_match_autograd_of_dense_core():
    """The plain K2/K3 formulas equal autograd through the dense core."""
    q, k, v = _qkv(S=20, N=4, K=2, seed=4)
    args = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    ref = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    g1 = torch.autograd.grad(TF.flash_sdpa(*args).square().sum(), args)
    g2 = torch.autograd.grad(xla_sdpa(*ref).square().sum(), ref)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_torch_flash_cpu_wrapper_counts_no_launches():
    _build.reset_launch_counts()
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv())
    TF.flash_sdpa(q, k, v).sum().backward()
    assert _build.launch_counts == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                                    "flash_bwd_dq": 0, "ce_fwd": 0,
                                    "ce_bwd": 0}
    assert TF.flash_sdpa.supports_segments and TF.flash_sdpa.supports_dropout


def test_torch_flash_rejects_what_the_kernels_do_not_take():
    meta = [torch.empty(1, 2, 8, 16, device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        TF.flash_attention_hmajor(*meta)
    with pytest.raises(ValueError, match="segment ids"):
        TF.flash_attention_hmajor(*(torch.zeros(2, 2, 8, 16)
                                    for _ in range(3)),
                                  torch.zeros(2, 9, dtype=torch.int32))
    q, k, v = (torch.from_numpy(_hmajor(x)) for x in _qkv(Sk=16))
    with pytest.raises(ValueError, match="causal"):
        TF.flash_attention_hmajor(q, k, v, causal=True)
    q, k, v = (torch.zeros(1, 2, 8, 160) for _ in range(3))
    with pytest.raises(ValueError, match="head_dim"):
        TF.flash_attention_hmajor(q, k, v)
    with pytest.raises(ValueError, match="dropout_seed"):
        TF.flash_attention_hmajor(*(torch.zeros(1, 2, 8, 16)
                                    for _ in range(3)), dropout_rate=0.1)


# ---------------------------------------------------------------------------
# the route each kernel takes (ops/flash_attention.py::kernel_route)
# ---------------------------------------------------------------------------

BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32
# (B, S, N, K, D, dtype, layout) -> routes of K1, K2, K3. The main paths
# take q/k/v as views of the fused qkv projection ("fused"), T5's
# cross-attention q from its own projection and k/v from a fused kv one
# ("cross"); the phase-3 cases of chip_smoke.py are contiguous
# ("hmajor") or rows d + 3 elements apart ("unaligned"). A fused view's
# batch stride is S (N + 2K) D, a multiple of 8 for any S when (N + 2K) D
# is, so the main paths are built at S=16.
ROUTE_CASES = {
    "gpt2": (8, 16, 12, 12, 64, BF16, "fused", "wgmma"),
    "qwen": (2, 16, 28, 4, 128, BF16, "fused", "wgmma"),
    "qwen_b1": (1, 16, 28, 4, 128, BF16, "fused", "wgmma"),
    "qwen_tp2": (2, 16, 14, 2, 128, BF16, "fused", "wgmma"),
    "qwen_fp16": (2, 16, 28, 4, 128, FP16, "fused", "wgmma"),
    "mixtral": (2, 16, 32, 8, 128, BF16, "fused", "wgmma"),
    "llama": (1, 16, 64, 8, 128, BF16, "fused", "wgmma"),
    "bert": (2, 16, 16, 16, 64, BF16, "fused", "wgmma"),
    "t5_self": (2, 16, 32, 32, 64, BF16, "fused", "wgmma"),
    "t5_cross": (2, 16, 32, 32, 64, BF16, "cross", "wgmma"),
    "gqa_s200": (2, 200, 8, 2, 64, BF16, "hmajor", "wgmma"),
    "ragged_s130_d128": (1, 130, 4, 4, 128, BF16, "hmajor", "wgmma"),
    "fp16_s200": (2, 200, 8, 2, 64, FP16, "hmajor", "wgmma"),
    "d32": (3, 77, 6, 3, 32, BF16, "hmajor", "mma"),
    "d40": (2, 200, 4, 2, 40, BF16, "hmajor", "mma"),
    "d40_unaligned_fp16": (2, 77, 4, 2, 40, FP16, "unaligned", "mma"),
    "unaligned": (2, 200, 8, 2, 64, BF16, "unaligned", "mma"),
    "fp32_gpt2": (2, 16, 12, 12, 64, FP32, "fused", "fma"),
    "fp32_s200": (2, 200, 8, 2, 64, FP32, "hmajor", "fma"),
}


def _route_operands(B, S, N, K, D, dtype, layout):
    """q, k, v, dO and the outputs o / dk / dv as the wrappers lay them."""
    def rows(h, length):
        if layout == "unaligned":
            return torch.zeros(B, h, length, D + 3, dtype=dtype)[..., :D]
        return torch.zeros(B, h, length, D, dtype=dtype)

    if layout == "fused":
        qkv = torch.zeros(B, S, (N + 2 * K) * D, dtype=dtype)
        q, k, v = torch.split(qkv, [N * D, K * D, K * D], dim=-1)
        q = q.view(B, S, N, D).transpose(1, 2)
        k, v = (x.view(B, S, K, D).transpose(1, 2) for x in (k, v))
    elif layout == "cross":
        q = torch.zeros(B, S, N * D, dtype=dtype).view(B, S, N, D)
        q = q.transpose(1, 2)
        k, v = torch.chunk(torch.zeros(B, S, 2 * K * D, dtype=dtype), 2, -1)
        k, v = (x.view(B, S, K, D).transpose(1, 2) for x in (k, v))
    else:
        q, k, v = rows(N, S), rows(K, S), rows(K, S)
    do = torch.zeros(B, S, N, D, dtype=dtype).transpose(1, 2)
    o = torch.empty((B, S, N, D), dtype=dtype).transpose(1, 2)
    dk = torch.empty((B, S, K, D), dtype=dtype).transpose(1, 2)
    return q, k, v, do, o, dk


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_torch_kernel_route_at_every_path_and_phase3_case(case):
    """K1 and K2 take the wgmma route at D = 64 or 128 in 16 bits on
    operands TMA can describe (every main path's fused views), mma.sync
    at D=32, D=40 and on rows d + 3 apart, the FMA kernels in fp32; K3
    stays on mma.sync. The operands are those the wrappers hand the C side,
    outputs included (``_launch`` decides over every rank-4 operand)."""
    *shape, want = ROUTE_CASES[case]
    q, k, v, do, o, dk = _route_operands(*shape)
    assert TF.kernel_route("flash_fwd", q, k, v, o) == want
    assert TF.kernel_route("flash_bwd_dkdv", q, k, v, do, dk, dk) == want
    assert TF.kernel_route("flash_bwd_dq", q, k, v, do, o) == (
        "fma" if want == "fma" else "mma")


def test_torch_kernel_route_follows_the_base_and_the_strides():
    """One element off 16 bytes, or a position stride that is not a
    multiple of 8, takes mma.sync; the C side refuses the wgmma route on the
    same operands (csrc/flash_sm90.cuh ``tma_ok``: D = 64 or 128 and
    ``rows_16b``), and the route codes match csrc/flash_common.cuh."""
    x = torch.zeros(1, 2, 8, 72, dtype=BF16)
    assert TF.kernel_route("flash_fwd", *[x[..., :64]] * 3) == "wgmma"
    assert TF.kernel_route("flash_fwd", *[x[..., 1:65]] * 3) == "mma"
    y = torch.zeros(1, 2, 8, 68, dtype=BF16)[..., :64]
    assert TF.kernel_route("flash_bwd_dkdv", *[y] * 4) == "mma"
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "hetu_galvatron_tpu_torch", "csrc")
    with open(os.path.join(csrc, "flash_common.cuh")) as f:
        enum = f.read()
    for name, code in TF.ROUTES.items():
        assert re.search(rf"kRoute{name.capitalize()} = {code}\b", enum)
    with open(os.path.join(csrc, "flash_sm90.cuh")) as f:
        rule = f.read()
    assert "return (D == 64 || D == 128) && rows_16b(p, s, D);" in rule
