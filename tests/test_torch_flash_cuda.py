"""The CUDA flash kernels (K1-K3) against their plain versions, on the card.

This file itself imports torch and numpy only; on a machine with a card
run ``python -m pytest tests/test_torch_flash_cuda.py -q``. Without a CUDA
device every test skips.
"""

import numpy as np
import pytest
import torch

from hetu_galvatron_tpu_torch.ops import _build
from hetu_galvatron_tpu_torch.ops import flash_attention as TF

pytestmark = pytest.mark.cuda


def _segments(B, S):
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 3:S // 3 + S // 2] = 1
    seg[:, S // 3 + S // 2:] = 2
    return seg


def test_torch_flash_kernels_match_plain_on_cuda():
    """On the card: K1-K3 against their plain versions (fp32 inputs, GQA,
    segments, dropout, ragged S); launches are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.manual_seed(0)
    dev = torch.device("cuda")
    q = torch.randn(2, 200, 8, 64, device=dev, requires_grad=True)
    k = torch.randn(2, 200, 2, 64, device=dev, requires_grad=True)
    v = torch.randn(2, 200, 2, 64, device=dev, requires_grad=True)
    seg = torch.from_numpy(_segments(2, 200)).to(dev)
    _build.reset_launch_counts()
    out = TF.flash_sdpa(q, k, v, segment_ids=seg, dropout_rate=0.1,
                        dropout_seed=7)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert _build.launch_counts == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                                    "flash_bwd_dq": 1, "ce_fwd": 0,
                                    "ce_bwd": 0}
    qh, kh, vh, gh = (t.detach().transpose(1, 2) for t in (q, k, v, g))
    o, lse = TF.flash_fwd_plain(qh, kh, vh, seg, 7, dropout_rate=0.1)
    np.testing.assert_allclose(out.detach().transpose(1, 2).cpu().numpy(),
                               o.cpu().numpy(), rtol=1e-4, atol=1e-4)
    delta = (gh * o).sum(-1)
    dk, dv = TF.flash_bwd_dkdv_plain(qh, kh, vh, gh, lse, delta, seg, 7,
                                     dropout_rate=0.1)
    dq = TF.flash_bwd_dq_plain(qh, kh, vh, gh, lse, delta, seg, 7,
                               dropout_rate=0.1)
    for a, b in zip(grads, (dq, dk, dv)):
        np.testing.assert_allclose(a.transpose(1, 2).cpu().numpy(),
                                   b.cpu().numpy(), rtol=1e-4, atol=1e-4)


def _runs(B, S, seed):
    """Segment ids in runs of 1-40 positions, repeating out of order."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        ids = []
        while len(ids) < S:
            ids += [int(rng.integers(0, 4))] * int(rng.integers(1, 41))
        rows.append(ids[:S])
    return np.asarray(rows, np.int32)


# 16-bit K2/K3 (tensor cores) against their plain versions: D zero-padded
# to a multiple of 16, unsorted segment ids, rows whose stride is not a
# multiple of 8 elements (element-wise loads), fp16, GQA and dropout
TC_CASES = {
    "bf16_d40_packed": dict(dtype=torch.bfloat16, D=40, seg="packed"),
    "bf16_unsorted_segments_dropout": dict(dtype=torch.bfloat16, D=64,
                                           seg="runs", rate=0.1),
    "bf16_unaligned_strides": dict(dtype=torch.bfloat16, D=64,
                                   seg="packed", pad=3),
    "fp16_d40_unaligned_noncausal": dict(dtype=torch.float16, D=40,
                                         causal=False, pad=3, Sk=136),
    "fp16_gqa_packed_dropout": dict(dtype=torch.float16, D=128,
                                    seg="packed", rate=0.1),
}


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_torch_flash_bwd_tensor_core_kernels_match_plain_on_cuda(case):
    """Every element of dk, dv, dq within 2e-2 * (rms(want) + |want|), the
    16-bit tolerance of chip_smoke.py phase 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    c = TC_CASES[case]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    B, N, K, S, D = 2, 8, 2, 200, c["D"]
    Sk = c.get("Sk", S)
    pad = c.get("pad", 0)

    def rnd(h, length):
        x = torch.randn(B, h, length, D + pad, device=dev, generator=gen)
        return x.to(c["dtype"])[..., :D]

    q, do, k, v = rnd(N, S), rnd(N, S), rnd(K, Sk), rnd(K, Sk)
    seg = {"packed": lambda: torch.from_numpy(_segments(B, S)),
           "runs": lambda: torch.from_numpy(_runs(B, S, 5)),
           None: lambda: None}[c.get("seg")]()
    seg = None if seg is None else seg.to(dev)
    causal, rate = c.get("causal", True), c.get("rate", 0.0)
    seed = 11 if rate > 0 else None
    kw = dict(causal=causal, dropout_rate=rate)
    o, lse = TF.flash_fwd_plain(q, k, v, seg, seed, **kw)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse.contiguous(), delta, seg, seed)
    _build.reset_launch_counts()
    got = (*TF.flash_bwd_dkdv(*args, **kw), TF.flash_bwd_dq(*args, **kw))
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_bwd_dkdv"] == 1
    assert _build.launch_counts["flash_bwd_dq"] == 1
    want = (*TF.flash_bwd_dkdv_plain(*args, **kw),
            TF.flash_bwd_dq_plain(*args, **kw))
    for g, w in zip(got, want):
        assert g.dtype == c["dtype"] and g.shape == w.shape
        g, w = g.float(), w.float()
        limit = 2e-2 * (w.square().mean().sqrt() + w.abs())
        assert ((g - w).abs() <= limit).all()


# 16-bit K1 (tensor cores) against its plain version: D 32, 40 (padded to
# 64), 64 and 128, GQA, packed and unsorted segment ids, dropout, non-causal
# Sk != S, and rows whose stride is not a multiple of 8 elements
FWD_TC_CASES = {
    "bf16_d32_packed": dict(dtype=torch.bfloat16, D=32, seg="packed"),
    "bf16_d40_unsorted_dropout": dict(dtype=torch.bfloat16, D=40,
                                      seg="runs", rate=0.1),
    "bf16_d64_unaligned_packed": dict(dtype=torch.bfloat16, D=64,
                                      seg="packed", pad=3),
    "bf16_d128_noncausal_sk136_dropout": dict(dtype=torch.bfloat16, D=128,
                                              causal=False, Sk=136,
                                              rate=0.1),
    "fp16_d40_unaligned_noncausal": dict(dtype=torch.float16, D=40,
                                         causal=False, pad=3, Sk=136),
    "fp16_d64_unsorted": dict(dtype=torch.float16, D=64, seg="runs"),
    "fp16_d128_gqa_packed_dropout": dict(dtype=torch.float16, D=128,
                                         seg="packed", rate=0.1),
}


@pytest.mark.parametrize("case", sorted(FWD_TC_CASES))
def test_torch_flash_fwd_tensor_core_kernel_matches_plain_on_cuda(case):
    """Every element of o within 2e-2 * (rms(want) + |want|) and lse within
    1e-3 absolute, the tolerances of chip_smoke.py phase 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    c = FWD_TC_CASES[case]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    B, N, K, S, D = 2, 8, 2, 200, c["D"]
    Sk = c.get("Sk", S)
    pad = c.get("pad", 0)

    def rnd(h, length):
        x = torch.randn(B, h, length, D + pad, device=dev, generator=gen)
        return x.to(c["dtype"])[..., :D]

    q, k, v = rnd(N, S), rnd(K, Sk), rnd(K, Sk)
    seg = {"packed": lambda: torch.from_numpy(_segments(B, S)),
           "runs": lambda: torch.from_numpy(_runs(B, S, 6)),
           None: lambda: None}[c.get("seg")]()
    seg = None if seg is None else seg.to(dev)
    rate = c.get("rate", 0.0)
    seed = 13 if rate > 0 else None
    kw = dict(causal=c.get("causal", True), dropout_rate=rate)
    _build.reset_launch_counts()
    o, lse = TF.flash_attention_hmajor(q, k, v, seg, seed, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == 1
    o_p, lse_p = TF.flash_fwd_plain(q, k, v, seg, seed, **kw)
    assert o.dtype == c["dtype"] and o.shape == o_p.shape
    g, w = o.float(), o_p.float()
    limit = 2e-2 * (w.square().mean().sqrt() + w.abs())
    assert ((g - w).abs() <= limit).all()
    assert float((lse - lse_p).abs().max()) <= 1e-3


# K1 and K2 on the wgmma + TMA route (bf16 / fp16, D = 64 or 128, operands
# TMA can describe): small cases (GQA, packed and unsorted segments,
# dropout, a ragged S, non-causal Sk != S), GPT-2's and the Qwen path's
# fused-qkv views, and one row with 4 kv heads (K2's cluster split at its
# smallest grid); each against the plain versions, and the mma.sync route
# at the same inputs
WG_CASES = {
    "bf16_d64_gqa_packed_dropout": dict(dtype=torch.bfloat16, B=2, N=8, K=2,
                                        S=200, D=64, seg="packed",
                                        rate=0.1),
    "fp16_d64_unsorted": dict(dtype=torch.float16, B=2, N=8, K=2, S=300,
                              D=64, seg="runs"),
    "bf16_d128_unsorted_dropout": dict(dtype=torch.bfloat16, B=2, N=8, K=2,
                                       S=300, D=128, seg="runs", rate=0.1),
    "fp16_d128_noncausal_sk136": dict(dtype=torch.float16, B=2, N=8, K=2,
                                      S=200, D=128, causal=False, Sk=136),
    "bf16_d128_ragged_s130": dict(dtype=torch.bfloat16, B=1, N=4, K=4,
                                  S=130, D=128),
    "bf16_d64_gpt2_fused": dict(dtype=torch.bfloat16, B=8, N=12, K=12,
                                S=1024, D=64, fused=True),
    "bf16_d128_qwen_b1_k4_packed": dict(dtype=torch.bfloat16, B=1, N=28,
                                        K=4, S=4096, D=128, seg="packed",
                                        fused=True),
}


def _close(got, want, tol=2e-2):
    g, w = got.float(), want.float()
    limit = tol * (w.square().mean().sqrt() + w.abs())
    return float(((g - w).abs() / limit).max())


@pytest.mark.parametrize("case", sorted(WG_CASES))
def test_torch_flash_wgmma_route_matches_plain_on_cuda(case):
    """K1 and K2 on the wgmma route: o, dk, dv within 2e-2 * (rms(want) +
    |want|) and lse within 1e-3 absolute of the plain versions (phase 3's
    rule), one launch a call, and the mma.sync route within the same rule
    at the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    c = WG_CASES[case]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    B, N, K, S, D = c["B"], c["N"], c["K"], c["S"], c["D"]
    Sk = c.get("Sk", S)
    dt = c["dtype"]

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dt)

    if c.get("fused"):
        qkv = rnd(B, S, (N + 2 * K) * D)
        q, k, v = torch.split(qkv, [N * D, K * D, K * D], dim=-1)
        q = q.view(B, S, N, D).transpose(1, 2)
        k = k.view(B, S, K, D).transpose(1, 2)
        v = v.view(B, S, K, D).transpose(1, 2)
    else:
        q, k, v = rnd(B, N, S, D), rnd(B, K, Sk, D), rnd(B, K, Sk, D)
    do = rnd(B, S, N, D).transpose(1, 2)
    seg = {"packed": lambda: torch.from_numpy(_segments(B, S)),
           "runs": lambda: torch.from_numpy(_runs(B, S, 8)),
           None: lambda: None}[c.get("seg")]()
    seg = None if seg is None else seg.to(dev)
    rate = c.get("rate", 0.0)
    seed = 17 if rate > 0 else None
    kw = dict(causal=c.get("causal", True), dropout_rate=rate)
    assert TF.kernel_route("flash_fwd", q, k, v) == "wgmma"
    assert TF.kernel_route("flash_bwd_dkdv", q, k, v, do) == "wgmma"
    assert TF.kernel_route("flash_bwd_dq", q, k, v, do) == "mma"

    _build.reset_launch_counts()
    o, lse = TF.flash_attention_hmajor(q, k, v, seg, seed, **kw)
    torch.cuda.synchronize()
    o_p, lse_p = TF.flash_fwd_plain(q, k, v, seg, seed, **kw)
    assert o.dtype == dt and o.shape == o_p.shape
    assert _close(o, o_p) <= 1.0
    assert float((lse - lse_p).abs().max()) <= 1e-3
    delta = (do.float() * o.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta, seg, seed)
    dk, dv = TF.flash_bwd_dkdv(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == 1
    assert _build.launch_counts["flash_bwd_dkdv"] == 1
    dk_p, dv_p = TF.flash_bwd_dkdv_plain(*args, **kw)
    assert dk.dtype == dt and dk.shape == dk_p.shape
    assert _close(dk, dk_p) <= 1.0 and _close(dv, dv_p) <= 1.0
    # the same inputs on the mma.sync kernels
    o_m, lse_m = TF.flash_attention_hmajor(q, k, v, seg, seed, _route="mma",
                                           **kw)
    dk_m, dv_m = TF.flash_bwd_dkdv(*args, _route="mma", **kw)
    torch.cuda.synchronize()
    assert _close(o_m, o_p) <= 1.0
    assert float((lse_m - lse_p).abs().max()) <= 1e-3
    assert _close(dk_m, dk_p) <= 1.0 and _close(dv_m, dv_p) <= 1.0
    # a repeat gives the same bits (no atomics; fixed sum orders)
    o2, _ = TF.flash_attention_hmajor(q, k, v, seg, seed, **kw)
    dk2, dv2 = TF.flash_bwd_dkdv(*args, **kw)
    assert torch.equal(o, o2) and torch.equal(dk, dk2)
    assert torch.equal(dv, dv2)


def test_torch_flash_wgmma_route_refuses_what_tma_cannot_describe():
    """Forcing the wgmma route on rows 67 elements apart (not a multiple of
    8) or at D=40: the C side refuses, the wrapper raises, nothing is
    counted; the route rule sends both to mma.sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    x = torch.randn(1, 4, 128, 67, device=dev).to(torch.bfloat16)[..., :64]
    y = torch.randn(1, 4, 128, 40, device=dev).to(torch.bfloat16)
    for t in (x, y):
        assert TF.kernel_route("flash_fwd", t, t, t) == "mma"
        _build.reset_launch_counts()
        with pytest.raises(RuntimeError, match="failed to launch"):
            TF.flash_attention_hmajor(t, t, t, _route="wgmma")
        assert _build.launch_counts["flash_fwd"] == 0
