"""What surrounds the 16-bit flash kernels K1-K3, on the CPU.

The CUDA kernels compute a (q-tile, k-tile) pair only where causality and
the tiles' segment-id ranges allow, reducing each tile's ids themselves;
``ops.flash_attention.computed_tiles`` (with ``tile_segment_ranges``) is
the same rule in torch. These tests hold that rule to the dense mask of
attended pairs, count its tiles at the packed layout of ``chip_smoke.py``,
and check tile-by-tile emulations of the kernels' arithmetic against the
JAX Pallas kernels in interpret mode: the forward's online softmax (fp32
scores, m, l and corr, P rounded to the 16-bit type) and the backward's (P
and dS rounded to the 16-bit type), bf16 as hi + lo and fp16 once, fp32
sums, each with its skipped tiles left out.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hetu_galvatron_tpu.ops.pallas import flash_attention as JF
from hetu_galvatron_tpu_torch.ops import flash_attention as TF

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "hetu_galvatron_tpu_torch", "csrc")
# the 16-bit tolerance of chip_smoke.py phase 3: every element within
# 2e-2 * (rms(want) + |want|)
TOL_16 = 2e-2
TILES = [(32, 64), (64, 32), (64, 64), (16, 48),
         # the wgmma route's: K1 at D=64 and D=128, K2
         (128, 128), (128, 64), (64, 128)]


def _packed(B, S):  # chip_smoke.segments_for: thirds, halves, sixths
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 3:S // 3 + S // 2] = 1
    seg[:, S // 3 + S // 2:] = 2
    return seg


def _unsorted_runs(B, S, seed):
    """Runs of 1-40 positions whose ids (0-3) repeat out of order."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        ids = []
        while len(ids) < S:
            ids += [int(rng.integers(0, 4))] * int(rng.integers(1, 41))
        rows.append(ids[:S])
    return np.asarray(rows, np.int32)


SEGMENT_CASES = {
    "causal_ragged_packed": dict(S=77, causal=True, seg="packed"),
    "causal_packed_4096": dict(S=4096, causal=True, seg="packed"),
    "causal_unsorted_runs": dict(S=150, causal=True, seg="runs"),
    "causal_unsorted_0102": dict(S=130, causal=True, seg="0102"),
    "noncausal_unsorted_runs": dict(S=97, causal=False, seg="runs"),
    "noncausal_sk_ne_s": dict(S=200, Sk=136, causal=False, seg=None),
    "causal_ragged_no_segments": dict(S=77, causal=True, seg=None),
}


def _case_segments(c, B=2):
    if c["seg"] == "packed":
        return torch.from_numpy(_packed(B, c["S"]))
    if c["seg"] == "runs":
        return torch.from_numpy(_unsorted_runs(B, c["S"], seed=c["S"]))
    if c["seg"] == "0102":  # per-position ids 0, 1, 0, 2 drawn at random
        rng = np.random.default_rng(11)
        return torch.from_numpy(rng.choice(
            np.array([0, 1, 0, 2], np.int32), size=(B, c["S"])))
    return None


def _expand(tiles, tq, tk, S, Sk):
    """[B, nq, nk] tile flags -> [B, S, Sk] element flags."""
    return (tiles.repeat_interleave(tq, dim=1)[:, :S]
            .repeat_interleave(tk, dim=2)[:, :, :Sk])


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_torch_tile_rule_never_skips_an_attended_pair(case, tile):
    c = SEGMENT_CASES[case]
    S, Sk = c["S"], c.get("Sk", c["S"])
    seg = _case_segments(c)
    tq, tk = tile
    allowed = TF._allowed(2, S, Sk, c["causal"], seg, "cpu")[:, 0]
    tiles = TF.computed_tiles(S, Sk, tq, tk, causal=c["causal"],
                              segments=seg)
    assert tiles.shape[1:] == (-(-S // tq), -(-Sk // tk))
    covered = _expand(tiles, tq, tk, S, Sk)
    assert not (allowed & ~covered).any()
    # with sorted documents (or none) it computes exactly the tiles that
    # hold an attended pair; unsorted ids may add tiles whose ranges
    # overlap without a shared id
    if c["seg"] in (None, "packed"):
        nq, nk = tiles.shape[1:]
        padded = torch.nn.functional.pad(allowed, (0, nk * tk - Sk,
                                                   0, nq * tq - S))
        any_allowed = padded.view(-1, nq, tq, nk, tk).any(4).any(2)
        assert torch.equal(tiles.expand_as(any_allowed), any_allowed)


@pytest.mark.parametrize("S", [64, 77, 200, 4096])
def test_torch_segment_ranges_merge_like_the_kernels(S):
    """Each kernel block reduces a tile's own ids (a ragged last tile over
    its own positions only): every range is the tile's min and max, and
    the ranges of the two tile heights, 32 and 64 rows, agree (two 32-row
    ranges merge into the 64-row one)."""
    seg = torch.from_numpy(_unsorted_runs(3, S, seed=S))
    r32 = TF.tile_segment_ranges(seg, 32)
    r64 = TF.tile_segment_ranges(seg, 64)
    assert r32.dtype == torch.int32 and r32.is_contiguous()
    n64 = r64.shape[1]
    pad = 2 * n64 - r32.shape[1]
    r32p = torch.cat([r32, r32[:, -1:].expand(-1, pad, -1)], dim=1)
    pairs = r32p.view(3, n64, 2, 2)
    merged = torch.stack([pairs[..., 0].amin(2), pairs[..., 1].amax(2)],
                         dim=-1)
    assert torch.equal(merged, r64)
    for b in range(3):
        for t in range(n64):
            part = seg[b, t * 64:(t + 1) * 64]
            assert r64[b, t].tolist() == [int(part.min()), int(part.max())]


def test_torch_tile_counts_at_the_packed_layout():
    """chip_smoke.py's Qwen shape (S=4096, documents of S/3, S/2 and S/6):
    the counts worked out by hand from the documents' tile spans."""
    seg = torch.from_numpy(_packed(2, 4096))
    sizes = TF.tile_sizes(torch.bfloat16)
    want = {  # (computed per batch row, causal triangle)
        "flash_fwd": (253 + 561 + 66 - 2, 2080),         # 64 x 64 tiles
        "flash_bwd_dkdv": (484 + 1089 + 132 - 2, 4160),  # 32 x 64 tiles
        "flash_bwd_dq": (505 + 1121 + 132 - 2, 4160),    # 64 x 32 tiles
    }
    for name, (tq, tk) in sizes.items():
        done = TF.computed_tiles(4096, 4096, tq, tk, causal=True,
                                 segments=seg)
        tri = TF.computed_tiles(4096, 4096, tq, tk, causal=True)
        assert [int(x) for x in done.sum(dim=(1, 2))] == [want[name][0]] * 2
        assert int(tri.sum()) == want[name][1]
    assert set(sizes) == set(want)


def test_torch_tile_sizes_mirror_the_kernel_source():
    with open(os.path.join(CSRC, "flash_tc.cuh")) as f:
        src = f.read()
    with open(os.path.join(CSRC, "flash_sm90.cuh")) as f:
        src90 = f.read()

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    sizes = TF.tile_sizes(torch.float16)
    assert sizes["flash_fwd"] == (const("K1_BQ"), const("K1_BK"))
    assert sizes["flash_bwd_dkdv"] == (const("K2_BQ"), const("K2_BK"))
    assert sizes["flash_bwd_dq"] == (const("K3_BQ"), const("K3_BK"))
    # the wgmma route (csrc/flash_sm90.cuh), by head dimension; K3 keeps
    # its mma.sync tiles
    for d in (64, 128):
        wg = TF.tile_sizes(torch.bfloat16, "wgmma", d)
        assert wg["flash_fwd"] == (const("WG_K1_BQ", src90),
                                   const(f"WG_K1_BK{d}", src90))
        assert wg["flash_bwd_dkdv"] == (const("WG_K2_BQ", src90),
                                        const("WG_K2_BK", src90))
        assert wg["flash_bwd_dq"] == sizes["flash_bwd_dq"]
    assert TF.tile_sizes(torch.float16, "mma") == sizes
    assert TF.tile_sizes(torch.float32) == TF.tile_sizes(torch.bfloat16,
                                                         "fma")


# ---------------------------------------------------------------------------
# a tile-by-tile emulation of the 16-bit K2/K3 arithmetic
# ---------------------------------------------------------------------------


def _rounded_product(a, b, dtype):
    """a @ b with a rounded to ``dtype`` as the kernels round P and dS in
    registers: bf16 as hi + lo (two products), fp16 once; fp32 sums."""
    hi = a.to(dtype).float()
    out = hi @ b
    if dtype == torch.bfloat16:
        out = out + (a - hi).to(dtype).float() @ b
    return out


def _tile_pd_ds(q, k, v, do, lse, delta, seg, b, n, q0, q1, k0, k1, *,
                causal, seed, rate, N):
    s = q @ k.T
    qpos = torch.arange(q0, q1)[:, None]
    kpos = torch.arange(k0, k1)[None, :]
    ok = torch.ones_like(s, dtype=torch.bool)
    if causal:
        ok &= qpos >= kpos
    if seg is not None:
        ok &= seg[b, q0:q1, None] == seg[b, None, k0:k1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.where(ok, torch.exp(s * scale - lse[:, None]), 0.0)
    dp = do @ v.T
    pd = p
    if rate > 0.0:
        keep = TF.keep_mask(seed, b * N + n, qpos, kpos, rate)
        pd = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        dp = torch.where(keep, dp * (1.0 / (1.0 - rate)), 0.0)
    return pd, p * (dp - delta[:, None]) * scale


def _emulate(q, k, v, do, lse, delta, seg, *, causal, seed, rate, dtype,
             skip=True, route=None, head_dim=64):
    """(dq, dk, dv) in fp32, tile by tile over the pairs the kernels
    compute (all pairs when ``skip`` is False), at the tiles of ``route``
    (``TF.tile_sizes``)."""
    B, N, S, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = N // K
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    sizes = TF.tile_sizes(dtype, route, head_dim)
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        tq, tk = sizes[name]
        if skip:
            tiles = TF.computed_tiles(S, Sk, tq, tk, causal=causal,
                                      segments=seg)
        else:
            tiles = torch.ones((1, -(-S // tq), -(-Sk // tk)), dtype=bool)
        for b in range(B):
            for n in range(N):
                for qt, kt in tiles[min(b, tiles.shape[0] - 1)].nonzero():
                    q0, k0 = int(qt) * tq, int(kt) * tk
                    q1, k1 = min(q0 + tq, S), min(k0 + tk, Sk)
                    kh = n // G
                    pd, ds = _tile_pd_ds(
                        q[b, n, q0:q1], k[b, kh, k0:k1], v[b, kh, k0:k1],
                        do[b, n, q0:q1], lse[b, n, q0:q1],
                        delta[b, n, q0:q1], seg, b, n, q0, q1, k0, k1,
                        causal=causal, seed=seed, rate=rate, N=N)
                    if name == "flash_bwd_dkdv":
                        dv[b, kh, k0:k1] += _rounded_product(
                            pd.T, do[b, n, q0:q1], dtype)
                        dk[b, kh, k0:k1] += _rounded_product(
                            ds.T, q[b, n, q0:q1], dtype)
                    else:
                        dq[b, n, q0:q1] += _rounded_product(
                            ds, k[b, kh, k0:k1], dtype)
    return dq, dk, dv


EMU_CASES = {
    "bf16_gqa_packed_dropout": dict(dtype=torch.bfloat16, seg="packed",
                                    rate=0.1, seed=321),
    "bf16_gqa_unsorted": dict(dtype=torch.bfloat16, seg="runs", rate=0.0,
                              seed=None),
    "fp16_gqa_packed_dropout": dict(dtype=torch.float16, seg="packed",
                                    rate=0.2, seed=-5),
}


def _check_bwd_emulation(case, route=None, head_dim=64):
    c = EMU_CASES[case]
    dtype, rate, seed = c["dtype"], c["rate"], c["seed"]
    B, N, K, S, D = 2, 4, 2, 96, 16
    rng = np.random.default_rng(7)

    def rnd(*shape):  # values the 16-bit type holds exactly
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(dtype).float().numpy()

    q, do = rnd(B, N, S, D), rnd(B, N, S, D)
    k, v = rnd(B, K, S, D), rnd(B, K, S, D)
    seg = (_packed(B, S) if c["seg"] == "packed"
           else _unsorted_runs(B, S, seed=3))
    jseg = jnp.asarray(seg)
    jseed = None if seed is None else jnp.asarray([seed], jnp.int32)
    o, lse = JF.flash_attention_hmajor(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, jseed,
        causal=True, block_q=S, block_k=S, interpret=True, dropout_rate=rate)
    want = JF.flash_attention_bwd_hmajor(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
        jnp.asarray(do), jseg, jseed, causal=True, block_q=S, block_k=S,
        interpret=True, dropout_rate=rate)
    o, lse = (torch.from_numpy(np.array(x)) for x in (o, lse[..., 0]))
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    delta = (tdo * o).sum(-1)
    tseg = torch.from_numpy(seg)
    kw = dict(causal=True, seed=seed, rate=rate, dtype=dtype, route=route,
              head_dim=head_dim)
    got = _emulate(tq_, tk_, tv_, tdo, lse, delta, tseg, **kw)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        g = g.to(dtype).float()  # the kernels write the input dtype
        limit = TOL_16 * (w.square().mean().sqrt() + w.abs())
        assert ((g - w).abs() <= limit).all(), float(
            ((g - w).abs() / limit).max())
    # a skipped tile adds exactly zero
    full = _emulate(tq_, tk_, tv_, tdo, lse, delta, tseg, skip=False, **kw)
    for a, b in zip(got, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_torch_tile_emulation_matches_jax_backward(case):
    _check_bwd_emulation(case)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_torch_tile_emulation_matches_jax_backward_wgmma_tiles(case,
                                                               head_dim):
    """The same arithmetic at the wgmma route's K2 tiles (128 k rows, 64 q
    rows: S=96 gives one ragged q tile and one ragged k tile)."""
    _check_bwd_emulation(case, "wgmma", head_dim)


# ---------------------------------------------------------------------------
# a tile-by-tile emulation of the 16-bit K1 arithmetic
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _emulate_fwd(q, k, v, seg, *, causal, seed, rate, dtype, skip=True,
                 route=None, head_dim=64):
    """(o in ``dtype``, lse fp32) as K1 computes them: per (q-tile, k-tile)
    pair that the tile rule keeps (every pair when ``skip`` is False) at
    the tiles of ``route``, fp32 scores scaled by log2(e) / sqrt(D), masked
    to NEG_INF, the online softmax's m, l and corr (0 while m is NEG_INF),
    l over the undropped p, and P rounded to ``dtype`` before P V (bf16 as
    hi + lo)."""
    B, N, S, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = N // K
    tq, tk = TF.tile_sizes(dtype, route, head_dim)["flash_fwd"]
    if skip:
        tiles = TF.computed_tiles(S, Sk, tq, tk, causal=causal, segments=seg)
    else:
        tiles = torch.ones((1, -(-S // tq), -(-Sk // tk)), dtype=bool)
    scale2 = 1.0 / math.sqrt(D) * LOG2E
    o = torch.empty((B, N, S, D), dtype=dtype)
    lse = torch.empty((B, N, S))
    for b in range(B):
        flags = tiles[min(b, tiles.shape[0] - 1)]
        for n in range(N):
            kh = n // G
            for qt in range(flags.shape[0]):
                q0, q1 = qt * tq, min(qt * tq + tq, S)
                qpos = torch.arange(q0, q1)[:, None]
                m = torch.full((q1 - q0,), TF.NEG_INF)
                l = torch.zeros(q1 - q0)
                acc = torch.zeros(q1 - q0, D)
                for kt in flags[qt].nonzero()[:, 0].tolist():
                    k0, k1 = kt * tk, min(kt * tk + tk, Sk)
                    kpos = torch.arange(k0, k1)[None, :]
                    ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
                    if causal:
                        ok &= qpos >= kpos
                    if seg is not None:
                        ok &= seg[b, q0:q1, None] == seg[b, None, k0:k1]
                    t = torch.where(ok, (q[b, n, q0:q1] @ k[b, kh, k0:k1].T)
                                    * scale2, TF.NEG_INF)
                    new_m = torch.maximum(m, t.amax(1))
                    corr = torch.where(m == TF.NEG_INF, 0.0,
                                       torch.exp2(m - new_m))
                    p = torch.where(ok, torch.exp2(t - new_m[:, None]), 0.0)
                    l = l * corr + p.sum(1)
                    m = new_m
                    if rate > 0.0:
                        keep = TF.keep_mask(seed, b * N + n, qpos, kpos, rate)
                        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
                    acc = (acc * corr[:, None]
                           + _rounded_product(p, v[b, kh, k0:k1], dtype))
                lf = l.clamp_min(1e-20)
                o[b, n, q0:q1] = (acc / lf[:, None]).to(dtype)
                lse[b, n, q0:q1] = torch.where(
                    m == TF.NEG_INF, TF.NEG_INF, m * LN2) + torch.log(lf)
    return o, lse


FWD_EMU_CASES = {
    "bf16_gqa_packed_dropout": dict(dtype=torch.bfloat16, seg="packed",
                                    rate=0.1, seed=321),
    "bf16_gqa_unsorted": dict(dtype=torch.bfloat16, seg="runs", rate=0.0,
                              seed=None),
    "fp16_gqa_packed_dropout": dict(dtype=torch.float16, seg="packed",
                                    rate=0.2, seed=-5),
    "fp16_causal_no_segments": dict(dtype=torch.float16, seg=None, rate=0.0,
                                    seed=None),
    "bf16_noncausal_sk_ne_s_dropout": dict(dtype=torch.bfloat16, seg=None,
                                           rate=0.1, seed=9, causal=False,
                                           Sk=136),
}


@pytest.mark.parametrize("case", sorted(FWD_EMU_CASES))
def test_torch_fwd_tile_emulation_matches_jax_forward(case):
    """K1's arithmetic, emulated per tile at its tile sizes over the pairs
    the tile rule keeps, against the JAX Pallas forward in interpret mode:
    o within TOL_16 * (rms + |want|), lse within 1e-3 absolute (the limits
    of chip_smoke.py phase 3). Skipped tiles leave o and lse bitwise as
    computing them would."""
    _check_fwd_emulation(case)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("case", sorted(FWD_EMU_CASES))
def test_torch_fwd_tile_emulation_matches_jax_forward_wgmma_tiles(case,
                                                                  head_dim):
    """The same at the wgmma route's K1 tiles: 128 q rows against 128 k
    rows (D=64) or 64 (D=128); S=200 gives two q tiles, the last ragged."""
    _check_fwd_emulation(case, "wgmma", head_dim)


def _check_fwd_emulation(case, route=None, head_dim=64):
    c = FWD_EMU_CASES[case]
    dtype, rate, seed = c["dtype"], c["rate"], c["seed"]
    causal = c.get("causal", True)
    B, N, K, S, D = 2, 4, 2, 200, 16  # 4 q tiles, the last one ragged
    Sk = c.get("Sk", S)
    rng = np.random.default_rng(5)

    def rnd(*shape):  # values the 16-bit type holds exactly
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(dtype).float().numpy()

    q, k, v = rnd(B, N, S, D), rnd(B, K, Sk, D), rnd(B, K, Sk, D)
    seg = {"packed": lambda: _packed(B, S),
           "runs": lambda: _unsorted_runs(B, S, seed=4),
           None: lambda: None}[c["seg"]]()
    jseg = None if seg is None else jnp.asarray(seg)
    jseed = None if seed is None else jnp.asarray([seed], jnp.int32)
    o_j, lse_j = JF.flash_attention_hmajor(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, jseed,
        causal=causal, block_q=S, block_k=Sk, interpret=True,
        dropout_rate=rate)
    want_o = torch.from_numpy(np.array(o_j))
    want_lse = torch.from_numpy(np.array(lse_j[..., 0]))
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    tseg = None if seg is None else torch.from_numpy(seg)
    kw = dict(causal=causal, seed=seed, rate=rate, dtype=dtype, route=route,
              head_dim=head_dim)
    o, lse = _emulate_fwd(tq_, tk_, tv_, tseg, **kw)
    g = o.float()
    limit = TOL_16 * (want_o.square().mean().sqrt() + want_o.abs())
    assert ((g - want_o).abs() <= limit).all(), float(
        ((g - want_o).abs() / limit).max())
    assert float((lse - want_lse).abs().max()) <= 1e-3
    o_all, lse_all = _emulate_fwd(tq_, tk_, tv_, tseg, skip=False, **kw)
    assert torch.equal(o, o_all) and torch.equal(lse, lse_all)
