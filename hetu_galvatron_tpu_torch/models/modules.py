"""Transformer building blocks as functions over explicit parameter trees.

Counterpart of ``hetu_galvatron_tpu/models/modules.py``: the same parameter
names and layouts (fused qkv ``wqkv [H, (nq + 2 nkv) hd]`` split q | k | v,
``win [H, F]``, ``wout [F, H]``, tied head over ``wte``), so weights cross
between the packages unchanged (``runtime/checkpoint.py``). Master weights
are fp32 tensors; compute casts down to the run's compute dtype.

The attention core is swappable through ``sdpa_fn``: :func:`xla_sdpa` is the
plain dense core and ``ops.flash_attention.flash_sdpa`` the CUDA kernels.

Outside this slice, and raising rather than ignored: post-norm (bert) and
encoder-decoder (t5) blocks, MoE layers, rope scaling and multimodal rope,
per-layer remat, and the fused cross-entropy kernels (K4/K5).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs

Params = Dict[str, Any]
NEG_INF = float(torch.finfo(torch.float32).min)


def compute_dtype_of(mixed_precision: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp16": torch.float16,
            "fp32": torch.float32}[mixed_precision]


def check_model_supported(cfg: ModelArgs) -> None:
    """Raise for model settings this slice of the port does not run."""
    if cfg.model_type not in ("gpt", "llama"):
        raise NotImplementedError(
            f"model_type={cfg.model_type!r} (bert/t5/moe) is not ported yet; "
            "this slice runs decoder-only gpt/llama stacks")
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    if cfg.post_norm:
        raise NotImplementedError("post-norm blocks are not ported yet")
    if cfg.rope_scaling or cfg.mrope_section:
        raise NotImplementedError(
            "rope_scaling / mrope_section are not ported yet")
    if cfg.norm_zero_centered or cfg.scale_embeddings:
        raise NotImplementedError(
            "gemma numerics (norm_zero_centered / scale_embeddings) are not "
            "ported yet")


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``rng``; identity when
    ``rng`` is None (eval) or the rate is 0. The JAX package draws from
    threefry, so masks differ between the packages at the same seed."""
    if rng is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=rng.device) >= rate
    return torch.where(keep.to(x.device), x / (1.0 - rate),
                       torch.zeros_like(x))


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelArgs) -> torch.Tensor:
    """LayerNorm or RMSNorm in fp32 whatever the activation dtype; empty
    params are the identity."""
    if not p:
        return x
    dtype = x.dtype
    x = x.float()
    if cfg.normalization == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + cfg.layernorm_epsilon) * p["scale"]
    else:
        y = F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"],
                         cfg.layernorm_epsilon)
    return y.to(dtype)


def rope_cos_sin(seq_len: int, head_dim: int, theta: float,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device,
                                             dtype=torch.float32)
                                / head_dim))
    t = torch.arange(seq_len, device=device, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, N, D], cos/sin [S, D/2]; rotate-half (llama) convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def xla_sdpa(q, k, v, *, causal: bool = True, dropout_rate: float = 0.0,
             dropout_rng: Optional[torch.Generator] = None,
             segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain dense attention core (the JAX package's XLA core):
    [B,S,N,D] x [B,T,K,D] -> [B,S,N,D]; GQA by grouping q heads, softmax in
    fp32, causal queries at absolute positions [T-S, T)."""
    B, S, N, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = N // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) / math.sqrt(D)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, NEG_INF)
    if segment_ids is not None:
        if T != S:
            raise ValueError("segment_ids require self-attention (S == T)")
        same = (segment_ids[:, None, None, :, None]
                == segment_ids[:, None, None, None, :])
        scores = torch.where(same, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    probs = dropout(probs, dropout_rate, dropout_rng)
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float())
    return out.reshape(B, S, N, D).to(q.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    y = torch.matmul(x.to(dtype), w.to(dtype))
    return y if b is None else y + b.to(dtype)


def apply_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelArgs,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    sdpa_fn: Callable[..., torch.Tensor] = xla_sdpa,
    compute_dtype: torch.dtype = torch.bfloat16,
    causal: bool = True,
    dropout_rng: Optional[torch.Generator] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    B, S, _ = x.shape
    hd = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.kv_heads
    qkv = _linear(x, p["wqkv"], p.get("bqkv"), compute_dtype)
    q, k, v = torch.split(qkv, [nq * hd, nkv * hd, nkv * hd], dim=-1)
    q = q.view(B, S, nq, hd)
    k = k.view(B, S, nkv, hd)
    v = v.view(B, S, nkv, hd)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if dropout_rng is not None and cfg.attention_dropout > 0.0:
        if not (sdpa_fn is xla_sdpa
                or getattr(sdpa_fn, "supports_dropout", False)):
            raise NotImplementedError(
                "attention_dropout > 0 needs an attention core with a "
                "dropout variant (the plain core or flash_sdpa)")
        out = sdpa_fn(q, k, v, causal=causal,
                      dropout_rate=cfg.attention_dropout,
                      dropout_rng=dropout_rng, segment_ids=segment_ids)
    elif segment_ids is not None:
        if not (sdpa_fn is xla_sdpa
                or getattr(sdpa_fn, "supports_segments", False)):
            raise NotImplementedError(
                "segment_ids need an attention core that masks packed "
                "documents (the plain core or flash_sdpa)")
        out = sdpa_fn(q, k, v, causal=causal, segment_ids=segment_ids)
    else:
        out = sdpa_fn(q, k, v, causal=causal)
    out = out.reshape(B, S, nq * hd)
    return _linear(out, p["wo"], p.get("bo"), compute_dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


_ACTS = {
    "gelu": _gelu_tanh,
    "gelu_exact": F.gelu,
    "relu": F.relu,
    "silu": F.silu,
    "swiglu": F.silu,  # gate activation
    "geglu": _gelu_tanh,
}


def is_gated(act: str) -> bool:
    return act in ("swiglu", "geglu")


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelArgs,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    act = _ACTS[cfg.hidden_act]
    h = _linear(x, p["win"], p.get("bin"), compute_dtype)
    if is_gated(cfg.hidden_act):
        gate, up = torch.chunk(h, 2, dim=-1)
        h = act(gate) * up
    else:
        h = act(h)
    return _linear(h, p["wout"], p.get("bout"), compute_dtype)


# ---------------------------------------------------------------------------
# decoder layer
# ---------------------------------------------------------------------------


def split_rng(rng: Optional[torch.Generator], n: int):
    """n child generators seeded from ``rng`` (None stays None)."""
    if rng is None:
        return [None] * n
    seeds = torch.randint(0, 2 ** 62, (n,), generator=rng,
                          device=rng.device).tolist()
    return [torch.Generator(device=rng.device).manual_seed(s) for s in seeds]


def apply_decoder_layer(
    p: Params,
    x: torch.Tensor,
    cfg: ModelArgs,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    sdpa_fn: Callable[..., torch.Tensor] = xla_sdpa,
    compute_dtype: torch.dtype = torch.bfloat16,
    causal: Optional[bool] = None,
    dropout_rng: Optional[torch.Generator] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pre-norm residual block; sublayer outputs take hidden dropout before
    the residual add."""
    if cfg.post_norm:
        raise NotImplementedError("post-norm blocks are not ported yet")
    if causal is None:
        causal = cfg.model_type != "bert"
    r_attn, r_res1, r_res2 = split_rng(dropout_rng, 3)
    h = apply_norm(p["ln1"], x, cfg)
    x = x + dropout(apply_attention(p["attn"], h, cfg, rope=rope,
                                    sdpa_fn=sdpa_fn,
                                    compute_dtype=compute_dtype,
                                    causal=causal, dropout_rng=r_attn,
                                    segment_ids=segment_ids),
                    cfg.hidden_dropout, r_res1)
    h = apply_norm(p["ln2"], x, cfg)
    return x + dropout(apply_mlp(p["mlp"], h, cfg,
                                 compute_dtype=compute_dtype),
                       cfg.hidden_dropout, r_res2)


# ---------------------------------------------------------------------------
# embedding / lm head / loss
# ---------------------------------------------------------------------------


def apply_embedding(p: Params, tokens: torch.Tensor, cfg: ModelArgs,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    dropout_rng: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    x = p["wte"][tokens]
    if "wpe" in p:
        x = x + p["wpe"][:tokens.shape[1]][None, :, :]
    x = dropout(x, cfg.hidden_dropout, dropout_rng)
    return x.to(compute_dtype)


def apply_lm_head(p: Params, x: torch.Tensor, cfg: ModelArgs,
                  wte: Optional[torch.Tensor] = None,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> torch.Tensor:
    """fp32 logits [B, S, V]; the tied head reuses the embedding table."""
    if "wt" in p:
        raise NotImplementedError("the bert MLM head is not ported yet")
    w = p["whead"] if "whead" in p else wte.t()
    logits = torch.matmul(x.to(compute_dtype), w.to(compute_dtype)).float()
    if "bias" in p:
        logits = logits + p["bias"]
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       loss_mask: Optional[torch.Tensor] = None,
                       z_loss: float = 0.0, fused=False) -> torch.Tensor:
    """Stable mean CE over masked tokens, fp32 throughout."""
    if fused:
        raise NotImplementedError(
            "fused cross-entropy needs kernels K4/K5 "
            "(ops/pallas/cross_entropy.py::_ce_fwd_kernel/_ce_bwd_kernel), "
            "which are not ported yet; set model.use_fused_ce=false")
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    if loss_mask is None:
        return nll.mean()
    loss_mask = loss_mask.float()
    return (nll * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)
