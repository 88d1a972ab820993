"""Transformer building blocks as functions over explicit parameter trees.

Counterpart of ``hetu_galvatron_tpu/models/modules.py``: the same parameter
names and layouts (fused qkv ``wqkv [H, (nq + 2 nkv) hd]`` split q | k | v,
``win [H, F]``, ``wout [F, H]``, tied head over ``wte``), so weights cross
between the packages unchanged (``runtime/checkpoint.py``). Master weights
are fp32 tensors; compute casts down to the run's compute dtype.

The attention core is swappable through ``sdpa_fn``: :func:`xla_sdpa` is the
plain dense core and ``ops.flash_attention.flash_sdpa`` the CUDA kernels.
``cross_entropy_loss(fused=True)`` runs the per-token NLL through
``ops.cross_entropy.fused_ce_nll`` (the CUDA kernels K4/K5); :func:`remat`
is per-layer activation checkpointing with the JAX package's policies.

Every family of the JAX package's model zoo runs: pre-norm decoder blocks,
BERT's post-norm blocks with the embedding LayerNorm and the MLM head,
rope with "linear" / "llama3" scaling (``_scale_inv_freq``), multimodal
rope (``mrope_cos_sin``) and gemma's zero-centered norms and scaled
embeddings. MoE layers live in ``models/moe.py``, the T5 encoder-decoder
stacks in ``models/encdec.py``.

The tensor-parallel seams (``tp=`` of :func:`apply_attention`,
:func:`apply_mlp` and :func:`apply_decoder_layer`, ``vocab=`` of
:func:`apply_embedding` and :func:`apply_lm_head`) default to None, which
is the single-device arithmetic bit for bit. ``parallel/spmd.py`` passes
them for a layer wider than one rank: the layer then holds its rank's
column and row shards and calls the seam where GSPMD puts the collectives
(a Megatron-SP sequence gather before the column-parallel product, a
reduce-scatter after the row-parallel one; a vocab-parallel lookup and a
column-parallel head). The ``*_axes`` functions give each leaf's logical
axis names, JAX's ``init_*`` second results, which ``runtime/mesh.py``
maps onto a layer's ranks.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.ops.cross_entropy import fused_ce_nll

Params = Dict[str, Any]
NEG_INF = float(torch.finfo(torch.float32).min)


def compute_dtype_of(mixed_precision: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp16": torch.float16,
            "fp32": torch.float32}[mixed_precision]


def check_model_supported(cfg: ModelArgs) -> None:
    """Raise before any weight is made for settings the forward would
    refuse: an unknown ``rope_scaling`` type, or ``mrope_section`` that
    does not split head_dim / 2 (the ``ValueError`` s of
    :func:`_scale_inv_freq` and :func:`mrope_cos_sin`)."""
    if cfg.position_embedding_type != "rope":
        return
    _scale_inv_freq(torch.ones(1), cfg.rope_scaling)
    if cfg.mrope_section and sum(cfg.mrope_section) != cfg.head_dim // 2:
        raise ValueError(
            f"mrope sections {tuple(cfg.mrope_section)} must sum to "
            f"head_dim//2 = {cfg.head_dim // 2}")


def normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """fp32 normal(0, std) weights drawn from ``gen``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=gen)


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


def init_norm(cfg: ModelArgs, device) -> Params:
    """Unit scale (0 when ``norm_zero_centered``: gemma stores the offset
    from 1), and a zero bias for LayerNorm."""
    init = 0.0 if cfg.norm_zero_centered else 1.0
    p = {"scale": torch.full((cfg.hidden_size,), init, device=device)}
    if cfg.normalization == "layernorm":
        p["bias"] = torch.zeros(cfg.hidden_size, device=device)
    return p


def norm_axes(cfg: ModelArgs) -> Params:
    a = {"scale": ("embed",)}
    if cfg.normalization == "layernorm":
        a["bias"] = ("embed",)
    return a


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelArgs) -> torch.Tensor:
    """LayerNorm or RMSNorm in fp32 whatever the activation dtype, with
    ``1 + scale`` under ``norm_zero_centered``; empty params (post-norm
    stacks have no final norm) are the identity."""
    if not p:
        return x
    dtype = x.dtype
    x = x.float()
    scale = p["scale"]
    if cfg.norm_zero_centered:
        scale = 1.0 + scale
    if cfg.normalization == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + cfg.layernorm_epsilon) * scale
    else:
        y = F.layer_norm(x, (x.shape[-1],), scale, p["bias"],
                         cfg.layernorm_epsilon)
    return y.to(dtype)


def _scale_inv_freq(inv_freq: torch.Tensor,
                    scaling: Optional[dict]) -> torch.Tensor:
    """HF-style ``rope_scaling``: "linear" divides the frequencies by
    ``factor``; "llama3" keeps the high-frequency bands, divides the
    low-frequency bands by ``factor`` and interpolates between the two
    wavelength thresholds. fp32 in the JAX function's order, every
    constant an fp32 tensor: a Python float over a tensor is a reciprocal
    times the float in torch, not a division."""
    if not scaling:
        return inv_freq
    rope_type = scaling.get("rope_type", scaling.get("type", "linear"))
    factor = float(scaling.get("factor", 1.0))
    if rope_type == "linear":
        return inv_freq / factor
    if rope_type == "llama3":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32,
                                device=inv_freq.device)

        low = float(scaling["low_freq_factor"])
        high = float(scaling["high_freq_factor"])
        orig = float(scaling["original_max_position_embeddings"])
        wavelen = f32(2.0 * math.pi) / inv_freq
        smooth = (f32(orig) / wavelen - low) / (high - low)
        smooth = smooth.clamp(0.0, 1.0)
        return (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    raise ValueError(f"unsupported rope_scaling type {rope_type!r} "
                     "(supported: linear, llama3)")


def _inv_freq(head_dim: int, theta: float, scaling: Optional[dict],
              device) -> torch.Tensor:
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device,
                                             dtype=torch.float32)
                                / head_dim))
    return _scale_inv_freq(inv_freq, scaling)


def rope_cos_sin(seq_len: int, head_dim: int, theta: float, device=None,
                 scaling: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables [seq, head_dim // 2], fp32, with ``rope_scaling``."""
    inv_freq = _inv_freq(head_dim, theta, scaling, device)
    t = torch.arange(seq_len, device=device, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def mrope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float,
                  sections, scaling: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal rope tables [B, S, D/2] from per-axis positions [3, B, S]
    (temporal, height, width): frequency dim d of section j rotates by
    position row j. The JAX function selects rows by a one-hot einsum; a
    gather gives the same bits (a product with 1.0 plus zeros). With the
    three rows equal it is :func:`rope_cos_sin` gathered per token."""
    sections = tuple(int(s) for s in sections)
    if sum(sections) != head_dim // 2:
        raise ValueError(
            f"mrope sections {sections} must sum to head_dim//2 "
            f"= {head_dim // 2}")
    if position_ids.dim() != 3 or position_ids.shape[0] != len(sections):
        raise ValueError(
            f"mrope position_ids must be [{len(sections)}, B, S], got "
            f"{tuple(position_ids.shape)}")
    device = position_ids.device
    inv_freq = _inv_freq(head_dim, theta, scaling, device)
    row = torch.cat([torch.full((s,), j, dtype=torch.long, device=device)
                     for j, s in enumerate(sections)])
    # [3, B, S] -> [B, S, D/2]: dim d takes position row row[d]
    sel = position_ids.float().permute(1, 2, 0)[..., row] * inv_freq
    return torch.cos(sel), torch.sin(sel)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, N, D]; rotate-half (llama) convention. cos/sin are [S, D/2]
    (positions in order) or [B, S, D/2] (rows gathered per token: packed
    samples with reset_position_ids)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
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


def init_attention(gen: torch.Generator, cfg: ModelArgs, device) -> Params:
    """Fused ``wqkv [H, (nq + 2 nkv) hd]`` at std 0.02, then ``wo`` at the
    residual std 0.02 / sqrt(2L), drawn in that order; zero biases."""
    h, hd = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.kv_heads
    p = {"wqkv": normal(gen, (h, (nq + 2 * nkv) * hd), 0.02, device),
         "wo": normal(gen, (nq * hd, h),
                      0.02 / math.sqrt(2 * cfg.num_hidden_layers), device)}
    if cfg.add_qkv_bias:
        p["bqkv"] = torch.zeros((nq + 2 * nkv) * hd, device=device)
    if cfg.add_bias_linear:
        p["bo"] = torch.zeros(h, device=device)
    return p


def attention_axes(cfg: ModelArgs) -> Params:
    a = {"wqkv": ("embed", "qkv"), "wo": ("heads", "embed")}
    if cfg.add_qkv_bias:
        a["bqkv"] = ("qkv",)
    if cfg.add_bias_linear:
        a["bo"] = ("embed",)
    return a


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
    tp: Any = None,
) -> torch.Tensor:
    """Self-attention of ``x [B, S, H]``. With a ``tp`` seam the layer holds
    its rank's heads (``wqkv`` columns q | k | v of them, ``wo`` rows) and
    ``x`` its sequence shard: ``tp.gather`` makes the whole sequence
    before the product and ``tp.scatter`` sums the row-parallel output
    over the group back onto the shard, the bias added after."""
    if tp is not None:
        x = tp.gather(x)
    B, S, _ = x.shape
    hd = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.kv_heads
    if tp is not None:
        nq, nkv = nq // tp.size, nkv // tp.size
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
    if tp is not None:
        out = tp.scatter(_linear(out, p["wo"], None, compute_dtype))
        return out if "bo" not in p else out + p["bo"].to(compute_dtype)
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


def init_mlp(gen: torch.Generator, cfg: ModelArgs, device,
             ffn_dim: Optional[int] = None) -> Params:
    """``win [H, F]`` (``[H, 2F]`` gated: gate | up) at std 0.02 and ``wout
    [F, H]`` at the residual std 0.02 / sqrt(2L), drawn in that order; zero
    biases with ``add_bias_linear``."""
    h, f = cfg.hidden_size, ffn_dim or cfg.ffn_dim
    fin = 2 * f if is_gated(cfg.hidden_act) else f
    p = {"win": normal(gen, (h, fin), 0.02, device),
         "wout": normal(gen, (f, h),
                        0.02 / math.sqrt(2 * cfg.num_hidden_layers), device)}
    if cfg.add_bias_linear:
        p["bin"] = torch.zeros(fin, device=device)
        p["bout"] = torch.zeros(h, device=device)
    return p


def mlp_axes(cfg: ModelArgs) -> Params:
    a = {"win": ("embed", "mlp"), "wout": ("mlp", "embed")}
    if cfg.add_bias_linear:
        a["bin"] = ("mlp",)
        a["bout"] = ("embed",)
    return a


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelArgs,
              compute_dtype: torch.dtype = torch.bfloat16,
              tp: Any = None) -> torch.Tensor:
    """The MLP of ``x``; a ``tp`` seam as in :func:`apply_attention` (the
    rank's ``win`` columns, gate | up of them when gated, and ``wout``
    rows)."""
    act = _ACTS[cfg.hidden_act]
    if tp is not None:
        x = tp.gather(x)
    h = _linear(x, p["win"], p.get("bin"), compute_dtype)
    if is_gated(cfg.hidden_act):
        gate, up = torch.chunk(h, 2, dim=-1)
        h = act(gate) * up
    else:
        h = act(h)
    if tp is not None:
        out = tp.scatter(_linear(h, p["wout"], None, compute_dtype))
        return out if "bout" not in p else out + p["bout"].to(compute_dtype)
    return _linear(h, p["wout"], p.get("bout"), compute_dtype)


# ---------------------------------------------------------------------------
# decoder layer
# ---------------------------------------------------------------------------


def split_seeds(rng: Optional[torch.Generator],
                n: int) -> List[Optional[int]]:
    """n child seeds drawn from ``rng`` (None gives n Nones)."""
    if rng is None:
        return [None] * n
    return torch.randint(0, 2 ** 62, (n,), generator=rng,
                         device=rng.device).tolist()


def generator_from_seed(seed: Optional[int], device
                        ) -> Optional[torch.Generator]:
    """A fresh generator for one child stream (None stays None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def split_rng(rng: Optional[torch.Generator], n: int):
    """n child generators seeded from ``rng`` (None stays None)."""
    if rng is None:
        return [None] * n
    return [generator_from_seed(s, rng.device) for s in split_seeds(rng, n)]


# matmul outputs the selective policies keep for the backward: "dots" is
# JAX's checkpoint_dots (every dot_general), "dots_no_batch" its
# checkpoint_dots_with_no_batch_dims (no batched products, so the attention
# core's einsums are recomputed)
_SAVED_DOTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default),
}


def remat(fn: Callable, cfg: ModelArgs,
          preserve_rng_state: bool = True) -> Callable:
    """Per-layer activation checkpointing with ``cfg.remat_policy``
    (JAX ``remat``): "full" recomputes the whole layer in the backward;
    "dots" / "dots_no_batch" keep the outputs of the matrix products listed
    in ``_SAVED_DOTS`` and recompute the rest. Under ``no_grad`` (eval) the
    layer simply runs. The wrapped function must draw any randomness from
    generators it creates inside itself (``generator_from_seed``): the
    recompute restores the global RNG state only, so an explicit generator
    advanced by the first pass would draw a different mask. Such a layer
    needs no global RNG state, and a caller that captures the layer into
    a CUDA graph passes ``preserve_rng_state=False``: stashing the global
    state reads it on the host, which a capture cannot."""
    policy = cfg.remat_policy
    if policy == "full":
        context_fn = None
    elif policy in _SAVED_DOTS:
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       list(_SAVED_DOTS[policy]))
    else:
        raise ValueError(f"unknown remat_policy {policy!r} "
                         "(full | dots | dots_no_batch)")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=preserve_rng_state)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=preserve_rng_state,
                          context_fn=context_fn)

    return wrapped


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
    tp: Any = None,
) -> torch.Tensor:
    """Pre-norm residual block, or with ``cfg.post_norm`` (BERT) residual
    then norm for both sublayers; sublayer outputs take hidden dropout
    before the residual add. ``causal=None`` is bidirectional for bert.
    ``tp`` is the sublayers' seam (:func:`apply_attention`): the norms and
    the residual stream stay on the sequence shard."""
    if causal is None:
        causal = cfg.model_type != "bert"
    r_attn, r_res1, r_res2 = split_rng(dropout_rng, 3)
    if cfg.post_norm:
        x = apply_norm(p["ln1"], x + dropout(
            apply_attention(p["attn"], x, cfg, rope=rope, sdpa_fn=sdpa_fn,
                            compute_dtype=compute_dtype, causal=causal,
                            dropout_rng=r_attn, segment_ids=segment_ids),
            cfg.hidden_dropout, r_res1), cfg)
        return apply_norm(p["ln2"], x + dropout(
            apply_mlp(p["mlp"], x, cfg, compute_dtype=compute_dtype),
            cfg.hidden_dropout, r_res2), cfg)
    h = apply_norm(p["ln1"], x, cfg)
    x = x + dropout(apply_attention(p["attn"], h, cfg, rope=rope,
                                    sdpa_fn=sdpa_fn,
                                    compute_dtype=compute_dtype,
                                    causal=causal, dropout_rng=r_attn,
                                    segment_ids=segment_ids, tp=tp),
                    cfg.hidden_dropout, r_res1)
    h = apply_norm(p["ln2"], x, cfg)
    return x + dropout(apply_mlp(p["mlp"], h, cfg,
                                 compute_dtype=compute_dtype, tp=tp),
                       cfg.hidden_dropout, r_res2)


# ---------------------------------------------------------------------------
# embedding / lm head / loss
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelArgs, device) -> Params:
    """``wte`` (then ``wpe`` for learned positions) at std 0.02; post-norm
    stacks (BERT) add the embedding LayerNorm."""
    p = {"wte": normal(gen, (cfg.padded_vocab_size, cfg.hidden_size), 0.02,
                       device)}
    if cfg.position_embedding_type == "learned":
        p["wpe"] = normal(gen, (cfg.max_position_embeddings,
                                cfg.hidden_size), 0.02, device)
    if cfg.post_norm:
        p["ln"] = init_norm(cfg, device)
    return p


def embedding_axes(cfg: ModelArgs) -> Params:
    a = {"wte": ("vocab", "embed")}
    if cfg.position_embedding_type == "learned":
        a["wpe"] = ("pos", "embed")
    if cfg.post_norm:
        a["ln"] = norm_axes(cfg)
    return a


def apply_embedding(p: Params, tokens: torch.Tensor, cfg: ModelArgs,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    dropout_rng: Optional[torch.Generator] = None,
                    position_ids: Optional[torch.Tensor] = None,
                    vocab: Any = None) -> torch.Tensor:
    """Token (+ position) rows in fp32, then BERT's LayerNorm, gemma's
    sqrt(hidden) scale and dropout, cast to the compute dtype. With a
    ``vocab`` seam ``wte`` holds the rank's vocab rows: ``vocab.lookup``
    gathers the tokens inside them (zeros elsewhere) and sums over the
    vocab group onto the rank's sequence shard, which is exact, since one
    shard alone holds each row; the positions are then the shard's
    (``vocab.seq_slice``)."""
    if vocab is None:
        x = p["wte"][tokens]
    else:
        x = vocab.lookup(p["wte"], tokens)
    if "wpe" in p:
        if position_ids is not None:  # packed samples: per-token positions
            if vocab is not None:
                position_ids = vocab.seq_slice(position_ids)
            x = x + p["wpe"][position_ids]
        else:
            w = p["wpe"][:tokens.shape[1]][None, :, :]
            x = x + (w if vocab is None else vocab.seq_slice(w))
    if "ln" in p:
        x = apply_norm(p["ln"], x, cfg)
    if cfg.scale_embeddings:
        # a fill, not a host copy: the compiled pipeline captures this
        x = x * torch.full((), float(cfg.hidden_size), dtype=torch.float32,
                           device=x.device).sqrt().to(x.dtype)
    x = dropout(x, cfg.hidden_dropout, dropout_rng)
    return x.to(compute_dtype)


def init_lm_head(gen: torch.Generator, cfg: ModelArgs, device) -> Params:
    """BERT's MLM head (``wt [H, H]`` at std 0.02, zero ``bt``, a norm, a
    zero vocab ``bias``, then ``whead`` when untied), else ``whead [H, V]``
    when untied and nothing when tied."""
    h, v = cfg.hidden_size, cfg.padded_vocab_size
    if cfg.model_type == "bert":
        p = {"wt": normal(gen, (h, h), 0.02, device),
             "bt": torch.zeros(h, device=device), "ln": init_norm(cfg, device),
             "bias": torch.zeros(v, device=device)}
        if not cfg.tie_word_embeddings:
            p["whead"] = normal(gen, (h, v), 0.02, device)
        return p
    if cfg.tie_word_embeddings:
        return {}
    return {"whead": normal(gen, (h, v), 0.02, device)}


def lm_head_axes(cfg: ModelArgs) -> Params:
    if cfg.model_type == "bert":
        a = {"wt": ("pos", "embed"), "bt": ("embed",), "ln": norm_axes(cfg),
             "bias": ("vocab",)}
        if not cfg.tie_word_embeddings:
            a["whead"] = ("embed", "vocab")
        return a
    if cfg.tie_word_embeddings:
        return {}
    return {"whead": ("embed", "vocab")}


def apply_lm_head(p: Params, x: torch.Tensor, cfg: ModelArgs,
                  wte: Optional[torch.Tensor] = None,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  vocab: Any = None) -> torch.Tensor:
    """fp32 logits [B, S, V]; the tied head reuses the embedding table.
    BERT's MLM head first runs its transform (``wt`` + ``bt``, the
    activation and the norm, in fp32) and adds the vocab bias last. With
    a ``vocab`` seam the head is column-parallel over the vocabulary:
    ``vocab.gather`` makes the whole sequence of ``x``'s shard and the
    logits are the rank's vocab columns ``[B, S, V / vtp]``."""
    if vocab is not None:
        x = vocab.gather(x)
    if "wt" in p:
        x = _linear(x, p["wt"], None, compute_dtype).float() + p["bt"]
        x = apply_norm(p["ln"], _ACTS[cfg.hidden_act](x), cfg)
    w = p["whead"] if "whead" in p else wte.t()
    logits = torch.matmul(x.to(compute_dtype), w.to(compute_dtype)).float()
    if "bias" in p:
        logits = logits + p["bias"]
    return logits


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              z_loss: float = 0.0, fused: Any = False) -> torch.Tensor:
    """Per-token NLL (``+ z * lse**2``) in fp32: ``fused=True`` through
    ``fused_ce_nll`` (K4/K5 on a CUDA device, their plain versions on the
    CPU), a callable ``fused`` through it (``ops.cross_entropy.
    make_vocab_parallel_ce``'s over vocab-sharded logits), else plain."""
    if callable(fused):
        return fused(logits, labels, z_loss=z_loss)
    if fused:
        return fused_ce_nll(logits, labels, z_loss=z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       loss_mask: Optional[torch.Tensor] = None,
                       z_loss: float = 0.0, fused: Any = False
                       ) -> torch.Tensor:
    """Stable mean CE over masked tokens, fp32 throughout; ``fused`` as in
    :func:`token_nll`, mask and mean plain."""
    nll = token_nll(logits, labels, z_loss=z_loss, fused=fused)
    if loss_mask is None:
        return nll.mean()
    loss_mask = loss_mask.float()
    return (nll * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)
