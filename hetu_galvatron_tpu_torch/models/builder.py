"""Causal-LM assembly: config -> parameter tree -> forward / loss.

Counterpart of ``hetu_galvatron_tpu/models/builder.py``. The parameter tree
has the JAX package's structure (``embed``, ``layers[i]``, ``prenorm``,
``head``) with fp32 tensors as leaves; ``layer_overrides`` swaps per-layer
keyword arguments (the ``sdpa_fn`` seam) as there.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models import modules as M

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=gen)


def _norm_params(cfg: ModelArgs, device) -> Params:
    p = {"scale": torch.ones(cfg.hidden_size, device=device)}
    if cfg.normalization == "layernorm":
        p["bias"] = torch.zeros(cfg.hidden_size, device=device)
    return p


def init_causal_lm(cfg: ModelArgs, seed: int = 1234,
                   device: torch.device | str = "cpu") -> Params:
    """Random init in the JAX package's scheme: normal(0.02) weights, the
    residual projections ``wo`` and ``wout`` scaled by 1/sqrt(2L), zero
    biases, unit norm scales. Numbers differ from the JAX init (another
    generator); carry JAX weights over with ``runtime.checkpoint``."""
    M.check_model_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    h, hd, L = cfg.hidden_size, cfg.head_dim, cfg.num_hidden_layers
    nq, nkv, f = cfg.num_attention_heads, cfg.kv_heads, cfg.ffn_dim
    resid_std = 0.02 / math.sqrt(2 * L)
    fin = 2 * f if M.is_gated(cfg.hidden_act) else f
    embed = {"wte": _normal(gen, (cfg.padded_vocab_size, h), 0.02, device)}
    if cfg.position_embedding_type == "learned":
        embed["wpe"] = _normal(gen, (cfg.max_position_embeddings, h), 0.02,
                               device)
    layers = []
    for _ in range(L):
        attn = {"wqkv": _normal(gen, (h, (nq + 2 * nkv) * hd), 0.02, device),
                "wo": _normal(gen, (nq * hd, h), resid_std, device)}
        if cfg.add_qkv_bias:
            attn["bqkv"] = torch.zeros((nq + 2 * nkv) * hd, device=device)
        if cfg.add_bias_linear:
            attn["bo"] = torch.zeros(h, device=device)
        mlp = {"win": _normal(gen, (h, fin), 0.02, device),
               "wout": _normal(gen, (f, h), resid_std, device)}
        if cfg.add_bias_linear:
            mlp["bin"] = torch.zeros(fin, device=device)
            mlp["bout"] = torch.zeros(h, device=device)
        layers.append({"ln1": _norm_params(cfg, device), "attn": attn,
                       "ln2": _norm_params(cfg, device), "mlp": mlp})
    head = ({} if cfg.tie_word_embeddings else
            {"whead": _normal(gen, (h, cfg.padded_vocab_size), 0.02,
                              device)})
    params = {"embed": embed, "layers": layers,
              "prenorm": _norm_params(cfg, device), "head": head}
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    return params


def named_leaves(params: Params, prefix: str = ""
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) for every leaf, in a fixed order."""
    if isinstance(params, torch.Tensor):
        yield prefix, params
        return
    items = (enumerate(params) if isinstance(params, (list, tuple))
             else sorted(params.items()))
    for key, sub in items:
        yield from named_leaves(sub, f"{prefix}.{key}" if prefix
                                else str(key))


def forward_causal_lm(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelArgs,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat_flags: Optional[Sequence[bool]] = None,
    layer_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    dropout_rng: Optional[torch.Generator] = None,
    position_ids: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [B, S] -> fp32 logits [B, S, V]."""
    M.check_model_supported(cfg)
    if remat_flags is not None and any(remat_flags):
        raise NotImplementedError("per-layer remat is not ported yet")
    if position_ids is not None or segment_ids is not None:
        raise NotImplementedError(
            "packed documents (position_ids / segment_ids) are not ported "
            "at the model level yet")
    S = tokens.shape[1]
    rope = None
    if cfg.position_embedding_type == "rope":
        rope = M.rope_cos_sin(S, cfg.head_dim, cfg.rope_theta,
                              device=tokens.device)
    n = len(params["layers"])
    # one child stream each for the embedding and every layer
    rngs = M.split_rng(dropout_rng, n + 1) if (
        cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0) \
        else [None] * (n + 1)
    x = M.apply_embedding(params["embed"], tokens, cfg,
                          compute_dtype=compute_dtype, dropout_rng=rngs[n])
    for i, lp in enumerate(params["layers"]):
        kwargs: Dict[str, Any] = dict(rope=rope, compute_dtype=compute_dtype,
                                      dropout_rng=rngs[i])
        if layer_overrides and i in layer_overrides:
            kwargs.update(layer_overrides[i])
        x = M.apply_decoder_layer(lp, x, cfg, **kwargs)
    x = M.apply_norm(params["prenorm"], x, cfg)
    return M.apply_lm_head(params["head"], x, cfg,
                           wte=params["embed"]["wte"],
                           compute_dtype=compute_dtype)


def causal_lm_loss(
    params: Params,
    batch: Dict[str, Any],
    cfg: ModelArgs,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat_flags: Optional[Sequence[bool]] = None,
    layer_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    fused_ce: Optional[bool] = None,
) -> torch.Tensor:
    """batch: tokens [B,S], labels [B,S], optional loss_mask [B,S] and
    dropout_rng -> scalar loss."""
    fused = cfg.use_fused_ce if fused_ce is None else fused_ce
    logits = forward_causal_lm(
        params, batch["tokens"], cfg, compute_dtype=compute_dtype,
        remat_flags=remat_flags, layer_overrides=layer_overrides,
        dropout_rng=batch.get("dropout_rng"),
        position_ids=batch.get("position_ids"),
        segment_ids=batch.get("segment_ids"))
    return M.cross_entropy_loss(logits, batch["labels"],
                                batch.get("loss_mask"), fused=fused)


def param_count(params: Params) -> int:
    return sum(t.numel() for _, t in named_leaves(params))


def model_flops_per_token(cfg: ModelArgs,
                          seq_len: Optional[int] = None) -> float:
    """Approximate training FLOPs per token (6N + attention), the MFU
    numerator of the JAX package's bench and profilers."""
    s = seq_len or cfg.seq_length
    h, f, v = cfg.hidden_size, cfg.ffn_dim, cfg.padded_vocab_size
    nq, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    per_layer = 2 * h * (nq + 2 * nkv) * hd  # qkv
    per_layer += 2 * nq * hd * h  # proj
    per_layer += 2 * h * f * (3 if M.is_gated(cfg.hidden_act) else 2)  # mlp
    attn = 2 * 2 * s * nq * hd  # qk^T + pv per token
    dense = cfg.num_hidden_layers * (per_layer + attn) + 2 * h * v
    return 3.0 * dense  # fwd + bwd(2x)
