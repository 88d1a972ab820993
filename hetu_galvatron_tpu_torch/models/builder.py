"""Model assembly: config -> parameter tree -> forward / loss.

Counterpart of ``hetu_galvatron_tpu/models/builder.py``. The parameter tree
has the JAX package's structure (``embed``, ``layers[i]``, ``prenorm``,
``head``) with fp32 tensors as leaves; ``layer_overrides`` swaps per-layer
keyword arguments (the ``sdpa_fn`` seam) as there. With ``num_experts``,
every ``moe_layer_freq``-th layer holds ``moe`` (``models/moe.py``) in place
of ``mlp``; its aux loss joins the loss and its router statistics come back
per layer. Post-norm stacks (BERT) have an empty ``prenorm``: the MLM
head's norm is the last. ``model_type == "t5"`` builds and trains the
encoder-decoder pair of ``models/encdec.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models import modules as M
from hetu_galvatron_tpu_torch.models.moe import (
    apply_moe_decoder_layer,
    init_moe_mlp,
    is_moe_layer,
)

Params = Dict[str, Any]


def init_decoder_layer(gen: torch.Generator, cfg: ModelArgs, device,
                       moe: bool = False) -> Params:
    """``ln1``, ``attn``, ``ln2`` and ``mlp`` (``moe`` for an MoE layer)."""
    layer = {"ln1": M.init_norm(cfg, device),
             "attn": M.init_attention(gen, cfg, device),
             "ln2": M.init_norm(cfg, device)}
    if moe:
        layer["moe"] = init_moe_mlp(gen, cfg, device)
    else:
        layer["mlp"] = M.init_mlp(gen, cfg, device)
    return layer


def init_causal_lm(cfg: ModelArgs, seed: int = 1234,
                   device: torch.device | str = "cpu") -> Params:
    """Random init in the JAX package's scheme: normal(0.02) weights, the
    residual projections ``wo`` and ``wout`` (the experts' too) scaled by
    1/sqrt(2L), zero biases, unit norm scales. Numbers differ from the JAX
    init (another generator); carry JAX weights over with
    ``runtime.checkpoint``. t5 builds ``encdec.init_encdec``."""
    M.check_model_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if cfg.model_type == "t5":
        from hetu_galvatron_tpu_torch.models.encdec import init_encdec

        params = init_encdec(gen, cfg, device)
    else:
        embed = M.init_embedding(gen, cfg, device)
        layers = [init_decoder_layer(gen, cfg, device,
                                     moe=is_moe_layer(cfg, i))
                  for i in range(cfg.num_hidden_layers)]
        # post-norm blocks end normalized; the MLM head's norm is the last
        params = {"embed": embed, "layers": layers,
                  "prenorm": {} if cfg.post_norm else M.init_norm(cfg, device),
                  "head": M.init_lm_head(gen, cfg, device)}
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


def rope_tables(cfg: ModelArgs, tokens: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                mrope_position_ids: Optional[torch.Tensor] = None):
    """The (cos, sin) rope tables of a [B, S] token batch, None without
    rope: [S, D/2] in order, [B, S, D/2] gathered per token for packed
    positions, and the multimodal tables with ``cfg.mrope_section``."""
    if cfg.position_embedding_type != "rope":
        return None
    S = tokens.shape[1]
    if cfg.mrope_section:
        mpos = mrope_position_ids
        if mpos is None:
            base = (position_ids if position_ids is not None else
                    torch.arange(S, device=tokens.device).expand(
                        tokens.shape))
            mpos = base[None].expand((len(cfg.mrope_section),)
                                     + tuple(base.shape))
        return M.mrope_cos_sin(mpos, cfg.head_dim, cfg.rope_theta,
                               sections=cfg.mrope_section,
                               scaling=cfg.rope_scaling)
    cos, sin = M.rope_cos_sin(S, cfg.head_dim, cfg.rope_theta,
                              device=tokens.device, scaling=cfg.rope_scaling)
    if position_ids is not None:
        # packed samples: gather per-token rows -> [B, S, D/2]
        cos, sin = cos[position_ids], sin[position_ids]
    return cos, sin


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
    mrope_position_ids: Optional[torch.Tensor] = None,
    with_aux: bool = False,
):
    """tokens [B, S] -> fp32 logits [B, S, V]; with ``with_aux``, (logits,
    the MoE layers' summed aux loss, router stats by ``layer{i}``), where
    the aux loss is None without MoE layers (JAX adds a zero there).

    ``position_ids`` / ``segment_ids`` [B, S] are the packed-document fields
    (reset_position_ids / reset_attention_mask): rope rows (or ``wpe`` rows)
    are gathered per token and every layer masks attention across
    documents. With ``cfg.mrope_section``, ``mrope_position_ids`` [3, B, S]
    drive the multimodal rope; without them the 1-D positions stand for all
    three rows, which is plain rope. ``remat_flags[i]`` checkpoints layer i
    under ``cfg.remat_policy`` (:func:`modules.remat`)."""
    M.check_model_supported(cfg)
    rope = rope_tables(cfg, tokens, position_ids, mrope_position_ids)
    n = len(params["layers"])
    # one child stream each for the embedding and every layer; a layer
    # gets its seed and builds its generator inside itself, so a remat
    # recompute draws the same masks as the first pass
    use_dropout = cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0
    seeds = M.split_seeds(dropout_rng if use_dropout else None, n + 1)
    device = None if dropout_rng is None else dropout_rng.device
    x = M.apply_embedding(params["embed"], tokens, cfg,
                          compute_dtype=compute_dtype,
                          dropout_rng=M.generator_from_seed(seeds[n], device),
                          position_ids=position_ids)
    aux_total = None
    moe_stats: Dict[str, Dict[str, torch.Tensor]] = {}
    for i, lp in enumerate(params["layers"]):
        kwargs: Dict[str, Any] = dict(rope=rope, compute_dtype=compute_dtype,
                                      segment_ids=segment_ids)
        if layer_overrides and i in layer_overrides:
            kwargs.update(layer_overrides[i])
        apply = apply_moe_decoder_layer if "moe" in lp \
            else M.apply_decoder_layer

        def layer(p, h, seed=seeds[i], kw=kwargs, apply=apply):
            return apply(p, h, cfg,
                         dropout_rng=M.generator_from_seed(seed, device),
                         **kw)

        if remat_flags is not None and remat_flags[i]:
            layer = M.remat(layer, cfg)
        if "moe" in lp:
            # a recompute under remat routes as the first pass did: the
            # same inputs give the same products
            x, aux, moe_stats[f"layer{i}"] = layer(lp, x)
            aux_total = aux if aux_total is None else aux_total + aux
        else:
            x = layer(lp, x)
    x = M.apply_norm(params["prenorm"], x, cfg)
    logits = M.apply_lm_head(params["head"], x, cfg,
                             wte=params["embed"]["wte"],
                             compute_dtype=compute_dtype)
    return (logits, aux_total, moe_stats) if with_aux else logits


def causal_lm_loss(
    params: Params,
    batch: Dict[str, Any],
    cfg: ModelArgs,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat_flags: Optional[Sequence[bool]] = None,
    layer_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    enc_remat_flags: Optional[Sequence[bool]] = None,
    enc_layer_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    fused_ce: Optional[bool] = None,
    with_moe_stats: bool = False,
):
    """batch: tokens [B,S], labels [B,S], optional loss_mask, position_ids
    and segment_ids [B,S], mrope_position_ids [3,B,S] and dropout_rng ->
    scalar loss, CE plus the MoE layers' aux loss (with ``with_moe_stats``:
    (loss, router stats by ``layer{i}``)). ``fused_ce`` overrides
    ``cfg.use_fused_ce`` (K4/K5 through ``fused_ce_nll``). t5 batches
    (``enc_tokens`` too) go to ``encdec.encdec_loss``; the ``enc_*`` knobs
    index its encoder stack."""
    fused = cfg.use_fused_ce if fused_ce is None else fused_ce
    if cfg.model_type == "t5":
        from hetu_galvatron_tpu_torch.models.encdec import encdec_loss

        loss = encdec_loss(params, batch, cfg, compute_dtype=compute_dtype,
                           remat_flags=remat_flags,
                           enc_remat_flags=enc_remat_flags,
                           layer_overrides=layer_overrides,
                           enc_layer_overrides=enc_layer_overrides,
                           fused_ce=fused)
        return (loss, {}) if with_moe_stats else loss
    logits, aux, moe_stats = forward_causal_lm(
        params, batch["tokens"], cfg, compute_dtype=compute_dtype,
        remat_flags=remat_flags, layer_overrides=layer_overrides,
        dropout_rng=batch.get("dropout_rng"),
        position_ids=batch.get("position_ids"),
        segment_ids=batch.get("segment_ids"),
        mrope_position_ids=batch.get("mrope_position_ids"), with_aux=True)
    loss = M.cross_entropy_loss(logits, batch["labels"],
                                batch.get("loss_mask"), fused=fused)
    if aux is not None:
        loss = loss + aux
    return (loss, moe_stats) if with_moe_stats else loss


def param_count(params: Params) -> int:
    return sum(t.numel() for _, t in named_leaves(params))


def model_flops_per_token(cfg: ModelArgs,
                          seq_len: Optional[int] = None) -> float:
    """Approximate training FLOPs per token (6N + attention): JAX
    ``models/builder.py::model_flops_per_token``, the MFU numerator of
    ``bench.py``. As there, an MoE layer counts one dense MLP of
    ``ffn_dim``, not its top-k experts, and a t5 model its decoder stack
    alone. The telemetry's MFU counts as JAX's cost model does
    (``observability.telemetry.model_flops_per_token``: active experts,
    the router, the t5 encoder), 1.69x this for Mixtral and 1.94x for
    T5-3B."""
    s = seq_len or cfg.seq_length
    h, f, v = cfg.hidden_size, cfg.ffn_dim, cfg.padded_vocab_size
    nq, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    per_layer = 2 * h * (nq + 2 * nkv) * hd  # qkv
    per_layer += 2 * nq * hd * h  # proj
    per_layer += 2 * h * f * (3 if M.is_gated(cfg.hidden_act) else 2)  # mlp
    attn = 2 * 2 * s * nq * hd  # qk^T + pv per token
    dense = cfg.num_hidden_layers * (per_layer + attn) + 2 * h * v
    return 3.0 * dense  # fwd + bwd(2x)
