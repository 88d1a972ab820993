"""Encoder-decoder (T5-family) stacks: cross-attention and seq2seq assembly.

Counterpart of ``hetu_galvatron_tpu/models/encdec.py``, with its parameter
tree (``embed``, ``enc_layers[j]``, ``enc_norm``, ``layers[i]`` with
``lnx`` and ``cross.{wq, wkv, wo}``, ``prenorm``, ``head``), so weights
cross between the packages unchanged (``runtime/checkpoint.py``). An
encoder of bidirectional pre-norm blocks, a decoder whose blocks add
cross-attention over the encoder output, one shared token embedding;
positions use the configured scheme (rope or learned) in both stacks, as
in the JAX package, not T5's relative bias.

Cross-attention runs its core with ``causal=False`` and the encoder's
length for the keys: ``ops.flash_attention.flash_sdpa`` (K1-K3) takes it
as it is. Dropout draws one child seed for every decoder layer, the
decoder embedding, the encoder embedding and every encoder layer, in that
order (JAX's disjoint fold-in streams, in the port's seed-splitting idiom:
``modules.split_seeds``); each layer builds its generator inside itself,
so a remat recompute redraws the same masks. Under remat a decoder layer
takes the encoder memory as an argument of the checkpointed function, so
each layer's share of the encoder's gradient flows through the
recompute.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models import modules as M

Params = Dict[str, Any]


def encoder_layers(cfg: ModelArgs) -> int:
    """``num_encoder_layers``, or the decoder's depth when unset."""
    return (cfg.num_encoder_layers if cfg.num_encoder_layers is not None
            else cfg.num_hidden_layers)


def init_cross_attention(gen: torch.Generator, cfg: ModelArgs,
                         device) -> Params:
    """Q from the decoder stream (``wq``), fused K|V from the encoder output
    (``wkv``), ``wo`` at the residual std; drawn in that order."""
    h, hd = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.kv_heads
    p = {"wq": M.normal(gen, (h, nq * hd), 0.02, device),
         "wkv": M.normal(gen, (h, 2 * nkv * hd), 0.02, device),
         "wo": M.normal(gen, (nq * hd, h),
                        0.02 / math.sqrt(2 * cfg.num_hidden_layers), device)}
    if cfg.add_qkv_bias:
        p["bq"] = torch.zeros(nq * hd, device=device)
        p["bkv"] = torch.zeros(2 * nkv * hd, device=device)
    if cfg.add_bias_linear:
        p["bo"] = torch.zeros(h, device=device)
    return p


def cross_kv(p: Params, memory: torch.Tensor, cfg: ModelArgs,
             compute_dtype: torch.dtype = torch.bfloat16
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory [B, S, H] projected to cross-attention (k, v)
    [B, S, Nkv, D]."""
    B, S, _ = memory.shape
    nkv, hd = cfg.kv_heads, cfg.head_dim
    kv = M._linear(memory, p["wkv"], p.get("bkv"), compute_dtype)
    k, v = torch.chunk(kv, 2, dim=-1)
    return k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def apply_cross_attention(
    p: Params,
    x: torch.Tensor,
    memory: torch.Tensor,
    cfg: ModelArgs,
    sdpa_fn: Callable[..., torch.Tensor] = M.xla_sdpa,
    compute_dtype: torch.dtype = torch.bfloat16,
    dropout_rng: Optional[torch.Generator] = None,
    cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Decoder stream x [B, T, H] over the whole encoder memory [B, S, H]
    (non-causal); probability dropout needs a core with a dropout
    variant, as in self-attention."""
    B, T, _ = x.shape
    nq, hd = cfg.num_attention_heads, cfg.head_dim
    q = M._linear(x, p["wq"], p.get("bq"), compute_dtype).view(B, T, nq, hd)
    k, v = (cached_kv if cached_kv is not None
            else cross_kv(p, memory, cfg, compute_dtype))
    if dropout_rng is not None and cfg.attention_dropout > 0.0:
        if not (sdpa_fn is M.xla_sdpa
                or getattr(sdpa_fn, "supports_dropout", False)):
            raise NotImplementedError(
                "attention_dropout > 0 needs an attention core with a "
                "dropout variant (the plain core or flash_sdpa) for "
                "cross-attention")
        out = sdpa_fn(q, k, v, causal=False,
                      dropout_rate=cfg.attention_dropout,
                      dropout_rng=dropout_rng)
    else:
        out = sdpa_fn(q, k, v, causal=False)
    return M._linear(out.reshape(B, T, nq * hd), p["wo"], p.get("bo"),
                     compute_dtype)


def init_cross_decoder_layer(gen: torch.Generator, cfg: ModelArgs,
                             device) -> Params:
    """``ln1``, self ``attn``, ``lnx``, ``cross``, ``ln2``, ``mlp``; the
    weights drawn self-attention, cross-attention, MLP."""
    attn = M.init_attention(gen, cfg, device)
    cross = init_cross_attention(gen, cfg, device)
    mlp = M.init_mlp(gen, cfg, device)
    return {"ln1": M.init_norm(cfg, device), "attn": attn,
            "lnx": M.init_norm(cfg, device), "cross": cross,
            "ln2": M.init_norm(cfg, device), "mlp": mlp}


def apply_cross_decoder_layer(
    p: Params,
    x: torch.Tensor,
    memory: torch.Tensor,
    cfg: ModelArgs,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    sdpa_fn: Callable[..., torch.Tensor] = M.xla_sdpa,
    cross_sdpa_fn: Optional[Callable[..., torch.Tensor]] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    dropout_rng: Optional[torch.Generator] = None,
    cached_cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Pre-norm: causal self-attention (``sdpa_fn``), cross-attention
    (``cross_sdpa_fn``, else ``sdpa_fn``), MLP; each sublayer output takes
    hidden dropout before its residual add."""
    r_attn, r_xattn, r1, r2, r3 = M.split_rng(dropout_rng, 5)
    h = M.apply_norm(p["ln1"], x, cfg)
    x = x + M.dropout(M.apply_attention(p["attn"], h, cfg, rope=rope,
                                        sdpa_fn=sdpa_fn,
                                        compute_dtype=compute_dtype,
                                        causal=True, dropout_rng=r_attn),
                      cfg.hidden_dropout, r1)
    h = M.apply_norm(p["lnx"], x, cfg)
    x = x + M.dropout(apply_cross_attention(
        p["cross"], h, memory, cfg, sdpa_fn=cross_sdpa_fn or sdpa_fn,
        compute_dtype=compute_dtype, dropout_rng=r_xattn,
        cached_kv=cached_cross_kv), cfg.hidden_dropout, r2)
    h = M.apply_norm(p["ln2"], x, cfg)
    return x + M.dropout(M.apply_mlp(p["mlp"], h, cfg,
                                     compute_dtype=compute_dtype),
                         cfg.hidden_dropout, r3)


def init_encdec(gen: torch.Generator, cfg: ModelArgs, device) -> Params:
    """The whole model: shared embedding, encoder stack, decoder stack with
    cross-attention, the encoder's and the decoder's final norms, (un)tied
    head; weights drawn in that order."""
    from hetu_galvatron_tpu_torch.models.builder import init_decoder_layer

    embed = M.init_embedding(gen, cfg, device)
    enc = [init_decoder_layer(gen, cfg, device)
           for _ in range(encoder_layers(cfg))]
    dec = [init_cross_decoder_layer(gen, cfg, device)
           for _ in range(cfg.num_hidden_layers)]
    return {"embed": embed, "enc_layers": enc,
            "enc_norm": M.init_norm(cfg, device), "layers": dec,
            "prenorm": M.init_norm(cfg, device),
            "head": M.init_lm_head(gen, cfg, device)}


def _rope(cfg: ModelArgs, length: int, device):
    if cfg.position_embedding_type != "rope":
        return None
    return M.rope_cos_sin(length, cfg.head_dim, cfg.rope_theta,
                          device=device, scaling=cfg.rope_scaling)


def encode(params: Params, enc_tokens: torch.Tensor, cfg: ModelArgs, *,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Encoder-only forward (no dropout) -> normed memory [B, S, H]."""
    rope = _rope(cfg, enc_tokens.shape[1], enc_tokens.device)
    mem = M.apply_embedding(params["embed"], enc_tokens, cfg,
                            compute_dtype=compute_dtype)
    for lp in params["enc_layers"]:
        mem = M.apply_decoder_layer(lp, mem, cfg, rope=rope,
                                    compute_dtype=compute_dtype,
                                    causal=False)
    return M.apply_norm(params["enc_norm"], mem, cfg)


def forward_encdec(
    params: Params,
    enc_tokens: torch.Tensor,
    dec_tokens: torch.Tensor,
    cfg: ModelArgs,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat_flags: Optional[Sequence[bool]] = None,
    enc_remat_flags: Optional[Sequence[bool]] = None,
    layer_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    enc_layer_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    dropout_rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(enc_tokens [B, S], dec_tokens [B, T]) -> fp32 logits [B, T, V].

    ``remat_flags`` / ``layer_overrides`` index decoder layers, the
    ``enc_*`` pair encoder layers (the combined-stack plan of
    ``runtime/hybrid_config.py``). Without ``enc_remat_flags`` the encoder
    takes ``remat_flags[0]`` on every layer, as in JAX. An encoder
    override's ``cross_sdpa_fn`` is dropped: encoder blocks have no
    cross-attention."""
    device = enc_tokens.device
    rope_enc = _rope(cfg, enc_tokens.shape[1], device)
    rope_dec = _rope(cfg, dec_tokens.shape[1], device)
    n_enc, n_dec = len(params["enc_layers"]), len(params["layers"])
    if enc_remat_flags is None and remat_flags:
        enc_remat_flags = [bool(remat_flags[0])] * n_enc
    use_dropout = cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0
    seeds = M.split_seeds(dropout_rng if use_dropout else None,
                          n_dec + 2 + n_enc)
    rng_device = None if dropout_rng is None else dropout_rng.device

    def gen(i):
        return M.generator_from_seed(seeds[i], rng_device)

    mem = M.apply_embedding(params["embed"], enc_tokens, cfg,
                            compute_dtype=compute_dtype,
                            dropout_rng=gen(n_dec + 1))
    for j, lp in enumerate(params["enc_layers"]):
        kwargs: Dict[str, Any] = dict(rope=rope_enc,
                                      compute_dtype=compute_dtype,
                                      causal=False)
        if enc_layer_overrides and j in enc_layer_overrides:
            kwargs.update(enc_layer_overrides[j])
        kwargs.pop("cross_sdpa_fn", None)

        def enc_layer(p, h, seed=seeds[n_dec + 2 + j], kw=kwargs):
            return M.apply_decoder_layer(
                p, h, cfg, dropout_rng=M.generator_from_seed(seed,
                                                             rng_device),
                **kw)

        if enc_remat_flags is not None and enc_remat_flags[j]:
            enc_layer = M.remat(enc_layer, cfg)
        mem = enc_layer(lp, mem)
    mem = M.apply_norm(params["enc_norm"], mem, cfg)

    x = M.apply_embedding(params["embed"], dec_tokens, cfg,
                          compute_dtype=compute_dtype, dropout_rng=gen(n_dec))
    for i, lp in enumerate(params["layers"]):
        kwargs = dict(rope=rope_dec, compute_dtype=compute_dtype)
        if layer_overrides and i in layer_overrides:
            kwargs.update(layer_overrides[i])

        def dec_layer(p, h, m, seed=seeds[i], kw=kwargs):
            return apply_cross_decoder_layer(
                p, h, m, cfg,
                dropout_rng=M.generator_from_seed(seed, rng_device), **kw)

        if remat_flags is not None and remat_flags[i]:
            dec_layer = M.remat(dec_layer, cfg)
        x = dec_layer(lp, x, mem)
    x = M.apply_norm(params["prenorm"], x, cfg)
    return M.apply_lm_head(params["head"], x, cfg,
                           wte=params["embed"]["wte"],
                           compute_dtype=compute_dtype)


def encdec_loss(
    params: Params,
    batch: Dict[str, Any],
    cfg: ModelArgs,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat_flags: Optional[Sequence[bool]] = None,
    enc_remat_flags: Optional[Sequence[bool]] = None,
    layer_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    enc_layer_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    fused_ce: bool = False,
) -> torch.Tensor:
    """batch: enc_tokens [B, S], tokens (decoder input) [B, T], labels
    [B, T], optional loss_mask and dropout_rng -> the masked mean CE."""
    logits = forward_encdec(params, batch["enc_tokens"], batch["tokens"],
                            cfg, compute_dtype=compute_dtype,
                            remat_flags=remat_flags,
                            enc_remat_flags=enc_remat_flags,
                            layer_overrides=layer_overrides,
                            enc_layer_overrides=enc_layer_overrides,
                            dropout_rng=batch.get("dropout_rng"))
    return M.cross_entropy_loss(logits, batch["labels"],
                                batch.get("loss_mask"), fused=fused_ce)
