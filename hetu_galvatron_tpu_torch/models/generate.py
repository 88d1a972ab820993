"""Autoregressive generation with a KV cache (single device).

Port of ``hetu_galvatron_tpu/models/generate.py``: a dense per-call KV
cache ``[batch, max_len, kv_heads, head_dim]`` per layer, prefill over the
prompt, then one fixed-shape decode step per new token (the JAX
``lax.scan`` becomes a Python loop over :func:`decode_step`), greedy or
temperature / top-k sampling, and the eos retirement contract.

The transformer math is not re-implemented: prefill and the decode step
run ``modules.apply_decoder_layer`` with an ``sdpa_fn`` closure that
captures (and, when decoding, writes) the rope-applied k/v. Attention
over the cache is :func:`_cached_sdpa`, the one implementation the
serving engine's paged decode, prefix-suffix prefill and speculative
verify also call (``serving/kv_cache.paged_sdpa``,
``paged_sdpa_window``).

Scope: dense causal decoder families (gpt / llama / qwen / mistral:
pre-norm, learned or rope positions, GQA, biases) through
:func:`generate`, and the t5 encoder-decoder through
:func:`generate_encdec`. Post-norm (BERT) and MoE layers raise.

Sampling draws from a ``torch.Generator``; the JAX package draws from
threefry keys, so sampled tokens differ between the packages at the same
seed. Greedy tokens do not depend on the generator.

Weights: every function takes the fp32 master tree and casts at each use,
as the JAX functions do; :func:`cast_for_compute` makes the cast once (the
same bits, since a cast is deterministic) for callers that decode many
steps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models import modules as M

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]
NEG = M.NEG_INF

# sqrt(head_dim) as a float32 tensor per (head_dim, device): made once, so
# the attention over the cache never copies a scalar to the device (a
# blocking copy, which would stall the host once a layer)
_SQRT_D: Dict[Any, torch.Tensor] = {}

# the parameter subtrees that reach the matrix products only
# (``modules._linear``, the untied head), where a cast at each use and a
# cast once give the same bits
_LINEAR_SUBTREES = ("attn", "mlp", "cross")


def _check_supported(cfg: ModelArgs, params: Params) -> None:
    if cfg.post_norm or cfg.model_type == "bert":
        raise NotImplementedError(
            "generate(): causal decoder families only (a post-norm / bert "
            "model has no KV-cache decode)")
    if cfg.model_type == "t5":
        raise NotImplementedError(
            "generate() is the causal-decoder path; use generate_encdec() "
            "for t5 (encoder once + cached cross-attention decode)")
    if any("moe" in lp for lp in params["layers"]):
        raise NotImplementedError("generate(): dense layers only")


def cast_for_compute(params: Params, compute_dtype: torch.dtype) -> Params:
    """A detached tree whose matrix-product weights (every leaf under a
    layer's ``attn``, ``mlp`` and ``cross``, and an untied ``whead``) are
    cast to ``compute_dtype`` once; embeddings and norms stay as given,
    since they are used in fp32. Running a model on this tree gives the
    bits of running it on ``params``."""

    def cast(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().to(compute_dtype)
        return {k: cast(v) for k, v in tree.items()}

    def keep(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach()
        if isinstance(tree, (list, tuple)):
            return [keep(v) for v in tree]
        return {k: keep(v) for k, v in tree.items()}

    out = {}
    for key, sub in params.items():
        if key in ("layers", "enc_layers"):
            out[key] = [{k: (cast(v) if k in _LINEAR_SUBTREES else keep(v))
                         for k, v in lp.items()} for lp in sub]
        elif key == "head":
            out[key] = {k: (cast(v) if k == "whead" else keep(v))
                        for k, v in sub.items()}
        else:
            out[key] = keep(sub)
    return out


def _cached_sdpa(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, pos,
                 shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, W, Nq, D], a window of W consecutive query positions per row
    (W = 1 is the plain decode step), against the whole cache [B, T, Nkv,
    D]: window row j sits at absolute position pos (+ j) and key positions
    beyond it are masked, in fp32. ``pos`` is an int (one shared position,
    the offline loop) or a [B] tensor (per-row positions: the serving
    engine's paged decode, its verify window and its prefix-suffix
    prefill all come here, so those multi-row passes are the same
    arithmetic as W decode steps). ``shift`` [B] (left-padded ragged
    prompts) also masks the leading pad positions < shift[b]."""
    B, W, nq, D = q.shape
    T, nkv = ck.shape[1], ck.shape[2]
    G = nq // nkv
    dev = q.device
    qg = q.reshape(B, W, nkv, G, D).float()
    s = torch.einsum("bwkgd,btkd->bwkgt", qg, ck.float())
    key = (D, dev)
    if key not in _SQRT_D:
        _SQRT_D[key] = torch.tensor(float(D), dtype=torch.float32,
                                    device=dev).sqrt()
    s = s / _SQRT_D[key]
    t = torch.arange(T, device=dev)[None, None, None, None, :]
    pos = torch.as_tensor(pos, device=dev)
    base = pos[:, None, None, None, None] if pos.dim() else pos
    row = torch.arange(W, device=dev)[None, :, None, None, None]
    mask = t <= (base + row)
    if shift is not None:
        mask = mask & (t >= shift[:, None, None, None, None])
    s = torch.where(mask, s, NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bwkgt,btkd->bwkgd", w, cv.float())
    return out.reshape(B, W, nq, D).to(q.dtype)


def _embed_at(p: Params, tokens: torch.Tensor, pos, cfg: ModelArgs,
              compute_dtype: torch.dtype,
              shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embedding for one decode step at absolute position ``pos``
    (per-row logical position ``pos - shift[b]`` for left-padded rows).
    Mirrors ``modules.apply_embedding``: the embedding LayerNorm and
    gemma's sqrt(hidden) scale included."""
    x = p["wte"][tokens[:, None]]  # [B, 1, H]
    if "wpe" in p:
        if shift is not None:
            x = x + p["wpe"][pos - shift][:, None]
        else:
            x = x + p["wpe"][pos:pos + 1][None]
    if "ln" in p:
        x = M.apply_norm(p["ln"], x, cfg)
    if cfg.scale_embeddings:
        x = x * torch.tensor(float(cfg.hidden_size), dtype=torch.float32,
                             device=x.device).sqrt().to(x.dtype)
    return x.to(compute_dtype)


def init_kv_cache(cfg: ModelArgs, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_hidden_layers)]


def _rope_full(cfg: ModelArgs, length: int, device):
    if cfg.position_embedding_type != "rope":
        return None
    return M.rope_cos_sin(length, cfg.head_dim, cfg.rope_theta,
                          device=device, scaling=cfg.rope_scaling)


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg: ModelArgs,
            max_len: int, *, compute_dtype: torch.dtype = torch.bfloat16,
            prompt_lens: Optional[torch.Tensor] = None):
    """The prompt through the stack, filling a fresh cache; returns
    (cache, logits of the last position [B, V]).

    ``prompt_lens`` [B] takes ragged prompts LEFT-padded to the common
    width S0 (row b's tokens in columns [S0 - len_b, S0)): positions
    restart at 0 on the first real token and the pad prefix is masked
    (``segment_ids``), so every row reproduces its unpadded prefill."""
    B, S0 = tokens.shape
    dev = tokens.device
    position_ids = segment_ids = None
    if prompt_lens is not None:
        shift = S0 - prompt_lens.to(device=dev, dtype=torch.long)
        idx = torch.arange(S0, device=dev)[None]
        position_ids = (idx - shift[:, None]).clamp_min(0)
        segment_ids = (idx >= shift[:, None]).to(torch.int32)
    rope = _rope_full(cfg, S0, dev)
    if rope is not None and position_ids is not None:
        rope = (rope[0][position_ids], rope[1][position_ids])
    cache = init_kv_cache(cfg, B, max_len, compute_dtype, dev)
    x = M.apply_embedding(params["embed"], tokens, cfg,
                          compute_dtype=compute_dtype,
                          position_ids=position_ids)
    for i, lp in enumerate(params["layers"]):
        cell: Dict[str, torch.Tensor] = {}

        def sdpa(q, k, v, *, causal=True, segment_ids=None, cell=cell):
            cell["k"], cell["v"] = k, v  # rope-applied, pre-attention
            return M.xla_sdpa(q, k, v, causal=causal,
                              segment_ids=segment_ids)

        sdpa.supports_segments = True
        x = M.apply_decoder_layer(lp, x, cfg, rope=rope, sdpa_fn=sdpa,
                                  compute_dtype=compute_dtype,
                                  segment_ids=segment_ids)
        cache[i]["k"][:, :S0] = cell["k"]
        cache[i]["v"][:, :S0] = cell["v"]
    x = M.apply_norm(params["prenorm"], x, cfg)
    logits = M.apply_lm_head(params["head"], x[:, -1:], cfg,
                             wte=params["embed"]["wte"],
                             compute_dtype=compute_dtype)
    return cache, logits[:, 0]


@torch.no_grad()
def decode_step(params: Params, cache: Cache, tokens: torch.Tensor, pos: int,
                cfg: ModelArgs, *, rope_full=None,
                compute_dtype: torch.dtype = torch.bfloat16,
                shift: Optional[torch.Tensor] = None):
    """One token per row at absolute position ``pos``; writes its k/v into
    ``cache`` in place and returns (cache, logits [B, V]). ``shift`` [B]
    carries a ragged prefill's left-pad offsets: rope and learned
    positions use the logical ``pos - shift[b]``, the pad stays masked."""
    x = _embed_at(params["embed"], tokens, pos, cfg, compute_dtype,
                  shift=shift)
    step_rope = None
    if rope_full is not None:
        cos, sin = rope_full
        if shift is not None:
            step_rope = (cos[pos - shift][:, None], sin[pos - shift][:, None])
        else:
            step_rope = (cos[pos:pos + 1], sin[pos:pos + 1])
    pos_t = torch.tensor(pos, device=tokens.device)  # one copy a step
    for i, lp in enumerate(params["layers"]):
        layer = cache[i]

        def sdpa(q, k, v, *, causal=True, layer=layer):
            layer["k"][:, pos] = k[:, 0]
            layer["v"][:, pos] = v[:, 0]
            return _cached_sdpa(q, layer["k"], layer["v"], pos_t,
                                shift=shift)

        x = M.apply_decoder_layer(lp, x, cfg, rope=step_rope, sdpa_fn=sdpa,
                                  compute_dtype=compute_dtype)
    x = M.apply_norm(params["prenorm"], x, cfg)
    logits = M.apply_lm_head(params["head"], x, cfg,
                             wte=params["embed"]["wte"],
                             compute_dtype=compute_dtype)
    return cache, logits[:, 0]


def _gumbel_pick(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (Gumbel-max: argmax of
    logits + Gumbel noise from ``generator``); a masked column (fp32 min)
    is never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample_pick(cfg: ModelArgs, tokens_dtype: torch.dtype,
                 temperature: float, top_k: Optional[int]) -> Callable:
    """Per-step token selection of the causal and encoder-decoder loops:
    greedy / temperature / top-k, the vocab-padding columns (untrained
    head rows) never picked."""

    def pick(logits: torch.Tensor, generator) -> torch.Tensor:
        valid = torch.arange(cfg.padded_vocab_size,
                             device=logits.device) < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.finfo(logits.dtype).min)
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(tokens_dtype)
        logits = logits / temperature
        if top_k:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth,
                                 torch.finfo(logits.dtype).min, logits)
        return _gumbel_pick(logits, generator).to(tokens_dtype)

    return pick


@torch.no_grad()
def generate(
    params: Params,
    tokens: torch.Tensor,  # [B, S0] prompt
    cfg: ModelArgs,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,  # 0 => greedy
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    pad_id: Optional[int] = None,
    prompt_lens: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    on_logits: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> torch.Tensor:
    """Returns [B, S0 + max_new_tokens].

    Retirement contract: once a row has emitted ``eos_id`` it is retired
    and every later position carries ``pad_id`` (``eos_id`` when pad_id is
    None), not live samples. Greedy rows are then independent of their
    neighbours. Sampled rows draw from one ``generator`` over the [B, V]
    batch (default: seeded 0 on the tokens' device).

    ``prompt_lens`` [B] takes ragged prompts left-padded to width S0: each
    row decodes as if it were alone and unpadded. ``on_logits(i, logits)``
    (a debug hook, off by default) sees the [B, V] logits each new token
    i is picked from."""
    _check_supported(cfg, params)
    B, S0 = tokens.shape
    dev = tokens.device
    total = S0 + max_new_tokens
    if total > cfg.max_position_embeddings and "wpe" in params["embed"]:
        raise ValueError(f"{total} exceeds max_position_embeddings")
    rope_full = _rope_full(cfg, total, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    shift = None
    if prompt_lens is not None:
        shift = S0 - prompt_lens.to(device=dev, dtype=torch.long)
    cache, logits = prefill(params, tokens, cfg, total,
                            compute_dtype=compute_dtype,
                            prompt_lens=prompt_lens)
    pick = _sample_pick(cfg, tokens.dtype, temperature, top_k)
    fill = eos_id if pad_id is None else pad_id
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = [tokens]
    for i in range(max_new_tokens):
        if on_logits is not None:
            on_logits(i, logits)
        nxt = pick(logits, generator)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, fill), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt[:, None])
        if i + 1 < max_new_tokens:
            cache, logits = decode_step(params, cache, nxt, S0 + i, cfg,
                                        rope_full=rope_full,
                                        compute_dtype=compute_dtype,
                                        shift=shift)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# encoder-decoder (t5): the encoder once, cached cross-attention k/v and a
# cached causal self-attention. Positions use the configured scheme, not
# T5's relative bias (models/encdec.py), so the decode contract tested is
# incremental == the teacher-forced forward.
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_encdec(params: Params, mem: torch.Tensor,
                   dec_tokens: torch.Tensor, cfg: ModelArgs, max_len: int, *,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """Decoder prefill over the start tokens against encoder memory
    ``mem``: fills the self-attention cache and projects the cross k/v
    once per layer. Returns (cache, cross, logits of the last position)."""
    from hetu_galvatron_tpu_torch.models.encdec import (
        apply_cross_decoder_layer,
        cross_kv,
    )

    B, T0 = dec_tokens.shape
    dev = dec_tokens.device
    rope = _rope_full(cfg, T0, dev)
    cache = init_kv_cache(cfg, B, max_len, compute_dtype, dev)
    cross = [cross_kv(lp["cross"], mem, cfg, compute_dtype)
             for lp in params["layers"]]
    x = M.apply_embedding(params["embed"], dec_tokens, cfg,
                          compute_dtype=compute_dtype)
    for i, lp in enumerate(params["layers"]):
        cell: Dict[str, torch.Tensor] = {}

        def sdpa(q, k, v, *, causal=True, cell=cell):
            cell["k"], cell["v"] = k, v
            return M.xla_sdpa(q, k, v, causal=causal)

        x = apply_cross_decoder_layer(lp, x, mem, cfg, rope=rope,
                                      sdpa_fn=sdpa,
                                      cross_sdpa_fn=M.xla_sdpa,
                                      compute_dtype=compute_dtype,
                                      cached_cross_kv=cross[i])
        cache[i]["k"][:, :T0] = cell["k"]
        cache[i]["v"][:, :T0] = cell["v"]
    x = M.apply_norm(params["prenorm"], x, cfg)
    logits = M.apply_lm_head(params["head"], x[:, -1:], cfg,
                             wte=params["embed"]["wte"],
                             compute_dtype=compute_dtype)
    return cache, cross, logits[:, 0]


@torch.no_grad()
def decode_step_encdec(params: Params, cache: Cache, cross, mem: torch.Tensor,
                       tokens: torch.Tensor, pos: int, cfg: ModelArgs, *,
                       rope_full=None,
                       compute_dtype: torch.dtype = torch.bfloat16):
    """One decoder token at absolute position ``pos``: cached causal
    self-attention and the cached cross k/v. Returns (cache, logits)."""
    from hetu_galvatron_tpu_torch.models.encdec import (
        apply_cross_decoder_layer,
    )

    x = _embed_at(params["embed"], tokens, pos, cfg, compute_dtype)
    step_rope = None
    if rope_full is not None:
        cos, sin = rope_full
        step_rope = (cos[pos:pos + 1], sin[pos:pos + 1])
    pos_t = torch.tensor(pos, device=tokens.device)  # one copy a step
    for i, lp in enumerate(params["layers"]):
        layer = cache[i]

        def sdpa(q, k, v, *, causal=True, layer=layer):
            layer["k"][:, pos] = k[:, 0]
            layer["v"][:, pos] = v[:, 0]
            return _cached_sdpa(q, layer["k"], layer["v"], pos_t)

        x = apply_cross_decoder_layer(lp, x, mem, cfg, rope=step_rope,
                                      sdpa_fn=sdpa,
                                      cross_sdpa_fn=M.xla_sdpa,
                                      compute_dtype=compute_dtype,
                                      cached_cross_kv=cross[i])
    x = M.apply_norm(params["prenorm"], x, cfg)
    logits = M.apply_lm_head(params["head"], x, cfg,
                             wte=params["embed"]["wte"],
                             compute_dtype=compute_dtype)
    return cache, logits[:, 0]


@torch.no_grad()
def generate_encdec(
    params: Params,
    enc_tokens: torch.Tensor,  # [B, S] source sequence
    cfg: ModelArgs,
    max_new_tokens: int,
    *,
    decoder_start_token_id: int = 0,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    on_logits: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> torch.Tensor:
    """Seq2seq generation: the encoder once, then one decode step per new
    token with cached self- and cross-attention k/v. Returns the decoder
    tokens [B, 1 + max_new_tokens], the start token included; a row that
    emitted ``eos_id`` repeats it."""
    from hetu_galvatron_tpu_torch.models.encdec import encode

    if cfg.model_type != "t5":
        raise ValueError("generate_encdec() is the t5/encoder-decoder path")
    B = enc_tokens.shape[0]
    dev = enc_tokens.device
    total = 1 + max_new_tokens
    if total > cfg.max_position_embeddings and "wpe" in params["embed"]:
        raise ValueError(f"{total} exceeds max_position_embeddings")
    rope_full = _rope_full(cfg, total, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    mem = encode(params, enc_tokens, cfg, compute_dtype=compute_dtype)
    start = torch.full((B, 1), decoder_start_token_id,
                       dtype=enc_tokens.dtype, device=dev)
    cache, cross, logits = prefill_encdec(params, mem, start, cfg, total,
                                          compute_dtype=compute_dtype)
    pick = _sample_pick(cfg, start.dtype, temperature, top_k)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = [start]
    for i in range(max_new_tokens):
        if on_logits is not None:
            on_logits(i, logits)
        nxt = pick(logits, generator)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt[:, None])
        if i + 1 < max_new_tokens:
            cache, logits = decode_step_encdec(
                params, cache, cross, mem, nxt, 1 + i, cfg,
                rope_full=rope_full, compute_dtype=compute_dtype)
    return torch.cat(out, dim=1)
