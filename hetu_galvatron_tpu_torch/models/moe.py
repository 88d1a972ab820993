"""Mixture-of-Experts layers: routers, token dispatch and the expert MLPs.

Counterpart of ``hetu_galvatron_tpu/models/moe.py``, with its parameter
layout (``router [H, E]``, ``win [E, H, 2F]`` gate | up for gated
activations or ``[E, H, F]``, ``wout [E, F, H]``, an optional ``shared``
dense MLP of ``num_shared_experts * F`` and an optional ``expert_bias
[E]``), so weights cross between the packages unchanged.

Routers (``moe_router_type``): softmax top-k, the weights renormalised over
the chosen k, optionally with a selection-only expert bias; or sinkhorn
selection with sigmoid / softmax weights of the raw logits. Dispatch
(``moe_dispatcher``):

* ``capacity`` (GShard): each (token, k) slot takes the next place in its
  expert's buffer of C slots, in token order and k order; over-capacity
  slots drop and the token's weight is spread over its survivors. Dispatch,
  the expert products and combine are dense matrix products over [E, C], as
  the JAX package's einsums are.
* ``dropless``: slots sorted by expert (stable), the expert MLPs run per
  expert over its run of the sorted buffer (the JAX package's
  ``lax.ragged_dot``), and ``index_add`` combines. Each call reads the
  per-expert group sizes to the host once, to slice the sorted buffer: a
  device sync per MoE layer, and one more per layer in a remat recompute.

The module has no kernel of its own: the JAX module reaches no Pallas
kernel, and its einsums and ragged products are torch matmuls here. Products
run in the compute dtype and round once to it, where the JAX package
accumulates in fp32 and casts; where it keeps an fp32 result (dropless
expert outputs, the routed sum before a shared expert is added), the port
rounds to the compute dtype first. fp32 runs are unaffected.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models import modules as M

Params = Dict[str, Any]
Stats = Dict[str, torch.Tensor]


def is_moe_layer(cfg: ModelArgs, layer_idx: int) -> bool:
    """Every ``moe_layer_freq``-th layer is MoE (none without experts)."""
    if not cfg.num_experts:
        return False
    return (layer_idx + 1) % max(cfg.moe_layer_freq, 1) == 0


def moe_capacity(cfg: ModelArgs, tokens: int,
                 capacity_factor: Optional[float] = None) -> int:
    """Per-expert slots: ceil(tokens * k / E * factor), at least k."""
    cf = (capacity_factor if capacity_factor is not None
          else cfg.moe_capacity_factor)
    return max(int(math.ceil(tokens * cfg.moe_topk / cfg.num_experts * cf)),
               cfg.moe_topk)


def sinkhorn(logits: torch.Tensor, n_iters: int = 8) -> torch.Tensor:
    """Sinkhorn normalisation of a [T, E] score matrix, a fixed number of
    iterations."""
    cost = torch.exp(logits.float())
    T, E = cost.shape
    d1 = torch.ones(E, dtype=torch.float32, device=cost.device)
    for _ in range(n_iters):
        d0 = 1.0 / T / (cost * d1[None, :]).sum(-1).clamp_min(1e-9)
        d1 = 1.0 / E / (cost * d0[:, None]).sum(0).clamp_min(1e-9)
    d0 = 1.0 / T / (cost * d1[None, :]).sum(-1).clamp_min(1e-9)
    return d0[:, None] * cost * d1[None, :]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over its last axis, by comparison (no
    device sync, no int64 copy)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def update_expert_bias(expert_bias: torch.Tensor,
                       tokens_per_expert: torch.Tensor,
                       update_rate: float = 1e-3) -> torch.Tensor:
    """Aux-loss-free balancing step: under-loaded experts' selection bias up
    by ``update_rate``, over-loaded ones down."""
    err = tokens_per_expert.mean() - tokens_per_expert
    return expert_bias + update_rate * torch.sign(err)


def _z_loss(logits: torch.Tensor, coeff: float) -> torch.Tensor:
    return coeff * torch.logsumexp(logits, dim=-1).square().mean()


def route_tokens(p: Params, xt: torch.Tensor, cfg: ModelArgs,
                 compute_dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Stats]:
    """Router: tokens [T, H] -> (top-k expert ids [T, K] in descending
    score, fp32 weights [T, K], aux loss, stats). ``stats`` holds the
    per-layer balance observables, detached: ``load_balance_loss``,
    ``z_loss`` and ``tokens_per_expert [E]`` (fp32 counts).

    With ``p["expert_bias"]`` the bias shifts only which experts are
    picked, and the aux loss gains a term of value 0 whose gradient with
    respect to the bias is minus its balancing update: the optimizer's
    SGD(lr=1) partition (``runtime/optimizer.py``) turns it into ``bias +
    update``."""
    E, K = cfg.num_experts, cfg.moe_topk
    router_dtype = (torch.float32 if cfg.moe_router_dtype == "float32"
                    else compute_dtype)
    # fp32 products of router_dtype values (JAX: preferred_element_type)
    logits = torch.matmul(xt.to(router_dtype).float(),
                          p["router"].to(router_dtype).float())
    zero = logits.new_zeros(())

    if cfg.moe_router_type == "sinkhorn":
        if cfg.moe_aux_loss_coeff:
            raise ValueError("sinkhorn routing does not support the aux "
                             "loss; set moe_aux_loss_coeff=0")
        topk_idx = torch.topk(sinkhorn(logits.detach()), K, dim=-1).indices
        scores = (torch.sigmoid(logits) if K == 1
                  else torch.softmax(logits, dim=-1))
        w = torch.gather(scores, -1, topk_idx)
        zloss = (_z_loss(logits, cfg.moe_z_loss_coeff)
                 if cfg.moe_z_loss_coeff else zero)
        stats = {"load_balance_loss": zero,
                 "z_loss": zloss.detach(),
                 "tokens_per_expert": _one_hot(topk_idx, E).sum((0, 1))}
        return topk_idx, w.float(), zloss, stats

    probs = torch.softmax(logits, dim=-1)  # [T, E]
    select = probs
    if "expert_bias" in p:
        select = probs + p["expert_bias"].detach()
    topk_idx = torch.topk(select, K, dim=-1).indices
    sel = _one_hot(topk_idx, E)  # [T, K, E]
    tokens_per_expert = sel.sum((0, 1))
    topk_probs = torch.gather(probs, -1, topk_idx)
    topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True).clamp_min(1e-9)
    frac_tokens = sel.sum(1).mean(0)  # f_e
    frac_probs = probs.mean(0)  # P_e
    balance = cfg.moe_aux_loss_coeff * E * torch.sum(frac_tokens * frac_probs)
    zloss = (_z_loss(logits, cfg.moe_z_loss_coeff)
             if cfg.moe_z_loss_coeff else zero)
    aux = balance + zloss
    if "expert_bias" in p:
        update = update_expert_bias(torch.zeros_like(tokens_per_expert),
                                    tokens_per_expert,
                                    cfg.moe_expert_bias_update_rate)
        term = torch.sum(-update * p["expert_bias"])
        aux = aux + (term - term.detach())
    stats = {"load_balance_loss": balance.detach(),
             "z_loss": zloss.detach(),
             "tokens_per_expert": tokens_per_expert}
    return topk_idx, topk_probs.float(), aux, stats


def init_moe_mlp(gen: torch.Generator, cfg: ModelArgs, device) -> Params:
    """``router``, ``win`` at std 0.02 and ``wout`` at the residual std
    0.02 / sqrt(2L), drawn in that order; then the ``shared`` MLP and a zero
    ``expert_bias`` where the config asks for them."""
    h, e = cfg.hidden_size, cfg.num_experts
    f = cfg.moe_ffn_hidden_size or cfg.ffn_dim
    fin = 2 * f if M.is_gated(cfg.hidden_act) else f
    p: Params = {
        "router": M.normal(gen, (h, e), 0.02, device),
        "win": M.normal(gen, (e, h, fin), 0.02, device),
        "wout": M.normal(gen, (e, f, h),
                         0.02 / math.sqrt(2 * cfg.num_hidden_layers), device),
    }
    if cfg.num_shared_experts:
        p["shared"] = M.init_mlp(gen, cfg, device,
                                 ffn_dim=f * cfg.num_shared_experts)
    if cfg.moe_router_enable_expert_bias:
        p["expert_bias"] = torch.zeros(e, device=device)
    return p


def _expert_act(hproj: torch.Tensor, cfg: ModelArgs,
                compute_dtype: torch.dtype) -> torch.Tensor:
    hproj = hproj.to(compute_dtype)
    act = M._ACTS[cfg.hidden_act]
    if M.is_gated(cfg.hidden_act):
        gate, up = torch.chunk(hproj, 2, dim=-1)
        return act(gate) * up
    return act(hproj)


def _capacity_dispatch(p: Params, xt: torch.Tensor, topk_idx: torch.Tensor,
                       w: torch.Tensor, cfg: ModelArgs,
                       compute_dtype: torch.dtype,
                       capacity_factor: Optional[float]) -> torch.Tensor:
    """GShard capacity dispatch: [T, H] -> [T, H] in the compute dtype."""
    T, H = xt.shape
    E, K = cfg.num_experts, cfg.moe_topk
    C = moe_capacity(cfg, T, capacity_factor)
    flat_sel = _one_hot(topk_idx.reshape(T * K), E)  # [T*K, E]
    # place of each slot in its expert's buffer; -1 where not routed there
    pos = torch.cumsum(flat_sel, dim=0) * flat_sel - 1.0
    in_cap = (pos >= 0) & (pos < C)
    # one-hot over C: all-zero rows for pos = -1 and for dropped slots
    # (pos >= C), as jax.nn.one_hot gives (times in_cap there)
    pos_oh = _one_hot(pos, C).view(T, K, E * C)  # [T, K, E*C]
    dispatch = pos_oh.sum(1)  # [T, E*C]
    # spread dropped slots' weight over the survivors, keeping the token's
    # total combine weight
    kept = (flat_sel * in_cap.float()).sum(-1).view(T, K)
    wk = w * kept
    wk = wk * (w.sum(-1, keepdim=True)
               / wk.sum(-1, keepdim=True).clamp_min(1e-9))
    # [T, 1, K] x [T, K, E*C]: a token's k slots sit in distinct experts,
    # so each entry is one weight or 0
    combine = torch.bmm(wk[:, None, :], pos_oh)[:, 0]  # [T, E*C]

    cd = compute_dtype
    # expert compute: [E, C, H] -> [E, C, F] -> [E, C, H]
    xe = torch.matmul(dispatch.to(cd).t(), xt.to(cd)).view(E, -1, H)
    hproj = _expert_act(torch.bmm(xe, p["win"].to(cd)), cfg, cd)
    ye = torch.bmm(hproj, p["wout"].to(cd))
    return torch.matmul(combine.to(cd), ye.view(E * C, H))


def _dropless_dispatch(p: Params, xt: torch.Tensor, topk_idx: torch.Tensor,
                       w: torch.Tensor, cfg: ModelArgs,
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """Dropless dispatch: [T, H] -> fp32 [T, H]. One host read of the group
    sizes per call (see the module docstring)."""
    T, H = xt.shape
    E, K = cfg.num_experts, cfg.moe_topk
    cd = compute_dtype
    eid = topk_idx.reshape(T * K)
    order = torch.argsort(eid, stable=True)  # token order within an expert
    tok_sorted = order // K  # slot -> token
    xs = xt[tok_sorted].to(cd)  # [T*K, H]
    sizes: List[int] = torch.bincount(eid, minlength=E).tolist()
    win, wout = p["win"].to(cd), p["wout"].to(cd)
    ys, start = [], 0
    for e, n in enumerate(sizes):
        hproj = _expert_act(torch.matmul(xs[start:start + n], win[e]), cfg,
                            cd)
        ys.append(torch.matmul(hproj, wout[e]))
        start += n
    ws = w.reshape(T * K)[order]
    # each token row receives its k addends onto zero; for k <= 2 every
    # order of the adds gives the same bits (0 + a + b == 0 + b + a), so
    # this equals the JAX scatter-add exactly; for k > 2 the order may
    # differ, and tests/test_torch_moe.py::test_torch_dropless_dispatch_
    # top3_matches_jax_scatter_add holds it within a few ULP
    return torch.zeros((T, H), dtype=torch.float32,
                       device=xt.device).index_add(
        0, tok_sorted, torch.cat(ys).float() * ws[:, None])


def apply_moe_mlp(p: Params, x: torch.Tensor, cfg: ModelArgs,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor, Stats]:
    """x [B, S, H] -> (y [B, S, H] in the compute dtype, aux loss, router
    stats)."""
    B, S, H = x.shape
    xt = x.reshape(B * S, H)
    topk_idx, w, aux, stats = route_tokens(p, xt, cfg, compute_dtype)
    if cfg.moe_dispatcher == "dropless":
        y = _dropless_dispatch(p, xt, topk_idx, w, cfg, compute_dtype)
    else:
        y = _capacity_dispatch(p, xt, topk_idx, w, cfg, compute_dtype,
                               cfg.moe_capacity_factor)
    if "shared" in p:
        y = y + M.apply_mlp(p["shared"], xt[None], cfg,
                            compute_dtype=compute_dtype)[0]
    return y.reshape(B, S, H).to(compute_dtype), aux, stats


def apply_moe_decoder_layer(
    p: Params,
    x: torch.Tensor,
    cfg: ModelArgs,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    sdpa_fn=M.xla_sdpa,
    compute_dtype: torch.dtype = torch.bfloat16,
    dropout_rng: Optional[torch.Generator] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Stats]:
    """Pre-norm block with an MoE FFN: (x, aux loss, router stats)."""
    r_attn, r_res1, r_res2 = M.split_rng(dropout_rng, 3)
    h = M.apply_norm(p["ln1"], x, cfg)
    x = x + M.dropout(
        M.apply_attention(p["attn"], h, cfg, rope=rope, sdpa_fn=sdpa_fn,
                          compute_dtype=compute_dtype, dropout_rng=r_attn,
                          segment_ids=segment_ids),
        cfg.hidden_dropout, r_res1)
    h = M.apply_norm(p["ln2"], x, cfg)
    y, aux, stats = apply_moe_mlp(p["moe"], h, cfg,
                                  compute_dtype=compute_dtype)
    return x + M.dropout(y, cfg.hidden_dropout, r_res2), aux, stats
