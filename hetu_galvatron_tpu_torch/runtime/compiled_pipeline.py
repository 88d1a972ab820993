"""Compiled pipeline schedule: the whole lockstep 1F1B forward/backward as
one captured CUDA graph.

Counterpart of ``hetu_galvatron_tpu/runtime/compiled_pipeline.py``
(``CompiledPipelineEngine`` :143). The host engine
(``runtime/pipeline.py``) sequences its schedule from the host, one
forward or backward leg of one stage at a time; this engine runs every
stage's lane in lockstep over a stage-stacked layout and captures the
whole forward/backward of a step, for one microbatch count, into one CUDA
graph that each step replays.

* **Stacked layout** (JAX :378-423): decoder layer ``s*lps + j`` is row
  ``s`` of the ``[pp, ...]`` leaves of ``stages[j]``; ``embed``,
  ``prenorm`` and ``head`` are one copy. With tied embeddings the one
  ``wte`` serves lane 0's lookup and the last lane's head, so autograd
  sums the two gradients and no exchange step is needed (JAX :57-61).
  ``merge_params`` gives the pp=1 tree, as the host engine's does.
* **Stacked layer** (JAX :467-671): the projections are batched products
  over the lane axis (``torch.bmm`` of ``[pp, B*S, H]`` by ``[pp, H,
  F]``); norms and dropout run per lane with the host engine's
  arithmetic, rope, activations and residuals on the stacked stream
  elementwise. The attention core folds ``[pp, B]`` into its batch, so on
  a CUDA device each layer slot of a tick is one launch of the flash
  kernels K1-K3 for every lane. The head runs on every lane, lane by lane
  (the host engine's product shapes), with the plain cross-entropy (JAX
  :661-670), so K4/K5 never launch here; only the last lane's loss
  carries a cotangent. ``layer.checkpoint`` remats each layer.
* **Lockstep schedule** (JAX :677-891): ``T = m + 2(pp-1)`` ticks; at tick
  t lane s runs the forward of microbatch ``t - s`` and the backward of
  ``j = t - 2(pp-1) + s``, recomputed from the stored stage input (per
  stage remat, as the host engine). The ticks are unrolled on the host at
  capture, so each lane's stored inputs are the forward inputs of the
  ticks ``t - 2(pp-1) + 2s`` (at most ``2pp - 1`` ticks back, JAX's
  buffer depth). Bubble units compute on stale or zero inputs and are
  masked as in JAX: zero cotangent seeds, and the loss accumulates only
  over valid units. Activations move lane s -> s+1 and cotangents s ->
  s-1 by a roll of the lane axis. The gradients accumulate in each leaf's
  ``.grad`` in fp32. The arithmetic is the host engine's, where JAX's
  compiled step seeds the loss with the microbatch weight (:787-790):
  the head lane back-propagates its loss unweighted and its token-share
  weight scales the head stage's gradients after (leaf hooks), a tied
  head reads a contiguous ``whead = wte.T`` whose gradient joins
  ``wte``'s after the schedule, and the global norm sums stage by stage
  less one tied copy. A step then equals the host engine's bit for bit
  where the products round alike (both cells of ``chip_smoke.py`` phase
  17 on an H100).
* **One graph per microbatch count** (JAX's jit cache :266): the first
  step of a count runs eagerly on a side stream (the warm-up, whose
  results are that step's) and is then captured; later steps copy their
  batch into the graph's static inputs (:meth:`put_batch`, the step's
  only host-to-device traffic) and replay. The graphs of a ramp share one
  memory pool. ``compile_count`` counts captures. On the CPU a stand-in
  takes the graph's place (the step runs eagerly again), so the tests
  count captures too.
* **The update stays eager** after the replay (:meth:`apply_update`),
  where JAX fuses it into its one program (:875): the port's AdamW takes
  ``lr`` and the bias corrections as host floats, which a graph would
  freeze. The split also lets the launcher's rerun machine judge the loss
  before the update, as under the host engine.
* **Observability** (JAX :1000-1013): a ``pp/compiled_step`` span around
  the step, the ``pp/bubble_frac`` gauge, and, once per microbatch count
  when a metrics sink is configured, ``cost/flops`` of the captured step
  (``trace_analysis.maybe_record_jit_cost``, program
  ``pp/compiled_step_m<m>``): the warm-up's operators counted with
  ``torch.utils.flop_counter``'s formulas (its bits unchanged) plus K1-K3's
  FLOPs from their shapes, which no dispatch mode sees.

Refused by name: plans the compiled schedule cannot express
(``analysis/eligibility.compiled_unsupported_reason``, JAX's reasons;
the launcher then runs the host engine and logs the reason); stages wider
than one rank and lanes spread over several devices (ROADMAP item 12c);
and, on a CUDA device, dropout (:data:`DROPOUT_REASON`). The eval
step runs eagerly (``T = m + pp - 1`` forward ticks), not captured.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, TrainArgs
from hetu_galvatron_tpu_torch.models import modules as M
from hetu_galvatron_tpu_torch.models.builder import named_leaves, rope_tables
from hetu_galvatron_tpu_torch.observability.registry import get_registry
from hetu_galvatron_tpu_torch.observability.trace_analysis import (
    maybe_record_jit_cost,
)
from hetu_galvatron_tpu_torch.observability.tracing import span
from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
    HybridParallelConfig,
    check_world,
)
from hetu_galvatron_tpu_torch.runtime.optimizer import (
    AdamState,
    make_pipeline_optimizer,
)
from hetu_galvatron_tpu_torch.runtime.pipeline import (
    UPDATE_SPAN,
    PipelineEngine,
)

Params = Dict[str, Any]
STEP_SPAN = "pp/compiled_step"
DROPOUT_REASON = (
    "dropout under the captured CUDA graph: every replay would repeat the "
    "first step's masks (the flash kernels take their dropout seed as a "
    "host integer and torch's generators are not registered with the "
    "graph); set model.hidden_dropout=0 and model.attention_dropout=0")


def _lead_axes(names: Sequence[str]) -> List[int]:
    """The leading axes the decay rule skips: ``[pp]`` on stacked leaves
    (JAX ``_stacked_decay_mask`` :113)."""
    return [1 if n.startswith("stages.") else 0 for n in names]


class _Program:
    """One microbatch count's step: its static inputs, the closure that
    computes the step into the leaves' ``.grad`` and the static scalars,
    and, once captured, its CUDA graph and launch census."""

    def __init__(self, m: int, inputs: Dict[str, torch.Tensor]):
        self.m = m
        self.inputs = inputs
        self.graph = None
        self.census = None
        self.captured = False
        self.cost: Optional[Dict[str, float]] = None


class CompiledPipelineEngine:
    """Lockstep 1F1B over a stage-stacked layout, one CUDA graph a
    microbatch count (see the module docstring). Same contract as
    ``PipelineEngine``: ``split_params`` / ``merge_params`` / ``init_opt``
    / ``forward_backward`` + ``apply_update`` / ``train_step`` /
    ``eval_step``, with one stacked tree and one AdamW state in place of
    the lists of stages."""

    ALLOWED_KEYS = frozenset({"tokens", "labels", "loss_mask"})

    @staticmethod
    def unsupported_reason(cfg: ModelArgs, hpc: HybridParallelConfig,
                           data: Any = None,
                           device: Optional[torch.device] = None
                           ) -> Optional[str]:
        """None when this engine can run the plan; otherwise the reason the
        launcher logs before it runs the host engine: JAX's
        (``analysis/eligibility.compiled_unsupported_reason``), and on a
        CUDA ``device`` the dropout plans a captured graph cannot replay
        (:data:`DROPOUT_REASON`)."""
        from hetu_galvatron_tpu_torch.analysis.eligibility import (
            compiled_unsupported_reason,
        )

        reason = compiled_unsupported_reason(cfg, hpc, data)
        if reason is None and device is not None and device.type == "cuda" \
                and (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0):
            reason = DROPOUT_REASON
        return reason

    def __init__(self, cfg: ModelArgs, hpc: HybridParallelConfig,
                 train: TrainArgs, devices: Sequence[torch.device], *,
                 compute_dtype: torch.dtype = torch.bfloat16):
        reason = self.unsupported_reason(cfg, hpc)
        if reason is not None:
            raise ValueError(f"compiled pipeline schedule unsupported: "
                             f"{reason}")
        check_world(hpc.world_size, hpc.pp_deg, where="compiled pipeline: ")
        wide = [i for i, s in enumerate(hpc.layers)
                if max(s.tp_size, s.cp_size, s.ep_size, s.etp_size) > 1
                or s.sp]
        if wide:
            raise NotImplementedError(
                f"compiled pipeline: layer {wide[0]} is wider than one rank "
                f"({hpc.layers[wide[0]]}); a pipeline stage wider than one "
                "rank is not ported yet (ROADMAP item 12c)")
        devices = list(devices)[:hpc.world_size]
        if len(devices) < hpc.world_size:
            raise ValueError(f"need {hpc.world_size} stage devices, have "
                             f"{len(devices)}")
        if len(set(devices)) > 1:
            raise NotImplementedError(
                f"compiled pipeline: the {hpc.pp_deg} stage lanes would "
                f"spread over {len(set(devices))} devices; this engine runs "
                "every lane on one device (lanes over several cards: "
                "ROADMAP item 12c)")
        self.cfg, self.hpc, self.train = cfg, hpc, train
        self.compute_dtype = compute_dtype
        self.device = devices[0]
        self.pp = hpc.pp_deg
        self.lps = hpc.pp_division[0]  # layers per stage (uniform)
        self.remat = bool(hpc.layers[0].checkpoint)
        self.tx = make_pipeline_optimizer(train)
        self._use_dropout = (cfg.hidden_dropout > 0.0
                             or cfg.attention_dropout > 0.0)
        self.graphs = self.device.type == "cuda"  # else the CPU stand-in
        if self._use_dropout and self.graphs:
            raise NotImplementedError(f"compiled pipeline: {DROPOUT_REASON}")
        self._sdpa = M.xla_sdpa
        self.flash = bool(cfg.use_flash_attn) and self.graphs
        if self.flash:
            from hetu_galvatron_tpu_torch.ops.flash_attention import (
                flash_sdpa,
            )

            self._sdpa = flash_sdpa
        self._causal = cfg.model_type != "bert"
        self._programs: Dict[Tuple[int, bool], _Program] = {}
        self._pool = None
        self._stream = None
        self._seeds = None  # (microbatch, lane) -> dropout seeds, per step
        self._sp: Optional[Params] = None
        self._rope = None

    # ------------------------------------------------------------------
    # params / optimizer state (stacked layout)
    # ------------------------------------------------------------------

    def split_params(self, params: Params) -> Params:
        """The full tree -> the stacked layout on the engine's device:
        layer ``s*lps + j`` becomes row s of ``stages[j]``; the vocab
        rows are shared with ``params`` where already in place. The tied
        head carries no transposed copy."""
        n = self.pp * self.lps
        if len(params["layers"]) != n:
            raise ValueError(f"params have {len(params['layers'])} layers, "
                             f"plan has {n}")

        def stack(*rows):
            if isinstance(rows[0], dict):
                return {k: stack(*(r[k] for r in rows)) for k in rows[0]}
            return torch.stack([r.detach().to(self.device) for r in rows]
                               ).contiguous().requires_grad_(True)

        sp: Params = {"stages": [
            stack(*[params["layers"][s * self.lps + j]
                    for s in range(self.pp)]) for j in range(self.lps)]}
        for k in ("embed", "prenorm", "head"):
            sp[k] = PipelineEngine._to(params[k], self.device)
        return sp

    def merge_params(self, sp: Params) -> Params:
        """The stacked layout -> the full tree (row views of the stacked
        leaves), the structure ``PipelineEngine.merge_params`` gives."""
        def row(tree, s):
            if isinstance(tree, dict):
                return {k: row(v, s) for k, v in tree.items()}
            return tree.detach()[s]

        layers = [row(sp["stages"][j], s) for s in range(self.pp)
                  for j in range(self.lps)]
        return {"layers": layers, "embed": sp["embed"],
                "prenorm": sp["prenorm"], "head": sp["head"]}

    def init_opt(self, sp: Params) -> AdamState:
        """One AdamW state over the stacked tree's named leaves; a stacked
        leaf's ``[pp]`` axis does not count toward the decay rule."""
        names, leaves = zip(*named_leaves(sp))
        return self.tx.init(list(leaves), list(names),
                            lead_axes=_lead_axes(names))

    # ------------------------------------------------------------------
    # the stacked stage computation
    # ------------------------------------------------------------------

    def _norm(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """A stacked per-layer norm, lane by lane (the host engine's
        per-stage call)."""
        if not p:
            return x
        return torch.stack([M.apply_norm({k: v[s] for k, v in p.items()},
                                         x[s], self.cfg)
                            for s in range(x.shape[0])])

    def _drop(self, x: torch.Tensor, gens) -> torch.Tensor:
        """Per-lane hidden dropout; ``gens`` is one generator a lane, or
        None."""
        if gens is None or self.cfg.hidden_dropout <= 0.0:
            return x
        return torch.stack([M.dropout(x[s], self.cfg.hidden_dropout, g)
                            for s, g in enumerate(gens)])

    def _linear(self, x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
        """``[pp, B, S, H] @ [pp, H, F] (+ [pp, F])`` as one batched product
        over the lanes, in the compute dtype (``modules._linear``)."""
        P, B, S, H = x.shape
        cd = self.compute_dtype
        y = torch.bmm(x.to(cd).reshape(P, B * S, H), w.to(cd))
        if b is not None:
            y = y + b.to(cd)[:, None, :]
        return y.reshape(P, B, S, -1)

    def _attention(self, p: Params, x: torch.Tensor, gens) -> torch.Tensor:
        cfg = self.cfg
        P, B, S, _ = x.shape
        hd, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
        qkv = self._linear(x, p["wqkv"], p.get("bqkv"))
        q, k, v = torch.split(qkv, [nq * hd, nkv * hd, nkv * hd], dim=-1)
        # lanes folded into the batch: one core call a layer slot
        q = q.reshape(P * B, S, nq, hd)
        k = k.reshape(P * B, S, nkv, hd)
        v = v.reshape(P * B, S, nkv, hd)
        if self._rope is not None:
            cos, sin = self._rope
            q, k = M.apply_rope(q, cos, sin), M.apply_rope(k, cos, sin)
        rate = cfg.attention_dropout
        if gens is not None and rate > 0.0:
            # per lane, each with its own generator (the host's draws)
            q, k, v = (t.reshape(P, B, S, -1, hd) for t in (q, k, v))
            out = torch.stack([self._sdpa(
                q[s], k[s], v[s], causal=self._causal, dropout_rate=rate,
                dropout_rng=g) for s, g in enumerate(gens)])
        else:
            out = self._sdpa(q, k, v, causal=self._causal)
        out = out.reshape(P, B, S, nq * hd)
        return self._linear(out, p["wo"], p.get("bo"))

    def _mlp(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        act = M._ACTS[self.cfg.hidden_act]
        h = self._linear(x, p["win"], p.get("bin"))
        if M.is_gated(self.cfg.hidden_act):
            gate, up = torch.chunk(h, 2, dim=-1)
            h = act(gate) * up
        else:
            h = act(h)
        return self._linear(h, p["wout"], p.get("bout"))

    def _layer(self, p: Params, x: torch.Tensor, seeds) -> torch.Tensor:
        """``modules.apply_decoder_layer`` on the stacked stream; ``seeds``
        (one int a lane, or None) seed each lane's generator as the host
        engine's layer does, inside the remat region."""
        r_attn = r_res1 = r_res2 = None
        if seeds is not None:
            gens = [M.split_rng(M.generator_from_seed(sd, self.device), 3)
                    for sd in seeds]
            r_attn, r_res1, r_res2 = ([g[i] for g in gens] for i in range(3))
        if self.cfg.post_norm:
            x = self._norm(p["ln1"], x + self._drop(
                self._attention(p["attn"], x, r_attn), r_res1))
            return self._norm(p["ln2"], x + self._drop(
                self._mlp(p["mlp"], x), r_res2))
        h = self._norm(p["ln1"], x)
        x = x + self._drop(self._attention(p["attn"], h, r_attn), r_res1)
        h = self._norm(p["ln2"], x)
        return x + self._drop(self._mlp(p["mlp"], h), r_res2)

    def _lane_seeds(self, mbs: Sequence[int]):
        """Each lane's list of ``lps + 1`` seeds (its layers', then the
        embedding's) for its microbatch, or None without dropout."""
        if self._seeds is None:
            return None
        return [self._seeds[(i, s)] for s, i in enumerate(mbs)]

    def _stacked_fwd(self, sp: Params, x_in: torch.Tensor,
                     tokens: torch.Tensor, mbs: Sequence[int]) -> torch.Tensor:
        """The stage forward of every lane: lane 0 embeds ``tokens``, the
        others take ``x_in``; then the ``lps`` layer slots."""
        lane_seeds = self._lane_seeds(mbs)
        emb_gen = (None if lane_seeds is None else
                   M.generator_from_seed(lane_seeds[0][self.lps],
                                         self.device))
        emb = M.apply_embedding(sp["embed"], tokens, self.cfg,
                                compute_dtype=self.compute_dtype,
                                dropout_rng=emb_gen)
        x = torch.cat([emb[None], x_in[1:]], dim=0)
        for j, lp in enumerate(sp["stages"]):
            seeds = (None if lane_seeds is None else
                     [ls[j] for ls in lane_seeds])

            def layer(p, h, seeds=seeds):
                return self._layer(p, h, seeds)

            if self.remat:
                layer = M.remat(layer, self.cfg, preserve_rng_state=False)
            x = layer(lp, x)
        return x

    def _stacked_full(self, sp: Params, x_in: torch.Tensor,
                      tokens: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor], mbs: Sequence[int],
                      whead: Optional[torch.Tensor] = None):
        """The stage forward with the head on every lane: ``(y, [pp]
        losses)``; only the last lane's loss is ever used (JAX :649). A
        tied head reads ``whead`` (``wte.T``) when given, else ``wte``."""
        y = self._stacked_fwd(sp, x_in, tokens, mbs)
        cfg = self.cfg
        head = sp["head"]
        wte = None
        if cfg.tie_word_embeddings:
            if whead is None:
                wte = sp["embed"]["wte"]
            else:
                head = dict(head, whead=whead)

        def lane_loss(h):
            # lane by lane: the head's weight gradient is then the host
            # engine's product, not one over every lane's tokens
            logits = M.apply_lm_head(head,
                                     M.apply_norm(sp["prenorm"], h, cfg),
                                     cfg, wte=wte,
                                     compute_dtype=self.compute_dtype)
            return M.cross_entropy_loss(logits, labels, mask)

        return y, torch.stack([lane_loss(y[s]) for s in range(self.pp)])

    # ------------------------------------------------------------------
    # the step program
    # ------------------------------------------------------------------

    def bubble_frac(self, m: Optional[int] = None) -> float:
        """Idle fraction of the lockstep schedule: each lane does 2m work
        units over ``T = m + 2(pp-1)`` ticks of 2 slots each."""
        m = max(m if m is not None else self.hpc.chunks, 1)
        return (2.0 * (self.pp - 1)) / (m + 2 * (self.pp - 1))

    def ticks(self, m: int) -> int:
        return m + 2 * (self.pp - 1)

    def _weights(self, mask: Optional[torch.Tensor], m: int) -> torch.Tensor:
        """Each microbatch's share of the valid tokens (the host engine's
        ``_microbatches`` arithmetic)."""
        if mask is not None:
            counts = mask.reshape(m, -1).to(torch.float32).sum(1)
        else:
            counts = torch.ones(m, device=self.device)
        return counts / counts.sum().clamp_min(1.0)

    def _host_norm_groups(self, names: Sequence[str]):
        """The host engine's global norm grouping: for each stage, in its
        ``named_leaves`` order, ``(leaf index, row)`` pairs that pick the
        stage's gradients out of the stacked tree (row None: the whole
        leaf; ``"whead"``: the tied copy, ``wte``'s gradient transposed)."""
        index = {n: i for i, n in enumerate(names)}
        groups = []
        for s in range(self.pp):
            items = []
            if s == 0:
                items += [(n, index[n], None) for n in names
                          if n.startswith("embed.")]
            if s == self.pp - 1:
                items += [(n, index[n], None) for n in names
                          if n.startswith("head.")]
                if self.cfg.tie_word_embeddings:
                    items.append(("head.whead", index["embed.wte"], "whead"))
            for n in names:
                if n.startswith("stages."):
                    j, rest = n.split(".", 2)[1:]
                    items.append((f"layers.{j}.{rest}", index[n], s))
            if s == self.pp - 1:
                items += [(n, index[n], None) for n in names
                          if n.startswith("prenorm.")]
            # the host stage tree's sorted names: embed, head, layers.<j>
            # (by j), prenorm
            items.sort(key=lambda it: (
                it[0].split(".")[0], int(it[0].split(".")[1])
                if it[0].startswith("layers.") else 0, it[0]))
            groups.append([(i, row) for _, i, row in items])
        return groups

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global grad norm as the host engine sums it (stage by stage,
        less one tied copy), so the clip scale is its bits too."""
        whead = None
        sq = None
        for group in self._norm_groups:
            ts = []
            for i, row in group:
                if row == "whead":
                    whead = grads[i].t().contiguous()
                    ts.append(whead)
                else:
                    ts.append(grads[i] if row is None else grads[i][row])
            part = PipelineEngine._sq_norm(ts)
            sq = part if sq is None else sq + part
        if whead is not None:
            sq = sq - PipelineEngine._sq_norm([whead])
        return torch.sqrt(sq)

    def _step(self, sp: Params, leaves: List[torch.Tensor],
              prog: _Program) -> None:
        """The whole forward/backward of one step from ``prog``'s static
        inputs: the gradients into the leaves' ``.grad`` and the loss, norm
        and clip scale into ``prog``'s static scalars. Run eagerly for the
        warm-up and once more under capture.

        The arithmetic is the host engine's: the last lane's head loss is
        back-propagated unweighted and its microbatch weight multiplies the
        head stage's gradients afterwards (leaf hooks scale the last
        lane's row of each stacked gradient, and the head's and final
        norm's, before they accumulate; and its input cotangent), a tied
        head reads a contiguous ``whead = wte.T`` whose gradient joins
        ``wte``'s after the schedule, and the norm sums stage by stage."""
        cfg, pp, m = self.cfg, self.pp, prog.m
        inp = prog.inputs
        tokens, labels = inp["tokens"], inp["labels"]
        mask = inp.get("loss_mask")
        torch._foreach_zero_([t.grad for t in leaves])
        w = self._weights(mask, m)
        _, b, S = tokens.shape
        zero = torch.zeros((pp, b, S, cfg.hidden_size),
                           dtype=self.compute_dtype, device=self.device)
        zero0 = torch.zeros((), device=self.device)
        one0 = torch.ones((), device=self.device)
        lag = 2 * (pp - 1)
        fwd_x, bwd_dy, hist = zero, zero, {}
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        clip = lambda i: min(max(i, 0), m - 1)  # noqa: E731
        whead = None
        if cfg.tie_word_embeddings:
            whead = sp["embed"]["wte"].detach().t().contiguous()
            whead.requires_grad_(True)
        for t in range(self.ticks(m)):
            # forward unit: lane s runs microbatch t - s (no graph kept)
            hist[t] = fwd_x
            with torch.no_grad():
                y = self._stacked_fwd(sp, fwd_x, tokens[clip(t)],
                                      [clip(t - s) for s in range(pp)])
            # backward unit: lane s recomputes microbatch t - 2(pp-1) + s
            # from its stored input, the forward of tick t - 2(pp-1) + 2s
            bj = [t - lag + s for s in range(pp)]
            valid = [0 <= j < m for j in bj]
            x_st = torch.stack([
                hist[t - lag + 2 * s][s] if t - lag + 2 * s >= 0 else zero[s]
                for s in range(pp)]).requires_grad_(True)
            dy_in = torch.stack([bwd_dy[s] if valid[s] else zero[s]
                                 for s in range(pp)])
            last = clip(bj[-1])
            w_last = w[last] if valid[-1] else zero0
            dl = torch.cat([torch.zeros(pp - 1, device=self.device),
                            (one0 if valid[-1] else zero0).reshape(1)])
            hooks = self._head_hooks(leaves, whead, w_last)
            with torch.enable_grad():
                y_re, losses = self._stacked_full(
                    sp, x_st, tokens[clip(bj[0])], labels[last],
                    None if mask is None else mask[last],
                    [clip(j) for j in bj], whead=whead)
                torch.autograd.backward(
                    [y_re, losses], [dy_in, dl],
                    inputs=leaves + [x_st] + ([] if whead is None
                                              else [whead]))
            for h in hooks:
                h.remove()
            if valid[-1]:
                loss = loss + w_last * losses[pp - 1].detach()
            x_st.grad[pp - 1].mul_(w_last)
            # rotate: activations s -> s+1, cotangents s -> s-1
            fwd_x = torch.roll(y, 1, 0)
            bwd_dy = torch.roll(x_st.grad, -1, 0)
            hist.pop(t - lag, None)
            del y, y_re, losses, x_st
        grads = [t.grad for t in leaves]
        if whead is not None:
            grads[self._names.index("embed.wte")].add_(whead.grad.t())
        gnorm = self._global_norm(grads)
        clip_grad = self.train.clip_grad
        scale = (torch.clamp(clip_grad / (gnorm + 1e-12), max=1.0)
                 if clip_grad and clip_grad > 0 else torch.ones_like(gnorm))
        prog.loss.copy_(loss)
        prog.gnorm.copy_(gnorm)
        prog.scale.copy_(scale)

    def _head_hooks(self, leaves: List[torch.Tensor],
                    whead: Optional[torch.Tensor], w: torch.Tensor):
        """Hooks that multiply the head stage's gradients by its microbatch
        weight ``w`` before they accumulate: the last lane's row of each
        stacked leaf, the head's and the final norm's leaves, the tied
        ``whead``."""
        pp = self.pp

        def last_row(g):
            return torch.cat([g[:pp - 1], g[pp - 1:] * w])

        def whole(g):
            return g * w

        hooks = []
        for name, t in zip(self._names, leaves):
            if name.startswith("stages."):
                hooks.append(t.register_hook(last_row))
            elif name.startswith(("head.", "prenorm.")):
                hooks.append(t.register_hook(whole))
        if whead is not None:
            hooks.append(whead.register_hook(whole))
        return hooks

    def _flash_flops(self, m: int, b: int, S: int) -> float:
        """K1-K3's FLOPs in one step (the launches the flop counter cannot
        see): each tick runs the layer slots' K1 ``2 + remat`` times and
        K2, K3 once, at the lanes folded into the batch."""
        from hetu_galvatron_tpu_torch.ops import flash_attention as TF

        if self._sdpa is not getattr(TF, "flash_sdpa", None):
            return 0.0
        cfg = self.cfg
        shape = (self.pp * b, cfg.num_attention_heads, S, S, cfg.head_dim)
        per_slot = ((2 + self.remat) * TF.flash_flops("flash_fwd", *shape,
                                                      causal=self._causal)
                    + TF.flash_flops("flash_bwd_dkdv", *shape,
                                     causal=self._causal)
                    + TF.flash_flops("flash_bwd_dq", *shape,
                                     causal=self._causal))
        return float(self.ticks(m) * self.lps * per_slot)

    def _program(self, m: int, has_mask: bool, like: Dict[str, Any]
                 ) -> _Program:
        key = (m, has_mask)
        if key not in self._programs:
            b = like["tokens"].shape[0] // m
            S = like["tokens"].shape[1]
            keys = ["tokens", "labels"] + (["loss_mask"] if has_mask else [])
            inputs = {k: torch.zeros(
                (m, b, S), device=self.device,
                dtype=torch.float32 if k == "loss_mask" else torch.long)
                for k in keys}
            prog = _Program(m, inputs)
            prog.loss, prog.gnorm, prog.scale = (
                torch.zeros((), device=self.device) for _ in range(3))
            self._programs[key] = prog
        return self._programs[key]

    def put_batch(self, batch: Dict[str, Any], m: int
                  ) -> Dict[str, torch.Tensor]:
        """Copy a batch (``[gbsz, S]`` numpy arrays or tensors) into the
        static inputs of microbatch count ``m``'s program, as ``[m, gbsz/m,
        S]``; returns those inputs. The step's only host-to-device copy."""
        extra = set(batch) - self.ALLOWED_KEYS - {"dropout_rng"}
        if extra:
            raise NotImplementedError(
                f"the compiled pipeline schedule does not thread batch keys "
                f"{sorted(extra)}")
        b = batch["tokens"].shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by chunks {m}")
        prog = self._program(m, "loss_mask" in batch, batch)
        for k, dst in prog.inputs.items():
            src = batch[k]
            if isinstance(src, np.ndarray):
                src = torch.from_numpy(np.ascontiguousarray(src))
            if tuple(src.shape) != (dst.shape[0] * dst.shape[1],
                                    dst.shape[2]):
                raise ValueError(f"batch {k} {tuple(src.shape)} does not fit "
                                 f"the program's {tuple(dst.shape)}")
            dst.copy_(src.reshape(dst.shape), non_blocking=True)
        return prog.inputs

    def _resolve_m(self, num_microbatches: Optional[int]) -> int:
        return max(num_microbatches if num_microbatches is not None
                   else self.hpc.chunks, 1)

    def _set_seeds(self, step_rng, m: int) -> None:
        """The host engine's dropout seeds of this step: one per
        (microbatch, stage) from the step's generator, split on the host
        into the stage's layers' and its embedding's."""
        if not self._use_dropout:
            return
        if step_rng is None:
            raise ValueError(
                "cfg enables dropout but the batch has no 'dropout_rng' "
                "key; train_dist adds one per step, manual callers must "
                "pass one")
        seeds = M.split_seeds(step_rng, m * self.pp)
        self._seeds = {(i, s): PipelineEngine._seeds(seeds[i * self.pp + s],
                                                     self.lps + 1)
                       for i in range(m) for s in range(self.pp)}

    def _run(self, sp: Params, leaves: List[torch.Tensor],
             prog: _Program) -> None:
        """Replay the program; on its first run, run it eagerly (the
        warm-up, counted for ``cost/flops``) and capture it."""
        if prog.captured:
            if prog.graph is not None:
                prog.graph.replay()
                prog.census.replayed()
            else:  # the CPU stand-in for a replay
                self._step(sp, leaves, prog)
            return
        b, S = prog.inputs["tokens"].shape[1:]
        step = lambda: self._step(sp, leaves, prog)  # noqa: E731
        program = f"{STEP_SPAN}_m{prog.m}"
        extra = lambda: self._flash_flops(prog.m, b, S)  # noqa: E731
        if not self.graphs:
            _, prog.cost = maybe_record_jit_cost(program, step,
                                                 extra_flops=extra)
            prog.captured = True
            return
        from hetu_galvatron_tpu_torch.ops import _build

        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        # warm-up on the capture's stream: kernel library, cuBLAS handles
        # and the autograd threads exist before the capture; its results
        # are this step's
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            _, prog.cost = maybe_record_jit_cost(program, step,
                                                 extra_flops=extra)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        census = _build.CaptureCensus()
        with census, torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream):
            step()
        prog.graph, prog.census, prog.captured = graph, census, True

    def _prepare(self, sp: Params) -> List[torch.Tensor]:
        """The stacked tree's leaves with their static ``.grad`` buffers;
        the graphs read the leaves in place, so another tree (or a leaf
        replaced) drops every captured program."""
        self._names, leaves = (list(x) for x in zip(*named_leaves(sp)))
        self._norm_groups = self._host_norm_groups(self._names)
        if self._sp is not None and (
                [t.data_ptr() for t in leaves] != self._leaf_ptrs):
            self._programs.clear()
        self._sp, self._leaf_ptrs = sp, [t.data_ptr() for t in leaves]
        for t in leaves:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        self._make_rope()
        return leaves

    def _make_rope(self) -> None:
        """The rope tables, made once before any capture (they build
        constants on the host)."""
        if self._rope is None and self.cfg.position_embedding_type == "rope":
            self._rope = rope_tables(self.cfg, torch.zeros(
                (1, self.cfg.seq_length), dtype=torch.long,
                device=self.device))

    def forward_backward(self, sp: Params, batch: Dict[str, Any],
                         num_microbatches: Optional[int] = None):
        """The step's gradients and metrics: ``(grads, metrics)`` with the
        leaves' ``.grad`` buffers in ``named_leaves`` order (the graph's
        static outputs: the next step overwrites them) and ``loss``,
        ``grad_norm`` and ``clip_scale`` as tensors; the parameters are
        untouched (the launcher's rerun machine judges the loss before
        :meth:`apply_update`). ``num_microbatches`` overrides the plan's
        chunks (the batch-size ramp)."""
        m = self._resolve_m(num_microbatches)
        batch = dict(batch)
        step_rng = batch.pop("dropout_rng", None)
        self._set_seeds(step_rng, m)
        leaves = self._prepare(sp)
        S = batch["tokens"].shape[1]
        if self._rope is not None and S != self._rope[0].shape[0]:
            raise ValueError(f"batch sequence {S} differs from the model's "
                             f"seq_length {self._rope[0].shape[0]}")
        prog = self._program(m, "loss_mask" in batch, batch)
        if not all(batch.get(k) is v for k, v in prog.inputs.items()):
            self.put_batch(batch, m)
        with span(STEP_SPAN):
            self._run(sp, leaves, prog)
        get_registry().gauge("pp/bubble_frac").set(self.bubble_frac(m))
        return [t.grad for t in leaves], {
            "loss": prog.loss.clone(), "grad_norm": prog.gnorm.clone(),
            "clip_scale": prog.scale.clone()}

    def apply_update(self, sp: Params, so: AdamState,
                     grads: List[torch.Tensor],
                     metrics: Dict[str, Any]) -> None:
        """The gradients times the clip scale (expert biases excepted),
        then AdamW, in place and eagerly (the module docstring says why).
        ``grads`` are consumed."""
        with span(UPDATE_SPAN):
            torch._foreach_mul_([grads[i] for i in so.adam],
                                metrics["clip_scale"])
            self.tx.update([t for _, t in named_leaves(sp)], grads, so, None)

    def train_step(self, sp: Params, so: AdamState, batch: Dict[str, Any],
                   num_microbatches: Optional[int] = None
                   ) -> Tuple[Params, AdamState, Dict[str, float]]:
        """One optimizer step, in place; returns the state and the host
        floats ``loss`` and ``grad_norm``."""
        grads, metrics = self.forward_backward(sp, batch, num_microbatches)
        self.apply_update(sp, so, grads, metrics)
        loss, gnorm = torch.stack([metrics["loss"],
                                   metrics["grad_norm"]]).tolist()
        return sp, so, {"loss": loss, "grad_norm": gnorm}

    def eval_step(self, sp: Params, batch: Dict[str, Any],
                  num_microbatches: Optional[int] = None
                  ) -> Dict[str, float]:
        """Held-out loss under the training plan, dropout off: ``T = m + pp
        - 1`` forward ticks, the loss from the last lane (JAX :892). Runs
        eagerly."""
        m = self._resolve_m(num_microbatches)
        batch = dict(batch)
        batch.pop("dropout_rng", None)
        extra = set(batch) - self.ALLOWED_KEYS
        if extra:
            raise NotImplementedError(
                f"the compiled pipeline schedule does not thread batch keys "
                f"{sorted(extra)}")
        self._make_rope()
        dev, pp = self.device, self.pp

        def mb(k):
            v = batch[k]
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            v = v.to(dev, torch.float32 if k == "loss_mask" else torch.long)
            return v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))

        tokens, labels = mb("tokens"), mb("labels")
        mask = mb("loss_mask") if "loss_mask" in batch else None
        w = self._weights(mask, m)
        clip = lambda i: min(max(i, 0), m - 1)  # noqa: E731
        seeds, self._seeds = self._seeds, None
        try:
            with torch.no_grad():
                x = torch.zeros(
                    (pp,) + tuple(tokens.shape[1:]) + (self.cfg.hidden_size,),
                    dtype=self.compute_dtype, device=dev)
                loss = torch.zeros((), device=dev)
                for t in range(m + pp - 1):
                    li = t - (pp - 1)  # the last lane's microbatch
                    y, losses = self._stacked_full(
                        sp, x, tokens[clip(t)], labels[clip(li)],
                        None if mask is None else mask[clip(li)],
                        [clip(t - s) for s in range(pp)])
                    if 0 <= li < m:
                        loss = loss + w[li] * losses[pp - 1]
                    x = torch.roll(y, 1, 0)
        finally:
            self._seeds = seeds
        return {"loss": float(loss)}

    def release(self) -> None:
        """Drop the captured graphs, their memory pool and the static
        ``.grad`` buffers (the end of a run: the pool holds the step's
        peak between replays)."""
        self._programs.clear()
        self._pool = self._stream = None
        if self._sp is not None:
            for _, t in named_leaves(self._sp):
                t.grad = None
        self._sp = None

    def compile_count(self) -> int:
        """Captured programs (one per microbatch count): a fixed plan
        captures once, a ramp once per distinct count."""
        return sum(p.captured for p in self._programs.values())

    def program_costs(self) -> Dict[str, Dict[str, float]]:
        """The recorded ``cost/*`` of each captured program, by name."""
        return {f"{STEP_SPAN}_m{m}": p.cost
                for (m, _), p in self._programs.items() if p.cost}
