"""Pipeline-parallel engine: GPipe, 1F1B and interleaved schedules that the
host sequences over a list of stage devices.

Counterpart of ``hetu_galvatron_tpu/runtime/pipeline.py`` (``_Stage`` :92,
``PipelineEngine`` :106), the JAX package's single-controller engine: one
process drives every stage, each stage is its own program on its own
device, and activations move between stages as tensors (``_transfer``
:892 there, ``Tensor.to`` here). Every stage runs one rank: the world is
``pp_deg`` (``runtime/hybrid_config.check_world``) and stage group g runs
on ``devices[g]``; several ranks may share one device
(``runtime/initialize.py``), and then the stages on it run one after
another.

* **Layout** (:190-233): ``pp_division`` has ``pp_deg x vpp_deg`` chunks;
  chunk c runs on group ``c % pp_deg`` (Megatron's round robin), chunk 0
  holds the embedding and the last chunk the final norm and the head. A
  t5 model slices its combined stack, encoder layers first; the
  inter-stage activation is the pair ``(a, b)``: the encoder stream (the
  encoder memory once the stage holding the last encoder layer applies
  ``enc_norm``) and the decoder stream. Stage 0 embeds both token streams,
  so the decoder stream rides through encoder stages unchanged.
* **Tied embeddings** (:323, :1067-1084): the last stage holds the
  transposed copy of ``wte`` as ``head.whead``; after the schedule the two
  gradients are summed, both copies get the sum, and the same elementwise
  AdamW keeps them equal. ``merge_params`` drops the copy.
* **Backward by recompute** (:641-686): a non-head stage's forward runs
  without a graph and stores only its input (detached); its backward
  recomputes the stage from that input under ``torch.enable_grad()`` and
  back-propagates the incoming cotangent, plus the microbatch's weight as
  the cotangent of the stage's MoE aux loss. The head stage's forward is
  fused into its backward, which returns the unweighted loss; its
  gradients are scaled by the microbatch weight after (:672-673). A
  per-layer ``checkpoint`` flag remats the layer inside the recompute, so
  a step launches the flash forward K1 ``2 L - L_head + C`` times a
  microbatch (L layers, L_head on the head chunk, C checkpointed; a t5
  decoder layer counts twice, self- and cross-attention) and K2, K3 ``L``
  times. The head runs the plain cross-entropy, as JAX's does (:542,
  :616), whatever ``use_fused_ce`` says: K4/K5 never launch here.
* **Schedules** (:994-1119): GPipe runs every forward, then every
  backward; 1F1B (``pipedream_flush``) runs ``min(chunks of stages,
  microbatches)`` forwards, then one backward and one forward in turn,
  then the rest of the backwards. A microbatch's stored inputs are freed
  after its backward. Gradients accumulate per stage in fp32.
* **Clip and update** (:1086-1109): the global norm sums every stage's
  squares less one tied copy, the clip scale ``min(1, clip / (norm +
  1e-12))`` is computed on the device and multiplies each stage's
  gradients (expert biases excepted) before the stage's AdamW without a
  clip (``optimizer.make_pipeline_optimizer``). ``train_step`` reads the
  host once, at its end: the weighted loss and the norm.
* **Dropout**: the step's generator gives one seed for each (microbatch,
  chunk); a stage derives its layers' seeds from it on the host, so a
  microbatch's forward and its recompute draw the same masks, K1's
  in-kernel dropout included. The streams are the port's own and differ
  from JAX's threefry (``_mb_rng`` :918).

The span names are JAX's (``pp/fwd_s<c>``, ``pp/bwd_s<c>``,
``pp/update``), built once per stage, so ``trace_analysis.attribute``
reads them.

Refused by name, as not ported yet: stages wider than one rank (tp, cp,
sp, ep, a world other than ``pp_deg``: ROADMAP item 12c). The launcher
refuses the rest where the settings enter (``cli/train_dist.check_flags``
and ``runtime/hybrid_config.check_plan_width``): the hierarchical dp
reduction and its per-lane backward (``hier_dp``, ``_make_bwd_lanes``
:688; item 12d), overlapped tp (item 11) and ``dcn_slices > 1``.
The per-stage cost recording (``maybe_record_jit_cost``) waits for a
captured step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, TrainArgs
from hetu_galvatron_tpu_torch.models import modules as M
from hetu_galvatron_tpu_torch.models.builder import named_leaves, rope_tables
from hetu_galvatron_tpu_torch.observability.tracing import span
from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
    HybridParallelConfig,
    check_world,
)
from hetu_galvatron_tpu_torch.runtime.optimizer import (
    AdamState,
    make_pipeline_optimizer,
)

Params = Dict[str, Any]
UPDATE_SPAN = "pp/update"


@dataclass
class _Stage:
    index: int
    device: torch.device
    layer_range: Tuple[int, int]  # [lo, hi) decoder-layer indices
    remat: List[bool]  # per decoder layer of the stage
    has_embed: bool
    has_head: bool
    # encoder-decoder (t5) only
    enc_layer_range: Tuple[int, int] = (0, 0)
    enc_remat: List[bool] = field(default_factory=list)
    has_enc_norm: bool = False
    attn: Dict[str, Any] = field(default_factory=dict)  # the sdpa cores
    fwd_span: str = ""
    bwd_span: str = ""


def _flat(x) -> List[Any]:
    return list(x) if isinstance(x, tuple) else [x]


def _unflat(xs: List[Any], like):
    return tuple(xs) if isinstance(like, tuple) else xs[0]


class PipelineEngine:
    """Stage-sliced training with GPipe / 1F1B / interleaved schedules,
    one rank a stage (see the module docstring)."""

    _SHIPPED_KEYS = frozenset({"tokens", "labels", "loss_mask", "enc_tokens"})
    _EXTRA_KEYS = frozenset({"position_ids", "segment_ids"})

    def __init__(self, cfg: ModelArgs, hpc: HybridParallelConfig,
                 train: TrainArgs, devices: Sequence[torch.device], *,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.cfg, self.hpc, self.train = cfg, hpc, train
        self.compute_dtype = compute_dtype
        self.pp = hpc.pp_deg
        if self.pp < 2:
            # pp=1 is the trainer's path: the engine's stage-0 backward
            # differentiates w.r.t. its input, integer tokens there, and
            # the tied reconciliation needs separate first and last stages
            raise ValueError("PipelineEngine needs pp_deg >= 2; pp=1 runs "
                             "through runtime/trainer.py")
        check_world(hpc.world_size, self.pp, where="pipeline: ")
        wide = [i for i, s in enumerate(hpc.layers)
                if max(s.tp_size, s.cp_size, s.ep_size, s.etp_size) > 1
                or s.sp]
        if wide:
            raise NotImplementedError(
                f"pipeline: layer {wide[0]} is wider than one rank "
                f"({hpc.layers[wide[0]]}); a pipeline stage wider than one "
                "rank is not ported yet (ROADMAP item 12c)")
        devices = list(devices)
        if len(devices) < hpc.world_size:
            raise ValueError(f"need {hpc.world_size} stage devices, have "
                             f"{len(devices)}")
        self.devices = devices[:hpc.world_size]
        self.is_t5 = cfg.model_type == "t5"
        self.tx = make_pipeline_optimizer(train)
        self.vpp = max(hpc.vpp_deg, 1)
        n_enc = hpc.num_encoder_layers
        flags = hpc.checkpoint_flags
        self.stages: List[_Stage] = []
        lo = 0
        n_chunks = self.pp * self.vpp
        for c in range(n_chunks):
            hi = lo + hpc.pp_division[c]
            # the combined stack: hpc.layers = encoder layers, then decoder
            enc_lo, enc_hi = min(lo, n_enc), min(hi, n_enc)
            dec_lo, dec_hi = max(lo, n_enc) - n_enc, max(hi, n_enc) - n_enc
            dev = self.devices[c % self.pp]
            self.stages.append(_Stage(
                index=c, device=dev, layer_range=(dec_lo, dec_hi),
                remat=flags[n_enc + dec_lo:n_enc + dec_hi],
                has_embed=c == 0, has_head=c == n_chunks - 1,
                enc_layer_range=(enc_lo, enc_hi),
                enc_remat=flags[enc_lo:enc_hi],
                has_enc_norm=self.is_t5 and (
                    enc_lo <= n_enc - 1 < enc_hi or (n_enc == 0 and c == 0)),
                attn=self._attention(dev), fwd_span=f"pp/fwd_s{c}",
                bwd_span=f"pp/bwd_s{c}"))
            lo = hi

    def _attention(self, device: torch.device) -> Dict[str, Any]:
        """The flash kernels K1-K3 on a CUDA device when
        ``use_flash_attn``, else the plain core (``cli/train_dist.py``'s
        ``attention_overrides``)."""
        if not (self.cfg.use_flash_attn and device.type == "cuda"):
            return {}
        from hetu_galvatron_tpu_torch.ops.flash_attention import flash_sdpa

        kw = {"sdpa_fn": flash_sdpa}
        if self.is_t5:
            kw["cross_sdpa_fn"] = flash_sdpa
        return kw

    # ------------------------------------------------------------------
    # params / optimizer state
    # ------------------------------------------------------------------

    def split_params(self, params: Params) -> List[Params]:
        """The full parameter tree sliced into per-stage trees on their
        devices (the leaves are shared, not copied, where the device is
        the same); on a tied model the last stage also holds ``whead``,
        the transposed copy of ``wte``."""
        out = []
        for st in self.stages:
            lo, hi = st.layer_range
            sp: Params = {"layers": list(params["layers"][lo:hi])}
            if self.is_t5:
                elo, ehi = st.enc_layer_range
                sp["enc_layers"] = list(params["enc_layers"][elo:ehi])
                if st.has_enc_norm:
                    sp["enc_norm"] = params["enc_norm"]
            if st.has_embed:
                sp["embed"] = params["embed"]
            if st.has_head:
                sp["prenorm"] = params["prenorm"]
                sp["head"] = dict(params["head"])
                if self.cfg.tie_word_embeddings:
                    sp["head"]["whead"] = params["embed"]["wte"].detach().t()
            out.append(self._to(sp, st.device))
        return out

    @staticmethod
    def _to(tree, device):
        if isinstance(tree, torch.Tensor):
            if (tree.device == device and tree.is_contiguous()
                    and tree.requires_grad):
                return tree  # already in place: share the leaf
            return tree.detach().to(device).contiguous().requires_grad_(True)
        if isinstance(tree, dict):
            return {k: PipelineEngine._to(v, device) for k, v in tree.items()}
        return [PipelineEngine._to(v, device) for v in tree]

    def merge_params(self, stage_params: List[Params]) -> Params:
        """The full tree back from the stages (the tied copy dropped)."""
        layers: List[Params] = []
        enc: List[Params] = []
        for sp in stage_params:
            layers += sp["layers"]
            enc += sp.get("enc_layers", [])
        full: Params = {"embed": stage_params[0]["embed"], "layers": layers}
        if self.is_t5:
            full["enc_layers"] = enc
            full["enc_norm"] = next(sp["enc_norm"] for sp in stage_params
                                    if "enc_norm" in sp)
        last = stage_params[-1]
        full["prenorm"] = last["prenorm"]
        full["head"] = {k: v for k, v in last["head"].items()
                        if not (k == "whead" and self.cfg.tie_word_embeddings)}
        return full

    def init_opt(self, stage_params: List[Params]) -> List[AdamState]:
        """One AdamW state per stage, over the stage's named leaves."""
        out = []
        for sp in stage_params:
            names, leaves = zip(*named_leaves(sp))
            out.append(self.tx.init(list(leaves), list(names)))
        return out

    # ------------------------------------------------------------------
    # stage programs
    # ------------------------------------------------------------------

    @staticmethod
    def _seeds(seed: Optional[int], n: int) -> List[Optional[int]]:
        """n child seeds of a (microbatch, chunk) seed, drawn on the host:
        the forward and its recompute get the same ones."""
        if seed is None:
            return [None] * n
        return M.split_seeds(torch.Generator().manual_seed(seed), n)

    def _stage_apply(self, st: _Stage, sp: Params, x, labels=None,
                     loss_mask=None, seed=None, pos=None, seg=None):
        """Non-head stages return ``(x, aux)`` (aux None without MoE
        layers); the head stage returns the CE loss plus its own aux
        (JAX :451-542)."""
        if self.is_t5:
            return self._stage_apply_t5(st, sp, x, labels, loss_mask, seed)
        from hetu_galvatron_tpu_torch.models.moe import (
            apply_moe_decoder_layer,
        )

        cfg, dev = self.cfg, st.device
        n = len(sp["layers"])
        seeds = self._seeds(seed, n + 1)
        if st.has_embed:
            x = M.apply_embedding(
                sp["embed"], x, cfg, compute_dtype=self.compute_dtype,
                dropout_rng=M.generator_from_seed(seeds[n], dev),
                position_ids=pos)
        rope = rope_tables(cfg, x[..., 0], pos)
        kw = dict(rope=rope, compute_dtype=self.compute_dtype,
                  segment_ids=seg, **st.attn)
        aux_total = None
        for j, lp in enumerate(sp["layers"]):
            apply = (apply_moe_decoder_layer if "moe" in lp
                     else M.apply_decoder_layer)

            def layer(p, h, seed=seeds[j], apply=apply):
                return apply(p, h, cfg,
                             dropout_rng=M.generator_from_seed(seed, dev),
                             **kw)

            if st.remat[j]:
                layer = M.remat(layer, cfg)
            if "moe" in lp:
                x, aux, _ = layer(lp, x)
                aux_total = aux if aux_total is None else aux_total + aux
            else:
                x = layer(lp, x)
        if not st.has_head:
            return x, aux_total
        x = M.apply_norm(sp["prenorm"], x, cfg)
        # sp["head"] holds whead, the tied copy on a tied model
        logits = M.apply_lm_head(sp["head"], x, cfg,
                                 compute_dtype=self.compute_dtype)
        loss = M.cross_entropy_loss(logits, labels, loss_mask)
        return loss if aux_total is None else loss + aux_total

    def _stage_apply_t5(self, st: _Stage, sp: Params, carry, labels=None,
                        loss_mask=None, seed=None):
        """The encoder-decoder stage (JAX :544-616): ``carry`` is
        ``(enc_tokens, dec_tokens)`` on the embed stage, else the ``(a,
        b)`` pair; same contract as :meth:`_stage_apply`. Seeds run in
        ``encdec.forward_encdec``'s order: decoder layers, decoder
        embedding, encoder embedding, encoder layers."""
        from hetu_galvatron_tpu_torch.models.encdec import (
            _rope,
            apply_cross_decoder_layer,
        )

        cfg, dev = self.cfg, st.device
        n_dec, n_enc = len(sp["layers"]), len(sp["enc_layers"])
        seeds = self._seeds(seed, n_dec + 2 + n_enc)

        def gen(i):
            return M.generator_from_seed(seeds[i], dev)

        if st.has_embed:
            enc_tok, dec_tok = carry
            a = M.apply_embedding(sp["embed"], enc_tok, cfg,
                                  compute_dtype=self.compute_dtype,
                                  dropout_rng=gen(n_dec + 1))
            b = M.apply_embedding(sp["embed"], dec_tok, cfg,
                                  compute_dtype=self.compute_dtype,
                                  dropout_rng=gen(n_dec))
        else:
            a, b = carry
        enc_kw = dict(rope=_rope(cfg, a.shape[1], dev),
                      compute_dtype=self.compute_dtype, causal=False,
                      **{k: v for k, v in st.attn.items()
                         if k != "cross_sdpa_fn"})
        for j, lp in enumerate(sp["enc_layers"]):
            def enc_layer(p, h, seed=seeds[n_dec + 2 + j]):
                return M.apply_decoder_layer(
                    p, h, cfg, dropout_rng=M.generator_from_seed(seed, dev),
                    **enc_kw)

            if st.enc_remat[j]:
                enc_layer = M.remat(enc_layer, cfg)
            a = enc_layer(lp, a)
        if st.has_enc_norm:
            a = M.apply_norm(sp["enc_norm"], a, cfg)
        dec_kw = dict(rope=_rope(cfg, b.shape[1], dev),
                      compute_dtype=self.compute_dtype, **st.attn)
        for j, lp in enumerate(sp["layers"]):
            def dec_layer(p, h, m, seed=seeds[j]):
                return apply_cross_decoder_layer(
                    p, h, m, cfg,
                    dropout_rng=M.generator_from_seed(seed, dev), **dec_kw)

            if st.remat[j]:
                dec_layer = M.remat(dec_layer, cfg)
            b = dec_layer(lp, b, a)
        if not st.has_head:
            return (a, b), None  # t5 stacks carry no MoE aux
        b = M.apply_norm(sp["prenorm"], b, cfg)
        logits = M.apply_lm_head(sp["head"], b, cfg,
                                 compute_dtype=self.compute_dtype)
        return M.cross_entropy_loss(logits, labels, loss_mask)

    def _forward(self, s: int, sp: Params, x, seed, pos, seg):
        """A non-head stage's forward without a graph (JAX ``_make_fwd``
        :641): the activation for the next stage."""
        with torch.no_grad():
            y, _ = self._stage_apply(self.stages[s], sp, x, seed=seed,
                                     pos=pos, seg=seg)
        return y

    def _backward(self, s: int, sp: Params, x, dy, w, seed, pos, seg,
                  labels=None, loss_mask=None):
        """``(dparams, dx, value)`` of stage s by recomputing its forward
        from the stored input (JAX ``_make_bwd`` :651). The head stage
        (``dy`` None) returns its unweighted loss as ``value``, with
        ``dparams`` and ``dx`` scaled by the microbatch weight ``w``;
        other stages back-propagate ``dy`` and ``w`` as the cotangent of
        their aux loss, and return the aux loss (or None)."""
        st = self.stages[s]
        leaves = [t for _, t in named_leaves(sp)]
        xs = [t.requires_grad_(True) if t.is_floating_point() else t
              for t in (t.detach() for t in _flat(x))]
        x_in = [t for t in xs if t.requires_grad]
        with torch.enable_grad():
            out = self._stage_apply(st, sp, _unflat(xs, x), labels,
                                    loss_mask, seed, pos, seg)
            if dy is None:
                outs, cots = [out], None
            else:
                y, value = out
                outs, cots = _flat(y), _flat(dy)
                if value is not None:
                    outs.append(value)
                    cots.append(w)
            grads = torch.autograd.grad(outs, leaves + x_in, cots,
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves + x_in, grads)]
        if dy is None:
            value = out
            torch._foreach_mul_(grads, w)
        dparams, dx = grads[:len(leaves)], grads[len(leaves):]
        it = iter(dx)
        dx = [next(it) if t.requires_grad else None for t in xs]
        return dparams, _unflat(dx, x), (None if value is None
                                         else value.detach())

    # ------------------------------------------------------------------
    # microbatches and placement
    # ------------------------------------------------------------------

    def _microbatches(self, batch: Dict[str, Any],
                      num_microbatches: Optional[int] = None):
        """The batch cut into microbatches (views) and each microbatch's
        share of the valid tokens, a float32 tensor on the first stage's
        device (JAX :838-862)."""
        shipped = self._SHIPPED_KEYS | (
            frozenset() if self.is_t5 else self._EXTRA_KEYS)
        extra = set(batch) - shipped
        if extra:
            raise NotImplementedError(
                f"the pipeline engine does not thread batch keys "
                f"{sorted(extra)} through its stage transfers")
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            from hetu_galvatron_tpu_torch.runtime.trainer import to_device

            batch = to_device(batch, self.devices[0])
        m = max(num_microbatches if num_microbatches is not None
                else self.hpc.chunks, 1)
        b = batch["tokens"].shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by chunks {m}")
        mbs = [{k: v[i * (b // m):(i + 1) * (b // m)]
                for k, v in batch.items()} for i in range(m)]
        dev = self.devices[0]
        if "loss_mask" in batch:
            counts = batch["loss_mask"].reshape(m, -1).to(
                dev, torch.float32).sum(1)
        else:
            counts = torch.ones(m, device=dev)
        return mbs, counts / counts.sum().clamp_min(1.0)

    def _stage0_input(self, mb):
        dev = self.stages[0].device
        if self.is_t5:
            return (mb["enc_tokens"].to(dev), mb["tokens"].to(dev))
        return mb["tokens"].to(dev)

    def _extras(self, mb, s: int):
        """position_ids / segment_ids on stage s's device: every stage
        masks and rotates with them, and the host holds the batch, so
        nothing travels between stages for them (JAX :880)."""
        dev = self.stages[s].device
        return tuple(mb[k].to(dev) if k in mb else None
                     for k in ("position_ids", "segment_ids"))

    def _labels(self, mb):
        dev = self.stages[-1].device
        mask = mb.get("loss_mask")
        return mb["labels"].to(dev), None if mask is None else mask.to(dev)

    def _transfer(self, y, s: int):
        """The inter-stage activation (a tensor, or t5's pair) onto stage
        s's device, detached."""
        dev = self.stages[s].device
        return _unflat([t.detach().to(dev) for t in _flat(y)], y)

    # ------------------------------------------------------------------
    # schedules
    # ------------------------------------------------------------------

    def _fwd_microbatch(self, stage_params, mb, ctx, m: int) -> None:
        """Microbatch m up to the head stage's input (the head's forward
        runs fused with its backward)."""
        x = self._stage0_input(mb)
        inputs, extras = [], []
        last = len(self.stages) - 1
        for s, st in enumerate(self.stages):
            # tokens, or an activation _transfer detached: no graph rides
            # along into the stored inputs
            inputs.append(x)
            extras.append(self._extras(mb, s))
            if s == last:
                ctx["labels"][m] = self._labels(mb)
            else:
                pos, seg = extras[s]
                with span(st.fwd_span):
                    y = self._forward(s, stage_params[s], x,
                                      ctx["seeds"](m, s), pos, seg)
                    x = self._transfer(y, s + 1)
        ctx["inputs"][m] = inputs
        ctx["extras"][m] = extras

    def _bwd_microbatch(self, stage_params, m: int, ctx, grad_acc) -> None:
        """Microbatch m's backward through every stage, seeded with its
        token weight; frees its stored inputs."""
        inputs, extras = ctx["inputs"][m], ctx["extras"][m]
        w = ctx["weights"][m]
        last = len(self.stages) - 1
        labels, mask = ctx["labels"][m]
        dx = None
        total = None
        for s in range(last, -1, -1):
            st = self.stages[s]
            pos, seg = extras[s]
            dy = None if s == last else self._transfer(dx, s)
            with span(st.bwd_span):
                dp, dx, value = self._backward(
                    s, stage_params[s], inputs[s], dy,
                    w.to(st.device), ctx["seeds"](m, s), pos, seg,
                    labels if s == last else None,
                    mask if s == last else None)
            if grad_acc[s] is None:
                grad_acc[s] = dp
            else:
                torch._foreach_add_(grad_acc[s], dp)
            if value is not None:
                value = value.to(self.devices[0])
                total = value if total is None else total + value
        # the loss and the aux losses stay on the device: the step reads
        # the host once, at its end
        ctx["loss"] = ctx["loss"] + w * total
        ctx["inputs"][m] = ctx["extras"][m] = ctx["labels"][m] = None

    def _mb_seeds(self, step_rng, mcount: int):
        """(m, s) -> the dropout seed of microbatch m on chunk s, drawn
        from the step's generator once (None without dropout)."""
        cfg = self.cfg
        if not (cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0):
            return lambda m, s: None
        n = len(self.stages)
        seeds = M.split_seeds(step_rng, mcount * n)
        return lambda m, s: seeds[m * n + s]

    def forward_backward(self, stage_params: List[Params],
                         batch: Dict[str, Any],
                         num_microbatches: Optional[int] = None):
        """The schedule, the tied-embedding exchange and the global norm:
        ``(stage grads, metrics)`` with ``loss``, ``grad_norm`` and
        ``clip_scale`` as tensors on the first stage's device; the
        parameters are untouched (the launcher's rerun machine judges the
        loss before :meth:`apply_update`). ``num_microbatches`` overrides
        the plan's chunks (the batch-size ramp)."""
        batch = dict(batch)
        step_rng = batch.pop("dropout_rng", None)
        if step_rng is None and (self.cfg.hidden_dropout > 0.0
                                 or self.cfg.attention_dropout > 0.0):
            raise ValueError(
                "cfg enables dropout but the batch has no 'dropout_rng' "
                "key; train_dist adds one per step, manual callers must "
                "pass one")
        mbs, weights = self._microbatches(batch, num_microbatches)
        mcount = len(mbs)
        ctx = {"inputs": [None] * mcount, "extras": [None] * mcount,
               "labels": [None] * mcount, "weights": weights,
               "seeds": self._mb_seeds(step_rng, mcount),
               "loss": torch.zeros((), device=self.devices[0])}
        grad_acc: List[Any] = [None] * len(self.stages)
        if self.hpc.pipeline_type == "gpipe":
            for m in range(mcount):
                self._fwd_microbatch(stage_params, mbs[m], ctx, m)
            for m in range(mcount):
                self._bwd_microbatch(stage_params, m, ctx, grad_acc)
        else:
            # pipedream-flush: warm up as deep as the pipeline, in chunks
            # (JAX :1044), then one backward and one forward in turn
            warmup = min(len(self.stages), mcount)
            for m in range(warmup):
                self._fwd_microbatch(stage_params, mbs[m], ctx, m)
            for m in range(mcount):
                self._bwd_microbatch(stage_params, m, ctx, grad_acc)
                if m + warmup < mcount:
                    self._fwd_microbatch(stage_params, mbs[m + warmup], ctx,
                                         m + warmup)
        names = [[n for n, _ in named_leaves(sp)] for sp in stage_params]
        tied = self.cfg.tie_word_embeddings
        if tied:
            # both copies get the summed gradient (JAX :1067-1084)
            i0 = names[0].index("embed.wte")
            i1 = names[-1].index("head.whead")
            dev0, dev1 = self.stages[0].device, self.stages[-1].device
            total = grad_acc[0][i0] + grad_acc[-1][i1].t().to(dev0)
            grad_acc[0][i0] = total
            grad_acc[-1][i1] = total.t().to(dev1).contiguous()
        # the global norm on the device, less one tied copy (:1086-1099)
        sq = None
        for s, (g, n) in enumerate(zip(grad_acc, names)):
            part = self._sq_norm([t for t, name in zip(g, n)
                                  if not name.endswith("expert_bias")])
            part = part.to(self.devices[0])
            sq = part if sq is None else sq + part
        if tied:
            sq = sq - self._sq_norm([grad_acc[-1][i1]]).to(self.devices[0])
        gnorm = torch.sqrt(sq)
        clip = self.train.clip_grad
        scale = (torch.clamp(clip / (gnorm + 1e-12), max=1.0)
                 if clip and clip > 0 else torch.ones_like(gnorm))
        return grad_acc, {"loss": ctx["loss"], "grad_norm": gnorm,
                          "clip_scale": scale}

    @staticmethod
    def _sq_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
        return torch.stack(torch._foreach_norm(tensors)).square().sum()

    def apply_update(self, stage_params: List[Params],
                     stage_opts: List[AdamState], grads: List[List[Any]],
                     metrics: Dict[str, Any]) -> None:
        """Each stage's gradients times the clip scale (expert biases
        excepted: theirs are the balancing update itself), then its AdamW,
        in place (JAX ``_make_update`` :810). ``grads`` are consumed."""
        with span(UPDATE_SPAN):
            for s, (sp, opt, g) in enumerate(zip(stage_params, stage_opts,
                                                 grads)):
                scale = metrics["clip_scale"].to(self.stages[s].device)
                torch._foreach_mul_([g[i] for i in opt.adam], scale)
                leaves = [t for _, t in named_leaves(sp)]
                self.tx.update(leaves, g, opt, None)

    def train_step(self, stage_params: List[Params],
                   stage_opts: List[AdamState], batch: Dict[str, Any],
                   num_microbatches: Optional[int] = None
                   ) -> Tuple[List[Params], List[AdamState], Dict[str, float]]:
        """One optimizer step; parameters and states are updated in place
        and returned with the host floats ``loss`` and ``grad_norm``."""
        grads, metrics = self.forward_backward(stage_params, batch,
                                               num_microbatches)
        self.apply_update(stage_params, stage_opts, grads, metrics)
        # the step's one host read, after every launch of the step
        loss, gnorm = torch.stack([metrics["loss"],
                                   metrics["grad_norm"]]).tolist()
        return stage_params, stage_opts, {"loss": loss, "grad_norm": gnorm}

    def eval_step(self, stage_params: List[Params],
                  batch: Dict[str, Any]) -> Dict[str, float]:
        """The held-out loss under the training plan: forward only through
        the stages, dropout off (JAX :779)."""
        batch = dict(batch)
        batch.pop("dropout_rng", None)
        mbs, weights = self._microbatches(batch)
        last = len(self.stages) - 1
        loss = torch.zeros((), device=self.devices[0])
        with torch.no_grad():
            for m, mb in enumerate(mbs):
                x = self._stage0_input(mb)
                for s, st in enumerate(self.stages):
                    pos, seg = self._extras(mb, s)
                    if s == last:
                        labels, mask = self._labels(mb)
                        value = self._stage_apply(st, stage_params[s], x,
                                                  labels, mask, None, pos,
                                                  seg)
                        loss = loss + weights[m] * value.to(loss.device)
                    else:
                        y, _ = self._stage_apply(st, stage_params[s], x,
                                                 pos=pos, seg=seg)
                        x = self._transfer(y, s + 1)
        return {"loss": float(loss)}
