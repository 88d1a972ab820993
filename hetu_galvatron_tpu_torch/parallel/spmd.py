"""The SPMD train step of a pp=1 layer-wise hybrid plan, one process a rank.

Counterpart of ``hetu_galvatron_tpu/parallel/spmd.py`` (``layer_shardings``
:37, ``param_specs`` :51 (with ``opt=True`` the moments' specs, JAX's
``opt_state_specs`` :83: the port's AdamW state is a list a leaf),
``attention_overrides`` :113 for its flash / plain branch,
``make_boundary_fn`` :231, ``shard_params`` :278, ``batch_sharding`` :284,
``build_spmd_loss_fn`` :303; :class:`SpmdEngine`'s ``train_step`` and
``eval_loss`` are ``make_spmd_train_step`` :445 and ``make_spmd_eval_step``
:418). JAX lowers
the plan to ``PartitionSpec`` s and one jitted program; here every rank
holds the slices its specs give it (:func:`shard_params`;
:func:`gather_params` is the inverse, for the tests, the gates and the
weight bridge) and runs the collectives of ``parallel/comm.py`` where
GSPMD puts them:

* a layer's activations ``[B, S, H]`` enter it as JAX's ``act_spec``
  lays them out: rows over the layer's dp axes, the sequence over its tp
  axes (Megatron-SP); a layer of tp > 1 holds its heads' columns of
  ``wqkv`` / ``win`` and rows of ``wo`` / ``wout`` (the fused q | k | v and
  gate | up columns are split part by part, so that a rank's columns are
  whole heads and matching gate and up columns; JAX splits the fused dim
  contiguously and lets GSPMD regroup, the bytes a rank holds are the
  same) and gathers the sequence before its products
  (``models/modules.py``'s ``tp`` seam);
* between layers of different axes :func:`make_boundary_fn` moves the
  activation to the next layer's layout, bitwise;
* a ZeRO-3 leaf (the "embed" dim of a 2-D+ leaf over dp) is all-gathered
  at use inside its layer (again in a remat recompute) and its gradient
  reduce-scattered back (:func:`make_use_fn`); the embedding's table is
  gathered once for the lookup and the tied head (JAX's
  ``make_embed_use_constraint`` :250);
* the embedding is a vocab-parallel lookup and the head column-parallel
  over the vocabulary, the loss through ``ops/cross_entropy.
  make_vocab_parallel_ce`` (K4/K5 per shard) at vtp > 1;
* after the backward every gradient is summed over the axes its leaf is
  replicated over: a layer's dp axes (DDP's all-reduce), and under SP
  also its tp axes for the norms and the row-parallel biases;
* ZeRO-2 (the moments' "embed" dim over dp) updates each rank's slice of
  the moments and of the parameter, then all-gathers the parameter;
* the global norm of the clip counts each logical element once: a
  gradient replicated over some axes is counted by the rank at index 0 on
  them.

The batch: every rank reads the whole global batch (the data loader is
deterministic from the seed) and each layer takes its own rows, so layers
of different dp axes need no token collective. Microbatch c holds global
rows ``[c B / chunks, (c + 1) B / chunks)``, split over dp, JAX's pinned
layout (:445's ``constrain_mbs``). The loss is the global token mean: a
rank sums its rows' masked NLL over the microbatch's whole token count,
which every rank reads from the batch.

Not here: ``tp_overlap_overrides`` (ROADMAP item 11), ring and Ulysses
attention (item 11), expert parallelism and ``make_spmd_generate`` (item
10b), the hierarchical dp reduction (item 12d).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, TrainArgs
from hetu_galvatron_tpu_torch.models import modules as M
from hetu_galvatron_tpu_torch.models.builder import (
    causal_lm_axes,
    named_leaves,
    rope_tables,
)
from hetu_galvatron_tpu_torch.parallel import comm
from hetu_galvatron_tpu_torch.runtime.mesh import (
    GroupCache,
    LayerSharding,
    Mesh,
    P,
    axes_size,
    build_mesh,
    lower_strategy,
    lower_vocab_strategy,
    spec_axes,
    stage_axes,
)
from hetu_galvatron_tpu_torch.runtime.optimizer import (
    AdamW,
    make_optimizer,
    sharded_grad_norm,
)
from hetu_galvatron_tpu_torch.runtime.trainer import (
    _grads,
    _split_batch,
    microbatch_weights,
)
from hetu_galvatron_tpu_torch.utils.strategy import DPType

Params = Dict[str, Any]
BUCKET_BYTES = 1 << 28  # one gradient all-reduce carries at most this


def _is_axes(x) -> bool:
    """A leaf of an axes tree (logical names) or of a spec tree."""
    return isinstance(x, P) or (isinstance(x, tuple)
                                and all(isinstance(s, str) for s in x))


def named_axes(tree, prefix: str = ""):
    """(dotted path, logical axes) for every leaf of an axes tree, in
    ``builder.named_leaves``'s order."""
    if _is_axes(tree):
        yield prefix, tree
        return
    items = (enumerate(tree) if isinstance(tree, list)
             else sorted(tree.items()))
    for key, sub in items:
        yield from named_axes(sub, f"{prefix}.{key}" if prefix else str(key))


def _map_tree(tree, fn, prefix: str = "", leaf=None):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    leaf = leaf or (lambda x: isinstance(x, torch.Tensor))
    if leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, list):
        return [_map_tree(t, fn, f"{prefix}.{i}" if prefix else str(i), leaf)
                for i, t in enumerate(tree)]
    return {k: _map_tree(v, fn, f"{prefix}.{k}" if prefix else str(k), leaf)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the lowering (JAX's names)
# ---------------------------------------------------------------------------


def layer_shardings(hpc, mesh: Mesh
                    ) -> Tuple[List[LayerSharding], LayerSharding]:
    """Lower every decoder layer and the vocab strategy onto the mesh."""
    per_layer = [lower_strategy(s, mesh) for s in hpc.layers]
    vocab = lower_vocab_strategy(hpc.vocab, mesh,
                                 DPType.from_name(hpc.default_dp_type))
    return per_layer, vocab


def param_specs(axes_tree: Params, per_layer: List[LayerSharding],
                vocab: LayerSharding, *, opt: bool = False) -> Params:
    """Spec tree mirroring the params: decoder layers by their own
    sharding, the embedding, the final norm and the head by the vocab
    sharding."""
    def tree(axes, sh):
        fn = sh.opt_spec if opt else sh.param_spec
        return _map_tree(axes, lambda _, a: fn(a), leaf=_is_axes)

    return {"embed": tree(axes_tree["embed"], vocab),
            "layers": [tree(a, sh) for a, sh in zip(axes_tree["layers"],
                                                     per_layer)],
            "prenorm": tree(axes_tree["prenorm"], vocab),
            "head": tree(axes_tree["head"], vocab)}


def fused_parts(name: str, cfg: ModelArgs) -> Optional[Tuple[int, ...]]:
    """The parts a fused leaf's tp dim concatenates (q | k | v of ``wqkv``
    and ``bqkv``; gate | up of a gated ``win`` / ``bin``), each split over
    the tp ranks on its own; None for a leaf of one part."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("wqkv", "bqkv"):
        hd = cfg.head_dim
        return (cfg.num_attention_heads * hd, cfg.kv_heads * hd,
                cfg.kv_heads * hd)
    if leaf in ("win", "bin") and M.is_gated(cfg.hidden_act):
        return (cfg.ffn_dim, cfg.ffn_dim)
    return None


@dataclass(frozen=True)
class LeafPlan:
    """One leaf of the plan: its logical axes, param and optimizer specs,
    its fused parts, and the axes its gradient is summed over (those it is
    replicated over)."""

    name: str
    axes: Tuple[str, ...]
    spec: P
    opt: P
    parts: Optional[Tuple[int, ...]]
    reduce: Tuple[str, ...]

    def part_dim(self) -> Optional[int]:
        """The dim the fused parts run along (its tp dim)."""
        if self.parts is None:
            return None
        return next(d for d, a in enumerate(self.axes)
                    if a in ("qkv", "mlp"))


def leaf_plans(cfg: ModelArgs, mesh: Mesh, axes_tree: Params,
               per_layer, vocab) -> List[LeafPlan]:
    pspecs = param_specs(axes_tree, per_layer, vocab)
    ospecs = param_specs(axes_tree, per_layer, vocab, opt=True)
    out = []
    for (name, axes), (_, spec), (_, opt) in zip(
            named_axes(axes_tree), named_axes(pspecs), named_axes(ospecs)):
        used = spec_axes(spec)
        reduce = tuple(a for a in stage_axes(mesh) if a not in used)
        out.append(LeafPlan(name, axes, spec, opt, fused_parts(name, cfg),
                            reduce))
    return out


def _split(t: torch.Tensor, dim: int, n: int, idx: int,
           parts: Optional[Sequence[int]]) -> torch.Tensor:
    if parts is None:
        return t.chunk(n, dim=dim)[idx]
    return torch.cat([p.chunk(n, dim=dim)[idx]
                      for p in t.split(list(parts), dim=dim)], dim=dim)


def _join(pieces: List[torch.Tensor], dim: int,
          parts: Optional[Sequence[int]]) -> torch.Tensor:
    if parts is None:
        return torch.cat(pieces, dim=dim)
    n = len(pieces)
    split = [[q for q in p.split([s // n for s in parts], dim=dim)]
             for p in pieces]
    return torch.cat([torch.cat([split[i][j] for i in range(n)], dim=dim)
                      for j in range(len(parts))], dim=dim)


def shard_params(params: Params, plans: List[LeafPlan], mesh: Mesh,
                 rank: int) -> Params:
    """The full tree -> this rank's slices (fresh leaves that require
    grad)."""
    by_name = {p.name: p for p in plans}

    def local(name, t):
        plan = by_name[name]
        for d, axes in enumerate(plan.opt):
            if axes and t.shape[d] % axes_size(mesh, axes):
                raise ValueError(
                    f"{name}: dim {d} of {tuple(t.shape)} does not split "
                    f"evenly over the {axes_size(mesh, axes)} ranks of "
                    f"{axes}")
        for d, axes in enumerate(plan.spec):
            if axes:
                t = _split(t, d, axes_size(mesh, axes),
                           mesh.axis_index(rank, axes),
                           plan.parts if d == plan.part_dim() else None)
        return t.detach().clone().requires_grad_(True)

    return _map_tree(params, local)


def gather_params(params: Params, plans: List[LeafPlan],
                  groups: GroupCache) -> Params:
    """This rank's slices -> the full tree on every rank (a collective:
    every rank calls it)."""
    by_name = {p.name: p for p in plans}

    @torch.no_grad()
    def full(name, t):
        plan = by_name[name]
        for d, axes in enumerate(plan.spec):
            if axes:
                t = _join(comm.all_gather_list(t, groups.get(axes)), d,
                          plan.parts if d == plan.part_dim() else None)
        return t.clone()

    return _map_tree(params, full)


@dataclass(frozen=True)
class BatchSlice:
    """A layer's rows of a ``[B, ...]`` batch tensor: shard ``index`` of
    ``count`` (JAX's ``batch_spec``: rows over dp, the sequence whole
    without cp)."""

    index: int
    count: int

    def __call__(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None or self.count == 1:
            return t
        if t.shape[0] % self.count:
            raise ValueError(
                f"a microbatch of {t.shape[0]} rows does not split over dp "
                f"{self.count}: the global batch over chunks must be a "
                "multiple of every layer's dp degree")
        n = t.shape[0] // self.count
        return t[self.index * n:(self.index + 1) * n]


def batch_sharding(sh: LayerSharding, mesh: Mesh, rank: int) -> BatchSlice:
    return BatchSlice(mesh.axis_index(rank, sh.dp_axes),
                      axes_size(mesh, sh.dp_axes))


def make_boundary_fn(per_layer: List[LayerSharding], vocab: LayerSharding,
                     mesh: Mesh, groups: GroupCache
                     ) -> Callable[[int, torch.Tensor], torch.Tensor]:
    """``boundary(i, x)``: move the activation leaving unit i - 1 (the
    embedding for i = 0) into layer i's ``act_spec`` layout, i = n into the
    head's; bitwise, the backward the reverse move."""
    world = groups.get(stage_axes(mesh))
    units = [vocab] + list(per_layer) + [vocab]
    layouts = [comm.layout_of(mesh, world, sh.dp_axes, sh.tp_axes)
               for sh in units]

    def boundary(i: int, x: torch.Tensor) -> torch.Tensor:
        return comm.relayout(x, world, layouts[i], layouts[i + 1])

    return boundary


def make_use_fn(plans: List[LeafPlan], sh: LayerSharding,
                groups: GroupCache) -> Callable[[Params, str], Params]:
    """``use(tree, prefix)``: a unit's leaves as its computation uses them,
    the ZeRO-3 "embed" dims (those split over the unit's dp axes)
    all-gathered, with a reduce-scatter of the gradient backward."""
    by_name = {p.name: p for p in plans}
    dp = sh.dp_axes

    def use(tree: Params, prefix: str) -> Params:
        def one(name, t):
            for d, axes in enumerate(by_name[name].spec):
                if dp and axes == dp:
                    t = comm.gather_along(t, groups.get(dp), d)
            return t

        return _map_tree(tree, one, prefix)

    return use


def attention_overrides(per_layer: List[LayerSharding], mesh: Mesh,
                        rank: int, *, use_flash: bool
                        ) -> Dict[int, Dict[str, Any]]:
    """The flash kernels on this rank's batch rows and heads where
    ``use_flash`` (``ops/flash_attention.make_flash_sdpa``), else no
    override (the plain core)."""
    if not use_flash:
        return {}
    from hetu_galvatron_tpu_torch.ops.flash_attention import make_flash_sdpa

    return {i: {"sdpa_fn": make_flash_sdpa(mesh, rank, sh.dp_axes,
                                           sh.tp_axes)}
            for i, sh in enumerate(per_layer)}


class _TPSeam:
    """``models/modules.py``'s ``tp`` seam over one tp group: the sequence
    gathered before a column-parallel product, the row-parallel output
    reduce-scattered back onto the rank's sequence shard."""

    def __init__(self, group):
        self.group, self.size = group, group.size

    def gather(self, x):
        return comm.gather_along(x, self.group, 1)

    def scatter(self, y):
        return comm.scatter_along(y, self.group, 1)


class _VocabSeam(_TPSeam):
    """The ``vocab`` seam: a vocab-parallel lookup summed onto the rank's
    sequence shard, the positions of that shard, and the head's gather."""

    def lookup(self, wte, tokens):
        v_local = wte.shape[0]
        local = tokens - self.group.index * v_local
        ok = (local >= 0) & (local < v_local)
        rows = wte[torch.where(ok, local, torch.zeros_like(local))]
        rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
        return self.scatter(rows)

    def seq_slice(self, t):
        n = t.shape[1] // self.size
        return t[:, self.group.index * n:(self.group.index + 1) * n]


def _check_divisible(cfg: ModelArgs, per_layer, vocab, mesh) -> None:
    for i, sh in enumerate(per_layer):
        tp = axes_size(mesh, sh.tp_axes)
        for what, n in (("attention heads", cfg.num_attention_heads),
                        ("kv heads", cfg.kv_heads), ("ffn", cfg.ffn_dim),
                        ("seq_length", cfg.seq_length)):
            if n % tp:
                raise ValueError(f"layer {i}: {what} {n} do not split over "
                                 f"tp {tp}")
    vtp = axes_size(mesh, vocab.tp_axes)
    for what, n in (("padded vocab", cfg.padded_vocab_size),
                    ("seq_length", cfg.seq_length)):
        if n % vtp:
            raise ValueError(f"{what} {n} does not split over vtp {vtp}")


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


class SpmdEngine:
    """One rank's view of a pp=1 plan over ``hpc.world_size`` ranks: the
    lowered shardings, the process groups, the leaf plans and the loss,
    with the step's two halves (``forward_backward``, ``apply_update``) as
    ``cli/train_dist.py`` calls them."""

    def __init__(self, cfg: ModelArgs, hpc, train: TrainArgs, rank: int,
                 device: torch.device, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 use_flash: Optional[bool] = None):
        if hpc.pp_deg != 1:
            raise ValueError("the SPMD step is the pp=1 path; pipelines run "
                             "through runtime/pipeline.py")
        self.cfg, self.hpc, self.rank = cfg, hpc, rank
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.mesh = build_mesh(hpc.world_size, 1)
        self.per_layer, self.vocab = layer_shardings(hpc, self.mesh)
        _check_divisible(cfg, self.per_layer, self.vocab, self.mesh)
        self.axes_tree = causal_lm_axes(cfg)
        self.plans = leaf_plans(cfg, self.mesh, self.axes_tree,
                                self.per_layer, self.vocab)
        need = {stage_axes(self.mesh)}
        for sh in self.per_layer + [self.vocab]:
            need.update({sh.dp_axes, sh.tp_axes})
        for p in self.plans:
            need.add(p.reduce)
            need.update(a for a in tuple(p.spec) + tuple(p.opt) if a)
        self.groups = GroupCache(self.mesh, rank).build(need)
        self.world = self.groups.get(stage_axes(self.mesh))
        self.vtp = axes_size(self.mesh, self.vocab.tp_axes)
        if use_flash is None:
            use_flash = cfg.use_flash_attn and self.device.type == "cuda"
        self.flash = use_flash
        self.tx: AdamW = make_optimizer(train)
        self.loss_fn = build_spmd_loss_fn(self)

    # -- state ------------------------------------------------------------

    def shard_params(self, params: Params) -> Params:
        return shard_params(params, self.plans, self.mesh, self.rank)

    def gather_params(self, params: Params) -> Params:
        return gather_params(params, self.plans, self.groups)

    def _opt_view(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf i's part the optimizer updates on this rank: ZeRO-2's slice
        of the dims its moments split over dp, else the whole leaf."""
        plan = self.plans[i]
        for d, (pa, oa) in enumerate(zip(plan.spec, plan.opt)):
            if oa and not pa:
                n = axes_size(self.mesh, oa)
                size = t.shape[d] // n
                t = t.narrow(d, self.mesh.axis_index(self.rank, oa) * size,
                             size)
        return t

    def init_opt(self, params: Params):
        names, leaves = zip(*named_leaves(params))
        return self.tx.init([self._opt_view(i, t)
                             for i, t in enumerate(leaves)], list(names))

    # -- the step ---------------------------------------------------------

    def _reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum every gradient over the axes its leaf is replicated over, in
        buckets of at most ``BUCKET_BYTES`` per group of axes."""
        by_axes: Dict[Tuple[str, ...], List[int]] = defaultdict(list)
        for i, p in enumerate(self.plans):
            if self.groups.get(p.reduce).size > 1:
                by_axes[p.reduce].append(i)
        for axes, idx in sorted(by_axes.items()):
            group = self.groups.get(axes)
            bucket, size = [], 0
            for k, i in enumerate(idx):
                bucket.append(i)
                size += grads[i].numel() * 4
                if size >= BUCKET_BYTES or k == len(idx) - 1:
                    flat = comm.all_reduce(torch.cat(
                        [grads[j].reshape(-1) for j in bucket]), group)
                    for j, part in zip(bucket, flat.split(
                            [grads[j].numel() for j in bucket])):
                        grads[j] = part.view_as(grads[j])
                    bucket, size = [], 0

    def global_loss(self, local: torch.Tensor) -> torch.Tensor:
        """The step's loss from the ranks' parts: their sum over the world,
        less the vtp copies of each row's NLL."""
        return comm.all_reduce(local.detach().float(), self.world) / self.vtp

    def forward_backward(self, params: Params, batch: Dict[str, Any],
                         chunks: int = 1):
        """(this rank's reduced gradients, metrics) of one step over the
        global ``batch``; the parameters stay untouched."""
        leaves = [t for _, t in named_leaves(params)]
        if chunks <= 1:
            loss = self.loss_fn(params, batch)
            grads = [g.float() for g in _grads(loss, leaves)]
            loss = loss.detach()
        else:
            batch = dict(batch)
            rng = batch.pop("dropout_rng", None)
            mask = batch.get("loss_mask")
            weights = microbatch_weights(
                None if mask is None else
                mask.reshape((chunks, -1) + tuple(mask.shape[1:])), chunks)
            weights = weights.to(leaves[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb, w, child in zip(_split_batch(batch, chunks), weights,
                                    M.split_rng(rng, chunks)):
                if child is not None:
                    mb["dropout_rng"] = child
                part = self.loss_fn(params, mb)
                torch._foreach_add_(grads, [x.float() * w for x in _grads(
                    part, leaves)])
                loss = loss + w * part.detach()
        self._reduce_grads(grads)
        counted = [g for i, g in enumerate(grads)
                   if self.mesh.axis_index(self.rank,
                                           self.plans[i].reduce) == 0]
        norm = sharded_grad_norm(
            counted, lambda sq: comm.all_reduce(sq, self.world),
            device=leaves[0].device)
        return grads, {"loss": self.global_loss(loss), "grad_norm": norm}

    @torch.no_grad()
    def apply_update(self, params: Params, opt_state, grads, metrics
                     ) -> None:
        """The AdamW update in place: every rank its leaves (ZeRO-2: its
        slices, then the parameter all-gathered over dp)."""
        leaves = [t for _, t in named_leaves(params)]
        views = [self._opt_view(i, t) for i, t in enumerate(leaves)]
        self.tx.update(views, [self._opt_view(i, g)
                               for i, g in enumerate(grads)],
                       opt_state, metrics["grad_norm"])
        for i, plan in enumerate(self.plans):
            for d, (pa, oa) in enumerate(zip(plan.spec, plan.opt)):
                if oa and not pa:
                    leaves[i].copy_(comm.all_gather(
                        views[i], self.groups.get(oa), d))

    def train_step(self, params, opt_state, batch, chunks: int = 1):
        grads, metrics = self.forward_backward(params, batch, chunks)
        self.apply_update(params, opt_state, grads, metrics)
        return params, opt_state, metrics

    @torch.no_grad()
    def eval_loss(self, params: Params, batch: Dict[str, Any]) -> float:
        return float(self.global_loss(self.loss_fn(params, batch)))


def build_spmd_loss_fn(eng: SpmdEngine) -> Callable[[Params, Dict], Any]:
    """``loss_fn(params, batch)``: this rank's part of one microbatch's
    loss (its rows' masked NLL over the microbatch's whole token count;
    each vocab-tp rank holds its rows' whole NLL). The per-layer
    shardings, the boundary moves, the flash / plain core, the remat
    flags, the vocab-parallel CE and the ZeRO-3 gathers at use."""
    cfg, mesh, rank = eng.cfg, eng.mesh, eng.rank
    per_layer, vocab, groups = eng.per_layer, eng.vocab, eng.groups
    boundary = make_boundary_fn(per_layer, vocab, mesh, groups)
    use_vocab = make_use_fn(eng.plans, vocab, groups)
    uses = [make_use_fn(eng.plans, sh, groups) for sh in per_layer]
    rows = [batch_sharding(sh, mesh, rank) for sh in per_layer]
    vrows = batch_sharding(vocab, mesh, rank)
    seams = [_TPSeam(groups.get(sh.tp_axes))
             if axes_size(mesh, sh.tp_axes) > 1 else None
             for sh in per_layer]
    vseam = (_VocabSeam(groups.get(vocab.tp_axes)) if eng.vtp > 1
             else None)
    overrides = attention_overrides(per_layer, mesh, rank,
                                    use_flash=eng.flash)
    ce: Any = cfg.use_fused_ce
    if vseam is not None:
        from hetu_galvatron_tpu_torch.ops.cross_entropy import (
            make_vocab_parallel_ce,
        )

        ce = make_vocab_parallel_ce(vseam.group, fused=cfg.use_fused_ce)
    use_dropout = cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0
    dtype = eng.compute_dtype

    def fold(seed):
        # each rank draws its own masks over its own shard
        return None if seed is None else (
            seed + rank * 0x9E3779B97F4A7C15) % (1 << 62)

    def loss_fn(p: Params, batch: Dict[str, Any]):
        tokens, labels = batch["tokens"], batch["labels"]
        mask = batch.get("loss_mask")
        pos, seg = batch.get("position_ids"), batch.get("segment_ids")
        rng = batch.get("dropout_rng")
        n = len(p["layers"])
        seeds = [fold(s) for s in M.split_seeds(
            rng if use_dropout else None, n + 1)]
        dev = None if rng is None else rng.device
        # gathered once for the lookup and the tied head
        embed = use_vocab(p["embed"], "embed")
        x = M.apply_embedding(embed, vrows(tokens), cfg, compute_dtype=dtype,
                              dropout_rng=M.generator_from_seed(seeds[n],
                                                                dev),
                              position_ids=vrows(pos), vocab=vseam)
        shared_rope = None if pos is not None else rope_tables(cfg, tokens)
        for i, lp in enumerate(p["layers"]):
            x = boundary(i, x)
            rope = (shared_rope if pos is None
                    else rope_tables(cfg, rows[i](tokens), rows[i](pos)))
            kw = dict(rope=rope, compute_dtype=dtype,
                      segment_ids=rows[i](seg), tp=seams[i],
                      **overrides.get(i, {}))

            def layer(lp, h, i=i, kw=kw):
                return M.apply_decoder_layer(
                    uses[i](lp, f"layers.{i}"), h, cfg,
                    dropout_rng=M.generator_from_seed(seeds[i], dev), **kw)

            if per_layer[i].checkpoint:
                layer = M.remat(layer, cfg)
            x = layer(lp, x)
        x = boundary(n, x)
        x = M.apply_norm(p["prenorm"], x, cfg)
        head = use_vocab(p["head"], "head")
        logits = M.apply_lm_head(head, x, cfg, wte=embed["wte"],
                                 compute_dtype=dtype, vocab=vseam)
        nll = M.token_nll(logits, vrows(labels), fused=ce)
        if mask is None:
            return nll.sum() / float(labels.numel())
        return ((nll * vrows(mask).float()).sum()
                / mask.float().sum().clamp_min(1.0))

    return loss_fn
