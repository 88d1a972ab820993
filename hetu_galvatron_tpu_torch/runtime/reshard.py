"""Move a committed checkpoint between the engines' parameter layouts.

Port of ``hetu_galvatron_tpu/runtime/reshard.py``: ``ReshardError`` :67,
``_normalize_raw`` :78, ``detect_layout`` :93, ``_unstack_compiled``
:130, ``_merge_stages`` :152, ``canonicalize_params`` :176,
``_fill_empty`` :188, ``_check_layer_count`` :204, ``_stack_like`` :212,
``_split_stages_like`` :229, ``_relayout`` :262, ``place_like`` :284,
``place_like_flat`` :299, ``map_params_like`` :325, ``_merge_opt_stages``
:350, ``load_checkpoint_canonical`` :398 and ``resume_elastic`` :481.

The three layouts a checkpoint may carry:

* **spmd**: one full-model tree (``models/builder.init_causal_lm``), the
  pp=1 trainer's;
* **stacked**: the compiled pipeline's (``runtime/compiled_pipeline.py``):
  decoder layer ``s*lps + j`` is row ``s`` of ``stages[j]``, the vocab
  rows one copy;
* **stages**: the host pipeline engine's (``runtime/pipeline.py``): a list
  of stage trees, the embedding on the first, the final norm and the head
  on the last (a tied head carrying the transposed copy ``whead``).

Everything goes through one canonical form, the full tree (CPU tensors),
and out again shaped like the destination engine's freshly initialized
state, its template: ``canonicalize -> re-split -> place``. "Placing" a
leaf is a copy onto the template leaf's device in its dtype (the
counterpart of JAX's ``device_put`` under the template's sharding), so
the destination never shares memory with the source. Moments move through
the same functions, so params and AdamW moments land bit for bit.

The port's checkpoints are flat dicts of dotted leaf names
(``runtime/checkpoint.py``); :func:`load_checkpoint_canonical` folds the
names back into the tree the engine saved (the counterpart of an orbax
raw restore, whose sequences come back as ``"0"``, ``"1"``-keyed dicts:
:func:`_normalize_raw`). An AdamW state (``runtime/optimizer.AdamState``)
is canonicalized as ``{"count", "mu", "nu"}`` with ``mu`` and ``nu``
trees shaped like the parameters; its ``adam`` / ``sgd`` leaf indices
belong to a layout and come from the destination's template.

Not ported: ``reshard_params`` :452 re-lays a tree over a device mesh,
which is ROADMAP item 10b; the launcher's elastic
pre-pass that calls :func:`resume_elastic` when the world changes waits
for item 15b. This is resume-path code: host copies are the point.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from hetu_galvatron_tpu_torch.models.builder import named_leaves
from hetu_galvatron_tpu_torch.runtime.optimizer import AdamState

Params = Dict[str, Any]

LAYOUT_SPMD = "spmd"
LAYOUT_STACKED = "stacked"
LAYOUT_STAGES = "stages"

# the full-model tree's vocab-row keys (everything that is not a layer)
_VOCAB_KEYS = ("embed", "prenorm", "head", "enc_norm")


class ReshardError(RuntimeError):
    """A checkpoint cannot be resharded onto the target plan (layer-count
    mismatch, unrecognized layout, shape drift): names both sides."""


# ---------------------------------------------------------------------------
# layout detection + normalization
# ---------------------------------------------------------------------------


def _normalize_raw(tree: Any) -> Any:
    """Fold dicts keyed ``'0', '1', ...`` back into lists (a flat
    checkpoint's dotted names, unflattened, give such dicts)."""
    if isinstance(tree, dict):
        keys = list(tree.keys())
        if keys and all(isinstance(k, str) and k.isdigit() for k in keys) \
                and sorted(int(k) for k in keys) == list(range(len(keys))):
            return [_normalize_raw(tree[str(i)]) for i in range(len(keys))]
        return {k: _normalize_raw(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_normalize_raw(v) for v in tree]
    return tree


def detect_layout(tree: Any) -> str:
    """Which engine layout a params tree (restored or live) carries."""
    if isinstance(tree, (list, tuple)):
        if tree and isinstance(tree[0], dict) and "layers" in tree[0]:
            return LAYOUT_STAGES
        raise ReshardError(
            f"unrecognized checkpoint params layout: sequence of "
            f"{type(tree[0]).__name__ if tree else 'nothing'}")
    if isinstance(tree, dict):
        if "stages" in tree:
            return LAYOUT_STACKED
        if "layers" in tree:
            return LAYOUT_SPMD
    raise ReshardError(
        "unrecognized checkpoint params layout: expected a full-model "
        "tree, a compiled stage-stacked tree, or a per-stage list "
        f"(got {type(tree).__name__} with keys "
        f"{sorted(tree) if isinstance(tree, dict) else '?'})")


def layout_of_names(names) -> str:
    """The layout of a flat checkpoint payload from its dotted leaf names
    (``<s>.`` prefixes: stages; ``stages.``: stacked; else spmd)."""
    heads = {n.split(".", 1)[0] for n in names}
    if heads and all(h.isdigit() for h in heads):
        return LAYOUT_STAGES
    if "stages" in heads:
        return LAYOUT_STACKED
    return LAYOUT_SPMD


def _unflatten(flat: Dict[str, Any]) -> Params:
    """Dotted names -> the nested tree (sequences as digit-keyed dicts)."""
    out: Params = {}
    for name, value in flat.items():
        node = out
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def _cpu(tree: Any) -> Any:
    """The tree with every tensor detached on the CPU and lists for
    sequences."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree


def _structure(tree: Any) -> Any:
    """A hashable skeleton of a tree (dict keys, sequence lengths, tensor
    leaves): the counterpart of ``jax.tree.structure``."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return ("seq", tuple(_structure(v) for v in tree))
    if isinstance(tree, torch.Tensor):
        return "tensor"
    return ("other", type(tree).__name__)


# ---------------------------------------------------------------------------
# canonicalize: any layout -> the full host tree
# ---------------------------------------------------------------------------


def _unstack_compiled(tree: Params) -> Params:
    """Stacked layout -> full tree (``CompiledPipelineEngine.merge_params``:
    layer ``s*lps + j`` is row ``s`` of ``stages[j]``)."""
    stages = list(tree["stages"])
    lps = len(stages)
    leaves = [t for _, t in named_leaves(stages[0])] if stages else []
    if not leaves:
        raise ReshardError("stacked checkpoint has no layer leaves")
    pp = int(leaves[0].shape[0])

    def row(node, s):
        if isinstance(node, dict):
            return {k: row(v, s) for k, v in node.items()}
        return node.detach().cpu()[s].clone()

    out: Params = {"layers": [row(stages[j], s) for s in range(pp)
                              for j in range(lps)]}
    for k in _VOCAB_KEYS:
        if k in tree:
            out[k] = _cpu(tree[k])
    return out


def _merge_stages(stage_list: Sequence[Params], *, tie: bool) -> Params:
    """Host per-stage layout -> full tree (``PipelineEngine.merge_params``;
    the tied head's transposed ``whead`` copy is dropped: ``wte`` carries
    the canonical value)."""
    layers: List[Params] = []
    enc: List[Params] = []
    out: Params = {}
    for sp in stage_list:
        layers.extend(_cpu(list(sp.get("layers", []))))
        if "enc_layers" in sp:
            enc.extend(_cpu(list(sp["enc_layers"])))
        for k in ("embed", "prenorm", "enc_norm"):
            if k in sp:
                out[k] = _cpu(sp[k])
        if "head" in sp:
            out["head"] = _cpu({k: v for k, v in sp["head"].items()
                                if not (tie and k == "whead")})
    out["layers"] = layers
    if enc:
        out["enc_layers"] = enc
    return out


def canonicalize_params(tree: Any, *, tie_word_embeddings: bool = False,
                        layout: Optional[str] = None) -> Params:
    """Any engine layout -> the canonical full tree (CPU tensors)."""
    tree = _normalize_raw(tree)
    layout = layout or detect_layout(tree)
    if layout == LAYOUT_SPMD:
        return _cpu(tree)
    if layout == LAYOUT_STACKED:
        return _unstack_compiled(tree)
    return _merge_stages(tree, tie=tie_word_embeddings)


def _fill_empty(canonical: Params, template: Params) -> Params:
    """Empty vocab-row containers (a tied model's ``head: {}``) leave no
    name on disk; recreate those the destination template has."""
    out = dict(canonical)
    for k in _VOCAB_KEYS:
        if k in template and k not in out:
            out[k] = {}
    return out


# ---------------------------------------------------------------------------
# re-split: canonical tree -> the destination template's layout
# ---------------------------------------------------------------------------


def _check_layer_count(canonical: Params, want: int, what: str) -> None:
    have = len(canonical["layers"])
    if have != want:
        raise ReshardError(
            f"checkpoint has {have} decoder layers but the target "
            f"{what} expects {want}: the plans describe different models")


def _stack_like(canonical: Params, template: Params) -> Params:
    """Canonical -> the stacked layout shaped like ``template``."""
    lps = len(template["stages"])
    leaves = [t for _, t in named_leaves(template["stages"][0])]
    pp = int(leaves[0].shape[0])
    _check_layer_count(canonical, pp * lps, "compiled plan")

    def stack(*rows):
        if isinstance(rows[0], dict):
            return {k: stack(*(r[k] for r in rows)) for k in rows[0]}
        return torch.stack([r.detach().cpu() for r in rows])

    out: Params = {"stages": [
        stack(*[canonical["layers"][s * lps + j] for s in range(pp)])
        for j in range(lps)]}
    for k in _VOCAB_KEYS:
        if k in template:
            out[k] = canonical.get(k, {})
    return out


def _split_stages_like(canonical: Params,
                       template: Sequence[Params]) -> List[Params]:
    """Canonical -> the host per-stage layout shaped like ``template``:
    layer slices by each stage's count, vocab rows by key presence, the
    tied ``whead`` recreated as the transpose of the canonical ``wte``
    (for the moments too: the engine's tied exchange keeps them so)."""
    total = sum(len(st["layers"]) for st in template)
    _check_layer_count(canonical, total, "pipeline plan")
    out: List[Params] = []
    lo = elo = 0
    for st in template:
        n = len(st["layers"])
        sp: Params = {"layers": list(canonical["layers"][lo:lo + n])}
        lo += n
        if "enc_layers" in st:
            ne = len(st["enc_layers"])
            sp["enc_layers"] = list(canonical["enc_layers"][elo:elo + ne])
            elo += ne
        for k in ("embed", "prenorm", "enc_norm"):
            if k in st:
                sp[k] = canonical.get(k, {})
        if "head" in st:
            head = canonical.get("head", {})
            if "whead" in st["head"] and "whead" not in head:
                head = {**head, "whead": canonical["embed"]["wte"].t()}
            sp["head"] = head
        out.append(sp)
    return out


def _relayout(canonical: Params, template: Any) -> Any:
    """Canonical tree -> a host tree in the template's layout."""
    layout = detect_layout(template)
    if layout == LAYOUT_SPMD:
        _check_layer_count(canonical, len(template["layers"]), "plan")
        return _fill_empty(canonical, template)
    if layout == LAYOUT_STACKED:
        return _stack_like(canonical, template)
    return _split_stages_like(canonical, template)


def _put(t: torch.Tensor, s: Any) -> torch.Tensor:
    """A contiguous copy of ``s`` on ``t``'s device in ``t``'s dtype."""
    if not isinstance(s, torch.Tensor):
        raise ReshardError(f"reshard structure mismatch: checkpoint leaf "
                           f"{type(s).__name__} for a tensor of "
                           f"{tuple(t.shape)}")
    if tuple(t.shape) != tuple(s.shape):
        raise ReshardError(
            f"reshard shape mismatch: checkpoint leaf {tuple(s.shape)} vs "
            f"target {tuple(t.shape)}")
    out = s.detach().to(device=t.device, dtype=t.dtype,
                        copy=True).contiguous()
    return out.requires_grad_(t.requires_grad)


def place_like(template: Any, host_tree: Any) -> Any:
    """Every host leaf placed like the matching template leaf (the
    destination engine's freshly initialized tree is the spec sheet).
    Raises :class:`ReshardError` on any structure or shape
    disagreement."""
    if isinstance(template, torch.Tensor):
        return _put(template, host_tree)
    if isinstance(template, dict):
        if not isinstance(host_tree, dict) or set(host_tree) != set(template):
            raise ReshardError(
                "reshard structure mismatch between the checkpoint and the "
                f"target plan's tree: keys {sorted(template)} vs "
                f"{sorted(host_tree) if isinstance(host_tree, dict) else host_tree!r}")
        return {k: place_like(template[k], host_tree[k]) for k in template}
    if isinstance(template, (list, tuple)):
        if (not isinstance(host_tree, (list, tuple))
                or len(host_tree) != len(template)):
            raise ReshardError(
                "reshard structure mismatch between the checkpoint and the "
                f"target plan's tree: a sequence of {len(template)} vs "
                f"{host_tree!r:.80}")
        return type(template)(place_like(a, b)
                              for a, b in zip(template, host_tree))
    return host_tree


def place_like_flat(template: AdamState, host_tree: Dict[str, Any]
                    ) -> AdamState:
    """Flat-order placement for OPTIMIZER state: the template AdamState's
    moments (``mu``, then ``nu``) paired in order with the host tree's
    (the ``mu`` tree's leaves, then ``nu``'s), every shape checked; the
    count is the checkpoint's, the ``adam`` / ``sgd`` indices and decay
    flags the template's. A misalignment surfaces as a shape or count
    mismatch, never as silent corruption."""
    hleaves = ([t for _, t in named_leaves(host_tree["mu"])]
               + [t for _, t in named_leaves(host_tree["nu"])])
    tleaves = template.mu + template.nu
    if len(tleaves) != len(hleaves):
        raise ReshardError(
            f"optimizer state leaf count mismatch: checkpoint has "
            f"{len(hleaves)} moments, target optimizer expects "
            f"{len(tleaves)}: resume with the optimizer the checkpoint was "
            "trained with")
    moments = [_put(t, h) for t, h in zip(tleaves, hleaves)]
    n = len(template.mu)
    return replace(template, count=int(host_tree["count"]), mu=moments[:n],
                   nu=moments[n:])


# ---------------------------------------------------------------------------
# optimizer state: map the params-shaped subtrees through the same moves
# ---------------------------------------------------------------------------


def map_params_like(tree: Any, params_def: Any,
                    fn: Callable[[Any], Any]) -> Any:
    """Replace every subtree of ``tree`` whose structure
    (:func:`_structure`) equals ``params_def`` with ``fn(subtree)``: how
    the AdamW moments, clones of the params tree, get the same layout
    moves as the params. Every other node (counts, index lists) passes
    through."""
    def walk(node):
        if _structure(node) == params_def:
            return fn(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c) for c in node)
        return node

    return walk(tree)


def _merge_opt_stages(stage_opts: Sequence[Any], stage_defs: Sequence[Any],
                      merge_fn: Callable[[List[Any]], Any]) -> Any:
    """Lockstep walk over the host engine's per-stage optimizer states:
    wherever every branch matches its stage's params structure, merge the
    per-stage trees into one canonical tree. Scalars (the step count) are
    equal across stages, and the first stage's is kept."""
    def walk(nodes):
        if all(_structure(n) == d for n, d in zip(nodes, stage_defs)):
            return merge_fn(list(nodes))
        n0 = nodes[0]
        if isinstance(n0, dict):
            return {k: walk([n[k] for n in nodes]) for k in n0}
        if isinstance(n0, (list, tuple)):
            return type(n0)(walk([n[i] for n in nodes])
                            for i in range(len(n0)))
        return n0

    return walk(list(stage_opts))


def _opt_tree(state: Any) -> Any:
    """A restored AdamW payload as ``{"count", "mu", "nu"}``: the leaf
    indices ``adam`` / ``sgd`` name a layout's leaves and are the
    destination's business."""
    if isinstance(state, list):
        return [_opt_tree(s) for s in state]
    return {k: v for k, v in state.items() if k not in ("adam", "sgd")}


# ---------------------------------------------------------------------------
# checkpoint -> canonical
# ---------------------------------------------------------------------------


def load_checkpoint_canonical(
    ckpt_dir: str,
    *,
    tie_word_embeddings: bool = False,
    with_opt: bool = True,
) -> Tuple[Params, Any, int, Dict[str, Any]]:
    """A committed checkpoint written under any engine layout, in the
    canonical full tree. Returns ``(params, opt_state, step, meta)``;
    ``opt_state`` is ``{"count", "mu", "nu"}`` with canonical moment
    trees, None when absent or ``with_opt`` is off. No target tree and no
    optimizer are needed: the saved names drive structure and layout."""
    from hetu_galvatron_tpu_torch.runtime.checkpoint import (
        OPT_FILE,
        PARAMS_FILE,
        _read_torch,
        read_checkpoint_meta,
    )

    ckpt_dir = os.path.abspath(ckpt_dir)
    meta = read_checkpoint_meta(ckpt_dir)
    if "step" not in meta:
        raise FileNotFoundError(
            f"{ckpt_dir} has no meta.json: not a committed checkpoint")
    raw = _normalize_raw(_unflatten(_read_torch(
        os.path.join(ckpt_dir, PARAMS_FILE))))
    layout = detect_layout(raw)
    canonical = canonicalize_params(raw, layout=layout,
                                    tie_word_embeddings=tie_word_embeddings)
    opt = None
    opt_path = os.path.join(ckpt_dir, OPT_FILE)
    if with_opt and os.path.exists(opt_path):
        raw_opt = _opt_tree(_normalize_raw(_unflatten(
            _read_torch(opt_path))))
        if layout == LAYOUT_STAGES:
            stage_defs = [_structure(st) for st in raw]
            opt = _merge_opt_stages(
                raw_opt, stage_defs,
                lambda trees: _merge_stages(trees, tie=tie_word_embeddings))
        else:
            opt = map_params_like(raw_opt, _structure(raw), lambda t:
                                  canonicalize_params(t, layout=layout))
    return canonical, opt, int(meta["step"]), meta


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def resume_elastic(
    ckpt_dir: str,
    dst_params: Any,
    dst_opt: Any,
    *,
    tie_word_embeddings: bool = False,
    num_experts: int = 0,
) -> Tuple[Any, Any, int]:
    """A committed checkpoint written under any engine layout, placed on
    the destination engine's freshly initialized ``(dst_params, dst_opt)``
    templates (its ``split_params`` / ``init_opt`` output): the same
    values in the new layout. Returns new ``(params, opt_state, step)``;
    the templates are left as they are. The destination optimizer must be
    the one the checkpoint was trained with (the flat pairing of
    :func:`place_like_flat` checks every leaf)."""
    if num_experts:
        # the expert-bias leaves take SGD and carry no moments, so the
        # moment trees do not match the params tree and the subtree
        # mapping would silently skip them
        raise ReshardError(
            "elastic reshard of MoE optimizer state is not supported yet "
            "(the expert-bias optimizer lane masks the moment trees); "
            "resume MoE runs on the original topology")
    canonical, canonical_opt, step, _ = load_checkpoint_canonical(
        ckpt_dir, tie_word_embeddings=tie_word_embeddings,
        with_opt=dst_opt is not None)
    sp = place_like(dst_params, _relayout(canonical, dst_params))
    so = dst_opt
    if canonical_opt is not None and dst_opt is not None:
        canon_def = _structure(canonical)
        if detect_layout(dst_params) == LAYOUT_STAGES:
            so = [place_like_flat(
                dst_opt[s],
                map_params_like(
                    canonical_opt, canon_def,
                    lambda t, s=s: _split_stages_like(t, dst_params)[s]))
                for s in range(len(dst_params))]
        else:
            so = place_like_flat(
                dst_opt,
                map_params_like(canonical_opt, canon_def,
                                lambda t: _relayout(t, dst_params)))
    return sp, so, step
