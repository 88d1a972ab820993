"""Checkpoint resharding across the engine layouts
(``runtime/reshard.py``), mirroring ``tests/core/test_reshard.py``:
layout detection, canonicalization from the three layouts, the re-split
onto destination templates, and the exactness contract (a reshard moves
bytes, never values), at world 1 on the CPU without JAX's mesh leg. The
canonical form of a checkpoint equals JAX's ``canonicalize_params`` on
the same arrays.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from hetu_galvatron_tpu.runtime import reshard as JR
from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, ModelArgs
from hetu_galvatron_tpu_torch.core.args_schema import TrainArgs
from hetu_galvatron_tpu_torch.models.builder import (
    init_causal_lm,
    named_leaves,
)
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime import reshard as R
from hetu_galvatron_tpu_torch.runtime.compiled_pipeline import (
    CompiledPipelineEngine,
)
from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
    get_hybrid_parallel_config,
)
from hetu_galvatron_tpu_torch.runtime.optimizer import make_optimizer
from hetu_galvatron_tpu_torch.runtime.pipeline import PipelineEngine

CPU = torch.device("cpu")
MODEL = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
             vocab_size=64, seq_length=8, max_position_embeddings=16,
             make_vocab_size_divisible_by=1)
TRAIN = dict(lr=1e-2, clip_grad=1.0, weight_decay=0.01,
             lr_decay_style="constant", lr_warmup_iters=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tiny models run faster on one thread
    than on a pool contending with the other test workers, and torch's
    multi-threaded CPU kernels are not bit-reproducible run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(pp=2, chunks=2, gbsz=8, model=MODEL):
    args = CoreArgs(device="cpu", model=ModelArgs(**model),
                    train=TrainArgs(**TRAIN))
    for k, v in dict(pp_deg=pp, chunks=chunks, global_train_batch_size=gbsz,
                     pipeline_type="pipedream_flush",
                     mixed_precision="fp32").items():
        setattr(args.parallel, k, v)
    args.parallel.num_devices = pp
    return args, get_hybrid_parallel_config(args, pp)


def _batch(seed=0, gbsz=8):
    tok = np.random.RandomState(seed).randint(0, 64, (gbsz, 9))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32)}


def _equal(a, b):
    la, lb = list(named_leaves(a)), list(named_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert torch.equal(x.detach().cpu(), y.detach().cpu()), n


def _equal_opt(a, b):
    """Two canonical AdamW states: the count, then every moment."""
    assert a["count"] == b["count"]
    _equal({"mu": a["mu"], "nu": a["nu"]}, {"mu": b["mu"], "nu": b["nu"]})


def _params():
    return init_causal_lm(ModelArgs(**MODEL), seed=0)


# -- pure-host layout mechanics ----------------------------------------------


def test_torch_detect_layout():
    params = _params()
    assert R.detect_layout(params) == R.LAYOUT_SPMD
    assert R.detect_layout([{"layers": []}, {"layers": []}]) \
        == R.LAYOUT_STAGES
    assert R.detect_layout({"stages": [], "embed": {}}) == R.LAYOUT_STACKED
    with pytest.raises(R.ReshardError):
        R.detect_layout({"nope": 1})
    with pytest.raises(R.ReshardError):
        R.detect_layout([1, 2])
    # a flat payload's names carry the same three layouts
    assert R.layout_of_names(["layers.0.attn.wqkv", "embed.wte"]) == "spmd"
    assert R.layout_of_names(["0.layers.0.attn.wqkv", "1.head.whead"]) \
        == "stages"
    assert R.layout_of_names(["stages.0.attn.wqkv", "embed.wte"]) \
        == "stacked"


def test_torch_normalize_raw_folds_indexed_dicts():
    """Dotted names unflatten to '0', '1'-keyed dicts; canonicalization
    sees the saved sequence."""
    tree = {"layers": {"0": {"w": torch.ones(2)}, "1": {"w": torch.zeros(2)}}}
    norm = R.canonicalize_params(tree)
    assert isinstance(norm["layers"], list) and len(norm["layers"]) == 2
    assert torch.equal(norm["layers"][1]["w"], torch.zeros(2))
    flat = {"layers.1.w": torch.zeros(2), "layers.0.w": torch.ones(2)}
    folded = R._normalize_raw(R._unflatten(flat))
    assert R._structure(folded) == R._structure(
        {"layers": [{"w": torch.ones(2)}, {"w": torch.zeros(2)}]})
    assert torch.equal(folded["layers"][0]["w"], torch.ones(2))


def test_torch_canonicalize_stacked_roundtrip():
    """Hand-stack the compiled layout (layer s*lps+j -> row s of
    stages[j]) and canonicalize back: exact, order-preserving; the
    re-stack like a template gives the stacked tree again."""
    params = _params()
    pp, lps = 2, 2

    def stack(*rows):
        if isinstance(rows[0], dict):
            return {k: stack(*(r[k] for r in rows)) for k in rows[0]}
        return torch.stack(rows)

    stacked = {"stages": [stack(*[params["layers"][s * lps + j]
                                  for s in range(pp)]) for j in range(lps)],
               "embed": params["embed"], "prenorm": params["prenorm"],
               "head": params["head"]}
    canonical = R.canonicalize_params(stacked)
    _equal(canonical, params)
    assert len(canonical["layers"]) == 4
    _equal(R._stack_like(canonical, stacked), stacked)


def test_torch_canonicalize_stages_drops_tied_whead():
    """The host layout's transposed tied copy is derived state: the merge
    drops it (wte is canonical) and the re-split recreates it as the
    transpose."""
    params = _params()
    assert ModelArgs(**MODEL).tie_word_embeddings
    st0 = {"layers": params["layers"][:2], "embed": params["embed"]}
    st1 = {"layers": params["layers"][2:], "prenorm": params["prenorm"],
           "head": {**params["head"],
                    "whead": params["embed"]["wte"].t().contiguous()}}
    canonical = R.canonicalize_params([st0, st1], tie_word_embeddings=True)
    assert "whead" not in canonical["head"]
    _equal(canonical, params)
    back = R._split_stages_like(canonical, [st0, st1])
    assert torch.equal(back[1]["head"]["whead"], params["embed"]["wte"].t())
    _equal(back[0]["layers"], params["layers"][:2])


def test_torch_layer_count_mismatch_is_typed():
    params = _params()
    short = {**params, "layers": params["layers"][:3]}
    with pytest.raises(R.ReshardError, match="3 decoder layers"):
        R._relayout(short, params)
    with pytest.raises(R.ReshardError, match="shape mismatch"):
        R.place_like({"w": torch.zeros(2, 3)}, {"w": torch.zeros(3, 2)})
    with pytest.raises(R.ReshardError, match="structure mismatch"):
        R.place_like({"w": torch.zeros(2)}, {"v": torch.zeros(2)})


def test_torch_map_params_like_hits_moment_subtrees():
    """The structure-match walker transforms the AdamW moments (params
    clones) and leaves the count untouched."""
    params = _params()
    opt = {"count": 3, "mu": params, "nu": copy.deepcopy(params)}
    hits = []
    out = R.map_params_like(opt, R._structure(params),
                            lambda t: (hits.append(1) or t))
    assert len(hits) == 2 and out["count"] == 3
    assert out["mu"] is params


def test_torch_resume_elastic_rejects_moe_opt_state(tmp_path):
    with pytest.raises(R.ReshardError, match="MoE"):
        R.resume_elastic(str(tmp_path), {}, {}, num_experts=4)


# -- the exactness contract through real engines + checkpoints ----------------


def _opt_canonical(path, tie):
    return R.load_checkpoint_canonical(path, tie_word_embeddings=tie)[1]


def test_torch_reshard_exact_across_engines(tmp_path):
    """JAX's ``test_reshard_exact_across_engines`` at world 1 without its
    mesh leg: a host-engine checkpoint moves to the compiled layout and
    to the pp=1 trainer, a compiled checkpoint back to the host layout.
    Params and AdamW moments are bit-equal in every direction, and each
    destination takes a finite step."""
    args, hpc = _args()
    tie = args.model.tie_word_embeddings
    params = _params()
    batch = _batch()
    host = PipelineEngine(args.model, hpc, args.train, [CPU] * 2,
                          compute_dtype=torch.float32)
    sp = host.split_params(copy.deepcopy(params))
    so = host.init_opt(sp)
    for _ in range(2):
        host.train_step(sp, so, batch)
    truth = host.merge_params(sp)
    TK.save_checkpoint(str(tmp_path / "host"), 2, sp, so, hpc=hpc)
    hd = str(tmp_path / "host" / "step_2")
    canonical, copt, step, _ = R.load_checkpoint_canonical(
        hd, tie_word_embeddings=tie)
    assert step == 2 and sorted(copt) == ["count", "mu", "nu"]
    _equal(canonical, truth)

    # stages -> stacked
    comp = CompiledPipelineEngine(args.model, hpc, args.train, [CPU] * 2,
                                  compute_dtype=torch.float32)
    csp = comp.split_params(copy.deepcopy(params))
    cso = comp.init_opt(csp)
    nsp, nso, _ = R.resume_elastic(hd, csp, cso, tie_word_embeddings=tie)
    _equal(comp.merge_params(nsp), truth)
    assert nso.count == so[0].count and nso.decay == cso.decay
    TK.save_checkpoint(str(tmp_path / "as_stacked"), 2, nsp, nso, hpc=hpc)
    _equal_opt(_opt_canonical(str(tmp_path / "as_stacked" / "step_2"),
                              tie), copt)
    _, _, mc = comp.train_step(nsp, nso, batch)
    assert np.isfinite(mc["loss"])

    # stages -> spmd (the pp=1 trainer)
    tx = make_optimizer(args.train)
    p1 = copy.deepcopy(params)
    names, leaves = zip(*named_leaves(p1))
    so1 = tx.init(list(leaves), list(names))
    nsp1, nso1, _ = R.resume_elastic(hd, p1, so1, tie_word_embeddings=tie)
    _equal(nsp1, truth)
    _equal({"mu": nso1.mu, "nu": nso1.nu},
           {"mu": [t for _, t in named_leaves(copt["mu"])],
            "nu": [t for _, t in named_leaves(copt["nu"])]})
    from hetu_galvatron_tpu_torch.runtime.trainer import (
        make_loss_fn,
        make_train_step,
        to_device,
    )

    step_fn = make_train_step(make_loss_fn(args.model,
                                           compute_dtype=torch.float32),
                              tx, chunks=hpc.chunks)
    _, _, m1 = step_fn(nsp1, nso1, to_device(batch, CPU))
    assert np.isfinite(float(m1["loss"]))

    # stacked -> stages
    TK.save_checkpoint(str(tmp_path / "compiled"), 3, nsp, nso, hpc=hpc)
    cd = str(tmp_path / "compiled" / "step_3")
    sp_h = host.split_params(copy.deepcopy(params))
    so_h = host.init_opt(sp_h)
    nsp3, nso3, st = R.resume_elastic(cd, sp_h, so_h,
                                      tie_word_embeddings=tie)
    assert st == 3
    _equal(host.merge_params(nsp3), comp.merge_params(nsp))
    assert torch.equal(nsp3[1]["head"]["whead"],
                       nsp3[0]["embed"]["wte"].t())
    TK.save_checkpoint(str(tmp_path / "as_stages"), 3, nsp3, nso3, hpc=hpc)
    _equal_opt(_opt_canonical(str(tmp_path / "as_stages" / "step_3"), tie),
               _opt_canonical(cd, tie))
    _, _, mh = host.train_step(nsp3, nso3, batch)
    assert np.isfinite(mh["loss"])
    # a layout the live tree does not have is refused, strict or not
    with pytest.raises(TK.PlanMismatchError, match="stacked layout"):
        TK.load_checkpoint(cd, sp_h, so_h, hpc=hpc)


def _to_np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tuple(_to_np(v) for v in tree)


@pytest.mark.parametrize("layout", ["stages", "stacked"])
def test_torch_canonical_form_equals_jax(layout):
    """The port's canonical form of a host-engine and of a compiled state
    equals JAX's ``canonicalize_params`` on the same arrays (JAX's own
    layouts: tuples of layers, numpy leaves), leaf for leaf."""
    args, hpc = _args()
    tie = args.model.tie_word_embeddings
    cls = PipelineEngine if layout == "stages" else CompiledPipelineEngine
    eng = cls(args.model, hpc, args.train, [CPU] * 2,
              compute_dtype=torch.float32)
    tree = eng.split_params(_params())
    ours = R.canonicalize_params(tree, tie_word_embeddings=tie)
    if layout == "stages":
        jtree = [dict(_to_np(st)) for st in tree]
    else:
        jtree = {k: _to_np(v) for k, v in tree.items()}
    theirs = JR.canonicalize_params(jtree, tie_word_embeddings=tie)
    got = {n: t.numpy() for n, t in named_leaves(ours)}
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert sorted(got) == sorted(want)
    for n in want:
        assert np.array_equal(got[n], want[n]), n
