"""The port's compiled 1F1B pipeline (``runtime/compiled_pipeline.py``)
against the JAX package's, at one rank a stage.

The oracle is JAX's ``CompiledPipelineEngine`` on ``jax.devices()[:pp]``
(the conftest's virtual CPU devices) at world = pp, tp = dp = 1, in fp32,
with the same weights (``params_from_jax``) and the same seeded numpy
batches; the port's lanes all sit on the CPU, where a stand-in takes the
CUDA graph's place (the step runs eagerly each time) and captures are
still counted. Tolerances are JAX's own
(``tests/core/test_compiled_pipeline.py``): loss within 2e-5, grad norm
within 1e-4, every parameter after the steps within rtol 5e-4 / atol
5e-5. Each JAX run is made once per module and shared.

Port-only: the port's host engine as a second oracle, the launch rule
counted through the flash kernels' plain versions, dropout against the
host engine's masks, the ramp's captures, the stacked decay mask against
JAX's, the launch census a capture records, the program cost, and the
refusals with JAX's reasons.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import CoreArgs as JCoreArgs
from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.core.args_schema import TrainArgs as JTrainArgs
from hetu_galvatron_tpu.models import builder as JB
from hetu_galvatron_tpu.runtime import compiled_pipeline as JC
from hetu_galvatron_tpu.runtime import hybrid_config as JH
from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, ModelArgs
from hetu_galvatron_tpu_torch.core.args_schema import TrainArgs
from hetu_galvatron_tpu_torch.models.builder import (
    init_causal_lm,
    named_leaves,
)
from hetu_galvatron_tpu_torch.ops import _build
from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH
from hetu_galvatron_tpu_torch.runtime.checkpoint import (
    params_from_jax,
    params_to_jax,
)
from hetu_galvatron_tpu_torch.runtime.compiled_pipeline import (
    DROPOUT_REASON,
    CompiledPipelineEngine,
)
from hetu_galvatron_tpu_torch.runtime.optimizer import make_optimizer
from hetu_galvatron_tpu_torch.runtime.pipeline import PipelineEngine

CPU = torch.device("cpu")
# JAX's CFG (tests/core/test_compiled_pipeline.py), tied
CFG = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
           vocab_size=64, max_position_embeddings=32, seq_length=8,
           hidden_act="swiglu", normalization="rmsnorm",
           position_embedding_type="rope", tie_word_embeddings=True,
           add_bias_linear=False, add_qkv_bias=False,
           make_vocab_size_divisible_by=1, ffn_hidden_size=64)
UNTIED = dict(CFG, tie_word_embeddings=False)
BERT = dict(model_type="bert", hidden_size=32, num_hidden_layers=4,
            num_attention_heads=2, vocab_size=64, max_position_embeddings=32,
            seq_length=8, hidden_act="gelu", normalization="layernorm",
            position_embedding_type="learned", add_qkv_bias=True,
            add_bias_linear=True, make_vocab_size_divisible_by=1)
TRAIN = dict(lr=1e-2, clip_grad=1.0, weight_decay=0.01,
             lr_decay_style="constant", lr_warmup_iters=0)
STEPS = 3
# name -> (model, parallel settings); every case at world = pp
CASES = {
    "tied_pp2": (CFG, dict(pp_deg=2, chunks=4)),
    "untied_pp4": (UNTIED, dict(pp_deg=4, chunks=4)),
    "bert_pp2": (BERT, dict(pp_deg=2, chunks=2)),
}
_JAX_RUNS = {}
_WEIGHTS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tiny models run faster on one thread
    than on a pool contending with the other test workers, and torch's
    multi-threaded CPU kernels are not bit-reproducible run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(seed, cfg=CFG, bsz=16):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, cfg["vocab_size"], (bsz, cfg["seq_length"] + 1))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32),
            "loss_mask": (rs.rand(bsz, cfg["seq_length"]) > 0.15).astype(
                np.float32)}


def weights(model):
    """The port's seeded weights in the JAX tree (numpy), and JAX's
    logical axes of that tree, traced without running JAX's init."""
    key = repr(sorted(model.items()))
    if key not in _WEIGHTS:
        cfg, box = JModelArgs(**model), {}

        def init(k):
            params, box["axes"] = JB.init_causal_lm(k, cfg)
            return params

        jax.eval_shape(init, jax.random.key(0))
        _WEIGHTS[key] = (params_to_jax(init_causal_lm(ModelArgs(**model),
                                                      seed=0)),
                         box["axes"])
    return _WEIGHTS[key]


def _parallel(obj, pkw):
    for k, v in {"pipeline_type": "pipedream_flush",
                 "global_train_batch_size": 16, **pkw}.items():
        setattr(obj, k, v)


def jax_hpc(model, pkw, data=None):
    args = JCoreArgs(model=JModelArgs(**model).model_dump(),
                     train=JTrainArgs(**TRAIN).model_dump())
    _parallel(args.parallel, pkw)
    if data:
        for k, v in data.items():
            setattr(args.data, k, v)
    return args, JH.get_hybrid_parallel_config(args, pkw["pp_deg"])


def port_args(model, pkw):
    args = CoreArgs(device="cpu", model=ModelArgs(**model),
                    train=TrainArgs(**TRAIN))
    _parallel(args.parallel, pkw)
    args.parallel.num_devices = pkw["pp_deg"]
    return args, TH.get_hybrid_parallel_config(args, pkw["pp_deg"])


def jax_run(name):
    """JAX's compiled engine, ``STEPS`` steps of seeded batches (one for
    BERT), then an eval; cached per module. Returns the per-step metrics,
    the merged numpy weights after the steps, and the eval loss."""
    if name in _JAX_RUNS:
        return _JAX_RUNS[name]
    model, pkw = CASES[name]
    args, hpc = jax_hpc(model, pkw)
    params, axes = weights(model)
    eng = JC.CompiledPipelineEngine(JModelArgs(**model), hpc, args.train,
                                    devices=jax.devices()[:pkw["pp_deg"]],
                                    compute_dtype=jnp.float32)
    sp = eng.split_params(params, axes)
    so = eng.init_opt(sp, axes)
    metrics = []
    for step in range(1 if model is BERT else STEPS):
        sp, so, m = eng.train_step(sp, so, batch(step, model))
        metrics.append({k: float(v) for k, v in m.items()})
    merged = jax.tree.map(np.asarray, eng.merge_params(sp))
    ev = eng.eval_step(sp, batch(99, model))["loss"]
    _JAX_RUNS[name] = (metrics, merged, ev)
    return _JAX_RUNS[name]


def engines(name, **over):
    """The port's compiled and host engines on the case, with the
    weights JAX's run starts from."""
    model, pkw = CASES[name]
    args, hpc = port_args(model, dict(pkw, **over))
    init = weights(model)[0]
    comp = CompiledPipelineEngine(args.model, hpc, args.train,
                                  [CPU] * hpc.pp_deg,
                                  compute_dtype=torch.float32)
    host = PipelineEngine(args.model, hpc, args.train, [CPU] * hpc.pp_deg,
                          compute_dtype=torch.float32)
    return comp, host, init, args


def assert_params_close(got, want, rtol=5e-4, atol=5e-5):
    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    assert sorted(got) == sorted(want)
    for n, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   want[n].detach().numpy(), rtol=rtol,
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize("name", list(CASES))
def test_torch_compiled_steps_match_jax_and_the_host_engine(name):
    """Three steps (one for BERT) of the tied pp 2, untied pp 4 and BERT
    plans: loss, grad norm and every parameter against JAX's compiled
    engine and the port's host engine; the held-out eval against JAX's;
    one capture."""
    jm, jnew, jev = jax_run(name)
    comp, host, init, _ = engines(name)
    csp = comp.split_params(params_from_jax(init))
    cso = comp.init_opt(csp)
    hsp = host.split_params(params_from_jax(init))
    hso = host.init_opt(hsp)
    model = CASES[name][0]
    for step, want in enumerate(jm):
        b = batch(step, model)
        _, _, cm = comp.train_step(csp, cso, b)
        _, _, hm = host.train_step(hsp, hso, b)
        for ref in (want, hm):
            assert abs(cm["loss"] - ref["loss"]) < 2e-5, (step, cm, ref)
            assert abs(cm["grad_norm"] - ref["grad_norm"]) < 1e-4, (step, cm,
                                                                    ref)
    merged = comp.merge_params(csp)
    assert_params_close(merged, params_from_jax(jnew))
    assert_params_close(merged, host.merge_params(hsp))
    assert abs(comp.eval_step(csp, batch(99, model))["loss"] - jev) < 2e-5
    assert comp.compile_count() == 1


def test_torch_compiled_layout_round_trip():
    """``split_params`` then ``merge_params`` is the identity; layer
    ``s*lps + j`` is row s of ``stages[j]``; a tied model keeps one
    ``wte`` and no transposed copy."""
    comp, _, init, _ = engines("tied_pp2")
    full = params_from_jax(init)
    sp = comp.split_params(full)
    assert len(sp["stages"]) == 2 and sp["head"] == {}
    names = [n for n, _ in named_leaves(sp)]
    assert not any("whead" in n for n in names)
    assert sum(n.endswith("wte") for n in names) == 1
    wqkv = sp["stages"][1]["attn"]["wqkv"]
    assert wqkv.shape[0] == 2 and wqkv.requires_grad
    assert torch.equal(wqkv[1], full["layers"][3]["attn"]["wqkv"])
    back = dict(named_leaves(comp.merge_params(sp)))
    want = dict(named_leaves(full))
    assert sorted(back) == sorted(want)
    assert all(torch.equal(back[n], want[n]) for n in want)


def test_torch_compiled_bubble_frac_formula():
    """JAX's ``test_bubble_frac_formula``: 2(pp-1) idle tick-slots over m
    + 2(pp-1) ticks."""
    comp, _, _, _ = engines("tied_pp2")
    assert comp.bubble_frac(4) == pytest.approx(2 / 6)
    assert comp.bubble_frac(1) == pytest.approx(2 / 3)
    assert comp.bubble_frac() == pytest.approx(2 / 6)  # the plan's chunks
    comp.pp = 4
    assert comp.bubble_frac(8) == pytest.approx(6 / 14)
    assert comp.ticks(8) == 14


def test_torch_compiled_ramp_captures_once_per_count():
    """JAX's ``test_compiled_ramp_caches_one_program_per_chunk_count``:
    one capture per distinct microbatch count, each captured once, the
    steps equal to fresh engines' at the same count."""
    comp, _, init, _ = engines("tied_pp2", chunks=2,
                               global_train_batch_size=8)
    sp = comp.split_params(params_from_jax(init))
    so = comp.init_opt(sp)
    b8, b4 = batch(0, bsz=8), batch(1, bsz=4)
    seen = [comp.train_step(sp, so, b8, num_microbatches=2)[2],
            comp.train_step(sp, so, b4, num_microbatches=1)[2],
            comp.train_step(sp, so, b8, num_microbatches=2)[2]]
    assert sorted(m for m, _ in comp._programs) == [1, 2]
    assert comp.compile_count() == 2
    assert all(np.isfinite(m["loss"]) for m in seen)


def _dropout_engines(seed_model=CFG):
    model = dict(seed_model, hidden_dropout=0.1, attention_dropout=0.1)
    args, hpc = port_args(model, dict(pp_deg=2, chunks=2,
                                      global_train_batch_size=8))
    init = params_from_jax(weights(CFG)[0])
    comp = CompiledPipelineEngine(args.model, hpc, args.train, [CPU] * 2,
                                  compute_dtype=torch.float32)
    host = PipelineEngine(args.model, hpc, args.train, [CPU] * 2,
                          compute_dtype=torch.float32)
    return comp, host, init


def test_torch_compiled_dropout_replays_the_host_masks():
    """With dropout on, every step (the first run and the stand-in
    replays) draws the host engine's per-(microbatch, stage) masks:
    losses and grad norms within 1e-6 over three steps of new generators;
    another generator draws other masks; a missing one is refused."""
    comp, host, init = _dropout_engines()
    csp, hsp = comp.split_params(copy.deepcopy(init)), \
        host.split_params(copy.deepcopy(init))
    cso, hso = comp.init_opt(csp), host.init_opt(hsp)
    for step in range(3):
        b = batch(step, bsz=8)
        cm = comp.train_step(csp, cso, dict(
            b, dropout_rng=torch.Generator().manual_seed(10 + step)))[2]
        hm = host.train_step(hsp, hso, dict(
            b, dropout_rng=torch.Generator().manual_seed(10 + step)))[2]
        assert abs(cm["loss"] - hm["loss"]) < 1e-6, (step, cm, hm)
        assert abs(cm["grad_norm"] - hm["grad_norm"]) < 1e-5, (step, cm, hm)
    runs = []
    for seed in (5, 5, 6):
        comp, _, init = _dropout_engines()
        sp = comp.split_params(init)
        runs.append(comp.train_step(sp, comp.init_opt(sp), dict(
            batch(0, bsz=8),
            dropout_rng=torch.Generator().manual_seed(seed)))[2])
    assert runs[0] == runs[1] and runs[0] != runs[2]
    with pytest.raises(ValueError, match="dropout_rng"):
        comp.train_step(sp, comp.init_opt(sp), batch(0, bsz=8))


def test_torch_compiled_stacked_decay_mask_matches_jax():
    """The AdamW decay flags of the stacked tree are JAX's
    ``_stacked_decay_mask``: a stacked bias or norm weight ([pp, H]) is
    not decayed, a stacked matrix is; one optimizer update moves the
    undecayed leaves as plain Adam does."""
    model, pkw = CASES["bert_pp2"]  # biases and LayerNorms in the layers
    args, hpc = jax_hpc(model, pkw)
    params, axes = weights(model)
    jeng = JC.CompiledPipelineEngine(JModelArgs(**model), hpc, args.train,
                                     devices=jax.devices()[:2],
                                     compute_dtype=jnp.float32)
    mask = JC._stacked_decay_mask(jeng.split_params(params, axes))
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(mask)[0]}
    comp, _, init, _ = engines("bert_pp2")
    sp = comp.split_params(params_from_jax(init))
    so = comp.init_opt(sp)
    names = [n for n, _ in named_leaves(sp)]
    got = {names[i]: flag for i, flag in zip(so.adam, so.decay)}
    assert got == want
    assert not got["stages.0.attn.bqkv"] and got["stages.0.attn.wqkv"]


def test_torch_adamw_lead_axes_keep_stacked_vectors_undecayed():
    """``AdamW.init(lead_axes=...)``: the decay rule skips the leading
    axes; without them a [pp, H] leaf counts as a matrix."""
    tx = make_optimizer(TrainArgs(**TRAIN))
    leaves = [torch.ones(2, 4), torch.ones(2, 4, 3), torch.ones(4, 3)]
    assert tx.init(leaves).decay is None
    assert tx.init(leaves, lead_axes=[1, 1, 0]).decay == [False, True, True]
    moved = []
    for lead in (None, [1, 1, 0]):
        p = [t.clone() for t in leaves]
        st = tx.init(p, lead_axes=lead)
        tx.update(p, [torch.full_like(t, 0.5) for t in p], st,
                  torch.tensor(1.0))
        moved.append(p[0])
    assert not torch.equal(moved[0], moved[1])


@pytest.mark.parametrize("remat,want", [(False, (2, 1)), (True, (3, 1))])
def test_torch_compiled_launch_rule(remat, want, monkeypatch):
    """The flash launches of a step, counted through the kernels' plain
    versions with the flash core forced on the CPU: each of the T = m +
    2(pp - 1) ticks runs every layer slot's K1 once in the forward unit,
    once in the backward unit's recompute and once more when the layer is
    checkpointed, and K2, K3 once, for every lane at once (the lanes
    folded into the batch)."""
    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    counts = {}
    for fn in ("flash_fwd_plain", "flash_bwd_dkdv_plain",
               "flash_bwd_dq_plain"):
        def counted(*a, _f=getattr(TF, fn), _n=fn, **kw):
            counts[_n] = counts.get(_n, 0) + 1
            return _f(*a, **kw)
        monkeypatch.setattr(TF, fn, counted)
    comp, _, init, _ = engines("untied_pp4", global_checkpoint=int(remat))
    assert comp.remat == remat
    comp._sdpa = TF.flash_sdpa
    sp = comp.split_params(params_from_jax(init))
    comp.train_step(sp, comp.init_opt(sp), batch(0, UNTIED))
    ticks, lps = comp.ticks(4), comp.lps
    assert counts == {"flash_fwd_plain": want[0] * ticks * lps,
                      "flash_bwd_dkdv_plain": want[1] * ticks * lps,
                      "flash_bwd_dq_plain": want[1] * ticks * lps}


def test_torch_capture_census_counts_every_replay():
    """A launch made while a census is open (a graph capturing) is
    recorded, not counted; each replay adds the census."""
    _build.reset_launch_counts()
    _build.check_launch("flash_fwd", 0)
    census = _build.CaptureCensus()
    with census:
        _build.check_launch("flash_fwd", 0)
        _build.check_launch("flash_bwd_dq", 0)
        with pytest.raises(RuntimeError, match="already open"):
            with _build.CaptureCensus():
                pass
    assert _build.launch_counts["flash_fwd"] == 1
    assert census.counts["flash_fwd"] == census.counts["flash_bwd_dq"] == 1
    census.replayed()
    census.replayed()
    assert _build.launch_counts["flash_fwd"] == 3
    assert _build.launch_counts["flash_bwd_dq"] == 2
    with pytest.raises(RuntimeError, match="failed to launch"):
        _build.check_launch("flash_fwd", 700)
    _build.reset_launch_counts()


def test_torch_program_cost_is_recorded_once_per_program():
    """``maybe_record_jit_cost``: with a sink, the first run of a program
    is counted (the flop counter's formulas over its operators) plus the
    caller's extra FLOPs and recorded once as ``cost/flops``; without a
    sink the program only runs."""
    from hetu_galvatron_tpu_torch.observability import trace_analysis as TA
    from hetu_galvatron_tpu_torch.observability.registry import (
        MetricsRegistry,
    )

    class Sink:
        def __init__(self):
            self.records = []

        def write(self, rec):
            self.records.append(rec)

    a, b = torch.ones(8, 16), torch.ones(16, 4)
    sink = Sink()
    reg = MetricsRegistry([sink])
    out, cost = TA.maybe_record_jit_cost("prog", torch.matmul, (a, b),
                                         registry=reg, extra_flops=lambda: 6)
    assert torch.equal(out, a @ b)
    assert cost == {"flops": 2 * 8 * 16 * 4 + 6}
    assert reg.gauge("cost/flops", program="prog").value == cost["flops"]
    assert [r["name"] for r in sink.records] == ["program_cost"]
    again = TA.maybe_record_jit_cost("prog", torch.matmul, (a, b),
                                     registry=reg)
    assert again[1] is None and len(sink.records) == 1
    quiet = TA.maybe_record_jit_cost("other", torch.matmul, (a, b),
                                     registry=MetricsRegistry())
    assert quiet[1] is not None  # an explicit registry opts in
    assert TA.jit_cost_summary(lambda: None)[1] == {}


def test_torch_program_cost_leaves_the_step_bits_alone():
    """Counting a compiled step's FLOPs runs every operator as it is: the
    counted step's gradients and norm equal an uncounted one's bit for bit
    (``FlopCounterMode`` decomposes the operators it has no formula for,
    which moves this tied plan's gradients)."""
    from hetu_galvatron_tpu_torch.observability.trace_analysis import (
        jit_cost_summary,
    )

    runs = []
    for counted in (False, True):
        comp, _, init, _ = engines("tied_pp2")
        sp = comp.split_params(params_from_jax(init))
        if counted:
            (grads, m), cost = jit_cost_summary(comp.forward_backward,
                                                (sp, batch(0)))
            assert cost["flops"] > 0
        else:
            grads, m = comp.forward_backward(sp, batch(0))
        runs.append(([g.clone() for g in grads], m["grad_norm"]))
    (g0, n0), (g1, n1) = runs
    assert torch.equal(n0, n1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _plan(tmp_path, **kw):
    plan = {"pp_deg": 2, "tp_sizes_enc": "1,1,1,1",
            "tp_consecutive_flags": "1,1,1,1", "dp_types_enc": "0,0,0,0",
            "use_sp": "0,0,0,0", "cp_sizes_enc": "1,1,1,1",
            "checkpoint": "0,0,0,0", "global_bsz": 16, "chunks": 4,
            "pp_division": "2,2", "pipeline_type": "pipedream_flush",
            "default_dp_type": "ddp", "vtp": 1, "vsp": 0, "embed_sdp": 0}
    plan.update(kw)
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    return str(path)


T5 = dict(model_type="t5", hidden_size=32, num_hidden_layers=2,
          num_encoder_layers=2, num_attention_heads=2, vocab_size=64,
          max_position_embeddings=32, seq_length=16, hidden_act="gelu",
          normalization="rmsnorm", position_embedding_type="rope",
          tie_word_embeddings=True, make_vocab_size_divisible_by=1)
MOE = dict(CFG, model_type="moe", num_experts=4, moe_topk=2)
INELIGIBLE = {
    "vpp": (CFG, dict(virtual_pp_deg=2), None),
    "gpipe": (CFG, dict(pipeline_type="gpipe"), None),
    "t5": (T5, {}, None),
    "moe": (MOE, {}, None),
    "uneven": (dict(CFG, num_hidden_layers=5), {}, None),
    "mixed": (CFG, "json", None),
    "packed": (CFG, {}, {"reset_position_ids": True}),
}


@pytest.mark.parametrize("case", list(INELIGIBLE))
def test_torch_compiled_refuses_ineligible_plans_with_jax_reasons(
        case, tmp_path):
    """Every plan the compiled schedule cannot express gives JAX's
    reason, word for word; building the engine for it raises."""
    model, over, data = INELIGIBLE[case]
    pkw = dict(pp_deg=2, chunks=4)
    if over == "json":
        path = _plan(tmp_path, checkpoint="1,0,0,0")
        over = dict(config_mode="json", galvatron_config_path=path)
    pkw.update(over)
    jargs, jhpc = jax_hpc(model, pkw, data)
    want = JC.CompiledPipelineEngine.unsupported_reason(
        JModelArgs(**model), jhpc, data=jargs.data)
    args, hpc = port_args(model, pkw)
    for k, v in (data or {}).items():
        setattr(args.data, k, v)
    got = CompiledPipelineEngine.unsupported_reason(args.model, hpc,
                                                    data=args.data)
    assert want and got == want
    if data is None:  # the data fields reach the launcher's check alone
        with pytest.raises(ValueError, match="unsupported"):
            CompiledPipelineEngine(args.model, hpc, args.train, [CPU] * 2)


def test_torch_compiled_refuses_what_one_card_cannot_run():
    """On a CUDA device a dropout plan is refused by name (a captured
    graph would repeat its masks); lanes on several devices are refused;
    the CPU runs both the eligible plan and its dropout variant."""
    model = dict(CFG, hidden_dropout=0.1)
    args, hpc = port_args(model, dict(pp_deg=2, chunks=4))
    cuda = torch.device("cuda", 0)
    assert CompiledPipelineEngine.unsupported_reason(
        args.model, hpc, device=cuda) == DROPOUT_REASON
    assert CompiledPipelineEngine.unsupported_reason(
        args.model, hpc, device=CPU) is None
    with pytest.raises(NotImplementedError, match="dropout under the"):
        CompiledPipelineEngine(args.model, hpc, args.train, [cuda] * 2)
    with pytest.raises(NotImplementedError, match="item 12c"):
        CompiledPipelineEngine(args.model, hpc, args.train,
                               [CPU, torch.device("meta")])
    with pytest.raises(NotImplementedError, match="does not thread"):
        comp, _, init, _ = engines("tied_pp2")
        sp = comp.split_params(params_from_jax(init))
        comp.train_step(sp, comp.init_opt(sp), dict(
            batch(0), position_ids=np.zeros((16, 8), np.int32)))
