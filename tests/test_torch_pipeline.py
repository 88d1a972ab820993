"""The port's pipeline engine (``runtime/pipeline.py``) against the JAX
package's, at one rank a stage.

The oracle is JAX's ``PipelineEngine`` on ``jax.devices()[:pp]`` (the
conftest's virtual CPU devices) at world = pp, in fp32, with the same
weights (``params_from_jax``) and the same seeded numpy batch; the port's
stages all sit on the CPU. Tolerances are JAX's own for its pipeline
against one device (``tests/core/test_pipeline.py``): loss within 2e-5,
every parameter after one step within rtol 5e-4 / atol 3e-4; the grad
norm within 1e-5 relative. Each JAX run is made once per module and
shared by the tests that read it.

Port-only: the pipeline against the port's pp=1 trainer, dropout (the
recompute draws the forward's masks, two runs from one generator repeat)
and the refusals by name.
"""

import copy
import dataclasses
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
from hetu_galvatron_tpu.runtime import hybrid_config as JH
from hetu_galvatron_tpu.runtime import pipeline as JP
from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, ModelArgs
from hetu_galvatron_tpu_torch.core.args_schema import TrainArgs
from hetu_galvatron_tpu_torch.models.builder import (
    init_causal_lm,
    named_leaves,
)
from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH
from hetu_galvatron_tpu_torch.runtime import trainer as TT
from hetu_galvatron_tpu_torch.runtime.checkpoint import (
    params_from_jax,
    params_to_jax,
)
from hetu_galvatron_tpu_torch.runtime.dataloader import packed_doc_fields
from hetu_galvatron_tpu_torch.runtime.optimizer import make_optimizer
from hetu_galvatron_tpu_torch.runtime.pipeline import PipelineEngine

CPU = torch.device("cpu")
DENSE = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
             vocab_size=128, max_position_embeddings=64, seq_length=16,
             hidden_act="swiglu", normalization="rmsnorm",
             position_embedding_type="rope", tie_word_embeddings=False,
             add_bias_linear=False, add_qkv_bias=False,
             make_vocab_size_divisible_by=1, ffn_hidden_size=128)
TIED = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=32, seq_length=16,
            tie_word_embeddings=True, make_vocab_size_divisible_by=1)
MOE = dict(model_type="moe", hidden_size=32, num_hidden_layers=4,
           num_attention_heads=2, vocab_size=64, max_position_embeddings=32,
           seq_length=16, hidden_act="swiglu", normalization="rmsnorm",
           position_embedding_type="rope", tie_word_embeddings=False,
           add_bias_linear=False, add_qkv_bias=False,
           make_vocab_size_divisible_by=1, ffn_hidden_size=48,
           num_experts=4, moe_topk=2, moe_aux_loss_coeff=1e-2,
           moe_z_loss_coeff=1e-3)
T5 = dict(model_type="t5", hidden_size=32, num_hidden_layers=2,
          num_encoder_layers=3, num_attention_heads=2, vocab_size=64,
          max_position_embeddings=32, seq_length=16, hidden_act="gelu",
          normalization="rmsnorm", position_embedding_type="rope",
          tie_word_embeddings=True, add_bias_linear=False,
          add_qkv_bias=False, make_vocab_size_divisible_by=1)
TRAIN = dict(lr=1e-2, clip_grad=1.0, weight_decay=0.01,
             lr_decay_style="constant", lr_warmup_iters=0)
EOD = 7


def lm_batch(bsz, seq, vocab, seed=0, packed=False):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, vocab, (bsz, seq + 1)).astype(np.int32)
    if packed:
        tok[:, 5] = EOD  # several documents a row
        tok[:, 11] = EOD
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "loss_mask": (rs.rand(bsz, seq) > 0.15).astype(np.float32)}
    if packed:
        batch["loss_mask"] = (tok[:, 1:] != EOD).astype(np.float32)
        batch.update(packed_doc_fields(batch["tokens"], EOD,
                                       reset_position_ids=True,
                                       reset_attention_mask=True))
    return batch


def t5_batch(seed=0):
    rs = np.random.RandomState(seed)
    return {"enc_tokens": rs.randint(0, 64, (16, 8)).astype(np.int32),
            "tokens": rs.randint(0, 64, (16, 6)).astype(np.int32),
            "labels": rs.randint(0, 64, (16, 6)).astype(np.int32)}


# name -> (model, parallel settings, batch); every case at world = pp
CASES = {
    "pp2_gpipe_c2": (DENSE, dict(pp_deg=2, pipeline_type="gpipe",
                                 chunks=2), lambda: lm_batch(16, 16, 128)),
    "pp2_1f1b_c4": (DENSE, dict(pp_deg=2, pipeline_type="pipedream_flush",
                                chunks=4), lambda: lm_batch(16, 16, 128)),
    "pp4_gpipe_c4": (DENSE, dict(pp_deg=4, pipeline_type="gpipe",
                                 chunks=4), lambda: lm_batch(16, 16, 128)),
    "pp4_1f1b_c2": (DENSE, dict(pp_deg=4, pipeline_type="pipedream_flush",
                                chunks=2), lambda: lm_batch(16, 16, 128)),
    "uneven_2_3": (dict(DENSE, num_hidden_layers=5),
                   dict(pp_deg=2, chunks=2), lambda: lm_batch(8, 16, 128)),
    "vpp2_gpipe": (DENSE, dict(pp_deg=2, virtual_pp_deg=2, chunks=4,
                               pipeline_type="gpipe"),
                   lambda: lm_batch(16, 16, 128)),
    "vpp2_1f1b": (DENSE, dict(pp_deg=2, virtual_pp_deg=2, chunks=4,
                              pipeline_type="pipedream_flush"),
                  lambda: lm_batch(16, 16, 128)),
    "tied": (TIED, dict(pp_deg=2, chunks=2), lambda: lm_batch(8, 16, 128)),
    "moe_aux": (MOE, dict(pp_deg=2, chunks=2),
                lambda: lm_batch(8, 16, 64)),
    "packed_1f1b": (dict(DENSE, vocab_size=64, max_position_embeddings=32),
                    dict(pp_deg=2, chunks=2,
                         pipeline_type="pipedream_flush"),
                    lambda: lm_batch(8, 16, 40, seed=3, packed=True)),
    "t5_pp4_1f1b": (T5, dict(pp_deg=4, pipeline_type="pipedream_flush",
                             chunks=4), t5_batch),
    "t5_vpp2": (T5, dict(pp_deg=2, virtual_pp_deg=2, chunks=4,
                         pipeline_type="pipedream_flush"), t5_batch),
}
EVAL_CASES = ("pp4_gpipe_c4", "t5_pp4_1f1b", "packed_1f1b")
_JAX_RUNS = {}
_WEIGHTS = {}


def _parallel(obj, pkw):
    for k, v in pkw.items():
        setattr(obj, k, v)
    obj.global_train_batch_size = pkw.get("global_train_batch_size", 16)


def weights(model):
    """The port's seeded weights in the JAX tree (numpy), and JAX's logical
    axes of that tree, traced without running JAX's init."""
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


def jax_run(name):
    """JAX's engine, one step on the case (with an eval before it for the
    cases of ``EVAL_CASES``); cached per module. Returns the initial numpy
    weights, the eval loss, the step's metrics and the merged numpy
    weights after the step."""
    if name in _JAX_RUNS:
        return _JAX_RUNS[name]
    model, pkw, make = CASES[name]
    batch = make()
    cfg = JModelArgs(**model)
    params, axes = weights(model)
    args = JCoreArgs(model=cfg.model_dump(),
                     train=JTrainArgs(**TRAIN).model_dump())
    _parallel(args.parallel, dict(pkw, global_train_batch_size=len(
        batch["tokens"])))
    pp = pkw["pp_deg"]
    hpc = JH.get_hybrid_parallel_config(args, pp)
    eng = JP.PipelineEngine(cfg, hpc, args.train,
                            devices=jax.devices()[:pp],
                            compute_dtype=jnp.float32)
    sp = eng.split_params(params, axes)
    so = eng.init_opt(sp, axes)
    ev = (eng.eval_step(sp, batch)["loss"] if name in EVAL_CASES
          else None)
    new_sp, _, metrics = eng.train_step(sp, so, batch)
    out = (params, ev, metrics,
           jax.tree.map(np.asarray, jax.device_get(eng.merge_params(new_sp))))
    _JAX_RUNS[name] = out
    return out


def port_engine(name, **over):
    model, pkw, make = CASES[name]
    batch = make()
    args = CoreArgs(device="cpu", model=ModelArgs(**model),
                    train=TrainArgs(**TRAIN))
    pkw = dict(pkw, **over)
    _parallel(args.parallel, dict(pkw, global_train_batch_size=len(
        batch["tokens"])))
    args.parallel.num_devices = pkw["pp_deg"]
    hpc = TH.get_hybrid_parallel_config(args, pkw["pp_deg"])
    eng = PipelineEngine(args.model, hpc, args.train,
                         [CPU] * pkw["pp_deg"], compute_dtype=torch.float32)
    return eng, batch, args


def assert_params_close(got, want_np, rtol=5e-4, atol=3e-4):
    want = dict(named_leaves(params_from_jax(want_np)))
    got = dict(named_leaves(got))
    assert sorted(got) == sorted(want)
    for n, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[n].detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=n)


@pytest.mark.parametrize("name", list(CASES))
def test_torch_pipeline_step_matches_jax(name):
    """One step of each schedule and layout: loss, grad norm and every
    parameter (merged from the stages) against JAX's engine."""
    init, _, jm, jnew = jax_run(name)
    eng, batch, _ = port_engine(name)
    sp = eng.split_params(params_from_jax(init))
    so = eng.init_opt(sp)
    _, _, m = eng.train_step(sp, so, batch)
    assert abs(m["loss"] - jm["loss"]) < 2e-5, (m, jm)
    assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    assert_params_close(eng.merge_params(sp), jnew)
    if eng.cfg.tie_word_embeddings:
        # both tied copies got the summed gradient and the same update
        wte = sp[0]["embed"]["wte"].detach()
        whead = sp[-1]["head"]["whead"].detach()
        torch.testing.assert_close(wte, whead.t(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", EVAL_CASES)
def test_torch_pipeline_eval_step_matches_jax(name):
    init, jev, _, _ = jax_run(name)
    eng, batch, _ = port_engine(name)
    sp = eng.split_params(params_from_jax(init))
    assert abs(eng.eval_step(sp, batch)["loss"] - jev) < 2e-5


def test_torch_pipeline_ramp_override_matches_jax_and_the_plan():
    """``num_microbatches`` (the batch-size ramp) on a chunks=2 plan runs
    as a plan of 4 chunks: bit for bit as the port's, and as JAX's within
    its tolerance."""
    init, _, jm, jnew = jax_run("pp2_1f1b_c4")
    out = []
    for chunks, nmb in ((2, 4), (4, None)):
        eng, batch, _ = port_engine("pp2_1f1b_c4", chunks=chunks)
        sp = eng.split_params(params_from_jax(init))
        _, _, m = eng.train_step(sp, eng.init_opt(sp), batch,
                                 num_microbatches=nmb)
        out.append((m, eng.merge_params(sp)))
    (m, merged), (m4, merged4) = out
    assert abs(m["loss"] - jm["loss"]) < 2e-5
    assert_params_close(merged, jnew)
    assert m == m4
    for (n, a), (_, b) in zip(named_leaves(merged), named_leaves(merged4)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("name", ["pp2_1f1b_c4", "vpp2_gpipe", "tied",
                                  "moe_aux"])
def test_torch_pipeline_matches_the_pp1_trainer(name):
    """The port against itself: the pipeline's step equals the pp=1
    trainer's with the same microbatches (the clip formulas differ in
    their last bits, so the parameters within JAX's tolerance)."""
    init = weights(CASES[name][0])[0]
    eng, batch, args = port_engine(name)
    sp = eng.split_params(params_from_jax(init))
    _, _, m = eng.train_step(sp, eng.init_opt(sp), batch)
    ref = params_from_jax(init)
    tx = make_optimizer(args.train)
    step = TT.make_train_step(
        TT.make_loss_fn(args.model, compute_dtype=torch.float32), tx,
        chunks=eng.hpc.chunks)
    names, leaves = zip(*named_leaves(ref))
    _, _, rm = step(ref, tx.init(list(leaves), list(names)),
                    TT.to_device(batch, CPU))
    assert abs(m["loss"] - float(rm["loss"])) < 2e-5
    assert m["grad_norm"] == pytest.approx(float(rm["grad_norm"]), rel=1e-5)
    got, want = dict(named_leaves(eng.merge_params(sp))), dict(
        named_leaves(ref))
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=5e-4, atol=3e-4)


def _dropout_engine(name="tied"):
    model, pkw, _ = CASES[name]
    eng, batch, args = port_engine(name)
    cfg = copy.deepcopy(eng.cfg)
    cfg.hidden_dropout = cfg.attention_dropout = 0.1
    eng = PipelineEngine(cfg, eng.hpc, args.train, [CPU] * pkw["pp_deg"],
                         compute_dtype=torch.float32)
    return eng, batch


def test_torch_pipeline_recompute_draws_the_forward_masks():
    """With dropout on, a stage's recompute in the backward gives the
    forward's output bit for bit (the same per-(microbatch, chunk) seed),
    and another seed gives another output."""
    eng, batch = _dropout_engine()
    sp = eng.split_params(params_from_jax(weights(TIED)[0]))
    mbs, _ = eng._microbatches(batch)
    x = eng._stage0_input(mbs[0])
    pos, seg = eng._extras(mbs[0], 0)
    y = eng._forward(0, sp[0], x, 1234, pos, seg)
    with torch.enable_grad():
        y2, _ = eng._stage_apply(eng.stages[0], sp[0], x, seed=1234)
    assert torch.equal(y, y2.detach())
    assert not torch.equal(y, eng._forward(0, sp[0], x, 99, pos, seg))
    plain = eng._forward(0, sp[0], x, None, pos, seg)
    assert not torch.equal(y, plain)


def test_torch_pipeline_dropout_repeats_from_one_generator():
    init = weights(TIED)[0]
    runs = []
    for seed in (5, 5, 6):
        eng, batch = _dropout_engine()
        sp = eng.split_params(params_from_jax(init))
        b = dict(TT.to_device(batch, CPU),
                 dropout_rng=torch.Generator().manual_seed(seed))
        _, _, m = eng.train_step(sp, eng.init_opt(sp), b)
        runs.append((m, eng.merge_params(sp)))
    assert runs[0][0] == runs[1][0] and runs[0][0] != runs[2][0]
    for (n, a), (_, b) in zip(named_leaves(runs[0][1]),
                              named_leaves(runs[1][1])):
        assert torch.equal(a, b), n
    eng, batch = _dropout_engine()
    sp = eng.split_params(params_from_jax(init))
    with pytest.raises(ValueError, match="dropout_rng"):
        eng.train_step(sp, eng.init_opt(sp), batch)


REFUSALS = {
    "pp1": (dict(pp_deg=1), ValueError, "pp_deg >= 2"),
    "tp2": (dict(global_tp_deg=2), NotImplementedError, "ROADMAP item 12c"),
    # refused where the plan enters, before any engine is built
    "hier_dp": ("hier_dp", NotImplementedError, "ROADMAP item 12d"),
    "world": ("world", NotImplementedError, "world size 4"),
    "batch_key": ("batch_key", NotImplementedError, "mrope_position_ids"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_torch_pipeline_refuses_by_name(case, tmp_path):
    what, exc, text = REFUSALS[case]
    eng, batch, args = port_engine("pp2_gpipe_c2")
    hpc = eng.hpc
    with pytest.raises(exc, match=text):
        if case == "pp1":
            PipelineEngine(eng.cfg, TH.get_hybrid_parallel_config(
                CoreArgs(device="cpu", model=eng.cfg), 1), args.train,
                [CPU])
        elif case == "tp2":
            wide = copy.deepcopy(hpc)
            wide.layers = [TH.LayerStrategy(pp_deg=2, tp_size=2)] * 4
            PipelineEngine(eng.cfg, wide, args.train, [CPU] * 2)
        elif case == "hier_dp":
            n = eng.cfg.num_hidden_layers
            plan = tmp_path / "hier_dp.json"
            plan.write_text(json.dumps({
                "pp_deg": 2, "pp_division": "2,2", "hier_dp": 1,
                "global_bsz": 4, "chunks": 2, **{
                    key: ",".join([value] * n) for key, value in (
                        ("tp_sizes_enc", "1"), ("tp_consecutive_flags", "1"),
                        ("dp_types_enc", "0"), ("use_sp", "0"),
                        ("cp_sizes_enc", "1"), ("checkpoint", "0"))}}))
            TH.get_hybrid_parallel_config(CoreArgs(
                device="cpu", model=eng.cfg, parallel=dataclasses.replace(
                    CoreArgs().parallel, config_mode="json",
                    galvatron_config_path=str(plan))), 2)
        elif case == "world":
            PipelineEngine(eng.cfg, dataclasses.replace(hpc, world_size=4),
                           args.train, [CPU] * 4)
        else:
            sp = eng.split_params(params_from_jax(weights(DENSE)[0]))
            eng.train_step(sp, eng.init_opt(sp), dict(
                batch, mrope_position_ids=np.zeros((3, 16, 16), np.int32)))


def test_torch_pipeline_layout_and_tied_copy():
    """The chunk layout of JAX :190-233 (chunk c on group c % pp, the head
    on the last chunk), and the tied copy: ``whead`` is ``wte.T``, its own
    leaf, dropped by ``merge_params``."""
    eng, _, _ = port_engine("vpp2_1f1b")
    assert [(st.layer_range, st.has_embed, st.has_head)
            for st in eng.stages] == [((0, 1), True, False),
                                      ((1, 2), False, False),
                                      ((2, 3), False, False),
                                      ((3, 4), False, True)]
    eng, _, _ = port_engine("tied")
    init = params_from_jax(weights(TIED)[0])
    sp = eng.split_params(init)
    whead = sp[-1]["head"]["whead"]
    assert whead.requires_grad and torch.equal(whead, init["embed"]["wte"].t())
    assert sp[0]["embed"]["wte"] is init["embed"]["wte"]
    assert "whead" not in eng.merge_params(sp)["head"]
    eng, _, _ = port_engine("t5_pp4_1f1b")
    assert [(st.enc_layer_range, st.layer_range, st.has_enc_norm)
            for st in eng.stages] == [((0, 1), (0, 0), False),
                                      ((1, 2), (0, 0), False),
                                      ((2, 3), (0, 0), True),
                                      ((3, 3), (0, 2), False)]


@pytest.mark.parametrize("name,over,want", [
    # (2 L - L_head + C) K1 a microbatch, L each of K2 and K3; 4 of them
    ("pp4_gpipe_c4", {}, (7, 4)),
    ("vpp2_1f1b", {}, (7, 4)),
    ("pp2_1f1b_c4", {"global_checkpoint": 1}, (10, 4)),
    # 3 encoder layers, 2 decoder layers of two attentions each
    ("t5_pp4_1f1b", {}, (10, 7))])
def test_torch_pipeline_launch_rule(name, over, want, monkeypatch):
    """The flash launches a step of the engine, counted through the
    kernels' plain versions with the flash core forced on the CPU: every
    non-head chunk runs its layers twice (no-grad forward, recompute), the
    head chunk once, a checkpointed layer once more; one K2 and K3 an
    attention."""
    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    counts = {}
    for fn in ("flash_fwd_plain", "flash_bwd_dkdv_plain",
               "flash_bwd_dq_plain"):
        def counted(*a, _f=getattr(TF, fn), _n=fn, **kw):
            counts[_n] = counts.get(_n, 0) + 1
            return _f(*a, **kw)
        monkeypatch.setattr(TF, fn, counted)
    monkeypatch.setattr(PipelineEngine, "_attention", lambda self, dev: dict(
        sdpa_fn=TF.flash_sdpa,
        **({"cross_sdpa_fn": TF.flash_sdpa} if self.is_t5 else {})))
    eng, batch, _ = port_engine(name, **over)
    sp = eng.split_params(params_from_jax(weights(CASES[name][0])[0]))
    eng.train_step(sp, eng.init_opt(sp), batch)
    m = eng.hpc.chunks
    assert counts == {"flash_fwd_plain": want[0] * m,
                      "flash_bwd_dkdv_plain": want[1] * m,
                      "flash_bwd_dq_plain": want[1] * m}
