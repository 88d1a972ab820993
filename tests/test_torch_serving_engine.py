"""The port's serving engine (``serving/engine.py``) against the JAX
package on the CPU, fp32, tiny Qwen-style model (rope, GQA 4:2, qkv bias,
SwiGLU, RMSNorm, untied head).

Greedy streams are exact: the port's engine equals JAX's engine and JAX's
offline ``generate`` (``tests/serving/test_engine.py:63`` and ``:82``),
with and without the prefix cache and speculative decoding; prefix-hit
streams equal cold ones and spec-decode streams equal plain ones. The
decode step keeps one input shape through admissions and retirements.
Sampled rows draw from ``torch.Generator`` s (JAX: threefry keys), so they
are held to their own contract: a stream depends on its seed alone, every
token lies in the top-k set, vocab padding is never drawn.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.core.args_schema import ServingArgs as JServingArgs
from hetu_galvatron_tpu.models import generate as JG
from hetu_galvatron_tpu.serving import engine as JE
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, ServingArgs
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import generate as TG
from hetu_galvatron_tpu_torch.observability.registry import MetricsRegistry
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_to_jax
from hetu_galvatron_tpu_torch.serving import engine as TE

SPEC = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, ffn_hidden_size=128, vocab_size=128,
            max_position_embeddings=128, seq_length=32, hidden_act="swiglu",
            normalization="rmsnorm", position_embedding_type="rope",
            tie_word_embeddings=False, add_bias_linear=False,
            add_qkv_bias=True, make_vocab_size_divisible_by=1)
CFG = ModelArgs(**SPEC)
JCFG = JModelArgs(**SPEC)
PLAIN = dict(max_batch_size=4, kv_block_size=8, max_seq_len=48,
             max_new_tokens=8)
REQS = [(3, 4), (9, 8), (13, 6), (1, 8), (16, 5), (7, 8)]


def _params(seed):
    return TB.init_causal_lm(CFG, seed=seed)


def _engine(params, **over):
    sv = ServingArgs(**dict(PLAIN, **over))
    return TE.ServingEngine(params, CFG, sv, compute_dtype=torch.float32)


def _serve(eng, reqs, step_between=False, **kw):
    hs = []
    for p, m in reqs:
        hs.append(eng.submit(p, max_new_tokens=m, **kw))
        if step_between:
            eng.step()
    eng.run_until_idle()
    assert all(h.status == "done" for h in hs)
    return [h.result(0) for h in hs]


def _offline(params, prompt, n_new):
    out = TG.generate(params, torch.tensor([prompt]), CFG, n_new, pad_id=0,
                      compute_dtype=torch.float32)
    return out[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def case():
    """The port's weights, the workloads and the JAX oracles, once."""
    params = _params(0)
    npy = params_to_jax(params)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 128, n).tolist(), m) for n, m in REQS]
    shared = rng.integers(0, 128, 24).tolist()  # 3 full blocks
    prefix_reqs = [(shared + rng.integers(0, 128, 5).tolist(), 8),
                   (shared + rng.integers(0, 128, 9).tolist(), 8),
                   (list(shared), 8)]
    spec_reqs = [(rng.integers(0, 128, n).tolist(), 24)
                 for n in (10, 7, 13, 10)]

    def jax_engine(reqs, step_between=False, **over):
        sv = JServingArgs(**dict(PLAIN, **over))
        eng = JE.ServingEngine(npy, JCFG, sv, compute_dtype=jnp.float32)
        hs = []
        for p, m in reqs:
            hs.append(eng.submit(p, max_new_tokens=m))
            if step_between:
                eng.step()
        eng.run_until_idle()
        return eng, [h.result(0) for h in hs], [h.cached_tokens for h in hs]

    # JAX's offline decode of the ragged batch, left-padded, 8 new tokens
    # (a greedy stream of m tokens is the first m of it)
    s0 = max(len(p) for p, _ in reqs)
    toks = np.zeros((len(reqs), s0), np.int32)
    for b, (p, _) in enumerate(reqs):
        toks[b, s0 - len(p):] = p
    lens = np.asarray([len(p) for p, _ in reqs], np.int32)
    off = np.asarray(jax.jit(lambda pp, t, n: JG.generate(
        pp, t, JCFG, 8, prompt_lens=n, pad_id=0,
        compute_dtype=jnp.float32))(npy, jnp.asarray(toks),
                                    jnp.asarray(lens)))
    offline = [off[b, s0:s0 + m].tolist() for b, (_, m) in enumerate(reqs)]
    _, plain, _ = jax_engine(reqs)
    _, prefix, cached = jax_engine(prefix_reqs, step_between=True,
                                   max_seq_len=64, prefix_cache=True)
    jspec, spec, _ = jax_engine(spec_reqs, max_seq_len=64,
                                max_new_tokens=24, spec_decode=True,
                                spec_k=3)
    return dict(params=params, reqs=reqs, prefix_reqs=prefix_reqs,
                 spec_reqs=spec_reqs, jax_offline=offline, jax_plain=plain,
                 jax_prefix=(prefix, cached), jax_spec=spec,
                 jax_accept=(jspec._drafted_total, jspec._accepted_total))


def test_torch_engine_greedy_streams_match_jax_engine_and_offline(case):
    eng = _engine(case["params"])
    eng.warmup(buckets=[8, 16])
    got = _serve(eng, case["reqs"])
    assert got == case["jax_plain"] == case["jax_offline"]
    for (p, m), out in zip(case["reqs"], got):
        assert out == _offline(case["params"], p, m)
    # admissions and retirements never change the decode step's shapes
    shapes = eng.program_shapes()
    assert shapes["decode"] == {((4,), (4,), (4, 6))}
    assert set(shapes) == {"decode", "prefill_8", "prefill_16"}
    assert eng.kv.allocator.used == 0
    reg = eng.registry
    assert reg.counter("serve/requests_completed").value >= 6
    eng.close()


def test_torch_engine_prefix_hits_match_cold_and_jax(case):
    reg = MetricsRegistry()
    sv = ServingArgs(**dict(PLAIN, max_seq_len=64, prefix_cache=True))
    eng = TE.ServingEngine(case["params"], CFG, sv, registry=reg,
                           compute_dtype=torch.float32)
    hs = []
    for p, m in case["prefix_reqs"]:
        hs.append(eng.submit(p, max_new_tokens=m))
        eng.step()
    eng.run_until_idle()
    want, cached = case["jax_prefix"]
    assert [h.result(0) for h in hs] == want
    assert [h.cached_tokens for h in hs] == cached == [0, 24, 24]
    cold = [_offline(case["params"], p, m) for p, m in case["prefix_reqs"]]
    assert want == cold
    # only the uncached suffixes reached a prefill; the full hit none
    assert reg.counter("serve/prefill_tokens").value == 29 + 9
    assert reg.counter("serve/prefix_hits").value == 2
    assert reg.histogram("serve/ttft_ms").count == 3
    # at idle the allocator holds the tree's pins and nothing else
    assert eng.kv.allocator.used == eng.prefix.blocks_held > 0
    # compaction between requests renames every table; hits stay exact
    eng.defrag()
    p4 = case["prefix_reqs"][0][0][:24] + [5, 6, 7]
    h4 = eng.submit(p4, max_new_tokens=6)
    eng.run_until_idle()
    assert h4.cached_tokens == 24
    assert h4.result(0) == _offline(case["params"], p4, 6)
    eng.close()


def test_torch_engine_prefix_request_retiring_at_its_prefill(case):
    """A one-token budget (or an eos first token) retires the request in
    its prefill step: the tree adopts its blocks first, so nothing is
    released twice (the JAX engine raises BlockAccountingError here)."""
    params = case["params"]
    prompt = list(range(1, 20))
    p2 = prompt[:17] + [3]
    first, first2 = _offline(params, prompt, 1)[0], _offline(params, p2, 1)[0]
    eng = _engine(params, prefix_cache=True)
    h = eng.submit(prompt, max_new_tokens=1)
    eng.step()
    h2 = eng.submit(p2, max_new_tokens=4, eos_id=first2)
    eng.run_until_idle()
    assert h.status == "done" and h.result(0) == [first]
    assert h2.status == "done" and h2.finish_reason == "eos"
    assert h2.cached_tokens == 16 and h2.result(0) == [first2]
    assert eng.kv.allocator.used == eng.prefix.blocks_held == 2
    eng.close()


def test_torch_engine_suffix_bucket_past_the_table_keeps_positions(case):
    """A deep cached prefix plus a power-of-two suffix bucket overshoots
    the table (cached 8 + bucket 16 > 20 positions): the suffix rows keep
    their own rope positions (JAX's dynamic slice clamps its start and
    shifts them), so the first token's logits equal the cold prefill's in
    fp32, 1e-4 * (rms + |want|)."""
    params = case["params"]
    rng = np.random.default_rng(7)
    pre = rng.integers(0, 128, 8).tolist()
    p2 = pre + rng.integers(0, 128, 9).tolist()
    eng = _engine(params, max_batch_size=2, kv_block_size=4, max_seq_len=20,
                  max_new_tokens=3, prefix_cache=True)
    _serve(eng, [(pre + rng.integers(0, 128, 4).tolist(), 3)])
    rows = {}
    eng.logits_hook = lambda rid, i, lg: rows.setdefault(i, lg.clone())
    assert _serve(eng, [(p2, 3)]) == [_offline(params, p2, 3)]
    assert eng.program_shapes().keys() >= {"prefix_prefill_16"}
    want = []
    TG.generate(params, torch.tensor([p2]), CFG, 3,
                compute_dtype=torch.float32,
                on_logits=lambda i, lg: want.append(lg[0].clone()))
    for i in range(3):
        got, w = rows[i].double(), want[i].double()
        lim = 1e-4 * (w.square().mean().sqrt() + w.abs())
        assert ((got - w).abs() <= lim).all(), i


def test_torch_engine_eviction_under_pool_pressure_stays_exact(case):
    """8 usable blocks of 8: each retired request leaves 3 in the tree,
    so the third admission must evict the coldest prefix."""
    eng = _engine(case["params"], max_seq_len=32, num_kv_blocks=9,
                  prefix_cache=True, max_batch_size=2)
    rng = np.random.default_rng(2)
    for _ in range(4):
        p = rng.integers(0, 128, 24).tolist()
        assert _serve(eng, [(p, 8)]) == [_offline(case["params"], p, 8)]
    assert eng.prefix.evicted_blocks > 0
    eng.close()


def test_torch_engine_spec_streams_match_plain_and_jax(case):
    reg = MetricsRegistry()
    sv = ServingArgs(**dict(PLAIN, max_seq_len=64, max_new_tokens=24,
                            spec_decode=True, spec_k=3))
    eng = TE.ServingEngine(case["params"], CFG, sv, registry=reg,
                           compute_dtype=torch.float32)
    eng.warmup(buckets=[8, 16])
    got = _serve(eng, case["spec_reqs"])
    assert got == case["jax_spec"]
    plain = _serve(_engine(case["params"], max_seq_len=64,
                           max_new_tokens=24), case["spec_reqs"])
    assert got == plain
    # the same drafts and the same acceptances as JAX's
    assert (eng._drafted_total, eng._accepted_total) == case["jax_accept"]
    assert eng.spec_accept_rate() > 0.0
    assert reg.counter("serve/spec_accepted_tokens").value > 0
    assert eng.program_shapes()["verify"] == {
        ((4, 4), (4,), (4, 8), (4,))}
    eng.close()


def test_torch_engine_spec_eos_mid_window_and_sampled_lanes(case):
    params = case["params"]
    prompt = np.random.default_rng(3).integers(0, 128, 6).tolist()
    free = _offline(params, prompt, 16)
    eos = free[7]
    want = free[: free.index(eos) + 1]
    eng = _engine(params, max_new_tokens=16, spec_decode=True, spec_k=4,
                  eos_id=eos)
    h = eng.submit(prompt)
    eng.run_until_idle()
    assert h.finish_reason == "eos" and h.result(0) == want
    assert eng.kv.allocator.used == 0
    h1 = eng.submit(prompt, max_new_tokens=1, eos_id=None)
    eng.run_until_idle()
    assert h1.result(0) == free[:1]
    # sampled lanes do not speculate and draw what the plain engine draws
    outs = []
    for spec in (False, True):
        e = _engine(params, max_new_tokens=10, spec_decode=spec, spec_k=3)
        hs = e.submit(prompt, temperature=0.8, seed=13)
        e.run_until_idle()
        outs.append(hs.result(0))
    assert outs[0] == outs[1] and len(set(outs[0])) > 1


def test_torch_engine_eos_retirement_and_recycling(case):
    params = case["params"]
    prompt = np.random.default_rng(1).integers(0, 128, 5).tolist()
    free = _offline(params, prompt, 8)
    eos = free[2]
    want = free[: free.index(eos) + 1]
    eng = _engine(params, max_batch_size=2, max_seq_len=32, eos_id=eos)
    h1 = eng.submit(prompt)
    eng.run_until_idle()
    assert h1.finish_reason == "eos" and h1.result(0) == want
    assert eng.kv.allocator.used == 0
    h2 = eng.submit(prompt, eos_id=None)
    eng.run_until_idle()
    assert h2.finish_reason == "length" and h2.result(0) == free


def test_torch_engine_sampling_contract(case):
    """A sampled stream depends on its own seed and temperature only; with
    top_k every token lies in the top-k set of the logits it was drawn
    from; vocab padding is never drawn even where the head favours it."""
    params = case["params"]
    rng = np.random.default_rng(2)
    probe = rng.integers(0, 128, 6).tolist()
    runs = []
    for neighbours in ([], [rng.integers(0, 128, 4).tolist(),
                            rng.integers(0, 128, 11).tolist()]):
        eng = _engine(params, max_new_tokens=6)
        for i, n in enumerate(neighbours):
            eng.submit(n, temperature=0.9, seed=100 + i)
        h = eng.submit(probe, temperature=0.7, seed=7)
        eng.run_until_idle()
        runs.append(h.result(0))
    assert runs[0] == runs[1] and len(set(runs[0])) > 1
    # top-k, over the logits the engine reports through its debug hook
    eng = _engine(params, max_new_tokens=12, top_k=3)
    seen = []
    eng.logits_hook = lambda rid, i, lg: seen.append(lg.clone())
    h = eng.submit(probe, temperature=1.5, seed=3)
    eng.run_until_idle()
    top = torch.topk(torch.stack(seen), 3, dim=-1).indices
    assert (top == torch.tensor(h.result(0))[:, None]).any(-1).all()
    # padding columns: vocab 100 padded to 128, the head favouring them
    spec = dict(SPEC, vocab_size=100, make_vocab_size_divisible_by=64)
    cfg = ModelArgs(**spec)
    p2 = TB.init_causal_lm(cfg, seed=4)
    with torch.no_grad():
        p2["head"]["whead"][:, 100:] += 5.0
    e2 = TE.ServingEngine(p2, cfg, ServingArgs(**PLAIN),
                          compute_dtype=torch.float32)
    hs = [e2.submit(probe, temperature=t, seed=s, max_new_tokens=8)
          for t, s in ((0.0, 0), (1.0, 1), (2.0, 2))]
    e2.run_until_idle()
    assert all(max(h.result(0)) < 100 for h in hs)


def test_torch_engine_cancellation_timeout_and_rejection(case):
    reg = MetricsRegistry()
    sv = ServingArgs(max_batch_size=2, kv_block_size=8, max_seq_len=32,
                     max_new_tokens=8)
    eng = TE.ServingEngine(case["params"], CFG, sv, registry=reg,
                           compute_dtype=torch.float32)
    prompt = [1, 2, 3]
    assert eng.submit([5] * 40, max_new_tokens=8).status == "rejected"
    h_c = eng.submit(prompt)
    eng.step()
    h_c.cancel()
    eng.step()
    assert h_c.status == "cancelled" and 0 < len(h_c.output) < 8
    h_t = eng.submit(prompt, timeout_s=1e-9)
    eng.step()
    time.sleep(0.005)
    eng.step()
    assert h_t.status == "timeout"
    assert eng.kv.allocator.used == 0
    blockers = [eng.submit(prompt) for _ in range(2)]
    eng.step()
    h_qc = eng.submit(prompt)
    h_qt = eng.submit(prompt, timeout_s=1e-9)
    h_qc.cancel()
    time.sleep(0.005)
    eng.step()
    assert h_qc.status == "cancelled" and h_qc.output == []
    assert h_qt.status == "timeout" and h_qt.output == []
    for name, n in (("rejected", 1), ("cancelled", 2), ("timeout", 2)):
        assert reg.counter(f"serve/requests_{name}").value == n
    eng.run_until_idle()
    assert all(b.status == "done" for b in blockers)


def test_torch_engine_background_thread_and_its_errors(case):
    params = case["params"]
    prompt = [3, 1, 4, 1, 5]
    with _engine(params, max_batch_size=2, max_new_tokens=5) as eng:
        eng.start()
        h = eng.submit(prompt)
        got = list(h.tokens())
        assert h.status == "done" and got == h.result(0)
        assert got == _offline(params, prompt, 5)
        eng.stop()
    eng = _engine(params, max_batch_size=2, max_new_tokens=4)

    def boom(slot, bucket):
        raise RuntimeError("injected prefill failure")

    eng._prefill_slot = boom
    eng.start()
    h = eng.submit([1, 2, 3])
    assert h.result(timeout=30) == []
    assert h.status == "error" and "injected" in h.finish_reason
    assert isinstance(eng.error, RuntimeError)
    late = eng.submit([4, 5])
    assert late.status == "error" and late.done()
    assert eng.registry.counter("serve/errors",
                                error="RuntimeError").value == 1
    eng.close()


def test_torch_engine_swap_weights(case):
    """After a swap the next request streams what a fresh engine on the
    new weights streams; shape or structure drift raises
    ``WeightSwapError`` and the engine keeps serving; the prefix cache is
    dropped at the flip."""
    prompt = list(range(1, 12))
    old, new = case["params"], _params(5)
    eng = _engine(old, prefix_cache=True, max_seq_len=64)
    out_old = _serve(eng, [(prompt, 6)])[0]
    shared = list(range(1, 17))
    _serve(eng, [(shared + [20, 21], 6), (shared + [30, 31], 6)])
    assert eng.prefix.hits >= 1 and eng.prefix.blocks_held > 0
    stall = eng.swap_weights(new)
    assert stall >= 0.0 and eng.prefix.blocks_held == 0
    out_new = _serve(eng, [(prompt, 6), (shared + [30, 31], 6)])
    fresh = _serve(_engine(new, prefix_cache=True, max_seq_len=64),
                   [(prompt, 6), (shared + [30, 31], 6)])
    assert out_new == fresh and out_new[0] != out_old
    assert eng.registry.counter("serve/weight_swaps").value == 1
    assert eng.registry.histogram("serve/swap_stall_ms").count == 1
    bigger = ModelArgs(**dict(SPEC, hidden_size=128, ffn_hidden_size=256))
    with pytest.raises(TE.WeightSwapError, match="shapes"):
        eng.swap_weights(TB.init_causal_lm(bigger))
    missing = _params(6)
    missing["layers"][0]["attn"].pop("wqkv")
    with pytest.raises(TE.WeightSwapError, match="structure"):
        eng.swap_weights(missing)
    assert _serve(eng, [(prompt, 6)]) == [fresh[0]]  # still the new weights
    eng.close()


def test_torch_engine_refusals_and_buckets(case):
    params = case["params"]
    bert = ModelArgs(**dict(SPEC, model_type="bert", norm_position="post"))
    with pytest.raises(NotImplementedError, match="bert/t5"):
        TE.ServingEngine(params, bert)
    moe = dict(params, layers=[dict(lp, moe={}) for lp in params["layers"]])
    with pytest.raises(NotImplementedError, match="dense layers only"):
        TE.ServingEngine(moe, CFG)
    with pytest.raises(NotImplementedError, match="mesh serving"):
        TE.ServingEngine(params, CFG, mesh=object(), hpc=object(),
                         axes_tree={})
    with pytest.raises(ValueError, match="spec_k"):
        _engine(params, spec_decode=True, spec_k=0)
    with pytest.raises(ValueError, match="draft_params"):
        _engine(params, spec_decode=True, spec_draft="model")
    for bs, cap in ((8, 32), (16, 112), (16, 16), (4, 20)):
        assert TE.default_buckets(bs, cap) == JE.default_buckets(bs, cap)


def test_torch_engine_prometheus_endpoint(case):
    reg = MetricsRegistry()
    sv = ServingArgs(**dict(PLAIN, metrics_port=0, slo_ttft_ms=1e6,
                            slo_itl_ms=1e-9))
    eng = TE.ServingEngine(case["params"], CFG, sv, registry=reg,
                           compute_dtype=torch.float32)
    _serve(eng, case["reqs"][:2])
    url = f"http://127.0.0.1:{eng.metrics_port}"
    text = urllib.request.urlopen(url + "/metrics", timeout=10).read()
    text = text.decode()
    assert "serve_ttft_ms" in text and "serve_requests_completed" in text
    health = json.loads(urllib.request.urlopen(url + "/healthz",
                                               timeout=10).read())
    assert health["status"] == "ok" and health["last_step_age_s"] >= 0
    assert reg.gauge("serve/slo_ttft_attainment").value == 1.0
    assert reg.gauge("serve/slo_itl_attainment").value == 0.0
    eng.close()
    assert eng.metrics_server is None
