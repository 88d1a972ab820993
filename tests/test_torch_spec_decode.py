"""The port's speculative-decoding drafts (``serving/spec_decode.py``)
against the JAX package on the CPU: the n-gram draft's proposals, the
acceptance rule and the draft dispatch are host logic, held exactly; the
model draft's greedy proposals equal JAX's ``ModelDraft`` over the same
weights (fp32), and an engine drafting with it still emits the plain
greedy streams.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.core.args_schema import ServingArgs as JServingArgs
from hetu_galvatron_tpu.serving import spec_decode as JSD
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, ServingArgs
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.runtime.checkpoint import params_to_jax
from hetu_galvatron_tpu_torch.serving import engine as TE
from hetu_galvatron_tpu_torch.serving import spec_decode as TSD

DRAFT = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
             vocab_size=64, max_position_embeddings=64, seq_length=16,
             hidden_act="swiglu", normalization="rmsnorm",
             position_embedding_type="rope", tie_word_embeddings=False,
             add_bias_linear=False, make_vocab_size_divisible_by=1,
             ffn_hidden_size=64)
TARGET = dict(DRAFT, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, ffn_hidden_size=128)


@pytest.mark.parametrize("n_range", [(3, 1), (2, 2), (4, 1)])
def test_torch_ngram_draft_matches_jax(n_range):
    mx, mn = n_range
    t, j = TSD.NgramDraft(mx, mn), JSD.NgramDraft(mx, mn)
    rng = np.random.default_rng(mx * 10 + mn)
    hits = 0
    for _ in range(300):
        ctx = rng.integers(0, 6, int(rng.integers(0, 30))).tolist()
        k = int(rng.integers(0, 6))
        got = t.propose(ctx, k)
        assert got == j.propose(ctx, k)
        hits += bool(got)
    assert hits > 50  # the lookup hit often enough to matter
    assert t.propose([1, 2, 3, 4, 5, 1, 2, 3], 2) == [4, 5]
    assert t.propose([7, 9, 7, 8, 7], 2) == ([8, 7] if mn == 1 else [])
    with pytest.raises(ValueError, match="bad ngram range"):
        TSD.NgramDraft(1, 2)


def test_torch_accept_length_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(500):
        d = rng.integers(0, 3, int(rng.integers(0, 6))).tolist()
        tg = rng.integers(0, 3, 6).tolist()
        k = int(rng.integers(0, 6))
        assert TSD.accept_length(d, tg, k) == JSD.accept_length(d, tg, k)
    assert TSD.accept_length([4, 5, 6], [4, 5, 9, 1], 3) == 2
    assert TSD.accept_length([4, 5, 6], [4, 5, 6, 1], 1) == 1


def test_torch_make_draft_dispatch():
    assert TSD.make_draft(ServingArgs()) is None
    d = TSD.make_draft(ServingArgs(spec_decode=True, spec_ngram_max=2))
    jd = JSD.make_draft(JServingArgs(spec_decode=True, spec_ngram_max=2))
    assert isinstance(d, TSD.NgramDraft) and (d.max_n, d.min_n) == \
        (jd.max_n, jd.min_n)
    assert isinstance(d, TSD.DraftProvider)
    with pytest.raises(ValueError, match="draft_params"):
        TSD.make_draft(ServingArgs(spec_decode=True, spec_draft="model"))
    cfg = ModelArgs(**DRAFT)
    md = TSD.make_draft(ServingArgs(spec_decode=True, spec_draft="model"),
                        draft_params=TB.init_causal_lm(cfg), draft_cfg=cfg)
    assert isinstance(md, TSD.ModelDraft) and md.window == 64


def test_torch_model_draft_matches_jax_and_keeps_streams():
    cfg, jcfg = ModelArgs(**DRAFT), JModelArgs(**DRAFT)
    dparams = TB.init_causal_lm(cfg, seed=3)
    t = TSD.ModelDraft(dparams, cfg, window=16)
    j = JSD.ModelDraft(params_to_jax(dparams), jcfg, window=16,
                       compute_dtype=jnp.float32)
    rng = np.random.default_rng(3)
    for n in (3, 8, 13, 40):
        ctx = rng.integers(0, 64, n).tolist()
        assert t.propose(ctx, 3) == j.propose(ctx, 3)
    assert t.propose([], 3) == [] and t.propose([1, 2], 0) == []
    # a model-drafted engine emits the plain greedy streams
    tcfg = ModelArgs(**TARGET)
    params = TB.init_causal_lm(tcfg, seed=4)
    reqs = [rng.integers(0, 64, n).tolist() for n in (5, 11, 2)]
    outs = []
    for spec in (False, True):
        sv = ServingArgs(max_batch_size=2, kv_block_size=8, max_seq_len=48,
                         max_new_tokens=10, spec_decode=spec, spec_k=3,
                         spec_draft="model")
        eng = TE.ServingEngine(params, tcfg, sv, compute_dtype=torch.float32,
                               draft_params=dparams, draft_cfg=cfg)
        hs = [eng.submit(p) for p in reqs]
        eng.run_until_idle()
        outs.append([h.result(0) for h in hs])
    assert outs[0] == outs[1]
