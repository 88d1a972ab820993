"""The port's ``cli/serve.py`` and ``cli/generate.py`` with ``device=cpu``
on a tiny GPT-2 (learned positions, tied head) cut from
``gpt2-small.yaml``: streams equal the engine's and the offline
``generate`` 's on the same weights, a checkpoint loads, ``watch=``
hot-swaps a newly committed checkpoint, the metrics stream renders with
``--timeline``, and what the port does not run raises by name (``hf_path=``,
a Hugging Face tokenizer, degree overrides, MoE and BERT in ``generate``,
no card without ``device=cpu``).
"""

import dataclasses
import io
import json
import os
import time

import pytest
import torch

from hetu_galvatron_tpu_torch.cli import generate as GEN
from hetu_galvatron_tpu_torch.cli import preprocess_data as PRE
from hetu_galvatron_tpu_torch.cli import serve as SERVE
from hetu_galvatron_tpu_torch.cli import summarize as TSUM
from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.models import generate as TG
from hetu_galvatron_tpu_torch.observability.registry import MetricsRegistry
from hetu_galvatron_tpu_torch.runtime.checkpoint import save_checkpoint
from hetu_galvatron_tpu_torch.serving.engine import ServingEngine

GPT2_YAML = os.path.join(os.path.dirname(__file__), "..",
                         "hetu_galvatron_tpu", "models", "configs",
                         "gpt2-small.yaml")
TINY = [GPT2_YAML, "model.hidden_size=32", "model.num_hidden_layers=2",
        "model.num_attention_heads=2", "model.vocab_size=300",
        "model.max_position_embeddings=64", "model.seq_length=16",
        "model.make_vocab_size_divisible_by=1", "device=cpu"]
SERVING = ["serving.max_batch_size=2", "serving.kv_block_size=8",
           "serving.max_seq_len=48"]


def _cfg():
    return args_from_cli(TINY, mode="train_dist")


def _engine_streams(params, prompts, max_new):
    args = _cfg()
    sv = dataclasses.replace(args.serving, max_batch_size=2, kv_block_size=8,
                             max_seq_len=48, eos_id=256)
    eng = ServingEngine(params, args.model, sv, registry=MetricsRegistry())
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_idle()
    eng.close()
    out = []
    for h in hs:
        toks = h.result(0)
        out.append(toks[: toks.index(256)] if 256 in toks else toks)
    return out


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_torch_byte_tokenizer_matches_jax_and_refuses_hf():
    from hetu_galvatron_tpu.cli import preprocess_data as JPRE

    tok, jtok = PRE.make_tokenizer(None), JPRE.make_tokenizer("byte")
    assert (tok.vocab_size, tok.eod_id) == (jtok.vocab_size, jtok.eod_id)
    for text in ("héllo", "", "a\x00b \u2603"):
        ids = tok.encode(text)
        assert ids == jtok.encode(text)
        assert tok.decode(ids + [256]) == jtok.decode(ids + [256]) == text
    with pytest.raises(NotImplementedError, match="transformers"):
        PRE.make_tokenizer("gpt2")


def test_torch_cli_generate_on_the_cpu(capsys):
    assert GEN.main(TINY + ["prompt=hello", "max_new_tokens=6"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    cfg = _cfg().model
    params = TB.init_causal_lm(cfg, seed=0)
    out = TG.generate(params, torch.tensor([list(b"hello")]), cfg, 6,
                      eos_id=256)[0, 5:].tolist()
    out = out[: out.index(256)] if 256 in out else out
    assert line == "hello" + PRE.ByteTokenizer().decode(out)
    assert GEN.main(TINY) == 2  # no prompt: usage


def test_torch_cli_serve_requests_metrics_and_timelines(tmp_path, capsys):
    prompts = ["the cat", "a", "serving engines batch requests"]
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text("".join(json.dumps(
        {"prompt": p, "max_new_tokens": 5, "arrival_offset_s": 0.01 * i})
        + "\n" for i, p in enumerate(prompts)))
    metrics = tmp_path / "m.jsonl"
    assert SERVE.main(TINY + SERVING + [
        f"requests={reqs}", f"metrics={metrics}", "stream=1",
        "serving.trace_requests=1"]) == 0
    lines = _lines(capsys.readouterr().out)
    done = [r for r in lines if r["event"] == "done"]
    assert [r["rid"] for r in done] == [0, 1, 2]
    assert all(r["status"] == "done" for r in done)
    params = TB.init_causal_lm(_cfg().model, seed=0)
    want = _engine_streams(params, [list(p.encode()) for p in prompts], 5)
    assert [r["tokens"] for r in done] == want
    tokens = [r for r in lines if r["event"] == "token"]
    assert len(tokens) == sum(r["n_tokens"] for r in done)
    buf = io.StringIO()
    head = TSUM.summarize(str(metrics), out=buf, timeline="all")
    assert head["timelines_complete"] == head["requests_traced"] == 3
    assert head["serve/requests_completed"] == 3


def test_torch_cli_serve_loads_and_watches_checkpoints(tmp_path, capsys):
    cfg = _cfg().model
    root = str(tmp_path / "ck")
    first = TB.init_causal_lm(cfg, seed=7)
    save_checkpoint(root, 1, first)
    assert SERVE.main(TINY + SERVING + [f"ckpt={root}", "prompt=the cat",
                                        "max_new_tokens=4", "stream=0",
                                        f"metrics={tmp_path / 'a.jsonl'}"]) \
        == 0
    done = _lines(capsys.readouterr().out)[-1]
    assert done["tokens"] == _engine_streams(first, [list(b"the cat")], 4)[0]

    # watch: a newly committed step swaps into the live engine
    args = _cfg()
    sv = dataclasses.replace(args.serving, max_batch_size=2, kv_block_size=8,
                             max_seq_len=48, eos_id=256)
    eng = ServingEngine(first, cfg, sv, registry=MetricsRegistry())
    watcher = SERVE._Watcher(root, 0.02, eng, cfg, torch.device("cpu"), 1)
    watcher.start()
    second = TB.init_causal_lm(cfg, seed=8)
    save_checkpoint(root, 2, second)
    deadline = time.monotonic() + 30
    while eng.registry.counter("serve/weight_swaps").value < 1:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    watcher.stop()
    assert watcher.step == 2
    h = eng.submit(list(b"the cat"), max_new_tokens=4)
    eng.run_until_idle()
    got = h.result(0)
    got = got[: got.index(256)] if 256 in got else got
    assert got == _engine_streams(second, [list(b"the cat")], 4)[0]
    eng.close()
    err = capsys.readouterr().err
    assert "weight swap: step 1 -> 2" in err


def test_torch_cli_serve_model_draft(tmp_path, capsys):
    draft = tmp_path / "draft.yaml"
    draft.write_text("model:\n  model_type: gpt\n  hidden_size: 16\n"
                     "  num_hidden_layers: 1\n  num_attention_heads: 2\n"
                     "  vocab_size: 300\n  max_position_embeddings: 64\n"
                     "  seq_length: 16\n  make_vocab_size_divisible_by: 1\n")
    base = TINY + SERVING + ["prompt=the the the the", "max_new_tokens=6",
                             "stream=0", f"metrics={tmp_path / 'm.jsonl'}"]
    assert SERVE.main(base) == 0
    plain = _lines(capsys.readouterr().out)[-1]["tokens"]
    assert SERVE.main(base + ["serving.spec_decode=1",
                              "serving.spec_draft=model",
                              f"draft_model={draft}"]) == 0
    assert _lines(capsys.readouterr().out)[-1]["tokens"] == plain
    with pytest.raises(ValueError, match="draft_model"):
        SERVE.main(base + ["serving.spec_decode=1",
                           "serving.spec_draft=model"])


@pytest.mark.parametrize("main", [GEN.main, SERVE.main],
                         ids=["generate", "serve"])
def test_torch_cli_refusals_by_name(main, tmp_path):
    base = TINY + ["prompt=hi", "max_new_tokens=2"]
    if main is SERVE.main:
        base.append(f"metrics={tmp_path / 'm.jsonl'}")
    with pytest.raises(NotImplementedError, match="hf_path"):
        main(base + ["hf_path=/nowhere"])
    with pytest.raises(NotImplementedError, match="transformers"):
        main(base + ["tokenizer=gpt2"])
    with pytest.raises(NotImplementedError, match="global_tp_deg"):
        main(base + ["parallel.global_tp_deg=2"])
    with pytest.raises(NotImplementedError, match="dense layers only"):
        main(base + ["model.num_experts=2", "model.moe_topk=1"])
    with pytest.raises(NotImplementedError, match="post-norm|bert"):
        main(base + ["model.model_type=bert", "model.norm_position=post"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            main([a for a in base if a != "device=cpu"])
