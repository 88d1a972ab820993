"""Text-generation launcher: prompt -> tokens -> KV-cache decode -> text.

Port of ``hetu_galvatron_tpu/cli/generate.py``, on one device::

    python -m hetu_galvatron_tpu_torch.cli.generate <model.yaml> \
        prompt="once upon a time" [max_new_tokens=64] [temperature=0.8] \
        [top_k=40] [tokenizer=byte] [ckpt=<checkpoint root or step dir>] \
        [seed=0] [device=cpu] [model.* overrides]

Weights come from a checkpoint of this package (``ckpt=``) or a random
init from ``seed`` (smoke mode). A t5 config decodes through
``generate_encdec`` with the prompt as the encoder source. It runs on the
CUDA device unless ``device=cpu`` is given, and raises without a card.

Refused by name: ``hf_path=`` (Hugging Face weights), a tokenizer other
than ``byte`` (``cli/preprocess_data.make_tokenizer``), degree overrides
that ask for several devices (``parallel.global_tp_deg`` and the like),
and MoE or post-norm models (``models/generate``).
"""

from __future__ import annotations

import os
import sys

# parallel.* keys that ask for a plan over several devices
DEGREE_KEYS = ("parallel.global_tp_deg", "parallel.pp_deg",
               "parallel.global_cp_deg", "parallel.global_ep_deg",
               "parallel.vocab_tp", "parallel.vocab_sp",
               "parallel.use_ulysses", "parallel.sdp",
               "parallel.num_devices")


def split_argv(argv, kv_keys):
    """(launcher key=values, config overrides) of a command line."""
    kv, passthrough = {}, []
    for a in argv:
        k = a.split("=", 1)[0]
        if "=" in a and k in kv_keys:
            kv[k] = a.split("=", 1)[1]
        else:
            passthrough.append(a)
    return kv, passthrough


def check_single_device(kv, passthrough) -> None:
    """Refuse what this package does not serve: HF weights, and plans
    over several devices."""
    if kv.get("hf_path"):
        raise NotImplementedError(
            "hf_path=: loading Hugging Face weights needs `transformers` "
            "and a download, which hetu_galvatron_tpu_torch does not use; "
            "pass ckpt=<a checkpoint of this package> or no weights")
    asked = [a.split("=", 1)[0] for a in passthrough
             if a.split("=", 1)[0] in DEGREE_KEYS]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: decoding under a plan over several "
            "devices (mesh serving) is not ported to "
            "hetu_galvatron_tpu_torch; it decodes on one device")


def load_weights(kv, cfg, device, seed: int, log=None):
    """(params, step) from ``ckpt=`` (a step dir, or the newest committed
    step under a root), else a random init from ``seed`` (step -1)."""
    from hetu_galvatron_tpu_torch.models.builder import init_causal_lm
    from hetu_galvatron_tpu_torch.runtime.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    log = log or (lambda m: print(m, file=sys.stderr))
    params = init_causal_lm(cfg, seed=seed, device=device)
    if not kv.get("ckpt"):
        log("warning: no ckpt given; using RANDOM weights (smoke mode)")
        return params, -1
    ckdir = kv["ckpt"]
    if not os.path.basename(ckdir.rstrip("/")).startswith("step_"):
        found = latest_checkpoint(ckdir)
        if found is None:
            raise FileNotFoundError(
                f"no step_* checkpoint found under {ckdir}")
        ckdir = found
    params, _, step = load_checkpoint(ckdir, params)
    log(f"loaded {ckdir} (step {step})")
    return params, step


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    kv, passthrough = split_argv(
        argv, ("prompt", "max_new_tokens", "temperature", "top_k",
               "tokenizer", "ckpt", "hf_path", "seed"))
    if "prompt" not in kv:
        print("usage: generate <model.yaml> prompt=\"...\" [key=value ...]",
              file=sys.stderr)
        return 2
    check_single_device(kv, passthrough)

    import torch

    from hetu_galvatron_tpu_torch.cli.preprocess_data import make_tokenizer
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.models.generate import (
        cast_for_compute,
        generate,
        generate_encdec,
    )
    from hetu_galvatron_tpu_torch.runtime.initialize import resolve_device

    args = args_from_cli(passthrough, mode="train_dist")
    cfg = args.model
    device = resolve_device(args)
    tok = make_tokenizer(kv.get("tokenizer"))
    if tok.vocab_size > cfg.vocab_size:
        # padded rows hold untrained weights
        raise ValueError(
            f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
            f"{cfg.vocab_size}; pass a matching model config")
    ids = tok.encode(kv["prompt"])
    if not ids:
        raise ValueError("empty prompt after tokenization")
    prompt = torch.tensor([ids], dtype=torch.long, device=device)
    seed = int(kv.get("seed", 0))
    params, _ = load_weights(kv, cfg, device, seed)
    compute_dtype = torch.bfloat16
    params = cast_for_compute(params, compute_dtype)
    n_new = int(kv.get("max_new_tokens", 64))
    gen_kwargs = dict(
        temperature=float(kv.get("temperature", 0.0)),
        top_k=int(kv["top_k"]) if kv.get("top_k") else None,
        eos_id=getattr(tok, "eod_id", None),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
        compute_dtype=compute_dtype)
    eod = getattr(tok, "eod_id", None)
    if cfg.model_type == "t5":
        # seq2seq: the prompt is the encoder source; decode starts from
        # the start token
        out = generate_encdec(params, prompt, cfg, n_new, **gen_kwargs)
        new_ids = out[0, 1:].tolist()
        if eod is not None and eod in new_ids:
            new_ids = new_ids[:new_ids.index(eod)]
        print(tok.decode(new_ids))
        return 0
    out = generate(params, prompt, cfg, n_new, **gen_kwargs)
    new_ids = out[0, prompt.shape[1]:].tolist()
    if eod is not None and eod in new_ids:
        new_ids = new_ids[:new_ids.index(eod)]
    print(kv["prompt"] + tok.decode(new_ids))
    return 0


if __name__ == "__main__":
    sys.exit(main())
