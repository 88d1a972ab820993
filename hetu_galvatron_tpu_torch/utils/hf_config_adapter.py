"""Model layer descriptions for the profiler and the search engine.

Port of ``hetu_galvatron_tpu/utils/hf_config_adapter.py``'s
``model_layer_configs`` (:151), ``model_name`` (:197) and
``resolve_model_config`` without a Hugging Face path. Reading a Hugging
Face config needs a download and ``transformers``; the port refuses it by
name (``extra.hf_model_path``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, ModelArgs


def resolve_model_config(args: CoreArgs,
                         hf_path: Optional[str] = None) -> CoreArgs:
    """The YAML's model, with ``max_position_embeddings`` raised to
    ``seq_length`` where it is shorter, as the JAX function does."""
    if hf_path or args.extra.get("hf_model_path"):
        raise NotImplementedError(
            "extra.hf_model_path: reading a Hugging Face config needs a "
            "download and transformers; it is not ported")
    if args.model.seq_length > args.model.max_position_embeddings:
        args.model.max_position_embeddings = args.model.seq_length
    return args


def model_layer_configs(model_args: ModelArgs) -> List[Dict[str, Any]]:
    """Per-layertype dicts for the profiler and the search engine. Dense
    models have one layertype; t5 has the encoder then the decoder; MoE
    models split their layers into dense and MoE by ``moe_layer_freq``."""
    base = {
        "hidden_size": model_args.hidden_size,
        "seq_len": model_args.seq_length,
        "num_attention_heads": model_args.num_attention_heads,
        "num_key_value_heads": model_args.kv_heads,
        "ffn_hidden_size": model_args.ffn_dim,
        "vocab_size": model_args.padded_vocab_size,
        "layer_num": model_args.num_hidden_layers,
    }
    if model_args.model_type == "t5":
        # layertype 0 = encoder, 1 = decoder: the seq2seq batches split
        # each sample in half (source | target)
        n_enc = (model_args.num_encoder_layers
                 if model_args.num_encoder_layers is not None
                 else model_args.num_hidden_layers)
        half = model_args.seq_length // 2
        enc = dict(base, seq_len=half, layer_num=n_enc)
        dec = dict(base, seq_len=model_args.seq_length - half,
                   layer_num=model_args.num_hidden_layers)
        return ([enc] if n_enc else []) + [dec]
    if not model_args.num_experts:
        return [base]
    # every moe_layer_freq-th layer is MoE; layer_num is split between the
    # two layertypes, never counted twice
    freq = max(model_args.moe_layer_freq, 1)
    n = model_args.num_hidden_layers
    n_moe = n // freq
    if n_moe == 0:
        return [base]
    moe = dict(base)
    moe.update(
        layer_num=n_moe,
        num_experts=model_args.num_experts,
        moe_topk=model_args.moe_topk,
        moe_ffn_hidden_size=(model_args.moe_ffn_hidden_size
                             or model_args.ffn_dim),
    )
    if n - n_moe == 0:
        return [moe]
    base["layer_num"] = n - n_moe
    return [base, moe]


def model_name(model_args: ModelArgs) -> str:
    return model_args.model_name.replace("/", "_")
