"""A seeded packed-pretraining corpus, for smoke runs and step measurements.

:func:`write_random_corpus` writes an indexed corpus of random documents
with the port's writer, in the vocabulary of a shipped config's tokenizer
(:func:`corpus_tokenizer`); :func:`packed_corpus_overrides` gives the config
overrides that train on it with packed documents (reset position ids and
attention mask) and end-of-document loss masking.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from hetu_galvatron_tpu_torch.data.indexed_dataset import write_indexed_dataset

# tokenizers of the shipped configs: padded vocabulary, end-of-document id,
# tokenizer length and the [lo, hi) range of ordinary token ids
TOKENIZERS: Dict[str, Dict[str, Any]] = {
    # Qwen2.5: <|endoftext|>; ids from it upwards are special tokens
    "qwen2.5": dict(vocab=152064, eod=151643, tokenizer_vocab=151665,
                    ids=(0, 151643)),
    # Mistral / Mixtral: 0 <unk>, 1 <s>, 2 </s>
    "mistral": dict(vocab=32000, eod=2, tokenizer_vocab=32000,
                    ids=(3, 32000)),
    # Llama 3: 128000 ordinary ids, then 256 special tokens;
    # <|end_of_text|> is 128001
    "llama3": dict(vocab=128256, eod=128001, tokenizer_vocab=128256,
                   ids=(0, 128000)),
}


def corpus_tokenizer(model_name: str) -> Dict[str, Any]:
    """The ``TOKENIZERS`` entry of a config's ``model_name`` (Mixtral's is
    Mistral's, Llama 3.1's Llama 3's); raises for a model without one."""
    for prefix, family in (("qwen2.5", "qwen2.5"), ("mistral", "mistral"),
                           ("mixtral", "mistral"), ("llama3", "llama3")):
        if model_name.startswith(prefix):
            return dict(TOKENIZERS[family])
    raise ValueError(f"no tokenizer is known for model {model_name!r} "
                     f"(known: {sorted(TOKENIZERS)})")


def write_random_corpus(prefix: str, *, docs: int, mean_len: float,
                        vocab: int, eod: int, tokenizer_vocab: int,
                        seed: int = 0, ids: Optional[Tuple[int, int]] = None
                        ) -> Dict[str, int]:
    """``docs`` documents with log-normal lengths around ``mean_len``
    clipped to [16, 16384], token ids uniform in ``ids`` = [lo, hi) (by
    default [0, min(eod, vocab))), each ending in ``eod``, as int32 tokens;
    plus the ``.meta.json`` sidecar the loader reads the eod id and the
    tokenizer's vocabulary from. Returns the writer's counts."""
    lo, hi = ids or (0, min(eod, vocab))
    if not (0 <= lo < hi <= vocab) or lo <= eod < hi:
        raise ValueError(f"token ids [{lo}, {hi}) must lie in [0, {vocab}) "
                         f"and leave out the eod id {eod}")
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(rng.lognormal(math.log(mean_len), 0.7, docs)),
                   16, 16384).astype(np.int64)
    stats = write_indexed_dataset(prefix, (
        np.append(rng.integers(lo, hi, n - 1), eod)
        for n in lens), dtype=np.int32)
    with open(prefix + ".meta.json", "w") as f:
        json.dump({"vocab_size": tokenizer_vocab, "eod_id": eod}, f)
    return stats


def packed_corpus_overrides(prefix: str) -> List[str]:
    """Overrides that train on the corpus at ``prefix`` (split 98/1/1) with
    packed documents and end-of-document loss masking."""
    return ["data.dataset=indexed", f"data.data_path=['{prefix}']",
            "data.split=98,1,1", "data.reset_position_ids=true",
            "data.reset_attention_mask=true", "data.eod_mask_loss=true"]
