"""A seeded packed-pretraining corpus, for smoke runs and step measurements.

:func:`write_random_corpus` writes an indexed corpus of random documents
with the port's writer; :func:`packed_corpus_overrides` gives the config
overrides that train on it with packed documents (reset position ids and
attention mask) and end-of-document loss masking.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List

import numpy as np

from hetu_galvatron_tpu_torch.data.indexed_dataset import write_indexed_dataset


def write_random_corpus(prefix: str, *, docs: int, mean_len: float,
                        vocab: int, eod: int, tokenizer_vocab: int,
                        seed: int = 0) -> Dict[str, int]:
    """``docs`` documents with log-normal lengths around ``mean_len``
    clipped to [16, 16384], token ids uniform in [0, min(eod, vocab)), each
    ending in ``eod``, as int32 tokens; plus the ``.meta.json`` sidecar the
    loader reads the eod id and the tokenizer's vocabulary from. Returns
    the writer's counts."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(rng.lognormal(math.log(mean_len), 0.7, docs)),
                   16, 16384).astype(np.int64)
    stats = write_indexed_dataset(prefix, (
        np.append(rng.integers(0, min(eod, vocab), n - 1), eod)
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
