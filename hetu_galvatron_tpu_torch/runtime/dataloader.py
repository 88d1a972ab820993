"""Data pipeline: synthetic tokens and the indexed corpus.

Counterpart of ``hetu_galvatron_tpu/runtime/dataloader.py``: the same
deterministic random-token dataset, the indexed corpus of
``data/indexed_dataset.py`` split into train/valid/test document ranges,
end-of-document loss masking and packed-document fields
(``position_ids`` / ``segment_ids``), giving the same numpy batches for the
same seed and position. Not ported yet, and raising: ``s3://`` corpus
prefixes, the bert/t5 batch shapes and the zigzag cp layout.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Iterator, Optional

import numpy as np

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, ModelArgs


class RandomTokenDataset:
    """Deterministic random tokens (seeded numpy ``RandomState``)."""

    def __init__(self, vocab_size: int, seq_length: int, size: int = 1024,
                 seed: int = 1234):
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.size = size
        rng = np.random.RandomState(seed)
        # +1 token so the input/label shift stays inside the sample
        self._data = rng.randint(
            0, vocab_size, (size, seq_length + 1), dtype=np.int32)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> np.ndarray:
        return self._data[idx % self.size]


def make_batch(samples: np.ndarray) -> Dict[str, np.ndarray]:
    """[B, S+1] tokens -> {tokens, labels, loss_mask}."""
    return {
        "tokens": samples[:, :-1].astype(np.int32),
        "labels": samples[:, 1:].astype(np.int32),
        "loss_mask": np.ones_like(samples[:, 1:], dtype=np.float32),
    }


def synthetic_batches(model: ModelArgs, global_batch_size: int, *,
                      size: int = 1024, seed: int = 1234
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of global batches of synthetic data."""
    ds = RandomTokenDataset(model.padded_vocab_size, model.seq_length,
                            size=size, seed=seed)
    i = 0
    while True:
        idx = [(i * global_batch_size + j) % len(ds)
               for j in range(global_batch_size)]
        yield make_batch(np.stack([ds[j] for j in idx]))
        i += 1


_SPLIT_INDEX = {"train": 0, "valid": 1, "test": 2}


def get_data_iterator(args: CoreArgs, *,
                      global_batch_size: Optional[int] = None,
                      split: str = "train"
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """One split's batch iterator. Indexed corpora take the split's document
    range by the ``data.split`` ratios and iterate evaluation splits
    unshuffled; the synthetic dataset draws each split from a disjoint
    seed."""
    gbs = global_batch_size or args.parallel.global_train_batch_size
    data = args.data
    if args.model.model_type in ("bert", "t5"):
        raise NotImplementedError(
            f"{args.model.model_type} batches are not ported yet")
    meta: Dict = {}
    split_idx = _SPLIT_INDEX[split]
    if data.dataset == "random":
        it = synthetic_batches(args.model, gbs,
                               seed=args.train.seed + 101 * split_idx)
    elif data.dataset == "indexed":
        from hetu_galvatron_tpu_torch.data.indexed_dataset import (
            indexed_batches,
        )

        paths = ([data.data_path] if isinstance(data.data_path, str)
                 else list(data.data_path))
        if not paths:
            raise ValueError("data.dataset=indexed requires data.data_path")
        remote = [p for p in paths if str(p).startswith("s3://")]
        if remote:
            raise NotImplementedError(
                f"s3:// corpus prefixes {remote} (object_store."
                "localize_prefix) are not ported yet; download the corpus "
                "and point data.data_path at the local prefix")
        meta = corpus_meta(paths)
        if meta.get("vocab_size", 0) > args.model.padded_vocab_size:
            raise ValueError(
                f"corpus tokenizer vocab {meta['vocab_size']} exceeds model "
                f"padded vocab {args.model.padded_vocab_size}")
        it = indexed_batches(paths, args.model.seq_length, gbs,
                             seed=args.train.seed, split=data.split,
                             split_index=split_idx,
                             shuffle=split == "train")
        if data.eod_mask_loss and meta.get("eod_id") is not None:
            it = eod_masked_batches(it, meta["eod_id"])
    else:
        raise ValueError(f"unknown dataset kind {data.dataset}")
    if data.reset_position_ids or data.reset_attention_mask:
        if meta.get("eod_id") is None:
            raise ValueError(
                "reset_position_ids/reset_attention_mask need document "
                "boundaries: use data.dataset=indexed with an eod-emitting "
                "tokenizer (preprocess_data writes eod_id to the sidecar)")
        it = packed_doc_batches(
            it, meta["eod_id"],
            reset_position_ids=data.reset_position_ids,
            reset_attention_mask=data.reset_attention_mask)
    return it


def get_train_valid_test_data_iterators(
        args: CoreArgs, *, global_batch_size: Optional[int] = None):
    """(train, valid, test) iterators; the eval iterators exist only when
    train.eval_interval and eval_iters are both set. An eval split too
    small for one sample is dropped with a warning instead of failing the
    run."""
    train_it = get_data_iterator(args, global_batch_size=global_batch_size,
                                 split="train")
    valid_it = test_it = None
    if args.train.eval_interval and args.train.eval_iters:
        its = []
        for name in ("valid", "test"):
            try:
                its.append(get_data_iterator(
                    args, global_batch_size=global_batch_size, split=name))
            except ValueError as e:
                print(f"warning: {name} eval disabled: {e}", file=sys.stderr)
                its.append(None)
        valid_it, test_it = its
    return train_it, valid_it, test_it


def corpus_meta(paths) -> Dict:
    """The ``<prefix>.meta.json`` sidecar (tokenizer geometry: vocab_size,
    eod_id) of the corpora; blended corpora must agree. {} when absent."""
    paths = [paths] if isinstance(paths, str) else list(paths)
    metas = []
    for p in paths:
        if os.path.exists(p + ".meta.json"):
            with open(p + ".meta.json") as f:
                metas.append(json.load(f))
    if not metas:
        return {}
    first = metas[0]
    for m in metas[1:]:
        if (m.get("vocab_size"), m.get("eod_id")) != (
                first.get("vocab_size"), first.get("eod_id")):
            raise ValueError(
                "blended corpora were tokenized with different tokenizers: "
                f"{metas}")
    return first


def eod_masked_batches(it: Iterator[Dict[str, np.ndarray]], eod_id: int
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Zero the loss where the input token is end-of-document (it would
    learn to predict the next document's first token); predicting eod
    itself stays in the loss."""
    for batch in it:
        batch = dict(batch)
        batch["loss_mask"] = (batch["loss_mask"]
                              * (batch["tokens"] != eod_id))
        yield batch


def packed_doc_fields(tokens: np.ndarray, eod_id: int, *,
                      reset_position_ids: bool, reset_attention_mask: bool
                      ) -> Dict[str, np.ndarray]:
    """Per-token ``position_ids`` / ``segment_ids`` of packed samples: a
    document starts after each eod token, where positions restart at 0 and
    the segment id steps up."""
    doc_starts = np.zeros_like(tokens, dtype=np.int64)
    doc_starts[:, 1:] = (tokens[:, :-1] == eod_id)
    segments = np.cumsum(doc_starts, axis=1)
    out: Dict[str, np.ndarray] = {}
    if reset_attention_mask:
        out["segment_ids"] = segments.astype(np.int32)
    if reset_position_ids:
        pos = np.arange(tokens.shape[1], dtype=np.int64)[None, :]
        starts = np.where(doc_starts.astype(bool), pos, 0)
        doc_start_pos = np.maximum.accumulate(starts, axis=1)
        out["position_ids"] = (pos - doc_start_pos).astype(np.int32)
    return out


def packed_doc_batches(it: Iterator[Dict[str, np.ndarray]], eod_id: int, *,
                       reset_position_ids: bool, reset_attention_mask: bool
                       ) -> Iterator[Dict[str, np.ndarray]]:
    for batch in it:
        batch = dict(batch)
        batch.update(packed_doc_fields(
            batch["tokens"], eod_id,
            reset_position_ids=reset_position_ids,
            reset_attention_mask=reset_attention_mask))
        yield batch
