"""Synthetic data pipeline.

Counterpart of ``hetu_galvatron_tpu/runtime/dataloader.py``: the same
deterministic random-token dataset and the same numpy batches for the same
seed and position (``tokens``, ``labels``, ``loss_mask``). The indexed
corpus, packed documents and the bert/t5 batch shapes are not ported yet
and raise.
"""

from __future__ import annotations

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
    """One split's batch iterator; the synthetic dataset draws each split
    from a disjoint seed."""
    gbs = global_batch_size or args.parallel.global_train_batch_size
    data = args.data
    if data.dataset == "indexed":
        raise NotImplementedError(
            "data.dataset=indexed (the mmap corpus) is not ported yet; use "
            "data.dataset=random")
    if data.dataset != "random":
        raise ValueError(f"unknown dataset kind {data.dataset}")
    if data.reset_position_ids or data.reset_attention_mask \
            or data.eod_mask_loss:
        raise NotImplementedError(
            "packed documents (reset_position_ids / reset_attention_mask / "
            "eod_mask_loss) are not ported yet")
    if args.model.model_type in ("bert", "t5"):
        raise NotImplementedError(
            f"{args.model.model_type} batches are not ported yet")
    return synthetic_batches(args.model, gbs,
                             seed=args.train.seed + 101 * _SPLIT_INDEX[split])


def get_train_valid_test_data_iterators(
        args: CoreArgs, *, global_batch_size: Optional[int] = None):
    """(train, valid, test) iterators; the eval iterators exist only when
    train.eval_interval and eval_iters are both set."""
    train_it = get_data_iterator(args, global_batch_size=global_batch_size,
                                 split="train")
    valid_it = test_it = None
    if args.train.eval_interval and args.train.eval_iters:
        valid_it = get_data_iterator(
            args, global_batch_size=global_batch_size, split="valid")
        test_it = get_data_iterator(
            args, global_batch_size=global_batch_size, split="test")
    return train_it, valid_it, test_it
