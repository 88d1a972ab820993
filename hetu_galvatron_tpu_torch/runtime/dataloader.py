"""Data pipeline: synthetic tokens and the indexed corpus.

Counterpart of ``hetu_galvatron_tpu/runtime/dataloader.py``: the same
deterministic random-token dataset, the indexed corpus of
``data/indexed_dataset.py`` split into train/valid/test document ranges,
end-of-document loss masking and packed-document fields
(``position_ids`` / ``segment_ids``), BERT's masked-LM batches
(``mlm_batches``, the masks bit-identical to JAX's at the same seed) and
T5's seq2seq split (``seq2seq_batches``), giving the same numpy batches for
the same seed and position; ``skip_batches`` replays a resumed run's data
position. Not ported yet, and raising: ``s3://`` corpus prefixes and the
zigzag cp layout.

Under a plan over several ranks (``parallel/spmd.py``) every rank builds
the same global batch from the seed; each layer then keeps its own rows
(``parallel/spmd.batch_sharding``: the rows of its dp shard, the sequence
whole), since the embedding and the layers of a searched plan may split
the batch over different axes. The tokens of a batch weigh a few hundred
kilobytes, so no collective moves them.
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


def make_mlm_batch(samples: np.ndarray, vocab_size: int,
                   rng: np.random.RandomState, *, mask_prob: float = 0.15,
                   mask_token: Optional[int] = None,
                   eligible: Optional[np.ndarray] = None
                   ) -> Dict[str, np.ndarray]:
    """[B, S] tokens -> a BERT masked-LM batch: ``mask_prob`` of the
    positions are selected (80% become ``mask_token``, 10% a random id, 10%
    stay); labels are the originals and ``loss_mask`` covers the selected
    positions. ``rng`` advances across calls; the draws (``rand``,
    ``rand``, ``randint``) are JAX's, in its order, so the masks are its
    bits. ``mask_token`` defaults to the padded vocab's top id;
    ``eligible`` limits which positions may be selected (eod tokens under
    ``eod_mask_loss``)."""
    tokens = samples.astype(np.int32).copy()
    labels = samples.astype(np.int32)
    mask_token = vocab_size - 1 if mask_token is None else mask_token
    selected = rng.rand(*tokens.shape) < mask_prob
    if eligible is not None:
        selected &= np.asarray(eligible) > 0
    action = rng.rand(*tokens.shape)
    tokens[selected & (action < 0.8)] = mask_token
    random_ids = rng.randint(0, vocab_size, tokens.shape)
    swap = selected & (action >= 0.8) & (action < 0.9)
    tokens[swap] = random_ids[swap]
    return {"tokens": tokens, "labels": labels,
            "loss_mask": selected.astype(np.float32)}


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


def skip_batches(it: Iterator, n: int) -> None:
    """Fast-forward ``n`` global batches: the resume's replay of the data
    stream (JAX ``runtime/dataloader.py::skip_batches`` :117). Replaying,
    not seeking, leaves every stateful stage after the raw reader (the
    packed-document fields, the eod masking) in the state the first run
    left it in. A rerun-machine wrapper is committed per batch, so the
    replayed prefix does not pile up in its rewind cache and its
    ``batches_consumed`` counts the replayed batches."""
    advance = getattr(it, "advance", None)
    for _ in range(int(n)):
        next(it)
        if advance is not None:
            advance()


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
    model_type = args.model.model_type
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
        if (data.eod_mask_loss and meta.get("eod_id") is not None
                and model_type != "bert"):
            # bert leaves eod to mlm_batches: the causal shift's mask is
            # one position off for MLM
            it = eod_masked_batches(it, meta["eod_id"])
    else:
        raise ValueError(f"unknown dataset kind {data.dataset}")
    if data.reset_position_ids or data.reset_attention_mask:
        if model_type in ("bert", "t5"):
            raise NotImplementedError(
                "reset_position_ids/reset_attention_mask are causal-LM "
                "packing flags (bert/t5 batches have no packed documents)")
        if meta.get("eod_id") is None:
            raise ValueError(
                "reset_position_ids/reset_attention_mask need document "
                "boundaries: use data.dataset=indexed with an eod-emitting "
                "tokenizer (preprocess_data writes eod_id to the sidecar)")
        it = packed_doc_batches(
            it, meta["eod_id"],
            reset_position_ids=data.reset_position_ids,
            reset_attention_mask=data.reset_attention_mask)
    if model_type == "bert":
        # encoders train on masked LM, never the causal shift
        return mlm_batches(it, args.model, seed=args.train.seed,
                           mask_token=meta.get("mask_id"),
                           eod_id=(meta.get("eod_id")
                                   if data.eod_mask_loss else None))
    if model_type == "t5":
        return seq2seq_batches(it)
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


def seq2seq_batches(it: Iterator[Dict[str, np.ndarray]]
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Causal batches -> seq2seq: the first half of each sample is the
    encoder's source, the second half the decoder's input and labels
    (already the one-step-shifted pair, so both halves stay aligned)."""
    for batch in it:
        tokens = batch["tokens"]
        half = tokens.shape[1] // 2
        yield {"enc_tokens": tokens[:, :half], "tokens": tokens[:, half:],
               "labels": batch["labels"][:, half:],
               "loss_mask": batch["loss_mask"][:, half:]}


def mlm_batches(it: Iterator[Dict[str, np.ndarray]], model: ModelArgs,
                seed: int, mask_token: Optional[int] = None,
                eod_id: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Masked-LM batches from the token stream, masks drawn from
    ``RandomState(seed + 1)``; ``eod_id`` keeps end-of-document tokens out
    of the selection."""
    rng = np.random.RandomState(seed + 1)
    for batch in it:
        eligible = (batch["tokens"] != eod_id) if eod_id is not None else None
        yield make_mlm_batch(batch["tokens"], model.padded_vocab_size, rng,
                             mask_token=mask_token, eligible=eligible)
