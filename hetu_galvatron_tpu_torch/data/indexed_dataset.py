"""Memory-mapped indexed token corpus (Megatron-style ``.bin``/``.idx`` pair).

Counterpart of ``hetu_galvatron_tpu/data/indexed_dataset.py``, in numpy:
the same file format, the same sample mapping and the same sample order for
the same seed, so a corpus written by either package reads the same in
both.

File format (version 1): ``<prefix>.bin`` holds the little-endian token ids
of every document back to back; ``<prefix>.idx`` holds the magic
``HGTPUIDX``, then ``<HHq`` (version, dtype code, document count), then the
document count + 1 int64 offsets in tokens. Token dtypes: uint16 (code 1),
int32 (2), int64 (3).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

_MAGIC = b"HGTPUIDX"
_VERSION = 1
_DTYPES = {1: np.uint16, 2: np.int32, 3: np.int64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_SPLIT_NAMES = {0: "train", 1: "valid", 2: "test"}


def build_sample_idx(doc_lens: np.ndarray, seq_len: int,
                     num_samples: int) -> np.ndarray:
    """[n, 2] (document index, in-document offset) of each sample start,
    samples ``seq_len`` tokens apart in the concatenated stream, as many as
    fit ``seq_len + 1`` tokens (at most ``num_samples``).

    The same answer as the JAX package's C++ two-pointer walk
    (``csrc/dataset_helpers.cpp``), zero-length documents included: the
    first sample starts at (0, 0); a later start that falls on a document's
    end is reported as offset 0 of the next document."""
    doc_lens = np.ascontiguousarray(doc_lens, np.int64)
    ends = np.cumsum(doc_lens)
    total = int(ends[-1]) if len(ends) else 0
    pos = np.arange(max(num_samples, 0), dtype=np.int64) * seq_len
    pos = pos[pos + seq_len + 1 <= total]
    if not len(pos):
        return np.zeros((0, 2), np.int64)
    # every start lies before the last token, so doc stays in range
    doc = np.searchsorted(ends, pos, side="left")
    doc += ends[doc] == pos
    doc[pos == 0] = 0
    off = pos - (ends - doc_lens)[doc]
    return np.stack([doc, off], axis=1).astype(np.int64)


def write_indexed_dataset(prefix: str, documents: Iterable[Sequence[int]],
                          dtype=np.int32) -> Dict[str, int]:
    """Token documents -> ``<prefix>.bin`` / ``<prefix>.idx``."""
    dtype = np.dtype(dtype)
    offsets: List[int] = [0]
    count = 0
    with open(prefix + ".bin", "wb") as f:
        for doc in documents:
            arr = np.asarray(doc, dtype=dtype)
            arr.tofile(f)
            count += arr.size
            offsets.append(count)
    with open(prefix + ".idx", "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<HHq", _VERSION, _DTYPE_CODES[dtype],
                            len(offsets) - 1))
        np.asarray(offsets, np.int64).tofile(f)
    return {"documents": len(offsets) - 1, "tokens": count}


class IndexedDataset:
    """Read-only memory map over a ``.bin``/``.idx`` pair."""

    def __init__(self, prefix: str):
        with open(prefix + ".idx", "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{prefix}.idx: bad magic {magic!r}")
            version, dtype_code, num_docs = struct.unpack("<HHq", f.read(12))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            self.dtype = np.dtype(_DTYPES[dtype_code])
            self.offsets = np.fromfile(f, np.int64, num_docs + 1)
        self.tokens = np.memmap(prefix + ".bin", dtype=self.dtype, mode="r")
        self.num_docs = num_docs

    def __len__(self) -> int:
        return self.num_docs

    @property
    def total_tokens(self) -> int:
        return int(self.offsets[-1])

    @property
    def doc_lens(self) -> np.ndarray:
        return np.diff(self.offsets)

    def get_doc(self, i: int) -> np.ndarray:
        return np.asarray(self.tokens[self.offsets[i]:self.offsets[i + 1]])

    def get_span(self, doc: int, offset: int, length: int) -> np.ndarray:
        """``length`` tokens from (doc, offset), crossing documents."""
        start = int(self.offsets[doc] + offset)
        return np.asarray(self.tokens[start:start + length])


class GPTDataset:
    """Samples of ``seq_length + 1`` tokens over a contiguous document range
    (``doc_range``, the train/valid/test split unit), in an order reshuffled
    every epoch by a permutation seeded with ``seed + epoch``."""

    def __init__(self, indexed: IndexedDataset, seq_length: int,
                 seed: int = 1234, shuffle: bool = True,
                 doc_range: Optional[tuple] = None):
        self.indexed = indexed
        self.seq_length = seq_length
        self.seed = seed
        self.shuffle = shuffle
        lo, hi = doc_range if doc_range is not None else (0, len(indexed))
        if not (0 <= lo <= hi <= len(indexed)):
            raise ValueError(f"doc_range {doc_range} outside "
                             f"[0, {len(indexed)}]")
        self._doc_lo = lo
        doc_lens = indexed.doc_lens[lo:hi]
        total = int(doc_lens.sum())
        self.sample_idx = build_sample_idx(
            doc_lens, seq_length, max((total - 1) // seq_length, 0))
        self._epoch = -1
        self._order = np.arange(len(self.sample_idx))

    def __len__(self) -> int:
        return len(self.sample_idx)

    def _order_for(self, epoch: int) -> np.ndarray:
        if epoch != self._epoch:
            order = np.arange(len(self.sample_idx))
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(order)
            self._epoch, self._order = epoch, order
        return self._order

    def __getitem__(self, i: int) -> np.ndarray:
        n = max(len(self), 1)
        order = self._order_for(i // n)
        doc, off = self.sample_idx[order[i % n]]
        return self.indexed.get_span(int(doc) + self._doc_lo, int(off),
                                     self.seq_length + 1).astype(np.int32)


class BlendedDataset:
    """Sample-proportional blend of several GPTDatasets: a seeded table of
    65536 picks, walked cyclically, with prefix counts giving each pick's
    index inside its dataset (stateless access)."""

    def __init__(self, datasets: Sequence[GPTDataset],
                 weights: Optional[Sequence[float]] = None, seed: int = 1234):
        if not datasets:
            raise ValueError("empty dataset blend")
        self.datasets = list(datasets)
        w = np.asarray(weights if weights is not None
                       else [len(d) for d in self.datasets], np.float64)
        self.weights = w / w.sum()
        rng = np.random.RandomState(seed)
        self._picks = rng.choice(len(self.datasets), size=65536,
                                 p=self.weights)
        onehot = self._picks[:, None] == np.arange(len(self.datasets))[None]
        cum = np.cumsum(onehot, axis=0)
        self._within = cum[np.arange(len(self._picks)), self._picks] - 1
        self._per_cycle = cum[-1]

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, i: int) -> np.ndarray:
        cycle, pos = divmod(i, len(self._picks))
        d = int(self._picks[pos])
        idx = cycle * int(self._per_cycle[d]) + int(self._within[pos])
        return self.datasets[d][idx]


def split_doc_ranges(n_docs: int, split: str) -> List[tuple]:
    """Train/valid/test document ranges from the comma-separated ratios of
    ``data.split`` (normalised; a zero ratio gives an empty range; every
    document lands in exactly one range)."""
    ratios = [float(x) for x in str(split).split(",")]
    if len(ratios) != 3 or any(r < 0 for r in ratios) or sum(ratios) <= 0:
        raise ValueError(
            f"data.split must be three non-negative ratios, got {split!r}")
    total = sum(ratios)
    bounds = [0]
    acc = 0.0
    for r in ratios:
        acc += r
        bounds.append(int(round(n_docs * acc / total)))
    bounds[-1] = n_docs
    return [(bounds[i], bounds[i + 1]) for i in range(3)]


def indexed_batches(prefix_or_paths, seq_length: int, global_batch_size: int,
                    *, seed: int = 1234,
                    weights: Optional[Sequence[float]] = None,
                    split: Optional[str] = None, split_index: int = 0,
                    shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Batch iterator over one or several (blended) corpora, yielding the
    synthetic iterator's batches (``tokens``, ``labels``, ``loss_mask``).
    ``split`` + ``split_index`` pick the train (0), valid (1) or test (2)
    document range of each corpus. A split smaller than one sample raises
    here, before the first batch, so a caller can drop an empty eval split
    before any training time is spent."""
    from hetu_galvatron_tpu_torch.runtime.dataloader import make_batch

    paths = ([prefix_or_paths] if isinstance(prefix_or_paths, str)
             else list(prefix_or_paths))
    ds_list = []
    for p in paths:
        idx = IndexedDataset(p)
        rng = (split_doc_ranges(len(idx), split)[split_index]
               if split is not None else None)
        ds_list.append(GPTDataset(idx, seq_length, seed=seed,
                                  shuffle=shuffle, doc_range=rng))
    ds = (ds_list[0] if len(ds_list) == 1
          else BlendedDataset(ds_list, weights=weights, seed=seed))
    if len(ds) == 0:
        name = _SPLIT_NAMES.get(split_index, "?")
        raise ValueError(
            f"indexed corpus {name} split smaller than one sample "
            f"(split={split!r}; grow the corpus or the split ratio)")

    def gen():
        i = 0
        while True:
            rows = [ds[i * global_batch_size + j]
                    for j in range(global_batch_size)]
            yield make_batch(np.stack(rows))
            i += 1

    return gen()
