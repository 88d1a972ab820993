"""Inference serving on one device: paged KV cache, continuous batching,
engine.

Port of ``hetu_galvatron_tpu/serving/`` with the same exports:

* ``kv_cache.py``: the paged KV cache, fixed-size blocks in a
  preallocated pool per layer with a per-sequence block table, written
  and read by torch indexing so a decode step keeps one shape.
* ``scheduler.py``: FIFO admission under a KV-block and prefill budget,
  per-sequence eos / length / timeout retirement, slot recycling at a
  fixed batch shape.
* ``prefix_cache.py``: the radix cache of shared prompt prefixes over the
  same pool (refcount-shared blocks, LRU eviction of unpinned nodes).
* ``spec_decode.py``: lossless speculative decoding (n-gram or model
  drafts, verified in one fixed-shape pass).
* ``engine.py``: the serving engine (paged prefill, prefix prefill,
  decode, verify), per-request token streams, cancellation, timeouts,
  weight swaps and the ``serve/*`` telemetry.

Front end: ``cli/serve.py``.
"""

from hetu_galvatron_tpu_torch.serving.engine import ServingEngine
from hetu_galvatron_tpu_torch.serving.kv_cache import (
    BlockAccountingError,
    BlockAllocator,
    PagedKVCache,
)
from hetu_galvatron_tpu_torch.serving.prefix_cache import PrefixCache
from hetu_galvatron_tpu_torch.serving.scheduler import (
    Request,
    RequestHandle,
    Scheduler,
)
from hetu_galvatron_tpu_torch.serving.spec_decode import (
    ModelDraft,
    NgramDraft,
)

__all__ = [
    "BlockAccountingError",
    "BlockAllocator",
    "ModelDraft",
    "NgramDraft",
    "PagedKVCache",
    "PrefixCache",
    "Request",
    "RequestHandle",
    "Scheduler",
    "ServingEngine",
]
