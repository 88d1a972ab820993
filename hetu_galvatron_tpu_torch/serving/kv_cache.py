"""Paged KV cache: fixed-size blocks in a preallocated pool + block tables.

Port of ``hetu_galvatron_tpu/serving/kv_cache.py``. One preallocated pool
per layer, carved into fixed-size blocks (the PagedAttention layout), and
a per-sequence block table mapping logical positions to pool blocks::

    pools[layer]["k"] : [num_blocks, block_size, kv_heads, head_dim]
    table[seq]        : [max_blocks_per_seq] block ids

Alloc / free is host-side free-list bookkeeping (:class:`BlockAllocator`,
the same ids in the same order as the JAX allocator); reads and writes are
torch indexing on the pool tensors, in place (:func:`scatter_prefill`,
:func:`scatter_token`, :func:`gather_pages`), so a decode step never
changes shape. Block 0 is reserved scratch: retired lanes point their
writes at it, which keeps the batch shape fixed without per-lane control
flow. Pools hold ``cfg.kv_heads`` heads (GQA shrinks them).

Not ported: ``pool_pspecs`` (the pool's sharding under a mesh) waits for
mesh serving.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs

# block 0 is never allocated: retired slots write into it so the decode
# batch keeps a fixed shape with no per-slot control flow
SCRATCH_BLOCK = 0

Pools = List[Dict[str, torch.Tensor]]


class BlockAccountingError(ValueError):
    """A block lifecycle violation: double free, strict-freeing a block
    other owners still reference, or touching the refcount of a block that
    was never allocated."""


class BlockAllocator:
    """Host-side refcounted free-list allocator over the pool's block ids.

    Every owner (a running sequence, the radix tree) holds one reference;
    a block returns to the free list when the last one drops it.
    :meth:`alloc` hands out blocks at refcount 1, co-owners
    :meth:`incref`, owners release through :meth:`decref`; :meth:`free`
    is the strict single-owner path and raises on a shared block or a
    double free. :meth:`defrag_plan` compacts live blocks to the low ids.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is scratch), got "
                             f"{num_blocks}")
        self.num_blocks = num_blocks
        # LIFO free list: recycled blocks are reused first
        self._free = list(range(num_blocks - 1, SCRATCH_BLOCK, -1))
        self._rc = [0] * num_blocks  # per-block owner count; 0 = free

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def refcount(self, block: int) -> int:
        self._check_id(block)
        return self._rc[block]

    def _check_id(self, b: int) -> None:
        if not (SCRATCH_BLOCK < b < self.num_blocks):
            raise BlockAccountingError(f"invalid block id {b} "
                                       f"(pool has 1..{self.num_blocks - 1})")

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks at refcount 1, or None when the pool cannot satisfy
        the request (never a partial grant)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._rc[b] = 1
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        """A new owner takes a reference; only allocated blocks can gain
        owners."""
        for b in blocks:
            self._check_id(b)
            if self._rc[b] < 1:
                raise BlockAccountingError(
                    f"incref of unallocated block {b}")
        for b in blocks:
            self._rc[b] += 1

    @staticmethod
    def _check_unique(blocks: Sequence[int]) -> None:
        # a duplicated id in one call would double-release: the free list
        # would hand one block to two sequences
        if len(set(blocks)) != len(blocks):
            dup = sorted(b for b in set(blocks)
                         if list(blocks).count(b) > 1)
            raise BlockAccountingError(
                f"duplicate block id(s) {dup} in one release call")

    def decref(self, blocks: Sequence[int]) -> List[int]:
        """Drop one reference per block; returns the blocks whose last
        owner left (now free). A decref of a free block is a double free."""
        self._check_unique(blocks)
        for b in blocks:
            self._check_id(b)
            if self._rc[b] < 1:
                raise BlockAccountingError(f"double free of block {b}")
        freed: List[int] = []
        for b in blocks:
            self._rc[b] -= 1
            if self._rc[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def free(self, blocks: Sequence[int]) -> None:
        """Strict sole-owner release: every block must be allocated with
        refcount exactly 1; a shared block raises (use :meth:`decref`)."""
        self._check_unique(blocks)
        for b in blocks:
            self._check_id(b)
            if self._rc[b] == 0:
                raise BlockAccountingError(f"double free of block {b}")
            if self._rc[b] > 1:
                raise BlockAccountingError(
                    f"free() of shared block {b} "
                    f"(refcount {self._rc[b]}); other owners still "
                    "reference it — use decref()")
        for b in blocks:
            self._rc[b] = 0
            self._free.append(b)

    def defrag_plan(self, tables: Sequence[Sequence[int]]
                    ) -> Tuple[List[int], List[List[int]]]:
        """Compaction plan: live blocks (every id in ``tables``) move to
        ids 1..n_live in first-reference order. Returns ``(perm,
        new_tables)``: ``perm[new_id] = old_id`` is the pool gather order
        (scratch stays at 0), ``new_tables`` mirror ``tables`` renamed.
        ``tables`` must cover every referencing view of every live block
        (sequence tables, ownership lists, radix node tables)."""
        remap: Dict[int, int] = {SCRATCH_BLOCK: SCRATCH_BLOCK}
        for table in tables:
            for b in table:
                if b not in remap:
                    self._check_id(b)
                    if self._rc[b] < 1:
                        raise BlockAccountingError(
                            f"defrag table references free block {b}")
                    remap[b] = len(remap)
        n_live = len(remap) - 1
        if n_live != self.used:
            raise ValueError(
                f"tables reference {n_live} blocks but allocator has "
                f"{self.used} outstanding — tables and allocator disagree")
        perm = [SCRATCH_BLOCK] * self.num_blocks
        for old, new in remap.items():
            perm[new] = old
        # unreferenced (free) blocks fill the tail in id order
        tail = [b for b in range(1, self.num_blocks) if b not in remap]
        for i, old in enumerate(tail):
            perm[n_live + 1 + i] = old
        new_tables = [[remap[b] for b in t] for t in tables]
        self._free = list(range(self.num_blocks - 1, n_live, -1))
        self._rc = [self._rc[perm[new]] for new in range(self.num_blocks)]
        return perm, new_tables


# ---------------------------------------------------------------------------
# pool ops: in-place writes into a layer's pool, reads through block tables
# ---------------------------------------------------------------------------


def scatter_prefill(pool: torch.Tensor, kv: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """Write a prefilled [S, K, D] k-or-v run into its blocks, in place.
    ``S`` is a multiple of block_size (prefill buckets are); ``table``
    holds the S / block_size destination block ids."""
    bs = pool.shape[1]
    nb = kv.shape[0] // bs
    pool[table] = kv.reshape(nb, bs, *kv.shape[1:]).to(pool.dtype)
    return pool


def scatter_token(pool: torch.Tensor, kv: torch.Tensor,
                  blocks: torch.Tensor, offsets: torch.Tensor
                  ) -> torch.Tensor:
    """Write one decode-step token per slot, in place: kv [S, K, D] lands
    at (blocks[s], offsets[s]). Retired slots alias the scratch block,
    whose colliding writes are never read."""
    pool[blocks, offsets] = kv.to(pool.dtype)
    return pool


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each slot's logical cache: tables [S, MB] -> [S, MB * bs, K, D]
    (positions past a slot's length hold garbage that the attention mask
    of :func:`paged_sdpa` hides)."""
    S, MB = tables.shape
    bs = pool.shape[1]
    return pool[tables].reshape(S, MB * bs, *pool.shape[2:])


def paged_sdpa(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Per-slot cached attention: q [S, 1, Nq, D] against assembled pages
    [S, T, K, D], keys past pos[s] masked. Delegates to the one
    dense-cache attention (``models/generate._cached_sdpa``)."""
    from hetu_galvatron_tpu_torch.models.generate import _cached_sdpa

    return _cached_sdpa(q, ck, cv, pos)


def paged_sdpa_window(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      start) -> torch.Tensor:
    """Windowed cached attention: q [S, W, Nq, D] holds W consecutive query
    positions per slot from absolute position ``start[s]`` (int or [S]);
    row j attends key positions <= start[s] + j. The speculative verify
    program and the prefix-suffix prefill come here; the same
    ``_cached_sdpa`` as :func:`paged_sdpa`."""
    from hetu_galvatron_tpu_torch.models.generate import _cached_sdpa

    return _cached_sdpa(q, ck, cv, start)


def scatter_window(pool: torch.Tensor, kv: torch.Tensor,
                   blocks: torch.Tensor, offsets: torch.Tensor
                   ) -> torch.Tensor:
    """Write a window of tokens per slot, in place: kv [S, W, K, D] lands
    at (blocks[s, j], offsets[s, j]); out-of-budget lanes point at the
    scratch block (the :func:`scatter_token` contract)."""
    pool[blocks, offsets] = kv.to(pool.dtype)
    return pool


def copy_block(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Duplicate one block's contents, in place (copy-on-write for a
    fully-cached prompt: the block holding the last prompt position must
    be private before the bootstrap decode step rewrites that position)."""
    pool[dst] = pool[src]
    return pool


def resolve_num_blocks(serving: Any, cfg: ModelArgs) -> int:
    """The pool an engine with these args allocates:
    ``serving.num_kv_blocks`` verbatim, or one full-length sequence per
    decode lane plus the scratch block."""
    if serving.num_kv_blocks:
        return int(serving.num_kv_blocks)
    max_seq_len = serving.max_seq_len or cfg.max_position_embeddings
    per_seq = -(-max_seq_len // serving.kv_block_size)
    return 1 + int(serving.max_batch_size) * per_seq


def kv_pool_mb(serving: Any, cfg: ModelArgs, *, kv_elem_bytes: int = 2,
               tp: int = 1) -> float:
    """Per-device megabytes of the paged KV pool under these serving args:
    ``num_blocks`` blocks of ``2 (k+v) * layers * block_size * kv_heads *
    head_dim`` elements, the kv-head axis divided over ``tp`` when tp
    divides the kv-head count. ``kv_elem_bytes`` defaults to bf16."""
    num_blocks = resolve_num_blocks(serving, cfg)
    shard = tp if (tp > 1 and cfg.kv_heads % tp == 0) else 1
    per_block = (2 * cfg.num_hidden_layers * serving.kv_block_size
                 * cfg.kv_heads * cfg.head_dim * kv_elem_bytes)
    return num_blocks * per_block / shard / (1024 * 1024)


class PagedKVCache:
    """The pool + allocator pair one engine owns: ``pools`` is a per-layer
    list of ``{"k", "v"}`` tensors on ``device`` that the engine's
    programs write in place; the allocator and the tables stay on the
    host."""

    def __init__(
        self,
        cfg: ModelArgs,
        *,
        num_blocks: int,
        block_size: int,
        max_seq_len: int,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        if block_size < 1:
            raise ValueError(f"block_size {block_size}")
        self.cfg = cfg
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len)
        self.max_blocks_per_seq = max(
            math.ceil(self.max_seq_len / self.block_size), 1)
        self.dtype = dtype
        self.allocator = BlockAllocator(self.num_blocks)
        shape = (self.num_blocks, self.block_size, cfg.kv_heads, cfg.head_dim)
        self.pools: Pools = [
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_hidden_layers)]

    # -- sizing -------------------------------------------------------------

    def blocks_for(self, total_tokens: int) -> int:
        """Blocks a sequence of ``total_tokens`` (prompt + generation
        budget) needs."""
        return max(math.ceil(total_tokens / self.block_size), 1)

    def fits(self, total_tokens: int) -> bool:
        """Whether a sequence of this total length can ever be served
        (table capacity), whatever the occupancy."""
        return (total_tokens <= self.max_seq_len
                and self.blocks_for(total_tokens) <= self.max_blocks_per_seq)

    @property
    def occupancy(self) -> float:
        """Fraction of allocatable blocks currently held."""
        cap = self.num_blocks - 1
        return self.allocator.used / cap if cap else 0.0

    def bytes_per_block(self) -> int:
        elt = torch.empty((), dtype=self.dtype).element_size()
        return (2 * self.cfg.num_hidden_layers * self.block_size
                * self.cfg.kv_heads * self.cfg.head_dim * elt)

    # -- maintenance --------------------------------------------------------

    def defrag(self, tables: Sequence[Sequence[int]]) -> List[List[int]]:
        """Compact live blocks to the low pool ids: permutes every pool
        (one gather each) and returns the renamed tables; the contents
        seen through the tables are unchanged."""
        perm, new_tables = self.allocator.defrag_plan(tables)
        idx = torch.as_tensor(perm, dtype=torch.long,
                              device=self.pools[0]["k"].device)
        self.pools = [{"k": p["k"][idx], "v": p["v"][idx]}
                      for p in self.pools]
        return new_tables
