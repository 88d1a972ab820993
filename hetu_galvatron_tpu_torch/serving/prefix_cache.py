"""Radix prefix cache: shared-prefix KV reuse over the paged block pool.

Port of ``hetu_galvatron_tpu/serving/prefix_cache.py`` (``RadixNode`` :49,
``PrefixCache`` :67), host logic only, the same matches, insertions,
splits, pins, LRU evictions and invalidations as the JAX tree:

* **Block-granular edges.** Every edge is a run of full blocks
  (``block_size`` tokens each); children are keyed by their first block's
  token tuple, so a matched prefix maps 1:1 onto pool block ids a
  request's table can point at copy-free.
* **Refcounted sharing.** The tree holds one allocator reference per
  adopted block (``BlockAllocator.incref``); a running request that
  matched a path pins its nodes (``node.ref``) so eviction never pulls a
  block from under a live table.
* **LRU eviction over unpinned leaves**, oldest first; inner nodes become
  leaves as their children go.
* **Invalidation** (a weight swap): every node leaves the tree; pinned
  nodes stay as zombies whose blocks free at their last release.

Content equality is exact token-id equality over whole blocks: k/v at
position p depends only on tokens[0..p].
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from hetu_galvatron_tpu_torch.serving.kv_cache import BlockAllocator

BlockKey = Tuple[int, ...]  # one block's tokens (length == block_size)


@dataclass
class RadixNode:
    """One edge+node of the tree: ``tokens`` is the edge label (a multiple
    of block_size tokens), ``blocks`` the pool ids holding their k/v.
    ``ref`` counts live requests pinning this node (match() .. release());
    ``stamp`` is the LRU clock value of the last touch."""

    tokens: Tuple[int, ...]
    blocks: List[int]
    parent: Optional["RadixNode"]
    children: Dict[BlockKey, "RadixNode"] = field(default_factory=dict)
    ref: int = 0
    stamp: int = 0
    # detached by invalidate() while still pinned by a live request: the
    # node no longer matches (its k/v was computed under superseded
    # weights) but its blocks stay live until the last pin releases
    zombie: bool = False


class PrefixCache:
    """The radix tree one engine owns (host logic only).

    All block ownership flows through the shared :class:`BlockAllocator`:
    the tree is just another owner. ``max_blocks`` caps how many blocks
    the tree may hold (0 = bounded only by the pool); either way,
    :meth:`evict` reclaims unpinned nodes LRU-first when the allocator
    runs dry.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 max_blocks: int = 0):
        if block_size < 1:
            raise ValueError(f"block_size {block_size}")
        self.allocator = allocator
        self.block_size = int(block_size)
        self.max_blocks = int(max_blocks)
        self.root = RadixNode(tokens=(), blocks=[], parent=None)
        self._clock = itertools.count(1)
        self.blocks_held = 0
        # nodes detached by invalidate() while pinned: kept only so
        # release() can drop their blocks when the last pin goes
        self._zombies: List[RadixNode] = []
        # telemetry: lookups/hits/tokens served from cache/evicted blocks
        self.lookups = 0
        self.hits = 0
        self.cached_tokens_served = 0
        self.evicted_blocks = 0

    # -- matching -----------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def note_lookup(self, cached_len: int) -> None:
        """Record one REQUEST's cache outcome for the hit-rate telemetry.
        Deliberately separate from :meth:`match`: admission re-matches a
        deferred head-of-queue request every engine step, and counting
        each retry would inflate the gauge."""
        self.lookups += 1
        if cached_len:
            self.hits += 1
            self.cached_tokens_served += cached_len

    def _touch(self, node: RadixNode) -> None:
        node.stamp = next(self._clock)

    def match(self, tokens: Sequence[int]
              ) -> Tuple[int, List[int], Tuple[RadixNode, ...]]:
        """Longest cached block-aligned prefix of ``tokens``. Returns
        ``(cached_len, blocks, path)``: ``cached_len`` tokens (a multiple
        of block_size, at most ``len(tokens) // bs * bs``) are already in
        the pool at ``blocks``; every node in ``path`` is PINNED (ref+1)
        until the caller passes it back to :meth:`release` — a partially
        used edge pins its node too (its blocks are in the table). Stats
        are NOT recorded here (:meth:`note_lookup` is the per-request
        accounting hook)."""
        bs = self.block_size
        toks = tuple(tokens)
        want = len(toks) // bs * bs  # only whole blocks can be shared
        node = self.root
        i = 0
        blocks: List[int] = []
        path: List[RadixNode] = []
        while i < want:
            child = node.children.get(toks[i:i + bs])
            if child is None:
                break
            # block-by-block common prefix along this edge
            n_match = 0
            for j in range(len(child.blocks)):
                lo = i + j * bs
                if lo + bs > want or child.tokens[j * bs:(j + 1) * bs] \
                        != toks[lo:lo + bs]:
                    break
                n_match += 1
            if n_match == 0:
                break
            child.ref += 1
            self._touch(child)
            path.append(child)
            blocks.extend(child.blocks[:n_match])
            i += n_match * bs
            if n_match < len(child.blocks):
                break
            node = child
        return i, blocks, tuple(path)

    def release(self, path: Sequence[RadixNode]) -> None:
        """Drop a request's pins (retirement). Idempotence is the
        caller's job — each match() pin is released exactly once. A
        zombie node (detached by :meth:`invalidate` while pinned) drops
        its block references when its last pin goes."""
        for node in path:
            if node.ref < 1:
                raise ValueError("release of an unpinned radix node")
            node.ref -= 1
            self._touch(node)
            if node.zombie and node.ref == 0:
                self.allocator.decref(node.blocks)
                self.blocks_held -= len(node.blocks)
                self.evicted_blocks += len(node.blocks)
                self._zombies.remove(node)

    # -- insertion ----------------------------------------------------------

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]
               ) -> List[int]:
        """Adopt a prefilled prompt's full blocks into the tree. ``tokens``
        is truncated to whole blocks; ``blocks`` maps 1:1 onto them and
        must already be live in the allocator (the inserting request's
        references). Returns the block ids the tree newly adopted (it
        increfs them; the request keeps its own references and decrefs at
        retirement as usual). Paths already present keep their existing
        blocks — the duplicate suffix is simply not adopted."""
        bs = self.block_size
        toks = tuple(tokens)
        n_full = len(toks) // bs
        toks = toks[: n_full * bs]
        blocks = list(blocks)[:n_full]
        if len(blocks) != n_full:
            raise ValueError(
                f"insert: {n_full} full blocks of tokens but "
                f"{len(blocks)} block ids")
        node = self.root
        i = 0
        adopted: List[int] = []
        while i < len(toks):
            key = toks[i:i + bs]
            child = node.children.get(key)
            if child is None:
                new = RadixNode(tokens=toks[i:], blocks=blocks[i // bs:],
                                parent=node)
                self.allocator.incref(new.blocks)
                adopted.extend(new.blocks)
                self.blocks_held += len(new.blocks)
                node.children[key] = new
                self._touch(new)
                break
            # advance along the edge's common block prefix
            n_match = 0
            for j in range(len(child.blocks)):
                lo = i + j * bs
                if lo >= len(toks) or child.tokens[j * bs:(j + 1) * bs] \
                        != toks[lo:lo + bs]:
                    break
                n_match += 1
            if n_match < len(child.blocks) and i + n_match * bs < len(toks):
                # diverging mid-edge: split the edge at the boundary
                child = self._split(child, n_match)
            self._touch(child)
            i += n_match * bs
            node = child
            if n_match == len(node.blocks) and i >= len(toks):
                break
            if n_match < len(node.blocks):
                # insert path is a strict prefix of the edge: nothing new
                break
        if self.max_blocks and self.blocks_held > self.max_blocks:
            self.evict(self.blocks_held - self.max_blocks)
        return adopted

    def _split(self, node: RadixNode, n_blocks: int) -> RadixNode:
        """Split ``node``'s edge after ``n_blocks`` blocks; returns the new
        upper node (which keeps the prefix), with ``node`` demoted to its
        child carrying the remainder. Pins (ref) stay on the lower node —
        eviction is leaf-only, so an ancestor whose descendant is pinned
        can never be evicted, and inheriting the pin here would leak it
        when the pinning request releases the (lower) node it recorded."""
        bs = self.block_size
        cut = n_blocks * bs
        upper = RadixNode(tokens=node.tokens[:cut],
                          blocks=node.blocks[:n_blocks],
                          parent=node.parent, ref=0,
                          stamp=node.stamp)
        parent = node.parent
        parent.children[upper.tokens[:bs]] = upper
        node.tokens = node.tokens[cut:]
        node.blocks = node.blocks[n_blocks:]
        node.parent = upper
        upper.children[node.tokens[:bs]] = node
        return upper

    # -- eviction -----------------------------------------------------------

    def _leaves(self) -> List[RadixNode]:
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            kids = list(n.children.values())
            if not kids and n is not self.root:
                out.append(n)
            stack.extend(kids)
        return out

    def evict(self, n_blocks: int) -> int:
        """Reclaim at least ``n_blocks`` tree-held blocks if possible:
        repeatedly drop the LRU unpinned leaf (decref its blocks — a block
        an active request still owns survives in ITS table; the tree just
        stops advertising it). Returns how many blocks left the tree."""
        freed = 0
        while freed < n_blocks:
            victims = [n for n in self._leaves() if n.ref == 0]
            if not victims:
                break
            victim = min(victims, key=lambda n: n.stamp)
            self.allocator.decref(victim.blocks)
            freed += len(victim.blocks)
            self.blocks_held -= len(victim.blocks)
            self.evicted_blocks += len(victim.blocks)
            del victim.parent.children[victim.tokens[:self.block_size]]
        return freed

    # -- invalidation (weight swap) ------------------------------------------

    def invalidate(self) -> int:
        """Drop every cached prefix — the weight-swap contract: pooled
        k/v was computed under the OLD weights, so a post-swap request
        must never splice it (its stream would not match a cold engine on
        the new checkpoint). Unpinned nodes free their blocks now; nodes
        pinned by in-flight requests detach as ZOMBIES whose blocks free
        at their last :meth:`release` (the in-flight request keeps its own
        allocator refs and finishes under the mixed-context contract).
        Returns how many blocks left the tree immediately."""
        nodes: List[RadixNode] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                nodes.append(n)
            stack.extend(n.children.values())
        dropped = 0
        for n in nodes:
            n.children = {}
            if n.ref > 0:
                n.zombie = True
                self._zombies.append(n)
            else:
                self.allocator.decref(n.blocks)
                dropped += len(n.blocks)
                self.blocks_held -= len(n.blocks)
                self.evicted_blocks += len(n.blocks)
        self.root = RadixNode(tokens=(), blocks=[], parent=None)
        return dropped

    # -- defrag support ------------------------------------------------------

    def export_tables(self) -> Tuple[List[RadixNode], List[List[int]]]:
        """Every node's block list, for compaction: the scheduler passes
        these alongside the sequences' tables so ``defrag_plan`` renames
        EVERY referencing view (satellite contract: a radix node's table
        is a first-class block table). Zombie nodes (detached by
        :meth:`invalidate`, blocks still live until their pins release)
        are included — their blocks are pool blocks like any other."""
        nodes: List[RadixNode] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                nodes.append(n)
            stack.extend(n.children.values())
        nodes.extend(self._zombies)
        return nodes, [list(n.blocks) for n in nodes]

    def adopt_tables(self, nodes: Sequence[RadixNode],
                     tables: Sequence[Sequence[int]]) -> None:
        for n, t in zip(nodes, tables):
            n.blocks = list(t)
