"""Continuous-batching scheduler: admission, slots, retirement, recycling.

Port of ``hetu_galvatron_tpu/serving/scheduler.py`` (``Request``,
``RequestHandle``, ``Slot``, ``bucket_length`` :182, ``Scheduler`` :194),
host logic only: the same admissions, block tables, evictions, retirements
and decode views as the JAX scheduler for the same sequence of calls.

* **Admission** is token-budget based. A request is admitted when a
  decode slot is free, the paged KV pool can hold its whole budget
  (prompt + ``max_new_tokens``, allocated up front so a running sequence
  never runs the pool dry) and the step's prefill budget has room (a
  token cap, or a FLOPs budget over the cost model's forward FLOPs per
  token). A request that can never be served is rejected at once.
* **Slots** are fixed: ``max_batch_size`` sequences decode together at
  one shape. Retired slots park on the scratch block and recycle on the
  next admission.
* **Retirement** (eos, length, cancellation, timeout) decrefs, never
  strict-frees: blocks the radix prefix cache co-owns stay resident.
* **Prefix-aware admission**: the cached block-aligned prefix of a prompt
  is matched copy-free into the block table and only the uncached suffix
  is charged; a fully cached prompt dispatches no prefill and bootstraps
  its first token through the decode step (the block of its last prompt
  position is duplicated, copy-on-write, first).

Prompt lengths are bucketed to ``block_size * 2^k``, so the set of
prefill shapes is logarithmic in the longest prompt.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hetu_galvatron_tpu_torch.serving.kv_cache import PagedKVCache, SCRATCH_BLOCK
from hetu_galvatron_tpu_torch.serving.prefix_cache import PrefixCache

_req_counter = itertools.count()

# terminal states a handle can land in
FINISHED = ("done", "cancelled", "timeout", "rejected", "error")


@dataclass
class Request:
    """One generation request. ``seed`` drives the per-request sampling
    stream (folded with the emitted-token index), so a request's tokens do
    not depend on which neighbors share its batch."""

    tokens: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    timeout_s: float = 0.0  # 0 = no deadline
    rid: int = field(default_factory=lambda: next(_req_counter))


class RequestHandle:
    """Caller-facing stream for one request.

    ``tokens()`` yields generated ids as they are produced (blocking
    iterator, ends at retirement); ``result()`` waits for completion and
    returns the full list; ``cancel()`` asks the engine to retire the
    request at the next step boundary.
    """

    _SENTINEL = object()

    def __init__(self, request: Request):
        self.request = request
        self.status = "queued"
        self.finish_reason: Optional[str] = None
        self.cached_tokens = 0  # prompt tokens served by the prefix cache
        self.output: List[int] = []
        self.submitted_t = time.monotonic()
        self.admitted_t: Optional[float] = None  # slot granted (queue end)
        self.first_token_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self._q: "queue.Queue[Any]" = queue.Queue()
        self._done = threading.Event()
        self._cancel = False

    # -- engine side --------------------------------------------------------

    def _emit(self, token: int) -> None:
        now = time.monotonic()
        if self.first_token_t is None:
            self.first_token_t = now
        self.output.append(int(token))
        self._q.put(int(token))

    def _finish(self, status: str, reason: str) -> None:
        self.status = status
        self.finish_reason = reason
        self.finished_t = time.monotonic()
        self._q.put(self._SENTINEL)
        self._done.set()

    # -- caller side --------------------------------------------------------

    @property
    def cancelled(self) -> bool:
        return self._cancel

    def cancel(self) -> None:
        self._cancel = True

    def done(self) -> bool:
        return self._done.is_set()

    def tokens(self):
        """Blocking per-token stream; terminates when the request retires.
        Safe to call again after the stream drained (returns immediately
        instead of blocking on the already-consumed sentinel)."""
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._done.is_set():
                    return
                continue
            if item is self._SENTINEL:
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.request.rid} still running")
        return list(self.output)

    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted_t


@dataclass
class Slot:
    """One decode lane: the sequence occupying it plus its paged-cache
    view. ``pos`` is the context length (tokens already in the cache);
    ``last_token`` is the next decode step's input.

    Prefix-cache bookkeeping: ``blocks`` is the TABLE view (shared prefix
    blocks + private blocks); ``owned_blocks`` are the ones this sequence
    allocated (decref'd at retirement — shared blocks are pinned via
    ``prefix_path`` instead). ``cached_len`` prompt tokens were served
    from the cache; ``cow`` asks the engine to copy one block
    (src, dst) before the slot's first decode step; ``limit`` is the last
    absolute position this sequence may ever write (spec-decode windows
    mask writes past it at the scratch block)."""

    index: int
    handle: RequestHandle
    blocks: List[int]
    pos: int
    last_token: int
    generated: int = 0
    last_token_t: float = 0.0
    prefill_ms: float = 0.0  # host wall of this slot's prefill dispatch
    cached_len: int = 0
    owned_blocks: List[int] = field(default_factory=list)
    shared_blocks: List[int] = field(default_factory=list)
    prefix_path: Tuple = ()
    cow: Optional[Tuple[int, int]] = None
    limit: int = 0

    @property
    def request(self) -> Request:
        return self.handle.request


def bucket_length(prompt_len: int, block_size: int,
                  cap_tokens: int) -> int:
    """Smallest ``block_size * 2^k`` >= prompt_len (capped at the pool's
    per-sequence table capacity ``cap_tokens``): prefill programs exist per
    bucket, not per length, so steady-state traffic stops compiling once
    the buckets are warm."""
    b = block_size
    while b < prompt_len and b < cap_tokens:
        b *= 2
    return min(b, cap_tokens)


class Scheduler:
    """Queue + slots + allocator choreography (host logic only)."""

    def __init__(
        self,
        kv: PagedKVCache,
        *,
        max_slots: int,
        max_position_embeddings: int,
        prefill_flops_budget: float = 0.0,
        flops_per_token: float = 0.0,
        max_prefill_tokens: int = 0,
        prefix_cache: Optional[PrefixCache] = None,
        events: Optional[Any] = None,
    ):
        self.kv = kv
        self.prefix = prefix_cache
        # request-lifecycle event stream (observability/events.py): the
        # scheduler emits the transitions it owns — submit, admit (incl.
        # the cold-retry livelock fallback), retire — with the stable
        # Request.rid; None degrades every emit to a no-op
        self.events = events
        self.max_slots = int(max_slots)
        self.max_positions = int(max_position_embeddings)
        # per-step prefill token budget: the tighter of the explicit token
        # cap and the FLOPs budget / cost-model per-token FLOPs
        caps = []
        if max_prefill_tokens > 0:
            caps.append(max_prefill_tokens)
        if prefill_flops_budget > 0 and flops_per_token > 0:
            caps.append(max(int(prefill_flops_budget // flops_per_token), 1))
        self.prefill_token_cap = min(caps) if caps else 0  # 0 = unlimited
        self.waiting: List[RequestHandle] = []
        self.slots: Dict[int, Slot] = {}
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self.rejected = 0
        self.completed = 0

    # -- intake -------------------------------------------------------------

    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks a request holds while running: its total-length need or
        its prefill bucket, whichever is larger (the bucket may overshoot
        ceil(total/bs) for prompts just past a power-of-two boundary)."""
        bucket = bucket_length(
            prompt_len, self.kv.block_size,
            self.kv.max_blocks_per_seq * self.kv.block_size)
        return max(self.kv.blocks_for(prompt_len + max_new),
                   bucket // self.kv.block_size)

    def _emit(self, ev: str, rid: int, **fields) -> None:
        if self.events is not None:
            self.events.emit(ev, rid, **fields)

    def submit(self, request: Request) -> RequestHandle:
        handle = RequestHandle(request)
        self._emit("submit", request.rid, prompt_len=len(request.tokens),
                   max_new=request.max_new_tokens)
        total = len(request.tokens) + request.max_new_tokens
        if (not request.tokens or request.max_new_tokens < 1
                or not self.kv.fits(total)
                or total > self.max_positions
                # can NEVER be satisfied even by an empty pool -> reject
                # now instead of queueing forever
                or (self._blocks_needed(len(request.tokens),
                                        request.max_new_tokens)
                    > self.kv.num_blocks - 1)):
            self.rejected += 1
            handle._finish("rejected", "capacity")
            self._emit("retire", request.rid, status="rejected",
                       reason="capacity", generated=0)
            return handle
        handle.status = "queued"
        self.waiting.append(handle)
        return handle

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def active(self) -> List[Slot]:
        return [self.slots[i] for i in sorted(self.slots)]

    def has_work(self) -> bool:
        return bool(self.waiting or self.slots)

    # -- admission ----------------------------------------------------------

    def _alloc_or_evict(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, evicting cold radix nodes LRU-first when
        the free list alone cannot satisfy the request (active sequences'
        blocks are pinned and never touched)."""
        blocks = self.kv.allocator.alloc(n)
        if blocks is None and self.prefix is not None:
            self.prefix.evict(n - self.kv.allocator.available)
            blocks = self.kv.allocator.alloc(n)
        return blocks

    def _need_for(self, prompt_len: int, max_new: int, cached_len: int,
                  bucket: int) -> int:
        """Private blocks an admission must allocate on top of its
        ``cached_len`` shared prefix tokens."""
        bs = self.kv.block_size
        n_cached = cached_len // bs
        total_need = self.kv.blocks_for(prompt_len + max_new)
        if prompt_len - cached_len:
            # the rest of the budget, or the suffix bucket's overshoot
            # past a power-of-two boundary — clipped at the per-sequence
            # table capacity (the prefix prefill routes bucket lanes past
            # it to scratch)
            cover = min(n_cached + bucket // bs,
                        self.kv.max_blocks_per_seq)
            return max(total_need, cover) - n_cached
        # fully cached: +1 for the copy-on-write duplicate of the block
        # holding the last prompt position (the bootstrap decode step
        # rewrites that position)
        return total_need - n_cached + 1

    def admit(self) -> List[Tuple[Slot, int]]:
        """Admit waiting requests into free slots under the block + prefill
        budget. Returns ``(slot, suffix_bucket)`` pairs: the engine must
        prefill each slot's UNCACHED prompt suffix this step
        (``suffix_bucket == 0`` means fully cached — no prefill dispatch
        at all; the slot enters decode directly and its first token comes
        from the next decode step). Only the uncached suffix is charged
        against the prefill budget. At least one request is admitted per
        call when a slot and blocks are available, even if its bucket
        exceeds the prefill cap — a cap below the smallest bucket must not
        deadlock."""
        self._drop_cancelled_waiting()
        admitted: List[Tuple[Slot, int]] = []
        budget_used = 0
        cap_tokens = self.kv.max_blocks_per_seq * self.kv.block_size
        bs = self.kv.block_size
        while self.waiting and self._free_slots:
            handle = self.waiting[0]
            req = handle.request
            prompt_len = len(req.tokens)
            cached_len, shared, path = 0, [], ()
            if self.prefix is not None:
                cached_len, shared, path = self.prefix.match(req.tokens)
                if not getattr(handle, "_prefix_counted", False):
                    # stats once per REQUEST: a deferred head-of-queue
                    # request is re-matched every step and must not
                    # inflate the hit-rate gauge on each retry
                    handle._prefix_counted = True
                    self.prefix.note_lookup(cached_len)
            suffix = prompt_len - cached_len
            bucket = bucket_length(suffix, bs, cap_tokens) if suffix else 0
            if self.prefill_token_cap and admitted and bucket and (
                    budget_used + bucket > self.prefill_token_cap):
                if path:
                    self.prefix.release(path)
                break
            need = self._need_for(prompt_len, req.max_new_tokens,
                                  cached_len, bucket)
            owned = self._alloc_or_evict(need)
            cold_retry = False
            if owned is None and path:
                # the match itself pins the path, which can make the
                # request UNADMITTABLE forever (its own cached blocks are
                # the only evictable ones) — retry as a cold request with
                # the pins dropped before concluding the pool is full
                self.prefix.release(path)
                cached_len, shared, path = 0, [], ()
                cold_retry = True
                suffix = prompt_len
                bucket = bucket_length(suffix, bs, cap_tokens)
                if self.prefill_token_cap and admitted and (
                        budget_used + bucket > self.prefill_token_cap):
                    break  # requeued; admits (cold or hit) next step
                need = self._need_for(prompt_len, req.max_new_tokens,
                                      0, bucket)
                owned = self._alloc_or_evict(need)
            if owned is None:
                if path:
                    self.prefix.release(path)
                break  # pool full; FIFO order preserved
            # the request takes its own reference on every matched block
            # (on top of the node pins), so a stray free() of a block a
            # live sequence is reading raises instead of corrupting it
            self.kv.allocator.incref(shared)
            self.waiting.pop(0)
            idx = self._free_slots.pop()
            cow = None
            if suffix:
                table = shared + owned
            else:
                cow = (shared[-1], owned[0])
                table = shared[:-1] + owned
            now = time.monotonic()
            slot = Slot(index=idx, handle=handle, blocks=table,
                        pos=prompt_len - (0 if suffix else 1),
                        last_token=req.tokens[-1],
                        last_token_t=now,
                        cached_len=cached_len, owned_blocks=owned,
                        shared_blocks=list(shared),
                        prefix_path=path, cow=cow,
                        limit=prompt_len + req.max_new_tokens - 1)
            handle.status = "running"
            handle.cached_tokens = cached_len
            handle.admitted_t = now
            self.slots[idx] = slot
            admitted.append((slot, bucket))
            budget_used += bucket
            self._emit("admit", req.rid, slot=idx,
                       queue_ms=(now - handle.submitted_t) * 1000.0,
                       cached_len=cached_len, hit_blocks=len(shared),
                       suffix=suffix, bucket=bucket, cold_retry=cold_retry)
        return admitted

    def note_prefilled(self, slot: Slot) -> List[int]:
        """Offer a freshly prefilled prompt's full blocks to the radix
        cache (the engine calls this right after the prefill dispatch).
        Returns the block ids the tree adopted (it holds its own
        references; the slot keeps decref'ing its ``owned_blocks`` at
        retirement as usual)."""
        if self.prefix is None:
            return []
        n_full = len(slot.request.tokens) // self.kv.block_size
        if n_full == 0 or slot.cached_len >= n_full * self.kv.block_size:
            return []
        return self.prefix.insert(
            slot.request.tokens[: n_full * self.kv.block_size],
            slot.blocks[:n_full])

    def _drop_cancelled_waiting(self) -> None:
        self.sweep_waiting()

    def sweep_waiting(self, now: Optional[float] = None
                      ) -> Tuple[int, int]:
        """Resolve cancelled and deadline-expired requests still in the
        queue (a request whose timeout lapsed while queued must not be
        admitted, prefilled, and only then retired — that wastes device
        work and pollutes the TTFT histogram). Returns
        ``(n_cancelled, n_timeout)``."""
        now = time.monotonic() if now is None else now
        n_cancel = n_timeout = 0
        still = []
        for h in self.waiting:
            if h.cancelled:
                h._finish("cancelled", "cancelled")
                self._emit("retire", h.request.rid, status="cancelled",
                           reason="cancelled", generated=0, queued=True)
                n_cancel += 1
            elif (h.request.timeout_s > 0
                  and now - h.submitted_t > h.request.timeout_s):
                h._finish("timeout", "timeout")
                self._emit("retire", h.request.rid, status="timeout",
                           reason="timeout", generated=0, queued=True)
                n_timeout += 1
            else:
                still.append(h)
        self.waiting = still
        return n_cancel, n_timeout

    # -- retirement ---------------------------------------------------------

    def retire(self, slot: Slot, status: str, reason: str) -> None:
        """Drop the slot's block references (decref, NOT strict free —
        blocks the radix cache adopted stay resident for future hits),
        unpin its prefix path, recycle the lane, resolve the handle."""
        self.kv.allocator.decref(slot.owned_blocks)
        if slot.shared_blocks:
            self.kv.allocator.decref(slot.shared_blocks)
        if slot.prefix_path:
            self.prefix.release(slot.prefix_path)
        del self.slots[slot.index]
        self._free_slots.append(slot.index)
        if status == "done":
            self.completed += 1
        slot.handle._finish(status, reason)
        self._emit("retire", slot.request.rid, status=status, reason=reason,
                   generated=slot.generated)

    def sweep(self, now: Optional[float] = None) -> Tuple[int, int]:
        """Retire cancelled / deadline-expired active sequences; returns
        ``(n_cancelled, n_timeout)`` — the single home of the retirement
        predicate (the engine's metric split reads these counts rather
        than re-deriving them)."""
        now = time.monotonic() if now is None else now
        n_cancel = n_timeout = 0
        for slot in list(self.slots.values()):
            h = slot.handle
            if h.cancelled:
                self.retire(slot, "cancelled", "cancelled")
                n_cancel += 1
            elif (h.request.timeout_s > 0
                  and now - h.submitted_t > h.request.timeout_s):
                self.retire(slot, "timeout", "timeout")
                n_timeout += 1
        return n_cancel, n_timeout

    # -- decode batch view --------------------------------------------------

    def padded_table(self, blocks: Sequence[int]) -> List[int]:
        t = list(blocks)[: self.kv.max_blocks_per_seq]
        return t + [SCRATCH_BLOCK] * (self.kv.max_blocks_per_seq - len(t))

    def decode_state(self) -> Dict[str, List]:
        """Fixed-shape per-lane arrays for the decode program. Inactive
        lanes feed token 0 at position 0 against the scratch block; their
        outputs are discarded host-side. ``limit`` bounds each lane's
        writable positions (the speculative verify window routes writes
        past it at the scratch block; parked lanes sit at 0 so their whole
        window lands on scratch)."""
        S, MB = self.max_slots, self.kv.max_blocks_per_seq
        state = {
            "tokens": [0] * S,
            "pos": [0] * S,
            "tables": [[SCRATCH_BLOCK] * MB for _ in range(S)],
            "temps": [0.0] * S,
            "seeds": [0] * S,
            "gen_idx": [0] * S,
            "active": [False] * S,
            "limit": [0] * S,
        }
        for i, slot in self.slots.items():
            req = slot.request
            state["tokens"][i] = slot.last_token
            state["pos"][i] = slot.pos
            state["tables"][i] = self.padded_table(slot.blocks)
            state["temps"][i] = float(req.temperature)
            state["seeds"][i] = int(req.seed)
            state["gen_idx"][i] = slot.generated
            state["active"][i] = True
            state["limit"][i] = slot.limit
        return state

    # -- maintenance --------------------------------------------------------

    def defrag(self) -> None:
        """Compact live blocks to the low pool indices, rewriting EVERY
        referencing view: each active sequence's table and ownership list
        AND every radix node's block list (a node's table is as live as a
        sequence's — a stale one would hand future hits permuted ids)."""
        slots = self.active
        tables: List[List[int]] = [list(s.blocks) for s in slots]
        tables += [list(s.owned_blocks) for s in slots]
        tables += [list(s.shared_blocks) for s in slots]
        nodes: List = []
        if self.prefix is not None:
            nodes, node_tables = self.prefix.export_tables()
            tables += node_tables
        new = self.kv.defrag(tables)
        n = len(slots)
        for s, t in zip(slots, new[:n]):
            s.blocks = t
        for s, t in zip(slots, new[n:2 * n]):
            s.owned_blocks = t
        for s, t in zip(slots, new[2 * n:3 * n]):
            s.shared_blocks = t
        if self.prefix is not None:
            self.prefix.adopt_tables(nodes, new[3 * n:])
