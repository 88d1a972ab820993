"""The port's continuous-batching scheduler and radix prefix cache
(``serving/scheduler.py``, ``serving/prefix_cache.py``) against the JAX
package on the CPU: host logic, held exactly.

Seeded scripts of submits, admissions, prefill notes, retirements,
cancellations, timeouts, evictions, invalidations and compactions run
through both packages' ``Scheduler`` + ``PrefixCache`` + ``BlockAllocator``;
after every call the admissions (slots, block tables, owned and shared
blocks, cached lengths, copy-on-write pairs), the handles' states, the
allocator's refcounts and free list, the radix tree (edges, blocks, pins,
stats) and the decode view must be equal.
"""

import itertools
import time

import numpy as np
import pytest

from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.serving import kv_cache as JK
from hetu_galvatron_tpu.serving import prefix_cache as JP
from hetu_galvatron_tpu.serving import scheduler as JS
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.serving import kv_cache as TK
from hetu_galvatron_tpu_torch.serving import prefix_cache as TP
from hetu_galvatron_tpu_torch.serving import scheduler as TS

JAX = (JModelArgs, JK, JP, JS)
PORT = (ModelArgs, TK, TP, TS)
CFG = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
           vocab_size=64, max_position_embeddings=64, seq_length=16,
           make_vocab_size_divisible_by=1)


def _tree(node):
    return (node.tokens, tuple(node.blocks), node.ref, node.zombie,
            tuple(_tree(node.children[k]) for k in sorted(node.children)))


def _snapshot(s, prefix, handles):
    a = s.kv.allocator
    state = [list(a._free), list(a._rc),
             [(h.status, h.finish_reason, h.cached_tokens) for h in handles],
             [(sl.index, sl.blocks, sl.owned_blocks, sl.shared_blocks,
               sl.cached_len, sl.cow, sl.pos, sl.limit, sl.last_token)
              for sl in s.active],
             s.decode_state(), s.queue_depth, s.rejected, s.completed]
    if prefix is not None:
        state += [_tree(prefix.root), prefix.blocks_held, prefix.lookups,
                  prefix.hits, prefix.cached_tokens_served,
                  prefix.evicted_blocks,
                  [_tree(z) for z in prefix._zombies]]
    return state


def _make(pkg, *, num_blocks, block_size, max_seq_len, max_slots,
          prefix=True, prefix_max=0, **kw):
    cfg_cls, K, P, S = pkg
    cfg = cfg_cls(**CFG)
    kv = K.PagedKVCache(cfg, num_blocks=num_blocks, block_size=block_size,
                        max_seq_len=max_seq_len)
    pc = (P.PrefixCache(kv.allocator, block_size, max_blocks=prefix_max)
          if prefix else None)
    s = S.Scheduler(kv, max_slots=max_slots, max_position_embeddings=64,
                    prefix_cache=pc, **kw)
    return s, pc


def _script(seed, n_ops=160):
    rng = np.random.default_rng(seed)
    families = [rng.integers(0, 64, 24).tolist() for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(
            ["submit", "admit", "retire", "cancel", "timeout", "evict",
             "defrag", "invalidate"],
            p=[.34, .26, .18, .06, .05, .04, .04, .03])
        fam = families[int(rng.integers(0, 3))]
        cut = int(rng.choice([0, 4, 8, 12, 16, 24]))
        # a third of the prompts are whole blocks of a family: the fully
        # cached path (copy-on-write) when the tree holds them
        n_tail = 0 if rng.random() < 0.35 else int(rng.integers(1, 9))
        tail = rng.integers(0, 64, n_tail).tolist()
        prompt = (fam[:cut] + tail) or [1]
        ops.append((str(kind), prompt, int(rng.integers(1, 9)),
                    int(rng.integers(0, 1 << 20))))
    return ops


def _run(pkg, ops, **make_kw):
    s, pc = _make(pkg, **make_kw)
    cls = pkg[3].Request
    handles, log = [], []
    rid = itertools.count()
    for kind, prompt, max_new, r in ops:
        pick = np.random.default_rng(r)
        if kind == "submit":
            timeout = float(pick.choice([0.0, 0.0, 1e6]))
            h = s.submit(cls(tokens=prompt, max_new_tokens=max_new,
                             timeout_s=timeout, rid=next(rid)))
            handles.append(h)
        elif kind == "admit":
            got = s.admit()
            log.append([(sl.index, b) for sl, b in got])
            for sl, _ in got:
                log.append(s.note_prefilled(sl))
        elif kind == "retire" and s.slots:
            sl = s.active[int(pick.integers(0, len(s.slots)))]
            s.retire(sl, "done", str(pick.choice(["eos", "length"])))
        elif kind == "cancel" and handles:
            handles[int(pick.integers(0, len(handles)))].cancel()
            log.append((s.sweep(), s.sweep_waiting()))
        elif kind == "timeout":
            # every request with a deadline has passed it
            later = time.monotonic() + 2e6
            log.append((s.sweep(later), s.sweep_waiting(later)))
        elif kind == "evict" and pc is not None:
            log.append(pc.evict(int(pick.integers(1, 4))))
        elif kind == "defrag":
            s.defrag()
        elif kind == "invalidate" and pc is not None:
            log.append(pc.invalidate())
        log.append(_snapshot(s, pc, handles))
    # drain: everything retires, the pins release, only the tree holds
    while s.has_work():
        for sl in list(s.active):
            s.retire(sl, "done", "length")
        s.admit()
    log.append(_snapshot(s, pc, handles))
    return log, s, pc


SETTINGS = {
    "prefix_tight_pool": dict(num_blocks=14, block_size=4, max_seq_len=32,
                              max_slots=3),
    "prefix_cap_and_budget": dict(num_blocks=30, block_size=4,
                                  max_seq_len=40, max_slots=4, prefix_max=6,
                                  max_prefill_tokens=16),
    "flops_budget": dict(num_blocks=40, block_size=8, max_seq_len=48,
                         max_slots=2, prefill_flops_budget=3000.0,
                         flops_per_token=100.0),
    "no_prefix": dict(num_blocks=12, block_size=4, max_seq_len=32,
                      max_slots=2, prefix=False),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("seed", [0, 3])
def test_torch_scheduler_script_matches_jax(setting, seed):
    ops = _script(seed)
    got, s, pc = _run(PORT, ops, **SETTINGS[setting])
    want, _, _ = _run(JAX, ops, **SETTINGS[setting])
    assert got == want
    # at idle the allocator holds the tree's blocks and nothing else
    held = pc.blocks_held if pc is not None else 0
    assert s.kv.allocator.used == held
    if pc is not None and setting == "prefix_tight_pool":
        # the script reached hits, evictions and fully cached prompts
        assert pc.hits and pc.evicted_blocks
        assert any(slot[5] is not None for snap in want
                   if isinstance(snap, list) and len(snap) > 8
                   for slot in snap[3])


def test_torch_bucket_length_matches_jax():
    for n in range(1, 70):
        for bs, cap in ((4, 32), (16, 112), (8, 8), (4, 12)):
            assert TS.bucket_length(n, bs, cap) == JS.bucket_length(n, bs,
                                                                    cap)


def test_torch_request_handle_stream_result_cancel():
    h = TS.RequestHandle(TS.Request(tokens=[1, 2], max_new_tokens=3))
    assert h.ttft_s() is None and not h.done()
    h._emit(5)
    h._emit(7)
    assert h.ttft_s() >= 0.0
    with pytest.raises(TimeoutError):
        h.result(timeout=0.01)
    h.cancel()
    assert h.cancelled
    h._finish("cancelled", "cancelled")
    assert list(h.tokens()) == [5, 7] and list(h.tokens()) == []
    assert h.result(0) == [5, 7] and h.status == "cancelled"


def test_torch_prefix_cache_zombie_pins_match_jax():
    """An invalidation while a request pins a path: the node leaves the
    tree as a zombie and frees its blocks at the last release."""
    outs = []
    for _, K, P, _ in (JAX, PORT):
        a = K.BlockAllocator(16)
        pc = P.PrefixCache(a, 4)
        toks = list(range(12))
        blocks = a.alloc(3)
        pc.insert(toks, blocks)
        a.decref(blocks)
        n, got, path = pc.match(toks + [99])
        dropped = pc.invalidate()
        mid = (a.used, pc.blocks_held, len(pc._zombies))
        pc.release(path)
        outs.append((n, got, dropped, mid, a.used, pc.blocks_held,
                     pc.evicted_blocks, pc.match(toks)[0]))
    assert outs[0] == outs[1]
    assert outs[1][3] == (3, 3, 1) and outs[1][4] == 0
