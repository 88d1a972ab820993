"""The port's paged KV cache (``serving/kv_cache.py``) against the JAX
package on the CPU.

The allocator is host logic: the same script of allocations, shares,
releases, faults and compactions gives the same block ids, refcounts,
errors and ``defrag_plan`` as JAX's, exactly. The pool ops are exact
too (the same writes land in the same places); paged attention holds
JAX's within 1e-4 * (rms(want) + |want|) in fp32 and equals the port's
own ``_cached_sdpa`` on the gathered pages bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hetu_galvatron_tpu.core.args_schema import ModelArgs as JModelArgs
from hetu_galvatron_tpu.core.args_schema import ServingArgs as JServingArgs
from hetu_galvatron_tpu.serving import kv_cache as JK
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, ServingArgs
from hetu_galvatron_tpu_torch.models.generate import _cached_sdpa
from hetu_galvatron_tpu_torch.serving import kv_cache as TK

CFG = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=64, max_position_embeddings=64,
           seq_length=32, make_vocab_size_divisible_by=1)


def close(got, want, tol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lim = tol * (np.sqrt(np.mean(want ** 2)) + np.abs(want))
    assert (np.abs(got - want) <= lim).all()


def _outcome(fn):
    """What one call does: its result, or the class and text of its
    error."""
    try:
        return ("ok", fn())
    except ValueError as e:
        return (type(e).__name__, str(e))


def _script(rng, n_ops=300, num_blocks=12):
    """A random script of allocator calls over ids an owner holds, with
    deliberate faults (double frees, scratch, duplicates, bad ids)."""
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["alloc", "incref", "decref", "free", "fault",
                           "defrag"], p=[.3, .15, .25, .1, .12, .08])
        ops.append((kind, int(rng.integers(0, 1 << 30))))
    return ops


def _run_script(mod, ops, num_blocks=12):
    a = mod.BlockAllocator(num_blocks)
    held = []  # one entry per reference this script owns
    log = []
    for kind, r in ops:
        rng = np.random.default_rng(r)
        if kind == "alloc":
            got = a.alloc(int(rng.integers(0, 4)))
            if got:
                held += got
            log.append(("alloc", got))
        elif kind == "incref" and held:
            b = sorted(set(held))
            pick = [b[i] for i in rng.choice(len(b), min(2, len(b)),
                                             replace=False)]
            log.append(_outcome(lambda: a.incref(pick)))
            held += pick
        elif kind in ("decref", "free") and held:
            b = sorted(set(held))
            pick = [b[int(rng.integers(0, len(b)))]]
            out = _outcome(lambda: getattr(a, kind)(pick))
            log.append((kind, out))
            if out[0] == "ok":
                held.remove(pick[0])
                if kind == "free":
                    held = [h for h in held if h != pick[0]]
        elif kind == "fault":
            which = int(rng.integers(0, 5))
            if which == 0:
                log.append(_outcome(lambda: a.free([TK.SCRATCH_BLOCK])))
            elif which == 1:
                log.append(_outcome(lambda: a.decref([num_blocks + 3])))
            elif which == 2 and held:
                log.append(_outcome(lambda: a.decref([held[0], held[0]])))
            elif which == 3:
                free = [b for b in range(1, num_blocks) if a.refcount(b) == 0]
                if free:
                    log.append(_outcome(lambda: a.incref(free[:1])))
            else:
                log.append(_outcome(lambda: a.alloc(-1)))
        elif kind == "defrag":
            tables = [sorted(set(held))]
            out = _outcome(lambda: a.defrag_plan(tables))
            log.append(("defrag", out))
            if out[0] == "ok":
                remap = dict(zip(tables[0], out[1][1][0]))
                held = [remap[h] for h in held]
        log.append((a.available, a.used,
                    [a.refcount(b) for b in range(1, num_blocks)],
                    list(a._free)))
    return log


def test_torch_allocator_script_matches_jax():
    rng = np.random.default_rng(0)
    ops = _script(rng)
    got = _run_script(TK, ops)
    want = _run_script(JK, ops)
    assert got == want
    # the script reached the faults, and they raised the typed error
    text = repr(want)
    assert "BlockAccountingError" in text and "'defrag', ('ok'" in text


def test_torch_allocator_faults_are_typed():
    a = TK.BlockAllocator(8)
    x = a.alloc(1)
    a.incref(x)
    with pytest.raises(TK.BlockAccountingError, match="shared"):
        a.free(x)
    a.decref(x)
    a.free(x)
    with pytest.raises(TK.BlockAccountingError, match="double free"):
        a.free(x)
    y = a.alloc(1)
    with pytest.raises(TK.BlockAccountingError, match="duplicate"):
        a.decref(y + y)
    with pytest.raises(ValueError, match="need >= 2"):
        TK.BlockAllocator(1)
    assert issubclass(TK.BlockAccountingError, ValueError)


def test_torch_pool_ops_match_jax_exactly():
    rng = np.random.default_rng(1)
    P, bs, K, D = 7, 4, 2, 8
    base = rng.standard_normal((P, bs, K, D)).astype(np.float32)
    tpool = torch.as_tensor(base.copy())
    jpool = jnp.asarray(base)
    # prefill run into blocks out of order
    kv = rng.standard_normal((8, K, D)).astype(np.float32)
    table = np.asarray([5, 2])
    TK.scatter_prefill(tpool, torch.as_tensor(kv), torch.as_tensor(table))
    jpool = JK.scatter_prefill(jpool, jnp.asarray(kv), jnp.asarray(table))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    # one token per slot, one slot parked on scratch
    tok = rng.standard_normal((3, K, D)).astype(np.float32)
    blocks, offs = np.asarray([2, 0, 6]), np.asarray([3, 1, 0])
    TK.scatter_token(tpool, torch.as_tensor(tok), torch.as_tensor(blocks),
                     torch.as_tensor(offs))
    jpool = JK.scatter_token(jpool, jnp.asarray(tok), jnp.asarray(blocks),
                             jnp.asarray(offs))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    # a window per slot
    win = rng.standard_normal((2, 3, K, D)).astype(np.float32)
    wb = np.asarray([[5, 5, 2], [6, 6, 6]])
    wo = np.asarray([[2, 3, 0], [1, 2, 3]])
    TK.scatter_window(tpool, torch.as_tensor(win), torch.as_tensor(wb),
                      torch.as_tensor(wo))
    jpool = JK.scatter_window(jpool, jnp.asarray(win), jnp.asarray(wb),
                              jnp.asarray(wo))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    TK.copy_block(tpool, 5, 3)
    jpool = JK.copy_block(jpool, 5, 3)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    tables = np.asarray([[5, 2, 0], [3, 6, 1]])
    np.testing.assert_array_equal(
        TK.gather_pages(tpool, torch.as_tensor(tables)).numpy(),
        np.asarray(JK.gather_pages(jpool, jnp.asarray(tables))))


def test_torch_paged_attention_matches_jax_and_the_dense_core():
    rng = np.random.default_rng(2)
    S, W, T, nq, nkv, D = 3, 4, 16, 4, 2, 8
    q = rng.standard_normal((S, W, nq, D)).astype(np.float32)
    ck = rng.standard_normal((S, T, nkv, D)).astype(np.float32)
    cv = rng.standard_normal((S, T, nkv, D)).astype(np.float32)
    pos = np.asarray([2, 9, 12])
    tq, tk, tv = map(torch.as_tensor, (q, ck, cv))
    got = TK.paged_sdpa(tq[:, :1], tk, tv, torch.as_tensor(pos))
    close(got, JK.paged_sdpa(jnp.asarray(q[:, :1]), jnp.asarray(ck),
                             jnp.asarray(cv), jnp.asarray(pos)))
    win = TK.paged_sdpa_window(tq, tk, tv, torch.as_tensor(pos))
    close(win, JK.paged_sdpa_window(jnp.asarray(q), jnp.asarray(ck),
                                    jnp.asarray(cv), jnp.asarray(pos)))
    # both are the dense core on the gathered pages
    assert torch.equal(got, _cached_sdpa(tq[:, :1], tk, tv,
                                         torch.as_tensor(pos)))
    for b in range(S):
        one = _cached_sdpa(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1], int(pos[b]))
        close(win[b:b + 1], one, tol=1e-6)
    # row j of the window is the decode step at position pos + j
    for j in range(W):
        close(win[:, j:j + 1],
              TK.paged_sdpa(tq[:, j:j + 1], tk, tv,
                            torch.as_tensor(pos + j)), tol=1e-6)


def test_torch_paged_cache_sizing_and_defrag_match_jax():
    tcfg, jcfg = ModelArgs(**CFG), JModelArgs(**CFG)
    tkv = TK.PagedKVCache(tcfg, num_blocks=9, block_size=4, max_seq_len=10,
                          dtype=torch.float32)
    jkv = JK.PagedKVCache(jcfg, num_blocks=9, block_size=4, max_seq_len=10,
                          dtype=jnp.float32)
    assert tuple(tkv.pools[0]["k"].shape) == jkv.pools[0]["k"].shape
    assert tkv.max_blocks_per_seq == jkv.max_blocks_per_seq == 3
    for n in (1, 4, 9, 10, 12, 13):
        assert tkv.blocks_for(n) == jkv.blocks_for(n)
        assert tkv.fits(n) == jkv.fits(n)
    assert tkv.bytes_per_block() == jkv.bytes_per_block()
    rng = np.random.default_rng(3)
    for kv in (tkv, jkv):
        a = kv.allocator
        shared = a.alloc(2)
        a.incref(shared)
        hole = a.alloc(1)
        private = a.alloc(2)
        a.decref(hole)
        kv._tables = [shared + private, list(shared)]
    assert tkv._tables == jkv._tables
    vals = rng.standard_normal(tuple(tkv.pools[0]["k"].shape)).astype(
        np.float32)
    for layer in range(2):
        tkv.pools[layer]["k"] = torch.as_tensor(vals + layer)
        jkv.pools[layer]["k"] = jnp.asarray(vals + layer)
    assert tkv.occupancy == jkv.occupancy
    got = tkv.defrag(tkv._tables)
    want = jkv.defrag(jkv._tables)
    assert got == want
    for layer in range(2):
        np.testing.assert_array_equal(tkv.pools[layer]["k"].numpy(),
                                      np.asarray(jkv.pools[layer]["k"]))
    assert tkv.allocator._rc == jkv.allocator._rc
    assert tkv.allocator._free == jkv.allocator._free
    with pytest.raises(ValueError, match="disagree"):
        tkv.defrag([got[0][:1]])


@pytest.mark.parametrize("over", [
    {}, {"num_kv_blocks": 100}, {"max_seq_len": 100, "max_batch_size": 3},
    {"kv_block_size": 32}])
def test_torch_pool_sizing_arithmetic_matches_jax(over):
    spec = dict(CFG, num_key_value_heads=2)
    tsv, jsv = ServingArgs(**over), JServingArgs(**over)
    tcfg, jcfg = ModelArgs(**spec), JModelArgs(**spec)
    assert TK.resolve_num_blocks(tsv, tcfg) == \
        JK.resolve_num_blocks(jsv, jcfg)
    for tp in (1, 2, 4):
        assert TK.kv_pool_mb(tsv, tcfg, tp=tp) == \
            JK.kv_pool_mb(jsv, jcfg, tp=tp)
