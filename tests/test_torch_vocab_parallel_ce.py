"""The vocab-parallel cross-entropy (``ops/cross_entropy.
make_vocab_parallel_ce``) on gloo ranks against JAX's
``ops/pallas/cross_entropy.make_vocab_parallel_ce`` over a 4-device slice
of the virtual CPU mesh, the Pallas kernels in interpret mode.

On the CPU each rank runs K4/K5's plain versions on its ``[T_l, V / vtp]``
logits with the labels offset by its shard (most fall outside it), merges
the lse over the vocab group and sums the gold; the backward is K5 against
the merged lse. The NLL and the gradient of every logit, assembled from
the ranks, are held to JAX's at 1e-5, with and without a z-loss, under
vtp 4 and vtp 2 x dp 2. The unfused variant (the plain K4/K5 on any
device) is held to JAX's plain per-token NLL on the whole logits. One
world of four ranks runs every case."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_galvatron_tpu.ops.pallas import cross_entropy as JC
from hetu_galvatron_tpu.runtime import mesh as JM
from hetu_galvatron_tpu.utils.strategy import DPType as JDP
from hetu_galvatron_tpu.utils.strategy import EmbeddingLMHeadStrategy as JE
from hetu_galvatron_tpu_torch.parallel.launch import spawn_world

B, S, V = 4, 8, 512
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [dict(vtp=4, fused=True, z=0.0), dict(vtp=4, fused=True, z=1e-4),
         dict(vtp=2, fused=True, z=1e-4), dict(vtp=2, fused=False, z=0.0),
         dict(vtp=4, fused=False, z=1e-4)]


def data(seed=0):
    rs = np.random.RandomState(seed)
    logits = (3.0 * rs.randn(B, S, V)).astype(np.float32)
    labels = rs.randint(0, V, (B, S)).astype(np.int64)
    cot = rs.randn(B, S).astype(np.float32)
    return logits, labels, cot


def _ranks(rank, world, cases):
    from hetu_galvatron_tpu_torch.ops.cross_entropy import (
        make_vocab_parallel_ce,
    )
    from hetu_galvatron_tpu_torch.parallel.spmd import batch_sharding
    from hetu_galvatron_tpu_torch.runtime.mesh import (
        GroupCache,
        build_mesh,
        lower_vocab_strategy,
    )
    from hetu_galvatron_tpu_torch.utils.strategy import (
        DPType,
        EmbeddingLMHeadStrategy,
    )

    logits, labels, cot = (torch.from_numpy(x) for x in data())
    mesh = build_mesh(world)
    groups = GroupCache(mesh, rank)
    out = []
    for case in cases:
        sh = lower_vocab_strategy(EmbeddingLMHeadStrategy(vtp=case["vtp"]),
                                  mesh, DPType.DDP)
        group = groups.build([sh.tp_axes]).get(sh.tp_axes)
        rows = batch_sharding(sh, mesh, rank)
        vl = V // case["vtp"]
        local = rows(logits)[..., group.index * vl:(group.index + 1) * vl]
        local = local.clone().requires_grad_(True)
        nll = make_vocab_parallel_ce(group, fused=case["fused"],
                                     z_loss=case["z"])(local, rows(labels))
        (grad,) = torch.autograd.grad((nll * rows(cot)).sum(), local)
        out.append(dict(nll=nll.detach().numpy(), grad=grad.numpy(),
                        row=rows.index, rows=rows.count, col=group.index))
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_world(_ranks, 4, CASES, timeout=120)


def assemble(ranks, i):
    nll = np.zeros((B, S), np.float32)
    grad = np.zeros((B, S, V), np.float32)
    for r in ranks:
        rec = r[i]
        bl, vl = B // rec["rows"], rec["grad"].shape[-1]
        rs = slice(rec["row"] * bl, (rec["row"] + 1) * bl)
        nll[rs] = rec["nll"]
        grad[rs, :, rec["col"] * vl:(rec["col"] + 1) * vl] = rec["grad"]
    return nll, grad


def jax_reference(case):
    logits, labels, cot = data()
    if case["fused"]:
        mesh = JM.build_mesh(4, 1, devices=jax.devices()[:4])
        sh = JM.lower_vocab_strategy(JE(vtp=case["vtp"]), mesh, JDP.DDP)
        fn = JC.make_vocab_parallel_ce(mesh, sh, z_loss=case["z"],
                                       interpret=True)

        def nll_of(x):
            return fn(x, jnp.asarray(labels, jnp.int32))
    else:
        def nll_of(x):
            lse = jax.scipy.special.logsumexp(x, axis=-1)
            gold = jnp.take_along_axis(
                x, jnp.asarray(labels)[..., None], axis=-1)[..., 0]
            return lse - gold + case["z"] * jnp.square(lse)
    nll, vjp = jax.vjp(nll_of, jnp.asarray(logits))
    (grad,) = vjp(jnp.asarray(cot))
    return np.asarray(nll), np.asarray(grad)


@pytest.mark.parametrize("i", range(len(CASES)), ids=lambda i: "-".join(
    f"{k}{v}" for k, v in CASES[i].items()))
def test_torch_vocab_parallel_ce_matches_jax(ranks, i):
    nll, grad = assemble(ranks, i)
    want_nll, want_grad = jax_reference(CASES[i])
    np.testing.assert_allclose(nll, want_nll, **TOL)
    np.testing.assert_allclose(grad, want_grad, **TOL)


def test_torch_vocab_parallel_ce_ranks_of_a_group_agree(ranks):
    """The merged NLL is equal on every rank of a vocab group (each holds
    its rows' whole loss), bit for bit."""
    for i in range(len(CASES)):
        by_rows = {}
        for r in ranks:
            by_rows.setdefault(r[i]["row"], []).append(r[i]["nll"])
        for copies in by_rows.values():
            assert all(np.array_equal(c, copies[0]) for c in copies)
