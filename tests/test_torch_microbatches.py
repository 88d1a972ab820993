"""The port's batch-size ramp (``runtime/microbatches.py``) against the JAX
package's: ``MicroBatchCalculator`` schedules and errors on a grid of
(global, micro, ramp triple, decrease), ``Rebatcher`` slices, and the
port's microbatch stream against JAX's per-step rebatching. Exact: the
schedule is integer arithmetic and the slices are copies."""

import itertools

import numpy as np
import pytest

from hetu_galvatron_tpu.runtime import microbatches as JM
from hetu_galvatron_tpu_torch.runtime import microbatches as TM

RAMPS = (None, [2, 2, 24], [4, 4, 40], [8, 8, 0], [3, 3, 30], [2, 4, 10],
         [6, 2, 17], [16, 4, 8], [1, 1, 5], [0, 2, 8], [4, 0, 8],
         [4, 4, -1], [40, 8, 16], [4, 4])
GRID = list(itertools.product((8, 16, 24), (1, 2, 4), RAMPS, (False, True)))


def _run(M, gbs, micro, ramp, decrease):
    """The schedule over 3 target batches, or the error's type and
    text."""
    try:
        calc = M.MicroBatchCalculator(gbs, micro, 1, ramp, decrease)
        sched = calc.schedule(3 * gbs)
        steps = []
        consumed = 0
        for _ in range(len(sched)):
            changed = calc.update(consumed)
            steps.append((changed, calc.get(),
                          calc.get_current_global_batch_size(),
                          calc.get_current_running_global_batch_size()))
            consumed += calc.current_running_global_batch_size
        return ("ok", sched, steps, calc.is_ramping,
                calc.get_micro_batch_size())
    except ValueError as e:
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("chunk", range(4))
def test_torch_microbatch_calculator_matches_jax_on_a_grid(chunk):
    """The grid in four parts: every case's schedule, per-step updates
    (changed flag, microbatch count, global and running sizes) or error
    equal JAX's."""
    part = GRID[chunk::4]
    outcomes = set()
    for gbs, micro, ramp, decrease in part:
        want = _run(JM, gbs, micro, ramp, decrease)
        got = _run(TM, gbs, micro, ramp, decrease)
        assert got == want, (gbs, micro, ramp, decrease)
        outcomes.add(want[0])
    assert outcomes == {"ok", "error"}  # both branches are exercised


def test_torch_microbatch_calculator_positive_sizes_and_triple():
    for M in (JM, TM):
        with pytest.raises(ValueError, match="positive"):
            M.MicroBatchCalculator(0, 1)
        with pytest.raises(ValueError, match="rampup_batch_size must be"):
            M.MicroBatchCalculator(8, 2, 1, [2, 2])


def test_torch_rebatcher_matches_jax():
    """Variable-size slices of a fixed-size stream, sample order kept."""
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 100, (8, 5)).astype(np.int32),
                "labels": rng.integers(0, 100, (8, 5)).astype(np.int32)}
               for _ in range(12)]
    rj, rt = JM.Rebatcher(iter(batches)), TM.Rebatcher(iter(batches))
    for n in (2, 2, 4, 6, 8, 8, 3, 7, 16, 8):
        a, b = rj.next_batch(n), rt.next_batch(n)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert len(b[k]) == n


def test_torch_microbatch_stream_joins_to_jax_rebatched_steps():
    """A ramped run's steps pulled as microbatches from the port's stream
    and joined equal JAX's ``Rebatcher.next_batch(running size)`` over
    the same ramp."""
    from hetu_galvatron_tpu_torch.cli.train_dist import _concat

    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(0, 100, (8, 4)).astype(np.int32)}
               for _ in range(20)]
    calc_j = JM.MicroBatchCalculator(8, 2, 1, [2, 2, 24])
    calc_t = TM.MicroBatchCalculator(8, 2, 1, [2, 2, 24])
    rj = JM.Rebatcher(iter(batches))
    mt = TM.MicrobatchIterator(iter(batches), 2)
    consumed, sizes = 0, []
    for _ in range(14):
        calc_j.update(consumed)
        calc_t.update(consumed)
        n = calc_j.current_running_global_batch_size
        want = rj.next_batch(n)
        got = _concat([next(mt) for _ in range(calc_t.num_micro_batches)])
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        sizes.append(n)
        consumed += n
    assert sizes == [2, 2, 2, 2, 4, 4, 6, 6, 8, 8, 8, 8, 8, 8]
