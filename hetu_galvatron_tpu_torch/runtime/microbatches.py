"""Microbatch / global-batch-size ramp calculator.

Port of ``hetu_galvatron_tpu/runtime/microbatches.py``
(``MicroBatchCalculator`` :27, ``Rebatcher`` :156), with the same
schedule, rounding, ``decrease_batch_size_if_needed`` and errors: the
global batch size ramps from ``start`` to the target in fixed
``increment`` steps spread evenly over ``ramp_samples`` consumed samples,
and each step's batch is expressed as N microbatches of a FIXED micro
size. The launcher keeps the micro size ``global_bsz / chunks`` and varies
only the microbatch count a step (``runtime/trainer.make_forward_backward
(chunks=N)``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence


def _round_down(batch_size: int, divisor: int) -> int:
    return (batch_size // divisor) * divisor


class MicroBatchCalculator:
    """Constant or ramped global batch size -> per-iteration microbatching.

    Args:
        global_batch_size: the target (final) global batch size.
        micro_batch_size: samples per microbatch per dp replica group —
            constant for the whole run.
        dp_size: data-parallel replica count (microbatch shape divisor).
        rampup_batch_size: None for constant, else
            ``[start_global_batch_size, increment, ramp_samples]``
            (the reference's --rampup-batch-size triple).
        decrease_batch_size_if_needed: round a ramp step down to
            micro*dp divisibility instead of asserting.
    """

    def __init__(
        self,
        global_batch_size: int,
        micro_batch_size: int,
        dp_size: int = 1,
        rampup_batch_size: Optional[Sequence[int]] = None,
        decrease_batch_size_if_needed: bool = False,
    ):
        if global_batch_size <= 0 or micro_batch_size <= 0 or dp_size <= 0:
            raise ValueError("batch sizes and dp_size must be positive")
        self.global_batch_size = int(global_batch_size)
        self.micro_batch_size = int(micro_batch_size)
        self.dp_size = int(dp_size)
        self.decrease_batch_size_if_needed = bool(decrease_batch_size_if_needed)
        self._micro_times_dp = self.micro_batch_size * self.dp_size

        if rampup_batch_size is None:
            self.start_global_batch_size = self.global_batch_size
            self.batch_size_increment = 0
            self.ramp_samples = 0
            self._samples_per_increment = 0.0
        else:
            if len(rampup_batch_size) != 3:
                raise ValueError(
                    "rampup_batch_size must be [start, increment, "
                    f"ramp_samples], got {rampup_batch_size}")
            start, inc, ramp = (int(v) for v in rampup_batch_size)
            if start <= 0 or inc <= 0 or ramp < 0:
                raise ValueError(
                    f"invalid rampup triple {rampup_batch_size}")
            diff = self.global_batch_size - start
            if diff < 0:
                raise ValueError(
                    f"start batch size {start} exceeds target "
                    f"{self.global_batch_size}")
            if diff % inc:
                raise ValueError(
                    f"batch size span {diff} not divisible by increment {inc}")
            self.start_global_batch_size = start
            self.batch_size_increment = inc
            self.ramp_samples = ramp
            num_increments = max(diff // inc, 1)
            # ramp_samples=0 = jump straight to the target batch size
            self._samples_per_increment = (ramp / num_increments
                                           if ramp > 0 else 0.0)

        self.current_global_batch_size = 0
        self.current_running_global_batch_size = 0
        self.num_micro_batches = 0
        self.update(0)

    # -- reference getter surface ------------------------------------------

    def get(self) -> int:
        """Number of microbatches at the current point in the ramp."""
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def get_current_running_global_batch_size(self) -> int:
        return self.current_running_global_batch_size

    def get_micro_batch_size(self) -> int:
        return self.micro_batch_size

    @property
    def is_ramping(self) -> bool:
        return self.batch_size_increment > 0

    # -- schedule ----------------------------------------------------------

    def update(self, consumed_samples: int) -> bool:
        """Recompute the current batch size from total consumed samples.
        Returns True when the global batch size changed."""
        old = self.current_global_batch_size
        if (not self.is_ramping or self._samples_per_increment == 0
                or consumed_samples > self.ramp_samples):
            cur = self.global_batch_size
        else:
            steps = int(consumed_samples / self._samples_per_increment)
            cur = min(self.start_global_batch_size
                      + steps * self.batch_size_increment,
                      self.global_batch_size)
        self.current_global_batch_size = cur

        if cur % self._micro_times_dp:
            if not self.decrease_batch_size_if_needed:
                raise ValueError(
                    f"global batch size {cur} is not divisible by "
                    f"micro_batch_size {self.micro_batch_size} * dp_size "
                    f"{self.dp_size}")
            running = max(_round_down(cur, self._micro_times_dp),
                          self._micro_times_dp)
        else:
            running = cur
        self.current_running_global_batch_size = running
        self.num_micro_batches = running // self._micro_times_dp
        return cur != old

    def schedule(self, total_samples: int) -> List[int]:
        """The full ramp as a list of per-iteration global batch sizes until
        ``total_samples`` are consumed — handy for tests and logging."""
        out: List[int] = []
        consumed = 0
        while consumed < total_samples:
            self.update(consumed)
            out.append(self.current_running_global_batch_size)
            consumed += self.current_running_global_batch_size
        self.update(0)
        return out


class Rebatcher:
    """Re-slice a fixed-size batch stream into ramped batch sizes.

    The data iterators yield dict batches of the TARGET global size; during
    a ramp the runtime consumes smaller batches. This wrapper buffers
    samples (row-wise) and emits exactly-``n``-sample batches, preserving
    sample order."""

    def __init__(self, it):
        self._it = it
        self._buf = None

    def next_batch(self, n: int):
        import numpy as np

        while self._buf is None or len(next(iter(self._buf.values()))) < n:
            batch = next(self._it)
            if self._buf is None:
                self._buf = {k: np.asarray(v) for k, v in batch.items()}
            else:
                self._buf = {k: np.concatenate([self._buf[k], batch[k]])
                             for k in self._buf}
        out = {k: v[:n] for k, v in self._buf.items()}
        self._buf = {k: v[n:] for k, v in self._buf.items()}
        return out


class MicrobatchIterator:
    """The stream as microbatches of ``micro`` samples, cut in order from
    the fixed-size batches of ``it`` (``Rebatcher.next_batch(micro)``).
    A ramp step pulls its count of microbatches and joins them, which is
    the batch JAX's ``Rebatcher.next_batch(n)`` cuts for the step; the
    resume's ``skip_batches`` then counts microbatches."""

    def __init__(self, it, micro: int):
        self._rebatch = Rebatcher(it)
        self.micro = int(micro)

    def __iter__(self):
        return self

    def __next__(self):
        return self._rebatch.next_batch(self.micro)
