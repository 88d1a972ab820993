"""The telemetry's lagged drain on the card: a CUDA scalar handed to the
hook is read at the next flush behind its own step's event, on a side
stream, so the hook that flushes never waits for the step in flight.
Needs a card; run there with ``python -m pytest --noconftest
tests/test_torch_telemetry_cuda.py`` (``tests/conftest.py`` imports JAX,
which the card's machine lacks)."""

import time

import pytest
import torch

from hetu_galvatron_tpu_torch.observability import registry as TG
from hetu_galvatron_tpu_torch.observability import telemetry as TT


@pytest.mark.cuda
def test_torch_telemetry_drains_cuda_scalars_without_waiting():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn(4096, 4096, device="cuda") / 64.0
    torch.cuda.synchronize()
    reg = TG.MetricsRegistry()
    tel = TT.TrainingTelemetry(reg, global_batch_size=2, seq_length=8,
                               flush_interval=2)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for it in range(6):
        # matrix products queued ahead of each step's loss
        start.record()
        for _ in range(20):
            prod = a @ a
        loss = prod.float().mean() * 0 + it
        t0 = time.perf_counter()
        tel(it, {"loss": loss, "grad_norm": loss + 1})
        hook_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if it % 2:
            # each flush read the step before, already done, and left its
            # own step's values for the next
            assert reg.gauge("train/loss").value == it - 1
        if it in (3, 5):
            # past the first flush's one-time host costs, the flushing
            # hook returns long before the step it follows
            assert hook_ms < 0.25 * start.elapsed_time(end), hook_ms
    tel.close()
    assert reg.gauge("train/loss").value == 5.0
    assert reg.gauge("train/grad_norm").value == 6.0
    assert TT.device_memory_mb()["peak"] > 0
