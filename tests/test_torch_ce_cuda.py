"""The CUDA cross-entropy kernels (K4/K5) against their plain versions, on
the card.

This file itself imports torch and numpy only; on a machine with a card
run ``python -m pytest tests/test_torch_ce_cuda.py -q``. Without a CUDA
device every test skips. Tolerances: lse within 1e-4 absolute, gold
bit-equal, dlogits within 1e-4 * (rms + |want|) in fp32 and 2e-2 in bf16.
"""

import numpy as np
import pytest
import torch

from hetu_galvatron_tpu_torch.ops import _build
from hetu_galvatron_tpu_torch.ops import cross_entropy as TC

pytestmark = pytest.mark.cuda


def _close_rel(got, want, tol):
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    assert bool(((g - w).abs() <= tol * (rms + w.abs())).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,V,ld", [(77, 1000, 1000), (64, 50257, 50257),
                                    (33, 1000, 1024)])
def test_torch_ce_kernels_match_plain_on_cuda(dtype, tol, T, V, ld):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(T + V)
    wide = (3 * torch.randn(T, ld, device=dev, generator=gen)).to(dtype)
    x = wide[:, :V]
    labels = torch.randint(0, V, (T,), device=dev, generator=gen)
    labels[:3] = torch.tensor([-1, V, 0], device=dev)
    x[5] = 1.5  # a row of equal logits: lse = 1.5 + log V
    _build.reset_launch_counts()
    lse, gold = TC.ce_fwd(x, labels)
    a = torch.randn(T, device=dev, generator=gen)
    b = torch.randn(T, device=dev, generator=gen)
    dx = TC.ce_bwd(x, labels, lse, a, b)
    torch.cuda.synchronize()
    assert _build.launch_counts == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                                    "flash_bwd_dq": 0, "ce_fwd": 1,
                                    "ce_bwd": 1}
    lse_p, gold_p = TC.ce_fwd_plain(x, labels)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_p.cpu().numpy(),
                               rtol=0, atol=1e-4)
    assert torch.equal(gold, gold_p) and gold[0] == 0 and gold[1] == 0
    assert abs(float(lse[5]) - (1.5 + np.log(V))) < 1e-4
    assert dx.dtype == dtype
    _close_rel(dx, TC.ce_bwd_plain(x, labels, lse, a, b), tol)
