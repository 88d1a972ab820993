"""The CUDA flash kernels (K1-K3) against their plain versions, on the card.

This file itself imports torch and numpy only; on a machine with a card
run ``python -m pytest tests/test_torch_flash_cuda.py -q``. Without a CUDA
device every test skips.
"""

import numpy as np
import pytest
import torch

from hetu_galvatron_tpu_torch.ops import _build
from hetu_galvatron_tpu_torch.ops import flash_attention as TF

pytestmark = pytest.mark.cuda


def _segments(B, S):
    seg = np.zeros((B, S), np.int32)
    seg[:, S // 3:S // 3 + S // 2] = 1
    seg[:, S // 3 + S // 2:] = 2
    return seg


def test_torch_flash_kernels_match_plain_on_cuda():
    """On the card: K1-K3 against their plain versions (fp32 inputs, GQA,
    segments, dropout, ragged S); launches are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.manual_seed(0)
    dev = torch.device("cuda")
    q = torch.randn(2, 200, 8, 64, device=dev, requires_grad=True)
    k = torch.randn(2, 200, 2, 64, device=dev, requires_grad=True)
    v = torch.randn(2, 200, 2, 64, device=dev, requires_grad=True)
    seg = torch.from_numpy(_segments(2, 200)).to(dev)
    _build.reset_launch_counts()
    out = TF.flash_sdpa(q, k, v, segment_ids=seg, dropout_rate=0.1,
                        dropout_seed=7)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert _build.launch_counts == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                                    "flash_bwd_dq": 1, "ce_fwd": 0,
                                    "ce_bwd": 0}
    qh, kh, vh, gh = (t.detach().transpose(1, 2) for t in (q, k, v, g))
    o, lse = TF.flash_fwd_plain(qh, kh, vh, seg, 7, dropout_rate=0.1)
    np.testing.assert_allclose(out.detach().transpose(1, 2).cpu().numpy(),
                               o.cpu().numpy(), rtol=1e-4, atol=1e-4)
    delta = (gh * o).sum(-1)
    dk, dv = TF.flash_bwd_dkdv_plain(qh, kh, vh, gh, lse, delta, seg, 7,
                                     dropout_rate=0.1)
    dq = TF.flash_bwd_dq_plain(qh, kh, vh, gh, lse, delta, seg, 7,
                               dropout_rate=0.1)
    for a, b in zip(grads, (dq, dk, dv)):
        np.testing.assert_allclose(a.transpose(1, 2).cpu().numpy(),
                                   b.cpu().numpy(), rtol=1e-4, atol=1e-4)
