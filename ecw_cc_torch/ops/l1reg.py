"""L1-regularization machinery (port of ecw_cc_tpu/ops/l1reg.py;
reference utilities.py:26-96).

Replicated exactly: the zero-branch test is `v <= 0` while the nonzero
branch is `|v| > 0`, so strictly negative amplitudes fall through to the
soft-threshold rule (utilities.py:53-67).
"""

from __future__ import annotations

import torch


def subdiff(eq, var, alpha):
    """Sub-gradient W of the L1-regularized residual."""
    zero = torch.zeros((), dtype=eq.dtype, device=eq.device)
    soft = torch.where(eq < -alpha, eq + alpha,
                       torch.where(eq > alpha, eq - alpha, zero))
    return torch.where(var > 0.0, eq + alpha * torch.sign(var), soft)


def prox_l1(x, alpha):
    """Proximal soft-threshold map."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > alpha, x - alpha,
                       torch.where(x < -alpha, x + alpha, zero))
