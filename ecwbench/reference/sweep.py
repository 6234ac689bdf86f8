"""The warm-started ECW-CCSD lambda sweep of the reference, in plain
PyTorch, against an rdm1 ('mat') target.

One iteration is the ECW solver's: the rdm1 of the current amplitudes,
the constraint potential V = lambda (target - rdm1), the effective Fock
matrix f - V, the energy Ep with it, the T update, the Lambda update from
the new T (the upstream's energy term kept), and DIIS over (l1, t1, l2,
t2).  The reference iterates until the largest change of an amplitude is
under `tol`, far below the benchmark's threshold, so its fixed point is
the equations' and not its path's.
"""

from __future__ import annotations

import torch

from ecwbench.reference import cc
from ecwbench.reference.target import DIIS


def _pack(*xs):
    return torch.cat([x.reshape(-1) for x in xs])


def sweep(eris, target, lambdas, tol=1e-8, max_cycle=400, strict=True):
    """[(Ep, Delta, rdm1)] per lambda; each solve starts from the last
    one's amplitudes, the first from t1 = l1 = 0 and the MP2 doubles.
    strict=False goes on from the last iterate where max_cycle runs
    out."""
    nocc, nvir = eris.nocc, eris.nvir
    d = torch.diagonal(eris.fock)
    eia = d[:nocc, None] - d[None, nocc:]
    ts = torch.zeros_like(eia)
    ls = torch.zeros_like(eia)
    td = eris.oovv / (eia[:, None, :, None] + eia[None, :, None, :])
    ld = td.clone()
    n1, n2 = nocc * nvir, nocc * nocc * nvir * nvir
    den = target.abs().sum()
    out = []
    for lam in lambdas:
        diis = DIIS(space=15)
        for _ in range(max_cycle):
            rdm1 = cc.gamma_CCSD(ts, td, ls, ld)
            diff = target - rdm1
            fsp = eris.fock - lam * diff
            Ep = cc.energy(eris, ts, td, fsp)
            ts_n, td_n = cc.tupdate(eris, ts, td, fsp)
            ls_n, ld_n = cc.lupdate(eris, ts_n, td_n, ls, ld, fsp)
            old = _pack(ls, ts, ld, td)
            x = diis.update(_pack(ls_n, ts_n, ld_n, td_n))
            ls, ts = x[:n1].reshape(nocc, nvir), x[n1:2 * n1].reshape(
                nocc, nvir)
            ld = x[2 * n1:2 * n1 + n2].reshape(nocc, nocc, nvir, nvir)
            td = x[2 * n1 + n2:].reshape(nocc, nocc, nvir, nvir)
            if (x - old).abs().max() < tol:
                break
        else:
            if strict:
                raise RuntimeError(
                    f"reference sweep did not converge at {lam}")
        rdm1 = cc.gamma_CCSD(ts, td, ls, ld)
        diff = target - rdm1
        fsp = eris.fock - lam * diff
        out.append((float(cc.energy(eris, ts, td, fsp)),
                    float(diff.abs().sum() / den), rdm1))
    return out
