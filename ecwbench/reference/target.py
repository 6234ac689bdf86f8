"""The CCSD(T) target of the reference, in plain PyTorch: plain GCCSD, the
(T) energy, and the CCSD(T) response density, the derivative of
E_CCSD + E_(T) with respect to the one-body matrix f, through the
amplitudes' dependence on f (adjoint of the CCSD fixed point), plus the
HF occupations.

The (T) energy is the pair form the port evaluates (a frozen copy of
ecw_cc_torch/ops/ccsd_t.py's dense pair term): one (k, a, b, c) slab per
occupied pair (I, J), so no o^3 v^3 tensor is formed; its gradient is
taken pair by pair with autograd.
"""

from __future__ import annotations

import torch

from ecwbench.reference import cc

einsum = torch.einsum


class DIIS:
    """Pulay mixing over flat vectors, the error being the change from the
    previous iterate."""

    def __init__(self, space=8):
        self.space, self.xs, self.errs, self.last = space, [], [], None

    def update(self, x):
        if self.last is None:
            self.last = x
            return x
        self.xs.append(x)
        self.errs.append(x - self.last)
        self.xs, self.errs = self.xs[-self.space:], self.errs[-self.space:]
        n = len(self.xs)
        E = torch.stack(self.errs)
        B = -torch.ones((n + 1, n + 1), dtype=torch.float64)
        B[n, n] = 0.0
        B[:n, :n] = (E @ E.T).to("cpu", torch.float64)
        if not torch.isfinite(B).all():
            # a diverging iteration (the control's): no extrapolation
            self.last = x
            return x
        rhs = torch.zeros((n + 1, 1), dtype=torch.float64)
        rhs[n] = -1.0
        c = torch.linalg.lstsq(B, rhs).solution[:n, 0].to(x.device, x.dtype)
        out = c @ torch.stack(self.xs)
        self.last = out if torch.isfinite(out).all() else x
        return self.last


def _flat(*xs):
    return torch.cat([x.reshape(-1) for x in xs])


def _unflat(v, nocc, nvir):
    n1 = nocc * nvir
    return v[:n1].reshape(nocc, nvir), v[n1:].reshape(nocc, nocc, nvir, nvir)


def solve_ccsd(eris, tol=1e-9, max_cycle=200, strict=True):
    """Plain CCSD amplitudes from the MP2 guess, Jacobi steps with DIIS,
    until the largest change of an amplitude is under tol: (t1, t2, e).
    strict=False returns the last iterate where max_cycle runs out."""
    nocc, nvir = eris.nocc, eris.nvir
    d = torch.diagonal(eris.fock)
    eia = d[:nocc, None] - d[None, nocc:]
    t1 = torch.zeros_like(eia)
    t2 = eris.oovv / (eia[:, None, :, None] + eia[None, :, None, :])
    diis = DIIS()
    for _ in range(max_cycle):
        n1, n2 = cc.tupdate(eris, t1, t2)
        x = diis.update(_flat(n1, n2))
        step = (x - _flat(t1, t2)).abs().max()
        t1, t2 = _unflat(x, nocc, nvir)
        if step < tol:
            break
    else:
        if strict:
            raise RuntimeError("reference CCSD did not converge")
    return t1, t2, float(cc.energy(eris, t1, t2, eris.fock))


def _pabc(x):
    return x - x.transpose(1, 2) - x.transpose(1, 3)


def _pair_term(eris, t1, t2, fo, fv, I, J):
    """The (T) energy term of the occupied pair (I, J); E_T is the sum of
    the terms of every ordered pair over 36."""
    vovv, ovoo, oovv = eris.vovv, eris.ovoo, eris.oovv
    t2I, t2J = t2[I], t2[J]
    A = (einsum("kae,ebc->kabc", t2J, vovv[:, I])
         - einsum("mbc,mak->kabc", t2I, ovoo[:, :, J]))
    B = (einsum("kae,ebc->kabc", t2I, vovv[:, J])
         - einsum("mbc,mak->kabc", t2J, ovoo[:, :, I]))
    C = (einsum("ae,ekbc->kabc", t2J[I], vovv)
         - einsum("kmbc,ma->kabc", t2, ovoo[:, :, J, I]))
    w = _pabc(A - B - C)
    v = _pabc(einsum("a,kbc->kabc", t1[I], oovv[J])
              - einsum("a,kbc->kabc", t1[J], oovv[I])
              - einsum("ka,bc->kabc", t1, oovv[J, I]))
    D = (fo[I] + fo[J] + fo[:, None, None, None] - fv[None, :, None, None]
         - fv[None, None, :, None] - fv[None, None, None, :])
    return torch.sum(w * (w + v) / D)


def energy_t_grad(eris, t1, t2, fo, fv):
    """(E_T, dE_T/dt1, dE_T/dt2, dE_T/dfo, dE_T/dfv), one pair's graph at a
    time."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (t1, t2, fo, fv)]
    grads = [torch.zeros_like(x) for x in leaves]
    e = 0.0
    nocc = t1.shape[0]
    for I in range(nocc):
        for J in range(nocc):
            with torch.enable_grad():
                term = _pair_term(eris, *leaves, I, J)
                gs = torch.autograd.grad(term, leaves)
            for a, g in zip(grads, gs):
                a.add_(g)
            e += float(term.detach())
    return (e / 36.0, *[g / 36.0 for g in grads])


def response_rdm1(eris, t1, t2, tol=1e-9, max_cycle=300, strict=True):
    """gamma = dE/df + HF occupations, E = E_CCSD(t(f), f) + E_T(t(f), f),
    t(f) the CCSD fixed point t = G(t, f) of cc.tupdate: w solves
    w = dE/dt + (dG/dt)^T w (Jacobi steps with DIIS), and gamma =
    dE/df + w^T dG/df.  Returns (gamma symmetrized, E_T); strict=False
    takes the last w where max_cycle runs out."""
    nocc, nvir = t1.shape
    f0 = eris.fock.detach()
    t1g, t2g, fg = (x.detach().clone().requires_grad_(True)
                    for x in (t1, t2, f0))
    with torch.enable_grad():
        e_cc = cc.energy(eris, t1g, t2g, fg)
        g1, g2, dE_df = torch.autograd.grad(e_cc, (t1g, t2g, fg))
    fo, fv = torch.diagonal(f0)[:nocc], torch.diagonal(f0)[nocc:]
    e_t, h1, h2, hfo, hfv = energy_t_grad(eris, t1, t2, fo, fv)
    dE_dt = _flat(g1 + h1, g2 + h2)
    dE_df = dE_df + torch.diag(torch.cat([hfo, hfv]))
    with torch.enable_grad():
        G = _flat(*cc.tupdate(eris, t1g, t2g, fg))

    def vjp(w, wrt):
        return torch.autograd.grad(G, wrt, w, retain_graph=True)

    w = dE_dt
    diis = DIIS(space=10)
    for _ in range(max_cycle):
        w_new = dE_dt + _flat(*vjp(w, (t1g, t2g)))
        step = (w_new - w).abs().max()
        w = diis.update(w_new)
        if step < tol:
            break
    else:
        if strict:
            raise RuntimeError("reference adjoint did not converge")
    gamma = dE_df + vjp(w, (fg,))[0]
    occ = torch.zeros(nocc + nvir, dtype=gamma.dtype, device=gamma.device)
    occ[:nocc] = 1.0
    gamma = gamma + torch.diag(occ)
    return 0.5 * (gamma + gamma.T), e_t
