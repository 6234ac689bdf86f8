"""ECW-CCS ground-state kernels (port of the GS half of
ecw_cc_tpu/ops/ccs.py; reference CCS.py), pure functions of tensors:

  - the rdm1: gamma_unsym_CCS / gamma_CCS (CCS.py:23-190)
  - T1 intermediates + SCF update with ES-coupling Vexp terms (CCS.py:288-488)
  - Lambda1 intermediates + update (CCS.py:511-768)
  - L1-regularized updates via the vectorized subgradient (CCS.py:353-384,
    585-617)
  - `Gccs`, the class wrapper of the reference API, and `ccs_gradient`, the
    Jacobian / Newton / steepest-descent machinery (CCS.py:1524-2160).

Conventions (as the reference): amplitudes (nocc, nvir); the fock diagonal
in the update denominators; Vexp enters as v = -Vexp[n, m] blocks.  The
contractions are o*v-sized torch.einsum calls (XLA einsums in the JAX
package, outside any kernel).

The excited-state half (R1/R0/L1/L0 equations, gamma_es/gamma_tr; JAX
ccs.py:324-640) is not ported yet (ROADMAP A.11).
"""

from __future__ import annotations

import torch

from ecw_cc_torch.ops.l1reg import subdiff

einsum = torch.einsum


def _hf_diag(nocc, nvir, like):
    return torch.diag(torch.cat([like.new_ones(nocc), like.new_zeros(nvir)]))


# ---------------------------------------------------------------------------
# rdm1 (reference CCS.py:23-190)
# ---------------------------------------------------------------------------

def gamma_unsym_CCS(ts, ls):
    """Unsymmetrized CCS one-particle rdm1 (GS). Reference CCS.py:23-48."""
    nocc, nvir = ts.shape
    doo = -einsum("ie,je->ij", ts, ls)
    dvv = einsum("ib,ia->ab", ts, ls)
    dvo = ls.T
    dov = -einsum("ja,ib,jb->ia", ts, ts, ls) + ts
    dm1 = torch.cat([torch.cat([doo, dov], dim=1),
                     torch.cat([dvo, dvv], dim=1)], dim=0)
    return dm1 + _hf_diag(nocc, nvir, dm1)


def gamma_CCS(ts, ls):
    """Symmetrized GS rdm1 (PySCF convention, t2=l2=0). Reference CCS.py:157-190."""
    nocc, nvir = ts.shape
    doo = -einsum("ja,ia->ij", ts, ls)
    dvv = einsum("ia,ib->ab", ts, ls)
    xtv = einsum("ie,me->im", ts, ls)
    dvo = ts.T - einsum("im,ma->ai", xtv, ts)
    dov = ls
    top = torch.cat([doo + doo.T, dov + dvo.T], dim=1)
    bot = torch.cat([(dov + dvo.T).T, dvv + dvv.T], dim=1)
    dm1 = 0.5 * torch.cat([top, bot], dim=0)
    return dm1 + _hf_diag(nocc, nvir, dm1)


# ---------------------------------------------------------------------------
# Energy (reference CCS.py:226-249)
# ---------------------------------------------------------------------------

def energy_ccs(eris, ts, fsp, rsn=None, r0n=None, vn=None):
    """E'_0; optional ES contributions from stacked rsn (n,?,?), r0n (n,), vn (n,dim,dim)."""
    nocc, nvir = ts.shape
    fsp = eris.fock if fsp is None else fsp
    e = einsum("ia,ia->", fsp[:nocc, nocc:], ts)
    e = e + 0.5 * einsum("ia,jb,ijab->", ts, ts, eris.oovv)
    if rsn is not None:
        v_ov = -vn[:, :nocc, nocc:]
        v_oo = -vn[:, :nocc, :nocc]
        e = e + einsum("nia,nia->", v_ov, rsn)
        e = e + einsum("n,nia,ia->", r0n, v_ov, ts)
        e = e + einsum("n,njj->", r0n, v_oo)
    return e


# ---------------------------------------------------------------------------
# T1 intermediates and updates (reference CCS.py:271-488)
# ---------------------------------------------------------------------------

def T1inter(eris, ts, fsp):
    """'Stasis' T1 intermediates. Reference CCS.py:406-440."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov = f[:nocc, :nocc], f[:nocc, nocc:]
    fvo, fvv = f[nocc:, :nocc], f[nocc:, nocc:]

    Fai = fvo + einsum("jb,jabi->ai", ts, eris.ovvo)
    Fab = fvv - einsum("jb,ja->ab", fov, ts) + einsum("jc,jacb->ab", ts, eris.ovvv)
    tmp = einsum("kc,jkcb->jb", ts, eris.oovv)
    Fji = (foo + einsum("kb,kjbi->ji", ts, eris.oovo)
           - einsum("ib,jb->ji", ts, tmp))
    return Fab, Fji, Fai


def T1inter_Stanton(eris, ts, fsp):
    """Stanton-paper T1 intermediates. Reference CCS.py:442-488."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov = f[:nocc, :nocc], f[:nocc, nocc:]
    fvo, fvv = f[nocc:, :nocc], f[nocc:, nocc:]

    tsts = einsum("ia,jb->ijab", 0.125 * ts, ts)
    tsts = tsts - tsts.permute(1, 0, 2, 3)
    tau = tsts - tsts.permute(0, 1, 3, 2)

    Fae = (fvv - 0.5 * einsum("me,ma->ae", fov, ts)
           + einsum("mf,amef->ae", ts, eris.vovv)
           - 0.5 * einsum("mnaf,mnef->ae", 2.0 * tau, eris.oovv))
    Fmi = (foo + 0.5 * einsum("ie,me->mi", ts, fov)
           + einsum("ne,mnie->mi", ts, eris.ooov)
           + 0.5 * einsum("inef,mnef->mi", 2.0 * tau, eris.oovv))
    Fai = fvo + einsum("me,amie->ai", ts, eris.voov)
    return Fae, Fmi, Fai


def T1eq(eris, ts, fsp):
    """T1 equation value (residual form). Reference CCS.py:271-286."""
    Fab, Fji, Fai = T1inter(eris, ts, fsp)
    return Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)


def _remove_diag(F, diag):
    return F - torch.diag(diag)


def tsupdate(eris, ts, T1i, rsn=None, r0n=None, vn=None):
    """SCF update of t1 with optional ES-coupling Vexp terms. Reference CCS.py:288-351.

    rsn: (n_es, nocc, nvir); r0n: (n_es,); vn: (n_es, dim, dim) with zeros for
    absent potentials (equivalent to the reference's skip-if-None)."""
    Fab, Fji, Fai = T1i
    nocc, nvir = ts.shape
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    Fab = _remove_diag(Fab, diag_vv)
    Fji = _remove_diag(Fji, diag_oo)

    tsnew = Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)

    if rsn is not None:
        v_oo = -vn[:, :nocc, :nocc]
        v_vv = -vn[:, nocc:, nocc:]
        v_ov = -vn[:, :nocc, nocc:]
        # Z intermediates (CCS.py:328-347), batched over states
        Z = einsum("njj->n", v_oo) + einsum("njb,jb->n", v_ov, ts)
        Z0 = (v_ov + einsum("ib,nab->nia", ts, v_vv)
              - einsum("ja,nji->nia", ts, v_oo)
              - einsum("ja,njb,ib->nia", ts, v_ov, ts))
        Zab = v_vv - einsum("ja,njb->nab", ts, v_ov)
        Zji = -v_oo - einsum("ib,njb->nji", ts, v_ov)
        tsnew = tsnew + einsum("nia,n->ia", rsn, Z)
        tsnew = tsnew + einsum("n,nia->ia", r0n, Z0)
        tsnew = tsnew + einsum("nab,nib->ia", Zab, rsn)
        tsnew = tsnew + einsum("nji,nja->ia", Zji, rsn)

    return tsnew / (diag_oo[:, None] - diag_vv[None, :])


def tsupdate_L1(eris, ts, T1i, alpha):
    """SCF + L1-regularized t1 update. Reference CCS.py:353-384."""
    Fab, Fji, Fai = T1i
    nocc, nvir = ts.shape
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    T1 = Fai.T + einsum("ib,ab->ia", ts, Fab) - einsum("ja,ji->ia", ts, Fji)
    dW = subdiff(T1, ts, alpha)
    eia = diag_oo[:, None] - diag_vv[None, :]
    return (dW + ts * eia) / eia


# ---------------------------------------------------------------------------
# Lambda1 intermediates and updates (reference CCS.py:490-768)
# ---------------------------------------------------------------------------

def L1inter(eris, ts, fsp, E_term=True):
    """'Stasis' Lambda1 intermediates. Reference CCS.py:649-698."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov, fvv = f[:nocc, :nocc], f[:nocc, nocc:], f[nocc:, nocc:]

    Fba = (fvv - einsum("ja,jb->ba", fov, ts)
           + einsum("jbca,jc->ba", eris.ovvv, ts))
    tmp = einsum("jkca,jc->ka", eris.oovv, ts)
    Fba = Fba - einsum("ka,kb->ba", tmp, ts)

    Fij = (foo + einsum("ib,jb->ij", fov, ts)
           + einsum("kibj,kb->ij", eris.oovo, ts))
    tmp = einsum("kibc,kb->ic", eris.oovv, ts)
    Fij = Fij + einsum("ic,jc->ij", tmp, ts)

    Wbija = eris.voov - einsum("kija,kb->bija", eris.ooov, ts)
    tmp = einsum("kica,kb->icab", eris.oovv, ts)
    Wbija = Wbija - einsum("icab,jc->bija", tmp, ts)
    Wbija = Wbija + einsum("bica,jc->bija", eris.vovv, ts)

    Fia = fov + einsum("jiba,jb->ia", eris.oovv, ts)

    if E_term:
        E = -einsum("jb,jb->", ts, fov) - 0.5 * einsum("jb,kc,jkbc->", ts, ts, eris.oovv)
    else:
        E = torch.zeros((), dtype=ts.dtype, device=ts.device)
    return Fia, Fba, Fij, Wbija, E


def L1inter_Stanton(eris, ts, fsp):
    """Stanton-95 Lambda1 intermediates with t2=0. Reference CCS.py:700-768."""
    nocc, nvir = ts.shape
    f = eris.fock if fsp is None else fsp
    foo, fov, fvv = f[:nocc, :nocc], f[:nocc, nocc:], f[nocc:, nocc:]

    tsts = einsum("ia,jb->ijab", 0.25 * ts, ts)
    tsts = tsts - tsts.permute(1, 0, 2, 3)
    tau = tsts - tsts.permute(0, 1, 3, 2)

    TFea = (fvv - 0.5 * einsum("ma,me->ea", fov, ts)
            + einsum("mf,emaf->ea", ts, eris.vovv)
            - 0.5 * einsum("mnef,mnaf->ea", tau, eris.oovv))
    TFie = fov + einsum("nf,inef->ie", ts, eris.oovv)
    TFim = (foo + 0.5 * einsum("me,ie->im", ts, fov)
            + einsum("ne,inme->im", ts, eris.ooov)
            + 0.5 * einsum("mnef,inef->im", tau, eris.oovv))
    Fea = TFea - 0.5 * einsum("me,ma->ea", ts, TFie)
    Fim = TFim + 0.5 * einsum("me,ie->im", ts, TFie)

    Weima = eris.ovvo + einsum("mf,ieaf->ieam", ts, eris.ovvv)
    Weima = Weima - einsum("ne,inam->ieam", ts, eris.oovo)
    Weima = Weima - einsum("mf,ne,inaf->ieam", ts, ts, eris.oovv)
    Weima = Weima.permute(1, 0, 3, 2)  # ieam -> eima

    Fia = TFie
    E = torch.zeros((), dtype=ts.dtype, device=ts.device)
    return Fia, Fea, Fim, Weima, E


def L1eq(eris, ts, ls, fsp, E_term=True):
    """Lambda1 equation value. Reference CCS.py:490-509."""
    Fia, Fba, Fij, Wbija, E = L1inter(eris, ts, fsp, E_term=E_term)
    return (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
            + einsum("jb,bija->ia", ls, Wbija) + ls * E)


def lsupdate(eris, ts, ls, L1i, rsn=None, lsn=None, r0n=None, l0n=None, vn=None):
    """SCF update of lambda1 with optional ES coupling. Reference CCS.py:511-583."""
    Fia, Fba, Fij, Wbija, E = L1i
    nocc, nvir = ls.shape
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    Fba = _remove_diag(Fba, diag_vv)
    Fij = _remove_diag(Fij, diag_oo)

    lsnew = (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
             + einsum("jb,bija->ia", ls, Wbija) + ls * E)

    if rsn is not None:
        v_oo = -vn[:, :nocc, :nocc]
        v_vv = -vn[:, nocc:, nocc:]
        v_ov = -vn[:, :nocc, nocc:]
        # P intermediates (CCS.py:555-579), batched over states
        Pl = (einsum("njb,njb->n", rsn, v_ov)
              + r0n * einsum("jb,njb->n", ts, v_ov)
              + r0n * einsum("njj->n", v_oo))
        P = einsum("njj->n", v_oo) + einsum("jb,njb->n", ts, v_ov)
        Pba = v_vv - einsum("jb,nja->nba", ts, v_ov)
        Pij = -v_oo - einsum("jb,nib->nij", ts, v_ov)
        lsnew = lsnew + ls * Pl.sum()
        lsnew = lsnew + einsum("n,nia->ia", l0n, v_ov)
        lsnew = lsnew + einsum("nia,n->ia", lsn, P)
        lsnew = lsnew + einsum("nib,nba->ia", lsn, Pba)
        lsnew = lsnew + einsum("nja,nij->ia", lsn, Pij)

    return lsnew / (diag_oo[:, None] - diag_vv[None, :])


def lsupdate_L1(eris, ls, L1i, alpha):
    """SCF + L1-regularized lambda1 update. Reference CCS.py:585-617."""
    Fia, Fba, Fij, Wbija, E = L1i
    nocc, nvir = ls.shape
    diag_vv = torch.diagonal(eris.fock)[nocc:]
    diag_oo = torch.diagonal(eris.fock)[:nocc]
    L1 = (Fia + einsum("ib,ba->ia", ls, Fba) - einsum("ja,ij->ia", ls, Fij)
          + einsum("jb,bija->ia", ls, Wbija) + ls * E)
    dW = subdiff(L1, ls, alpha)
    eia = diag_oo[:, None] - diag_vv[None, :]
    return (dW + ls * eia) / eia


class Gccs:
    """Thin class wrapper matching the reference API (CCS.py:197), ground
    state only."""

    def __init__(self, eris, fock=None, M_tot=None):
        self.eris = eris
        self.fock = eris.fock if fock is None else fock
        self.M_tot = 1 if M_tot is None else M_tot
        self.nocc = eris.nocc
        self.nvir = eris.nvir

    def energy_ccs(self, ts, fsp, rsn=None, r0n=None, vn=None):
        return energy_ccs(self.eris, ts, fsp, rsn, r0n, vn)

    def gamma(self, ts, ls):
        return gamma_CCS(ts, ls)

    def gamma_unsym(self, ts, ls):
        return gamma_unsym_CCS(ts, ls)

    def T1inter(self, ts, fsp):
        return T1inter(self.eris, ts, fsp)

    def T1inter_Stanton(self, ts, fsp):
        return T1inter_Stanton(self.eris, ts, fsp)

    def T1eq(self, ts, fsp):
        return T1eq(self.eris, ts, fsp)

    def tsupdate(self, ts, T1i, rsn=None, r0n=None, vn=None):
        return tsupdate(self.eris, ts, T1i, rsn, r0n, vn)

    def tsupdate_L1(self, ts, T1i, alpha):
        return tsupdate_L1(self.eris, ts, T1i, alpha)

    def L1inter(self, ts, fsp, E_term=True):
        return L1inter(self.eris, ts, fsp, E_term=E_term)

    def L1inter_Stanton(self, ts, fsp):
        return L1inter_Stanton(self.eris, ts, fsp)

    def L1eq(self, ts, ls, fsp, E_term=True):
        return L1eq(self.eris, ts, ls, fsp, E_term=E_term)

    def lsupdate(self, ts, ls, L1i, rsn=None, lsn=None, r0n=None, l0n=None,
                 vn=None):
        return lsupdate(self.eris, ts, ls, L1i, rsn, lsn, r0n, l0n, vn)

    def lsupdate_L1(self, ls, L1i, alpha):
        return lsupdate_L1(self.eris, ls, L1i, alpha)


# ---------------------------------------------------------------------------
# Gradient / Newton machinery (reference CCS.py:1524-2160, class ccs_gradient)
#
# Instead of the reference's hand-derived Jacobian blocks (dT/dt, dT/dl,
# dL/dt, dL/dl with three Vexp-derivative models DV1/DV2/DV3,
# CCS.py:1668-2071), the Jacobian of the coupled (T1, Lambda1) residual
# system is obtained exactly with torch.func.jacfwd through the whole
# computation, the Vexp(gamma(t, l)) dependence included.  This covers the
# reference's DV1 linear-in-gamma 'mat' model exactly and generalizes to
# every property the device Vexp supports.
# ---------------------------------------------------------------------------

class ccs_gradient:
    def __init__(self, eris, Vexp_model=1, exp_pot=None):
        self.eris = eris
        self.fock = eris.fock
        self.nocc = eris.nocc
        self.nvir = eris.nvir
        self.exp_pot = exp_pot
        # device Vexp closure (optional): exact property-model derivatives
        self._vexp_fn = None
        if exp_pot is not None and Vexp_model in (2, 3):
            from ecw_cc_torch.ops.vexp import make_gs_vexp_device

            self._vexp_fn = make_gs_vexp_device(
                exp_pot, dtype=self.fock.dtype, device=self.fock.device)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.fock.dtype,
                               device=self.fock.device)

    # -- coupled residual with the local 'mat'-linear Vexp model ----------
    def _residuals(self, ts, ls, fsp0, gamma0, L):
        """T1/Lambda1 residuals with fsp varying through the rdm1:
        fsp(t, l) = fsp0 + L (gamma(t, l) - gamma0)  (exact for 'mat')."""
        if self._vexp_fn is not None:
            rdm1 = gamma_CCS(ts, ls)
            nprop = len(self.exp_pot.prop_names[0])
            V, _, _ = self._vexp_fn(rdm1, [L] * nprop)
            fsp = self.eris.fock - V
        else:
            fsp = fsp0 + L * (gamma_CCS(ts, ls) - gamma0)
        T1 = T1eq(self.eris, ts, fsp)
        L1 = L1eq(self.eris, ts, ls, fsp, E_term=False)
        return T1, L1

    def Jacobian(self, ts, ls, fsp, L):
        """Exact Jacobian of the stacked (T1, L1) residuals w.r.t (t1, l1):
        (J, residuals)."""
        ts, ls, fsp0 = self._tensor(ts), self._tensor(ls), self._tensor(fsp)
        gamma0 = gamma_CCS(ts, ls)
        n = ts.numel()

        def stacked(x):
            t = x[:n].reshape(ts.shape)
            l = x[n:].reshape(ls.shape)
            T1, L1 = self._residuals(t, l, fsp0, gamma0, L)
            return torch.cat([T1.reshape(-1), L1.reshape(-1)])

        x0 = torch.cat([ts.reshape(-1), ls.reshape(-1)])
        return torch.func.jacfwd(stacked)(x0), stacked(x0)

    def Newton(self, ts, ls, fsp, L):
        """One Newton step on the coupled system. Reference CCS.py:2094-2124."""
        ts, ls = self._tensor(ts), self._tensor(ls)
        n = ts.numel()
        J, R = self.Jacobian(ts, ls, fsp, L)
        dx = torch.linalg.solve(J, -R)
        return (ts + dx[:n].reshape(ts.shape),
                ls + dx[n:].reshape(ls.shape))

    def Gradient_Descent(self, beta, ts, ls, fsp, L):
        """Steepest-descent step on 1/2 |R|^2. Reference CCS.py:2126-2160."""
        ts, ls, fsp0 = self._tensor(ts), self._tensor(ls), self._tensor(fsp)
        gamma0 = gamma_CCS(ts, ls)

        def objective(t, l):
            T1, L1 = self._residuals(t, l, fsp0, gamma0, L)
            return 0.5 * ((T1 ** 2).sum() + (L1 ** 2).sum())

        gt, gl = torch.func.grad(objective, argnums=(0, 1))(ts, ls)
        return ts - beta * gt, ls - beta * gl
