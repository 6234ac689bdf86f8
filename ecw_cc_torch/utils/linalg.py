"""Linear-algebra helpers, initial guesses and the non-symmetric Davidson
eigensolvers (reference utilities.py:397-876).

The host half (everything down to `davidson_nosym`) is a copy of
ecw_cc_tpu/utils/linalg.py:12-338 (the PyTorch port imports nothing of the
JAX package); only the imports differ.

`davidson_device` is the port of the JAX package's default device
Davidson, the pipelined one (linalg.py:545-757): each cycle is one device
program (on the card a captured CUDA graph, solvers/device_loop.Program)
and one read, and the host solves the small projected eigenproblem with
numpy.linalg.eig.  `davidson_nosym_device` and `davidson_pipelined_device`
are kept as names for it, so that callers read the same.  The JAX
package's host-cycle and fused variants, its program cache and schur.py
(a TPU has no non-symmetric eig) are not ported.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from ecw_cc_torch.config import matmul_precision
from ecw_cc_torch.solvers.device_loop import Program, on_side_stream
from ecw_cc_torch.utils import convert


def get_norm(rs, ls, r0, l0):
    """<Psi_r|Psi_l> inner product of amplitude sets. Reference utilities.py:625-642."""
    rs = np.asarray(rs)
    ls = np.asarray(ls)
    if rs.shape != ls.shape:
        raise ValueError("shape of both sets of amplitudes must be the same")
    return l0 * np.conjugate(r0) + np.sum(np.conjugate(rs) * ls)


def ortho_QR(Mvec):
    """QR orthonormalization of column vectors. Reference utilities.py:645-655."""
    Q, _ = np.linalg.qr(Mvec)
    return Q


def ortho_SVD(mol, cL, cR):
    """Biorthogonalize two MO coefficient sets via SVD (Werner 2007).
    Reference utilities.py:658-695. `mol` may be a Molecule or an AO overlap."""
    if hasattr(mol, "intor"):
        S_AO = mol.intor("ovlp")
    elif isinstance(mol, np.ndarray):
        S_AO = mol
    else:
        raise ValueError("AO overlap must be an ndarray or a Molecule")
    if S_AO.shape[0] * 2 == cL.shape[0]:
        S_AO = convert.convert_r_to_g_rdm1(S_AO)
    S = np.einsum("mp,nq,mn->pq", np.conj(cL), cR, S_AO)
    u, sv, v = np.linalg.svd(S)
    S_inv_sqrt = np.sqrt(np.linalg.inv(np.diag(sv)))
    TL = u @ S_inv_sqrt
    TR = np.conj(v).T @ S_inv_sqrt
    return cL @ TL, cR @ TR


def ortho_GS(U, eps=1e-12):
    """Gram-Schmidt orthonormalization of columns. Reference utilities.py:698-727."""
    U = np.array(U, dtype=float)
    V = U.T
    for i in range(len(V)):
        prev = V[:i]
        coeff = prev @ V[i].T
        V[i] -= coeff @ prev
        nrm = np.linalg.norm(V[i])
        if nrm < eps:
            V[i][V[i] < eps] = 0.0
        else:
            V[i] /= nrm
    return V.T


def check_ortho(rn, ln, r0n, l0n):
    """Matrix of averaged overlaps between state vectors. Reference utilities.py:730-758."""
    n = len(rn)
    if n != len(ln):
        raise ValueError("r and l lists must have the same length")
    C = np.zeros((n, n))
    for k in range(n):
        for l in range(n):
            c_l = get_norm(rn[k], ln[l], r0n[k], l0n[l])
            c_r = get_norm(rn[l], ln[k], r0n[l], l0n[k])
            C[k, l] = np.real((c_l + c_r) / 2.0)
    return C


def ortho_es(rn, ln, r0n, l0n):
    """QR-orthonormalize the (r0, r) and (l0, l) state vectors.
    Reference utilities.py:761-801."""
    nocc, nvir = np.asarray(rn[0]).shape
    n = len(rn)
    Mr = np.zeros((nocc * nvir + 1, n))
    Ml = np.zeros((nocc * nvir + 1, n))
    for j in range(n):
        Mr[1:, j] = np.ravel(rn[j])
        Mr[0, j] = r0n[j]
        Ml[1:, j] = np.ravel(ln[j])
        Ml[0, j] = l0n[j]
    Qr = ortho_QR(Mr)
    Ql = ortho_QR(Ml)
    new_rn = [Qr[1:, i].reshape(nocc, nvir) for i in range(n)]
    new_ln = [Ql[1:, i].reshape(nocc, nvir) for i in range(n)]
    new_r0 = [Qr[0, i] for i in range(n)]
    new_l0 = [Ql[0, i] for i in range(n)]
    return new_rn, new_ln, new_r0, new_l0


def biortho_es(r1, l1, r0, l0):
    """Biorthogonalize one (r, l) pair via QR. Reference utilities.py:804-832."""
    nocc, nvir = np.asarray(r1).shape
    M = np.zeros((nocc * nvir + 1, 2))
    M[1:, 0] = np.ravel(r1)
    M[0, 0] = r0
    M[1:, 1] = np.ravel(l1)
    M[0, 1] = l0
    Q = ortho_QR(M)
    return (Q[1:, 0].reshape(nocc, nvir), Q[1:, 1].reshape(nocc, nvir),
            Q[0, 0], Q[0, 1])


def ortho_norm(rn, ln, rn0, ln0, ortho=True):
    """Normalize (and biorthogonalize for 2 states) the state vectors.
    Reference utilities.py:835-876."""
    C = check_ortho(rn, ln, rn0, ln0)
    ln_new = copy.deepcopy(list(ln))
    rn_new = copy.deepcopy(list(rn))
    ln0_new = copy.deepcopy(list(ln0))
    rn0_new = copy.deepcopy(list(rn0))
    if len(rn) == 2 and ortho:
        for c in np.tril(C, -1).ravel():
            if abs(c) > 0.001:
                rn_new[0], ln_new[1], rn0_new[0], ln0_new[1] = biortho_es(
                    rn_new[0], ln_new[1], rn0_new[0], ln0_new[1])
                rn_new[1], ln_new[0], rn0_new[1], ln0_new[0] = biortho_es(
                    rn_new[1], ln_new[0], rn0_new[1], ln0_new[0])
                C = check_ortho(rn_new, ln_new, rn0_new, ln0_new)
                break
    for i in range(len(ln_new)):
        if C[i, i] < 0.999 or C[i, i] > 1.001:
            ln_new[i] = ln_new[i] / C[i, i]
            ln0_new[i] = ln0_new[i] / C[i, i]
    return rn_new, ln_new, rn0_new, ln0_new


def check_spin(amp_r, amp_l):
    """Total spin indicator of an amplitude pair. Reference utilities.py:551-571."""
    spin_mat = np.zeros_like(np.asarray(amp_r))
    spin_mat[::2, 1::2] = -1.0
    spin_mat[1::2, 0::2] = 1.0
    return np.einsum("ia,ia,ia", np.asarray(amp_r), np.asarray(amp_l), spin_mat)


def spin_square(rdm1, mo_coeff, ovlp=1):
    """Spin multiplicity from a G-format rdm1. Reference utilities.py:574-617."""
    dm1a, dm1b = convert.convert_g_to_ru_rdm1(np.asarray(rdm1))[1]
    nao = mo_coeff.shape[0] // 2
    moa = mo_coeff[:nao, 0::2]
    mob = mo_coeff[nao:, 1::2]
    if isinstance(ovlp, np.ndarray):
        ovlpaa = moa.T @ ovlp @ moa
        ovlpbb = mob.T @ ovlp @ mob
    else:
        ovlpaa = moa.T @ moa
        ovlpbb = mob.T @ mob
    ssz = (np.einsum("ji,ij->", dm1a, ovlpaa) + np.einsum("ji,ij->", dm1b, ovlpbb)) * 0.25
    ssxy = (np.einsum("ji,ij->", dm1a, ovlpaa) + np.einsum("ji,ij->", dm1b, ovlpbb)) * 0.5
    ss = ssxy + ssz
    s = np.sqrt(ss + 0.25) - 0.5
    return s * 2 + 1


def koopman_init_guess(mo_energy, mo_occ, nstates=(1, 0), koop_idx=None,
                       core_ene_thresh=10.0):
    """Koopman r1 guesses in G format, valence/core split.
    Reference utilities.py:397-478."""
    nstates = list(nstates)
    if koop_idx is not None and sum(nstates) != len(koop_idx):
        raise ValueError("number of Koopman indices must equal number of states")
    if koop_idx is None:
        val_idx = np.zeros(nstates[0], dtype=int) if nstates[0] else [0]
        core_idx = np.zeros(nstates[1], dtype=int) if nstates[1] else [0]
    else:
        val_idx = koop_idx[: nstates[0]] if nstates[0] else [0]
        core_idx = koop_idx[nstates[0]:] if nstates[1] else [0]

    mo_energy = np.asarray(mo_energy)[0::2]
    mo_occ = np.asarray(mo_occ)[0::2]
    occidx = np.where(mo_occ > 0)[0]
    viridx = np.where(mo_occ == 0)[0]
    nocc, nvir = len(occidx), len(viridx)
    ncore = int(np.sum(np.abs(mo_energy[:nocc]) > core_ene_thresh))
    e_ia = mo_energy[viridx] - mo_energy[occidx, None]

    x0, DE = [], []
    eia_val = e_ia[ncore:, :].ravel()
    eia_core = e_ia[:ncore, :].ravel()
    if nstates[0] > eia_val.size or nstates[1] > eia_core.size:
        raise ValueError("basis too small for the requested number of states")

    nroot = min(nstates[0], eia_val.size)
    idx = np.argsort(eia_val)
    nocc_val = nocc - ncore
    for i in range(nroot):
        tmp = np.zeros(eia_val.size)
        tmp[idx[i + val_idx[i]]] = 1.0
        tmp = tmp.reshape(nocc_val, nvir)
        tmp = np.vstack([np.zeros((ncore, nvir)), tmp])
        g = convert.convert_r_to_g_amp(tmp)
        # zero the first of the two degenerate spin components
        nz = np.transpose(np.nonzero(g))
        g[tuple(nz[0])] = 0.0
        x0.append(g)
        DE.append(eia_val[idx[i + val_idx[i]]])

    nroot = min(nstates[1], eia_core.size)
    idx = np.argsort(eia_core)
    for i in range(nroot):
        tmp = np.zeros(eia_core.size)
        tmp[idx[i + core_idx[i]]] = 1.0
        tmp = tmp.reshape(ncore, nvir)
        tmp = np.vstack([tmp, np.zeros((nocc_val, nvir))])
        g = convert.convert_r_to_g_amp(tmp)
        nz = np.transpose(np.nonzero(g))
        g[tuple(nz[0])] = 0.0
        x0.append(g)
        DE.append(eia_core[idx[i + core_idx[i]]])

    return x0, DE


def get_DE(mo_energy, rs):
    """Orbital-energy difference at the largest amplitude.
    Reference utilities.py:481-493."""
    nocc, nvir = np.asarray(rs).shape
    mo_energy = np.asarray(mo_energy)
    eia = mo_energy[nocc:] - mo_energy[:nocc, None]
    idx = np.unravel_index(np.argmax(np.asarray(rs)), (nocc, nvir))
    return eia[idx]


def tdm_slater(TcL, TcR, occ_diff):
    """Biorthogonal Slater transition density matrix in AO basis.
    Reference utilities.py:496-515."""
    Tg = np.diag(occ_diff)
    return np.einsum("pi,ij,qj->pq", TcL, Tg, np.conj(TcR))


def EOM_r0(DE, t1, r1, fsp, eris_oovv, r2=None):
    """EOM r0 amplitudes. Reference utilities.py:518-548."""
    n = len(r1)
    nocc, nvir = np.asarray(r1[0]).shape
    if r2 is None:
        r2 = [np.zeros((nocc, nocc, nvir, nvir))] * n
    Xia = np.asarray(fsp)[:nocc, nocc:] + np.einsum(
        "me,imae->ia", np.asarray(t1), np.asarray(eris_oovv))
    out = []
    for k in range(n):
        r0 = np.einsum("ld,ld", Xia, np.asarray(r1[k]))
        r0 += 0.25 * np.einsum("lmde,lmde", np.asarray(eris_oovv), np.asarray(r2[k]))
        out.append(r0 / DE[k])
    return out


def davidson_nosym(matvec, x0, diag, nroots=1, tol=1e-8, max_cycle=80,
                   max_space=20, follow=False):
    """Davidson eigensolver for a non-symmetric real matrix (right
    eigenvectors), the analogue of pyscf.lib.davidson_nosym1 used by the
    reference's Solver_ES.SCF_diag (Solver_ES.py:710-711).

    :param matvec: callable v -> A v on flat vectors
    :param x0: list of initial guess vectors
    :param diag: diagonal of A (preconditioner)
    :param nroots: number of roots
    :param follow: if True, pick Ritz roots by maximum overlap with the
        initial guesses (root homing for state-specific EOM solves) instead
        of lowest eigenvalue
    :return: (converged_flags, eigenvalues, eigenvectors)
    """
    diag = np.asarray(diag, dtype=float)
    n = diag.size
    V = []
    AV = []

    def orthonormalize(v):
        for u in V:
            v = v - u * np.dot(u, v)
        nrm = np.linalg.norm(v)
        return None if nrm < 1e-12 else v / nrm

    for v in x0:
        v = orthonormalize(np.asarray(v, dtype=float).ravel())
        if v is not None:
            V.append(v)
    if not V:
        raise ValueError("no independent initial vectors")

    conv = [False] * nroots
    theta = np.zeros(nroots)
    Xs = [None] * nroots
    for _ in range(max_cycle):
        while len(AV) < len(V):
            AV.append(np.asarray(matvec(V[len(AV)])).ravel())
        m = len(V)
        H = np.array([[np.dot(V[i], AV[j]) for j in range(m)] for i in range(m)])
        w, y = np.linalg.eig(H)
        if follow:
            # overlap of each Ritz vector with the span of the guesses
            G = np.array([np.asarray(g, dtype=float).ravel() for g in x0])
            ritz_full = np.array([[np.dot(G[q], sum(y[i, k].real * V[i]
                                                    for i in range(m)))
                                   for k in range(m)] for q in range(len(G))])
            score = np.max(np.abs(ritz_full), axis=0)
            order = np.argsort(-score)
        else:
            order = np.argsort(w.real)
        w = w[order]
        y = y[:, order]
        new_dirs = []
        for k in range(min(nroots, m)):
            theta[k] = w[k].real
            xk = sum(y[i, k].real * V[i] for i in range(m))
            Axk = sum(y[i, k].real * AV[i] for i in range(m))
            r = Axk - theta[k] * xk
            Xs[k] = xk / max(np.linalg.norm(xk), 1e-300)
            conv[k] = np.linalg.norm(r) < tol
            if not conv[k]:
                denom = theta[k] - diag
                denom = np.where(np.abs(denom) < 1e-8,
                                 np.sign(denom + 1e-30) * 1e-8, denom)
                new_dirs.append(r / denom)
        if all(conv[: min(nroots, m)]) and m >= nroots:
            break
        if len(V) + len(new_dirs) > max_space:
            # collapse the subspace to the current Ritz vectors
            V = []
            AV = []
            for k in range(min(nroots, m)):
                v = orthonormalize(Xs[k].copy())
                if v is not None:
                    V.append(v)
        added = 0
        for d in new_dirs:
            v = orthonormalize(d)
            if v is not None:
                V.append(v)
                added += 1
        if added == 0 and not all(conv[:nroots]):
            break
    return conv, theta[:nroots], [Xs[k] for k in range(nroots)]


# ---------------------------------------------------------------------------
# The device Davidson
# ---------------------------------------------------------------------------

def _device_tree(x, dtype, device):
    """A copy of an operand tree (tuples and lists of tensors, numbers and
    None) that a kept cycle program reads: tensors cloned, numbers as 0-d
    tensors of `dtype`."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        items = [_device_tree(y, dtype, device) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    if x is None:
        return None
    if isinstance(x, (int, float, np.number)):
        return torch.tensor(float(x), dtype=dtype, device=device)
    raise TypeError("a kept Davidson program takes operands made of "
                    f"tensors, numbers and None, not {type(x).__name__}")


def _copy_tree(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(torch.as_tensor(src, dtype=dst.dtype))
    elif dst is not None:
        if len(dst) != len(src):
            raise ValueError("the operands changed structure between "
                             "solves of one kept Davidson program")
        for d, s in zip(dst, src):
            _copy_tree(d, s)


class _Subspace:
    """The device state of one pipelined Davidson (JAX linalg.py:545-665):
    the basis V and its images AV as (S, n) tensors, the count m as a 0-d
    tensor, and static buffers for what the host gives each solve (diag,
    tol, the follow guesses G, the operands) and each cycle (`yth`: Y
    (nroots, S) then theta).  init, cycle and ritz are JAX's init, cycle
    and ritz programs; the cycle's collapse is a separate body (see
    davidson_device).  Every method writes V, AV and m in place, makes no
    host read and issues the same operations whatever the data."""

    def __init__(self, matvec, project, S, B, k, n, ng, dtype, device,
                 operands, kept):
        self.matvec, self.project = matvec, project
        self.S, self.B, self.k, self.n = S, B, k, n
        self.dtype = dtype
        z = dict(dtype=dtype, device=device)
        self.V = torch.zeros((S, n), **z)
        self.AV = torch.zeros((S, n), **z)
        self.m = torch.zeros((), dtype=torch.long, device=device)
        self.yth = torch.zeros(k * S + k, **z)
        self.diag = torch.zeros(n, **z)
        self.tol = torch.zeros((), **z)
        self.G = torch.zeros((ng, n), **z)
        self.rows = torch.arange(S, device=device)
        self.tiny = torch.finfo(dtype).tiny
        self.ops = (_device_tree(operands, dtype, device) if kept
                    else operands)
        self.kept = kept

    def start(self, diag, tol, G, operands):
        self.diag.copy_(diag)
        self.tol.fill_(tol)
        self.G.copy_(G)
        if self.kept:
            _copy_tree(self.ops, operands)

    def mv(self, v):
        out = self.matvec(v) if self.ops is None else self.matvec(v, self.ops)
        return out.reshape(-1).to(self.dtype)

    def insert(self, ptr, D, allow):
        """CGS2-orthonormalise the candidates D (rows) one after another
        against the first ptr rows of V and write each accepted one at
        row ptr (JAX `_ortho_insert`, :568-590): a candidate is rejected
        when its norm falls below 1e-12, when V is full, or where `allow`
        (a 0-d bool tensor, or True) is false.  Returns the new ptr."""
        V, S = self.V, self.S
        for d in D:
            if self.project is not None:
                d = self.project(d)
            mask = (self.rows < ptr).to(self.dtype)
            for _ in range(2):
                d = d - V.T @ ((V @ d) * mask)
            if self.project is not None:
                # CGS2 against projected rows brings back only O(eps) of
                # null-space content; project again before normalising
                d = self.project(d)
            nrm = torch.linalg.norm(d)
            ok = (nrm >= 1e-12) & (ptr < S) & allow
            row = torch.where(ok, d / torch.clamp(nrm, min=self.tiny),
                              torch.zeros_like(d))
            at = torch.clamp(ptr, max=S - 1).reshape(1)
            V.index_copy_(0, at, torch.where(ok, row[None, :],
                                             V.index_select(0, at)))
            ptr = ptr + ok.to(ptr.dtype)
        return ptr

    def mv_rows(self, start, count, allow):
        """AV rows start .. start + count - 1 = the matvecs of V's rows,
        one call each, the start clamped to S - count as JAX's
        dynamic_slice clamps it (`_mv_rows`, :592-595); rows are written
        only where `allow`."""
        first = torch.clamp(start, min=0, max=self.S - count)
        for i in range(count):
            at = (first + i).reshape(1)
            out = self.mv(self.V.index_select(0, at)[0])
            if allow is not True:
                out = torch.where(allow, out, self.AV.index_select(0, at)[0])
            self.AV.index_copy_(0, at, out[None, :])

    def pack(self, rn, need):
        """(H = V AV^T | G V^T | rn | m | need), the one read of a cycle."""
        H = self.V @ self.AV.T
        return torch.cat([H.reshape(-1), (self.G @ self.V.T).reshape(-1),
                          rn.to(self.dtype), self.m.to(self.dtype)[None],
                          need.to(self.dtype)[None]])

    def init(self, x0):
        self.V.zero_()
        self.AV.zero_()
        self.m.zero_()
        yes = torch.ones((), dtype=torch.bool, device=self.m.device)
        self.m.copy_(self.insert(self.m, x0, yes))
        self.mv_rows(torch.zeros_like(self.m), self.B, True)
        rn = torch.full((self.k,), float("inf"), dtype=self.dtype,
                        device=self.m.device)
        return self.pack(rn, ~yes)

    def ritz(self, Y):
        X = Y @ self.V
        return X / torch.clamp(torch.linalg.norm(X, dim=1, keepdim=True),
                               min=self.tiny)

    def cycle(self, collapse):
        """JAX's cycle program (:613-642) for the Y and theta in `yth`:
        the Ritz residuals, the preconditioned expansion, the insert, the
        matvecs of rows m .. m + nroots - 1 and the next projected matrix.
        `need` = m + (unconverged roots) > S is JAX's collapse condition.
        collapse=False: where `need` holds, nothing is written (the host
        then calls collapse=True with the same Y and theta); collapse=True:
        the basis restarts from the Ritz vectors first, as JAX's lax.cond
        branch does."""
        k, S = self.k, self.S
        Y = self.yth[:k * S].reshape(k, S)
        theta = self.yth[k * S:]
        X = Y @ self.V
        R = Y @ self.AV - theta[:, None] * X
        rn = torch.linalg.norm(R, dim=1)
        conv = rn < self.tol
        Xu = X / torch.clamp(torch.linalg.norm(X, dim=1, keepdim=True),
                             min=self.tiny)
        denom = theta[:, None] - self.diag[None, :]
        denom = torch.where(denom.abs() < 1e-8,
                            torch.sign(denom + 1e-30) * 1e-8, denom)
        D = torch.where(conv[:, None], torch.zeros_like(R), R / denom)
        need = self.m + (~conv).sum() > S
        if collapse:
            self.V.zero_()
            self.AV.zero_()
            zero = torch.zeros_like(self.m)
            start = self.insert(zero, Xu, True)
            self.mv_rows(zero, k, True)
            allow = True
        else:
            start, allow = self.m, ~need
        ptr = self.insert(start, D, allow)
        self.mv_rows(start, k, allow)
        self.m.copy_(ptr)
        return self.pack(rn, need)


class _Pipeline:
    """A _Subspace with its two cycle programs (device_loop.Program), the
    plain cycle and the collapse; the programs hold the subspace, and
    nothing here is held by them."""

    def __init__(self, sub):
        self.sub = sub
        self.programs = [Program(functools.partial(sub.cycle, c), sub.yth)
                         for c in (False, True)]

    def release(self):
        for p in self.programs:
            p.release()


def davidson_device(matvec, x0, diag, nroots=1, tol=1e-8, max_cycle=80,
                    max_space=20, follow=False, guesses=None, verbose=False,
                    operands=None, project=None, *, dtype=None, device=None,
                    log=None, programs=None):
    """davidson_nosym on the device: the JAX package's pipelined Davidson
    (davidson_pipelined_device and its programs, JAX linalg.py:545-757),
    the analogue of pyscf.lib.davidson_nosym1 at reference
    Solver_ES.py:710-711.

    The basis V and its images AV are (max_space, n) tensors on the device
    for the whole solve.  The init program inserts the guesses (CGS2) and
    applies the matvec to them; then each cycle is one call of a device
    program and one read: for the host's Ritz coefficients Y and values
    theta it forms the residuals, the preconditioned expansion, inserts it,
    applies nroots matvecs and packs (H = V AV^T | G V^T | |r| | m) into one
    vector, which the host reads to solve the small eigenproblem
    (numpy.linalg.eig of H[:m, :m], in the subspace dtype) for the next
    cycle's Y and theta: roots ordered by real part, or under `follow` by
    overlap with the guesses G.  It stops when every root's |r| < tol or
    when the basis stopped growing, and returns the Ritz vectors of the
    last Y.  JAX's collapse (a lax.cond) is a second program: a cycle
    whose insert would overflow V writes nothing and says so in its read,
    and the host calls the collapse program with the same Y and theta,
    which restarts the basis from the Ritz vectors and then runs the
    cycle.  The trajectory is JAX's; a collapse cycle costs the discarded
    cycle's matvecs once more.

    On the card each program is a device_loop.Program: the first call runs
    eagerly, the second is captured as a CUDA graph and the others replay
    it, so a cycle is one copy of Y and theta, one graph launch and one
    read (two launches and two reads on a collapse cycle).  On the CPU the
    same bodies run eagerly.

    :param matvec: flat (n,) tensor -> flat (n,) tensor; with `operands`
        given, called as matvec(v, operands).  It may run at a lower
        precision than the subspace bookkeeping.  It must read nothing to
        the host (it runs inside the captured cycle).
    :param x0: initial guess vectors (tensors or arrays), at most
        max_space
    :param diag: diagonal of the matrix (preconditioner)
    :param follow: pick Ritz roots by maximum overlap with `guesses`
        (default: the x0 vectors) instead of lowest eigenvalue
    :param project: optional projector P (flat (n,) -> flat (n,), P^2 = P)
        onto the invariant subspace the operator acts in.  It is applied to
        every candidate direction before the orthogonalisation and again
        after it.  Without it, f32 preconditioned residuals gather roundoff
        in the operator's structural null space; once such a direction is
        normalised into V its image is ~0 and a spurious ~0 eigenvalue
        converges as the lowest root.
    :param dtype, device: of the subspace; by default those of the first
        tensor among `diag` and `x0`.  With NumPy inputs only, the device
        is the card unless `device='cpu'` is given, and the dtype
        config.dtype.
    :param log: a dict that receives 'cycles', 'matvecs' (calls of
        `matvec`: the JAX count, len(x0) + nroots per cycle + nroots per
        collapse, plus nroots per collapse for the discarded cycle),
        'collapses', 'converged', 'graph' (whether a program replayed a
        captured graph), 'replays', and where a capture ran 'capture_ms'
        and 'empty_cache_ms' (summed over the programs), or None.
    :param programs: a dict that keeps the device state and its captured
        programs across solves of one operator shape (the same matvec,
        project, sizes, dtype and device): a later solve copies its diag,
        tolerance, guesses and operands (tuples of tensors and numbers, of
        the same structure) into the kept buffers and replays at once.
        None: both are made for this solve and freed at its end.  The
        caller releases a kept dict's entries (`release_programs`).
    :return: (converged flags, eigenvalues as float64 NumPy, eigenvectors
        as tensors on the device)
    """
    ref = next((a for a in (diag, *x0) if isinstance(a, torch.Tensor)), None)
    if ref is not None:
        device = ref.device if device is None else torch.device(device)
        dtype = ref.dtype if dtype is None else dtype
    else:
        from ecw_cc_torch.config import check_device, torch_dtype

        device = check_device("cuda" if device is None else device)
        dtype = torch_dtype(dtype)

    def dev(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype).reshape(-1)
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                            device=device).reshape(-1)

    diag_d = dev(diag)
    n = diag_d.numel()
    S = int(max_space)
    x0 = torch.stack([dev(v) for v in x0])
    B = x0.shape[0]
    if B > S:
        raise ValueError("more guesses than max_space")
    if nroots > S:
        raise ValueError("more roots than max_space")
    if follow:
        G = torch.stack([dev(g) for g in (x0 if guesses is None
                                          else guesses)])
    else:
        G = diag_d.new_zeros((0, n))
    ng = G.shape[0]

    key = (matvec, project, S, B, nroots, n, ng, dtype, str(device))
    pipe = None if programs is None else programs.get(key)
    if pipe is None:
        pipe = _Pipeline(_Subspace(matvec, project, S, B, nroots, n, ng,
                                   dtype, device, operands,
                                   programs is not None))
        if programs is not None:
            programs[key] = pipe
    sub = pipe.sub
    progs = pipe.programs
    # what a kept pipeline did before this solve
    before = [(p.replays, p.graph is not None) for p in progs]
    matvecs = B
    try:
        def unpack(p):
            H = p[:S * S].reshape(S, S)
            off = S * S
            Gov = p[off:off + ng * S].reshape(ng, S)
            off += ng * S
            return (H, Gov, p[off:off + nroots],
                    int(round(float(p[off + nroots]))),
                    bool(p[off + nroots + 1]))

        with torch.no_grad(), matmul_precision("highest"), \
                on_side_stream(device):
            sub.start(diag_d, tol, G, operands)
            H, Gov, rn, m, _ = unpack(sub.init(x0).cpu().numpy())
        if m < nroots:
            raise ValueError("no independent initial vectors")
        conv = [False] * nroots
        theta = np.zeros(nroots)
        Y = np.zeros((nroots, S))
        collapses = 0
        cyc = -1
        for cyc in range(max_cycle):
            w, y = np.linalg.eig(H[:m, :m])
            if follow:
                order = np.argsort(-np.max(np.abs(Gov[:, :m] @ y.real),
                                           axis=0))
            else:
                order = np.argsort(w.real)
            w = w[order]
            y = y[:, order]
            kc = min(nroots, m)
            theta[:kc] = w[:kc].real
            Y = np.zeros((nroots, S))
            Y[:kc, :m] = y[:, :nroots].real.T
            m_prev = m
            H, Gov, rn, m, need = unpack(progs[0](
                np.concatenate([Y.ravel(), theta])))
            matvecs += nroots
            if need:
                H, Gov, rn, m, _ = unpack(progs[1]())
                collapses += 1
                matvecs += 2 * nroots
            conv = [bool(r < tol) for r in rn]
            if verbose:
                print(f"  davidson cycle {cyc:3d} m={m_prev:3d} "
                      f"|r|={[f'{r:.2e}' for r in rn]}", flush=True)
            if all(conv[:nroots]):
                break
            if m == m_prev:
                break                           # stall: no new directions
        with torch.no_grad(), on_side_stream(device):
            X = sub.ritz(torch.as_tensor(Y, dtype=dtype, device=device))
    finally:
        if programs is None:
            pipe.release()
    if log is not None:
        replays = sum(p.replays - r for p, (r, _) in zip(progs, before))
        caps = [p for p, (_, had) in zip(progs, before)
                if not had and p.capture_ms is not None]
        log.update(cycles=cyc + 1, matvecs=matvecs, collapses=collapses,
                   converged=list(conv[:nroots]), graph=replays > 0,
                   replays=replays)
        if caps:
            log.update(capture_ms=sum(p.capture_ms for p in caps),
                       empty_cache_ms=sum(p.empty_cache_ms for p in caps))
    return conv, theta[:nroots].copy(), [X[k] for k in range(nroots)]


def release_programs(programs):
    """Free the captured programs and device state that davidson_device
    kept in `programs`, and empty it."""
    for pipe in programs.values():
        pipe.release()
    programs.clear()


# the JAX package's host-cycle and fused variants are not ported (the
# fused one exists for a TPU's missing non-symmetric eig); the names stay
# so that callers read the same
davidson_nosym_device = davidson_device
davidson_pipelined_device = davidson_device
