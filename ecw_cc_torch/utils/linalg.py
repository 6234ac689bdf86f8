"""Linear-algebra helpers, initial guesses and the non-symmetric Davidson
eigensolvers (reference utilities.py:397-876).

The host half (everything down to `davidson_nosym`) is a copy of
ecw_cc_tpu/utils/linalg.py:12-338 (the PyTorch port imports nothing of the
JAX package); only the imports differ.

`davidson_device` is the port of the JAX package's device Davidson
(linalg.py:668-958).  The JAX package has three device variants, because a
TPU has no non-symmetric eigensolver and every host read crosses a
network: a host-cycle loop, a one-round-trip "pipelined" loop with a cache
of compiled programs, and a fully fused loop on a hand-written shifted-QR
eig (utils/schur.py).  Here `torch.linalg.eig` runs on the tensors' device,
so one variant serves; `davidson_nosym_device` and
`davidson_pipelined_device` are kept as names for it, so that callers read
the same.  The fused variant, the program cache and schur.py are not
ported.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

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

def davidson_device(matvec, x0, diag, nroots=1, tol=1e-8, max_cycle=80,
                    max_space=20, follow=False, guesses=None, verbose=False,
                    operands=None, project=None, *, dtype=None, device=None,
                    log=None):
    """davidson_nosym with the basis V and its images AV held as
    (max_space, n) tensors on the device for the whole solve.  Same
    algorithm and semantics as davidson_nosym (the analogue of
    pyscf.lib.davidson_nosym1 at reference Solver_ES.py:710-711).

    Per cycle the host reads the residual norms (one read of nroots
    numbers) and the number of accepted directions (one integer).  The
    small projected eigenproblem is ONE torch.linalg.eig call per cycle on
    the (m, m) matrix, m <= max_space, on the tensors' device; its spectrum
    comes back complex and unordered, so the roots are sorted by real part
    (or by overlap with the guesses under `follow`) and the imaginary parts
    of the real roots are dropped, as the twin does.

    :param matvec: flat (n,) tensor -> flat (n,) tensor; with `operands`
        given, called as matvec(v, operands).  It may run at a lower
        precision than the subspace bookkeeping.
    :param x0: initial guess vectors (tensors or arrays)
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
    :param log: a dict that receives 'cycles' (eigenproblems solved),
        'matvecs' (calls of `matvec`) and 'converged', or None.
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
    x0 = [dev(v) for v in x0]
    if len(x0) > S:
        raise ValueError("more guesses than max_space")
    calls = [0]

    def mv(v):
        calls[0] += 1
        return matvec(v) if operands is None else matvec(v, operands)

    rows = torch.arange(S, device=device)
    tiny = torch.finfo(dtype).tiny

    def ortho_insert(V, m, D):
        # CGS2-orthonormalise the candidates D (k, n) one after the other
        # against the first `ptr` rows of V and write each accepted one in
        # place; ptr stays on the device, so the block costs one read
        ptr = torch.full((1,), m, dtype=torch.long, device=device)
        for d in D:
            if project is not None:
                d = project(d)
            mask = (rows < ptr).to(dtype)
            for _ in range(2):
                d = d - V.T @ ((V @ d) * mask)
            if project is not None:
                # CGS2 against projected rows brings back only O(eps) of
                # null-space content; project again before normalising
                d = project(d)
            nrm = torch.linalg.norm(d)
            ok = (nrm >= 1e-12) & (ptr < S)
            row = torch.where(ok, d / torch.clamp(nrm, min=tiny),
                              torch.zeros_like(d))
            at = torch.clamp(ptr, max=S - 1)
            V.index_copy_(0, at, torch.where(ok, row[None, :],
                                             V.index_select(0, at)))
            ptr = ptr + ok.to(ptr.dtype)
        return int(ptr)

    def add_block(V, AV, m, cand):
        """Orthonormalise candidate directions into V, then their images."""
        if not cand:
            return m
        m_new = ortho_insert(V, m, cand)
        for i in range(m, m_new):
            AV[i] = mv(V[i]).reshape(-1).to(dtype)
        return m_new

    V = torch.zeros((S, n), dtype=dtype, device=device)
    AV = torch.zeros((S, n), dtype=dtype, device=device)
    m = add_block(V, AV, 0, x0)
    if m == 0:
        raise ValueError("no independent initial vectors")
    G = None
    if follow:
        G = torch.stack([dev(g) for g in (x0 if guesses is None else guesses)])

    conv = [False] * nroots
    theta = np.zeros(nroots)
    Xs = [None] * nroots
    cycle = -1
    for cycle in range(max_cycle):
        H = V[:m] @ AV[:m].T
        w, y = torch.linalg.eig(H)
        if follow:
            score = ((G @ V[:m].T) @ y.real).abs().amax(dim=0)
            order = torch.argsort(-score)
        else:
            order = torch.argsort(w.real)
        kc = min(nroots, m)
        sel = order[:kc]
        th = w.real[sel]                             # (kc,)
        Y = y.real[:, sel].T                         # (kc, m)
        X = Y @ V[:m]
        R = Y @ AV[:m] - th[:, None] * X
        Xn = X / torch.clamp(torch.linalg.norm(X, dim=1, keepdim=True),
                             min=tiny)
        denom = th[:, None] - diag_d[None, :]
        denom = torch.where(denom.abs() < 1e-8,
                            torch.sign(denom + 1e-30) * 1e-8, denom)
        Dk = R / denom
        # the one read of the cycle's Ritz data: theta and |r| together
        got = torch.cat([th, torch.linalg.norm(R, dim=1)]).double().cpu()
        theta[:kc] = got[:kc].numpy()
        rns = got[kc:].numpy()
        new_dirs = []
        for k in range(kc):
            Xs[k] = Xn[k]
            conv[k] = float(rns[k]) < tol
            if verbose:
                print(f"  davidson cycle {cycle:3d} m={m:3d} root {k}: "
                      f"theta={theta[k]:.8f} |r|={rns[k]:.2e}", flush=True)
            if not conv[k]:
                new_dirs.append(Dk[k])
        if all(conv[:kc]) and m >= nroots:
            break
        if m + len(new_dirs) > S:
            # collapse the subspace to the current Ritz vectors
            V = torch.zeros((S, n), dtype=dtype, device=device)
            AV = torch.zeros((S, n), dtype=dtype, device=device)
            m = add_block(V, AV, 0, [Xs[k] for k in range(min(nroots, len(Xs)))
                                     if Xs[k] is not None])
        m_before = m
        m = add_block(V, AV, m, new_dirs)
        if m == m_before and not all(conv[:nroots]):
            break
    if log is not None:
        log.update(cycles=cycle + 1, matvecs=calls[0],
                   converged=list(conv[:nroots]))
    return conv, theta[:nroots], [Xs[k] for k in range(nroots)]


# the JAX package's other two device variants differ from this one only in
# how they cross to the host; the names stay so that callers read the same
davidson_nosym_device = davidson_device
davidson_pipelined_device = davidson_device
