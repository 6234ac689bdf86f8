"""EOM-EE-CCSD by automatic differentiation (port of ecw_cc_tpu/ops/eom.py).

At a converged CCSD point the Jacobian of the residual equations,
A_{mu nu} = dR_mu/dt_nu = <mu| e^-T [H, tau_nu] e^T |0>, is the EOM-EE-CCSD
matrix: its right and left eigenpairs are the EOM excitation energies and
R/L amplitudes.  The sigma vectors are therefore

    sigma(r)   = jvp(residual, t, r)      (right)
    sigma_L(l) = vjp(residual, t)(l)      (left)

with residual = ops/ccsd.tupdate(..., equation=True) (or the sorted
layout's ops/ccsd_sect.tupdate_sect), which is zero at the solution.
`make_sigma`, the public pair, takes them with torch.func.jvp and vjp.
The solver evaluates the residual once per problem instead and keeps its
autograd graph (`_linearize`; under jit the JAX package's XLA drops the
primal that jax.jvp computes, JAX ops/eom.py:53-61): a left matvec is
that graph's backward, and a right matvec the backward of the linear map
l -> vjp(l), taken once at l = 0 with its own graph (a double backward).
On the card the residual's ladder runs the hand-written kernel, so a
problem launches it once forward per product for the primal and once
backward for the map's graph, then each right matvec once per product (a
tangent, kernels/ladder_mm.py) and each left matvec once backward; no
matvec launches a forward product.

The Davidson (utils/linalg.davidson_device, the JAX package's pipelined
one, each cycle a captured program on the card) runs in the
antisymmetric, spin-balanced doubles subspace; the left roots take the
raw-storage to determinant metric correction (x4 on the doubles) and are
biorthonormalised to the right ones.  Transition and excited-state
densities come from the Wick engine's terms (ops/wick.
generate_trdm_terms), contracted with torch.einsum along a path chosen
once per expression (`contract`).
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ecw_cc_torch.ops import ccsd as ccsd_ops
from ecw_cc_torch.parallel import sharding
from ecw_cc_torch.solvers.device_loop import on_side_stream
from ecw_cc_torch.utils.linalg import davidson_device


# ---------------------------------------------------------------------------
# multi-operand einsum along a fixed pairwise path
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _path(expr, shapes):
    """The pairwise contraction order of `expr` at these operand shapes
    (numpy's 'optimal' search on stride-0 stand-ins: no memory is
    touched): a list of (i, j) operand positions, as np.einsum_path gives
    them."""
    fakes = [np.broadcast_to(np.zeros(()), s) for s in shapes]
    path, _ = np.einsum_path(expr, *fakes, optimize="optimal")
    return tuple(tuple(p) for p in path[1:])


def contract(expr, *operands):
    """torch.einsum(expr, *operands), two operands at a time along the path
    `_path` picks (the JAX twin's einsum(optimize=True)): a term such as
    'ijab,klcd,...' never forms an outer product of its first two factors,
    and the order does not depend on whether opt_einsum is installed."""
    if len(operands) <= 2:
        return torch.einsum(expr, *operands)
    inputs, out = expr.split("->")
    subs = inputs.split(",")
    ops = list(operands)
    for pos in _path(expr, tuple(tuple(o.shape) for o in operands)):
        picked = [subs[p] for p in pos]
        picked_ops = [ops[p] for p in pos]
        for p in sorted(pos, reverse=True):
            del subs[p]
            del ops[p]
        rest = "".join(subs) + out
        keep = "".join(dict.fromkeys(c for c in "".join(picked)
                                     if c in rest))
        ops.append(torch.einsum(",".join(picked) + "->" + keep,
                                *picked_ops))
        subs.append(keep)
    return torch.einsum(subs[0] + "->" + out, ops[0])


# ---------------------------------------------------------------------------
# sigma vectors
# ---------------------------------------------------------------------------

def _residual(eris, vvvv_op, fsp, a, b, sect):
    if sect is not None:
        from ecw_cc_torch.ops.ccsd_sect import tupdate_sect

        # sym stays OFF inside jvp/vjp, whatever the mirror gate said: the
        # mirror-halved kernels fold the derivative (a tangent or cotangent
        # need not be mirror-symmetric); the plain sectored map restricted
        # to spin-balanced directions equals the dense Jacobian
        f = eris.fock if fsp is None else fsp
        return tupdate_sect(eris, a, b, f, sect[0], vvvv_op=vvvv_op,
                            equation=True)
    return ccsd_ops.tupdate(eris, a, b, fsp=fsp, equation=True,
                            vvvv_op=vvvv_op)


def _sigma_right(eris, vvvv_op, fsp, t1, t2, r1, r2, sect=None):
    def res(a, b):
        return _residual(eris, vvvv_op, fsp, a, b, sect)

    _, s = torch.func.jvp(res, (t1, t2), (r1, r2))
    return s


def _sigma_left(eris, vvvv_op, fsp, t1, t2, l1, l2, sect=None):
    def res(a, b):
        return _residual(eris, vvvv_op, fsp, a, b, sect)

    _, vjp = torch.func.vjp(res, t1, t2)
    return vjp((l1, l2))


def make_sigma(eris, t1, t2, fsp=None, vvvv_op=None, sect=None):
    """(sigma_right, sigma_left) at the converged amplitudes.

    vvvv_op: a non-dense ladder operand (PackedVVVV, SectoredVVVV).  Exact
    for the Davidson iterates: right tangents are antisymmetric (where the
    packed route equals the dense ladder), and for antisymmetric
    cotangents the packed route's transpose collapses to the dense one
    under the left matvec's output antisymmetrisation.

    sect: optional (SectorInfo, sym): the sector-blocked residual (sorted
    layout), always run with sym=False.  Exact for EOM-EE: Sz-conserving
    R/L vectors are spin-balanced, the Jacobian maps the balanced subspace
    to itself, and the guesses are balanced.

    On a device mesh (ERIs, amplitudes or operand as DTensors,
    parallel/sharding.py) the transforms run on plain tensors: the ERIs
    and amplitudes are gathered once here, the ladder operand (a split
    vvvv or vvvv_op) becomes this rank's RowShard, whose product carries
    its own tangent and gradient rules (one launch on the local rows
    each), and each sigma gathers its input vectors and returns its
    output in their placements."""
    if sharding.mesh_of(eris, t1, t2, fsp, vvvv_op) is not None:
        eris = sharding.local_eris(eris)
        t1, t2, fsp = (sharding.replicate(x) for x in (t1, t2, fsp))
        vvvv_op = sharding.local_operand(vvvv_op)

    def placed(fn):
        def run(x1, x2):
            y1, y2 = fn(sharding.replicate(x1), sharding.replicate(x2))
            return sharding.place_like(y1, x1), sharding.place_like(y2, x2)
        return run

    @placed
    def sigma(r1, r2):
        return _sigma_right(eris, vvvv_op, fsp, t1, t2, r1, r2, sect=sect)

    @placed
    def sigma_left(l1, l2):
        return _sigma_left(eris, vvvv_op, fsp, t1, t2, l1, l2, sect=sect)

    return sigma, sigma_left


def _asym(r2):
    return 0.25 * (r2 - r2.permute(1, 0, 2, 3) - r2.permute(0, 1, 3, 2)
                   + r2.permute(1, 0, 3, 2))


def _balance_masks(nocc, nvir, info):
    """The spin-balance masks of the sorted layout (NumPy 0/1): singles
    alpha->alpha or beta->beta, doubles whose occupied spins sum to the
    virtual ones'."""
    so = np.zeros(nocc, dtype=int)
    so[info.oa:] = 1
    sv = np.zeros(nvir, dtype=int)
    sv[info.va:] = 1
    mask1 = (so[:, None] == sv[None, :]).astype(np.float64)
    mask2 = ((so[:, None, None, None] + so[None, :, None, None])
             == (sv[None, None, :, None]
                 + sv[None, None, None, :])).astype(np.float64)
    return mask1, mask2


def _linearize(eris, vvvv_op, fsp, t1, t2, sect=None):
    """(right, left) at the converged amplitudes from one evaluation of
    the residual, kept with its autograd graph for the problem:
    left(l1, l2) is its vjp, the kept graph's backward; right(r1, r2) = J r
    is the vjp of the linear map u -> J^T u, whose graph is taken once at
    u = 0 (create_graph).  Equal to make_sigma's jvp and vjp (the exact
    Jacobian of the same function either way), with no forward product
    per call.  The graph is built on the device loops' side stream
    (device_loop.on_side_stream), so that each backward, which runs on
    its forward's stream, lands on a captured Davidson cycle's stream."""
    with on_side_stream(t1.device), torch.enable_grad():
        a = t1.detach().requires_grad_(True)
        b = t2.detach().requires_grad_(True)
        res = _residual(eris, vvvv_op, fsp, a, b, sect)
        u = tuple(torch.zeros_like(x).requires_grad_(True) for x in res)
        g = torch.autograd.grad(res, (a, b), u, create_graph=True)

    def right(r1, r2):
        return torch.autograd.grad(g, u, (r1, r2), retain_graph=True)

    def left(l1, l2):
        return torch.autograd.grad(res, (a, b), (l1, l2), retain_graph=True)

    return right, left


def _mv_factory(nocc, nvir, sect, dtype, device, right, left):
    """(mv_right, mv_left, project, unpack) for one EE problem, the
    matvecs on `_linearize`'s (right, left): the antisymmetriser and, on
    the sorted layout, the spin-balance projector (the sectored Jacobian's
    off-balance sector is an exact null space, in which f32 Davidson
    residuals otherwise gather roundoff until a spurious ~0 root
    converges; masking every iterate and matvec output keeps the Krylov
    space exactly Sz-conserving)."""
    nov = nocc * nvir
    if sect is not None:
        m1, m2 = _balance_masks(nocc, nvir, sect[0])
        mask1 = torch.as_tensor(m1, dtype=dtype, device=device)
        mask2 = torch.as_tensor(m2, dtype=dtype, device=device)
    else:
        mask1 = mask2 = None

    def unpack(v, asym=True):
        r1 = v[:nov].reshape(nocc, nvir)
        r2 = v[nov:].reshape(nocc, nocc, nvir, nvir)
        if asym:
            r2 = _asym(r2)
        if mask1 is not None:
            r1 = r1 * mask1
            r2 = r2 * mask2
        return r1, r2

    def _pack_out(s1, s2):
        if mask1 is not None:
            s1 = s1 * mask1
            s2 = s2 * mask2
        return torch.cat([s1.reshape(-1), s2.reshape(-1)])

    def mv_right(v):
        return _pack_out(*right(*unpack(v.to(dtype))))

    def mv_left(v):
        # the transpose of (A . P) is P . A^T: the raw cotangent goes into
        # the vjp unprojected, and the output doubles are antisymmetrised
        s1, s2 = left(*unpack(v.to(dtype), asym=False))
        return _pack_out(s1, _asym(s2))

    def project(v):
        # the input-space projector (antisymmetry x spin balance) for the
        # Davidson's candidate directions
        r1, r2 = unpack(v)
        return torch.cat([r1.reshape(-1), r2.reshape(-1)])

    return mv_right, mv_left, project, unpack


# ---------------------------------------------------------------------------
# guesses
# ---------------------------------------------------------------------------

def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def koopman_guesses(eris, nroots, alpha_only=True, info=None):
    """Unit r1 vectors on the smallest orbital-energy gaps (Koopman); with
    alpha_only, only alpha->alpha excitations are seeded.  info: the
    SectorInfo of the spin-sorted layout, else the alternating
    [0,1,0,1,...] convention is assumed."""
    nocc, nvir = eris.nocc, eris.nvir
    mo_e = np.diag(_host(eris.fock)).astype(np.float64)
    gaps = mo_e[None, nocc:] - mo_e[:nocc, None]
    if alpha_only:
        mask = np.ones_like(gaps) * np.inf
        if info is not None:
            mask[:info.oa, :info.va] = 0.0
        else:
            mask[0::2, 0::2] = 0.0
        gaps = gaps + mask
    order = np.argsort(gaps.ravel())
    guesses = []
    for k in range(nroots):
        g = np.zeros(nocc * nvir)
        g[order[k]] = 1.0
        guesses.append(g)
    return guesses


def cis_guesses(eris, nroots, info=None, alpha_only=True):
    """CIS-quality singles guesses: the lowest eigenvectors of the explicit
    singles block A[ia,jb] = d_ij d_ab (e_a - e_i) + <aj||ib>, on the host
    (nov x nov).  For an RHF-derived GHF the two spin-adapted alpha-sized
    blocks A+- = A_same +- A_cross (singlet, triplet) are diagonalised with
    eigh; otherwise the full matrix with eig, keeping roots with weight in
    the alpha->alpha sector.  Returns raveled r1 guesses (NumPy)."""
    nocc, nvir = eris.nocc, eris.nvir
    mo_e = np.diag(_host(eris.fock)).astype(np.float64)
    eia = mo_e[None, nocc:] - mo_e[:nocc, None]          # (o, v)
    ovvo = _host(eris.ovvo).astype(np.float64)            # <ja||bi>
    if info is not None:
        oA = np.arange(info.oa); oB = info.oa + np.arange(info.ob)
        vA = np.arange(info.va); vB = info.va + np.arange(info.vb)
    else:
        oA = np.arange(0, nocc, 2); oB = np.arange(1, nocc, 2)
        vA = np.arange(0, nvir, 2); vB = np.arange(1, nvir, 2)
    paired = (len(oA) == len(oB) and len(vA) == len(vB)
              and np.allclose(mo_e[oA], mo_e[oB], atol=1e-10)
              and np.allclose(mo_e[nocc + vA], mo_e[nocc + vB],
                              atol=1e-10))
    if paired and len(oA) and alpha_only:
        na = len(oA) * len(vA)
        same = ovvo[np.ix_(oA, vA, vA, oA)].transpose(3, 1, 0, 2)
        cross = ovvo[np.ix_(oB, vA, vB, oA)].transpose(3, 1, 0, 2)
        same = same.reshape(na, na).copy()
        cross = cross.reshape(na, na)
        same[np.arange(na), np.arange(na)] += eia[np.ix_(oA, vA)].ravel()
        cands = []
        for sgn in (1.0, -1.0):
            M = same + sgn * cross
            w, v = np.linalg.eigh(0.5 * (M + M.T))
            for k in range(min(nroots + 2, na)):
                cands.append((w[k], v[:, k], sgn))
        cands.sort(key=lambda t: t[0])
        guesses = []
        for _, vk, sgn in cands[:nroots]:
            g = np.zeros((nocc, nvir))
            g[np.ix_(oA, vA)] = vk.reshape(len(oA), len(vA))
            g[np.ix_(oB, vB)] = sgn * vk.reshape(len(oA), len(vA))
            guesses.append(g.ravel() / np.linalg.norm(g))
        return guesses

    A = np.transpose(ovvo, (3, 1, 0, 2)).copy()
    A = A.reshape(nocc * nvir, nocc * nvir)
    A[np.arange(nocc * nvir), np.arange(nocc * nvir)] += eia.ravel()
    w, v = np.linalg.eig(A)
    guesses = []
    for idx in np.argsort(w.real):
        g = v[:, idx].real.copy()
        if alpha_only:
            g2 = g.reshape(nocc, nvir)
            m = np.zeros_like(g2)
            if info is not None:
                m[:info.oa, :info.va] = 1.0
            else:
                m[0::2, 0::2] = 1.0
            if np.linalg.norm(g2 * m) < 0.5:
                continue
        nrm = np.linalg.norm(g)
        if nrm < 1e-12:
            continue
        guesses.append(g / nrm)
        if len(guesses) == nroots:
            break
    if len(guesses) < nroots:      # pathological fallback
        guesses += koopman_guesses(eris, nroots - len(guesses), info=info)
    return guesses


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def _diag(eris, nocc):
    mo_e = np.diag(_host(eris.fock)).astype(np.float64)
    d1 = (mo_e[None, nocc:] - mo_e[:nocc, None]).ravel()
    eia = mo_e[:nocc, None] - mo_e[None, nocc:]
    d2 = -(eia[:, None, :, None] + eia[None, :, None, :]).ravel()
    return np.concatenate([d1, d2])


def canonical_phase(v):
    """v (a flat tensor) normalised, with its first near-maximal component
    positive: spin-partner components have equal magnitudes, so a bare
    argmax would depend on the rounding, and transition densities flip
    with the sign."""
    v = v / torch.linalg.norm(v)
    av = v.abs()
    idx = int(torch.nonzero(av >= 0.999 * av.max())[0, 0])
    return -v if float(v[idx]) < 0 else v


def _flat(x1, x2):
    return torch.cat([x1.reshape(-1), x2.reshape(-1)])


def eom_ccsd(eris, t1, t2, nroots=1, fsp=None, guess=None, tol=1e-7,
             max_space=30, max_cycle=120, left=False, vvvv_op=None,
             sect=None, log=None):
    """EOM-EE-CCSD roots by Davidson on the autodiff sigma, on the tensors'
    device.

    :param sect: None, or (SectorInfo, sym) for the sorted layout (the
        sector-blocked residual, always sym=False, and the balance
        projector).
    :param log: a dict that receives, per Davidson solve ('right', 'left'
        and 'left_follow' for each per-root fallback), its log
        (utils/linalg.davidson_device: cycles, matvecs, converged flags,
        and its programs' graph, replays and capture ms).
    :return: (omegas, [(r1, r2), ...]) as floats and tensors; with
        left=True also [(l1, l2), ...], metric-corrected and
        biorthonormalised: l1.r1 + 1/4 l2.r2 = 1.
    """
    nocc, nvir = t1.shape
    dtype, device = t1.dtype, t1.device
    diag = torch.as_tensor(_diag(eris, nocc), dtype=dtype, device=device)
    mv_right, mv_left, project, unpack = _mv_factory(
        nocc, nvir, sect, dtype, device,
        *_linearize(eris, vvvv_op, fsp, t1, t2, sect))
    log = {} if log is None else log

    if guess is None:
        guess = cis_guesses(eris, nroots,
                            info=None if sect is None else sect[0])
    x0 = [np.concatenate([np.asarray(g, dtype=np.float64),
                          np.zeros(nocc * nocc * nvir * nvir)])
          for g in guess]
    log["right"] = {}
    conv, w, xs = davidson_device(mv_right, x0, diag, nroots=nroots, tol=tol,
                                  max_cycle=max_cycle, max_space=max_space,
                                  project=project, log=log["right"])
    if not all(conv[:nroots]):
        # an exhausted Davidson can report junk roots (e.g. ~0 from the
        # projected null space); say so instead of returning quietly
        warnings.warn(
            f"EOM Davidson unconverged roots: conv={list(conv[:nroots])} "
            f"omegas={[float(x) for x in w[:nroots]]} (tol={tol}; in f32 "
            "use tol>=1e-5)", RuntimeWarning, stacklevel=2)
    omegas = [float(x) for x in w[:nroots]]
    Rs = [unpack(canonical_phase(xs[k].to(dtype))) for k in range(nroots)]
    if not left:
        return omegas, Rs

    # ONE block Davidson for all left roots from the R vectors (A^T has
    # A's spectrum), each left root then paired to its right root by
    # raw-storage overlap (eigenvalues alone mis-pair degenerate
    # multiplets); a root that pairs badly gets a per-root follow solve
    xr = [_flat(*R) for R in Rs]
    log["left"] = {}
    conv_l, wl, xls = davidson_device(mv_left, xr, diag, nroots=nroots,
                                      tol=tol, max_cycle=max_cycle,
                                      project=project, max_space=max_space,
                                      log=log["left"])
    ovm = (torch.stack(list(xls)) @ torch.stack(xr).T).abs().double()
    ovm = ovm.cpu().numpy()
    assign = {}
    for _ in range(nroots):
        j, k = np.unravel_index(np.argmax(ovm), ovm.shape)
        assign[k] = j
        ovm[j, :] = -1.0
        ovm[:, k] = -1.0
    Ls = []
    for k in range(nroots):
        j = assign[k]
        bad = (not conv_l[j]) or abs(wl[j] - omegas[k]) > max(1e-3,
                                                               1e3 * tol)
        if bad:
            sub = log.setdefault("left_follow", [])
            sub.append({})
            conv_1, _, xl_1 = davidson_device(
                mv_left, [xr[k]], diag, nroots=1, tol=tol,
                max_cycle=max_cycle, project=project, max_space=max_space,
                follow=True, log=sub[-1])
            if not conv_1[0]:
                warnings.warn(
                    f"EOM left Davidson unconverged for root {k} "
                    f"(omega={omegas[k]:.6f}, tol={tol}); the L vector and "
                    "any transition density built from it may be "
                    "inaccurate", RuntimeWarning, stacklevel=2)
            lv = xl_1[0]
        else:
            lv = xls[j]
        l1, l2 = unpack(lv.to(dtype))
        # METRIC CORRECTION + biorthonormalisation.  The Davidson solves
        # the transpose of the raw-storage map, whose inner product counts
        # each physical (i<j, a<b) doubles slot 4x; the left eigenvector of
        # the determinant-basis EOM matrix is D.y with D = diag(1 on
        # singles, 4 on doubles).  The returned Ls are operator-convention
        # amplitudes (the 1/4-weighted storage of Lambda) with
        # <L|R> = l1.r1 + 1/4 l2.r2 = 1; the raw A^T eigenvector is
        # (l1, l2/4)
        l2 = 4.0 * l2
        ov = float(torch.vdot(l1.reshape(-1), Rs[k][0].reshape(-1))
                   + 0.25 * torch.vdot(l2.reshape(-1), Rs[k][1].reshape(-1)))
        Ls.append((l1 / ov, l2 / ov))
    return omegas, Rs, Ls


# ---------------------------------------------------------------------------
# transition and excited-state densities (Wick terms)
# ---------------------------------------------------------------------------

_TRDM_CACHE: dict = {}


def _trdm_terms(bra, ket, ps, qs):
    key = (bra, ket, ps, qs)
    if key not in _TRDM_CACHE:
        from ecw_cc_torch.ops.wick import generate_trdm_terms

        _TRDM_CACHE[key] = tuple(
            (c, tuple(p), o)
            for c, p, o in generate_trdm_terms(bra, ket, ps, qs))
    return _TRDM_CACHE[key]


def _eval_trdm(bra, ket, tens, nocc, nvir, dtype):
    """The full (nmo, nmo) gamma_pq from its four Wick blocks."""
    dims = {"o": nocc, "v": nvir}
    device = tens["t1"].device
    rows = []
    for ps in ("o", "v"):
        cols = []
        for qs in ("o", "v"):
            acc = torch.zeros((dims[ps], dims[qs]), dtype=dtype,
                              device=device)
            for coeff, pieces, out in _trdm_terms(bra, ket, ps, qs):
                operands = [tens[name] for name, _ in pieces]
                subs = [ss for _, ss in pieces]
                acc = acc + coeff * contract(",".join(subs) + "->" + out,
                                             *operands)
            cols.append(acc)
        rows.append(torch.cat(cols, dim=1))
    return torch.cat(rows, dim=0)


def _as(x, t1):
    return torch.as_tensor(x, dtype=t1.dtype, device=t1.device)


def tr_rdm1_right(t1, t2, lam1, lam2, r1, r2, r0):
    """EOM-EE right transition rdm1 <0|(1+Lambda) (e^-T ap+.aq e^T)
    (r0+R)|0>, including the <0|pq-bar R|0> coupling of the bra's
    reference component with R (without it the biorthogonal dipole product
    fails the FCI identity)."""
    nocc, nvir = t1.shape
    tens = {"t1": t1, "t2": t2, "l1": _as(lam1, t1), "l2": _as(lam2, t1),
            "ree1": _as(r1, t1), "ree2": _as(r2, t1),
            "eye_o": torch.eye(nocc, dtype=t1.dtype, device=t1.device)}
    g = _eval_trdm("gs", "ree", tens, nocc, nvir, t1.dtype)
    if r0 != 0.0:
        g = g + r0 * _eval_trdm("gs", "ref", tens, nocc, nvir, t1.dtype)
    return g


def tr_rdm1_left(t1, t2, lk1, lk2):
    """EOM-EE left transition rdm1 <0|L (e^-T ap+.aq e^T)|0> (l0 = 0)."""
    nocc, nvir = t1.shape
    tens = {"t1": t1, "t2": t2, "lee1": _as(lk1, t1), "lee2": _as(lk2, t1),
            "eye_o": torch.eye(nocc, dtype=t1.dtype, device=t1.device)}
    return _eval_trdm("lee", "ref", tens, nocc, nvir, t1.dtype)


def es_rdm1(t1, t2, lk1, lk2, r1, r2, r0):
    """EOM-EE excited-state one-body density
    <0|L_k (e^-T ap+.aq e^T) (r0 + R_k)|0> (biorthogonal; l0 = 0).  With
    the metric-corrected, biorthonormalised L_k of eom_ccsd(left=True) its
    trace is the electron number."""
    nocc, nvir = t1.shape
    tens = {"t1": t1, "t2": t2, "lee1": _as(lk1, t1), "lee2": _as(lk2, t1),
            "ree1": _as(r1, t1), "ree2": _as(r2, t1),
            "eye_o": torch.eye(nocc, dtype=t1.dtype, device=t1.device)}
    g = _eval_trdm("lee", "ree", tens, nocc, nvir, t1.dtype)
    if r0 != 0.0:
        g = g + r0 * _eval_trdm("lee", "ref", tens, nocc, nvir, t1.dtype)
    return g


def eom_r0(eris, t1, t2, r1, r2, omega, fsp=None):
    """r0 = <0|Hbar R|0> / omega, with <0|Hbar R|0> = dE/dt . R: the
    gradient of the CCSD energy functional (one backward) dotted with R,
    as the JAX package's jax.jvp of it gives."""
    with torch.enable_grad():
        a = t1.detach().requires_grad_(True)
        b = t2.detach().requires_grad_(True)
        g = torch.autograd.grad(ccsd_ops.energy(eris, a, b, fsp), (a, b),
                                allow_unused=True)
    dE = sum(torch.vdot(x.reshape(-1), _as(r, t1).reshape(-1))
             for x, r in zip(g, (r1, r2)) if x is not None)
    return float(dE) / omega
