"""CCSD(T): plain CCSD solve, perturbative triples energy and response
density (port of ecw_cc_tpu/ops/ccsd_t.py; replaces the reference's use of
pyscf ccsd_t_lambda_slow / ccsd_t_rdm_slow, gamma_exp.py:228-248).

Energy: the spin-orbital (T) correction
    D_ijkabc = f_ii + f_jj + f_kk - f_aa - f_bb - f_cc
    t3c = P(i/jk) P(a/bc) [ t2_jkae <ei||bc> - t2_imbc <ma||jk> ] / D
    t3d = P(i/jk) P(a/bc) [ t1_ia <jk||bc> ] / D
    E_T = 1/36 sum t3c * D * (t3c + t3d)
evaluated pair by pair: a Python loop over the occupied pairs (I, J) whose
body holds only (o, v, v, v) slabs (`energy_t`), or one such loop per
occupied spin-sector pair on the sorted layout, with every slab contraction
restricted to its nonzero spin blocks (`energy_t_sect`).  `_energy_t_dense`
materializes the full t3 and is the oracle for both on tiny systems.

Density: the unrelaxed response density gamma_pq = dE_CCSD(T)/df_pq by the
implicit-function theorem on the SCF update MAP G(t; f) (t* = G(t*, f)):
    w = dE/dt + (dG/dt)^T w        (fixed-point iteration with DIIS)
    gamma = dE/df + (dG/df)^T w + HF diagonal
The map, not the residual: the residual's Jacobian is singular, because the
t2 antisymmetry makes its constraint rows redundant.  (dG/dt)^T is linear
in w, so the map is evaluated once with its autograd graph and the graph is
applied every iteration.  E_T is a sum over pairs whose gradient is needed
once, so it is taken pair by pair (`energy_t_grad`): no pair's slabs outlive
their own backward.  Every ladder product of the map is a launch of the
hand-written GEMM kernel, forward and backward (kernels/ladder_mm.py).
"""

from __future__ import annotations

import torch

from ecw_cc_torch.ops import ccsd as ccsd_ops
from ecw_cc_torch.ops import diis as diis_ops
from ecw_cc_torch.ops import ladder
from ecw_cc_torch.ops import spinsect as ss
from ecw_cc_torch.parallel import sharding
from ecw_cc_torch.utils.metrics import StageClock

einsum = torch.einsum


def _p_i_jk(x):
    """P(i/jk) f(i,j,k,...) = f - f(i<->j) - f(i<->k) on the first 3 axes."""
    return x - x.transpose(0, 1) - x.transpose(0, 2)


def _p_a_bc(x):
    """P(a/bc) on axes 3,4,5."""
    return x - x.transpose(3, 4) - x.transpose(3, 5)


def _fock_diag(eris, fsp, nocc):
    d = torch.diagonal(eris.fock if fsp is None else fsp)
    return d[:nocc], d[nocc:]


def _t3_pieces(eris, t1, t2, fsp):
    nocc = t1.shape[0]
    fo, fv = _fock_diag(eris, fsp, nocc)
    D = (fo[:, None, None, None, None, None] + fo[None, :, None, None, None, None]
         + fo[None, None, :, None, None, None] - fv[None, None, None, :, None, None]
         - fv[None, None, None, None, :, None] - fv[None, None, None, None, None, :])
    # connected: W_ijkabc = P(i/jk)P(a/bc)[ t2_jkae <ei||bc> - t2_imbc <ma||jk> ]
    w = einsum("jkae,eibc->ijkabc", t2, eris.vovv)
    w = w - einsum("imbc,majk->ijkabc", t2, eris.ovoo)
    w = _p_a_bc(_p_i_jk(w))
    t3c = w / D
    # disconnected: t1_ia <jk||bc>
    v = einsum("ia,jkbc->ijkabc", t1, eris.oovv)
    v = _p_a_bc(_p_i_jk(v))
    t3d = v / D
    return t3c, t3d, D, w


def _energy_t_dense(eris, t1, t2, fsp=None):
    """(T) with the full t3 materialized: O(o^3 v^3) memory; the oracle for
    the pair loops on tiny systems."""
    t3c, t3d, D, w = _t3_pieces(eris, t1, t2, fsp)
    return einsum("ijkabc,ijkabc->", w, t3c + t3d) / 36.0


def _pabc(x):
    """P(a/bc) on axes 1,2,3 of (k,a,b,c)."""
    return x - x.transpose(1, 2) - x.transpose(1, 3)


def _dense_pairs(eris, t1, t2, fo, fv):
    """The (T) energy terms of the occupied pairs (I, J), one scalar each,
    in the order I * nocc + J.  A generator: a consumer that drops (or
    back-propagates) each term before it asks for the next holds one pair's
    (o, v, v, v) slabs at a time."""
    nocc = t1.shape[0]
    vovv, ovoo, oovv = eris.vovv, eris.ovoo, eris.oovv
    Dk = (fo[:, None, None, None]
          - fv[None, :, None, None] - fv[None, None, :, None]
          - fv[None, None, None, :])
    for I in range(nocc):
        for J in range(nocc):
            t2I, t2J = t2[I], t2[J]                    # (o, v, v)
            vovvI, vovvJ = vovv[:, I], vovv[:, J]      # (v, v, v) = (e, b, c)
            ovooJ, ovooI = ovoo[:, :, J], ovoo[:, :, I]   # (o, v, o) = (m, a, k)
            # P(i/jk) W0 evaluated at (I, J, k), per (k,a,b,c):
            #   W0[i,j,k] = t2[j,k,a,e] <ei||bc> - t2[i,m,b,c] <ma||jk>
            A = (einsum("kae,ebc->kabc", t2J, vovvI)
                 - einsum("mbc,mak->kabc", t2I, ovooJ))
            B = (einsum("kae,ebc->kabc", t2I, vovvJ)
                 - einsum("mbc,mak->kabc", t2J, ovooI))
            C = (einsum("ae,ekbc->kabc", t2J[I], vovv)
                 - einsum("kmbc,ma->kabc", t2, ovoo[:, :, J, I]))
            w = _pabc(A - B - C)
            # P(i/jk) [t1_ia <jk||bc>] at (I, J, k)
            v0 = (einsum("a,kbc->kabc", t1[I], oovv[J])
                  - einsum("a,kbc->kabc", t1[J], oovv[I])
                  - einsum("ka,bc->kabc", t1, oovv[J, I]))
            v = _pabc(v0)
            D = fo[I] + fo[J] + Dk
            yield torch.sum(w * (w + v) / D)


def _sect_pairs(eris, t1, t2, fo, fv, info, sI, sJ, slab_dtype=None,
                mesh=None):
    """The (T) energy terms of the pairs (I, J) with I in occupied spin
    sector sI and J in sector sJ (sorted layout), one scalar each.  With the
    pair spins fixed, every slab contraction decomposes over the compatible
    spin sectors only (spinsect.sector_einsum with sliced_support): the
    structurally-zero blocks of the per-pair t3 slab are never formed.

    slab_dtype: the five big operands are cast to it once; the energy
    denominators and the accumulation stay at fo.dtype.

    mesh: a DeviceMesh: this rank takes only its share of the pairs, the
    pair list (I * nJ + J order) cut into mesh.size() even chunks, the
    last ones short (JAX ccsd_t.py:192-196); the caller sums over the
    ranks."""
    nI = info.oa if sI == 0 else info.ob
    nJ = info.oa if sJ == 0 else info.ob
    baseI = 0 if sI == 0 else info.oa
    baseJ = 0 if sJ == 0 else info.oa
    vovv, ovoo, oovv = eris.vovv, eris.ovoo, eris.oovv
    if slab_dtype is not None:
        t2, t1, vovv, ovoo, oovv = (x.to(slab_dtype)
                                    for x in (t2, t1, vovv, ovoo, oovv))
    fo_s = {0: fo[:info.oa], 1: fo[info.oa:]}
    fv_s = {0: fv[:info.va], 1: fv[info.va:]}
    # loop-invariant views of the full tensors
    t2_b = ss.wrap(t2, "oovv", info)
    t1_b = ss.wrap(t1, "ov", info)
    vovv_b = ss.wrap(vovv, "vovv", info)

    def blk(arr, kinds_full, fixed):
        kinds, sup = ss.sliced_support(kinds_full, fixed)
        return ss.SpinBlocked.from_dense(arr, kinds, info, support=sup)

    def pabc(x):  # P(a/bc) on blocked (k,a,b,c)
        return (x + x.transpose(0, 2, 1, 3).scale(-1.0)
                + x.transpose(0, 3, 2, 1).scale(-1.0))

    S = ss.sector_einsum
    ids = range(nI * nJ)
    if mesh is not None:
        per = -(-len(ids) // mesh.size())
        r = sharding.mesh_rank(mesh)
        ids = ids[r * per:(r + 1) * per]
    for ij in ids:
        I, J = baseI + ij // nJ, baseJ + ij % nJ
        t2I = blk(t2[I], "oovv", {0: sI})
        t2J = blk(t2[J], "oovv", {0: sJ})
        vovvI = blk(vovv[:, I], "vovv", {1: sI})
        vovvJ = blk(vovv[:, J], "vovv", {1: sJ})
        ovooJ = blk(ovoo[:, :, J], "ovoo", {2: sJ})
        ovooI = blk(ovoo[:, :, I], "ovoo", {2: sI})
        t2JI = blk(t2[J, I], "oovv", {0: sJ, 1: sI})
        ovooJI = blk(ovoo[:, :, J, I], "ovoo", {2: sJ, 3: sI})
        t1I = blk(t1[I], "ov", {0: sI})
        t1J = blk(t1[J], "ov", {0: sJ})
        oovvI = blk(oovv[I], "oovv", {0: sI})
        oovvJ = blk(oovv[J], "oovv", {0: sJ})
        oovvJI = blk(oovv[J, I], "oovv", {0: sJ, 1: sI})
        # P(i/jk) W0 at (I, J, k): the terms of the dense body
        A = (S("kae,ebc->kabc", t2J, vovvI)
             + S("mbc,mak->kabc", t2I, ovooJ).scale(-1.0))
        B = (S("kae,ebc->kabc", t2I, vovvJ)
             + S("mbc,mak->kabc", t2J, ovooI).scale(-1.0))
        C = (S("ae,ekbc->kabc", t2JI, vovv_b)
             + S("kmbc,ma->kabc", t2_b, ovooJI).scale(-1.0))
        w = pabc(A + B.scale(-1.0) + C.scale(-1.0))
        v0 = (S("a,kbc->kabc", t1I, oovvJ)
              + S("a,kbc->kabc", t1J, oovvI).scale(-1.0)
              + S("ka,bc->kabc", t1_b, oovvJI).scale(-1.0))
        v = pabc(v0)
        foIJ = fo[I] + fo[J]
        e = torch.zeros((), dtype=fo.dtype, device=fo.device)
        for key, wblk in w.blocks.items():
            sk, sa, sb, sc = key
            D = (foIJ + fo_s[sk][:, None, None, None]
                 - fv_s[sa][None, :, None, None]
                 - fv_s[sb][None, None, :, None]
                 - fv_s[sc][None, None, None, :])
            vblk = v.get(key)
            tot = wblk if vblk is None else wblk + vblk
            # the products are promoted to fo.dtype before the
            # reduction, also when the slabs are stored reduced
            e = e + torch.sum(wblk.to(fo.dtype) * tot.to(fo.dtype) / D)
        yield e


def _t_terms(eris, t1, t2, fo, fv, sect=None, slab_dtype=None, mesh=None):
    """(terms, factor): the generator of per-pair energy terms of the route
    and the factor that turns their sum into E_T.  With sect=(info, True)
    the inputs must already be mirror-averaged (_mirror_average)."""
    if sect is None:
        if slab_dtype is not None:
            raise ValueError("slab_dtype requires the sector-blocked route "
                             "(pass sect=(SectorInfo, sym))")
        return _dense_pairs(eris, t1, t2, fo, fv), 1.0 / 36.0
    info, sym = sect
    if isinstance(slab_dtype, str):
        slab_dtype = getattr(torch, slab_dtype)
    pairs = ((0, 0), (0, 1)) if sym else ((0, 0), (0, 1), (1, 0), (1, 1))

    def terms():
        for sI, sJ in pairs:
            yield from _sect_pairs(eris, t1, t2, fo, fv, info, sI, sJ,
                                   slab_dtype=slab_dtype, mesh=mesh)

    return terms(), (2.0 if sym else 1.0) / 36.0


def _mirror_average(t1, t2, fo, fv, info):
    """(x + Mx)/2 of each input, M the global spin mirror: the identity on
    mirror-symmetric inputs."""
    avg = lambda x, kinds: 0.5 * (x + ss.mirror_dense(x, kinds, info))
    return avg(t1, "ov"), avg(t2, "oovv"), avg(fo, "o"), avg(fv, "v")


def energy_t_sect(eris, t1, t2, info, fsp=None, sym=False, mesh=None,
                  slab_dtype=None):
    """(T) energy with spin-sector blocking (SORTED layout; exact).

    The per-pair structure of energy_t, with one loop per occupied
    spin-sector pair (sI, sJ), so that the body's contractions skip every
    structurally-zero spin block.  sym=True (closed-shell mirror symmetry,
    spin-restricted eris; gate: eris_spin_restricted) also skips the
    (beta, *) loops and doubles the (alpha, alpha) + (alpha, beta) energies.

    VALIDITY: eris in the spin-sorted layout with the standard balanced
    support, amplitudes from a spin-conserving solve.

    GRADIENT under sym: E_sym = 2(E00 + E01) has the right VALUE at a
    mirror-symmetric point but a FOLDED gradient (2 grad(E00 + E01) instead
    of the true (1 + M) grad(E00 + E01), M the global spin mirror).  The
    inputs are therefore mirror-AVERAGED first ((x + Mx)/2, the identity on
    symmetric inputs): the chain rule then emits exactly (1 + M)/2 of the
    folded gradient, the true one, so that the response density can
    differentiate straight through.

    mesh: a DeviceMesh (parallel/mesh.py): the pairs are split evenly over
    all its ranks (they are independent: the operands stay replicated,
    each rank runs its share), and the energy is one all-reduce of the
    ranks' sums.  Sharded operands are gathered first."""
    if mesh is not None:
        eris = sharding.local_eris(eris)
        t1, t2, fsp = (sharding.replicate(x) for x in (t1, t2, fsp))
    fo, fv = _fock_diag(eris, fsp, info.nocc)
    if sym:
        t1, t2, fo, fv = _mirror_average(t1, t2, fo, fv, info)
    terms, factor = _t_terms(eris, t1, t2, fo, fv, sect=(info, sym),
                             slab_dtype=slab_dtype, mesh=mesh)
    e = factor * sum(terms, torch.zeros((), dtype=fo.dtype,
                                        device=fo.device))
    return e if mesh is None else sharding.all_reduce_sum(e, mesh)


def energy_t(eris, t1, t2, fsp=None, sect=None, mesh=None, slab_dtype=None):
    """The (T) energy correction, pair by pair over the occupied (I, J).

    sect: optional (SectorInfo, sym): the spin-sector-blocked loops
    (energy_t_sect; the sorted layout).

    The full t3 tensor is O(o^3 v^3), so the permutation operators are
    expanded per (I, J) slab: each step holds only (o, v, v, v) work
    arrays.  Differentiable as it stands on small systems; the response
    density of a large one takes the gradient pair by pair
    (energy_t_grad), since this sum's graph keeps every pair's slabs."""
    if sect is not None:
        info, sym = sect
        return energy_t_sect(eris, t1, t2, info, fsp=fsp, sym=sym, mesh=mesh,
                             slab_dtype=slab_dtype)
    if mesh is not None:
        raise ValueError("energy_t(mesh=...) requires sect: the sharded "
                         "pair loops are implemented on the sector-blocked "
                         "route only (pass sect=(SectorInfo, sym))")
    fo, fv = _fock_diag(eris, fsp, t1.shape[0])
    terms, factor = _t_terms(eris, t1, t2, fo, fv, slab_dtype=slab_dtype)
    return factor * sum(terms, torch.zeros((), dtype=t1.dtype,
                                           device=t1.device))


def energy_t_grad(eris, t1, t2, fsp=None, sect=None):
    """(E_T, dE_T/dt1, dE_T/dt2, dE_T/dfo, dE_T/dfv), fo and fv the occupied
    and virtual diagonal of the one-body matrix (the only way it enters).

    The gradient of each pair's term is taken as soon as the term exists and
    accumulated, so one pair's slabs and graph are alive at a time: a graph
    over all pairs does not fit at production sizes (C2H2/cc-pVTZ: 196
    pairs of 14 x 162^3 slabs)."""
    nocc = t1.shape[0]
    fo, fv = _fock_diag(eris, fsp, nocc)
    sym = sect is not None and sect[1]
    leaves = [x.detach() for x in (t1, t2, fo, fv)]
    if sym:
        leaves = list(_mirror_average(*leaves, sect[0]))
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    grads = [torch.zeros_like(x) for x in leaves]
    e_t = torch.zeros((), dtype=fo.dtype, device=fo.device)
    with torch.enable_grad():
        terms, factor = _t_terms(eris, *leaves, sect=sect)
        for e in terms:
            for acc, g in zip(grads, torch.autograd.grad(e, leaves,
                                                         allow_unused=True)):
                if g is not None:
                    acc += g
            e_t += e.detach()
    grads = [factor * g for g in grads]
    if sym:
        # the chain rule through the averaging of the inputs
        grads = list(_mirror_average(*grads, sect[0]))
    return (factor * e_t, *grads)


def eris_spin_restricted(eris, info, vvvv_op=None):
    """Closed-shell mirror-symmetry gate for target-generation (T): equal
    alpha/beta sector sizes and every ERI block + the Fock diagonal
    numerically flip-symmetric (an RHF-derived GHF passes at machine
    epsilon).  Once per build (one device read); no Vexp on this path.

    vvvv_op: the ladder operand the sym solves consume: when eris were
    built pack-on-build (vvvv is a size-0 placeholder), its sectored
    alpha-alpha and beta-beta packs are compared directly, as the solver's
    gate does (Solver_CCSD._spin_restricted): a transform error
    concentrated in the v^4 block must veto sym."""
    if info.oa != info.ob or info.va != info.vb:
        return False
    dt, dev = eris.oovv.dtype, eris.oovv.device
    eps = float(torch.finfo(dt).eps)
    d = torch.diagonal(eris.fock)
    no, va = info.nocc, info.va
    worst = [(d[:info.oa] - d[info.oa:no]).abs().max(),
             (d[no:no + va] - d[no + va:]).abs().max()]
    scale = [torch.ones((), dtype=dt, device=dev), d.abs().max()]
    blocks = [(getattr(eris, name), name) for name in
              ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovvv", "ovoo",
               "vovv", "vvvv")]
    for blk, name in blocks:
        if blk.numel() == 0:
            continue
        worst.append(ss.spin_flip_asymmetry(blk, name, info))
        scale.append(blk.abs().max())
    if eris.vvvv.numel() == 0 and isinstance(vvvv_op, ladder.SectoredVVVV):
        if vvvv_op.wc_aa.shape != vvvv_op.wc_bb.shape:
            return False
        worst.append((vvvv_op.wc_aa - vvvv_op.wc_bb).abs().max())
        scale.append(vvvv_op.wc_aa.abs().max())
    worst_v, scale_v = torch.stack(
        [torch.stack(worst).max(), torch.stack(scale).max()]).tolist()
    return worst_v <= 1e3 * eps * scale_v


def _update_map(eris, t1, t2, f, vvvv_op=None, sect=None):
    """The SCF update map G(t; f) of the amplitudes, t* = G(t*, f).

    vvvv_op: optional non-dense ladder operand (pack-on-build ERIs).  Safe
    under the adjoint solve: the packed map agrees with the dense one on
    antisymmetric t2 and both maps' t2 outputs are antisymmetric by
    construction, so they share the fixed-point branch t*(f) and the
    implicit gradient is identical.

    sect: optional (SectorInfo, sym): the SECTOR-BLOCKED map
    (ccsd_sect.tupdate_sect, sorted layout).  Exact for the implicit
    gradient: at a balanced amplitude point the dense Jacobian's
    (balanced-out, off-balance-in) blocks vanish by spin conservation, so
    the balanced-subspace adjoint iterates never couple to what the
    sectored map drops.  The map always runs sym=False: sym folds
    derivatives, and is valid for values only."""
    if sect is not None:
        from ecw_cc_torch.ops.ccsd_sect import tupdate_sect

        return tupdate_sect(eris, t1, t2, f, sect[0], vvvv_op=vvvv_op)
    return ccsd_ops.tupdate(eris, t1, t2, fsp=f, vvvv_op=vvvv_op)


def _default_tol(tol, dtype, f64, f32):
    if tol is not None:
        return tol
    return f64 if dtype == torch.float64 else f32


def ccsd_t_rdm1_response(eris, t1, t2, fsp=None, with_t=True, tol=None,
                         maxiter=300, vvvv_op=None, sect=None, log=None):
    """Unrelaxed response density of E_CCSD(+T) in the MO G basis (with the
    HF diagonal added), via adjoint implicit differentiation of the SCF
    fixed-point map:
        (I - dG/dt)^T w = dE/dt   (fixed-point iteration + DIIS)
        gamma = dE/df + w^T dG/df

    sect: optional (SectorInfo, sym) routing the map and the (T) energy
    through the sector-blocked kernels (sorted layout).  EXACT for the
    gradient too: the sectored E only drops t-derivative components on
    structurally-zero (off-balance) blocks, and those components of the
    true dE/dt vanish at a balanced amplitude point by spin conservation;
    the f-derivative of (T) enters only through diag(f), which sectoring
    never touches.

    tol: on ||w_new - w||; None is 1e-10 at f64 (the JAX package's value)
    and 1e-5 at f32, whose rounding floors the norm near 1e-6.
    log: a dict that receives 'iterations', 'converged' and the host
    seconds of the three parts ('energy_grad_s', 'map_s', 'iterations_s';
    the device is synchronized before each reading), or None."""
    clock = StageClock(t1.device, log)
    nocc, nvir = t1.shape
    dim = nocc + nvir
    tol = _default_tol(tol, t1.dtype, 1e-10, 1e-5)
    f0 = (eris.fock if fsp is None else fsp).detach()
    if sect is not None:
        vvvv_op = ladder.ensure_sorted_vvvv_op(vvvv_op, eris, sect[0])
    t1g, t2g, fg = (x.detach().clone().requires_grad_(True)
                    for x in (t1, t2, f0))
    n1 = nocc * nvir
    flat = lambda a, b: torch.cat([a.reshape(-1), b.reshape(-1)])

    # dE/dt and dE/df of E = E_CCSD (+ E_T)
    with torch.enable_grad():
        e_cc = ccsd_ops.energy(eris, t1g, t2g, fg)
        g1, g2, dE_df = torch.autograd.grad(e_cc, (t1g, t2g, fg))
    if with_t:
        _, h1, h2, hfo, hfv = energy_t_grad(eris, t1g, t2g, fg, sect=sect)
        g1, g2 = g1 + h1, g2 + h2
        # f enters (T) through its diagonal only
        dE_df = dE_df + torch.diag(torch.cat([hfo, hfv]))
    dE_dt = flat(g1, g2)
    clock.done("energy_grad_s")

    # the map, evaluated once; its graph serves every product below
    with torch.enable_grad():
        G = _update_map(eris, t1g, t2g, fg, vvvv_op=vvvv_op, sect=sect)

    clock.done("map_s")

    def vjp(w, wrt):
        cot = (w[:n1].reshape(nocc, nvir),
               w[n1:].reshape(nocc, nocc, nvir, nvir))
        return torch.autograd.grad(G, wrt, cot, retain_graph=True)

    # w = dE/dt + (dG/dt)^T w: the contraction structure of the Lambda
    # equations; one scalar read per iteration
    w = dE_dt
    dstate = diis_ops.diis_init(w.numel(), space=10, dtype=w.dtype,
                                device=w.device)
    converged = False
    k = 0
    for k in range(1, maxiter + 1):
        w_new = dE_dt + flat(*vjp(w, (t1g, t2g)))
        nrm = torch.linalg.norm(w_new - w)
        dstate, w_d = diis_ops.diis_update(dstate, w_new, 2)
        if float(nrm) < tol:
            w, converged = w_new, True
            break
        w = w_d
    gamma = dE_df + vjp(w, (fg,))[0]
    clock.done("iterations_s")
    if log is not None:
        log.update(iterations=k, converged=converged)

    hf = torch.diag(torch.cat([torch.ones(nocc, dtype=gamma.dtype,
                                          device=gamma.device),
                               torch.zeros(nvir, dtype=gamma.dtype,
                                           device=gamma.device)]))
    return gamma + hf


def _ccsd_diis_step(eris, vvvv_op, t1, t2, dstate, sect=None):
    """Jacobi step + DIIS; the energy is that of the un-extrapolated
    update.  sect: optional (SectorInfo, sym): the sector-blocked update
    (sorted layout).  A pure value iteration, so the sym (mirror-halved)
    kernels are usable directly."""
    if sect is not None:
        from ecw_cc_torch.ops.ccsd_sect import tupdate_sect

        t1n, t2n = tupdate_sect(eris, t1, t2, eris.fock, sect[0],
                                vvvv_op=vvvv_op, sym=sect[1])
    else:
        t1n, t2n = ccsd_ops.tupdate(eris, t1, t2, None, vvvv_op=vvvv_op)
    e_cc = ccsd_ops.energy(eris, t1n, t2n, None)
    nocc, nvir = t1n.shape
    n1 = nocc * nvir
    dstate, vec = diis_ops.diis_update(
        dstate, torch.cat([t1n.reshape(-1), t2n.reshape(-1)]), 2)
    return (vec[:n1].reshape(nocc, nvir),
            vec[n1:].reshape(nocc, nocc, nvir, nvir), dstate, e_cc)


def solve_ccsd(eris, conv_tol=None, max_cycle=200, vvvv_op=None, sect=None,
               log=None):
    """Plain CCSD amplitudes (MP2 start, Jacobi iterations with DIIS of
    space 8): (t1, t2, e_cc).  Converged when |dE| < conv_tol; one scalar
    read per iteration.

    vvvv_op: prebuilt ladder operand (pack-on-build ERIs); default derives
    one from eris.vvvv per config.ladder_mode.
    sect: optional (SectorInfo, sym): sector-blocked updates (sorted
    layout; needs a non-dense vvvv_op or a dense sorted eris.vvvv).
    conv_tol: None is 1e-10 at f64 (the JAX package's value) and 1e-7 at
    f32, about what an f32 energy of 0.1-1 Ha resolves.
    log: a dict that receives 'iterations' and 'converged', or None."""
    nocc, nvir = eris.nocc, eris.nvir
    fock = eris.fock
    conv_tol = _default_tol(conv_tol, fock.dtype, 1e-10, 1e-7)
    if sect is not None:
        vvvv_op = ladder.ensure_sorted_vvvv_op(vvvv_op, eris, sect[0])
    elif vvvv_op is None:
        vvvv_op = ladder.make_vvvv_op(eris.vvvv)
    with torch.no_grad():
        e = torch.diagonal(fock)
        eia = e[:nocc, None] - e[None, nocc:]
        eijab = eia[:, None, :, None] + eia[None, :, None, :]
        t1 = torch.zeros((nocc, nvir), dtype=fock.dtype, device=fock.device)
        t2 = eris.oovv / eijab
        dstate = diis_ops.diis_init(nocc * nvir + (nocc * nvir) ** 2, space=8,
                                    dtype=t1.dtype, device=t1.device)
        e_old = e_cc = 0.0
        converged = False
        k = 0
        for k in range(1, max_cycle + 1):
            t1, t2, dstate, e_dev = _ccsd_diis_step(eris, vvvv_op, t1, t2,
                                                    dstate, sect=sect)
            e_cc = float(e_dev)
            if abs(e_cc - e_old) < conv_tol:
                converged = True
                break
            e_old = e_cc
    if log is not None:
        log.update(iterations=k, converged=converged)
    return t1, t2, e_cc
