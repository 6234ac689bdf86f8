"""CCSD(T): plain CCSD solve, perturbative triples energy and response
density (port of ecw_cc_tpu/ops/ccsd_t.py; replaces the reference's use of
pyscf ccsd_t_lambda_slow / ccsd_t_rdm_slow, gamma_exp.py:228-248).

Energy: the spin-orbital (T) correction
    D_ijkabc = f_ii + f_jj + f_kk - f_aa - f_bb - f_cc
    t3c = P(i/jk) P(a/bc) [ t2_jkae <ei||bc> - t2_imbc <ma||jk> ] / D
    t3d = P(i/jk) P(a/bc) [ t1_ia <jk||bc> ] / D
    E_T = 1/36 sum t3c * D * (t3c + t3d)
evaluated pair by pair: a device_loop.scan over the occupied pairs (I, J),
the pair a device index, whose body holds only (o, v, v, v) slabs
(`energy_t`; JAX's lax.scan), or one such scan per occupied spin-sector
pair on the sorted layout, with every slab contraction restricted to its
nonzero spin blocks (`energy_t_sect`).  `_energy_t_dense` materializes the
full t3 and is the oracle for both on tiny systems.

Density: the unrelaxed response density gamma_pq = dE_CCSD(T)/df_pq by the
implicit-function theorem on the SCF update MAP G(t; f) (t* = G(t*, f)):
    w = dE/dt + (dG/dt)^T w        (fixed-point iteration with DIIS)
    gamma = dE/df + (dG/df)^T w + HF diagonal
The map, not the residual: the residual's Jacobian is singular, because the
t2 antisymmetry makes its constraint rows redundant.  (dG/dt)^T is linear
in w, so the map is evaluated once with its autograd graph and the graph is
applied every iteration.  E_T is a sum over pairs whose gradient is needed
once, so it is taken pair by pair in a scan (`energy_t_grad`): no pair's
slabs outlive their own backward.  Every ladder product of the map is a
launch of the hand-written GEMM kernel, forward and backward (kernels/
ladder_mm.py).  The CCSD solve and the adjoint iterations are
device_loop.Loops: on the card, like the scans, captured once and replayed.
"""

from __future__ import annotations

import torch

from ecw_cc_torch.ops import ccsd as ccsd_ops
from ecw_cc_torch.ops import diis as diis_ops
from ecw_cc_torch.ops import ladder
from ecw_cc_torch.ops import spinsect as ss
from ecw_cc_torch.parallel import sharding
from ecw_cc_torch.solvers import device_loop
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
    the pair scans on tiny systems."""
    t3c, t3d, D, w = _t3_pieces(eris, t1, t2, fsp)
    return einsum("ijkabc,ijkabc->", w, t3c + t3d) / 36.0


def _pabc(x):
    """P(a/bc) on axes 1,2,3 of (k,a,b,c)."""
    return x - x.transpose(1, 2) - x.transpose(1, 3)


def _take(x, dim, idx):
    """x[..., idx, ...] at axis dim for a 1-element index tensor: a
    gather by a device index, no host read."""
    return x.index_select(dim, idx).squeeze(dim)


def _dense_term(eris, t1, t2, fo, fv):
    """term(ij): the (T) energy term of the occupied pair (I, J) = (ij //
    nocc, ij % nocc), ij a 0-d int64 device tensor (JAX ccsd_t.py:338-364,
    the dense route's scan body).  One pair's (o, v, v, v) slabs live
    while a term is evaluated."""
    nocc = t1.shape[0]
    vovv, ovoo, oovv = eris.vovv, eris.ovoo, eris.oovv

    def term(ij):
        I, J = (ij // nocc).reshape(1), (ij % nocc).reshape(1)
        t2I, t2J = _take(t2, 0, I), _take(t2, 0, J)        # (o, v, v)
        vovvI, vovvJ = _take(vovv, 1, I), _take(vovv, 1, J)  # (e, b, c)
        ovooJ, ovooI = _take(ovoo, 2, J), _take(ovoo, 2, I)  # (m, a, k)
        # P(i/jk) W0 evaluated at (I, J, k), per (k,a,b,c):
        #   W0[i,j,k] = t2[j,k,a,e] <ei||bc> - t2[i,m,b,c] <ma||jk>
        A = (einsum("kae,ebc->kabc", t2J, vovvI)
             - einsum("mbc,mak->kabc", t2I, ovooJ))
        B = (einsum("kae,ebc->kabc", t2I, vovvJ)
             - einsum("mbc,mak->kabc", t2J, ovooI))
        C = (einsum("ae,ekbc->kabc", _take(t2J, 0, I), vovv)
             - einsum("kmbc,ma->kabc", t2, _take(ovooJ, 2, I)))
        w = _pabc(A - B - C)
        # P(i/jk) [t1_ia <jk||bc>] at (I, J, k)
        oovvJ = _take(oovv, 0, J)
        v0 = (einsum("a,kbc->kabc", _take(t1, 0, I), oovvJ)
              - einsum("a,kbc->kabc", _take(t1, 0, J), _take(oovv, 0, I))
              - einsum("ka,bc->kabc", t1, _take(oovvJ, 0, I)))
        v = _pabc(v0)
        D = (_take(fo, 0, I) + _take(fo, 0, J)
             + fo[:, None, None, None] - fv[None, :, None, None]
             - fv[None, None, :, None] - fv[None, None, None, :])
        return torch.sum(w * (w + v) / D)

    return term


def _sect_term(ops, fo, fv, info, sI, sJ):
    """term(ij): the (T) energy term of the pair (I, J) = (baseI + ij //
    nJ, baseJ + ij % nJ), I in occupied spin sector sI and J in sJ (sorted
    layout), ij a 0-d int64 device tensor (JAX _sect_scan_t's body,
    ccsd_t.py:119-169).  With the pair spins static, every slab
    contraction decomposes over the compatible spin sectors only
    (spinsect.sector_einsum with sliced_support): the structurally-zero
    blocks of the pair's t3 slab are never formed.  ops: (t2, t1, vovv,
    ovoo, oovv), maybe stored reduced; the energy denominators and the
    sum stay at fo.dtype."""
    t2, t1, vovv, ovoo, oovv = ops
    nJ = info.oa if sJ == 0 else info.ob
    baseI = 0 if sI == 0 else info.oa
    baseJ = 0 if sJ == 0 else info.oa

    def blk(arr, kinds_full, fixed):
        kinds, sup = ss.sliced_support(kinds_full, fixed)
        return ss.SpinBlocked.from_dense(arr, kinds, info, support=sup)

    def pabc(x):  # P(a/bc) on blocked (k,a,b,c)
        return (x + x.transpose(0, 2, 1, 3).scale(-1.0)
                + x.transpose(0, 3, 2, 1).scale(-1.0))

    S = ss.sector_einsum

    def term(ij):
        I = (baseI + ij // nJ).reshape(1)
        J = (baseJ + ij % nJ).reshape(1)
        # views of the full tensors, made in the body, where the
        # gradient's step records them (a capture makes them once)
        fo_s = {0: fo[:info.oa], 1: fo[info.oa:]}
        fv_s = {0: fv[:info.va], 1: fv[info.va:]}
        t2_b = ss.wrap(t2, "oovv", info)
        t1_b = ss.wrap(t1, "ov", info)
        vovv_b = ss.wrap(vovv, "vovv", info)
        t2I, t2J = _take(t2, 0, I), _take(t2, 0, J)
        ovooJ = _take(ovoo, 2, J)
        oovvJ = _take(oovv, 0, J)
        t2I_b = blk(t2I, "oovv", {0: sI})
        t2J_b = blk(t2J, "oovv", {0: sJ})
        vovvI = blk(_take(vovv, 1, I), "vovv", {1: sI})
        vovvJ = blk(_take(vovv, 1, J), "vovv", {1: sJ})
        ovooJ_b = blk(ovooJ, "ovoo", {2: sJ})
        ovooI = blk(_take(ovoo, 2, I), "ovoo", {2: sI})
        t2JI = blk(_take(t2J, 0, I), "oovv", {0: sJ, 1: sI})
        ovooJI = blk(_take(ovooJ, 2, I), "ovoo", {2: sJ, 3: sI})
        t1I = blk(_take(t1, 0, I), "ov", {0: sI})
        t1J = blk(_take(t1, 0, J), "ov", {0: sJ})
        oovvI = blk(_take(oovv, 0, I), "oovv", {0: sI})
        oovvJ_b = blk(oovvJ, "oovv", {0: sJ})
        oovvJI = blk(_take(oovvJ, 0, I), "oovv", {0: sJ, 1: sI})
        # P(i/jk) W0 at (I, J, k): the terms of the dense body
        A = (S("kae,ebc->kabc", t2J_b, vovvI)
             + S("mbc,mak->kabc", t2I_b, ovooJ_b).scale(-1.0))
        B = (S("kae,ebc->kabc", t2I_b, vovvJ)
             + S("mbc,mak->kabc", t2J_b, ovooI).scale(-1.0))
        C = (S("ae,ekbc->kabc", t2JI, vovv_b)
             + S("kmbc,ma->kabc", t2_b, ovooJI).scale(-1.0))
        w = pabc(A + B.scale(-1.0) + C.scale(-1.0))
        v0 = (S("a,kbc->kabc", t1I, oovvJ_b)
              + S("a,kbc->kabc", t1J, oovvI).scale(-1.0)
              + S("ka,bc->kabc", t1_b, oovvJI).scale(-1.0))
        v = pabc(v0)
        foIJ = _take(fo, 0, I) + _take(fo, 0, J)
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
        return e

    return term


def _pair_scans(eris, t1, t2, fo, fv, sect=None, slab_dtype=None, mesh=None):
    """([(term, first pair id, pairs)] of the route, one per occupied
    spin-sector pair in the order their energies are summed, and the
    factor that turns the sum of the terms into E_T).  With sect=(info,
    True) the inputs must already be mirror-averaged (_mirror_average).

    slab_dtype: the five big operands are cast to it once; the energy
    denominators and the accumulation stay at fo.dtype.  mesh: a
    DeviceMesh: this rank takes only its share of each sector pair's
    pairs, the id list (I * nJ + J order) cut into mesh.size() even
    chunks, the last ones short or empty (JAX ccsd_t.py:192-196); the
    caller sums over the ranks."""
    if sect is None:
        if slab_dtype is not None:
            raise ValueError("slab_dtype requires the sector-blocked route "
                             "(pass sect=(SectorInfo, sym))")
        nocc = t1.shape[0]
        return [(_dense_term(eris, t1, t2, fo, fv), 0, nocc * nocc)], \
            1.0 / 36.0
    info, sym = sect
    if isinstance(slab_dtype, str):
        slab_dtype = getattr(torch, slab_dtype)
    ops = (t2, t1, eris.vovv, eris.ovoo, eris.oovv)
    if slab_dtype is not None:
        ops = tuple(x.to(slab_dtype) for x in ops)
    scans = []
    for sI, sJ in ((0, 0), (0, 1)) if sym else ((0, 0), (0, 1), (1, 0),
                                                  (1, 1)):
        nI = info.oa if sI == 0 else info.ob
        nJ = info.oa if sJ == 0 else info.ob
        ids = range(nI * nJ)
        if mesh is not None:
            per = -(-len(ids) // mesh.size())
            r = sharding.mesh_rank(mesh)
            ids = ids[r * per:(r + 1) * per]
        scans.append((_sect_term(ops, fo, fv, info, sI, sJ), ids.start,
                      len(ids)))
    return scans, (2.0 if sym else 1.0) / 36.0


def _ij(first, device):
    return torch.full((), first, dtype=torch.int64, device=device)


def _energy_step(term):
    """The scan body of the (T) energy: (ij, acc) -> (ij + 1, acc +
    term(ij))."""
    def step(state):
        ij, acc = state
        return ij + 1, acc + term(ij)

    return step


def _scan_energy(scans, dtype, device, log=None):
    """The sum of every scan's terms: one device_loop.scan per sector
    pair, each pair's term added in id order, the scans' sums in order."""
    total = torch.zeros((), dtype=dtype, device=device)
    logs = [] if log is None else log.setdefault("scans", [])
    for term, first, n in scans:
        logs.append({})
        _, acc = device_loop.scan(
            _energy_step(term),
            (_ij(first, device), torch.zeros((), dtype=dtype,
                                             device=device)), n, logs[-1])
        total = total + acc
    return total


def _mirror_average(t1, t2, fo, fv, info):
    """(x + Mx)/2 of each input, M the global spin mirror: the identity on
    mirror-symmetric inputs."""
    avg = lambda x, kinds: 0.5 * (x + ss.mirror_dense(x, kinds, info))
    return avg(t1, "ov"), avg(t2, "oovv"), avg(fo, "o"), avg(fv, "v")


def energy_t_sect(eris, t1, t2, info, fsp=None, sym=False, mesh=None,
                  slab_dtype=None, log=None):
    """(T) energy with spin-sector blocking (SORTED layout; exact).

    The per-pair structure of energy_t, with one scan per occupied
    spin-sector pair (sI, sJ), so that the body's contractions skip every
    structurally-zero spin block.  sym=True (closed-shell mirror symmetry,
    spin-restricted eris; gate: eris_spin_restricted) also skips the
    (beta, *) scans and doubles the (alpha, alpha) + (alpha, beta) energies.

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
    each rank scans its share), and the energy is one all-reduce of the
    ranks' sums.  Sharded operands are gathered first.  log: as energy_t's."""
    if mesh is not None:
        eris = sharding.local_eris(eris)
        t1, t2, fsp = (sharding.replicate(x) for x in (t1, t2, fsp))
    fo, fv = _fock_diag(eris, fsp, info.nocc)
    if sym:
        t1, t2, fo, fv = _mirror_average(t1, t2, fo, fv, info)
    scans, factor = _pair_scans(eris, t1, t2, fo, fv, sect=(info, sym),
                                slab_dtype=slab_dtype, mesh=mesh)
    e = factor * _scan_energy(scans, fo.dtype, fo.device, log)
    return e if mesh is None else sharding.all_reduce_sum(e, mesh)


def energy_t(eris, t1, t2, fsp=None, sect=None, mesh=None, slab_dtype=None,
             log=None):
    """The (T) energy correction, pair by pair over the occupied (I, J):
    a device_loop.scan over the pair ids, one per spin-sector pair on the
    sector-blocked route, one read at the end.

    sect: optional (SectorInfo, sym): the spin-sector-blocked scans
    (energy_t_sect; the sorted layout).

    The full t3 tensor is O(o^3 v^3), so the permutation operators are
    expanded per (I, J) slab: each step holds only (o, v, v, v) work
    arrays.  On the CPU the sum is differentiable as it stands on small
    systems; on the card the scans run under torch.no_grad(), and the
    gradient is energy_t_grad's, pair by pair.  log: a dict that receives
    'scans', one device_loop.scan log per scan."""
    if sect is not None:
        info, sym = sect
        return energy_t_sect(eris, t1, t2, info, fsp=fsp, sym=sym, mesh=mesh,
                             slab_dtype=slab_dtype, log=log)
    if mesh is not None:
        raise ValueError("energy_t(mesh=...) requires sect: the sharded "
                         "pair scans are implemented on the sector-blocked "
                         "route only (pass sect=(SectorInfo, sym))")
    fo, fv = _fock_diag(eris, fsp, t1.shape[0])
    scans, factor = _pair_scans(eris, t1, t2, fo, fv, slab_dtype=slab_dtype)
    return factor * _scan_energy(scans, t1.dtype, t1.device, log)


def _grad_step(term, leaves):
    """The scan body of the (T) gradient: (ij, e, *acc) -> (ij + 1, e +
    term(ij), *acc + d term(ij) / d leaves), the term and its gradient
    evaluated with grad enabled and the gradient added in place into the
    accumulators (a leaf the term does not reach keeps its zeros: the
    same at every pair of a scan)."""
    def step(state):
        ij, e, *acc = state
        with torch.enable_grad():
            t = term(ij)
            grads = torch.autograd.grad(t, leaves, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g)
        return (ij + 1, e + t.detach(), *acc)

    return step


def energy_t_grad(eris, t1, t2, fsp=None, sect=None, log=None):
    """(E_T, dE_T/dt1, dE_T/dt2, dE_T/dfo, dE_T/dfv), fo and fv the occupied
    and virtual diagonal of the one-body matrix (the only way it enters).

    A device_loop.scan over the pairs whose step evaluates one pair's term
    and its gradient and adds them into accumulators, so one pair's slabs
    and graph are alive at a time (JAX's checkpointed scan): a graph over
    all pairs does not fit at production sizes (C2H2/cc-pVTZ: 196 pairs
    of 14 x 162^3 slabs).  log: as energy_t's."""
    nocc = t1.shape[0]
    fo, fv = _fock_diag(eris, fsp, nocc)
    sym = sect is not None and sect[1]
    leaves = [x.detach() for x in (t1, t2, fo, fv)]
    if sym:
        leaves = list(_mirror_average(*leaves, sect[0]))
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    grads = [torch.zeros_like(x) for x in leaves]
    e_t = torch.zeros((), dtype=fo.dtype, device=fo.device)
    logs = [] if log is None else log.setdefault("scans", [])
    scans, factor = _pair_scans(eris, *leaves, sect=sect)
    for term, first, n in scans:
        logs.append({})
        _, e, *grads = device_loop.scan(
            _grad_step(term, leaves),
            (_ij(first, fo.device), torch.zeros_like(e_t), *grads), n,
            logs[-1])
        e_t = e_t + e
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
    The iterations are a device_loop.Loop: on the card one iteration, the
    map's graph applied to w (backward launches included), the DIIS and
    the test, is captured and replayed, one flag read per iteration.

    log: a dict that receives 'iterations', 'converged', the host seconds
    of the three parts ('energy_grad_s', 'map_s', 'iterations_s':
    StageClock stages, the device synchronized at both ends), the (T)
    gradient's scan logs ('energy_grad') and the loop's ('loop'), or
    None."""
    clock = StageClock(t1.device, log, "ops.ccsd_t.")
    nocc, nvir = t1.shape
    tol = _default_tol(tol, t1.dtype, 1e-10, 1e-5)
    f0 = (eris.fock if fsp is None else fsp).detach()
    if sect is not None:
        vvvv_op = ladder.ensure_sorted_vvvv_op(vvvv_op, eris, sect[0])
    t1g, t2g, fg = (x.detach().clone().requires_grad_(True)
                    for x in (t1, t2, f0))
    n1 = nocc * nvir
    flat = lambda a, b: torch.cat([a.reshape(-1), b.reshape(-1)])
    sub = (lambda name: None) if log is None else \
        (lambda name: log.setdefault(name, {}))

    # on the side stream of the loop below: the map's graph, which its
    # body applies, is then launched on the stream it is captured on
    with device_loop.on_side_stream(t1.device):
        with clock("energy_grad_s"):
            # dE/dt and dE/df of E = E_CCSD (+ E_T)
            with torch.enable_grad():
                e_cc = ccsd_ops.energy(eris, t1g, t2g, fg)
                g1, g2, dE_df = torch.autograd.grad(e_cc, (t1g, t2g, fg))
            if with_t:
                _, h1, h2, hfo, hfv = energy_t_grad(eris, t1g, t2g, fg,
                                                    sect=sect,
                                                    log=sub("energy_grad"))
                g1, g2 = g1 + h1, g2 + h2
                # f enters (T) through its diagonal only
                dE_df = dE_df + torch.diag(torch.cat([hfo, hfv]))
            dE_dt = flat(g1, g2)

        # the map, evaluated once; its graph serves every product below
        with clock("map_s"), torch.enable_grad():
            G = _update_map(eris, t1g, t2g, fg, vvvv_op=vvvv_op, sect=sect)

        def vjp(w, wrt):
            cot = (w[:n1].reshape(nocc, nvir),
                   w[n1:].reshape(nocc, nocc, nvir, nvir))
            return torch.autograd.grad(G, wrt, cot, retain_graph=True)

        def body(state):
            # w = dE/dt + (dG/dt)^T w: the contraction structure of the
            # Lambda equations, with the DIIS updated on the converging
            # iteration too
            _, w, *ring, k, _ = state
            w_new = dE_dt + flat(*vjp(w, (t1g, t2g)))
            nrm = torch.linalg.norm(w_new - w)
            dstate, w_d = diis_ops.diis_update(diis_ops.DIISState(*ring),
                                               w_new, 2)
            conv = nrm.to(torch.float64) < tol
            k = k + 1
            return (~conv & (k < maxiter), torch.where(conv, w_new, w_d),
                    *dstate, k, conv)

        with clock("iterations_s"):
            i0 = torch.zeros((), dtype=torch.int64, device=t1.device)
            _, w, *_, k, conv = device_loop.Loop(body)(
                (torch.full((), maxiter > 0, device=t1.device), dE_dt,
                 *diis_ops.diis_init(dE_dt.numel(), space=10,
                                     dtype=dE_dt.dtype, device=dE_dt.device),
                 i0, torch.zeros((), dtype=torch.bool, device=t1.device)),
                sub("loop"))
            gamma = dE_df + vjp(w, (fg,))[0]
            del G
    if log is not None:
        log.update(iterations=int(k), converged=bool(conv))

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
    space 8): (t1, t2, e_cc).  Converged when |dE| < conv_tol.  The
    iterations are a device_loop.Loop (JAX _ccsd_diis_step, one jitted
    program per iteration): on the card one is captured and replayed, one
    flag read per iteration.

    vvvv_op: prebuilt ladder operand (pack-on-build ERIs); default derives
    one from eris.vvvv per config.ladder_mode.
    sect: optional (SectorInfo, sym): sector-blocked updates (sorted
    layout; needs a non-dense vvvv_op or a dense sorted eris.vvvv).
    conv_tol: None is 1e-10 at f64 (the JAX package's value) and 1e-7 at
    f32, about what an f32 energy of 0.1-1 Ha resolves.
    log: a dict that receives 'iterations', 'converged' and the loop's log
    ('loop'), or None."""
    nocc, nvir = eris.nocc, eris.nvir
    fock = eris.fock
    conv_tol = _default_tol(conv_tol, fock.dtype, 1e-10, 1e-7)
    if sect is not None:
        vvvv_op = ladder.ensure_sorted_vvvv_op(vvvv_op, eris, sect[0])
    elif vvvv_op is None:
        vvvv_op = ladder.make_vvvv_op(eris.vvvv)
    dev, f64 = fock.device, torch.float64

    def body(state):
        # one Jacobi + DIIS step and the test |e - e_old| < conv_tol,
        # made in f64 on the energies as the host floats they were
        _, t1, t2, *ring, e_old, k, _ = state
        t1, t2, dstate, e_dev = _ccsd_diis_step(
            eris, vvvv_op, t1, t2, diis_ops.DIISState(*ring), sect=sect)
        e = e_dev.to(f64)
        conv = (e - e_old).abs() < conv_tol
        k = k + 1
        return (~conv & (k < max_cycle), t1, t2, *dstate, e, k, conv)

    with torch.no_grad():
        e = torch.diagonal(fock)
        eia = e[:nocc, None] - e[None, nocc:]
        eijab = eia[:, None, :, None] + eia[None, :, None, :]
        t1 = torch.zeros((nocc, nvir), dtype=fock.dtype, device=dev)
        t2 = eris.oovv / eijab
        ring = diis_ops.diis_init(nocc * nvir + (nocc * nvir) ** 2, space=8,
                                  dtype=t1.dtype, device=dev)
        _, t1, t2, *_, e_cc, k, conv = device_loop.Loop(body)(
            (torch.full((), max_cycle > 0, device=dev), t1, t2, *ring,
             torch.zeros((), dtype=f64, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev)),
            None if log is None else log.setdefault("loop", {}))
    if log is not None:
        log.update(iterations=int(k), converged=bool(conv))
    return t1, t2, float(e_cc)
