"""The rank side of tests/test_torch_parallel.py: what each gloo rank of the
module's process group runs (ecw_cc_torch.parallel.dryrun.run_ranks).

`rank_checks(data)` runs every check of the port's mesh once, on a mesh of
dp = 2 x tp = 4 over 8 ranks (the scale proof on 1 x 8), and returns one
dict of results: energies, amplitudes, errors, counts.  The test module
asserts each test's own part of it, against the JAX package where the
test says so.  It imports the port alone: the JAX package's inputs come in
`data`, as NumPy arrays.
"""

import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ecw_cc_torch.kernels import ladder_mm as lmm
from ecw_cc_torch.models.eris import ErisHost, GEris, from_numpy
from ecw_cc_torch.ops import ccsd_t, eom, ladder
from ecw_cc_torch.ops.ccsd import GCC
from ecw_cc_torch.ops.spinsect import SectorInfo
from ecw_cc_torch.ops.vexp import Exp
from ecw_cc_torch.parallel import dryrun, sharding
from ecw_cc_torch.parallel.mesh import make_mesh, replicated
from ecw_cc_torch.solvers.gs import Solver_CCSD

F64 = dict(dtype=torch.float64, device="cpu")
SCALE_P = 13041                   # C2H2/cc-pVTZ's packed pairs (nvir 162)


def _np(x):
    return sharding.replicate(x).detach().cpu().numpy()


def _sharded_amps(solver, mesh):
    sh = sharding.amp_shardings(mesh)
    return dict(ts=sharding.shard_tensor(solver.tsini, mesh, sh["t1"]),
                ls=sharding.shard_tensor(solver.lsini, mesh, sh["l1"]),
                td=sharding.shard_tensor(solver.tdini, mesh, sh["t2"]),
                ld=sharding.shard_tensor(solver.ldini, mesh, sh["l2"]))


def _solve(er, op, perm, data, mesh=None, log=False):
    """The JAX test's solve (lambda 0.05, 'tl', 1e-8, DIIS 'tl'), whole or
    with ERIs, operand and amplitudes split over `mesh`."""
    exp = Exp(0.05, [[["mat", data["target"]]]], mol=None,
              mo_coeff=data["mo_coeff"])
    if mesh is not None:
        er = sharding.shard_eris(er, mesh)
        op = sharding.shard_vvvv_op(op, mesh)
    with sharding.CollectiveLog() as coll:
        solver = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8,
                             diis="tl", maxiter=60, vvvv_op=op,
                             mo_perm=perm)
        kw = _sharded_amps(solver, mesh) if mesh is not None else {}
        out = solver.SCF(0.05, keep_device=True, **kw)
    amps = out[5]
    placed = [list(a.placements) if sharding.is_sharded(a) else None
              for a in amps]
    res = dict(text=out[0], Ep=np.asarray(out[1]), rdm1=out[4],
               amps=[_np(a) for a in amps], placed=placed,
               route=solver.last_solve["route"],
               sym=solver.last_solve["sym"],
               iterations=solver.last_solve["iterations"])
    if log:
        res.update(collectives=coll.calls,
                   products_per_iteration=_products(solver, op))
    return res


def _products(solver, op):
    """Ladder products per iteration of the solve's route: one stacked
    product on a PackedVVVV, one per sector without the mirror (two with
    it), two (t and lambda sides) on the dense vvvv."""
    route = solver.last_solve["route"]
    if route == "packed":
        return 1
    if route == "sectored":
        return 2 if solver.last_solve["sym"] else 3
    return 2


def _mesh_checks(mesh):
    sh = sharding.eris_shardings(mesh)
    bad = []
    for n in (3, 5):
        try:
            make_mesh(n_tp=n, device_type="cpu")
        except ValueError as e:
            bad.append(str(e))
    return dict(
        names=mesh.mesh_dim_names, shape=tuple(mesh.mesh.shape),
        bad=bad, replicated=list(replicated(mesh)),
        eris_placements={k: list(v) for k, v in sh.items()},
        amp_placements={k: list(v)
                        for k, v in sharding.amp_shardings(mesh).items()})


def _step_check(mesh):
    """The JAX test's step: synthetic (4, 8) f64, lambda 0.1."""
    nocc, nvir = 4, 8
    eris = dryrun._synthetic_eris(nocc, nvir, torch.float64)
    nmo = nocc + nvir
    target = torch.eye(nmo, dtype=torch.float64) * (
        torch.arange(nmo) < nocc)
    rng = np.random.default_rng(1)
    t1 = rng.standard_normal((nocc, nvir)) * 0.01
    t2 = rng.standard_normal((nocc, nocc, nvir, nvir)) * 0.01
    t2 = t2 - t2.transpose(1, 0, 2, 3)
    t2 = t2 - t2.transpose(0, 1, 3, 2)
    t1, t2 = torch.as_tensor(t1), torch.as_tensor(t2)
    l1, l2 = t1 * 0.5, t2 * 0.5
    ref = dryrun._step_fn(eris, target, 0.1)(t1, t2, l1, l2)
    sh = sharding.amp_shardings(mesh)
    step = dryrun._step_fn(sharding.shard_eris(eris, mesh), target, 0.1)
    out = step(*(sharding.shard_tensor(a, mesh, sh[n]) for a, n in
                 zip((t1, t2, l1, l2), ("t1", "t2", "l1", "l2"))))
    return dict(err=max(float((_np(a) - _np(b)).__abs__().max())
                        for a, b in zip(ref, out)),
                t2_placed=list(out[1].placements))


def _odd_p_check(mesh, data):
    """H2O/STO-3G: p = 6 rows over tp = 4, padded to 8."""
    dense = GEris(*(torch.as_tensor(a) for a in data["sto3g_dense"]))
    packed = ladder.PackedVVVV(wc=torch.as_tensor(data["sto3g_wc"]))
    sh = sharding.shard_vvvv_op(packed, mesh)
    y = ladder.packed_vvvv_contract(sh, dense.oovv)
    ref = 0.5 * torch.einsum("ijef,abef->ijab", dense.oovv, dense.vvvv)
    casts = {}
    for name, dtype in (("tf32", "tf32"), ("bf16", torch.bfloat16)):
        w = sh.to(dtype).wc
        want = lmm.tf32_rows(sh.wc.to_local()) if name == "tf32" else \
            sh.wc.to_local().to(torch.bfloat16)
        casts[name] = (list(w.placements), tuple(w.shape),
                       tuple(w.to_local().shape), w.dtype,
                       bool(torch.equal(w.to_local(), want)))
    return dict(rows=sh.wc.shape[0], local=tuple(sh.wc.to_local().shape),
                p=packed.wc.shape[0], err=float((y - ref).abs().max()),
                casts=casts)


def _to_device_check(mesh, data):
    """ErisHost.to_device(sharding=eris_shardings(mesh)) on H2O/STO-3G's
    host blocks: each block in its placements, equal to the whole."""
    host = SimpleNamespace(**dict(zip(GEris._fields, data["sto3g_dense"])))
    er = ErisHost.to_device(host, dtype=torch.float64, device="cpu",
                            sharding=sharding.eris_shardings(mesh))
    return {k: (list(getattr(er, k).placements),
                float(np.abs(_np(getattr(er, k)) - a).max()) if a.size
                else 0.0)
            for k, a in zip(GEris._fields, data["sto3g_dense"])}


def _shard_rules_check(mesh):
    """The product on a row shard against the whole product, with the
    plain versions on the CPU: forward, backward (autograd and
    torch.func.vjp), tangent (torch.func.jvp) and lanes (torch.func.vmap),
    and what each product runs on this rank (_local_mm calls by kind)."""
    n, M = 37, 9                               # 37 rows over tp = 4: pad 3
    g = torch.Generator().manual_seed(7)
    w = torch.rand((n, n), generator=g, dtype=torch.float64)
    w = w + w.T
    a = torch.rand((M, n), generator=g, dtype=torch.float64)
    da = torch.rand((M, n), generator=g, dtype=torch.float64)
    dc = torch.rand((M, n + 3), generator=g, dtype=torch.float64)
    sh = sharding.local_operand(
        sharding.shard_vvvv_op(ladder.PackedVVVV(wc=w), mesh)).wc
    wp = torch.cat([w, w.new_zeros((3, n))])   # the padded whole operand
    kinds = []
    real = lmm._local_mm

    def counted(a_, b_, precision, kind):
        kinds.append(kind)
        return real(a_, b_, precision, kind)

    lmm._local_mm = counted
    try:
        out = {}
        c = lmm.ladder_mm(a, sh, symmetric=True)
        out["forward"] = float((c - a @ wp.T).abs().max())
        out["forward_kinds"] = list(kinds)
        kinds.clear()
        x = a.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(
            (lmm.ladder_mm(x, sh, symmetric=True) * dc).sum(), x)
        out["backward"] = float((gx - dc @ wp).abs().max())
        out["backward_kinds"] = list(kinds)
        kinds.clear()
        _, vjp = torch.func.vjp(
            lambda y: lmm.ladder_mm(y, sh, symmetric=True), a)
        out["vjp"] = float((vjp(dc)[0] - dc @ wp).abs().max())
        kinds.clear()
        _, tan = torch.func.jvp(
            lambda y: lmm.ladder_mm(y, sh, symmetric=True), (a,), (da,))
        out["tangent"] = float((tan - da @ wp.T).abs().max())
        out["tangent_kinds"] = list(kinds)
        kinds.clear()
        lanes = torch.stack([a, da, 2 * a])
        cv = torch.func.vmap(
            lambda y: lmm.ladder_mm(y, sh, symmetric=True))(lanes)
        out["vmap"] = float((cv - lanes @ wp.T).abs().max())
        out["vmap_kinds"] = list(kinds)
        try:
            lmm.ladder_mm(a, sh, symmetric=False)
        except ValueError:
            out["refuses_general"] = True
    finally:
        lmm._local_mm = real
    return out


def _scale_check(data):
    """cc-pVTZ's packed operand (p = 13041, f32) split over tp = 8, each
    rank drawing only its own rows, from a generator seeded by its row
    block; the packed ladder on it with every collective logged."""
    mesh = make_mesh(n_tp=8, n_dp=1, device_type="cpu")
    p, nocc, nvir = SCALE_P, 14, 162
    rows = p + (-p) % 8
    lo, hi = sharding.row_range(rows, mesh)
    block = lo // (rows // 8)
    rng = np.random.default_rng(1000 + block)
    local = np.zeros((hi - lo, p), dtype=np.float32)
    real = min(hi, p) - lo
    local[:real] = rng.random((real, p), dtype=np.float32) * 1e-3
    wc = sharding.from_rows(torch.from_numpy(local), mesh, rows)
    packed = ladder.PackedVVVV(wc=wc)
    x = torch.as_tensor(np.random.default_rng(0).random(
        (nocc, nocc, nvir, nvir), dtype=np.float32) * 1e-2)
    x = x - x.transpose(2, 3)
    with sharding.CollectiveLog() as log:
        y = ladder.packed_vvvv_contract(packed, x)
    return dict(shape=tuple(wc.shape), local=tuple(wc.to_local().shape),
                local_bytes=wc.to_local().numel() * 4,
                whole_bytes=p * p * 4, collectives=log.calls,
                largest=log.largest(), y_shape=tuple(y.shape),
                finite=bool(torch.isfinite(y).all()))


def _t_energy_check(mesh, data):
    info = SectorInfo(*data["t_info"])
    er = GEris(*(torch.as_tensor(a) for a in data["sorted_eris"]))
    t1, t2 = (torch.as_tensor(a) for a in data["t_amps"])
    rank = dist.get_rank()
    out = {}
    for sym in (False, True):
        out[f"mesh_{sym}"] = float(ccsd_t.energy_t_sect(
            er, t1, t2, info, sym=sym, mesh=mesh))
        # the whole sums, one per rank (the ranks run alongside)
        if rank == int(sym):
            out[f"one_{sym}"] = float(ccsd_t.energy_t_sect(er, t1, t2, info,
                                                           sym=sym))
    try:
        ccsd_t.energy_t(er, t1, t2, mesh=mesh)
    except ValueError as e:
        out["dense_refused"] = str(e)
    return out


def _eom_check(mesh):
    """The JAX test's EOM sigmas: synthetic (4, 8) f64."""
    nocc, nvir = 4, 8
    eris = dryrun._synthetic_eris(nocc, nvir, torch.float64)

    def amps(scale, seed):
        r = np.random.default_rng(seed)
        a1 = torch.as_tensor(r.standard_normal((nocc, nvir)) * scale)
        a2 = torch.as_tensor(
            r.standard_normal((nocc, nocc, nvir, nvir)) * scale)
        a2 = a2 - a2.permute(1, 0, 2, 3)
        a2 = a2 - a2.permute(0, 1, 3, 2)
        return a1, a2

    t1, t2 = amps(0.02, 1)
    r1, r2 = amps(1.0, 2)
    sigma, sigma_left = eom.make_sigma(eris, t1, t2)
    ref = sigma(r1, r2) + sigma_left(r1, r2)
    sh = sharding.amp_shardings(mesh)
    place = lambda x, n: sharding.shard_tensor(x, mesh, sh[n])  # noqa: E731
    sigma_s, sigma_left_s = eom.make_sigma(sharding.shard_eris(eris, mesh),
                                           place(t1, "t1"), place(t2, "t2"))
    r1s, r2s = place(r1, "t1"), place(r2, "t2")
    n0 = dict(calls=0)
    real = lmm._local_mm

    def counted(*a):
        n0["calls"] += 1
        return real(*a)

    lmm._local_mm = counted
    try:
        out = sigma_s(r1s, r2s) + sigma_left_s(r1s, r2s)
    finally:
        lmm._local_mm = real
    return dict(err=[float(np.abs(_np(a) - _np(b)).max())
                     for a, b in zip(ref, out)],
                placed=list(out[1].placements),
                shard_products=n0["calls"])


def _batch(er, op, data, mesh=None):
    """SCF_batch (two lanes) on the packed route, the operand whole or
    split over `mesh`."""
    exp = Exp(0.05, [[["mat", data["target"]]]], mol=None,
              mo_coeff=data["mo_coeff"])
    if mesh is not None:
        er = sharding.shard_eris(er, mesh)
        op = sharding.shard_vvvv_op(op, mesh)
    solver = Solver_CCSD(GCC(er), exp, conv="tl", conv_thres=1e-8,
                         diis="tl", maxiter=60, vvvv_op=op)
    return [(r[0], np.asarray(r[1]), r[5][2])
            for r in solver.SCF_batch([0.0, 0.1])]


def rank_checks(data):
    clock = [time.perf_counter()]
    seconds = {}

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    mesh = make_mesh(n_dp=2, device_type="cpu")
    out = dict(mesh=_mesh_checks(mesh), step=_step_check(mesh),
               odd_p=_odd_p_check(mesh, data),
               to_device=_to_device_check(mesh, data),
               shard_rules=_shard_rules_check(mesh))
    lap("small")
    out["eom"] = _eom_check(mesh)
    lap("eom")
    out["t"] = _t_energy_check(mesh, data)
    lap("t")
    alt = from_numpy(GEris(*data["alt_eris"]), **F64)
    pk = from_numpy(GEris(*data["packed_eris"]),
                    ladder.PackedVVVV(wc=data["packed_wc"]), **F64)
    srt = from_numpy(GEris(*data["sorted_eris"]),
                     ladder.SectoredVVVV(*data["sorted_sect"]), **F64)
    routes = (("dense", (alt, None), None), ("packed", pk, None),
              ("sectored", srt, data["perm"]))
    # the whole (unsplit) solves, one per rank, side by side
    rank = dist.get_rank()
    if rank < len(routes):
        name, (er, op), perm = routes[rank]
        out["whole"] = {name: _solve(er, op, perm, data)}
    elif rank == len(routes):
        out["whole"] = {"batch": _batch(*pk, data)}
    lap("whole")
    solves = {}
    for route, (er, op), perm in routes:
        solves[route] = _solve(er, op, perm, data, mesh=mesh, log=True)
        lap(route)
    sect_sh = sharding.shard_vvvv_op(srt[1], mesh)
    out["sect_rows"] = [w.shape[0] for w in sect_sh]
    out["operands"] = {"packed": tuple(pk[1].wc.shape),
                       "sectored": [tuple(w.shape) for w in srt[1]],
                       "dense": tuple(alt.vvvv.shape)}
    out["solves"] = solves
    out["batch"] = _batch(*pk, data, mesh=mesh)
    lap("batch")
    out["scale"] = _scale_check(data)
    lap("scale")
    out["seconds"] = seconds
    return out
