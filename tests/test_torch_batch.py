"""The batched lambda sweep of the PyTorch port (Solver_CCSD.SCF_batch and
ECW.CCSD_GS(mode='parallel'); ROADMAP A.13), f64 on the CPU:

  - SCF_batch against the JAX package's SCF_batch, lane by lane, on the
    alternating (dense ladder) and the sorted sectored route, both packages
    on the same ERIs (so one orbital gauge; mirrors
    tests/test_parallel.py:233-291);
  - SCF_batch against the port's own cold-start SCF on every route, with
    each DIIS kind, with L1, under 'hybrid' (the lane freeze on the fast
    leg's own predicate), and with a lane that reaches maxiter;
  - ECW.CCSD_GS(mode='parallel') against mode='sweep' and the JAX ECW's
    parallel sweep (mirrors tests/test_e2e_gs.py:482-497);
  - the ladder kernel's vmap rule, driven by a stand-in launch (the plain
    product on the CPU): one launch for all lanes, M = lanes x rows;
  - spinsect, diis and vexp under torch.func.vmap against per-lane calls.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import ecw_cc_torch
from ecw_cc_tpu.models.eris import build_eris_device
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_tpu.ops.ccsd import GCC as JGCC
from ecw_cc_tpu.ops.vexp import Exp as JExp
from ecw_cc_tpu.solvers.gs import Solver_CCSD as JSolver
from ecw_cc_torch.kernels import ladder_mm as lmm
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import diis as tdiis
from ecw_cc_torch.ops import ladder as tladder
from ecw_cc_torch.ops import spinsect as tss
from ecw_cc_torch.ops.ccsd import GCC as TGCC
from ecw_cc_torch.ops.vexp import Exp as TExp, make_gs_vexp_device
from ecw_cc_torch.solvers.gs import MAXITER, Solver_CCSD as TSolver

torch.set_num_threads(1)

LS = [0.0, 0.05, 0.1]          # the JAX tests' lanes
LS2 = [0.0, 0.1]               # two lanes, for the route x DIIS product
F64 = dict(dtype=torch.float64, device="cpu")

# route -> (ERIs, the port's config for it)
ROUTES = {
    "dense": ("alt", dict(ladder_mode="dense")),
    "packed": ("alt", dict(ladder_mode="packed")),
    "dense_sorted": ("srt", dict(soup_sector=False)),
    "sectored": ("srt", dict(soup_sym=True)),
    "sectored_nosym": ("srt", dict(soup_sym=False)),
}
DEFAULTS = dict(ladder_mode="auto", soup_sector=True, soup_sym=True,
                iter_precision="highest", hybrid_fast="high")


@contextlib.contextmanager
def port_config(**kw):
    ecw_cc_torch.set_config(**kw)
    try:
        yield
    finally:
        ecw_cc_torch.set_config(**DEFAULTS)


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


@pytest.fixture(scope="module")
def problem(h2o_631g):
    """H2O/6-31G: the JAX ERIs in the alternating layout (dense vvvv) and
    in the sorted layout with their SectoredVVVV, and the port's tensors
    of both; the HF density as the target."""
    mol, ghf, eris_host, eris = h2o_631g
    er_s, sect = build_eris_device(mol, ghf, dtype="float64",
                                   pack_ladder=True, sort_spin=True)
    perm = jl.spin_sort_perm(ghf.orbspin, eris_host.nocc)
    return dict(mol=mol, ghf=ghf, eris=eris, er_s=er_s, sect=sect,
                perm=perm,
                alt=(from_numpy(eris, **F64), None),
                srt=from_numpy(er_s, sect, **F64),
                target=np.diag(np.asarray(ghf.mo_occ, dtype=np.float64)))


def _port_solver(p, layout, **kw):
    exp = TExp(0.05, [[["mat", p["target"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    er, op = p[layout]
    args = dict(conv="tl", conv_thres=1e-8, diis="tl", maxiter=60)
    if layout == "srt":
        args.update(vvvv_op=op, mo_perm=p["perm"])
    args.update(kw)
    return TSolver(TGCC(er), exp, **args)


def _jax_solver(p, layout, **kw):
    exp = JExp(0.05, [[["mat", p["target"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    args = dict(conv="tl", conv_thres=1e-8, diis="tl", maxiter=60)
    if layout == "srt":
        return JSolver(JGCC(p["er_s"]), exp, vvvv_op=p["sect"],
                       mo_perm=p["perm"], **args, **kw)
    return JSolver(JGCC(p["eris"]), exp, **args, **kw)


def _same_lanes(batch, seq, amp_tol=1e-9, ep_tol=1e-10):
    """Lane i of `batch` = seq[i]: text (status, lambda, iterations),
    histories, rdm1 and amplitudes."""
    assert len(batch) == len(seq)
    for out, ref in zip(batch, seq):
        assert out[0] == ref[0]
        assert len(out[1]) == len(ref[1])
        np.testing.assert_allclose(out[1], np.asarray(ref[1]), rtol=0,
                                   atol=ep_tol)
        np.testing.assert_allclose(out[2], np.asarray(ref[2]), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(out[3], np.asarray(ref[3]), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(out[4], np.asarray(ref[4]), rtol=0,
                                   atol=amp_tol)
        for a, b in zip(out[5], ref[5]):
            assert isinstance(a, np.ndarray) and a.shape == np.shape(b)
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=amp_tol)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_batch_matches_jax(problem):
    """The JAX test's batch (conv_thres 1e-8, diis 'tl', lambdas 0, 0.05,
    0.1) on the sorted sectored route, both packages on the same ERIs:
    equal texts and iterations per lane, energies to 1e-10 Ha, rdm1 and
    amplitudes to 1e-9.  (The alternating route is held to the JAX
    package through ECW below.)"""
    ref = _jax_solver(problem, "srt").SCF_batch(LS)
    solver = _port_solver(problem, "srt")
    out = solver.SCF_batch(LS)
    assert solver.last_solve["route"] == "sectored"
    assert solver.last_solve["lanes"] == len(LS)
    assert solver.last_solve["iterations"] == [len(r[1]) for r in ref]
    assert all("Convergence reached" in r[0] for r in out)
    _same_lanes(out, ref)


def test_ecw_parallel_matches_sweep_and_jax(h2o_631g):
    """ECW.CCSD_GS(mode='parallel') lands on mode='sweep''s energies (warm
    starts against cold ones, 1e-9) and on the JAX ECW's parallel sweep
    (1e-9); its solve_log has one entry per lambda from one batched
    solve."""
    from ecw_cc_tpu import ECW as JECW

    def run(ecw, mode):
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        res = _quiet(ecw.CCSD_GS, np.linspace(0.0, 0.1, 3), conv_thres=1e-8,
                     maxiter=60, diis="tl", mode=mode)
        return np.asarray(ecw.Ep_lamb), res

    ref = JECW("h2o", "6-31g")
    ep_jax, res_jax = run(ref, "parallel")
    port = ecw_cc_torch.ECW("h2o", "6-31g", **F64)
    ep_par, res_par = run(port, "parallel")
    log = port.solve_log
    assert [s["L"] for s in log] == list(np.linspace(0.0, 0.1, 3))
    assert all(s["lanes"] == 3 and s["status"] == 1 for s in log)
    assert [s["lane"] for s in log] == [0, 1, 2]
    ep_seq, _ = run(ecw_cc_torch.ECW("h2o", "6-31g", **F64), "sweep")
    np.testing.assert_allclose(ep_par, ep_seq, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ep_par, ep_jax, rtol=0, atol=1e-9)
    assert res_par[0] == res_jax[0]
    assert len(res_par[1]) == len(res_jax[1])
    # any other mode runs the warm sweep, as the JAX ECW does (JAX
    # models/ecw.py:487)
    _quiet(port.CCSD_GS, [0.0], conv_thres=1e-8, maxiter=60, diis="tl",
           mode="batched")
    assert "lanes" not in port.solve_log[-1]
    assert port.solve_log[-1]["status"] == 1


# ---------------------------------------------------------------------------
# against the port's own cold-start SCF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("diis", ["", "tl", "rdm1"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_batch_equals_cold_start_scf(problem, route, diis):
    """Each lane of SCF_batch = a cold-start SCF at its lambda, on every
    route and with each DIIS kind.  Without DIIS the lanes converge in
    different iteration counts, so the finished ones are frozen while the
    others run.  rdm1 DIIS amplifies roundoff along its trajectory (1e-16
    to 1e-9 in Ep over 30 iterations, tests/test_torch_solver.py), so it
    runs a fixed 9 iterations on the 'l' criterion."""
    layout, cfg = ROUTES[route]
    kw = (dict(diis=diis, conv="l", conv_thres=1e-12, maxiter=8)
          if diis == "rdm1" else dict(diis=diis, conv_thres=1e-6))
    with port_config(**cfg):
        solver = _port_solver(problem, layout, **kw)
        out = solver.SCF_batch(LS2)
        seq = [_port_solver(problem, layout, **kw).SCF(L) for L in LS2]
        assert solver.last_solve["route"] == route.replace("_nosym", "")
        assert solver.last_solve["sym"] is (route == "sectored")
    _same_lanes(out, seq)
    if diis == "":
        assert len({len(r[1]) for r in out}) > 1     # lanes froze apart


def test_batch_with_l1_equals_cold_start_scf(problem):
    """alpha (the L1 proximal term) shared by the lanes; L1 does not
    converge to a tight threshold, so a fixed 10 iterations."""
    kw = dict(maxiter=9, conv_thres=1e-12)
    with port_config(ladder_mode="packed"):
        out = _port_solver(problem, "alt", **kw).SCF_batch(LS, alpha=1e-3)
        seq = [_port_solver(problem, "alt", **kw).SCF(L, alpha=1e-3)
               for L in LS]
    _same_lanes(out, seq)


def test_batch_lane_at_maxiter(problem):
    """A maxiter one below the slowest lane's iterations: that lane ends
    in 'Max iteration reached' while the others converge, each with the
    status and histories of its sequential solve."""
    kw = dict(diis="", conv_thres=1e-6)
    seq = [_port_solver(problem, "srt", **kw).SCF(L) for L in LS]
    slow = int(np.argmax([len(r[1]) for r in seq]))
    kw["maxiter"] = len(seq[slow][1]) - 1
    seq[slow] = _port_solver(problem, "srt", **kw).SCF(LS[slow])
    solver = _port_solver(problem, "srt", **kw)
    out = solver.SCF_batch(LS)
    status = solver.last_solve["status"]
    assert MAXITER in status and 1 in status
    assert status == [MAXITER if r[0] == "Max iteration reached" else 1
                      for r in seq]
    _same_lanes(out, seq)


@pytest.mark.parametrize("fast", ["high", "bf16"])
def test_batch_hybrid_lane_freeze(problem, fast):
    """Under 'hybrid' a lane that leaves the fast leg first freezes there
    on the fast leg's own predicate (switch or stall) while slower lanes
    finish it; every lane then converges to its sequential result (the
    JAX test's tolerances, tests/test_parallel.py:265-291), and at f64 the
    'high' leg is the full-precision arithmetic, so each lane's legs equal
    the sequential ones.  The 'bf16' fast leg runs the BF16 product's plain
    version through its vmap rule: its roundoff differs between one
    folded product and one per lane, so there only the converged result
    is held to the sequential one."""
    with port_config(iter_precision="hybrid", hybrid_fast=fast):
        solver = _port_solver(problem, "alt")
        out = solver.SCF_batch(LS)
        seq, legs = [], []
        for L in LS:
            s = _port_solver(problem, "alt")
            seq.append(s.SCF(L))
            legs.append(s.last_solve["legs"])
    batch_legs = solver.last_solve["legs"]
    assert [m for m, _, _ in batch_legs] == [fast, "highest"]
    for i, (res, ref) in enumerate(zip(out, seq)):
        assert "Convergence reached" in res[0], res[0]
        assert abs(res[1][-1] - ref[1][-1]) < 1e-10
        for a, b in zip(res[5], ref[5]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
        if fast == "high":
            assert [n[i] for _, n, _ in batch_legs] == [
                n for _, n, _ in legs[i]]


# ---------------------------------------------------------------------------
# the ladder kernel's vmap rule (a stand-in launch on the CPU)
# ---------------------------------------------------------------------------

def _stand_in_launch(calls):
    """_launch replaced by the plain product; it records each launch's A
    shape and kind, and reads data_ptr() as the launch does, so a wrapped
    (batched) tensor fails."""
    def stand_in(a, b, backward=False, precision=None, tangent=False):
        a.data_ptr()
        b.data_ptr()
        calls.append((tuple(a.shape), backward, tangent))
        lmm.ladder_mm.launches += 1
        return a @ b.T
    return stand_in


@pytest.mark.parametrize("in_dim", [0, 1])
def test_ladder_vmap_rule_one_launch(monkeypatch, in_dim):
    """vmap of _LadderMM over lanes of A: one launch with the lanes folded
    into M, equal to the per-lane products; under jvp one forward and one
    tangent launch for all lanes; a batched B raises."""
    calls = []
    monkeypatch.setattr(lmm, "_launch", _stand_in_launch(calls))
    monkeypatch.setattr(lmm.ladder_mm, "launches", 0)
    rng = np.random.default_rng(2)
    a, da = (torch.tensor(rng.standard_normal((3, 5, 7))) for _ in range(2))
    w = torch.tensor(rng.standard_normal((7, 7)))
    w = w + w.T
    fn = lambda x: lmm._LadderMM.apply(x, w, True, False)   # noqa: E731
    out = torch.func.vmap(fn, in_dims=in_dim)(a.movedim(0, in_dim))
    assert calls == [((15, 7), False, False)]
    for i in range(3):
        assert (out[i] - a[i] @ w.T).abs().max() < 1e-13
    calls.clear()
    c, dc = torch.func.vmap(lambda x, dx: torch.func.jvp(fn, (x,), (dx,)))(
        a, da)
    assert calls == [((15, 7), False, False), ((15, 7), False, True)]
    assert (dc - da @ w.T).abs().max() < 1e-13
    with pytest.raises(RuntimeError, match="batch axis"):
        torch.func.vmap(lambda y: lmm._LadderMM.apply(a[0], y, False,
                                                      False))(
            torch.stack([w, w]))


def test_reduced_vmap_rule_folds_and_pads(monkeypatch):
    """vmap of the TF32 product: one call of the plain version with M =
    lanes x rows; the folded A of a padded batch (the solver's _pack_pairs
    rows) keeps its 16-byte rows, so the launch's _tc_operands takes it
    without a copy, and a compact one is padded after the fold; a batched
    B raises."""
    seen = []
    plain = lmm.ladder_mm_plain

    def recording(a, b, precision=None):
        a2, _, _ = lmm._tc_operands(a, b, "tf32")
        seen.append((tuple(a.shape), a2.stride(0), a2.data_ptr() ==
                     a.data_ptr()))
        return plain(a, b, precision)

    monkeypatch.setattr(lmm, "ladder_mm_plain", recording)
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.standard_normal((6, 7)), dtype=torch.float32)
    buf = torch.zeros((3, 5, 8), dtype=torch.float32)
    buf[..., :7] = torch.tensor(rng.standard_normal((3, 5, 7)))
    padded = buf[..., :7]                       # rows 32 bytes apart
    fn = lambda x: lmm.ladder_mm(x, w, precision="tf32")   # noqa: E731
    out = torch.func.vmap(fn)(padded)
    assert seen == [((15, 7), 8, True)]
    want = plain(padded.reshape(15, 7), w, "tf32").reshape(3, 5, 6)
    assert torch.equal(out, want)
    torch.func.vmap(fn)(padded.contiguous())    # rows 28 bytes apart
    assert seen[1] == ((15, 7), 8, False)
    with pytest.raises(RuntimeError, match="batch axis"):
        torch.func.vmap(lambda y: lmm.ladder_mm(padded[0], y,
                                                precision="tf32"))(
            torch.stack([w, w]))


@pytest.mark.parametrize("route,per_iteration", [("packed", 1),
                                                 ("sectored", 2)])
def test_batch_launches_once_per_product(monkeypatch, problem, route,
                                         per_iteration):
    """With every ladder product sent through _LadderMM and the launch
    replaced by the plain product (as on the card): a batched iteration
    makes one launch per product for all lanes, with M = lanes x rows
    (the packed route's stacked 2 o^2; the sectored route's two
    mirror-symmetric sector GEMMs), and the lanes do not move."""
    layout, cfg = ROUTES[route]
    calls = []
    monkeypatch.setattr(lmm, "_launch", _stand_in_launch(calls))
    monkeypatch.setattr(lmm.ladder_mm, "launches", 0)
    monkeypatch.setattr(
        tladder, "ladder_mm",
        lambda a, b, symmetric=False, precision=None:
        lmm._LadderMM.apply(a, b, bool(symmetric), False))
    with port_config(**cfg):
        solver = _port_solver(problem, layout, conv_thres=1e-6)
        out = solver.SCF_batch(LS)
        n = max(solver.last_solve["iterations"])
        assert solver.last_solve["ladder_launches"] == per_iteration * n
        assert len(calls) == per_iteration * n
        nocc = problem["ghf"].mo_occ.sum().astype(int)
        rows = ([2 * nocc * nocc] if route == "packed" else
                [2 * (nocc // 2) ** 2, 2 * (nocc // 2) ** 2])
        assert [c[0][0] for c in calls[:per_iteration]] == [
            len(LS) * m for m in rows]
        monkeypatch.undo()
        seq = [_port_solver(problem, layout, conv_thres=1e-6).SCF(L)
               for L in LS]
    _same_lanes(out, seq)


# ---------------------------------------------------------------------------
# the modules under vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,batched,folded", [
    ("ijab,abcd->ijcd", (True, False), True),      # lanes into the rows
    ("jb,iajb->ia", (True, False), True),          # one row per lane
    ("ikab,jkab->ij", (True, True), False),        # small output, long sum
    ("ijab,ijab->", (True, True), False),          # a dot per lane
    ("iajb,jb->ia", (True, True), True),           # a batched GEMV
    ("ia,jb,ijab->", (True, True, False), False),  # the t1.t1 energy
])
def test_lane_einsum_under_vmap(monkeypatch, spec, batched, folded):
    """promote.lane_einsum under torch.func.vmap over three lanes equals
    the per-lane einsums (at any lane axis, nested, and with a gradient
    through it), in one torch.einsum for all lanes or one per lane as
    _lane_by_lane decides; outside vmap it is torch.einsum."""
    from ecw_cc_torch.ops import promote

    rng = np.random.default_rng(6)
    size = dict(zip("ijkabcd", (4, 3, 5, 6, 7, 6, 7)))
    ins = spec.split("->")[0].split(",")
    ops = [torch.tensor(rng.standard_normal(
        ((3,) if b else ()) + tuple(size[c] for c in sub)))
        for sub, b in zip(ins, batched)]
    in_dims = tuple(0 if b else None for b in batched)
    want = torch.stack([torch.einsum(spec, *(o[n] if b else o for o, b in
                                             zip(ops, batched)))
                        for n in range(3)])
    calls = []
    real = torch.einsum
    monkeypatch.setattr(torch, "einsum",
                        lambda *a: calls.append(a[0]) or real(*a))
    got = torch.func.vmap(lambda *x: promote.lane_einsum(spec, *x),
                          in_dims=in_dims)(*ops)
    assert len(calls) == (1 if folded else 3)
    assert (got - want).abs().max() < 1e-12
    moved = [o.movedim(0, -1) if b else o for o, b in zip(ops, batched)]
    got = torch.func.vmap(lambda *x: promote.lane_einsum(spec, *x),
                          in_dims=tuple(-1 if b else None
                                        for b in batched))(*moved)
    assert (got - want).abs().max() < 1e-12
    nested = torch.func.vmap(torch.func.vmap(
        lambda *x: promote.lane_einsum(spec, *x), in_dims=in_dims),
        in_dims=in_dims)(*(torch.stack([o, 2 * o]) if b else o
                           for o, b in zip(ops, batched)))
    assert (nested[0] - want).abs().max() < 1e-12
    x = ops[0].clone().requires_grad_()
    torch.func.vmap(lambda *y: promote.lane_einsum(spec, *y),
                    in_dims=in_dims)(x, *ops[1:]).sum().backward()
    ref = ops[0].clone().requires_grad_()
    torch.stack([real(spec, *(o[n] if b else o for o, b in
                              zip([ref] + ops[1:], batched)))
                 for n in range(3)]).sum().backward()
    assert (x.grad - ref.grad).abs().max() < 1e-12
    calls.clear()
    plain = promote.lane_einsum(spec, *(o[0] if b else o
                                        for o, b in zip(ops, batched)))
    assert calls == [spec] and (plain - want[0]).abs().max() < 1e-12


def test_spinsect_diis_vexp_under_vmap(problem):
    """SpinBlocked.dense / unpack_balanced, diis_update (past min_space)
    and the GS Vexp update with per-lane weights, each vmapped over three
    lanes, equal to per-lane calls."""
    p = problem
    info = tss.sector_info(p["perm"] % 2, p["eris"].nocc)
    rng = np.random.default_rng(5)
    n4 = tss.packed_size("oovv", info, sym=True)
    flat = torch.tensor(rng.standard_normal((3, n4)))
    un = lambda f: tss.unpack_balanced(f, "oovv", info, sym=True)  # noqa
    got = torch.func.vmap(un)(flat)
    for i in range(3):
        assert torch.equal(got[i], un(flat[i]))

    space, n = 4, 6
    xs = torch.tensor(rng.standard_normal((5, 3, n)))
    st_b = tdiis.diis_init(n, space, dtype=torch.float64, device="cpu",
                           lanes=3)
    st_l = [tdiis.diis_init(n, space, dtype=torch.float64, device="cpu")
            for _ in range(3)]
    ring = [st_b]

    def upd(x, e, f, last, B):
        ring[0], out = tdiis.diis_update(
            ring[0]._replace(xs=x, errs=e, last=last, B=B), f, 2)
        return out, ring[0].xs, ring[0].errs, ring[0].last, ring[0].B

    for k in range(5):
        s = ring[0]
        out, *tens = torch.func.vmap(upd)(s.xs, s.errs, xs[k], s.last, s.B)
        ring[0] = ring[0]._replace(**dict(zip(("xs", "errs", "last", "B"),
                                               tens)))
        for i in range(3):
            st_l[i], want = tdiis.diis_update(st_l[i], xs[k, i], 2)
            assert (out[i] - want).abs().max() < 1e-12
    assert ring[0].nvec == st_l[0].nvec == space

    exp = TExp(0.1, [[["mat", p["target"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    fn = make_gs_vexp_device(exp, dtype=torch.float64, device="cpu")
    dim = p["target"].shape[0]
    rdm1 = torch.tensor(rng.standard_normal((3, dim, dim)))
    Lw = torch.tensor([[0.0], [0.05], [0.1]], dtype=torch.float64)
    V, D, vmax = torch.func.vmap(fn)(rdm1, Lw)
    for i in range(3):
        Vi, Di, vi = fn(rdm1[i], [float(Lw[i, 0])])
        assert torch.equal(V[i], Vi) and torch.equal(D[i], Di)
        assert torch.equal(vmax[i], vi)
