"""The port's device loops (ecw_cc_torch.solvers.device_loop) and the
fixed-shape DIIS ring under them (ecw_cc_torch.ops.diis), f64 on the CPU:

  - the ring against the JAX package's ring state by state (its
    bookkeeping exactly, the extrapolation to 1e-12), through wraps, a
    non-finite vector, and three lanes under torch.func.vmap;
  - every solver loop body is capturable: run under a TorchDispatchMode,
    it reads nothing to the host (no `_local_scalar_dense`, `nonzero`,
    `masked_select`, and no tensor made from host data, `lift_fresh`), and
    iterations 2, 3 and one after the DIIS ring has filled issue the same
    operations on tensors of the same shapes and dtypes: the
    precondition of a CUDA graph capture, checked without a card;
  - the same for the target's loops (solve_ccsd, solve_lambda, the (T)
    adjoint's iterations) and for the (T) scans' pair bodies, energy and
    gradient, on every route and spin-sector pair;
  - device_loop.scan on the CPU is the Python loop of its body;
  - Solver_CCS and SolverES_Device keep their loops across a sweep's
    lambdas: one loop per CCS sweep, at most two per ES sweep, with the
    results of one solver per lambda;
  - on a card (marked `gpu`, skipped without one): the captured C2H2/6-31G
    f64 solve equals the CPU's.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import ecw_cc_torch
from ecw_cc_tpu.models.eris import build_eris_device
from ecw_cc_tpu.ops import diis as jdiis
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_torch import ECW
from ecw_cc_torch.config import matmul_precision
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import diis as tdiis
from ecw_cc_torch.ops.ccs import Gccs
from ecw_cc_torch.ops.ccsd import GCC as TGCC
from ecw_cc_torch.ops.vexp import Exp as TExp
from ecw_cc_torch.solvers import device_loop
from ecw_cc_torch.solvers.es import Solver_ES, SolverES_Device
from ecw_cc_torch.solvers.gs import Solver_CCS, Solver_CCSD

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


# ---------------------------------------------------------------------------
# (a) the fixed-shape ring against the JAX ring
# ---------------------------------------------------------------------------

def _same_ring(st, sj, xt, xj, step):
    """Bookkeeping exactly; extrapolation and Gram matrix to 1e-12 of
    their largest entry (non-finite entries where JAX has them)."""
    assert int(st.nvec) == int(sj.nvec), step
    assert int(st.head) == int(sj.head), step
    assert bool(st.has_last) == bool(sj.has_last), step
    for a, b in ((xt, xj), (st.B, sj.B), (st.last, sj.last)):
        b = np.asarray(b)
        fin = np.isfinite(b)
        scale = np.abs(b[fin]).max() if fin.any() else 1.0
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * scale,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("space,min_space", [(5, 2), (15, 3)])
def test_ring_matches_jax_state_by_state(space, min_space):
    """3 x space pushes of iterates approaching a fixed point: the ring
    fills and wraps (twice with space 5)."""
    rng = np.random.default_rng(space)
    n = 40
    x_star = rng.standard_normal(n)
    sj = jdiis.diis_init(n, space, dtype=jnp.float64)
    st = tdiis.diis_init(n, space, **F64)
    for step in range(3 * space):
        x = x_star + 0.8 ** step * rng.standard_normal(n)
        sj, xj = jdiis.diis_update(sj, jnp.asarray(x), min_space)
        st, xt = tdiis.diis_update(st, torch.tensor(x), min_space)
        assert st.nvec.dtype == torch.int64 and st.nvec.dim() == 0
        _same_ring(st, sj, xt, xj, step)


def test_ring_with_a_non_finite_vector_matches_jax():
    """A NaN pushed at step 3 poisons the Gram matrix until the ring
    evicts it; every extrapolation until then falls back to the iterate
    given, in both packages, and the ring recovers after."""
    rng = np.random.default_rng(3)
    n, space = 12, 4
    sj = jdiis.diis_init(n, space, dtype=jnp.float64)
    st = tdiis.diis_init(n, space, **F64)
    for step in range(4 * space):
        x = rng.standard_normal(n)
        if step == 3:
            x[5] = np.nan
        sj, xj = jdiis.diis_update(sj, jnp.asarray(x), 2)
        st, xt = tdiis.diis_update(st, torch.tensor(x), 2)
        _same_ring(st, sj, xt, xj, step)
        if 3 <= step <= 3 + space:
            # the NaN row is in the ring: no extrapolation is taken
            np.testing.assert_array_equal(xt.numpy(), x)
    assert np.isfinite(xt.numpy()).all()


def test_ring_three_lanes_under_vmap_equal_three_rings():
    """Three lanes of one ring under torch.func.vmap (the batched
    sweep's way: the bookkeeping shared, in_dims None) equal three
    single rings, through a wrap, to 1e-12."""
    rng = np.random.default_rng(11)
    space, n, lanes = 5, 9, 3
    xs = torch.tensor(rng.standard_normal((3 * space, lanes, n)))
    st_b = tuple(tdiis.diis_init(n, space, lanes=lanes, **F64))
    st_l = [tdiis.diis_init(n, space, **F64) for _ in range(lanes)]
    dims = (0, 0, 0, 0, None, None, None)

    def upd(ring, x):
        st, out = tdiis.diis_update(tdiis.DIISState(*ring), x, 2)
        return tuple(st), out

    step = torch.func.vmap(upd, in_dims=(dims, 0), out_dims=(dims, 0))
    for k in range(3 * space):
        st_b, out = step(st_b, xs[k])
        for i in range(lanes):
            st_l[i], want = tdiis.diis_update(st_l[i], xs[k, i], 2)
            assert (out[i] - want).abs().max() < 1e-12
            assert (st_b[3][i] - st_l[i].B).abs().max() < 1e-12
        assert int(st_b[4]) == int(st_l[0].nvec)
        assert int(st_b[5]) == int(st_l[0].head)
    assert int(st_b[4]) == space


# ---------------------------------------------------------------------------
# (b) every loop body is capturable
# ---------------------------------------------------------------------------

# operations that read a device value to the host, or make a tensor from
# host data (a host-to-device copy on the card); none may be captured
_HOST = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
         torch.ops.aten.masked_select, torch.ops.aten.lift_fresh,
         torch.ops.aten.is_nonzero, torch.ops.aten.item}


def _sig(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y) for y in x)
    return None


class _Record(TorchDispatchMode):
    """The operations one call dispatches: name, and the shapes and
    dtypes of every tensor in and out; the host-touching ones apart."""

    def __init__(self):
        super().__init__()
        self.ops, self.host = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in _HOST:
            self.host.append(str(func))
        out = func(*args, **kwargs)
        self.ops.append((str(func), _sig(list(args)),
                         _sig(list(kwargs.values())), _sig(out)))
        return out


N_ITER = 9        # past the ring's filling at maxdiis 4


@pytest.fixture
def recorded(monkeypatch):
    """device_loop.Loop's call replaced
    by N_ITER recorded eager iterations, whatever `go` says; returns the
    list of each loop's recordings."""
    loops = []

    def call(self, state, log=None):
        recs = []
        state = tuple(state)
        with torch.no_grad(), matmul_precision(self.mode):
            for _ in range(N_ITER):
                rec = _Record()
                with rec:
                    state = tuple(self.body(state))
                recs.append(rec)
        loops.append(recs)
        if log is not None:
            log.update(graph=False, iterations=N_ITER)
        return state

    def scan(body, state, n, log=None):
        # N_ITER steps whatever n says (every case has more pairs)
        recs = []
        state = tuple(state)
        for _ in range(N_ITER):
            rec = _Record()
            with rec:
                state = tuple(body(state))
            recs.append(rec)
        loops.append(recs)
        return state

    monkeypatch.setattr(device_loop.Loop, "__call__", call)
    monkeypatch.setattr(device_loop, "scan", scan)
    return loops


def _assert_capturable(loops):
    assert loops
    for recs in loops:
        for i, rec in enumerate(recs):
            assert not rec.host, f"iteration {i + 1} reads the host: " \
                                 f"{sorted(set(rec.host))}"
        # iteration 2 against 3 and the last (the ring full)
        for j in (2, N_ITER - 1):
            a, b = recs[1].ops, recs[j].ops
            assert len(a) == len(b), (j, len(a), len(b))
            for n, (x, y) in enumerate(zip(a, b)):
                assert x == y, (j, n, x, y)


@contextlib.contextmanager
def _port_config(**kw):
    ecw_cc_torch.set_config(**kw)
    try:
        yield
    finally:
        ecw_cc_torch.set_config(ladder_mode="auto", soup_sector=True,
                                soup_sym=True)


@pytest.fixture(scope="module")
def ccsd_problem(h2o_631g):
    """H2O/6-31G in the alternating layout (dense vvvv) and the sorted
    one with its SectoredVVVV; the HF density as the target."""
    mol, ghf, eris_host, eris = h2o_631g
    er_s, sect = build_eris_device(mol, ghf, dtype="float64",
                                   pack_ladder=True, sort_spin=True)
    return dict(mol=mol, ghf=ghf,
                perm=jl.spin_sort_perm(ghf.orbspin, eris_host.nocc),
                alt=(from_numpy(eris, **F64), None),
                srt=from_numpy(er_s, sect, **F64),
                target=np.diag(np.asarray(ghf.mo_occ, dtype=np.float64)))


# case -> (ERIs, the port's config, the route Solver_CCSD takes)
CCSD_ROUTES = {
    "packed": ("alt", dict(ladder_mode="packed"), "packed"),
    "sectored_sym": ("srt", dict(soup_sym=True), "sectored"),
    "dense": ("alt", dict(ladder_mode="dense"), "dense"),
    "dense_sorted": ("srt", dict(soup_sector=False), "dense_sorted"),
}


def _ccsd_case(p, route, lanes, diis):
    layout, cfg, name = CCSD_ROUTES[route]
    er, op = p[layout]
    exp = TExp(0.05, [[["mat", p["target"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    kw = dict(vvvv_op=op, mo_perm=p["perm"]) if layout == "srt" else {}
    with _port_config(**cfg):
        solver = Solver_CCSD(TGCC(er), exp, conv="tl", conv_thres=1e-12,
                             diis=diis, maxiter=40, maxdiis=4, **kw)
        assert solver.route() == name
        if lanes == 1:
            solver.SCF(0.05)
        else:
            solver.SCF_batch([0.0, 0.05, 0.1])


def _ccs_case(diis, store_ite):
    ecw = ECW("h2o", "6-31g", **F64)
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
    solver = Solver_CCS(Gccs(ecw.eris),
                        TExp(0.5, ecw.exp_data, ecw.mol, ecw.mo_coeff,
                             Ek_exp_GS=ecw.Ek_exp_GS),
                        conv="tl", conv_thres=1e-12, maxiter=40, maxdiis=4,
                        diis=diis)
    solver.SCF(0.5, store_ite=store_ite)


def _es_case(diis):
    ecw = ECW("h2o", "6-31g", **F64)
    dip = (0.523742 + 0.550251) / 2.0
    ecw.Build_ES_exp_input([[["trdip", (dip, 0.0, 0.0)]],
                            [["DEk", 7.6051 * 0.03675]]])
    S = Solver_ES(Gccs(ecw.eris),
                  TExp(0.15, ecw.exp_data, ecw.mol, ecw.mo_coeff),
                  rn_ini=ecw.r_ini, conv_var="rl", conv_thres=1e-12,
                  maxiter=40, maxdiis=4, diis=diis)
    SolverES_Device(S).SCF(0.15)


def _target_system(p, route):
    """(eris, vvvv_op, sect, t1, t2) of the target's loops on H2O/6-31G:
    'sectored_sym' and 'sectored' the sorted ERIs with their
    SectoredVVVV, amplitudes balanced and mirror symmetric; 'dense' the
    alternating ERIs and their MP2 amplitudes with a small t1."""
    from test_ccsd_kernels import _mirror_amps

    from ecw_cc_torch.ops.spinsect import sector_info

    if route == "dense":
        er, _ = p["alt"]
        e = torch.diagonal(er.fock)
        no = er.nocc
        eia = e[:no, None] - e[None, no:]
        t2 = er.oovv / (eia[:, None, :, None] + eia[None, :, None, :])
        t1 = 0.01 * torch.ones_like(eia)
        return er, None, None, t1, t2
    er, op = p["srt"]
    info = sector_info(np.asarray(p["ghf"].orbspin)[p["perm"]], er.nocc)
    t1, t2 = (torch.tensor(x) for x in _mirror_amps(info, seed=7)[:2])
    return er, op, (info, route == "sectored_sym"), t1, t2


def _target_case(p, part, route):
    from ecw_cc_torch.models import gamma_exp
    from ecw_cc_torch.ops import ccsd_t

    er, op, sect, t1, t2 = _target_system(p, route)
    if part == "ccsd":
        ccsd_t.solve_ccsd(er, vvvv_op=op, sect=sect)
    elif part == "lambda":
        gamma_exp.solve_lambda(er, t1, t2, vvvv_op=op, sect=sect)
    elif part == "adjoint":
        ccsd_t.ccsd_t_rdm1_response(er, t1, t2, with_t=False, vvvv_op=op,
                                    sect=sect)
    elif part == "t_energy":
        ccsd_t.energy_t(er, t1, t2, sect=sect)
    else:
        ccsd_t.energy_t_grad(er, t1, t2, sect=sect)


TARGET_ROUTES = {"ccsd": ("sectored_sym", "sectored", "dense"),
                 "lambda": ("sectored", "dense"),
                 "adjoint": ("sectored", "dense"),
                 "t_energy": ("sectored_sym", "sectored", "dense"),
                 "t_grad": ("sectored_sym", "sectored", "dense")}
# the loops (and scans: one per spin-sector pair) each case records
TARGET_LOOPS = {"sectored_sym": 2, "sectored": 4, "dense": 1}

CASES = ([("ccsd", r, n, d) for r in CCSD_ROUTES for n in (1, 3)
          for d in ("", "tl", "rdm1")]
         + [("ccs", d, s) for d in ("", "tl", "rdm1") for s in (False, True)]
         + [("es", d) for d in ("", "GS", "ES", "all")]
         + [("target", part, r) for part, routes in TARGET_ROUTES.items()
            for r in routes])


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_loop_body_is_capturable(request, recorded, case):
    """The loop body of every CCSD route (1 and 3 lanes), of CCS (with
    store_ite) and of ES, with every DIIS kind, and of the target's CCSD,
    Lambda and adjoint loops and the (T) scans (energy and gradient, each
    spin-sector pair, with the mirror symmetry and without, and the dense
    route), reads nothing to the host and repeats one sequence of
    operations (module docstring)."""
    kind, *args = case
    if kind == "ccsd":
        _ccsd_case(request.getfixturevalue("ccsd_problem"), *args)
    elif kind == "ccs":
        _ccs_case(*args)
    elif kind == "es":
        _es_case(*args)
    else:
        _target_case(request.getfixturevalue("ccsd_problem"), *args)
        if args[0] in ("t_energy", "t_grad"):
            assert len(recorded) == TARGET_LOOPS[args[1]]
    _assert_capturable(recorded)


def test_scan_gradient_body_records_its_backward(recorded, ccsd_problem):
    """The (T) gradient's step takes its pair's gradient inside the body:
    the recorded steps hold the backward operations (here, the gathers'
    scatter-adds), which a capture therefore holds too."""
    _target_case(ccsd_problem, "t_grad", "sectored_sym")
    ops = {op for op, *_ in recorded[0][1].ops}
    assert any("index_add" in op for op in ops), sorted(ops)


@pytest.mark.parametrize("n", [0, 1, 5])
def test_scan_on_cpu_is_the_python_loop(n):
    """device_loop.scan on the CPU: the body n times from the state, the
    step index a 0-d tensor in the state, nothing read to the host (no
    flag: the length is known); a body that takes a gradient inside
    itself adds it up as the loop would."""
    x = torch.linspace(0.5, 2.0, 12, dtype=torch.float64)
    w = x.clone().requires_grad_(True)

    def body(state):
        ij, acc, g = state
        with torch.enable_grad():
            t = _take1(w, ij) ** 3
            dt, = torch.autograd.grad(t, w)
        g.add_(dt)
        return ij + 1, acc + t.detach(), g

    rec = _Record()
    log = {}
    state = (torch.tensor(3), torch.zeros((), dtype=torch.float64),
             torch.zeros_like(x))
    with rec:
        ij, acc, g = device_loop.scan(body, state, n, log)
    assert not rec.host, sorted(set(rec.host))
    assert log == {"steps": n, "graph": False}
    assert int(ij) == 3 + n
    want_g = torch.zeros_like(x)
    want_g[3:3 + n] = 3 * x[3:3 + n] ** 2
    assert abs(float(acc) - float((x[3:3 + n] ** 3).sum())) < 1e-14
    assert (g - want_g).abs().max() < 1e-14


def _take1(x, ij):
    return x.index_select(0, ij.reshape(1)).squeeze(0)


def _count_loops(monkeypatch):
    made = [0]
    init = device_loop.Loop.__init__

    def counted(self, *a, **k):
        made[0] += 1
        init(self, *a, **k)

    monkeypatch.setattr(device_loop.Loop, "__init__", counted)
    return made


SWEEP = (0.0, 0.25, 0.5)


@pytest.mark.parametrize("diis,store_ite", [("", False), ("tl", False),
                                            ("rdm1", False), ("tl", True)])
def test_ccs_sweep_keeps_one_loop(monkeypatch, diis, store_ite):
    """Solver_CCS over three lambdas, each warm-started from the last,
    builds one loop (the weights a device tensor the kept body reads);
    every lambda equals a new solver's solve from the same start to
    1e-12."""
    ecw = ECW("h2o", "6-31g", **F64)
    ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])

    def solver():
        return Solver_CCS(Gccs(ecw.eris),
                          TExp(0.5, ecw.exp_data, ecw.mol, ecw.mo_coeff,
                               Ek_exp_GS=ecw.Ek_exp_GS),
                          conv="tl", conv_thres=1e-10, maxiter=60,
                          maxdiis=6, diis=diis)

    made = _count_loops(monkeypatch)
    kept, amps, outs = solver(), (None, None), []
    for L in SWEEP:
        out = kept.SCF(L, *amps, store_ite=store_ite)
        outs.append((out, amps))
        amps = out[5:] if store_ite else out[5]
        if store_ite:
            amps = (amps[0][-1], amps[1][-1])
    assert made[0] == 1
    kept.release_graphs()
    assert kept._kept is None
    for L, (out, start) in zip(SWEEP, outs):
        ref = solver().SCF(L, *start, store_ite=store_ite)
        assert out[0] == ref[0]
        for a, b in zip(out[1:], ref[1:]):
            a, b = (np.asarray(v, dtype=float) for v in (a, b))
            assert np.abs(a - b).max() < 1e-12


@pytest.mark.parametrize("diis", ["", "all"])
def test_es_sweep_keeps_at_most_two_loops(monkeypatch, diis):
    """SolverES_Device over three lambdas (the L_loop sweep's way: a cold
    start that pins each state's position, then warm starts that follow
    the largest amplitude) builds two loops; every lambda equals a new
    solver's solve from the same start to 1e-12."""
    ecw = ECW("h2o", "6-31g", **F64)
    dip = (0.523742 + 0.550251) / 2.0
    ecw.Build_ES_exp_input([[["trdip", (dip, 0.0, 0.0)]],
                            [["DEk", 7.6051 * 0.03675]]])
    S = Solver_ES(Gccs(ecw.eris),
                  TExp(0.15, ecw.exp_data, ecw.mol, ecw.mo_coeff),
                  rn_ini=ecw.r_ini, conv_var="rl", conv_thres=1e-9,
                  maxiter=60, maxdiis=8, diis=diis)
    made = _count_loops(monkeypatch)
    kept, amp, outs = SolverES_Device(S), None, []
    for L in (0.0, 0.05, 0.1):
        out = kept.SCF(L, dic_amp_ini=amp, diis=diis)
        outs.append((L, out, amp))
        amp = out[1]
    assert made[0] == 2
    kept.release_graphs()
    for L, out, start in outs:
        ref = SolverES_Device(S).SCF(L, dic_amp_ini=start, diis=diis)
        assert out[0] == ref[0]
        for a, b in ((out[2], ref[2]), (out[3], ref[3]), (out[4], ref[4])):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12
        for k in out[1]:
            assert np.abs(np.asarray(out[1][k])
                          - np.asarray(ref[1][k])).max() < 1e-12


def test_cpu_loop_reads_one_flag_per_iteration():
    """On the CPU the body runs eagerly until its flag is false; the log
    says no graph ran."""
    seen = []

    def body(state):
        go, x = state
        seen.append(float(x))
        x = x + 1
        return (x < 4), x

    log = {}
    go, x = device_loop.Loop(body)(
        (torch.tensor(True), torch.zeros((), dtype=torch.float64)), log)
    assert float(x) == 4 and not bool(go)
    assert seen == [0, 1, 2, 3]
    assert log == {"graph": False, "iterations": 4}


def test_solver_with_kept_loops_is_freed_when_dropped(ccsd_problem):
    """Solver_CCSD keeps its set-up and loops for its next SCF call; the
    loops' bodies hold no reference back to the solver, so dropping the
    solver frees them at once (on the card a graph left to the garbage
    collector may be freed inside another loop's capture)."""
    import gc
    import weakref

    p = ccsd_problem
    er, _ = p["alt"]
    exp = TExp(0.05, [[["mat", p["target"]]]], mol=p["mol"],
               mo_coeff=p["ghf"].mo_coeff)
    solver = Solver_CCSD(TGCC(er), exp, conv="tl", conv_thres=1e-6,
                         diis="tl", maxiter=40)
    solver.SCF(0.05)
    loop = solver._kept[3][0]
    assert isinstance(loop, device_loop.Loop)
    refs = weakref.ref(solver), weakref.ref(loop)
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        del solver, loop
        assert all(r() is None for r in refs)
    finally:
        if gc_was_on:
            gc.enable()


# ---------------------------------------------------------------------------
# (c) on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_captured_solve_equals_cpu_on_card():
    """C2H2/6-31G f64, the sweep lambda = 0, 0.25, 0.5 with DIIS 'tl':
    the captured CCSD solves on the card against the CPU's eager ones:
    equal iterations and Ep to 1e-9 Ha at every lambda; every loop on the
    card replayed a graph, captured at the first lambda and kept for the
    others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for dev in ("cpu", "cuda"):
        ecw = ECW("c2h2", "6-31g", device=dev, dtype=torch.float64)
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        ecw.CCSD_GS([0.0, 0.25, 0.5], diis="tl")
        out[dev] = (list(ecw.Ep_lamb), list(ecw.solve_log))
    (e_cpu, log_cpu), (e_card, log_card) = out["cpu"], out["cuda"]
    assert ([s["iterations"] for s in log_card]
            == [s["iterations"] for s in log_cpu])
    assert max(abs(a - b) for a, b in zip(e_card, e_cpu)) < 1e-9
    loops = [s["loops"] for s in log_card]
    assert all(lp["graph"] for ls in loops for lp in ls)
    assert "capture_ms" in loops[0][0]
    assert not any("capture_ms" in lp for ls in loops[1:] for lp in ls)
