"""The PyTorch port's ECW-CCS ground state (ecw_cc_torch.ops.ccs, solvers.gs.
Solver_CCS, ECW.CCS_GS and the JSON runner) against the JAX package on
identical f64 inputs, CPU, and the JAX package's own anchors mirrored."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_g_amp
from gauge import jax_gauge
from ecw_cc_tpu import ECW as JaxECW
from ecw_cc_tpu.ops import ccs as jccs
from ecw_cc_tpu.ops.vexp import Exp as JaxExp
from ecw_cc_tpu.solvers.gs import Solver_CCS as JaxSolverCCS
from ecw_cc_torch import ECW
from ecw_cc_torch.__main__ import run_spec
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import ccs as tccs
from ecw_cc_torch.ops.vexp import Exp
from ecw_cc_torch.solvers.gs import Solver_CCS

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
FIELD = [0.05, 0.01, 0.0]


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _flat(x):
    """A result (tensor, array, scalar, or a tuple of them) as one vector."""
    if isinstance(x, (tuple, list)):
        return np.concatenate([_flat(y) for y in x])
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    return np.asarray(x, dtype=np.float64).ravel()


@pytest.fixture(scope="module")
def kernel_inputs(h2o_631g):
    """H2O/6-31G ERIs in both packages, seeded amplitudes, a symmetric
    perturbed fsp, and stacked ES-coupling operands (n_es = 2)."""
    _, _, _, er = h2o_631g
    no, nv = er.nocc, er.nvir
    dim = no + nv
    rng = np.random.default_rng(11)
    ts, ls = random_g_amp(rng, no, nv), random_g_amp(rng, no, nv)
    V = rng.standard_normal((dim, dim)) * 0.02
    fsp = np.asarray(er.fock) - (V + V.T)
    es = dict(rsn=rng.standard_normal((2, no, nv)) * 0.05,
              lsn=rng.standard_normal((2, no, nv)) * 0.05,
              r0n=rng.standard_normal(2) * 0.1,
              l0n=rng.standard_normal(2) * 0.1,
              vn=rng.standard_normal((2, dim, dim)) * 0.02)
    return dict(er=er, er_t=from_numpy(er, **F64), ts=ts, ls=ls, fsp=fsp,
                es=es)


def _gs_cases():
    """name -> f(module, eris, to, ts, ls, fsp, es): one GS function of
    ops/ccs.py on the shared inputs (`to` converts an array)."""
    def inter(kind):
        def run(m, er, to, ts, ls, fsp, es):
            return getattr(m, kind)(er, ts, fsp)
        return run

    def tsup(es_terms, l1):
        def run(m, er, to, ts, ls, fsp, es):
            T1i = m.T1inter(er, ts, fsp)
            if l1:
                return m.tsupdate_L1(er, ts, T1i, 0.01)
            if es_terms:
                return m.tsupdate(er, ts, T1i, to(es["rsn"]), to(es["r0n"]),
                                  to(es["vn"]))
            return m.tsupdate(er, ts, T1i)
        return run

    def lsup(es_terms, l1):
        def run(m, er, to, ts, ls, fsp, es):
            L1i = m.L1inter(er, ts, fsp)
            if l1:
                return m.lsupdate_L1(er, ls, L1i, 0.01)
            if es_terms:
                return m.lsupdate(er, ts, ls, L1i, to(es["rsn"]),
                                  to(es["lsn"]), to(es["r0n"]),
                                  to(es["l0n"]), to(es["vn"]))
            return m.lsupdate(er, ts, ls, L1i)
        return run

    return {
        "gamma_unsym_CCS": lambda m, er, to, ts, ls, fsp, es:
            m.gamma_unsym_CCS(ts, ls),
        "gamma_CCS": lambda m, er, to, ts, ls, fsp, es: m.gamma_CCS(ts, ls),
        "energy_ccs": lambda m, er, to, ts, ls, fsp, es:
            m.energy_ccs(er, ts, fsp),
        "energy_ccs_fock": lambda m, er, to, ts, ls, fsp, es:
            m.energy_ccs(er, ts, None),
        "energy_ccs_es": lambda m, er, to, ts, ls, fsp, es:
            m.energy_ccs(er, ts, fsp, to(es["rsn"]), to(es["r0n"]),
                         to(es["vn"])),
        "T1inter": inter("T1inter"),
        "T1inter_Stanton": inter("T1inter_Stanton"),
        "T1eq": inter("T1eq"),
        "tsupdate": tsup(False, False),
        "tsupdate_es": tsup(True, False),
        "tsupdate_L1": tsup(False, True),
        "L1inter": inter("L1inter"),
        "L1inter_noE": lambda m, er, to, ts, ls, fsp, es:
            m.L1inter(er, ts, fsp, E_term=False),
        "L1inter_Stanton": inter("L1inter_Stanton"),
        "L1eq": lambda m, er, to, ts, ls, fsp, es: m.L1eq(er, ts, ls, fsp),
        "L1eq_noE": lambda m, er, to, ts, ls, fsp, es:
            m.L1eq(er, ts, ls, fsp, E_term=False),
        "lsupdate": lsup(False, False),
        "lsupdate_es": lsup(True, False),
        "lsupdate_L1": lsup(False, True),
    }


GS_CASES = _gs_cases()


@pytest.mark.parametrize("name", sorted(GS_CASES))
def test_gs_function_matches_jax(kernel_inputs, name):
    k = kernel_inputs
    fn = GS_CASES[name]
    ref = fn(jccs, k["er"], jnp.asarray, jnp.asarray(k["ts"]),
             jnp.asarray(k["ls"]), jnp.asarray(k["fsp"]), k["es"])
    out = fn(tccs, k["er_t"], _t, _t(k["ts"]), _t(k["ls"]), _t(k["fsp"]),
             k["es"])
    ref, out = _flat(ref), _flat(out)
    assert ref.shape == out.shape and np.abs(ref).max() > 0
    assert np.abs(out - ref).max() < 1e-12


def test_gccs_wraps_the_gs_functions(kernel_inputs):
    k = kernel_inputs
    cc = tccs.Gccs(k["er_t"])
    ts, ls, fsp = _t(k["ts"]), _t(k["ls"]), _t(k["fsp"])
    assert (cc.nocc, cc.nvir) == (k["er"].nocc, k["er"].nvir)
    assert torch.equal(cc.gamma(ts, ls), tccs.gamma_CCS(ts, ls))
    assert torch.equal(cc.gamma_unsym(ts, ls), tccs.gamma_unsym_CCS(ts, ls))
    assert torch.equal(cc.T1eq(ts, fsp), tccs.T1eq(k["er_t"], ts, fsp))
    assert torch.equal(cc.L1eq(ts, ls, fsp),
                       tccs.L1eq(k["er_t"], ts, ls, fsp))
    assert torch.equal(cc.tsupdate(ts, cc.T1inter(ts, fsp)),
                       tccs.tsupdate(k["er_t"], ts,
                                     tccs.T1inter(k["er_t"], ts, fsp)))
    assert torch.equal(cc.lsupdate(ts, ls, cc.L1inter(ts, fsp)),
                       tccs.lsupdate(k["er_t"], ts, ls,
                                     tccs.L1inter(k["er_t"], ts, fsp)))
    # the ES half is there as well (tests/test_torch_es_eqs.py)
    assert hasattr(cc, "R1inter") and hasattr(cc, "es_L1inter")


# ---------------------------------------------------------------------------
# ccs_gradient (tests/test_newton.py mirrored, and against JAX)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h2_pair():
    """The H2/6-31G ECW objects of both packages with the same HF target."""
    ref = JaxECW("h2", "6-31g")
    ref.Build_GS_exp("mat", "HF", field=[0.03, 0.0, 0.0])
    with jax_gauge(ref):
        ecw = ECW("h2", "6-31g", **F64)
    ecw.Build_GS_exp("mat", "HF", field=[0.03, 0.0, 0.0])
    return ref, ecw


def _grad_state(pair, L, seed=7, scale=0.01, model=1):
    """(JAX gradient, torch gradient, ts, ls, fsp) at seeded amplitudes,
    with a consistent fsp at the linearization point."""
    ref, ecw = pair
    rng = np.random.default_rng(seed)
    no, nv = ecw.nocc, ecw.nvir
    ts = scale * rng.standard_normal((no, nv))
    ls = scale * rng.standard_normal((no, nv))
    vx = Exp(L, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    jvx = JaxExp(L, ref.exp_data, ref.mol, ref.mo_coeff)
    pots = (jvx, vx) if model in (2, 3) else (None, None)
    jgrad = jccs.ccs_gradient(ref._eris_alt(), Vexp_model=model,
                              exp_pot=pots[0])
    tgrad = tccs.ccs_gradient(ecw.eris, Vexp_model=model, exp_pot=pots[1])
    rdm1 = tccs.gamma_CCS(_t(ts), _t(ls)).numpy()
    vx.Vexp_update(rdm1, rdm1, (0, 0), L=L)
    fsp = ecw.fock - np.real(np.asarray(vx.Vexp[0, 0], dtype=float))
    return jgrad, tgrad, ts, ls, fsp, vx


@pytest.mark.parametrize("model", [1, 2])
def test_jacobian_matches_jax_and_finite_differences(h2_pair, model):
    L = 0.1
    jgrad, tgrad, ts, ls, fsp, _ = _grad_state(h2_pair, L, model=model)
    Jj, Rj = jgrad.Jacobian(jnp.asarray(ts), jnp.asarray(ls),
                            jnp.asarray(fsp), L)
    J, R = tgrad.Jacobian(ts, ls, fsp, L)
    assert np.abs(J.numpy() - np.asarray(Jj)).max() < 1e-9
    assert np.abs(R.numpy() - np.asarray(Rj)).max() < 1e-12
    n = ts.size
    gamma0 = tccs.gamma_CCS(_t(ts), _t(ls))
    x0 = np.concatenate([ts.ravel(), ls.ravel()])

    def stacked(x):
        T1, L1 = tgrad._residuals(_t(x[:n].reshape(ts.shape)),
                                  _t(x[n:].reshape(ls.shape)), _t(fsp),
                                  gamma0, L)
        return np.concatenate([T1.numpy().ravel(), L1.numpy().ravel()])

    h = 1e-6
    J_fd = np.zeros((2 * n, 2 * n))
    for j in range(2 * n):
        e = np.zeros(2 * n)
        e[j] = h
        J_fd[:, j] = (stacked(x0 + e) - stacked(x0 - e)) / (2 * h)
    assert np.abs(J.numpy() - J_fd).max() < 5e-7


@pytest.mark.parametrize("model", [1, 2])
def test_jacobian_chunks_equal_one_pass(h2_pair, model, monkeypatch):
    """The Jacobian's columns in chunks of the vmapped jvp (ROADMAP A.9),
    the chunk set by the memory budget (jac_chunk), equal all of them in
    one pass and torch.func.jacfwd, to 1e-12."""
    L = 0.1
    _, tgrad, ts, ls, fsp, _ = _grad_state(h2_pair, L, model=model)
    n2 = 2 * ts.size
    per_column = (tccs.JAC_COLUMN_BLOCKS * tgrad.nocc * tgrad.nvir ** 3
                  * 8)
    x = torch.zeros(n2, dtype=torch.float64)

    def jacobian(chunk):
        # the budget that holds `chunk` columns and not one more
        monkeypatch.setattr(tccs, "JAC_CPU_BYTES", chunk * per_column + 1)
        assert tccs.jac_chunk(tgrad.nocc, tgrad.nvir, x) == chunk
        return tgrad.Jacobian(ts, ls, fsp, L)

    J_all, R_all = jacobian(n2)
    for chunk in (1, 5, n2 - 1):
        J, R = jacobian(chunk)
        assert (J - J_all).abs().max() < 1e-12
        assert torch.equal(R, R_all)
    ts_t, ls_t = _t(ts), _t(ls)
    gamma0 = tccs.gamma_CCS(ts_t, ls_t)

    def stacked(x):
        T1, L1 = tgrad._residuals(x[:n2 // 2].reshape(ts.shape),
                                  x[n2 // 2:].reshape(ls.shape), _t(fsp),
                                  gamma0, L)
        return torch.cat([T1.reshape(-1), L1.reshape(-1)])

    J_fwd = torch.func.jacfwd(stacked)(torch.cat([ts_t.reshape(-1),
                                                  ls_t.reshape(-1)]))
    assert (J_fwd - J_all).abs().max() < 1e-12
    # no budget: one column at a time; more than all: all of them
    monkeypatch.setattr(tccs, "JAC_CPU_BYTES", 0)
    assert tccs.jac_chunk(tgrad.nocc, tgrad.nvir, x) == 1
    monkeypatch.setattr(tccs, "JAC_CPU_BYTES", 10 * n2 * per_column)
    assert tccs.jac_chunk(tgrad.nocc, tgrad.nvir, x) == n2


def test_newton_and_descent_steps_match_jax(h2_pair):
    L = 0.1
    jgrad, tgrad, ts, ls, fsp, _ = _grad_state(h2_pair, L, scale=0.02)
    args = (jnp.asarray(ts), jnp.asarray(ls), jnp.asarray(fsp), L)
    for jout, tout in ((jgrad.Newton(*args), tgrad.Newton(ts, ls, fsp, L)),
                       (jgrad.Gradient_Descent(0.05, *args),
                        tgrad.Gradient_Descent(0.05, ts, ls, fsp, L))):
        for a, b in zip(jout, tout):
            assert np.abs(b.numpy() - np.asarray(a)).max() < 1e-9


def test_newton_quadratic_decay(h2_pair):
    """|R| along the Newton iteration, with fsp refreshed from Vexp at each
    rdm1 as the solver does, falls at least quadratically to solver
    precision."""
    L = 0.1
    _, grad, ts, ls, fsp, vx = _grad_state(h2_pair, L, scale=0.02)
    ecw = h2_pair[1]
    ts, ls = _t(ts), _t(ls)
    norms = []
    for _ in range(8):
        rdm1 = tccs.gamma_CCS(ts, ls).numpy()
        vx.Vexp_update(rdm1, rdm1, (0, 0), L=L)
        fsp = ecw.fock - np.real(np.asarray(vx.Vexp[0, 0], dtype=float))
        norms.append(float(torch.linalg.norm(
            grad.Jacobian(ts, ls, fsp, L)[1])))
        ts, ls = grad.Newton(ts, ls, fsp, L)
    assert norms[-1] < 1e-10
    for a, b in zip(norms[2:6], norms[3:7]):
        if a > 1e-13:
            assert b < max(50.0 * a * a, 1e-14)


def test_newton_fixed_point_matches_scf(h2_pair):
    ecw = h2_pair[1]
    r_scf = ecw.CCS_GS([0.1], method="scf", conv_thres=1e-10, maxiter=200)
    r_newton = ecw.CCS_GS([0.1], method="newton", conv_thres=1e-10,
                          maxiter=30)
    assert "onverg" in r_newton[0]
    assert abs(r_newton[1][-1] - r_scf[1][-1]) < 1e-8
    assert np.abs(r_newton[4] - r_scf[4]).max() < 1e-6
    assert len(r_newton[1]) <= len(r_scf[1])


def test_gradient_descent_decreases_residual(h2_pair):
    L = 0.1
    _, grad, ts, ls, fsp, _ = _grad_state(h2_pair, L, scale=0.02, seed=3)
    rnorm = lambda t, l: float(torch.linalg.norm(
        grad.Jacobian(t, l, fsp, L)[1]))
    r_prev = rnorm(ts, ls)
    for _ in range(5):
        ts, ls = grad.Gradient_Descent(0.05, ts, ls, fsp, L)
        r = rnorm(ts, ls)
        assert r < r_prev
        r_prev = r


# ---------------------------------------------------------------------------
# Solver_CCS and ECW.CCS_GS
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h2o_pair():
    ref = JaxECW("h2o", "6-31g")
    ref.Build_GS_exp("mat", "HF", field=FIELD)
    with jax_gauge(ref):
        ecw = ECW("h2o", "6-31g", **F64)
    ecw.Build_GS_exp("mat", "HF", field=FIELD)
    return ref, ecw


@pytest.mark.parametrize("kw", [
    dict(), dict(diis="tl"), dict(diis="rdm1", thres=1e-5), dict(alpha=1e-3),
    dict(conv="Ep"), dict(conv="l", diis="tl")],
    ids=["plain", "diis_tl", "diis_rdm1", "l1", "conv_Ep", "conv_l"])
def test_solver_ccs_scf_matches_jax_device_solver(h2o_pair, kw):
    """Solver_CCS.SCF against the JAX SCF_device: the same text (so the
    same iterations), histories and amplitudes.  (The rdm1 DIIS stops at
    1e-5: below that its trajectory amplifies roundoff.)"""
    ref, ecw = h2o_pair
    kw = dict(kw)
    alpha = kw.pop("alpha", None)
    conv = kw.pop("conv", "tl")
    thres = kw.pop("thres", 1e-8)
    jsolver = JaxSolverCCS(
        jccs.Gccs(ref._eris_alt()),
        JaxExp(0.5, ref.exp_data, ref.mol, ref.mo_coeff,
               Ek_exp_GS=ref.Ek_exp_GS),
        conv=conv, conv_thres=thres, maxiter=80, **kw)
    solver = Solver_CCS(
        tccs.Gccs(ecw.eris),
        Exp(0.5, ecw.exp_data, ecw.mol, ecw.mo_coeff,
            Ek_exp_GS=ecw.Ek_exp_GS),
        conv=conv, conv_thres=thres, maxiter=80, **kw)
    r_ref = jsolver.SCF_device(0.5, alpha=alpha)
    res = solver.SCF(0.5, alpha=alpha)
    assert res[0] == r_ref[0] and "Convergence reached" in res[0]
    assert solver.last_solve["iterations"] == len(r_ref[1])
    for i in (1, 2, 3):
        np.testing.assert_allclose(res[i], np.asarray(r_ref[i]), rtol=0,
                                   atol=1e-10)
    assert np.abs(res[4] - np.asarray(r_ref[4])).max() < 1e-10
    for a, b in zip(res[5], r_ref[5]):
        assert np.abs(a - np.asarray(b)).max() < 1e-10


def test_solver_ccs_refuses_the_unported_host_loop(h2o_pair):
    ecw = h2o_pair[1]
    solver = Solver_CCS(tccs.Gccs(ecw.eris),
                        Exp(0.5, ecw.exp_data, ecw.mol, ecw.mo_coeff))
    with pytest.raises(NotImplementedError, match="store_ite"):
        solver.SCF(0.5, store_ite=True)
    with pytest.raises(ValueError, match="ccs_gradient"):
        solver.Gradient(0.5)
    with pytest.raises(ValueError, match="convergence parameter"):
        Solver_CCS(tccs.Gccs(ecw.eris), solver.myVexp, conv="x")


def test_solver_ccs_warns_on_sorted_eris(h2o_pair):
    """The layout guard: spin-sorted ERIs under the alternating CCS
    kernels would give silently wrong physics."""
    from ecw_cc_torch.models.eris import sorted_from_host
    from ecw_cc_torch.ops.ladder import spin_sort_perm

    ecw = h2o_pair[1]
    er, _ = sorted_from_host(ecw.eris_host,
                             spin_sort_perm(ecw.mf.orbspin, ecw.nocc), **F64)
    vx = Exp(0.5, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    with pytest.warns(RuntimeWarning, match="spin-SORTED"):
        Solver_CCS(tccs.Gccs(er), vx)


def test_doctest_anchors(h2o_pair):
    ecw = h2o_pair[1]
    assert abs(ecw.EHF - (-75.9839)) < 1e-3
    assert abs(ecw.Eexp_GS - (-75.9860)) < 1e-3
    res = ecw.CCS_GS(np.linspace(0.5, 0.5, 1))
    assert "Convergence reached" in res[0]
    assert "after 8 iteration" in res[0]
    assert abs(res[1][-1] + ecw.EHF - (-75.9840)) < 5e-4


@pytest.mark.parametrize("kw", [
    dict(method="scf", diis="tl"), dict(method="newton", maxiter=30),
    dict(method="descend", beta=0.01, maxiter=3),
    dict(method="L1_grad", alpha=1e-3, beta=0.5, maxiter=60)],
    ids=["scf_diis", "newton", "descend", "L1_grad"])
def test_ccs_gs_sweep_matches_jax_ecw(h2o_pair, kw):
    ref, ecw = h2o_pair
    r_ref = ref.CCS_GS([0.2, 0.5], **kw)
    res = ecw.CCS_GS([0.2, 0.5], **kw)
    assert res[0] == r_ref[0]
    np.testing.assert_allclose(res[1], np.asarray(r_ref[1]), rtol=0,
                               atol=1e-10)
    assert np.abs(res[4] - np.asarray(r_ref[4])).max() < 1e-9
    np.testing.assert_allclose(ecw.Ep_lamb, ref.Ep_lamb, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ecw.Delta_lamb, ref.Delta_lamb, rtol=0,
                               atol=1e-9)


def test_l1_regularization_sparsifies(h2o_pair):
    ecw = h2o_pair[1]
    res_plain = ecw.CCS_GS([0.2], conv_thres=1e-6, maxiter=120)
    res_l1 = ecw.CCS_GS([0.2], alpha=0.02, conv_thres=1e-6, maxiter=120)
    assert (np.sum(np.abs(res_l1[5][0]) > 1e-10)
            < np.sum(np.abs(res_plain[5][0]) > 1e-10))


def test_l1_grad_solver(h2_pair):
    ecw = h2_pair[1]
    res = ecw.CCS_GS([0.1], method="L1_grad", alpha=0.001, beta=0.5,
                     conv_thres=1e-7, maxiter=300)
    assert len(res[1]) > 1
    assert np.all(np.isfinite(res[5][0]))
    with pytest.raises(ValueError, match="beta"):
        ecw.CCS_GS([0.1], method="L1_grad", alpha=0.001)
    with pytest.raises(ValueError, match="method not recognized"):
        ecw.CCS_GS([0.1], method="bfgs")


def test_ccs_gs_outputs_and_checkpoints(tmp_path):
    ecw = ECW("h2", "sto-3g", out_dir=str(tmp_path / "out"), **F64)
    ecw.Build_GS_exp("mat", "HF", field=[0.02, 0.0, 0.0])
    ck = str(tmp_path / "ckpt")
    first = ecw.CCS_GS([0.1], nbr_cube_file=1, maxiter=50, checkpoint_dir=ck)
    files = {f.name for f in (tmp_path / "out").iterdir()}
    assert {"HF.cube", "target_GS.cube", "output.txt"} <= files
    assert any(f.startswith("L0.10") for f in files)
    again = ecw.CCS_GS([0.1], nbr_cube_file=1, maxiter=50, checkpoint_dir=ck,
                       resume=True)
    assert len(again[1]) <= len(first[1])


# ---------------------------------------------------------------------------
# the JSON runner
# ---------------------------------------------------------------------------

def _spec(tmp_path, solver, **run):
    spec = {"molecule": "h2o", "basis": "6-31g", "out_dir": str(tmp_path),
            "device": "cpu", "dtype": "float64",
            "target": {"prop": "mat", "posthf": "HF", "field": FIELD},
            "run": {"solver": solver, "Larray": [0.5, 0.5, 1], **run}}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    return json.loads(path.read_text())


def test_cli_runner_ccs_gs(tmp_path):
    """The doctest-anchor experiment from a JSON spec:
    Ep_total = -75.98424 = EHF (-75.98395) + (-2.9451e-4)."""
    result = run_spec(_spec(tmp_path, "CCS_GS"))
    assert result[0].startswith("Convergence reached")
    assert abs(float(np.ravel(result[1])[-1]) - (-2.9451e-4)) < 2e-6
    assert (tmp_path / "output.txt").exists()


def test_cli_runner_ccsd_gs(tmp_path):
    spec = _spec(tmp_path, "CCSD_GS", diis="tl")
    spec["config"] = {"ladder_mode": "dense"}
    result = run_spec(spec)
    assert result[0].startswith("Convergence reached")
    assert abs(float(result[1][-1]) - (-0.1342177396)) < 1e-8


def test_cli_runner_names_what_is_not_ported(tmp_path, capsys):
    from ecw_cc_torch.__main__ import main

    spec = _spec(tmp_path, "CCS_ES")
    with pytest.raises(NotImplementedError, match="GS solver"):
        run_spec(spec)                      # CCS_ES without ES targets
    spec = _spec(tmp_path, "CCSD_GS", diis="tl", conv_thres=1e-8)
    spec["run"]["Larray"] = [0.0, 0.5, 2]
    sweep = run_spec(spec)
    spec["run"]["mode"] = "parallel"       # the batched sweep (A.13)
    parallel = run_spec(spec)
    assert parallel[0].startswith("Convergence reached")
    assert abs(float(parallel[1][-1]) - float(sweep[1][-1])) < 1e-9
    np.testing.assert_allclose(parallel[4], sweep[4], rtol=0, atol=1e-7)
    # any other mode runs the warm sweep, as the JAX ECW does (JAX
    # models/ecw.py:487)
    spec["run"]["mode"] = "batched"
    other = run_spec(spec)
    assert other[0] == sweep[0]
    np.testing.assert_array_equal(np.asarray(other[1]), np.asarray(sweep[1]))
    np.testing.assert_array_equal(other[4], sweep[4])
    spec = _spec(tmp_path, "CCS_GS")
    spec["es_targets"] = {"fci": 1}
    with pytest.raises(ValueError, match="unknown es_targets"):
        run_spec(spec)
    spec = _spec(tmp_path, "FCI")
    with pytest.raises(ValueError, match="unknown solver"):
        run_spec(spec)
    assert main([]) == 2
    assert "usage" in capsys.readouterr().err
