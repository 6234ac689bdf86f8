"""The port's ECW builds the JAX driver's f32 layout (JAX models/ecw.py:
74-112, 308-323): where the ladder is packed at f32 (nvir >= 48 under
'auto'; here H2O/6-31G at ladder_mode='packed') and config.spin_sorted
holds, spin-sorted device ERIs with a SectoredVVVV and mo_perm, the
sectored CCSD route, an alternating fock and an alternating view for the
CCS and ES solvers; with spin_sorted=False the alternating packed route.

Held here, f32 on the CPU, against the JAX ECW at f32 on its own sorted
build (JAX config dtype='float32', ladder_mode='packed', spin_sorted=True)
at PERF.md section 2's f32 limits (1e-5 Ha, +-1 iteration): mo_perm, fock
to 1e-6 and the CCSD_GS solve; CCS_GS, the CCS_ES trdip flow of
Build_ES_exp_input, a tl1ini=1 start and a target that couples the spins
(the dense_sorted route), each also against the port's alternating ECW.
On the sorted ECW against the alternating one: store_ite, refine=True (to
the f64 sweep, 1e-8 Ha), checkpoints in the alternating convention and a
resume from them, and mode='parallel'.
"""

import contextlib
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import ecw_cc_torch
from ecw_cc_torch.ops.ladder import PackedVVVV, SectoredVVVV
from ecw_cc_torch.utils import checkpoint
from gauge import jax_gauge

torch.set_num_threads(1)

FIELD = [0.05, 0.01, 0.0]
SORTED_WARNING = ".*spin-SORTED.*"


@contextlib.contextmanager
def port_config(**kw):
    saved = dataclasses.asdict(ecw_cc_torch.get_config())
    ecw_cc_torch.set_config(**kw)
    try:
        yield
    finally:
        ecw_cc_torch.set_config(**saved)


def _ecw(spin_sorted, dtype=torch.float32, target=True, ref=None):
    """H2O/6-31G ECW on the CPU with the ladder packed (as 'auto' does at
    nvir >= 48), sorted or not, with the HF 'mat' target in a field; in
    the orbital gauge of the JAX ECW `ref` when one is given."""
    gauge = jax_gauge(ref) if ref is not None else contextlib.nullcontext()
    with gauge, port_config(ladder_mode="packed", spin_sorted=spin_sorted):
        ecw = ecw_cc_torch.ECW("h2o", "6-31g", device="cpu", dtype=dtype)
    if target:
        ecw.Build_GS_exp("mat", "HF", field=FIELD)
    return ecw


def _jax_ecw(target=True):
    """The JAX ECW at f32 on its sorted build under the same config (set
    through the JAX package's set_config; conftest restores it), with the
    same target."""
    from ecw_cc_tpu import config as jcfg
    from ecw_cc_tpu.models.ecw import ECW as JECW

    jcfg.set_config(dtype="float32", ladder_mode="packed", spin_sorted=True)
    ref = JECW("h2o", "6-31g")
    assert ref.mo_perm is not None
    if target:
        ref.Build_GS_exp("mat", "HF", field=FIELD)
    return ref


def _iterations(text):
    """The count in a solver's convergence text (None at max iterations)."""
    words = text.replace(",", " ").split()
    return int(words[words.index("after") + 1]) if "after" in words else None


@contextlib.contextmanager
def no_sorted_warning():
    """warn_if_sorted_layout's warning raised as an error inside."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=SORTED_WARNING)
        yield


def test_ecw_f32_layout_matches_the_jax_ecw():
    """The JAX ECW at f32 under the same config (set through the JAX
    package's set_config; conftest restores it) and the port's: equal
    mo_perm, a SectoredVVVV, fock to 1e-6, and CCSD_GS([0.5], diis='tl') on
    the sectored route within 1e-5 Ha and +-1 iteration."""
    from ecw_cc_tpu.ops.ladder import spin_sort_perm as j_perm

    ref = _jax_ecw()
    res_j = ref.CCSD_GS([0.5], diis="tl")
    ecw = _ecw(True, ref=ref)
    np.testing.assert_array_equal(ecw.mo_perm, ref.mo_perm)
    np.testing.assert_array_equal(
        ecw.mo_perm, j_perm(ecw.mf.orbspin, ecw.nocc))
    assert isinstance(ecw.vvvv_op, SectoredVVVV)
    np.testing.assert_allclose(ecw.fock, np.asarray(ref.fock), rtol=0,
                               atol=1e-6)
    res = ecw.CCSD_GS([0.5], diis="tl")
    assert ecw.solve_log[0]["route"] == "sectored"
    assert ecw.solve_log[0]["sym"]
    assert abs(len(res[1]) - len(res_j[1])) <= 1
    assert abs(float(res[1][-1]) - float(res_j[1][-1])) <= 1e-5
    # the public rdm1 is alternating, as the JAX one
    assert np.abs(res[4] - np.asarray(res_j[4])).max() < 1e-5


def test_ccs_gs_and_store_ite_on_the_alternating_view():
    """CCS_GS on the sorted ECW runs on its alternating view (no layout
    warning) and equals the JAX ECW's sweep on its sorted build (1e-5 Ha,
    +-1 iteration, rdm1 and amplitudes to 1e-5) and the alternating ECW's;
    the view is built once, on the ECW's device, and
    Solver_CCS.SCF(store_ite=True)'s per-iteration amplitudes on it are
    alternating."""
    from ecw_cc_torch.ops.ccs import Gccs
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.solvers.gs import Solver_CCS

    ref = _jax_ecw()
    res_j = ref.CCS_GS([0.0, 0.5], maxiter=80)
    out, rows = {}, {}
    for sort in (True, False):
        ecw = _ecw(sort, ref=ref)
        with no_sorted_warning():
            out[sort] = ecw.CCS_GS([0.0, 0.5], maxiter=80)
            alt = ecw._eris_alt()
            assert ecw._eris_alt() is alt
            solver = Solver_CCS(Gccs(alt), Exp(0.5, ecw.exp_data, ecw.mol,
                                               ecw.mo_coeff),
                                conv="tl", conv_thres=1e-6, maxiter=60)
            rows[sort] = solver.SCF(0.5, store_ite=True)
        assert (alt is ecw.eris) == (not sort)
        assert alt.fock.device == ecw.eris.fock.device
        np.testing.assert_allclose(np.diag(alt.fock.numpy()),
                                   np.diag(ecw.fock), rtol=0, atol=1e-6)
    res = out[True]
    assert "Convergence reached" in res[0]
    assert abs(len(res[1]) - len(res_j[1])) <= 1
    assert abs(float(res[1][-1]) - float(res_j[1][-1])) <= 1e-5
    assert np.abs(res[4] - np.asarray(res_j[4])).max() < 1e-5
    for a, b in zip(res[5], res_j[5]):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-5
    assert out[True][0] == out[False][0]
    assert abs(float(out[True][1][-1]) - float(out[False][1][-1])) <= 1e-5
    assert np.abs(out[True][4] - out[False][4]).max() < 1e-5
    # store_ite: (conv_text, Ep_it, Delta_it, conv_it, rdm1, ts_it, ls_it)
    assert len(rows[True][1]) == len(rows[False][1])
    for k in (5, 6):
        assert rows[True][k].shape == rows[False][k].shape
        assert np.abs(rows[True][k] - rows[False][k]).max() < 1e-5


def test_ccs_es_trdip_flow_on_the_alternating_view():
    """Build_ES_exp_input and CCS_ES (the doctest 'trdip' flow) on the
    sorted ECW: no layout warning, the Koopman guess from its alternating
    fock, and the solve of the JAX ECW on its sorted build (excitation and
    ground energies to 1e-5 Ha, +-1 iteration, rdm1 to 1e-5) and of the
    alternating ECW."""
    es_prop = [[["trdip", (0.54, 0.0, 0.0)]]]
    kw = dict(diis="all", conv="rl", print_ite=False)
    ref = _jax_ecw(target=False)
    ref.Build_ES_exp_input([[list(p) for p in st] for st in es_prop])
    r_j, res_j = ref.r_ini, ref.CCS_ES(0.15, **kw)
    out = {}
    for sort in (True, False):
        ecw = _ecw(sort, target=False, ref=ref)
        with no_sorted_warning():
            ecw.Build_ES_exp_input([[list(p) for p in st] for st in es_prop])
            out[sort] = (ecw.r_ini, ecw.CCS_ES(0.15, **kw))
    (r_s, res_s), (r_a, res_a) = out[True], out[False]
    for a, b in zip(r_s, r_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "Convergence reached" in res_j[0]
    assert abs(_iterations(res_s[0]) - _iterations(res_j[0])) <= 1
    assert np.abs(np.asarray(res_s[3]) - np.asarray(res_j[3])).max() <= 1e-5
    assert np.abs(res_s[4] - np.asarray(res_j[4])).max() < 1e-5
    for a, b in zip(r_s, r_a):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "Convergence reached" in res_s[0]
    assert res_s[0] == res_a[0]
    assert np.abs(np.asarray(res_s[3]) - np.asarray(res_a[3])).max() <= 1e-5
    assert np.abs(res_s[4] - res_a[4]).max() < 1e-5


def test_sorted_eris_handed_to_ccs_or_es_directly_still_warn():
    """The layout warning stays for a caller who hands the sorted ERIs
    themselves to Solver_CCS or Solver_ES."""
    from ecw_cc_torch.ops.ccs import Gccs
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.solvers.es import Solver_ES
    from ecw_cc_torch.solvers.gs import Solver_CCS

    ecw = _ecw(True)
    vexp = Exp(0.1, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    with pytest.warns(RuntimeWarning, match=SORTED_WARNING):
        Solver_CCS(Gccs(ecw.eris), vexp)
    ecw.Build_ES_exp_input([[["trdip", (0.54, 0.0, 0.0)]]])
    vexp = Exp(0.1, ecw.exp_data, ecw.mol, ecw.mo_coeff)
    with pytest.warns(RuntimeWarning, match=SORTED_WARNING):
        Solver_ES(Gccs(ecw.eris), vexp, rn_ini=ecw.r_ini)


@pytest.mark.parametrize("case", ["tl1ini", "spin_mixing"])
def test_sorted_sweep_equals_the_alternating_one(case):
    """The sorted ECW's CCSD_GS against the JAX ECW's on its sorted build
    and against the alternating ECW's: a tl1ini=1 start (read from the
    alternating fock), and a target that couples the spins, on which the
    structure gate sends the sorted solve to 'dense_sorted'; 1e-5 Ha and
    +-1 iteration, amplitudes alternating (to 1e-5)."""
    kw = dict(diis="tl")
    if case == "tl1ini":
        kw["tl1ini"] = 1
    ref = _jax_ecw()
    hf = np.diag(np.asarray(ref.mo_occ, dtype=np.float64))
    mix = np.random.default_rng(0).standard_normal(hf.shape) * 1e-3
    target = [[["mat", hf + mix + mix.T]]]
    if case == "spin_mixing":
        ref.exp_data = target
    res_j = ref.CCSD_GS([0.05, 0.5], **kw)
    res, routes = {}, {}
    for sort in (True, False):
        ecw = _ecw(sort, ref=ref)
        if case == "spin_mixing":
            ecw.exp_data = target
        res[sort] = ecw.CCSD_GS([0.05, 0.5], **kw)
        routes[sort] = {s["route"] for s in ecw.solve_log}
    assert routes[False] == {"packed"}
    assert routes[True] == ({"sectored"} if case == "tl1ini"
                            else {"dense_sorted"})
    assert abs(len(res[True][1]) - len(res_j[1])) <= 1
    assert abs(float(res[True][1][-1]) - float(res_j[1][-1])) <= 1e-5
    for a, b in zip(res[True][5], res_j[5]):
        assert np.abs(a - np.asarray(b)).max() < 1e-5
    assert abs(len(res[True][1]) - len(res[False][1])) <= 1
    assert abs(float(res[True][1][-1]) - float(res[False][1][-1])) <= 1e-5
    for a, b in zip(res[True][5], res[False][5]):
        assert np.abs(a - b).max() < 1e-5


def test_refine_reaches_the_f64_sweep():
    """refine=True on the sorted ECW: the sectored solve's amplitudes
    arrive alternating at the f64 polish on ECW.eris_f64, which lands on
    the f64 sweep to 1e-8 Ha with f64 amplitudes."""
    ecw = _ecw(True)
    res = ecw.CCSD_GS([0.1], conv_thres=1e-7, maxiter=60, diis="tl",
                      refine=True)
    assert ecw.solve_log[0]["route"] == "sectored"
    assert ecw._eris_host is None
    ref_ecw = _ecw(False, dtype=torch.float64)
    ref = ref_ecw.CCSD_GS([0.1], conv_thres=1e-7, maxiter=60, diis="tl")
    assert abs(float(res[1][-1]) - float(ref[1][-1])) < 1e-8
    assert res[5][0].dtype == np.float64
    for a, b in zip(res[5], ref[5]):
        assert np.abs(a - b).max() < 1e-6


def test_checkpoints_are_alternating_and_resume(tmp_path):
    """The sorted ECW saves public (alternating) amplitudes: equal to the
    alternating ECW's to 1e-5; resume=True puts them back through mo_perm
    and converges at once to the saved solve's energy."""
    ck = str(tmp_path / "ckpt")
    ecw = _ecw(True)
    first = ecw.CCSD_GS([0.25, 0.5], diis="tl", checkpoint_dir=ck)
    alt = _ecw(False).CCSD_GS([0.25, 0.5], diis="tl")
    saved = checkpoint.load_amplitudes(ck, 0.5)
    for k, b in zip(("ts", "ls", "td", "ld"), alt[5]):
        assert np.abs(saved[k] - b).max() < 1e-5
    again = ecw.CCSD_GS([0.5], diis="tl", checkpoint_dir=ck, resume=True)
    assert ecw.solve_log[0]["route"] == "sectored"
    assert len(again[1]) <= 3 < len(first[1])
    assert abs(float(again[1][-1]) - float(first[1][-1])) <= 1e-6


def test_parallel_lanes_on_the_sorted_ecw():
    """mode='parallel' on the sorted ECW: the sectored route for every
    lane, each within 1e-5 Ha and +-1 iteration of a sequential sorted
    solve at its lambda started as cold (one CCSD_GS call per lambda), and
    within 1e-5 Ha of the warm sequential sweep."""
    lambdas = [0.0, 0.25, 0.5]
    ecw = _ecw(True)
    ecw.CCSD_GS(lambdas, diis="tl", mode="parallel")
    par = list(ecw.Ep_lamb)
    lanes = ecw.solve_log
    assert {s["route"] for s in lanes} == {"sectored"}
    assert all(s["status"] == 1 and s["lanes"] == 3 for s in lanes)
    ecw.CCSD_GS(lambdas, diis="tl")
    np.testing.assert_allclose(par, ecw.Ep_lamb, rtol=0, atol=1e-5)
    for L, lane, ep in zip(lambdas, lanes, par):
        ecw.CCSD_GS([L], diis="tl")
        cold = ecw.solve_log[0]
        assert cold["route"] == "sectored"
        assert abs(cold["iterations"] - lane["iterations"]) <= 1
        assert abs(ecw.Ep_lamb[0] - ep) <= 1e-5


def test_spin_sorted_false_keeps_the_packed_route():
    """set_config(spin_sorted=False) at construction: the alternating
    layout with a PackedVVVV and no mo_perm; the sorted ECW's fock is the
    same alternating matrix."""
    alt, srt = _ecw(False, target=False), _ecw(True, target=False)
    assert alt.mo_perm is None and isinstance(alt.vvvv_op, PackedVVVV)
    assert srt.mo_perm is not None and isinstance(srt.vvvv_op,
                                                  SectoredVVVV)
    np.testing.assert_allclose(srt.fock, alt.fock, rtol=0, atol=1e-6)
    # below the packed threshold, and at f64, no layout is sorted
    with port_config(spin_sorted=True):
        dense = ecw_cc_torch.ECW("h2o", "6-31g", device="cpu",
                                 dtype=torch.float32)
    assert dense.mo_perm is None and dense.vvvv_op is None
    f64 = _ecw(True, dtype=torch.float64, target=False)
    assert f64.mo_perm is None


@pytest.mark.parametrize("spin_sorted", [True, False])
def test_runner_reports_the_route(spin_sorted, capsys):
    """`python -m ecw_cc_torch`'s run_spec takes spin_sorted in its config
    block and prints the route the CCSD_GS sweep ran."""
    from ecw_cc_torch.__main__ import run_spec

    with port_config():
        out = run_spec({"molecule": "h2o", "basis": "6-31g",
                        "device": "cpu", "dtype": "float32",
                        "config": {"ladder_mode": "packed",
                                   "spin_sorted": spin_sorted},
                        "target": {"prop": "mat", "posthf": "HF",
                                   "field": FIELD},
                        "run": {"solver": "CCSD_GS", "Larray": [0.5],
                                "diis": "tl"}})
    assert "Convergence reached" in out[0]
    route = "sectored" if spin_sorted else "packed"
    assert f"route: {route}\n" in capsys.readouterr().out
