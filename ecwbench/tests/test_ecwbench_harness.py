"""The harness end to end on the CPU at C2H2/STO-3G, with its look for a
card skipped: a cell made only of added files (a configuration, a traffic
mix, its limits and a new per-layer metric) runs, reports its metrics and
comes out correct against the reference; and with the timed path broken
underneath, in each way the cell can break, `correct` comes out false."""

import json
import os
import shutil
import time
import types

import pytest

from ecwbench import harness
from ecwbench.spec import ROOT, Spec

LIMITS = {"sweep_short.c2h2_sto-3g": {
    "eexp_gap": 1e-6, "target_gap": 1e-5, "ep_gap": 1e-6, "delta_gap": 1e-6,
    "rdm1_gap": 1e-5, "unconverged": 0},
    "target_once.c2h2_sto-3g": {"eexp_gap": 1e-6, "target_gap": 1e-5}}


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """A checkout whose benchmark gains two cells from added files only."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(os.path.join(ROOT, "ecwbench"), root / "ecwbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    d = root / "ecwbench"
    cfg = json.load(open(d / "configs" / "c2h2_6-31pgss.json"))
    cfg.update(name="c2h2_sto-3g", basis="sto-3g", nao=12, nvir=10,
               basis_file="ecwbench/reference/basis/sto-3g.json")
    (d / "configs" / "c2h2_sto-3g.json").write_text(json.dumps(cfg))
    sweep = json.load(open(d / "traffic" / "sweep.json"))
    sweep.update(lambdas={"start": 0.0, "stop": 0.7, "num": 3},
                 warmup_jobs=0, traced_jobs=1)
    (d / "traffic" / "sweep_short.json").write_text(json.dumps(sweep))
    target = json.load(open(d / "traffic" / "target.json"))
    target.update(warmup_jobs=0)
    (d / "traffic" / "target_once.json").write_text(json.dumps(target))
    (d / "metrics" / "lambdas.sweep.py").write_text(
        "def read(ctx):\n"
        "    recs = ctx.records('sweep')\n"
        "    return len(recs[0]['solve_log']) if recs else None\n")
    b = json.load(open(root / "BENCHMARK.json"))
    b["configs"].append({"name": "c2h2_sto-3g", "source": "tests",
                         "file": "ecwbench/configs/c2h2_sto-3g.json",
                         "reduced": [], "why": "tests"})
    for w, t in (("sweep_short.c2h2_sto-3g", "sweep_short"),
                 ("target_once.c2h2_sto-3g", "target_once")):
        b["workloads"].append({"name": w, "config": "c2h2_sto-3g",
                               "traffic": t, "chips": 1, "why": "tests"})
        (d / "limits" / (w + ".json")).write_text(json.dumps(LIMITS[w]))
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] == "sweep_ms" or m["name"].endswith(".sweep"):
            m["workloads"].append("sweep_short.c2h2_sto-3g")
        if m["name"] == "target_ms" or m["name"].endswith(".target"):
            m["workloads"].append("target_once.c2h2_sto-3g")
    b["per_layer"].append({"name": "lambdas.sweep", "unit": "solves",
                           "better": "lower", "source": "program_counter",
                           "layer": "driver", "moves": "sweep_ms",
                           "workloads": ["sweep_short.c2h2_sto-3g"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return Spec(str(root))


def run(sp, workload, trace=0, seed=2**31 + 77):
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=0.0,
                                 trace=trace)
    return harness.run_cell(sp, args, time.perf_counter(), device="cpu")


def test_sweep_cell_of_added_files(added):
    r = run(added, "sweep_short.c2h2_sto-3g")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 1
    assert set(r["metrics"]) == {"sweep_ms", "setup_s"}
    assert list(r)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())


def test_traced_run_reports_the_added_metric(added):
    r = run(added, "sweep_short.c2h2_sto-3g", trace=1)
    assert r["correct"]
    assert r["metrics"]["lambdas.sweep"]["value"] == 3
    assert r["metrics"]["iters.sweep"]["value"] > 0
    assert "driver_ms.sweep" in r["metrics"]
    # no device on the CPU: the device readers find nothing to read
    assert "ladder_roofline.sweep" not in r["metrics"]
    assert "idle_pct.sweep" not in r["metrics"]


def test_target_cell_of_added_files(added):
    r = run(added, "target_once.c2h2_sto-3g")
    assert r["correct"] and set(r["metrics"]) == {"target_ms", "setup_s"}


def unchanged_step(monkeypatch):
    """A CCSD step that returns its amplitudes unchanged."""
    from ecw_cc_torch.solvers import gs

    make = gs.Solver_CCSD._make_step

    def broken(self, su, mode, alpha):
        step = make(self, su, mode, alpha)

        def same(amps, ring_t, conv, Lw):
            out = step(amps, ring_t, conv, Lw)
            return (amps, out[1], conv) + tuple(out[3:])
        return same
    monkeypatch.setattr(gs.Solver_CCSD, "_make_step", broken)


def half_the_lambdas(monkeypatch):
    """A sweep that solves every other lambda and hands the solve before
    it out for the one it left out."""
    from ecw_cc_torch.models.ecw import ECW

    sweep = ECW.CCSD_GS

    def broken(self, Larray, **kw):
        res = sweep(self, list(Larray)[::2], **kw)
        for name in ("Ep_lamb", "Delta_lamb", "solve_log"):
            kept = getattr(self, name)
            setattr(self, name, [kept[i // 2] for i in range(len(Larray))])
        return res
    monkeypatch.setattr(ECW, "CCSD_GS", broken)


def altered_energy(monkeypatch):
    """Each solve's energy altered by 1e-5 Ha where the solver makes it."""
    from ecw_cc_torch.solvers import gs

    scf = gs.Solver_CCSD.SCF

    def broken(self, *a, **kw):
        text, Ep, *rest = scf(self, *a, **kw)
        return (text, Ep + 1e-5, *rest)
    monkeypatch.setattr(gs.Solver_CCSD, "SCF", broken)


def unchanged_ccsd(monkeypatch):
    """The target's CCSD step returns its amplitudes unchanged."""
    from ecw_cc_torch.ops import ccsd_t

    step = ccsd_t._ccsd_diis_step

    def broken(eris, vvvv_op, t1, t2, dstate, sect=None):
        _, _, dstate, e = step(eris, vvvv_op, t1, t2, dstate, sect=sect)
        return t1, t2, dstate, e
    monkeypatch.setattr(ccsd_t, "_ccsd_diis_step", broken)


def altered_target(monkeypatch):
    """The target's (T) energy altered by 1e-5 Ha where it is made."""
    from ecw_cc_torch.models import gamma_exp

    run_t = gamma_exp._run_gccsd_t_rdm1

    def broken(built, log=None):
        e_cc, e_t, rdm1 = run_t(built, log=log)
        return e_cc, e_t + 1e-5, rdm1
    monkeypatch.setattr(gamma_exp, "_run_gccsd_t_rdm1", broken)


@pytest.mark.parametrize("workload,fault", [
    ("sweep_short.c2h2_sto-3g", unchanged_step),
    ("sweep_short.c2h2_sto-3g", half_the_lambdas),
    ("sweep_short.c2h2_sto-3g", altered_energy),
    ("target_once.c2h2_sto-3g", unchanged_ccsd),
    ("target_once.c2h2_sto-3g", altered_target),
])
def test_a_broken_timed_path_is_not_correct(added, monkeypatch, workload,
                                            fault):
    fault(monkeypatch)
    r = run(added, workload)
    assert r["correct"] is False
    assert r["failed"] == r["attempted"] == 1
