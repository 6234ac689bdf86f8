"""The JSON runner of the port with excited-state specs: `python -m
ecw_cc_torch spec.json` in a process of its own, and run_spec against the
JAX package's runner."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from ecw_cc_tpu.__main__ import run_spec as jax_run_spec
from ecw_cc_torch.__main__ import run_spec
from ecw_cc_tpu.models.molecule import Molecule as JMolecule
from ecw_cc_tpu.models.scf import RHF as JRHF
from gauge import jax_gauge

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spec(out_dir, **run):
    return {"molecule": "h2o", "basis": "6-31g", "out_dir": str(out_dir),
            "device": "cpu", "dtype": "float64",
            "target": {"prop": "mat", "posthf": "HF",
                       "field": [0.02, 0.0, 0.0]},
            "es_targets": {"input": [[["trdip", [0.54, 0.0, 0.0]]]]},
            "run": {"solver": "CCS_ES", "L": 0.15, "diis": "all",
                    "conv": "rl", "print_ite": False, **run}}


def test_module_runs_a_ccs_es_spec(tmp_path):
    """`python -m ecw_cc_torch spec.json` with es_targets and the CCS_ES
    solver on the CPU: exit 0, the convergence line on stdout, the cube
    files of the set-up in out_dir."""
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(_spec(tmp_path / "out", method="device")))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "ecw_cc_torch", str(path)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "*** ES data stored ***" in proc.stdout
    assert "Convergence reached for lambda=" in proc.stdout
    assert (tmp_path / "out" / "HF.cube").exists()
    assert (tmp_path / "out" / "output.txt").exists()


def test_run_spec_ccs_es_matches_jax_runner(tmp_path):
    """The same spec through both runners: a GS 'mat' target beside the
    transition dipole, device loop.  The port's ECW takes the orbital
    signs of the JAX package's SCF (tests/gauge.py)."""
    jrhf = JRHF(JMolecule("h2o", "6-31g"), conv_tol=1e-11)
    jrhf.kernel()
    with jax_gauge(jrhf):
        out_t = run_spec(_spec(tmp_path / "t", method="device"))
    spec = _spec(tmp_path / "j", method="device")
    del spec["device"]
    out_j = jax_run_spec(spec)
    assert out_t[0] == out_j[0] and "Convergence reached" in out_t[0]
    assert np.abs(np.asarray(out_j[3]) - out_t[3]).max() < 1e-9
    assert np.abs(np.asarray(out_j[2]) - out_t[2]).max() < 1e-9


def test_run_spec_mom_targets_and_sweep(tmp_path):
    """es_targets {"mom": ...} reaches Build_ES_exp_MOM, and an L_loop
    sweep writes the ES results table."""
    spec = _spec(tmp_path, method="device", L_loop=True)
    spec["run"]["L"] = [0.05, 0.1]
    assert run_spec(spec) is None
    text = (tmp_path / "output.txt").read_text()
    assert "Er_1" in text and text.count("\n") >= 5
    mom = {"molecule": "h2", "basis": "6-31g", "device": "cpu",
           "dtype": "float64", "es_targets": {"mom": [1, 0]},
           "run": {"solver": "CCS_ES", "L": 0.0, "maxiter": 1,
                   "print_ite": False}}
    out = run_spec(mom)
    assert out[2].shape == (2, 2)               # one 'trmat' state was built


def test_run_spec_eom_targets(tmp_path):
    """es_targets {"eom": 1, "eom_prop": "trdip"} reaches
    Build_ES_exp_EOM on the CPU (H2O/STO-3G f64): one EOM-EE root as a
    transition-dipole target, then the device CCS_ES loop converges to a
    finite energy; the root equals the JAX runner's ECW's."""
    from ecw_cc_tpu import ECW as JaxECW

    spec = {"molecule": "h2o", "basis": "sto-3g", "device": "cpu",
            "dtype": "float64", "out_dir": str(tmp_path),
            "es_targets": {"eom": 1, "eom_prop": "trdip"},
            "run": {"solver": "CCS_ES", "L": 0.05, "method": "device",
                    "diis": "all", "conv": "rl", "maxiter": 80,
                    "print_ite": False}}
    out = run_spec(spec)
    assert "Convergence reached" in out[0], out[0]
    assert np.all(np.isfinite(out[3])) and out[3].shape == (2, 2)
    j = JaxECW("h2o", "sto-3g")
    j.Build_ES_exp_EOM(1, prop="trdip")
    assert j.exp_data[1][0][0] == "trdip"
    assert abs(j.Eexp_ES[0][0] - 0.3968253886860486) < 1e-9
