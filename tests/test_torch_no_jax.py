"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

  - in a fresh interpreter where `import jax` and `import ecw_cc_tpu` fail,
    import ecw_cc_torch, build its solver on H2/6-31G through the ECW
    entry point at f64 (host ERIs) and f32 (device ERI build, dense and
    sectored routes), and run a solve on each, and a 'hybrid' bf16 solve
    with refine=True; build a CCSD(T) target, run the CCS ground state on
    it, the JSON runner, a coupled excited-state solve (host loop,
    device loop, Davidson), and EOM-EE targets and EOM-IP/EA roots, and
    one sharded ECW-CCSD step on a 2-rank gloo group (each rank a fresh
    interpreter with the same imports made to fail);
  - no file of the port, and not chip_smoke.py, has an import statement
    naming jax or ecw_cc_tpu (read with `ast`, so lazy imports inside
    functions count too).
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises
    sys.modules["ecw_cc_tpu"] = None   # and so does `import ecw_cc_tpu...`
    import torch
    torch.set_num_threads(1)
    import ecw_cc_torch
    from ecw_cc_torch import ECW
    # f64 (host ERIs) and f32 (device ERI build) on the dense alternating
    # route that 'auto' takes at nvir 6; f32 'packed' on the alternating
    # packed one
    for dt, thres, mode, route in (
            (torch.float64, 1e-8, "auto", "dense"),
            (torch.float32, 1e-6, "auto", "dense"),
            (torch.float32, 1e-6, "packed", "packed")):
        ecw_cc_torch.set_config(ladder_mode=mode)
        ecw = ECW("H 0 0 0\\nH 0 0 1", "6-31g", device="cpu", dtype=dt)
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        res = ecw.CCSD_GS([0.5], diis="tl", conv_thres=thres)
        assert "Convergence reached" in res[0], res[0]
        assert ecw.solve_log[0]["route"] == route, ecw.solve_log
    # the precision modes: a 'hybrid' solve with a bf16 fast leg, and an f32
    # solve polished in f64 (refine)
    ecw_cc_torch.set_config(ladder_mode="auto", iter_precision="hybrid",
                            hybrid_fast="bf16")
    hyb = ecw.CCSD_GS([0.5], diis="tl", conv_thres=1e-6, refine=True)
    assert "Convergence reached" in hyb[0], hyb[0]
    assert [m for m, _, _ in ecw.solve_log[0]["legs"]] == ["bf16", "highest"]
    assert hyb[5][0].dtype.name == "float64"
    ecw_cc_torch.set_config(iter_precision="highest")
    # a correlated target (CCSD, (T), the response density), the CCS ground
    # state on it, and the JSON runner
    for dt in (torch.float64, torch.float32):
        e2 = ECW("H 0 0 0\\nH 0 0 1", "6-31g", device="cpu", dtype=dt)
        e2.Build_GS_exp("mat", "CCSD(T)", field=[0.05, 0.01, 0.0])
        assert e2.target_log["adjoint"]["converged"], e2.target_log
        assert "Convergence reached" in e2.CCS_GS([0.5], maxiter=200)[0]
    from ecw_cc_torch.__main__ import run_spec
    out = run_spec({"molecule": "h2", "basis": "sto-3g", "device": "cpu",
                    "target": {"prop": "mat", "posthf": "CCSD"},
                    "run": {"solver": "CCS_GS", "Larray": [0.1]}})
    assert "Convergence reached" in out[0], out[0]
    # excited states: the three routes of CCS_ES, and MOM targets
    e3 = ECW("h2o", "sto-3g", device="cpu", dtype=torch.float64)
    e3.Build_ES_exp_input([[["trdip", (0.5, 0.0, 0.0)]]])
    es = {}
    for method in ("scf", "device"):
        es[method] = e3.CCS_ES(0.1, method=method, diis="all", conv="rl",
                               print_ite=False)
        assert "Convergence reached" in es[method][0], es[method][0]
    assert es["scf"][0] == es["device"][0]
    assert abs(es["scf"][3] - es["device"][3]).max() < 1e-9
    out = e3.CCS_ES(0.1, method="diag", conv="tl", davidson=True,
                    print_ite=False)
    assert "Convergence reached" in out[0], out[0]
    e4 = ECW("H 0 0 0\\nH 0 0 1", "6-31g", device="cpu", dtype=torch.float64)
    e4.Build_ES_exp_MOM((1, 0))
    assert e4.exp_data[1][0][0] == "trmat"
    # EOM: the EE targets through the entry point (CCSD, Lambda, the
    # Davidson on the jvp/vjp sigmas, the Wick densities), then IP and EA
    e5 = ECW("h2o", "sto-3g", device="cpu", dtype=torch.float64)
    e5.Build_ES_exp_EOM(1, prop="trdip")
    assert e5.es_eom.log["eom"]["left"]["converged"] == [True]
    from ecw_cc_torch.ops import ccsd_t, eom_ipea
    t1, t2, _ = ccsd_t.solve_ccsd(e5.eris)
    w_ip, _ = eom_ipea.eom_ip_ccsd(e5.eris, t1, t2, nroots=1)
    w_ea, _ = eom_ipea.eom_ea_ccsd(e5.eris, t1, t2, nroots=1)
    assert 0.3 < w_ip[0] < 0.5 and w_ea[0] > 0
    # the sorted, sectored route through the solver's own entry point
    from ecw_cc_torch.models.eris import build_eris_device
    from ecw_cc_torch.ops.ccsd import GCC
    from ecw_cc_torch.ops.ladder import spin_sort_perm
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.solvers.gs import Solver_CCSD
    er, sect = build_eris_device(ecw.mol, ecw.mf, dtype=torch.float32,
                                 device="cpu", pack_ladder=True,
                                 sort_spin=True)
    solver = Solver_CCSD(
        GCC(er), Exp(0.5, [ecw.exp_data[0]], ecw.mol, ecw.mo_coeff),
        conv_thres=1e-6, diis="tl", vvvv_op=sect,
        mo_perm=spin_sort_perm(ecw.mf.orbspin, ecw.nocc))
    out = solver.SCF(0.5)
    assert "Convergence reached" in out[0], out[0]
    assert solver.last_solve["route"] == "sectored", solver.last_solve
    assert solver.last_solve["sym"] is True
    assert abs(out[1][-1] - res[1][-1]) < 1e-5
    # one sharded step on a 2-rank gloo group: each rank a fresh
    # interpreter with the same two imports made to fail
    import os, subprocess, tempfile
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", os.environ["RANK_SCRIPT"], str(r), tmp])
            for r in range(2)]
        assert [p.wait(timeout=240) for p in procs] == [0, 0]
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "ecw_cc_tpu")
                 or m.startswith(("jax.", "jaxlib", "ecw_cc_tpu.")))
    assert sys.modules["jax"] is None and sys.modules["ecw_cc_tpu"] is None
    assert bad == ["ecw_cc_tpu", "jax"], bad
    print("NO_JAX_OK", res[1][-1])
""")

RANK_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["ecw_cc_tpu"] = None
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=2)
    from ecw_cc_torch.parallel import dryrun, sharding
    from ecw_cc_torch.parallel.mesh import make_mesh
    mesh = make_mesh(n_tp=2, device_type="cpu")
    eris = dryrun._synthetic_eris(4, 8, torch.float64)
    target = torch.diag((torch.arange(12) < 4).double())
    rng = np.random.default_rng(1)
    t2 = rng.standard_normal((4, 4, 8, 8)) * 0.01
    t2 = t2 - t2.transpose(1, 0, 2, 3)
    amps = [torch.as_tensor(rng.standard_normal((4, 8)) * 0.01),
            torch.as_tensor(t2 - t2.transpose(0, 1, 3, 2))]
    amps += [0.5 * a for a in amps]
    ref = dryrun._step_fn(eris, target, 0.1)(*amps)
    sh = sharding.amp_shardings(mesh)
    out = dryrun._step_fn(sharding.shard_eris(eris, mesh), target, 0.1)(
        *(sharding.shard_tensor(a, mesh, sh[n])
          for a, n in zip(amps, ("t1", "t2", "l1", "l2"))))
    err = max(float((sharding.replicate(a) - b).abs().max())
              for a, b in zip(out, ref))
    assert err < 1e-11, err
    assert sharding.is_sharded(out[1])
    dist.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "ecw_cc_tpu")
                 or m.startswith(("jax.", "jaxlib", "ecw_cc_tpu.")))
    assert bad == ["ecw_cc_tpu", "jax"], bad
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), RANK_SCRIPT=RANK_SCRIPT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


FORBIDDEN = ("jax", "jaxlib", "ecw_cc_tpu")
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "ecw_cc_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(REPO, "chip_smoke.py")])


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_import_of_jax_or_the_jax_package(rel):
    roots = set(_imported_roots(os.path.join(REPO, rel)))
    assert not roots & set(FORBIDDEN), (rel, sorted(roots & set(FORBIDDEN)))
