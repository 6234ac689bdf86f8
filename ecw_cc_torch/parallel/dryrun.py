"""A multi-rank dry run of the production solver on the CPU (port of the
JAX package's `dryrun_multichip`, in `__graft_entry__.py`).

    python -m ecw_cc_torch.parallel.dryrun [n]     # n ranks, default 8

`dryrun_multichip(n)` starts n processes, one gloo rank each (rendezvous
through a file in a temporary directory), builds a ('dp', 'tp') mesh of
dp = 2 x tp = n/2 over them (dp = 1 for odd n or n <= 2), and runs two
legs of Solver_CCSD.SCF with the ERIs, the ladder operand and the
amplitudes split as parallel/sharding.py splits them:

  1. synthetic ERIs (nocc 4, nvir 8, float32; `_synthetic_eris`): the
     dense route, the ladder launched on each rank's rows of vvvv;
  2. the production route: H2O/6-31G float32 ERIs from
     build_eris_device(pack_ladder=True, sort_spin=True), sectored with
     the mirror symmetry (both gates must engage), the SectoredVVVV split
     by rows, packed DIIS, lambda = 0.05, maxiter 4.

Each leg prints one line, as the JAX twin does.  `run_ranks` is the
spawner they share; the CPU tests of the mesh use it too.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ecw_cc_torch.models.eris import GEris
from ecw_cc_torch.parallel import sharding
from ecw_cc_torch.parallel.mesh import make_mesh


def _synthetic_eris(nocc, nvir, dtype, seed=0, device="cpu"):
    """Random antisymmetrized <pq||rs> blocks and a diagonal fock with a
    gap: the shapes and symmetries of a real system, values made with
    numpy from `seed` (the JAX package's `_synthetic_eris`, draw for
    draw)."""
    rng = np.random.default_rng(seed)
    nmo = nocc + nvir
    eri = rng.standard_normal((nmo, nmo, nmo, nmo)) * 0.05
    # <pq||rs>: antisymmetric in (p,q) and (r,s), symmetric under
    # (pq)<->(rs)
    eri = eri - eri.transpose(1, 0, 2, 3)
    eri = eri - eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    mo_e = np.concatenate([np.linspace(-2.0, -0.5, nocc),
                           np.linspace(0.3, 3.0, nvir)])
    o, v = slice(0, nocc), slice(nocc, nmo)
    sl = {"o": o, "v": v}
    blocks = {name: eri[tuple(sl[c] for c in name)]
              for name in GEris._fields if name != "fock"}
    blocks["fock"] = np.diag(mo_e)
    return GEris(**{k: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)
                    for k, a in blocks.items()})


def _step_fn(eris, target_rdm1, Lw):
    """One ECW-CCSD iteration (rdm1 -> Vexp('mat') -> fsp -> t and lambda
    update -> energy), the body of the production loop, on ERIs and
    amplitudes whole or split over a mesh: the split ERIs are gathered
    once here (a split vvvv stays split: the ladder runs on each rank's
    rows), split amplitudes at each call, and the updated amplitudes
    come back in the placements of the ones given."""
    from ecw_cc_torch.ops import ccsd as ccsd_ops

    eris = sharding.local_eris(eris)

    def step(t1, t2, l1, l2):
        given = (t1, t2, l1, l2)
        t1, t2, l1, l2 = (sharding.replicate(x) for x in given)
        rdm1 = ccsd_ops.gamma_CCSD(t1, t2, l1, l2)
        V = Lw * (target_rdm1 - rdm1)
        fsp = eris.fock - V
        Ep = ccsd_ops.energy(eris, t1, t2, fsp)
        t1n, t2n = ccsd_ops.tupdate(eris, t1, t2, fsp=fsp)
        l1n, l2n = ccsd_ops.lupdate(eris, t1n, t2n, l1, l2, fsp=fsp)
        return tuple(sharding.place_like(y, x) for y, x in
                     zip((t1n, t2n, l1n, l2n), given)) + (Ep,)

    return step


# ---------------------------------------------------------------------------
# the spawner
# ---------------------------------------------------------------------------

def _rank_main(rank, n, tmp, fn):
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=n)
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(n, fn, *args):
    """fn(*args) in each of n new processes, one gloo rank each of a
    process group over them (rendezvous through a file, so that no port
    is taken), fn a module-level function; returns what each rank
    returned, in rank order.  A rank that raises stops them all, and the
    error is raised here."""
    with tempfile.TemporaryDirectory() as tmp:
        # the arguments go through a file: through the start pipe, each
        # start would wait for the rank before it to read them
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        mp.start_processes(_rank_main, args=(n, tmp, fn), nprocs=n,
                           start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _sharded_amps(solver, mesh):
    sh = sharding.amp_shardings(mesh)
    return {k: sharding.shard_tensor(a, mesh, sh[n]) for k, a, n in zip(
        ("ts", "ls", "td", "ld"),
        (solver.tsini, solver.lsini, solver.tdini, solver.ldini),
        ("t1", "l1", "t2", "l2"))}


def _check_amps(amps, mesh, what):
    """The solve's amplitudes kept on the device: DTensors on the CPU in
    amp_shardings' placements."""
    sh = sharding.amp_shardings(mesh)
    for name, a in zip(("t1", "l1", "t2", "l2"), amps):
        if not (sharding.is_sharded(a) and list(a.placements) == sh[name]
                and a.device.type == "cpu"):
            raise AssertionError(f"{what} output {name} is not a CPU DTensor "
                                 f"in {sh[name]}")


def _leg_synthetic(mesh):
    from ecw_cc_torch.ops.ccsd import GCC
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.solvers.gs import Solver_CCSD

    n_dp, n_tp = mesh.size(0), mesh.size(1)
    nocc = 4
    nvir = max(8, 2 * n_tp)
    nvir = n_tp * (-(-nvir // n_tp))     # divisible by the tp axis
    eris = sharding.shard_eris(_synthetic_eris(nocc, nvir, torch.float32),
                               mesh)
    nmo = nocc + nvir
    target = np.eye(nmo) * (np.arange(nmo) < nocc)
    exp = Exp(0.1, [[["mat", target]]], mol=None, mo_coeff=np.eye(nmo))
    solver = Solver_CCSD(GCC(eris), exp, conv="tl", conv_thres=1e-4,
                         diis="tl", maxiter=6)
    text, Ep_it, _, _, _, amps = solver.SCF(
        0.1, **_sharded_amps(solver, mesh), keep_device=True)
    ep = float(Ep_it[-1]) if len(Ep_it) else float("nan")
    if not np.isfinite(ep):
        raise AssertionError(f"solver produced non-finite energy: {ep}")
    _check_amps(amps, mesh, "dryrun")
    return (f"dryrun_multichip OK on {mesh.size()} devices (mesh dp={n_dp} x "
            f"tp={n_tp}); production Solver_CCSD.SCF ran {len(Ep_it)} "
            f"sharded iterations on cpu-only buffers; Ep = {ep:.6f} ({text})")


def _leg_production(mesh, data):
    from ecw_cc_torch.models.eris import from_numpy
    from ecw_cc_torch.ops.ccsd import GCC
    from ecw_cc_torch.ops.ladder import SectoredVVVV
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.solvers.gs import Solver_CCSD

    er, sect = from_numpy(GEris(*data["eris"]), SectoredVVVV(*data["sect"]),
                          dtype=torch.float32, device="cpu")
    exp = Exp(0.05, [[["mat", data["target"]]]], mol=None,
              mo_coeff=data["mo_coeff"])
    solver = Solver_CCSD(GCC(sharding.shard_eris(er, mesh)), exp, conv="tl",
                         conv_thres=1e-4, diis="tl", maxiter=4,
                         vvvv_op=sharding.shard_vvvv_op(sect, mesh),
                         mo_perm=data["perm"])
    # the production gates must be on for this leg to mean anything
    if not solver._vexp_block_diagonal():
        raise AssertionError("sector gate did not engage")
    if not solver._spin_restricted():
        raise AssertionError("sym gate did not engage")
    text, Ep_it, _, _, _, amps = solver.SCF(
        0.05, **_sharded_amps(solver, mesh), keep_device=True)
    if solver.last_solve["route"] != "sectored" or not solver.last_solve[
            "sym"]:
        raise AssertionError(f"took {solver.last_solve}")
    ep = float(Ep_it[-1]) if len(Ep_it) else float("nan")
    if not np.isfinite(ep):
        raise AssertionError(f"sectored solver non-finite energy: {ep}")
    _check_amps(amps, mesh, "sectored dryrun")
    return (f"dryrun production route OK (sorted+sectored+sym+packed-DIIS, "
            f"mesh dp={mesh.size(0)} x tp={mesh.size(1)}): {len(Ep_it)} "
            f"sharded iterations, Ep = {ep:.6f} ({text})")


def _dryrun_rank(n, data):
    mesh = make_mesh(n_dp=2 if n % 2 == 0 and n > 2 else 1,
                     device_type="cpu")
    return [_leg_synthetic(mesh), _leg_production(mesh, data)]


def production_inputs():
    """Leg 2's inputs, built once in the calling process with the port's
    host front end: H2O/6-31G RHF -> GHF -> float32 ERIs on the CPU,
    spin-sorted, the ladder packed into a SectoredVVVV; as NumPy arrays,
    with the sort permutation, the HF density target and the MO
    coefficients."""
    from ecw_cc_torch.models.eris import build_eris_device
    from ecw_cc_torch.models.molecule import Molecule
    from ecw_cc_torch.models.scf import GHF, RHF
    from ecw_cc_torch.ops.ladder import spin_sort_perm

    mol = Molecule("h2o", "6-31g")
    mf = RHF(mol)
    mf.kernel()
    ghf = GHF(mf)
    er, sect = build_eris_device(mol, ghf, dtype=torch.float32,
                                 device="cpu", pack_ladder=True,
                                 sort_spin=True)
    return {"eris": [x.numpy() for x in er], "sect": [w.numpy() for w in sect],
            "perm": spin_sort_perm(ghf.orbspin, er.nocc),
            "target": np.diag(np.asarray(ghf.mo_occ, dtype=np.float64)),
            "mo_coeff": np.asarray(ghf.mo_coeff)}


def dryrun_multichip(n_devices, data=None):
    """Both legs on n_devices gloo ranks of the CPU; prints and returns
    their two lines (rank 0's; every rank computes the same).  data: leg
    2's inputs (production_inputs()), built here when None."""
    if data is None:
        data = production_inputs()
    lines = run_ranks(n_devices, _dryrun_rank, n_devices, data)
    if any(out != lines[0] for out in lines[1:]):
        raise AssertionError(f"the ranks disagree: {lines}")
    for line in lines[0]:
        print(line)
    return lines[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
