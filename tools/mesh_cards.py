"""The split ladder across the cards of one host (ecw_cc_torch/parallel).

    python3 tools/mesh_cards.py [n] [basis]     # default: every card, cc-pvtz

n NCCL ranks, one per card, each build C2H2/<basis> f32 through ECW (lambda
= 0.25, HF target in a field, as chip_smoke.py phase 7) in the layout the
config gives it: at the default config.spin_sorted the spin-sorted ERIs
with a SectoredVVVV and mo_perm (the sectored route), under
set_config(spin_sorted=False) the alternating ERIs with a PackedVVVV (the
packed route).  Each solves it two ways, in turns (alone, split, split,
alone): alone on its own card, and with the ERIs, the ladder operand (each
sector of a SectoredVVVV) and the amplitudes split by rows over a 1 x n
mesh, each ladder product one launch on the rank's rows and an all-gather
of its columns.  The kernels are built once, before the ranks start.
Rank 0 prints one JSON line per solve (route, iterations, Ep, ms per
iteration, ladder launches and those on the rows, peak device memory) and
one for the split solve's collectives (their count and the largest tensor
of any), then the card's name and power limit.  Exits nonzero when a
solve leaves the route of the ECW's layout, a split solve differs from the
lone one (iterations, 1e-6 Ha), launches other than its route's products
per iteration (route_launches) on the rows, or any collective holds the
operand.

`rank_solves` and `verdict` run on gloo ranks on the CPU as well, where a
ladder product is its plain version and no launch is counted.
"""

import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ecw_cc_torch.kernels import build  # noqa: E402

L = 0.25
FIELD = [0.05, 0.01, 0.0]


def route_launches(run):
    """Ladder products per iteration of a solve's route (chip_smoke.py's
    route_launches): the stacked packed GEMM once, the sector GEMMs twice
    with the mirror symmetry (alpha-alpha, alpha-beta), three times
    without."""
    if run["route"] == "sectored":
        return 2 if run["sym"] else 3
    return {"packed": 1}[run["route"]]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _solve(ecw, mesh, log):
    from ecw_cc_torch.kernels.ladder_mm import ladder_mm
    from ecw_cc_torch.ops.ccsd import GCC
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.parallel import sharding
    from ecw_cc_torch.solvers.gs import Solver_CCSD

    eris, op = ecw.eris, ecw.vvvv_op
    dev = eris.fock.device
    if mesh is not None:
        eris = sharding.shard_eris(eris, mesh)
        op = sharding.shard_vvvv_op(op, mesh)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ladder_mm.launches = ladder_mm.shard_launches = 0
    coll = sharding.CollectiveLog() if log else None
    if coll:
        coll.__enter__()
    solver = Solver_CCSD(GCC(eris), Exp(L, [ecw.exp_data[0]], ecw.mol,
                                        ecw.mo_coeff),
                         conv="tl", conv_thres=1e-6, diis="tl", maxiter=60,
                         vvvv_op=op, mo_perm=ecw.mo_perm)
    kw = {}
    if mesh is not None:
        sh = sharding.amp_shardings(mesh)
        kw = {k: sharding.shard_tensor(a, mesh, sh[n]) for k, a, n in zip(
            ("ts", "ls", "td", "ld"),
            (solver.tsini, solver.lsini, solver.tdini, solver.ldini),
            ("t1", "l1", "t2", "l2"))}
    res = solver.SCF(L, **kw)
    _sync(dev)
    if coll:
        coll.__exit__(None, None, None)
    s = solver.last_solve
    out = {"split": mesh is not None, "iterations": s["iterations"],
           "status": s["status"], "route": s["route"], "sym": s["sym"],
           "Ep": float(res[1][-1]), "ms": s["ms"],
           "ms_per_iteration": s["ms"] / s["iterations"],
           "launches": ladder_mm.launches,
           "launches_on_rows": ladder_mm.shard_launches,
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                       if dev.type == "cuda" else None)}
    # the operand's tensors: the PackedVVVV's one, a SectoredVVVV's three
    whole = list(ecw.vvvv_op)
    if mesh is not None:
        local = [w.to_local() for w in op]
        out["operand_local"] = [list(w.shape) for w in local]
        out["operand_local_mb"] = sum(w.numel() * w.element_size()
                                      for w in local) / 1e6
    if coll:
        shapes = {tuple(w.shape) for w in whole}
        shapes |= {tuple(w.to_local().shape) for w in op}
        out["collectives"] = len(coll.calls)
        out["largest_collective_elements"] = coll.largest()
        out["collectives_on_operand"] = sum(
            any(tuple(x) in shapes for x in xs) for _, xs in coll.calls)
    return out


def rank_solves(n, molecule="c2h2", basis="cc-pvtz", device="cuda",
                config=None):
    """One rank's part: set_config(**config) if given, the ECW at f32 on
    `device` with its HF target, then the lone and split solves in turns
    (alone, split with its collectives logged, split, alone; then the
    second lone and split once more, for the spread) over a 1 x n mesh of
    the default process group.  Returns {"setup_s", "runs"}."""
    from ecw_cc_torch import ECW, set_config
    from ecw_cc_torch.parallel.mesh import make_mesh

    if config:
        set_config(**config)
    t0 = time.perf_counter()
    ecw = ECW(molecule, basis, device=device, dtype=torch.float32)
    ecw.Build_GS_exp("mat", "HF", field=FIELD)
    setup_s = time.perf_counter() - t0
    mesh = make_mesh(n_tp=n, n_dp=1, device_type=torch.device(device).type)
    runs = [_solve(ecw, m, log) for m, log in (
        (None, False), (mesh, True), (mesh, False), (None, False))]
    runs += [_solve(ecw, m, False) for m in (None, mesh)]
    return {"setup_s": setup_s, "runs": runs,
            "route": "packed" if ecw.mo_perm is None else "sectored"}


def verdict(out, counted=True):
    """True when every solve converged on the route of the ECW's layout,
    each split solve equals the first lone one (iterations, 1e-6 Ha), the
    logged split solve moved no operand-sized tensor and, with `counted`
    (on the cards), each split solve launched its route's products per
    iteration, every one of them on the rank's rows."""
    lone = [r for r in out["runs"] if not r["split"]]
    split = [r for r in out["runs"] if r["split"]]
    ok = all(r["status"] == 1 and r["route"] == out["route"]
             for r in out["runs"])
    ok &= all(r["iterations"] == lone[0]["iterations"]
              and abs(r["Ep"] - lone[0]["Ep"]) <= 1e-6 for r in split)
    if counted:
        ok &= all(r["launches"] == r["launches_on_rows"]
                  == route_launches(r) * r["iterations"] for r in split)
    ok &= split[0]["collectives_on_operand"] == 0
    return bool(ok)


def rank_main(rank, n, port, basis, out_path):
    torch.cuda.set_device(rank)
    torch.set_num_threads(max(1, os.cpu_count() // n))   # the host's share
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n,
                            device_id=torch.device("cuda", rank))
    try:
        out = rank_solves(n, "c2h2", basis, "cuda")
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(argv):
    if not torch.cuda.is_available():
        print("mesh_cards: this needs CUDA cards", file=sys.stderr)
        return 2
    n = int(argv[0]) if argv else torch.cuda.device_count()
    basis = argv[1] if len(argv) > 1 else "cc-pvtz"
    if n > torch.cuda.device_count():
        print(f"mesh_cards: {n} ranks need {n} cards", file=sys.stderr)
        return 2
    build.library()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_path = os.path.join(build.BUILD_DIR, f"mesh_cards_{os.getpid()}.json")
    t0 = time.perf_counter()
    mp.start_processes(rank_main, args=(n, port, basis, out_path), nprocs=n,
                       start_method="spawn")
    with open(out_path) as f:
        out = json.load(f)
    os.remove(out_path)
    for r in out["runs"]:
        print(json.dumps({"ranks": n, "basis": basis, **r}))
    ok = verdict(out)
    print(json.dumps({"ranks": n, "basis": basis, "ok": ok,
                      "route": out["route"], "setup_s": out["setup_s"],
                      "ms_per_iteration_lone": [
                          r["ms_per_iteration"] for r in out["runs"]
                          if not r["split"]],
                      # the logged split solve (a dispatch mode slows
                      # every operation) is left out
                      "ms_per_iteration_split": [
                          r["ms_per_iteration"] for r in out["runs"]
                          if r["split"] and "collectives" not in r],
                      "seconds": time.perf_counter() - t0}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
