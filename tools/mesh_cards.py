"""The split ladder across the cards of one host (ecw_cc_torch/parallel).

    python3 tools/mesh_cards.py [n] [basis]     # default: every card, cc-pvtz

n NCCL ranks, one per card, each build C2H2/<basis> f32 through ECW
(alternating ERIs with a PackedVVVV, lambda = 0.25, HF target in a field,
as chip_smoke.py phase 7) and solve it two ways, in turns (alone, split,
split, alone): alone on their own card, and with the ERIs, the PackedVVVV
and the amplitudes split over a 1 x n mesh, each ladder product one launch
on the rank's rows and an all-gather of its columns.  The kernels are built
once, before the ranks start.  Rank 0 prints one JSON line per solve
(iterations, Ep, ms per iteration, ladder launches and those on the rows,
peak device memory) and one for the split solve's collectives (their
count and the largest tensor of any), then the card's name and power
limit.  Exits nonzero when a split solve differs from the lone one
(iterations, 1e-6 Ha), launches other than one product per iteration on
the rows, or any collective holds the operand.
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


def _solve(ecw, mesh, log):
    from ecw_cc_torch.kernels.ladder_mm import ladder_mm
    from ecw_cc_torch.ops.ccsd import GCC
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.parallel import sharding
    from ecw_cc_torch.solvers.gs import Solver_CCSD

    eris, op = ecw.eris, ecw.vvvv_op
    if mesh is not None:
        eris = sharding.shard_eris(eris, mesh)
        op = sharding.shard_vvvv_op(op, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ladder_mm.launches = ladder_mm.shard_launches = 0
    coll = sharding.CollectiveLog() if log else None
    if coll:
        coll.__enter__()
    solver = Solver_CCSD(GCC(eris), Exp(L, [ecw.exp_data[0]], ecw.mol,
                                        ecw.mo_coeff),
                         conv="tl", conv_thres=1e-6, diis="tl", maxiter=60,
                         vvvv_op=op)
    kw = {}
    if mesh is not None:
        sh = sharding.amp_shardings(mesh)
        kw = {k: sharding.shard_tensor(a, mesh, sh[n]) for k, a, n in zip(
            ("ts", "ls", "td", "ld"),
            (solver.tsini, solver.lsini, solver.tdini, solver.ldini),
            ("t1", "l1", "t2", "l2"))}
    res = solver.SCF(L, **kw)
    torch.cuda.synchronize()
    if coll:
        coll.__exit__(None, None, None)
    s = solver.last_solve
    out = {"split": mesh is not None, "iterations": s["iterations"],
           "status": s["status"], "route": s["route"],
           "Ep": float(res[1][-1]), "ms": s["ms"],
           "ms_per_iteration": s["ms"] / s["iterations"],
           "launches": ladder_mm.launches,
           "launches_on_rows": ladder_mm.shard_launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if mesh is not None:
        local = op.wc.to_local()
        out["operand_local"] = list(local.shape)
        out["operand_local_mb"] = local.numel() * local.element_size() / 1e6
    if coll:
        whole = tuple(ecw.vvvv_op.wc.shape)
        out["collectives"] = len(coll.calls)
        out["largest_collective_elements"] = coll.largest()
        out["collectives_on_operand"] = sum(
            any(tuple(x) in (whole, tuple(op.wc.to_local().shape))
                for x in shapes) for _, shapes in coll.calls)
    return out


def rank_main(rank, n, port, basis, out_path):
    from ecw_cc_torch import ECW
    from ecw_cc_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(rank)
    torch.set_num_threads(max(1, os.cpu_count() // n))   # the host's share
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n,
                            device_id=torch.device("cuda", rank))
    try:
        t0 = time.perf_counter()
        ecw = ECW("c2h2", basis, device="cuda", dtype=torch.float32)
        ecw.Build_GS_exp("mat", "HF", field=FIELD)
        setup_s = time.perf_counter() - t0
        mesh = make_mesh(n_tp=n, n_dp=1)
        runs = [_solve(ecw, m, log) for m, log in (
            (None, False), (mesh, True), (mesh, False), (None, False))]
        # the second lone and split solves once more, for the spread
        runs += [_solve(ecw, m, False) for m in (None, mesh)]
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"setup_s": setup_s, "runs": runs}, f)
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
    lone = [r for r in out["runs"] if not r["split"]]
    split = [r for r in out["runs"] if r["split"]]
    for r in out["runs"]:
        print(json.dumps({"ranks": n, "basis": basis, **r}))
    ok = all(r["status"] == 1 and r["route"] == "packed" for r in
             out["runs"])
    ok &= all(r["iterations"] == lone[0]["iterations"]
              and abs(r["Ep"] - lone[0]["Ep"]) <= 1e-6 for r in split)
    ok &= all(r["launches"] == r["launches_on_rows"] == r["iterations"]
              for r in split)
    ok &= split[0]["collectives_on_operand"] == 0
    print(json.dumps({"ranks": n, "basis": basis, "ok": bool(ok),
                      "setup_s": out["setup_s"],
                      "ms_per_iteration_lone": [r["ms_per_iteration"]
                                                for r in lone],
                      # the logged split solve (a dispatch mode slows
                      # every operation) is left out
                      "ms_per_iteration_split": [
                          r["ms_per_iteration"] for r in split
                          if "collectives" not in r],
                      "seconds": time.perf_counter() - t0}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
