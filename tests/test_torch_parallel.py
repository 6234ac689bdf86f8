"""The PyTorch port's multi-device layer (ecw_cc_torch/parallel) on the CPU:
a gloo group of 8 ranks, started once for the module (file rendezvous),
runs every rank-side check once (tests/torch_parallel_ranks.py); each test
asserts its own part.  The tests mirror tests/test_parallel.py by name:

  - the mesh, its placements and make_mesh's errors;
  - the ECW-CCSD step and the production solve on the dense, packed and
    sectored routes with ERIs, ladder operand and amplitudes split
    (sharded = whole at the JAX tests' tolerances; the sharded solve also
    against the JAX package's sharded solve);
  - the packed operand's padding at odd p, and the scale proof at
    cc-pVTZ's p = 13041 over tp = 8: each rank holds 1/8 of the rows, and
    no collective moves an operand-sized tensor;
  - the (T) pairs split over the ranks, with pair counts that do not
    divide; the EOM sigmas on split inputs;
  - the shard product's forward, backward, tangent and vmap rules against
    the whole product (plain versions on the CPU);
  - the dry run of both legs on dp = 2 x tp = 4;
  - ECW.CCSD_GS with a mode other than 'sweep' or 'parallel' runs the
    warm sweep, as the JAX ECW does.
"""

import concurrent.futures
import re

import numpy as np
import pytest
import torch

import ecw_cc_torch
import torch_parallel_ranks as ranks
from ecw_cc_torch.parallel import dryrun
from ecw_cc_torch.parallel.mesh import make_mesh
from gauge import jax_gauge
from torch.distributed.tensor import Replicate, Shard

R, S3 = Replicate(), Shard(3)

torch.set_num_threads(1)
N_RANKS = 8
ERI_FIELDS = ("fock", "oooo", "ooov", "oovo", "oovv", "ovov", "ovvo",
               "ovvv", "ovoo", "vvvv", "vooo", "vovo", "voov", "vovv",
               "vvoo", "vvvo")


def _arrays(er):
    return [np.asarray(getattr(er, f)) for f in ERI_FIELDS]


def _inputs(h2o_631g, h2o_sto3g):
    """The ranks' inputs, as NumPy arrays, all from the JAX package's host
    ERIs (one orbital gauge for both packages): the alternating blocks,
    the same with the pack-on-build placeholder vvvv and their
    PackedVVVV, the spin-sorted blocks with their SectoredVVVV, H2O/
    STO-3G's blocks and PackedVVVV, and the (T) amplitudes; and the (T)
    system for the JAX energy."""
    from ecw_cc_torch.models.eris import sorted_from_host
    from ecw_cc_torch.ops.ladder import pack_vvvv, spin_sort_perm
    from ecw_cc_tpu.ops.spinsect import SectorInfo
    from test_ccsd_kernels import _mirror_amps

    _, ghf, eh, _ = h2o_631g
    nocc, nvir = eh.nocc, eh.nvir
    packed = _arrays(eh)
    packed[ERI_FIELDS.index("vvvv")] = np.zeros((nvir, 0, 0, 0))
    perm = spin_sort_perm(ghf.orbspin, nocc)
    er_s, sect = sorted_from_host(eh, perm, dtype=torch.float64,
                                  device="cpu")
    spin = np.asarray(ghf.orbspin)[perm]
    info = SectorInfo(*(int(np.sum(spin[sl] == s)) for sl, s in (
        (slice(0, nocc), 0), (slice(0, nocc), 1), (slice(nocc, None), 0),
        (slice(nocc, None), 1))))
    t1, t2, _, _ = _mirror_amps(info, seed=41)
    eh3 = h2o_sto3g[2]
    data = dict(
        alt_eris=_arrays(eh), packed_eris=packed,
        packed_wc=pack_vvvv(torch.as_tensor(eh.vvvv)).wc.numpy(),
        sorted_eris=[x.numpy() for x in er_s],
        sorted_sect=[w.numpy() for w in sect], perm=np.asarray(perm),
        target=np.diag(np.asarray(ghf.mo_occ, dtype=np.float64)),
        mo_coeff=np.asarray(ghf.mo_coeff), sto3g_dense=_arrays(eh3),
        sto3g_wc=pack_vvvv(torch.as_tensor(eh3.vvvv)).wc.numpy(),
        t_info=tuple(info), t_amps=[t1, t2])
    return data, (data["sorted_eris"], t1, t2)


def _jax_sharded_solve(h2o_631g):
    """tests/test_parallel.py's sharded dense-route solve."""
    import jax
    from ecw_cc_tpu.ops.ccsd import GCC
    from ecw_cc_tpu.ops.vexp import Exp
    from ecw_cc_tpu.parallel.mesh import make_mesh as jmesh
    from ecw_cc_tpu.parallel.sharding import amp_shardings, shard_eris
    from ecw_cc_tpu.solvers.gs import Solver_CCSD

    mol, ghf, _, eris = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, dtype=np.float64))
    mesh = jmesh(n_dp=2)
    exp = Exp(0.05, [[["mat", target]]], mol=mol, mo_coeff=ghf.mo_coeff)
    solver = Solver_CCSD(GCC(shard_eris(eris, mesh)), exp, conv="tl",
                         conv_thres=1e-8, diis="tl", maxiter=60)
    sh = amp_shardings(mesh)
    return solver.SCF_device(
        0.05, ts=jax.device_put(solver.tsini, sh["t1"]),
        ls=jax.device_put(solver.lsini, sh["l1"]),
        td=jax.device_put(solver.tdini, sh["t2"]),
        ld=jax.device_put(solver.ldini, sh["l2"]))


@pytest.fixture(scope="module")
def runs(h2o_631g, h2o_sto3g):
    """The ranks' results of ranks.rank_checks (rank order), and the JAX
    references, computed while the ranks run."""
    import jax.numpy as jnp
    from ecw_cc_tpu.models.eris import GEris
    from ecw_cc_tpu.ops import ccsd_t

    data, (er_s, t1, t2) = _inputs(h2o_631g, h2o_sto3g)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        group = pool.submit(dryrun.run_ranks, N_RANKS, ranks.rank_checks,
                            data)
        er = GEris(*(jnp.asarray(x) for x in er_s))
        ref = dict(e_dense=float(ccsd_t.energy_t(er, jnp.asarray(t1),
                                                 jnp.asarray(t2))),
                   solve=_jax_sharded_solve(h2o_631g))
        return group.result(), ref


@pytest.fixture(scope="module")
def group(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


def _same_on_every_rank(group, key):
    first = group[0][key]
    for out in group[1:]:
        assert repr(out[key]) == repr(first), key
    return first


def test_mesh_construction(group):
    m = _same_on_every_rank(group, "mesh")
    assert m["names"] == ("dp", "tp")
    assert m["shape"] == (2, 4)
    assert m["replicated"] == [R, R]
    split = {"oovv": S3, "ovvv": Shard(1), "vvvv": Shard(0),
             "vovv": Shard(0)}
    assert m["eris_placements"] == {k: [R, split.get(k, R)]
                                    for k in ERI_FIELDS}
    assert m["amp_placements"] == {"t1": [R, R], "l1": [R, R],
                                   "t2": [R, S3], "l2": [R, S3]}


def test_make_mesh_rejects_a_wrong_shape(group):
    """n_dp x n_tp must cover the ranks (8 ranks: no 2 x 3, no 2 x 5);
    without a process group make_mesh starts none and raises."""
    assert len(group[0]["mesh"]["bad"]) == 2
    assert all("does not match 8 devices" in e
               for e in group[0]["mesh"]["bad"])
    with pytest.raises(ValueError, match="does not match 4 devices"):
        make_mesh(n_tp=3, devices=[0, 1, 2, 3], device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")


def test_sharded_ccsd_step_matches_replicated(group):
    step = _same_on_every_rank(group, "step")
    assert step["err"] < 1e-11
    assert step["t2_placed"] == [R, S3]


def _whole(group, name):
    """The unsplit run `name`, which one rank made."""
    return next(out["whole"][name] for out in group
                if name in out.get("whole", {}))


def _check_solve(group, route, expect_route, entry, sym=False):
    """Sharded = whole (the JAX test's tolerances), the amplitudes kept on
    the device in their placements, and the collectives of the sharded
    solve: `entry` at its start (the split ERI blocks and amplitudes
    gathered, the mirror gate's all-reduces), then one all-gather of a
    product's columns per ladder product and iteration; none of them
    holds the ladder operand's rows."""
    whole = _whole(group, route)
    shard = group[0]["solves"][route]
    for out in group[1:]:
        assert abs(out["solves"][route]["Ep"][-1] - shard["Ep"][-1]) == 0.0
    assert "Convergence reached" in whole["text"]
    assert whole["route"] == shard["route"] == expect_route
    assert whole["sym"] == shard["sym"] == sym
    assert len(whole["Ep"]) == len(shard["Ep"])
    assert abs(whole["Ep"][-1] - shard["Ep"][-1]) < 1e-10
    np.testing.assert_allclose(shard["rdm1"], whole["rdm1"], rtol=0,
                               atol=1e-9)
    for a, b in zip(shard["amps"], whole["amps"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert shard["placed"] == [[R, R], [R, R], [R, S3], [R, S3]]
    calls = shard["collectives"]
    n_products = shard["products_per_iteration"] * len(shard["Ep"])
    assert len(calls) == entry + n_products, [c for c, _ in calls]
    gathers = calls[len(calls) - n_products:]
    assert {c for c, _ in gathers} == {"_allgather_base_"}
    ops = group[0]["operands"][route]
    forbidden = set()
    for o in (ops if isinstance(ops, list) else [ops]):
        rows = o[0] + (-o[0]) % 4
        views = [o, (rows,) + o[1:]]
        if len(o) == 4:                       # the dense vvvv's GEMM view
            views.append((o[0] * o[1], o[2] * o[3]))
        forbidden |= {v for v in views}
        forbidden |= {(v[0] // 4,) + v[1:] for v in views}
    for _, shapes in calls:
        for shape in shapes:
            assert tuple(shape) not in forbidden, (shape, ops)
    return shard


def test_sharded_full_solve_matches_replicated(group):
    # entry: oovv, ovvv, vovv and t2, l2 gathered (vvvv stays split);
    # per iteration the two ladders (t and lambda sides) on the split vvvv
    _check_solve(group, "dense", "dense", entry=5)


def test_sharded_packed_ladder_solve_matches_replicated(group):
    # entry: oovv, ovvv, vovv, the (16, 0, 0, 0) vvvv placeholder, t2, l2;
    # per iteration the one stacked product on the split PackedVVVV
    _check_solve(group, "packed", "packed", entry=6)


def test_sharded_sectored_ladder_solve_matches_replicated(group):
    # entry as packed, and the mirror gate's two all-reduces (max) over
    # the split sectors; per iteration the aa and ab sector products
    _check_solve(group, "sectored", "sectored", entry=8, sym=True)
    # sector rows padded to the tp multiple (paa = 28, pab = 64, tp = 4)
    assert all(r % 4 == 0 for r in group[0]["sect_rows"])


def test_sharded_solve_matches_jax_sharded_solve(group, jax_ref):
    """The port's sharded dense-route solve against the JAX package's
    sharded one (tests/test_parallel.py's), f64."""
    ref = jax_ref["solve"]
    shard = group[0]["solves"]["dense"]
    assert "Convergence reached" in ref[0]
    assert shard["text"] == ref[0]
    assert len(shard["Ep"]) == len(ref[1])
    assert abs(shard["Ep"][-1] - float(ref[1][-1])) <= 1e-10
    np.testing.assert_allclose(shard["rdm1"], np.asarray(ref[4]), rtol=0,
                               atol=1e-9)


def test_sharded_packed_operand_pads_odd_p(group):
    """H2O/STO-3G: p = 6 over tp = 4, padded to 8; the packed ladder on
    the split operand equals the dense one.  Its TF32 and bfloat16 casts
    act on the local rows and keep the placement."""
    out = _same_on_every_rank(group, "odd_p")
    assert out["p"] == 6
    assert out["rows"] == 8 and out["local"] == (2, 6)
    assert out["err"] < 1e-12
    for name, dtype in (("tf32", torch.float32), ("bf16", torch.bfloat16)):
        placed, shape, local, got, same = out["casts"][name]
        assert placed == [R, Shard(0)] and shape == (8, 6)
        assert local == (2, 6) and got == dtype and same, name


def test_eris_to_device_places_each_block(group):
    """ErisHost.to_device(sharding=eris_shardings(mesh)): every block a
    DTensor in its placements, equal to the host block."""
    out = _same_on_every_rank(group, "to_device")
    split = {"oovv": S3, "ovvv": Shard(1), "vvvv": Shard(0),
             "vovv": Shard(0)}
    for k, (placed, err) in out.items():
        assert placed == [R, split.get(k, R)], k
        assert err == 0.0, k


def test_sharded_packed_ladder_scale_proof(group):
    """p = 13041 f32 over tp = 8: each rank holds 13048/8 rows of 13041
    (85 MB of the 680 MB operand), and the ladder on it runs one
    collective, the all-gather of its 196 x 1631 columns."""
    p = ranks.SCALE_P
    rows = p + (-p) % 8
    for out in group:
        sc = out["scale"]
        assert sc["shape"] == (rows, p)
        assert sc["local"] == (rows // 8, p)
        assert sc["local_bytes"] * 8 >= sc["whole_bytes"]
        assert sc["local_bytes"] <= sc["whole_bytes"] // 8 + p * 4 * 8
        assert sc["y_shape"] == (14, 14, 162, 162) and sc["finite"]
        assert len(sc["collectives"]) == 1
        # no collective holds an operand-sized tensor (rows x K, or its
        # pair axis whole: 13041 or 13048 wide on either side)
        assert sc["largest"] <= 8 * 196 * (rows // 8)
        for _, shapes in sc["collectives"]:
            for shape in shapes:
                assert p not in shape and rows not in shape, shape


def test_sharded_sectored_t_energy_matches_single(group, jax_ref):
    """The (T) pair loops split over all 8 ranks (operands replicated, one
    all-reduce) equal the single-rank sectored loops and the JAX dense
    energy, with 25 alpha-alpha pairs over 8 ranks."""
    e_dense = jax_ref["e_dense"]
    t = group[0]["t"]
    assert "requires sect" in t["dense_refused"]
    for sym in (False, True):
        e_one = group[int(sym)]["t"][f"one_{sym}"]
        for out in group:
            e_mesh = out["t"][f"mesh_{sym}"]
            assert abs(e_mesh - e_one) < 1e-12 * max(1.0, abs(e_one))
            assert abs(e_mesh - e_dense) < 1e-11 * max(1.0, abs(e_dense))
    assert group[0]["t"]["mesh_False"] != 0.0


def test_sharded_eom_sigma_matches_replicated(group):
    out = _same_on_every_rank(group, "eom")
    assert max(out["err"]) < 1e-11
    assert out["placed"] == [R, S3]
    # the right sigma's ladder is a forward and a tangent product, the
    # left one's a forward and a backward, on each rank's rows of vvvv
    assert out["shard_products"] > 0


def test_shard_backward_and_tangent_match_unsharded(group):
    """Forward, backward (autograd, vjp), tangent and vmap of the product
    on a row shard equal the whole product's (37 rows over tp = 4,
    padded to 40); one local product per rank for each."""
    for out in group:
        r = out["shard_rules"]
        for k in ("forward", "backward", "vjp", "tangent", "vmap"):
            assert r[k] < 1e-13, (k, r[k])
        assert r["forward_kinds"] == [False]
        assert r["backward_kinds"] == [False, True]
        assert r["tangent_kinds"] == [False, "tangent"]
        assert r["vmap_kinds"] == [False]     # the lanes folded: one
        assert r["refuses_general"]


def test_sharded_batch_matches_whole(group):
    """SCF_batch on the split packed operand: each lane equal to the
    whole operand's lane."""
    whole, shard = _whole(group, "batch"), group[0]["batch"]
    for (tw, ew, aw), (ts, es, as_) in zip(whole, shard):
        assert "Convergence reached" in tw and tw == ts
        assert len(ew) == len(es) and abs(ew[-1] - es[-1]) < 1e-10
        np.testing.assert_allclose(as_, aw, rtol=0, atol=1e-9)


def test_dryrun_multichip(capsys):
    lines = dryrun.dryrun_multichip(8)
    printed = capsys.readouterr().out
    assert lines[0] in printed and lines[1] in printed
    assert "mesh dp=2 x tp=4" in lines[0]
    m = re.search(r"(\d+) sharded iterations, Ep = (-?[\d.]+)", lines[1])
    assert m, lines[1]
    # MULTICHIP_r05.json (the JAX twin): 5 iterations, Ep = -0.135283
    assert int(m.group(1)) == 5
    assert abs(float(m.group(2)) - (-0.135283)) <= 1e-5


def test_ccsd_gs_other_mode_runs_the_sweep(h2o_631g):
    """CCSD_GS(mode=<anything but 'parallel'>) runs the warm-started
    sweep, as the JAX ECW does (models/ecw.py:487): 'serial' gives
    'sweep''s energies, iteration counts and rdm1, and the JAX ECW's
    'serial' sweep, f64."""
    from ecw_cc_tpu import ECW as JECW

    Ls = [0.0, 0.1]

    def run(ecw, mode):
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        res = ecw.CCSD_GS(Ls, conv_thres=1e-8, maxiter=60, diis="tl",
                          mode=mode)
        return np.asarray(ecw.Ep_lamb), res

    ref_ecw = JECW("h2o", "6-31g")
    ep_jax, res_jax = run(ref_ecw, "serial")
    out = {}
    for mode in ("sweep", "serial"):
        with jax_gauge(ref_ecw):
            ecw = ecw_cc_torch.ECW("h2o", "6-31g", device="cpu",
                                   dtype=torch.float64)
        out[mode] = run(ecw, mode) + (
            [s["iterations"] for s in ecw.solve_log],)
    (ep_sw, res_sw, it_sw), (ep_se, res_se, it_se) = out["sweep"], \
        out["serial"]
    assert it_se == it_sw and "lanes" not in ecw.solve_log[0]
    np.testing.assert_allclose(ep_se, ep_sw, rtol=0, atol=1e-12)
    np.testing.assert_allclose(res_se[4], res_sw[4], rtol=0, atol=1e-12)
    assert res_se[0] == res_jax[0]
    assert len(res_se[1]) == len(res_jax[1])
    np.testing.assert_allclose(ep_se, ep_jax, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res_se[4], res_jax[4], rtol=0, atol=1e-9)
