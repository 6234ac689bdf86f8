"""The PyTorch port's precision modes of the CCSD solve (config.
iter_precision 'highest', 'high', 'default', 'bf16', 'hybrid'; SCF(refine=
True) and ECW.CCSD_GS(refine=True)) and the ladder kernel's TF32 and BF16
variants, against the JAX package (tests/test_e2e_gs.py:309-479 mirrored)
on H2O/6-31G, CPU.

On the CPU the ladder products take the variants' plain versions (TF32
rounding as cvt.rna rounds; bf16 products summed in f32 and rounded once),
and bf16 storage rounds for real, so a 'bf16' leg is genuinely reduced
here.  The variants' kernels are held against those plain versions on the
card (the `gpu` tests at the end, and chip_smoke.py phase 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import ecw_cc_torch
import ecw_cc_tpu.config as jcfg
from ecw_cc_tpu.models.eris import build_eris_device as j_build_eris_device
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_tpu.ops.ccsd import GCC as JGCC
from ecw_cc_tpu.ops.vexp import Exp as JExp
from ecw_cc_tpu.solvers.gs import Solver_CCSD as JSolver
from ecw_cc_torch import ECW, config
from ecw_cc_torch.kernels import ladder_mm as lmm
from ecw_cc_torch.models.eris import from_numpy
from ecw_cc_torch.ops import ladder as tl
from ecw_cc_torch.ops.ccsd import GCC as TGCC
from ecw_cc_torch.ops.promote import einsum
from ecw_cc_torch.ops.vexp import Exp as TExp
from ecw_cc_torch.solvers import gs as tgs

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
L = 0.05


@pytest.fixture(autouse=True)
def _restore_port_config():
    snap = dataclasses.asdict(ecw_cc_torch.get_config())
    yield
    ecw_cc_torch.set_config(**snap)


@pytest.fixture(scope="module")
def system(h2o_631g):
    """H2O/6-31G: the JAX fixture's ERIs in both packages (alternating,
    dense ladder at nvir 16), and sorted with a SectoredVVVV."""
    mol, ghf, eris_host, eris = h2o_631g
    er_s, sect = j_build_eris_device(mol, ghf, dtype="float64",
                                     pack_ladder=True, sort_spin=True)
    er_s_t, sect_t = from_numpy(er_s, sect, **F64)
    return dict(mol=mol, ghf=ghf, eris=eris, eris_t=from_numpy(eris, **F64),
                er_s=er_s, sect=sect, er_s_t=er_s_t, sect_t=sect_t,
                perm=jl.spin_sort_perm(ghf.orbspin, eris_host.nocc),
                target=np.diag(np.asarray(ghf.mo_occ, dtype=np.float64)))


def _solvers(s, route, **kw):
    """(JAX solver, port solver) on one route: 'dense' (alternating) or
    'sectored' (sorted, mirror symmetry)."""
    def exp(cls):
        return cls(L, [[["mat", s["target"]]]], mol=s["mol"],
                   mo_coeff=s["ghf"].mo_coeff)
    args = dict(conv="tl", conv_thres=1e-9, diis="tl", maxiter=60)
    args.update(kw)
    if route == "sectored":
        return (JSolver(JGCC(s["er_s"]), exp(JExp), vvvv_op=s["sect"],
                        mo_perm=s["perm"], **args),
                tgs.Solver_CCSD(TGCC(s["er_s_t"]), exp(TExp),
                                vvvv_op=s["sect_t"], mo_perm=s["perm"],
                                **args))
    return (JSolver(JGCC(s["eris"]), exp(JExp), **args),
            tgs.Solver_CCSD(TGCC(s["eris_t"]), exp(TExp), **args))


def _amps(out):
    return [np.asarray(a, dtype=np.float64) for a in out[5]]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_matmul_precision_sets_and_restores_the_flags():
    """Each mode's torch setting inside, the previous flags after, also
    after an exception; 'highest' (TF32 off) outside any."""
    want = {"highest": ("highest", False), "high": ("high", True),
            "default": ("medium", True), "bf16": ("medium", True)}
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32) == ("highest", False)
    assert config.active_precision() == "highest"
    for mode, flags in want.items():
        with config.matmul_precision(mode):
            assert config.active_precision() == mode
            assert (torch.get_float32_matmul_precision(),
                    torch.backends.cuda.matmul.allow_tf32) == flags
            assert torch.backends.cudnn.allow_tf32 is False
            with config.matmul_precision("highest"):
                assert not torch.backends.cuda.matmul.allow_tf32
            assert config.active_precision() == mode
        assert config.active_precision() == "highest"
    with pytest.raises(KeyError):
        with config.matmul_precision("high"):
            raise KeyError("inside a solve")
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == ("highest", False, False)
    assert config.active_precision() == "highest"
    with pytest.raises(ValueError, match="matmul_precision"):
        with config.matmul_precision("hybrid"):
            pass


# ---------------------------------------------------------------------------
# the kernel variants' plain versions and the wrapper
# ---------------------------------------------------------------------------

def _f32(bits):
    return float(np.array([bits], dtype=np.uint32).view(np.float32)[0])


TF32_EDGES = [
    (1.0, 1.0),
    (1 + 2 ** -11, 1 + 2 ** -10),               # a tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -11 - 2 ** -23, 1.0),             # just below the tie
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),            # a tie with an odd lsb
    (2 - 2 ** -23, 2.0),                        # carry into the exponent
    (_f32(0x7F7FFFFF), float("inf")),           # the largest f32
    (-_f32(0x7F7FFFFF), float("-inf")),
    (float("inf"), float("inf")),
    (_f32(0x00000001), 0.0),                    # the smallest subnormal
    (_f32(0x00001000), _f32(0x00002000)),       # a subnormal tie
    (0.0, 0.0),
]


def test_round_tf32_follows_the_bit_rule():
    """cvt.rna.tf32.f32: nearest with 10 mantissa bits, ties away from
    zero, on edge values; NaN stays NaN; on random values the low 13 bits
    are clear and the error at most half a TF32 ulp."""
    x = torch.tensor([a for a, _ in TF32_EDGES], dtype=torch.float32)
    want = torch.tensor([b for _, b in TF32_EDGES], dtype=torch.float32)
    got = lmm.round_tf32(x)
    assert torch.equal(got, want), (got.tolist(), want.tolist())
    assert torch.signbit(lmm.round_tf32(torch.tensor([-0.0])))[0]
    nan = lmm.round_tf32(torch.tensor([float("nan"), _f32(0x7F800001)]))
    assert torch.isnan(nan).all()
    r = torch.tensor(np.random.default_rng(3).standard_normal(4096)
                     * 10.0 ** np.random.default_rng(4).integers(
                         -30, 30, 4096), dtype=torch.float32)
    t = lmm.round_tf32(r)
    assert not (t.view(torch.int32) & 0x1FFF).any()
    ulp = 2.0 ** (torch.floor(torch.log2(r.abs().double())) - 10)
    assert ((t.double() - r.double()).abs() <= 0.5 * ulp).all()


def test_variants_plain_versions_and_refusals():
    """tf32: the rounded operands' f32 product; bf16: bf16 out of an f32
    sum; a dtype or precision without a kernel raises, on either device."""
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.standard_normal((37, 129)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((51, 129)), dtype=torch.float32)
    c = lmm.ladder_mm(a, b, precision="tf32")
    assert c.dtype == torch.float32
    assert torch.equal(c, lmm.round_tf32(a) @ lmm.round_tf32(b).T)
    ref = (a.double() @ b.double().T)
    assert 1e-6 < float((c - ref).abs().max() / ref.abs().max()) < 2e-3
    cb = lmm.ladder_mm(a.bfloat16(), b.bfloat16())
    assert cb.dtype == torch.bfloat16
    exact = a.bfloat16().double() @ b.bfloat16().double().T
    assert float((cb.double() - exact).abs().max()) <= (
        2 ** -8 * float(exact.abs().max()))
    assert torch.equal(lmm.ladder_mm(a, b), a @ b.T)
    assert [lmm.variant(d, p) for d, p in (
        (torch.float32, None), (torch.float64, None),
        (torch.float32, "tf32"), (torch.bfloat16, None))] == list(
            lmm.VARIANTS)
    for d, p in ((torch.float16, None), (torch.float64, "tf32"),
                 (torch.bfloat16, "tf32"), (torch.float32, "fp8")):
        with pytest.raises(TypeError, match="no kernel"):
            lmm.ladder_mm(torch.zeros(2, 3, dtype=d),
                          torch.zeros(4, 3, dtype=d), precision=p)
    with pytest.raises(TypeError):
        lmm.plan(98, 465, 465, torch.float16, 132)


@pytest.mark.parametrize("precision,dtype", [("tf32", torch.float32),
                                             (None, torch.bfloat16)])
def test_no_gradient_through_a_reduced_precision_product(precision, dtype):
    a = torch.randn(6, 5, dtype=dtype, requires_grad=True)
    b = torch.randn(7, 5, dtype=dtype)
    c = lmm.ladder_mm(a, b, symmetric=False, precision=precision)
    with pytest.raises(RuntimeError, match="reduced-precision solve"):
        c.float().sum().backward()
    with pytest.raises(RuntimeError, match="detach it"):
        lmm.ladder_mm(a.detach(), b.requires_grad_(), precision=precision)


def test_bf16_rows_and_operand_casts(system):
    """The per-solve bf16 copies of the ladder operands keep their values
    and get 16-byte rows; an aligned bf16 operand passes untouched."""
    sect = system["sect_t"]
    bf = sect.to(torch.bfloat16)
    for w, w16 in zip(sect, bf):
        assert w16.dtype == torch.bfloat16 and w16.shape == w.shape
        assert w16.stride(1) == 1 and w16.stride(0) % lmm.BF16_ROW_ALIGN == 0
        assert torch.equal(w16.float(), w.to(torch.bfloat16).float())
    packed = tl.pack_vvvv(system["eris_t"].vvvv)
    p16 = packed.to(torch.bfloat16)
    assert p16.wc.shape == packed.wc.shape and p16.wc.stride(0) % 8 == 0
    assert lmm.bf16_rows(p16.wc) is p16.wc
    assert packed.to(torch.float32).wc.dtype == torch.float32


def test_tf32_rows_is_a_padded_rounded_view():
    """tf32_rows: round_tf32's values in zero-filled rows of a multiple of
    4 floats (16 bytes), as a view of the first K columns that the wrapper
    knows as rounded; rounding is idempotent, so the TF32 plain version
    gives the same bits on it."""
    rng = np.random.default_rng(8)
    for n, k in ((7, 13), (5, 16), (3, 1), (4, 3)):
        x = torch.tensor(rng.standard_normal((n, k)), dtype=torch.float32)
        r = lmm.tf32_rows(x)
        assert r.shape == x.shape and r.stride() == (-(-k // 4) * 4, 1)
        assert r.data_ptr() % 16 == 0 and r.dtype == torch.float32
        assert torch.equal(r, lmm.round_tf32(x))
        assert not r._base[:, k:].any()
        assert lmm.is_tf32_rows(r) and not lmm.is_tf32_rows(x)
        assert not lmm.is_tf32_rows(r[:, :k])     # another view
    a = torch.tensor(rng.standard_normal((37, 129)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((51, 129)), dtype=torch.float32)
    assert torch.equal(lmm.ladder_mm_plain(a, lmm.tf32_rows(b), "tf32"),
                       lmm.ladder_mm_plain(a, b, "tf32"))
    assert torch.equal(lmm.ladder_mm(a, lmm.tf32_rows(b), precision="tf32"),
                       lmm.ladder_mm(a, b, precision="tf32"))


def test_tf32_operand_casts_and_padded_rows(system):
    """The per-solve TF32 copies of the ladder operands ('tf32' in
    PackedVVVV.to and SectoredVVVV.to) are tf32_rows of every block; under
    a TF32 mode the packed route's A rows are gathered into 16-byte rows
    (no launch copies them), and the product is unchanged."""
    sect = system["sect_t"]
    s32 = sect.to(torch.float32).to("tf32")
    for w, wt in zip(sect, s32):
        assert lmm.is_tf32_rows(wt)
        assert torch.equal(wt, lmm.round_tf32(w.float()))
    packed = tl.pack_vvvv(system["eris_t"].vvvv.float())
    pt = packed.to("tf32")
    assert lmm.is_tf32_rows(pt.wc) and pt.wc.stride(0) % 4 == 0
    rng = np.random.default_rng(9)
    v = system["eris_t"].vvvv.shape[0]
    x = torch.tensor(rng.standard_normal((3, 5, v, v)), dtype=torch.float32)
    x = x - x.transpose(2, 3)
    with config.matmul_precision("high"):
        assert tl._row_align(x) == lmm.TF32_ROW_ALIGN
        xc = tl._pack_pairs(x.reshape(15, v * v), v, tl._row_align(x))
        assert xc.stride(0) % 4 == 0 and xc.shape == (15, v * (v - 1) // 2)
        assert torch.equal(xc, tl._pack_pairs(x.reshape(15, v * v), v))
        assert torch.equal(tl.packed_vvvv_contract(pt, x),
                           tl.packed_vvvv_contract(packed, x))
    assert tl._row_align(x) == 1
    assert tl._row_align(x.bfloat16()) == lmm.BF16_ROW_ALIGN


def test_high_solve_with_the_per_solve_operand_matches_without(system,
                                                               monkeypatch):
    """An f32 'high' solve on the sectored route reads the per-solve TF32
    operand (tf32_rows) in its ladder products, and gives the same Ep and
    iterations as the same solve that hands the raw f32 operand to every
    product (rounded there instead)."""
    from ecw_cc_torch.models.eris import from_numpy as fn

    er32, sect32 = fn(system["er_s"], system["sect"], dtype=torch.float32,
                      device="cpu")

    def solver():
        def exp():
            return TExp(L, [[["mat", system["target"]]]], mol=system["mol"],
                        mo_coeff=system["ghf"].mo_coeff)
        return tgs.Solver_CCSD(TGCC(er32), exp(), vvvv_op=sect32,
                               mo_perm=system["perm"], conv="tl",
                               conv_thres=1e-6, diis="tl", maxiter=60)

    seen = []
    real = lmm.ladder_mm

    def spy(a, b, *args, **kw):
        seen.append(lmm.is_tf32_rows(b))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(tl, "ladder_mm", spy)
    ecw_cc_torch.set_config(iter_precision="high")
    s1 = solver()
    out1 = s1.SCF(L)
    assert seen and all(seen)
    monkeypatch.setattr(tgs, "TF32_MODES", ())
    seen.clear()
    s2 = solver()
    out2 = s2.SCF(L)
    assert seen and not any(seen)
    assert s1.last_solve["route"] == "sectored"
    assert "Convergence reached" in out1[0]
    assert s1.last_solve["iterations"] == s2.last_solve["iterations"]
    assert out1[1][-1] == out2[1][-1]


def test_promoting_einsum_matches_jax_promotion():
    x = torch.randn(3, 4, dtype=torch.bfloat16)
    y = torch.randn(4, 5, dtype=torch.float32)
    z = einsum("ij,jk->ik", x, y)
    assert z.dtype == torch.float32
    assert torch.equal(z, torch.einsum("ij,jk->ik", x.float(), y))
    assert einsum("ij,jk->ik", x, x.T.contiguous()).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["dense", "sectored"])
def test_bf16_iteration_matches_jax(system, route, monkeypatch):
    """One 'bf16' loop iteration from the same f64 amplitudes in both
    packages: the t/lambda updates read bf16 ERI blocks, ladder operand
    and amplitudes beside an f64 fock, and land within 2^-7 max of the
    JAX package's; the f64 step is visibly elsewhere."""
    jsolver, tsolver = _solvers(system, route, diis="", conv_thres=0.0,
                                maxiter=4)
    start = _amps(jsolver.SCF_device(L))       # 5 f64 iterations
    jcfg.set_config(iter_precision="bf16")
    ecw_cc_torch.set_config(iter_precision="bf16")
    jsolver, tsolver = _solvers(system, route, diis="", conv_thres=0.0,
                                maxiter=0)
    seen = []
    upd = "tupdate_sect" if route == "sectored" else "tupdate"
    real = getattr(tgs.ccsd_sect if route == "sectored" else tgs.ccsd_ops,
                   upd)

    def spy(eris, t1, t2, *args, **kw):
        fsp = kw.get("fsp", args[0] if args else None)
        seen.append((eris.oovv.dtype, eris.fock.dtype, t1.dtype, t2.dtype,
                     fsp.dtype))
        return real(eris, t1, t2, *args, **kw)

    monkeypatch.setattr(tgs.ccsd_sect if route == "sectored"
                        else tgs.ccsd_ops, upd, spy)
    out_j = jsolver.SCF_device(L, *start)
    out_t = tsolver.SCF(L, *start)
    assert tsolver.last_solve["route"] == route
    assert tsolver.last_solve["legs"][0][:2] == ("bf16", 1)
    bf, f64 = torch.bfloat16, torch.float64
    assert seen == [(bf, f64, bf, bf, bf)]
    ecw_cc_torch.set_config(iter_precision="highest")
    out_h = _solvers(system, route, diis="", conv_thres=0.0,
                     maxiter=0)[1].SCF(L, *start)
    for a, b, h in zip(_amps(out_t), _amps(out_j), _amps(out_h)):
        assert a.dtype == np.float64
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 2 ** -7 * scale
        assert np.abs(h - b).max() > 1e-6 * scale


@pytest.mark.parametrize("fast", ["high", "bf16"])
def test_hybrid_lands_on_the_highest_fixed_point(system, fast):
    """'hybrid' (a leg at hybrid_fast, a fresh DIIS ring, then 'highest' to
    conv_thres) ends where the 'highest' solve ends (Ep to 1e-9, amplitudes
    to 1e-7) and where the JAX hybrid solve ends; the iteration and
    history counters run across both legs."""
    out_ref = _solvers(system, "dense")[1].SCF(L)
    jcfg.set_config(iter_precision="hybrid", hybrid_fast=fast)
    ecw_cc_torch.set_config(iter_precision="hybrid", hybrid_fast=fast)
    jsolver, tsolver = _solvers(system, "dense")
    out_j = jsolver.SCF_device(L)
    out_h = tsolver.SCF(L)
    legs = tsolver.last_solve["legs"]
    assert [m for m, _, _ in legs] == [fast, "highest"]
    assert legs[0][1] >= 1 and legs[1][1] >= 1
    assert sum(n for _, n, _ in legs) == tsolver.last_solve["iterations"]
    assert len(out_h[1]) == tsolver.last_solve["iterations"]
    assert "Convergence reached" in out_h[0]
    assert abs(out_h[1][-1] - out_ref[1][-1]) <= 1e-9
    assert abs(out_h[1][-1] - out_j[1][-1]) <= 1e-9
    for a, b, c in zip(_amps(out_h), _amps(out_ref), _amps(out_j)):
        assert np.abs(a - b).max() <= 1e-7
        assert np.abs(a - c).max() <= 1e-7


def test_hybrid_stall_ends_the_fast_leg(system):
    """A hybrid_switch below what the fast leg can reach: the leg ends on
    the stall rule (3 iterations without a new best below 0.95 best), not
    on its threshold, and the 'highest' leg finishes."""
    ecw_cc_torch.set_config(iter_precision="hybrid", hybrid_fast="bf16",
                            hybrid_switch=1e-12)
    tsolver = _solvers(system, "dense", conv_thres=1e-8)[1]
    out = tsolver.SCF(L)
    (fast, n_fast, d_fast), (slow, n_slow, d_slow) = (
        tsolver.last_solve["legs"])
    assert (fast, slow) == ("bf16", "highest")
    assert d_fast > 1e-8 and n_fast < 60 and d_slow <= 1e-8
    assert "Convergence reached" in out[0]


def test_refine_recovers_f64_parity():
    """SCF(refine=True): an f32 solve plus 6 f64 polish iterations equals
    the f64 solve (Ep to 1e-8, amplitudes to 1e-7, f64 amplitudes); the
    raw f32 solve does not (JAX test_scf_device_refine_recovers_f64_
    parity), closer than the raw f32 solve."""
    e64 = ECW("h2o", "6-31g", **F64)
    e32 = ECW("h2o", "6-31g", device="cpu", dtype=torch.float32)
    target = np.diag(e64.mo_occ)

    def make(ecw, host=None, thres=1e-7):
        exp = TExp(L, [[["mat", target]]], mol=ecw.mol,
                   mo_coeff=ecw.mo_coeff)
        return tgs.Solver_CCSD(TGCC(ecw.eris), exp, conv="tl",
                               conv_thres=thres, diis="tl", maxiter=60,
                               eris_host=host)

    out64 = make(e64).SCF(L)
    solver = make(e32, host=e32.eris_f64)
    out32 = solver.SCF(L, refine=True)
    assert e32._eris_host is None     # the polish ERIs were built as tensors
    assert abs(out32[1][-1] - out64[1][-1]) < 1e-8
    assert len(out32[1]) == solver.last_solve["iterations"] + 1
    assert solver.last_solve["refine_iterations"] >= 6
    assert out32[4].dtype == np.float64
    for a, b in zip(out32[5], out64[5]):
        assert a.dtype == np.float64
        assert np.abs(a - b).max() < 1e-7
    # the raw f32 solve: f32 amplitudes, farther from the f64 fixed point
    # in Ep and in the amplitudes (the JAX test's 1e-8 gap is its own f32
    # error; the port's f32 solve lands closer, so the polish is held to
    # halving it)
    raw = make(e32, host=e32.eris_f64).SCF(L)
    assert raw[5][0].dtype == np.float32

    def gaps(o):
        return (abs(o[1][-1] - out64[1][-1]),
                sum(np.abs(a - b).max() for a, b in zip(o[5], out64[5])))

    assert all(r > 2 * p for r, p in zip(gaps(raw), gaps(out32)))
    with pytest.raises(ValueError, match="eris_host"):
        make(e32).SCF(L, refine=True)
    with pytest.raises(TypeError, match="GEris"):
        make(e32, host=e32.eris_host)
    # from a coarse 'bf16' solve the polish runs past its six iterations
    # until Ep settles, and still lands on f64
    ecw_cc_torch.set_config(iter_precision="bf16")
    coarse = make(e32, host=e32.eris_f64, thres=1e-3)
    out_bf = coarse.SCF(L, refine=True)
    assert coarse.last_solve["refine_iterations"] > 6
    assert abs(out_bf[1][-1] - out64[1][-1]) < 1e-8


def test_ccsd_gs_refine_through_driver():
    """ECW.CCSD_GS(refine=True) at f32 returns f64-parity energies and f64
    amplitudes; the raw f32 sweep is farther from it (JAX
    test_ccsd_gs_refine_through_driver)."""
    def run(dtype, refine):
        ecw = ECW("h2o", "6-31g", device="cpu", dtype=dtype)
        ecw.Build_GS_exp("mat", "HF", field=[0.05, 0.01, 0.0])
        out = ecw.CCSD_GS([0.1], conv_thres=1e-7, maxiter=60, diis="tl",
                          refine=refine)
        # at f32 the polish ERIs come from the device transform
        assert ecw._eris_host is None or dtype == torch.float64
        return out

    r64 = run(torch.float64, False)
    r32 = run(torch.float32, True)
    r32_raw = run(torch.float32, False)
    assert abs(r32[1][-1] - r64[1][-1]) < 1e-8
    assert r32[5][0].dtype == np.float64
    assert r32_raw[5][0].dtype == np.float32
    assert abs(r32_raw[1][-1] - r64[1][-1]) > 2 * abs(r32[1][-1] - r64[1][-1])


def test_precision_change_between_calls_takes_effect(system):
    """A precision set between two SCF calls on one solver is the one the
    second call runs (JAX test_solver_cache_respects_precision_change)."""
    solver = _solvers(system, "dense", conv_thres=1e-8)[1]
    out1 = solver.SCF(L)
    assert [m for m, _, _ in solver.last_solve["legs"]] == ["highest"]
    ecw_cc_torch.set_config(iter_precision="hybrid")
    out2 = solver.SCF(L)
    assert solver.last_solve["precision"] == "hybrid"
    assert [m for m, _, _ in solver.last_solve["legs"]] == ["high",
                                                            "highest"]
    assert abs(out1[1][-1] - out2[1][-1]) < 1e-9


def test_runner_takes_precision_and_refine():
    """`python -m ecw_cc_torch`'s config block takes the new fields, and a
    `refine` key of the run reaches CCSD_GS."""
    from ecw_cc_torch.__main__ import run_spec

    out = run_spec({"molecule": "h2", "basis": "6-31g", "device": "cpu",
                    "dtype": "float32",
                    "config": {"iter_precision": "hybrid",
                               "hybrid_fast": "bf16",
                               "hybrid_switch": 1e-3},
                    "run": {"solver": "CCSD_GS", "Larray": [0.2],
                            "diis": "tl", "conv_thres": 1e-7,
                            "refine": True}})
    assert "Convergence reached" in out[0]
    assert out[5][0].dtype == np.float64
    assert ecw_cc_torch.get_config().hybrid_fast == "bf16"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# the route shapes (C2H2 at cc-pVDZ), the sector shapes, the split-K plan's
# edges (ragged K across chunk boundaries, one row, two row tiles) and K
# not a multiple of 8 (the bf16 row padding)
CARD_SHAPES = [(392, 1891, 1891), (196, 3844, 3844), (392, 961, 961),
               (98, 465, 465), (98, 961, 961), (98, 465, 240),
               (98, 465, 241), (98, 465, 257), (98, 961, 959),
               (98, 465, 15), (1, 961, 961), (129, 465, 465), (37, 513, 129),
               (100, 130, 1001),
               # the 128 x 128 tile's edges: one and two row tiles, a
               # cluster of four row tiles, K 1-3 past a multiple of 4 and 8
               (64, 465, 465), (65, 465, 465), (128, 961, 961),
               (392, 465, 465), (98, 961, 961 - 6), (98, 961, 961 - 4),
               (98, 465, 463), (392, 1891, 1889)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("var", ["tf32", "bf16"])
def test_tensor_core_variants_match_plain_on_card(var, shape):
    """The TF32 and BF16 kernels against their plain versions on the same
    card inputs: TF32 within 1e-5 max|C| (f32 sums in another order); BF16
    against the plain version's f32 sum before its rounding, within
    2^-8 max|C| (the rounding) plus the f32 accumulation bound
    K 2^-24 max(|A| |B|^T); each launch counted under its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    M, N, K = shape
    rng = np.random.default_rng(sum(shape))
    dt = torch.bfloat16 if var == "bf16" else torch.float32
    a = torch.tensor(rng.standard_normal((M, K)), dtype=dt, device="cuda")
    b = torch.tensor(rng.standard_normal((N, K)), dtype=dt, device="cuda")
    prec = "tf32" if var == "tf32" else None
    before = dict(lmm.ladder_mm.launches_by_variant)
    c = lmm.ladder_mm(a, b, precision=prec)
    torch.cuda.synchronize()
    with config.matmul_precision("highest"):
        if var == "tf32":
            ref = lmm.ladder_mm_plain(a, b, prec)
            tol = 1e-5 * float(ref.abs().max())
        else:
            ref = a.float() @ b.float().T
            tol = (2 ** -8 * float(ref.abs().max()) + K * 2 ** -24
                   * float((a.float().abs() @ b.float().abs().T).max()))
    err = float((c.float() - ref).abs().max())
    assert c.dtype == dt and err <= tol, (err, tol)
    assert lmm.ladder_mm.launches_by_variant[var] == before[var] + 1
    assert torch.equal(c, lmm.ladder_mm(a, b, precision=prec))


@pytest.mark.gpu
def test_reduced_variants_raise_on_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.zeros(4, 8, dtype=torch.float16, device="cuda")
    with pytest.raises(TypeError, match="no kernel"):
        lmm.ladder_mm(a, a)
    x = torch.zeros(4, 8, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError, match="no kernel"):
        lmm.ladder_mm(x, x, precision="tf32")
