"""The f64 ladder operands of csrc/ladder_mm_f64tc.cu on the CPU: f64_rows,
_cast, pack_vvvv, _pack_pairs and the device packed build give rows of a
whole 16 bytes (the kernel's TMA loads) with the values unchanged; ECW's
f64 packed and dense routes, and the f64 polish, solve on such operands
and land on the JAX package's f64 sweep; the f64 plain version equals the
JAX package's XLA ladder product."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ecw_cc_torch
from ecw_cc_torch.kernels import ladder_mm as lmm
from ecw_cc_torch.models import eris as port_eris
from ecw_cc_torch.ops import ladder as tl
from ecw_cc_tpu.ops import ladder as jl
from gauge import jax_gauge

torch.set_num_threads(1)

F64 = torch.float64
FIELD = [0.05, 0.01, 0.0]


def _has_f64_rows(x):
    return (x.stride(-1) == 1 and x.stride(0) % lmm.F64_ROW_ALIGN == 0
            and x.data_ptr() % 16 == 0)


def _antisymmetric_vvvv(v, seed):
    """A random <ab||ef>-like block: antisymmetric in a<->b and e<->f and
    symmetric under the pair swap."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((v, v, v, v))
    w = w - w.transpose(1, 0, 2, 3)
    w = w - w.transpose(0, 1, 3, 2)
    return w + w.transpose(2, 3, 0, 1)


@pytest.mark.parametrize("n,k", [(7, 13), (5, 16), (3, 1), (4, 1891),
                                 (1, 3)])
def test_f64_rows_is_a_padded_view_of_the_same_values(n, k):
    rng = np.random.default_rng(n * k)
    x = torch.tensor(rng.standard_normal((n, k)), dtype=F64)
    r = lmm.f64_rows(x)
    assert r.shape == x.shape and r.dtype == F64 and torch.equal(r, x)
    assert _has_f64_rows(r) and r.stride(0) == -(-k // 2) * 2
    if k % 2:
        assert r.data_ptr() != x.data_ptr() and not r._base[:, k:].any()
    assert lmm.f64_rows(r) is r                  # already in TMA rows
    assert lmm.tma_rows(r) is r
    y = lmm.f64_rows(x.float())                  # cast on the way
    assert y.dtype == F64 and torch.equal(y, x.float().double())
    assert _has_f64_rows(y)


def test_cast_pack_vvvv_and_pack_pairs_give_f64_rows():
    """p = 21 (v = 7) is odd: the packed operand from pack_vvvv and the
    packed rows of a product's A are written into 16-byte rows by their
    gathers, equal to the JAX package's packing; a cast of an unpadded
    block pads it once."""
    v = 7
    w = _antisymmetric_vvvv(v, 3)
    packed = tl.pack_vvvv(torch.tensor(w))
    p = v * (v - 1) // 2
    assert packed.wc.shape == (p, p) and _has_f64_rows(packed.wc)
    np.testing.assert_array_equal(packed.wc.numpy(),
                                  np.asarray(jl.pack_vvvv(jnp.asarray(w)).wc))
    assert packed.to(F64).wc is packed.wc        # no copy per solve
    odd = packed.wc.contiguous()
    assert not _has_f64_rows(odd)
    cast = tl._cast(odd, F64)
    assert _has_f64_rows(cast) and torch.equal(cast, odd)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((3, 5, v, v)), dtype=F64)
    x = x - x.transpose(2, 3)
    assert tl._row_align(x) == lmm.F64_ROW_ALIGN
    xc = tl._pack_pairs(x.reshape(15, v * v), v, tl._row_align(x))
    assert xc.shape == (15, p) and _has_f64_rows(xc)
    assert torch.equal(xc, tl._pack_pairs(x.reshape(15, v * v), v))
    ref = tl.packed_vvvv_contract(tl.PackedVVVV(wc=odd), x)
    assert torch.equal(tl.packed_vvvv_contract(packed, x), ref)


def test_device_packed_f64_build_has_f64_rows():
    """build_eris_device(pack_ladder=True) at f64 (phase 7's f64 twin on
    the card) writes its PackedVVVV into 16-byte rows (C2H2/6-31G: p =
    435) with the values of pack_vvvv on the dense build."""
    from ecw_cc_torch.models.molecule import Molecule
    from ecw_cc_torch.models.scf import GHF, RHF

    mol = Molecule("c2h2", "6-31g", charge=0, spin=0)
    mf = RHF(mol, conv_tol=1e-11)
    mf.kernel()
    ghf = GHF(mf)
    _, op = port_eris.build_eris_device(mol, ghf, dtype=F64, device="cpu",
                                        pack_ladder=True)
    dense = port_eris.build_eris_device(mol, ghf, dtype=F64, device="cpu")
    ref = tl.pack_vvvv(dense.vvvv).wc
    assert op.wc.shape == ref.shape == (435, 435)
    assert _has_f64_rows(op.wc) and _has_f64_rows(ref)
    # two transforms that sum in other orders: chip_smoke.py phase 6's
    # f64 ERI tolerance
    assert float((op.wc - ref).abs().max()) <= 1e-10


@pytest.mark.parametrize("shape", [(98, 61, 465), (14, 45, 1891),
                                   (196, 30, 900), (37, 13, 129)])
def test_f64_plain_version_equals_the_jax_product(shape):
    """ladder_mm_plain at f64, on operands in 16-byte rows, against the
    JAX package's _ladder_mm_xla (the plain product of its Pallas
    kernel)."""
    from ecw_cc_tpu.ops.ladder import _ladder_mm_xla

    M, N, K = shape
    rng = np.random.default_rng(sum(shape))
    a, b = rng.standard_normal((M, K)), rng.standard_normal((N, K))
    c = lmm.ladder_mm_plain(lmm.f64_rows(torch.tensor(a)),
                            lmm.f64_rows(torch.tensor(b))).numpy()
    cj = np.asarray(_ladder_mm_xla(jnp.asarray(a), jnp.asarray(b)))
    assert cj.dtype == np.float64
    assert np.abs(c - cj).max() <= 1e-13 * np.abs(cj).max()


def _iterations(out):
    return len(out[1])


@contextlib.contextmanager
def _ladder_mode(mode):
    """config.ladder_mode set inside and restored after."""
    old = ecw_cc_torch.get_config().ladder_mode
    ecw_cc_torch.set_config(ladder_mode=mode)
    try:
        yield
    finally:
        ecw_cc_torch.set_config(ladder_mode=old)


def _f64_operands(monkeypatch):
    """Record the row layout of every f64 ladder product's operands (the
    CPU runs the plain version on the operands as the kernel would get
    them)."""
    seen = []
    plain = lmm.ladder_mm_ref

    def recording(a, b):
        if a.dtype == F64:
            seen.append((tuple(a.shape), tuple(b.shape), _has_f64_rows(a),
                         _has_f64_rows(b)))
        return plain(a, b)

    monkeypatch.setattr(lmm, "ladder_mm_ref", recording)
    return seen


@pytest.fixture(scope="module")
def jax_c2h2():
    """The JAX package's f64 sweep at C2H2/6-31G (nvir 30), lambda = 0 and
    0.25, and the JAX ECW for the orbital gauge."""
    from ecw_cc_tpu import ECW as JECW

    ref = JECW("c2h2", "6-31g")
    ref.Build_GS_exp("mat", "HF", field=FIELD)
    out = [ref.CCSD_GS([L], diis="tl", conv_thres=1e-8) for L in (0.0, 0.25)]
    return ref, out


@pytest.mark.parametrize("mode", ["packed", "dense"])
def test_f64_routes_on_padded_operands_match_the_jax_sweep(monkeypatch,
                                                           jax_c2h2, mode):
    """C2H2/6-31G at f64 on the packed route (p = 435, odd: its operand
    and A rows padded) and the dense route (K = 900): every f64 ladder
    product's operands in 16-byte rows, and the sweep takes the JAX
    package's iterations and Ep to 1e-10 Ha at each lambda."""
    ref, out_j = jax_c2h2
    seen = _f64_operands(monkeypatch)
    with _ladder_mode(mode):
        with jax_gauge(ref):
            ecw = ecw_cc_torch.ECW("c2h2", "6-31g", device="cpu", dtype=F64)
        ecw.Build_GS_exp("mat", "HF", field=FIELD)
        out, routes = [], []
        for L in (0.0, 0.25):
            out.append(ecw.CCSD_GS([L], diis="tl", conv_thres=1e-8))
            routes.append(ecw.solve_log[0]["route"])
    assert routes == [mode] * 2
    assert seen and all(ra and rb for _, _, ra, rb in seen)
    K = 435 if mode == "packed" else 900
    assert {b for _, b, _, _ in seen} == {(K, K)}
    for o, oj in zip(out, out_j):
        assert "Convergence reached" in o[0]
        assert _iterations(o) == _iterations(oj)
        assert abs(o[1][-1] - oj[1][-1]) <= 1e-10


def test_f64_polish_on_padded_operands_matches_the_jax_sweep(monkeypatch,
                                                             jax_c2h2):
    """refine=True after an f32 solve at C2H2/6-31G: the f64 polish's
    dense ladder products (196 x 900^2, two an iteration) take operands in
    16-byte rows, and its Ep lands on the JAX package's f64 Ep to 1e-8 Ha
    (the refine's contract, chip_smoke.py phase 12)."""
    ref, out_j = jax_c2h2
    seen = _f64_operands(monkeypatch)
    with _ladder_mode("auto"):
        with jax_gauge(ref):
            ecw = ecw_cc_torch.ECW("c2h2", "6-31g", device="cpu",
                                   dtype=torch.float32)
        ecw.Build_GS_exp("mat", "HF", field=FIELD)
        out = ecw.CCSD_GS([0.25], diis="tl", conv_thres=1e-6, refine=True)
    s = ecw.solve_log[0]
    assert s["refine_iterations"] >= 6
    assert len(seen) == 2 * s["refine_iterations"]
    assert all(ra and rb and b == (900, 900) for _, b, ra, rb in seen)
    assert abs(float(out[1][-1]) - out_j[1][1][-1]) <= 1e-8


def test_f64_packed_route_at_nvir_62_matches_the_jax_sweep(monkeypatch):
    """C2H2/cc-pVDZ (nvir 62): ECW's default f64 route packs the ladder
    ('auto' from nvir 48; p = 1891, odd) on operands in 16-byte rows, and
    lambda = 0.25 takes the JAX package's iterations and Ep to 1e-10 Ha."""
    from ecw_cc_tpu import ECW as JECW

    ref = JECW("c2h2", "cc-pvdz")
    ref.Build_GS_exp("mat", "HF", field=FIELD)
    out_j = ref.CCSD_GS([0.25], diis="tl", conv_thres=1e-8)
    seen = _f64_operands(monkeypatch)
    with _ladder_mode("auto"):
        with jax_gauge(ref):
            ecw = ecw_cc_torch.ECW("c2h2", "cc-pvdz", device="cpu",
                                   dtype=F64)
        ecw.Build_GS_exp("mat", "HF", field=FIELD)
        out = ecw.CCSD_GS([0.25], diis="tl", conv_thres=1e-8)
    assert ecw.solve_log[0]["route"] == "packed"
    assert seen and all(ra and rb and b == (1891, 1891)
                        for _, b, ra, rb in seen)
    assert _iterations(out) == _iterations(out_j)
    assert abs(out[1][-1] - out_j[1][-1]) <= 1e-10
