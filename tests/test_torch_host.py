"""The PyTorch port's own host front end (ecw_cc_torch.{native,models,utils})
against the JAX package's originals it copies, f64 on H2O/6-31G: the same
inputs through both give the same numbers to 1e-12."""

import os
import platform

import numpy as np
import pytest
import torch

from ecw_cc_tpu.models import basis_io as j_basis_io
from ecw_cc_tpu.models.eris import build_eris as j_build_eris
from ecw_cc_tpu.models.molecule import Molecule as JMolecule
from ecw_cc_tpu.models.scf import GHF as JGHF
from ecw_cc_tpu.models.scf import RHF as JRHF
from ecw_cc_tpu.models.scf import UHF as JUHF
from ecw_cc_tpu.utils import convert as jconvert
from ecw_cc_tpu.utils import props as jprops
from ecw_cc_tpu.utils.metrics import IterationMetrics as JMetrics
from ecw_cc_torch.models import basis_io, eris as teris
from ecw_cc_torch.models.molecule import Molecule
from ecw_cc_torch.models.scf import GHF, RHF, UHF
from ecw_cc_torch.utils import checkpoint, convert, props
from ecw_cc_torch.utils.metrics import IterationMetrics
from gauge import flip, ghf_signs

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture(scope="module")
def pair():
    """(port, JAX) molecule, RHF and GHF on H2O/6-31G."""
    out = {}
    for key, (Mol, R, G) in {"t": (Molecule, RHF, GHF),
                             "j": (JMolecule, JRHF, JGHF)}.items():
        mol = Mol("h2o", "6-31g")
        mf = R(mol, conv_tol=1e-11)
        mf.kernel()
        out[key] = dict(mol=mol, rhf=mf, ghf=G(mf))
    return out


@pytest.mark.parametrize("kind", ["ovlp", "kin", "nuc", "r", "int2e"])
def test_integrals_match_jax(pair, kind):
    a = pair["t"]["mol"].intor(kind)
    b = pair["j"]["mol"].intor(kind)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_native_engine_builds_outside_the_source_tree():
    from ecw_cc_torch import native

    if not native.available():
        pytest.skip("no C++ toolchain")
    path = native._lib_path()
    assert f"{os.sep}_build{os.sep}" in path
    assert os.path.dirname(path) != os.path.dirname(native._SRC)


def test_native_binary_is_keyed_on_host_and_command(monkeypatch):
    """A binary built on another machine, or with other flags, has another
    name, so it is never loaded here (-march=native differs per host)."""
    from ecw_cc_torch import native

    here = native._lib_path()
    assert native._host().startswith(platform.machine())
    monkeypatch.setattr(native, "_host", lambda: "x86_64|avx512f fma sse2")
    assert native._lib_path() != here
    monkeypatch.undo()
    assert native._lib_path() == here
    monkeypatch.setattr(native, "_CMD", native._CMD + ("-ffp-contract=off",))
    assert native._lib_path() != here


@pytest.mark.parametrize("which", ["rhf", "ghf"])
def test_scf_matches_jax(pair, which):
    a, b = pair["t"][which], pair["j"][which]
    assert abs(a.e_tot - b.e_tot) < TOL
    np.testing.assert_allclose(a.mo_energy, b.mo_energy, rtol=0, atol=TOL)
    np.testing.assert_array_equal(a.mo_occ, b.mo_occ)
    np.testing.assert_allclose(a.make_rdm1(), b.make_rdm1(), rtol=0,
                               atol=TOL)
    if which == "ghf":
        np.testing.assert_array_equal(a.orbspin, b.orbspin)


def test_uhf_matches_jax(pair):
    """UHF (with its DIIS) on the triplet O2 / STO-3G."""
    out = []
    for Mol, U in ((Molecule, UHF), (JMolecule, JUHF)):
        mf = U(Mol("O 0 0 0\nO 0 0 1.21", "sto-3g", spin=2))
        out.append((mf.kernel(), mf))
    (ea, a), (eb, b) = out
    assert abs(ea - eb) < TOL
    for x, y in zip(a.mo_energy, b.mo_energy):
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL)


def test_eris_host_matches_jax(pair):
    """The MO blocks compared in one orbital gauge (tests/gauge.py)."""
    a = teris.build_eris(pair["t"]["mol"], pair["t"]["ghf"])
    b = j_build_eris(pair["j"]["mol"], pair["j"]["ghf"])
    assert (a.nocc, a.nvir) == (b.nocc, b.nvir)
    d = ghf_signs(pair["t"]["ghf"], pair["j"]["ghf"], pair["t"]["mol"])
    for f in teris.GEris._fields:
        kinds = "nn" if f == "fock" else f
        np.testing.assert_allclose(flip(getattr(a, f), d, kinds, a.nocc),
                                   getattr(b, f), rtol=0, atol=TOL,
                                   err_msg=f)
    dev = a.to_device(torch.float64, device="cpu")
    assert isinstance(dev, teris.GEris)
    assert torch.equal(dev.vvvv, torch.from_numpy(a.vvvv))


@pytest.mark.parametrize("prop", ["Ekin", "v1e", "dipole"])
@pytest.mark.parametrize("basis", ["ao", "mo", "mo_full"])
def test_props_match_jax(pair, prop, basis):
    """mo_full: an MO rdm1 with every element set, so the MO -> AO transform
    is exercised whole."""
    t, j = pair["t"], pair["j"]
    rdm1 = t["ghf"].make_rdm1()
    kw = dict(aobasis=True, g=True, mo_coeff=t["ghf"].mo_coeff)
    if basis != "ao":
        rdm1 = np.diag(t["ghf"].mo_occ.astype(float))
        if basis == "mo_full":
            r = np.random.default_rng(3).standard_normal(rdm1.shape) * 1e-2
            rdm1 = rdm1 + r + r.T
        kw["aobasis"] = False
    a = getattr(props, prop)(t["mol"], rdm1, **kw)
    b = getattr(jprops, prop)(j["mol"], rdm1, **kw)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_convert_round_trips(pair):
    rng = np.random.default_rng(7)
    r_amp = rng.standard_normal((3, 4))
    g_amp = convert.convert_r_to_g_amp(r_amp)
    np.testing.assert_array_equal(g_amp, jconvert.convert_r_to_g_amp(r_amp))
    np.testing.assert_allclose(convert.convert_g_to_r_amp(g_amp), r_amp,
                               rtol=0, atol=TOL)
    r_rdm = rng.standard_normal((5, 5))
    g_rdm = convert.convert_r_to_g_rdm1(r_rdm)
    np.testing.assert_array_equal(g_rdm, jconvert.convert_r_to_g_rdm1(r_rdm))
    r_back, (a, b) = convert.convert_g_to_ru_rdm1(g_rdm)
    np.testing.assert_allclose(r_back, r_rdm, rtol=0, atol=TOL)
    np.testing.assert_allclose(a, 0.5 * r_rdm, rtol=0, atol=TOL)
    np.testing.assert_allclose(b, 0.5 * r_rdm, rtol=0, atol=TOL)
    mo = pair["t"]["ghf"].mo_coeff
    ao = pair["t"]["ghf"].make_rdm1()
    back = convert.mo_to_ao(convert.ao_to_mo(ao, mo), mo)
    ref = jconvert.mo_to_ao(jconvert.ao_to_mo(ao, mo), mo)
    np.testing.assert_allclose(back, ref, rtol=0, atol=TOL)
    rc = pair["t"]["rhf"].mo_coeff
    np.testing.assert_allclose(
        convert.convert_g_to_r_coeff(convert.convert_r_to_g_coeff(rc)),
        jconvert.convert_g_to_r_coeff(jconvert.convert_r_to_g_coeff(rc)),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("operands", ["real", "complex", "ghf"])
def test_rdm1_basis_changes_are_the_three_operand_einsum(pair, operands):
    """mo_to_ao and ao_to_mo as GEMM chains give the reference's
    einsum('pi,ij,qj->pq') to 1e-14 relative."""
    rng = np.random.default_rng(11)

    def rand(n):
        a = rng.standard_normal((n, n))
        return a + 1j * rng.standard_normal((n, n)) if operands == "complex" \
            else a

    if operands == "ghf":
        mo = pair["t"]["ghf"].mo_coeff
        ao = pair["t"]["ghf"].make_rdm1()
        mo_rdm = np.diag(pair["t"]["ghf"].mo_occ.astype(float))
    else:
        mo = np.eye(16) + 0.1 * rand(16)
        ao = rand(16)
        ao = ao + ao.conj().T
        mo_rdm = rand(16)
        mo_rdm = mo_rdm + mo_rdm.conj().T
    cinv = np.linalg.inv(mo)
    for got, ref in (
            (convert.mo_to_ao(mo_rdm, mo),
             np.einsum("pi,ij,qj->pq", mo, mo_rdm, mo.conj())),
            (convert.ao_to_mo(ao, mo),
             np.einsum("pi,ij,qj->pq", cinv, ao, cinv.conj()))):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
    with pytest.raises(ValueError):
        convert.mo_to_ao(mo_rdm[:-1], mo)
    with pytest.raises(ValueError):
        convert.ao_to_mo(ao[:, :-1], mo)


def test_checkpoint_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    amps = {k: rng.standard_normal((4, 6)) for k in ("ts", "ls")}
    checkpoint.save_amplitudes(tmp_path, 0.25, amps, meta={"Ep": -0.1})
    checkpoint.save_amplitudes(tmp_path, 0.5, amps)
    back = checkpoint.load_amplitudes(tmp_path, 0.25)
    assert back.keys() == amps.keys()
    for k in amps:
        np.testing.assert_array_equal(back[k], amps[k])
    assert checkpoint.load_amplitudes(tmp_path, 0.75) is None
    L, last = checkpoint.last_checkpoint(tmp_path)
    assert L == 0.5 and last.keys() == amps.keys()


def test_checkpoint_reads_across_packages(tmp_path):
    """The port's checkpoint (stored) loads through the JAX copy, and the
    JAX copy's (deflated) through the port, array for array."""
    from ecw_cc_tpu.utils import checkpoint as jcheckpoint

    rng = np.random.default_rng(4)
    amps = {"ts": rng.standard_normal((4, 6)),
            "td": rng.standard_normal((4, 4, 6, 6)).astype(np.float32)}
    for save, load in ((checkpoint, jcheckpoint), (jcheckpoint, checkpoint)):
        d = tmp_path / save.__name__.split(".")[0]
        save.save_amplitudes(str(d), 0.3, amps)
        back = load.load_amplitudes(str(d), 0.3)
        assert back.keys() == amps.keys()
        for k in amps:
            assert back[k].dtype == amps[k].dtype
            np.testing.assert_array_equal(back[k], amps[k])


def test_basis_file_round_trip(tmp_path):
    """A Gaussian94 file written from an embedded set loads back through
    the port's get_basis path branch, as in the JAX copy."""
    from ecw_cc_torch.models.basis_data import BASIS

    table = {el: BASIS["6-31g"][el] for el in ("H", "O")}
    text = basis_io.format_gaussian94(table)
    assert text == j_basis_io.format_gaussian94(table)
    path = tmp_path / "h2o.gbs"
    path.write_text(text)
    a = Molecule("h2o", str(path))
    np.testing.assert_allclose(a.intor("ovlp"),
                               JMolecule("h2o", "6-31g").intor("ovlp"),
                               rtol=0, atol=1e-10)


def test_iteration_metrics_match_jax():
    out = []
    for M in (IterationMetrics, JMetrics):
        m = M(solver="CCSD", L=0.5)
        m.record(0, Ep=-0.1, Delta=0.2)
        m.record(1, Ep=-0.2, Delta=0.1)
        out.append([{k: v for k, v in r.items() if k != "t_wall_s"}
                    for r in m.rows])
    assert out[0] == out[1]



@pytest.mark.parametrize("n", [(20, 20, 20), (7, 13, 11)],
                         ids=["cubic", "uneven"])
def test_cube_density_writes_the_jax_file(pair, tmp_path, n):
    """The port's cube writer (a plane per product and per format) writes
    the JAX writer's file, character for character."""
    from ecw_cc_tpu.utils import output as joutput
    from ecw_cc_torch.utils import output

    dm = pair["t"]["rhf"].make_rdm1()
    got = output.cube_density(pair["t"]["mol"], str(tmp_path / "t"), dm, *n)
    want = joutput.cube_density(pair["j"]["mol"], str(tmp_path / "j"), dm,
                                *n)
    with open(got) as a, open(want) as b:
        assert a.read() == b.read()
