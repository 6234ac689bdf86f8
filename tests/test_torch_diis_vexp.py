"""Parity of the PyTorch port's DIIS ring buffer and ground-state Vexp
(ecw_cc_torch.ops.diis, ops.vexp) with the JAX package on identical f64
inputs, CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecw_cc_tpu.ops import diis as jdiis
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_tpu.ops import vexp as jvexp
from ecw_cc_torch.ops import diis as tdiis
from ecw_cc_torch.ops import vexp as tvexp

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("space,min_space", [(5, 2), (15, 3)])
def test_diis_sequence_matches_jax(space, min_space):
    """20 updates on the same input sequence (iterates approaching a fixed
    point); with space=5 the ring buffer wraps three times."""
    rng = np.random.default_rng(space)
    n = 40
    x_star = rng.standard_normal(n)
    sj = jdiis.diis_init(n, space, dtype=jnp.float64)
    st = tdiis.diis_init(n, space, **F64)
    for step in range(20):
        x = x_star + 0.7 ** step * rng.standard_normal(n)
        sj, xj = jdiis.diis_update(sj, jnp.asarray(x), min_space)
        st, xt = tdiis.diis_update(st, torch.tensor(x), min_space)
        xj = np.asarray(xj)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                                   atol=1e-12 * np.abs(xj).max(),
                                   err_msg=f"step {step}")
        assert st.nvec == int(sj.nvec) and st.head == int(sj.head)
        Bj = np.asarray(sj.B)
        np.testing.assert_allclose(st.B.numpy(), Bj, rtol=0,
                                   atol=1e-12 * np.abs(Bj).max())


def test_diis_singular_system_falls_back():
    """Repeated identical iterates make the Gram matrix zero: the solve is
    singular and both versions return the un-extrapolated iterate."""
    n, space = 8, 4
    sj = jdiis.diis_init(n, space, dtype=jnp.float64)
    st = tdiis.diis_init(n, space, **F64)
    x = np.linspace(0.0, 1.0, n)
    for _ in range(4):
        sj, xj = jdiis.diis_update(sj, jnp.asarray(x), 2)
        st, xt = tdiis.diis_update(st, torch.tensor(x), 2)
        np.testing.assert_array_equal(np.asarray(xj), x)
        np.testing.assert_array_equal(xt.numpy(), x)


TARGETS = {
    "mat": ["mat"],
    "mat+dip": ["mat", "dip"],
    "Ek+v1e+dip": ["Ek", "v1e", "dip"],
}


@pytest.mark.parametrize("hf_prop", [False, True])
@pytest.mark.parametrize("names", list(TARGETS), ids=list(TARGETS))
def test_gs_vexp_device_matches_jax(h2o_631g, names, hf_prop):
    mol, ghf, eris_host, _ = h2o_631g
    nocc = eris_host.nocc
    dim = ghf.mo_coeff.shape[1]
    rng = np.random.default_rng(len(names))
    values = {"mat": np.diag(np.asarray(ghf.mo_occ, dtype=np.float64)),
              "dip": [0.1, -0.2, 0.35], "Ek": 75.3, "v1e": -199.0}
    hf_values = {"mat": np.diag(np.asarray(ghf.mo_occ, np.float64)) * 0.9,
                 "dip": [0.05, -0.1, 0.3], "Ek": 75.0, "v1e": -198.5}
    exp_data = [[[n, values[n]] for n in TARGETS[names]]]
    HF = [[hf_values[n] for n in TARGETS[names]]] if hf_prop else False
    ej = jvexp.Exp(0.3, exp_data, mol, ghf.mo_coeff, HF_prop=HF)
    et = tvexp.Exp(0.3, exp_data, mol, ghf.mo_coeff, HF_prop=HF)
    perm = jl.spin_sort_perm(ghf.orbspin, nocc)
    fj = jvexp.make_gs_vexp_device(ej, perm=perm)
    ft = tvexp.make_gs_vexp_device(et, perm=perm, **F64)
    r = rng.standard_normal((dim, dim)) * 0.05
    rdm1 = r + r.T + np.diag(np.asarray(ghf.mo_occ, np.float64))[
        np.ix_(perm, perm)]
    L = [0.3 + 0.1 * i for i in range(len(TARGETS[names]))]
    Vj, dj, mj = fj(jnp.asarray(rdm1), jnp.asarray(L))
    Vt, dt, mt = ft(torch.tensor(rdm1), L)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), rtol=0,
                               atol=1e-12)
    assert abs(float(dt) - float(dj)) <= 1e-12 * max(1.0, abs(float(dj)))
    assert abs(float(mt) - float(mj)) <= 1e-12 * max(1.0, abs(float(mj)))
    # the host update of both classes agrees as well
    rdm1_alt = rdm1[np.ix_(np.argsort(perm), np.argsort(perm))]
    hj = ej.Vexp_update(rdm1_alt, rdm1_alt, (0, 0), L=0.3)
    ht = et.Vexp_update(rdm1_alt, rdm1_alt, (0, 0), L=0.3)
    # (1e-12, as for the device update above: the port's props._to_ao_r
    # takes two matrix products where the JAX copy takes a three-operand
    # einsum, which moves the property values in the 13th digit)
    np.testing.assert_allclose(ht, hj, rtol=1e-12)
    np.testing.assert_allclose(et.Vexp[0, 0], ej.Vexp[0, 0], rtol=0,
                               atol=1e-12)


def test_to_ao_r_is_two_products(h2o_631g):
    """utils/props._to_ao_r: C gamma C^H as two matrix products equals the
    JAX copy's three-operand einsum, for a real and a complex coefficient
    matrix, and the properties built on it agree."""
    from ecw_cc_tpu.utils import props as jprops
    from ecw_cc_torch.utils import props as tprops

    mol, ghf, _, _ = h2o_631g
    C = np.asarray(ghf.mo_coeff)
    dim = C.shape[1]
    rng = np.random.default_rng(4)
    rdm1 = rng.standard_normal((dim, dim)) * 0.1 + np.diag(
        np.asarray(ghf.mo_occ, np.float64))
    for coeff in (C, C + 0.1j * rng.standard_normal(C.shape)):
        ref = np.einsum("pi,ij,qj->pq", coeff, rdm1, np.conj(coeff))
        for g in (False, True):
            out = tprops._to_ao_r(mol, rdm1, g, False, coeff)
            want = jprops._to_ao_r(mol, rdm1, g, False, coeff)
            assert np.abs(out - want).max() < 1e-12
        assert np.abs(tprops._to_ao_r(mol, rdm1, False, False, coeff)
                      - ref).max() < 1e-12
    for name in ("Ekin", "v1e", "dipole"):
        a = getattr(tprops, name)(mol, rdm1, aobasis=False, mo_coeff=C)
        b = getattr(jprops, name)(mol, rdm1, aobasis=False, mo_coeff=C)
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12 * max(
            1.0, np.abs(np.asarray(b)).max())
    with pytest.raises(ValueError, match="mo_coeff"):
        tprops._to_ao_r(mol, rdm1, True, False, None)


def test_set_config_refuses_unported_precision_modes():
    """iter_precision takes the JAX package's five names (and hybrid_fast
    its three); any other name is refused when it is set, so that no
    solver can be handed a mode it would ignore."""
    import ecw_cc_torch

    for name in ("highest", "high", "default", "bf16", "hybrid"):
        ecw_cc_torch.set_config(iter_precision=name)
        assert ecw_cc_torch.get_config().iter_precision == name
    for name in ("high", "default", "bf16"):
        ecw_cc_torch.set_config(hybrid_fast=name)
        assert ecw_cc_torch.get_config().hybrid_fast == name
    ecw_cc_torch.set_config(iter_precision="highest", hybrid_fast="high")
    for field, name in (("iter_precision", "tf32"), ("iter_precision", ""),
                        ("iter_precision", "medium"),
                        ("hybrid_fast", "highest"),
                        ("hybrid_fast", "hybrid")):
        with pytest.raises(ValueError, match=field):
            ecw_cc_torch.set_config(**{field: name})
    assert ecw_cc_torch.get_config().iter_precision == "highest"
    assert ecw_cc_torch.get_config().hybrid_fast == "high"


def test_exp_rejects_excited_state_targets(h2o_631g):
    """The GS device update takes GS properties only; the ES kinds go
    through make_es_vexp_device (tests/test_torch_es_vexp.py)."""
    mol, ghf, _, _ = h2o_631g
    target = np.diag(np.asarray(ghf.mo_occ, np.float64))
    exp = tvexp.Exp(0.1, [[["mat", target]], [["trdip", (0.5, 0, 0)]]], mol,
                    ghf.mo_coeff)
    assert exp.nbr_states == 2 and exp.prop_names[1] == ["trdip"]
    gs_dek = tvexp.Exp(0.1, [[["DEk", 0.3]]], mol, ghf.mo_coeff)
    with pytest.raises(NotImplementedError, match="DEk"):
        tvexp.make_gs_vexp_device(gs_dek, **F64)
