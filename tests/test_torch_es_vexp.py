"""The excited-state half of ecw_cc_torch.ops.vexp: the host class `Exp`
with ES data and `make_es_vexp_device` against the JAX package for each
target kind, and the host `Vexp_update` against the device update."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecw_cc_tpu.ops import vexp as jvexp
from ecw_cc_torch.ops import vexp as tvexp

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
H = [[1, 0, 0], [0, 1, 0], [1, 1, 0]]
REC = np.asarray([8.0, 8.0, 8.0])


def _es_target(name, rng, dim, occ):
    """One ES target of the given kind with seeded values."""
    mat = lambda: np.diag(occ) + 0.05 * rng.standard_normal((dim, dim))
    if name == "mat":
        return ["mat", mat()]
    if name == "trmat":
        return ["trmat", [0.1 * rng.standard_normal((dim, dim)),
                          0.1 * rng.standard_normal((dim, dim))]]
    if name == "Ek":
        return ["Ek", 75.4]
    if name == "v1e":
        return ["v1e", -198.7]
    if name == "dip":
        # a zero component: the relative deviation skips it
        return ["dip", [0.3, 0.0, -0.2]]
    if name == "DEk":
        return ["DEk", 0.28]
    if name == "trdip":
        return ["trdip", (0.54, 0.0, 0.1)]
    if name == "F":
        return ["F", list(rng.standard_normal(3) + 1j * rng.standard_normal(3)),
                H, REC]
    raise KeyError(name)


def _problem(h2o_631g, es_names, gs_names=("mat",), seed=0):
    """exp_data [[GS targets], [targets of ES 1], [of ES 2]] and seeded
    rdm1s; es_names is one list of kinds per excited state."""
    mol, ghf, _, _ = h2o_631g
    occ = np.asarray(ghf.mo_occ, dtype=np.float64)
    dim = occ.size
    rng = np.random.default_rng(seed)
    gs = []
    for name in gs_names:
        gs.append(["mat", np.diag(occ)] if name == "mat"
                  else _es_target(name, rng, dim, occ))
    exp_data = [gs] + [[_es_target(n, rng, dim, occ) for n in st]
                       for st in es_names]
    n_es = len(es_names)
    rd = lambda: np.diag(occ) + 0.05 * rng.standard_normal((dim, dim))
    tr = lambda: 0.1 * rng.standard_normal((dim, dim))
    arrays = dict(rdm1_gs=rd(), rdm1_es=np.stack([rd() for _ in range(n_es)]),
                  tr_r=np.stack([tr() for _ in range(n_es)]),
                  tr_l=np.stack([tr() for _ in range(n_es)]))
    # one weight per property, all different
    L = [[0.1 + 0.05 * i + 0.2 * n for i in range(len(st))]
         for n, st in enumerate(exp_data)]
    return mol, ghf, exp_data, arrays, L


def _both_updates(mol, ghf, exp_data, arrays, L):
    ej = jvexp.Exp(L, exp_data, mol, ghf.mo_coeff)
    et = tvexp.Exp(L, exp_data, mol, ghf.mo_coeff)
    Lflat = [x for st in L for x in st]
    keys = ("rdm1_gs", "rdm1_es", "tr_r", "tr_l")
    out_j = jvexp.make_es_vexp_device(ej)(
        *(jnp.asarray(arrays[k]) for k in keys), jnp.asarray(Lflat))
    out_t = tvexp.make_es_vexp_device(et, **F64)(
        *(torch.tensor(arrays[k]) for k in keys), Lflat)
    return ej, et, out_j, out_t


KINDS = ["mat", "trmat", "Ek", "v1e", "dip", "DEk", "trdip", "F"]


@pytest.mark.parametrize("kind", KINDS)
def test_es_vexp_device_matches_jax(h2o_631g, kind):
    """Two excited states, the first with the kind under test and the
    second with it beside a transition dipole: V00, Vnn, V0n, Vn0 and
    Delta."""
    prob = _problem(h2o_631g, [[kind], ["trdip", kind]], seed=KINDS.index(kind))
    _, _, out_j, out_t = _both_updates(*prob)
    for name, a, b in zip(("V00", "Vnn", "V0n", "Vn0", "Delta"), out_j, out_t):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(a).max()), name
    # something was built
    assert max(float(np.abs(np.asarray(x)).max()) for x in out_j[:4]) > 0


@pytest.mark.parametrize("gs_names", [(), ("mat", "Ek"), ("DEk", "dip")],
                         ids=["no_gs_data", "mat+Ek", "DEk_weight+dip"])
def test_es_vexp_device_gs_part_matches_jax(h2o_631g, gs_names):
    """The GS block, the case without GS data, and the DEk weight taken
    from the GS list (DEk_GS_idx)."""
    prob = _problem(h2o_631g, [["DEk"], ["trdip"]], gs_names=gs_names, seed=9)
    if "DEk" in gs_names:
        # a GS 'DEk' entry only carries the weight: neither package gives
        # it a device value, so it is read by the ES states alone
        with pytest.raises(NotImplementedError, match="DEk"):
            _both_updates(*prob)
        return
    _, _, out_j, out_t = _both_updates(*prob)
    for a, b in zip(out_j, out_t):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-12 * max(
            1.0, np.abs(np.asarray(a)).max())


@pytest.mark.parametrize("kind", KINDS)
def test_es_exp_host_class_matches_jax(h2o_631g, kind):
    """Exp.Vexp_update for every index the solver visits: potential, Delta
    and vmax of both classes."""
    mol, ghf, exp_data, arr, L = _problem(h2o_631g, [[kind]],
                                          seed=20 + KINDS.index(kind))
    ej = jvexp.Exp(L, exp_data, mol, ghf.mo_coeff)
    et = tvexp.Exp(L, exp_data, mol, ghf.mo_coeff)
    assert et.nbr_states == 2 and et.prop_names == ej.prop_names
    assert et.L == ej.L and et.DEk_GS_idx == ej.DEk_GS_idx
    calls = [((0, 0), arr["rdm1_gs"], arr["rdm1_gs"]),
             ((1, 1), arr["rdm1_es"][0], arr["rdm1_gs"]),
             ((1, 0), arr["tr_r"][0], arr["tr_l"][0]),
             ((0, 1), arr["tr_l"][0], arr["tr_r"][0])]
    for index, rdm1, rdm1_add in calls:
        if kind == "mat" and index == (1, 1):
            # an excited-state 'mat' target has no host Delta in either
            # package (Exp.Delta takes a matrix for the ground state only);
            # the device update is its route
            for e in (ej, et):
                with pytest.raises(ValueError, match="ambiguous"):
                    e.Vexp_update(rdm1, rdm1_add, index, L=L)
            continue
        dj = ej.Vexp_update(rdm1, rdm1_add, index, L=L)
        dt = et.Vexp_update(rdm1, rdm1_add, index, L=L)
        np.testing.assert_allclose(np.asarray(dt, dtype=float),
                                   np.asarray(dj, dtype=float), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(
            np.asarray(et.Vexp[index], dtype=float),
            np.asarray(ej.Vexp[index], dtype=float), rtol=0, atol=1e-12)
    if et.Vexp[0, 0] is not None:
        np.testing.assert_allclose(np.asarray(et.Vexp[0, 0], dtype=float),
                                   np.asarray(ej.Vexp[0, 0], dtype=float),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_device_es_vexp_matches_host_update(h2o_631g, kind):
    """The device update against the port's own host Exp.Vexp_update, as
    tests/test_es.py holds the JAX pair together for 'F'."""
    mol, ghf, exp_data, arr, L = _problem(h2o_631g, [[kind]],
                                          gs_names=("mat",),
                                          seed=40 + KINDS.index(kind))
    host = tvexp.Exp(L, exp_data, mol, ghf.mo_coeff)
    dev = tvexp.make_es_vexp_device(
        tvexp.Exp(L, exp_data, mol, ghf.mo_coeff), **F64)
    V00, Vnn, V0n, Vn0, Delta = dev(
        *(torch.tensor(arr[k]) for k in ("rdm1_gs", "rdm1_es", "tr_r",
                                         "tr_l")),
        [x for st in L for x in st])
    if kind in ("trmat", "trdip"):
        d_r, _ = host.Vexp_update(arr["tr_r"][0], arr["tr_l"][0], (1, 0))
        d_l, _ = host.Vexp_update(arr["tr_l"][0], arr["tr_r"][0], (0, 1))
        assert np.abs(Vn0[0].numpy() - host.Vexp[1, 0]).max() < 1e-10
        assert np.abs(V0n[0].numpy() - host.Vexp[0, 1]).max() < 1e-10
        assert abs(float(Delta[1, 0]) - d_r) < 1e-10
        assert abs(float(Delta[0, 1]) - d_l) < 1e-10
    elif kind == "mat":
        # no host route for an ES 'mat' (see above): the formula itself
        tgt = exp_data[1][0][1]
        diff = tgt - arr["rdm1_es"][0]
        assert np.abs(Vnn[0].numpy() - L[1][0] * diff).max() < 1e-12
        assert abs(float(Delta[1, 1])
                   - np.abs(diff).sum() / np.abs(tgt).sum()) < 1e-12
    else:
        host.Vexp[0, 0] = np.zeros_like(arr["rdm1_gs"])
        d_h, _ = host.Vexp_update(arr["rdm1_es"][0], arr["rdm1_gs"], (1, 1))
        if kind == "DEk":
            # fed back into V00, on top of the GS 'mat' term
            gs_term = L[0][0] * (exp_data[0][0][1] - arr["rdm1_gs"])
            assert np.abs(V00.numpy() - gs_term
                          - host.Vexp[0, 0]).max() < 1e-10
        else:
            assert np.abs(Vnn[0].numpy() - host.Vexp[1, 1]).max() < 1e-10
        assert abs(float(Delta[1, 1]) - d_h) < 1e-10


def test_device_es_vexp_rejects_unknown_target(h2o_631g):
    mol, ghf, _, _ = h2o_631g
    exp = tvexp.Exp(0.1, [[], [["trdip", (0.5, 0.0, 0.0)]]], mol, ghf.mo_coeff)
    exp.prop_names[1][0] = "quadrupole"
    with pytest.raises(NotImplementedError, match="quadrupole"):
        tvexp.make_es_vexp_device(exp, **F64)
    with pytest.raises(SyntaxError, match="L_loop"):
        exp.L_check([0.1])
