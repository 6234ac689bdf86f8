"""Parity of the PyTorch port's ladder (ecw_cc_torch.ops.ladder and the
ladder GEMM wrapper) with the JAX package on identical f64 inputs, CPU.

On CPU tensors `ladder_mm` computes its plain version, so the kernel's
launch counter must stay at 0; the CUDA kernel itself is checked on the
card (the `gpu` test below and chip_smoke.py)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecw_cc_tpu.models.eris import build_eris_device
from ecw_cc_tpu.ops import ladder as jl
from ecw_cc_tpu.ops import spinsect as jss
from ecw_cc_tpu.ops.ccsd_sect import _tau_b as j_tau_b
from ecw_cc_torch.kernels.ladder_mm import ladder_mm, ladder_mm_ref
from ecw_cc_torch.models.eris import from_numpy, sorted_from_host
from ecw_cc_torch.ops import ladder as tl
from ecw_cc_torch.ops import spinsect as tss
from ecw_cc_torch.ops.ccsd_sect import _tau_b as t_tau_b

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def sorted_system(h2o_631g):
    """The JAX sorted, sector-packed H2O/6-31G build (dense sorted vvvv
    too), its SectorInfo, and the same ERIs as torch tensors."""
    mol, ghf, eris_host, _ = h2o_631g
    nocc = eris_host.nocc
    er, sect = build_eris_device(mol, ghf, dtype="float64",
                                 pack_ladder=True, sort_spin=True)
    er_dense = build_eris_device(mol, ghf, dtype="float64", sort_spin=True)
    perm = jl.spin_sort_perm(ghf.orbspin, nocc)
    info = jss.sector_info(np.asarray(ghf.orbspin)[perm], nocc)
    er_t, sect_t = from_numpy(er, sect, **F64)
    return dict(er=er, sect=sect, er_dense=er_dense, perm=perm, info=info,
                er_t=er_t, sect_t=sect_t, eris_host=eris_host)


def _mirror_amps(info, seed=7, scale=0.05):
    """Balanced, antisymmetric and exactly mirror-symmetric (t1, t2, l2)."""
    rng = np.random.default_rng(seed)
    sl = jss._slices(info)
    dims = {"o": info.nocc, "v": info.nvir}

    def rand(kinds):
        arr = np.zeros(tuple(dims[k] for k in kinds))
        for key in itertools.product((0, 1), repeat=len(kinds)):
            if jss._balanced(key) and key <= jss._flip(key):
                blk = rng.standard_normal(
                    arr[tuple(sl[(k, s)] for k, s in zip(kinds, key))].shape)
                arr[tuple(sl[(k, s)] for k, s in zip(kinds, key))] = blk
                arr[tuple(sl[(k, 1 - s)] for k, s in zip(kinds, key))] = blk
        return scale * arr

    def asym(x):
        x = x - x.transpose(1, 0, 2, 3)
        return 0.5 * (x - x.transpose(0, 1, 3, 2))

    return rand("ov"), asym(rand("oovv")), asym(rand("oovv"))


@pytest.mark.parametrize("shape", [(1, 1, 1), (37, 513, 129),
                                   (98, 465, 465), (100, 130, 1001)])
def test_ladder_mm_matches_xla_reference(shape):
    M, N, K = shape
    rng = np.random.default_rng(sum(shape))
    a, b = rng.standard_normal((M, K)), rng.standard_normal((N, K))
    ref = np.asarray(jl._ladder_mm_xla(jnp.asarray(a), jnp.asarray(b)))
    ladder_mm.launches = 0
    for fn in (ladder_mm_ref, ladder_mm):
        c = fn(_t(a), _t(b))
        assert c.shape == (M, N)
        np.testing.assert_allclose(c.numpy(), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
    assert ladder_mm.launches == 0   # CPU tensors never reach the kernel


def test_ladder_mm_refuses_non_cuda_devices():
    a = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ladder_mm(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        ladder_mm(torch.zeros(4, 3), a)
    assert ladder_mm.launches == 0


def _card_operands(shape, dtype):
    M, N, K = shape
    rng = np.random.default_rng(M * N * K)
    a = torch.as_tensor(rng.standard_normal((M, K)), dtype=dtype,
                        device="cuda")
    b = torch.as_tensor(rng.standard_normal((N, K)), dtype=dtype,
                        device="cuda")
    return a, b


@pytest.mark.gpu
def test_ladder_mm_kernel_matches_plain_on_card():
    """The main, ragged and split-K edge shapes (K where the split changes
    and around chunk boundaries, K below one chunk, M = 1, M = 129), f32
    and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for shape in [(98, 465, 465), (98, 961, 961), (1, 1, 1),
                      (37, 513, 129), (100, 130, 1001), (98, 465, 240),
                      (98, 465, 241), (98, 465, 256), (98, 465, 257),
                      (98, 961, 959), (98, 961, 960), (98, 465, 15),
                      (98, 465, 17), (1, 961, 961), (129, 465, 465),
                      (129, 961, 961)]:
            a, b = _card_operands(shape, dtype)
            n0 = ladder_mm.launches
            c = ladder_mm(a, b)
            torch.cuda.synchronize()
            assert ladder_mm.launches == n0 + 1
            ref = ladder_mm_ref(a, b)
            assert float((c - ref).abs().max()) <= tol * float(
                ref.abs().max())


@pytest.mark.gpu
def test_ladder_mm_kernel_is_deterministic_on_card():
    """Split-K sums in a fixed order: two launches give the same bits, and
    so does a captured launch replayed twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in (torch.float32, torch.float64):
        for shape in [(98, 465, 465), (98, 961, 961)]:
            a, b = _card_operands(shape, dtype)
            c1 = ladder_mm(a, b)
            assert torch.equal(ladder_mm(a, b), c1)
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                ladder_mm(a, b)
            s.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                cg = ladder_mm(a, b)
            for _ in range(2):
                cg.fill_(float("nan"))
                g.replay()
                torch.cuda.synchronize()
                assert torch.equal(cg, c1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(196, 3844, 3844), (392, 1891, 1891),
                                   (392, 13041, 13041), (392, 465, 465),
                                   (392, 961, 961)],
                         ids=["dense-pvdz", "packed-pvdz", "packed-pvtz",
                              "sect-aa-pvdz", "sect-ab-pvdz"])
def test_ladder_mm_kernel_at_the_route_shapes_on_card(shape, dtype):
    """The dense, packed and stacked-sector GEMMs of C2H2 (nocc 14): the
    kernel against its plain version, one launch each, and two launches
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    a, b = _card_operands(shape, dtype)
    n0 = ladder_mm.launches
    c = ladder_mm(a, b)
    torch.cuda.synchronize()
    assert ladder_mm.launches == n0 + 1
    ref = ladder_mm_ref(a, b)
    assert float((c - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(ladder_mm(a, b), c)


@pytest.mark.parametrize("v", [2, 5, 9])
def test_pack_pairs_roundtrip(v):
    rng = np.random.default_rng(v)
    x = rng.standard_normal((6, v * v))
    packed = tl._pack_pairs(_t(x), v)
    assert packed.shape == (6, v * (v - 1) // 2)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jl._pack_pairs(jnp.asarray(x), v)))
    back = tl._unpack_pairs(packed, v).numpy().reshape(6, v, v)
    upper = np.triu(np.ones((v, v), bool), 1)
    np.testing.assert_array_equal(back[:, upper], x.reshape(6, v, v)[:, upper])
    assert not back[:, ~upper].any()
    np.testing.assert_array_equal(
        back.reshape(6, v * v),
        np.asarray(jl._unpack_pairs(jl._pack_pairs(jnp.asarray(x), v), v)))


def test_pack_vvvv_sorted_matches_jax(sorted_system):
    s = sorted_system
    vvvv = np.asarray(s["er_dense"].vvvv)
    ma = s["info"].va
    ref = jl.pack_vvvv_sorted(jnp.asarray(vvvv), ma)
    out = tl.pack_vvvv_sorted(_t(vvvv), ma)
    for name in tl.SectoredVVVV._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert tl._sector_dims(out, vvvv.shape[0]) == (ma, s["info"].vb)


def test_sorted_from_host_matches_jax_sorted_build(sorted_system):
    """The port's host-ERI sort + pack equals the JAX device build with
    sort_spin=True, pack_ladder=True (two f64 transforms: 1e-10)."""
    s = sorted_system
    er_t, sect_t = sorted_from_host(s["eris_host"], s["perm"], **F64)
    for name in ("fock", "oooo", "ooov", "oovv", "ovov", "ovvo", "ovvv",
                 "ovoo", "vovv"):
        np.testing.assert_allclose(getattr(er_t, name).numpy(),
                                   np.asarray(getattr(s["er"], name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    assert er_t.vvvv.shape == (s["info"].nvir, 0, 0, 0)
    for name in tl.SectoredVVVV._fields:
        np.testing.assert_allclose(getattr(sect_t, name).numpy(),
                                   np.asarray(getattr(s["sect"], name)),
                                   rtol=0, atol=1e-10, err_msg=name)


def test_sectored_vvvv_contract_matches_jax(sorted_system):
    s = sorted_system
    _, t2, _ = _mirror_amps(s["info"])
    ref = np.asarray(jl.sectored_vvvv_contract(s["sect"], jnp.asarray(t2)))
    out = tl.sectored_vvvv_contract(s["sect_t"], _t(t2)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["dense", "blocked", "single_dense",
                                  "single_blocked"])
@pytest.mark.parametrize("sym", [False, True])
def test_balanced_stacked_sectored_contract_matches_jax(sorted_system, sym,
                                                        mode):
    s = sorted_system
    info = s["info"]
    t1, t2, l2 = _mirror_amps(info)
    blocked = mode.endswith("blocked")
    single = mode.startswith("single")
    # x1 = tau: SpinBlocked (as the solver builds it) or dense
    tau_j = j_tau_b(jss.wrap(jnp.asarray(t2), "oovv", info, sym=sym),
                    jss.wrap(jnp.asarray(t1), "ov", info, sym=sym))
    tau_t = t_tau_b(tss.wrap(_t(t2), "oovv", info, sym=sym),
                    tss.wrap(_t(t1), "ov", info, sym=sym))
    if not blocked:
        tau_j, tau_t = tau_j.dense(), tau_t.dense()
    bi = info if blocked else None
    ref = jl.balanced_stacked_sectored_contract(
        s["sect"], tau_j, None if single else jnp.asarray(l2), info.oa,
        sym=sym, blocked_info=bi)
    out = tl.balanced_stacked_sectored_contract(
        s["sect_t"], tau_t, None if single else _t(l2), info.oa, sym=sym,
        blocked_info=bi)
    refs = (ref,) if single else ref
    outs = (out,) if single else out
    assert len(outs) == len(refs)
    for r, o in zip(refs, outs):
        if blocked:
            r, o = r.dense(), o.dense()
        np.testing.assert_allclose(_np(o), _np(r), rtol=0, atol=1e-12)


def test_balanced_contract_rejects_bad_blocked_operands(sorted_system):
    """The two latent faults of the JAX ladder fail loudly in the port: a
    SpinBlocked operand whose sym differs from the call's, and one with no
    blocks."""
    s = sorted_system
    info = s["info"]
    _, t2, _ = _mirror_amps(info)
    x = tss.wrap(_t(t2), "oovv", info, sym=True)
    with pytest.raises(ValueError, match="sym=True"):
        tl.balanced_stacked_sectored_contract(s["sect_t"], x, None, info.oa,
                                              sym=False, blocked_info=info)
    empty = tss.SpinBlocked("oovv", {}, info, sym=False)
    with pytest.raises(ValueError, match="no blocks"):
        tl.balanced_stacked_sectored_contract(s["sect_t"], empty, None,
                                              info.oa, blocked_info=info)


# ---------------------------------------------------------------------------
# the gradient through the ladder (the CCSD(T) response density takes it)
# ---------------------------------------------------------------------------

def _sym_operand(n, seed, dtype=torch.float64, device="cpu", rows=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, n))
    w = np.concatenate([w + w.T, np.zeros((rows, n))])
    return torch.as_tensor(w, dtype=dtype, device=device).contiguous()


@pytest.mark.parametrize("symmetric", [False, True])
def test_ladder_mm_gradcheck_cpu(symmetric):
    """On CPU tensors ladder_mm is the plain version with its native
    autograd, whatever the call site says of its operand."""
    w = _sym_operand(6, 0)
    a = torch.randn(4, 6, dtype=torch.float64, requires_grad=True)
    fn = lambda x: ladder_mm(x, w, symmetric=symmetric)
    assert torch.autograd.gradcheck(fn, (a,))
    assert ladder_mm.launches == 0 or not torch.cuda.is_available()


@pytest.mark.parametrize("case", ["square", "padded", "transposed"])
def test_ladder_mm_function_gradient_with_a_stand_in_launch(monkeypatch, case):
    """The autograd.Function around the launch, with the launch replaced by
    a @ b.T (no kernel runs off the card): first and second derivatives by
    gradcheck, the symmetric backward also on a zero-padded operand, the
    backward on a transposed copy for an operand not declared symmetric
    (here a rectangular one), and the same under torch.func.vjp, where
    forward must see plain tensors.  Every backward is a launch, counted
    where it is made."""
    from ecw_cc_torch.kernels import ladder_mm as lmm

    seen, made = [], []

    def stand_in(a, b, backward=False):
        seen.append(type(a) is torch.Tensor
                    and not torch._C._functorch.is_functorch_wrapped_tensor(a))
        made.append(backward)
        return a @ b.T

    monkeypatch.setattr(lmm, "_launch", stand_in)
    w = _sym_operand(7, 1, rows=3 if case == "padded" else 0)
    if case == "transposed":
        w = torch.randn(5, 7, dtype=torch.float64)
    sym = case != "transposed"
    a = torch.randn(4, 7, dtype=torch.float64, requires_grad=True)
    fn = lambda x: lmm._LadderMM.apply(x, w, sym, False)
    assert torch.autograd.gradcheck(fn, (a,))
    assert torch.autograd.gradgradcheck(fn, (a,))
    out, vjp = torch.func.vjp(fn, a.detach())
    g = torch.randn_like(out)
    assert (vjp(g)[0] - g @ w).abs().max() < 1e-13
    # a cotangent that is not contiguous, as autograd often hands one
    gt, = torch.autograd.grad((fn(a) * g.T.contiguous().T).sum(), a)
    assert (gt - g @ w).abs().max() < 1e-13
    assert seen and all(seen)
    # that one gradient: a forward launch, then a backward one
    assert made[-2:] == [False, True]


def test_ladder_mm_refuses_a_gradient_for_the_eri_operand():
    """b is an ERI block: no gradient is defined for it, on any device the
    kernel serves; a symmetric operand must have at least K rows."""
    b = torch.empty((4, 3), device="meta", requires_grad=True)
    a = torch.empty((2, 3), device="meta")
    with pytest.raises(RuntimeError, match="no gradient"):
        ladder_mm(a, b)
    with pytest.raises(ValueError, match="cannot be symmetric"):
        ladder_mm(a, torch.empty((2, 3), device="meta"), symmetric=True)
    assert ladder_mm.launches == 0 or torch.cuda.is_available()


def _antisym(x):
    return x - x.transpose(2, 3)


@pytest.mark.parametrize("route", ["packed", "sectored", "dense",
                                   "stacked_packed", "balanced"])
def test_ladder_contract_gradcheck_wrt_x(sorted_system, route):
    """torch.autograd.gradcheck of each ladder route with respect to x (x
    kept antisymmetric by construction, as tau, t2 and l2 are)."""
    s = sorted_system
    info = s["info"]
    o, v = 2, info.nvir
    dense = _t(s["er_dense"].vvvv)
    if route in ("packed", "stacked_packed"):
        op = tl.pack_vvvv(dense)
    else:
        op = s["sect_t"]
    x0 = torch.randn(o, o, v, v, dtype=torch.float64, requires_grad=True)

    def fn(x):
        x = _antisym(x)
        if route == "packed":
            return tl.packed_vvvv_contract(op, x)
        if route == "sectored":
            return tl.sectored_vvvv_contract(op, x)
        if route == "dense":
            return tl.dense_ladder(x, dense)
        if route == "stacked_packed":
            return sum(tl.stacked_packed_contract(op, x, 2.0 * x))
        # balanced rows of a full-size operand
        return tl.balanced_stacked_sectored_contract(op, x, None, info.oa)

    if route == "balanced":
        x0 = torch.randn(info.nocc, info.nocc, v, v, dtype=torch.float64,
                         requires_grad=True)
    assert torch.autograd.gradcheck(fn, (x0,), fast_mode=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(98, 961), (392, 1891), (37, 129)])
def test_ladder_mm_gradient_matches_plain_on_card(shape, dtype):
    """The kernel's gradient against the plain version's on the card, w
    symmetric: through autograd (the backward is one more launch), through
    torch.func.vjp, with a zero-padded operand, and with an operand that
    is neither symmetric nor declared so (the backward then launches on a
    transposed copy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    M, N = shape
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    w = _sym_operand(N, 5, dtype, "cuda")
    pad = _sym_operand(N, 5, dtype, "cuda", rows=16)
    a = torch.randn(M, N, dtype=dtype, device="cuda")
    g = torch.randn(M, N, dtype=dtype, device="cuda")
    ar = a.clone().requires_grad_(True)
    ref, = torch.autograd.grad((ladder_mm_ref(ar, w) * g).sum(), ar)
    n0, b0 = ladder_mm.launches, ladder_mm.backward_launches
    wn = torch.randn(N, N, dtype=dtype, device="cuda")
    ar = a.clone().requires_grad_(True)
    ref_n, = torch.autograd.grad((ladder_mm_ref(ar, wn) * g).sum(), ar)
    grads = []
    for op, sym, want in ((w, True, ref), (pad, True, ref),
                          (wn, False, ref_n)):
        ak = a.clone().requires_grad_(True)
        out = ladder_mm(ak, op, symmetric=sym)[:, :N]
        grads.append((torch.autograd.grad((out * g).sum(), ak)[0], want))
    _, vjp = torch.func.vjp(lambda x: ladder_mm(x, w, symmetric=True), a)
    grads.append((vjp(g)[0], ref))
    assert ladder_mm.launches - n0 == 8          # 4 forward, 4 backward
    assert ladder_mm.backward_launches - b0 == 4
    for got, want in grads:
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())
