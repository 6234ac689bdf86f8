"""EOM-IP/EA-CCSD: ionization potentials and electron affinities (port of
ecw_cc_tpu/ops/eom_ipea.py).

The sigma equations are derived by the Wick engine (ops/wick.
generate_eom_terms): every term of

    sigma_mu = <mu| H_N e^T R |0>,   mu in {1h, 2h1p} (IP) / {1p, 2p1h} (EA)

is an einsum on the stored ERI blocks, contracted by ops/eom.contract.
With the R-disconnected terms kept (connected=False) the sigma matrix is
the projection P (e^-T H_N e^T) P onto the 1h+2h1p (1p+2p1h) determinants
at any amplitudes; the solver uses the connected variant, whose
eigenvalues are omega directly, in the antisymmetry-projected subspace.
Its terms are read from eom_ipea_terms.json, the generator's output
written once (`write_term_table`).

The EA sigma's two <ab||cd> terms on pack-on-build ERIs (no dense vvvv)
run as one ladder product through the hand-written kernel
(`_ea_vvvv_packed`, M = nocc rows); on dense ERIs they stay torch.einsum
against eris.vvvv, as the JAX package's are an einsum outside any Pallas
kernel.  IP never touches vvvv.  The left sigma is the vjp of the
(linear) right one: make_sigma_ipea takes it with torch.func.vjp at each
call; the solver evaluates the sigma at zeros once per problem and keeps
its autograd graph, whose backward each left matvec applies (on the card
one backward launch per left matvec on the EA packed route, and no
forward).  The Davidson is utils/linalg.davidson_device, each cycle a
captured program on the card.  The left roots take the raw-storage
metric correction (x2 on the doubles) and are biorthonormalised to the
right ones.
"""

from __future__ import annotations

import functools
import json
import os
import warnings

import numpy as np
import torch

from ecw_cc_torch.ops.eom import canonical_phase, contract
from ecw_cc_torch.ops.wick import generate_dyson_terms, generate_eom_terms
from ecw_cc_torch.solvers.device_loop import on_side_stream
from ecw_cc_torch.utils.linalg import davidson_device

_OCC = set("ijklmnop")

# term lists are constants: cache per (kind, mu_rank, connected)
_TERMS_CACHE: dict = {}
# The solver's terms (connected=True), as wick.generate_eom_terms gives
# them: the generator takes about 35 s of host time for each doubles
# block, once per process, so they are read from this table
# (write_term_table makes it; tests/test_torch_wick.py holds it equal to
# the generator's output)
TERM_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "eom_ipea_terms.json")


def _as_terms(raw):
    return tuple((coeff, tuple((name, ss) for name, ss in pieces), out)
                 for coeff, pieces, out in raw)


@functools.cache
def _table():
    with open(TERM_TABLE) as f:
        return json.load(f)


def _terms(kind, mu_rank, connected):
    key = (kind, mu_rank, connected)
    if key not in _TERMS_CACHE:
        raw = (_table()[kind][str(mu_rank)] if connected else
               generate_eom_terms(kind, mu_rank, connected=False))
        _TERMS_CACHE[key] = _as_terms(raw)
    return _TERMS_CACHE[key]


def write_term_table(path=TERM_TABLE):
    """Generate the connected EOM-IP/EA terms of both ranks and write them
    to `path` (JSON; Python's float repr round-trips the coefficients)."""
    table = {kind: {str(rank): [[c, [list(p) for p in pieces], out]
                                for c, pieces, out in generate_eom_terms(
                                    kind, rank, connected=True)]
                    for rank in (1, 2)}
             for kind in ("ip", "ea")}
    with open(path, "w") as f:
        json.dump(table, f, indent=0)
        f.write("\n")


def _block_pattern(subs):
    return "".join("o" if c in _OCC else "v" for c in subs)


def _split_vvvv_terms(terms):
    """(plain_terms, vvvv_terms): the <ab||cd> ladder terms, which take the
    packed route when the dense block is absent (pack-on-build ERIs)."""
    plain, lad = [], []
    for t in terms:
        pats = [_block_pattern(ss) for name, ss in t[1] if name == "v"]
        (lad if "vvvv" in pats else plain).append(t)
    return tuple(plain), tuple(lad)


def _ea_vvvv_packed(vvvv_op, t1, r1, r2, lad_terms):
    """The EA sigma's two <ab||cd> terms as ONE ladder product.

    Both generated terms are einsum('abcd,icd->iba', v, X) with
    X = coeff1 * r1[c] t1[i,d] and X = coeff2 * rea2[i,c,d]; v is
    antisymmetric in (c,d), so only the antisymmetric part of X counts,
    and the combined W rides packed_vvvv_contract (or the sectored one on
    the sorted layout), which computes 0.5*einsum('ijef,abef->ijab') on a
    (nocc, 1, nvir, nvir) view: one launch of the kernel with M = nocc
    rows (three on the sectored route).  The term shapes are asserted so
    that a change of the generator fails loudly instead of dropping a
    term."""
    from ecw_cc_torch.ops.ladder import (PackedVVVV, SectoredVVVV,
                                         packed_vvvv_contract,
                                         sectored_vvvv_contract)

    if isinstance(vvvv_op, SectoredVVVV):
        contract_op = sectored_vvvv_contract   # spin-sorted pack-on-build
    elif isinstance(vvvv_op, PackedVVVV):
        contract_op = packed_vvvv_contract
    else:
        raise NotImplementedError(
            "EOM-EA with a non-dense vvvv supports the PackedVVVV/"
            f"SectoredVVVV routes only (got {type(vvvv_op).__name__})")
    W = torch.zeros_like(r2)
    for coeff, pieces, out in lad_terms:
        d = dict(pieces)
        assert d.get("v") == "abcd" and out == "iba", (pieces, out)
        if "rea2" in d:
            assert d["rea2"] == "icd", pieces
            W = W + coeff * r2
        else:
            assert d.get("rea1") == "c" and d.get("t1") == "id", pieces
            x = torch.einsum("c,id->icd", r1, t1)
            W = W + coeff * 0.5 * (x - x.transpose(1, 2))
    p = contract_op(vvvv_op, W[:, None])[:, 0]   # (no, nv, nv)
    # einsum('abcd,icd->iab') = 2 * p; the out order is 'iba'
    return 2.0 * p.transpose(1, 2)


def _apply_terms(terms, eris, fsp, t1, t2, r1, r2, kind):
    nocc = t1.shape[0]
    rname1, rname2 = ("rip1", "rip2") if kind == "ip" else ("rea1", "rea2")
    tens = {"t1": t1, "t2": t2, rname1: r1, rname2: r2}

    def fblock(ss):
        return fsp[tuple(slice(0, nocc) if c in _OCC else slice(nocc, None)
                         for c in ss)]

    out = None
    for coeff, pieces, out_subs in terms:
        operands, subs = [], []
        for name, ss in pieces:
            if name == "f":
                operands.append(fblock(ss))
            elif name == "v":
                operands.append(getattr(eris, _block_pattern(ss)))
            else:
                operands.append(tens[name])
            subs.append(ss)
        val = coeff * contract(",".join(subs) + "->" + out_subs, *operands)
        out = val if out is None else out + val
    return out


def _sigma(eris, vvvv_op, fsp, t1, t2, r1, r2, kind, connected=True,
           use_packed=False):
    """(sigma1, sigma2) of the EOM-IP/EA matrix acting on (r1, r2)."""
    s1 = _apply_terms(_terms(kind, 1, connected), eris, fsp, t1, t2,
                      r1, r2, kind)
    terms2 = _terms(kind, 2, connected)
    lad = ()
    if use_packed:
        terms2, lad = _split_vvvv_terms(terms2)
    s2 = _apply_terms(terms2, eris, fsp, t1, t2, r1, r2, kind)
    if lad:
        s2 = s2 + _ea_vvvv_packed(vvvv_op, t1, r1, r2, lad)
    return s1, s2


def _check_eris(eris, kind, vvvv_op):
    """Whether the EA ladder takes the packed route: the ERIs carry no
    dense vvvv (pack-on-build), which then needs `vvvv_op`."""
    if kind == "ea" and eris.vvvv.numel() == 0 and vvvv_op is None:
        raise NotImplementedError(
            "EOM-EA sigma needs the <ab||ef> ladder: pass the pack-on-build "
            "vvvv_op (PackedVVVV) or rebuild with a dense eris.vvvv")
    return kind == "ea" and eris.vvvv.numel() == 0


def _asym2(x, kind):
    """Projector onto the physical antisymmetric doubles storage."""
    if kind == "ip":
        return 0.5 * (x - x.permute(1, 0, 2))
    return 0.5 * (x - x.permute(0, 2, 1))


def _mv_factory(kind, use_packed, ops):
    """(mv_right, left_map, project, unpack) for one problem on its
    operands (eris, ladder operand, fock, amplitudes).  left_map() makes
    mv_left: the sigma evaluated at zeros once, on the device loops' side
    stream (device_loop.on_side_stream: the backward of a captured cycle
    runs on its forward's stream), and each call its kept graph's
    backward."""
    er, vvo, f, a, b = ops
    nocc, nvir = a.shape
    n1 = nocc if kind == "ip" else nvir
    shape2 = (nocc, nocc, nvir) if kind == "ip" else (nocc, nvir, nvir)

    def unpack(v, asym=True):
        r1 = v[:n1]
        r2 = v[n1:].reshape(shape2)
        if asym:
            r2 = _asym2(r2, kind)
        return r1, r2

    def mv_right(v):
        s1, s2 = _sigma(er, vvo, f, a, b, *unpack(v.to(a.dtype)), kind,
                        use_packed=use_packed)
        return torch.cat([s1.reshape(-1), s2.reshape(-1)])

    def left_map():
        with on_side_stream(a.device), torch.enable_grad():
            x = (a.new_zeros(n1).requires_grad_(True),
                 a.new_zeros(shape2).requires_grad_(True))
            s = _sigma(er, vvo, f, a, b, *x, kind, use_packed=use_packed)

        def mv_left(v):
            # the transpose of (A . P) is P . A^T: raw cotangent in, output
            # doubles antisymmetrised (as ops/eom's left matvec)
            s1, s2 = torch.autograd.grad(
                s, x, unpack(v.to(a.dtype), asym=False), retain_graph=True)
            return torch.cat([s1.reshape(-1), _asym2(s2, kind).reshape(-1)])

        return mv_left

    def project(v):
        r1, r2 = unpack(v)
        return torch.cat([r1.reshape(-1), r2.reshape(-1)])

    return mv_right, left_map, project, unpack


def make_sigma_ipea(eris, t1, t2, kind, fsp=None, connected=True,
                    vvvv_op=None):
    """(sigma, sigma_left) at fixed amplitudes: sigma(r1, r2) applies the
    EOM-IP/EA-CCSD matrix, sigma_left its transpose (torch.func.vjp of the
    linear map).  vvvv_op: the pack-on-build ladder operand, required for
    EA when eris.vvvv is the placeholder; IP never touches vvvv."""
    use_packed = _check_eris(eris, kind, vvvv_op)
    if fsp is None:
        fsp = eris.fock
    if not use_packed:
        vvvv_op = None

    def sigma(r1, r2):
        return _sigma(eris, vvvv_op, fsp, t1, t2, r1, r2, kind, connected,
                      use_packed)

    def sigma_left(l1, l2):
        _, vjp = torch.func.vjp(
            lambda a, b: _sigma(eris, vvvv_op, fsp, t1, t2, a, b, kind,
                                connected, use_packed),
            torch.zeros_like(l1), torch.zeros_like(l2))
        return vjp((l1, l2))

    return sigma, sigma_left


def _diag_guess(eris, kind, nroots):
    """Koopman diagonal and unit-vector guesses: IP omega ~ -e_i (highest
    occupied first), EA omega ~ e_a (lowest virtual first)."""
    nocc = eris.nocc
    mo_e = np.diag(eris.fock.detach().cpu().numpy()).astype(np.float64)
    e_o, e_v = mo_e[:nocc], mo_e[nocc:]
    if kind == "ip":
        d1 = -e_o
        d2 = (-e_o[:, None, None] - e_o[None, :, None]
              + e_v[None, None, :])
        order = np.argsort(-e_o)
        n1 = nocc
    else:
        d1 = e_v
        d2 = (-e_o[:, None, None] + e_v[None, :, None]
              + e_v[None, None, :])
        order = np.argsort(e_v)
        n1 = len(e_v)
    diag = np.concatenate([d1.ravel(), d2.ravel()])
    guesses = []
    for k in range(min(nroots, n1)):
        g = np.zeros(diag.size)
        g[order[k]] = 1.0
        guesses.append(g)
    # more roots than 1h/1p slots: seed the lowest-diagonal doubles too
    for k in range(max(0, nroots - n1)):
        g = np.zeros(diag.size)
        g[n1 + int(np.argsort(d2.ravel())[k])] = 1.0
        guesses.append(g)
    return diag, guesses


def eom_ipea_ccsd(eris, t1, t2, kind, nroots=1, fsp=None, guess=None,
                  tol=1e-7, max_space=30, max_cycle=120, left=False,
                  vvvv_op=None, verbose=False, log=None):
    """EOM-IP/EA-CCSD roots by Davidson on the Wick-derived sigma, on the
    tensors' device.

    :param kind: 'ip' (omega = E_{N-1} - E_CCSD) or 'ea' (omega = E_{N+1}
        - E_CCSD, negative for a bound anion).
    :param log: a dict that receives the cycles, matvecs and converged
        flags of the right solve ('right') and of each left one ('left', a
        list).
    :return: (omegas, Rs) with Rs[k] = (r1, r2) tensors, rip2[i,j,a]
        antisymmetric in i,j or rea2[i,a,b] in a,b; with left=True also
        Ls, biorthonormalised so that l1.r1 + 1/2 l2.r2 = 1.
    """
    dtype, device = t1.dtype, t1.device
    use_packed = _check_eris(eris, kind, vvvv_op)
    ops = (eris, vvvv_op if use_packed else None,
           eris.fock if fsp is None else fsp, t1, t2)
    diag, auto_guess = _diag_guess(eris, kind, nroots)
    diag = torch.as_tensor(diag, dtype=dtype, device=device)
    if guess is None:
        guess = auto_guess
    mv_right, left_map, project, unpack = _mv_factory(kind, use_packed,
                                                      ops)
    log = {} if log is None else log
    log["right"] = {}
    conv, w, xs = davidson_device(mv_right, guess, diag, nroots=nroots,
                                  tol=tol, max_cycle=max_cycle,
                                  max_space=max_space, verbose=verbose,
                                  project=project, log=log["right"])
    if not all(conv[:nroots]):
        warnings.warn(
            f"EOM-{kind.upper()} Davidson unconverged roots: "
            f"conv={list(conv[:nroots])} "
            f"omegas={[float(x) for x in w[:nroots]]} (tol={tol})",
            RuntimeWarning, stacklevel=2)
    omegas = [float(x) for x in w[:nroots]]
    Rs = [unpack(canonical_phase(xs[k].to(dtype))) for k in range(nroots)]
    if not left:
        return omegas, Rs

    Ls = []
    log["left"] = []
    mv_left = left_map()
    for k in range(nroots):
        log["left"].append({})
        conv_l, _, xls = davidson_device(
            mv_left, [torch.cat([Rs[k][0].reshape(-1),
                                 Rs[k][1].reshape(-1)])],
            diag, nroots=1, tol=tol, max_cycle=max_cycle,
            max_space=max_space, follow=True, project=project,
            log=log["left"][-1])
        if not conv_l[0]:
            warnings.warn(
                f"EOM-{kind.upper()} left Davidson unconverged for root {k} "
                f"(omega={omegas[k]:.6f}, tol={tol})",
                RuntimeWarning, stacklevel=2)
        l1, l2 = unpack(xls[0].to(dtype))
        # METRIC CORRECTION + biorthonormalisation (see ops/eom.py): the
        # raw-storage metric counts each (i<j) / (a<b) slot twice, so the
        # left eigenvector is D.y with D = diag(1, 2); the returned Ls are
        # operator-convention amplitudes with <L|R> = l1.r1 + 1/2 l2.r2 = 1,
        # the normalisation the Dyson pole strengths assume.  The raw A^T
        # eigenvector is (l1, l2/2)
        l2 = 2.0 * l2
        ov = float(torch.vdot(l1.reshape(-1), Rs[k][0].reshape(-1))
                   + 0.5 * torch.vdot(l2.reshape(-1), Rs[k][1].reshape(-1)))
        Ls.append((l1 / ov, l2 / ov))
    return omegas, Rs, Ls


def _dyson_terms(kind, side, p_space):
    key = ("dyson", kind, side, p_space)
    if key not in _TERMS_CACHE:
        _TERMS_CACHE[key] = tuple(
            (coeff, tuple(pieces), out)
            for coeff, pieces, out in generate_dyson_terms(kind, side,
                                                           p_space))
    return _TERMS_CACHE[key]


def _eval_dyson_block(terms, tens, size, like):
    acc = like.new_zeros((size,))
    for coeff, pieces, out in terms:
        operands = [tens[name] for name, _ in pieces]
        subs = [ss for _, ss in pieces]
        acc = acc + coeff * contract(",".join(subs) + "->" + out, *operands)
    return acc


def dyson_orbitals(t1, t2, Rs, Ls, kind, lam1=None, lam2=None):
    """Dyson orbitals and pole strengths of EOM-IP/EA roots:
    d^L_p = <0| L_k (e^-T a#_p e^T) |0>,
    d^R_p = <0| (1+Lambda) (e^-T a#_p e^T) R_k |0>,
    a#_p = a_p or a+_p by (kind, side), terms from wick.
    generate_dyson_terms; the pole strength is s_k = d^L . d^R.

    lam1/lam2: the converged ground-state Lambda; None takes Lambda = 0.
    :return: list of (dL (nmo,), dR (nmo,), strength) per root, NumPy."""
    nocc, nvir = t1.shape

    def dev(x):
        return torch.as_tensor(x, dtype=t1.dtype, device=t1.device)

    lam1 = torch.zeros_like(t1) if lam1 is None else dev(lam1)
    lam2 = torch.zeros_like(t2) if lam2 is None else dev(lam2)
    lname1, lname2 = ("lip1", "lip2") if kind == "ip" else ("lea1", "lea2")
    rname1, rname2 = ("rip1", "rip2") if kind == "ip" else ("rea1", "rea2")
    out = []
    for (r1, r2), (e1, e2) in zip(Rs, Ls):
        tens = {"t1": t1, "t2": t2, "l1": lam1, "l2": lam2,
                lname1: dev(e1), lname2: dev(e2),
                rname1: dev(r1), rname2: dev(r2)}
        dL = torch.cat([
            _eval_dyson_block(_dyson_terms(kind, "left", "o"), tens, nocc,
                              t1),
            _eval_dyson_block(_dyson_terms(kind, "left", "v"), tens, nvir,
                              t1)])
        dR = torch.cat([
            _eval_dyson_block(_dyson_terms(kind, "right", "o"), tens, nocc,
                              t1),
            _eval_dyson_block(_dyson_terms(kind, "right", "v"), tens, nvir,
                              t1)])
        out.append((dL.cpu().numpy(), dR.cpu().numpy(),
                    float(torch.dot(dL, dR))))
    return out


def eom_ip_ccsd(eris, t1, t2, **kw):
    """Ionization potentials: see eom_ipea_ccsd."""
    return eom_ipea_ccsd(eris, t1, t2, "ip", **kw)


def eom_ea_ccsd(eris, t1, t2, **kw):
    """Electron affinities: see eom_ipea_ccsd."""
    return eom_ipea_ccsd(eris, t1, t2, "ea", **kw)
