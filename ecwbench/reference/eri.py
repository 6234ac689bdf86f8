"""Two-electron integrals of the reference, (ij|kl) in chemists' notation,
by the McMurchie-Davidson scheme in plain PyTorch.

The scheme is that of the NumPy engine copied in reference/aoints.py,
batched: shell pairs are grouped by their angular momenta, and every pair
of such groups is one set of tensor operations over all its primitive
quartets (the Boys function, the Hermite Coulomb table R_tuv, the two
Hermite contractions), instead of a Python loop over shell quartets.  So
it runs in seconds on a card, in f64, where the loop would take minutes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ecwbench.reference.aoints import (CART_COMPONENTS, NSPH, _c2s_matrix,
                                       _E_table)

# elements of the (primitive quartet x R table) tensors held at once
CHUNK = 1 << 26
BOYS_SWITCH = 35.0     # series below, asymptotic form above
BOYS_TERMS = 160


def hermite_index(L):
    """The Hermite triples (t, u, v) with t + u + v <= L, in a fixed order."""
    return [(t, u, v) for t in range(L + 1) for u in range(L + 1 - t)
            for v in range(L + 1 - t - u)]


def boys(nmax, T):
    """F_n(T) for n = 0..nmax as an (nmax + 1, *T.shape) tensor: the
    series of F_nmax and downward recursion below BOYS_SWITCH, the
    asymptotic F_0 and upward recursion above it."""
    small = T < BOYS_SWITCH
    Ts = torch.where(small, T, torch.zeros_like(T))
    term = torch.full_like(T, 1.0 / (2 * nmax + 1))
    acc = term.clone()
    for k in range(1, BOYS_TERMS):
        term = term * (2.0 * Ts) / (2 * nmax + 2 * k + 1)
        acc = acc + term
    eT = torch.exp(-Ts)
    down = [None] * (nmax + 1)
    down[nmax] = acc * eT
    for n in range(nmax - 1, -1, -1):
        down[n] = (2.0 * Ts * down[n + 1] + eT) / (2 * n + 1)
    Tl = torch.where(small, torch.full_like(T, BOYS_SWITCH), T)
    eTl = torch.exp(-Tl)
    up = [0.5 * torch.sqrt(math.pi / Tl)]
    for n in range(nmax):
        up.append(((2 * n + 1) * up[n] - eTl) / (2.0 * Tl))
    return torch.stack([torch.where(small, d, u) for d, u in zip(down, up)])


def r_table(Lmax, alpha, PQ):
    """R^0_tuv(alpha, PQ) for the Hermite triples of hermite_index(Lmax),
    as an (N, n_triples) tensor over the N quartets of alpha (N,) and
    PQ (N, 3)."""
    X, Y, Z = PQ[:, 0], PQ[:, 1], PQ[:, 2]
    F = boys(Lmax, alpha * (X * X + Y * Y + Z * Z))
    R = {}
    m2a = -2.0 * alpha
    for n in range(Lmax + 1):
        R[n, 0, 0, 0] = m2a ** n * F[n]
    for total in range(1, Lmax + 1):
        for t, u, v in hermite_index(total):
            if t + u + v != total:
                continue
            for n in range(Lmax - total + 1):
                if t > 0:
                    val = X * R[n + 1, t - 1, u, v]
                    if t > 1:
                        val = val + (t - 1) * R[n + 1, t - 2, u, v]
                elif u > 0:
                    val = Y * R[n + 1, t, u - 1, v]
                    if u > 1:
                        val = val + (u - 1) * R[n + 1, t, u - 2, v]
                else:
                    val = Z * R[n + 1, t, u, v - 1]
                    if v > 1:
                        val = val + (v - 1) * R[n + 1, t, u, v - 2]
                R[n, t, u, v] = val
    return torch.stack([R[0, t, u, v] for t, u, v in hermite_index(Lmax)],
                       dim=1)


def _pair_group(bs, pairs, la, lb):
    """The shell pairs (i, j) of one (la, lb) class as tensors: the
    primitive exponents p, centres P and the Hermite expansion of each
    spherical product, with contraction coefficients and AO norms folded
    in, H[pair, sa, sb, triple, prim]; primitives padded with zero
    weight to the class's largest count."""
    herm = hermite_index(la + lb)
    K = max(len(bs.shells[i].exps) * len(bs.shells[j].exps)
            for i, j in pairs)
    n = len(pairs)
    p = np.ones((n, K))
    P = np.zeros((n, K, 3))
    H = np.zeros((n, NSPH[la], NSPH[lb], len(herm), K))
    Ca, Cb = _c2s_matrix(la), _c2s_matrix(lb)
    ca, cb = CART_COMPONENTS[la], CART_COMPONENTS[lb]
    offs = np.zeros((n, 2), dtype=np.int64)
    for q, (i, j) in enumerate(pairs):
        sha, shb = bs.shells[i], bs.shells[j]
        a = np.repeat(sha.exps, len(shb.exps))
        b = np.tile(shb.exps, len(sha.exps))
        cc = np.outer(sha.coefs, shb.coefs).ravel()
        pp = a + b
        PP = (a[:, None] * sha.center + b[:, None] * shb.center) / pp[:, None]
        E = [_E_table(la, lb, sha.center[d], shb.center[d], a, b)
             for d in range(3)]
        cart = np.zeros((len(ca), len(cb), len(herm), len(pp)))
        for ia, (ix, iy, iz) in enumerate(ca):
            for ib, (jx, jy, jz) in enumerate(cb):
                for h, (t, u, v) in enumerate(herm):
                    if t <= ix + jx and u <= iy + jy and v <= iz + jz:
                        cart[ia, ib, h] = (cc * E[0][ix, jx, t]
                                           * E[1][iy, jy, u]
                                           * E[2][iz, jz, v])
        sph = np.einsum("pa,qb,abhk->pqhk", Ca, Cb, cart)
        oi, oj = bs.sph_offsets[i], bs.sph_offsets[j]
        sph = (sph * bs._norms[oi:oi + NSPH[la], None, None, None]
               * bs._norms[None, oj:oj + NSPH[lb], None, None])
        m = len(pp)
        p[q, :m], P[q, :m], H[q, ..., :m] = pp, PP, sph
        offs[q] = oi, oj
    return p, P, H, offs


def eri(bs, device="cpu", dtype=torch.float64):
    """The full (nao, nao, nao, nao) tensor (ij|kl) of BasisSet bs, on
    `device`."""
    nsh = len(bs.shells)
    classes = {}
    for i in range(nsh):
        for j in range(i + 1):
            a, b = (i, j) if bs.shells[i].l >= bs.shells[j].l else (j, i)
            classes.setdefault((bs.shells[a].l, bs.shells[b].l),
                               []).append((a, b))
    dev = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    groups = []
    for (la, lb), pairs in sorted(classes.items()):
        p, P, H, offs = _pair_group(bs, pairs, la, lb)
        groups.append((la, lb, dev(p), dev(P), dev(H),
                       torch.as_tensor(offs, device=device)))
    nao = bs.nao
    out = torch.zeros(nao ** 4, dtype=dtype, device=device)
    for la, lb, pb, Pb, Hb, ob in groups:
        hb = hermite_index(la + lb)
        for lc, ld, pk, Pk, Hk, ok in groups:
            hk = hermite_index(lc + ld)
            Lmax = la + lb + lc + ld
            full = {h: n for n, h in enumerate(hermite_index(Lmax))}
            gather = torch.as_tensor(
                [[full[(t1 + t2, u1 + u2, v1 + v2)]
                  for (t2, u2, v2) in hk] for (t1, u1, v1) in hb],
                device=device)
            sign = dev([(-1.0) ** (t + u + v) for t, u, v in hk])
            Hks = Hk * sign[None, None, None, :, None]
            nk, Kk = pk.shape
            Kb = pb.shape[1]
            per_bra = Kb * nk * Kk * max(len(full), len(hb) * len(hk))
            step = max(1, CHUNK // per_bra)
            for s in range(0, pb.shape[0], step):
                p1, P1, H1 = pb[s:s + step], Pb[s:s + step], Hb[s:s + step]
                nb = p1.shape[0]
                pp = p1[:, :, None, None]
                qq = pk[None, None, :, :]
                alpha = (pp * qq / (pp + qq)).reshape(-1)
                PQ = (P1[:, :, None, None, :]
                      - Pk[None, None, :, :, :]).reshape(-1, 3)
                pref = (2.0 * math.pi ** 2.5
                        / (pp * qq * torch.sqrt(pp + qq))).reshape(-1)
                R = r_table(Lmax, alpha, PQ) * pref[:, None]
                R2 = R[:, gather].reshape(nb, Kb, nk, Kk, len(hb), len(hk))
                M = torch.einsum("bBkKxy,kcdyK->bBkxcd", R2, Hks)
                blk = torch.einsum("bsSxB,bBkxcd->bsSkcd", H1, M)
                _scatter(out, blk, ob[s:s + step], ok, nao)
    return out.reshape(nao, nao, nao, nao)


def _scatter(out, blk, ob, ok, nao):
    """Writes the blocks (bra pair, sa, sb, ket pair, sc, sd) and their
    (ji|kl), (ij|lk), (ji|lk) images into the flat (nao^4,) out."""
    nb, na_, nb_, nk, nc_, nd_ = blk.shape
    dv = blk.device
    i = (ob[:, 0, None] + torch.arange(na_, device=dv))[:, :, None, None,
                                                         None, None]
    j = (ob[:, 1, None] + torch.arange(nb_, device=dv))[:, None, :, None,
                                                         None, None]
    k = (ok[:, 0, None] + torch.arange(nc_, device=dv))[None, None, None, :,
                                                         :, None]
    l = (ok[:, 1, None] + torch.arange(nd_, device=dv))[None, None, None, :,
                                                         None, :]
    n2, n3 = nao * nao, nao ** 3
    for a, b in ((i, j), (j, i)):
        for c, d in ((k, l), (l, k)):
            idx = a * n3 + b * n2 + c * nao + d
            out.index_put_((idx.reshape(-1),), blk.reshape(-1))
