"""Raw CC residual equations by programmatic Wick contraction.

A copy of ecw_cc_tpu/ops/wick.py (NumPy only; the PyTorch port imports
nothing of the JAX package), with only this paragraph added.  The port's
EOM modules (ops/eom.py, ops/eom_ipea.py) take their transition-density,
Dyson and IP/EA sigma terms from it.

The reference ships hand-transcribed "raw" (unfactorized) CC equations as an
independent check of its factorized kernels, including a CCSDT set its
solvers never use (CC_raw_equations.py:523-640).  Re-transcribing hundreds
of einsum terms would be both error-prone and a copy; instead this module
DERIVES the raw equations:

    R_mu = <mu| (H_N e^T)_C |0>,   mu in {singles, doubles, triples}

by enumerating full Wick pairings of the second-quantized operator string
<0| (mu)^+  H_N  T_{n1} ... T_{nk} |0> with the Fermi-vacuum contraction
rules, collecting each surviving pairing into an einsum term (subscript
string, tensor labels, signed coefficient).  Connectedness is automatic:
pure excitation operators cannot contract with each other, so every T
factor must contract with H or the pairing vanishes — exactly the linked-
cluster restriction.

The generated CCSD equations are certified term-for-term against the
factorized Stanton kernels (ops/ccsd.tupdate(equation=True)) at random
amplitudes, which certifies the generator itself; the CCSDT equations then
come from the same machinery and are validated by solving them for a
3-electron system, where CCSDT is exact (== FCI).

Evaluation is jnp.einsum over the generated term list — jit-safe, TPU-ready
(tiny systems only; this is a validation oracle, not a production solver).

Conventions: H_N = sum f_pq {p+ q} + 1/4 sum <pq||rs> {p+ q+ s r} with f the
effective (normal-ordered) Fock matrix used by the CC kernels; T_n carries
1/(n!)^2 t^{ab..}_{ij..} a+ i b+ j ...; the k-fold cluster product carries
the multiset factor prod 1/m_j! from e^T.
"""

from __future__ import annotations

import itertools
from collections import Counter
from math import factorial

import numpy as np


# ---------------------------------------------------------------------------
# operator strings
#
# An elementary operator is (kind, space, index) with kind 'c' (creation
# a+_p) or 'a' (annihilation a_p) and space 'o' or 'v'.  Indices are symbols
# tagged with the tensor slot they belong to, so a full pairing directly
# yields an einsum subscript assignment.
# ---------------------------------------------------------------------------

class Op:
    __slots__ = ("kind", "space", "sym")

    def __init__(self, kind, space, sym):
        self.kind = kind      # 'c' or 'a'
        self.space = space    # 'o' / 'v' / 'g' (general: either space)
        self.sym = sym        # (tensor_id, slot)

    def __repr__(self):
        return f"{self.kind}{self.space}[{self.sym}]"


def _contractable(left: Op, right: Op):
    """Nonzero Fermi-vacuum contraction of (left, right) with left earlier
    in the string: a_a a+_b = delta_ab (virtual), a+_i a_j = delta_ij
    (occupied).  'g' (general) indices match either rule; the resulting
    space is returned (None if zero)."""
    sl, sr = left.space, right.space
    if left.kind == "a" and right.kind == "c":
        if sl in ("v", "g") and sr in ("v", "g"):
            return "v"
        return None
    if left.kind == "c" and right.kind == "a":
        if sl in ("o", "g") and sr in ("o", "g"):
            return "o"
        return None
    return None


def _pairings(ops):
    """Yield (pairs, sign) over all nonzero full Wick pairings.

    pairs: tuple of ((i, j), space) index pairs into `ops` (i < j).
    sign: (-1)^crossings.
    """
    n = len(ops)
    if n % 2:
        return
    order = list(range(n))

    def rec(remaining, acc, sign):
        if not remaining:
            yield tuple(acc), sign
            return
        i = remaining[0]
        for kj, j in enumerate(remaining[1:], start=1):
            sp = _contractable(ops[i], ops[j])
            if sp is None:
                continue
            # crossing-number sign: pairing (i, j) crosses the kj-1
            # remaining operators between them
            s = sign * (-1) ** (kj - 1)
            yield from rec(remaining[1:kj] + remaining[kj + 1:],
                           acc + [((i, j), sp)], s)

    yield from rec(order, [], 1)


# ---------------------------------------------------------------------------
# term assembly
# ---------------------------------------------------------------------------

def _h_parts():
    """Normal-ordered H pieces as (tensor_name, ops, prefactor).

    f: f_pq {p+ q};  v: 1/4 <pq||rs> {p+ q+ s r}.  String order matters for
    signs and must match the normal-ordered operator order."""
    f_ops = [Op("c", "g", ("f", 0)), Op("a", "g", ("f", 1))]
    v_ops = [Op("c", "g", ("v", 0)), Op("c", "g", ("v", 1)),
             Op("a", "g", ("v", 3)), Op("a", "g", ("v", 2))]
    return [("f", f_ops, 1.0), ("v", v_ops, 0.25)]


def _t_ops(n, tid):
    """T_n cluster operator string a+ i a+ j ... with tensor t{n}[i,j,..,a,b,..]
    (occupied slots first, then virtual — matching t2[i,j,a,b] storage)."""
    ops = []
    for k in range(n):
        ops.append(Op("c", "v", (tid, n + k)))   # a+_{a_k}
        ops.append(Op("a", "o", (tid, k)))       # a_{i_k}
    return ops


def _mu_ops(n, tid="mu"):
    """<mu|: the adjoint of the excitation a+_a a_i b+ j ... -> the bra
    string  ... j+ b i+ a  = reversed daggers.  mu tensor slots mirror
    t_n: occupied first, virtual second."""
    ops = []
    for k in reversed(range(n)):
        ops.append(Op("c", "o", (tid, k)))       # i_k^+
        ops.append(Op("a", "v", (tid, n + k)))   # a_{a_k}
    return ops


_ANTISYM = {"f": (), "v": ((0, 1), (2, 3)), "t1": (),
            "t2": ((0, 1), (2, 3)), "t3": ((0, 1, 2), (3, 4, 5)),
            # EOM-IP/EA amplitudes: r1 is a bare vector; rip2[i,j,a] is
            # antisymmetric in (i,j), rea2[i,a,b] in (a,b); the left
            # eigenvectors share the storage
            "rip1": (), "rip2": ((0, 1),),
            "rea1": (), "rea2": ((1, 2),),
            "lip1": (), "lip2": ((0, 1),),
            "lea1": (), "lea2": ((1, 2),),
            # ground-state Lambda de-excitation amplitudes
            "l1": (), "l2": ((0, 1), (2, 3)),
            # EOM-EE right/left eigenvector amplitudes (t-like storage)
            "ree1": (), "ree2": ((0, 1), (2, 3)),
            "lee1": (), "lee2": ((0, 1), (2, 3)),
            # identity on the occupied block (pq self-contraction)
            "eye_o": ()}


def _sort_sign(letters):
    """(parity sign, sorted letters) of sorting by selection sort."""
    ls = list(letters)
    sign = 1
    for i in range(len(ls)):
        k = min(range(i, len(ls)), key=lambda j: ls[j])
        if k != i:
            ls[i], ls[k] = ls[k], ls[i]
            sign = -sign
    return sign, ls


def _canon_term(coeff, pieces, out):
    """Canonicalize a term: sort antisymmetric tensor slots (sign-tracked),
    exploit v's (pq)<->(rs) pair-swap symmetry, sort the piece list, and
    relabel dummy indices in traversal order — iterated to a fixed point.
    Merges the dummy-relabeled duplicates the raw enumeration produces
    (equivalent-but-unmerged leftovers are harmless, just slower)."""
    occ_letters = "ijklmnop"
    vir_letters = "abcdefgh"
    pieces = list(pieces)
    sign = 1
    for _ in range(6):
        canon = []
        for name, ss in pieces:
            s = list(ss)
            for group in _ANTISYM[name]:
                sg, g_sorted = _sort_sign([s[k] for k in group])
                sign *= sg
                for k, c in zip(group, g_sorted):
                    s[k] = c
            if name == "v" and s[2:] < s[:2]:
                s = s[2:] + s[:2]
            canon.append((name, "".join(s)))
        canon.sort()
        # relabel dummies in order of first appearance (free mu letters
        # in `out` are pinned)
        mapping = {c: c for c in out}
        free_o = iter(c for c in occ_letters if c not in out)
        free_v = iter(c for c in vir_letters if c not in out)
        for name, ss in canon:
            for c in ss:
                if c not in mapping:
                    mapping[c] = (next(free_o) if c in occ_letters
                                  else next(free_v))
        relab = [(name, "".join(mapping[c] for c in ss))
                 for name, ss in canon]
        if relab == pieces:
            break
        pieces = relab
    return sign * coeff, tuple(pieces), out


def _r_ops_ipea(kind, n, tid):
    """Ionization/attachment operator strings.

    IP:  R1 = sum_i r_i a_i                      rip1[i]
         R2 = 1/2 sum_{ij,a} r_{ija} a+_a a_j a_i  rip2[i,j,a], antisym (i,j)
    EA:  R1 = sum_a r^a a+_a                     rea1[a]
         R2 = 1/2 sum_{i,ab} r_i^{ab} a+_a a+_b a_i  rea2[i,a,b], antisym (a,b)
    Returns (ops, prefactor, tensor_name)."""
    if kind == "ip":
        if n == 1:
            return [Op("a", "o", (tid, 0))], 1.0, "rip1"
        return [Op("c", "v", (tid, 2)), Op("a", "o", (tid, 1)),
                Op("a", "o", (tid, 0))], 0.5, "rip2"
    if n == 1:
        return [Op("c", "v", (tid, 0))], 1.0, "rea1"
    return [Op("c", "v", (tid, 1)), Op("c", "v", (tid, 2)),
            Op("a", "o", (tid, 0))], 0.5, "rea2"


def _mu_ops_ipea(kind, n):
    """Bra strings: the adjoints of the R operator strings above (product
    order reversed, daggers flipped); slot ids mirror the R storage."""
    if kind == "ip":
        if n == 1:          # <0| a+_i
            return [Op("c", "o", ("mu", 0))]
        #                    (a+_a a_j a_i)^+ = a+_i a+_j a_a
        return [Op("c", "o", ("mu", 0)), Op("c", "o", ("mu", 1)),
                Op("a", "v", ("mu", 2))]
    if n == 1:              # <0| a_a
        return [Op("a", "v", ("mu", 0))]
    #                        (a+_a a+_b a_i)^+ = a+_i a_b a_a
    return [Op("c", "o", ("mu", 0)), Op("a", "v", ("mu", 2)),
            Op("a", "v", ("mu", 1))]


def _lambda_ops(n, tid):
    """Lambda_n de-excitation string: 1/(n!)^2 l_{ij..ab..} a+_i a+_j .. a_b a_a
    (bra side of <0|(1+Lambda)); slots occupied-first, matching l2[i,j,a,b]."""
    ops = [Op("c", "o", (tid, k)) for k in range(n)]
    ops += [Op("a", "v", (tid, n + k)) for k in reversed(range(n))]
    return ops


def generate_dyson_terms(kind, side, p_space, t_levels=(1, 2)):
    """Einsum terms of one block of an EOM-IP/EA Dyson orbital.

    left :  d^L_p = <0| L_k  (e^-T a#_p e^T) |0>
    right:  d^R_p = <0| (1 + Lambda) (e^-T a#_p e^T) R_k |0>

    with a#_p = a_p / a+_p chosen by (kind, side): IP left annihilates
    (a_p), IP right creates (a+_p); EA mirrored.  p is restricted to
    p_space 'o' or 'v' — the occupied and virtual blocks of the vector are
    generated separately (they contract differently).

    e^-T X e^T = (X e^T)_C: every T factor must contract with a#_p
    directly (T-T contractions vanish), so terms with two or more T
    factors drop out automatically; the constraint is still enforced.

    Tensors: t1/t2; L_k as lip1/lip2 (lea1/lea2), the GS Lambda as l1/l2,
    R_k as rip1/rip2 (rea1/rea2) — all in the module's storage conventions.
    :return: list of (coeff, [(tensor, subscripts), ...], out_letter).
    """
    terms = Counter()
    occ_letters = "ijklmnop"
    vir_letters = "abcdefgh"
    ap_kind = {("ip", "left"): "a", ("ip", "right"): "c",
               ("ea", "left"): "c", ("ea", "right"): "a"}[(kind, side)]
    ap = Op(ap_kind, p_space, ("ap", 0))

    if side == "left":
        # the L eigenvector bra: same strings as the mu projections
        bra_choices = []
        for rank in (1, 2):
            name = ("lip" if kind == "ip" else "lea") + str(rank)
            ops = [Op(o.kind, o.space, (name, o.sym[1]))
                   for o in _mu_ops_ipea(kind, rank)]
            bra_choices.append((ops, 0.5 if rank == 2 else 1.0, name))
        ket_choices = [([], 1.0, None)]
    else:
        bra_choices = [([], 1.0, None)]
        for n in (1, 2):
            bra_choices.append((_lambda_ops(n, "lam"),
                                1.0 / float(factorial(n)) ** 2, f"l{n}"))
        ket_choices = []
        for rank in (1, 2):
            ops, pref, name = _r_ops_ipea(kind, rank, "r#")
            ket_choices.append((ops, pref, name))

    for bra_ops, bra_pref, bra_name in bra_choices:
        for ket_ops, ket_pref, ket_name in ket_choices:
            for k in range(0, 3):
                for combo in itertools.combinations_with_replacement(
                        t_levels, k):
                    nt = 2 * sum(combo)
                    if (len(bra_ops) + 1 + nt + len(ket_ops)) % 2:
                        continue
                    mult = Counter(combo)
                    fac = bra_pref * ket_pref
                    for m in mult.values():
                        fac /= float(factorial(m))
                    for n in combo:
                        fac /= float(factorial(n)) ** 2
                    t_ops_all = []
                    t_names = []
                    for idx, n in enumerate(combo):
                        tid = f"t{n}#{idx}"
                        t_names.append((tid, f"t{n}", n))
                        t_ops_all.extend(_t_ops(n, tid))
                    ops = list(bra_ops) + [ap] + t_ops_all + list(ket_ops)
                    for pairs, sign in _pairings(ops):
                        touched = set()
                        ok = True
                        for (i, j), sp in pairs:
                            ti = ops[i].sym[0]
                            tj = ops[j].sym[0]
                            if ti == tj:
                                ok = False
                                break
                            if ti == "ap" and tj.startswith("t"):
                                touched.add(tj)
                            if tj == "ap" and ti.startswith("t"):
                                touched.add(ti)
                        if not ok:
                            continue
                        if any(tid not in touched for tid, _, _ in t_names):
                            continue
                        sub = {}
                        no, nv = 0, 0
                        for (i, j), sp in pairs:
                            if sp == "o":
                                letter = occ_letters[no]
                                no += 1
                            else:
                                letter = vir_letters[nv]
                                nv += 1
                            sub[ops[i].sym] = letter
                            sub[ops[j].sym] = letter
                        pieces = []
                        for tname, nslots in (
                                ((bra_name, len(bra_ops)),)
                                if bra_name else ()):
                            pieces.append((tname, "".join(
                                sub[(("lam" if tname in ("l1", "l2")
                                      else tname), s)]
                                for s in range(nslots))))
                        for tid, tname, n in t_names:
                            pieces.append((tname, "".join(
                                sub[(tid, s)] for s in range(2 * n))))
                        if ket_name:
                            pieces.append((ket_name, "".join(
                                sub[("r#", s)] for s in range(len(ket_ops)))))
                        out = sub[("ap", 0)]
                        c, cpieces, out = _canon_term(sign * fac, pieces, out)
                        terms[(cpieces, out)] += c
    return [(coeff, list(pieces), out)
            for (pieces, out), coeff in terms.items() if abs(coeff) > 1e-12]


def generate_trdm_terms(bra, ket, p_space, q_space, t_levels=(1, 2)):
    """Einsum terms of one block of an EE (transition) one-body density.

        gamma_pq = <bra| (e^-T a+_p a_q e^T) |ket'>

    bra: 'gs'  — <0|(1+Lambda)   (tensors l1/l2)
         'lee' — <0|L_k          (EOM-EE left eigenvector, lee1/lee2)
         'one' — <0|             (bare reference bra)
    ket: 'ref' — |0>             (the ket's r0-weighted reference part)
         'ree' — R_k|0>          (EOM-EE right eigenvector, ree1/ree2)
    p_space/q_space: 'o'/'v' — the four blocks are generated separately.

    The a+_p a_q pair may self-contract (p,q both occupied): that pairing
    contributes delta_pq on the occupied block, emitted as an 'eye_o'
    tensor piece so overlap-type terms (e.g. delta_oo * l2.r2) evaluate as
    ordinary einsums.  Every T factor must contract with the a+_p a_q pair
    (the connected identity; >=3 T factors vanish automatically).

    Validated against determinant-space contractions at random amplitudes
    (tests/test_eom.py) — unlike the reference's hand-derived tr_rdm1
    (CCSD.py:75-133), whose bra carries an implicit unit reference weight
    and which omits the <0|pq-bar R|0> coupling entirely.
    """
    terms = Counter()
    occ_letters = "ijklmnop"
    vir_letters = "abcdefgh"
    pq_ops = [Op("c", p_space, ("pq", 0)), Op("a", q_space, ("pq", 1))]

    if bra == "gs":
        bra_choices = [([], 1.0, None)]
        for n in (1, 2):
            bra_choices.append((_lambda_ops(n, "lam"),
                                1.0 / float(factorial(n)) ** 2, f"l{n}"))
    elif bra == "lee":
        bra_choices = []
        for n in (1, 2):
            ops = [Op(o.kind, o.space, (f"lee{n}", o.sym[1]))
                   for o in _mu_ops(n, f"lee{n}")]
            bra_choices.append((ops, 1.0 / float(factorial(n)) ** 2,
                                f"lee{n}"))
    else:
        bra_choices = [([], 1.0, None)]

    if ket == "ree":
        ket_choices = [(_t_ops(n, "r~"), 1.0 / float(factorial(n)) ** 2,
                        f"ree{n}") for n in (1, 2)]
    else:
        ket_choices = [([], 1.0, None)]

    for bra_ops, bra_pref, bra_name in bra_choices:
        for ket_ops, ket_pref, ket_name in ket_choices:
            for k in range(0, 3):
                for combo in itertools.combinations_with_replacement(
                        t_levels, k):
                    nt = 2 * sum(combo)
                    if (len(bra_ops) + 2 + nt + len(ket_ops)) % 2:
                        continue
                    mult = Counter(combo)
                    fac = bra_pref * ket_pref
                    for m in mult.values():
                        fac /= float(factorial(m))
                    for n in combo:
                        fac /= float(factorial(n)) ** 2
                    t_ops_all = []
                    t_names = []
                    for idx, n in enumerate(combo):
                        tid = f"t{n}#{idx}"
                        t_names.append((tid, f"t{n}", n))
                        t_ops_all.extend(_t_ops(n, tid))
                    ops = (list(bra_ops) + pq_ops + t_ops_all
                           + list(ket_ops))
                    for pairs, sign in _pairings(ops):
                        touched = set()
                        pq_self = False
                        ok = True
                        for (i, j), sp in pairs:
                            ti = ops[i].sym[0]
                            tj = ops[j].sym[0]
                            if ti == tj:
                                if ti == "pq":
                                    pq_self = True
                                    continue
                                ok = False
                                break
                            if ti == "pq" and tj.startswith("t"):
                                touched.add(tj)
                            if tj == "pq" and ti.startswith("t"):
                                touched.add(ti)
                        if not ok:
                            continue
                        if any(tid not in touched for tid, _, _ in t_names):
                            continue
                        sub = {}
                        no, nv = 0, 0
                        eye_piece = None
                        for (i, j), sp in pairs:
                            if (ops[i].sym[0] == "pq"
                                    and ops[j].sym[0] == "pq"):
                                # self-contraction: delta on occupied;
                                # both slots get FRESH free letters and an
                                # explicit identity operand carries the
                                # delta into the einsum
                                la = occ_letters[no]
                                no += 1
                                lb = occ_letters[no]
                                no += 1
                                sub[("pq", 0)] = la
                                sub[("pq", 1)] = lb
                                eye_piece = ("eye_o", la + lb)
                                continue
                            if sp == "o":
                                letter = occ_letters[no]
                                no += 1
                            else:
                                letter = vir_letters[nv]
                                nv += 1
                            sub[ops[i].sym] = letter
                            sub[ops[j].sym] = letter
                        pieces = []
                        if eye_piece is not None:
                            pieces.append(eye_piece)
                        if bra_name:
                            nb = len(bra_ops)
                            btid = ("lam" if bra_name in ("l1", "l2")
                                    else bra_name)
                            pieces.append((bra_name, "".join(
                                sub[(btid, s)] for s in range(nb))))
                        for tid, tname, n in t_names:
                            pieces.append((tname, "".join(
                                sub[(tid, s)] for s in range(2 * n))))
                        if ket_name:
                            pieces.append((ket_name, "".join(
                                sub[("r~", s)] for s in range(len(ket_ops)))))
                        out = sub[("pq", 0)] + sub[("pq", 1)]
                        c, cpieces, out = _canon_term(sign * fac, pieces, out)
                        terms[(cpieces, out)] += c
    return [(coeff, list(pieces), out)
            for (pieces, out), coeff in terms.items() if abs(coeff) > 1e-12]


def generate_eom_terms(kind, mu_rank, r_ranks=(1, 2), t_levels=(1, 2),
                       connected=True):
    """All einsum terms of <mu| H_N e^T R |0> for EOM-IP/EA sigma vectors.

    kind: 'ip' or 'ea'; mu_rank: 1 (1h / 1p) or 2 (2h1p / 2p1h).

    connected=True keeps only terms where R contracts with H — the textbook
    sigma (Hbar_N R)_C whose eigenvalues are the omega directly.
    connected=False additionally keeps the R-disconnected pieces, making the
    matrix equal the determinant-space projection  P (e^-T H_N e^T) P  at
    ARBITRARY amplitudes (the oracle identity tested in
    tests/test_eom_ipea.py); at converged T the two variants differ by
    E_corr * identity (plus GS-residual terms that vanish there).

    Every T factor must contract with H (linked-cluster, as in
    generate_terms); T-T, R-R, mu-mu self-pairings vanish automatically.

    :return: list of (coeff, [(tensor, subscripts), ...], out_subscripts);
        tensors are 'f', 'v', 't1', 't2' and one of rip1/rip2/rea1/rea2.
    """
    terms = Counter()
    occ_letters = "ijklmnop"
    vir_letters = "abcdefgh"
    mu_ops = _mu_ops_ipea(kind, mu_rank)
    n_mu = len(mu_ops)

    for hname, h_ops, h_pref in _h_parts():
        n_h = len(h_ops)
        for r_rank in r_ranks:
            r_ops, r_pref, r_name = _r_ops_ipea(kind, r_rank, "r#")
            n_r = len(r_ops)
            for k in range(0, n_h + 1):
                for combo in itertools.combinations_with_replacement(
                        t_levels, k):
                    nt = 2 * sum(combo)
                    if (nt + n_mu + n_h + n_r) % 2:
                        continue
                    mult = Counter(combo)
                    fac = h_pref * r_pref
                    for m in mult.values():
                        fac /= float(factorial(m))
                    for n in combo:
                        fac /= float(factorial(n)) ** 2
                    t_ops_all = []
                    t_names = []
                    for idx, n in enumerate(combo):
                        tid = f"t{n}#{idx}"
                        t_names.append((tid, f"t{n}", n))
                        t_ops_all.extend(_t_ops(n, tid))
                    ops = mu_ops + h_ops + t_ops_all + r_ops
                    for pairs, sign in _pairings(ops):
                        touched = set()
                        r_touched = False
                        ok = True
                        for (i, j), sp in pairs:
                            ti = ops[i].sym[0]
                            tj = ops[j].sym[0]
                            in_h_i = n_mu <= i < n_mu + n_h
                            in_h_j = n_mu <= j < n_mu + n_h
                            if in_h_i:
                                if tj.startswith("t"):
                                    touched.add(tj)
                                elif tj == "r#":
                                    r_touched = True
                            if in_h_j:
                                if ti.startswith("t"):
                                    touched.add(ti)
                                elif ti == "r#":
                                    r_touched = True
                            if ti == tj:
                                ok = False
                                break
                        if not ok:
                            continue
                        if any(tid not in touched for tid, _, _ in t_names):
                            continue
                        if connected and not r_touched:
                            continue
                        sub = {}
                        no, nv = 0, 0
                        for (i, j), sp in pairs:
                            if sp == "o":
                                letter = occ_letters[no]
                                no += 1
                            else:
                                letter = vir_letters[nv]
                                nv += 1
                            sub[ops[i].sym] = letter
                            sub[ops[j].sym] = letter
                        pieces = []
                        if hname == "f":
                            pieces.append(("f", sub[("f", 0)] + sub[("f", 1)]))
                        else:
                            pieces.append(("v", "".join(
                                sub[("v", s)] for s in range(4))))
                        for tid, tname, n in t_names:
                            pieces.append((tname, "".join(
                                sub[(tid, s)] for s in range(2 * n))))
                        pieces.append((r_name, "".join(
                            sub[("r#", s)] for s in range(n_r))))
                        out = "".join(sub[("mu", s)] for s in range(n_mu))
                        c, cpieces, out = _canon_term(sign * fac, pieces, out)
                        terms[(cpieces, out)] += c
    return [(coeff, list(pieces), out)
            for (pieces, out), coeff in terms.items() if abs(coeff) > 1e-12]


def generate_terms(mu_level, t_levels=(1, 2, 3), max_rank=4):
    """All einsum terms of <mu_level| (H_N e^T)_C |0>.

    :return: list of (coeff, [(tensor, subscripts), ...], out_subscripts)
        where subscripts use 'ijklmn' for occupied and 'abcdef' for virtual
        symbols; out_subscripts are the free mu indices (occ then vir).
    """
    terms = Counter()
    occ_letters = "ijklmnop"
    vir_letters = "abcdefgh"

    for hname, h_ops, h_pref in _h_parts():
        n_h = len(h_ops)
        n_mu = 2 * mu_level
        for k in range(0, n_h + 1):
            for combo in itertools.combinations_with_replacement(
                    t_levels, k):
                # T-T contractions vanish identically, so every T index
                # must pair with mu or H (and vice versa) — prune
                # impossible operator counts before enumerating
                nt = 2 * sum(combo)
                if nt > n_mu + n_h or n_mu > n_h + nt or n_h > n_mu + nt:
                    continue
                if (nt + n_mu + n_h) % 2:
                    continue
                # e^T multiset factor
                mult = Counter(combo)
                fac = h_pref
                for m in mult.values():
                    fac /= float(factorial(m))
                for n in combo:
                    fac /= float(factorial(n)) ** 2
                t_ops_all = []
                t_names = []
                for idx, n in enumerate(combo):
                    tid = f"t{n}#{idx}"
                    t_names.append((tid, f"t{n}", n))
                    t_ops_all.extend(_t_ops(n, tid))
                ops = _mu_ops(mu_level) + h_ops + t_ops_all
                for pairs, sign in _pairings(ops):
                    # linked-cluster: every T factor must touch H
                    touched = set()
                    ok = True
                    for (i, j), sp in pairs:
                        ti = ops[i].sym[0]
                        tj = ops[j].sym[0]
                        in_h_i = n_mu <= i < n_mu + n_h
                        in_h_j = n_mu <= j < n_mu + n_h
                        if in_h_i and tj.startswith("t"):
                            touched.add(tj)
                        if in_h_j and ti.startswith("t"):
                            touched.add(ti)
                        # mu must not contract with itself / T with itself
                        if ti == tj:
                            ok = False
                            break
                    if not ok:
                        continue
                    if any(tid not in touched for tid, _, _ in t_names):
                        continue
                    # assign letters per contraction
                    sub = {}
                    no, nv = 0, 0
                    for (i, j), sp in pairs:
                        if sp == "o":
                            letter = occ_letters[no]
                            no += 1
                        else:
                            letter = vir_letters[nv]
                            nv += 1
                        sub[ops[i].sym] = letter
                        sub[ops[j].sym] = letter
                    # build einsum pieces
                    pieces = []
                    if hname == "f":
                        pieces.append(("f", sub[("f", 0)] + sub[("f", 1)]))
                    else:
                        pieces.append(("v", "".join(
                            sub[("v", s)] for s in range(4))))
                    for tid, tname, n in t_names:
                        pieces.append((tname, "".join(
                            sub[(tid, s)] for s in range(2 * n))))
                    out = "".join(sub[("mu", s)] for s in range(2 * mu_level))
                    c, cpieces, out = _canon_term(sign * fac, pieces, out)
                    terms[(cpieces, out)] += c
    out_terms = []
    for (pieces, out), coeff in terms.items():
        if abs(coeff) > 1e-12:
            out_terms.append((coeff, list(pieces), out))
    return out_terms


def evaluate_terms(terms, f, v, t1=None, t2=None, t3=None, xp=np):
    """Evaluate a generated term list with concrete tensors.

    f: effective Fock (nmo, nmo); v: <pq||rs> antisymmetrized (nmo^4);
    t1/t2/t3: amplitudes in occ-then-vir storage (t2[i,j,a,b], ...).
    Slices f/v blocks per subscript spaces.  Returns the residual array
    with mu's (occ.., vir..) axes."""
    nocc = t1.shape[0] if t1 is not None else t2.shape[0]
    occ, vir = slice(0, nocc), slice(nocc, None)
    tens = {"t1": t1, "t2": t2, "t3": t3}

    def block(name, subs):
        src = f if name == "f" else v
        sl = tuple(occ if c in "ijklmnop" else vir for c in subs)
        return src[sl]

    out = None
    for coeff, pieces, out_subs in terms:
        operands = []
        subs = []
        for name, ss in pieces:
            if name in ("f", "v"):
                operands.append(block(name, ss))
            else:
                if tens[name] is None:
                    operands = None
                    break
                operands.append(tens[name])
            subs.append(ss)
        if operands is None:
            continue
        expr = ",".join(subs) + "->" + out_subs
        # optimize=True: 3-operand terms (e.g. v.t3.t3) are intractable
        # under the naive nested-loop contraction path
        val = coeff * xp.einsum(expr, *operands, optimize=True)
        out = val if out is None else out + val
    return out


# ---------------------------------------------------------------------------
# CCSDT solver on the generated equations (validation-scale only)
# ---------------------------------------------------------------------------

def solve_raw_cc(f, v, nocc, levels=(1, 2, 3), conv_tol=1e-10,
                 max_cycle=200, damp=0.0):
    """Jacobi-solve the generated raw equations for t1 (+t2 +t3).

    Returns (amps dict, E_corr).  Intended for tiny validation systems
    (3-electron CCSDT == FCI); production solves use the factorized
    kernels."""
    nmo = f.shape[0]
    nvir = nmo - nocc
    eps = np.diag(f)
    eia = eps[:nocc, None] - eps[None, nocc:]
    amps = {}
    if 1 in levels:
        amps["t1"] = np.zeros((nocc, nvir))
    if 2 in levels:
        amps["t2"] = np.zeros((nocc, nocc, nvir, nvir))
    if 3 in levels:
        amps["t3"] = np.zeros((nocc,) * 3 + (nvir,) * 3)
    term_sets = {n: generate_terms(n, t_levels=levels) for n in levels}
    e_terms = generate_terms(0, t_levels=levels)

    denoms = {}
    if 1 in levels:
        denoms[1] = eia
    if 2 in levels:
        denoms[2] = eia[:, None, :, None] + eia[None, :, None, :]
    if 3 in levels:
        denoms[3] = (eia[:, None, None, :, None, None]
                     + eia[None, :, None, None, :, None]
                     + eia[None, None, :, None, None, :])

    e_old = 0.0
    for _ in range(max_cycle):
        res = {n: evaluate_terms(term_sets[n], f, v, **amps)
               for n in levels}
        for n in levels:
            amps[f"t{n}"] = (1 - damp) * (
                amps[f"t{n}"] + res[n] / denoms[n]) + damp * amps[f"t{n}"]
        e = float(evaluate_terms(e_terms, f, v, **amps))
        if abs(e - e_old) < conv_tol:
            break
        e_old = e
    return amps, e
