"""Gaussian94 / EMSL basis-set file reader and writer.

Matches the reference capability of loading any published basis set (the
reference delegates to PySCF, ECW_CC/Main.py:131-143; this
framework is PySCF-free, so published sets are loaded from standard
Gaussian94-format text as exported by the EMSL Basis Set Exchange).

Format parsed (the BSE "Gaussian" flavor):

    ! comment lines
    ****
    H     0
    S    3   1.00
          3.42525091           0.15432897
          0.62391373           0.53532814
          0.16885540           0.44463454
    ****
    O     0
    SP   3   1.00
         5.0331513           -0.09996723            0.15591627
    ...

Rules honored:
  - '!' comments and blank lines ignored; '****' separates element blocks
    (a leading '****' is optional).
  - element header: "<symbol> 0".
  - shell header: "<L-label> <nprim> <scale>", L-label in S/P/D/F/G/H or a
    fused label (SP, SPD, L == SP): fused shells are split into one shell
    per angular momentum with SHARED exponents (the repo's storage
    convention, models/basis_data.py).
  - numbers may use Fortran 'D' exponents (1.2D+03).
  - a non-1.0 scale factor scales every exponent by scale**2 (the
    Gaussian convention; EMSL always exports 1.00).

Output layout == models/basis_data.py: {element: [(l, [(exp, coeff),...]),...]}
with coefficients w.r.t. normalized primitives (EMSL convention; the
integral engine renormalizes contractions numerically).

Copy of ecw_cc_tpu/models/basis_io.py (the PyTorch port imports
nothing of the JAX package); only the imports and the reference's
path above differ.
"""

from __future__ import annotations

_L_LABELS = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4, "H": 5, "I": 6}


def _num(tok):
    return float(tok.replace("D", "E").replace("d", "e"))


def parse_gaussian94(text):
    """Parse Gaussian94-format basis text -> {element: shell list}."""
    table = {}
    lines = [ln.split("!", 1)[0].rstrip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln.strip()]
    i = 0
    # optional leading separator(s)
    while i < len(lines) and lines[i].strip() == "****":
        i += 1
    while i < len(lines):
        head = lines[i].split()
        # an element header is "<symbol> 0"; a shell header's second token
        # is nprim >= 1 (the symbol alone can't discriminate: H is both an
        # element and the l=5 label)
        if len(head) != 2 or head[1] != "0":
            raise ValueError(
                f"expected an element header ('<symbol> 0'), got "
                f"{lines[i]!r} (missing '****' separator?)")
        el = head[0].capitalize()
        i += 1
        shells = []
        while i < len(lines) and lines[i].strip() != "****":
            hd = lines[i].split()
            if len(hd) < 2:
                raise ValueError(f"bad shell header: {lines[i]!r}")
            label = hd[0].upper()
            label = "SP" if label == "L" else label
            try:
                nprim = int(hd[1])
            except ValueError:
                raise ValueError(f"bad shell header: {lines[i]!r}")
            scale = _num(hd[2]) if len(hd) > 2 else 1.0
            if label in _L_LABELS:
                ls = [_L_LABELS[label]]
            else:
                try:
                    ls = [_L_LABELS[c] for c in label]
                except KeyError:
                    raise ValueError(f"unknown shell label {label!r}")
            i += 1
            rows = []
            for _ in range(nprim):
                if i >= len(lines):
                    raise ValueError(
                        f"truncated shell ({label}, {nprim} primitives) "
                        f"for element {el}")
                toks = lines[i].split()
                if len(toks) != 1 + len(ls):
                    raise ValueError(
                        f"expected exponent + {len(ls)} coefficient(s), "
                        f"got {lines[i]!r}")
                rows.append([_num(t) for t in toks])
                i += 1
            s2 = scale * scale
            for k, l in enumerate(ls):
                shells.append(
                    (l, [(r[0] * s2, r[1 + k]) for r in rows]))
        table.setdefault(el, []).extend(shells)
        while i < len(lines) and lines[i].strip() == "****":
            i += 1
    if not table:
        raise ValueError("no basis data found in text")
    return table


def load_basis_file(path):
    """Read a Gaussian94/EMSL basis file -> {element: shell list}."""
    with open(path) as fh:
        return parse_gaussian94(fh.read())


_INV_L = {v: k for k, v in _L_LABELS.items()}


def format_gaussian94(table):
    """{element: shell list} -> Gaussian94 text (round-trips through
    parse_gaussian94; shared-exponent sp fusion is NOT reconstructed —
    every shell is written separately, which every consumer accepts)."""
    out = []
    for el in table:
        out.append(f"{el:<6s} 0")
        for l, prims in table[el]:
            out.append(f"{_INV_L[l]}   {len(prims)}   1.00")
            for e, c in prims:
                out.append(f"      {e:<18.10f} {c: .10f}")
        out.append("****")
    return "\n".join(out) + "\n"
