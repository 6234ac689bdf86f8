"""Molecule container + geometry catalog (replaces PySCF gto.Mole usage in
reference Main.py:51-149 and the integral front-end of exp_pot.py/utilities.py).

Copy of ecw_cc_tpu/models/molecule.py (the PyTorch port imports
nothing of the JAX package); only the imports differ.
"""

from __future__ import annotations

import numpy as np

from ecw_cc_torch.models import integrals

ANG2BOHR = 1.0 / 0.52917721092

ELEMENT_Z = {"H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7,
             "O": 8, "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13,
             "Si": 14, "P": 15, "S": 16, "Cl": 17, "Ar": 18}

# Geometry catalog, verbatim from the reference driver (Main.py:55-129), in Angstrom.
GEOMETRIES = {
    "h2": [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 0.74))],
    "h2o": [("O", (0.0, 0.0, 0.0)), ("H", (0.0, -0.757, 0.587)), ("H", (0.0, 0.757, 0.587))],
    # beyond the reference catalog: experimental r(SH)=1.3356 A, 92.11 deg
    "h2s": [("S", (0.0, 0.0, 0.0)), ("H", (0.0, -0.9617, 0.9268)),
            ("H", (0.0, 0.9617, 0.9268))],
    "c2h2": [("C", (0.0, 0.0, 0.6034010)), ("C", (0.0, 0.0, -0.6034010)),
             ("H", (0.0, 0.0, 1.6667490)), ("H", (0.0, 0.0, -1.6667490))],
    "h2o2": [("O", (0.0, 0.7272250, -0.0593400)), ("O", (0.0, -0.7272250, -0.0593400)),
             ("H", (0.7847270, 0.8942120, 0.4747180)), ("H", (-0.7847270, -0.8942120, 0.4747180))],
    "allene": [("C", (0.0, 0.0, 0.0)), ("C", (0.0, 0.0, 1.3079970)), ("C", (0.0, 0.0, -1.3079970)),
               ("H", (0.0, 0.9259120, 1.8616000)), ("H", (0.0, -0.9259120, 1.8616000)),
               ("H", (0.9259120, 0.0, -1.8616000)), ("H", (-0.9259120, 0.0, -1.8616000))],
    "formamide": [("C", (-0.1602460, 0.3869220, 0.0000360)), ("O", (-1.1915410, -0.2451360, 0.0001150)),
                  ("N", (1.0794370, -0.1581170, -0.0013270)), ("H", (-0.1354140, 1.4855780, 0.0008460)),
                  ("H", (1.1758790, -1.1556350, 0.0035780)), ("H", (1.8972850, 0.4164350, 0.0037260))],
    "urea": [("C", (0.0000, 0.0000, 0.1449)), ("O", (0.0000, 0.0000, 1.3650)),
             ("N", (-0.1309, 1.1569, -0.6170)), ("N", (0.1309, -1.1569, -0.6170)),
             ("H", (0.0000, 1.9959, -0.0667)), ("H", (0.3478, 1.1778, -1.5093)),
             ("H", (0.0000, -1.9959, -0.0667)), ("H", (-0.3478, -1.1778, -1.5093))],
}


def parse_geometry(spec):
    """Accepts a catalog name, an xyz-like string ('H 0 0 0; H 0 0 0.74' or
    newline separated), or a list [(symbol_or_Z, (x, y, z)), ...] in Angstrom."""
    if isinstance(spec, str):
        key = spec.strip().lower()
        if key in GEOMETRIES:
            return [(s, tuple(c)) for s, c in GEOMETRIES[key]]
        if not any(ch.isdigit() for ch in spec):
            # a bare name that isn't in the catalog (reference Main.py:123-129)
            raise ValueError(
                f"molecule {spec!r} not recognized; available: "
                f"{sorted(GEOMETRIES)} — or pass an explicit geometry "
                "string/list")
        atoms = []
        for line in spec.replace(";", "\n").strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            sym = parts[0]
            # strip trailing digits used as labels (e.g. 'C1', 'H3' in the urea catalog)
            sym = "".join(ch for ch in sym if not ch.isdigit())
            atoms.append((sym.capitalize(), tuple(float(x) for x in parts[1:4])))
        if not atoms:
            raise ValueError(f"could not parse geometry {spec!r}")
        return atoms
    atoms = []
    for sym, xyz in spec:
        if isinstance(sym, (int, np.integer)):
            sym = {v: k for k, v in ELEMENT_Z.items()}[int(sym)]
        atoms.append((sym.capitalize(), tuple(float(x) for x in xyz)))
    return atoms


class Molecule:
    """Molecule + basis; computes and caches AO integrals.

    Coordinates are stored in Bohr. `charge`/`spin` follow the PySCF meaning
    (spin = 2S = Nalpha - Nbeta).
    """

    def __init__(self, geometry, basis, charge=0, spin=0, unit="angstrom"):
        atoms = parse_geometry(geometry)
        scale = ANG2BOHR if unit.lower().startswith("ang") else 1.0
        self.atoms = [(s, np.asarray(c, float) * scale) for s, c in atoms]
        self.basis_name = basis
        self.charge = charge
        self.spin = spin
        self.bs = integrals.BasisSet(self.atoms, basis)
        self.nao = self.bs.nao
        self._cache = {}

    # ---- composition ----------------------------------------------------
    @property
    def charges(self):
        return np.array([ELEMENT_Z[s] for s, _ in self.atoms], dtype=float)

    @property
    def coords(self):
        return np.array([c for _, c in self.atoms])

    @property
    def nelectron(self):
        return int(self.charges.sum()) - self.charge

    @property
    def nelec(self):
        na = (self.nelectron + self.spin) // 2
        return (na, self.nelectron - na)

    @property
    def natm(self):
        return len(self.atoms)

    def energy_nuc(self):
        e = 0.0
        Z, R = self.charges, self.coords
        for i in range(len(Z)):
            for j in range(i):
                e += Z[i] * Z[j] / np.linalg.norm(R[i] - R[j])
        return e

    def charge_center(self):
        Z, R = self.charges, self.coords
        return (Z[:, None] * R).sum(0) / Z.sum()

    # ---- integrals (cached) ---------------------------------------------
    def intor(self, kind, origin=None):
        """kind in {'ovlp','kin','nuc','r','int2e'}; 'r' needs `origin` (Bohr)."""
        key = (kind, None if origin is None else tuple(np.round(origin, 12)))
        if key in self._cache:
            return self._cache[key]
        if kind == "ovlp":
            v = integrals.overlap(self.bs)
        elif kind == "kin":
            v = integrals.kinetic(self.bs)
        elif kind == "nuc":
            v = integrals.nuclear(self.bs, self.charges, self.coords)
        elif kind == "r":
            v = integrals.dipole(self.bs, self.charge_center() if origin is None else origin)
        elif kind == "int2e":
            v = integrals.eri(self.bs)
        else:
            raise ValueError(kind)
        self._cache[key] = v
        return v

    def ft_aopair(self, kvecs):
        return integrals.ft_aopair(self.bs, kvecs)

    def copy(self):
        m = Molecule.__new__(Molecule)
        m.atoms = [(s, c.copy()) for s, c in self.atoms]
        m.basis_name = self.basis_name
        m.charge = self.charge
        m.spin = self.spin
        m.bs = self.bs
        m.nao = self.nao
        m._cache = {}
        return m

    def with_geometry(self, atoms_bohr):
        m = Molecule.__new__(Molecule)
        m.atoms = [(s, np.asarray(c, float)) for s, c in atoms_bohr]
        m.basis_name = self.basis_name
        m.charge = self.charge
        m.spin = self.spin
        m.bs = integrals.BasisSet(m.atoms, m.basis_name)
        m.nao = m.bs.nao
        m._cache = {}
        return m

    def with_basis(self, basis):
        m = Molecule.__new__(Molecule)
        m.atoms = [(s, c.copy()) for s, c in self.atoms]
        m.basis_name = basis
        m.charge = self.charge
        m.spin = self.spin
        m.bs = integrals.BasisSet(m.atoms, basis)
        m.nao = m.bs.nao
        m._cache = {}
        return m
