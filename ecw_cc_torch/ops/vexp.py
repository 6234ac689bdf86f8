"""Experimental-constraint (Vexp) engine for the ground state.

Port of ecw_cc_tpu/ops/vexp.py (reference exp_pot.py): the host class `Exp`
holds the target data and the MO-basis property integrals and updates
Vexp[0, 0] from an rdm1 (NumPy, reference API); `make_gs_vexp_device`
builds the update the solver runs on the device every iteration.

Ground-state properties only: 'mat', 'Ek', 'v1e', 'dip' and 'F'.  The
excited-state targets ('trmat', 'trdip', 'DEk', ES 'mat') wait for the ES
solver (ROADMAP A.11) and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ecw_cc_torch.utils import convert
from ecw_cc_torch.utils import props as uprops

GS_PROPS = ("mat", "Ek", "v1e", "dip", "F")


def _es_not_ported(what):
    return NotImplementedError(
        f"{what}: excited-state Vexp targets are not ported yet "
        "(ROADMAP A.11)")


class Exp:
    """Reference exp_pot.py:13-129, ground-state part.  exp_data =
    [[GS props]], each prop ['name', value] with name in GS_PROPS."""

    def __init__(self, L, exp_data, mol, mo_coeff, Ek_exp_GS=None,
                 Ek_HF_GS=None, HF_prop=False):
        if len(exp_data) != 1:
            raise _es_not_ported(f"{len(exp_data) - 1} excited states")
        self.nbr_states = 1
        self.exp_data = exp_data
        self.mo_coeff = np.asarray(mo_coeff)
        self.mol = mol
        self.prop_calc = []
        self.HF_prop = (HF_prop if HF_prop
                        else [[None for _ in exp_data[0]]])
        self.Ek_HF_GS = Ek_HF_GS
        self.L = self.L_check(L)
        self.charge_center = None

        self.Ek_int = None
        self.dip_int = None
        self.v1e_int = None
        self.F_int = None
        self.dic_int = {}
        self.prop_names = [[]]
        for prop in exp_data[0]:
            name = prop[0]
            if name not in GS_PROPS:
                raise _es_not_ported(f"target {name!r}")
            if name == "F":
                if len(prop) < 4:
                    raise SyntaxError(
                        "structure factors require ['F', F, h, rec_vec]")
                if self.F_int is None:
                    _, self.F_int = uprops.FT_MO(
                        mol, prop[2], self.mo_coeff, prop[3])
                    self.dic_int["F"] = np.stack([
                        convert.convert_aoint(fa, self.mo_coeff)
                        for fa in self.F_int])
                self.h = prop[2]
                self.rec_vec = prop[3]
            if name == "dip" and self.dip_int is None:
                self.charge_center = mol.charge_center()
                self.dip_int = mol.intor("r", origin=self.charge_center)
                self.dic_int["dip"] = convert.convert_aoint(self.dip_int,
                                                            self.mo_coeff)
            if name == "v1e" and self.v1e_int is None:
                self.v1e_int = mol.intor("nuc")
                self.dic_int["v1e"] = convert.convert_aoint(self.v1e_int,
                                                            self.mo_coeff)
            if name == "Ek" and self.Ek_int is None:
                self.Ek_int = mol.intor("kin")
                self.dic_int["Ek"] = convert.convert_aoint(self.Ek_int,
                                                           self.mo_coeff)
            self.prop_names[0].append(name)

        self.Ek_exp_GS = Ek_exp_GS
        self.Ek_calc_GS = None
        self.Delta_Ek_GS = None
        self.Vexp = np.full((1, 1), None)

    def Vexp_update(self, rdm1, rdm1_add, index, L=None):
        """Update Vexp[0, 0] from the GS rdm1; return (Delta, vmax).
        Reference exp_pot.py:131-345 (GS branches)."""
        if tuple(index) != (0, 0):
            raise _es_not_ported(f"Vexp index {index}")
        rdm1 = np.asarray(rdm1)
        self.Vexp[0, 0] = np.zeros_like(rdm1)
        Delta = 0.0
        vmax = 0.0
        self.prop_calc = []
        L = self.L if L is None else self.L_check(L)

        for i, prop in enumerate(self.prop_names[0]):
            w = L[0][i]
            if prop == "mat":
                diff = np.subtract(self.exp_data[0][i][1], rdm1)
                self.Vexp[0, 0] += w * diff
                Delta += self.Delta(0, i, diff)
                vmax += np.max(np.abs(diff))
                if self.Ek_exp_GS is not None:
                    self.Ek_calc_GS = uprops.Ekin(
                        self.mol, rdm1, aobasis=False,
                        mo_coeff=self.mo_coeff, ek_int=self.Ek_int, g=True)
                    denom = (np.abs(self.Ek_exp_GS) if self.Ek_HF_GS is None
                             else np.abs(self.Ek_exp_GS - self.Ek_HF_GS))
                    self.Delta_Ek_GS = (np.abs(self.Ek_exp_GS
                                               - self.Ek_calc_GS) / denom)
            elif prop in ("Ek", "v1e"):
                calc = self.calc_prop(prop, rdm1)
                diff = np.abs(self.exp_data[0][i][1] - calc)
                Delta += self.Delta(0, i, diff)
                dmat = diff * self.dic_int[prop]
                self.Vexp[0, 0] += w * dmat
                vmax += np.max(np.abs(dmat))
                self.prop_calc.append([prop, calc])
            elif prop == "dip":
                calc = self.calc_prop("dip", rdm1)
                for j, (d_calc, d_exp) in enumerate(
                        zip(calc, self.exp_data[0][i][1])):
                    diff = np.abs(d_exp - d_calc)
                    Delta += self.Delta(0, i, diff, comp_idx=j)
                    dmat = diff * self.dic_int["dip"][j]
                    self.Vexp[0, 0] += w * dmat
                    vmax += np.max(np.abs(dmat))
                self.prop_calc.append([prop, calc])
            elif prop == "F":
                calc = uprops.structure_factor(
                    self.mol, self.h, rdm1, aobasis=False,
                    mo_coeff=self.mo_coeff, F_int=self.F_int,
                    rec_vec=self.rec_vec)
                for F_exp, F_calc, F_int_mo in zip(
                        self.exp_data[0][i][1], calc, self.dic_int["F"]):
                    diff = np.abs(F_exp - F_calc)
                    Delta += self.Delta(0, i, diff)
                    dmat = np.real(diff * F_int_mo)
                    self.Vexp[0, 0] += w * (2.0 / len(self.h)) * dmat
                    vmax += np.max(np.abs(dmat))
                self.prop_calc.append([prop, calc])
        return Delta, vmax

    def calc_prop(self, prop, rdm1):
        """Reference exp_pot.py:347-390 (state properties)."""
        if prop == "Ek":
            return uprops.Ekin(self.mol, rdm1, g=True, aobasis=False,
                               mo_coeff=self.mo_coeff, ek_int=self.Ek_int)
        if prop == "v1e":
            return uprops.v1e(self.mol, rdm1, g=True, aobasis=False,
                              mo_coeff=self.mo_coeff, v1e_int=self.v1e_int)
        if prop == "dip":
            return list(uprops.dipole(self.mol, rdm1, g=True,
                                      aobasis=False, mo_coeff=self.mo_coeff,
                                      dip_int=self.dip_int))
        raise NotImplementedError("possible properties are Ek, v1e and dip")

    def Delta(self, n_st, i_prop, prop_diff, comp_idx=1, threshold=1e-6):
        """Relative deviation; reference exp_pot.py:392-448."""
        exp_val = self.exp_data[n_st][i_prop][1]
        hf = self.HF_prop[n_st][i_prop] if n_st < len(self.HF_prop) else None
        if isinstance(prop_diff, np.ndarray) and n_st == 0:
            if hf is None:
                return np.sum(np.abs(prop_diff)) / np.sum(np.abs(exp_val))
            return np.sum(np.abs(prop_diff)) / np.sum(np.abs(exp_val - hf))
        if (isinstance(exp_val, (list, tuple, np.ndarray))
                and not np.isscalar(exp_val)):
            ref = exp_val[comp_idx]
            if abs(ref) > threshold:
                if hf is None:
                    return prop_diff / np.abs(ref)
                return prop_diff / np.abs(ref - hf[comp_idx])
            return 0.0
        if (isinstance(exp_val, (float, np.floating))
                and abs(exp_val) > threshold):
            if hf is None:
                return prop_diff / np.abs(exp_val)
            return prop_diff / np.abs(exp_val - hf)
        return 0.0

    def L_check(self, L):
        """Normalize the weight format to [[w per prop] per state].
        Reference exp_pot.py:459-489."""
        if isinstance(L, (float, int)):
            return [[float(L)] * len(st) for st in self.exp_data]
        if isinstance(L, (list, np.ndarray)):
            if len(L) != self.nbr_states:
                raise SyntaxError(
                    "constraint-weight length must equal the number of "
                    "states (did you forget L_loop=True?)")
            out = []
            for st, l in zip(self.exp_data, L):
                l = list(np.atleast_1d(l))
                if len(st) != len(l) and len(l) == 1:
                    l = l * len(st)
                elif len(st) != len(l):
                    raise SyntaxError("wrong syntax for L list")
                out.append([float(x) for x in l])
            return out
        raise SyntaxError("L must be a float or a nested list")


def _f_update(trace_F, F_pot, nh_F, tgt_np, rdm1):
    """Structure-factor body of the device GS update: |F| deviation per
    reciprocal vector, potential = deviation-weighted real MO FT integrals
    scaled 2/nh.  Returns (vpot, delta_inc or None, vmax_inc); delta_inc is
    None when the normalization reference is below threshold (host Delta()
    quirk: every component is normalized by |exp[1]|)."""
    Fre, Fim = trace_F
    cre = torch.einsum("hij,ji->h", Fre, rdm1)
    cim = torch.einsum("hij,ji->h", Fim, rdm1)
    tgt_np = np.asarray(tgt_np)
    t_re = torch.as_tensor(np.real(tgt_np), dtype=rdm1.dtype,
                           device=rdm1.device)
    t_im = torch.as_tensor(np.imag(tgt_np), dtype=rdm1.dtype,
                           device=rdm1.device)
    diff = torch.sqrt((t_re - cre) ** 2 + (t_im - cim) ** 2)
    ref = (abs(complex(tgt_np.ravel()[1])) if tgt_np.size > 1
           else abs(complex(tgt_np.ravel()[0])))
    delta_inc = diff.sum() / ref if ref > 1e-6 else None
    dmat = diff[:, None, None] * F_pot
    vpot = (2.0 / nh_F) * dmat.sum(dim=0)
    vmax_inc = dmat.abs().amax(dim=(1, 2)).sum()
    return vpot, delta_inc, vmax_inc


def make_gs_vexp_device(exp: Exp, perm=None, *, dtype, device):
    """The GS Vexp update as a function (rdm1, L) -> (Vexp00, Delta, vmax)
    on `device`, for properties 'mat', 'Ek', 'v1e', 'dip' and 'F'.  L is the
    per-property weight list (Exp.L_check(L)[0]).

    Two MO transforms, as in the reference: potential matrices use
    convert_aoint (C^-1 A C^-H) -> exp.dic_int; property values are
    Tr(A_ao gamma_ao), i.e. C^T A_G C contracted with the MO rdm1.

    perm: MO permutation (new_from_old; ops/ladder.spin_sort_perm) when the
    rdm1 lives in the spin-SORTED layout: every MO-basis matrix is permuted
    once here.  Delta and vmax are permutation-invariant."""
    if perm is None:
        pmat = lambda M: np.asarray(M)
    else:
        P = np.asarray(perm)
        pmat = lambda M: np.asarray(M)[np.ix_(P, P)]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    names = list(exp.prop_names[0])
    for name in names:
        if name not in GS_PROPS:
            raise _es_not_ported(f"device GS Vexp target {name!r}")
    targets = [exp.exp_data[0][i][1] if n != "mat"
               else dev(pmat(exp.exp_data[0][i][1]))
               for i, n in enumerate(names)]
    pot_mats = {}
    for k, v in exp.dic_int.items():
        v = np.real(np.asarray(v))
        if perm is not None:
            v = v[..., P, :][..., :, P]
        pot_mats[k] = dev(v)
    hf_props = [p if (names[i] != "mat" or p is None) else dev(pmat(p))
                for i, p in enumerate(exp.HF_prop[0])]
    C = np.asarray(exp.mo_coeff)

    def _trace_mat(A_ao):
        A_g = convert.convert_r_to_g_rdm1(A_ao) * 2.0  # block-diag, no 1/2
        return dev(pmat(C.T @ A_g @ C))

    trace_mats = {}
    if exp.Ek_int is not None:
        trace_mats["Ek"] = _trace_mat(exp.Ek_int)
    if exp.v1e_int is not None:
        trace_mats["v1e"] = _trace_mat(exp.v1e_int)
    if exp.dip_int is not None:
        trace_mats["dip"] = torch.stack([_trace_mat(exp.dip_int[c])
                                         for c in range(3)])
    if exp.F_int is not None and "F" in names:
        trace_mats["F"] = (
            torch.stack([_trace_mat(np.real(fa)) for fa in exp.F_int]),
            torch.stack([_trace_mat(np.imag(fa)) for fa in exp.F_int]))
        nh_F = len(exp.h)

    def device_update(rdm1, L):
        v = torch.zeros_like(rdm1)
        delta = torch.zeros((), dtype=rdm1.dtype, device=rdm1.device)
        vmax = torch.zeros((), dtype=rdm1.dtype, device=rdm1.device)
        for i, name in enumerate(names):
            w = float(L[i])
            hf = hf_props[i]
            if name == "mat":
                tgt = targets[i]
                diff = tgt - rdm1
                v = v + w * diff
                den = (tgt.abs().sum() if hf is None
                       else (tgt - hf).abs().sum())
                delta = delta + diff.abs().sum() / den
                vmax = vmax + diff.abs().max()
            elif name in ("Ek", "v1e"):
                calc = torch.einsum("ij,ji->", trace_mats[name], rdm1)
                exp_val = float(targets[i])
                diff = (exp_val - calc).abs()
                den = abs(exp_val) if hf is None else abs(exp_val - hf)
                if abs(exp_val) > 1e-6:
                    delta = delta + diff / den
                dmat = diff * pot_mats[name]
                v = v + w * dmat
                vmax = vmax + dmat.abs().max()
            elif name == "dip":
                calc = torch.einsum("xij,ji->x", trace_mats["dip"], rdm1)
                exp_np = np.asarray(targets[i], dtype=np.float64)
                exp_val = dev(exp_np)
                diff = (exp_val - calc).abs()
                den = dev(np.abs(exp_np) if hf is None
                          else np.abs(exp_np - np.asarray(hf)))
                keep = dev(np.abs(exp_np) > 1e-6)
                delta = delta + torch.where(keep > 0, diff / den,
                                            torch.zeros_like(diff)).sum()
                dmat = diff[:, None, None] * pot_mats["dip"]
                v = v + w * dmat.sum(dim=0)
                vmax = vmax + dmat.abs().amax(dim=(1, 2)).sum()
            else:   # 'F'
                vpot, delta_inc, vmax_inc = _f_update(
                    trace_mats["F"], pot_mats["F"], nh_F, targets[i], rdm1)
                if delta_inc is not None:
                    delta = delta + delta_inc
                v = v + w * vpot
                vmax = vmax + vmax_inc
        return v, delta, vmax

    return device_update
