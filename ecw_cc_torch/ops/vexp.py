"""Experimental-constraint (Vexp) engine.

Port of ecw_cc_tpu/ops/vexp.py (reference exp_pot.py, class Exp): holds the
per-state target ("experimental") data, precomputes property integrals in
the MO G basis, and updates the Vexp[n, m] potential matrix plus the
relative deviation Delta and vmax from the current (transition) rdm1s.

Math (exp_pot.py:139-147): for state properties the potential is linear in
gamma,
    Vexp^nn = sum_i L_i * |Aexp_i - Tr(gamma^nn A_i)| * A_i      (prop case)
    Vexp^00 = sum_i L_i * (gamma_exp - gamma^00)                 ('mat' case)
and for transition properties the norm-squared form contracts both left and
right tr-rdm1s.

The host class `Exp` mirrors the reference API (Vexp_update returning
(Delta, vmax), attribute .Vexp as an (n_states, n_states) object array) in
NumPy.  `make_gs_vexp_device` and `make_es_vexp_device` build the updates
the solvers run on the device every iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ecw_cc_torch.utils import convert
from ecw_cc_torch.utils import props as uprops


class Exp:
    def __init__(self, L, exp_data, mol, mo_coeff, Ek_exp_GS=None, Ek_HF_GS=None,
                 HF_prop=False):
        """See reference exp_pot.py:13-129 for the exp_data format:
        exp_data = [[GS props], [ES1 props], ...], each prop ['name', value]
        with names mat/trmat/Ek/v1e/dip/trdip/DEk/F.  A copy of the JAX
        package's class (ecw_cc_tpu/ops/vexp.py:69-315): host NumPy."""
        self.nbr_states = len(exp_data)
        self.exp_data = exp_data
        self.mo_coeff = np.asarray(mo_coeff)
        self.mol = mol
        self.prop_calc = []
        if not HF_prop:
            self.HF_prop = [[None for _ in exp_data[n]] for n in range(len(exp_data))]
        else:
            self.HF_prop = HF_prop
        self.Ek_HF_GS = Ek_HF_GS

        self.L = self.L_check(L)
        self.charge_center = None

        # AO integrals
        self.Ek_int = None
        self.dip_int = None
        self.v1e_int = None
        self.F_int = None
        self.dic_int = {}
        self.prop_names = []

        for i, state in enumerate(exp_data):
            self.prop_names.append([])
            for prop in state:
                name = prop[0]
                if name == "F":
                    if len(prop) < 4:
                        raise SyntaxError(
                            "structure factors require ['F', F, h, rec_vec]")
                    if self.F_int is None:
                        _, self.F_int = uprops.FT_MO(
                            mol, prop[2], self.mo_coeff, prop[3])
                        # G-format MO potential matrices via the same
                        # transform convention as the other properties
                        # (the reference stores the R-format FT_MO result,
                        # which cannot broadcast against the G-format Vexp —
                        # 'F' was never runnable end-to-end there)
                        self.dic_int["F"] = np.stack([
                            convert.convert_aoint(fa, self.mo_coeff)
                            for fa in self.F_int])
                    self.h = prop[2]
                    self.rec_vec = prop[3]
                if ("dip" in name or "trdip" in name) and self.dip_int is None:
                    self.charge_center = mol.charge_center()
                    self.dip_int = mol.intor("r", origin=self.charge_center)
                    self.dic_int["dip"] = convert.convert_aoint(self.dip_int, self.mo_coeff)
                if "v1e" in name and self.v1e_int is None:
                    self.v1e_int = mol.intor("nuc")
                    self.dic_int["v1e"] = convert.convert_aoint(self.v1e_int, self.mo_coeff)
                if "Ek" in name and self.Ek_int is None:
                    self.Ek_int = mol.intor("kin")
                    self.dic_int["Ek"] = convert.convert_aoint(self.Ek_int, self.mo_coeff)
                self.prop_names[i].append(name)

        self.DEk_GS_idx = None
        for i, name in enumerate(self.prop_names[0]):
            if "DEk" in name:
                self.DEk_GS_idx = i

        self.Ek_exp_GS = Ek_exp_GS
        self.Ek_calc_GS = None
        self.Delta_Ek_GS = None
        self.Vexp = np.full((self.nbr_states, self.nbr_states), None)

    # ------------------------------------------------------------------
    def Vexp_update(self, rdm1, rdm1_add, index, L=None):
        """Update Vexp[index] from the current rdm1(s); return (Delta, vmax).
        Reference exp_pot.py:131-345."""
        n, m = index
        rdm1 = np.asarray(rdm1)
        self.Vexp[n, m] = np.zeros_like(rdm1)
        Delta = 0.0
        vmax = 0.0
        self.prop_calc = []
        L = self.L if L is None else self.L_check(L)
        st_idx = max(index)

        for i, prop in enumerate(self.prop_names[st_idx]):
            if prop == "mat":
                if index == (0, 0):
                    diff = np.subtract(self.exp_data[0][i][1], rdm1)
                    self.Vexp[0, 0] += L[st_idx][i] * diff
                    Delta += self.Delta(0, i, diff)
                    vmax += np.max(np.abs(diff))
                    if self.Ek_exp_GS is not None:
                        self.Ek_calc_GS = uprops.Ekin(
                            self.mol, rdm1, aobasis=False, mo_coeff=self.mo_coeff,
                            ek_int=self.Ek_int, g=True)
                        denom = (np.abs(self.Ek_exp_GS) if self.Ek_HF_GS is None
                                 else np.abs(self.Ek_exp_GS - self.Ek_HF_GS))
                        self.Delta_Ek_GS = np.abs(self.Ek_exp_GS - self.Ek_calc_GS) / denom
                elif n == m:
                    diff = np.subtract(self.exp_data[n][i][1], rdm1)
                    self.Vexp[n, n] += L[st_idx][i] * diff
                    Delta += self.Delta(n, i, diff)
                    vmax += np.max(np.abs(diff))

            if prop == "trmat" and n != m:
                if n == 0:  # left
                    diff = np.subtract(self.exp_data[st_idx][i][1][0], rdm1)
                elif m == 0:  # right
                    diff = np.subtract(self.exp_data[st_idx][i][1][1], rdm1)
                else:
                    raise ValueError("only GS<->ES transition properties supported")
                self.Vexp[n, m] += L[st_idx][i] * diff
                avg = (np.sum(np.abs(self.exp_data[st_idx][i][1][1]))
                       + np.sum(np.abs(self.exp_data[st_idx][i][1][0])))
                Delta += np.sum(np.abs(diff)) / (avg / 2.0)
                vmax += np.max(np.abs(diff))

            if prop in ("Ek", "v1e") and n == m:
                calc = self.calc_prop(prop, rdm1)
                diff = np.abs(self.exp_data[st_idx][i][1] - calc)
                Delta += self.Delta(n, i, diff)
                dmat = diff * self.dic_int[prop]
                self.Vexp[n, n] += L[st_idx][i] * dmat
                vmax += np.max(np.abs(dmat))
                self.prop_calc.append([prop, calc])

            if "DEk" in prop and n == m and n != 0:
                diff_rdm1 = np.subtract(rdm1_add, rdm1)
                calc = self.calc_prop("Ek", diff_rdm1)
                diff = np.abs(self.exp_data[st_idx][i][1] - calc)
                Delta += self.Delta(st_idx, i, diff)
                dmat = diff * self.dic_int["Ek"]
                if self.Vexp[0, 0] is None:
                    self.Vexp[0, 0] = 0.0
                if self.DEk_GS_idx is not None:
                    self.Vexp[0, 0] += L[0][self.DEk_GS_idx] * dmat
                else:
                    self.Vexp[0, 0] += L[st_idx][i] * dmat
                vmax += np.max(np.abs(dmat))
                self.prop_calc.append([prop, calc])

            if prop == "dip" and n == m:
                calc = self.calc_prop("dip", rdm1)
                exp = self.exp_data[st_idx][i][1]
                for j, (d_calc, d_exp) in enumerate(zip(calc, exp)):
                    diff = np.abs(d_exp - d_calc)
                    Delta += self.Delta(st_idx, i, diff, comp_idx=j)
                    dmat = diff * self.dic_int["dip"][j]
                    self.Vexp[n, m] += L[st_idx][i] * dmat
                    vmax += np.max(np.abs(dmat))
                self.prop_calc.append([prop, calc])

            if prop == "trdip" and n != m:
                calc, A_scale = self.calc_prop("dip", rdm1, rdm1_add=rdm1_add)
                exp = self.exp_data[st_idx][i][1]
                for j, (d_calc, d_exp, A) in enumerate(zip(calc, exp, A_scale)):
                    diff = np.abs(d_exp - d_calc)
                    Delta += self.Delta(st_idx, i, diff, comp_idx=j)
                    dmat = diff * self.dic_int["dip"][j] * A
                    self.Vexp[n, m] += L[st_idx][i] * dmat
                    vmax += np.max(np.abs(dmat))
                self.prop_calc.append([prop, calc])

            if prop == "F" and n == m:
                calc = uprops.structure_factor(
                    self.mol, self.h, rdm1, aobasis=False, mo_coeff=self.mo_coeff,
                    F_int=self.F_int, rec_vec=self.rec_vec)
                exp = self.exp_data[st_idx][i][1]
                for F_exp, F_calc, F_int_mo in zip(exp, calc, self.dic_int["F"]):
                    diff = np.abs(F_exp - F_calc)
                    Delta += self.Delta(st_idx, i, diff)
                    dmat = np.real(diff * F_int_mo)
                    self.Vexp[n, n] += L[st_idx][i] * (2.0 / len(self.h)) * dmat
                    vmax += np.max(np.abs(dmat))
                self.prop_calc.append([prop, calc])

        return Delta, vmax

    # ------------------------------------------------------------------
    def calc_prop(self, prop, rdm1, g_format=True, rdm1_add=None):
        """Reference exp_pot.py:347-390."""
        if prop == "Ek":
            f = lambda dm, cint: uprops.Ekin(self.mol, dm, g=g_format, aobasis=False,
                                             mo_coeff=self.mo_coeff, ek_int=cint)
            ints = self.Ek_int
        elif prop == "v1e":
            f = lambda dm, cint: uprops.v1e(self.mol, dm, g=g_format, aobasis=False,
                                            mo_coeff=self.mo_coeff, v1e_int=cint)
            ints = self.v1e_int
        elif prop == "dip":
            a1 = uprops.dipole(self.mol, rdm1, g=g_format, aobasis=False,
                               mo_coeff=self.mo_coeff, dip_int=self.dip_int)
            if rdm1_add is not None:
                a2 = uprops.dipole(self.mol, np.asarray(rdm1_add).T, g=g_format,
                                   aobasis=False, mo_coeff=self.mo_coeff,
                                   dip_int=np.conj(self.dip_int))
                return list(a1 * a2), list(a2)
            return list(a1)
        else:
            raise NotImplementedError("possible properties are Ek, v1e and dip")
        a1 = f(rdm1, ints)
        if rdm1_add is not None:
            a2 = f(np.asarray(rdm1_add).T, np.conj(ints))
            return a1 * a2, a2
        return a1

    def Delta(self, n_st, i_prop, prop_diff, comp_idx=1, threshold=1e-6):
        """Relative deviation; reference exp_pot.py:392-448."""
        exp_val = self.exp_data[n_st][i_prop][1]
        hf = self.HF_prop[n_st][i_prop] if n_st < len(self.HF_prop) else None
        if isinstance(prop_diff, np.ndarray) and n_st == 0:
            if hf is None:
                return np.sum(np.abs(prop_diff)) / np.sum(np.abs(exp_val))
            return np.sum(np.abs(prop_diff)) / np.sum(np.abs(exp_val - hf))
        if isinstance(exp_val, (list, tuple, np.ndarray)) and not np.isscalar(exp_val):
            ref = exp_val[comp_idx]
            if abs(ref) > threshold:
                if hf is None:
                    return prop_diff / np.abs(ref)
                return prop_diff / np.abs(ref - hf[comp_idx])
            return 0.0
        if isinstance(exp_val, (float, np.floating)) and abs(exp_val) > threshold:
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
                    "constraint-weight length must equal the number of states "
                    "(did you forget L_loop=True?)")
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


def _f_target(tgt_np, dtype, device):
    """A structure-factor target as _f_update takes it, uploaded once:
    (Re, Im on the device, the host normalization |exp[1]| (|exp[0]| for
    a single component))."""
    tgt_np = np.asarray(tgt_np)
    t_re = torch.as_tensor(np.real(tgt_np), dtype=dtype, device=device)
    t_im = torch.as_tensor(np.imag(tgt_np), dtype=dtype, device=device)
    ref = (abs(complex(tgt_np.ravel()[1])) if tgt_np.size > 1
           else abs(complex(tgt_np.ravel()[0])))
    return t_re, t_im, ref


def _f_update(trace_F, F_pot, nh_F, tgt, rdm1):
    """Structure-factor body of the device GS and ES updates (one state):
    |F| deviation per
    reciprocal vector, potential = deviation-weighted real MO FT integrals
    scaled 2/nh.  tgt: the target as _f_target gives it.  Returns (vpot,
    delta_inc or None, vmax_inc); delta_inc is None when the normalization
    reference is below threshold (host Delta() quirk: every component is
    normalized by |exp[1]|)."""
    Fre, Fim = trace_F
    cre = torch.einsum("hij,ji->h", Fre, rdm1)
    cim = torch.einsum("hij,ji->h", Fim, rdm1)
    t_re, t_im, ref = tgt
    diff = torch.sqrt((t_re - cre) ** 2 + (t_im - cim) ** 2)
    delta_inc = diff.sum() / ref if ref > 1e-6 else None
    dmat = diff[:, None, None] * F_pot
    vpot = (2.0 / nh_F) * dmat.sum(dim=0)
    vmax_inc = dmat.abs().amax(dim=(1, 2)).sum()
    return vpot, delta_inc, vmax_inc


def make_gs_vexp_device(exp: Exp, perm=None, *, dtype, device):
    """The GS Vexp update as a function (rdm1, L) -> (Vexp00, Delta, vmax)
    on `device`, for properties 'mat', 'Ek', 'v1e', 'dip' and 'F'.  L is the
    per-property weight list (Exp.L_check(L)[0]), or a tensor of them on
    `device` (one lambda lane of the batched sweep, under torch.func.vmap):
    the update reads no value back to the host.

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
        if name not in ("mat", "Ek", "v1e", "dip", "F"):
            raise NotImplementedError(
                f"device GS Vexp does not support {name!r}; use the host "
                "path")
    targets = [exp.exp_data[0][i][1] if n != "mat"
               else dev(pmat(exp.exp_data[0][i][1]))
               for i, n in enumerate(names)]
    # the device constants of the 'dip' and 'F' targets, uploaded once:
    # the update makes no tensor from host data
    consts = {}
    for i, n in enumerate(names):
        if n == "dip":
            exp_np = np.asarray(targets[i], dtype=np.float64)
            hf = exp.HF_prop[0][i]
            consts[i] = (dev(exp_np),
                         dev(np.abs(exp_np) if hf is None
                             else np.abs(exp_np - np.asarray(hf))),
                         dev(np.abs(exp_np) > 1e-6))
        elif n == "F":
            consts[i] = _f_target(targets[i], dtype, device)
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
            w = L[i]
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
                exp_val, den, keep = consts[i]
                diff = (exp_val - calc).abs()
                delta = delta + torch.where(keep > 0, diff / den,
                                            torch.zeros_like(diff)).sum()
                dmat = diff[:, None, None] * pot_mats["dip"]
                v = v + w * dmat.sum(dim=0)
                vmax = vmax + dmat.abs().amax(dim=(1, 2)).sum()
            else:   # 'F'
                vpot, delta_inc, vmax_inc = _f_update(
                    trace_mats["F"], pot_mats["F"], nh_F, consts[i], rdm1)
                if delta_inc is not None:
                    delta = delta + delta_inc
                v = v + w * vpot
                vmax = vmax + vmax_inc
        return v, delta, vmax

    return device_update


def make_es_vexp_device(exp: Exp, *, dtype, device):
    """The multi-state Vexp update as a function on `device`

        (rdm1_gs, rdm1_es, tr_r, tr_l, Lflat) ->
            (V00, Vnn, V0n, Vn0, Delta)

    where rdm1_es/tr_r/tr_l are stacked (n_es, dim, dim), Vnn/V0n/Vn0 are
    stacked potentials and Delta is the (n_states, n_states) deviation
    matrix.  Supports mat/Ek/v1e/dip/F for the GS and
    mat/Ek/v1e/dip/DEk/trdip/trmat/F for excited states (reference
    exp_pot.py:131-345 and Solver_ES.py:274-296).  Lflat is the flattened
    per-state per-property weight list: host numbers, or a tensor of them
    on `device` (a kept loop's weights, refilled per solve).

    Every target is uploaded here, once; the update itself reads nothing
    from the host and nothing back.  The loop over the states is over their
    property lists, which differ from state to state."""
    n_states = exp.nbr_states
    n_es = n_states - 1
    names = [list(p) for p in exp.prop_names]
    offs = []
    k = 0
    for st in names:
        offs.append(k)
        k += len(st)
    gs_update = (make_gs_vexp_device(exp, dtype=dtype, device=device)
                 if names[0] else None)

    def dev(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    pot_mats = {kk: dev(np.real(vv)) for kk, vv in exp.dic_int.items()}
    C = np.asarray(exp.mo_coeff)

    def _trace_mat(A_ao):
        A_g = convert.convert_r_to_g_rdm1(A_ao) * 2.0
        return dev(C.T @ A_g @ C)

    trace_mats = {}
    if exp.Ek_int is not None:
        trace_mats["Ek"] = _trace_mat(exp.Ek_int)
    if exp.v1e_int is not None:
        trace_mats["v1e"] = _trace_mat(exp.v1e_int)
    if exp.dip_int is not None:
        trace_mats["dip"] = torch.stack([_trace_mat(exp.dip_int[c])
                                         for c in range(3)])
    nh_F = None
    if exp.F_int is not None and any("F" in st for st in names):
        trace_mats["F"] = (
            torch.stack([_trace_mat(np.real(fa)) for fa in exp.F_int]),
            torch.stack([_trace_mat(np.imag(fa)) for fa in exp.F_int]))
        nh_F = len(exp.h)
    DEk_GS_idx = exp.DEk_GS_idx

    def relative(exp_np):
        """(target, 1/|target| where |target| > 1e-6 else 0) on the device:
        the relative deviation is diff * the second."""
        exp_np = np.asarray(exp_np, dtype=np.float64)
        keep = np.abs(exp_np) > 1e-6
        inv = np.where(keep, 1.0 / np.where(keep, np.abs(exp_np), 1.0), 0.0)
        return dev(exp_np), dev(inv)

    # per-state, per-property targets, uploaded once
    targets = {}
    for n in range(1, n_states):
        for i, name in enumerate(names[n]):
            val = exp.exp_data[n][i][1]
            if name == "mat":
                tgt = dev(val)
                targets[n, i] = (tgt, tgt.abs().sum())
            elif name == "trmat":
                tgtL, tgtR = dev(val[0]), dev(val[1])
                targets[n, i] = (tgtL, tgtR,
                                 0.5 * (tgtR.abs().sum() + tgtL.abs().sum()))
            elif name in ("Ek", "v1e", "dip", "DEk", "trdip"):
                targets[n, i] = relative(val)
            elif name == "F":
                targets[n, i] = _f_target(val, dtype, device)
            else:
                raise NotImplementedError(
                    f"device ES Vexp does not support {name!r}")

    def update(rdm1_gs, rdm1_es, tr_r, tr_l, Lflat):
        dim = rdm1_gs.shape[0]
        zero = torch.zeros((), dtype=dtype, device=device)
        zmat = torch.zeros((dim, dim), dtype=dtype, device=device)
        Delta = {}
        V00 = zmat
        Vnn = [zmat] * n_es
        V0n = [zmat] * n_es
        Vn0 = [zmat] * n_es

        def add_delta(i, j, d):
            Delta[i, j] = Delta.get((i, j), zero) + d

        if gs_update is not None:
            Lgs = Lflat[offs[0]: offs[0] + len(names[0])]
            v, d, _ = gs_update(rdm1_gs, Lgs)
            V00 = V00 + v
            Delta[0, 0] = d

        for n in range(1, n_states):
            e = n - 1
            for i, name in enumerate(names[n]):
                w = Lflat[offs[n] + i]
                if name == "mat":
                    tgt, den = targets[n, i]
                    diff = tgt - rdm1_es[e]
                    Vnn[e] = Vnn[e] + w * diff
                    add_delta(n, n, diff.abs().sum() / den)
                elif name == "trmat":
                    tgtL, tgtR, avg = targets[n, i]
                    # right (n,0) built from tr_r; left (0,n) from tr_l
                    diffR = tgtR - tr_r[e]
                    diffL = tgtL - tr_l[e]
                    Vn0[e] = Vn0[e] + w * diffR
                    V0n[e] = V0n[e] + w * diffL
                    add_delta(n, 0, diffR.abs().sum() / avg)
                    add_delta(0, n, diffL.abs().sum() / avg)
                elif name in ("Ek", "v1e"):
                    exp_val, inv = targets[n, i]
                    calc = torch.einsum("ij,ji->", trace_mats[name],
                                        rdm1_es[e])
                    diff = (exp_val - calc).abs()
                    add_delta(n, n, diff * inv)
                    Vnn[e] = Vnn[e] + (w * diff) * pot_mats[name]
                elif name == "dip":
                    exp_val, inv = targets[n, i]
                    calc = torch.einsum("xij,ji->x", trace_mats["dip"],
                                        rdm1_es[e])
                    diff = (exp_val - calc).abs()
                    add_delta(n, n, (diff * inv).sum())
                    Vnn[e] = Vnn[e] + w * torch.einsum(
                        "x,xij->ij", diff, pot_mats["dip"])
                elif name == "DEk":
                    # Ek difference fed back into V00 (exp_pot.py:256-282)
                    exp_val, inv = targets[n, i]
                    calc = torch.einsum("ij,ji->", trace_mats["Ek"],
                                        rdm1_gs - rdm1_es[e])
                    diff = (exp_val - calc).abs()
                    add_delta(n, n, diff * inv)
                    wgs = (Lflat[offs[0] + DEk_GS_idx]
                           if DEk_GS_idx is not None else w)
                    V00 = V00 + (wgs * diff) * pot_mats["Ek"]
                elif name == "trdip":
                    exp_val, inv = targets[n, i]
                    A_tr, A_pot = trace_mats["dip"], pot_mats["dip"]
                    # right update (n,0): rdm1 = tr_r, rdm1_add = tr_l; the
                    # left one (0,n) the other way round
                    for right, main, add in ((True, tr_r[e], tr_l[e]),
                                             (False, tr_l[e], tr_r[e])):
                        a1 = torch.einsum("xij,ji->x", A_tr, main)
                        a2 = torch.einsum("xij,ij->x", A_tr, add)
                        diff = (exp_val - a1 * a2).abs()
                        dmat = torch.einsum("x,xij->ij", diff * a2, A_pot)
                        if right:
                            Vn0[e] = Vn0[e] + w * dmat
                            add_delta(n, 0, (diff * inv).sum())
                        else:
                            V0n[e] = V0n[e] + w * dmat
                            add_delta(0, n, (diff * inv).sum())
                else:   # 'F': state structure factor (_f_update)
                    vpot, delta_inc, _ = _f_update(
                        trace_mats["F"], pot_mats["F"], nh_F,
                        targets[n, i], rdm1_es[e])
                    if delta_inc is not None:
                        add_delta(n, n, delta_inc)
                    Vnn[e] = Vnn[e] + w * vpot

        Delta = torch.stack([Delta.get((i, j), zero)
                             for i in range(n_states)
                             for j in range(n_states)]
                            ).reshape(n_states, n_states)
        stack = lambda vs: (torch.stack(vs) if vs else
                            torch.zeros((0, dim, dim), dtype=dtype,
                                        device=device))
        return V00, stack(Vnn), stack(V0n), stack(Vn0), Delta

    return update
