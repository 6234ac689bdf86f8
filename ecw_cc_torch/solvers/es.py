"""Excited-state ECW-CCS solver: coupled T, Lambda, R/L/r0/l0 equations
(port of ecw_cc_tpu/solvers/es.py; reference Solver_ES.py, class Solver_ES
:26-496).

Per iteration, all state and transition rdm1s are built, the Vexp[n,m]
matrix is refreshed, the GS t/lambda amplitudes are updated with the
ES-coupling terms, and each excited state's (r, r0, l, l0) is updated with
its energy extracted from the largest amplitude; spin and orthonormality
are monitored.  DIIS modes 'GS' | 'ES' | 'all' mirror Solver_ES.py:320-411.

Three routes, as in the JAX package:

  - `Solver_ES.SCF`: the host-orchestrated loop.  The amplitudes and the
    equations are on the solver's device, the Vexp class and the DIIS are
    host NumPy, so every iteration crosses to the host once per state.
  - `Solver_ES.SCF_diag`: at each macro-iteration the R1 / L1 maps are
    diagonalized in the singles space instead of the power-iteration
    update: exactly (NumPy on the host), or with `davidson=True` by the
    device Davidson of utils/linalg.py.
  - `SolverES_Device.SCF`: the whole iteration on the device.  The JAX
    package compiles it as one lax.while_loop with jax.vmap over the
    excited states; here it is a solvers/device_loop.Loop whose state
    stays on the device and whose per-state work carries a leading state
    axis through the einsums of ops/ccs.py.  On the card the iteration is
    captured once as a CUDA graph and replayed; each iteration reads back
    ONE flag, whether the loop goes on.  The positions of the extracted
    amplitudes are found (argmax), read (gather) and written (scatter)
    with index tensors, the histories are written at the iteration's
    tensor index, and the DIIS ring of ops/diis.py stays on the device.
    The loop is kept across the lambdas of a sweep (one per kind of
    start), the weights and pinned positions device tensors it reads.

The solvers take the ERIs in the reference (alternating) MO layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ecw_cc_torch.models.eris import warn_if_sorted_layout
from ecw_cc_torch.models.scf import HostDIIS
from ecw_cc_torch.ops import ccs as ccs_ops
from ecw_cc_torch.ops import diis as diis_ops
from ecw_cc_torch.solvers import device_loop
from ecw_cc_torch.solvers.gs import (CONVERGED, DIVERGED, MAXITER, RUNNING,
                                     _conv_text, _record_metrics)
from ecw_cc_torch.utils import linalg as ulinalg

format_float = "{:.4e}"

try:
    from tabulate import tabulate
except ImportError:  # pragma: no cover
    tabulate = None


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def amp_from_numpy(dic, device, dtype):
    """An amplitude dictionary {ts, ls, rn, ln, r0n, l0n} of arrays (NumPy,
    JAX or torch; rn/ln lists or stacks, r0n/l0n lists of numbers) as
    tensors on `device`: ts, ls (nocc, nvir); rn, ln stacked (n_es, nocc,
    nvir); r0n, l0n (n_es,).  This is how a solve of the JAX package
    warm-starts one of the port."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                            device=device)

    def stack(xs):
        if isinstance(xs, (list, tuple)):
            return torch.stack([one(x) for x in xs])
        return one(xs)

    return {"ts": one(dic["ts"]), "ls": one(dic["ls"]),
            "rn": stack(dic["rn"]), "ln": stack(dic["ln"]),
            "r0n": stack(list(dic["r0n"])).reshape(-1),
            "l0n": stack(list(dic["l0n"])).reshape(-1)}


def amp_to_numpy(dic):
    """The public form of an amplitude dictionary: NumPy arrays, rn/ln as
    lists of (nocc, nvir) arrays, r0n/l0n as lists of floats; what the
    solvers return and what either package takes as `dic_amp_ini`."""
    return {"ts": _np(dic["ts"]), "ls": _np(dic["ls"]),
            "rn": [_np(x) for x in dic["rn"]],
            "ln": [_np(x) for x in dic["ln"]],
            "r0n": [float(x) for x in dic["r0n"]],
            "l0n": [float(x) for x in dic["l0n"]]}


class Solver_ES:
    """Reference API: Solver_ES.Solver_ES.  mycc: ops.ccs.Gccs over torch
    ERIs in the alternating layout; the device and dtype of the solve are
    those of mycc.eris."""

    def __init__(self, mycc, Vexp, rn_ini=None, tsini=None, lsini=None,
                 val_core=None, rini_koop_idx=None, conv_var="tl",
                 conv_thres=1e-6, diis="", maxiter=40, maxdiis=20, mindiis=2,
                 tablefmt="rst"):
        self.mycc = mycc
        self.Vexp_class = Vexp
        self.nbr_states = Vexp.nbr_states
        self.tablefmt = tablefmt
        # the ES equations take the reference (alternating) MO layout; a
        # spin-sorted handle would scramble them silently
        warn_if_sorted_layout(mycc.eris, "Solver_ES")
        self.nocc = mycc.nocc
        self.nvir = mycc.nvir
        self.dim = self.nocc + self.nvir
        self.EHF = getattr(mycc.eris, "EHF", None)
        fock = mycc.eris.fock
        self.device, self.dtype = fock.device, fock.dtype

        self.tsini = (np.zeros((self.nocc, self.nvir)) if tsini is None
                      else _np(tsini))
        self.lsini = (np.zeros((self.nocc, self.nvir)) if lsini is None
                      else _np(lsini))

        fock_diag = np.diag(_np(mycc.fock)).astype(np.float64)
        if rn_ini is None:
            if val_core is None:
                val_core = [self.nbr_states - 1, 0]
            self.rn_ini, de = ulinalg.koopman_init_guess(
                fock_diag, self._mo_occ(), val_core, koop_idx=rini_koop_idx)
        else:
            if len(rn_ini) != self.nbr_states - 1:
                raise ValueError("number of initial r vectors inconsistent "
                                 "with the experimental data")
            self.rn_ini = [_np(r) for r in rn_ini]
            de = [ulinalg.get_DE(fock_diag, r) for r in self.rn_ini]

        self.ln_ini = [r.copy() for r in self.rn_ini]
        # r0 of the guesses: zero t, zero Fock shift, on the solver's device
        # and dtype; read to the host once, here
        with torch.no_grad():
            zero_t = self._t(np.zeros((self.nocc, self.nvir)))
            zero_f = self._t(np.zeros((self.dim, self.dim)))
            self.r0_ini = [float(ccs_ops.r0_fromE(mycc.eris, float(d), zero_t,
                                                  self._t(r), zero_f))
                           for r, d in zip(self.rn_ini, de)]
        self.l0_ini = [x for x in self.r0_ini]
        self.E_ini = -np.asarray(de)
        print(" Initial Koopman energies in eV: ", -self.E_ini * 27.2114)

        self.diis = diis
        self.maxdiis = maxdiis
        self.mindiis = mindiis
        self.maxiter = maxiter
        self.conv_thres = conv_thres
        if conv_var not in ("Ep", "rl", "tl", "all"):
            raise ValueError("accepted convergence parameter is Ep, tl, rl or all")
        self.conv_var = conv_var

    def _t(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=self.dtype)
        return torch.tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                            device=self.device)

    def _mo_occ(self):
        occ = np.zeros(self.dim)
        occ[: self.nocc] = 1.0
        return occ

    def _ini_amp(self):
        return {"ts": self.tsini, "ls": self.lsini, "rn": self.rn_ini,
                "ln": self.ln_ini, "r0n": self.r0_ini, "l0n": self.l0_ini}

    def _vmat(self, v):
        """An entry of the host Vexp matrix as a device tensor, None where
        the entry is unset."""
        if v is None or np.isscalar(v):
            return None
        return self._t(np.asarray(v, dtype=float))

    def _stack_v(self, col):
        """Entries of the host Vexp matrix stacked over the states, zeros
        where an entry is unset."""
        return self._t(np.stack([
            np.zeros((self.dim, self.dim)) if (v is None or np.isscalar(v))
            else np.asarray(v, dtype=float) for v in col]))

    # -- convergence checks (reference Solver_ES.py:119-140) --------------
    def _conv(self, dic):
        if self.conv_var == "Ep":
            return np.asarray(dic["Ep"]).copy()
        if self.conv_var == "tl":
            return np.asarray(dic["ts"]) + np.asarray(dic["ls"])
        if self.conv_var == "rl":
            ans = np.zeros_like(np.asarray(dic["rn"][0]))
            for r, l in zip(dic["rn"], dic["ln"]):
                ans = ans + np.asarray(r) + np.asarray(l)
            return ans
        ans = np.asarray(dic["ts"]) + np.asarray(dic["ls"])
        for r, l in zip(dic["rn"], dic["ln"]):
            ans = ans + np.asarray(r) + np.asarray(l)
        return ans

    # ------------------------------------------------------------------
    @torch.no_grad()
    def SCF(self, L=None, dic_amp_ini=None, diis=None, force_alpha=True,
            print_ite=True, use_diag=False):
        """Coupled multi-state SCF (reference Solver_ES.py:146-496)."""
        Vexp_class = self.Vexp_class
        nbr_states = self.nbr_states
        eris = self.mycc.eris
        nocc, nvir = self.nocc, self.nvir
        T = self._t

        if L is None:
            L = Vexp_class.L
        else:
            L = Vexp_class.L_check(L)

        if dic_amp_ini is None:
            amp = amp_from_numpy(self._ini_amp(), self.device, self.dtype)
            # dominant (i,a) of each initial r: argmax of |r| (Koopman unit
            # guesses hit exactly 1; a generated r_ini has no exact-1.0
            # entry)
            ov = []
            for r in self.rn_ini:
                r = np.asarray(r)
                if r.size and np.max(np.abs(r)) > 0:
                    ov.append(tuple(
                        int(x) for x in
                        np.unravel_index(np.argmax(np.abs(r)), r.shape)))
                else:
                    ov.append(None)
        else:
            amp = amp_from_numpy(dic_amp_ini, self.device, self.dtype)
            ov = [None] * (nbr_states - 1)
        ts, ls = amp["ts"], amp["ls"]
        rn, ln = list(amp["rn"]), list(amp["ln"])
        r0n = [float(x) for x in amp["r0n"]]
        l0n = [float(x) for x in amp["l0n"]]

        dic_amp = amp_to_numpy({"ts": ts, "ls": ls, "rn": rn, "ln": ln,
                                "r0n": r0n, "l0n": l0n})
        rnew = [None] * (nbr_states - 1)
        lnew = [None] * (nbr_states - 1)
        r0new = [None] * (nbr_states - 1)
        l0new = [None] * (nbr_states - 1)
        fsp = [None] * nbr_states
        rdm1 = [None] * nbr_states
        tr_rdm1 = [None] * (nbr_states - 1)
        Spin = np.zeros(nbr_states - 1)
        diis = self.diis if diis is None else diis

        Delta = np.zeros((nbr_states, nbr_states))
        Ep = np.zeros((nbr_states, 2))
        conv = 0.0
        Dconv = 1.0
        ite = 0
        Delta_ite, Ep_ite, conv_ite = [], [], []
        amp_diis = (HostDIIS(space=self.maxdiis, min_space=self.mindiis)
                    if diis else None)

        table, headers = [], []
        if print_ite:
            headers = ["ite", "Dconv " + str(self.conv_var)]
            for i in range(nbr_states - 1):
                cols = [f"ES {i + 1}", "norm", "Delta_r", "Delta_l", "2S+1",
                        "r0", "l0", "Er", "El"]
                if i > 0:
                    cols.append("Ortho wrt ES 1")
                headers.extend(cols)

        fock = eris.fock
        C_norm = np.eye(nbr_states - 1)
        Conv_text = ""

        while Dconv > self.conv_thres:
            conv_old = conv

            # all rdm1 / tr_rdm1 (reference :254-268), to the host Vexp
            rdm1[0] = _np(ccs_ops.gamma_CCS(ts, ls))
            for n in range(1, nbr_states):
                rdm1[n] = _np(ccs_ops.gamma_es_CCS(ts, ln[n - 1], rn[n - 1],
                                                   r0n[n - 1], l0n[n - 1]))
                tr_r = ccs_ops.gamma_tr_CCS(ts, ln[n - 1],
                                            torch.zeros_like(ts), 1.0,
                                            l0n[n - 1])
                tr_l = ccs_ops.gamma_tr_CCS(ts, ls, rn[n - 1], r0n[n - 1],
                                            1.0)
                tr_rdm1[n - 1] = [_np(tr_r), _np(tr_l)]

            # Vexp updates (reference :274-296).  Vexp[0,0] is reset every
            # macro-iteration: the reference resets it inside the (0,0)
            # Vexp_update, which is skipped when the GS has no target data;
            # the ES DEk contribution would then accumulate unboundedly.
            Vexp_class.Vexp[0, 0] = np.zeros((self.dim, self.dim))
            if Vexp_class.exp_data[0]:
                Delta[0, 0], _ = Vexp_class.Vexp_update(
                    rdm1[0], tr_rdm1, (0, 0), L=L)
            for n in range(1, nbr_states):
                if Vexp_class.exp_data[n]:
                    names = Vexp_class.prop_names[n]
                    if "trdip" in names or "trmat" in names:
                        Delta[n, 0], _ = Vexp_class.Vexp_update(
                            tr_rdm1[n - 1][0], tr_rdm1[n - 1][1], (n, 0), L=L)
                        Delta[0, n], _ = Vexp_class.Vexp_update(
                            tr_rdm1[n - 1][1], tr_rdm1[n - 1][0], (0, n), L=L)
                    else:
                        Delta[n, n], _ = Vexp_class.Vexp_update(
                            rdm1[n], rdm1[0], (n, n), L=L)
                        fsp[n] = fock - T(Vexp_class.Vexp[n, n])
                if fsp[n] is None:
                    fsp[n] = fock
            if Vexp_class.Vexp[0, 0] is not None:
                fsp[0] = fock - T(np.asarray(Vexp_class.Vexp[0, 0],
                                             dtype=float))
            else:
                fsp[0] = fock
            Delta_ite.append(Delta.copy())

            # t update with ES coupling (reference :301-305)
            v0n = self._stack_v([Vexp_class.Vexp[0, n]
                                 for n in range(1, nbr_states)])
            T1i = ccs_ops.T1inter(eris, ts, fsp[0])
            ts = ccs_ops.tsupdate(eris, ts, T1i, rsn=torch.stack(rn),
                                  r0n=T(r0n), vn=v0n)

            # lambda update with ES coupling (reference :309-314)
            vn0 = self._stack_v([Vexp_class.Vexp[n, 0]
                                 for n in range(1, nbr_states)])
            L1i = ccs_ops.L1inter(eris, ts, fsp[0])
            ls = ccs_ops.lsupdate(eris, ts, ls, L1i, rsn=torch.stack(rn),
                                  lsn=torch.stack(ln), r0n=T(r0n),
                                  l0n=T(l0n), vn=vn0)

            if diis == "GS":
                vec = np.concatenate([np.ravel(_np(ls)), np.ravel(_np(ts))])
                lsv, tsv = np.split(amp_diis.update(vec), 2)
                ls = T(lsv.reshape(nocc, nvir))
                ts = T(tsv.reshape(nocc, nvir))

            # per-state R/L updates (reference :332-373)
            for n in range(1, nbr_states):
                vexp = self._vmat(Vexp_class.Vexp[0, n])
                Rinter = ccs_ops.R1inter(eris, ts, fsp[n], vexp)
                En_r, o, v = ccs_ops.Extract_Em_r(eris, rn[n - 1], r0n[n - 1],
                                                  Rinter, ov=ov[n - 1])
                En_r = float(En_r)
                o, v = int(o), int(v)
                rnew[n - 1] = ccs_ops.rsupdate(eris, rn[n - 1], r0n[n - 1],
                                               Rinter, En_r,
                                               force_alpha=force_alpha)
                rov = ccs_ops.get_ov(ln[n - 1], l0n[n - 1], rn[n - 1],
                                     r0n[n - 1], (o, v))
                rnew[n - 1][o, v] = float(rov)
                r0new[n - 1] = float(ccs_ops.r0_fromE(eris, En_r, ts,
                                                      rn[n - 1], vexp,
                                                      fsp=fsp[n]))

                vexp_l = self._vmat(Vexp_class.Vexp[n, 0])
                Linter = ccs_ops.es_L1inter(eris, ts, fsp[n], vexp_l)
                En_l, o, v = ccs_ops.Extract_Em_l(eris, ln[n - 1], l0n[n - 1],
                                                  Linter, ov=ov[n - 1])
                En_l = float(En_l)
                o, v = int(o), int(v)
                lnew[n - 1] = ccs_ops.es_lsupdate(eris, ln[n - 1], l0n[n - 1],
                                                  En_l, Linter,
                                                  force_alpha=force_alpha)
                lov = ccs_ops.get_ov(rn[n - 1], r0n[n - 1], ln[n - 1],
                                     l0n[n - 1], (o, v))
                lnew[n - 1][o, v] = float(lov)
                l0new[n - 1] = float(ccs_ops.l0_fromE(eris, En_l, ts,
                                                      ln[n - 1], vexp_l,
                                                      fsp=fsp[n]))
                Ep[n, 0] = En_r
                Ep[n, 1] = En_l

            # DIIS over ES or all amplitudes (reference :376-411)
            if diis == "ES":
                vec = np.concatenate(
                    [np.ravel(_np(rnew[0])), np.ravel(_np(lnew[0])),
                     np.atleast_1d(r0new[0]), np.atleast_1d(l0new[0])])
                vec = amp_diis.update(vec)
                nov = nocc * nvir
                rnew[0] = T(vec[:nov].reshape(nocc, nvir))
                lnew[0] = T(vec[nov:2 * nov].reshape(nocc, nvir))
                r0new[0] = float(vec[-2])
                l0new[0] = float(vec[-1])
            elif diis == "all":
                nES = len(r0new)
                vec = np.concatenate(
                    [np.ravel(_np(ts)), np.ravel(_np(ls))]
                    + [np.ravel(_np(r)) for r in rnew]
                    + [np.ravel(_np(l)) for l in lnew]
                    + [np.atleast_1d(x) for x in r0new]
                    + [np.atleast_1d(x) for x in l0new])
                vec = amp_diis.update(vec)
                nov = nocc * nvir
                ts = T(vec[:nov].reshape(nocc, nvir))
                ls = T(vec[nov:2 * nov].reshape(nocc, nvir))
                for i in range(nES):
                    rnew[i] = T(
                        vec[(2 + i) * nov:(3 + i) * nov].reshape(nocc, nvir))
                    lnew[i] = T(
                        vec[(2 + nES + i) * nov:(3 + nES + i) * nov
                            ].reshape(nocc, nvir))
                    r0new[i] = float(vec[-2 * nES + i])
                    l0new[i] = float(vec[-nES + i])

            rn = [x for x in rnew]
            ln = [x for x in lnew]
            r0n = list(r0new)
            l0n = list(l0new)
            dic_amp = amp_to_numpy({"ts": ts, "ls": ls, "rn": rn, "ln": ln,
                                    "r0n": r0n, "l0n": l0n})

            # orthonormality / spin diagnostics (reference :419-421)
            C_norm = ulinalg.check_ortho(dic_amp["ln"], dic_amp["rn"],
                                         l0new, r0new)
            for i in range(nbr_states - 1):
                Spin[i] = ulinalg.check_spin(dic_amp["rn"][i],
                                             dic_amp["ln"][i])

            # GS energy with ES contributions (reference :436-438)
            vexp0 = self._stack_v([Vexp_class.Vexp[0, n]
                                   for n in range(1, nbr_states)])
            Ep[0, 0] = float(ccs_ops.energy_ccs(eris, ts, fsp[0],
                                                rsn=torch.stack(rn),
                                                r0n=T(r0n), vn=vexp0))
            Ep_ite.append(Ep.copy())

            conv = self._conv({**dic_amp, "Ep": Ep})
            if ite > 0:
                Dconv = float(np.linalg.norm(conv - conv_old))
            conv_ite.append(Dconv)

            if print_ite:
                tmp = [ite, format_float.format(Dconv)]
                for i in range(nbr_states - 1):
                    cols = ["", format_float.format(C_norm[i, i]),
                            Delta[i + 1, 0], Delta[0, i + 1], 2 * Spin[i] + 1,
                            r0n[i], l0n[i], Ep[i + 1, 0], Ep[i + 1, 1]]
                    if i > 0:
                        cols.append(format_float.format(
                            (C_norm[0, i] + C_norm[i, 0]) / 2))
                    tmp.extend(cols)
                table.append(tmp)

            if ite >= self.maxiter:
                Conv_text = "Max iteration reached"
                break
            if Dconv > 10.0:
                Conv_text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
        else:
            Conv_text = f"Convergence reached for lambda= {L}, after {ite} iteration"

        if print_ite and tabulate is not None:
            print(tabulate(table, headers, tablefmt=self.tablefmt))

        self.last_solve = {"L": L, "iterations": len(conv_ite)}
        _record_metrics(self, "ES", L if np.isscalar(L) else 0.0,
                        [e[0, 0] for e in Ep_ite], Delta_ite, conv_ite)
        return Conv_text, dic_amp, Delta, Ep, rdm1[0]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def SCF_diag(self, L=None, dic_amp_ini=None, print_ite=True,
                 davidson=False, max_space=20):
        """Diagonalization variant: at each macro-iteration the R1/L1
        updates are replaced by diagonalization of the similarity-
        transformed singles matrix (the intent of the reference's stale
        SCF_diag, Solver_ES.py:502-862).  With davidson=True the
        matrix-free non-symmetric Davidson (utils.linalg.davidson_device,
        the analogue of pyscf lib.davidson_nosym1 at Solver_ES.py:710-711)
        runs on the solver's device with the exact map diagonal as
        preconditioner, its cycle programs kept across the iterations;
        otherwise exact dense diagonalization on the host."""
        Vexp_class = self.Vexp_class
        nbr_states = self.nbr_states
        eris = self.mycc.eris
        nocc, nvir = self.nocc, self.nvir
        T = self._t
        if L is None:
            L = Vexp_class.L
        else:
            L = Vexp_class.L_check(L)

        amp = amp_from_numpy(self._ini_amp() if dic_amp_ini is None
                             else dic_amp_ini, self.device, self.dtype)
        ts, ls = amp["ts"], amp["ls"]
        rn, ln = list(amp["rn"]), list(amp["ln"])
        r0n = [float(x) for x in amp["r0n"]]
        l0n = [float(x) for x in amp["l0n"]]

        fock = eris.fock
        Delta = np.zeros((nbr_states, nbr_states))
        Ep = np.zeros((nbr_states, 2))
        conv = 0.0
        Dconv = 1.0
        ite = 0
        Conv_text = ""
        rdm1_gs = None
        nov = nocc * nvir
        eye_o = torch.eye(nocc, dtype=self.dtype, device=self.device)
        eye_v = torch.eye(nvir, dtype=self.dtype, device=self.device)

        def follow_root(A, cur):
            """(eigenvalue, unit eigenvector) of the dense map A with the
            largest overlap with the current vector."""
            w, vecs = np.linalg.eig(_np(A).astype(np.float64))
            k = int(np.argmax(np.abs(vecs.T @ np.ravel(_np(cur)))))
            vec = np.real(vecs[:, k])
            return float(w[k].real), T((vec / np.linalg.norm(vec)
                                        ).reshape(nocc, nvir))

        # the Davidson's device state and captured cycle programs, kept
        # across the outer iterations: each solve copies its map's
        # operands (the intermediates and r0/l0) into their buffers
        programs = {}

        def davidson_root(matvec, cur, diag, operands):
            _, w, xs = ulinalg.davidson_device(
                matvec, [cur.reshape(-1)], diag, nroots=1,
                max_space=max_space, follow=True, operands=operands,
                programs=programs)
            vec = xs[0]
            return float(w[0]), (vec / torch.linalg.norm(vec)
                                 ).reshape(nocc, nvir).to(self.dtype)

        def matvec_r(v, mops):
            Ri, r0c = mops
            return ccs_ops.R1eq(v.reshape(nocc, nvir), r0c, Ri).reshape(-1)

        def matvec_l(v, mops):
            Lii, l0c = mops
            return ccs_ops.es_L1eq(v.reshape(nocc, nvir), l0c,
                                   Lii).reshape(-1)

        while Dconv > self.conv_thres:
            conv_old = conv
            rdm1_gs = _np(ccs_ops.gamma_CCS(ts, ls))
            fsp = [fock] * nbr_states
            if Vexp_class.exp_data[0]:
                Delta[0, 0], _ = Vexp_class.Vexp_update(
                    rdm1_gs, None, (0, 0), L=L)
                fsp[0] = fock - T(np.asarray(Vexp_class.Vexp[0, 0],
                                             dtype=float))
            for n in range(1, nbr_states):
                rdm1_n = ccs_ops.gamma_es_CCS(ts, ln[n - 1], rn[n - 1],
                                              r0n[n - 1], l0n[n - 1])
                names = Vexp_class.prop_names[n]
                if not Vexp_class.exp_data[n]:
                    continue
                if "trdip" in names or "trmat" in names:
                    # transition Vexp refresh so V^{0n}/V^{n0} can be
                    # threaded into the diagonalized maps (reference
                    # Solver_ES.py:684-744)
                    tr_r = _np(ccs_ops.gamma_tr_CCS(
                        ts, ln[n - 1], torch.zeros_like(ts), 1.0, l0n[n - 1]))
                    tr_l = _np(ccs_ops.gamma_tr_CCS(ts, ls, rn[n - 1],
                                                    r0n[n - 1], 1.0))
                    Delta[n, 0], _ = Vexp_class.Vexp_update(
                        tr_r, tr_l, (n, 0), L=L)
                    Delta[0, n], _ = Vexp_class.Vexp_update(
                        tr_l, tr_r, (0, n), L=L)
                else:
                    Delta[n, n], _ = Vexp_class.Vexp_update(
                        _np(rdm1_n), rdm1_gs, (n, n), L=L)
                    fsp[n] = fock - T(np.asarray(Vexp_class.Vexp[n, n],
                                                 dtype=float))

            T1i = ccs_ops.T1inter(eris, ts, fsp[0])
            ts = ccs_ops.tsupdate(eris, ts, T1i)
            L1i = ccs_ops.L1inter(eris, ts, fsp[0])
            ls = ccs_ops.lsupdate(eris, ts, ls, L1i)

            # diagonalization of the R1 (right) and es-L1 (left) maps in the
            # singles space.  The left vectors get their OWN eigensolve of
            # the transposed-similarity map (the reference runs a separate
            # non-symmetric Davidson for L, Solver_ES.py:746-761; ln = rn
            # is wrong for a non-symmetric matrix).
            for n in range(1, nbr_states):
                vexp_r = self._vmat(Vexp_class.Vexp[0, n])
                vexp_l = self._vmat(Vexp_class.Vexp[n, 0])
                if vexp_l is None:
                    vexp_l = vexp_r  # reference fallback (Solver_ES.py:738-741)
                Rinter = ccs_ops.R1inter(eris, ts, fsp[n], vexp_r)
                Fab, Fji, W, F, Tia, Pia = Rinter
                Li = ccs_ops.es_L1inter(eris, ts, fsp[n], vexp_l)
                Fba_l, Fij_l, W_l, F_l, Zia_l, P_l = Li

                if davidson:
                    # matrix-free Davidson; the matvec carries the current
                    # r0/l0 affine terms along (Solver_ES.py:704-711) and
                    # is preconditioned with the exact map diagonal incl.
                    # the Vexp term (Solver_ES.py:697-702): Fab[bb] -
                    # Fji[jj] + W[b,j,j,b] + F + Pia[j,b].  W is [a,k,i,c]
                    # (R1eq contracts 'akic,kc->ia'): diagonal 'bjjb'.
                    diag_r = (torch.diagonal(Fab)[None, :]
                              - torch.diagonal(Fji)[:, None]
                              + torch.einsum("bjjb->jb", W) + F + Pia
                              ).reshape(-1)
                    Em, rn[n - 1] = davidson_root(
                        matvec_r, rn[n - 1], diag_r, (Rinter, r0n[n - 1]))
                    # left: W_l is [b,i,j,a] (es_L1eq contracts
                    # 'jb,bija->ia'): diagonal 'aiia'
                    diag_l = (torch.diagonal(Fba_l)[None, :]
                              - torch.diagonal(Fij_l)[:, None]
                              + torch.einsum("aiia->ia", W_l) + F_l + P_l
                              ).reshape(-1)
                    Em_l, ln[n - 1] = davidson_root(
                        matvec_l, ln[n - 1], diag_l, (Li, l0n[n - 1]))
                else:
                    # dense path: exact eigendecomposition of the linear
                    # part of both maps, root followed by overlap with the
                    # current vector
                    A = (torch.einsum("ab,ij->iajb", Fab, eye_o)
                         - torch.einsum("ji,ab->iajb", Fji, eye_v)
                         + torch.einsum("akic->iakc", W))
                    A = A.reshape(nov, nov) + F * torch.eye(
                        nov, dtype=self.dtype, device=self.device)
                    Em, rn[n - 1] = follow_root(A, rn[n - 1])
                    B = (torch.einsum("ba,ij->iajb", Fba_l, eye_o)
                         - torch.einsum("ij,ab->iajb", Fij_l, eye_v)
                         + torch.einsum("bija->iajb", W_l))
                    B = B.reshape(nov, nov) + F_l * torch.eye(
                        nov, dtype=self.dtype, device=self.device)
                    Em_l, ln[n - 1] = follow_root(B, ln[n - 1])
                r0n[n - 1] = float(ccs_ops.r0_fromE(eris, Em, ts, rn[n - 1],
                                                    vexp_r, fsp=fsp[n]))
                l0n[n - 1] = float(ccs_ops.l0_fromE(eris, Em_l, ts,
                                                    ln[n - 1], vexp_l,
                                                    fsp=fsp[n]))
                Ep[n, 0] = Em
                Ep[n, 1] = Em_l

            Ep[0, 0] = float(ccs_ops.energy_ccs(eris, ts, fsp[0]))
            conv = _np(ts) + _np(ls)
            if ite > 0:
                Dconv = float(np.linalg.norm(conv - conv_old))
            if ite >= self.maxiter:
                Conv_text = "Max iteration reached"
                break
            if Dconv > 30.0:
                Conv_text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
        else:
            Conv_text = f"Convergence reached for lambda= {L}, after {ite} iteration"

        ulinalg.release_programs(programs)
        dic_amp = amp_to_numpy({"ts": ts, "ls": ls, "rn": rn, "ln": ln,
                                "r0n": r0n, "l0n": l0n})
        return Conv_text, dic_amp, Delta, Ep, rdm1_gs


# ---------------------------------------------------------------------------
# The device route: the whole coupled iteration on the device
# ---------------------------------------------------------------------------

_ES_DEVICE_PROPS = {"mat", "trmat", "Ek", "v1e", "dip", "DEk", "trdip", "F"}


def _es_conv_vec(kind, ts, ls, rn, ln, Ep):
    if kind == "Ep":
        return Ep.reshape(-1)
    if kind == "tl":
        return (ts + ls).reshape(-1)
    if kind == "rl":
        return (rn + ln).sum(dim=0).reshape(-1)
    return ((ts + ls) + (rn + ln).sum(dim=0)).reshape(-1)


def _es_step(vexp, eris, amp, ov, Lflat, force_alpha=True):
    """One coupled iteration before DIIS: (ts, ls, rnew, lnew, r0new,
    l0new, Em_r, Em_l, fsp0, V0n, Delta) from the amplitudes `amp` (the
    stacked form of amp_from_numpy), vexp the multi-state Vexp update
    (ops/vexp.make_es_vexp_device) and Lflat its weights.  ov: flattened
    (o, v) positions, one per state, or None to take each state's largest
    amplitude.  It reads nothing to the host."""
    ts, ls, rn, ln, r0n, l0n = (amp[k] for k in
                                ("ts", "ls", "rn", "ln", "r0n", "l0n"))
    nvir = ts.shape[1]
    rdm1_gs = ccs_ops.gamma_CCS(ts, ls)
    rdm1_es = ccs_ops.gamma_es_CCS(ts, ln, rn, r0n, l0n)
    tr_r = ccs_ops.gamma_tr_CCS(ts, ln, torch.zeros_like(ts), 1.0, l0n)
    tr_l = ccs_ops.gamma_tr_CCS(ts, ls, rn, r0n, 1.0)

    V00, Vnn, V0n, Vn0, Delta = vexp(rdm1_gs, rdm1_es, tr_r, tr_l, Lflat)
    fsp0 = eris.fock - V00
    fspn = eris.fock[None] - Vnn

    T1i = ccs_ops.T1inter(eris, ts, fsp0)
    ts = ccs_ops.tsupdate(eris, ts, T1i, rsn=rn, r0n=r0n, vn=V0n)
    L1i = ccs_ops.L1inter(eris, ts, fsp0)
    ls = ccs_ops.lsupdate(eris, ts, ls, L1i, rsn=rn, lsn=ln, r0n=r0n,
                          l0n=l0n, vn=Vn0)

    pos = None if ov is None else (ov // nvir, ov % nvir)
    Rinter = ccs_ops.R1inter(eris, ts, fspn, V0n)
    Em_r, o, v = ccs_ops.Extract_Em_r(eris, rn, r0n, Rinter, ov=pos)
    rnew = ccs_ops.rsupdate(eris, rn, r0n, Rinter, Em_r,
                            force_alpha=force_alpha)
    rov = ccs_ops.get_ov(ln, l0n, rn, r0n, (o, v))
    rnew = ccs_ops._put(rnew, o * nvir + v, rov)
    r0new = ccs_ops.r0_fromE(eris, Em_r, ts, rn, V0n, fsp=fspn)

    Linter = ccs_ops.es_L1inter(eris, ts, fspn, Vn0)
    Em_l, o, v = ccs_ops.Extract_Em_l(eris, ln, l0n, Linter, ov=pos)
    lnew = ccs_ops.es_lsupdate(eris, ln, l0n, Em_l, Linter,
                               force_alpha=force_alpha)
    lov = ccs_ops.get_ov(rn, r0n, ln, l0n, (o, v))
    lnew = ccs_ops._put(lnew, o * nvir + v, lov)
    l0new = ccs_ops.l0_fromE(eris, Em_l, ts, ln, Vn0, fsp=fspn)
    return (ts, ls, rnew, lnew, r0new, l0new, Em_r, Em_l, fsp0, V0n,
            Delta)


def _es_body(vexp, s, diis, force_alpha, pins, Lflat):
    """SolverES_Device.SCF's loop body (JAX es.py:643-842) for the
    Solver_ES s and these arguments: pins the (o, v) positions of the
    states (a device tensor), or None to follow each state's largest
    amplitude; Lflat the weights (a device tensor).  It holds no
    reference to the SolverES_Device, which keeps it."""
    eris = s.mycc.eris
    n_es = s.nbr_states - 1
    maxiter, thres, mindiis = s.maxiter, s.conv_thres, s.mindiis
    conv_var, f64 = s.conv_var, torch.float64
    zeros_es = torch.zeros(n_es, dtype=s.dtype, device=s.device)

    def body(state):
        # one coupled iteration: every decision a tensor, every write at
        # a tensor index
        (_, ts, ls, rn, ln, r0n, l0n, conv_old, Dconv, ite, k, status,
         Ep_h, Delta_h, *ring) = state
        (ts, ls, rnew, lnew, r0new, l0new, Em_r, Em_l, fsp0, V0n,
         Delta) = _es_step(vexp, eris, {"ts": ts, "ls": ls, "rn": rn,
                                        "ln": ln, "r0n": r0n, "l0n": l0n},
                           pins, Lflat, force_alpha)
        if diis:
            parts = {"GS": (ls, ts), "ES": (rnew, lnew, r0new, l0new),
                     "all": (ts, ls, rnew, lnew, r0new, l0new)}[diis]
            st, vec = diis_ops.diis_update(
                diis_ops.DIISState(*ring),
                torch.cat([x.reshape(-1) for x in parts]), mindiis)
            ring = tuple(st)
            out, i = [], 0
            for x in parts:
                out.append(vec[i:i + x.numel()].reshape(x.shape))
                i += x.numel()
            if diis == "GS":
                ls, ts = out
            elif diis == "ES":
                rnew, lnew, r0new, l0new = out
            else:
                ts, ls, rnew, lnew, r0new, l0new = out

        rn, ln, r0n, l0n = rnew, lnew, r0new, l0new
        Ep0 = ccs_ops.energy_ccs(eris, ts, fsp0, rsn=rn, r0n=r0n, vn=V0n)
        Ep = torch.stack([torch.cat([Ep0.reshape(1), Em_r]),
                          torch.cat([zeros_es[:1], Em_l])], dim=1)
        conv = _es_conv_vec(conv_var, ts, ls, rn, ln, Ep)
        Ep_h.index_put_((k,), Ep)
        Delta_h.index_put_((k,), Delta)
        Dconv = torch.where(
            ite > 0, torch.linalg.norm(conv - conv_old).to(f64), Dconv)
        # NaN included: it compares false with the threshold
        status = torch.where(ite >= maxiter, MAXITER,
                             torch.where(Dconv <= 10.0, status, DIVERGED))
        ite = torch.where(status == RUNNING, ite + 1, ite)
        go = (Dconv > thres) & (status == RUNNING)
        return (go, ts, ls, rn, ln, r0n, l0n, conv, Dconv, ite, k + 1,
                status, Ep_h, Delta_h, *ring)

    return body


class SolverES_Device:
    """Solver_ES.SCF with all state/transition rdm1s, the whole Vexp[n,m]
    refresh, the coupled t/lambda updates, the (r, r0, l, l0) updates of
    every excited state at once, and the DIIS on the device (the module
    docstring says how).

    Construct from a Solver_ES; call `SCF(L, ...)`."""

    def __init__(self, solver: "Solver_ES"):
        self.s = solver
        names = solver.Vexp_class.prop_names
        if not all(p in _ES_DEVICE_PROPS for st in names for p in st):
            raise NotImplementedError(
                "device ES solver supports mat/trmat/Ek/v1e/dip/DEk/trdip/F "
                "targets; use Solver_ES.SCF for others")
        from ecw_cc_torch.ops.vexp import make_es_vexp_device

        self._vexp = make_es_vexp_device(solver.Vexp_class,
                                         dtype=solver.dtype,
                                         device=solver.device)
        # SCF's loops by what changes their launches, and the device
        # tensors their bodies read: the weights and the pinned positions
        self._loops = {}
        self._weights = self._pins = None

    def release_graphs(self):
        """Free the loops (their graphs, pools and static state) that SCF
        keeps for the next call with the same arguments; ECW.CCS_ES calls
        it after its solve or sweep."""
        self._loops = {}
        self._weights = self._pins = None

    @torch.no_grad()
    def SCF(self, L=None, dic_amp_ini=None, diis=None, force_alpha=True,
            print_ite=False):
        """One coupled solve at weights L, a device_loop.Loop (a replayed
        graph on the card, one flag read per iteration).  The loop is
        kept for the next call with the same diis, force_alpha and kind of
        start (a cold start pins each state's (o, v) position, a warm one
        follows the largest amplitude: an L_loop sweep captures at most
        twice), its weights and pinned positions device tensors the body
        reads, refilled per call, until release_graphs()."""
        s = self.s
        Vexp_class = s.Vexp_class
        L = Vexp_class.L if L is None else Vexp_class.L_check(L)
        Lflat = torch.tensor(
            [float(x) for st in L for x in np.atleast_1d(st)], dtype=s.dtype)
        diis = s.diis if diis is None else diis
        dev, dt = s.device, s.dtype
        nocc, nvir = s.nocc, s.nvir
        nov = nocc * nvir
        n_states = s.nbr_states
        n_es = n_states - 1
        maxiter = s.maxiter

        if dic_amp_ini is None:
            amp = amp_from_numpy(s._ini_amp(), dev, dt)
            # a cold start pins (o, v) of each state at the largest entry
            # of its guess, as Solver_ES.SCF does (the unit entry of a
            # Koopman guess; a generated guess, such as an EOM R1, has no
            # entry equal to 1, and pinning (0, 0) there divided by zero);
            # a warm start follows the largest amplitude
            ov = torch.tensor([int(np.argmax(np.abs(np.asarray(r))))
                               for r in s.rn_ini])
        else:
            amp = amp_from_numpy(dic_amp_ini, dev, dt)
            ov = None
        ts, ls, rn, ln, r0n, l0n = (amp[k] for k in
                                    ("ts", "ls", "rn", "ln", "r0n", "l0n"))
        if self._weights is None:
            self._weights = torch.empty_like(Lflat, device=dev)
            self._pins = torch.zeros(n_es, dtype=torch.int64, device=dev)
        self._weights.copy_(Lflat)
        if ov is not None:
            self._pins.copy_(ov)
        key = (diis, force_alpha, ov is None, s.conv_var, s.conv_thres,
               maxiter, s.mindiis, s.maxdiis)
        if key not in self._loops:
            self._loops[key] = device_loop.Loop(_es_body(
                self._vexp, s, diis, force_alpha,
                None if ov is None else self._pins, self._weights))
        loop = self._loops[key]

        nvec = {"GS": 2 * nov, "ES": 2 * n_es * nov + 2 * n_es,
                "all": 2 * nov + 2 * n_es * nov + 2 * n_es}.get(diis)
        ring = (tuple(diis_ops.diis_init(nvec, s.maxdiis, dtype=dt,
                                         device=dev)) if nvec else ())
        hist = maxiter + 2
        Ep_h = torch.zeros((hist, n_states, 2), dtype=dt, device=dev)
        Delta_h = torch.zeros((hist, n_states, n_states), dtype=dt,
                              device=dev)
        conv = torch.zeros_like(_es_conv_vec(s.conv_var, ts, ls, rn, ln,
                                             Ep_h[0]))
        f64 = torch.float64
        i0 = torch.zeros((), dtype=torch.int64, device=dev)
        log = {}
        (_, ts, ls, rn, ln, r0n, l0n, _, _, ite, k, status, Ep_h,
         Delta_h, *_) = loop(
            (torch.full((), 1.0 > s.conv_thres, dtype=torch.bool,
                        device=dev),
                   ts, ls, rn, ln, r0n, l0n, conv,
                   torch.ones((), dtype=f64, device=dev), i0, i0.clone(),
                   torch.full_like(i0, RUNNING), Ep_h, Delta_h, *ring),
            log)
        ite, k, status = int(ite), int(k), int(status)
        if status == RUNNING:
            status = CONVERGED

        rdm1_gs = _np(ccs_ops.gamma_CCS(ts, ls))
        dic_amp = amp_to_numpy({"ts": ts, "ls": ls, "rn": rn, "ln": ln,
                                "r0n": r0n, "l0n": l0n})
        Ep_h, Delta_h = _np(Ep_h), _np(Delta_h)
        Ep = Ep_h[k - 1] if k else Ep_h[0]
        Delta = Delta_h[k - 1] if k else Delta_h[0]
        self.last_solve = {"L": L, "iterations": k, "status": status,
                           "loops": [log]}
        _record_metrics(self, "ES_device", L if np.isscalar(L) else 0.0,
                        Ep_h[:k, 0, 0], Delta_h[:k, 0, 0], [])
        return _conv_text(status, L, ite), dic_amp, Delta, Ep, rdm1_gs
