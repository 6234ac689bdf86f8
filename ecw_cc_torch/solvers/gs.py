"""Ground-state ECW-CCS and ECW-CCSD solvers (port of
ecw_cc_tpu/solvers/gs.py, device routes; reference Solver_GS.py).

Solver_CCS (reference Solver_GS.py:22-514) iterates the o*v-sized t1 and
lambda1 equations: `SCF` is the device loop, `Gradient` the Newton /
steepest-descent solve on the exact Jacobian, `L1_grad` the proximal
L1 solve.

Solver_CCSD (reference Solver_GS.py:521-742) takes one of the routes of the
JAX loop (gs.py:681-1067), chosen per solver:

  - sectored: ERIs in the spin-SORTED layout (mo_perm given), and every
    Vexp target / potential spin-block-diagonal (the structure gate) with
    config.soup_sector: the sector-blocked updates of ops/ccsd_sect.py
    (with the closed-shell mirror symmetry where its gate passes; one
    f32 lane's step runs them through a ccsd_sect.SoupPlan built once per
    set-up, last_solve["soup"] its counts), both
    ladders as one stacked sector GEMM per spin sector (a dense sorted
    vvvv is first packed into a SectoredVVVV), and the DIIS in the packed
    balanced-block space;
  - dense on the sorted layout: mo_perm given but the gate fails (a target
    that couples the spins) or soup_sector is off: the dense updates of
    ops/ccsd.py; a SectoredVVVV runs both ladders as one stacked GEMM per
    sector on every occupied row pair (stacked_sectored_contract, sym
    off), any other operand as on the alternating layout;
  - alternating (mo_perm=None): the reference layout, dense updates, and
    the ladder operand of config.ladder_mode: a PackedVVVV (both ladders
    as one stacked packed GEMM) or none (each update runs the dense GEMM
    against eris.vvvv).
Every ladder product is a launch of the hand-written GEMM kernel.

The JAX package compiles the solve as one lax.while_loop.  Here each leg
is a body over device tensors, every decision of the loop a tensor, run by
solvers/device_loop.py: on the card one iteration is captured as a CUDA
graph and replayed, each iteration reading back one flag, whether any
lane is still active.  The set-up and the loops are kept on the solver
for its next SCF call with the same arguments (the lambdas of a sweep),
until release_graphs().  Public
amplitudes and rdm1s are in the reference (alternating) spin convention:
on the sorted layout they are sorted once on entry and unsorted once on
exit.

Precision (config.iter_precision, JAX gs.py:732-1038): each leg of the
loop runs under config.matmul_precision of its mode; under 'bf16' the
t/lambda updates read bf16 copies of the ERI blocks, the ladder operand
(and, on the sectored route, their blocked views), built once per set-up
(_setup), and bf16 amplitudes, while rdm1, Vexp, the energy, DIIS and the
convergence test stay in the loop's dtype; 'hybrid' runs a leg at
config.hybrid_fast, then a 'highest' leg with a fresh DIIS ring.
SCF(refine=True) follows the solve with polish_f64, f64 iterations on the
amplitudes' own device.

SCF_batch (JAX gs.py:1131-1179) solves every lambda of a sweep at once:
one iteration step, the one SCF calls, runs under torch.func.vmap over a
leading lambda axis, so each ladder product launches once with the lanes
stacked into its rows; the legs, the stall detector and the per-lane
freeze stay outside it, in the loop's body.

On a device mesh (ERIs, ladder operand or amplitudes split as
parallel/sharding.py places them, JAX SCF_device(ts=, ls=, td=, ld=))
Solver_CCSD gathers the split ERI blocks at construction and the split
amplitudes at SCF's entry, and keeps the ladder operand split: every
ladder product is one launch on this rank's rows (a RowShard) and an
all-gather of its columns.  The loop runs on plain tensors; amplitudes
kept on the device come back in amp_shardings' placements.

Every GS property is a device property, so the JAX package's host loops
(_scf_host) have no counterpart: Solver_CCS.SCF(store_ite=True), which
ran on the CCS one there, records its trajectory in the device loop.
SCF_device names SCF on both solvers, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import types

import numpy as np
import torch

from ecw_cc_torch.config import get_config, matmul_precision
from ecw_cc_torch.ops import ccs as ccs_ops
from ecw_cc_torch.ops import ccsd as ccsd_ops
from ecw_cc_torch.ops import ccsd_sect
from ecw_cc_torch.ops import diis as diis_ops
from ecw_cc_torch.ops import spinsect
from ecw_cc_torch.kernels.ladder_mm import RowShard, ladder_mm
from ecw_cc_torch.models.eris import GEris, warn_if_sorted_layout
from ecw_cc_torch.ops.ladder import (PackedVVVV, SectoredVVVV,
                                     balanced_stacked_sectored_contract,
                                     ensure_sorted_vvvv_op, make_vvvv_op,
                                     stacked_packed_contract,
                                     stacked_sectored_contract)
from ecw_cc_torch.ops.l1reg import subdiff
from ecw_cc_torch.ops.vexp import make_gs_vexp_device
from ecw_cc_torch.parallel import sharding
from ecw_cc_torch.solvers import device_loop
from ecw_cc_torch.utils.metrics import IterationMetrics, span

# the iter_precision modes whose float32 ladder products run TF32
TF32_MODES = ("high", "default")

# status codes of a solve (as in the JAX solver)
RUNNING, CONVERGED, MAXITER, DIVERGED = 0, 1, 2, 3


def _perm2(t, o_idx, v_idx):
    """Apply occ/vir index maps to a (nocc, nvir) amplitude."""
    return t[o_idx][:, v_idx]


def _perm4(t, o_idx, v_idx):
    """Apply occ/vir index maps to a (nocc, nocc, nvir, nvir) amplitude."""
    return t[o_idx][:, o_idx][:, :, v_idx][:, :, :, v_idx]


def _record_metrics(solver_obj, name, L, Ep_it, Delta_it, conv_it):
    """solver.last_metrics from the per-iteration histories (JSON lines to
    $ECW_CC_TPU_METRICS when set, as in the JAX package)."""
    m = IterationMetrics(solver=name, L=float(L) if np.isscalar(L) else None)
    for i, Ep in enumerate(np.atleast_1d(Ep_it)):
        row = {"Ep": float(Ep)}
        if i < len(conv_it):
            row["conv"] = float(conv_it[i])
        if i < len(Delta_it):
            d = np.ravel(Delta_it[i])
            row["Delta"] = float(d[0])
            if d.size == 2:
                row["vmax"] = float(d[1])
        m.record(i, **row)
    solver_obj.last_metrics = m
    path = os.environ.get("ECW_CC_TPU_METRICS")
    if path:
        m.write(path)
    return m


def _conv_text(status, L, n_ite, alpha=None, ccsd=False):
    if status == CONVERGED:
        if ccsd:
            return (f"Convergence reached for lambda= {L} and alpha={alpha}, "
                    f"after {n_ite} iteration")
        return f"Convergence reached for lambda= {L}, after {n_ite} iteration"
    if status == MAXITER:
        return "Max iteration reached"
    return f"Diverges for lambda = {L} after {n_ite} iterations"


def _to_tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        a = sharding.replicate(a)
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _ccs_conv_vec(conv, mycc, ts, ls, fsp):
    if conv == "tl":
        return (ts + ls).reshape(-1)
    if conv == "l":
        return ls.reshape(-1)
    return mycc.energy_ccs(ts, fsp).reshape(1)


class Solver_CCS:
    """Reference API: Solver_GS.Solver_CCS (Solver_GS.py:22-239).

    mycc: ops.ccs.Gccs over torch ERIs in the alternating layout (the
    device and dtype of the solve are those of mycc.eris); CCS_grad: an
    ops.ccs.ccs_gradient for `Gradient`."""

    def __init__(self, mycc, VX_exp, conv="tl", conv_thres=1e-6, tsini=None,
                 lsini=None, diis="", maxiter=40, maxdiis=15, CCS_grad=None,
                 mindiis=2):
        if conv not in ("Ep", "l", "tl"):
            raise ValueError("Accepted convergence parameter is Ep, l or tl")
        # the CCS kernels take the alternating MO layout (no mo_perm here);
        # a spin-sorted handle would scramble them silently
        warn_if_sorted_layout(mycc.eris, "Solver_CCS")
        self.nocc, self.nvir = mycc.nocc, mycc.nvir
        self.mycc = mycc
        self.myVexp = VX_exp
        self.Grad = CCS_grad
        self.diis = diis
        self.maxdiis = maxdiis
        self.mindiis = mindiis
        self.maxiter = maxiter
        self.conv_thres = conv_thres
        self.conv = conv
        self.fock = mycc.fock
        self.device, self.dtype = self.fock.device, self.fock.dtype
        self.tsini = self._amp(tsini)
        self.lsini = self._amp(lsini)
        self._kept = None     # (key, loop, weights): SCF

    def _amp(self, a):
        if a is None:
            return torch.zeros((self.nocc, self.nvir), dtype=self.dtype,
                               device=self.device)
        return _to_tensor(a, self.dtype, self.device)

    def release_graphs(self):
        """Free the loop (its graph, pool and static state) that SCF keeps
        for the next call with the same arguments; ECW.CCS_GS calls it
        after its sweep."""
        self._kept = None

    def _conv_vec(self, ts, ls, fsp):
        return _ccs_conv_vec(self.conv, self.mycc, ts, ls, fsp)

    def SCF(self, L, ts=None, ls=None, diis="", alpha=None, store_ite=False):
        """SCF+DIIS solve at constraint weight L (reference
        Solver_GS.py:101-239): a device_loop.Loop whose state stays on the
        device (a replayed graph on the card), one flag read per
        iteration.  Returns the reference
        6-tuple (conv_text, Ep_it, Delta_it, conv_it, rdm1, (ts, ls)) as
        NumPy arrays.

        store_ite=True returns the JAX 7-tuple (conv_text, Ep_it,
        Delta_it, conv_it, rdm1, ts_ite, ls_ite) instead: ts and ls after
        each iteration's DIIS, of every iteration that did not stop the
        loop on maxiter or divergence (the converging one included), as
        (n, nocc, nvir) arrays.  They are kept in device buffers and read
        once, after the loop.

        The loop is kept for the next call with the same diis, alpha and
        store_ite (the lambdas of a sweep: one capture per sweep), its
        weights a device tensor the body reads, refilled per call, until
        release_graphs()."""
        ts = self.tsini if ts is None else self._amp(ts)
        ls = self.lsini if ls is None else self._amp(ls)
        diis = diis or self.diis
        eris = self.mycc.eris
        nocc, nvir = self.nocc, self.nvir
        n1, dim = nocc * nvir, nocc + nvir
        dev, dt, maxiter = self.device, self.dtype, self.maxiter
        f64, thres = torch.float64, self.conv_thres
        Lw_host = torch.tensor(self.myVexp.L_check(L)[0], dtype=dt)
        key = (diis, alpha, store_ite, self.conv, thres, maxiter,
               self.mindiis, self.maxdiis, tuple(Lw_host.shape))
        if self._kept is None or self._kept[0] != key:
            self.release_graphs()
            Lw = torch.empty_like(Lw_host, device=dev)
            self._kept = (key, device_loop.Loop(
                self._scf_body(diis, alpha, store_ite, Lw)), Lw)
        _, loop, Lw = self._kept
        Lw.copy_(Lw_host)

        with torch.no_grad():
            rdm1 = ccs_ops.gamma_CCS(ts, ls)
            ring = (tuple(diis_ops.diis_init(
                2 * n1 if diis == "tl" else dim * dim, self.maxdiis,
                dtype=dt, device=dev)) if diis else ())
            conv = torch.zeros_like(self._conv_vec(ts, ls, eris.fock))
            hist = torch.zeros((4, maxiter + 2), dtype=dt, device=dev)
            ite_bufs = tuple(torch.zeros((maxiter + 2, nocc, nvir),
                                         dtype=dt, device=dev)
                             for _ in range(2 * store_ite))
            i0 = torch.zeros((), dtype=torch.int64, device=dev)
            go = torch.full((), 1.0 > thres, dtype=torch.bool, device=dev)
            log = {}
            (_, ts, ls, rdm1, _, _, ite, k, status, hist,
             *rest) = loop(
                (go, ts, ls, rdm1, conv,
                 torch.ones((), dtype=dt, device=dev), i0, i0.clone(),
                 torch.full_like(i0, RUNNING), hist, *ring, *ite_bufs), log)
        ite, k, status = int(ite), int(k), int(status)
        if status == RUNNING:
            status = CONVERGED
        Ep_h, Delta_h, vmax_h, conv_h = hist[:, :k].cpu().numpy()
        rdm1 = rdm1.cpu().numpy()
        Delta_it = np.stack([Delta_h, vmax_h], axis=1)
        # keep the host Vexp state consistent for later property queries
        self.myVexp.Vexp_update(rdm1, rdm1, (0, 0), L=L)
        self.last_solve = {"L": L, "iterations": k, "status": status,
                           "loops": [log]}
        _record_metrics(self, "CCS_device", L, Ep_h, Delta_it, conv_h)
        text = _conv_text(status, L, ite)
        if store_ite:
            ts_ite, ls_ite = rest[-2:]
            return (text, Ep_h, Delta_it, conv_h, rdm1,
                    ts_ite[:ite].cpu().numpy(), ls_ite[:ite].cpu().numpy())
        return (text, Ep_h, Delta_it, conv_h, rdm1,
                (ts.cpu().numpy(), ls.cpu().numpy()))

    def _scf_body(self, diis, alpha, store_ite, Lw):
        """SCF's loop body for these arguments, reading the weights from
        the device tensor Lw."""
        eris = self.mycc.eris
        nocc, nvir = self.nocc, self.nvir
        n1, dim = nocc * nvir, nocc + nvir
        dev, maxiter = self.device, self.maxiter
        f64, thres, mindiis = torch.float64, self.conv_thres, self.mindiis
        # the body holds no reference to the solver, which keeps it
        conv_vec = functools.partial(_ccs_conv_vec, self.conv, self.mycc)
        vexp_fn = make_gs_vexp_device(self.myVexp, dtype=self.dtype,
                                      device=dev)
        rows = torch.arange(4, device=dev)

        def body(state):
            # one iteration (JAX gs.py:203-310): every decision a tensor,
            # every write at a tensor index
            (_, ts, ls, rdm1, conv_old, Dconv, ite, k, status, hist,
             *rest) = state
            ring = tuple(rest[:len(rest) - 2 * store_ite])
            ite_bufs = rest[len(ring):]
            V, Delta, vmax = vexp_fn(rdm1, Lw)
            fsp = eris.fock - V
            T1i = ccs_ops.T1inter(eris, ts, fsp)
            ts = (ccs_ops.tsupdate(eris, ts, T1i) if alpha is None
                  else ccs_ops.tsupdate_L1(eris, ts, T1i, alpha))
            L1i = ccs_ops.L1inter(eris, ts, fsp)
            ls = (ccs_ops.lsupdate(eris, ts, ls, L1i) if alpha is None
                  else ccs_ops.lsupdate_L1(eris, ls, L1i, alpha))
            if diis == "tl":
                st, vec = diis_ops.diis_update(
                    diis_ops.DIISState(*ring),
                    torch.cat([ls.reshape(-1), ts.reshape(-1)]),
                    mindiis)
                ring = tuple(st)
                ls = vec[:n1].reshape(nocc, nvir)
                ts = vec[n1:].reshape(nocc, nvir)
            rdm1 = ccs_ops.gamma_CCS(ts, ls)
            if diis == "rdm1":
                st, vec = diis_ops.diis_update(
                    diis_ops.DIISState(*ring), rdm1.reshape(-1),
                    mindiis)
                ring = tuple(st)
                rdm1 = vec.reshape(dim, dim)
            Ep = ccs_ops.energy_ccs(eris, ts, fsp)
            conv = conv_vec(ts, ls, fsp)
            Dconv = torch.where(ite > 0, torch.linalg.norm(conv - conv_old),
                                Dconv)
            hist.index_put_((rows, k), torch.stack([Ep, Delta, vmax, Dconv]))
            D64 = Dconv.to(f64)     # compared as the host float it was
            status = torch.where(ite >= maxiter, MAXITER,
                                 torch.where(D64 > 10.0, DIVERGED, status))
            for buf, x in zip(ite_bufs, (ts, ls)):
                # row ite is read only if this iteration counts
                buf.index_put_((ite,), x)
            ite = torch.where(status == RUNNING, ite + 1, ite)
            go = (D64 > thres) & (status == RUNNING)
            return (go, ts, ls, rdm1, conv, Dconv, ite, k + 1, status, hist,
                    *ring, *ite_bufs)

        return body

    SCF_device = SCF    # the JAX name of the device loop

    # -- gradient-based variants (reference Solver_GS.py:245-514) --------
    def _step_loop(self, L, ts, ls, step, diverged, scalar_conv=False):
        """The loop that Gradient and L1_grad share, its state on the
        device as in SCF: Vexp at the current rdm1, one `step(ts, ls,
        fsp)`, the energy and the convergence measure, read once per
        iteration.  scalar_conv: converge on the change of |conv|
        (L1_grad) instead of |conv - conv_old|."""
        mycc = self.mycc
        fock = self.fock
        vexp_fn = make_gs_vexp_device(self.myVexp, dtype=self.dtype,
                                      device=self.device)
        Lw = self.myVexp.L_check(L)[0]
        rdm1 = mycc.gamma(ts, ls)
        conv = 0.0
        Dconv = 1.0
        ite = 0
        hist, conv_ite = [], []
        while Dconv > self.conv_thres:
            conv_old = conv
            with torch.no_grad():
                V, Delta, vmax = vexp_fn(rdm1, Lw)
            fsp = fock - V
            ts, ls = step(ts, ls, fsp)
            rdm1 = mycc.gamma(ts, ls)
            hist.append(torch.stack([mycc.energy_ccs(ts, fsp), Delta, vmax]))
            convv = self._conv_vec(ts, ls, fsp)
            if scalar_conv:
                conv = float(torch.linalg.norm(convv))
                conv_ite.append(conv)
                if ite > 0:
                    Dconv = abs(conv - conv_old)
            else:
                conv = convv
                if ite > 0:
                    Dconv = float(torch.linalg.norm(conv - conv_old))
                conv_ite.append(Dconv)
            if ite >= self.maxiter:
                text = "Max iteration reached"
                break
            if Dconv > diverged:
                text = f"Diverges for lambda = {L} after {ite} iterations"
                break
            ite += 1
        else:
            text = _conv_text(CONVERGED, L, ite)
        hist = torch.stack(hist).cpu().numpy()
        rdm1 = rdm1.cpu().numpy()
        # keep the host Vexp state consistent for later property queries
        self.myVexp.Vexp_update(rdm1, rdm1, (0, 0), L=L)
        return (text, hist[:, 0], hist[:, 1:], np.asarray(conv_ite), rdm1,
                (ts.cpu().numpy(), ls.cpu().numpy()))

    def Gradient(self, L, method="newton", ts=None, ls=None, diis="", beta=0.1,
                 store_ite=False):
        """Newton / steepest-descent solve via the CCS Jacobian (reference
        Solver_GS.Gradient)."""
        if self.Grad is None:
            raise ValueError("a ccs_gradient object is required for Gradient")
        if method == "newton":
            step = lambda t, l, fsp: self.Grad.Newton(t, l, fsp, L)
        elif method == "descend":
            step = lambda t, l, fsp: self.Grad.Gradient_Descent(beta, t, l,
                                                                fsp, L)
        else:
            raise ValueError("method must be 'newton' or 'descend'")
        ts = self.tsini if ts is None else self._amp(ts)
        ls = self.lsini if ls is None else self._amp(ls)
        return self._step_loop(L, ts, ls, step, diverged=10.0)

    def L1_grad(self, L, alpha, chi, ts=None, ls=None, diis=""):
        """Ivanov-style L1 proximal-gradient solve (reference
        Solver_GS.L1_grad :375-514)."""
        mycc = self.mycc
        nocc = self.nocc
        d = torch.diagonal(self.fock)
        eia = -d[:nocc, None] + d[None, nocc:]
        thres = self.conv_thres

        def step(ts, ls, fsp):
            dWT = subdiff(mycc.T1eq(ts, fsp), ts, alpha)
            dWL = subdiff(mycc.L1eq(ts, ls, fsp), ls, alpha)
            # proximal step with hard P_0 projection (reference :452-469)
            Xj_t = ts - chi * dWT / eia
            ts_new = torch.where(Xj_t * ts > thres, Xj_t,
                                 torch.zeros_like(ts))
            Xj_l = ls - chi * dWL / eia
            ls_new = torch.where(Xj_l * ls > thres, Xj_l,
                                 torch.zeros_like(ls))
            return ts_new, ls_new

        ts = (self.tsini if ts is None else self._amp(ts)).clone()
        ls = (self.lsini if ls is None else self._amp(ls)).clone()
        return self._step_loop(L, ts, ls, step, diverged=2.0,
                               scalar_conv=True)


class Solver_CCSD:
    """Reference API: Solver_GS.Solver_CCSD (Solver_GS.py:521-742).

    mycc: ops.ccsd.GCC over torch ERIs (the device and dtype of the solve
    are those of mycc.eris); vvvv_op: their ladder operand (SectoredVVVV,
    PackedVVVV), or None to derive it from eris.vvvv per
    config.ladder_mode at each solve; mo_perm: the MO permutation
    (new_from_old) the ERIs were spin-sorted with, or None for ERIs in the
    reference alternating layout; eris_host: the f64 ERIs that
    SCF(refine=True) polishes on, a GEris of tensors in the alternating
    layout with the dense vvvv (ECW.eris_f64: build_eris_device(dtype=
    float64), or ErisHost.to_device), moved to the solve's device once."""

    def __init__(self, mycc, VX_exp, conv="tl", conv_thres=1e-6, tsini=None,
                 lsini=None, tdini=None, ldini=None, diis="", maxiter=40,
                 maxdiis=None, mindiis=None, energy_term="ref", vvvv_op=None,
                 mo_perm=None, eris_host=None):
        if conv not in ("Ep", "l", "tl"):
            raise ValueError("Accepted convergence parameter is Ep, l or tl")
        if diis not in ("", "tl", "rdm1"):
            raise ValueError("diis must be '', 'tl' or 'rdm1'")
        # ERIs, ladder operand or amplitudes split over a device mesh
        # (parallel/sharding.py): the loop runs on the gathered blocks and
        # launches each ladder product on this rank's rows of the operand
        self.mesh = sharding.mesh_of(mycc.eris, vvvv_op, tsini, lsini,
                                     tdini, ldini)
        if self.mesh is not None:
            mycc = ccsd_ops.GCC(sharding.local_eris(mycc.eris),
                                fock=sharding.replicate(mycc.fock))
            vvvv_op = sharding.local_operand(vvvv_op)
        if mo_perm is None:
            # without mo_perm the kernels take the alternating layout; a
            # sorted handle (ECW's f32 sectored ERIs) would scramble them
            warn_if_sorted_layout(mycc.eris, "Solver_CCSD(mo_perm=None)")
            if isinstance(vvvv_op, SectoredVVVV):
                raise ValueError(
                    "a SectoredVVVV ladder operand is in the spin-sorted "
                    "layout: pass the mo_perm its ERIs were sorted with")
        self.mycc = mycc
        self.myVexp = VX_exp
        if eris_host is not None and not isinstance(eris_host, GEris):
            raise TypeError("eris_host: a GEris of tensors with the dense "
                            "vvvv (ECW.eris_f64), not "
                            f"{type(eris_host).__name__}")
        self.eris_host = eris_host   # enables refine=True (f64 polish)
        # an operand given here is used as it is; else _get_vvvv_op builds
        # it from eris.vvvv, anew when config.ladder_mode changes
        self._vvvv_op = vvvv_op
        self._vvvv_mode = "explicit" if vvvv_op is not None else None
        self._sorted_op = None
        self.nocc, self.nvir = mycc.nocc, mycc.nvir
        fock = mycc.eris.fock
        self.device, self.dtype = fock.device, fock.dtype
        self.diis = diis
        self.maxdiis = get_config().maxdiis if maxdiis is None else maxdiis
        self.mindiis = get_config().mindiis if mindiis is None else mindiis
        self.maxiter = maxiter
        self.conv_thres = conv_thres
        self.energy_term = energy_term
        self.conv = conv

        nocc = self.nocc
        self.mo_perm = None if mo_perm is None else np.asarray(mo_perm)
        self._sinfo = None
        if self.mo_perm is not None:
            po = self.mo_perm[:nocc]
            pv = self.mo_perm[nocc:] - nocc
            idx = lambda a: torch.as_tensor(a, device=self.device)
            self._po, self._pv = idx(po), idx(pv)
            self._io, self._iv = idx(np.argsort(po)), idx(np.argsort(pv))
            self._ip = idx(np.argsort(self.mo_perm))
            # sector sizes of the sorted layout, from the standard
            # alternating [0,1,0,1,...] GHF orbspin the perm was built
            # from: alpha = even original indices
            self._sinfo = spinsect.sector_info(self.mo_perm % 2, nocc)

        self.tsini = self._amp(tsini, (nocc, self.nvir))
        self.lsini = self._amp(lsini, (nocc, self.nvir))
        if tdini is None:
            # MP2 guess, built in the ERIs' layout; public amplitudes are
            # alternating, so a sorted one is unsorted
            diag = torch.diagonal(fock)
            eia = diag[:nocc, None] - diag[None, nocc:]
            eijab = eia[:, None, :, None] + eia[None, :, None, :]
            tdini = mycc.eris.oovv / eijab
            if self.mo_perm is not None:
                tdini = _perm4(tdini, self._io, self._iv)
            ldini = tdini
        self.tdini = self._amp(tdini)
        self.ldini = self._amp(ldini)
        self._eris_sym_checked = None
        self._kept = None     # (key, set-up, weights, loops): _solve

    def _amp(self, a, zeros_shape=None):
        if a is None:
            return torch.zeros(zeros_shape, dtype=self.dtype,
                               device=self.device)
        return _to_tensor(a, self.dtype, self.device)

    # ------------------------------------------------------------------
    # structure gates (host-side, once per solver)
    # ------------------------------------------------------------------
    def _vexp_mats_sorted(self):
        """The GS target and potential matrices in the sorted layout."""
        P = self.mo_perm
        exp = self.myVexp
        mats = []
        for i, n in enumerate(exp.prop_names[0]):
            if n == "mat":
                mats.append(np.asarray(exp.exp_data[0][i][1])[np.ix_(P, P)])
        for v in exp.dic_int.values():
            arr = np.real(np.asarray(v))
            if arr.ndim == 2:
                mats.append(arr[np.ix_(P, P)])
            else:
                mats.extend(a[np.ix_(P, P)]
                            for a in arr.reshape(-1, *arr.shape[-2:]))
        return mats

    def _vexp_block_diagonal(self):
        """True if every GS target / potential matrix is spin-block-diagonal
        in the sorted layout: then the amplitudes keep their spin structure
        and the sector-blocked kernels are exact."""
        return all(
            spinsect.is_block_diagonal(
                m, self._sinfo, tol=1e-10 * max(1.0, float(np.abs(m).max())))
            for m in self._vexp_mats_sorted())

    def _spin_restricted(self):
        """Closed-shell mirror-symmetry gate for the sym kernels: equal
        alpha/beta sector sizes, every target / potential matrix
        spin-restricted, and the ERI blocks and ladder operand numerically
        flip-symmetric (one device check per solver)."""
        info = self._sinfo
        if info.oa != info.ob or info.va != info.vb:
            return False
        if not all(
                spinsect.is_spin_restricted(
                    m, info, tol=1e-10 * max(1.0, float(np.abs(m).max())))
                for m in self._vexp_mats_sorted()):
            return False
        if self._eris_sym_checked is None:
            eris = self.mycc.eris
            eps = float(torch.finfo(self.dtype).eps)
            d = torch.diagonal(eris.fock)
            no, va = info.nocc, info.va
            worst = [(d[:info.oa] - d[info.oa:no]).abs().max(),
                     (d[no:no + va] - d[no + va:]).abs().max()]
            scale = [torch.ones((), dtype=self.dtype, device=self.device)]
            for name in ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovvv",
                         "ovoo", "vovv"):
                blk = getattr(eris, name)
                worst.append(spinsect.spin_flip_asymmetry(blk, name, info))
                scale.append(blk.abs().max())
            vv = self._sectored_vvvv_op()
            if isinstance(vv, SectoredVVVV):
                if vv.wc_aa.shape != vv.wc_bb.shape:
                    self._eris_sym_checked = False
                    return False
                if isinstance(vv.wc_aa, RowShard):
                    worst.append(vv.wc_aa.amax_abs(vv.wc_bb))
                    scale.append(vv.wc_aa.amax_abs())
                else:
                    worst.append((vv.wc_aa - vv.wc_bb).abs().max())
                    scale.append(vv.wc_aa.abs().max())
            worst_v, scale_v = (float(torch.stack(worst).max()),
                                float(torch.stack(scale).max()))
            self._eris_sym_checked = worst_v <= 1e3 * eps * scale_v
        return self._eris_sym_checked

    def _get_vvvv_op(self):
        """The ladder operand: the one given at construction, else
        make_vvvv_op(eris.vvvv) per config.ladder_mode (None for 'dense'),
        rebuilt when the mode changes (JAX gs.py:1054-1067)."""
        if self._vvvv_mode == "explicit":
            return self._vvvv_op
        mode = get_config().ladder_mode
        if self._vvvv_mode != mode:
            self._vvvv_op = make_vvvv_op(self.mycc.eris.vvvv)
            self._vvvv_mode = mode
            self._sorted_op = None
        return self._vvvv_op

    def route(self):
        """'sectored', 'dense_sorted', 'packed' or 'dense': the route the
        next solve takes under the current config (module docstring).  As
        in the JAX loop (gs.py:691-701), the sorted layout's choice rests on
        config.soup_sector and the structure gate alone, whatever the
        ladder operand."""
        if self.mo_perm is not None:
            if get_config().soup_sector and self._vexp_block_diagonal():
                return "sectored"
            return "dense_sorted"
        return ("packed" if isinstance(self._get_vvvv_op(), PackedVVVV)
                else "dense")

    def _sectored_vvvv_op(self):
        """The sectored route's ladder operand: the resolved one, or (dense
        ladder_mode on dense sorted ERIs) eris.vvvv packed into a
        SectoredVVVV once per mode (JAX ladder.py:342)."""
        vv = self._get_vvvv_op()
        if vv is None:
            if self._sorted_op is None:
                self._sorted_op = ensure_sorted_vvvv_op(None, self.mycc.eris,
                                                        self._sinfo)
            vv = self._sorted_op
        return vv

    # ------------------------------------------------------------------
    # the solve
    # ------------------------------------------------------------------
    def SCF(self, L, ts=None, ls=None, td=None, ld=None, alpha=None, diis="",
            keep_device=False, refine=False, refine_iter=6):
        """Solve at constraint weight L.  Returns the reference 6-tuple
        (conv_text, Ep_it, Delta_it, conv_it, rdm1, [ts, ls, td, ld]),
        amplitudes as NumPy arrays (device tensors with keep_device=True).

        On a device mesh (sharded ERIs, ladder operand or amplitudes,
        parallel/sharding.py) the amplitudes given as DTensors are gathered
        on entry, and those kept on the device come back as DTensors in
        amp_shardings' placements.

        refine=True follows the solve with at least `refine_iter` f64
        polish iterations (polish_f64) on the amplitudes' device, recovering
        f64 parity from an f32 or reduced-precision solve (JAX
        gs.py:1070-1130); it needs eris_host at construction.  The returned
        amplitudes and rdm1 are then f64, and the histories gain the
        polish's energy."""
        if refine and self.eris_host is None:
            raise ValueError("refine=True requires eris_host at "
                             "Solver_CCSD construction")
        # the host work around the solve: spans whose ms go to
        # last_solve["driver"] (ECW.CCSD_GS adds its own there)
        driver = {}
        with span("solver.enter", driver, "enter_ms"):
            mesh = self.mesh or sharding.mesh_of(ts, ls, td, ld)
            route = self.route()
            sym = (route == "sectored" and get_config().soup_sym
                   and self._spin_restricted())
            amps0 = [self._amp(a) if a is not None else d for a, d in
                     zip((ts, ls, td, ld),
                         (self.tsini, self.lsini, self.tdini, self.ldini))]
        # wall time to solution: _solve ends in a device->host copy
        solve = {}
        with span("solver.solve", solve, "ms"), torch.no_grad():
            out = self._solve([L], amps0, alpha=alpha,
                              diis=diis or self.diis,
                              sectored=route == "sectored", sym=sym,
                              log=solve)
        with span("solver.exit", driver, "exit_ms"):
            ts, ls, td, ld, rdm1, ite, k, status, hist, legs, loops = out
            ite, k, status = int(ite[0]), int(k[0]), int(status[0])
            Ep_h, Delta_h, vmax_h, conv_h = hist[0]
            self.last_solve = {"L": L, "iterations": k, "status": status,
                               "route": route, "sym": sym,
                               "precision": get_config().iter_precision,
                               "legs": [(m, n[0], d[0]) for m, n, d in legs],
                               "loops": loops, **solve, "driver": driver}
            text = _conv_text(status, L, ite, alpha=alpha, ccsd=True)
            Delta_it = np.stack([Delta_h[:k], vmax_h[:k]], axis=1)
            amps = [ts[0], ls[0], td[0], ld[0]]
            rdm1 = rdm1[0].cpu().numpy()
            if refine:
                with span("solver.refine", self.last_solve, "refine_ms"):
                    amps, Ep64, rdm1, n_pol = polish_f64(
                        self._polish_eris(), self.myVexp, L, amps,
                        n_iter=refine_iter, alpha=alpha,
                        energy_term=self.energy_term)
                self.last_solve["refine_iterations"] = n_pol
                Ep_h = np.concatenate([Ep_h[:k], [Ep64]])
                conv_h = np.concatenate([conv_h[:k], [conv_h[k - 1]]])
                Delta_it = np.concatenate([Delta_it, Delta_it[-1:]], axis=0)
                k += 1
            if not keep_device:
                amps = [a.cpu().numpy() for a in amps]
            elif mesh is not None:
                sh = sharding.amp_shardings(mesh)
                amps = [sharding.shard_tensor(a, mesh, sh[n])
                        for a, n in zip(amps, ("t1", "l1", "t2", "l2"))]
            self.myVexp.Vexp_update(rdm1, rdm1, (0, 0), L=L)
            _record_metrics(self, "CCSD_device", L, Ep_h[:k], Delta_it,
                            conv_h[:k])
        return (text, Ep_h[:k], Delta_it, conv_h[:k], rdm1, amps)

    def release_graphs(self):
        """Free the set-up and the captured loops (their graphs, pools and
        static state) that SCF and SCF_batch keep for the next call with
        the same arguments; ECW.CCSD_GS calls it after its sweep."""
        self._kept = None

    def _polish_eris(self):
        """eris_host as f64 tensors on the solve's device, moved once per
        solver (JAX uploads them per polish)."""
        if getattr(self, "_eris64", None) is None:
            er = self.eris_host
            self._eris64 = er._replace(
                **{f: sharding.replicate(getattr(er, f)).to(
                    self.device, torch.float64) for f in er._fields})
        return self._eris64

    def _bf16_operands(self, eris, vv, sectored, sym):
        """The 'bf16' mode's update operands, built once per set-up (JAX
        gs.py:922-936): every ERI block but fock and the ladder operand in
        bf16, and on the sectored route their blocked views; fock stays in
        the loop's dtype, so the denominators divide there."""
        bf = torch.bfloat16
        eris_bf = eris._replace(**{f: getattr(eris, f).to(bf)
                                   for f in eris._fields if f != "fock"})
        vv_bf = None if vv is None else vv.to(bf)
        sb_bf = (ccsd_sect.wrap_eris(eris_bf, self._sinfo, sym=sym)
                 if sectored else None)
        return eris_bf, vv_bf, sb_bf

    SCF_device = SCF    # the JAX name of the device loop

    def SCF_batch(self, Larray, alpha=None, diis=""):
        """Solve every lambda of Larray at once (JAX gs.py:1131-1179): one
        lane per lambda, each a cold start from tsini/lsini/tdini/ldini
        (no warm start from the previous lambda, which is sequential by
        nature), all lanes through one iteration step under
        torch.func.vmap, so that each ladder product is one launch with the
        lanes stacked into its rows.  A lane freezes where its cold-start
        SCF would stop; the loop ends when none is left, reading one
        scalar per iteration.  Returns a list of per-lambda results in
        SCF's format (amplitudes as NumPy arrays).  No refine: as in the
        JAX package, the batched solve has no f64 polish."""
        route = self.route()
        sym = (route == "sectored" and get_config().soup_sym
               and self._spin_restricted())
        n0 = ladder_mm.launches
        solve = {}
        with span("solver.solve", solve, "ms"), torch.no_grad():
            out = self._solve(list(Larray),
                              (self.tsini, self.lsini, self.tdini,
                               self.ldini),
                              alpha=alpha, diis=diis or self.diis,
                              sectored=route == "sectored", sym=sym,
                              log=solve)
        ts, ls, td, ld, rdm1 = (a.cpu().numpy() for a in out[:5])
        ite, k, status, hist, legs, loops = out[5:]
        self.last_solve = {"L": list(Larray), "lanes": len(Larray),
                           "iterations": k.tolist(),
                           "status": status.tolist(), "route": route,
                           "sym": sym,
                           "precision": get_config().iter_precision,
                           "legs": legs, "loops": loops, **solve,
                           "ladder_launches": ladder_mm.launches - n0}
        results = []
        for i, L in enumerate(Larray):
            n = int(k[i])
            Delta_it = np.stack([hist[i, 1, :n], hist[i, 2, :n]], axis=1)
            results.append((
                _conv_text(int(status[i]), L, int(ite[i]), alpha=alpha,
                           ccsd=True),
                hist[i, 0, :n], Delta_it, hist[i, 3, :n], rdm1[i],
                [ts[i], ls[i], td[i], ld[i]]))
        # the host Vexp state reflects the last lambda, as after a sweep
        self.myVexp.Vexp_update(rdm1[-1], rdm1[-1], (0, 0), L=Larray[-1])
        return results

    def _setup(self, diis, sectored, sym, lanes, alpha):
        """What an SCF or SCF_batch call builds once: the ladder operand,
        the packed-space maps of the route, the legs of the precision mode
        and their update operands, the Vexp update, the DIIS vector size;
        on the f32 sectored route of one lane, the updates' SoupPlan (its
        ERI operands laid out for the step's products).  The lanes of
        SCF_batch run under vmap, which the plan leaves to sector_einsum.
        An f64 sectored solve is the route's check against the JAX
        package on the host (the card's f64 solves take the alternating
        layout): it keeps sector_einsum's order of summation, which an
        rdm1-DIIS trajectory amplifies from 1e-16 to 1e-9 within 15
        iterations."""
        eris = self.mycc.eris
        vv = self._sectored_vvvv_op() if sectored else self._get_vvvv_op()
        info = self._sinfo
        nocc, nvir = self.nocc, self.nvir
        dt, thres = self.dtype, self.conv_thres
        if sectored:
            # packed balanced-block space (canonical blocks when sym): the
            # amplitudes live entirely there, so packing is lossless
            p_ov = lambda a: spinsect.pack_balanced(a, "ov", info, sym=sym)
            p_4 = lambda a: spinsect.pack_balanced(a, "oovv", info, sym=sym)
            u_ov = lambda f: spinsect.unpack_balanced(f, "ov", info, sym=sym)
            u_4 = lambda f: spinsect.unpack_balanced(f, "oovv", info,
                                                     sym=sym)
            n_ov = spinsect.packed_size("ov", info, sym=sym)
            n_4 = spinsect.packed_size("oovv", info, sym=sym)
        else:
            p_ov = p_4 = lambda a: a.reshape(-1)
            u_ov = lambda f: f.reshape(nocc, nvir)
            u_4 = lambda f: f.reshape(nocc, nocc, nvir, nvir)
            n_ov, n_4 = nocc * nvir, nocc * nocc * nvir * nvir
        # the legs of the solve: (precision mode, Dconv it runs down to)
        prec = get_config().iter_precision
        if prec == "hybrid":
            legs = [(get_config().hybrid_fast,
                     max(thres, get_config().hybrid_switch)),
                    ("highest", thres)]
        else:
            legs = [(prec, thres)]
        upd_bf = (self._bf16_operands(eris, vv, sectored, sym)
                  if any(mode == "bf16" for mode, _ in legs) else None)
        # the TF32 modes' ladder operand, rounded into TMA-ready rows once
        # per set-up, which the captured loops keep alive with the TMA
        # descriptors that hold its address (the dense route's vvvv view
        # is rounded by the kernel instead: it is never copied)
        vv_tf = (vv.to("tf32") if vv is not None and dt == torch.float32
                 and any(m in TF32_MODES for m, _ in legs) else vv)
        dim = nocc + nvir
        eris_sb = (ccsd_sect.wrap_eris(eris, info, sym=sym) if sectored
                   else None)
        plan = None
        if (sectored and lanes == 1 and dt == torch.float32
                and any(m != "bf16" for m, _ in legs)):
            with span("solver.soup_plan"):
                plan = ccsd_sect.SoupPlan(eris, eris_sb, info, sym,
                                          alpha=alpha)
        return types.SimpleNamespace(
            eris=eris, vv=vv, vv_tf=vv_tf, upd_bf=upd_bf, info=info,
            sectored=sectored, sym=sym, legs=legs, diis=diis,
            p_ov=p_ov, p_4=p_4, u_ov=u_ov, u_4=u_4, n_ov=n_ov, n_4=n_4,
            nvec=(2 * n_ov + 2 * n_4) if diis == "tl" else dim * dim,
            eris_sb=eris_sb, plan=plan,
            vexp_fn=make_gs_vexp_device(self.myVexp, perm=self.mo_perm,
                                        dtype=dt, device=self.device))

    def _fresh_diis(self, su, lanes, reset=False):
        return (diis_ops.diis_init(su.nvec, self.maxdiis, dtype=self.dtype,
                                   device=self.device, lanes=lanes,
                                   reset=reset)
                if su.diis else None)

    def _make_step(self, su, mode, alpha):
        """One iteration of the leg at precision `mode`, as a function

            step(amps, ring_t, conv, Lw) ->
                (amps, ring_t, conv, rdm1, Ep, Delta, vmax,
                 |conv - conv_old|)

        of one lane's amplitudes (ts, ls, td, ld), DIIS ring (the fields of
        a DIISState, in order; () without DIIS), convergence vector and
        Vexp weights (a device tensor, one per property).
        The ERIs, the ladder operand and the leg's update operands are
        closed over: _solve calls the step directly on one lane, and
        through torch.func.vmap over a leading lambda axis of every
        argument on several (but the ring's SHARED_FIELDS, which the lanes
        share), so that each ladder product stacks the lanes into its
        rows and launches once."""
        su_eris, info, sectored, sym = su.eris, su.info, su.sectored, su.sym
        diis, dim, dt = su.diis, self.nocc + self.nvir, self.dtype
        # the step closes over no reference to the solver: a solver that
        # keeps its captured loops is then freed as soon as it is dropped
        # (a cycle would leave the graphs to the garbage collector, which
        # may run in the middle of another loop's capture)
        conv_kind, mindiis = self.conv, self.mindiis
        energy_term = self.energy_term
        n_ov, n_4 = su.n_ov, su.n_4
        p_ov, p_4, u_ov, u_4 = su.p_ov, su.p_4, su.u_ov, su.u_4
        # the bf16 leg's update operands; rdm1, Vexp, the energy, DIIS and
        # the convergence test stay in dt
        er_u, vv_u, sb_u = (
            su.upd_bf if mode == "bf16" else
            (su_eris, su.vv_tf if mode in TF32_MODES else su.vv, su.eris_sb))
        plan = su.plan if mode != "bf16" else None
        cast = ((lambda x: x) if mode != "bf16"
                else (lambda x: x.to(torch.bfloat16)))

        def diis_step(ring_t, x):
            st, vec = diis_ops.diis_update(diis_ops.DIISState(*ring_t), x,
                                           mindiis)
            return tuple(st), vec

        def step(amps, ring_t, conv, Lw):
            ts, ls, td, ld = amps
            conv_old = conv
            rdm1 = ccsd_ops.gamma_CCSD(
                ts, td, ls, ld,
                inter=(ccsd_sect.gamma_inter_sect(ts, td, ls, ld, info,
                                                  sym=sym, plan=plan)
                       if sectored else None))
            if diis == "rdm1":
                ring_t, vec = diis_step(ring_t, rdm1.reshape(-1))
                rdm1 = vec.reshape(dim, dim)
            V, Delta, vmax = su.vexp_fn(rdm1, Lw)
            fsp = su_eris.fock - V
            Ep = ccsd_ops.energy(su_eris, ts, td, fsp)
            ts_u, td_u, ls_u, ld_u, fsp_u = (
                cast(x) for x in (ts, td, ls, ld, fsp))
            # both vvvv ladders read only pre-update amplitudes (tau on the
            # t side, l2 on the lambda side): one stacked GEMM per operand
            # block, so each block is read once per iteration
            ladder_t = ladder_l = tau_pre = None
            if isinstance(vv_u, PackedVVVV):
                ladder_t, ladder_l = stacked_packed_contract(
                    vv_u, ccsd_ops.make_tau(td_u, ts_u, ts_u), ld_u)
            elif isinstance(vv_u, SectoredVVVV):
                if sectored:
                    # balanced rows (mirror skip when sym); the blocked tau
                    # is shared with tupdate_sect
                    tau_pre = ccsd_sect._tau_b(
                        spinsect.wrap(td_u, "oovv", info, sym=sym),
                        spinsect.wrap(ts_u, "ov", info, sym=sym))
                    ladder_t, ladder_l = balanced_stacked_sectored_contract(
                        vv_u, tau_pre, ld_u, info.oa, sym=sym,
                        blocked_info=info)
                else:
                    ladder_t, ladder_l = stacked_sectored_contract(
                        vv_u, ccsd_ops.make_tau(td_u, ts_u, ts_u), ld_u)
            if sectored:
                ts, td = ccsd_sect.tupdate_sect(
                    er_u, ts_u, td_u, fsp_u, info, alpha=alpha,
                    vvvv_op=vv_u, ladder_pre=ladder_t, eris_sb=sb_u,
                    sym=sym, tau_pre=tau_pre, plan=plan)
                ls, ld = ccsd_sect.lupdate_sect(
                    er_u, cast(ts), cast(td), ls_u, ld_u, fsp_u, info,
                    alpha=alpha, energy_term=energy_term,
                    vvvv_op=vv_u, ladder_pre=ladder_l, eris_sb=sb_u,
                    sym=sym, plan=plan)
            else:
                ts, td = ccsd_ops.tupdate(
                    er_u, ts_u, td_u, fsp=fsp_u, alpha=alpha,
                    vvvv_op=vv_u, ladder_pre=ladder_t)
                # the f32 denominators promoted ts/td back: the lambda
                # update reads them in bf16 again
                ls, ld = ccsd_ops.lupdate(
                    er_u, cast(ts), cast(td), ls_u, ld_u, fsp=fsp_u,
                    alpha=alpha, energy_term=energy_term,
                    vvvv_op=vv_u, ladder_pre=ladder_l)
            ts, td, ls, ld = (x.to(dt) for x in (ts, td, ls, ld))
            vec = None
            if diis == "tl":
                ring_t, vec = diis_step(
                    ring_t, torch.cat([p_ov(ls), p_ov(ts), p_4(ld),
                                       p_4(td)]))
                ls = u_ov(vec[:n_ov])
                ts = u_ov(vec[n_ov:2 * n_ov])
                ld = u_4(vec[2 * n_ov:2 * n_ov + n_4])
                td = u_4(vec[2 * n_ov + n_4:])
            if vec is not None and conv_kind == "tl":
                # the DIIS vector already holds the components conv_vec
                # would gather
                conv = torch.cat([
                    vec[:n_ov].abs() + vec[n_ov:2 * n_ov].abs(),
                    vec[2 * n_ov:2 * n_ov + n_4].abs()
                    + vec[2 * n_ov + n_4:].abs()])
            else:
                conv = _ccsd_conv_vec(conv_kind, su, ts, ls, td, ld, fsp)
            return ((ts, ls, td, ld), ring_t, conv, rdm1, Ep, Delta, vmax,
                    torch.linalg.norm(conv - conv_old))

        return step

    def _sort_in(self, ts, ls, td, ld):
        """Public (alternating) amplitudes into the ERIs' layout: one sort
        on entry."""
        if self.mo_perm is None:
            return ts, ls, td, ld
        po, pv = self._po, self._pv
        return (_perm2(ts, po, pv), _perm2(ls, po, pv), _perm4(td, po, pv),
                _perm4(ld, po, pv))

    def _sort_out(self, ts, ls, td, ld, rdm1):
        """... and back to the public layout: one unsort on exit."""
        if self.mo_perm is None:
            return ts, ls, td, ld, rdm1
        io, iv, ip = self._io, self._iv, self._ip
        return (_perm2(ts, io, iv), _perm2(ls, io, iv), _perm4(td, io, iv),
                _perm4(ld, io, iv), rdm1[ip][:, ip])

    def _solve(self, Ls, amps0, alpha, diis, sectored, sym, log=None):
        """The loop of SCF (one lane) and SCF_batch (one lane per lambda of
        Ls), every lane started from amps0 = (ts, ls, td, ld) (public
        layout).  The state of every lane lives on the device; one lane
        calls the step directly, several call it through torch.func.vmap,
        so that each ladder product stacks the lanes into its rows.  A
        lane is active while its solve would still iterate; an inactive
        lane keeps its amplitudes, convergence vector, Dconv, status,
        counters and rdm1 (torch.where), and the loop ends when no lane is
        active.  Each leg is one device_loop.Loop over `body`, whose every
        decision is a tensor (JAX body_impl/body_fast, gs.py:772-1019):
        on the card the leg replays a captured graph and reads one flag
        per iteration, whether any lane is still active.  Returns the
        per-lane amplitudes and rdm1 (device tensors with a leading lane
        axis), iterations, steps, status and hist (NumPy; hist: (lanes, 4,
        maxiter + 2)), the legs' log [(mode, steps, Dconv) per lane] and
        the loops' logs (one per leg).  The set-up and the legs' loops are
        kept for the next call with the same arguments (release_graphs).

        log: a dict that receives the ms of the host work around the legs,
        each a span: 'setup_ms' (_setup, where the kept set-up is rebuilt),
        'lanes_ms' (the lanes' state and, per leg, its DIIS ring and step)
        and 'finish_ms' (the copies, the unsort and the host reads); the
        legs are 'solver.leg' spans."""
        log = {} if log is None else log
        dev, dt, f64 = self.device, self.dtype, torch.float64
        thres, maxiter = self.conv_thres, self.maxiter
        nL = len(Ls)
        with span("solver.lanes", log, "lanes_ms"):
            Lw_host = torch.tensor([self.myVexp.L_check(L)[0] for L in Ls],
                                   dtype=dt)
            # the set-up and the legs' loops are kept for the next call
            # with the same arguments and config (the lambdas of a sweep):
            # its loops start replaying at once.  The weights are a device
            # tensor the kept bodies read, refilled per call
            key = (nL, alpha, diis, sectored, sym,
                   dataclasses.astuple(get_config()), self.conv,
                   self.conv_thres, self.maxiter, self.mindiis,
                   self.maxdiis, self.energy_term, tuple(Lw_host.shape))
        if self._kept is None or self._kept[0] != key:
            with span("solver.setup", log, "setup_ms"):
                self.release_graphs()
                su = self._setup(diis, sectored, sym, nL, alpha)
                self._kept = (key, su,
                              torch.empty_like(Lw_host, device=dev),
                              [None] * len(su.legs))
        with span("solver.lanes", log, "lanes_ms"):
            _, su, Lw_t, loops = self._kept
            if su.plan is not None:
                log["soup"] = dict(su.plan.counts)
            Lw_t.copy_(Lw_host)
            Lw = Lw_t[0] if nL == 1 else Lw_t
            amps0 = self._sort_in(*amps0)
            # one materialized copy per lane
            amps = tuple(a.unsqueeze(0).repeat(nL, *(1,) * a.dim())
                         for a in amps0)
            conv0 = _ccsd_conv_vec(self.conv, su, *amps0, su.eris.fock)
            conv = conv0.new_zeros((nL,) + conv0.shape)
            hist = torch.zeros((nL, 4, maxiter + 2), dtype=dt, device=dev)
            # the lane controls: Dconv (compared in f64, as the host float
            # the threshold is), iterations, steps, status
            Dconv = torch.ones(nL, dtype=f64, device=dev)
            ite = torch.zeros(nL, dtype=torch.int64, device=dev)
            k = torch.zeros_like(ite)
            status = torch.full_like(ite, RUNNING)
            rdm1 = torch.zeros((nL,) + (self.nocc + self.nvir,) * 2,
                               dtype=dt, device=dev)
        # a single lane steps only while it is active: nothing to keep
        keep = ((lambda act, new, old: new) if nL == 1 else
                lambda act, new, old: torch.where(
                    act.view((-1,) + (1,) * (new.dim() - 1)), new, old))
        leg_log, loop_log = [], []
        for leg, (mode, stop) in enumerate(su.legs):
            with span("solver.lanes", log, "lanes_ms"):
                # a fresh DIIS ring per leg: the 'highest' leg of 'hybrid' (JAX
                # gs.py:1019-1035) must not extrapolate over the fast leg's
                # noisy differences, which poison the subspace.  The ring is
                # not frozen with the lanes: a finished lane never reads it
                # again, and the freeze's copy of the history (~1.3 GB per
                # iteration at cc-pVTZ, as the JAX package notes) would cost
                # more than the step it guards
                # (a kept loop's ring is emptied by copies of broadcast zeros:
                # a fresh one would cost the history's size again)
                ring = self._fresh_diis(
                    su, lanes=nL,
                    reset=loops[leg] is not None and loops[leg].captured)
                ring = tuple(ring) if ring is not None else ()
                ring_dims = ((0,) * len(diis_ops.LANE_FIELDS)
                             + (None,) * len(diis_ops.SHARED_FIELDS)
                             if ring else 0)
                if leg:
                    # at least one full-precision iteration per running lane
                    Dconv = torch.where(status == RUNNING,
                                        Dconv.clamp(min=1.5 * thres), Dconv)
                step = self._make_step(su, mode, alpha)
                step = (torch.func.vmap(
                    step, in_dims=(0, ring_dims, 0, 0),
                    out_dims=(0, ring_dims, 0, 0, 0, 0, 0, 0))
                    if nL > 1 else _one_lane(step, ring_dims))
                # the fast leg of 'hybrid' also ends when Dconv stalls: 3
                # iterations without a new best below 0.95 * best
                stall_on = len(su.legs) > 1 and leg == 0
                dmin = torch.full((nL,), float("inf"), dtype=f64, device=dev)
                stall = torch.zeros_like(ite)
                k0 = k.clone()
                nr = len(ring)

            def active_of(Dconv, status, stall, stop=stop,
                          stall_on=stall_on):
                act = (Dconv > stop) & (status == RUNNING)
                return act & (stall < 3) if stall_on else act

            def body(state, step=step, nr=nr, stall_on=stall_on,
                     active_of=active_of):
                (_, ts, ls, td, ld, *rest) = state
                ring_t, rest = tuple(rest[:nr]), rest[nr:]
                conv, rdm1, Dconv, ite, k, status, hist, stall, dmin = rest
                amps = (ts, ls, td, ld)
                active = active_of(Dconv, status, stall)
                (new_amps, ring_t, conv_n, rdm1_n, Ep, Delta, vmax,
                 dnorm) = step(amps, ring_t, conv, Lw)
                amps = tuple(keep(active, a, b)
                             for a, b in zip(new_amps, amps))
                conv = keep(active, conv_n, conv)
                rdm1 = keep(active, rdm1_n, rdm1)
                Dconv = torch.where(ite > 0,
                                    keep(active, dnorm.to(f64), Dconv),
                                    Dconv)
                # column k of every lane: an inactive lane's k is one past
                # its history, which is read only up to k
                col = torch.stack([Ep, Delta, vmax, Dconv.to(dt)], dim=1)
                hist.scatter_(2, k.view(nL, 1, 1).expand(nL, 4, 1),
                              col[:, :, None])
                status = keep(active, torch.where(
                    ite >= maxiter, MAXITER,
                    torch.where(Dconv > 1.0, DIVERGED, status)), status)
                ite = keep(active, torch.where(status == RUNNING, ite + 1,
                                               ite), ite)
                k = keep(active, k + 1, k)
                if stall_on:
                    # (the first iteration's Dconv is a placeholder)
                    upd = active & (ite > 1)
                    stall = torch.where(
                        upd, torch.where(Dconv < 0.95 * dmin, 0,
                                         stall + 1), stall)
                    dmin = torch.where(upd, torch.minimum(dmin, Dconv),
                                       dmin)
                go = active_of(Dconv, status, stall).any()
                return (go, *amps, *ring_t, conv, rdm1, Dconv, ite, k,
                        status, hist, stall, dmin)

            go = active_of(Dconv, status, stall).any()
            if loops[leg] is None:
                loops[leg] = device_loop.Loop(body, mode=mode)
            with span("solver.leg"):
                lp = {}
                state = loops[leg](
                    (go, *amps, *ring, conv, rdm1, Dconv, ite, k, status,
                     hist, stall, dmin), lp)
                amps, rest = tuple(state[1:5]), state[5 + nr:]
                conv, rdm1, Dconv, ite, k, status, hist = rest[:7]
                del state, rest
                loop_log.append(lp)
                leg_log.append((mode, (k - k0).tolist(), Dconv.tolist()))
        with span("solver.finish", log, "finish_ms"):
            status = torch.where(status == RUNNING, CONVERGED, status)
            # copies: the kept loops' static state is overwritten by the
            # next call
            amps, rdm1 = tuple(a.clone() for a in amps), rdm1.clone()
            ts, ls, td, ld, rdm1 = torch.func.vmap(self._sort_out)(*amps,
                                                                   rdm1)
            return (ts, ls, td, ld, rdm1, ite.cpu().numpy(),
                    k.cpu().numpy(), status.cpu().numpy(),
                    hist.cpu().numpy(), leg_log, loop_log)


def _ccsd_conv_vec(conv, su, ts, ls, td, ld, fsp):
    """The convergence vector of Solver_CCSD(conv=conv) on set-up su."""
    if conv == "tl":
        return torch.cat([su.p_ov(ls.abs() + ts.abs()),
                          su.p_4(ld.abs() + td.abs())])
    if conv == "l":
        return torch.cat([su.p_ov(ls), su.p_4(ld)])
    return ccsd_ops.energy(su.eris, ts, td, fsp).reshape(1)


def _one_lane(step, ring_dims):
    """The step over lane-stacked state of one lane, called directly (no
    vmap): the lane axis taken off the tensors it is given and put back on
    those it returns (but the ring's fields that ring_dims marks None,
    which have none)."""
    def lane(amps, ring_t, conv, Lw):
        dims = ring_dims if ring_t else ()
        out = step(tuple(a[0] for a in amps),
                   tuple(r if d is None else r[0]
                         for r, d in zip(ring_t, dims)),
                   conv[0], Lw)
        amps, ring_t, rest = out[0], out[1], out[2:]
        return ((tuple(x.unsqueeze(0) for x in amps),
                 tuple(r if d is None else r.unsqueeze(0)
                       for r, d in zip(ring_t, dims)))
                + tuple(o.unsqueeze(0) for o in rest))
    return lane


# ---------------------------------------------------------------------------
# Mixed precision: a reduced-precision solve, then an f64 polish
# ---------------------------------------------------------------------------

POLISH_TOL = 1e-10      # Ha: the polish stops once Ep moves less than this
POLISH_MAX = 5          # ... or after this many times refine_iter iterations


def polish_f64(eris64, VXexp, L, amps, n_iter=6, alpha=None,
               energy_term="ref"):
    """Refine converged ECW-CCSD amplitudes with f64 iterations (JAX
    gs.py:1183-1233): the dense ops/ccsd.py updates, the ladder the f64
    kernel's dense GEMM, and the host Vexp refreshed from each rdm1.  The
    JAX package runs it on the CPU because the TPU has no f64; here it
    runs on the device of `eris64` (f64 tensors in the alternating layout,
    ECW.eris_f64), the card's FP64 tensor cores included.

    The JAX package runs `n_iter` iterations.  Here those are the least:
    the polish goes on until Ep moves by less than POLISH_TOL between two
    iterations, at most POLISH_MAX * n_iter.  The iteration halves the
    error each time, and a TF32 solve's fixed point lies 1e-5 Ha from the
    f64 one where the TPU's three-pass 'high' stayed near 1e-6: six
    iterations left 2.9e-7 Ha (measured on an H100, C2H2/cc-pVDZ).

    amps: (ts, ls, td, ld) of the solve (tensors or arrays).  Returns
    ([ts, ls, td, ld] as f64 tensors, the last iteration's Ep, the final
    rdm1 as an f64 NumPy array, the iterations run)."""
    dev, f64 = eris64.fock.device, torch.float64
    ts, ls, td, ld = (_to_tensor(a, f64, dev) for a in amps)
    Ep = None
    with torch.no_grad(), matmul_precision("highest"):
        for it in range(1, POLISH_MAX * n_iter + 1):
            rdm1 = ccsd_ops.gamma_CCSD(ts, td, ls, ld).cpu().numpy()
            VXexp.Vexp_update(rdm1, rdm1, (0, 0), L=L)
            fsp = eris64.fock - _to_tensor(VXexp.Vexp[0, 0], f64, dev)
            Ep, Ep_old = float(ccsd_ops.energy(eris64, ts, td, fsp)), Ep
            ts, td = ccsd_ops.tupdate(eris64, ts, td, fsp=fsp, alpha=alpha)
            ls, ld = ccsd_ops.lupdate(eris64, ts, td, ls, ld, fsp=fsp,
                                      alpha=alpha, energy_term=energy_term)
            if it >= n_iter and abs(Ep - Ep_old) < POLISH_TOL:
                break
        rdm1 = ccsd_ops.gamma_CCSD(ts, td, ls, ld).cpu().numpy()
    return [ts, ls, td, ld], Ep, rdm1, it
