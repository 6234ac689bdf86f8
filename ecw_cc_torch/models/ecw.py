"""User API / driver: the ECW class (port of ecw_cc_tpu/models/ecw.py;
reference Main.py class ECW).

Builds the molecule and RHF -> GHF, then the device ERIs by the JAX
driver's rule (ecw_cc_tpu/models/ecw.py:74-112):

  - f32, ladder_mode resolving to 'packed' (nvir >= 48 under 'auto'): the
    device transform with the ladder packed on build.  With
    config.spin_sorted (the default) the MO layout is spin-sorted
    (ops/ladder.spin_sort_perm, kept as self.mo_perm) and the operand is
    the block-diagonal SectoredVVVV: the solve takes the sectored route
    (the mirror-symmetric sector GEMMs, two ladder launches per
    iteration), or 'dense_sorted' where a target couples the spins.
    With spin_sorted=False the layout is the alternating one with a
    PackedVVVV (the packed route, one launch per iteration);
  - f32, 'dense': the dense device transform, alternating;
  - f64 (the parity mode): the host f64 ErisHost, uploaded, alternating;
    the solver derives its ladder operand per ladder_mode.

Everything public stays in the reference alternating convention whatever
the layout: fock, amplitudes, rdm1s, cube files and checkpoints
(Solver_CCSD(mo_perm=...) sorts on entry and unsorts on exit).  The CCS
and ES solvers take an alternating view of sorted ERIs (_eris_alt).

Then it builds ground-state targets (HF, CCSD or CCSD(T), solved on the
same device at the same precision) and runs the warm-started ECW-CCSD or
ECW-CCS lambda sweep; or excited-state targets (MOM delta-SCF, or given
property values) and the coupled multi-state ECW-CCS solve (CCS_ES).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ecw_cc_torch.config import check_device, get_config, torch_dtype
from ecw_cc_torch.models import gamma_exp
from ecw_cc_torch.models.eris import (build_eris, build_eris_device,
                                      permute_geris)
from ecw_cc_torch.models.molecule import Molecule
from ecw_cc_torch.models.scf import GHF, RHF
from ecw_cc_torch.ops.ccs import Gccs, ccs_gradient
from ecw_cc_torch.ops.ccsd import GCC
from ecw_cc_torch.ops.ladder import resolve_mode, spin_sort_perm
from ecw_cc_torch.ops.vexp import Exp
from ecw_cc_torch.solvers.es import Solver_ES, SolverES_Device
from ecw_cc_torch.solvers.gs import Solver_CCS, Solver_CCSD
from ecw_cc_torch.utils import (checkpoint, convert, linalg, metrics, output,
                                props)

format_float = "{:10.5e}"


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


class ECW:
    def __init__(self, molecule, basis, int_thresh=1e-13, out_dir=None,
                 U_format=False, spin=0, *, device="cuda", dtype=None):
        """Molecule, RHF -> GHF, and the device ERIs on `device` in `dtype`
        (torch dtype or name; None = config.dtype) by the route of the
        module docstring.  Reference Main.py:34-253.  `self.timings` gets
        the host-clock seconds of the set-up: 'integrals_scf', and at f32
        'x_half_s' and 'device_s' of the device transform."""
        self.device = check_device(device)
        self.dtype = torch_dtype(dtype)
        self.myccs = None
        self.myccsd = None
        if U_format:
            raise NotImplementedError("UHF reference implies different orbspin")
        t0 = time.perf_counter()
        mol = Molecule(molecule, basis, charge=0, spin=spin)
        self.molecule = molecule
        self.mol = mol

        mf = RHF(mol, conv_tol=1e-11)
        mf.kernel()
        ghf = GHF(mf)
        self.mf = ghf
        self.mo_coeff = ghf.mo_coeff
        self.mo_occ = ghf.mo_occ
        self.nocc = int(np.sum(ghf.mo_occ > 0))
        self.nvir = int(np.sum(ghf.mo_occ == 0))
        self.EHF = ghf.e_tot
        self.timings = {"integrals_scf": time.perf_counter() - t0}
        self.dim = self.nocc + self.nvir
        self.aosize = mol.nao
        self.rdm1_hf = ghf.make_rdm1()

        self.HF_prop = [[]]
        self.Ek_HF_GS = props.Ekin(mol, self.rdm1_hf, aobasis=True, g=True,
                                   mo_coeff=self.mo_coeff)
        self.v1e_HF_GS = props.v1e(mol, self.rdm1_hf, aobasis=True, g=True,
                                   mo_coeff=self.mo_coeff)
        self.dip_HF_GS = props.dipole(mol, self.rdm1_hf, aobasis=True, g=True,
                                      mo_coeff=self.mo_coeff)

        self.out_dir = out_dir
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            rdm1_r = convert.convert_g_to_ru_rdm1(self.rdm1_hf)[0]
            output.cube_density(mol, os.path.join(out_dir, "HF.cube"), rdm1_r)

        # device ERIs by the rule of the module docstring.  f32: the MO
        # transform runs on the device and no host G-format ERIs are built;
        # f64: the host f64 ERIs, the parity mode.  The host ERIs stay
        # available lazily.
        self._int_thresh = int_thresh
        self._eris_host = None
        self._eris_f64 = None
        self._eris_alt_cache = None
        self.vvvv_op = None
        self.mo_perm = None          # the alternating layout: no permutation
        if self.dtype == torch.float32:
            build = dict(dtype=self.dtype, device=self.device,
                         timings=self.timings)
            if resolve_mode(self.nvir) == "packed":
                sort = bool(get_config().spin_sorted)
                self.eris, self.vvvv_op = build_eris_device(
                    mol, ghf, pack_ladder=True, sort_spin=sort, **build)
                if sort:
                    self.mo_perm = spin_sort_perm(ghf.orbspin, self.nocc)
            else:
                self.eris = build_eris_device(mol, ghf, **build)
        else:
            self.eris = self.eris_host.to_device(dtype=self.dtype,
                                                 device=self.device)
        # fock in the reference (alternating) convention, as every public
        # quantity; only the device ERIs and the solver's state are sorted
        fock = _host(self.eris.fock).astype(np.float64)
        if self.mo_perm is not None:
            ip = np.argsort(self.mo_perm)
            fock = fock[np.ix_(ip, ip)]
        self.fock = fock

        self.target_rdm1_GS = None
        self.cal_rdm1_Delta = False
        self.exp_data = [[]]
        self.r_ini = None
        self.Ek_exp_GS = None
        self.nbr_ES = 0
        self.Delta_rdm1 = None
        self.Eexp_GS = None
        self.Eexp_ES = []
        self.method = "scf"
        self.diis = ""
        self.Larray = []
        self.Delta_lamb = []
        self.Ep_lamb = []
        self.vmax_lamb = []
        self.Delta_Ek = []
        self.solve_log = []
        print("*** Molecule build ***")

    @property
    def eris_host(self):
        """Host f64 ERI container in the alternating layout (built lazily:
        the f32 route transforms on the device instead)."""
        if self._eris_host is None:
            self._eris_host = build_eris(self.mol, self.mf,
                                         int_thresh=self._int_thresh)
        return self._eris_host

    @property
    def eris_f64(self):
        """f64 ERIs in the alternating layout with the dense vvvv, on the
        ECW's device: the operands of refine=True's polish.  The ECW's own at
        f64; at f32 transformed on the device once, at first use
        (build_eris_device), and never through the host ERIs."""
        if self.dtype == torch.float64:
            return self.eris
        if self._eris_f64 is None:
            self._eris_f64 = build_eris_device(
                self.mol, self.mf, dtype=torch.float64, device=self.device)
        return self._eris_f64

    def init_plot_var(self, Larray):
        self.Larray = Larray
        self.Delta_lamb = []
        self.Ep_lamb = []
        self.vmax_lamb = []
        self.Delta_Ek = []
        self.solve_log = []   # the solver's last_solve of each lambda

    # ------------------------------------------------------------------
    # Target construction (reference Main.py:267-398)
    # ------------------------------------------------------------------

    @metrics.job()
    def Build_GS_exp(self, prop="mat", posthf="HF", field=None,
                     para_factor=None, max_def=None, basis=None):
        """Build GS target data.  Reference Main.py:267-398.

        self.target_log: the build's Gexp.log (the seconds of its stages)
        with 'init_s' (the Gexp construction), 'target_store_s' (the
        target's conversion into this ECW's MO basis) and 'spans', the
        rows of the build's job (utils/metrics.py)."""
        if basis is not None and "mat" in prop and self.mol.basis_name != basis:
            print("WARNING: rdm1 comparison requires identical bases; using "
                  f"{self.mol.basis_name} for the target rdm1")
            basis = None
        if "mat" in prop and max_def is not None:
            print("WARNING: rdm1 comparison requires the same geometry")
            max_def = None

        init = {}
        with metrics.span("ecw.target.init", init, "init_s"):
            gexp = gamma_exp.Gexp(self.mol, posthf, basis=basis,
                                  device=self.device, dtype=self.dtype)
        if max_def is not None:
            gexp.deform(max_def)
        if field is not None:
            if not isinstance(field, (list, tuple, np.ndarray)):
                raise SyntaxError("external field must be a list [vx, vy, vz]")
            gexp.Vext(field)
        gexp.build()
        self.target_log = log = {**init, **gexp.log}
        if para_factor is not None:
            gexp.underfit(para_factor)
        self.Eexp_GS = gexp.Eexp

        if isinstance(prop, str):
            prop = [prop]
        for p in prop:
            if p == "mat":
                with metrics.span("ecw.target.store", log, "target_store_s"):
                    tgt = convert.convert_r_to_g_rdm1(gexp.gamma_ao)
                    tgt = convert.ao_to_mo(tgt, self.mo_coeff)
                    self.exp_data[0].append(["mat", tgt])
                    self.Ek_exp_GS = props.Ekin(gexp.mol_def, gexp.gamma_ao,
                                                g=False)
                    self.HF_prop[0].append(np.diag(self.mo_occ))
            elif isinstance(p, (list, np.ndarray)):
                raise NotImplementedError(
                    "structure-factor targets are not wired into the driver "
                    "(the reference also raises here, Main.py:343-344); "
                    "build exp_data manually with ['F', F, h, rec_vec]")
            elif p == "Ek":
                self.exp_data[0].append(
                    ["Ek", props.Ekin(gexp.mol_def, gexp.gamma_ao, g=False)])
                self.HF_prop[0].append(self.Ek_HF_GS)
                self.cal_rdm1_Delta = True
            elif p == "v1e":
                self.exp_data[0].append(
                    ["v1e", props.v1e(gexp.mol_def, gexp.gamma_ao, g=False)])
                self.HF_prop[0].append(self.v1e_HF_GS)
                self.cal_rdm1_Delta = True
            elif p == "dip":
                d = props.dipole(gexp.mol_def, gexp.gamma_ao, g=False)
                self.exp_data[0].append(["dip", list(d)])
                self.HF_prop[0].append(self.dip_HF_GS)
                self.cal_rdm1_Delta = True

        if basis is not None and self.mol.basis_name != basis:
            self.cal_rdm1_Delta = False
        elif self.cal_rdm1_Delta:
            tgt = convert.convert_r_to_g_rdm1(gexp.gamma_ao)
            self.target_rdm1_GS = convert.ao_to_mo(tgt, self.mo_coeff)

        if self.out_dir is not None:
            output.cube_density(gexp.mol_def,
                                os.path.join(self.out_dir, "target_GS.cube"),
                                gexp.gamma_ao)
        log["spans"] = metrics.current_job().rows
        print("*** GS data stored ***")

    def Build_ES_exp_MOM(self, nbr_of_es=(1, 0), field=None):
        """ES targets from MOM delta-SCF. Reference Main.py:400-435."""
        es_exp = gamma_exp.ESexp(self.mol, Vext=field, nbr_of_states=nbr_of_es)
        es_exp.MOM()
        if self.Eexp_GS is None:
            self.Eexp_GS = es_exp.Eexp_GS
        self.Eexp_ES.append(es_exp.DE_exp)
        if self.r_ini is None:
            self.r_ini = []
        for (kind, tr), rini in zip(es_exp.gamma_tr_ao, es_exp.ini_r):
            tr_mo = convert.ao_to_mo(tr, self.mo_coeff)
            self.exp_data.append([["trmat", [tr_mo, tr_mo]]])
            self.r_ini.append(convert.convert_r_to_g_amp(rini))
        print("*** ES data stored ***")

    def Build_ES_exp_EOM(self, nbr_of_es=1, prop="trmat"):
        """ES targets from EOM-EE-CCSD, solved on this ECW's device in its
        dtype (models/gamma_exp.ESexp.EOM; JAX ecw.py:237-275): the
        excitation energies and, per state, the target `prop` names:
        'trmat' the left and right transition rdm1 matrices;
        'trdip' the transition dipole vector (the component-wise average of
        the biorthogonal left and right moments); 'mat' the EOM
        excited-state density (Tr = N, biorthogonal).  The oscillator
        strengths go to self.f_osc_ES, the spin labels to self.spin_ES;
        self.es_eom is the ESexp of the build (its densities, dipoles and
        `log`: the seconds of each stage, the Davidson's cycles)."""
        if prop not in ("trmat", "trdip", "mat"):
            raise ValueError("prop must be 'trmat', 'trdip' or 'mat'")
        es_exp = gamma_exp.ESexp(self.mol, device=self.device,
                                 dtype=self.dtype)
        es_exp.EOM(nbr_of_es)
        self.es_eom = es_exp
        self.Eexp_ES.append(es_exp.DE_exp)
        if self.r_ini is None:
            self.r_ini = []
        self.f_osc_ES = [f for _, _, f in es_exp.trdip_exp]
        for ((tr_l, tr_r), g_es, rini, (dl, dr, _)) in zip(
                es_exp.gamma_tr_mo, es_exp.gamma_es_mo, es_exp.ini_r,
                es_exp.trdip_exp):
            if prop == "trmat":
                self.exp_data.append([["trmat", [tr_l, tr_r]]])
            elif prop == "mat":
                self.exp_data.append([["mat", g_es]])
            else:
                self.exp_data.append([["trdip", tuple(0.5 * (dl + dr))]])
            self.HF_prop.append([None])
            self.r_ini.append(np.asarray(rini))
        self.spin_ES = list(es_exp.spin_labels)
        for k, (de, lab, f) in enumerate(zip(es_exp.DE_exp,
                                             es_exp.spin_labels,
                                             self.f_osc_ES)):
            print(f"  EOM ES {k + 1}: {de * 27.2114:8.4f} eV  {lab:9s} "
                  f"f = {f:.5f}")
        print("*** EOM-CCSD ES data stored ***")

    def Build_ES_exp_input(self, es_prop, rini_list=None, val_core=None,
                           rini_koop_idx=None):
        """ES targets from given property values. Reference Main.py:437-488."""
        if val_core is None:
            val_core = [len(es_prop), 0]
        elif sum(val_core) != len(es_prop):
            raise ValueError("val_core must sum to the number of given states")
        if rini_koop_idx is not None and sum(val_core) != len(rini_koop_idx):
            raise ValueError("number of Koopman indices must equal the states")
        for es in es_prop:
            self.exp_data.append(es)
            self.HF_prop.append([None for _ in es])
        if not self.HF_prop[0]:
            self.HF_prop[0].append(None)
        if self.myccs is None:
            self.myccs = Gccs(self._eris_alt())
        if rini_list is None:
            r1, de = linalg.koopman_init_guess(np.diag(self.fock), self.mo_occ,
                                               val_core, koop_idx=rini_koop_idx)
            self.r_ini = r1
        else:
            if len(rini_list) != len(es_prop):
                raise ValueError("number of initial r vectors inconsistent "
                                 "with the given ES data")
            self.r_ini = rini_list
        print("*** ES data stored ***")

    # ------------------------------------------------------------------
    # Solvers (reference Main.py:490-950)
    # ------------------------------------------------------------------

    def _eris_alt(self):
        """The eris in the reference (alternating) MO layout, which the CCS
        and ES solvers take (JAX ecw.py:308-323): self.eris, or with the
        spin-sorted build an alternating view of it, gathered on the ECW's
        device once and cached (CCS reads no vvvv block, so the sorted
        sectors would buy it nothing)."""
        if self.mo_perm is None:
            return self.eris
        if self._eris_alt_cache is None:
            po = self.mo_perm[:self.nocc]
            pv = self.mo_perm[self.nocc:] - self.nocc
            self._eris_alt_cache = permute_geris(
                self.eris, np.argsort(po), np.argsort(pv),
                np.argsort(self.mo_perm))
        return self._eris_alt_cache

    def _tl_init(self, tl1ini):
        nocc, nvir = self.nocc, self.nvir
        if tl1ini == 1:
            mo_ene = np.diag(self.fock)
            eia = mo_ene[:nocc, None] - mo_ene[None, nocc:]
            tsini = self.fock[:nocc, nocc:] / eia
            lsini = tsini.copy()
        elif tl1ini == 2:
            rng = np.random.default_rng()
            tsini = convert.convert_r_to_g_amp(
                rng.random((nocc // 2, nvir // 2)) * 0.01)
            lsini = convert.convert_r_to_g_amp(
                rng.random((nocc // 2, nvir // 2)) * 0.01)
        else:
            tsini = np.zeros((nocc, nvir))
            lsini = np.zeros((nocc, nvir))
        return tsini, lsini

    @metrics.job()
    def CCSD_GS(self, Larray, alpha=None, diis="", nbr_cube_file=2, tl1ini=0,
                print_ite_info=False, diis_max=15, conv="tl", conv_thres=1e-5,
                maxiter=40, tablefmt="rst", HF_prop=False, target_rdm1_GS=None,
                checkpoint_dir=None, resume=False, mode="sweep",
                refine=False):
        """GS-ECW-CCSD lambda sweep.  Reference Main.py:663-816.

        mode='sweep' (the reference's), or any mode but 'parallel', as in
        the JAX ECW (models/ecw.py:487): warm-started and sequential, each
        lambda starting from the previous one's amplitudes.
        mode='parallel' (JAX models/ecw.py:487-492): every lambda at once
        in one Solver_CCSD.SCF_batch, lanes of one vmapped step that share
        each ladder launch; cold starts, so its iteration counts are those
        of a cold-start sequential sweep and its converged results those of
        the warm one.  It applies neither resume nor refine, as in the JAX
        package; checkpoints are written.

        refine=True (every mode but 'parallel') follows each solve with
        f64 polish iterations on eris_f64 (built on the device at f32, at
        first use),
        for f64 parity of the returned energies, amplitudes and rdm1 (JAX
        models/ecw.py:441-504).

        The sweep is one job of spans (utils/metrics.py): each solve_log
        entry holds under 'spans' the rows of the spans that ended while
        its lambda ran (the preparation's in the first, the release's and
        the fetch's in the last), and under 'driver' the ms of its host
        spans: 'prepare_ms' (first entry), 'record_ms', 'release_ms'
        (Solve.release_graphs(), last entry), 'fetch_ms' (the final
        prints and results and the amplitudes' fetch to the host, last
        entry), and Solver_CCSD.SCF's 'enter_ms' and 'exit_ms'."""
        job = metrics.current_job()
        prepare = {}
        with metrics.span("ecw.sweep.prepare", prepare, "prepare_ms"):
            refine = refine and mode != "parallel"
            self.diis = diis + f" diis_max={diis_max}"
            if len(self.exp_data) > 1:
                print("Warning: ES data found but GS solver used; only GS "
                      "data used")
            tsini, lsini = self._tl_init(tl1ini)
            ts, ls = tsini.copy(), lsini.copy()
            idx_L_print = np.round(np.linspace(0, len(Larray) - 1,
                                               nbr_cube_file)).astype(int)
            if target_rdm1_GS is None:
                target_rdm1_GS = self.target_rdm1_GS
            self.Delta_rdm1 = []

            Ek_HF_GS = self.Ek_HF_GS if HF_prop else None
            hf_prop = self.HF_prop if HF_prop else False
            VXexp = Exp(Larray[0], [self.exp_data[0]], self.mol,
                        self.mo_coeff, Ek_exp_GS=self.Ek_exp_GS,
                        HF_prop=hf_prop, Ek_HF_GS=Ek_HF_GS)
            if self.myccsd is None:
                self.myccsd = GCC(self.eris)
            Solve = Solver_CCSD(self.myccsd, VXexp, conv=conv,
                                conv_thres=conv_thres, tsini=tsini,
                                lsini=lsini, diis=diis, maxdiis=diis_max,
                                maxiter=maxiter, vvvv_op=self.vvvv_op,
                                mo_perm=self.mo_perm,
                                eris_host=self.eris_f64 if refine else None)
            td = ld = None
            Result = None
            Ep = Delta = vmax = None
            self.init_plot_var(Larray)
            print()
            print("##############################################")
            print("#  Results using SCF for CCSD- GS calculation ")
            print("##############################################")
            print()
        batch = None
        if mode == "parallel":
            batch = Solve.SCF_batch(list(Larray), alpha=alpha, diis=diis)
            lanes = Solve.last_solve
        filed = 0       # the job's rows already in an entry
        for idx_L, L in enumerate(Larray):
            with metrics.span("ecw.sweep.lambda"):
                print("LAMBDA= ", L)
                if batch is not None:
                    Result = batch[idx_L]
                    entry = {**lanes, "L": L, "lane": idx_L,
                             "iterations": lanes["iterations"][idx_L],
                             "status": lanes["status"][idx_L],
                             "driver": {}}
                else:
                    if resume and checkpoint_dir is not None:
                        saved = checkpoint.load_amplitudes(checkpoint_dir, L)
                        if saved is not None:
                            ts, ls = saved["ts"], saved["ls"]
                            td, ld = saved["td"], saved["ld"]
                    # amplitudes stay on the device across the warm-started
                    # sweep
                    Result = Solve.SCF(L, ts=ts, ls=ls, td=td, ld=ld,
                                       alpha=alpha, keep_device=True,
                                       refine=refine)
                    entry = Solve.last_solve
                self.solve_log.append(entry)
                if idx_L == 0:
                    entry["driver"].update(prepare)
                with metrics.span("ecw.sweep.record", entry["driver"],
                                  "record_ms"):
                    ts, ls, td, ld = Result[5]
                    if checkpoint_dir is not None:
                        checkpoint.save_amplitudes(
                            checkpoint_dir, L,
                            {"ts": _host(ts), "ls": _host(ls),
                             "td": _host(td), "ld": _host(ld)},
                            meta={"Ep": float(Result[1][-1])})
                    if self.out_dir is not None and idx_L in idx_L_print:
                        fout = os.path.join(self.out_dir, f"L{L:.2f}")
                        output.cube_rdm1(Result[4], self.mo_coeff, self.mol,
                                         fout)
                    if print_ite_info:
                        output.print_iteration_table(Result, conv, tablefmt)
                    print(Result[0])
                    Ep = Result[1][-1]
                    Delta = Result[2][-1][0]
                    vmax = Result[2][-1][1]
                    print("Delta = ", Delta)
                    print()
                    if target_rdm1_GS is not None and self.cal_rdm1_Delta:
                        diff = np.subtract(target_rdm1_GS, Result[4])
                        self.Delta_rdm1.append(
                            np.sum(np.abs(diff)) / np.sum(np.abs(
                                target_rdm1_GS - np.diag(self.mo_occ))))
                    self.Delta_lamb.append(Delta)
                    self.Ep_lamb.append(self.EHF - Ep)
                    self.vmax_lamb.append(vmax)
                    if VXexp.Delta_Ek_GS is not None:
                        self.Delta_Ek.append(VXexp.Delta_Ek_GS)
            entry["spans"] = job.rows[filed:]
            filed = len(job.rows)
        with metrics.span("ecw.sweep.release", entry["driver"],
                          "release_ms"):
            Solve.release_graphs()
        with metrics.span("ecw.sweep.fetch", entry["driver"], "fetch_ms"):
            print()
            print("FINAL RESULTS")
            print("Ep   = " + format_float.format(Ep + self.EHF))
            print("Delta   = " + format_float.format(Delta))
            if VXexp.Delta_Ek_GS is not None:
                print("DEk  = " + format_float.format(VXexp.Delta_Ek_GS))
            print()
            print("EHF    = " + format_float.format(self.EHF))
            if self.Eexp_GS is not None:
                print("Eexp   = " + format_float.format(self.Eexp_GS))
            if self.out_dir is not None:
                self.print_results()
            # the public API returns NumPy amplitudes (one fetch, at the
            # end)
            out = tuple(Result[:5]) + ([_host(a) for a in Result[5]],)
        entry["spans"] += job.rows[filed:]
        return out

    def CCS_GS(self, Larray, alpha=None, method="scf", diis="",
               nbr_cube_file=2, tl1ini=0, print_ite_info=False, beta=None,
               diis_max=15, conv="tl", conv_thres=1e-5, maxiter=80,
               tablefmt="rst", HF_prop=False, target_rdm1_GS=None,
               checkpoint_dir=None, resume=False):
        """GS-ECW-CCS lambda sweep (warm-started, sequential).  Reference
        Main.py:490-661.  method: 'scf', 'newton', 'descend' or 'L1_grad'
        (the last needs alpha and the step beta)."""
        self.diis = diis + f" diis_max={diis_max}"
        if method == "L1_grad" and beta is None:
            raise ValueError("beta (gradient step) required for L1_grad")
        if len(self.exp_data) > 1:
            self.exp_data = [self.exp_data[0]]
            print("Warning: ES data found but GS solver used; only GS data "
                  "kept")
        self.method = method
        if target_rdm1_GS is None:
            target_rdm1_GS = self.target_rdm1_GS
        self.Delta_rdm1 = []

        Ek_HF_GS = self.Ek_HF_GS if HF_prop else None
        hf_prop = self.HF_prop if HF_prop else False
        VXexp = Exp(Larray[0], self.exp_data, self.mol, self.mo_coeff,
                    Ek_exp_GS=self.Ek_exp_GS, HF_prop=hf_prop,
                    Ek_HF_GS=Ek_HF_GS)
        tsini, lsini = self._tl_init(tl1ini)
        ts, ls = tsini.copy(), lsini.copy()
        idx_L_print = np.round(np.linspace(0, len(Larray) - 1,
                                           nbr_cube_file)).astype(int)
        if self.myccs is None:
            self.myccs = Gccs(self._eris_alt())
        mygrad = (ccs_gradient(self._eris_alt())
                  if method in ("newton", "descend") else None)
        Solve = Solver_CCS(self.myccs, VXexp, conv=conv,
                           conv_thres=conv_thres, tsini=tsini, lsini=lsini,
                           diis=diis, maxdiis=diis_max, maxiter=maxiter,
                           CCS_grad=mygrad)
        Result = None
        Ep = Delta = vmax = None
        self.init_plot_var(Larray)
        print()
        print("#######################################################")
        print(f"#  Results using {method} for CCS-GS calculation ")
        print("#######################################################")
        print()
        for idx_L, L in enumerate(Larray):
            print("LAMBDA= ", L)
            if resume and checkpoint_dir is not None:
                saved = checkpoint.load_amplitudes(checkpoint_dir, L)
                if saved is not None:
                    ts, ls = saved["ts"], saved["ls"]
            if method == "newton":
                Result = Solve.Gradient(L, ts=ts, ls=ls)
            elif method == "descend":
                Result = Solve.Gradient(L, method=method, ts=ts, ls=ls,
                                        beta=beta)
            elif method == "scf":
                Result = Solve.SCF(L, ts=ts, ls=ls, alpha=alpha)
                self.solve_log.append(Solve.last_solve)
            elif method == "L1_grad":
                Result = Solve.L1_grad(L, alpha, beta, ts=ts, ls=ls)
            else:
                raise ValueError("method not recognized")
            ts, ls = Result[5]
            if checkpoint_dir is not None:
                checkpoint.save_amplitudes(checkpoint_dir, L,
                                           {"ts": ts, "ls": ls},
                                           meta={"Ep": float(Result[1][-1])})
            if self.out_dir is not None and idx_L in idx_L_print:
                fout = os.path.join(self.out_dir, f"L{L:.2f}")
                output.cube_rdm1(Result[4], self.mo_coeff, self.mol, fout)
            if print_ite_info:
                output.print_iteration_table(Result, conv, tablefmt)
            print(Result[0])
            Ep = Result[1][-1]
            Delta = Result[2][-1][0]
            vmax = Result[2][-1][1]
            print("Delta = ", Delta)
            print()
            if target_rdm1_GS is not None and self.cal_rdm1_Delta:
                diff = np.subtract(target_rdm1_GS, Result[4])
                self.Delta_rdm1.append(
                    np.sum(np.abs(diff)) / np.sum(np.abs(
                        target_rdm1_GS - np.diag(self.mo_occ))))
            self.Delta_lamb.append(Delta)
            self.Ep_lamb.append(Ep)
            self.vmax_lamb.append(vmax)
            if VXexp.Delta_Ek_GS is not None:
                self.Delta_Ek.append(VXexp.Delta_Ek_GS)
        Solve.release_graphs()

        print("FINAL RESULTS")
        print("Ep   = " + format_float.format(Ep + self.EHF))
        print("Delta   = " + format_float.format(Delta))
        if VXexp.Delta_Ek_GS is not None:
            print("Delta Ek  = " + format_float.format(VXexp.Delta_Ek_GS))
        print()
        print("EHF    = " + format_float.format(self.EHF))
        print("Eexp   = ", self.Eexp_GS)
        print()
        if self.out_dir is not None:
            self.print_results()
        return Result

    def CCS_ES(self, L, method="scf", conv="rl", exp_data=None,
               conv_thres=1e-5, maxiter=40, diis="", L_loop=False,
               nbr_cube_file=0, target_rdm1_GS=None, print_ite=True,
               maxdiis=15, mindiis=2, davidson=False):
        """Coupled multi-state ES solve. Reference Main.py:818-950.

        method: 'scf'    - the host-orchestrated coupled SCF (reference
                           Solver_ES.SCF),
                'device' - the whole iteration on the device
                           (SolverES_Device: rdm1s, Vexp refresh, coupled
                           t/lambda and the r/l updates of all states at
                           once, DIIS; one flag read per iteration),
                'diag'   - the diagonalization variant (reference branch
                           Main.py:892-894; davidson=True for the
                           matrix-free solver).
        With L_loop=True, L is a 1D array of weights, each solve
        warm-started from the one before, and the sweep is kept for
        print_results_ES / plot_results_ES; nothing is returned."""
        if exp_data is None:
            exp_data = self.exp_data
            if len(exp_data) == 1:
                raise NotImplementedError(
                    "no excited-state data found; use the GS solver instead")
        self.nbr_ES = len(exp_data) - 1
        if target_rdm1_GS is None:
            target_rdm1_GS = self.target_rdm1_GS
        if self.r_ini is None:
            print("Initial amplitudes will be taken from Koopman's guess")
        if self.myccs is None:
            self.myccs = Gccs(self._eris_alt())

        if L_loop:
            if isinstance(L, float):
                raise ValueError("with L_loop=True, L must be a 1D array")
            Vexp = Exp(L[0], exp_data, self.mol, self.mo_coeff,
                       Ek_exp_GS=self.Ek_exp_GS)
        else:
            Vexp = Exp(L, exp_data, self.mol, self.mo_coeff,
                       Ek_exp_GS=self.Ek_exp_GS)
            L = Vexp.L_check(L)

        Solver = Solver_ES(self.myccs, Vexp, conv_var=conv,
                           conv_thres=conv_thres, maxiter=maxiter, diis=diis,
                           maxdiis=maxdiis, mindiis=mindiis,
                           rn_ini=self.r_ini)
        if method == "scf":
            used = Solver
            solve = lambda L_, amp=None: Solver.SCF(
                L_, dic_amp_ini=amp, print_ite=print_ite)
        elif method == "device":
            used = SolverES_Device(Solver)
            solve = lambda L_, amp=None: used.SCF(L_, dic_amp_ini=amp,
                                                  diis=diis)
        elif method == "diag":
            used = None
            solve = lambda L_, amp=None: Solver.SCF_diag(
                L_, dic_amp_ini=amp, print_ite=print_ite, davidson=davidson)
        else:
            raise SyntaxError("method must be 'scf', 'device' or 'diag'")
        self.solve_log = []
        print()
        print("########################################")
        print("#  Results using SCF for ES calculation ")
        print("########################################")
        print()
        if not L_loop:
            Conv_text, dic_amp, Delta, Ep, rdm1_GS = solve(L)
            self.solve_log.append(getattr(used, "last_solve", None))
            if method == "device":
                used.release_graphs()
            if target_rdm1_GS is not None:
                diff = np.subtract(target_rdm1_GS, rdm1_GS)
                self.Delta_rdm1 = (np.sum(np.abs(diff)) / np.sum(np.abs(
                    target_rdm1_GS - np.diag(self.mo_occ))))
            print(Conv_text)
            return Conv_text, dic_amp, Delta, Ep, rdm1_GS

        dic_amp = None
        self.init_plot_var(L)
        self.Delta_rdm1 = [] if target_rdm1_GS is not None else None
        for lamb in L:
            print("LAMBDA= ", lamb)
            Conv_text, dic_amp, Delta, Ep, rdm1_GS = solve(lamb, dic_amp)
            self.solve_log.append(getattr(used, "last_solve", None))
            if self.out_dir is not None:
                fout = os.path.join(self.out_dir, f"L{lamb:.2f}")
                output.cube_rdm1(rdm1_GS, self.mo_coeff, self.mol, fout)
            self.Delta_lamb.append([Delta[0, 1:], Delta[1:, 0]])
            self.Ep_lamb.append([np.ravel(Ep[:, 0]), np.ravel(Ep[:, 1])])
            if target_rdm1_GS is not None:
                diff = np.subtract(target_rdm1_GS, rdm1_GS)
                self.Delta_rdm1.append(
                    np.sum(np.abs(diff)) / np.sum(np.abs(
                        target_rdm1_GS - np.diag(self.mo_occ))))
            print(Conv_text)
            print("Delta = \n", Delta)
            print()
        if method == "device":
            used.release_graphs()

    # ------------------------------------------------------------------
    # Output (reference Main.py:956-1179)
    # ------------------------------------------------------------------

    def print_results(self, out_dir=None):
        return output.print_results_gs(self, out_dir)

    def print_results_ES(self, out_dir=None):
        return output.print_results_es(self, out_dir)

    def plot_results(self):
        return output.plot_results_gs(self)

    def plot_results_ES(self):
        return output.plot_results_es(self)
