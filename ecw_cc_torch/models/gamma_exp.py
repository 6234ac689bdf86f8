"""Simulated target ("experimental") data (port of
ecw_cc_tpu/models/gamma_exp.py; reference gamma_exp.py:104-488).

Gexp builds the target rdm1 of an HF, CCSD or CCSD(T) calculation,
optionally with a static external field, a random geometry deformation and
under-fitting.  The correlated targets run plain GCCSD (ops/ccsd_t.
solve_ccsd) and then either the textbook Lambda equations (solve_lambda)
and the CCSD rdm1, or the (T) energy and the CCSD(T) response density
(ops/ccsd_t.ccsd_t_rdm1_response), on `device` in `dtype`.

ESexp builds excited-state targets by the MOM (delta-SCF) approach with
SVD-biorthogonalized Slater transition density matrices (host NumPy, a
copy of the JAX module's), or from EOM-EE-CCSD (ESexp.EOM: plain CCSD +
Lambda, the EOM roots by the autodiff sigma of ops/eom.py, and the Wick
transition densities) on `device` in `dtype`.
"""

from __future__ import annotations

import numpy as np
import torch

from ecw_cc_torch.config import check_device, torch_dtype
from ecw_cc_torch.models.eris import build_eris, build_eris_device
from ecw_cc_torch.models.molecule import ANG2BOHR, Molecule  # noqa: F401
from ecw_cc_torch.models.scf import GHF, RHF, UHF
from ecw_cc_torch.ops import ccsd as ccsd_ops
from ecw_cc_torch.ops import ccsd_t
from ecw_cc_torch.ops.ladder import ensure_sorted_vvvv_op, spin_sort_perm
from ecw_cc_torch.ops.spinsect import sector_info
from ecw_cc_torch.solvers import device_loop
from ecw_cc_torch.utils import convert, linalg, props
from ecw_cc_torch.utils.metrics import StageClock, span


def _l_step(eris, vvvv_op, t1, t2, l1, l2, sect=None):
    if sect is not None:
        from ecw_cc_torch.ops.ccsd_sect import lupdate_sect

        l1n, l2n = lupdate_sect(eris, t1, t2, l1, l2, eris.fock, sect[0],
                                energy_term="off", vvvv_op=vvvv_op,
                                sym=sect[1])
    else:
        l1n, l2n = ccsd_ops.lupdate(eris, t1, t2, l1, l2, None,
                                    energy_term="off", vvvv_op=vvvv_op)
    return l1n, l2n, torch.linalg.norm(l1n) + torch.linalg.norm(l2n)


def solve_lambda(eris, t1, t2, conv_tol=None, max_cycle=200, vvvv_op=None,
                 sect=None, log=None):
    """GS Lambda amplitudes (textbook equations, energy_term='off'): plain
    Jacobi iterations from l = t, converged when the norm |l1| + |l2| moves
    by less than conv_tol.  The iterations are a device_loop.Loop (JAX
    gamma_exp.py:35-67, one jitted step per iteration): on the card one is
    captured and replayed, one flag read per iteration; the first
    iteration, which has no norm to compare with, is a flag in the state.

    sect: optional (SectorInfo, sym): sector-blocked kernels (sorted
    layout).  conv_tol: None is 1e-10 at f64 (the JAX package's value) and
    1e-6 at f32.  log: a dict that receives 'iterations', 'converged' and
    the loop's log ('loop')."""
    conv_tol = ccsd_t._default_tol(conv_tol, t1.dtype, 1e-10, 1e-6)
    if sect is not None:
        vvvv_op = ensure_sorted_vvvv_op(vvvv_op, eris, sect[0])
    dev, f64 = t1.device, torch.float64

    def body(state):
        # the norm compared in f64, as the host float it was
        _, l1, l2, l_old, has_old, k, _ = state
        l1, l2, nrm = _l_step(eris, vvvv_op, t1, t2, l1, l2, sect=sect)
        nrm = nrm.to(f64)
        conv = has_old & ((nrm - l_old).abs() < conv_tol)
        k = k + 1
        return (~conv & (k < max_cycle), l1, l2, nrm,
                torch.ones_like(has_old), k, conv)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    with torch.no_grad():
        _, l1, l2, _, _, k, conv = device_loop.Loop(body)(
            (torch.full((), max_cycle > 0, device=dev), t1, t2,
             torch.zeros((), dtype=f64, device=dev), false,
             torch.zeros((), dtype=torch.int64, device=dev), false.clone()),
            None if log is None else log.setdefault("loop", {}))
    if log is not None:
        log.update(iterations=int(k), converged=bool(conv))
    return l1, l2


def _spin_label(r1):
    """singlet/triplet/spin-flip label of an EE R1 block (alternating
    spin layout): the Ms=0 singlet combination is symmetric in
    alpha<->beta, the triplet antisymmetric."""
    r1 = np.asarray(r1)
    raa = r1[0::2, 0::2]
    rbb = r1[1::2, 1::2]
    off = np.linalg.norm(r1[0::2, 1::2]) + np.linalg.norm(r1[1::2, 0::2])
    if off > 0.5 * max(np.linalg.norm(r1), 1e-300):
        return "spin-flip"
    s = np.linalg.norm(raa + rbb)
    t = np.linalg.norm(raa - rbb)
    if max(s, t) < 1e-8:
        return "n/a"
    return "singlet" if s > t else "triplet"


def _swap_ov_vo(g, nocc):
    """Det-space <p+ q> layout -> the reference tr_rdm1 index convention
    (ov/vo blocks transposed; oo/vv unchanged).  Verified: the reference
    formula's pure-L part equals the swapped determinant-space matrix
    exactly (tests/test_eom.py)."""
    out = g.copy()
    out[:nocc, nocc:] = g[nocc:, :nocc].T
    out[nocc:, :nocc] = g[:nocc, nocc:].T
    return out


def _build_eris_auto(mol, ghf, dtype, device):
    """(eris, vvvv_op) in the alternating layout: at f32 the device build
    with pack-on-build, so that the dense (v,v,v,v) block is never
    materialized; at f64 (the parity mode) the exact host build, dense,
    vvvv_op=None."""
    if dtype == torch.float32:
        return build_eris_device(mol, ghf, dtype=dtype, device=device,
                                 pack_ladder=True)
    return build_eris(mol, ghf).to_device(dtype=dtype, device=device), None


def _build_eris_sorted(mol, ghf, dtype, device):
    """(eris, vvvv_op, sect, unperm) for CCSD / CCSD(T) target builds.

    At f32 the device build runs in the spin-SORTED layout (pack-on-build
    SectoredVVVV ladder), so the t/lambda solves, the o^3 v^4 (T) loops and
    the response-density adjoint all go through the sector-blocked kernels
    (ops/ccsd_sect.py, ops/ccsd_t.energy_t_sect), under the closed-shell
    mirror gate where it passes.  The CC equations are orbital-order
    covariant, so everything runs sorted and only the final density is
    permuted back (unperm).  f64 keeps the dense host build and the dense
    kernels as the oracle path."""
    if dtype != torch.float32:
        eris, _ = _build_eris_auto(mol, ghf, dtype, device)
        return eris, None, None, None
    eris, vvvv_op = build_eris_device(mol, ghf, dtype=dtype, device=device,
                                      pack_ladder=True, sort_spin=True)
    perm = spin_sort_perm(np.asarray(ghf.orbspin), ghf.nocc)
    info = sector_info(np.asarray(ghf.orbspin)[perm], ghf.nocc)
    sym = ccsd_t.eris_spin_restricted(eris, info, vvvv_op=vvvv_op)
    return eris, vvvv_op, (info, sym), np.argsort(perm)


def _gamma(t1, t2, l1, l2, sect=None):
    """The CCSD rdm1, through the sectored intermediates on the sorted
    layout."""
    if sect is not None:
        from ecw_cc_torch.ops.ccsd_sect import gamma_inter_sect

        inter = gamma_inter_sect(t1, t2, l1, l2, sect[0], sym=sect[1])
        return ccsd_ops.gamma_CCSD(t1, t2, l1, l2, inter=inter)
    return ccsd_ops.gamma_CCSD(t1, t2, l1, l2)


def _run_gccsd_rdm1(built, conv_tol=None, max_cycle=200, log=None):
    """Plain GCCSD + Lambda on the (eris, vvvv_op, sect, unperm) of a
    build: (e_corr, rdm1_mo_G as NumPy in the alternating MO order)."""
    eris, vvvv_op, sect, unperm = built
    stage = StageClock(eris.fock.device, log, "gexp.")
    with stage("ccsd_s"):
        t1, t2, e_cc = ccsd_t.solve_ccsd(eris, conv_tol=conv_tol,
                                         max_cycle=max_cycle,
                                         vvvv_op=vvvv_op, sect=sect,
                                         log=stage.sub("ccsd"))
    with stage("lambda_s"):
        l1, l2 = solve_lambda(eris, t1, t2, conv_tol, max_cycle,
                              vvvv_op=vvvv_op, sect=sect,
                              log=stage.sub("lambda"))
    with torch.no_grad():
        rdm1_mo = _gamma(t1, t2, l1, l2, sect=sect).cpu().numpy()
    if unperm is not None:
        rdm1_mo = rdm1_mo[np.ix_(unperm, unperm)]
    return e_cc, rdm1_mo.astype(np.float64)


def _run_gccsd_t_rdm1(built, log=None):
    """Plain GCCSD, the (T) energy and the CCSD(T) response density on the
    (eris, vvvv_op, sect, unperm) of a build: (e_cc, e_t, rdm1_mo_G as
    NumPy in the alternating MO order, symmetrized).  log receives the
    iterations and the seconds of each stage."""
    eris, vvvv_op, sect, unperm = built
    stage = StageClock(eris.fock.device, log, "gexp.")
    with stage("ccsd_s"):
        t1, t2, e_cc = ccsd_t.solve_ccsd(eris, vvvv_op=vvvv_op, sect=sect,
                                         log=stage.sub("ccsd"))
    with stage("energy_t_s"), torch.no_grad():
        e_t = float(ccsd_t.energy_t(eris, t1, t2, sect=sect,
                                    log=stage.sub("energy_t")))
    with stage("adjoint_s"):
        rdm1_mo = ccsd_t.ccsd_t_rdm1_response(
            eris, t1, t2, vvvv_op=vvvv_op, sect=sect,
            log=stage.sub("adjoint")).cpu().numpy().astype(np.float64)
    if unperm is not None:
        # back to the alternating-spin MO order of ghf.mo_coeff
        rdm1_mo = rdm1_mo[np.ix_(unperm, unperm)]
    # symmetrize (the response density of a real functional)
    return e_cc, e_t, 0.5 * (rdm1_mo + rdm1_mo.T)


class Gexp:
    """GS target rdm1 generator.  Reference gamma_exp.py:104-275.

    device, dtype: where and at what precision a correlated target is
    solved (None = config.dtype); an HF target is host work.  After a
    correlated build, `self.log` holds the iterations and the seconds of
    each stage."""

    def __init__(self, mol: Molecule, method, basis=None, *, device="cuda",
                 dtype=None):
        self.device = device
        self.dtype = torch_dtype(dtype)
        self.log = {}
        self.mol_def = mol.with_basis(basis) if basis is not None else mol.copy()
        self.mf_def = RHF(self.mol_def)
        self.mo_coeff_def = None
        self.nocc = None
        self.nvir = None
        self.gamma_ao = None  # AO basis, R format
        self.method = method
        self.EHF_def = 0.0
        self.ECCSD_def = 0.0
        self.ECCSD_t_def = 0.0
        self.Eexp = 0.0

    def deform(self, def_max, rng=None):
        """Random geometry kicks up to def_max (Bohr); reference
        gamma_exp.py:140-168 with per-coordinate indexing."""
        rng = rng or np.random.default_rng()
        natm = self.mol_def.natm
        dq = (rng.random(natm * 3) * 2 - 1) * def_max
        new_atoms = [(sym, xyz + dq[3 * i:3 * i + 3])
                     for i, (sym, xyz) in enumerate(self.mol_def.atoms)]
        self.mol_def = self.mol_def.with_geometry(new_atoms)
        self.mf_def = RHF(self.mol_def)

    def Vext(self, field):
        """Static external field on the one-electron operator; reference
        gamma_exp.py:170-191 (dipole origin at [0,0,0])."""
        mol = self.mol_def
        h = (mol.intor("kin") + mol.intor("nuc")
             + np.einsum("x,xij->ij", np.asarray(field, float),
                         mol.intor("r", origin=np.zeros(3))))
        self.mf_def.set_hcore(h)

    def _store_mo_g(self, rdm1_mo_g, ghf):
        """MO G -> AO G -> AO R."""
        rdm1_ao_g = convert.mo_to_ao(rdm1_mo_g, ghf.mo_coeff)
        self.gamma_ao = convert.convert_g_to_ru_rdm1(rdm1_ao_g)[0]

    def build(self):
        """HF, CCSD or CCSD(T) target calculation.  Reference
        gamma_exp.py:193-255."""
        method = self.method.upper().replace("(", "").replace(")", "")
        if method not in ("HF", "CCSD", "CCSDT"):
            raise ValueError("method not recognized (use 'HF', 'CCSD' or "
                             "'CCSD(T)')")
        self.log = log = {}
        self.mf_def.conv_tol = 1e-11
        with span("gexp.scf", log, "scf_s"):
            self.mf_def.kernel()
        self.mo_coeff_def = self.mf_def.mo_coeff
        self.nocc = int(np.sum(self.mf_def.mo_occ > 0))
        self.nvir = int(np.sum(self.mf_def.mo_occ == 0))
        self.EHF_def = self.mf_def.e_tot
        self.Eexp = self.EHF_def
        if method == "HF":
            self.gamma_ao = self.mf_def.make_rdm1()
            return

        with span("gexp.ghf", log, "ghf_s"):
            ghf = GHF(self.mf_def)
        dev = check_device(self.device)
        stage = StageClock(dev, log, "gexp.")
        with stage("eris_s"):
            built = _build_eris_sorted(self.mol_def, ghf, self.dtype, dev)
        log["sym"] = bool(built[2][1]) if built[2] is not None else False
        if method == "CCSD":
            e_corr, rdm1_mo_g = _run_gccsd_rdm1(built, log=log)
            self.ECCSD_def = e_corr
            self.Eexp = self.EHF_def + e_corr
        else:
            e_cc, et, rdm1_mo_g = _run_gccsd_t_rdm1(built, log=log)
            self.ECCSD_def = e_cc
            self.ECCSD_t_def = e_cc + et
            self.Eexp = self.EHF_def + e_cc + et
        with span("gexp.store", log, "store_s"):
            self._store_mo_g(rdm1_mo_g, ghf)

    def underfit(self, para_factor, rng=None):
        """Randomly zero elements of gamma_ao to simulate under-fitting;
        reference gamma_exp.py:257-275."""
        rng = rng or np.random.default_rng()
        dim = self.mo_coeff_def.shape[0]
        n_exp = int(round(dim ** 2 - para_factor * (self.nocc * self.nvir * 2)))
        idx = rng.choice(dim * dim, size=max(n_exp, 0), replace=False)
        flat = self.gamma_ao.ravel().copy()
        flat[idx] = 0.0
        self.gamma_ao = flat.reshape(dim, dim)


class ESexp:
    """ES targets via MOM (delta-SCF) or EOM-EE-CCSD.  Reference
    gamma_exp.py:282-488.

    device, dtype: where and at what precision the EOM targets are solved
    (None = config.dtype); MOM is host work.  After EOM(), `self.log`
    holds the seconds of each stage and the Davidson's cycles and
    matvecs."""

    def __init__(self, mol: Molecule, Vext=None, nbr_of_states=(1, 0), *,
                 device="cuda", dtype=None):
        self.device = device
        self.dtype = torch_dtype(dtype)
        self.log = {}
        self.mol = mol
        self.mf = RHF(mol)
        self.nbr_of_states = nbr_of_states
        self.gamma_ao = []     # [('val'|'core', rdm1_ao_G), ...]
        self.gamma_tr_ao = []  # [('val'|'core', tdm_ao), ...]
        if Vext is not None:
            h = (mol.intor("kin") + mol.intor("nuc")
                 + np.einsum("x,xij->ij", np.asarray(Vext, float),
                             mol.intor("r", origin=np.zeros(3))))
            self.mf.set_hcore(h)
        self.mf.kernel()
        self.mo_coeff = self.mf.mo_coeff
        self.nocc = int(np.sum(self.mf.mo_occ > 0))
        self.nvir = int(np.sum(self.mf.mo_occ == 0))
        self.Eexp_GS = self.mf.e_tot
        self.DE_exp = []
        self.ini_r = [np.zeros((self.nocc, self.nvir))
                      for _ in range(sum(nbr_of_states))]

    def MOM(self):
        """Delta-SCF (MOM) for valence and core excited states; builds the
        G-format ES rdm1s and biorthogonal Slater transition densities.
        Reference gamma_exp.py:332-462."""
        mol = self.mol
        nao = self.nocc + self.nvir
        homo = mol.nelectron // 2 - 1
        lumo = homo + 1
        mo_coeff_u = np.stack([self.mo_coeff, self.mo_coeff])

        def run_state(occ_a_from, occ_a_to, state_kind, istate):
            moc = np.zeros((2, nao))
            moc[0, : mol.nelec[0]] = 1.0
            moc[1, : mol.nelec[1]] = 1.0
            moc[0, occ_a_from] = 0.0
            moc[0, occ_a_to] = 1.0
            self.ini_r[istate][occ_a_from, occ_a_to - self.nocc] = 1.0

            es_mf = UHF(mol)
            if self.mf._hcore_override is not None:
                es_mf.set_hcore(self.mf._hcore_override)
            dma = (mo_coeff_u[0] * moc[0]) @ mo_coeff_u[0].T
            dmb = (mo_coeff_u[1] * moc[1]) @ mo_coeff_u[1].T
            es_mf.set_mom(mo_coeff_u, moc)
            es_mf.kernel(dm0=(dma, dmb))
            self.DE_exp.append(es_mf.e_tot - self.Eexp_GS)

            uhf_ao = es_mf.make_rdm1()
            ghf_ao = convert.convert_u_to_g_rdm1(uhf_ao)
            self.gamma_ao.append([state_kind, ghf_ao])

            mo_g = convert.convert_r_to_g_coeff(self.mo_coeff)
            es_mo_g = convert.convert_u_to_g_coeff(es_mf.mo_coeff)
            moc_g = convert.convert_u_to_g_moc(moc)
            TcL, TcR = linalg.ortho_SVD(mol, es_mo_g, mo_g)
            tdm = linalg.tdm_slater(TcL, TcR, moc_g)
            self.gamma_tr_ao.append([state_kind, tdm])

        for v in range(self.nbr_of_states[0]):
            run_state(homo, lumo + v, "val", v)
        for c in range(self.nbr_of_states[1]):
            run_state(0, lumo + c, "core", self.nbr_of_states[0] + c)

    def EOM(self, nbr_ES, tol=None):
        """EOM-EE-CCSD excited-state targets (JAX gamma_exp.py:339-435).

        tol: the Davidson residual tolerance, by default 1e-5 at f32 (a
        tighter one is out of f32's reach) and 1e-7 at f64.

        Solves plain CCSD + Lambda on the ERIs of _build_eris_sorted (f32:
        the spin-sorted sectored build; f64: the dense host build), then the
        lowest nbr_ES roots with their left vectors (ops/eom.eom_ccsd), and
        builds the MO-G transition rdm1s
          (0,n): <Psi_0(t,Lambda)| ap+ aq |R_k>   (tr_rdm1_right)
          (n,0): <L_k| ap+ aq |Psi_0(t)>          (tr_rdm1_left)
        in the reference tr_rdm1 index convention, the excited-state
        densities (Tr = N), spin labels and transition dipoles, all in the
        alternating MO order.  Results: DE_exp (omegas), gamma_tr_mo
        [(tr_l, tr_r), ...], gamma_es_mo, spin_labels, ini_r (R1 guesses
        for the ES solver), trdip_exp [(d_0k, d_k0, f_osc), ...]."""
        from ecw_cc_torch.ops import eom as eom_ops

        if tol is None:
            tol = 1e-5 if self.dtype == torch.float32 else 1e-7
        ghf = GHF(self.mf)
        self.log = log = {}
        dev = check_device(self.device)
        stage = StageClock(dev, log, "gexp.")
        with stage("eris_s"):
            eris, vvvv_op, sect, unperm = _build_eris_sorted(
                self.mol, ghf, self.dtype, dev)
        log["sym"] = bool(sect[1]) if sect is not None else False
        with stage("ccsd_s"):
            t1, t2, e_cc = ccsd_t.solve_ccsd(eris, vvvv_op=vvvv_op,
                                             sect=sect,
                                             log=stage.sub("ccsd"))
        # GS Lambda (textbook equations; plain-CCSD target generation)
        with stage("lambda_s"):
            l1, l2 = solve_lambda(eris, t1, t2, vvvv_op=vvvv_op, sect=sect,
                                  log=stage.sub("lambda"))
        with stage("eom_s"):
            omegas, Rs, Ls = eom_ops.eom_ccsd(eris, t1, t2, nroots=nbr_ES,
                                              tol=tol, left=True,
                                              vvvv_op=vvvv_op, sect=sect,
                                              log=stage.sub("eom"))
        with stage("densities_s"):
            nocc = eris.nocc
            if unperm is not None:
                io, iv = unperm[:nocc], unperm[nocc:] - nocc
            self.ECCSD = float(e_cc)
            self.gamma_tr_mo = []
            self.gamma_es_mo = []  # EOM excited-state densities (Tr = N)
            self.spin_labels = []  # singlet/triplet/spin-flip per root
            self.ini_r = []
            self.trdip_exp = []   # [(d_0k, d_k0, oscillator strength), ...]
            dip_int = self.mol.intor("r", origin=self.mol.charge_center())

            def host(x):
                return x.detach().cpu().numpy().astype(np.float64)

            for k in range(nbr_ES):
                r1, r2 = Rs[k]
                lk1, lk2 = Ls[k]
                with torch.no_grad():
                    r0 = eom_ops.eom_r0(eris, t1, t2, r1, r2, omegas[k])
                    # the Wick transition densities, stored in the reference
                    # index convention (ov/vo blocks transposed relative to
                    # <p+ q>), as the ES solver's gamma_tr kernels read them
                    tr_l = _swap_ov_vo(host(eom_ops.tr_rdm1_right(
                        t1, t2, l1, l2, r1, r2, r0)), nocc)
                    tr_r = _swap_ov_vo(host(eom_ops.tr_rdm1_left(
                        t1, t2, lk1, lk2)), nocc)
                    g_es = _swap_ov_vo(host(eom_ops.es_rdm1(
                        t1, t2, lk1, lk2, r1, r2, r0)), nocc)
                r1_out = host(r1)
                if unperm is not None:
                    tr_l = tr_l[np.ix_(unperm, unperm)]
                    tr_r = tr_r[np.ix_(unperm, unperm)]
                    g_es = g_es[np.ix_(unperm, unperm)]
                    r1_out = r1_out[np.ix_(io, iv)]
                # canonical phase in the ALTERNATING layout, so that the f32
                # sorted and the f64 dense paths agree: first near-maximal r1
                # component positive.  tr_l carries R's phase, tr_r L's (tied
                # to R by <L|R> = 1): both flip together; g_es and the
                # oscillator strengths do not depend on it
                flat = r1_out.ravel()
                aflat = np.abs(flat)
                if aflat.max() > 0 and flat[int(np.argmax(
                        aflat >= 0.999 * aflat.max()))] < 0:
                    r1_out = -r1_out
                    tr_l = -tr_l
                    tr_r = -tr_r
                self.DE_exp.append(float(omegas[k]))
                self.gamma_tr_mo.append((tr_l, tr_r))
                self.gamma_es_mo.append(g_es)
                self.ini_r.append(r1_out)
                self.spin_labels.append(_spin_label(r1_out))
                # the biorthogonal product d(0,k).d(k,0) equals |<0|mu|k>|^2
                # in the FCI limit
                dl = props.dipole(self.mol, tr_l, g=True, aobasis=False,
                                  mo_coeff=ghf.mo_coeff, dip_int=dip_int)
                dr = props.dipole(self.mol, tr_r, g=True, aobasis=False,
                                  mo_coeff=ghf.mo_coeff, dip_int=dip_int)
                f_osc = 2.0 / 3.0 * float(omegas[k]) * float(np.dot(dl, dr))
                self.trdip_exp.append((np.real(dl), np.real(dr), f_osc))
        return omegas
