#!/usr/bin/env python3
"""Drive the PyTorch port (ecw_cc_torch) once on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --kernel-times   # phase 1 and the kernel timing only
                                           # (f32, f64, and the TF32 and BF16
                                           # variants after their check)
    python3 chip_smoke.py --profile        # phase 1 and a profiler trace of
                                           # the f32 chain, cc-pVDZ and cc-pVTZ,
                                           # sectored and packed routes
    python3 chip_smoke.py --routes         # phase 1 and the timed f32 lambda
                                           # sweep on each route, nvir 16 to
                                           # 162
    python3 chip_smoke.py --chain          # phase 1 and the timed f32
                                           # 'highest' chain, cc-pVDZ and
                                           # cc-pVTZ (copied into an older
                                           # checkout, it times that one)
    python3 chip_smoke.py --targets        # phases 1, 2 and 10 only: the
                                           # correlated targets and the CCS
                                           # ground state
    python3 chip_smoke.py --es             # phases 1, 2 and 11 only: the
                                           # excited states
    python3 chip_smoke.py --precision      # phases 1, 2 and 12 only: the
                                           # CCSD solve's precision modes
    python3 chip_smoke.py --eom            # phases 1, 2, phase 3's
                                           # tangent check and 13 only:
                                           # EOM-EE/IP/EA-CCSD
    python3 chip_smoke.py --batch          # phases 1, 2, phase 3 at the
                                           # batched shapes and 14 only:
                                           # the batched lambda sweep
    python3 chip_smoke.py --parallel       # phases 1, 2 and 15 only: the
                                           # multi-device layer

Phases, one output line each (and one "phase_seconds" line at the end of
each); any failure raises and exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), TF32 off;
  2. build: the hand-written kernels compiled from ecw_cc_torch/csrc (one
     nvcc per source, started together), with ptxas's registers and spills
     per kernel, and the SASS check per kernel function: the f64 ladder_mm
     runs DMMA, the f32 one no HMMA or HGMMA, the TF32 and BF16 variants
     HGMMA (wgmma) and UTMALDG (TMA loads);
  3. kernel vs plain: ladder_mm against ladder_mm_ref (a @ b.T) in f32 and
     f64 at the solver's sector-GEMM shapes of C2H2/cc-pVDZ and cc-pVTZ,
     at the GEMMs of the dense, packed and stacked-sector routes (phase
     9), of the target builds (phase 10) and (f64 only) of phase 12's
     polish at cc-pVTZ, ragged shapes and shapes at the edges of the
     split-K plan
     (printed per shape, with its plan); two launches bitwise equal; one
     launch captured in a CUDA graph and replayed twice, equal to the
     eager result; then both timed at the solver's shapes; the same for
     phase 14's batched shapes (the lambda lanes stacked into M: 3 and 8
     lanes of the packed GEMM, 3 of the sector GEMMs; BATCH_SHAPES) checked
     and timed in f32, and the 3-lane packed shapes (BATCH_TC_SHAPES) in
     the TF32 and BF16 variants;
     the TF32 and BF16 variants against their plain versions (TF32 to
     1e-5 max|C|; BF16 to 2^-8 max|C| plus the f32 accumulation bound, on
     the plain version's f32 sum before its rounding), also at the edges
     of their 128 x 128 tile and of K (TC_EDGE_SHAPES), B held as the
     solver holds it (tf32_rows, bf16_rows), and a raw TF32 B that the
     kernel rounds itself equal to its tf32_rows copy; timed beside their
     plain versions and the library call (cuBLAS with TF32 on, on bf16);
     phase 13's EOM shapes (196x1891x1891 and 14x1891x1891, the sorted
     sigma's 196x465x465 and 196x961x961) checked and timed in f32 and
     f64; and the kernel's tangent: torch.func.jvp of ladder_mm(a, w) in
     a against that of a @ w.T at 196x1891x1891, 14x1891x1891 and a
     ragged shape, f32 and f64, w symmetric and not, each one forward and
     one tangent launch;
  4. main path, f32: ECW('c2h2', 'cc-pvdz') (ERIs transformed on the card,
     alternating layout, a PackedVVVV at nvir 62) -> HF target with a
     field -> CCSD_GS over lambda = 0, 0.25, 0.5 (diis 'tl', conv_thres
     1e-6); every lambda must converge on the packed route with exactly
     one ladder launch per iteration; then a fixed 41-iteration chain
     (conv_thres 0) for ms/iter;
  5. main path, f64: lambda = 0.25 on the card (through the kernel) and on
     the CPU (plain versions), both on ECW's f64 route (host ERIs in the
     alternating layout, a PackedVVVV at nvir 62: one ladder launch per
     iteration), must take the same iterations and agree in Ep to 1e-9
     Ha; the f32 card solve must agree to 1e-5 Ha, iterations +-1;
  6. ERI build at cc-pVDZ on the card: build_eris_device at f64 and at f32,
     alternating with a PackedVVVV (ECW's build) against the host f64
     build_eris and its packed vvvv, and sorted with a SectoredVVVV against
     sorted_from_host, block by block, to 1e-10 and 3e-6;
  7. main path at full width, C2H2/cc-pVTZ f32: ECW -> HF target ->
     CCSD_GS([0.25]) must converge on the packed route with 1 ladder
     launch per iteration, and agree with the same solve on f64 ERIs
     built on the card to 1e-5 Ha, iterations +-1; prints the set-up
     seconds, peak device memory of the build and the solve, and ms/iter
     of a 20-iteration chain;
  9. the sorted and dense routes:
     (a) C2H2/cc-pVTZ f32 on phase 7's molecule, SCF and target with
         build_eris_device(pack_ladder=True, sort_spin=True) and its
         mo_perm: lambda = 0.25 on the sectored route with exactly 2
         ladder launches per iteration (mirror symmetry), within 1e-5 Ha
         and +-1 iteration of phase 7's packed solve; build seconds, peak
         memory of build and solve, ms/iter of a 20-iteration chain;
     (b) C2H2/cc-pVDZ f32 with a target that couples the spins: on sorted
         ERIs the gate fails and the dense route takes 3 launches per
         iteration, on ECW's alternating packed ERIs 1; the two agree to
         1e-5 Ha, iterations +-1;
     (c) C2H2/cc-pVDZ with ladder_mode='dense': f32 on dense alternating
         device ERIs, 2 launches per iteration of the 196x3844x3844 GEMM,
         against phase 5's f32 solve (1e-5 Ha, +-1 iteration); f64 on the
         card against the CPU (same iterations, 1e-9 Ha);
 10. correlated targets and the CCS ground state:
     (a) C2H2/cc-pVDZ f32 through ECW.Build_GS_exp('mat', 'CCSD(T)', field)
         (sorted sectored target build: CCSD solve, (T) loops, response
         density by the adjoint) and ECW.CCSD_GS over lambda = 0, 0.25,
         0.5: E_CCSD, E_T, the iterations and seconds of each stage, peak
         memory, Tr(target) = N to 1e-5, Delta falling with lambda, and
         the forward and backward ladder launches exactly as the iteration
         counts predict; then the stages of an f32 CCSD(T) target (no
         field) on ERIs built both ways (sorted sectored as Gexp builds
         them, and alternating packed with the dense (T) loop), twice each
         in turns, for their seconds;
     (b) the CCSD(T) target at f64 on the card against the CPU at
         C2H2/6-31G (E_CCSD and E_T to 1e-10, the density to 1e-8, equal
         adjoint iterations), and at cc-pVDZ f32 against f64 on the card
         (1e-5 Ha, density 1e-4);
     (c) the kernel's gradient: torch.autograd.grad of sum(ladder_mm(a, w)
         * g) against that of a @ w.T, w symmetric, f32 and f64, at
         98x961x961, 392x1891x1891 and a ragged shape, through autograd
         and through torch.func.vjp, with a zero-padded operand, and
         with an operand not declared symmetric (every backward a launch);
         and through the f32 vvvv block as it is built on the card
         (symmetric to roundoff only), declared symmetric, against the
         transposed-copy route, to 1e-5 * max|dA|;
     (d) C2H2/cc-pVTZ f32 on phase 7's molecule: solve_ccsd, then the (T)
         energy dense, sector-blocked and with bf16 slabs (relative errors
         and ms), then the CCSD(T) response density, on the sorted
         sectored and on the alternating packed ERIs, with seconds and
         peak memory;
     (e) ECW.CCS_GS over lambda = 0, 0.25, 0.5 against a CCSD target at
         cc-pVDZ: f64 on the card equal to the CPU (same target), and f32
         within 1e-5 Ha of them; then Newton (the Jacobian by
         forward-mode AD, its columns a chunked vmap of torch.func.jvp)
         and the L1 proximal-gradient solve at C2H2/6-31G, f64 on the
         card equal to the CPU; and Newton at C2H2/cc-pVDZ f64 on the
         card (1736 columns in chunks sized from free memory) within
         1e-6 Ha of the SCF solve;
 11. excited states (the coupled ECW-CCS n-state solve; it launches no
     hand-written kernel: CCS reads no vvvv block):
     (a) ECW('h2o', '6-31++g**') with two transition-dipole targets ->
         CCS_ES(0.1, method='device', diis='all', conv='rl', 1e-5,
         maxdiis=20): f32 on the card must converge to 7.134 and 10.07 eV
         (+-0.01); f64 on the card and on the CPU take equal iterations and
         agree to 1e-9 Ha; f32 within 1e-5 Ha and +-2 iterations of f64
         (printed beside the JAX package's 19, which this run reproduces
         when its SCF orbitals carry the same signs);
     (b) on the same system at f64 on the card: method='scf' equals
         'device' in iterations and to 1e-9 Ha; method='diag' at lambda =
         0, exact and with davidson=True, converges, and each of its
         energies is an eigenvalue of the singles matrix at its amplitudes
         to 1e-6 Ha;
     (c) acetylene at cc-pVDZ and cc-pVTZ (nocc 14, nvir 62 / 162; trans-
         bent by 20 degrees, which lifts the degeneracy of the linear
         molecule's excited states), two valence states with the
         transition dipoles of the two lowest bright TDHF roots as targets
         (at cc-pVDZ the MOM delta-SCF targets are tried first and
         printed): the sweep
         lambda = 0, 0.05, 0.1 with L_loop=True, method='device', to 2e-6
         in 'rl', at f32
         and at f64 on ERIs built on the card from the same SCF: every
         lambda converges, Ep per state within 1e-5 Ha, Delta falling from
         lambda = 0 to 0.1 for each transition; set-up seconds, sweep ms,
         ms per iteration of a 20-iteration chain, peak memory, and the
         device operations per iteration with one and with two excited
         states (torch.profiler), the second adding under 30%, and the
         synchronizing calls per iteration, named by their Python line:
         one, the read of the convergence scalar (the profiler's
         device-to-host copies per iteration printed beside it);
     (d) davidson_device on the R1 map of (c)'s cc-pVTZ system (n = o*v),
         3 roots, f64 and f32 with the Ms = 0 projector, against
         numpy.linalg.eig of the explicit matrix (1e-9 and 1e-5); the f32
         run without a projector, printed; and an operator with a
         structural null space (n = 2304), where f32 needs the projector;
  12. the precision modes of the CCSD solve (config.iter_precision):
     (a) C2H2/cc-pVDZ, the f32 ECW.CCSD_GS sweep over lambda = 0, 0.25,
         0.5 on the packed route under 'highest', 'high', 'default',
         'bf16', 'hybrid' (fast leg 'high', and 'bf16'), and with
         refine=True after 'highest', 'high' and 'bf16' (the polish on
         ECW.eris_f64, built on the card; no host ERIs), each against the
         f64 sweep on those ERIs (converged to 1e-9): iterations,
         ms per iteration, solve ms, |dEp|, the legs of each solve, and
         the ladder launches by variant, which must equal one per
         iteration in its mode's variant ('highest' f32, 'high' and
         'default' TF32, 'bf16' BF16) plus 2 f64 per polish iteration; a
         30-iteration chain per mode gives its ms per iteration and the
         Dconv at which it stalls, and raw 'default' and 'bf16' run at
         three times that (1e-6 at least) and do not fail on it; 'highest',
         'high' and both hybrids must converge to 1e-6, refine after
         'highest' and 'high' must be within 1e-8 Ha of f64 and each
         hybrid within 1e-5;
     (b) C2H2/cc-pVTZ at lambda = 0.25 (phase 7's ECW): 'bf16' with and
         without refine, and both hybrids, the same way, and the chains of
         'highest', 'high' and 'bf16' (ms per iteration; every chain's
         launches exactly one per iteration in its mode's variant);
  13. EOM-CCSD (the sigmas by torch.func.jvp / vjp of the CCSD residual,
     whose ladder launches the kernel forward, for the tangent and
     backward):
     (a) the JAX package's EOM bench rows, C2H2/cc-pVDZ f32 on ECW's ERIs
         (alternating, a PackedVVVV), solve_ccsd(conv_tol=1e-8), then
         eom_ccsd(nroots=1), eom_ccsd(nroots=2, left=True),
         eom_ip_ccsd(nroots=2), eom_ea_ccsd(nroots=1), tol 1e-5: energies
         within 0.005 eV of BENCH_r05's 5.51, 6.682, 11.315 and 4.493 eV;
         the same solves at f64 on ERIs built on the card (tol 1e-7)
         within 1e-5 Ha per root; <L_j|R_k> = delta_jk to 1e-5 (1e-4 off
         the diagonal); per solve the Davidson cycles and matvecs, the
         ladder launches (forward, tangent, backward) exactly as the
         matvecs predict (one product per matvec on this route, none for
         IP), peak memory, and the warm solve ms (median of 3);
     (b) the same four solves at f64 at C2H2/6-31G (the dense ladder, the
         kernel at 196x900x900), card against CPU: roots to 1e-9 Ha, equal
         cycles and matvecs, the card's launches as predicted;
     (c) ECW(trans-bent acetylene, cc-pVDZ).Build_ES_exp_EOM(2, 'trdip')
         at f32 (the sorted sectored ESexp.EOM: three products per
         matvec) and at f64 on the card: launches as the iteration and
         matvec counts predict, Tr(gamma_es) = N to 1e-5, the f32 roots
         and oscillator strengths within 1e-5 Ha and 1e-4 of f64; then
         CCS_ES over lambda = 0, 0.05, 0.1 (method='device', L_loop=True)
         on the f32 states, with their 'trdip' targets (printed: the two
         roots are triplets, whose transition dipoles vanish) and with
         their transition densities ('trmat'), where every lambda must
         converge;
  14. (run after 9) the batched lambda sweep, ECW.CCSD_GS(mode='parallel')
     (Solver_CCSD.SCF_batch: every lambda a lane of one vmapped iteration
     step, each ladder product one launch for all lanes, cold starts),
     each lane held to a cold-start sequential solve at its lambda:
     (a) C2H2/cc-pVDZ f32 on phase 4's ECW (packed route), lambda = 0,
         0.25, 0.5 and then an 8-lane grid over [0, 0.5] (M = 3136): every
         lane converged within 1e-5 Ha and +-1 iteration of its cold
         start, exactly one ladder launch per batched iteration; the
         batched sweep's ms, ms per batched iteration, per-lane
         iterations and peak memory beside the warm-started and the
         cold-start sequential sweeps;
     (b) f64 at C2H2/6-31G: the batch on the card equal to the batch on
         the CPU (1e-9 Ha, equal iterations per lane) and to the card's
         cold-start sequential solves (1e-9 Ha, equal iterations);
     (c) C2H2/cc-pVTZ f32 on phase 7's ECW, checked as (a), with solve
         ms, ms per batched iteration, peak memory and the busy share of a
         10-iteration batched chain (--profile's method);
     (d) the sorted sectored route at cc-pVDZ batched with the mirror
         symmetry (2 launches per batched iteration), then 'high' and
         'hybrid' batched on the packed route, launching each leg's
         variant once per batched iteration; every hybrid lane within
         1e-5 Ha of its 'highest' cold start;
     (e) synchronizing calls per iteration by Python line
         (torch.cuda.set_sync_debug_mode('warn'), two chains differenced)
         of a 3-lane batched chain and of the sequential CCSD chain:
         exactly one each, the loop test of solvers/gs.py;
 15. (run after 14) the multi-device layer (ecw_cc_torch/parallel) on a
     world-size-1 NCCL group started in the process (mesh dp 1 x tp 1 on
     the card; NCCL takes no second rank on one card):
     (a) C2H2/cc-pVDZ f32 at lambda = 0.25 on the packed route (phase 4's
         ECW ERIs) and on the sorted sectored route with the mirror
         symmetry, each solved whole and with ERIs, ladder operand and
         amplitudes split (shard_eris, shard_vvvv_op, amp_shardings):
         equal iterations, |dEp| <= 1e-9 Ha, ladder launches per
         iteration unchanged (1 packed, 2 sectored), every one on the
         rank's rows; the collectives counted (CommDebugMode, and their
         shapes), none on the operand; ms per iteration of both;
     (b) the shard launches at cc-pVTZ's packed shape (M = 392, p =
         13041, f32) for tp = 2, 4 and 8, side by side in one process: each
         rank's rows (6521, 3261, 1631 after padding) launched, the columns
         concatenated, equal to the whole launch to 1e-5 * max|C|; the
         shard backward (one launch on the rows as they are) equal to
         dC @ B; the bytes per rank; each shard shape checked and timed
         beside cuBLAS by phase 3's method;
     (c) energy_t_sect over the mesh equal to the call without one, on
         (a)'s sorted ERIs and amplitudes;
     (d) the shard product's rules on the card: ladder_mm on a RowShard
         of a symmetric 1891 x 1891 operand, forward, backward
         (autograd), tangent (torch.func.jvp) and 3 vmapped lanes against
         the plain product (1e-5 * max|ref|), with the launches each rule
         predicts, every one on the rows;
  8. (run last) neither JAX nor the JAX package ecw_cc_tpu was imported,
     and the excited-state and EOM modules were.
Before the last line it prints the kernel report as one JSON object and
the card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Kernel times are device times: a sleep kernel holds the stream while the
host enqueues a run of TIMING_LAUNCHES back-to-back launches between two
CUDA events, so the run's time over its count excludes the host's enqueue;
the median of TIMING_RUNS runs, kernel and plain in turns.  Where B is
large enough to matter against the 50 MB L2 (the cc-pVTZ shapes), the
launches cycle through copies of the operands that together exceed twice
the L2, so B comes from device memory as it does in the solve.  The host's
own cost per call (no sync between calls) is printed beside it.  Each
shape's bound is the larger of 2MNK over the published 67 TFLOP/s (FP32,
and FP64 on the tensor cores, H100 SXM) and one pass over A, B and C over
3.35 TB/s.
"""

import collections
import contextlib
import copy
import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

MOLECULE, BASIS = "c2h2", "cc-pvdz"
BASIS_TZ = "cc-pvtz"
FIELD = [0.05, 0.01, 0.0]
LAMBDAS = [0.0, 0.25, 0.5]
CONV_THRES = 1e-6
CHAIN_ITERS = 40
CHAIN_ITERS_TZ = 19          # maxiter 19: a 20-iteration chain
CHAIN_REPS = 5               # --chain: timed runs of each chain
CHAIN_OPS_ITERS = (4, 12)    # --chain: two profiled chains, differenced
PROFILE_ITERS = 10
DTYPES = (torch.float32, torch.float64)
MAIN_SHAPES = [(98, 465, 465), (98, 961, 961)]          # (M, N, K), pVDZ
TZ_SHAPES = [(98, 3240, 3240), (98, 6561, 6561)]        # cc-pVTZ
# phase 9's routes (C2H2, nocc 14): the dense ladder at cc-pVDZ, the
# stacked packed GEMM at cc-pVDZ and cc-pVTZ, the stacked sector GEMMs
DENSE_DZ, PACKED_DZ, PACKED_TZ = ((196, 3844, 3844), (392, 1891, 1891),
                                  (392, 13041, 13041))
ROUTE_SHAPES = [DENSE_DZ, PACKED_DZ, PACKED_TZ, (392, 465, 465),
                (392, 961, 961)]
# phase 12's f64 polish (refine=True): the dense ladder, twice an
# iteration, at cc-pVTZ (at cc-pVDZ it is DENSE_DZ)
POLISH_TZ = (196, 26244, 26244)
F64_SHAPES = [POLISH_TZ]     # checked and timed in f64 only
# phase 13's EOM sigmas at C2H2/cc-pVDZ (nocc 14): the EE ladder on the
# packed route (every occupied pair: 196 rows; forward, tangent and
# backward) and the EA ladder (one row per occupied orbital: 14); on the
# sorted layout the sectored EE sigma's three products per matvec, every
# occupied pair (alpha-alpha and beta-beta 465, alpha-beta 961)
EOM_SHAPES = [(196, 1891, 1891), (14, 1891, 1891), (196, 465, 465),
              (196, 961, 961)]
# phase 14's batched sweeps: the lambda lanes stacked into M of each
# ladder product (3 lanes of the packed route at cc-pVDZ and cc-pVTZ, the
# 8-lane cc-pVDZ grid, 3 lanes of the sectored route's mirror-symmetric
# sector GEMMs at cc-pVDZ and cc-pVTZ and of the sorted dense route's
# stacked sectors)
BATCH_SHAPES = [(1176, 1891, 1891), (3136, 1891, 1891), (1176, 13041, 13041),
                (294, 465, 465), (294, 961, 961), (294, 3240, 3240),
                (294, 6561, 6561), (1176, 465, 465), (1176, 961, 961)]
BATCH_TC_SHAPES = [(1176, 1891, 1891), (1176, 13041, 13041)]
TIMED_SHAPES = {torch.float32: MAIN_SHAPES + TZ_SHAPES + ROUTE_SHAPES
                + EOM_SHAPES + BATCH_SHAPES,
                torch.float64: MAIN_SHAPES + TZ_SHAPES + [DENSE_DZ,
                                                          PACKED_TZ]
                + F64_SHAPES + EOM_SHAPES}
# phase 10's target builds (C2H2, 196 occupied pairs, one ladder at a time):
# the packed GEMM at cc-pVDZ and cc-pVTZ, the dense one at 6-31G (nvir 30)
TARGET_SHAPES = [(196, 1891, 1891), (196, 13041, 13041), (196, 900, 900)]
RAGGED_SHAPES = [(1, 1, 1), (37, 513, 129), (100, 130, 1001)]
# The split-K plan's edges: K across 16 chunks (split 8 -> 16 at N = 465)
# and 17, K across a chunk boundary at N = 961, K below one chunk, one row,
# and M = 129 (two row tiles).
EDGE_SHAPES = [(98, 465, 240), (98, 465, 241), (98, 465, 256), (98, 465, 257),
               (98, 961, 959), (98, 961, 960), (98, 465, 15), (98, 465, 17),
               (1, 961, 961), (129, 465, 465), (129, 961, 961)]
# The tensor-core variants' 128 x 128 tile: one row tile and one past it
# (64, 65, 128, 129), the four-tile cluster (392), K 1-3 past a multiple of
# 8 (457-459) and of 4 (461-463, 1889), K across the 256-deep accumulator
# runs (255-257) and within one chunk (31, 33)
TC_EDGE_SHAPES = [(64, 465, 465), (65, 465, 465), (128, 961, 961),
                  (129, 961, 961), (392, 961, 961 - 4), (98, 465, 457),
                  (98, 465, 458), (98, 465, 459), (98, 465, 461),
                  (98, 465, 462), (98, 465, 463), (392, 1891, 1889),
                  (98, 465, 255), (98, 465, 256), (98, 465, 257),
                  (98, 465, 31), (98, 465, 33)]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}       # x max|C_ref|
ERI_TOL = {torch.float64: 1e-10, torch.float32: 3e-6}   # max abs vs host f64
TIMING_RUNS = 10
TIMING_LAUNCHES = 50
HOST_CALLS = 200
SLEEP_CYCLES = 20_000_000   # ~11 ms at 1.8 GHz: longer than any enqueue run
L2_BYTES = 50 * 2 ** 20
COLD_B_BYTES = 8 * 2 ** 20  # a B this large is timed cold (cycled copies)
DEVICE_RNG_ELEMENTS = 10 ** 8   # operands this large are drawn on the card
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
# dense peak FLOP/s of each kernel variant on an H100 SXM (NVIDIA's data
# sheet): FP32 on the CUDA cores and FP64 on the tensor cores 67 T, TF32
# 494 T, BF16 989 T; and the bytes of one element
VARIANT_PEAK = {"f32": 67e12, "f64": 67e12, "tf32": 494e12, "bf16": 989e12}
VARIANT_BYTES = {"f32": 4, "f64": 8, "tf32": 4, "bf16": 2}
TC_VARIANTS = ("tf32", "bf16")       # the tensor-core variants (phase 3, 12)


def _json_value(x):
    """NumPy arrays and scalars, and tensors, as JSON values."""
    return x.tolist() if hasattr(x, "tolist") else float(x)


def phase(n, name, **fields):
    print(json.dumps({"phase": n, "name": name, **fields},
                     default=_json_value), flush=True)


@contextlib.contextmanager
def timed(n, seconds):
    """Record phase n's host seconds into `seconds` and print them."""
    t0 = time.perf_counter()
    yield
    seconds[n] = time.perf_counter() - t0
    phase(n, "phase_seconds", seconds=seconds[n])


def bound(shape, dtype):
    """(ms, 'operations' or 'bytes'): the least time the card could take
    for C = A @ B.T at `shape`, one pass over A, B and C, for a torch
    dtype (its full-precision variant) or a variant name."""
    v = dtype if isinstance(dtype, str) else {
        torch.float32: "f32", torch.float64: "f64"}[dtype]
    M, N, K = shape
    t_ops = 2 * M * N * K / VARIANT_PEAK[v]
    t_bytes = (M * K + N * K + M * N) * VARIANT_BYTES[v] / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def operands(shape, dtype, seed):
    M, N, K = shape
    if (M + N) * K > DEVICE_RNG_ELEMENTS:
        # drawn on the card: the host takes seconds for a 5 GB operand
        g = torch.Generator("cuda").manual_seed(seed)
        return tuple(torch.randn(n, K, generator=g, device="cuda",
                                 dtype=dtype) for n in (M, N))
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((M, K)), dtype=dtype).cuda()
    b = torch.as_tensor(rng.standard_normal((N, K)), dtype=dtype).cuda()
    return a, b


def tag(shape):
    return "x".join(map(str, shape))


def sass_counts(path):
    """{kernel name: Counter of DMMA/HMMA/HGMMA/UTMALDG/FFMA} from
    cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
        elif fn is not None:
            for op in re.findall(r"\b(DMMA|HMMA|HGMMA|UTMALDG|FFMA)\b",
                                 line):
                counts[fn][op] += 1
    return counts


# each kernel variant's functions in the SASS, by mangled template name
SASS_NAMES = {"f32": "ladder_mm_ntIf", "f64": "ladder_mm_ntId",
              "tf32": "ladder_mm_tcIf", "bf16": "ladder_mm_tcI13__nv_bfloat16"}


def check_sass(path):
    """Per kernel function: every f64 ladder_mm instance runs DMMA; no f32
    one touches the tensor cores (no TF32, no HMMA or HGMMA); the TF32 and
    BF16 variants run wgmma (HGMMA) on operands loaded by TMA (UTMALDG)."""
    counts = sass_counts(path)
    by = {v: {n: dict(c) for n, c in counts.items() if key in n}
          for v, key in SASS_NAMES.items()}
    if not all(by.values()):
        raise AssertionError(f"ladder_mm kernels not found in SASS: "
                             f"{sorted(counts)}")
    if not all(c.get("DMMA", 0) for c in by["f64"].values()):
        raise AssertionError(f"an f64 ladder_mm runs no DMMA: {by['f64']}")
    if any(c.get("HMMA", 0) or c.get("DMMA", 0) or c.get("HGMMA", 0)
           for c in by["f32"].values()):
        raise AssertionError(f"an f32 ladder_mm uses tensor cores: "
                             f"{by['f32']}")
    for v in TC_VARIANTS:
        if not all(c.get("HGMMA", 0) and c.get("UTMALDG", 0)
                   for c in by[v].values()):
            raise AssertionError(f"a {v} ladder_mm runs no HGMMA or no "
                                 f"UTMALDG: {by[v]}")
    return {v: list(c.values()) for v, c in by.items()}


def plan_fields(p):
    return {"tile": [p.bm, p.bn, p.bk], "tiles": [p.m_tiles, p.n_tiles],
            "split_k": p.split, "cluster_m": getattr(p, "cluster_m", 1),
            "blocks": p.blocks}


def check_kernel(ladder_mm, ladder_mm_ref, device_plan, n_sm, only=None):
    """Kernel against plain at every shape; the cc-pVDZ shapes' plans fill
    the card (the cc-pVTZ ones run about 1.5 waves and are only printed).
    only: these f32 shapes alone.  Returns {(dtype, shape): (max_abs_err,
    plan)}."""
    out = {}
    for dtype in DTYPES[:1] if only else DTYPES:
        for i, shape in enumerate(only or dict.fromkeys(
                MAIN_SHAPES + TZ_SHAPES + ROUTE_SHAPES + TARGET_SHAPES
                + RAGGED_SHAPES + EDGE_SHAPES
                + (F64_SHAPES if dtype == torch.float64 else BATCH_SHAPES)
                + EOM_SHAPES)):
            a, b = operands(shape, dtype, seed=i)
            c = ladder_mm(a, b)
            torch.cuda.synchronize()
            ref = ladder_mm_ref(a, b)
            torch.cuda.synchronize()
            err = float((c - ref).abs().max())
            scale = float(ref.abs().max())
            ok = bool(torch.isfinite(c).all()) and err <= TOL[dtype] * scale
            p = device_plan(*shape, dtype, a.device)
            phase(3, "kernel_vs_plain", dtype=str(dtype), shape=shape,
                  max_abs_err=err, max_abs_ref=scale, ok=ok,
                  waves=p.blocks / n_sm, **plan_fields(p))
            if not ok:
                raise AssertionError(f"ladder_mm disagrees at {shape} "
                                     f"{dtype}: {err} > {TOL[dtype]} * "
                                     f"{scale}")
            if (shape in MAIN_SHAPES + ROUTE_SHAPES + BATCH_SHAPES
                    and p.blocks < n_sm):
                raise AssertionError(f"plan at {shape} {dtype} launches "
                                     f"{p.blocks} blocks on {n_sm} SMs")
            out[(dtype, shape)] = (err, p)
    return out


# phase 3's tangent check: the EE and EA sigma shapes of phase 13 and a
# ragged one
TANGENT_SHAPES = [(196, 1891, 1891), (14, 1891, 1891), (37, 129, 129)]


def check_kernel_tangent(ladder_mm, ladder_mm_ref):
    """torch.func.jvp of ladder_mm(a, w) in a against that of a @ w.T, f32
    and f64, w symmetric (declared so) and not: the primal and the tangent
    to TOL * max|C|, and each jvp exactly one forward and one tangent
    launch.  Returns {(dtype, shape, symmetric): max abs error of the
    tangent}."""
    out = {}
    for dtype in DTYPES:
        for i, shape in enumerate(TANGENT_SHAPES):
            M, N, K = shape
            rng = np.random.default_rng(300 + i)
            a, da = (torch.as_tensor(rng.standard_normal((M, K)),
                                     dtype=dtype, device="cuda")
                     for _ in range(2))
            w = torch.as_tensor(rng.standard_normal((N, K)), dtype=dtype,
                                device="cuda")
            for symmetric, op in ((True, (w + w.T).contiguous()),
                                  (False, w)):
                c0, dc0 = torch.func.jvp(lambda x: ladder_mm_ref(x, op),
                                         (a,), (da,))
                (c, dc), n = count_all(ladder_mm, lambda: torch.func.jvp(
                    lambda x: ladder_mm(x, op, symmetric=symmetric), (a,),
                    (da,)))
                torch.cuda.synchronize()
                err = float((dc - dc0).abs().max())
                err_c = float((c - c0).abs().max())
                scale = float(dc0.abs().max())
                ok = (err <= TOL[dtype] * scale
                      and err_c <= TOL[dtype] * float(c0.abs().max())
                      and tuple(n) == (1, 1, 0))
                phase(3, "kernel_tangent", dtype=str(dtype), shape=shape,
                      symmetric=symmetric, max_abs_err=err,
                      max_abs_ref=scale, primal_max_abs_err=err_c,
                      launches_fwd_tan_back=n, ok=ok)
                if not ok:
                    raise AssertionError(
                        f"ladder_mm tangent at {shape} {dtype} symmetric="
                        f"{symmetric}: {err} against {TOL[dtype]} * {scale}"
                        f" (primal {err_c}), launches {n}")
                out[(dtype, shape, symmetric)] = err
    return out


def check_deterministic(ladder_mm):
    """Two launches on the same inputs give the same bits; so does a launch
    captured in a CUDA graph on a side stream, replayed twice."""
    for dtype in DTYPES:
        for shape in MAIN_SHAPES + TZ_SHAPES + ROUTE_SHAPES:
            a, b = operands(shape, dtype, seed=11)
            c1, c2 = ladder_mm(a, b), ladder_mm(a, b)
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                ladder_mm(a, b)   # warm-up on the capture stream
            s.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                cg = ladder_mm(a, b)
            replays = []
            for _ in range(2):
                cg.fill_(float("nan"))
                g.replay()
                torch.cuda.synchronize()
                replays.append(bool(torch.equal(cg, c1)))
            bitwise = bool(torch.equal(c1, c2))
            phase(3, "kernel_deterministic", dtype=str(dtype), shape=shape,
                  bitwise=bitwise, graph_replays_equal=replays)
            if not (bitwise and all(replays)):
                raise AssertionError(f"ladder_mm is not deterministic at "
                                     f"{shape} {dtype}: {bitwise}, "
                                     f"{replays}")


def device_run_ms(fn, n):
    """Device ms per launch of n back-to-back launches of fn."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)   # the enqueue below ends before it does
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def host_us(fn, n):
    """Host µs per call, n calls with no sync in between."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def time_kernel(ladder_mm, ladder_mm_ref, only=None):
    """{(dtype, shape): times} for the kernel and a @ b.T at TIMED_SHAPES
    (only: these f32 shapes alone).  The plain version is one library call
    (cuBLAS), so its time is also the report's library_ms."""
    times = {}
    for dtype in DTYPES[:1] if only else DTYPES:
        for shape in only or TIMED_SHAPES[dtype]:
            a, b = operands(shape, dtype, seed=0)
            b_bytes = b.numel() * b.element_size()
            n_copies = (-(-2 * L2_BYTES // b_bytes)
                        if b_bytes >= COLD_B_BYTES else 1)
            ops = [(a, b)] + [(a.clone(), b.clone())
                              for _ in range(n_copies - 1)]
            turn = [0]

            def args():
                turn[0] += 1
                return ops[turn[0] % n_copies]

            def kern():
                return ladder_mm(*args())

            def plain():
                return ladder_mm_ref(*args())

            for _ in range(5):
                kern()
                plain()
            torch.cuda.synchronize()
            runs = {kern: [], plain: []}
            for i in range(TIMING_RUNS):   # plain, kernel, kernel, plain, ...
                for fn in ((plain, kern) if i % 2 == 0 else (kern, plain)):
                    runs[fn].append(device_run_ms(fn, TIMING_LAUNCHES))
            bound_ms, bound_by = bound(shape, dtype)
            t = {"ms": statistics.median(runs[kern]),
                 "plain_ms": statistics.median(runs[plain]),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "operand_copies": n_copies,
                 "ms_runs": runs[kern], "plain_ms_runs": runs[plain],
                 "host_us": host_us(kern, HOST_CALLS),
                 "plain_host_us": host_us(plain, HOST_CALLS)}
            times[(dtype, shape)] = t
            phase(3, "kernel_time", dtype=str(dtype), shape=shape,
                  runs=TIMING_RUNS, launches_per_run=TIMING_LAUNCHES, **t)
    return times


def variant_operands(lmm, shape, var, seed):
    """(a, b, precision) on the card for a tensor-core variant; B is held
    as the solver holds its per-solve copy (bf16_rows, tf32_rows: rows
    padded to 16 bytes, TF32 values rounded), A contiguous as it comes,
    so its per-call preparation is part of the timed call."""
    dtype = torch.bfloat16 if var == "bf16" else torch.float32
    a, b = operands(shape, dtype, seed)
    b = variant_rows(lmm, var)(b)
    return a, b, ("tf32" if var == "tf32" else None)


def variant_rows(lmm, var):
    """The per-solve copy of a variant's B (an older checkout without
    tf32_rows holds a TF32 B as it is)."""
    if var == "bf16":
        return lmm.bf16_rows
    return getattr(lmm, "tf32_rows", lambda b: b)


def variant_error(lmm, a, b, c, var):
    """(max |C - plain|, max |plain|, bound).  TF32: against the plain
    version (the same rounded operands, f32 sums in another order) to
    1e-5 max|C|.  BF16: against the plain version's f32 sum before its one
    rounding to bf16, to 2^-8 max|C| (the rounding) plus the f32
    accumulation bound K 2^-24 max(|A| |B|^T)."""
    from ecw_cc_torch.config import matmul_precision

    with matmul_precision("highest"):
        if var == "tf32":
            ref = lmm.ladder_mm_plain(a, b, "tf32")
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            tol = 1e-5 * scale
        else:
            af, bf = a.float(), b.float()
            ref = af @ bf.T
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            acc = float((af.abs() @ bf.abs().T).max()) if ref.numel() else 0
            tol = 2 ** -8 * scale + a.shape[1] * 2 ** -24 * acc
    err = float((c.float() - ref).abs().max()) if ref.numel() else 0.0
    return err, scale, tol


def check_variants(lmm, n_sm, only=None):
    """Phase 3 for the TF32 and BF16 variants: each against its plain
    version at every shape of the f32 check (only: these shapes alone,
    unchecked for determinism); two launches bitwise equal and a
    CUDA-graph replay at the solver's shapes.  Returns {(variant, shape):
    (max_abs_err, plan)}."""
    out = {}
    for var in TC_VARIANTS:
        for i, shape in enumerate(only or (
                MAIN_SHAPES + TZ_SHAPES + ROUTE_SHAPES + TARGET_SHAPES
                + RAGGED_SHAPES + EDGE_SHAPES + TC_EDGE_SHAPES
                + BATCH_TC_SHAPES)):
            a, b, prec = variant_operands(lmm, shape, var, seed=i)
            c = lmm.ladder_mm(a, b, precision=prec)
            torch.cuda.synchronize()
            err, scale, tol = variant_error(lmm, a, b, c, var)
            ok = bool(torch.isfinite(c).all()) and err <= tol
            p = lmm.device_plan(*shape, var, a.device)
            phase(3, "variant_vs_plain", variant=var, shape=shape,
                  dtype=str(c.dtype), max_abs_err=err, max_abs_ref=scale,
                  bound=tol, ok=ok, waves=p.blocks / n_sm, **plan_fields(p))
            if not ok:
                raise AssertionError(f"ladder_mm {var} disagrees at {shape}: "
                                     f"{err} > {tol}")
            if (var == "tf32" and not only
                    and i < len(MAIN_SHAPES + TZ_SHAPES)
                    and hasattr(lmm, "tf32_rows")):
                # a raw B in 16-byte rows (rounded by the kernel, as the
                # dense route's vvvv view is) gives the bits of its
                # tf32_rows copy
                b_raw = operands(shape, torch.float32, seed=i)[1]
                raw = lmm.ladder_mm(a, lmm._padded(b_raw, torch.float32, 4),
                                    precision=prec)
                if not torch.equal(raw, c):
                    raise AssertionError(f"tf32 at {shape}: the kernel's "
                                         "rounding of B differs from "
                                         "tf32_rows")
            out[(var, shape)] = (err, p)
        for shape in [] if only else MAIN_SHAPES + ROUTE_SHAPES:
            a, b, prec = variant_operands(lmm, shape, var, seed=11)
            c1 = lmm.ladder_mm(a, b, precision=prec)
            c2 = lmm.ladder_mm(a, b, precision=prec)
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                lmm.ladder_mm(a, b, precision=prec)
            s.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                cg = lmm.ladder_mm(a, b, precision=prec)
            replays = []
            for _ in range(2):
                cg.fill_(float("nan"))
                g.replay()
                torch.cuda.synchronize()
                replays.append(bool(torch.equal(cg, c1)))
            bitwise = bool(torch.equal(c1, c2))
            phase(3, "variant_deterministic", variant=var, shape=shape,
                  bitwise=bitwise, graph_replays_equal=replays)
            if not (bitwise and all(replays)):
                raise AssertionError(f"ladder_mm {var} is not deterministic "
                                     f"at {shape}: {bitwise}, {replays}")
    return out


def library_call(var):
    """One PyTorch call computing the variant's product (the yardstick;
    the port never calls it): cuBLAS with TF32 on (float32 matmul
    precision 'high'), or on bf16 tensors."""
    def tf32(a, b):
        torch.set_float32_matmul_precision("high")
        try:
            return a @ b.T
        finally:
            torch.set_float32_matmul_precision("highest")

    return tf32 if var == "tf32" else (lambda a, b: torch.matmul(a, b.T))


def time_variants(lmm, only=None):
    """{(variant, shape): times} for the TF32 and BF16 kernels, their plain
    versions and the library call at the solver's shapes (the kernel
    table's; only: these alone), by time_kernel's method, in turns."""
    times = {}
    for var in TC_VARIANTS:
        lib = library_call(var)
        for shape in only or (MAIN_SHAPES + TZ_SHAPES + ROUTE_SHAPES
                              + BATCH_TC_SHAPES):
            a, b, prec = variant_operands(lmm, shape, var, seed=0)
            b_bytes = b.shape[0] * b.stride(0) * b.element_size()
            n_copies = (-(-2 * L2_BYTES // b_bytes)
                        if b_bytes >= COLD_B_BYTES else 1)
            rows = variant_rows(lmm, var)
            ops = [(a, b)] + [(a.clone(), rows(b.clone()))
                              for _ in range(n_copies - 1)]
            turn = [0]

            def args():
                turn[0] += 1
                return ops[turn[0] % n_copies]

            fns = {"ms": lambda: lmm.ladder_mm(*args(), precision=prec),
                   "plain_ms": lambda: lmm.ladder_mm_plain(*args(), prec),
                   "library_ms": lambda: lib(*args())}
            for _ in range(5):
                for fn in fns.values():
                    fn()
            torch.cuda.synchronize()
            runs = {k: [] for k in fns}
            order = list(fns)
            for i in range(TIMING_RUNS):   # in turns, the order reversed
                for k in (order if i % 2 == 0 else order[::-1]):
                    runs[k].append(device_run_ms(fns[k], TIMING_LAUNCHES))
            bound_ms, bound_by = bound(shape, var)
            t = {k: statistics.median(v) for k, v in runs.items()}
            t.update(bound_ms=bound_ms, bound_by=bound_by,
                     operand_copies=n_copies,
                     host_us=host_us(fns["ms"], HOST_CALLS),
                     runs_ms={k: v for k, v in runs.items()})
            times[(var, shape)] = t
            phase(3, "variant_time", variant=var, shape=shape,
                  runs=TIMING_RUNS, launches_per_run=TIMING_LAUNCHES, **t)
    return times


def build_ecw(device, dtype, basis=BASIS):
    from ecw_cc_torch import ECW

    ecw = ECW(MOLECULE, basis, device=device, dtype=dtype)
    ecw.Build_GS_exp("mat", "HF", field=FIELD)
    return ecw


def solve(ecw, lambdas, **kw):
    res = ecw.CCSD_GS(lambdas, diis=kw.pop("diis", "tl"), conv="tl", **kw)
    return res, ecw.solve_log


def chain_ops(ecw, diis):
    """Device operations per iteration of --chain's chain: the difference
    of two profiled chains (CHAIN_OPS_ITERS), so that a solve's set-up and
    read-back cancel."""
    from torch.profiler import ProfilerActivity, profile

    got = []
    for n in CHAIN_OPS_ITERS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve(ecw, [0.25], diis=diis, conv_thres=0.0, maxiter=n - 1)
        got.append(sum(e.count for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")))
    return (got[1] - got[0]) / (CHAIN_OPS_ITERS[1] - CHAIN_OPS_ITERS[0])


def chain_times():
    """--chain: ms per iteration of the f32 main-path chain under the
    default precision (ECW's packed route, lambda = 0.25, conv_thres 0),
    without DIIS and with the sweep's 'tl' DIIS, at C2H2/cc-pVDZ and
    cc-pVTZ: one untimed run, then CHAIN_REPS timed, on the wall clock and
    in the process's CPU time (which other load on the host moves less),
    and the device operations per iteration (chain_ops).  It calls only ECW and
    CCSD_GS, so a copy of this script times an older checkout the same
    way."""
    for basis, iters in ((BASIS, CHAIN_ITERS), (BASIS_TZ, CHAIN_ITERS_TZ)):
        ecw = build_ecw("cuda", torch.float32, basis=basis)
        for diis in ("", "tl"):
            runs, cpu = [], []
            for _ in range(CHAIN_REPS + 1):
                c0 = time.process_time()
                _, log = solve(ecw, [0.25], diis=diis, conv_thres=0.0,
                               maxiter=iters)
                its = log[-1]["iterations"]
                runs.append(log[-1]["ms"] / its)
                cpu.append((time.process_time() - c0) * 1e3 / its)
            phase("chain", "chain_f32", basis=basis, diis=diis,
                  route=log[-1]["route"], iterations=its,
                  ms_per_iteration=statistics.median(runs[1:]),
                  ms_per_iteration_runs=runs[1:], untimed_run=runs[0],
                  cpu_ms_per_iteration=statistics.median(cpu[1:]),
                  cpu_ms_per_iteration_runs=cpu[1:],
                  device_ops_per_iteration=chain_ops(ecw, diis))
        del ecw
        torch.cuda.empty_cache()


def with_eris(ecw, eris, vvvv_op, mo_perm):
    """A shallow copy of a built ECW that solves on other device ERIs (the
    same molecule, SCF and targets; ECW.fock stays the alternating one)."""
    out = copy.copy(ecw)
    out.eris, out.vvvv_op, out.myccsd = eris, vvvv_op, None
    out.mo_perm = mo_perm
    out.dtype = eris.oovv.dtype
    return out


def max_abs_diff(a, b):
    if a.numel() == 0 and b.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def sort_perm(ecw):
    """The spin-sorting MO permutation of an ECW's GHF."""
    from ecw_cc_torch.ops.ladder import spin_sort_perm

    return spin_sort_perm(ecw.mf.orbspin, ecw.nocc)


def check_eri_build(ecw):
    """Phase 6: build_eris_device at f64 and f32 on the card, alternating
    with a PackedVVVV (ECW's build) against the host f64 build_eris and
    pack_vvvv of its vvvv, and sorted with a SectoredVVVV against
    sorted_from_host, block by block.  Returns {layout dtype: error}."""
    from ecw_cc_torch.models.eris import (GEris, build_eris_device,
                                          sorted_from_host)
    from ecw_cc_torch.ops.ladder import pack_vvvv

    perm = sort_perm(ecw)
    alt = ecw.eris_host.to_device(dtype=torch.float64, device="cuda")
    refs = {"alternating": (alt, pack_vvvv(alt.vvvv)),
            "sorted": sorted_from_host(ecw.eris_host, perm,
                                       dtype=torch.float64, device="cuda")}
    del alt
    out = {}
    for layout, (ref, ref_op) in refs.items():
        for dtype in (torch.float64, torch.float32):
            timings = {}
            er, op = build_eris_device(ecw.mol, ecw.mf, dtype=dtype,
                                       device="cuda", pack_ladder=True,
                                       sort_spin=layout == "sorted",
                                       timings=timings)
            # the packed build's vvvv is a placeholder: its rows are op
            fields = [f for f in GEris._fields
                      if getattr(ref, f).shape == getattr(er, f).shape]
            errs = {f: max_abs_diff(getattr(er, f), getattr(ref, f))
                    for f in fields}
            errs.update({f"op.{f}": max_abs_diff(x, y) for f, x, y in
                         zip(op._fields, op, ref_op)})
            worst = max(errs.values())
            shapes_ok = (set(GEris._fields) - set(fields) <= {"vvvv"}
                         and all(x.shape == y.shape
                                 for x, y in zip(op, ref_op)))
            name = str(dtype).split(".")[-1]
            phase(6, "eri_build_vs_host", layout=layout, dtype=name,
                  max_abs_err=worst, tol=ERI_TOL[dtype],
                  worst_block=max(errs, key=errs.get), shapes_ok=shapes_ok,
                  **timings)
            if not shapes_ok or worst > ERI_TOL[dtype]:
                raise AssertionError(f"device ERI build ({layout}, {name}) "
                                     f"differs from the host build: {errs}")
            out[f"{layout} {name}"] = worst
            del er, op
    return out


def run_tz(ladder_mm):
    """Phase 7: the full-width C2H2/cc-pVTZ solve at f32 on device-built
    ERIs (ECW's packed route), and its f64 reference on packed ERIs built
    on the card.  Returns the ladder launches of the f32 solve."""
    from ecw_cc_torch.models.eris import build_eris_device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ecw = build_ecw("cuda", torch.float32, basis=BASIS_TZ)
    torch.cuda.synchronize()
    phase(7, "build_tz_f32", seconds=time.perf_counter() - t0,
          **ecw.timings, peak_bytes=torch.cuda.max_memory_allocated(),
          host_eris_built=ecw._eris_host is not None, nao=ecw.aosize,
          nmo=ecw.dim, nocc=ecw.nocc, nvir=ecw.nvir)
    if ecw._eris_host is not None:
        raise AssertionError("the f32 build made host G-format ERIs")

    torch.cuda.reset_peak_memory_stats()
    ladder_mm.launches = 0
    res, log = solve(ecw, [0.25], conv_thres=CONV_THRES)
    launches = ladder_mm.launches
    s32, ep32 = log[0], float(res[1][-1])
    phase(7, "solve_tz_f32", route=s32["route"],
          iterations=s32["iterations"], converged=s32["status"] == 1,
          Ep=ep32, Ep_total=ep32 + ecw.EHF, ms=s32["ms"],
          ladder_launches=launches,
          peak_bytes=torch.cuda.max_memory_allocated())
    if s32["status"] != 1 or s32["route"] != "packed":
        raise AssertionError(f"the cc-pVTZ f32 solve did not converge on "
                             f"the packed route: {s32}")
    if launches != s32["iterations"]:
        raise AssertionError(f"ladder kernel launched {launches} times in "
                             f"{s32['iterations']} cc-pVTZ iterations "
                             "(expected 1 each)")
    if not np.all(np.isfinite(res[4])) or res[4].shape != (ecw.dim,) * 2:
        raise AssertionError("cc-pVTZ rdm1 is not finite or has the wrong "
                             "shape")
    _, chain = solve(ecw, [0.25], diis="", conv_thres=0.0,
                     maxiter=CHAIN_ITERS_TZ)
    chain = chain[0]
    phase(7, "chain_tz_f32", iterations=chain["iterations"], ms=chain["ms"],
          ms_per_iteration=chain["ms"] / chain["iterations"])

    # the f64 reference: the same molecule, SCF, target and route, on f64
    # ERIs built on the card (the host route would hold 176^4 f64 on the
    # host)
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    er64, packed64 = build_eris_device(ecw.mol, ecw.mf, dtype=torch.float64,
                                       device="cuda", pack_ladder=True,
                                       timings=timings)
    build64_peak = torch.cuda.max_memory_allocated()
    ecw64 = with_eris(ecw, er64, packed64, None)
    torch.cuda.reset_peak_memory_stats()
    res64, log64 = solve(ecw64, [0.25], conv_thres=CONV_THRES)
    s64, ep64 = log64[0], float(res64[1][-1])
    dep = abs(ep32 - ep64)
    phase(7, "solve_tz_f64_vs_f32", iterations_f64=s64["iterations"],
          iterations_f32=s32["iterations"], converged=s64["status"] == 1,
          Ep_f64=ep64, dEp=dep, ms_f64=s64["ms"], build_f64=timings,
          build_f64_peak_bytes=build64_peak,
          solve_f64_peak_bytes=torch.cuda.max_memory_allocated())
    if s64["status"] != 1:
        raise AssertionError("the cc-pVTZ f64 solve did not converge")
    if abs(s64["iterations"] - s32["iterations"]) > 1 or dep > 1e-5:
        raise AssertionError(f"cc-pVTZ f32 solve differs from f64: "
                             f"{s32['iterations']} vs {s64['iterations']} "
                             f"iterations, |dEp| = {dep}")
    del ecw64, er64, packed64
    return launches, ecw, (ep32, s32["iterations"])


def check_route_solve(name, log, res, launches, route, per_iter,
                      ref=None, tol=1e-5, same_iterations=False):
    """A converged solve on `route` with `per_iter` ladder launches per
    iteration, finite rdm1 of the right shape, and (with ref = (Ep,
    iterations)) within tol of the reference and +-1 iteration of it (the
    same iterations with same_iterations)."""
    s0, ep = log[0], float(res[1][-1])
    fields = dict(route=s0["route"], iterations=s0["iterations"],
                  converged=s0["status"] == 1, Ep=ep, ms=s0["ms"],
                  ladder_launches=launches,
                  launches_per_iteration=launches / max(s0["iterations"], 1))
    if ref is not None:
        fields.update(Ep_ref=ref[0], dEp=abs(ep - ref[0]),
                      iterations_ref=ref[1])
    phase(9, name, **fields)
    if s0["status"] != 1:
        raise AssertionError(f"{name}: did not converge")
    if s0["route"] != route:
        raise AssertionError(f"{name}: took route {s0['route']}, not {route}")
    if launches != per_iter * s0["iterations"]:
        raise AssertionError(f"{name}: {launches} ladder launches in "
                             f"{s0['iterations']} iterations (expected "
                             f"{per_iter} each)")
    dim = res[4].shape[0]
    if not np.all(np.isfinite(res[4])) or res[4].shape != (dim, dim):
        raise AssertionError(f"{name}: rdm1 not finite or not square")
    if ref is not None:
        dit = abs(s0["iterations"] - ref[1])
        if abs(ep - ref[0]) > tol or dit > (0 if same_iterations else 1):
            raise AssertionError(f"{name}: Ep {ep} in {s0['iterations']} "
                                 f"iterations against {ref}")
    return ep, s0["iterations"]


def run_sorted_tz(ladder_mm, ecw, ref):
    """Phase 9 (a): C2H2/cc-pVTZ f32 on sorted sectored ERIs built on the
    card, on phase 7's molecule, SCF and target.  Returns the launches."""
    from ecw_cc_torch.models.eris import build_eris_device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings, t0 = {}, time.perf_counter()
    er, sect = build_eris_device(ecw.mol, ecw.mf, dtype=torch.float32,
                                 device="cuda", pack_ladder=True,
                                 sort_spin=True, timings=timings)
    torch.cuda.synchronize()
    phase(9, "build_tz_f32_sorted", seconds=time.perf_counter() - t0,
          **timings, peak_bytes=torch.cuda.max_memory_allocated(),
          op_bytes=sum(w.numel() * w.element_size() for w in sect))
    srt = with_eris(ecw, er, sect, sort_perm(ecw))
    torch.cuda.reset_peak_memory_stats()
    ladder_mm.launches = 0
    res, log = solve(srt, [0.25], conv_thres=CONV_THRES)
    launches = ladder_mm.launches
    phase(9, "solve_tz_f32_sectored_memory",
          peak_bytes=torch.cuda.max_memory_allocated(), sym=log[0]["sym"])
    check_route_solve("solve_tz_f32_sectored", log, res, launches,
                      "sectored", 2, ref=ref)
    _, chain = solve(srt, [0.25], diis="", conv_thres=0.0,
                     maxiter=CHAIN_ITERS_TZ)
    chain = chain[0]
    phase(9, "chain_tz_f32_sectored", iterations=chain["iterations"],
          ms=chain["ms"], ms_per_iteration=chain["ms"] / chain["iterations"])
    return launches


def run_spin_mixing(ladder_mm, ecw32):
    """Phase 9 (b): C2H2/cc-pVDZ f32 with a target that couples the spins,
    on sorted ERIs (the gate fails: the dense route, 3 launches per
    iteration) and on ECW's alternating packed ERIs (1).  Returns the
    launches."""
    from ecw_cc_torch.models.eris import build_eris_device
    from ecw_cc_torch.ops.ccsd import GCC
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.solvers.gs import Solver_CCSD

    nmo = ecw32.dim
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((nmo, nmo)) * 1e-3
    target = np.diag(np.asarray(ecw32.mo_occ, dtype=np.float64))
    target = target + 0.5 * (mix + mix.T)      # couples alpha and beta
    er, sect = build_eris_device(ecw32.mol, ecw32.mf, dtype=torch.float32,
                                 device="cuda", pack_ladder=True,
                                 sort_spin=True)
    out, ref = {}, None
    for name, eris, op, perm, route, per_iter in (
            ("spin_mixing_sorted", er, sect, sort_perm(ecw32),
             "dense_sorted", 3),
            ("spin_mixing_packed", ecw32.eris, ecw32.vvvv_op, None,
             "packed", 1)):
        exp = Exp(0.05, [[["mat", target]]], mol=ecw32.mol,
                  mo_coeff=ecw32.mo_coeff)
        solver = Solver_CCSD(GCC(eris), exp, conv="tl",
                             conv_thres=CONV_THRES, diis="tl", maxiter=60,
                             vvvv_op=op, mo_perm=perm)
        if perm is not None and solver._vexp_block_diagonal():
            raise AssertionError("the spin-mixing target passed the gate")
        ladder_mm.launches = 0
        res = solver.SCF(0.05)
        out[f"c2h2_ccpvdz_f32_{name}"] = launches = ladder_mm.launches
        ref = check_route_solve(name, [solver.last_solve], res, launches,
                                route, per_iter, ref=ref)
    return out


def run_dense(ladder_mm, ecw32, ref32, ecw64c, ecwc):
    """Phase 9 (c): ladder_mode='dense' at C2H2/cc-pVDZ.  f32 on dense
    alternating device ERIs against phase 5's f32 solve; f64 on the card
    against the CPU.  Returns the launches."""
    import ecw_cc_torch
    from ecw_cc_torch.models.eris import build_eris_device

    out = {}
    ecw_cc_torch.set_config(ladder_mode="dense")
    try:
        er = build_eris_device(ecw32.mol, ecw32.mf, dtype=torch.float32,
                               device="cuda")
        v = er.nvir
        vr = er.vvvv.view(v * v, v * v)
        phase(9, "dense_vvvv_f32", vvvv_bytes=vr.numel() * vr.element_size(),
              pair_swap_asymmetry=float((vr - vr.T).abs().max()),
              max_abs=float(vr.abs().max()))
        ladder_mm.launches = 0
        res, log = solve(with_eris(ecw32, er, None, None), [0.25],
                         conv_thres=CONV_THRES)
        out["c2h2_ccpvdz_f32_dense"] = ladder_mm.launches
        check_route_solve("solve_dz_f32_dense", log, res, ladder_mm.launches,
                          "dense", 2, ref=ref32)
        ladder_mm.launches = 0
        res64, log64 = solve(ecw64c, [0.25], conv_thres=CONV_THRES)
        out["c2h2_ccpvdz_f64_dense"] = ladder_mm.launches
        ep64 = check_route_solve("solve_dz_f64_dense", log64, res64,
                                 ladder_mm.launches, "dense", 2)
        resc, logc = solve(ecwc, [0.25], conv_thres=CONV_THRES)
        check_route_solve("solve_dz_f64_dense_cpu", logc, resc, 0, "dense",
                          0, ref=ep64, tol=1e-9, same_iterations=True)
    finally:
        ecw_cc_torch.set_config(ladder_mode="auto")
    return out


GRAD_SHAPES = [(98, 961, 961), (392, 1891, 1891), (37, 129, 129)]
SMALL_BASIS = "6-31g"        # phase 10 (b): what the CPU finishes in ~1 min
CARD = "cuda"                # where phase 10 builds its targets


def fresh_targets(ecw):
    """A shallow copy of a built ECW without its targets."""
    out = copy.copy(ecw)
    out.exp_data, out.HF_prop = [[]], [[]]
    out.myccsd = out.myccs = None
    out.cal_rdm1_Delta, out.target_rdm1_GS = False, None
    return out


def count_launches(ladder_mm, fn):
    """(result of fn(), forward launches, backward launches)."""
    ladder_mm.launches = ladder_mm.backward_launches = 0
    out = fn()
    back = ladder_mm.backward_launches
    return out, ladder_mm.launches - back, back


def target_launches(log, per_solve, route_backward):
    """(forward, backward) ladder launches of a CCSD(T) target build from
    its iteration counts: `per_solve` per CCSD iteration, then the map
    once (`route_backward` products) and one backward of it per adjoint
    iteration (the last product, with respect to the Fock matrix, does
    not pass through a ladder: tau does not depend on f)."""
    return (per_solve * log["ccsd"]["iterations"] + route_backward,
            route_backward * log["adjoint"]["iterations"])


def gexp_target(mol, method, dtype, device):
    from ecw_cc_torch.models.gamma_exp import Gexp

    g = Gexp(mol, method, device=device, dtype=dtype)
    g.Vext(FIELD)
    g.build()
    return g


def run_target_sweep(ladder_mm, ecw32):
    """Phase 10 (a)."""
    ecw = fresh_targets(ecw32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, fwd, back = count_launches(
        ladder_mm, lambda: ecw.Build_GS_exp("mat", "CCSD(T)", field=FIELD))
    torch.cuda.synchronize()
    log = ecw.target_log
    trace = float(np.trace(ecw.exp_data[0][0][1]))
    nelec = int(round(float(np.sum(ecw.mo_occ))))
    per_solve = 2 if log["sym"] else 3
    want = target_launches(log, per_solve, 3)
    phase(10, "target_ccsd_t_f32", seconds=time.perf_counter() - t0,
          Eexp=ecw.Eexp_GS, stages=log, trace=trace, electrons=nelec,
          peak_bytes=torch.cuda.max_memory_allocated(),
          forward_launches=fwd, backward_launches=back,
          expected_launches=want)
    if not (log["ccsd"]["converged"] and log["adjoint"]["converged"]):
        raise AssertionError(f"the f32 CCSD(T) target did not converge: {log}")
    if abs(trace - nelec) > 1e-5:
        raise AssertionError(f"Tr(target) = {trace}, not {nelec}")
    if (fwd, back) != want or min(fwd, back) <= 0:
        raise AssertionError(f"target build launched the kernel {fwd} times "
                             f"forward and {back} backward, expected {want}")
    ladder_mm.launches = 0
    res, slog = solve(ecw, LAMBDAS, conv_thres=CONV_THRES)
    sweep = ladder_mm.launches
    deltas = [float(d) for d in ecw.Delta_lamb]
    iters = [s["iterations"] for s in slog]
    phase(10, "sweep_on_ccsd_t_target", iterations=iters, Delta=deltas,
          Ep=[float(ecw.EHF - e) for e in ecw.Ep_lamb],
          ms=[s["ms"] for s in slog], ladder_launches=sweep)
    if not all(s["status"] == 1 for s in slog) or sweep != sum(iters):
        raise AssertionError("the sweep on the CCSD(T) target did not "
                             f"converge with 1 launch per iteration: {slog}")
    if not deltas[-1] < deltas[0]:
        raise AssertionError(f"Delta did not fall with lambda: {deltas}")
    return {"c2h2_ccpvdz_f32_ccsd_t_target": fwd + back,
            "c2h2_ccpvdz_f32_sweep_on_ccsd_t": sweep}, fwd + back, back


def compare_targets(name, a, b, tol_e, tol_g, same_iterations):
    de = abs(a.ECCSD_def - b.ECCSD_def)
    det = abs((a.ECCSD_t_def - a.ECCSD_def) - (b.ECCSD_t_def - b.ECCSD_def))
    dg = float(np.abs(a.gamma_ao - b.gamma_ao).max())
    its = [x.log["adjoint"]["iterations"] for x in (a, b)]
    phase(10, name, E_CCSD=b.ECCSD_def, E_T=b.ECCSD_t_def - b.ECCSD_def,
          dE_CCSD=de, dE_T=det, max_abs_dgamma_ao=dg, adjoint_iterations=its,
          ccsd_iterations=[x.log["ccsd"]["iterations"] for x in (a, b)],
          stages=[a.log, b.log])
    if de > tol_e or det > tol_e or dg > tol_g:
        raise AssertionError(f"{name}: |dE_CCSD| {de}, |dE_T| {det}, "
                             f"max|dgamma| {dg}")
    if same_iterations and its[0] != its[1]:
        raise AssertionError(f"{name}: adjoint iterations {its}")


def run_target_parity(ladder_mm, ecw32):
    """Phase 10 (b)."""
    from ecw_cc_torch.models.molecule import Molecule

    small = Molecule(MOLECULE, SMALL_BASIS, charge=0, spin=0)
    card, fwd, back = count_launches(ladder_mm, lambda: gexp_target(
        small, "CCSD(T)", torch.float64, CARD))
    cpu = gexp_target(small, "CCSD(T)", torch.float64, "cpu")
    compare_targets("target_f64_card_vs_cpu", card, cpu, 1e-10, 1e-8, True)
    # the f64 target runs the dense kernels on host ERIs: one ladder
    # product per update, so 1 launch per CCSD iteration, 1 for the map and
    # 1 per backward of it
    want = target_launches(card.log, 1, 1)
    if (fwd, back) != want:
        raise AssertionError(f"f64 target launched {fwd}/{back}, expected "
                             f"{want}")
    f64 = gexp_target(ecw32.mol, "CCSD(T)", torch.float64, CARD)
    f32 = gexp_target(ecw32.mol, "CCSD(T)", torch.float32, CARD)
    compare_targets("target_f32_vs_f64_card", f32, f64, 1e-5, 1e-4, False)
    return {"c2h2_631g_f64_ccsd_t_target": fwd + back}, back


def check_gradient_card_built(ladder_mm, ecw32):
    """Phase 10 (c), the operand the solves really hand the kernel: the f32
    vvvv block of C2H2/cc-pVDZ as build_eris_device leaves it on the card,
    symmetric under the pair swap only to roundoff.  The gradient with
    symmetric=True (the backward reads the block as it is) against the
    transposed-copy route and the plain version, to 1e-5 * max|dA|."""
    from ecw_cc_torch.models.eris import build_eris_device

    er = build_eris_device(ecw32.mol, ecw32.mf, dtype=torch.float32,
                           device="cuda")
    v = er.nvir
    w = er.vvvv.view(v * v, v * v)
    M = DENSE_DZ[0]
    rng = np.random.default_rng(200)
    a = torch.as_tensor(rng.standard_normal((M, v * v)), dtype=torch.float32,
                        device="cuda")
    g = torch.as_tensor(rng.standard_normal((M, v * v)), dtype=torch.float32,
                        device="cuda")
    ladder_mm.launches = ladder_mm.backward_launches = 0
    grads = []
    for symmetric in (True, False):
        x = a.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(
            (ladder_mm(x, w, symmetric=symmetric) * g).sum(), x)[0])
    launches = (ladder_mm.launches, ladder_mm.backward_launches)
    x = a.clone().requires_grad_(True)
    plain, = torch.autograd.grad(((x @ w.T) * g).sum(), x)
    scale = float(plain.abs().max())
    errs = {"as_it_is_vs_transposed": float((grads[0] - grads[1]).abs().max()),
            "as_it_is_vs_plain": float((grads[0] - plain).abs().max()),
            "transposed_vs_plain": float((grads[1] - plain).abs().max())}
    asym = float((w - w.T).abs().max())
    ok = max(errs.values()) <= 1e-5 * scale
    phase(10, "kernel_gradient_card_built_vvvv", shape=(M, v * v, v * v),
          pair_swap_asymmetry=asym, max_abs_operand=float(w.abs().max()),
          max_abs_err=errs, max_abs_ref=scale, bound=1e-5 * scale, ok=ok,
          launches=launches)
    if not ok or launches != (4, 2):
        raise AssertionError(f"ladder_mm gradient through the card-built "
                             f"vvvv block: {errs} against 1e-5 * {scale}, "
                             f"launches {launches}")
    return max(errs.values())


def check_kernel_gradient(ladder_mm, ladder_mm_ref, ecw32):
    """Phase 10 (c)."""
    out = {}
    for dtype in DTYPES:
        for i, shape in enumerate(GRAD_SHAPES):
            M, N, _ = shape
            rng = np.random.default_rng(100 + i)
            a = torch.as_tensor(rng.standard_normal((M, N)), dtype=dtype,
                                device="cuda")
            w = torch.as_tensor(rng.standard_normal((N, N)), dtype=dtype,
                                device="cuda")
            w = (w + w.T).contiguous()
            g = torch.as_tensor(rng.standard_normal((M, N)), dtype=dtype,
                                device="cuda")
            pad = torch.cat([w, w.new_zeros((16, N))])
            a_k, a_p = (a.clone().requires_grad_(True) for _ in range(2))
            ladder_mm.launches = ladder_mm.backward_launches = 0
            # g.T.T: a cotangent that is not contiguous, as autograd makes
            gk, = torch.autograd.grad(
                (ladder_mm(a_k, w, symmetric=True) * g.T.contiguous().T).sum(),
                a_k)
            gp, = torch.autograd.grad((ladder_mm_ref(a_p, w) * g).sum(), a_p)
            _, vjp = torch.func.vjp(
                lambda x: ladder_mm(x, w, symmetric=True), a)
            gv, = vjp(g)
            # an operand neither symmetric nor declared so: the backward
            # launches on a transposed copy
            w_n = torch.as_tensor(rng.standard_normal((N, N)), dtype=dtype,
                                  device="cuda")
            a_n, a_q = (a.clone().requires_grad_(True) for _ in range(2))
            gn, = torch.autograd.grad((ladder_mm(a_n, w_n) * g).sum(), a_n)
            gq, = torch.autograd.grad((ladder_mm_ref(a_q, w_n) * g).sum(),
                                      a_q)
            a_z = a.clone().requires_grad_(True)
            gz, = torch.autograd.grad(
                (ladder_mm(a_z, pad, symmetric=True)[:, :N] * g).sum(), a_z)
            launches = (ladder_mm.launches, ladder_mm.backward_launches)
            scale = float(gp.abs().max())
            errs = {k: float((x - y).abs().max()) for k, x, y in
                    (("autograd", gk, gp), ("func_vjp", gv, gp),
                     ("transposed", gn, gq), ("padded", gz, gp))}
            ok = max(errs.values()) <= TOL[dtype] * scale
            phase(10, "kernel_gradient", dtype=str(dtype), shape=shape,
                  max_abs_err=errs, max_abs_ref=scale, ok=ok,
                  launches=launches)
            # 4 forward launches and a backward one for each
            if not ok or launches != (8, 4):
                raise AssertionError(f"ladder_mm gradient at {shape} {dtype}: "
                                     f"{errs} against {TOL[dtype]} * {scale}, "
                                     f"launches {launches}")
            out[(dtype, shape)] = max(errs.values())
    out[(torch.float32, DENSE_DZ)] = check_gradient_card_built(ladder_mm, ecw32)
    b = torch.ones((4, 4), device="cuda", requires_grad=True)
    try:
        ladder_mm(torch.ones((2, 4), device="cuda"), b)
    except RuntimeError:
        pass
    else:
        raise AssertionError("ladder_mm took an operand b that requires grad")
    return out


def timed_ms(fn, reps=2):
    """(best host ms of `reps` synchronized calls after one warm-up, value)."""
    val = fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        val = float(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3, val


def target_eris(layout, mol, ghf):
    """The (eris, vvvv_op, sect, unperm) of an f32 target build on the
    card: 'sorted' is Gexp's route (_build_eris_sorted: the sector-blocked
    kernels and (T) loops), 'alternating' _build_eris_auto's (a PackedVVVV,
    the dense kernels, the dense (T) loop)."""
    from ecw_cc_torch.models import gamma_exp

    if layout == "sorted":
        return gamma_exp._build_eris_sorted(mol, ghf, torch.float32, CARD)
    return gamma_exp._build_eris_auto(mol, ghf, torch.float32, CARD) + (
        None, None)


def run_target_stages(ladder_mm, tag, mol, ghf, layouts, t_row=False):
    """The stages of an f32 CCSD(T) target of (mol, ghf), one build per
    entry of `layouts` (target_eris), each through the stages Gexp.build
    runs and times (gamma_exp._run_gccsd_t_rdm1).  Phase 10 (a) runs it at
    cc-pVDZ (twice each, in turns), (d) at cc-pVTZ, with t_row the (T)
    energy three ways on the sorted ERIs.  Returns ({path: launches},
    backward launches)."""
    from ecw_cc_torch.models import gamma_exp
    from ecw_cc_torch.utils.metrics import StageClock

    out, total_back, e_ref = {}, 0, None
    for layout in layouts:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        log = {}
        clock = StageClock(torch.device(CARD), log)
        built = target_eris(layout, mol, ghf)
        clock.done("eris_s")
        sect = built[2]
        (e_cc, e_t, gamma), fwd, back = count_launches(
            ladder_mm, lambda: gamma_exp._run_gccsd_t_rdm1(built, log=log))
        cc, ad = log["ccsd"], log["adjoint"]
        trace = float(np.trace(gamma))
        sym = bool(sect[1]) if sect else False
        per = (2 if sym else 3) if sect else 1
        want = target_launches(log, per, 3 if sect else 1)
        phase(10, f"target_{tag}_f32", layout=layout, sym=sym, E_CCSD=e_cc,
              E_T=e_t, stages=log,
              seconds=sum(v for k, v in log.items() if k.endswith("_s")),
              trace=trace, peak_bytes=torch.cuda.max_memory_allocated(),
              forward_launches=fwd, backward_launches=back,
              expected_launches=want)
        if not (cc["converged"] and ad["converged"]):
            raise AssertionError(f"{tag} target ({layout}) did not "
                                 f"converge: {cc}, {ad}")
        if (fwd, back) != want:
            raise AssertionError(f"{tag} target ({layout}) launched "
                                 f"{fwd}/{back}, expected {want}")
        if (abs(trace - ghf.nocc) > 1e-3
                or gamma.shape != tuple(built[0].fock.shape)
                or not np.all(np.isfinite(gamma))):
            raise AssertionError(f"{tag} density ({layout}): trace {trace}")
        if e_ref is None:
            e_ref = e_cc + e_t
        elif abs(e_cc + e_t - e_ref) > 1e-5:
            raise AssertionError(f"{tag} E_CCSD(T) differs across layouts "
                                 f"by {abs(e_cc + e_t - e_ref)}")
        key = f"c2h2_{tag}_f32_ccsd_t_stages_{layout}"
        out[key] = out.get(key, 0) + fwd + back
        total_back += back
        if t_row and layout == "sorted":
            n = run_t_row(ladder_mm, tag, built)
            out[key] += n
        del built, gamma
        torch.cuda.empty_cache()
    return out, total_back


def run_t_row(ladder_mm, tag, built):
    """The (T) energy three ways on converged amplitudes of sorted ERIs
    (bench.py's t row): dense pair loop, sector-blocked, bf16 slabs.
    Returns the ladder launches of its CCSD solve."""
    from ecw_cc_torch.ops import ccsd_t

    eris, op, (info, sym), _ = built
    cc = {}
    (t1, t2, _), fwd, _ = count_launches(
        ladder_mm, lambda: ccsd_t.solve_ccsd(eris, vvvv_op=op,
                                             sect=(info, sym), log=cc))
    with torch.no_grad():
        d_ms, e_d = timed_ms(lambda: ccsd_t.energy_t(eris, t1, t2))
        s_ms, e_s = timed_ms(lambda: ccsd_t.energy_t_sect(
            eris, t1, t2, info, sym=sym))
        b_ms, e_b = timed_ms(lambda: ccsd_t.energy_t_sect(
            eris, t1, t2, info, sym=sym, slab_dtype="bfloat16"))
    rel_s = abs(e_s - e_d) / abs(e_d)
    rel_b = abs(e_b - e_s) / abs(e_s)
    phase(10, f"energy_t_{tag}_f32", dense_ms=d_ms, sect_ms=s_ms,
          bf16_ms=b_ms, sym=sym, ccsd=cc, E_T_dense=e_d, E_T_sect=e_s,
          E_T_bf16=e_b, sect_rel_err=rel_s, bf16_rel_err=rel_b)
    if rel_s > 5e-4 or rel_b > 5e-3:
        raise AssertionError(f"(T) at {tag}: sectored off by {rel_s}, "
                             f"bf16 by {rel_b}")
    if fwd != (2 if sym else 3) * cc["iterations"]:
        raise AssertionError(f"(T) row's CCSD solve launched {fwd} times in "
                             f"{cc['iterations']} iterations")
    return fwd


def run_ccs(ecw32, ecw64c, ecwc):
    """Phase 10 (e)."""
    kw = dict(conv_thres=CONV_THRES, maxiter=80)
    e64 = fresh_targets(ecw64c)
    e64.Build_GS_exp("mat", "CCSD", field=FIELD)
    ec = fresh_targets(ecwc)          # the CPU solve on the card's target
    ec.exp_data, ec.HF_prop = e64.exp_data, e64.HF_prop
    ec.Ek_exp_GS, ec.Eexp_GS = e64.Ek_exp_GS, e64.Eexp_GS
    e32 = fresh_targets(ecw32)
    e32.Build_GS_exp("mat", "CCSD", field=FIELD)
    rows = {}
    for name, ecw in (("cuda_f64", e64), ("cpu_f64", ec), ("cuda_f32", e32)):
        t0 = time.perf_counter()
        res = ecw.CCS_GS(LAMBDAS, **kw)
        rows[name] = dict(
            iterations=[s["iterations"] for s in ecw.solve_log],
            converged=all(s["status"] == 1 for s in ecw.solve_log),
            Ep=[float(e) for e in ecw.Ep_lamb],
            Delta=[float(d) for d in ecw.Delta_lamb],
            seconds=time.perf_counter() - t0,
            rdm1_finite=bool(np.all(np.isfinite(res[4]))))
    d64 = max(abs(a - b) for a, b in zip(rows["cuda_f64"]["Ep"],
                                         rows["cpu_f64"]["Ep"]))
    d32 = max(abs(a - b) for a, b in zip(rows["cuda_f32"]["Ep"],
                                         rows["cpu_f64"]["Ep"]))
    phase(10, "ccs_gs_on_ccsd_target", **rows, dEp_cuda_f64=d64,
          dEp_cuda_f32=d32, target_f64=e64.target_log,
          target_f32=e32.target_log, Eexp_f64=e64.Eexp_GS,
          Eexp_f32=e32.Eexp_GS)
    if not all(r["converged"] and r["rdm1_finite"] for r in rows.values()):
        raise AssertionError(f"a CCS_GS sweep did not converge: {rows}")
    if (rows["cuda_f64"]["iterations"] != rows["cpu_f64"]["iterations"]
            or d64 > 1e-10):
        raise AssertionError(f"CCS_GS f64 card differs from the CPU: {rows}")
    if d32 > 1e-5:
        raise AssertionError(f"CCS_GS f32 differs from f64 by {d32} Ha")
    if not rows["cuda_f64"]["Delta"][-1] < rows["cuda_f64"]["Delta"][0]:
        raise AssertionError("CCS_GS: Delta did not fall with lambda")


def run_ccs_steps():
    """Phase 10 (e), the other CCS solves: Newton on the exact Jacobian
    (torch.func.jacfwd) and the L1 proximal-gradient solve (warm-started
    from the SCF solve's checkpoint: from zero amplitudes its projection
    keeps them zero) at lambda = 0.25, C2H2/6-31G with an HF target in a
    field: f64 on the card against the CPU (equal iterations, Ep and
    rdm1), Newton against the SCF solve, and f32 Newton on the card
    against f64."""
    import tempfile

    e64, ec, e32 = (build_ecw(*a, basis=SMALL_BASIS) for a in (
        ("cuda", torch.float64), ("cpu", torch.float64),
        ("cuda", torch.float32)))
    solves = {
        "scf": dict(method="scf", conv_thres=1e-9, maxiter=200),
        "newton": dict(method="newton", conv_thres=1e-9, maxiter=30),
        "L1_grad": dict(method="L1_grad", alpha=1e-4, beta=0.5,
                        conv_thres=1e-7, maxiter=60, resume=True)}
    rows, res = {}, {}
    for name, ecw in (("cuda_f64", e64), ("cpu_f64", ec)):
        with tempfile.TemporaryDirectory() as ck:
            for key, kw in solves.items():
                if key != "newton":
                    kw = dict(kw, checkpoint_dir=ck)
                t0 = time.perf_counter()
                r = res[name, key] = ecw.CCS_GS([0.25], **kw)
                rows[f"{key}_{name}"] = dict(
                    text=r[0], iterations=len(r[1]), Ep=float(r[1][-1]),
                    Delta=float(r[2][-1][0]),
                    nonzero_ts=int(np.count_nonzero(r[5][0])),
                    seconds=time.perf_counter() - t0)
    r32 = e32.CCS_GS([0.25], method="newton", conv_thres=1e-5, maxiter=30)
    rows["newton_cuda_f32"] = dict(text=r32[0], iterations=len(r32[1]),
                                   Ep=float(r32[1][-1]))
    diffs = {}
    for key in solves:
        a, b = res["cuda_f64", key], res["cpu_f64", key]
        if len(a[1]) != len(b[1]):
            raise AssertionError(f"CCS {key}: card and CPU took "
                                 f"{len(a[1])} and {len(b[1])} iterations")
        diffs[key] = dict(dEp=float(np.abs(a[1] - b[1]).max()),
                          drdm1=float(np.abs(a[4] - b[4]).max()))
    newton, scf = res["cuda_f64", "newton"], res["cuda_f64", "scf"]
    d_ns = abs(float(newton[1][-1] - scf[1][-1]))
    d32 = abs(float(r32[1][-1] - newton[1][-1]))
    phase(10, "ccs_newton_and_l1_grad", basis=SMALL_BASIS, **rows,
          card_vs_cpu=diffs, dEp_newton_vs_scf=d_ns, dEp_newton_f32=d32)
    if max(max(d.values()) for d in diffs.values()) > 1e-10:
        raise AssertionError(f"CCS Newton / L1_grad: card differs from the "
                             f"CPU: {diffs}")
    if not all("Convergence reached" in res["cuda_f64", k][0]
               for k in ("scf", "newton")) or d_ns > 1e-6:
        raise AssertionError(f"CCS Newton against SCF: {rows}, {d_ns}")
    l1 = res["cuda_f64", "L1_grad"]
    if (not np.all(np.isfinite(l1[4])) or not np.count_nonzero(l1[5][0])
            or d32 > 1e-5):
        raise AssertionError(f"CCS L1_grad / f32 Newton: {rows}, {d32}")


def run_ccs_newton_dz(ecw64c):
    """Phase 10 (e) at full width: Newton at C2H2/cc-pVDZ f64 on the card
    (2ov = 1736 Jacobian columns, taken in chunks of the vmapped jvp as
    free memory allows: all at once they would hold ~46 GB), against the
    SCF solve at lambda = 0.25 with phase 4's HF target."""
    from ecw_cc_torch.ops.ccs import jac_chunk

    ecw = fresh_targets(ecw64c)
    ecw.Build_GS_exp("mat", "HF", field=FIELD)
    n = 2 * ecw.nocc * ecw.nvir
    chunk = jac_chunk(ecw.nocc, ecw.nvir,
                      torch.zeros(n, dtype=torch.float64, device=CARD))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    newton = ecw.CCS_GS([0.25], method="newton", conv_thres=1e-9, maxiter=30)
    newton_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    scf = ecw.CCS_GS([0.25], method="scf", conv_thres=1e-9, maxiter=200)
    d = abs(float(newton[1][-1] - scf[1][-1]))
    phase(10, "ccs_newton_ccpvdz", basis=BASIS, columns=n, chunk=chunk,
          text=newton[0], iterations=len(newton[1]), seconds=newton_s,
          peak_bytes=peak, Ep=float(newton[1][-1]),
          iterations_scf=len(scf[1]), dEp_newton_vs_scf=d)
    if "Convergence reached" not in newton[0] or d > 1e-6:
        raise AssertionError(f"CCS Newton at cc-pVDZ: {newton[0]}, |dEp| "
                             f"against SCF {d}")


def run_phase10(ladder_mm, ladder_mm_ref, ecw32, ecw64c, ecwc, tz):
    """Phase 10; returns ({path: launches}, backward launches among them,
    {(dtype, shape): gradient error})."""
    launches, _, back = run_target_sweep(ladder_mm, ecw32)
    steps = (
        lambda: run_target_stages(
            ladder_mm, "ccpvdz", ecw32.mol, ecw32.mf,
            ("sorted", "alternating", "alternating", "sorted")),
        lambda: run_target_parity(ladder_mm, ecw32),
        lambda: run_target_stages(ladder_mm, "ccpvtz", *tz,
                                  ("sorted", "alternating"), t_row=True))
    for step in steps:
        out, b = step()
        launches.update(out)
        back += b
    grads = check_kernel_gradient(ladder_mm, ladder_mm_ref, ecw32)
    run_ccs(ecw32, ecw64c, ecwc)
    run_ccs_steps()
    run_ccs_newton_dz(ecw64c)
    return launches, back, grads


# Phase 11: excited states.  The anchor of (a) is H2O/6-31++G** with the
# two transition dipoles below at lambda = 0.1, which the JAX package
# converges in 19 iterations to 7.134 and 10.07 eV (Solver_ES's maxdiis 20).
ES_MOLECULE, ES_BASIS = "h2o", "6-31++g**"
ES_DIPS = ((0.523742 + 0.550251) / 2.0, (0.622534 + 0.649058) / 2.0)
ES_ANCHOR_EV, ES_ANCHOR_ITERATIONS = (7.134, 10.07), 19
ES_L, ES_SWEEP = 0.1, [0.0, 0.05, 0.1]
# (c) runs trans-bent acetylene: the catalog's C2H2 with each H bent 20
# degrees off the axis (same atoms, bond lengths, nocc 14, nvir 62 / 162).
# Every excited state of the linear molecule's pi system is one of a
# symmetry-degenerate pair, and the coupled solve follows a state by its
# largest amplitude: on such a pair it does not reach 1e-5 at f32.
ES_CH, ES_BEND = 1.063348, np.deg2rad(20.0)
ES_ACETYLENE = "\n".join(
    f"{sym} {x:.7f} 0.0 {z:.7f}" for sym, x, z in (
        ("C", 0.0, 0.603401), ("C", 0.0, -0.603401),
        ("H", ES_CH * np.sin(ES_BEND), 0.603401 + ES_CH * np.cos(ES_BEND)),
        ("H", -ES_CH * np.sin(ES_BEND), -0.603401 - ES_CH * np.cos(ES_BEND))))
ES_KW = dict(method="device", diis="all", conv="rl", conv_thres=1e-5,
             maxiter=80, maxdiis=20, print_ite=False)
ES_CHAIN_ITERS = 20
# (c) converges further than (a)'s 1e-5: there the card's f32 lambda = 0
# solve has stopped at its 16th iteration 9.5e-6 Ha from the f64 one
ES_SWEEP_THRES = 2e-6
ES_TDHF_ROOTS = 400
ES_PROFILE_ITERS = (4, 12)   # two profiled chains; their difference is read
EV = 27.2114


def es_solve(ecw, L, **kw):
    """(what ECW.CCS_ES returns, its host ms with the card synchronized);
    the solver's tables are swallowed."""
    import io

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = ecw.CCS_ES(L, **{**ES_KW, **kw})
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def es_iterations(text):
    """The count in a solver's convergence text (None at the limit)."""
    words = text.replace(",", " ").split()
    return int(words[words.index("after") + 1]) if "after" in words else None


def es_with_eris(ecw, eris):
    """A shallow copy of a built ECW (same SCF, targets and guesses) whose
    excited-state solve runs on other ERIs."""
    out = copy.copy(ecw)
    out.eris, out.vvvv_op, out.myccs, out.myccsd = eris, None, None, None
    out.dtype = eris.fock.dtype
    return out


def es_device_solver(ecw, conv_thres=1e-5, maxiter=80):
    """The device solver ECW.CCS_ES(method='device') builds, by hand, for
    what the entry point does not offer: a solve warm-started from given
    amplitudes (dic_amp_ini), as its own L_loop sweep warm-starts."""
    import io

    from ecw_cc_torch.ops.ccs import Gccs
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.solvers.es import Solver_ES, SolverES_Device

    with contextlib.redirect_stdout(io.StringIO()):
        vexp = Exp(0.0, ecw.exp_data, ecw.mol, ecw.mo_coeff)
        solver = Solver_ES(Gccs(ecw.eris), vexp, rn_ini=ecw.r_ini,
                           conv_var=ES_KW["conv"], conv_thres=conv_thres,
                           maxiter=maxiter, diis=ES_KW["diis"],
                           maxdiis=ES_KW["maxdiis"])
    return SolverES_Device(solver)


def es_sweep_amplitudes(ecw):
    """The amplitudes at the end of the lambda sweep (each lambda warm-
    started from the one before, as ECW.CCS_ES(L_loop=True) runs it)."""
    dev, amp = es_device_solver(ecw, conv_thres=ES_SWEEP_THRES), None
    for lam in ES_SWEEP:
        text, amp = dev.SCF(lam, dic_amp_ini=amp)[:2]
        if "Convergence reached" not in text:
            raise AssertionError(f"warm-started solve at lambda = {lam}: "
                                 f"{text}")
    return amp


def es_chain(ecw, amp, iterations):
    """(iterations run, host ms) of a fixed chain of the device loop at
    lambda = ES_L from the amplitudes amp (conv_thres 0)."""
    dev = es_device_solver(ecw, conv_thres=0.0, maxiter=iterations - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev.SCF(ES_L, dic_amp_ini=amp)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if dev.last_solve["iterations"] != iterations:
        raise AssertionError(f"the ES chain stopped after "
                             f"{dev.last_solve['iterations']} of "
                             f"{iterations} iterations")
    return iterations, ms


def r1_matrix(eris, ts):
    """The linear part of the R1 map at amplitudes ts as an (o*v, o*v)
    matrix (what Solver_ES.SCF_diag diagonalizes), and its intermediates."""
    from ecw_cc_torch.ops import ccs as ccs_ops

    inter = ccs_ops.R1inter(eris, ts, None, None)
    Fab, Fji, W, F = inter[:4]
    nocc, nvir = ts.shape
    eye_o = torch.eye(nocc, dtype=ts.dtype, device=ts.device)
    eye_v = torch.eye(nvir, dtype=ts.dtype, device=ts.device)
    A = (torch.einsum("ab,ij->iajb", Fab, eye_o)
         - torch.einsum("ji,ab->iajb", Fji, eye_v)
         + torch.einsum("akic->iakc", W)).reshape(nocc * nvir, nocc * nvir)
    return A + F * torch.eye(nocc * nvir, dtype=ts.dtype,
                             device=ts.device), inter


def run_es_anchor():
    """Phase 11 (a) and (b)."""
    from ecw_cc_torch import ECW

    ecws, outs, ms = {}, {}, {}
    for name, device, dtype in (("cuda_f32", CARD, torch.float32),
                                ("cuda_f64", CARD, torch.float64),
                                ("cpu_f64", "cpu", torch.float64)):
        ecw = ECW(ES_MOLECULE, ES_BASIS, device=device, dtype=dtype)
        ecw.Build_ES_exp_input([[["trdip", (ES_DIPS[0], 0.0, 0.0)]],
                                [["trdip", (0.0, 0.0, ES_DIPS[1])]]])
        _, first = es_solve(ecw, ES_L)       # loads the card's kernels
        outs[name], ms[name] = es_solve(ecw, ES_L)
        ecws[name] = ecw
        ms[name + "_first"] = first
    its = {k: es_iterations(o[0]) for k, o in outs.items()}
    ep = {k: np.asarray(o[3], dtype=np.float64) for k, o in outs.items()}
    ev32 = ep["cuda_f32"][1:, 0] * EV
    d_card_cpu = float(np.abs(ep["cuda_f64"] - ep["cpu_f64"]).max())
    d_f32 = float(np.abs(ep["cuda_f32"] - ep["cuda_f64"]).max())
    ecw = ecws["cuda_f32"]
    phase(11, "es_anchor", molecule=ES_MOLECULE, basis=ES_BASIS,
          nocc=ecw.nocc, nvir=ecw.nvir, EHF=ecw.EHF, L=ES_L, iterations=its,
          reference_iterations=ES_ANCHOR_ITERATIONS,
          E_eV_cuda_f32=ev32, E_eV_cuda_f64=ep["cuda_f64"][1:, 0] * EV,
          E_eV_reference=ES_ANCHOR_EV, dEp_cuda_f64_vs_cpu=d_card_cpu,
          dEp_cuda_f32_vs_f64=d_f32, ms=ms,
          Delta_cuda_f32=np.asarray(outs["cuda_f32"][2]).tolist())
    if not all("Convergence reached" in o[0] for o in outs.values()):
        raise AssertionError(f"an anchor solve did not converge: "
                             f"{[o[0] for o in outs.values()]}")
    if np.abs(ev32 - np.asarray(ES_ANCHOR_EV)).max() > 0.01:
        raise AssertionError(f"f32 anchor energies {ev32} eV")
    # The count is held to this run's f64 solve, not to the reference's 19:
    # conv='rl' sums r and l over the states, so with two states it depends
    # on the arbitrary signs of the SCF's orbitals (19 or 23 iterations with
    # the host integral engine built with or without FMA)
    if abs(its["cuda_f32"] - its["cuda_f64"]) > 2:
        raise AssertionError(f"f32 anchor took {its['cuda_f32']} iterations, "
                             f"f64 {its['cuda_f64']}")
    if its["cuda_f64"] != its["cpu_f64"] or d_card_cpu > 1e-9:
        raise AssertionError(f"f64 card differs from CPU: {its}, "
                             f"{d_card_cpu}")
    if d_f32 > 1e-5:
        raise AssertionError(f"f32 anchor differs from f64 by {d_f32} Ha")
    rdm1 = np.asarray(outs["cuda_f32"][4])
    if not np.all(np.isfinite(rdm1)) or rdm1.shape != (ecw.dim,) * 2:
        raise AssertionError("ES rdm1 is not finite or has the wrong shape")

    # (b) the three methods on the card at f64
    ecw = ecws["cuda_f64"]
    dev = outs["cuda_f64"]
    scf, scf_ms = es_solve(ecw, ES_L, method="scf")
    d_scf = float(np.abs(np.asarray(scf[3]) - np.asarray(dev[3])).max())
    diag, worst = {}, {}
    # at lambda = 0, where the maps are linear: with a transition target at
    # lambda > 0 SCF_diag's matvec carries the affine r0 / Vexp terms along
    # and its Davidson returns no eigenvalue of the singles matrix
    for name, kw in (("exact", {}), ("davidson", {"davidson": True})):
        out, t = es_solve(ecw, 0.0, method="diag", conv="tl", **kw)
        ts = torch.as_tensor(out[1]["ts"], dtype=torch.float64,
                             device=CARD)
        w = np.linalg.eigvals(r1_matrix(ecw.eris, ts)[0].cpu().numpy()).real
        e = np.asarray(out[3])[1:]
        worst[name] = float(max(np.abs(w - x).min() for x in e.ravel()))
        diag[name] = dict(text=out[0], ms=t, Er_eV=e[:, 0] * EV,
                          El_eV=e[:, 1] * EV)
    phase(11, "es_methods", scf=scf[0], device=dev[0], dEp_scf_vs_device=d_scf,
          ms_scf=scf_ms, ms_device=ms["cuda_f64"],
          ms_per_iteration_scf=scf_ms / (es_iterations(scf[0]) + 1),
          ms_per_iteration_device=ms["cuda_f64"] / (its["cuda_f64"] + 1),
          diag=diag, diag_distance_to_an_eigenvalue=worst)
    if scf[0] != dev[0] or d_scf > 1e-9:
        raise AssertionError(f"method='scf' differs from 'device': "
                             f"{scf[0]} / {dev[0]}, {d_scf}")
    for name, d in diag.items():
        if "Convergence reached" not in d["text"] or worst[name] > 1e-6:
            raise AssertionError(f"method='diag' ({name}): {d['text']}, "
                                 f"{worst[name]} Ha from an eigenvalue")


def es_mom_probe(ecw):
    """The MOM delta-SCF targets of two valence states and a lambda = 0
    solve from MOM's own guesses, printed: why (c) takes TDHF targets."""
    import io

    probe = copy.copy(ecw)
    probe.exp_data, probe.HF_prop = [[]], [[]]
    probe.Eexp_ES, probe.r_ini, probe.myccs = [], None, None
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        probe.Build_ES_exp_MOM((2, 0))
    seconds = time.perf_counter() - t0
    out, _ = es_solve(probe, 0.0, maxiter=20)
    ep = np.asarray(out[3], dtype=np.float64)
    phase(11, "es_mom_probe", seconds=seconds,
          delta_scf_eV=np.asarray(probe.Eexp_ES[0]) * EV,
          solve_from_mom_guesses=out[0], energies_finite=bool(
              np.all(np.isfinite(ep))),
          Delta=np.nan_to_num(np.asarray(out[2]), nan=-1.0).tolist())
    return "Convergence reached" in out[0] and bool(np.all(np.isfinite(ep)))


def es_tdhf_targets(ecw):
    """('trdip' targets, unit guesses, info) of the two lowest bright TDHF
    roots (|transition dipole| > 0.05 au): the target is the root's
    |transition dipole| by component, the guess the unit vector at the
    root's largest beta -> beta amplitude (the spin block the solver's
    force_alpha keeps), a different position for each state."""
    from ecw_cc_torch.models import tdscf
    from ecw_cc_torch.utils import props

    t0 = time.perf_counter()
    es, X, Y = tdscf.tdhf(ecw.eris, ecw.mf.mo_energy, nroots=ES_TDHF_ROOTS)
    tdhf_s = time.perf_counter() - t0
    nocc, nvir, dim = ecw.nocc, ecw.nvir, ecw.dim
    dip_int = ecw.mol.intor("r", origin=ecw.mol.charge_center())
    targets, guesses, info, taken = [], [], [], set()
    for k in range(len(es)):
        t = np.zeros((dim, dim))
        t[:nocc, nocc:] = X[k] + Y[k]
        tdm = np.asarray(props.dipole(ecw.mol, t, g=True, aobasis=False,
                                      mo_coeff=ecw.mf.mo_coeff,
                                      dip_int=dip_int), dtype=np.float64)
        if np.linalg.norm(tdm) < 0.05:
            continue
        w = np.abs(X[k] + Y[k])
        w[0::2, :] = 0.0
        w[:, 0::2] = 0.0
        at = next(int(f) for f in np.argsort(-w.ravel()) if f not in taken)
        taken.add(at)
        g = np.zeros((nocc, nvir))
        g[at // nvir, at % nvir] = 1.0
        guesses.append(g)
        val = tuple(float(abs(x)) if abs(x) > 1e-8 else 0.0 for x in tdm)
        targets.append([["trdip", val]])
        info.append(dict(root=k, eV=float(es[k] * EV), trdip=val,
                         guess=(at // nvir, at % nvir)))
        if len(targets) == 2:
            break
    if len(targets) < 2:
        raise AssertionError(f"fewer than two bright roots among the "
                             f"{len(es)} lowest TDHF roots")
    return targets, guesses, dict(tdhf_seconds=tdhf_s, roots=info)


def es_profile(ecw, amp):
    """(device operations, device ms, device-to-host copies, {source:
    synchronizing calls}) per iteration of the device ES loop at lambda =
    ES_L from the amplitudes amp: the difference of two profiled fixed
    chains, so that a solve's set-up and read-back cancel.  The sources
    are the Python lines that made a synchronizing CUDA call (a read to
    the host among them), as torch.cuda.set_sync_debug_mode('warn')
    reports them in the same windows."""
    from torch.profiler import ProfilerActivity, profile

    got = []
    for n in ES_PROFILE_ITERS:
        with warnings.catch_warnings(record=True) as caught, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                es_chain(ecw, amp, n)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        ops = us = reads = 0
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                ops += e.count
                us += e.self_device_time_total
                if "memcpy dtoh" in e.key.lower():
                    reads += e.count
        src = collections.Counter(
            sync_source(w) for w in caught
            if "synchroniz" in str(w.message).lower())
        got.append((n, ops, us, reads, src))
    (i1, k1, u1, r1, s1), (i2, k2, u2, r2, s2) = got
    if k2 <= k1:
        raise AssertionError(f"the profiler saw no device work: {got}")
    per_src = {k: (s2[k] - s1[k]) / (i2 - i1) for k in s1.keys() | s2.keys()
               if s2[k] != s1[k]}
    return ((k2 - k1) / (i2 - i1), (u2 - u1) / 1e3 / (i2 - i1),
            (r2 - r1) / (i2 - i1), per_src)


def run_es_width(basis, mom_probe=False):
    """Phase 11 (c) at one basis.  Returns (the f32 ECW, its f64 twin on
    ERIs built on the card, the f64 amplitudes at the sweep's end)."""
    import io

    from ecw_cc_torch import ECW
    from ecw_cc_torch.models.eris import build_eris_device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ecw = ECW(ES_ACETYLENE, basis, device=CARD, dtype=torch.float32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    mom_usable = es_mom_probe(ecw) if mom_probe else None
    targets, guesses, info = es_tdhf_targets(ecw)
    with contextlib.redirect_stdout(io.StringIO()):
        ecw.Build_ES_exp_input(targets, rini_list=guesses)

    def sweep(e):
        kw = dict(L_loop=True, conv_thres=ES_SWEEP_THRES)
        es_solve(e, np.asarray(ES_SWEEP), **kw)             # untimed
        torch.cuda.reset_peak_memory_stats()
        _, t = es_solve(e, np.asarray(ES_SWEEP), **kw)
        return dict(ms=t, log=list(e.solve_log),
                    Ep=np.asarray([x[0] for x in e.Ep_lamb], np.float64),
                    El=np.asarray([x[1] for x in e.Ep_lamb], np.float64),
                    Delta=np.asarray(e.Delta_lamb, np.float64),
                    peak_bytes=torch.cuda.max_memory_allocated())

    s32 = sweep(ecw)
    er64, op64 = build_eris_device(ecw.mol, ecw.mf, dtype=torch.float64,
                                   device=CARD, pack_ladder=True)
    del op64
    ecw64 = es_with_eris(ecw, er64)
    s64 = sweep(ecw64)
    d_ep = float(max(np.abs(s32["Ep"] - s64["Ep"]).max(),
                     np.abs(s32["El"][:, 1:] - s64["El"][:, 1:]).max()))
    its = {k: [x["iterations"] for x in s["log"]]
           for k, s in (("f32", s32), ("f64", s64))}
    ok = {k: all(x["status"] == 1 for x in s["log"])
          for k, s in (("f32", s32), ("f64", s64))}
    # Delta[k] = [Delta[0, 1:], Delta[1:, 0]] at lambda k
    falls = bool(np.all(s32["Delta"][-1] < s32["Delta"][0])
                 and np.all(s64["Delta"][-1] < s64["Delta"][0]))

    # the loop's cost at lambda = ES_L, from the sweep's last amplitudes
    amp, amp64 = es_sweep_amplitudes(ecw), es_sweep_amplitudes(ecw64)
    es_chain(ecw, amp, ES_CHAIN_ITERS)                      # untimed
    chain_its, chain_ms = es_chain(ecw, amp, ES_CHAIN_ITERS)
    one = copy.copy(ecw)
    one.exp_data, one.r_ini = ecw.exp_data[:2], ecw.r_ini[:1]
    amp_one = {k: (v[:1] if k in ("rn", "ln", "r0n", "l0n") else v)
               for k, v in amp.items()}
    ops2, dev_ms2, reads2, src2 = es_profile(ecw, amp)
    ops1, dev_ms1, reads1, src1 = es_profile(one, amp_one)
    # the check: the package's synchronizing calls per iteration, exact
    # per line.  The profiler's copies per iteration are printed beside
    # them: a window's count can differ by a copy that no iteration made
    # (1.25 and 0.875 were read where the lines showed one read)
    syncs1, syncs2 = ({k: v for k, v in src.items()
                       if k.startswith("ecw_cc_torch/")}
                      for src in (src1, src2))
    per_it = chain_ms / chain_its
    phase(11, "es_sweep", molecule="c2h2, trans-bent 20 degrees",
          basis=basis, nocc=ecw.nocc,
          nvir=ecw.nvir, targets="tdhf_trdip", mom_targets_usable=mom_usable,
          **info, setup_seconds=setup_s, setup=ecw.timings,
          build_peak_bytes=build_peak, lambdas=ES_SWEEP,
          conv_thres=ES_SWEEP_THRES, iterations=its,
          converged=ok, sweep_ms_f32=s32["ms"], sweep_ms_f64=s64["ms"],
          Ep_f32=s32["Ep"].tolist(), E_eV_f64=(s64["Ep"][:, 1:] * EV).tolist(),
          dEp_f32_vs_f64=d_ep, Delta_f32=s32["Delta"].tolist(),
          Delta_f64=s64["Delta"].tolist(), delta_falls=falls,
          sweep_peak_bytes_f32=s32["peak_bytes"],
          sweep_peak_bytes_f64=s64["peak_bytes"],
          chain_iterations=chain_its, chain_ms=chain_ms,
          ms_per_iteration=per_it,
          device_ops_per_iteration={"one_state": ops1, "two_states": ops2},
          second_state_adds=ops2 / ops1 - 1.0,
          host_reads_per_iteration={"one_state": reads1, "two_states": reads2},
          syncs_by_source={"one_state": src1, "two_states": src2},
          device_ms_per_iteration={"one_state": dev_ms1,
                                   "two_states": dev_ms2},
          busy_share=dev_ms2 / per_it)
    if not all(ok.values()):
        raise AssertionError(f"{basis}: an ES lambda did not converge: "
                             f"{s32['log']} {s64['log']}")
    if d_ep > 1e-5:
        raise AssertionError(f"{basis}: f32 ES sweep differs from f64 by "
                             f"{d_ep} Ha")
    if not falls:
        raise AssertionError(f"{basis}: Delta does not fall with lambda: "
                             f"{s32['Delta']} {s64['Delta']}")
    if sum(syncs1.values()) != 1.0 or sum(syncs2.values()) != 1.0:
        raise AssertionError(f"{basis}: the ES loop synchronizes with the "
                             f"host {syncs1} / {syncs2} times per iteration "
                             "with one / two states (one scalar read is "
                             f"allowed); device-to-host copies {reads1} / "
                             f"{reads2}")
    if ops2 > 1.3 * ops1:
        raise AssertionError(f"{basis}: the second excited state adds "
                             f"{ops2 / ops1 - 1:.0%} device operations per "
                             "iteration (a loop over the states?)")
    return ecw, ecw64, amp64


def lowest_guesses(diag, n, keep=None):
    """Unit vectors at the n lowest entries of diag (among `keep`)."""
    d = diag.detach().double().cpu().numpy().copy()
    if keep is not None:
        d[~keep] = np.inf
    out = []
    for at in np.argsort(d)[:n]:
        x = np.zeros(d.size)
        x[at] = 1.0
        out.append(x)
    return out


def run_es_davidson(ecw32, ecw64, amp64):
    """Phase 11 (d): the R1 map at the t amplitudes of (c)'s sweep."""
    from ecw_cc_torch.ops import ccs as ccs_ops
    from ecw_cc_torch.utils.linalg import davidson_device

    nocc, nvir = ecw64.nocc, ecw64.nvir
    ts64 = torch.as_tensor(amp64["ts"], dtype=torch.float64, device=CARD)
    A, _ = r1_matrix(ecw64.eris, ts64)
    t0 = time.perf_counter()
    w_all = np.sort(np.linalg.eig(A.cpu().numpy())[0].real)
    eig_s = time.perf_counter() - t0
    # spin-conserving (Ms = 0) singles: alpha -> alpha and beta -> beta
    keep = np.zeros((nocc, nvir), dtype=bool)
    keep[0::2, 0::2] = keep[1::2, 1::2] = True
    mask = {dt: torch.as_tensor(keep.ravel(), device=CARD).to(dt)
            for dt in DTYPES}
    rows = {}
    for name, ecw, dtype, project, tol, bound in (
            ("f64", ecw64, torch.float64, True, 1e-10, 1e-9),
            ("f32_projected", ecw32, torch.float32, True, 3e-5, 1e-5),
            ("f32_unprojected", ecw32, torch.float32, False, 3e-5, None)):
        ts = ts64.to(dtype)
        inter = ccs_ops.R1inter(ecw.eris, ts, None, None)
        Fab, Fji, W, F = inter[:4]
        diag = (torch.diagonal(Fab)[None, :] - torch.diagonal(Fji)[:, None]
                + torch.einsum("bjjb->jb", W) + F).reshape(-1)

        def matvec(v, inter=inter):
            return ccs_ops.R1eq(v.reshape(nocc, nvir), 0.0,
                                inter).reshape(-1)

        proj = (lambda v, m=mask[dtype]: v * m) if project else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conv, theta, xs = davidson_device(
            matvec, lowest_guesses(diag, 3, keep.ravel()), diag, nroots=3,
            tol=tol, max_cycle=100, max_space=24, project=proj, dtype=dtype,
            device=CARD)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        dist = [float(np.abs(w_all - x).min()) for x in theta]
        rows[name] = dict(converged=[bool(c) for c in conv],
                          roots_eV=(theta * EV).tolist(),
                          distance_to_an_eigenvalue=dist,
                          lowest_minus_lowest_eigenvalue=float(
                              theta.min() - w_all[0]), ms=ms)
        # (the lowest root found need not be the matrix's lowest: unit
        # guesses span only their own symmetry)
        if bound is not None and not (all(conv) and max(dist) <= bound):
            raise AssertionError(f"davidson_device ({name}) on the R1 map: "
                                 f"{rows[name]} against {bound}")
    phase(11, "es_davidson_r1", size=nocc * nvir, numpy_eig_seconds=eig_s,
          lowest_eigenvalues_eV=(w_all[:4] * EV).tolist(), **rows,
          spurious_root_without_projector=bool(
              abs(rows["f32_unprojected"]["roots_eV"][0]) < 1e-2))

    # X -> S X + X S on m x m matrices, applied to the antisymmetric part of
    # X only: the symmetric matrices are a structural null space, and the
    # roots in the antisymmetric ones are s_i + s_j (i < j), s the spectrum
    # of S
    m = 48
    rng = np.random.default_rng(0)
    e = np.sort(rng.random(m)) * 2 + 0.3
    M = rng.standard_normal((m, m))
    M = 0.05 * (M + M.T) / 2
    s = np.linalg.eigvalsh(np.diag(e) + M)
    roots = np.sort([s[i] + s[j] for i in range(m) for j in range(i)])[:3]
    Dt = torch.as_tensor(e[:, None] + e[None, :], dtype=torch.float32,
                         device=CARD)
    Mt = torch.as_tensor(M, dtype=torch.float32, device=CARD)

    def project(v):
        X = v.reshape(m, m)
        return (0.5 * (X - X.T)).reshape(-1)

    def matvec(v):
        X = project(v).reshape(m, m)
        return (Dt * X + Mt @ X + X @ Mt).reshape(-1)

    def guess(i, j):
        x = np.zeros((m, m))
        x[i, j], x[j, i] = 1.0, -1.0
        return x.ravel() / np.sqrt(2)

    x0 = [guess(0, 1), guess(0, 2), guess(1, 2)]
    kw = dict(nroots=3, tol=1e-5, max_cycle=100, max_space=12,
              dtype=torch.float32, device=CARD)
    conv_p, w_p, _ = davidson_device(matvec, x0, Dt.reshape(-1),
                                     project=project, **kw)
    conv_n, w_n, _ = davidson_device(matvec, x0, Dt.reshape(-1), **kw)
    err = float(np.abs(w_p - roots).max())
    phase(11, "es_davidson_null_space", size=m * m, roots=roots.tolist(),
          with_projector=w_p.tolist(), converged_with_projector=[
              bool(c) for c in conv_p], max_abs_err_with_projector=err,
          without_projector=w_n.tolist(),
          spurious_root_without_projector=bool(abs(w_n[0]) < 1e-3))
    if not all(conv_p) or err > 1e-5:
        raise AssertionError(f"f32 davidson_device with its projector: "
                             f"{w_p} against {roots}")


ES_MODULES = ("ecw_cc_torch.solvers.es", "ecw_cc_torch.utils.linalg",
              "ecw_cc_torch.models.tdscf")


def run_phase11():
    run_es_anchor()
    run_es_width(BASIS, mom_probe=True)
    torch.cuda.empty_cache()
    run_es_davidson(*run_es_width(BASIS_TZ))


def check_no_jax(es_ran, eom_ran=False):
    """Phase 8."""
    bad = sorted(m for m in sys.modules if m in ("jax", "ecw_cc_tpu")
                 or m.startswith(("jax.", "jaxlib", "ecw_cc_tpu.")))
    want = (ES_MODULES if es_ran else ()) + (EOM_MODULES if eom_ran else ())
    missing = [m for m in want if m not in sys.modules]
    if bad or missing:
        raise AssertionError(f"imported: {bad}; not imported: {missing}")
    phase(8, "no_jax", ok=True, checked_modules=sum(
        m.startswith("ecw_cc_torch") for m in sys.modules))


# Phase 12: the CCSD solve's precision modes.  Each mode runs the f32
# ECW.CCSD_GS sweep on the packed route (one ladder launch per iteration,
# in the variant of the iteration's mode); 'default' and 'bf16' may stall
# above 1e-6 (a coarser fixed point, ecw_cc_tpu/config.py:53-54), so a
# 30-iteration chain first finds the Dconv at which each mode stalls and
# those two run at 3 times it (1e-6 at least).
PREC_MODES = (("highest", "high"), ("high", "high"), ("default", "high"),
              ("bf16", "high"), ("hybrid", "high"), ("hybrid", "bf16"))
PREC_REFINE = ("highest", "high", "bf16")      # sweeps rerun with refine
PREC_RAW = ("default", "bf16")
PREC_CHAIN, PREC_MAXITER, PREC_F64_THRES = 30, 40, 1e-9
PREC_L_TZ = [0.25]
LEG_VARIANT = {"highest": "f32", "high": "tf32", "default": "tf32",
               "bf16": "bf16"}
ROUTE_LAUNCHES = {"packed": 1, "dense": 2}   # ladder launches per iteration
POLISH_LAUNCHES = 2      # f64 ladder launches per polish iteration


def mode_name(mode, fast):
    return f"hybrid({fast})" if mode == "hybrid" else mode


@contextlib.contextmanager
def iter_precision(mode, fast="high"):
    from ecw_cc_torch import set_config

    set_config(iter_precision=mode, hybrid_fast=fast)
    try:
        yield
    finally:
        set_config(iter_precision="highest", hybrid_fast="high")


def reset_counts(ladder_mm, variants):
    ladder_mm.launches = ladder_mm.backward_launches = 0
    ladder_mm.launches_by_variant = dict.fromkeys(variants, 0)


def precision_chain(ecw, lmm, mode, basis):
    """Dconv's floor, ms per iteration and ladder launches by variant of a
    PREC_CHAIN-iteration chain (diis 'tl', conv_thres 0) at lambda = 0.25
    under `mode`; each iteration must launch its mode's variant."""
    reset_counts(lmm.ladder_mm, lmm.VARIANTS)
    with iter_precision(mode):
        res, log = solve(ecw, [0.25], conv_thres=0.0,
                         maxiter=PREC_CHAIN - 1)
    floor = float(np.min(res[3][1:]))
    n = log[0]["iterations"]
    counts = {v: c for v, c in lmm.ladder_mm.launches_by_variant.items() if c}
    row = dict(mode=mode, basis=basis, iterations=n,
               ms_per_iteration=log[0]["ms"] / n, floor=floor,
               route=log[0]["route"], launches=counts)
    phase(12, "precision_chain", **row)
    want = {LEG_VARIANT[mode]: ROUTE_LAUNCHES[log[0]["route"]] * n}
    if counts != want:
        raise AssertionError(f"{basis} {mode} chain launched {counts}, "
                             f"expected {want}")
    return row


def precision_sweep(ecw, lmm, mode, fast, lambdas, thres, refine, ref_ep,
                    basis):
    """One f32 ECW.CCSD_GS sweep under `mode` (refine: with the f64
    polish), its launches by variant against what its legs predict, and
    |dEp| per lambda against the f64 reference `ref_ep`."""
    reset_counts(lmm.ladder_mm, lmm.VARIANTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with iter_precision(mode, fast):
        res = ecw.CCSD_GS(lambdas, diis="tl", conv="tl", conv_thres=thres,
                          maxiter=PREC_MAXITER, refine=refine)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(lmm.ladder_mm.launches_by_variant)
    log = list(ecw.solve_log)
    want = dict.fromkeys(lmm.VARIANTS, 0)
    for s in log:
        for leg_mode, n, _ in s["legs"]:
            want[LEG_VARIANT[leg_mode]] += ROUTE_LAUNCHES[s["route"]] * n
    want["f64"] += POLISH_LAUNCHES * sum(s.get("refine_iterations", 0)
                                         for s in log)
    ep = [float(ecw.EHF - e) for e in ecw.Ep_lamb]
    row = dict(mode=mode_name(mode, fast), basis=basis, refine=refine,
               conv_thres=thres, L=list(lambdas),
               iterations=[s["iterations"] for s in log],
               converged=[s["status"] == 1 for s in log],
               legs=[s["legs"] for s in log],
               ms=[s["ms"] for s in log],
               routes=[s["route"] for s in log],
               refine_ms=[s.get("refine_ms") for s in log],
               refine_iterations=[s.get("refine_iterations") for s in log],
               ms_per_iteration=[s["ms"] / s["iterations"] for s in log],
               sweep_ms=sweep_ms, Ep=ep,
               dEp=[abs(a - b) for a, b in zip(ep, ref_ep)],
               launches=counts, expected_launches=want,
               rdm1_finite=bool(np.all(np.isfinite(res[4]))),
               amplitude_dtype=str(np.asarray(res[5][0]).dtype))
    phase(12, "precision_sweep", **row)
    if counts != want:
        raise AssertionError(f"{row['mode']} (refine={refine}) launched "
                             f"{counts}, its legs predict {want}")
    if not row["rdm1_finite"]:
        raise AssertionError(f"{row['mode']}: rdm1 is not finite")
    return row


def f64_reference(ecw, lambdas):
    """(Ep per lambda, iterations): the f64 sweep on the same molecule, SCF
    and target, on the f64 ERIs that refine polishes on (ECW.eris_f64,
    built on the card; solved on their PackedVVVV), converged to
    PREC_F64_THRES."""
    from ecw_cc_torch.ops.ladder import pack_vvvv

    er64 = ecw.eris_f64
    ecw64 = with_eris(ecw, er64, pack_vvvv(er64.vvvv), None)
    _, log = solve(ecw64, lambdas, conv_thres=PREC_F64_THRES, maxiter=60)
    ep = [float(ecw64.EHF - e) for e in ecw64.Ep_lamb]
    if not all(s["status"] == 1 for s in log):
        raise AssertionError(f"the f64 reference sweep did not converge: "
                             f"{log}")
    return ep, [s["iterations"] for s in log]


def run_phase12(lmm, ecw_tz=None):
    """Phase 12 (alone with --precision): every precision mode on the f32
    sweep at C2H2/cc-pVDZ, refine after 'highest', 'high' and 'bf16', and
    'bf16' + refine and both hybrids at cc-pVTZ (lambda = 0.25).  The
    refine polishes on ECW.eris_f64, the f64 ERIs the ECW transforms on the
    card at first use; the f64 reference sweep runs on the same ERIs.
    Returns ({path: launches}, {variant: launches})."""
    from ecw_cc_torch import get_config

    launches, by_variant = {}, dict.fromkeys(lmm.VARIANTS, 0)
    tests = [(BASIS, None, LAMBDAS, PREC_MODES, PREC_REFINE, ()),
             (BASIS_TZ, ecw_tz, PREC_L_TZ,
              (("bf16", "high"), ("hybrid", "high"), ("hybrid", "bf16")),
              ("bf16",), ("high",))]
    for basis, ecw, lambdas, modes, refine_after, chains in tests:
        t0 = time.perf_counter()
        ecw = ecw if ecw is not None else build_ecw("cuda", torch.float32,
                                                    basis=basis)
        t1 = time.perf_counter()
        ecw.eris_f64     # the refine's f64 ERIs, built once here
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ref_ep, ref_its = f64_reference(ecw, lambdas)
        phase(12, "set_up", basis=basis, ecw_s=t1 - t0, eris_f64_s=t2 - t1,
              f64_reference_s=time.perf_counter() - t2, Ep_f64=ref_ep,
              iterations_f64=ref_its,
              host_eris_built=ecw._eris_host is not None)
        # 'highest' always, for the ms per iteration the others save;
        # `chains`: modes timed by a chain only (cc-pVTZ 'high': what the
        # TF32 kernel does to an iteration on the card-bound route)
        floors = {m: precision_chain(ecw, lmm, m, basis)["floor"]
                  for m in sorted({m for m, _ in modes} - {"hybrid"}
                                  | {"highest"} | set(chains),
                                  key=list(LEG_VARIANT).index)}
        rows = {}
        for mode, fast in modes:
            thres = (max(CONV_THRES, 3 * floors[mode]) if mode in PREC_RAW
                     else CONV_THRES)
            for refine in (False, True) if mode in refine_after else (False,):
                key = (mode_name(mode, fast), refine)
                rows[key] = row = precision_sweep(
                    ecw, lmm, mode, fast, lambdas, thres, refine, ref_ep,
                    basis)
                tag_ = (f"c2h2_{basis.replace('-', '')}_f32_"
                        f"{key[0]}{'_refine' if refine else ''}")
                launches[tag_] = sum(row["launches"].values())
                for v, n in row["launches"].items():
                    by_variant[v] += n
        for (name, refine), row in rows.items():
            converged = all(row["converged"])
            if name in ("highest", "high", "hybrid(high)", "hybrid(bf16)"):
                if not converged:
                    raise AssertionError(f"{basis} {name} did not converge "
                                         f"to {CONV_THRES}: {row}")
            gap = max(row["dEp"])
            if refine and name in ("highest", "high") and gap > 1e-8:
                raise AssertionError(f"{basis} {name} + refine is {gap} Ha "
                                     "from f64 (limit 1e-8)")
            if name.startswith("hybrid") and gap > 1e-5:
                raise AssertionError(f"{basis} {name} is {gap} Ha from f64 "
                                     "(limit 1e-5)")
        if ecw._eris_host is not None:
            raise AssertionError(f"{basis}: refine built the host ERIs")
        phase(12, "precision_summary", basis=basis, floors=floors, rows=[
            {"mode": n, "refine": r, "iterations": row["iterations"],
             "converged": row["converged"], "max_dEp": max(row["dEp"]),
             "ms_per_iteration": row["ms_per_iteration"],
             "launches": {v: c for v, c in row["launches"].items() if c}}
            for (n, r), row in rows.items()])
        assert get_config().iter_precision == "highest"
        del ecw
        torch.cuda.empty_cache()
    return launches, by_variant


def kernel_kind(name):
    """The §5 breakdown's class of a kernel, from its name."""
    low = name.lower()
    for kind, keys in (("ladder_mm", ("ladder_mm",)),
                       ("gemm", ("gemm", "gemv", "splitk")),
                       ("elementwise", ("elementwise", "vectorized")),
                       ("reduce", ("reduce",)),
                       ("cat_index", ("cat", "index", "gather", "scatter"))):
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_chain(basis, route, diis="", lanes=None):
    """--profile: a torch.profiler trace of a fixed PROFILE_ITERS-iteration
    f32 chain at lambda = 0.25 (after a warm-up solve), beside the same
    chain run without the profiler, on the route's ERIs (route_eris:
    'sectored' or 'packed') of one ECW; with diis='tl' the
    chain is instead the sweep's converged solve (DIIS, conv_thres 1e-6);
    lanes: the chain batched over those lambdas (phase 14's), per batched
    iteration.  Prints kernels and launch calls per iteration, device ms
    per iteration by kernel class, the ten costliest kernels and host
    operators, and the busy share (device time over the unprofiled
    wall)."""
    from torch.profiler import ProfilerActivity, profile

    base = build_ecw("cuda", torch.float32, basis=basis)
    er, op, perm, _ = route_eris(base, route)
    ecw = with_eris(base, er, op, perm)
    del base
    chain = (dict(diis=diis, conv_thres=CONV_THRES) if diis else
             dict(diis="", conv_thres=0.0, maxiter=PROFILE_ITERS - 1))

    def run():
        """(iterations, the solve's ms) of one chain."""
        if lanes:
            b = batch_solve(ecw, lanes, **chain)
            return b["iterations"], b["ms"]
        _, log = solve(ecw, [0.25], **chain)
        return log[0]["iterations"], log[0]["ms"]

    run()
    plain = run()
    # no shapes under vmap: with record_shapes the profiler held the
    # batched chain's tensors until it ended (68 GB after 10 iterations of
    # 2 lanes at cc-pVTZ, against a 2.5 GB peak without)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=not lanes) as prof:
        t0 = time.perf_counter()
        n, _ = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind, kernels, host_ops = collections.Counter(), [], []
    n_kernels = launch_calls = 0
    for e in prof.key_averages():
        if e.key.startswith("cudaLaunchKernel"):
            launch_calls += e.count
        if str(e.device_type).endswith("CUDA"):
            us = e.self_device_time_total
            n_kernels += e.count
            by_kind[kernel_kind(e.key)] += us / 1e3 / n
            kernels.append((us, e.count, e.key[:100]))
        else:
            host_ops.append((e.self_cpu_time_total, e.count, e.key[:100]))
    # the operators (and their input shapes) whose own kernels took the
    # most device time
    ops = sorted(((e.self_device_time_total, e.count, e.key,
                   str(e.input_shapes)[:160])
                  for e in prof.key_averages(group_by_input_shape=True)
                  if not str(e.device_type).endswith("CUDA")
                  and e.self_device_time_total > 0), reverse=True)[:15]
    device_ms = sum(by_kind.values())
    plain_ms = plain[1] / plain[0]
    phase("P", "profile", basis=basis, route=route, diis=diis,
          lanes=len(lanes) if lanes else 1, iterations=n,
          kernels_per_iteration=n_kernels / n,
          launch_calls_per_iteration=launch_calls / n,
          device_ms_per_iteration=device_ms,
          device_ms_by_kind=dict(by_kind),
          profiled_ms_per_iteration=wall_ms / n,
          ms_per_iteration=plain_ms, busy_share=device_ms / plain_ms,
          top_kernels=[{"name": k, "launches": c, "ms": us / 1e3}
                       for us, c, k in sorted(kernels, reverse=True)[:10]],
          top_host_ops=[{"name": k, "calls": c, "self_ms": us / 1e3}
                        for us, c, k in sorted(host_ops, reverse=True)[:10]],
          top_ops_by_device_ms=[
              {"name": k, "shapes": sh, "calls": c, "device_ms": us / 1e3}
              for us, c, k, sh in ops])


# --routes: (molecule, basis) from nvir 16 to 162, across the 'auto'
# dense/packed crossover at nvir 48
ROUTE_CELLS = [("h2o", "6-31g"), ("c2h2", "6-31g"), ("h2o", "cc-pvdz"),
               ("c2h2", "6-31g*"), ("c2h2", "cc-pvdz"), ("c2h2", "cc-pvtz")]
ROUTE_REPS = 3


def route_eris(ecw, route):
    """(eris, vvvv_op, mo_perm) of an ECW f32 route on the card:
    'sectored' (sorted, SectoredVVVV), 'packed' (alternating PackedVVVV),
    'dense' (alternating, dense vvvv), and the build's host seconds."""
    from ecw_cc_torch.models.eris import build_eris_device
    from ecw_cc_torch.ops.ladder import spin_sort_perm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kw = dict(dtype=torch.float32, device="cuda")
    if route == "dense":
        out = (build_eris_device(ecw.mol, ecw.mf, **kw), None, None)
    else:
        sort = route == "sectored"
        er, op = build_eris_device(ecw.mol, ecw.mf, pack_ladder=True,
                                   sort_spin=sort, **kw)
        out = (er, op, spin_sort_perm(ecw.mf.orbspin, ecw.nocc)
               if sort else None)
    torch.cuda.synchronize()
    return out + (time.perf_counter() - t0,)


def route_sweeps(ladder_mm, cells=ROUTE_CELLS, reps=ROUTE_REPS,
                 routes=("sectored", "packed", "dense")):
    """--routes: at each cell, the f32 warm-started sweep of phase 4 (HF
    target with a field, lambda = 0, 0.25, 0.5, diis 'tl', conv_thres
    1e-6) through ECW.CCSD_GS on each route's device ERIs (one SCF per
    cell): one untimed sweep per route, then `reps` timed ones with the
    routes in turns.  Prints one line per route and cell and returns the
    rows."""
    import io

    import ecw_cc_torch

    rows = []
    for mol_name, basis in cells:
        with contextlib.redirect_stdout(io.StringIO()):
            from ecw_cc_torch import ECW
            base = ECW(mol_name, basis, device="cuda", dtype=torch.float32)
            base.Build_GS_exp("mat", "HF", field=FIELD)
        ecws, build_s = {}, {}
        for route in routes:
            er, op, perm, build_s[route] = route_eris(base, route)
            ecws[route] = with_eris(base, er, op, perm)
        del base
        runs = {r: [] for r in routes}
        for rep in range(reps + 1):
            for route in (routes if rep % 2 == 0 else routes[::-1]):
                ecw = ecws[route]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ladder_mm.launches = 0
                # the dense route's solver keeps no operand only under
                # ladder_mode='dense' ('auto' packs eris.vvvv at nvir >= 48)
                ecw_cc_torch.set_config(ladder_mode=(
                    "dense" if route == "dense" else "auto"))
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    res, log = solve(ecw, LAMBDAS, conv_thres=CONV_THRES)
                ms = (time.perf_counter() - t0) * 1e3
                ecw_cc_torch.set_config(ladder_mode="auto")
                if rep == 0:
                    continue                      # the untimed sweep
                runs[route].append(dict(
                    ms=ms, solve_ms=[s["ms"] for s in log],
                    iterations=[s["iterations"] for s in log],
                    Ep=[float(ecw.EHF - e) for e in ecw.Ep_lamb],
                    route=[s["route"] for s in log],
                    converged=all(s["status"] == 1 for s in log),
                    launches=ladder_mm.launches,
                    peak_bytes=torch.cuda.max_memory_allocated()))
        for route in routes:
            r = runs[route]
            its = sum(r[0]["iterations"])
            ms = statistics.median(x["ms"] for x in r)
            row = dict(molecule=mol_name, basis=basis,
                       nvir=ecws[route].nvir, route=route,
                       solver_routes=r[0]["route"], build_s=build_s[route],
                       sweep_ms=ms, sweep_ms_runs=[x["ms"] for x in r],
                       solve_ms_runs=[x["solve_ms"] for x in r],
                       iterations=r[0]["iterations"],
                       ms_per_iteration=ms / its, Ep=r[0]["Ep"],
                       launches_per_iteration=r[0]["launches"] / its,
                       peak_bytes=max(x["peak_bytes"] for x in r),
                       converged=all(x["converged"] for x in r))
            rows.append(row)
            phase("R", "route_sweep", **row)
            if not row["converged"] or set(row["solver_routes"]) != {route}:
                raise AssertionError(f"{mol_name}/{basis} {route}: a lambda "
                                     "did not converge or took the route "
                                     f"{row['solver_routes']}")
        del ecws
        torch.cuda.empty_cache()
    return rows


# Phase 13: EOM-CCSD.  (a) runs the JAX package's EOM bench rows
# (bench.py:713-776) at their full width, C2H2/cc-pVDZ f32 on the ERIs ECW
# builds (alternating layout, a PackedVVVV), and holds the energies to
# BENCH_r05's (rounded there to 3 decimals, so +-0.005 eV): EE 5.51 eV
# (one root) and 6.682 (the second of two with left vectors), IP 11.315,
# EA 4.493.
EOM_ANCHOR_EV = {"ee": (5.51,), "ee_left": (None, 6.682), "ip": (11.315,),
                 "ea": (4.493,)}
EOM_EV_TOL = 0.005
EOM_TOL = {torch.float32: 1e-5, torch.float64: 1e-7}
EOM_CCSD_TOL = 1e-8          # solve_ccsd(conv_tol=) of the bench rows
EOM_REPS = 3                 # timed warm solves (median), after one counted
EOM_SOLVES = ("ee", "ee_left", "ip", "ea")
# ladder products per matvec of each route's EE sigma (right: forward and
# tangent; left: forward and backward) and of the EA sigma on pack-on-build
# ERIs; IP reads no vvvv
EOM_PRODUCTS = {"packed": 1, "dense": 1, "sectored": 3}
EOM_MODULES = ("ecw_cc_torch.ops.eom", "ecw_cc_torch.ops.eom_ipea",
               "ecw_cc_torch.ops.wick")


def eom_calls(eris, op, t1, t2, tol):
    """The four solves of the bench rows, each as fn(log)."""
    from ecw_cc_torch.ops import eom, eom_ipea

    return {
        "ee": lambda log: eom.eom_ccsd(eris, t1, t2, nroots=1, tol=tol,
                                       vvvv_op=op, log=log),
        "ee_left": lambda log: eom.eom_ccsd(eris, t1, t2, nroots=2, tol=tol,
                                            left=True, vvvv_op=op, log=log),
        "ip": lambda log: eom_ipea.eom_ip_ccsd(eris, t1, t2, nroots=2,
                                               tol=tol, log=log),
        "ea": lambda log: eom_ipea.eom_ea_ccsd(eris, t1, t2, nroots=1,
                                               tol=tol, vvvv_op=op, log=log)}


def eom_matvecs(log):
    """(right, left) matvecs of an EOM solve's log, the left ones with
    those of every per-root solve."""
    left = log.get("left", [])
    left = left if isinstance(left, list) else [left]
    left = left + log.get("left_follow", [])
    return log["right"]["matvecs"], sum(x["matvecs"] for x in left)


def eom_cycles(log):
    left = log.get("left", [])
    left = left if isinstance(left, list) else [left]
    return ([log["right"]["cycles"]]
            + [x["cycles"] for x in left + log.get("left_follow", [])])


def expected_eom_launches(name, log, products, ea_packed):
    """(forward, tangent, backward) ladder launches of one solve: per right
    matvec `products` forward and as many tangent ones (EE), per left
    matvec forward and backward; the EA sigma as many forward per right
    matvec on pack-on-build ERIs (`ea_packed`; with a dense vvvv its
    ladder terms are einsums, as in the JAX package); IP none."""
    right, left = eom_matvecs(log)
    if name == "ip" or (name == "ea" and not ea_packed):
        return 0, 0, 0
    if name == "ea":
        return products * right, 0, products * left
    return products * (right + left), products * right, products * left


def count_all(ladder_mm, fn):
    """(result of fn(), (forward, tangent, backward) launches)."""
    ladder_mm.launches = ladder_mm.backward_launches = 0
    ladder_mm.tangent_launches = 0
    out = fn()
    tan, back = ladder_mm.tangent_launches, ladder_mm.backward_launches
    return out, (ladder_mm.launches - tan - back, tan, back)


def run_eom_solves(ladder_mm, tag_, eris, op, t1, t2, route, reps):
    """The four solves on one set of ERIs: one counted run each (launches
    held to expected_eom_launches, peak memory), then `reps` timed ones."""
    dtype = t1.dtype
    out = {}
    for name, fn in eom_calls(eris, op, t1, t2, EOM_TOL[dtype]).items():
        log = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res, launches = count_all(ladder_mm, lambda: fn(log))
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn({})
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        want = expected_eom_launches(name, log, EOM_PRODUCTS[route],
                                     eris.vvvv.numel() == 0)
        omegas = [float(w) for w in res[0]]
        conv = [log["right"]["converged"]] + [
            x["converged"] for x in ([log["left"]] if isinstance(
                log.get("left"), dict) else log.get("left", []))]
        phase(13, "eom_solve", path=tag_, solve=name, dtype=str(dtype),
              route=route, omegas_Ha=omegas,
              omegas_eV=[w * EV for w in omegas], cycles=eom_cycles(log),
              matvecs=eom_matvecs(log), converged=conv,
              launches_fwd_tan_back=launches, expected=want,
              launches_per_matvec=want[0] / max(1, sum(eom_matvecs(log))),
              cold_ms=cold_ms, warm_ms=statistics.median(runs) if runs
              else None, warm_ms_runs=runs, peak_bytes_above_base=peak)
        if tuple(launches) != tuple(want):
            raise AssertionError(f"{tag_} {name}: ladder launches "
                                 f"(forward, tangent, backward) {launches}, "
                                 f"expected {want}")
        if not all(all(c) for c in conv):
            raise AssertionError(f"{tag_} {name}: a Davidson did not "
                                 f"converge: {log}")
        out[name] = dict(res=res, log=log, launches=launches,
                         ms=statistics.median(runs) if runs else None)
    return out


def eom_overlaps(Rs, Ls):
    """<L_j|R_k> = l1.r1 + 1/4 l2.r2 (the EE operator convention)."""
    n = len(Rs)
    return np.array([[float(torch.vdot(Ls[j][0].reshape(-1),
                                       Rs[k][0].reshape(-1))
                            + 0.25 * torch.vdot(Ls[j][1].reshape(-1),
                                                Rs[k][1].reshape(-1)))
                      for k in range(n)] for j in range(n)])


def eom_matvec_ms(eris, op, t1, t2, reps=EOM_REPS * 3):
    """Host ms (synchronized, median of `reps` after one untimed call) of
    one right EE matvec (torch.func.jvp of the residual), one left one
    (vjp), and the residual alone (the primal that the jvp evaluates
    again in every right matvec, ROADMAP A.12)."""
    from ecw_cc_torch.ops import eom

    g = torch.Generator(t1.device).manual_seed(7)
    r1 = torch.randn(t1.shape, generator=g, device=t1.device, dtype=t1.dtype)
    r2 = eom._asym(torch.randn(t2.shape, generator=g, device=t1.device,
                               dtype=t1.dtype))
    sigma, sigma_left = eom.make_sigma(eris, t1, t2, vvvv_op=op)

    def primal():
        with torch.no_grad():
            return eom._residual(eris, op, None, t1, t2, None)

    out = {}
    for name, fn in (("right_matvec", lambda: sigma(r1, r2)),
                     ("left_matvec", lambda: sigma_left(r1, r2)),
                     ("primal_residual", primal)):
        fn()
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(runs)
    return out


def run_eom_bench(ladder_mm):
    """Phase 13 (a).  Returns {path: (forward, tangent, backward)}."""
    import io

    from ecw_cc_torch import ECW
    from ecw_cc_torch.models.eris import build_eris_device
    from ecw_cc_torch.ops import ccsd_t
    from ecw_cc_torch.ops.ladder import PackedVVVV

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ecw = ECW(MOLECULE, BASIS, device=CARD, dtype=torch.float32)
    setup_s = time.perf_counter() - t0
    if not isinstance(ecw.vvvv_op, PackedVVVV) or ecw.eris.vvvv.numel():
        raise AssertionError("the f32 ECW did not build pack-on-build ERIs")
    ccsd_log = {}
    t0 = time.perf_counter()
    t1, t2, e_cc = ccsd_t.solve_ccsd(ecw.eris, conv_tol=EOM_CCSD_TOL,
                                     vvvv_op=ecw.vvvv_op, log=ccsd_log)
    ccsd_s = time.perf_counter() - t0
    r32 = run_eom_solves(ladder_mm, "c2h2_ccpvdz_f32_eom", ecw.eris,
                         ecw.vvvv_op, t1, t2, "packed", EOM_REPS)
    mv_ms = eom_matvec_ms(ecw.eris, ecw.vvvv_op, t1, t2)
    er64, op64 = build_eris_device(ecw.mol, ecw.mf, dtype=torch.float64,
                                   device=CARD, pack_ladder=True)
    t1d, t2d, e_cc64 = ccsd_t.solve_ccsd(er64, vvvv_op=op64)
    r64 = run_eom_solves(ladder_mm, "c2h2_ccpvdz_f64_eom", er64, op64, t1d,
                         t2d, "packed", 0)
    ev = {k: [w * EV for w in r32[k]["res"][0]] for k in EOM_SOLVES}
    d_anchor = {k: [abs(e - a) for e, a in zip(ev[k], EOM_ANCHOR_EV[k])
                    if a is not None] for k in EOM_SOLVES}
    d64 = {k: max(abs(a - b) for a, b in zip(r32[k]["res"][0],
                                             r64[k]["res"][0]))
           for k in EOM_SOLVES}
    _, Rs, Ls = r32["ee_left"]["res"]
    O = eom_overlaps(Rs, Ls)
    diag_err = float(np.abs(np.diag(O) - 1.0).max())
    off = float(np.abs(O - np.diag(np.diag(O))).max())
    phase(13, "eom_bench", molecule=MOLECULE, basis=BASIS, nocc=ecw.nocc,
          nvir=ecw.nvir, setup_seconds=setup_s, ccsd=ccsd_log,
          ccsd_seconds=ccsd_s, E_ccsd_f32=float(e_cc),
          E_ccsd_f64=float(e_cc64), eV_f32=ev, anchors_eV=EOM_ANCHOR_EV,
          d_anchor_eV=d_anchor, d_f32_vs_f64_Ha=d64, left_right_overlap=O,
          biorthonormal_err=diag_err, off_diagonal_max=off,
          warm_ms={k: r32[k]["ms"] for k in EOM_SOLVES}, matvec_ms=mv_ms)
    if max(max(v) for v in d_anchor.values()) > EOM_EV_TOL:
        raise AssertionError(f"EOM energies off BENCH_r05's anchors by "
                             f"{d_anchor} eV")
    if max(d64.values()) > 1e-5:
        raise AssertionError(f"f32 EOM roots differ from f64 by {d64} Ha")
    if diag_err > 1e-5 or off > 1e-4:
        raise AssertionError(f"<L|R> is not biorthonormal: {O}")
    return {"c2h2_ccpvdz_f32_eom": sum_launches(r32),
            "c2h2_ccpvdz_f64_eom": sum_launches(r64)}


def sum_launches(results):
    return tuple(int(sum(r["launches"][i] for r in results.values()))
                 for i in range(3))


def run_eom_parity(ladder_mm):
    """Phase 13 (b): C2H2/6-31G f64, the card against the CPU (dense
    route: the kernel at 196 x 900 x 900)."""
    import io

    from ecw_cc_torch import ECW
    from ecw_cc_torch.ops import ccsd_t

    res = {}
    for dev in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            ecw = ECW(MOLECULE, SMALL_BASIS, device=dev, dtype=torch.float64)
        t1, t2, _ = ccsd_t.solve_ccsd(ecw.eris)
        out = {}
        for name, fn in eom_calls(ecw.eris, None, t1, t2,
                                  EOM_TOL[torch.float64]).items():
            log = {}
            t0 = time.perf_counter()
            r, launches = count_all(ladder_mm, lambda: fn(log))
            out[name] = dict(w=[float(x) for x in r[0]], log=log,
                             launches=launches, cycles=eom_cycles(log),
                             matvecs=eom_matvecs(log),
                             s=time.perf_counter() - t0)
        res[dev] = out
    card, cpu = res["cuda"], res["cpu"]
    dw = {k: max(abs(a - b) for a, b in zip(card[k]["w"], cpu[k]["w"]))
          for k in EOM_SOLVES}
    same = {k: card[k]["cycles"] == cpu[k]["cycles"]
            and card[k]["matvecs"] == cpu[k]["matvecs"] for k in EOM_SOLVES}
    want = {k: expected_eom_launches(k, card[k]["log"], EOM_PRODUCTS["dense"],
                                     False) for k in EOM_SOLVES}
    phase(13, "eom_card_vs_cpu", molecule=MOLECULE, basis=SMALL_BASIS,
          dtype="float64", omegas_cpu={k: cpu[k]["w"] for k in EOM_SOLVES},
          d_omega_Ha=dw, cycles={k: (card[k]["cycles"], cpu[k]["cycles"])
                                 for k in EOM_SOLVES},
          same_cycles=same, seconds={k: (card[k]["s"], cpu[k]["s"])
                                     for k in EOM_SOLVES},
          launches_card={k: card[k]["launches"] for k in EOM_SOLVES},
          expected=want,
          launches_cpu={k: cpu[k]["launches"] for k in EOM_SOLVES})
    if max(dw.values()) > 1e-9 or not all(same.values()):
        raise AssertionError(f"f64 EOM on the card differs from the CPU: "
                             f"{dw}, cycles {same}")
    if any(tuple(card[k]["launches"]) != tuple(want[k]) for k in EOM_SOLVES):
        raise AssertionError(f"card launches {[card[k]['launches'] for k in EOM_SOLVES]}"
                             f" against {want}")
    if any(any(cpu[k]["launches"]) for k in EOM_SOLVES) and CARD == "cuda":
        raise AssertionError("the CPU solves launched the kernel")
    return {"c2h2_631g_f64_eom_card": tuple(
        int(sum(card[k]["launches"][i] for k in EOM_SOLVES))
        for i in range(3))}


def eom_target(ladder_mm, dtype):
    """ECW(trans-bent acetylene, cc-pVDZ).Build_ES_exp_EOM(2, 'trdip') on
    the card: (ECW, set-up seconds, target seconds, launches)."""
    import io

    from ecw_cc_torch import ECW

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ecw = ECW(ES_ACETYLENE, BASIS, device=CARD, dtype=dtype)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, launches = count_all(
            ladder_mm, lambda: ecw.Build_ES_exp_EOM(2, "trdip"))
    return ecw, setup_s, time.perf_counter() - t0, launches


def run_eom_targets(ladder_mm):
    """Phase 13 (c)."""
    out, launches = {}, {}
    for dtype in (torch.float32, torch.float64):
        ecw, setup_s, target_s, n = eom_target(ladder_mm, dtype)
        log = ecw.es_eom.log
        right, left = eom_matvecs(log["eom"])
        # f32: the sorted sectored build (sectored sigma, 2 products per
        # CCSD and Lambda iteration under the mirror gate, 3 without); f64:
        # the dense host build (the CCSD solve packs its operand at nvir
        # 62, 1 product per iteration; Lambda and the sigma dense, 1)
        route = "sectored" if dtype == torch.float32 else "dense"
        k = EOM_PRODUCTS[route]
        per_it = (2 if log["sym"] else 3) if route == "sectored" else 1
        want = (k * (right + left) + per_it * (log["ccsd"]["iterations"]
                                               + log["lambda"]["iterations"]),
                k * right, k * left)
        traces = [float(np.trace(g)) for g in ecw.es_eom.gamma_es_mo]
        out[dtype] = dict(ecw=ecw, w=np.asarray(ecw.Eexp_ES[0]),
                          f=np.asarray(ecw.f_osc_ES), traces=traces)
        # "f32"/"f64" in the name: the kernel report files a path's
        # launches under the entry of that dtype
        name = ("c2h2_bent_ccpvdz_"
                f"{'f64' if dtype == torch.float64 else 'f32'}_eom_target")
        launches[name] = tuple(int(x) for x in n)
        phase(13, "eom_target", path=name, route=route, sym=log["sym"],
              setup_seconds=setup_s, target_seconds=target_s,
              stages={k_: v for k_, v in log.items()
                      if k_.endswith("_s")},
              ccsd_iterations=log["ccsd"]["iterations"],
              lambda_iterations=log["lambda"]["iterations"],
              eom=log["eom"], omegas_eV=(out[dtype]["w"] * EV).tolist(),
              f_osc=out[dtype]["f"].tolist(), spin=ecw.spin_ES,
              trace_gamma_es=traces, launches_fwd_tan_back=n,
              expected=want)
        if tuple(n) != want:
            raise AssertionError(f"{name}: ladder launches {n}, expected "
                                 f"{want}")
        nelec = ecw.mol.nelectron
        if max(abs(t - nelec) for t in traces) > 1e-5:
            raise AssertionError(f"{name}: Tr(gamma_es) = {traces}, not "
                                 f"{nelec}")
    o32, o64 = out[torch.float32], out[torch.float64]
    dw = float(np.abs(o32["w"] - o64["w"]).max())
    df = float(np.abs(o32["f"] - o64["f"]).max())
    phase(13, "eom_target_compare", d_omega_f32_vs_f64_Ha=dw,
          d_f_osc_f32_vs_f64=df)
    if dw > 1e-5 or df > 1e-4:
        raise AssertionError(f"f32 EOM targets differ from f64: roots "
                             f"{dw} Ha, f_osc {df}")
    # The sweep on the f32 targets.  The two lowest roots are triplets:
    # their transition dipoles vanish, and on those 'trdip' targets the
    # lambda = 0.1 solve does not converge (at f32 and f64, device and
    # host loop alike), which is recorded; the check is the sweep on the
    # same states' transition densities ('trmat', what
    # Build_ES_exp_EOM(prop='trmat') stores)
    ecw = o32["ecw"]
    flows = {"trdip": ecw, "trmat": copy.copy(ecw)}
    flows["trmat"].exp_data = [[]] + [[["trmat", list(tr)]]
                                     for tr in ecw.es_eom.gamma_tr_mo]
    result = {}
    for prop, e in flows.items():
        _, sweep_ms = es_solve(e, np.asarray(ES_SWEEP), L_loop=True)
        its = [x["iterations"] for x in e.solve_log]
        ok = [x["status"] == 1 and bool(np.all(np.isfinite(ep[0])))
              for x, ep in zip(e.solve_log, e.Ep_lamb)]
        result[prop] = ok
        phase(13, "eom_target_sweep", prop=prop, lambdas=ES_SWEEP,
              iterations=its, converged=ok, sweep_ms=sweep_ms,
              Ep=[np.asarray(x[0], np.float64).tolist() for x in e.Ep_lamb])
    ok = result["trmat"]
    if len(ok) != len(ES_SWEEP) or not all(ok):
        raise AssertionError(f"CCS_ES on the EOM 'trmat' targets: {ok}")
    return launches


def run_phase13(ladder_mm):
    """Phase 13; returns {path: (forward, tangent, backward) launches}."""
    launches = run_eom_bench(ladder_mm)
    launches.update(run_eom_parity(ladder_mm))
    launches.update(run_eom_targets(ladder_mm))
    torch.cuda.empty_cache()
    return launches


# Phase 14: the batched lambda sweep (Solver_CCSD.SCF_batch through
# ECW.CCSD_GS(mode='parallel')): every lambda a lane of one vmapped
# iteration step, each ladder product one launch for all lanes, the lanes
# cold-started, so each is held to a cold-start sequential solve at its
# lambda (a CCSD_GS call per lambda), not to the warm-started sweep.
BATCH_GRID = [float(x) for x in np.linspace(0.0, 0.5, 8)]
BATCH_SYNC_ITERS = (4, 12)    # 14e: two chains, differenced
SYNC_MARK = "the one read per iteration"    # solvers/gs.py's loop tests


def batch_solve(ecw, lambdas, **kw):
    """One ECW.CCSD_GS(mode='parallel') (diis 'tl', conv 'tl'), timed:
    {Ep per lane, solve_log, wall ms, ladder launches, peak bytes, the
    batched iterations (per leg, the slowest lane's), rdm1 finite}."""
    from ecw_cc_torch.kernels.ladder_mm import ladder_mm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = ladder_mm.launches
    t0 = time.perf_counter()
    res = ecw.CCSD_GS(list(lambdas), diis=kw.pop("diis", "tl"), conv="tl",
                      mode="parallel", **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    log = list(ecw.solve_log)
    return dict(Ep=[float(ecw.EHF - e) for e in ecw.Ep_lamb], log=log,
                ms=ms, launches=ladder_mm.launches - n0,
                peak_bytes=torch.cuda.max_memory_allocated(),
                iterations=sum(max(n) for _, n, _ in log[0]["legs"]),
                rdm1_finite=bool(np.all(np.isfinite(res[4]))))


def cold_starts(ecw, lambdas, **kw):
    """A cold-start sequential solve per lambda (one CCSD_GS call each):
    ([(Ep, iterations, status)], total ms)."""
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for L in lambdas:
        res, log = solve(ecw, [L], **kw)
        rows.append((float(res[1][-1]), log[0]["iterations"],
                     log[0]["status"]))
    return rows, (time.perf_counter() - t0) * 1e3


def check_lanes(name, b, cold, route, per_iter, tol=1e-5, dit=1):
    """The batch `b` (batch_solve) on `route`, each lane converged within
    tol and dit iterations of its cold start, and exactly per_iter ladder
    launches per batched iteration.  Returns the lanes' fields."""
    log = b["log"]
    its = [s["iterations"] for s in log]
    dEp = [abs(e - c[0]) for e, c in zip(b["Ep"], cold)]
    fields = dict(lanes=len(log), route=log[0]["route"], sym=log[0]["sym"],
                  iterations=its, iterations_cold=[c[1] for c in cold],
                  batched_iterations=b["iterations"],
                  ladder_launches=b["launches"], dEp_vs_cold=dEp,
                  ms=b["ms"], ms_per_batched_iteration=b["ms"]
                  / b["iterations"], peak_bytes=b["peak_bytes"])
    if not all(s["status"] == 1 for s in log) or not b["rdm1_finite"]:
        raise AssertionError(f"{name}: a lane did not converge: {fields}")
    if {s["route"] for s in log} != {route}:
        raise AssertionError(f"{name}: route {fields['route']}, not {route}")
    if b["launches"] != per_iter * b["iterations"]:
        raise AssertionError(f"{name}: {b['launches']} ladder launches in "
                             f"{b['iterations']} batched iterations "
                             f"(expected {per_iter} each, for all lanes)")
    bad = [i for i, c in enumerate(cold)
           if dEp[i] > tol or abs(its[i] - c[1]) > dit or c[2] != 1]
    if bad:
        raise AssertionError(f"{name}: lanes {bad} differ from their cold "
                             f"starts: {fields}")
    return fields


def run_batch_dz(ecw32):
    """Phase 14 (a): 3 lanes and the 8-lane grid at cc-pVDZ f32, beside
    the warm-started sequential sweep and the cold-start one.  Returns
    ({path: launches}, the 3 lanes' cold starts)."""
    # one untimed solve of each kind first (a process's first solve loads
    # its kernels)
    solve(ecw32, [0.25], conv_thres=CONV_THRES)
    batch_solve(ecw32, LAMBDAS[:2], conv_thres=CONV_THRES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, warm = solve(ecw32, LAMBDAS, conv_thres=CONV_THRES)
    warm_ms = (time.perf_counter() - t0) * 1e3
    row, launches, cold3 = {}, {}, None
    for name, lambdas in (("lanes3", LAMBDAS), ("grid8", BATCH_GRID)):
        cold, cold_ms = cold_starts(ecw32, lambdas, conv_thres=CONV_THRES)
        b = batch_solve(ecw32, lambdas, conv_thres=CONV_THRES)
        row[name] = check_lanes(f"14a {name}", b, cold, "packed", 1)
        row[name]["cold_sequential_ms"] = cold_ms
        launches[f"c2h2_ccpvdz_f32_batch_{name}"] = b["launches"]
        cold3 = cold3 or cold
    phase(14, "batch_ccpvdz_f32", **row, warm_sequential_ms=warm_ms,
          warm_iterations=[s["iterations"] for s in warm])
    return launches, cold3


def run_batch_f64():
    """Phase 14 (b): f64 at C2H2/6-31G (nvir 30: the dense route, 2
    launches per iteration), the batch on the card against the batch on
    the CPU (1e-9 Ha, equal iterations per lane), both against the card's
    cold-start sequential solves."""
    card = build_ecw("cuda", torch.float64, basis=SMALL_BASIS)
    cpu = build_ecw("cpu", torch.float64, basis=SMALL_BASIS)
    b_card = batch_solve(card, LAMBDAS, conv_thres=1e-9, maxiter=60)
    t0 = time.perf_counter()
    res = cpu.CCSD_GS(LAMBDAS, diis="tl", conv="tl", mode="parallel",
                      conv_thres=1e-9, maxiter=60)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    ep_cpu = [float(cpu.EHF - e) for e in cpu.Ep_lamb]
    its_cpu = [s["iterations"] for s in cpu.solve_log]
    cold, cold_ms = cold_starts(card, LAMBDAS, conv_thres=1e-9, maxiter=60)
    fields = check_lanes("14b card", b_card, cold, "dense", 2, tol=1e-9,
                         dit=0)
    d_cpu = [abs(a - c) for a, c in zip(b_card["Ep"], ep_cpu)]
    phase(14, "batch_f64_card_vs_cpu", basis=SMALL_BASIS, card=fields,
          iterations_cpu=its_cpu, dEp_card_vs_cpu=d_cpu, cpu_ms=cpu_ms,
          cold_sequential_ms=cold_ms,
          cpu_converged=all(s["status"] == 1 for s in cpu.solve_log),
          rdm1_finite_cpu=bool(np.all(np.isfinite(res[4]))))
    if max(d_cpu) > 1e-9 or its_cpu != fields["iterations"]:
        raise AssertionError(f"14b: the f64 batch on the card differs from "
                             f"the CPU: {d_cpu}, {its_cpu} against "
                             f"{fields['iterations']}")
    return {"c2h2_631g_f64_batch": b_card["launches"]}


def batch_busy_share(ecw, lambdas, iters=PROFILE_ITERS):
    """--profile's busy share of a fixed `iters`-iteration batched chain
    (diis '', conv_thres 0): the profiler's device ms over the unprofiled
    chain's wall ms, both per batched iteration."""
    from torch.profiler import ProfilerActivity, profile

    chain = dict(diis="", conv_thres=0.0, maxiter=iters - 1)
    plain = batch_solve(ecw, lambdas, **chain)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        batch_solve(ecw, lambdas, **chain)
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")) / 1e3
    wall = plain["ms"] / plain["iterations"]
    dev = device_ms / plain["iterations"]
    return dict(chain_iterations=plain["iterations"],
                chain_ms_per_iteration=wall,
                device_ms_per_iteration=dev, busy_share=dev / wall)


def run_batch_tz(ecw_tz):
    """Phase 14 (c): 3 lanes at full width, C2H2/cc-pVTZ f32 on phase 7's
    ECW (packed route)."""
    cold, cold_ms = cold_starts(ecw_tz, LAMBDAS, conv_thres=CONV_THRES)
    b = batch_solve(ecw_tz, LAMBDAS, conv_thres=CONV_THRES)
    fields = check_lanes("14c", b, cold, "packed", 1)
    phase(14, "batch_ccpvtz_f32", **fields, cold_sequential_ms=cold_ms,
          **batch_busy_share(ecw_tz, LAMBDAS))
    return {"c2h2_ccpvtz_f32_batch": b["launches"]}


def run_batch_routes(lmm, ecw32, cold):
    """Phase 14 (d): the sorted sectored route at cc-pVDZ batched with the
    mirror symmetry (2 launches per batched iteration), then 'high' and
    'hybrid' batched on the packed route, each iteration launching its
    leg's variant once for all lanes; every hybrid lane within 1e-5 Ha of
    its 'highest' cold start (`cold`, 14a's).  Returns ({path: launches},
    {variant: launches} of the precision runs)."""
    er, op, perm, build_s = route_eris(ecw32, "sectored")
    ecw_s = with_eris(ecw32, er, op, perm)
    cold_s, cold_ms = cold_starts(ecw_s, LAMBDAS, conv_thres=CONV_THRES)
    b = batch_solve(ecw_s, LAMBDAS, conv_thres=CONV_THRES)
    row = {"sectored": check_lanes("14d sectored", b, cold_s, "sectored", 2)
           | {"cold_sequential_ms": cold_ms, "build_s": build_s}}
    if not b["log"][0]["sym"]:
        raise AssertionError("14d: the sectored batch ran without sym")
    launches = {"c2h2_ccpvdz_f32_batch_sectored": b["launches"]}
    by_variant = dict.fromkeys(lmm.VARIANTS, 0)
    del ecw_s, er, op
    for mode in ("high", "hybrid"):
        reset_counts(lmm.ladder_mm, lmm.VARIANTS)
        with iter_precision(mode):
            b = batch_solve(ecw32, LAMBDAS, conv_thres=CONV_THRES,
                            maxiter=PREC_MAXITER)
        counts = dict(lmm.ladder_mm.launches_by_variant)
        want = dict.fromkeys(lmm.VARIANTS, 0)
        for leg_mode, n, _ in b["log"][0]["legs"]:
            want[LEG_VARIANT[leg_mode]] += max(n)
        dEp = [abs(e - c[0]) for e, c in zip(b["Ep"], cold)]
        row[mode] = dict(iterations=[s["iterations"] for s in b["log"]],
                         legs=b["log"][0]["legs"], launches=counts,
                         expected_launches=want, ms=b["ms"],
                         ms_per_batched_iteration=b["ms"] / b["iterations"],
                         dEp_vs_highest_cold=dEp)
        if counts != want:
            raise AssertionError(f"14d {mode}: launched {counts}, its legs "
                                 f"predict {want}")
        if not all(s["status"] == 1 for s in b["log"]):
            raise AssertionError(f"14d {mode}: a lane did not converge")
        if mode == "hybrid" and max(dEp) > 1e-5:
            raise AssertionError(f"14d hybrid: lanes {dEp} Ha from their "
                                 "'highest' cold starts")
        for v, n in counts.items():
            by_variant[v] += n
    phase(14, "batch_routes_ccpvdz_f32", **row)
    return launches, by_variant


def sync_source(w):
    """A sync-debug warning's Python line, from the package or torch."""
    return (re.sub(r"^.*?(ecw_cc_torch/|torch/|chip_smoke)", r"\1",
                   w.filename) + f":{w.lineno}")


def syncs_per_iteration(run, iters=BATCH_SYNC_ITERS):
    """({Python line: synchronizing CUDA calls per iteration}, {line: the
    change of a count that did not follow the chain's length}) of the
    chain run(n) (n iterations), as torch.cuda.set_sync_debug_mode('warn')
    names them: the difference of two chains, after one unrecorded
    warm-up.  A line whose count differs by one between the chains synced
    once per call in one of them (a first use), not per iteration."""
    run(iters[0])
    got = []
    for n in iters:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run(n)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        got.append(collections.Counter(
            sync_source(w) for w in caught
            if "synchroniz" in str(w.message).lower()))
    (n1, n2), (s1, s2) = iters, got
    diff = {k: s2[k] - s1[k] for k in s1.keys() | s2.keys()
            if s2[k] != s1[k]}
    return ({k: d / (n2 - n1) for k, d in diff.items() if abs(d) > 1},
            {k: d for k, d in diff.items() if abs(d) <= 1})


def run_batch_syncs(ecw32):
    """Phase 14 (e): synchronizing calls per iteration, by Python line, of
    a batched chain (3 lanes) and of the sequential CCSD chain (diis
    'tl', conv_thres 0): exactly one each, the loop test's read of
    solvers/gs.py."""
    import ecw_cc_torch.solvers.gs as gs

    # one loop runs both: SCF_batch's lanes and SCF's one
    lines, start = inspect.getsourcelines(gs.Solver_CCSD._solve)
    test = [f"ecw_cc_torch/solvers/gs.py:{start + i}"
            for i, line in enumerate(lines) if SYNC_MARK in line]
    want = {"batched": test, "sequential": test}
    chains = {
        "batched": lambda n: batch_solve(ecw32, LAMBDAS, conv_thres=0.0,
                                         maxiter=n - 1),
        "sequential": lambda n: solve(ecw32, [0.25], conv_thres=0.0,
                                      maxiter=n - 1)}
    per, once = {}, {}
    for k, run in chains.items():
        per[k], once[k] = syncs_per_iteration(run)
    phase(14, "batch_syncs_per_iteration", **per, loop_test_lines=want,
          per_call_differences=once)
    for k, src in per.items():
        if len(want[k]) != 1 or src != {want[k][0]: 1.0}:
            raise AssertionError(f"14e: the {k} chain synchronizes {src} "
                                 f"per iteration (expected one, at "
                                 f"{want[k]})")


def run_phase14(lmm, ecw32, ecw_tz):
    """Phase 14; returns ({path: launches}, {variant: launches} of 14d's
    precision runs)."""
    launches, cold = run_batch_dz(ecw32)
    launches.update(run_batch_f64())
    launches.update(run_batch_tz(ecw_tz))
    out, by_variant = run_batch_routes(lmm, ecw32, cold)
    launches.update(out)
    run_batch_syncs(ecw32)
    torch.cuda.empty_cache()
    return launches, by_variant


# Phase 15: the multi-device layer (ecw_cc_torch/parallel).  One card, so
# the group is one NCCL rank (mesh 1 x 1): the sharded solves run every
# collective and the launch on the rank's rows (here all of them), and
# the shard launches of tp = 2, 4 and 8 are made side by side in one
# process, at cc-pVTZ's packed shape.
SHARD_TPS = (2, 4, 8)
SHARD_P = 13041                 # C2H2/cc-pVTZ packed pairs (nvir 162)
SHARD_M = 392                   # the stacked packed product's rows
SHARD_SHAPES = [(SHARD_M, (SHARD_P + (-SHARD_P) % tp) // tp, SHARD_P)
                for tp in SHARD_TPS]
PAR_LAMBDA = 0.25


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def par_solve(ecw, eris, op, perm, mesh, sharding, log=False):
    """Solver_CCSD.SCF at lambda PAR_LAMBDA on ECW's target, the ERIs,
    operand and amplitudes split over `mesh` (None: whole); returns the
    result, the solver, the kernel launches (all, on a shard) and, with
    `log`, the collectives (their log and CommDebugMode's counts: both
    are dispatch modes, which slow every operation, so a timed solve
    runs without them)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from ecw_cc_torch.kernels.ladder_mm import ladder_mm
    from ecw_cc_torch.ops.ccsd import GCC
    from ecw_cc_torch.ops.vexp import Exp
    from ecw_cc_torch.solvers.gs import Solver_CCSD

    exp = Exp(PAR_LAMBDA, [ecw.exp_data[0]], ecw.mol, ecw.mo_coeff)
    kw = {}
    if mesh is not None:
        eris = sharding.shard_eris(eris, mesh)
        op = sharding.shard_vvvv_op(op, mesh)
    torch.cuda.synchronize()
    ladder_mm.launches = ladder_mm.shard_launches = 0
    comm, coll = ((CommDebugMode(), sharding.CollectiveLog()) if log
                  else (contextlib.nullcontext(), contextlib.nullcontext()))
    with comm, coll:
        solver = Solver_CCSD(GCC(eris), exp, conv="tl",
                             conv_thres=CONV_THRES, diis="tl", maxiter=60,
                             vvvv_op=op, mo_perm=perm)
        if mesh is not None:
            sh = sharding.amp_shardings(mesh)
            kw = {k: sharding.shard_tensor(a, mesh, sh[n]) for k, a, n in zip(
                ("ts", "ls", "td", "ld"),
                (solver.tsini, solver.lsini, solver.tdini, solver.ldini),
                ("t1", "l1", "t2", "l2"))}
        res = solver.SCF(PAR_LAMBDA, keep_device=True, **kw)
    torch.cuda.synchronize()
    counts = ({str(k): v for k, v in comm.get_comm_counts().items()}
              if log else None)
    return (res, solver, ladder_mm.launches, ladder_mm.shard_launches,
            coll, counts)


def run_par_solves(ecw32, mesh):
    """15a: the packed and the sectored route at C2H2/cc-pVDZ f32, whole
    and split over the 1 x 1 mesh: equal iterations, |dEp| <= 1e-9 Ha,
    the same launches per iteration (each on the rank's rows), and no
    collective on the operand.  Returns ({path: launches}, the sorted
    system for 15c)."""
    from ecw_cc_torch.models.eris import build_eris_device
    from ecw_cc_torch.parallel import sharding

    er_s, sect = build_eris_device(ecw32.mol, ecw32.mf, dtype=torch.float32,
                                   device="cuda", pack_ladder=True,
                                   sort_spin=True)
    perm = sort_perm(ecw32)
    launches = {}
    for route, eris, op, perm_, per_iter in (
            ("packed", ecw32.eris, ecw32.vvvv_op, None, 1),
            ("sectored", er_s, sect, perm, 2)):
        # checked: whole, then split with its collectives logged; then
        # timed in turns, whole, split, split, whole, with no log
        (rw, sw, lw, _, _, _), (rs, ss, ls, shard_l, log, counts) = (
            par_solve(ecw32, eris, op, perm_, None, sharding),
            par_solve(ecw32, eris, op, perm_, mesh, sharding, log=True))
        ms = [par_solve(ecw32, eris, op, perm_, m, sharding)[1].last_solve
              for m in (None, mesh, mesh, None)]
        ms = [r["ms"] / r["iterations"] for r in ms]
        its = (sw.last_solve["iterations"], ss.last_solve["iterations"])
        d_ep = abs(float(rw[1][-1]) - float(rs[1][-1]))
        shapes = {tuple(w.shape) for w in (op if isinstance(op, tuple)
                                           else [op])}
        on_operand = [c for c in log.calls
                      if any(tuple(x) in shapes for x in c[1])]
        amps_placed = [str(list(a.placements)) for a in rs[5]]
        phase(15, f"sharded_solve_{route}", mesh=[1, 1], L=PAR_LAMBDA,
              route=ss.last_solve["route"], sym=ss.last_solve["sym"],
              iterations=its, Ep=float(rs[1][-1]), dEp=d_ep,
              launches=(lw, ls), shard_launches=shard_l,
              launches_per_iteration=ls / its[1],
              ms_per_iteration_whole=[ms[0], ms[3]],
              ms_per_iteration_sharded=ms[1:3],
              collectives=len(log.calls), comm_counts=counts,
              collectives_on_operand=len(on_operand),
              amp_placements=amps_placed)
        if not (sw.last_solve["status"] == ss.last_solve["status"] == 1):
            raise AssertionError(f"a {route} solve did not converge")
        if ss.last_solve["route"] != route or its[0] != its[1] or \
                d_ep > 1e-9:
            raise AssertionError(f"sharded {route} solve differs: {its}, "
                                 f"{d_ep}, {ss.last_solve['route']}")
        if lw != per_iter * its[0] or ls != per_iter * its[1] or \
                shard_l != ls:
            raise AssertionError(f"{route}: launches whole {lw}, sharded "
                                 f"{ls} ({shard_l} on the shard) in {its} "
                                 f"iterations, expected {per_iter} each")
        if on_operand:
            raise AssertionError(f"a collective moved the operand: "
                                 f"{on_operand[:3]}")
        launches[f"phase15_sharded_{route}_f32"] = ls
    return launches, (er_s, perm, ss, rs)


def check_shard_launches(lmm):
    """15b: the launches of tp = 2, 4 and 8 ranks on their rows of a
    symmetric 13041 x 13041 f32 operand (rows zero-padded to a multiple
    of tp), side by side: concatenated, they equal the whole launch to
    1e-5 * max|C|, and the shard backward (dC[:, :K] on each rank's rows)
    equals dC @ B.  Returns {tp: fields}."""
    from ecw_cc_torch.config import matmul_precision

    g = torch.Generator("cuda").manual_seed(15)
    p = SHARD_P
    b = torch.randn(p, p, generator=g, device="cuda")
    b = (b + b.T).mul_(0.5e-2)
    a = torch.randn(SHARD_M, p, generator=g, device="cuda")
    dc = torch.randn(SHARD_M, p, generator=g, device="cuda")
    whole = lmm._launch(a, b)
    with matmul_precision("highest"):
        da_ref = dc @ b
    scale, dscale = float(whole.abs().max()), float(da_ref.abs().max())
    out = {}
    for tp in SHARD_TPS:
        rows = p + (-p) % tp
        per = rows // tp
        cs, das, nbytes = [], [], 0
        for r in range(tp):
            b_r = b.new_zeros((per, p))
            hi = min((r + 1) * per, p)
            b_r[:hi - r * per] = b[r * per:hi]
            nbytes = max(nbytes, b_r.numel() * b_r.element_size())
            cs.append(lmm._launch(a, b_r))
            das.append(lmm._launch(dc[:, :p].contiguous(), b_r,
                                   backward=True))
            del b_r
        c = torch.cat(cs, 1)[:, :p]
        da = torch.cat(das, 1)[:, :p]
        err = float((c - whole).abs().max())
        derr = float((da - da_ref).abs().max())
        ok = err <= TOL[torch.float32] * scale and \
            derr <= TOL[torch.float32] * dscale
        out[tp] = dict(rows_per_rank=per, bytes_per_rank=nbytes,
                       bytes_whole=p * p * 4, concatenated_max_abs_err=err,
                       backward_max_abs_err=derr)
        phase(15, "shard_launches", tp=tp, shape=(SHARD_M, per, p),
              max_abs_err=err, max_abs_ref=scale,
              backward_max_abs_err=derr, backward_max_abs_ref=dscale,
              bytes_per_rank=nbytes, bytes_whole=p * p * 4, ok=ok)
        if not ok:
            raise AssertionError(f"shard launches at tp={tp} disagree: "
                                 f"{err} / {scale}, {derr} / {dscale}")
    del b, a, dc, whole, da_ref
    torch.cuda.empty_cache()
    return out


def check_par_t(mesh, sorted_system):
    """15c: energy_t_sect over the 1 x 1 mesh equals the call without one,
    on 15a's sorted ERIs and sectored amplitudes (sorted), sym on."""
    from ecw_cc_torch.ops import ccsd_t
    from ecw_cc_torch.parallel import sharding

    er, perm, solver, res = sorted_system
    nocc = solver.nocc
    po = torch.as_tensor(perm[:nocc], device="cuda")
    pv = torch.as_tensor(perm[nocc:] - nocc, device="cuda")
    t1, _, t2, _ = (sharding.replicate(x) for x in res[5])
    t1 = t1[po][:, pv]
    t2 = t2[po][:, po][:, :, pv][:, :, :, pv]
    info = solver._sinfo
    es = {}
    for name, m in (("whole", None), ("mesh", mesh)):
        t0 = time.perf_counter()
        es[name] = float(ccsd_t.energy_t_sect(er, t1, t2, info, sym=True,
                                              mesh=m))
        es[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    d = abs(es["mesh"] - es["whole"])
    phase(15, "energy_t_sharded", E_T=es["whole"], dE=d,
          ms=(es["whole_ms"], es["mesh_ms"]))
    if not np.isfinite(es["whole"]) or d > 1e-7 * abs(es["whole"]):
        raise AssertionError(f"(T) over the mesh differs: {es}")


def check_shard_rules(lmm, mesh):
    """15d: ladder_mm on a RowShard over the 1 x 1 mesh, a symmetric
    1891 x 1891 f32 operand (the packed cc-pVDZ width) and M = 196: the
    forward, the autograd backward, torch.func.jvp's tangent and
    torch.func.vmap over 3 lanes, each against the plain product to
    1e-5 * max|ref| and each the launches its rule predicts, every one
    on the rows (forward 1; backward 1 + 1; tangent 1 + 1; vmap 1)."""
    from ecw_cc_torch.config import matmul_precision
    from ecw_cc_torch.ops.ladder import PackedVVVV
    from ecw_cc_torch.parallel import sharding

    mm = lmm.ladder_mm
    g = torch.Generator("cuda").manual_seed(16)
    n, M = 1891, 196
    w = torch.randn(n, n, generator=g, device="cuda")
    w = (w + w.T).mul_(0.05)
    a, da, dc = (torch.randn(M, n, generator=g, device="cuda")
                 for _ in range(3))
    sh = sharding.local_operand(
        sharding.shard_vvvv_op(PackedVVVV(wc=w), mesh)).wc
    lanes = torch.stack([a, da, a - da])
    with matmul_precision("highest"):
        refs = {"forward": a @ w.T, "backward": dc @ w,
                "tangent": da @ w.T, "vmap": lanes @ w.T}
    runs = {
        "forward": lambda: mm(a, sh, symmetric=True),
        "backward": lambda: _shard_grad(mm, a, sh, dc),
        "tangent": lambda: torch.func.jvp(
            lambda y: mm(y, sh, symmetric=True), (a,), (da,))[1],
        "vmap": lambda: torch.func.vmap(
            lambda y: mm(y, sh, symmetric=True))(lanes)}
    want = {"forward": 1, "backward": 2, "tangent": 2, "vmap": 1}
    for name, fn in runs.items():
        mm.launches = mm.shard_launches = 0
        out = fn()
        torch.cuda.synchronize()
        err = float((out - refs[name]).abs().max())
        scale = float(refs[name].abs().max())
        launches = (mm.launches, mm.shard_launches)
        phase(15, "shard_rule", rule=name, shape=(M, n, n),
              max_abs_err=err, max_abs_ref=scale, launches=launches)
        if err > TOL[torch.float32] * scale or launches != (want[name],) * 2:
            raise AssertionError(f"shard {name}: {err} / {scale}, "
                                 f"launches {launches}")


def _shard_grad(mm, a, sh, dc):
    x = a.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad((mm(x, sh, symmetric=True) * dc).sum(), x)
    return gx


def run_phase15(lmm, ecw32):
    """Phase 15 on a world-size-1 NCCL group started here (and ended
    here).  Returns ({path: launches}, {tp: shard check fields},
    {shape: times})."""
    import torch.distributed as dist

    from ecw_cc_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(n_tp=1, n_dp=1)
        phase(15, "mesh", shape=list(mesh.mesh.shape),
              names=list(mesh.mesh_dim_names), backend=dist.get_backend())
        launches, sorted_system = run_par_solves(ecw32, mesh)
        check_par_t(mesh, sorted_system)
        del sorted_system
        check_shard_rules(lmm, mesh)
    finally:
        dist.destroy_process_group()
    shards = check_shard_launches(lmm)
    checks = check_kernel(lmm.ladder_mm, lmm.ladder_mm_ref, lmm.device_plan,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count, only=SHARD_SHAPES)
    times = time_kernel(lmm.ladder_mm, lmm.ladder_mm_ref,
                        only=SHARD_SHAPES)
    by_shape = {}
    for tp, shape in zip(SHARD_TPS, SHARD_SHAPES):
        t = times[(torch.float32, shape)]
        err, plan_ = checks[(torch.float32, shape)]
        by_shape[tag(shape)] = {
            "tp": tp, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "max_abs_err": err,
            "blocks": plan_.blocks, "split_k": plan_.split,
            **shards[tp]}
    torch.cuda.empty_cache()
    return launches, by_shape


def kernel_report(launches, checks, times, backward, grads, variants,
                  eom_launches, tangents, batch_variants, shards):
    """The kernel line: one entry per variant of the ladder kernel.  f32
    and f64 (csrc/ladder_mm.cu): the headline numbers at the main path's
    cc-pVTZ shape (392x13041x13041, the stacked packed GEMM), every timed
    shape under by_dtype; launches: {path: ladder launches in its run},
    split by the dtype in the path's name; backward: the launches among
    them that a backward made (phase 10's response densities); grads:
    {(dtype, shape): error of the kernel's gradient against the plain
    version's}.  variants: (checks, times) of the TF32 and BF16 kernels
    (csrc/ladder_mm_tc.cu, phase 3) and {variant: launches} of phase 12,
    whose f32 and f64 launches join those entries.  eom_launches: {path:
    (forward, tangent, backward)} of phase 13, joining the f32 and f64
    entries by the dtype in the path's name; tangents: {(dtype, shape,
    symmetric): error of the kernel's tangent} (phase 3); batch_variants:
    {variant: launches} of phase 14's batched precision runs, joining
    phase 12's; shards: phase 15's ({path: launches}, {shape: fields}):
    the sharded solves' launches (each on the rank's rows) join the f32
    entry, with the shard shapes' checks and times."""
    by_dtype = {}
    for dtype in DTYPES:
        by_dtype[str(dtype).split(".")[-1]] = {tag(shape): {
            "ms": times[(dtype, shape)]["ms"],
            "plain_ms": times[(dtype, shape)]["plain_ms"],
            "library_ms": times[(dtype, shape)]["plain_ms"],
            "bound_ms": times[(dtype, shape)]["bound_ms"],
            "bound_by": times[(dtype, shape)]["bound_by"],
            "host_us": times[(dtype, shape)]["host_us"],
            "plain_host_us": times[(dtype, shape)]["plain_host_us"],
            "max_abs_err": checks[(dtype, shape)][0],
            "blocks": checks[(dtype, shape)][1].blocks,
            "split_k": checks[(dtype, shape)][1].split}
            for shape in TIMED_SHAPES[dtype]}
    v_checks, v_times, v_launches = variants
    entries = []
    for dtype, v in ((torch.float32, "f32"), (torch.float64, "f64")):
        main = (dtype, PACKED_TZ)
        paths = {k: n for k, n in launches.items()
                 if ("f64" in k) == (v == "f64")}
        paths["phase12_precision_modes"] = v_launches[v]
        paths["phase14_batch_precision_modes"] = batch_variants[v]
        eom = {k: n for k, n in eom_launches.items()
               if ("f64" in k) == (v == "f64")}
        paths.update({k: sum(n) for k, n in eom.items()})
        entries.append({
            "name": f"ladder_mm_{v}", "route": "cuda",
            "source": "ecw_cc_torch/csrc/ladder_mm.cu",
            "replaces": "ecw_cc_tpu/ops/ladder.py:54",
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(checks[(dtype, s)][0]
                               for s in TIMED_SHAPES[dtype]),
            "ms": times[main]["ms"], "plain_ms": times[main]["plain_ms"],
            "bound_ms": times[main]["bound_ms"],
            "bound_by": times[main]["bound_by"],
            "library_ms": times[main]["plain_ms"],
            "shape": tag(main[1]), "dtype": str(dtype).split(".")[-1],
            "blocks": checks[main][1].blocks,
            "split_k": checks[main][1].split, "deterministic": True,
            "eom_launches_fwd_tan_back": eom,
            "tangent_launches": sum(n[1] for n in eom.values()),
            "tangent_max_abs_err": {
                f"{tag(sh)} {'symmetric' if sym else 'general'}": e
                for (d, sh, sym), e in tangents.items() if d == dtype}})
    shard_launches, shard_shapes = shards
    entries[0]["launches_by_path"].update(shard_launches)
    entries[0]["launches"] += sum(shard_launches.values())
    entries[0].update(backward_launches=backward, gradient_max_abs_err={
        f"{str(d).split('.')[-1]} {tag(sh)}": e
        for (d, sh), e in grads.items()}, by_dtype=by_dtype,
        shard_launches=sum(shard_launches.values()),
        shard_shapes=shard_shapes)
    for v in TC_VARIANTS:
        t = v_times[(v, PACKED_TZ)]
        entries.append({
            "name": f"ladder_mm_{v}", "route": "cuda",
            "source": "ecw_cc_torch/csrc/ladder_mm_tc.cu",
            "replaces": "ecw_cc_tpu/ops/ladder.py:54",
            "launches": v_launches[v] + batch_variants[v],
            "launches_by_path": {
                "phase12_precision_modes": v_launches[v],
                "phase14_batch_precision_modes": batch_variants[v]},
            "max_abs_err": max(v_checks[(v, s)][0]
                               for s in MAIN_SHAPES + TZ_SHAPES
                               + ROUTE_SHAPES),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": tag(PACKED_TZ),
            "blocks": v_checks[(v, PACKED_TZ)][1].blocks,
            "split_k": v_checks[(v, PACKED_TZ)][1].split,
            "deterministic": True,
            "by_shape": {tag(s): {k: v_times[(v, s)][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "host_us")} | {"max_abs_err": v_checks[(v, s)][0]}
                for s in MAIN_SHAPES + TZ_SHAPES + ROUTE_SHAPES
                + BATCH_TC_SHAPES}})
    return {"kernels": entries}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a GPU",
              file=sys.stderr)
        return 2
    import ecw_cc_torch.config  # noqa: F401  (sets the TF32 switches)
    from ecw_cc_torch.kernels import build
    from ecw_cc_torch.kernels import ladder_mm as lmm

    ladder_mm, ladder_mm_ref = lmm.ladder_mm, lmm.ladder_mm_ref
    t_start = time.perf_counter()
    seconds = {}

    # 1. device
    with timed(1, seconds):
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        assert tf32 == (False, False), f"TF32 is on: {tf32}"
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        phase(1, "device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, count=torch.cuda.device_count(),
              sms=n_sm)

    if "--kernel-times" in argv:
        # Timing only, through whatever ecw_cc_torch is importable: the
        # same method can time an older checkout's kernel.  The TF32 and
        # BF16 variants are checked against their plain versions first.
        times = time_kernel(ladder_mm, ladder_mm_ref)
        check_variants(lmm, n_sm)
        v_times = time_variants(lmm)
        print(json.dumps({"kernel_times": {
            f"{str(d).split('.')[-1]} {tag(s)}": t
            for (d, s), t in list(times.items()) + list(v_times.items())}}))
        print(smi)
        return 0
    if "--routes" in argv:
        route_sweeps(ladder_mm)
        print(smi)
        return 0
    if "--chain" in argv:
        chain_times()
        print(smi)
        return 0
    if "--profile" in argv:
        for route in ("sectored", "packed"):
            for basis in (BASIS, BASIS_TZ):
                profile_chain(basis, route)
                profile_chain(basis, route, lanes=LAMBDAS)
            profile_chain(BASIS_TZ, route, diis="tl")
        print(smi)
        return 0

    targets_only = "--targets" in argv

    # 2. build
    with timed(2, seconds):
        t0 = time.perf_counter()
        lib = build.library()
        phase(2, "build", seconds=time.perf_counter() - t0,
              nvcc_seconds=lib.build_seconds, library=lib.path,
              ptxas=[ln.strip() for ln in lib.log.splitlines()
                     if re.search(r"registers|spill|entry function", ln)],
              sass=check_sass(lib.path))

    if "--precision" in argv:
        with timed(12, seconds):
            launches_12, by_variant_12 = run_phase12(lmm)
        with timed(8, seconds):
            check_no_jax(False)
        phase(0, "seconds", total=time.perf_counter() - t_start,
              by_phase=seconds, launches=launches_12,
              launches_by_variant=by_variant_12)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    if "--es" in argv:
        with timed(11, seconds):
            run_phase11()
        with timed(8, seconds):
            check_no_jax(True)
        phase(0, "seconds", total=time.perf_counter() - t_start,
              by_phase=seconds)
        print(smi)
        return 0

    if "--batch" in argv:
        # phase 3 at the batched shapes, then phase 14 on its own ECWs
        with timed(3, seconds):
            check_kernel(ladder_mm, ladder_mm_ref, lmm.device_plan, n_sm,
                         only=BATCH_SHAPES)
            time_kernel(ladder_mm, ladder_mm_ref, only=BATCH_SHAPES)
            check_variants(lmm, n_sm, only=BATCH_TC_SHAPES)
            time_variants(lmm, only=BATCH_TC_SHAPES)
        with timed(14, seconds):
            launches_14, by_variant_14 = run_phase14(
                lmm, build_ecw("cuda", torch.float32),
                build_ecw("cuda", torch.float32, basis=BASIS_TZ))
        with timed(8, seconds):
            check_no_jax(False)
        phase(0, "seconds", total=time.perf_counter() - t_start,
              by_phase=seconds, launches=launches_14,
              launches_by_variant=by_variant_14)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    if "--parallel" in argv:
        with timed(15, seconds):
            launches_15, shards_15 = run_phase15(
                lmm, build_ecw("cuda", torch.float32))
        with timed(8, seconds):
            check_no_jax(False)
        phase(0, "seconds", total=time.perf_counter() - t_start,
              by_phase=seconds, launches=launches_15,
              shard_shapes=shards_15)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    if "--eom" in argv:
        with timed(3, seconds):
            check_kernel_tangent(ladder_mm, ladder_mm_ref)
        with timed(13, seconds):
            launches_13 = run_phase13(ladder_mm)
        with timed(8, seconds):
            check_no_jax(False, eom_ran=True)
        phase(0, "seconds", total=time.perf_counter() - t_start,
              by_phase=seconds, launches_fwd_tan_back=launches_13)
        print(smi)
        return 0

    if targets_only:
        # phase 10 alone, on its own ECWs (and cc-pVTZ SCF)
        from ecw_cc_torch.models.molecule import Molecule
        from ecw_cc_torch.models.scf import GHF, RHF

        with timed(10, seconds):
            mol_tz = Molecule(MOLECULE, BASIS_TZ, charge=0, spin=0)
            mf_tz = RHF(mol_tz, conv_tol=1e-11)
            mf_tz.kernel()
            launches_10, back_10, _ = run_phase10(
                ladder_mm, ladder_mm_ref, build_ecw("cuda", torch.float32),
                build_ecw("cuda", torch.float64),
                build_ecw("cpu", torch.float64), (mol_tz, GHF(mf_tz)))
        phase(0, "seconds", total=time.perf_counter() - t_start,
              by_phase=seconds, launches=launches_10,
              backward_launches=back_10)
        print(smi)
        return 0

    # 3. kernel vs plain
    with timed(3, seconds):
        checks = check_kernel(ladder_mm, ladder_mm_ref, lmm.device_plan,
                              n_sm)
        check_deterministic(ladder_mm)
        tangents = check_kernel_tangent(ladder_mm, ladder_mm_ref)
        times = time_kernel(ladder_mm, ladder_mm_ref)
        v_checks = check_variants(lmm, n_sm)
        v_times = time_variants(lmm)

    # 4. main path, f32 (ERIs transformed on the card)
    with timed(4, seconds):
        ecw32 = build_ecw("cuda", torch.float32)
        phase(4, "build_f32", **ecw32.timings,
              host_eris_built=ecw32._eris_host is not None)
        ladder_mm.launches = 0
        t0 = time.perf_counter()
        res, log = solve(ecw32, LAMBDAS, conv_thres=CONV_THRES)
        sweep_ms = (time.perf_counter() - t0) * 1e3
        launches = ladder_mm.launches
        iters = sum(s["iterations"] for s in log)
        for s, ep, delta in zip(log, ecw32.Ep_lamb, ecw32.Delta_lamb):
            phase(4, "solve_f32", L=s["L"], route=s["route"],
                  iterations=s["iterations"], converged=s["status"] == 1,
                  Ep=ecw32.EHF - ep, Delta=delta, ms=s["ms"])
        phase(4, "sweep_f32", ms=sweep_ms, iterations=iters,
              ladder_launches=launches, launches_per_iteration=1)
        if not all(s["status"] == 1 and s["route"] == "packed" for s in log):
            raise AssertionError("an f32 lambda did not converge on the "
                                 "packed route")
        if launches != iters:
            raise AssertionError(f"ladder kernel launched {launches} times "
                                 f"in {iters} iterations (expected 1 each)")
        if not np.all(np.isfinite(res[4])) or res[4].shape != (ecw32.dim,) * 2:
            raise AssertionError("rdm1 is not finite or has the wrong shape")
        _, chain = solve(ecw32, [0.25], diis="", conv_thres=0.0,
                         maxiter=CHAIN_ITERS)
        chain = chain[0]
        phase(4, "chain_f32", iterations=chain["iterations"], ms=chain["ms"],
              ms_per_iteration=chain["ms"] / chain["iterations"])

    # 5. main path, f64, card against CPU; f32 (device ERIs) against both
    with timed(5, seconds):
        ecw64c = build_ecw("cuda", torch.float64)
        ecwc = build_ecw("cpu", torch.float64)
        if ecw64c.mo_perm is not None or ecw64c.vvvv_op is not None:
            raise AssertionError("the f64 ECW is not on the alternating "
                                 "host route")
        ladder_mm.launches = 0
        res64, log64 = solve(ecw64c, [0.25], conv_thres=CONV_THRES)
        launches_64 = ladder_mm.launches
        resc, logc = solve(ecwc, [0.25], conv_thres=CONV_THRES)
        res32, log32 = solve(ecw32, [0.25], conv_thres=CONV_THRES)
        d64 = abs(float(res64[1][-1]) - float(resc[1][-1]))
        d32 = abs(float(res32[1][-1]) - float(resc[1][-1]))
        it = {k: v[0]["iterations"] for k, v in
              (("cuda_f64", log64), ("cpu_f64", logc), ("cuda_f32", log32))}
        routes = {k: v[0]["route"] for k, v in
                  (("cuda_f64", log64), ("cpu_f64", logc), ("cuda_f32", log32))}
        phase(5, "f64_card_vs_cpu", iterations=it, routes=routes,
              Ep_cpu_f64=float(resc[1][-1]), dEp_cuda_f64=d64,
              dEp_cuda_f32=d32, ms_cuda_f64=log64[0]["ms"],
              ms_cpu_f64=logc[0]["ms"], ms_cuda_f32=log32[0]["ms"],
              ladder_launches_cuda_f64=launches_64)
        if not all(s[0]["status"] == 1 for s in (log64, logc, log32)):
            raise AssertionError("a lambda = 0.25 solve did not converge")
        if set(routes.values()) != {"packed"}:
            raise AssertionError(f"phase 5 took the routes {routes}")
        if launches_64 != it["cuda_f64"]:
            raise AssertionError(f"f64 packed solve launched the kernel "
                                 f"{launches_64} times in {it['cuda_f64']} "
                                 "iterations (expected 1 each)")
        if it["cuda_f64"] != it["cpu_f64"] or d64 > 1e-9:
            raise AssertionError(f"f64 card solve differs from CPU: {it}, "
                                 f"{d64}")
        if abs(it["cuda_f32"] - it["cpu_f64"]) > 1 or d32 > 1e-5:
            raise AssertionError(f"f32 card solve differs from CPU f64: "
                                 f"{it}, {d32}")
        ref32 = (float(res32[1][-1]), it["cuda_f32"])

    # 6. ERI build at cc-pVDZ on the card against the host build
    with timed(6, seconds):
        check_eri_build(ecw32)

    # 7. main path at full width: C2H2/cc-pVTZ
    with timed(7, seconds):
        launches_tz, ecw_tz, ref_tz = run_tz(ladder_mm)

    # 9. the sorted and dense routes
    with timed(9, seconds):
        launches_9 = {"c2h2_ccpvtz_f32_sectored": run_sorted_tz(
            ladder_mm, ecw_tz, ref_tz)}
        tz = (ecw_tz.mol, ecw_tz.mf)
        launches_9.update(run_spin_mixing(ladder_mm, ecw32))
        launches_9.update(run_dense(ladder_mm, ecw32, ref32, ecw64c, ecwc))

    # 14. the batched lambda sweep (phase 4's and phase 7's ECWs)
    with timed(14, seconds):
        launches_14, by_variant_14 = run_phase14(lmm, ecw32, ecw_tz)

    # 15. the multi-device layer (phase 4's ECW)
    with timed(15, seconds):
        launches_15, shards_15 = run_phase15(lmm, ecw32)

    # 10. correlated targets and the CCS ground state
    with timed(10, seconds):
        launches_10, back_10, grads = run_phase10(
            ladder_mm, ladder_mm_ref, ecw32, ecw64c, ecwc, tz)
        del ecw32, ecw64c, ecwc

    # 11. excited states
    with timed(11, seconds):
        ladder_mm.launches = 0
        run_phase11()
        if ladder_mm.launches:
            raise AssertionError("the excited-state path launched ladder_mm "
                                 f"{ladder_mm.launches} times")

    # 12. the precision modes (phase 7's cc-pVTZ ECW, kept for it)
    with timed(12, seconds):
        launches_12, by_variant_12 = run_phase12(lmm, ecw_tz)
        del ecw_tz

    # 13. EOM-CCSD
    with timed(13, seconds):
        launches_13 = run_phase13(ladder_mm)

    # 8. neither JAX nor the JAX package
    with timed(8, seconds):
        check_no_jax(True, eom_ran=True)

    phase(0, "seconds", total=time.perf_counter() - t_start,
          by_phase=seconds)
    print(json.dumps(kernel_report(
        {"c2h2_ccpvdz_f32_packed_sweep": launches,
         "c2h2_ccpvdz_f64_packed": launches_64,
         "c2h2_ccpvtz_f32_packed": launches_tz, **launches_9,
         **launches_10, **launches_14},
        checks, times, back_10, grads,
        (v_checks, v_times, by_variant_12), launches_13, tangents,
        by_variant_14, (launches_15, shards_15))))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
