"""
ecw_cc_torch — the PyTorch/CUDA port of ecw_cc_tpu for one NVIDIA H100.

It runs the ECW-CCSD ground-state lambda solve on every route of the JAX
solver: the spin-sorted, sector-blocked one, and the dense kernels on the
sorted or the alternating layout, with every vvvv ladder GEMM in a
hand-written Hopper kernel (csrc/ladder_mm.cu); at f32 the ERIs are
transformed on the card (models/eris.build_eris_device).  Targets are HF,
CCSD or CCSD(T) densities (models/gamma_exp.py, ops/ccsd_t.py: plain CCSD
and Lambda, the (T) energy and its response density, whose adjoint takes
the gradient through the same kernel), and the ECW-CCS ground state runs
beside the CCSD one (ops/ccs.py, ECW.CCS_GS); `python -m ecw_cc_torch
spec.json` runs either from a JSON spec.  The JAX package ecw_cc_tpu stays
the reference.  This package imports neither jax nor ecw_cc_tpu: it keeps its
own copies of the host front end (native/, models/{basis_io,basis_data,
integrals,molecule,scf}.py, the host half of models/eris.py, utils/).
Entry points run on the card (device='cuda') unless asked for the CPU.

    import torch
    from ecw_cc_torch import ECW
    ecw = ECW('h2o', '6-31g', device='cpu', dtype=torch.float64)
    ecw.Build_GS_exp('mat', 'HF', field=[0.05, 0.01, 0.0])
    result = ecw.CCSD_GS([0.5], diis='tl')
"""

__version__ = "0.1.0"

from ecw_cc_torch.config import Config, get_config, set_config  # noqa: F401


def __getattr__(name):
    # Lazy import of the driver keeps `import ecw_cc_torch` light.
    if name == "ECW":
        from ecw_cc_torch.models.ecw import ECW
        return ECW
    raise AttributeError(f"module 'ecw_cc_torch' has no attribute {name!r}")
