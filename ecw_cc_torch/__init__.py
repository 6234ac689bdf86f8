"""
ecw_cc_torch — the PyTorch/CUDA port of ecw_cc_tpu for one NVIDIA H100.

It runs the ECW-CCSD ground-state lambda solve on the spin-sorted,
sector-blocked route, with the vvvv ladder GEMM in a hand-written Hopper
kernel (csrc/ladder_mm.cu).  The JAX package ecw_cc_tpu stays the
reference; this package imports only its JAX-free host modules (molecule,
integrals, SCF, host ERIs, utils) and never imports jax.

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
