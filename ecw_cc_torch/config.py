"""Global configuration of the PyTorch port.

Precision: TF32 is switched off for both matmuls and cuDNN when this
module is imported, so f32 runs at full precision ('highest') and f64 is
the parity mode (CPU tests, and the card's f64 check).  A solve under a
reduced `iter_precision` sets the matmul precision for its iterations only,
through `matmul_precision`, which restores the flags on exit.

Every entry point runs on the card (`device="cuda"`) unless the caller asks
for the CPU; `check_device` refuses CUDA on a machine without a card
instead of moving the work to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Config:
    # Working dtype when an entry point is given dtype=None.
    dtype: str = "float64"
    # DIIS defaults of Solver_CCSD (reference Solver_GS).
    maxdiis: int = 15
    mindiis: int = 2
    # Route of the v^4 ladder contraction (ops/ladder.py; JAX config.py:
    # 27-44): 'dense' is one (o^2, v^2) x (v^2, v^2) GEMM against the full
    # vvvv, 'packed' the antisymmetry-packed (o^2, p) x (p, p) GEMM of a
    # PackedVVVV, 'auto' packed at nvir >= ops/ladder.PACKED_MIN_NVIR and
    # dense below.  Where it resolves to 'packed' at f32, ECW builds the
    # spin-sorted layout and its SectoredVVVV instead while spin_sorted is
    # True (models/ecw.py).  The JAX package's 'sectors' (the
    # alternating-layout spin sectors) is deliberately not ported: 'auto'
    # never picks it, and the spin-sorted SectoredVVVV route (spin_sorted)
    # does the same work without strided slices.
    ladder_mode: str = "auto"
    # Spin-sorted MO layout of ECW's f32 ERIs where ladder_mode resolves to
    # 'packed' (JAX config.py:76-84): alpha first within occ and vir
    # (ops/ladder.spin_sort_perm), the ladder operand the block-diagonal
    # SectoredVVVV, and the solve the sectored route
    # (Solver_CCSD(mo_perm=...)); amplitudes, rdm1s and fock stay in the
    # reference alternating convention.  False builds the alternating
    # layout with a PackedVVVV (the packed route).
    spin_sorted: bool = True
    # Sector-blocked soup kernels (ops/ccsd_sect.py) on the spin-sorted
    # layout, where the solver's structure gate passes; False (or a target
    # that couples the spins) runs the dense kernels of ops/ccsd.py on the
    # same sorted layout.
    soup_sector: bool = True
    # Closed-shell mirror symmetry on top of the sectored kernels
    # (ops/spinsect.py sym mode), used where the solver's gate passes.
    soup_sym: bool = True
    # Matmul precision of the Solver_CCSD iterations (JAX config.py:48-59),
    # each set by matmul_precision for the iterations only:
    #   'highest' f32 with TF32 off (the parity mode);
    #   'high'    TF32 matmuls (cuBLAS, and the ladder kernel's TF32
    #             variant);
    #   'default' torch's 'medium' f32 matmul precision (TF32 in cuBLAS on
    #             the card), the ladder kernel's TF32 variant;
    #   'bf16'    'default', and the t/lambda updates read bf16 copies of
    #             the ERI blocks, the ladder operand and the amplitudes
    #             (the ladder kernel's BF16 variant); rdm1, Vexp, energy,
    #             DIIS and the convergence test stay in the solve's dtype;
    #   'hybrid'  iterations at hybrid_fast until Dconv falls below
    #             hybrid_switch or stalls, then 'highest' iterations to
    #             conv_thres: the 'highest' fixed point.
    # The reduced modes converge to a coarser fixed point; SCF(refine=True)
    # or 'hybrid' recovers f64 / 'highest' parity.
    iter_precision: str = "highest"
    hybrid_switch: float = 1e-4
    # Precision of the hybrid fast leg.
    hybrid_fast: str = "high"


_CHOICES = {
    "dtype": ("float32", "float64"),
    "iter_precision": ("highest", "high", "default", "bf16", "hybrid"),
    "hybrid_fast": ("high", "default", "bf16"),
    "ladder_mode": ("auto", "dense", "packed"),
}

# torch's float32 matmul precision under each iter_precision ('hybrid' sets
# it per leg)
_TORCH_PRECISION = {"highest": "highest", "high": "high",
                    "default": "medium", "bf16": "medium"}
_active = ["highest"]

_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"unknown config field {k!r}")
        if k == "ladder_mode" and v == "sectors":
            raise ValueError(
                "config.ladder_mode='sectors' (the alternating-layout spin "
                "sectors) is deliberately not ported: use the spin-sorted "
                "layout (config.spin_sorted=True, ECW's f32 default where "
                "the ladder is packed; or build_eris_device(sort_spin=True) "
                "and Solver_CCSD(mo_perm=...)), whose SectoredVVVV does the "
                "same work, or 'auto'/'dense'/'packed'")
        if k in _CHOICES and v not in _CHOICES[k]:
            raise ValueError(f"config.{k} must be one of {_CHOICES[k]}, "
                             f"got {v!r}")
        setattr(_config, k, v)
    return _config


@contextlib.contextmanager
def matmul_precision(mode):
    """Run the body under the matmul precision of iter_precision `mode`
    ('highest', 'high', 'default' or 'bf16'): 'highest' is TF32 off, 'high'
    `torch.backends.cuda.matmul.allow_tf32 = True`, 'default' and 'bf16'
    `torch.set_float32_matmul_precision('medium')`, all set and restored
    through torch.set_float32_matmul_precision (mixing it with the
    allow_tf32 setters makes torch refuse to read the precision).  The
    previous precision comes back on exit, also on an exception; cuDNN's
    flag is left as it is (off).  `active_precision()` names the mode
    inside, for the ladder kernel's variant."""
    if mode not in _TORCH_PRECISION:
        raise ValueError(f"matmul_precision takes one of "
                         f"{tuple(_TORCH_PRECISION)}, got {mode!r}")
    saved = torch.get_float32_matmul_precision()
    _active.append(mode)
    try:
        torch.set_float32_matmul_precision(_TORCH_PRECISION[mode])
        yield
    finally:
        _active.pop()
        torch.set_float32_matmul_precision(saved)


def active_precision() -> str:
    """The iter_precision mode of the innermost matmul_precision, or
    'highest' outside any."""
    return _active[-1]


def torch_dtype(dtype=None) -> torch.dtype:
    """dtype argument (torch dtype, name, or None = config.dtype)."""
    if dtype is None:
        dtype = _config.dtype
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {"float32": torch.float32, "float64": torch.float64}.get(
            str(dtype))
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")
    return out


def np_dtype():
    """config.dtype as a NumPy dtype."""
    import numpy as np

    return np.dtype(_config.dtype)


def check_device(device) -> torch.device:
    """The requested device, validated; CUDA without a card raises."""
    if device is None:
        raise ValueError("device=None: pass 'cuda' (the default of the "
                         "entry points) or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available on this machine")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
