"""Native (C++) integral engine loader.

Compiles mdint.cpp to ecw_cc_torch/_build/libmdint-<hash>.so on first use
(g++ -O3 -march=native; the directory is git-ignored) and exposes
`compute_eri(basis_set) -> (nao,nao,nao,nao)` via ctypes.  Falls back to the
NumPy engine transparently if no C++ toolchain is available
(models/integrals.py checks `available()`).

Copy of ecw_cc_tpu/native/__init__.py (the PyTorch port imports
nothing of the JAX package); the imports, the build directory and the
binary's name differ: it is keyed on the compile command and the host as
well as the source, so a binary built on another machine (another
-march=native) is never loaded here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mdint.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lib = None
_build_error = None

# highest angular momentum compiled into mdint.cpp (its LMAX constant);
# models/integrals.py falls back to the NumPy engine above this
NATIVE_LMAX = 4


_CMD = ("g++", "-O3", "-march=native", "-fPIC", "-shared")


@functools.cache
def _host():
    """The machine and its CPU's feature flags: what -march=native reads."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            flags = next((line for line in fh if line.startswith("flags")),
                         "")
    except OSError:
        pass
    return f"{platform.machine()}|{' '.join(sorted(flags.split()))}"


def _lib_path():
    """Binary name keyed on the source content (not mtimes), the compile
    command and the host: a binary from another source, other flags or
    another machine (-march=native) is never loaded; a fresh clone or a
    new machine rebuilds on first use."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CMD).encode())
    h.update(_host().encode())
    return os.path.join(_BUILD_DIR, f"libmdint-{h.hexdigest()[:12]}.so")


def _build(lib_path):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    subprocess.run([*_CMD, _SRC, "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, lib_path)


def _load():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    try:
        lib_path = _lib_path()
        if not os.path.exists(lib_path):
            _build(lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.compute_eri.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
        ]
        lib.compute_eri.restype = None
        lib.compute_int1e.argtypes = [
            ctypes.c_int,  # kind
            ctypes.c_int,  # nshell
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            ctypes.c_int,  # nao
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_int,  # natm
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
        ]
        lib.compute_int1e.restype = None
        _lib = lib
        return _lib
    except Exception as exc:  # pragma: no cover - toolchain missing
        _build_error = exc
        return None


def available():
    return _load() is not None


_KINDS = {"overlap": 0, "kinetic": 1, "nuclear": 2, "dipole": 3}


def compute_int1e(bs, kind, charges=None, coords=None, origin=None):
    """One-electron integrals from the C++ engine.

    kind: 'overlap' | 'kinetic' | 'nuclear' | 'dipole'
    Returns (nao, nao), or (3, nao, nao) for 'dipole' about `origin`."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    k = _KINDS[kind]
    args = _shell_arrays(bs)
    natm = 0
    zq = np.zeros(1)
    atm = np.zeros(3)
    if kind == "nuclear":
        zq = np.ascontiguousarray(np.asarray(charges, dtype=np.float64))
        atm = np.ascontiguousarray(np.asarray(coords, dtype=np.float64).reshape(-1))
        natm = zq.size
    org = np.zeros(3) if origin is None else np.asarray(origin, dtype=np.float64)
    ncomp = 3 if kind == "dipole" else 1
    out = np.zeros((ncomp, bs.nao, bs.nao), dtype=np.float64)
    lib.compute_int1e(k, args["nshell"], args["ls"], args["nprim"],
                      args["prim_off"], args["exps"], args["coefs"],
                      args["centers"], args["sph_off"], bs.nao,
                      args["norms"], natm, zq, atm,
                      np.ascontiguousarray(org), out.reshape(-1))
    return out if kind == "dipole" else out[0]


def _shell_arrays(bs):
    shells = bs.shells
    nshell = len(shells)
    ls = np.array([sh.l for sh in shells], dtype=np.int32)
    nprim = np.array([len(sh.exps) for sh in shells], dtype=np.int32)
    prim_off = np.zeros(nshell, dtype=np.int32)
    off = 0
    exps, coefs = [], []
    for i, sh in enumerate(shells):
        prim_off[i] = off
        exps.extend(sh.exps.tolist())
        coefs.extend(sh.coefs.tolist())
        off += len(sh.exps)
    return dict(
        nshell=nshell, ls=ls, nprim=nprim, prim_off=prim_off,
        exps=np.asarray(exps, dtype=np.float64),
        coefs=np.asarray(coefs, dtype=np.float64),
        centers=np.ascontiguousarray(
            np.array([sh.center for sh in shells], dtype=np.float64)
        ).reshape(-1),
        sph_off=np.asarray(bs.sph_offsets, dtype=np.int32),
        norms=np.ascontiguousarray(bs._norms, dtype=np.float64),
    )


def compute_eri(bs):
    """Full spherical ERI tensor from the C++ engine (chemists' (ij|kl))."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    shells = bs.shells
    nshell = len(shells)
    ls = np.array([sh.l for sh in shells], dtype=np.int32)
    nprim = np.array([len(sh.exps) for sh in shells], dtype=np.int32)
    prim_off = np.zeros(nshell, dtype=np.int32)
    off = 0
    exps, coefs = [], []
    for i, sh in enumerate(shells):
        prim_off[i] = off
        exps.extend(sh.exps.tolist())
        coefs.extend(sh.coefs.tolist())
        off += len(sh.exps)
    exps = np.asarray(exps, dtype=np.float64)
    coefs = np.asarray(coefs, dtype=np.float64)
    centers = np.ascontiguousarray(
        np.array([sh.center for sh in shells], dtype=np.float64))
    sph_off = np.asarray(bs.sph_offsets, dtype=np.int32)
    norms = np.ascontiguousarray(bs._norms, dtype=np.float64)
    out = np.zeros((bs.nao,) * 4, dtype=np.float64)
    lib.compute_eri(nshell, ls, nprim, prim_off, exps, coefs,
                    centers.reshape(-1), sph_off, bs.nao, norms,
                    out.reshape(-1))
    return out
