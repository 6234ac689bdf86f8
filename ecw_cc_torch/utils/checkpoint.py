"""Checkpoint / resume for the lambda sweep.

The reference only warm-starts amplitudes in memory between lambda values
(Main.py:609,764; SURVEY.md section 5 'Checkpoint/resume').  Here converged
amplitude pytrees are additionally serialized per lambda so a sweep can be
resumed across processes (and a crashed sweep restarted from the last
converged lambda).

Copy of ecw_cc_tpu/utils/checkpoint.py (the PyTorch port imports
nothing of the JAX package); only the imports differ.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _key(L):
    return f"L{float(L):.10g}"


def save_amplitudes(ckpt_dir, L, amps: dict, meta: dict | None = None):
    """Save an amplitude dict {name: array} for weight L."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, _key(L) + ".npz")
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in amps.items()})
    idx_path = os.path.join(ckpt_dir, "index.json")
    index = {}
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            index = json.load(f)
    index.pop(_key(L), None)  # re-append so insertion order == save order
    index[_key(L)] = {"L": float(L), "file": os.path.basename(path),
                      **(meta or {})}
    # atomic replace: a crash mid-write must not corrupt the index this
    # module exists to protect
    tmp = idx_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(index, f, indent=1)
    os.replace(tmp, idx_path)
    return path


def load_amplitudes(ckpt_dir, L):
    """Load the amplitude dict for weight L, or None if absent."""
    path = os.path.join(ckpt_dir, _key(L) + ".npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def last_checkpoint(ckpt_dir):
    """(L, amps) of the most recently saved lambda (insertion order, so a
    descending or re-visited sweep resumes correctly), or (None, None)."""
    idx_path = os.path.join(ckpt_dir, "index.json")
    if not os.path.exists(idx_path):
        return None, None
    with open(idx_path) as f:
        index = json.load(f)
    if not index:
        return None, None
    L = index[list(index)[-1]]["L"]
    return L, load_amplitudes(ckpt_dir, L)
