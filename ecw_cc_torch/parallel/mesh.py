"""Device-mesh helpers (port of ecw_cc_tpu/parallel/mesh.py).

The scaling dimension of ECW-CC is the virtual-orbital index of the big
ERI blocks (the vvvv ladder) and the independent lambda / state axes:

  mesh axes:
    'tp' -- tensor parallel: the ladder operand's rows, and the
            oovv/ovvv/vvvv/vovv/t2/l2 virtual axes of parallel/sharding.py;
    'dp' -- batch parallel: independent lambda values / excited states
            (the operands are replicated over it).

A mesh is built over the ranks of a process group the caller has started
(one process per card: `torchrun --nproc-per-node N script.py`, then
`torch.distributed.init_process_group('nccl')` in the script, then
`make_mesh`).  Nothing here starts a process or a group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate


def make_mesh(n_tp=None, n_dp=1, devices=None, device_type="cuda"):
    """A 2-D ('dp', 'tp') DeviceMesh over `devices` (a list of ranks; all
    ranks of the default process group when None), n_dp x n_tp of them,
    row-major.  Every rank of the default group calls it (the mesh makes
    one subgroup per row and column).  device_type: 'cuda' (NCCL), or
    'cpu' (gloo)."""
    if devices is None:
        if not dist.is_initialized():
            raise RuntimeError(
                "make_mesh needs a process group: start one first "
                "(torchrun, then torch.distributed.init_process_group)")
        devices = list(range(dist.get_world_size()))
    n = len(devices)
    if n_tp is None:
        n_tp = n // n_dp
    if n_tp * n_dp != n:
        raise ValueError(f"mesh {n_dp}x{n_tp} does not match {n} devices")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: start one first "
            "(torchrun, then torch.distributed.init_process_group)")
    ranks = torch.as_tensor(list(devices), dtype=torch.int64)
    return DeviceMesh(device_type, ranks.reshape(n_dp, n_tp),
                      mesh_dim_names=("dp", "tp"))


def replicated(mesh):
    """The placements of a tensor replicated over the whole mesh."""
    return [Replicate(), Replicate()]
