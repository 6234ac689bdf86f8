"""Placement rules for the ECW-CC tensors over a ('dp', 'tp') mesh (port of
ecw_cc_tpu/parallel/sharding.py), on DTensor.

Layout (the JAX package's, placement for placement):

  - vvvv <ab||ef>: rows (the first virtual axis) split over 'tp'.  In the
    ladder product M[ij, ab] = tau[ij, ef] . W[ab, ef] each rank owns a
    slice of the output pairs ab and contracts the whole ef axis: its
    columns of M come from its own rows alone, so the operand is never
    gathered; only M's columns are (one all-gather of o^2 x v^2).
  - the packed and sectored ladder operands (ops/ladder.py): the same, on
    their pair rows, zero-padded to a multiple of the 'tp' size
    (shard_vvvv_op).
  - ovvv / vovv: split along a virtual axis over 'tp'; oovv and the
    amplitudes t2, l2 along their last virtual axis.
  - fock, the other blocks, t1, l1: replicated.

How the port computes on these placements.  The ladder operand stays
split: the consumers (the solver, the EOM sigmas) turn it into a RowShard
(`local_operand`, `local_eris`) once, before their loop, and every ladder
product on it is one launch of the kernel on the rank's own rows
(kernels/ladder_mm._ShardMM).  Every other sharded tensor is gathered
once where a consumer takes it (`replicate`, the one redistribution
point: an all-gather per tensor), and the iteration runs on replicated
plain tensors; results are handed back in their placements by local
slicing (`shard_tensor`, no communication).  DTensor's own operator
rules are not used inside the loop: its einsum gathers the operands per
call, it has no rule for an index-tensor gather (the pair maps, spin
sectors and DIIS packing) nor for torch.func.jvp (the EOM right sigma).
"""

from __future__ import annotations

import re
import sys

import torch
import torch.distributed as dist

from ecw_cc_torch.kernels.ladder_mm import RowShard, tma_rows
from ecw_cc_torch.models.eris import GEris


def _dt():
    """torch.distributed.tensor, imported at first use (about a second):
    the solver and the ops import this module, and most runs use no
    mesh."""
    import torch.distributed.tensor as dt

    return dt


def is_sharded(x):
    """x is a DTensor (none exists before DTensor's module is loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


class MeshPlacements(list):
    """A placement list over the mesh's ('dp', 'tp') axes that also
    carries its mesh (the role of the JAX package's NamedSharding)."""

    def __init__(self, mesh, placements):
        super().__init__(placements)
        self.mesh = mesh


def _on_tp(mesh, dim=None):
    """Replicated over 'dp'; split along `dim` over 'tp' (None: replicated
    there too)."""
    dt = _dt()
    return MeshPlacements(mesh, [dt.Replicate(), dt.Replicate() if dim is None
                                 else dt.Shard(dim)])


def eris_shardings(mesh):
    """Per-block placements of a GEris."""
    split = {"oovv": 3, "ovvv": 1, "vvvv": 0, "vovv": 0}
    return {name: _on_tp(mesh, split.get(name)) for name in GEris._fields}


def amp_shardings(mesh):
    """Placements of the amplitudes {t1, t2, l1, l2}."""
    return {"t1": _on_tp(mesh), "l1": _on_tp(mesh),
            "t2": _on_tp(mesh, 3), "l2": _on_tp(mesh, 3)}


def _chunk(n, parts, i):
    """[lo, hi) of chunk i of n split into `parts` (torch.chunk's sizes,
    as DTensor's Shard cuts them: ceil(n / parts) each, the last ones
    short or empty)."""
    per = -(-n // parts)
    lo = min(i * per, n)
    return lo, min(lo + per, n)


def _strides(shape):
    """The strides of a contiguous tensor of `shape`."""
    return torch.empty(tuple(shape), device="meta").stride()


def shard_tensor(x, mesh, placements):
    """x (the whole tensor, on every rank) as a DTensor with `placements`:
    each rank keeps its own chunk, no communication."""
    dt = _dt()
    local = x
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, dt.Shard):
            lo, hi = _chunk(x.shape[p.dim], mesh.size(i), coord[i])
            local = local.narrow(p.dim, lo, hi - lo)
    return dt.DTensor.from_local(local.contiguous(), mesh, list(placements),
                              run_check=False, shape=x.shape,
                              stride=_strides(x.shape))


def row_range(n_rows, mesh):
    """[lo, hi) of the rows this rank holds of an operand of n_rows rows
    split over 'tp' (n_rows a multiple of the 'tp' size)."""
    tp = mesh["tp"]
    return _chunk(n_rows, tp.size(), tp.get_local_rank())


def from_rows(local, mesh, n_rows):
    """The DTensor, replicated over 'dp' and split by rows over 'tp', of
    which `local` is this rank's rows [row_range(n_rows, mesh)): the one
    wrapping of a rank's own rows, so that an operand is never whole on
    any rank."""
    dt = _dt()
    shape = (n_rows,) + tuple(local.shape[1:])
    # rows contiguous along K stay as they are (padded TMA rows)
    if local.dim() != 2 or local.stride(-1) != 1:
        local = local.contiguous()
    return dt.DTensor.from_local(local, mesh,
                                 [dt.Replicate(), dt.Shard(0)],
                                 run_check=False, shape=shape,
                                 stride=_strides(shape))


def _pad_rows(w, mesh):
    """w's rows zero-padded to a multiple of the 'tp' size, this rank's
    part of them wrapped by from_rows."""
    tp = mesh["tp"].size()
    rows = w.shape[0] + (-w.shape[0]) % tp
    lo, hi = row_range(rows, mesh)
    local = w.new_zeros((hi - lo,) + tuple(w.shape[1:]))
    if w.dim() == 2:
        # the operand's 16-byte rows, so that no launch on the rank's rows
        # copies them
        local = tma_rows(local)
    top = min(hi, w.shape[0])
    if top > lo:
        local[:top - lo] = w[lo:top]
    return from_rows(local, mesh, rows)


def shard_eris(eris, mesh):
    """A GEris of DTensors with eris_shardings' placements."""
    sh = eris_shardings(mesh)
    return GEris(**{k: shard_tensor(getattr(eris, k), mesh, sh[k])
                    for k in GEris._fields})


def shard_vvvv_op(vvvv_op, mesh):
    """A non-dense ladder operand (ops/ladder.py) split by rows over 'tp'.

    PackedVVVV.wc[A, E] is split along its row (output-pair) axis: each
    rank owns a slice of output pairs A = (a<b) and contracts the whole E
    axis.  p = nvir(nvir-1)/2 is odd for half of all nvir (13041 at
    cc-pVTZ), so the rows are zero-padded to a multiple of the 'tp' size
    first; packed_vvvv_contract slices the padded output columns back to
    p.  Each SectoredVVVV sector is split the same way, and a tuple of
    dense sectors along each sector's first axis."""
    if vvvv_op is None:
        return None
    from ecw_cc_torch.ops.ladder import PackedVVVV, SectoredVVVV

    if isinstance(vvvv_op, PackedVVVV):
        return PackedVVVV(wc=_pad_rows(vvvv_op.wc, mesh))
    if isinstance(vvvv_op, SectoredVVVV):
        return SectoredVVVV(*(_pad_rows(w, mesh) for w in vvvv_op))
    return tuple(shard_tensor(s, mesh, _on_tp(mesh, 0)) for s in vvvv_op)


# ---------------------------------------------------------------------------
# what the consumers take: gathered tensors and row shards
# ---------------------------------------------------------------------------

def mesh_of(*objs):
    """The mesh of the first DTensor among objs (tensors, GEris, ladder
    operands, tuples of them), or None."""
    for o in objs:
        if is_sharded(o):
            return o.device_mesh
        if isinstance(o, tuple):
            m = mesh_of(*o)
            if m is not None:
                return m
    return None


def replicate(x):
    """x as a plain tensor holding the whole of it: a DTensor is gathered
    (one all-gather per split axis), anything else passes.  The one point
    where the port redistributes a sharded tensor."""
    return x.full_tensor() if is_sharded(x) else x


def place_like(x, ref):
    """x (whole, on every rank) in ref's placements when ref is a DTensor
    (local slicing, no communication), else x."""
    if is_sharded(ref):
        return shard_tensor(x, ref.device_mesh, ref.placements)
    return x


def _rows_on_tp(x):
    """x (a DTensor) is split by rows over 'tp' and replicated over 'dp'."""
    dt = _dt()
    return list(x.placements) == [dt.Replicate(), dt.Shard(0)]


def row_shard(x):
    """The RowShard of a DTensor split by rows over 'tp' (and replicated
    over 'dp'): its local rows as the GEMM view the ladder launches on (a
    dense (v, v, v, v) vvvv: rows of v*v)."""
    mesh = x.device_mesh
    if not _rows_on_tp(x):
        raise ValueError(f"a ladder operand split over the mesh takes the "
                         f"placements [Replicate(), Shard(0)] over ('dp', "
                         f"'tp'), not {list(x.placements)}")
    if x.dim() == 2:
        unit, K = 1, x.shape[1]        # GEMM rows per leading row, columns
    elif x.dim() == 4:
        unit, K = x.shape[1], x.shape[2] * x.shape[3]
    else:
        raise ValueError(f"no GEMM view of a {x.dim()}-D ladder operand")
    local = x.to_local()
    tp = mesh["tp"]
    per = -(-x.shape[0] // tp.size()) * unit
    # a 2-D local as it is (the TMA-ready rows of a cast operand stay)
    return RowShard(local if x.dim() == 2 else local.reshape(-1, K), x.shape,
                    x.shape[0] * unit, per, tp.get_group(), tp.size())


def map_local(fn, x):
    """fn applied to a sharded operand's local rows, the placement kept
    (a DTensor, a RowShard), or to x itself."""
    if isinstance(x, RowShard):
        return x.with_local(fn(x.local))
    if is_sharded(x):
        return _dt().DTensor.from_local(fn(x.to_local()), x.device_mesh,
                                        x.placements, run_check=False,
                                        shape=x.shape, stride=x.stride())
    return fn(x)


def local_operand(op):
    """A ladder operand (PackedVVVV, SectoredVVVV, a tensor, a tuple) with
    each DTensor in it turned into its RowShard; None and plain operands
    pass."""
    if op is None:
        return None
    if is_sharded(op):
        return row_shard(op)
    if isinstance(op, tuple):
        return type(op)(*(local_operand(w) for w in op)) if hasattr(
            op, "_fields") else tuple(local_operand(w) for w in op)
    return op


def local_eris(eris):
    """A GEris as the loop takes it: every DTensor block gathered, except
    a split dense vvvv, which becomes its RowShard (the dense route's
    ladder operand)."""
    def one(name, x):
        if name == "vvvv" and is_sharded(x) and x.numel() and _rows_on_tp(x):
            return row_shard(x)
        return replicate(x)

    return GEris(**{k: one(k, getattr(eris, k)) for k in GEris._fields})


def all_reduce_sum(x, mesh):
    """x summed over every rank of the mesh: one all-reduce (over the
    default group when the mesh spans it, else one per mesh axis)."""
    if mesh.size() == dist.get_world_size():
        dist.all_reduce(x)
    else:
        for name in ("dp", "tp"):
            dist.all_reduce(x, group=mesh[name].get_group())
    return x


def mesh_rank(mesh):
    """This rank's place among the mesh's ranks, in row-major order."""
    coord = mesh.get_coordinate()
    return coord[0] * mesh.size(1) + coord[1]


_COLLECTIVE = re.compile(r"gather|reduce|scatter|broadcast|all_?to_?all|"
                         r"send|recv|barrier")


class CollectiveLog:
    """Records the collectives run inside it, on any backend: (op name,
    [shape of each tensor argument]) per call, in `calls` (a
    TorchDispatchMode, as torch's CommDebugMode, which counts the same
    calls but keeps no shapes).  Use: `with CollectiveLog() as log:`."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        calls = self.calls = []

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if "c10d" in func.namespace and _COLLECTIVE.search(
                        func.__name__):
                    shapes = [tuple(t.shape) for t in _tensors(args)]
                    calls.append((func.__name__.split(".")[0], shapes))
                return func(*args, **(kwargs or {}))

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def largest(self):
        """The most elements any one tensor of a logged collective had."""
        return max((int(torch.Size(s).numel()) for _, shapes in self.calls
                    for s in shapes), default=0)


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)
