"""Sharding rules (mirrors ``repro.dist.sharding``): map parameter, cache
and batch leaves onto a mesh, and cut a rank's slice of a leaf.

One shape-driven policy instead of per-arch tables: on the model axis,
shard the *widest* dim that divides (ties go to the later dim), else
replicate, so every leaf gets a legal placement.  A spec is a tuple with
one entry a dim, as the reference's ``PartitionSpec``: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
their product, the first axis major).

Axis conventions (:mod:`repro_torch.launch.mesh`): tensor-parallel and
expert-parallel collectives run over ``"model"``; data parallelism spans
whichever of ``("pod", "data", "replica")`` the mesh has; ZeRO state
slices over those same DP axes.

``mesh`` is a ``DeviceMesh`` or a mapping ``{axis name: size}`` in mesh
order (the rules need only the axes and their sizes, so production meshes
of 256 or 512 ranks can be costed in one process).  Leaves are
``{name: shape}`` (or anything with a ``.shape``); the rules return
``{name: spec}``.
"""
from __future__ import annotations

import torch

DP_AXES = ("pod", "data", "replica")
TP_AXIS = "model"


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh)


def _dp_axes(sizes: dict) -> tuple:
    return tuple(a for a in DP_AXES if a in sizes)


def _axes(entry) -> tuple:
    """The axes of one spec entry (``()`` for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axes_size(sizes: dict, axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


def _dp_entry(dp: tuple):
    """Spec entry for the DP axes (tuple entry only when >1)."""
    return dp if len(dp) > 1 else dp[0]


def _shape_of(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", leaf))


def scalar_sharding(mesh) -> tuple:
    """Fully replicated (scalars, lengths, step counters)."""
    return ()


def batch_sharding(mesh, ndim: int = 2, batch: int | None = None, *,
                   dp_axes: tuple = DP_AXES) -> tuple:
    """Leading-axis data parallelism over the mesh's ``dp_axes`` (the
    reference's DP axes unless given); replicated when ``batch`` is given
    and does not divide the DP extent (tiny long-context batches)."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in dp_axes if a in sizes)
    if not dp or (batch is not None and batch % _axes_size(sizes, dp) != 0):
        return (None,) * ndim
    return (_dp_entry(dp),) + (None,) * (ndim - 1)


def param_shardings(leaves: dict, mesh, *, fsdp: bool = False) -> dict:
    """Tensor-parallel parameter specs: shard ONE dim over the model axis
    -- the widest dim that divides (ties prefer the later dim); replicate
    when nothing divides.  ``fsdp=True`` also shards the first remaining
    dim that divides over the DP axes (FSDP / ZeRO-3 slicing)."""
    sizes = axis_sizes(mesh)
    tp = TP_AXIS if TP_AXIS in sizes else None
    tp_size = sizes[tp] if tp else 1
    dp = _dp_axes(sizes)
    dp_size = _axes_size(sizes, dp) if dp else 1

    def one(leaf):
        shape = _shape_of(leaf)
        spec = [None] * len(shape)
        if tp and tp_size > 1:
            order = sorted(range(len(shape)), key=lambda i: (-shape[i], -i))
            for d in order:
                if shape[d] >= tp_size and shape[d] % tp_size == 0:
                    spec[d] = tp
                    break
        if fsdp and dp and dp_size > 1:
            for d in range(len(shape)):
                if (spec[d] is None and shape[d] >= dp_size
                        and shape[d] % dp_size == 0):
                    spec[d] = _dp_entry(dp)
                    break
        return tuple(spec)

    return {name: one(leaf) for name, leaf in leaves.items()}


def zero_shardings(pspecs: dict, leaves: dict, mesh) -> dict:
    """ZeRO-1/2 optimizer-state specs: the parameter's spec with the first
    still-replicated dim that divides also sliced over the DP axes, so each
    data-parallel rank owns a distinct shard of m / v / master.  Leaves
    with no such dim keep the parameter's spec."""
    sizes = axis_sizes(mesh)
    dp = _dp_axes(sizes)
    dp_size = _axes_size(sizes, dp) if dp else 1

    def one(spec, leaf):
        shape = _shape_of(leaf)
        if not dp or dp_size == 1:
            return spec
        spec = list(spec) + [None] * (len(shape) - len(spec))
        for d in range(len(shape)):
            if (spec[d] is None and shape[d] >= dp_size
                    and shape[d] % dp_size == 0):
                spec[d] = _dp_entry(dp)
                break
        return tuple(spec)

    return {name: one(pspecs[name], leaf) for name, leaf in leaves.items()}


def cache_shardings(leaves: dict, mesh) -> dict:
    """Decode-state specs.  KV caches are (B, S, Hk, D): shard the
    *sequence* axis over the model axis (the layout
    :mod:`repro_torch.dist.seq_decode` combines over: each rank owns a
    contiguous slice of positions), else the heads axis when the sequence
    does not divide, else replicate.  Non-4D leaves (SSM / RWKV recurrent
    state) replicate: they are small and updated every step."""
    sizes = axis_sizes(mesh)
    tp = TP_AXIS if TP_AXIS in sizes else None
    tp_size = sizes[tp] if tp else 1

    def one(leaf):
        shape = _shape_of(leaf)
        if tp and tp_size > 1 and len(shape) == 4:
            if shape[1] >= tp_size and shape[1] % tp_size == 0:
                return (None, tp, None, None)
            if shape[2] >= tp_size and shape[2] % tp_size == 0:
                return (None, None, tp, None)
        return (None,) * len(shape)

    return {name: one(leaf) for name, leaf in leaves.items()}


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def coordinate(mesh) -> dict[str, int]:
    """This rank's ``{axis name: index}`` on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axes_index(sizes: dict, coord: dict, axes) -> int:
    """The rank's index along ``axes`` flattened, the first axis major."""
    idx = 0
    for a in _axes(axes):
        idx = idx * sizes[a] + coord[a]
    return idx


def placements(spec: tuple, mesh) -> list:
    """The spec as ``DTensor`` placements: one a mesh dim, ``Shard(d)``
    where the dim's axis shards tensor dim ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec) if axis in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one rank's slice of a leaf of ``shape``."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // _axes_size(sizes, e) for n, e in zip(shape, spec))


def local_slice(full: torch.Tensor, spec: tuple, mesh,
                coord: dict | None = None) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (a view; ``coord``
    names the rank's mesh coordinate, by default the running rank's)."""
    sizes = axis_sizes(mesh)
    coord = coordinate(mesh) if coord is None else coord
    out = full
    for d, e in enumerate(spec):
        if e is None:
            continue
        n = _axes_size(sizes, e)
        if full.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not "
                             f"divide over {e} ({n} ranks)")
        step = full.shape[d] // n
        out = out.narrow(d, axes_index(sizes, coord, e) * step, step)
    return out


def gather_full(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice (a collective: every rank of
    the mesh calls it with its own slice)."""
    from repro_torch.dist import comm
    out = local
    for d, e in enumerate(spec):
        if e is not None:
            out = comm.all_gather(out, mesh, _axes(e), dim=d)
    return out
