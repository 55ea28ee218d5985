"""The collectives of every sharded path, over named mesh axes, and their
count (the port's counterpart of ``repro.dist.hlo``'s contract).

The reference reads its traffic off the compiled HLO: per collective op,
the bytes of its *output* shape (an all-gather counts its gathered size,
a reduce-scatter its scattered slice).  The port has no HLO, so every
collective it makes goes through these wrappers, which count the same
way while :func:`count_collectives` is open:

    with count_collectives() as c:
        ...
    c == {"all-reduce": {"count": 2, "bytes": 96}, ..., "total_bytes": ...}

``axes`` is one mesh axis name or a tuple of them; a tuple's group is the
ranks that differ only along those axes, indexed with the first axis
major (the order of a ``PartitionSpec`` entry).

The autograd forms (:func:`sum_over`, :func:`gather_on_use`) carry the
exact adjoint of their collective backward: a sum's gradient is summed,
an all-gather's is reduce-scattered.  A sharded step therefore treats the
global loss as the sum of every rank's local term, each rank
backpropagating ``loss / world`` (:mod:`repro_torch.dist.fsdp`).
"""
from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import _axes, axes_index, axis_sizes, coordinate

_ACTIVE: list[dict] = []


@contextlib.contextmanager
def count_collectives():
    """Yield a dict that counts every collective made inside the block:
    ``{op: {"count", "bytes"}, ..., "total_bytes"}``, ops named as the
    reference's HLO names them (``all-reduce``, ``all-gather``,
    ``reduce-scatter``)."""
    out: dict = {"total_bytes": 0}
    _ACTIVE.append(out)
    try:
        yield out
    finally:
        _ACTIVE.remove(out)


def _record(op: str, out: torch.Tensor) -> None:
    nbytes = out.numel() * out.element_size()
    for c in _ACTIVE:
        entry = c.setdefault(op, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += nbytes
        c["total_bytes"] += nbytes


def axis_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (flattened, the first axis major)."""
    return axes_index(axis_sizes(mesh), coordinate(mesh), _axes(axes))


def group(mesh, axes):
    """The process group of this rank's line along ``axes``.  A tuple of
    axes makes one group a line, on every rank in the same order (a
    collective call), the first time it is asked for."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        ranks = mesh.mesh
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        lines = ranks.permute(*rest, *dims).reshape(-1, axis_size(mesh, axes))
        mine = None
        for line in lines.tolist():
            g = dist.new_group(line)
            if dist.get_rank() in line:
                mine = g
        cache[axes] = mine
    return cache[axes]


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced (sum | mean | max) over ``axes``.  The
    mean is a sum divided by the group's size (Gloo has no AVG)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"all_reduce op {op!r}: sum | mean | max")
    dist.all_reduce(out, op=red, group=group(mesh, axes))
    _record("all-reduce", out)
    if op == "mean":
        out = out / axis_size(mesh, axes)
    return out


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axes``, concatenated along ``dim`` in
    axis-index order."""
    n = axis_size(mesh, axes)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    with warnings.catch_warnings():      # renamed *_single in newer torch
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group(mesh, axes))
    _record("all-gather", out)
    return out.movedim(0, dim)


def broadcast(x: torch.Tensor, group, *, op: str,
              src: int = 0) -> torch.Tensor:
    """``x`` from rank ``src`` on every rank of ``group``, in place; counted
    under ``op`` (the op stream of :mod:`repro_torch.dist.leader` counts
    its records as ``"op-stream"``, apart from the search's own traffic)."""
    dist.broadcast(x, src=src, group=group)
    _record(op, x)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axes``; this rank's slice of ``dim``."""
    n = axis_size(mesh, axes)
    src = x.detach().movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group(mesh, axes))
    _record("reduce-scatter", out)
    return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# autograd forms
# ---------------------------------------------------------------------------
class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """All-reduce sum whose backward is the all-reduce sum of the gradient
    (its adjoint when every rank's loss is a term of one global sum)."""
    return _SumOver.apply(x, mesh, axes)


def gather_on_use(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` whose backward reduce-scatters the gradient
    back onto the slices (the FSDP parameter gather)."""
    return _GatherOnUse.apply(x, mesh, axes, dim)
