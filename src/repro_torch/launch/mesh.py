"""Device meshes over ``torch.distributed`` (mirrors ``repro.launch.mesh``).

Functions, not constants: importing this module starts nothing.  Each
``make_*`` returns a ``DeviceMesh`` with the reference's axis names over
the process group that is already running (:func:`init_distributed`),
ranks laid out row-major.  A mesh whose size is not the world's raises,
naming both: nothing shrinks a mesh to fit.

Topology of the reference's pods: 256 chips as (data=16, model=16);
multi-pod adds a leading ``"pod"`` axis.  DP gradient reduction runs over
``("pod", "data")``; TP / EP collectives stay on ``"model"``.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

#: the default timeout of a process group's collectives and rendezvous
TIMEOUT_S = 600


def init_distributed(device, *, backend: str | None = None,
                     init_method: str = "env://",
                     timeout_s: float = TIMEOUT_S) -> None:
    """Start the default process group: NCCL for a ``cuda`` device, Gloo
    for ``cpu`` (``backend`` overrides, e.g. Gloo over CUDA tensors).
    Rank and world size come from ``RANK`` / ``WORLD_SIZE``, as
    ``torchrun`` or :mod:`repro_torch.launch.train`'s launcher sets them;
    on ``cuda`` the rank takes card ``LOCAL_RANK``."""
    device = torch.device(device)
    if backend is None:
        backend = {"cuda": "nccl", "cpu": "gloo"}[device.type]
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    size = 1
    for n in shape:
        size *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if size != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {axes} needs "
                         f"{size} ranks; the world has {world}")
    return DeviceMesh(_device_type(), torch.arange(size).reshape(shape),
                      mesh_dim_names=axes)


def production_axes(*, multi_pod: bool = False) -> dict[str, int]:
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def tuned_axes(tp: int = 16, *, multi_pod: bool = False) -> dict[str, int]:
    """The 256 / 512-rank grid with its 16-wide model dimension split
    into ``("replica", "model") = (16 // tp, tp)``: the TP-degree knob
    (activation collectives traded for a larger gradient reduction)."""
    if 16 % tp:
        raise ValueError(f"tp {tp} does not divide 16")
    axes = {"pod": 2} if multi_pod else {}
    axes.update({"data": 16, "replica": 16 // tp, "model": tp})
    return axes


def make_production_mesh(*, multi_pod: bool = False):
    axes = production_axes(multi_pod=multi_pod)
    return _mesh(tuple(axes.values()), tuple(axes))


def make_debug_mesh(n_data: int = 2, n_model: int = 4):
    """A small ``("data", "model")`` mesh (CPU tests: Gloo processes)."""
    return _mesh((n_data, n_model), ("data", "model"))


def make_shard_mesh(n_shards: int):
    """1-D ``("shard",)`` mesh for the sharded ANNS backend: each rank
    owns one slice of the stacked cell-major layout."""
    return _mesh((n_shards,), ("shard",))


def shard_mesh_if_available(n_shards: int):
    """:func:`make_shard_mesh` when a process group runs with at least one
    rank a shard (it raises unless exactly one), else ``None``: the caller
    runs the single-device search (identical results, no placement)."""
    if (n_shards > 1 and dist.is_initialized()
            and dist.get_world_size() >= n_shards):
        return make_shard_mesh(n_shards)
    return None


def make_tuned_mesh(tp: int = 16, *, multi_pod: bool = False):
    axes = tuned_axes(tp, multi_pod=multi_pod)
    return _mesh(tuple(axes.values()), tuple(axes))
