"""Checkpoints in the reference's on-disk format (``repro.ckpt.checkpoint``),
without JAX, ``msgpack`` or ``zstandard`` at import.

A checkpoint is a directory holding ``manifest.json`` (step, ``extra``,
each leaf's shape and dtype, and the shard file's compression) and
``shard_0.bin``: one msgpack array of frames ``{"key", "bounds", "data"}``,
one a leaf, each a whole array's C-order bytes with the bounds
``[[0, s], ...]`` of a full slice.  The port writes the frames raw
(``"compression": "none"``), as the reference does where ``zstandard`` is
missing, so its files are byte-equal to the reference's there; a
``zstd`` checkpoint is read by importing ``zstandard`` when it is met.

The tree is flat: ``{path: tensor or ndarray}``, frames in sorted key
order (the order a JAX dict flattens in).  Writes are atomic: into
``<dir>.tmp``, then ``os.replace``.  bfloat16 leaves are written as the
reference writes them (dtype ``"bfloat16"``, 2 bytes an element) without
numpy knowing that dtype.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.ckpt import _msgpack


class HostArray(NamedTuple):
    """A leaf copied to the host: its C-order ``data`` and the dtype name
    the manifest records.  numpy has no bfloat16 of its own, so a bfloat16
    tensor's copy holds its uint16 bits under the name ``"bfloat16"``
    (the name the reference writes for its ``ml_dtypes`` arrays)."""
    data: np.ndarray
    dtype: str


def host_copy(leaf) -> HostArray:
    """A host copy of a tensor or array that later writes to ``leaf`` do
    not reach (a CPU tensor's ``.numpy()`` would alias it)."""
    if isinstance(leaf, HostArray):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return HostArray(t.view(torch.int16).numpy().view(np.uint16),
                             "bfloat16")
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True, order="C")
    return HostArray(arr, str(arr.dtype))


def _from_bytes(data, dtype: str, shape) -> np.ndarray | torch.Tensor:
    """A leaf read back: an ndarray, or a CPU bfloat16 tensor for
    ``"bfloat16"`` (whether or not numpy knows the name)."""
    if dtype == "bfloat16":
        bits = np.frombuffer(data, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)


def save_checkpoint(path: str, tree: dict, step: int,
                    extra: dict | None = None) -> None:
    """Write the flat ``tree`` ({path: tensor, ndarray or HostArray}) with
    ``step`` and the JSON-able ``extra`` to the directory ``path``."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": int(step), "extra": extra or {}, "leaves": {}}
    frames = []
    for key in sorted(tree):
        arr, dtype = host_copy(tree[key])
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
        frames.append({"key": key, "bounds": [[0, s] for s in arr.shape],
                       "data": arr.tobytes()})
    manifest["compression"] = "none"
    with open(os.path.join(tmp, "shard_0.bin"), "wb") as f:
        f.write(_msgpack.packb(frames))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_checkpoint(path: str, like_tree: dict | None = None):
    """``(tree, step, extra)`` of the checkpoint at ``path``.  The tree is
    ``{path: read-only ndarray}`` (a CPU tensor for a bfloat16 leaf); with
    ``like_tree`` (a flat dict of tensors or arrays) every leaf of it must
    be there with its shape, and comes back as a tensor or array of its
    dtype (and device)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "shard_0.bin"), "rb") as f:
        payload = f.read()
    if manifest.get("compression", "zstd") == "zstd":
        try:
            import zstandard
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                "checkpoint was written with zstd compression but "
                "zstandard is not installed") from e
        payload = zstandard.ZstdDecompressor().decompress(payload)
    arrays = {}
    for fr in _msgpack.unpackb(payload):
        meta = manifest["leaves"][fr["key"]]
        arrays[fr["key"]] = _from_bytes(fr["data"], meta["dtype"],
                                        meta["shape"])
    if like_tree is None:
        return arrays, manifest["step"], manifest["extra"]
    out = {}
    for key, leaf in like_tree.items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            src = arr if isinstance(arr, torch.Tensor) else torch.tensor(arr)
            out[key] = src.to(dtype=leaf.dtype, device=leaf.device)
        else:
            out[key] = np.array(arr, dtype=leaf.dtype)
    return out, manifest["step"], manifest["extra"]
