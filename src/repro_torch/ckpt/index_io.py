"""Ship built indexes: the reference's ``repro.ckpt.index_io`` on the port.

``save_index`` drops a backend's ``to_state_dict()`` snapshot into a
checkpoint (array leaves in the shard file; the backend's name, metric,
``state_format`` and search variant in the manifest's ``extra``), and
``load_index`` restores it through the registry onto a device, so a
serving host needs no rebuild::

    from repro_torch import ckpt
    ckpt.save_index("idx.ckpt", backend)
    backend = ckpt.load_index("idx.ckpt")          # on cuda

The format is the reference's, both ways: the port loads a directory the
JAX package wrote (zstd frames too, where ``zstandard`` is installed) and
the JAX package loads the port's.  A snapshot in a ``state_format`` newer
than the backend's ``STATE_FORMAT`` fails fast with
:class:`~repro_torch.ckpt.versioning.ArtifactFormatError`.  Streaming
deltas (``delta_*`` sub-checkpoints of the reference's mutable backends)
come with the port's streaming slice; a directory that holds them is
refused, never loaded without them.
"""
from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.ckpt.versioning import check_artifact_format

INDEX_META_KEY = "anns_index_meta"


def save_index(path: str, backend, *, step: int = 0,
               extra: dict | None = None) -> None:
    """Checkpoint a built backend's ``to_state_dict()`` snapshot, with its
    ``variant`` (the search knobs' defaults), so a host restoring it
    serves at the build host's operating point."""
    state = backend.to_state_dict()
    arrays = {k: v for k, v in state.items() if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in state.items() if not isinstance(v, np.ndarray)}
    meta.setdefault("backend", backend.name)
    variant = getattr(backend, "variant", None)
    if variant is not None and "variant" not in meta:
        meta["variant"] = dataclasses.asdict(variant)
    save_checkpoint(path, arrays, step,
                    extra={INDEX_META_KEY: meta, **(extra or {})})


def load_index(path: str, variant=None, *, seed: int = 0, device="cuda"):
    """A backend on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``) holding the index saved at ``path``.  The
    backend comes from the checkpoint; ``variant`` overrides the saved
    search knobs' defaults."""
    from repro_torch.anns import registry
    from repro_torch.anns.engine import VariantConfig
    from repro_torch.anns.state import from_reference_state
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    deltas = sorted(glob.glob(os.path.join(path, "delta_*")))
    if deltas:
        raise NotImplementedError(
            f"{path!r} holds {len(deltas)} streaming delta checkpoint(s) "
            f"({os.path.basename(deltas[0])}, ...): replaying them comes "
            f"with the port's streaming slice (ROADMAP item 7); load the "
            f"base without them only by re-saving it from a host that "
            f"replayed them")
    arrays, _step, extra = load_checkpoint(path)
    meta = extra.get(INDEX_META_KEY)
    if meta is None:
        raise KeyError(f"{path!r} is not an index checkpoint (missing "
                       f"{INDEX_META_KEY!r} in manifest extra)")
    meta = dict(meta)
    saved_variant = meta.pop("variant", None)
    if variant is None and saved_variant is not None:
        variant = VariantConfig(**saved_variant)
    check_artifact_format(
        "state", meta.get("state_format"),
        getattr(registry.get(meta["backend"]), "STATE_FORMAT", 1),
        what=f"{path!r} ({meta['backend']!r} index)",
        hint="rebuild the index or upgrade the serving host")
    return from_reference_state({**arrays, **meta}, device, variant=variant,
                                seed=seed)
