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
:class:`~repro_torch.ckpt.versioning.ArtifactFormatError`.

Incremental deltas (streaming backends): :func:`save_index_delta` writes a
mutable-state snapshot — delta-tail leaves, tombstone bitmaps and the
monotone mutation ``seqno`` — as a ``delta_<seqno>`` sub-checkpoint inside
the base index directory.  Deltas are cumulative since the base's
compaction ``epoch``, and :func:`load_index` replays them in ascending
``seqno`` order (the zero-padded names sort lexically = numerically),
checking that seqnos strictly increase and that each delta's ``epoch`` is
the base's: a delta recorded before a compaction cannot apply to the
compacted base.  ``save_index_delta`` snapshots under the backend's
mutation lock, so one called while a background compaction is in flight
carries a coherent (``seqno``, ``epoch``) pair from one side of the fenced
swap.  Re-saving the base (``save_index`` replaces the directory) clears
its deltas.
"""
from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.ckpt.versioning import check_artifact_format

INDEX_META_KEY = "anns_index_meta"
INDEX_DELTA_META_KEY = "anns_index_delta_meta"

#: Format of :func:`save_index_delta` payloads (the envelope: meta keys,
#: replay rules).  The *leaves* inside are backend-owned, versioned by the
#: backend's ``state_format`` / ``epoch`` fields.
DELTA_FORMAT = 1


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


def save_index_delta(path: str, backend, *, extra: dict | None = None) -> str:
    """Write an incremental mutable-state delta under a base index dir.

    ``backend`` must implement the streaming protocol (``to_delta_dict``);
    the delta lands at ``path/delta_<seqno zero-padded>`` so lexical
    directory order is replay order.  Returns the delta directory.  A delta
    at a seqno that already exists is overwritten (same mutation state).
    """
    to_delta = getattr(backend, "to_delta_dict", None)
    if not callable(to_delta):
        raise TypeError(
            f"backend {getattr(backend, 'name', backend)!r} does not "
            f"support incremental deltas (no to_delta_dict); use a "
            f"streaming backend or save_index for a full snapshot")
    state = to_delta()
    arrays = {k: v for k, v in state.items() if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in state.items() if not isinstance(v, np.ndarray)}
    meta.setdefault("backend", backend.name)
    meta["delta_format"] = DELTA_FORMAT
    seqno = int(meta["seqno"])
    sub = os.path.join(path, f"delta_{seqno:012d}")
    save_checkpoint(sub, arrays, seqno,
                    extra={INDEX_DELTA_META_KEY: meta, **(extra or {})})
    return sub


def _replay_deltas(path: str, backend) -> None:
    """Replay ``path``'s ``delta_*`` sub-checkpoints onto ``backend`` in
    seqno order (see the module docstring for the checks)."""
    prev_seqno = None
    for sub in sorted(glob.glob(os.path.join(path, "delta_*"))):
        arrays, _step, extra = load_checkpoint(sub)
        dmeta = extra.get(INDEX_DELTA_META_KEY)
        if dmeta is None:
            raise KeyError(
                f"{sub!r} is not an index delta (missing "
                f"{INDEX_DELTA_META_KEY!r} in manifest extra)")
        dmeta = dict(dmeta)
        check_artifact_format(
            "delta", dmeta.get("delta_format"), DELTA_FORMAT,
            what=f"{sub!r}", hint="upgrade the serving host or re-save "
            "the base index")
        if dmeta.get("backend") not in (None, backend.name):
            raise ValueError(
                f"{sub!r} is a delta for backend {dmeta.get('backend')!r}, "
                f"but the base restored {backend.name!r}")
        apply_delta = getattr(backend, "apply_delta_dict", None)
        if not callable(apply_delta):
            raise ValueError(
                f"{path!r} carries checkpoint deltas, but restored "
                f"backend {backend.name!r} cannot replay them (no "
                f"apply_delta_dict) — the index was saved by a streaming "
                f"backend")
        seqno = int(dmeta.get("seqno", -1))
        if prev_seqno is not None and seqno <= prev_seqno:
            raise ValueError(
                f"{sub!r} has mutation seqno {seqno} <= the previously "
                f"replayed {prev_seqno} — the delta sequence is not "
                f"monotone; the checkpoint directory is corrupt")
        apply_delta({**arrays, **dmeta})
        prev_seqno = seqno


def load_index(path: str, variant=None, *, seed: int = 0, device="cuda"):
    """A backend on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``) holding the index saved at ``path``, with any
    ``delta_*`` sub-checkpoints (:func:`save_index_delta`) replayed in
    seqno order on top, to the exact live mutable state.  The backend
    comes from the checkpoint; ``variant`` overrides the saved search
    knobs' defaults."""
    from repro_torch.anns import registry
    from repro_torch.anns.engine import VariantConfig
    from repro_torch.anns.state import from_reference_state
    from repro_torch.device import resolve_device

    device = resolve_device(device)
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
    backend = from_reference_state({**arrays, **meta}, device,
                                   variant=variant, seed=seed)
    _replay_deltas(path, backend)
    return backend
