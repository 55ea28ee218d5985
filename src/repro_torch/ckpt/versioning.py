"""Artifact format versioning: the one fail-fast check every loader shares.

Three artifact families carry a format stamp — index checkpoints
(``state_format``, per backend), index checkpoint *deltas*
(``delta_format``, see :mod:`repro_torch.ckpt.index_io`), and swept frontiers
(``frontier_format``, see :mod:`repro_torch.ckpt.frontier_io`).  All three obey
the same convention: the payload records the format it was written in,
the installed code declares the newest format it understands, and a
loader meeting a *newer* stamp must raise a typed error naming both
numbers — never fall through to a ``KeyError`` on leaves it has never
heard of, and never silently drop fields it doesn't recognize.

This module is stdlib-only so the jax-free artifact layers (the tuner's
frontier model, CLI validation paths) can use it without paying kernel
import time.
"""
from __future__ import annotations


class ArtifactFormatError(ValueError):
    """An artifact's declared format is newer than this code understands.

    ``found``/``supported`` carry the two format numbers so callers can
    report or branch without re-parsing the message.  Subclasses
    ``ValueError`` — every pre-existing caller catching the loaders'
    ValueErrors keeps working.
    """

    def __init__(self, msg: str, *, kind: str, found: int, supported: int):
        super().__init__(msg)
        self.kind = kind
        self.found = int(found)
        self.supported = int(supported)


class StaleArtifactError(ValueError):
    """An epoch-stamped artifact describes an older (or foreign) state
    of a mutating index than the one being served.

    Format versioning (:class:`ArtifactFormatError`) answers "can this
    code read these bytes"; this answers "do these *numbers* still hold"
    — a frontier swept at mutation epoch 2 measured a layout that a
    compaction at epoch 3 no longer serves.  ``found_epoch`` /
    ``current_epoch`` carry both stamps for callers that branch.
    """

    def __init__(self, msg: str, *, kind: str, found_epoch: int,
                 current_epoch: int):
        super().__init__(msg)
        self.kind = kind
        self.found_epoch = int(found_epoch)
        self.current_epoch = int(current_epoch)


def check_artifact_age(kind: str, found_epoch, current_epoch, *,
                       max_age: int = 0, what: str = "",
                       hint: str = "") -> int | None:
    """Age-out policy for epoch-stamped artifacts.

    Returns ``current_epoch - found_epoch`` (how many compactions the
    artifact has missed), or ``None`` when either side is unstamped —
    an artifact from a pre-epoch writer, or a read-only target, has no
    age to enforce.  Raises :class:`StaleArtifactError` when the age
    exceeds ``max_age``, and *always* when the age is negative: an
    artifact stamped with a future epoch belongs to a different
    mutation history, not an older one.
    """
    if found_epoch is None or current_epoch is None:
        return None
    age = int(current_epoch) - int(found_epoch)
    if 0 <= age <= int(max_age):
        return age
    rel = ("a future epoch" if age < 0
           else f"{age} compaction(s) behind")
    msg = (f"{what or kind} was recorded at mutation epoch "
           f"{int(found_epoch)}, but the index is at epoch "
           f"{int(current_epoch)} ({rel})")
    if hint:
        msg += f" — {hint}"
    raise StaleArtifactError(msg, kind=kind, found_epoch=int(found_epoch),
                             current_epoch=int(current_epoch))


def check_artifact_format(kind: str, found, supported: int, *,
                          what: str = "", hint: str = "") -> None:
    """Raise :class:`ArtifactFormatError` iff ``found`` is newer than
    ``supported``.

    ``kind`` names the stamp ("state", "delta", "frontier"); ``what``
    describes the artifact for the message (defaults to the kind);
    ``hint`` suggests the fix.  ``found`` may be ``None`` (an unstamped
    v1 artifact) — that always passes.
    """
    if found is None:
        return
    if int(found) <= int(supported):
        return
    msg = (f"{what or kind} is in {kind} format {int(found)}, newer than "
           f"the supported {int(supported)}")
    if hint:
        msg += f" — {hint}"
    raise ArtifactFormatError(msg, kind=kind, found=int(found),
                              supported=int(supported))
