"""Ship swept Pareto frontiers as versioned JSON (the reference's
``repro.ckpt.frontier_io``, on the port).

``serve --save-frontier`` / ``--load-frontier`` move a frontier as
``--save-index`` / ``--load-index`` move an index.  The JSON is
byte-deterministic (sorted keys, indent 2, atomic replace), so equal
frontiers give equal files, and it is the reference's byte for byte.
The payload stamps ``frontier_format``; a newer one fails fast.  A
frontier swept over a mutable index carries its mutation ``epoch`` in
``meta``, and :func:`load_frontier` ages it out against the serving
index's epoch (refuse past ``max_epoch_age``, warn on any lag).
"""
from __future__ import annotations

import json
import os
import warnings

from repro_torch.ckpt.versioning import StaleArtifactError, check_artifact_age


def frontier_json(frontier) -> str:
    """Canonical JSON text of a frontier (sorted keys, indent 2)."""
    return json.dumps(frontier.to_json_dict(), sort_keys=True, indent=2)


def save_frontier(path: str, frontier) -> str:
    """Write ``frontier`` to ``path`` atomically; returns ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(frontier_json(frontier))
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_frontier(path: str, *, current_epoch: int | None = None,
                  max_epoch_age: int = 0, stale_ok: bool = False):
    """The :class:`~repro_torch.anns.tune.frontier.Frontier` at ``path``
    (:func:`save_frontier` output).  Raises ``ValueError`` on a file that
    is no frontier or whose ``frontier_format`` is newer than the tuner's.

    ``current_epoch`` (the serving index's mutation epoch) turns on the
    age-out: a frontier more than ``max_epoch_age`` compactions old
    raises :class:`~repro_torch.ckpt.versioning.StaleArtifactError` (a
    warning with ``stale_ok``); one behind within the allowance warns.
    Unstamped frontiers have no age and always load.
    """
    from repro_torch.anns.tune.frontier import Frontier

    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or "frontier_format" not in payload:
        raise ValueError(
            f"{path!r} is not a frontier artifact (missing "
            f"'frontier_format'); expected save_frontier output")
    frontier = Frontier.from_json_dict(payload)
    if current_epoch is not None:
        found = frontier.meta.get("epoch")
        hint = ("re-sweep against the live index "
                "(resweep_and_choose / serve --tune) or pass "
                "stale_ok to serve it anyway")
        try:
            age = check_artifact_age(
                "frontier", found, current_epoch,
                max_age=max_epoch_age, what=f"frontier {path!r}",
                hint=hint)
        except StaleArtifactError:
            if not stale_ok:
                raise
            warnings.warn(
                f"frontier {path!r} (epoch {found}) is stale for the "
                f"index at epoch {current_epoch}; serving it anyway "
                f"(stale_ok) — its measured recall/QPS may not hold",
                stacklevel=2)
        else:
            if age is not None and age > 0:
                warnings.warn(
                    f"frontier {path!r} is {age} compaction(s) behind "
                    f"the index (epoch {found} vs {current_epoch}); "
                    f"within max_epoch_age={max_epoch_age} but its "
                    f"numbers were measured on an older layout",
                    stacklevel=2)
    return frontier
