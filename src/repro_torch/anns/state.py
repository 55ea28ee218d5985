"""Carry a built index across from the reference package.

The reference's ``to_state_dict()`` returns plain numpy leaves, so the
port can search the very index the reference built: the same graph
(neighbors, entry points, int8 codes; state format 2) or the same IVF
cells (ivf format 2; sharded format 3, whose v1 and v2 snapshots load
too), with ``attr/<col>`` leaves for attribute columns.
"""
from __future__ import annotations

from repro_torch.anns import registry


def from_reference_state(state: dict, device=None, *, variant=None,
                         seed: int = 0):
    """A port backend holding ``state`` (a ``to_state_dict()`` snapshot of
    either package, unchanged) on ``device``; the backend class comes from
    ``state["backend"]``.  Pass the reference backend's ``variant`` so the
    search knobs it resolves match."""
    backend = registry.create(state["backend"], variant,
                              metric=state["metric"], seed=seed,
                              device=device)
    backend.from_state_dict(state)
    return backend
