"""Built-in :class:`repro_torch.anns.api.AnnsIndex` backends.

Backend classes are exposed lazily (PEP 562): accessing e.g.
``backends.GraphBeamBackend`` imports only that backend's module, and the
registry itself never imports this package eagerly.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "GraphBeamBackend": "repro_torch.anns.backends.graph_beam",
    "BruteForceBackend": "repro_torch.anns.backends.brute_force",
    "QuantizedPrefilterBackend": "repro_torch.anns.backends.quantized",
    "IvfBackend": "repro_torch.anns.backends.ivf",
    "ShardedBackend": "repro_torch.anns.backends.sharded",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value          # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
