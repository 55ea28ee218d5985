"""The ANNS engine of the PyTorch/CUDA port (mirrors ``repro.anns``).

- :class:`repro_torch.anns.api.AnnsIndex` — the structural interface
  (``build`` / ``search`` / ``memory_bytes`` / ``to_state_dict`` /
  ``from_state_dict``) every algorithm family implements.
- :mod:`repro_torch.anns.registry` — string-keyed backend registry.
  Ported built-ins: ``"graph"`` (flat fixed-degree graph + lockstep
  batched beam search), ``"brute_force"`` (exact search through the CUDA
  distance / top-k kernels — the recall=1.0 anchor) and
  ``"quantized_prefilter"`` (int8 prefilter + fp32 rerank), ``"ivf"``
  (k-means cells scanned in int8 through the CUDA ``qdist`` kernel) and
  ``"sharded"`` (the ivf layout in whole-cell shards on one device).
- :class:`repro_torch.anns.api.SearchParams` / ``SearchResult`` — the
  typed request/response structs.
- :class:`repro_torch.anns.engine.Engine` — thin compatibility facade.
- :func:`repro_torch.anns.state.from_reference_state` — load a built
  index of the reference package onto a device.
"""
import importlib

from repro_torch.anns import registry

# Lazy exports (PEP 562), as in the reference: importing the package pulls
# in no backend or kernel module until one of its symbols is touched.
_EXPORTS = {
    "AnnsIndex": "repro_torch.anns.api",
    "SearchParams": "repro_torch.anns.api",
    "SearchResult": "repro_torch.anns.api",
    "Engine": "repro_torch.anns.engine",
    "VariantConfig": "repro_torch.anns.engine",
    "Dataset": "repro_torch.anns.datasets",
    "make_dataset": "repro_torch.anns.datasets",
    "DATASET_SPECS": "repro_torch.anns.datasets",
    "FilterPredicate": "repro_torch.anns.filters",
    "FilterError": "repro_torch.anns.filters",
    "EmptyPredicate": "repro_torch.anns.filters",
    "UnknownAttribute": "repro_torch.anns.filters",
    "AttributeMismatch": "repro_torch.anns.filters",
    "parse_filter": "repro_torch.anns.filters",
    "selectivity_filter": "repro_torch.anns.datasets",
    "filtered_recall_at_k": "repro_torch.anns.datasets",
    "from_reference_state": "repro_torch.anns.state",
}

__all__ = sorted(_EXPORTS) + ["registry"]


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
