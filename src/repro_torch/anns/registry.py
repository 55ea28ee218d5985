"""String-keyed backend registry for :class:`repro_torch.anns.api.AnnsIndex`.

Built-in backends are *lazy*: the registry knows their names and module
paths up front, but a backend module (and the kernels it pulls in) is
imported only when that backend is first requested, as in the reference.

Built-ins ported so far:

- ``"graph"``               — beam search over the flat fixed-degree graph.
- ``"brute_force"``         — exact search through the ``distance`` +
                              ``topk`` CUDA kernels; the recall=1.0 anchor
                              of every QPS-recall curve.
- ``"quantized_prefilter"`` — int8 graph prefilter + fp32 rerank.
- ``"ivf"``                 — k-means cells, int8 cell scans through the
                              ``qdist`` CUDA kernel, fp32 rerank.
- ``"sharded"``             — the ivf layout sliced into whole-cell shards,
                              unrolled on one device.

The reference's streaming families are not ported yet.

Adding a backend::

    from repro_torch.anns.registry import register

    @register("my_index")
    class MyBackend:
        name = "my_index"
        def __init__(self, variant=None, *, metric="l2", seed=0,
                     device=None):
            self.index = None          # built state (protocol attribute)
            ...
        def build(self, base): ...
        def search(self, queries, params): ...
        def memory_bytes(self): ...
        def to_state_dict(self): ...
        def from_state_dict(self, state): ...
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Type

_REGISTRY: Dict[str, type] = {}

# name -> defining module; importing the module runs its @register
# decorator, which fills _REGISTRY.
_BUILTIN_MODULES: Dict[str, str] = {
    "graph": "repro_torch.anns.backends.graph_beam",
    "brute_force": "repro_torch.anns.backends.brute_force",
    "quantized_prefilter": "repro_torch.anns.backends.quantized",
    "ivf": "repro_torch.anns.backends.ivf",
    "sharded": "repro_torch.anns.backends.sharded",
}


def register(name: str) -> Callable[[type], type]:
    """Class decorator: register ``cls`` under ``name`` (last write wins)."""
    def deco(cls: type) -> type:
        _REGISTRY[name] = cls
        if not getattr(cls, "name", None):
            cls.name = name
        return cls
    return deco


def get(name: str) -> Type:
    """Backend class for ``name``; raises KeyError listing known names.
    Lazily imports the defining module for built-ins on first use."""
    if name not in _REGISTRY and name in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[name])
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown ANNS backend {name!r}; registered: "
            f"{list(available())}") from None


def create(name: str, variant=None, *, metric: str = "l2", seed: int = 0,
           device=None):
    """Instantiate a backend by name (the one constructor shape all
    backends share: ``(variant, *, metric, seed, device)``).  ``device``
    defaults to ``cuda``; pass ``"cpu"`` to run on the CPU."""
    return get(name)(variant, metric=metric, seed=seed, device=device)


def available() -> tuple:
    """Sorted names of all registered + built-in backends (no imports)."""
    return tuple(sorted(set(_REGISTRY) | set(_BUILTIN_MODULES)))

