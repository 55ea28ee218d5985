"""Engine facade + VariantConfig — the RL action space.

A :class:`VariantConfig` is one "implementation variant" in CRINN terms:
the decoded output of a policy completion (``repro.core.variant_space`` in
the reference) and the unit the speed reward evaluates.  Field groups correspond to the
paper's three sequentially-optimized modules (§3.1): graph construction,
search, refinement — plus ``backend``, which selects a whole algorithm
family from :mod:`repro_torch.anns.registry` (the axis that grows the action
space beyond graph knobs).

:class:`Engine` is a thin compatibility facade over the backend protocol:
``Engine(variant).build_index(base)`` then ``search(queries, k=…, ef=…)``
keeps working exactly as before, while new code talks to the backend
directly with :class:`~repro_torch.anns.api.SearchParams` /
:class:`~repro_torch.anns.api.SearchResult`.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch.anns import registry
from repro_torch.anns.api import SearchParams, SearchResult, effective_ef


@dataclass(frozen=True)
class VariantConfig:
    # -- backend family (registry key; the coarsest action dimension) -----
    backend: str = "graph"
    # -- graph construction module (§6.1) --------------------------------
    degree: int = 32                 # R: fixed out-degree
    ef_construction: int = 64        # candidate-pool breadth per round
    nn_descent_rounds: int = 4
    alpha: float = 1.2               # RobustPrune diversity (1.0 = off)
    num_entry_points: int = 1        # multi-entry architecture (1..9)
    adaptive_ef_coef: float = 0.0    # dynamic-EF scaling vs target recall
    # -- search module (§6.2) --------------------------------------------
    gather_width: int = 1            # g: beam entries expanded per step
    patience: int = 0                # 0 = off; else early-termination rounds
    # -- refinement module (§6.3) ----------------------------------------
    quantized_prefilter: bool = False
    rerank_factor: int = 2
    # -- ivf module (partition family; inert for graph backends) ---------
    nlist: int = 64                  # k-means cells
    nprobe: int = 8                  # cells probed at the default ef=64
    kmeans_iters: int = 8            # coarse-quantizer training iterations
    max_cell: int = 0                # 0 = off; else balanced-assignment cap
                                     # (oversized cells split at build)
    # -- sharded backend: device-mesh scale-out knob ---------------------
    n_shards: int = 1                # cell-granular shards of the layout
    # -- streaming backends (repro_torch.anns.stream) --------------------
    tail_cap: int = 256              # delta-tail capacity (per shard for
                                     # stream_sharded); 0 = default

    def __post_init__(self):
        # fail fast on unknown families: a typo'd backend name would
        # otherwise surface only when the first search runs.  The lazy
        # registry makes this check import-free.
        if self.backend not in registry.available():
            raise ValueError(
                f"unknown ANNS backend {self.backend!r}; registered: "
                f"{list(registry.available())}")

    def describe(self) -> str:
        return (f"[{self.backend}] R={self.degree} "
                f"efc={self.ef_construction} "
                f"rounds={self.nn_descent_rounds} a={self.alpha} "
                f"eps={self.num_entry_points} adEF={self.adaptive_ef_coef} "
                f"g={self.gather_width} pat={self.patience} "
                f"q8={int(self.quantized_prefilter)} rr={self.rerank_factor} "
                f"nlist={self.nlist} npr={self.nprobe} km={self.kmeans_iters} "
                f"mc={self.max_cell} sh={self.n_shards}")


# the paper's baseline (GLASS defaults, §3.5): single entry point, fixed ef,
# no batching/early-termination/quantization tricks.
GLASS_BASELINE = VariantConfig(
    backend="graph", degree=32, ef_construction=64, nn_descent_rounds=4,
    alpha=1.0, num_entry_points=1, adaptive_ef_coef=0.0, gather_width=1,
    patience=0, quantized_prefilter=False, rerank_factor=1)

# the partition-family analogue of GLASS: untuned FAISS-style IVF defaults
# (sqrt(N)-ish cells at bench scale, modest probe budget, plain rerank).
IVF_BASELINE = VariantConfig(
    backend="ivf", nlist=64, nprobe=8, kmeans_iters=8, rerank_factor=2)

# the sharded family's reference point: the same untuned IVF knobs split
# over two cell shards with the balanced-assignment cap off.
SHARDED_BASELINE = dataclasses.replace(IVF_BASELINE, backend="sharded",
                                       n_shards=2)

# One canonical baseline variant per ported backend family: the reference
# point each family's reward is normalised against.  Only registered
# families may appear (``__post_init__`` rejects the rest).
FAMILY_BASELINE_VARIANTS = {
    "graph": GLASS_BASELINE,
    "brute_force": dataclasses.replace(GLASS_BASELINE,
                                       backend="brute_force"),
    "quantized_prefilter": dataclasses.replace(
        GLASS_BASELINE, backend="quantized_prefilter", rerank_factor=2),
    "ivf": IVF_BASELINE,
    "sharded": SHARDED_BASELINE,
    # the streaming family serves the same layouts, mutable
    "stream_ivf": dataclasses.replace(IVF_BASELINE, backend="stream_ivf"),
    "stream_sharded": dataclasses.replace(SHARDED_BASELINE,
                                          backend="stream_sharded"),
}


def family_baseline(backend: str) -> VariantConfig:
    """Baseline variant for a backend family (GLASS knobs for unknown /
    third-party families, with the family's own backend key)."""
    try:
        return FAMILY_BASELINE_VARIANTS[backend]
    except KeyError:
        return dataclasses.replace(GLASS_BASELINE, backend=backend)


_ENGINE_DEPRECATION_EMITTED = False


def _warn_engine_deprecated():
    """One DeprecationWarning per process — not one per Engine(): the RL
    loop constructs hundreds of facades per run."""
    global _ENGINE_DEPRECATION_EMITTED
    if not _ENGINE_DEPRECATION_EMITTED:
        _ENGINE_DEPRECATION_EMITTED = True
        warnings.warn(
            "repro_torch.anns.engine.Engine is a compatibility facade; new code "
            "should create backends via repro_torch.anns.registry "
            "(registry.create(name, variant)) and call "
            "search(queries, SearchParams(...)) directly.",
            DeprecationWarning, stacklevel=3)


class Engine:
    """Compatibility facade: ``build_index()`` / ``search()`` with a
    VariantConfig — the module interface the paper's prompt template
    mandates (Table 1).  All real work is delegated to the registered
    :class:`~repro_torch.anns.api.AnnsIndex` backend named by
    ``variant.backend``."""

    def __init__(self, variant: VariantConfig, metric: str = "l2",
                 seed: int = 0, device=None):
        _warn_engine_deprecated()
        self.variant = variant
        self.metric = metric
        self.seed = seed
        self.backend = registry.create(
            getattr(variant, "backend", "graph") or "graph",
            variant=variant, metric=metric, seed=seed, device=device)

    # the built state lives on the backend; expose it read/write so legacy
    # callers (tests, the RL index cache) can keep sharing/patching it.
    @property
    def index(self):
        return self.backend.index

    @index.setter
    def index(self, value):
        self.backend.index = value

    def build_index(self, base: np.ndarray):
        return self.backend.build(base)

    def effective_ef(self, ef: int, target_recall: float = 0.0) -> int:
        """Paper §6.1: dynamic-EF scaling above a critical recall (raw,
        unbucketed value — the backend snaps it to the static ladder)."""
        return effective_ef(ef, target_recall, self.variant.adaptive_ef_coef)

    def search(self, queries, k: int, ef: int, target_recall: float = 0.0):
        """Legacy kwarg API: returns ``(ids, dists)``."""
        res = self.query(queries,
                         SearchParams(k=k, ef=ef, target_recall=target_recall))
        return res.ids, res.dists

    def query(self, queries, params: SearchParams) -> SearchResult:
        """Typed API: the backend search with full telemetry."""
        return self.backend.search(queries, params)

    def memory_bytes(self) -> int:
        return self.backend.memory_bytes()

    def with_variant(self, **overrides) -> "Engine":
        eng = Engine(dataclasses.replace(self.variant, **overrides),
                     self.metric, self.seed, device=self.backend.device)
        if eng.variant.backend == self.variant.backend:
            # same family => the built state is reusable; a different
            # backend needs its own build_index() call
            eng.index = self.index
        return eng
