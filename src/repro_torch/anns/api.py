"""The ANNS backend API: typed search parameters + the ``AnnsIndex`` protocol.

CRINN treats the ANNS implementation as a *search space* — the RL loop
mutates variants and rewards wall-clock QPS at fixed recall — so the
engine must be able to swap whole algorithm families behind one interface
(the ann-benchmarks lesson) and expose a *typed* parameter space the
optimizer can enumerate (the ScaNN auto-configuration lesson).

Three pieces:

- :class:`SearchParams` — one frozen struct replacing the ``ef`` / ``k`` /
  ``gather_width`` / ``patience`` / ``quantized`` / ``rerank`` kwarg soup
  that previously leaked through four layers.  Backend-specific knobs
  default to ``None`` = "use the backend's variant config"; the resolved
  defaults reproduce the legacy kwarg defaults bit-for-bit.
- :class:`SearchResult` — ids/dists plus traversal telemetry.
- :class:`AnnsIndex` — the structural protocol every backend implements.
  Backends register under a string key in :mod:`repro_torch.anns.registry`;
  ``VariantConfig.backend`` selects one, which grows the RL action space
  beyond graph knobs.

The ladder helpers live here too: :func:`round_ef` / :func:`round_steps`
snap derived integer knobs onto the same small static ladders as the
reference, so the port searches with the same ``ef`` and step cap.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np
import torch

# ---------------------------------------------------------------------------
# static ladders (the reference's jit buckets; the port keeps them so it
# searches with the same ef and step cap)
# ---------------------------------------------------------------------------

# Geometric ~1.5x ladder covering every sweep value the benchmarks use.
# Derived efs (adaptive-EF scaling produces arbitrary ints) snap up to the
# next rung.
EF_LADDER = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)

# The beam search's step cap, bucketed the same way (the loop exits early
# once no row is active, so a larger cap never changes the results of a
# converged search).
STEP_LADDER = (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def snap_to_ladder(value: int, ladder: tuple, overflow_step: int) -> int:
    """Smallest ladder rung >= value; multiples of ``overflow_step`` past
    the ladder's end.  One policy for every bucketed knob (ef, max_steps,
    the IVF backend's nprobe) so a ladder change lands everywhere."""
    for v in ladder:
        if value <= v:
            return v
    return ((value + overflow_step - 1) // overflow_step) * overflow_step


def round_ef(ef: int) -> int:
    """Smallest ladder rung >= ef (multiples of 128 past the ladder)."""
    return snap_to_ladder(ef, EF_LADDER, 128)


def snap_down_to_ladder(value: int, ladder: tuple) -> int:
    """Largest ladder rung <= value; ``value`` itself below the ladder.

    The downward twin of :func:`snap_to_ladder`, for knobs bounded from
    *above* by live state: clamping batched ``k`` to the index size lands
    on a rung, as in the reference.
    """
    best = None
    for v in ladder:
        if v <= value:
            best = v
        else:
            break
    return best if best is not None else max(1, value)


def round_steps(steps: int) -> int:
    """Smallest step-ladder rung >= steps (multiples of 256 past it)."""
    return snap_to_ladder(steps, STEP_LADDER, 256)


def search_ef_ladder(backend, *, ef_cap: int | None = None) -> tuple:
    """The ef values worth sweeping for ``backend`` — its static effort
    ladder, introspected.

    Backends expose a ``search_ef_ladder()`` method when the universal
    ``ef`` knob maps onto a family-specific ladder (brute force is
    effort-free and returns a single point); graph-family backends
    default to :data:`EF_LADDER`.

    ``ef_cap`` trims the top of the ladder; at least one rung always
    survives.
    """
    fn = getattr(backend, "search_ef_ladder", None)
    ladder = tuple(fn()) if callable(fn) else EF_LADDER
    if ef_cap is not None:
        capped = tuple(e for e in ladder if e <= ef_cap)
        ladder = capped or ladder[:1]
    return ladder


# ---------------------------------------------------------------------------
# parameter / result structs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SearchParams:
    """One search request: what to retrieve and how hard to try.

    ``k`` / ``ef`` / ``target_recall`` are universal; the remaining fields
    are graph-family knobs that default to ``None`` meaning "take the value
    from the backend's :class:`~repro_torch.anns.engine.VariantConfig`".  With no
    variant either (``resolved(None)``) they fall back to the historical
    ``repro_torch.anns.search.search`` kwarg defaults.

    ``filter`` (a frozen, hashable
    :class:`~repro_torch.anns.filters.FilterPredicate`, or ``None`` for
    unfiltered) restricts retrieval to the vectors matching an attribute
    predicate; every backend compiles it to a per-vector bitmask AND-ed
    into the validity masks already guarding pad slots and tombstones.
    Slots without a matching vector come back as id ``-1``.
    """
    k: int = 10
    ef: int = 64
    target_recall: float = 0.0
    gather_width: Optional[int] = None
    patience: Optional[int] = None
    quantized: Optional[bool] = None
    rerank_factor: Optional[int] = None
    filter: Optional[Any] = None       # FilterPredicate | None

    # legacy kwarg defaults of repro_torch.anns.search.search (pre-registry API)
    _FALLBACK = {"gather_width": 1, "patience": 0, "quantized": False,
                 "rerank_factor": 2}

    def resolved(self, variant=None) -> "SearchParams":
        """Fill ``None`` fields from ``variant`` (or legacy defaults)."""
        updates = {}
        for name in ("gather_width", "patience", "quantized", "rerank_factor"):
            if getattr(self, name) is not None:
                continue
            if variant is not None:
                vname = {"quantized": "quantized_prefilter"}.get(name, name)
                updates[name] = getattr(variant, vname)
            else:
                updates[name] = self._FALLBACK[name]
        return dataclasses.replace(self, **updates) if updates else self

    def replace(self, **overrides) -> "SearchParams":
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class SearchResult:
    """Batched k-NN answer plus traversal telemetry.

    ``steps`` / ``expansions`` are 0 for single-shot (non-iterative)
    backends such as brute force.
    """
    ids: torch.Tensor       # (B, k) int32
    dists: torch.Tensor     # (B, k) fp32, ascending
    steps: Any = 0          # while-loop iterations (scalar)
    expansions: Any = 0     # total beam expansions (scalar)
    backend: str = ""

    @property
    def k(self) -> int:
        return int(self.ids.shape[-1])


def effective_ef(ef: int, target_recall: float, adaptive_coef: float,
                 critical: float = 0.9) -> int:
    """Paper §6.1 dynamic-EF scaling: widen the beam above a critical
    recall target.  Callers on the hot path should snap the result with
    :func:`round_ef` — this function returns the raw scaled value."""
    if adaptive_coef > 0 and target_recall > critical:
        excess = target_recall - critical
        return int(ef * (1.0 + excess * adaptive_coef))
    return ef


# ---------------------------------------------------------------------------
# backend protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class AnnsIndex(Protocol):
    """Structural interface every registered backend implements.

    Lifecycle: construct with a ``VariantConfig`` (or ``None`` for backend
    defaults), ``build(base)`` once, then ``search(queries, params)`` any
    number of times.  ``to_state_dict``/``from_state_dict`` round-trip the
    built state through plain numpy for checkpointing / shipping to
    another host.

    ``index`` holds the built state (``None`` before ``build``).  It is
    part of the protocol because the Engine facade and the RL index cache
    share/patch built state through it.
    """

    name: str
    index: Any

    def build(self, base: np.ndarray) -> Any:
        """Build index state from (N, d) base vectors; returns the state."""
        ...

    def search(self, queries, params: SearchParams) -> SearchResult:
        """Batched k-NN over (B, d) queries."""
        ...

    def memory_bytes(self) -> int:
        """Resident bytes of the built index state."""
        ...

    def to_state_dict(self) -> dict:
        """Serializable (numpy) snapshot of the built state."""
        ...

    def from_state_dict(self, state: dict) -> None:
        """Restore a snapshot produced by :meth:`to_state_dict`."""
        ...


@runtime_checkable
class MutableAnnsIndex(AnnsIndex, Protocol):
    """A backend that stays correct under online mutation.

    The streaming contract (the reference's ``repro.anns.stream``, not
    ported yet): ``insert`` lands new vectors in a fixed-capacity fp32
    delta tail scanned exactly alongside the built structure, ``delete`` tombstones ids through the
    same validity mask that already guards pad slots (a tombstoned id can
    never appear in a :class:`SearchResult`), and ``compact`` folds the
    tail back into the built layout deterministically.  ``seqno`` is the
    monotone mutation counter checkpoint deltas are ordered by; ``epoch``
    counts compactions (a delta only replays onto the base epoch it was
    recorded against).
    """

    seqno: int
    epoch: int

    def insert(self, vectors, ids=None) -> np.ndarray:
        """Add (m, d) vectors; returns their (m,) int32 ids (assigned
        sequentially when ``ids`` is None).  Raises when the delta tail
        is full — call :meth:`compact` first."""
        ...

    def delete(self, ids) -> int:
        """Tombstone ids (base or tail); returns how many were newly
        tombstoned.  Unknown / already-deleted ids are ignored."""
        ...

    def compact(self) -> None:
        """Fold the tail into the built layout and drop tombstones.
        Deterministic: the same mutation history always yields the same
        bytes.  Bumps ``epoch``."""
        ...

    def n_live(self) -> int:
        """Vectors currently visible to search (base minus tombstones
        plus live tail)."""
        ...

    def tail_fraction(self) -> float:
        """Live tail entries / ``n_live()`` — the drift/compaction
        trigger quantity (tail scans are exact but O(tail))."""
        ...

