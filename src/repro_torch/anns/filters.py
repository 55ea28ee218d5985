"""Attribute filter predicates — the metadata half of filtered ANN search.

Real retrieval traffic is dominated by *filtered* queries: every vector
carries integer attribute columns (category, tenant, shard hint, ...) and
a query retrieves nearest neighbors **among the rows matching a
predicate**.  The predicate changes the ground truth, so it changes the
recall being measured — filtered evaluation must score against the
filtered gt (see ``Dataset.filtered_gt``), never the unfiltered one.

Design:

- :class:`FilterPredicate` — a frozen, hashable equality / categorical-set
  predicate over ONE integer attribute column (``attr=3`` or
  ``attr=3|5|7``).  Hashability matters: it rides inside
  :class:`~repro_torch.anns.api.SearchParams`, which the serving tier uses as a
  dict key and the tuner serializes into frontiers.
- ``predicate.mask(attrs)`` compiles it to a per-vector bool bitmask.
  Backends AND that mask into the validity masks they already carry (pad
  slots, tombstones), so the search keeps its shapes.
- :class:`AttributeColumns` — the backend mixin: ``set_attributes`` stores
  validated columns **in the backend's own storage order** (row order for
  brute force / graph; cell-major position order for the IVF family, via
  ``_attr_order``), with per-predicate mask caches on top.

Typed failure modes (the serving tier fails fast on all three):
:class:`EmptyPredicate` (a predicate that can match nothing),
:class:`UnknownAttribute` (no such column / no columns at all), and
:class:`AttributeMismatch` (column length or dtype does not fit the base).
All subclass :class:`FilterError` (a ``ValueError``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class FilterError(ValueError):
    """A malformed filter predicate or attribute table."""


class EmptyPredicate(FilterError):
    """The predicate's value set is empty — it can never match a row."""


class UnknownAttribute(FilterError):
    """The predicate names an attribute column the target does not hold."""


class AttributeMismatch(FilterError):
    """An attribute column's length / dtype does not fit the base."""


def check_attributes(attrs, n: int) -> dict:
    """Validate per-vector attribute columns against an ``n``-row base.

    Returns a normalized ``{name: (n,) int32}`` dict; raises
    :class:`AttributeMismatch` on anything else (non-dict, non-integer
    dtype, wrong rank, wrong length).
    """
    if not isinstance(attrs, dict) or not attrs:
        raise AttributeMismatch(
            "attributes must be a non-empty {name: (n,) int column} dict")
    out = {}
    for name, col in attrs.items():
        col = np.asarray(col)
        if col.dtype == object or not np.issubdtype(col.dtype, np.integer):
            raise AttributeMismatch(
                f"attribute column {name!r} has dtype {col.dtype} — "
                f"integer columns only")
        if col.ndim != 1:
            raise AttributeMismatch(
                f"attribute column {name!r} must be 1-D, got shape "
                f"{col.shape}")
        if len(col) != n:
            raise AttributeMismatch(
                f"attribute column {name!r} has {len(col)} rows but the "
                f"base holds {n} vectors")
        out[str(name)] = np.ascontiguousarray(col, np.int32)
    return out


@dataclass(frozen=True)
class FilterPredicate:
    """``attr IN values`` over one integer attribute column.

    Values are canonicalised to a sorted unique tuple, so two predicates
    matching the same rows compare (and hash) equal — the property every
    mask cache in the backends keys on.
    """
    attr: str
    values: tuple = ()

    def __post_init__(self):
        try:
            vals = tuple(sorted({int(v) for v in self.values}))
        except (TypeError, ValueError) as e:
            raise FilterError(
                f"filter values must be integers, got {self.values!r}") from e
        if not vals:
            raise EmptyPredicate(
                f"filter on {self.attr!r} has an empty value set — it can "
                f"never match a vector")
        object.__setattr__(self, "values", vals)

    # -- constructors ------------------------------------------------------
    @classmethod
    def eq(cls, attr: str, value: int) -> "FilterPredicate":
        """Equality predicate: ``attr == value``."""
        return cls(attr, (int(value),))

    @classmethod
    def isin(cls, attr: str, values) -> "FilterPredicate":
        """Categorical-set predicate: ``attr IN values``."""
        return cls(attr, tuple(int(v) for v in values))

    @classmethod
    def parse(cls, text: str) -> "FilterPredicate":
        """Parse the CLI grammar ``attr=v`` / ``attr=v1|v2|v3``."""
        attr, sep, rhs = str(text).partition("=")
        attr = attr.strip()
        if not sep or not attr:
            raise FilterError(
                f"cannot parse filter {text!r} — expected 'attr=v1|v2|...'")
        parts = [p.strip() for p in rhs.split("|") if p.strip()]
        try:
            vals = tuple(int(p) for p in parts)
        except ValueError as e:
            raise FilterError(
                f"cannot parse filter {text!r} — values must be "
                f"integers") from e
        return cls(attr, vals)

    # -- compilation -------------------------------------------------------
    def mask(self, attrs, n: int | None = None) -> np.ndarray:
        """Compile to a per-vector bool bitmask over ``attrs``' rows."""
        if not attrs:
            raise UnknownAttribute(
                f"filter on {self.attr!r} but no attribute columns are "
                f"set — call set_attributes() / build the dataset with "
                f"attributes")
        col = attrs.get(self.attr)
        if col is None:
            raise UnknownAttribute(
                f"unknown attribute {self.attr!r} — available columns: "
                f"{sorted(attrs)}")
        col = np.asarray(col)
        if n is not None and len(col) != n:
            raise AttributeMismatch(
                f"attribute column {self.attr!r} has {len(col)} rows but "
                f"the target holds {n} vectors")
        return np.isin(col, np.asarray(self.values, col.dtype))

    def selectivity(self, attrs) -> float:
        """Fraction of rows the predicate keeps (1.0 = unfiltered)."""
        return float(self.mask(attrs).mean())

    def describe(self) -> str:
        return f"{self.attr}=" + "|".join(str(v) for v in self.values)

    def __str__(self) -> str:          # CLI/log rendering
        return self.describe()


def parse_filter(text: str) -> FilterPredicate:
    """Module-level alias of :meth:`FilterPredicate.parse` (CLI entry)."""
    return FilterPredicate.parse(text)


def describe_filter(predicate) -> str:
    """Canonical string of a predicate, '' for None (serialization)."""
    return "" if predicate is None else predicate.describe()


def require_filterable(predicate, attributes) -> None:
    """Fail fast (typed) when ``predicate`` cannot run against a backend
    holding ``attributes`` — the submit-time check of the serving tier:
    a filtered operating point on a backend without the named column
    must be rejected at enqueue, not discovered inside a flushed batch.
    """
    if predicate is None:
        return
    if not isinstance(predicate, FilterPredicate):
        raise FilterError(
            f"params.filter must be a FilterPredicate, got "
            f"{type(predicate).__name__}")
    if not attributes:
        raise UnknownAttribute(
            f"served backend has no attribute columns — set_attributes() "
            f"before serving filtered params (filter: {predicate})")
    if predicate.attr not in attributes:
        raise UnknownAttribute(
            f"served backend has no attribute column {predicate.attr!r} "
            f"(available: {sorted(attributes)})")


# ---------------------------------------------------------------------------
# backend mixin
# ---------------------------------------------------------------------------

class AttributeColumns:
    """Per-vector attribute columns + per-predicate mask caches for
    read-only backends.

    ``attributes`` is stored in the backend's OWN storage order: callers
    hand ``set_attributes`` columns in build-row order, and backends
    whose layout permutes rows (the IVF family's cell-major positions)
    override ``_attr_order`` so the stored columns — and therefore every
    compiled mask — line up with the arrays the search actually scans.
    Checkpoint leaves (``attr/<col>``) carry this same order, matching
    the saved layout byte-for-byte.
    """

    attributes = None          # {name: (n,) int32} in storage order

    def set_attributes(self, attrs) -> None:
        """Attach validated columns to the *built* index (build first —
        a rebuild drops them; the columns describe one base layout)."""
        cols = check_attributes(attrs, self._attr_rows())
        order = self._attr_order()
        if order is not None:
            cols = {c: col[order] for c, col in cols.items()}
        self.attributes = cols
        self._clear_filter_caches()

    def _attr_rows(self) -> int:
        idx = self.index
        assert idx is not None, "build() first"
        n = getattr(idx, "n", None)
        return int(n) if n is not None else int(idx.shape[0])

    def _attr_order(self):
        """Storage permutation (build row -> storage row), None = identity."""
        return None

    def _clear_filter_caches(self) -> None:
        self._fmask_cache = {}
        self._fmask_dev = {}

    def _row_mask(self, predicate: FilterPredicate) -> np.ndarray:
        """(n,) bool bitmask in storage order, cached per predicate —
        attributes are immutable after ``set_attributes``, so a predicate
        compiles exactly once per backend."""
        if self.attributes is None:
            raise UnknownAttribute(
                f"{getattr(self, 'name', '?')} backend has no attribute "
                f"columns — call set_attributes() before filtered search")
        cache = getattr(self, "_fmask_cache", None)
        if cache is None:
            cache = self._fmask_cache = {}
        m = cache.get(predicate)
        if m is None:
            m = predicate.mask(self.attributes, self._attr_rows())
            cache[predicate] = m
        return m

    def _row_mask_dev(self, predicate: FilterPredicate):
        """Twin of :meth:`_row_mask` on the backend's ``device`` (what the
        search consumes), cached separately so repeated filtered searches
        re-upload nothing."""
        import torch
        cache = getattr(self, "_fmask_dev", None)
        if cache is None:
            cache = self._fmask_dev = {}
        m = cache.get(predicate)
        if m is None:
            m = torch.from_numpy(self._row_mask(predicate)).to(self.device)
            cache[predicate] = m
        return m

    # -- checkpoint helpers ------------------------------------------------
    def _attr_state_leaves(self) -> dict:
        if self.attributes is None:
            return {}
        return {f"attr/{c}": np.asarray(col)
                for c, col in self.attributes.items()}

    def _restore_attr_leaves(self, state: dict) -> None:
        cols = {k.split("/", 1)[1]: np.ascontiguousarray(v, np.int32)
                for k, v in state.items() if k.startswith("attr/")}
        self.attributes = cols or None
        self._clear_filter_caches()
