"""Offline half of the autotuner: turn the bench harness into frontiers.

:func:`sweep_frontier` runs :func:`repro_torch.anns.bench.qps_recall_curve`
over one or more backends at the efs their static ladders actually
distinguish (:func:`repro_torch.anns.api.search_ef_ladder` — the full
``EF_LADDER`` for the graph family, the ``NPROBE_LADDER``-derived efs
for ivf/sharded, a single anchor for brute force), prunes the result to
the Pareto-optimal set, and returns a serializable
:class:`~repro_torch.anns.tune.frontier.Frontier`.  Sweep once per (dataset,
build), then answer every SLO with
:func:`repro_torch.anns.tune.choose.choose` — no serving host re-measures.

Measurement is injectable (``measure_fn``) so the frontier *pipeline* is
testable deterministically: wall-clock QPS is inherently noisy, but
everything downstream of the measurement — params construction, point
ordering, pruning, serialization — must be byte-stable under equal
inputs (pinned by the golden test in ``tests/test_tune.py``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.anns.api import SearchParams, search_ef_ladder
from repro_torch.anns.tune.frontier import (Frontier, OperatingPoint,
                                            frontier_from_points)

#: families swept when the caller doesn't name backends: the general
#: graph frontier plus the partition family (brute_force contributes a
#: recall-1.0 anchor only when asked — it is never the SLO pick at scale)
DEFAULT_TUNE_BACKENDS = ("graph", "ivf")


def _measure(target, ds, params, repeats, build_seconds):
    from repro_torch.anns.bench import measure_point
    return measure_point(target, ds, params=params, repeats=repeats,
                         build_seconds=build_seconds)


def sweep_target(target, ds, *, k: int = 10, repeats: int = 2,
                 ef_cap: int | None = None, label: str = "",
                 build_seconds: float = 0.0, measure_fn=None,
                 filters=(None,)) -> list:
    """Sweep one *built* backend along its own effort ladder; returns raw
    (unpruned) :class:`OperatingPoint` rows.  ``measure_fn`` defaults to
    :func:`repro_torch.anns.bench.measure_point` (injectable for determinism
    tests).

    ``filters`` is the workload axis: each entry (a
    :class:`~repro_torch.anns.filters.FilterPredicate` or ``None`` for
    unfiltered) runs the whole ef ladder, and every resulting point is
    stamped with the predicate's selectivity (filtered points score
    against :meth:`~repro_torch.anns.datasets.Dataset.filtered_gt`).  The
    target must carry attribute columns (``set_attributes``) before a
    non-None filter is swept."""
    from repro_torch.anns.bench import sweep_params
    measure = measure_fn or _measure
    points = []
    for flt in filters:
        base = SearchParams(k=k, filter=flt)   # sweep_params keeps filter
        sel = 1.0 if flt is None else float(flt.selectivity(ds.attrs))
        for ef in search_ef_ladder(target, ef_cap=ef_cap):
            params = sweep_params(base, ef)
            pt = measure(target, ds, params, repeats, build_seconds)
            points.append(OperatingPoint(
                backend=getattr(target, "name", ""), params=params,
                recall=float(pt.recall), qps=float(pt.qps),
                p50_ms=float(pt.p50_ms),
                build_seconds=float(pt.build_seconds),
                memory_bytes=int(pt.memory_bytes),
                device_memory_bytes=int(pt.device_memory_bytes),
                label=label, selectivity=sel))
    return points


def sweep_frontier(ds, *, backends=DEFAULT_TUNE_BACKENDS, targets=(),
                   variants=None, k: int = 10, repeats: int = 2,
                   ef_cap: int | None = None, seed: int = 0,
                   measure_fn=None, meta: dict | None = None,
                   filters=(None,), device="cuda") -> Frontier:
    """Build the QPS/recall/memory Pareto frontier of a dataset.

    ``backends`` are registry names built here with their family-baseline
    variants (override per family via ``variants={name: VariantConfig}``);
    ``targets`` are *already built* backends swept as-is (the serving
    CLI's ``--tune`` path: tune exactly the deployment you hold).
    Backends built here go on ``device`` (default ``cuda``; raises without
    a card unless ``device="cpu"``).
    Either may be empty; sweeping nothing is an error — an empty frontier
    would make every SLO look infeasible for the wrong reason.

    ``filters`` adds the filtered-workload axis (see
    :func:`sweep_target`): when any entry is a predicate, backends built
    here get the dataset's attribute columns attached, and already-built
    ``targets`` without columns get them too.  Filtered and unfiltered
    points share the frontier but never dominate each other.

    The returned :class:`Frontier` records the dataset identity (name,
    sizes, seed) so a load-time mismatch is visible before a pick from
    it is trusted.
    """
    filtered = any(f is not None for f in filters)
    swept = []
    built = list(targets)
    if backends:
        from repro_torch.anns import registry
        from repro_torch.anns.bench import build_timed
        from repro_torch.anns.engine import family_baseline
        for name in backends:
            variant = (variants or {}).get(name)
            if variant is None:
                variant = dataclasses.replace(family_baseline(name),
                                              backend=name)
            b = registry.create(name, variant, metric=ds.metric, seed=seed,
                                device=device)
            build_s = build_timed(b, ds.base)
            swept.append((b, build_s))
    swept.extend((t, 0.0) for t in built)
    if not swept:
        raise ValueError("sweep_frontier with no backends and no targets "
                         "— nothing to measure")
    if filtered:
        for target, _ in swept:
            if getattr(target, "attributes", None) is None:
                target.set_attributes(ds.attrs)
    points = []
    for target, build_s in swept:
        points.extend(sweep_target(target, ds, k=k, repeats=repeats,
                                   ef_cap=ef_cap, build_seconds=build_s,
                                   measure_fn=measure_fn, filters=filters))
    return frontier_from_points(
        points, dataset=ds.spec.name, n_base=len(ds.base),
        n_query=len(ds.queries), k=k, seed=seed, meta=meta)


def frontier_from_curve(backend: str, curve, *, k: int = 10, label: str = "",
                        base_params: SearchParams | None = None) -> list:
    """Lift bench :class:`~repro_torch.anns.bench.CurvePoint` rows (which carry
    ``ef`` but not full params) into :class:`OperatingPoint` rows, via the
    same :func:`repro_torch.anns.bench.sweep_params` rule the sweep used — so a
    table3 run can emit a frontier artifact without re-measuring."""
    from repro_torch.anns.bench import sweep_params
    base = base_params or SearchParams(k=k)
    return [OperatingPoint(
        backend=backend, params=sweep_params(base, pt.ef),
        recall=float(pt.recall), qps=float(pt.qps), p50_ms=float(pt.p50_ms),
        build_seconds=float(pt.build_seconds),
        memory_bytes=int(pt.memory_bytes),
        device_memory_bytes=int(pt.device_memory_bytes), label=label,
        selectivity=float(getattr(pt, "selectivity", 1.0)))
        for pt in curve]
