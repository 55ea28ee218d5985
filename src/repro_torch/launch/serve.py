"""Serving driver of the port: build an ANNS index with a variant config
and serve batched queries through :class:`AnnsServer`.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --dataset sift-128-euclidean --n-base 1000000 --n-query 10000 \
        --n-requests 2048 --ef 64 --backend brute_force
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sharded \
        --n-shards 2 --nlist 1024 --n-base 1000000 --n-query 10000

Runs on the CUDA card unless ``--device cpu`` is given.  The printed
``served … QPS`` and ``recall@k=`` lines match ``repro.launch.serve``.
``--n-shards`` unrolls the shards on the one device.

Built indexes ship without a rebuild: ``--save-index DIR`` checkpoints
the built state, ``--load-index DIR`` restores it (the backend comes from
the checkpoint), in the JAX package's format both ways.  Operating points
ship the same way: ``--tune`` sweeps the served backend's effort ladder
into a Pareto frontier, ``--save-frontier`` / ``--load-frontier`` move it
as JSON, and ``--target-recall R`` (with ``--memory-budget-mb M``) serves
the frontier's max-QPS pick meeting R instead of ``--ef``::

    serve --backend ivf --tune --save-frontier f.json          # bench host
    serve --backend ivf --load-frontier f.json --target-recall 0.9

``--filter EXPR`` serves every request under an attribute predicate;
``--filter-demo`` runs the scripted unfiltered-vs-filtered episode at
three selectivities (greppable ``filter:`` lines).  The reference's
streaming, drift and async flags come with their slices.
"""
from __future__ import annotations

import argparse
import time


def _shard_conflict_note(target, n_shards) -> str | None:
    """Warning line for ``--load-index`` with ``--n-shards``, safe for
    every backend: the shard count is build identity, so a restored
    index keeps its own (a sharded checkpoint's count, or no shard axis
    at all)."""
    if not n_shards:
        return None
    ckpt_shards = getattr(getattr(target, "index", None), "n_shards", None)
    if ckpt_shards is None:
        return (f"note: --n-shards {n_shards} ignored — restored "
                f"{getattr(target, 'name', '?')!r} index has no shard axis")
    if int(ckpt_shards) != int(n_shards):
        return (f"note: --n-shards {n_shards} ignored — the shard "
                f"count is build identity; checkpoint carries "
                f"n_shards={int(ckpt_shards)}")
    return None


def _memory_line(target) -> str:
    """Resident-footprint fragment: total, plus the worst per-device bound
    where the backend distinguishes them (sharded)."""
    total = target.memory_bytes()
    dev = getattr(target, "device_memory_bytes", target.memory_bytes)()
    if dev != total:
        return (f"{total/1e6:.1f} MB total, "
                f"{dev/1e6:.1f} MB/device when mesh-placed")
    return f"{total/1e6:.1f} MB resident"


def _run_filter_demo(target, ds, args) -> dict:
    """Scripted filtered-serving episode (greppable ``filter:`` lines): one
    unfiltered window, then the same request stream under predicates at
    three selectivities, each scored against the filtered exact ground
    truth.  Returns {selectivity: recall} (1.0 for the unfiltered
    window)."""
    import dataclasses

    import numpy as np
    from repro_torch.anns import SearchParams
    from repro_torch.anns.datasets import (filtered_recall_at_k, recall_at_k,
                                           selectivity_filter)
    from repro_torch.runtime.server import AnnsServer

    k = args.k
    rng = np.random.default_rng(0)
    order = rng.integers(0, len(ds.queries), size=args.n_requests)

    def episode(params, gt, scorer):
        server = AnnsServer(target, max_batch=args.max_batch, params=params)
        t0 = time.time()
        for i in order:
            server.submit(ds.queries[i])
        responses = server.run()
        dt = time.time() - t0
        found = np.stack([r.ids for r in responses])
        return scorer(found, gt[order]), len(responses) / dt

    base = SearchParams(k=k, ef=args.ef)
    rec, qps = episode(base, ds.gt, lambda f, g: recall_at_k(f, g, k))
    print(f"filter: unfiltered recall@{k}={rec:.3f} qps={qps:,.0f}")
    out = {1.0: rec}
    for sel in (0.5, 0.1, 0.02):
        pred = selectivity_filter(ds, sel)
        fgt = ds.filtered_gt(pred, k=k)
        rec, qps = episode(dataclasses.replace(base, filter=pred), fgt,
                           lambda f, g: filtered_recall_at_k(f, g, k))
        got = pred.selectivity(ds.attrs)
        print(f"filter: selectivity={got:.3f} "
              f"({pred.attr} in {len(pred.values)} values) "
              f"recall@{k}={rec:.3f} qps={qps:,.0f} "
              f"(scored vs filtered gt)")
        out[got] = rec
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sift-128-euclidean")
    ap.add_argument("--n-base", type=int, default=5000)
    ap.add_argument("--n-query", type=int, default=128)
    ap.add_argument("--n-requests", type=int, default=256)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--backend", default="graph",
                    help="ANNS backend name (see repro_torch.anns.registry)")
    ap.add_argument("--n-shards", type=int, default=None,
                    help="cell-granular shard count (sharded backend), "
                         "unrolled on the one device")
    ap.add_argument("--nlist", type=int, default=None,
                    help="k-means cell count (ivf-family backends)")
    ap.add_argument("--optimized", action="store_true",
                    help="serve the CRINN-optimized variant instead of GLASS")
    ap.add_argument("--save-index", metavar="DIR", default=None,
                    help="checkpoint the built index state to DIR")
    ap.add_argument("--load-index", metavar="DIR", default=None,
                    help="serve a previously checkpointed index from DIR "
                         "(no rebuild; overrides --backend)")
    # -- autotuning / SLO mode (repro_torch.anns.tune) ---------------------
    ap.add_argument("--tune", action="store_true",
                    help="sweep the served backend's effort ladder into a "
                         "Pareto frontier before serving")
    ap.add_argument("--tune-repeats", type=int, default=1,
                    help="bench repeats per frontier point (sweep cost "
                         "knob; 1 is fine for operating-point selection)")
    ap.add_argument("--tune-ef-cap", type=int, default=None,
                    help="cap the swept effort ladder at this ef (--tune "
                         "sweep-cost knob)")
    ap.add_argument("--save-frontier", metavar="FILE", default=None,
                    help="write the swept/loaded frontier JSON to FILE")
    ap.add_argument("--load-frontier", metavar="FILE", default=None,
                    help="reuse a frontier swept elsewhere (no re-sweep; "
                         "mutually exclusive with --tune)")
    ap.add_argument("--frontier-label", default=None,
                    help="restrict a loaded frontier to points with this "
                         "provenance label (a pick is only valid for the "
                         "matching build)")
    ap.add_argument("--target-recall", type=float, default=None,
                    help="serve in SLO mode: pick max-QPS params with "
                         "recall >= this from the frontier instead of --ef")
    ap.add_argument("--memory-budget-mb", type=float, default=None,
                    help="SLO memory constraint: the pick's per-device "
                         "resident bytes must fit this budget")
    # -- filtered search (repro_torch.anns.filters) ------------------------
    ap.add_argument("--filter", default=None, metavar="EXPR",
                    help="serve filtered queries: 'attr=v' or "
                         "'attr=v1|v2|...' over the dataset's attribute "
                         "columns; recall is scored against the filtered "
                         "ground truth")
    ap.add_argument("--filter-demo", action="store_true",
                    help="run the scripted filtered-serving episode: an "
                         "unfiltered anchor window, then the same "
                         "traffic at three predicate selectivities "
                         "(greppable 'filter:' markers)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.tune and args.load_frontier:
        ap.error("--tune re-sweeps, --load-frontier reuses: pick one")
    if args.save_frontier and not (args.tune or args.load_frontier):
        ap.error("--save-frontier needs a frontier (--tune or "
                 "--load-frontier)")
    if args.target_recall is not None and not (args.tune
                                               or args.load_frontier):
        ap.error("--target-recall is frontier-driven: add --tune (sweep "
                 "now) or --load-frontier FILE (reuse a sweep)")
    if args.memory_budget_mb is not None and args.target_recall is None:
        ap.error("--memory-budget-mb only constrains an SLO pick; add "
                 "--target-recall")
    if args.filter and args.target_recall is not None:
        ap.error("--filter serves explicit params; a filtered SLO pick "
                 "needs a frontier swept under the same predicate "
                 "(tune.sweep_frontier filters=...)")

    import dataclasses

    import numpy as np
    from repro_torch import ckpt
    from repro_torch.anns import SearchParams, make_dataset, registry
    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.anns.engine import GLASS_BASELINE, VariantConfig
    from repro_torch.device import resolve_device
    from repro_torch.runtime.server import AnnsServer

    if args.backend not in registry.available():
        ap.error(f"unknown backend {args.backend!r}; "
                 f"registered: {registry.available()}")
    device = resolve_device(args.device)

    ds = make_dataset(args.dataset, n_base=args.n_base, n_query=args.n_query,
                      device=device)
    variant = GLASS_BASELINE
    if args.optimized:
        variant = VariantConfig(alpha=1.2, num_entry_points=3,
                                gather_width=2, patience=4,
                                adaptive_ef_coef=14.5)
    variant = dataclasses.replace(variant, backend=args.backend)
    if args.n_shards:
        variant = dataclasses.replace(variant, n_shards=args.n_shards)
    if args.nlist:
        variant = dataclasses.replace(variant, nlist=args.nlist)
    if args.load_index:
        t0 = time.time()
        target = ckpt.load_index(args.load_index, device=device)
        print(f"restored {target.name!r} index from {args.load_index} "
              f"onto {device} in {time.time()-t0:.1f}s "
              f"({_memory_line(target)}, no rebuild)")
        note = _shard_conflict_note(target, args.n_shards)
        if note:
            print(note)
    else:
        print(f"building index ({variant.describe()}) on {device} ...")
        t0 = time.time()
        target = registry.create(args.backend, variant, metric=ds.metric,
                                 device=device)
        target.build(ds.base)
        print(f"built in {time.time()-t0:.1f}s ({_memory_line(target)})")
        if args.save_index:
            ckpt.save_index(args.save_index, target)
            print(f"index state checkpointed to {args.save_index}")

    if (args.filter or args.filter_demo) and target.attributes is None:
        # a restored index may carry its columns (attr/<col> leaves)
        target.set_attributes(ds.attrs)
        print(f"attribute columns attached: {sorted(ds.attrs)}")
    if args.filter_demo:
        return _run_filter_demo(target, ds, args)

    frontier = None
    if args.load_frontier:
        frontier = ckpt.load_frontier(args.load_frontier)
        print(f"loaded {frontier.describe()} from {args.load_frontier}")
        if args.frontier_label is not None:
            pts = tuple(p for p in frontier.points
                        if p.label == args.frontier_label)
            if not pts:
                ap.error(f"frontier has no points labeled "
                         f"{args.frontier_label!r}; labels present: "
                         f"{sorted({p.label for p in frontier.points})}")
            frontier = dataclasses.replace(frontier, points=pts)
        if (frontier.dataset, frontier.n_base) != (args.dataset,
                                                   args.n_base):
            print(f"note: frontier was swept on {frontier.dataset} "
                  f"n_base={frontier.n_base}, serving "
                  f"{args.dataset} n_base={args.n_base} — its measured "
                  f"recall/QPS may not transfer")
    elif args.tune:
        from repro_torch.anns.tune import sweep_frontier
        t0 = time.time()
        frontier = sweep_frontier(ds, backends=(), targets=[target],
                                  k=args.k, repeats=args.tune_repeats,
                                  ef_cap=args.tune_ef_cap)
        print(f"swept {frontier.describe()} in {time.time()-t0:.1f}s")
    if args.save_frontier and frontier is not None:
        ckpt.save_frontier(args.save_frontier, frontier)
        print(f"frontier saved to {args.save_frontier}")

    if args.target_recall is not None:
        from repro_torch.anns.tune import RecallSLO
        if args.k != frontier.k:
            # the frontier's recall/QPS were measured at its own k
            ap.error(f"frontier operating points were swept at "
                     f"k={frontier.k}; serve with --k {frontier.k} or "
                     f"re-sweep with --tune")
        budget = (None if args.memory_budget_mb is None
                  else int(args.memory_budget_mb * 1e6))
        slo = RecallSLO(args.target_recall, memory_budget_bytes=budget)
        labels = {p.label for p in frontier.for_backend(target.name)}
        if len(labels) > 1:
            print(f"note: frontier mixes variant labels {sorted(labels)} "
                  f"for this backend — the pick's swept recall assumes "
                  f"the matching build; restrict with --frontier-label")
        server = AnnsServer(target, max_batch=args.max_batch,
                            slo=slo, frontier=frontier)
        op = server.operating_point
        print(f"slo pick [{slo.describe()}]: backend={op.backend} "
              f"ef={server.params.ef} k={server.params.k} "
              f"(swept recall={op.recall:.3f} qps={op.qps:.0f} "
              f"dev_mem_mb={op.device_memory_bytes/1e6:.1f})")
    else:
        pred = None
        if args.filter:
            from repro_torch.anns.filters import (parse_filter,
                                                  require_filterable)
            pred = parse_filter(args.filter)
            require_filterable(pred, target.attributes)
            print(f"serving filtered params: {pred} "
                  f"(selectivity={pred.selectivity(ds.attrs):.3f})")
        server = AnnsServer(target, max_batch=args.max_batch,
                            params=SearchParams(k=args.k, ef=args.ef,
                                                filter=pred))
    rng = np.random.default_rng(0)
    order = rng.integers(0, len(ds.queries), size=args.n_requests)
    t0 = time.time()
    for i in order:
        server.submit(ds.queries[i])
    responses = server.run()
    dt = time.time() - t0
    lat = np.array([r.latency_ms for r in responses])
    found = np.stack([r.ids for r in responses])
    if server.params.filter is not None:
        from repro_torch.anns.datasets import filtered_recall_at_k
        fgt = ds.filtered_gt(server.params.filter, k=args.k)
        rec = filtered_recall_at_k(found, fgt[order], args.k)
    else:
        rec = recall_at_k(found, ds.gt[order], args.k)
    print(f"served {len(responses)} requests in {dt:.2f}s "
          f"({len(responses)/dt:,.0f} QPS)")
    print(f"recall@{args.k}={rec:.3f}  latency p50={np.percentile(lat,50):.1f}ms "
          f"p99={np.percentile(lat,99):.1f}ms")
    return rec


if __name__ == "__main__":
    main()
