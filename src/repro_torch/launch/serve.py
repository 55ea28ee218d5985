"""Serving driver of the port: build an ANNS index with a variant config
and serve batched queries through :class:`AnnsServer`.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --dataset sift-128-euclidean --n-base 1000000 --n-query 10000 \
        --n-requests 2048 --ef 64 --backend brute_force
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sharded \
        --n-shards 2 --nlist 1024 --n-base 1000000 --n-query 10000

Runs on the CUDA card unless ``--device cpu`` is given.  The printed
``served … QPS`` and ``recall@k=`` lines match ``repro.launch.serve``.
``--n-shards`` unrolls the shards on the one device; under a process
group (``WORLD_SIZE`` > 1, as ``torchrun`` sets it: NCCL on ``cuda``,
Gloo on ``cpu``) a ``sharded`` / ``stream_sharded`` index of one shard a
rank is placed across the ranks instead, and only rank 0 prints::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --backend sharded --n-shards 2

Built indexes ship without a rebuild: ``--save-index DIR`` checkpoints
the built state, ``--load-index DIR`` restores it (the backend comes from
the checkpoint), in the JAX package's format both ways.  Operating points
ship the same way: ``--tune`` sweeps the served backend's effort ladder
into a Pareto frontier, ``--save-frontier`` / ``--load-frontier`` move it
as JSON, and ``--target-recall R`` (with ``--memory-budget-mb M``) serves
the frontier's max-QPS pick meeting R instead of ``--ef``::

    serve --backend ivf --tune --save-frontier f.json          # bench host
    serve --backend ivf --load-frontier f.json --target-recall 0.9

Streaming backends (``--backend stream_ivf`` / ``stream_sharded``, with
``--tail-cap``) mutate in place; ``--drift-retune MARGIN`` /
``--max-tail-frac FRAC`` attach a drift monitor to the SLO pick, and
``--stream-demo N`` runs the scripted drift episode end to end (insert N
drifted vectors -> tail trigger -> background compaction -> recall drift
-> ladder re-sweep -> SLO restored), printing greppable ``drift:`` lines.

``--async`` serves through the asyncio continuous-batching tier
(:mod:`repro_torch.serve`); with ``--tenants name:recall[:weight[:
deadline_ms]],...`` it runs the scripted multi-tenant episode (greppable
``serve:`` lines), bounded by ``--max-queue``, with ``--deadline-ms`` as
the default deadline.

``--filter EXPR`` serves every request under an attribute predicate;
``--filter-demo`` runs the scripted unfiltered-vs-filtered episode at
three selectivities (greppable ``filter:`` lines).

Under a process group every rank makes the same search calls, so loops
whose batches or picks come from timing raise there: ``--async``, the
background compactor, and an SLO pick from a sweep of this run (sweep
with ``--save-frontier``, then serve with ``--load-frontier``).  A
leader / follower loop for them is open work (ROADMAP §1).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
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


def served_recall(found_ids, served_indices, gt, k) -> float:
    """Recall@k of the *served* subset of an episode: response ``i`` is
    scored against the gt row of the query it actually answered.

    The naive form — stack the accepted results and compare against
    ``gt[:n_ok]`` — silently misattributes every response after a
    mid-stream shed: one ``ServeRejection`` shifts all later rows onto
    the wrong ground truth, corrupting the recall fed to the drift
    monitors.  ``served_indices[i]`` is the original query index of
    ``found_ids[i]``; NaN when nothing was served (a fully-shed tenant
    has no measured recall, which is not 0.0).
    """
    import numpy as np
    from repro_torch.anns.datasets import recall_at_k
    if not len(found_ids):
        return float("nan")
    gt_rows = np.asarray(gt)[np.asarray(list(served_indices), int)]
    return recall_at_k(np.stack(found_ids), gt_rows, k)


def _serve_window(server, queries, gt, k):
    """Push one query window through the server; returns (recall, p50 ms)."""
    import numpy as np
    from repro_torch.anns.datasets import recall_at_k
    for q in queries:
        server.submit(q)
    responses = server.run()
    found = np.stack([r.ids for r in responses])
    lat = np.array([r.latency_ms for r in responses])
    return (recall_at_k(found, gt, k), float(np.percentile(lat, 50)))


def _voronoi_tied_sites(cents, rng, *, g=6, n_sites=3):
    """Points exactly equidistant to ``g`` centroids, every other
    centroid strictly farther.

    Equidistance to ``g`` points is ``g - 1`` *linear* constraints on x
    (the pairwise-bisector hyperplanes), so the site is a least-squares
    solve, seeded at a centroid and its ``g - 1`` nearest neighbors to
    keep the tied distance short.  Returns ``(x, d_tie, margin)`` rows —
    ``margin`` is how much farther the nearest non-anchor centroid sits.
    Vectors inserted around such a site split ~evenly across ``g`` cells
    under nearest-centroid assignment, so any ``nprobe < g`` search over
    them loses recall — the worst case for a partition layout, and the
    drift the demo manufactures.
    """
    import numpy as np
    sites = []
    for seed in rng.permutation(len(cents)):
        anchor_idx = np.argsort(
            np.linalg.norm(cents - cents[seed], axis=1))[:g]
        A = cents[anchor_idx]
        a0 = A[0]
        M = 2.0 * (a0 - A[1:])
        rhs = (a0 @ a0) - np.einsum("ij,ij->i", A[1:], A[1:])
        mean = A.mean(axis=0)
        y, *_ = np.linalg.lstsq(M, rhs - M @ mean, rcond=None)
        x = mean + y
        dx = np.linalg.norm(cents - x, axis=1)
        d_tie = float(dx[anchor_idx].mean())
        spread = float(dx[anchor_idx].max() - dx[anchor_idx].min())
        margin = float(np.delete(dx, anchor_idx).min() - d_tie)
        if spread < 1e-6 * d_tie and margin > 0.03 * d_tie:
            sites.append((x, d_tie, margin))
        if len(sites) >= n_sites:
            break
    return sites


def _run_stream_drift_demo(server, target, ds, slo, args):
    """Scripted streaming-drift episode (greppable ``drift:`` markers).

    Phase A serves the build distribution — the monitor stays quiet.
    Then vectors drawn around Voronoi-tied sites (equidistant to several
    k-means centroids, :func:`_voronoi_tied_sites`) are inserted until
    the delta tail trips the ``--max-tail-frac`` trigger; while they sit
    in the tail they are scanned exactly, so recall holds.  The episode
    answers with ``compact()``, which folds them into cells via the
    *existing* centroids — each site's points split across all its tied
    cells.  Phase B serves queries drawn at the same sites: their true
    neighbors now straddle more cells than the build-time pick probes,
    served recall EWMA falls below the frontier's prediction, and the
    ``recall_drift`` verdict fires.  The episode re-sweeps the
    neighboring ladder rungs against ground truth over the *live* set
    and re-chooses for the same SLO; phase C verifies the served recall
    is back above the target.
    """
    import dataclasses

    import numpy as np
    from repro_torch.anns.stream import exact_live_gt
    from repro_torch.anns.tune import resweep_and_choose

    k, window = args.k, server.max_batch
    rng = np.random.default_rng(7)
    # phase A: in-distribution traffic matches the swept prediction
    for _ in range(2):
        idx = rng.integers(0, len(ds.queries), size=window)
        rec, p50 = _serve_window(server, ds.queries[idx], ds.gt[idx], k)
        v = server.observe_served(recall=rec, latency_ms=p50)
        print(f"drift: baseline window {v.describe()}")
    # drift arrives: vectors at cell-boundary sites of the frozen layout
    d = ds.base.shape[1]
    cents = target.index.centroids.cpu().numpy().astype(np.float64)
    sites = _voronoi_tied_sites(cents, rng)
    if not sites:
        print("drift: no tied sites found on this layout — demo aborted")
        return
    n_q = 4 * window
    per = -(-args.stream_demo // len(sites))       # ceil split over sites
    chunks, qchunks = [], []
    for x, d_tie, margin in sites:
        sig = min(0.3 * margin, 0.05 * d_tie) / np.sqrt(d)
        chunks.append(x + sig * rng.standard_normal((per, d)))
        qchunks.append(x + sig * rng.standard_normal(
            (-(-n_q // len(sites)), d)))
    drifted = np.concatenate(chunks)[: args.stream_demo].astype(np.float32)
    dq = np.concatenate(qchunks)[:n_q].astype(np.float32)
    new_ids = target.insert(drifted)
    print(f"drift: inserted {len(new_ids)} vectors "
          f"(tail_frac={target.tail_fraction():.3f})")
    # measured against ground truth over the live set: the tail is
    # scanned exactly, so recall holds — the tail trigger fires on
    # state, not on quality
    idx = rng.integers(0, len(ds.queries), size=window)
    wq = ds.queries[idx]
    rec, p50 = _serve_window(server, wq, exact_live_gt(target, wq, k), k)
    v = server.observe_served(recall=rec, latency_ms=p50)
    print(f"drift: verdict {v.describe()}")
    if v.reason == "tail_frac":
        # the verdict scheduled a *background* compaction: the
        # replacement layout builds on the compactor's worker while
        # serving continues against the old epoch — prove it with a
        # mid-flight window (the live set is swap-invariant, so its
        # exact gt holds on both sides of the fence)
        idx = rng.integers(0, len(ds.queries), size=window)
        wq = ds.queries[idx]
        rec, p50 = _serve_window(server, wq,
                                 exact_live_gt(target, wq, k), k)
        print(f"drift: served during compaction recall={rec:.3f} "
              f"p50={p50:.1f}ms")
        server.compactor.join()
        print(f"drift: compacted -> epoch {target.epoch}, "
              f"n_live={target.n_live()}, "
              f"tail_frac={target.tail_fraction():.3f}")
    # phase B: served distribution follows the drift — queries land at
    # the same tied sites, ground truth re-derived over the live set
    dgt = exact_live_gt(target, dq, k)
    triggered = None
    for w in range(len(dq) // window):
        sl = slice(w * window, (w + 1) * window)
        rec, p50 = _serve_window(server, dq[sl], dgt[sl], k)
        v = server.observe_served(recall=rec, latency_ms=p50)
        print(f"drift: drifted window {v.describe()}")
        if v.triggered:
            triggered = v
            break
    if triggered is None or triggered.reason != "recall_drift":
        print("drift: no recall_drift verdict — served recall still "
              "within margin of the swept prediction")
        return
    # re-tune against ground truth over the live set: re-sweep the
    # neighboring rungs, re-choose for the same SLO, adopt the pick
    live_ds = dataclasses.replace(ds, queries=dq, gt=dgt)
    old_ef = server.params.ef
    point, refront = resweep_and_choose(
        target, live_ds, slo, server.operating_point, k=k,
        repeats=args.tune_repeats, label="retune")
    server.apply_operating_point(point)
    print(f"drift: retune ef {old_ef} -> {server.params.ef} "
          f"(swept recall={point.recall:.3f} qps={point.qps:.0f})")
    if args.save_frontier:
        # the re-swept frontier reflects the *live* state (epoch +
        # n_live stamped in meta) — persist it over the build-time
        # artifact so the shipped operating points describe the index
        # actually being served
        from repro_torch import ckpt
        ckpt.save_frontier(args.save_frontier, refront)
        print(f"drift: re-swept frontier persisted to "
              f"{args.save_frontier} (epoch "
              f"{refront.meta.get('epoch')}, "
              f"n_live={refront.meta.get('n_live')})")
    # phase C: served recall back above the SLO target
    recs = []
    for w in range(2):
        idx = rng.integers(0, len(dq), size=window)
        rec, p50 = _serve_window(server, dq[idx], dgt[idx], k)
        server.observe_served(recall=rec, latency_ms=p50)
        recs.append(rec)
    post = float(np.mean(recs))
    print(f"drift: post-retune recall={post:.3f} "
          f"target={slo.target_recall:.3f} "
          f"{'slo restored' if post >= slo.target_recall else 'SLO NOT MET'}")
    return post


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


def _run_async_tier(target, ds, frontier, args, ap):
    """Serve through :class:`repro_torch.serve.AsyncServeTier` (``--async``).

    Single-tenant mode mirrors the closed-loop report (recall/QPS/p50/
    p99) plus the queue-wait vs compute latency split only the async
    tier can measure.  With ``--tenants`` it runs the scripted
    multi-tenant episode instead (greppable ``serve:`` markers):
    per-tenant frontier picks, a deterministic overload burst
    (admissions happen before the serve loop starts, so exactly
    ``max_queue`` are admitted and the rest get typed ``Overloaded``),
    a graceful drain, then steady mixed traffic measuring each tenant's
    recall against its own SLO through its named drift monitor.
    """
    import asyncio

    import numpy as np
    from repro_torch.anns import SearchParams
    from repro_torch.serve import (AsyncServeTier, TenantSpec,
                             attach_drift_monitors, parse_tenant_specs,
                             resolve_tenants)

    def warm_buckets(tenants):
        # run each tenant group's batch shape once before the measured
        # episode — outside the tier, so telemetry records serving
        # latency, not a cold operating point's first call (kernel
        # builds, allocator growth)
        from repro_torch.runtime.server import (execute_search_batch,
                                          search_callable)
        search = search_callable(target)
        groups = {st.params for st in tenants.values()}
        for params in groups:
            execute_search_batch(search, ds.queries[:1], params,
                                 max_batch=args.max_batch)
        print(f"serve: warmed {len(groups)} batch shape(s)")

    max_queue = args.max_queue if args.max_queue is not None else 256
    if args.tenants is not None:
        try:
            specs = parse_tenant_specs(args.tenants)
        except ValueError as e:
            ap.error(str(e))
        if args.k != frontier.k:
            ap.error(f"frontier operating points were swept at "
                     f"k={frontier.k}; serve with --k {frontier.k} or "
                     f"re-sweep with --tune")
        tenants = resolve_tenants(specs, target=target, frontier=frontier)
        margin = args.drift_retune if args.drift_retune is not None else 0.05
        attach_drift_monitors(tenants, recall_margin=margin,
                              max_tail_frac=args.max_tail_frac)
        for name in sorted(tenants):
            st = tenants[name]
            extra = ("" if st.spec.deadline_ms is None
                     else f" deadline_ms={st.spec.deadline_ms:g}")
            print(f"serve: tenant {name} pick ef={st.params.ef} "
                  f"k={st.params.k} weight={st.spec.weight:g}{extra} "
                  f"(swept recall={st.point.recall:.3f} "
                  f"qps={st.point.qps:.0f})")
        warm_buckets(tenants)
        tier = AsyncServeTier(target, tenants, max_batch=args.max_batch,
                              max_queue=max_queue)
        from repro_torch.anns.api import supports_mutation
        if supports_mutation(target):
            from repro_torch.anns.stream import BackgroundCompactor
            tier.attach_compactor(BackgroundCompactor(target))
            print("serve: background compactor attached (tail verdicts "
                  "schedule fenced swaps)")
        asyncio.run(_multitenant_episode(tier, ds, args, max_queue))
        return tier.telemetry.snapshot()

    spec = TenantSpec("default", target_recall=args.target_recall,
                      deadline_ms=args.deadline_ms)
    if args.target_recall is not None:
        tenants = resolve_tenants([spec], target=target, frontier=frontier)
        st = tenants["default"]
        print(f"slo pick [recall>={args.target_recall:.3f}]: "
              f"backend={st.point.backend} ef={st.params.ef} "
              f"k={st.params.k} (swept recall={st.point.recall:.3f} "
              f"qps={st.point.qps:.0f})")
    else:
        tenants = resolve_tenants(
            [spec], default_params=SearchParams(k=args.k, ef=args.ef))
    warm_buckets(tenants)
    tier = AsyncServeTier(target, tenants, max_batch=args.max_batch,
                          max_queue=max_queue)

    async def episode():
        from repro_torch.anns.datasets import recall_at_k
        tier.start()
        rng = np.random.default_rng(0)
        order = rng.integers(0, len(ds.queries), size=args.n_requests)
        t0 = time.time()
        responses = []
        # chunked open-loop submission: each chunk fits the admission
        # bound, so a healthy run sheds nothing
        for s in range(0, len(order), max_queue):
            chunk = order[s:s + max_queue]
            futs = [tier.submit(ds.queries[i], "default") for i in chunk]
            responses.extend(await asyncio.gather(*futs))
        dt = time.time() - t0
        await tier.close(drain=True)
        found = np.stack([r.ids for r in responses])
        lat = np.array([r.latency_ms for r in responses])
        rec = recall_at_k(found, ds.gt[order], args.k)
        tot = tier.telemetry.totals()
        snap = tier.telemetry.snapshot()
        print(f"serve: async served {len(responses)} requests in "
              f"{dt:.2f}s ({len(responses)/dt:,.0f} QPS) over "
              f"{snap['queue']['batches']} batches "
              f"(depth_max={snap['queue']['depth_max']})")
        print(f"recall@{args.k}={rec:.3f}  "
              f"latency p50={np.percentile(lat, 50):.1f}ms "
              f"p99={np.percentile(lat, 99):.1f}ms")
        print(f"serve: latency split queue-wait "
              f"p95={tot.queue_wait.quantile(0.95):.1f}ms compute "
              f"p95={tot.compute.quantile(0.95):.1f}ms")

    asyncio.run(episode())
    return tier.telemetry.snapshot()


async def _multitenant_episode(tier, ds, args, max_queue):
    """The scripted multi-tenant load episode (``serve:`` markers)."""
    import asyncio

    import numpy as np
    from repro_torch.serve import Overloaded, ServeRejection

    names = sorted(tier.tenants)
    k = args.k

    # phase 1 — overload burst: submissions happen *before* the serve
    # loop starts, so admission is deterministic — exactly max_queue
    # admitted, the rest typed Overloaded
    rng = np.random.default_rng(1)
    futs, shed = [], 0
    for i in range(3 * max_queue):
        name = names[i % len(names)]
        q = ds.queries[int(rng.integers(0, len(ds.queries)))]
        try:
            futs.append(tier.submit(q, name))
        except Overloaded:
            shed += 1
    print(f"serve: overload burst admitted={len(futs)} shed={shed} "
          f"(typed Overloaded)")
    tier.start()
    res = await asyncio.gather(*futs, return_exceptions=True)
    ok = [r for r in res if not isinstance(r, BaseException)]
    expired = [r for r in res if isinstance(r, ServeRejection)]
    if ok:
        lat = np.array([r.latency_ms for r in ok])
        print(f"serve: burst drained served={len(ok)} "
              f"shed_deadline={len(expired)} "
              f"p50={np.percentile(lat, 50):.1f}ms "
              f"p99={np.percentile(lat, 99):.1f}ms")

    # phase 2 — steady mixed traffic: every tenant sees the full query
    # set, interleaved window by window so batches contend, and each
    # tenant's recall is measured against its own SLO
    W = max(1, max_queue // len(names))
    found = {n: [] for n in names}
    served_idx = {n: [] for n in names}
    lats = {n: [] for n in names}
    for s in range(0, len(ds.queries), W):
        qs = ds.queries[s:s + W]
        window = [(n, s + j, tier.submit(q, n))
                  for j, q in enumerate(qs) for n in names]
        for name, qi, fut in window:
            try:
                r = await fut
            except ServeRejection:
                continue
            found[name].append(r.ids)
            served_idx[name].append(qi)
            lats[name].append(r.latency_ms)
    tail_fraction = getattr(tier.batcher.target, "tail_fraction",
                            lambda: 0.0)()
    all_ok = True
    for name in names:
        st = tier.tenants[name]
        n_ok = len(found[name])
        # score each response against the gt row of the query it served
        # — a mid-stream shed must not shift later results onto the
        # wrong rows (that silently corrupts the drift telemetry)
        rec = served_recall(found[name], served_idx[name], ds.gt, k)
        p50 = (float(np.percentile(lats[name], 50)) if lats[name]
               else float("nan"))
        verdict = tier.batcher.observe_served(
            name, recall=rec, latency_ms=p50, tail_fraction=tail_fraction)
        ok_slo = rec >= st.spec.target_recall
        all_ok = all_ok and ok_slo
        print(f"serve: tenant {name} recall={rec:.3f} "
              f"target={st.spec.target_recall:.3f} "
              f"{'ok' if ok_slo else 'MISS'} p50={p50:.1f}ms "
              f"served={n_ok}/{len(ds.queries)}"
              + (f" drift={verdict.describe()}"
                 if verdict is not None and verdict.triggered else ""))

    # phase 3 — graceful shutdown: stop admitting, serve everything
    # already in the queue, account for every request
    await tier.close(drain=True)
    tot = tier.telemetry.totals()
    snap = tier.telemetry.snapshot()
    print(f"serve: closed served={tot.served} "
          f"shed_overload={tot.shed_overload} "
          f"shed_deadline={tot.shed_deadline} "
          f"shed_closed={tot.shed_closed} "
          f"depth_max={snap['queue']['depth_max']} "
          f"batches={snap['queue']['batches']}")
    print(f"serve: accounting {'ok' if tot.accounted() else 'BROKEN'} "
          f"(admitted={tot.admitted} == "
          f"served+shed_deadline+shed_closed)")
    print(f"serve: latency split queue-wait "
          f"p95={tot.queue_wait.quantile(0.95):.1f}ms compute "
          f"p95={tot.compute.quantile(0.95):.1f}ms")
    print(f"serve: episode {'ok' if all_ok else 'SLO MISS'}")


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
    # -- streaming / drift (repro_torch.anns.stream + tune.drift) ----------
    ap.add_argument("--tail-cap", type=int, default=None,
                    help="delta-tail capacity for streaming backends "
                         "(per shard for stream_sharded)")
    ap.add_argument("--drift-retune", type=float, default=None,
                    metavar="MARGIN",
                    help="attach a drift monitor: trigger a re-tune when "
                         "served recall EWMA falls MARGIN below the "
                         "frontier pick's swept recall (SLO mode only)")
    ap.add_argument("--max-tail-frac", type=float, default=None,
                    help="drift-monitor tail trigger: flag when the "
                         "delta tail exceeds this fraction of live "
                         "vectors (streaming backends, SLO mode)")
    ap.add_argument("--stream-demo", type=int, default=None, metavar="N",
                    help="run the scripted drift episode: serve, insert "
                         "N drifted vectors, compact on the tail trigger, "
                         "re-tune on the recall trigger (needs a "
                         "streaming backend + SLO mode + both drift flags)")
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
    # -- async serving tier (repro_torch.serve) ----------------------------
    ap.add_argument("--async", dest="async_tier", action="store_true",
                    help="serve through the asyncio continuous-batching "
                         "tier (repro_torch.serve) instead of the "
                         "closed-loop AnnsServer")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="multi-tenant episode: comma-separated "
                         "name:recall[:weight[:deadline_ms]] traffic "
                         "classes, each resolved to its own frontier pick "
                         "(needs --async and --tune/--load-frontier)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="async admission-queue depth bound (default "
                         "256); excess submissions are rejected with "
                         "typed Overloaded, never silently dropped")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="async default per-request deadline; requests "
                         "that expire while queued are shed with "
                         "DeadlineExceeded")
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
    if ((args.drift_retune is not None or args.max_tail_frac is not None)
            and args.target_recall is None and args.tenants is None):
        ap.error("drift monitoring compares served recall against an SLO "
                 "pick; --drift-retune/--max-tail-frac need "
                 "--target-recall (or --tenants, which carries per-tenant "
                 "targets)")
    if args.stream_demo is not None:
        if args.stream_demo < 1:
            ap.error("--stream-demo needs a positive vector count")
        if args.drift_retune is None or args.max_tail_frac is None:
            ap.error("--stream-demo exercises both triggers; set "
                     "--drift-retune MARGIN and --max-tail-frac FRAC")
    if args.tenants is not None and not args.async_tier:
        ap.error("--tenants configures the async tier; add --async")
    if args.tenants is not None and args.target_recall is not None:
        ap.error("--tenants carries per-tenant recall targets "
                 "(name:recall[:weight[:deadline_ms]]); drop "
                 "--target-recall")
    if args.tenants is not None and not (args.tune or args.load_frontier):
        ap.error("per-tenant SLOs resolve through a frontier: add --tune "
                 "(sweep now) or --load-frontier FILE")
    if args.max_queue is not None and not args.async_tier:
        ap.error("--max-queue bounds the async admission queue; add "
                 "--async")
    if args.deadline_ms is not None and not args.async_tier:
        ap.error("--deadline-ms sets the async tier's default deadline; "
                 "add --async")
    if args.async_tier and args.stream_demo is not None:
        ap.error("--stream-demo drives the closed-loop AnnsServer; drop "
                 "--async")
    if args.filter_demo and args.async_tier:
        ap.error("--filter-demo drives the closed-loop AnnsServer; drop "
                 "--async")
    if args.filter and args.target_recall is not None:
        ap.error("--filter serves explicit params; a filtered SLO pick "
                 "needs a frontier swept under the same predicate "
                 "(tune.sweep_frontier filters=...)")

    grouped = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if grouped:
        timed = ("--async" if args.async_tier else
                 "--tune with an SLO pick" if args.tune and (
                     args.target_recall is not None
                     or args.tenants is not None) else None)
        if timed:
            ap.error(f"{timed} forms its batches or picks from timing, which "
                     f"the ranks of a process group would not agree on; a "
                     f"leader / follower loop for timing-driven serving loops is "
                     f"open work (ROADMAP §1)")
    quiet = grouped and int(os.environ.get("RANK", "0")) != 0
    with (contextlib.redirect_stdout(io.StringIO()) if quiet
          else contextlib.nullcontext()):
        return _serve(args, ap, grouped)


def _serve(args, ap, grouped: bool):
    from repro_torch.anns import registry
    from repro_torch.device import resolve_device

    if args.backend not in registry.available():
        ap.error(f"unknown backend {args.backend!r}; "
                 f"registered: {registry.available()}")
    device = resolve_device(args.device)
    if grouped:
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_distributed
        init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        try:
            return _serve_on(args, ap, device, grouped)
        finally:
            dist.destroy_process_group()
    return _serve_on(args, ap, device, grouped)


def _serve_on(args, ap, device, grouped: bool):
    import dataclasses

    import numpy as np
    from repro_torch import ckpt
    from repro_torch.anns import SearchParams, make_dataset, registry
    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.anns.engine import GLASS_BASELINE, VariantConfig
    from repro_torch.runtime.server import AnnsServer

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
    if args.tail_cap:
        variant = dataclasses.replace(variant, tail_cap=args.tail_cap)
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

    if args.stream_demo is not None:
        from repro_torch.anns.api import supports_mutation
        if not supports_mutation(target):
            ap.error(f"--stream-demo needs a mutable backend "
                     f"(stream_ivf/stream_sharded); "
                     f"{getattr(target, 'name', args.backend)!r} is "
                     f"read-only")

    if getattr(target, "name", "") in ("sharded", "stream_sharded"):
        from repro_torch.launch.mesh import shard_mesh_if_available
        ns = target.index.n_shards
        mesh = shard_mesh_if_available(ns)
        if mesh is not None:
            # each rank holds only its cell shard
            target.place_on_mesh(mesh)
            print(f"placed {ns} cell shards on {ns} devices "
                  f"({target.device_memory_bytes()/1e6:.1f} MB/device)")

    if (args.filter or args.filter_demo) and target.attributes is None:
        # a restored index may carry its columns (attr/<col> leaves)
        target.set_attributes(ds.attrs)
        print(f"attribute columns attached: {sorted(ds.attrs)}")
    if args.filter_demo:
        return _run_filter_demo(target, ds, args)

    frontier = None
    if args.load_frontier:
        # a frontier stamped with a mutation epoch ages out: serving a
        # compacted index off measurements of an older layout refuses
        frontier = ckpt.load_frontier(
            args.load_frontier,
            current_epoch=getattr(target, "epoch", None))
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

    if args.async_tier:
        if (args.target_recall is not None and frontier is not None
                and args.k != frontier.k):
            ap.error(f"frontier operating points were swept at "
                     f"k={frontier.k}; serve with --k {frontier.k} or "
                     f"re-sweep with --tune")
        return _run_async_tier(target, ds, frontier, args, ap)

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
        if args.drift_retune is not None or args.max_tail_frac is not None:
            from repro_torch.anns.api import supports_mutation
            from repro_torch.anns.tune import DriftMonitor
            margin = (args.drift_retune if args.drift_retune is not None
                      else 0.02)
            server.attach_drift_monitor(DriftMonitor(
                server.operating_point, recall_margin=margin,
                max_tail_frac=args.max_tail_frac, min_observations=2))
            print(f"drift monitor attached (margin={margin:.3f}, "
                  f"max_tail_frac={args.max_tail_frac})")
            if supports_mutation(target):
                if grouped:
                    ap.error("the background compactor swaps layouts on its "
                             "own timing, which the ranks of a process "
                             "group would not agree on; a leader / follower "
                             "loop for timing-driven serving loops is open work "
                             "(ROADMAP §1)")
                from repro_torch.anns.stream import BackgroundCompactor
                server.attach_compactor(BackgroundCompactor(target))
                print("background compactor attached (tail verdicts "
                      "schedule fenced swaps off the serve loop)")
        if args.stream_demo is not None:
            return _run_stream_drift_demo(server, target, ds, slo, args)
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
    verdict = server.observe_served(recall=rec,
                                    latency_ms=float(np.percentile(lat, 50)))
    if verdict is not None and verdict.triggered:
        print(f"drift: verdict {verdict.describe()}")
    return rec


if __name__ == "__main__":
    main()
