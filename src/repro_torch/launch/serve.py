"""Serving driver of the port: build an ANNS index with a variant config
and serve batched queries through :class:`AnnsServer`.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --dataset sift-128-euclidean --n-base 1000000 --n-query 10000 \
        --n-requests 2048 --ef 64 --backend brute_force
    PYTHONPATH=src python -m repro_torch.launch.serve --backend sharded \
        --n-shards 2 --nlist 1024 --n-base 1000000 --n-query 10000

Runs on the CUDA card unless ``--device cpu`` is given.  The printed
``served … QPS`` and ``recall@k=`` lines match ``repro.launch.serve``.
``--n-shards`` unrolls the shards on the one device.  The reference's
tuning, async, streaming and checkpoint flags come with their slices.
"""
from __future__ import annotations

import argparse
import time


def _memory_line(target) -> str:
    return f"{target.memory_bytes() / 1e6:.1f} MB resident"


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
    ap.add_argument("--filter", default=None, metavar="EXPR",
                    help="serve filtered queries: 'attr=v' or "
                         "'attr=v1|v2|...' over the dataset's attribute "
                         "columns; recall is scored against the filtered "
                         "ground truth")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
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
    print(f"building index ({variant.describe()}) on {device} ...")
    t0 = time.time()
    target = registry.create(args.backend, variant, metric=ds.metric,
                             device=device)
    target.build(ds.base)
    print(f"built in {time.time()-t0:.1f}s ({_memory_line(target)})")

    pred = None
    if args.filter:
        from repro_torch.anns.filters import parse_filter, require_filterable
        target.set_attributes(ds.attrs)
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
    if pred is not None:
        from repro_torch.anns.datasets import filtered_recall_at_k
        fgt = ds.filtered_gt(pred, k=args.k)
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
