"""The rank side of ``tests/test_torch_leader.py``: functions that run in
Gloo CPU processes spawned through ``tests/_torch_dist_ranks.py``'s
``entry``.  Rank 0 serves through a ``Leader`` over its placed index and
rank 1 follows; this module imports only ``repro_torch``, and each rank
writes what it saw (and rank 0 its op log) next to ``out``.
"""
from __future__ import annotations

import asyncio
import pickle

import numpy as np

#: episode (b): tail-trigger threshold; the mid-episode inserts cross it
MAX_TAIL_FRAC = 0.05


def _backend(state: dict, variant: dict):
    from repro_torch.anns import from_reference_state
    from repro_torch.anns.engine import VariantConfig
    return from_reference_state(state, "cpu",
                                variant=VariantConfig(**variant))


def _placed(state: dict, variant: dict):
    from repro_torch.launch.mesh import make_shard_mesh
    b = _backend(state, variant)
    b.place_on_mesh(make_shard_mesh(b.index.n_shards))
    return b


def _layout(b) -> dict:
    idx = b.index
    return {"shard": idx.shard, "ids": idx.ids.numpy(),
            "base_q": idx.base_q[0].numpy(), "cells": idx.cells[0].numpy()}


def _dump(path: str, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _lead_or_follow(rank, b, out: str, episode) -> None:
    """Rank 0 runs ``episode(leader)`` under a recording Leader, the others
    follow; each rank writes its tallies, epoch / seqno and layout, and
    rank 0 its log and the episode's result."""
    from repro_torch.dist.leader import Leader, follow
    res = {}
    if rank == 0:
        with Leader(b, record=True) as leader:
            res["episode"] = episode(leader)
        res["log"], res["tallies"] = leader.log, leader.tallies
    else:
        res["tallies"] = follow(b)
    res["state"] = (getattr(b, "epoch", -1), getattr(b, "seqno", -1))
    res["layout"] = _layout(b)
    _dump(out.format(rank=rank), res)


def async_single_episode(leader, queries, params, max_batch: int) -> dict:
    """One tenant at ``params`` through the async tier, in chunks of two
    batches; each request's ids in submission order."""
    from repro_torch.serve import AsyncServeTier, TenantSpec, resolve_tenants
    tenants = resolve_tenants([TenantSpec("default")], default_params=params)
    tier = AsyncServeTier(leader, tenants, max_batch=max_batch,
                          max_queue=2 * max_batch)

    async def run():
        tier.start()
        got = []
        for lo in range(0, len(queries), 2 * max_batch):
            futs = [tier.submit(q, "default")
                    for q in queries[lo:lo + 2 * max_batch]]
            got.extend(await asyncio.gather(*futs))
        await tier.close(drain=True)
        return got

    got = asyncio.run(run())
    return {"ids": np.stack([r.ids for r in got]),
            "batches": tier.telemetry.snapshot()["queue"]["batches"]}


def burst_compact_episode(leader, frontier, queries, inserts, dels_before,
                          dels_during, tenants: str, max_batch: int,
                          max_queue: int) -> dict:
    """The multi-tenant burst (3 x max_queue submitted before the serve
    loop starts), then windows of mixed traffic; after the second window
    ``inserts`` and ``dels_before`` land and the gold tenant's tail verdict
    schedules a background compaction; ``dels_during`` lands between its
    prepare and its commit (from the warm spec, on the worker); a last
    window is served after the swap."""
    from repro_torch.anns.stream import BackgroundCompactor
    from repro_torch.serve import (AsyncServeTier, Overloaded,
                                   attach_drift_monitors, parse_tenant_specs,
                                   resolve_tenants)
    specs = parse_tenant_specs(tenants)
    states = resolve_tenants(specs, target=leader, frontier=frontier)
    attach_drift_monitors(states, max_tail_frac=MAX_TAIL_FRAC)
    tier = AsyncServeTier(leader, states, max_batch=max_batch,
                          max_queue=max_queue)
    compactor = BackgroundCompactor(leader)
    tier.attach_compactor(compactor)
    default_warm = compactor.warm

    def warm():
        leader.delete(dels_during)          # journaled: between the fences
        return default_warm()

    compactor.warm = warm
    names = [s.name for s in specs]
    out = {"verdicts": []}

    async def run():
        futs, shed = [], 0
        for i in range(3 * max_queue):
            try:
                futs.append(tier.submit(queries[i % len(queries)],
                                        names[i % len(names)]))
            except Overloaded:
                shed += 1
        out["admitted"], out["shed"] = len(futs), shed
        tier.start()
        await asyncio.gather(*futs)
        W = max_queue // len(names)
        windows = list(range(0, len(queries), W))
        for w, lo in enumerate(windows + [None]):
            if lo is None:              # one window after the swap
                compactor.join()
                lo = windows[0]
            if w == 2:
                leader.insert(inserts, ids=np.arange(
                    10 ** 6, 10 ** 6 + len(inserts)))
                leader.delete(dels_before)
                # the recall as swept: only the tail trigger is under test
                v = tier.batcher.observe_served(
                    names[0], recall=states[names[0]].point.recall,
                    tail_fraction=leader.tail_fraction())
                out["verdicts"].append(v.reason)
            subs = [tier.submit(q, n) for q in queries[lo:lo + W]
                    for n in names]
            await asyncio.gather(*subs)
        await tier.close(drain=True)

    asyncio.run(run())
    tot = tier.telemetry.totals()
    out.update(accounted=tot.accounted(), admitted_total=tot.admitted,
               served=tot.served, shed_deadline=tot.shed_deadline,
               shed_closed=tot.shed_closed, runs=compactor.runs)
    return out


def episodes_rank(rank, single: dict, burst: dict, out: str) -> None:
    """Episode (a) over a placed sharded index, then (b) over a placed
    stream_sharded one, in one group."""
    b = _placed(single["state"], single["variant"])
    _lead_or_follow(rank, b, out.replace("{rank}", "a{rank}"),
                    lambda leader: async_single_episode(
                        leader, single["queries"], single["params"],
                        single["max_batch"]))
    b = _placed(burst["state"], burst["variant"])
    frontier = burst["frontier"]
    _lead_or_follow(rank, b, out.replace("{rank}", "b{rank}"),
                    lambda leader: burst_compact_episode(
                        leader, frontier, burst["queries"], burst["inserts"],
                        burst["dels_before"], burst["dels_during"],
                        burst["tenants"], burst["max_batch"],
                        burst["max_queue"]))


def failing_rank(rank, state: dict, variant: dict, queries, out: str) -> None:
    """Rank 0 serves two searches through the leader, then raises; every
    rank writes the message it ends with and re-raises."""
    from repro_torch.anns import SearchParams
    from repro_torch.dist.leader import Leader, follow
    b = _placed(state, variant)
    try:
        if rank == 0:
            with Leader(b) as leader:
                for _ in range(2):
                    leader.search(queries, SearchParams(k=10, ef=64))
                raise RuntimeError("boom: the leader failed mid-episode")
        follow(b)
    except BaseException as e:
        with open(out.format(rank=rank), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise


def serve_runs(rank: int, world: int, ports: list, argvs: list,
               out: str) -> None:
    """Several serve CLI runs, one after another, each under ``torchrun``'s
    environment on its own port; run i's standard output goes to
    ``out.format(rank=rank, run=i)``."""
    import contextlib
    import io
    import os

    import torch

    from repro_torch.launch import serve
    torch.set_num_threads(1)
    for i, (port, argv) in enumerate(zip(ports, argvs)):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                serve.main(argv)
        finally:
            with open(out.format(rank=rank, run=i), "w") as f:
                f.write(buf.getvalue())
