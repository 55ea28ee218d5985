"""The rank side of ``tests/test_torch_mesh_search.py``: functions that run
in Gloo CPU processes (spawned through ``tests/_torch_dist_ranks.py``'s
``entry``, or :func:`serve_entry` for the serve CLI, which starts its own
group).  This module imports only ``repro_torch``; states and queries
arrive as numpy, and each rank writes its results to an ``.npz`` file.
"""
from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch

from _torch_dist_ranks import _save

#: the per-shard leaves of a ShardedIvfIndex (the rest stay whole)
SHARD_LEAVES = ("cells", "vec_start", "base_q", "scales", "base_f")


def _params(case: dict):
    from repro_torch.anns import SearchParams
    from repro_torch.anns.filters import FilterPredicate
    case = dict(case)
    if "filter" in case:
        case["filter"] = FilterPredicate(*case["filter"])
    return SearchParams(**case)


def _backend(state: dict, variant: dict):
    from repro_torch.anns import from_reference_state
    from repro_torch.anns.engine import VariantConfig
    return from_reference_state(state, "cpu",
                                variant=VariantConfig(**variant))


def _m_shard(backend, queries, params) -> int:
    """The shortlist width a shard keeps for ``params`` (the search's own
    arithmetic: a shard never keeps more than its probed slots)."""
    from repro_torch.anns.backends.ivf import (_probe_floor_nprobe,
                                               shortlist_width)
    idx = backend.index
    p = params.resolved(backend.variant)
    k = min(p.k, idx.n)
    nprobe = _probe_floor_nprobe(idx, backend.variant, p, k)
    m = shortlist_width(p, k, idx.n, nprobe, idx.cell_pad)
    return min(m, nprobe * idx.cell_pad)


def _placement(res: dict, key: str, backend) -> None:
    """What the rank holds after placement."""
    idx = backend.index
    res[f"{key}/leading"] = [getattr(idx, f).shape[0] for f in SHARD_LEAVES]
    n, d = idx.n, idx.centroids.shape[1]
    res[f"{key}/nd_leaf"] = any(
        isinstance(t, torch.Tensor) and tuple(t.shape) == (n, d)
        for t in vars(idx).values())
    res[f"{key}/held"] = (sum(t.numel() * t.element_size()
                              for t in vars(idx).values()
                              if isinstance(t, torch.Tensor))
                          + idx.offsets.nbytes + idx.cell_bounds.nbytes
                          + idx.vec_bounds.nbytes)
    res[f"{key}/device_bytes"] = backend.device_memory_bytes()


def placed_sharded_rank(rank, jobs: list, out: str) -> None:
    """Each job: a sharded state, its variant's fields, queries and search
    cases.  Search unplaced, place on the ``("shard",)`` mesh, search
    again under ``count_collectives``; write both and what is held."""
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import make_shard_mesh
    res = {}
    for i, job in enumerate(jobs):
        port = _backend(job["state"], job["variant"])
        q = job["queries"]
        params = [_params(c) for c in job["cases"]]
        plain = [port.search(q, p) for p in params]
        widths = [_m_shard(port, q, p) for p in params]
        port.place_on_mesh(make_shard_mesh(port.index.n_shards))
        _placement(res, str(i), port)
        for c, (p, base) in enumerate(zip(params, plain)):
            with comm.count_collectives() as cnt:
                got = port.search(q, p)
            key = f"{i}/{c}"
            res[f"{key}/ids"], res[f"{key}/dists"] = got.ids, got.dists
            res[f"{key}/plain_ids"] = base.ids
            res[f"{key}/plain_dists"] = base.dists
            res[f"{key}/expansions"] = int(got.expansions)
            res[f"{key}/plain_expansions"] = int(base.expansions)
            res[f"{key}/bytes"] = cnt["total_bytes"]
            res[f"{key}/m_shard"] = widths[c]
    _save(out.format(rank=rank), **res)


def placed_stream_rank(rank, state: dict, variant: dict, queries,
                       inserts, deletes, cases: list, out: str) -> None:
    """A placed and an unplaced stream_sharded from one state through the
    same history (insert, delete, compact); both searched after each
    stage."""
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import make_shard_mesh
    plain = _backend(state, variant)
    placed = _backend(state, variant)
    placed.place_on_mesh(make_shard_mesh(placed.index.n_shards))
    params = [_params(c) for c in cases]
    res = {}

    def serve(stage: str) -> None:
        for c, p in enumerate(params):
            base = plain.search(queries, p)
            with comm.count_collectives() as cnt:
                got = placed.search(queries, p)
            key = f"{stage}/{c}"
            res[f"{key}/ids"], res[f"{key}/dists"] = got.ids, got.dists
            res[f"{key}/plain_ids"] = base.ids
            res[f"{key}/plain_dists"] = base.dists
            res[f"{key}/bytes"] = cnt["total_bytes"]
            res[f"{key}/m_shard"] = _m_shard(plain, queries, p)
        view = placed._view
        res[f"{stage}/view_rows"] = [view.live.shape[0],
                                     view.tail_vecs.shape[0],
                                     view.tail_live.shape[0]]
        res[f"{stage}/cap"] = placed.tail_cap
        _placement(res, stage, placed)

    serve("base")
    for b in (plain, placed):
        b.insert(inserts, ids=np.arange(10**6, 10**6 + len(inserts)))
    serve("insert")
    for b in (plain, placed):
        b.delete(deletes)
    serve("delete")
    for b in (plain, placed):
        b.compact()
    serve("compact")
    from repro_torch.anns.stream import BackgroundCompactor
    try:
        BackgroundCompactor(placed)
        res["compactor_refused"] = False
    except ValueError as e:
        res["compactor_refused"] = "ROADMAP" in str(e)
    # one history compacts to the same layout, placed or not
    j = placed.index.shard
    res["compact/layout_equal"] = (
        torch.equal(plain.index.ids, placed.index.ids)
        and torch.equal(plain.index.base_q[j], placed.index.base_q[0])
        and torch.equal(plain.index.cells[j], placed.index.cells[0]))
    _save(out.format(rank=rank), **res)


def serve_entry(rank: int, world: int, port: int, argv: list,
                out: str) -> None:
    """One rank of the serve CLI under ``torchrun``'s environment; its
    standard output goes to ``out``."""
    from repro_torch.launch import serve
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
    finally:
        with open(out.format(rank=rank), "w") as f:
            f.write(buf.getvalue())

