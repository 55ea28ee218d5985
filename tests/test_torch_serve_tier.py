"""The port's async serving tier (``repro_torch.serve``) against the JAX
package's (``repro.serve``) on the CPU.

Both packages' ``ContinuousBatcher`` serve one index (the reference's
ivf, moved across as a snapshot) under one fake clock, with each batch's
compute time pinned, so every batch's (tenant group, size, params), the
ids each ticket gets and the telemetry snapshots must be equal.  Around
that: the reference's unit and property tests of the histogram, the
tenant grammar, the admission queue (its depth accounting as a hypothesis
property), typed overload / deadline / close paths, stride scheduling,
SLO isolation, the asyncio front door, and both scripted CLI episodes
(``--async --tenants`` and ``--backend stream_ivf --stream-demo``) run as
subprocesses of both packages with their deterministic ``serve:`` /
``drift:`` lines compared.
"""
import asyncio
import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.serve as jax_serve  # noqa: E402
from repro import ckpt as jax_ckpt  # noqa: E402
from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import make_dataset as jax_make_dataset  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.bench import measure_point as jax_measure_point  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro.anns.tune import sweep_frontier as jax_sweep_frontier  # noqa: E402
from repro.launch import serve as jax_launch  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.anns import SearchParams, from_reference_state, registry  # noqa: E402
from repro_torch.anns.api import (EF_LADDER, round_ef,  # noqa: E402
                                  snap_down_to_ladder)
from repro_torch.anns.datasets import recall_at_k  # noqa: E402
from repro_torch.anns.engine import GLASS_BASELINE, family_baseline  # noqa: E402
from repro_torch.anns.tune import (InfeasibleSLO, OperatingPoint,  # noqa: E402
                                   frontier_from_points)
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.runtime.server import (AnnsServer, batch_k_policy,  # noqa: E402
                                        execute_search_batch, validate_query)
from repro_torch.serve import (AdmissionQueue, AsyncServeTier,  # noqa: E402
                               ContinuousBatcher, DeadlineExceeded,
                               LatencyHistogram, Overloaded, ServeRejection,
                               ServeRequest, ServerClosed, TenantSpec, Ticket,
                               attach_drift_monitors, parse_tenant_specs,
                               resolve_tenants)
from repro_torch.serve import scheduler  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_BASE, N_QUERY = 1500, 32
P8, P16, P64 = (SearchParams(k=10, ef=ef) for ef in (8, 16, 64))
MAX_BATCH = 8
COMPUTE_S = 0.002


@pytest.fixture(scope="module")
def ds():
    return jax_make_dataset("sift-128-euclidean", n_base=N_BASE,
                            n_query=N_QUERY)


@pytest.fixture(scope="module")
def indexes(ds):
    """(reference ivf, port ivf) over one built index."""
    v = dataclasses.replace(family_baseline("ivf"), nlist=16, kmeans_iters=2)
    ref = jax_registry.create("ivf", JaxVariant(**dataclasses.asdict(v)),
                              metric=ds.metric, seed=0)
    ref.build(ds.base)
    return ref, from_reference_state(ref.to_state_dict(), "cpu", variant=v)


@pytest.fixture(scope="module")
def ivf(indexes):
    return indexes[1]


def _tenants(*specs, params=P16):
    return resolve_tenants(list(specs), default_params=params)


class FakeClock:
    t = 0.0

    def __call__(self):
        return self.t


class _Twin:
    """The reference's and the port's ContinuousBatcher on one fake clock,
    each batch's compute time pinned to ``COMPUTE_S``; ``batches`` records
    every batch both formed as (params, size)."""

    def __init__(self, indexes, tenants, *, max_batch=MAX_BATCH,
                 max_queue=64, monkeypatch):
        self.clock = FakeClock()
        self.batches = {"ref": [], "port": []}
        for side, mod in (("ref", jax_serve.scheduler), ("port", scheduler)):
            real = mod.execute_search_batch

            def pinned(search, queries, params, *, max_batch, _real=real,
                       _log=self.batches[side]):
                ids, dists, _ = _real(search, queries, params,
                                      max_batch=max_batch)
                _log.append((params.ef, params.k, len(queries)))
                return ids, dists, COMPUTE_S

            monkeypatch.setattr(mod, "execute_search_batch", pinned)
        ref_tenants = {n: jax_serve.TenantState(
            spec=jax_serve.TenantSpec(**dataclasses.asdict(t.spec)),
            params=JaxParams(**{f.name: getattr(t.params, f.name)
                                for f in dataclasses.fields(t.params)}))
            for n, t in tenants.items()}
        self.ref = jax_serve.ContinuousBatcher(
            indexes[0], ref_tenants, max_batch=max_batch,
            max_queue=max_queue, clock=self.clock)
        self.port = ContinuousBatcher(indexes[1], tenants,
                                      max_batch=max_batch,
                                      max_queue=max_queue, clock=self.clock)

    def submit(self, query, tenant, **kw):
        out = []
        for b in (self.ref, self.port):
            try:
                out.append(b.submit(query, tenant, **kw))
            except (ServeRejection, jax_serve.ServeRejection) as e:
                out.append(e)
        assert type(out[0]).__name__ == type(out[1]).__name__, out
        return tuple(out)

    def both(self, method, *args):
        a, b = (getattr(x, method)(*args) for x in (self.ref, self.port))
        assert a == b, (method, a, b)
        return b

    def check(self, tickets=()):
        """Batches, each ticket's outcome and ids, and the telemetry
        snapshots: equal on both sides."""
        assert self.batches["ref"] == self.batches["port"]
        for rt, pt in tickets:
            assert rt.done == pt.done
            if not pt.done:
                continue
            assert type(rt.error).__name__ == type(pt.error).__name__
            if pt.error is None:
                np.testing.assert_array_equal(np.asarray(rt.result.ids),
                                              pt.result.ids)
                assert rt.result.queue_wait_ms == pt.result.queue_wait_ms
        assert (self.ref.telemetry.snapshot()
                == self.port.telemetry.snapshot())
        assert self.port.telemetry.totals().accounted()


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def _hists(values):
    out = []
    for mod in (jax_serve, serve):
        h = mod.LatencyHistogram()
        for v in values:
            h.record(v)
        out.append(h)
    return out


def test_histogram_quantiles_and_mean():
    ref, h = _hists([10.0] * 100)
    assert h.count == 100 and h.mean_ms == pytest.approx(10.0)
    assert h.quantile(0.5) == pytest.approx(10.0)
    assert h.quantile(0.99) == pytest.approx(10.0)
    assert h.snapshot() == ref.snapshot()


def test_histogram_quantile_bucket_accuracy():
    ref, h = _hists([0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0])
    assert h.quantile(0.05) <= 0.5 * 1.2
    assert 8.0 / 1.2 <= h.quantile(0.5) <= 8.0 * 1.2
    assert h.quantile(1.0) == pytest.approx(256.0)
    assert h.counts == ref.counts
    assert [h.quantile(q) for q in (0.1, 0.5, 0.9, 0.99)] == \
        [ref.quantile(q) for q in (0.1, 0.5, 0.9, 0.99)]


def test_histogram_empty_and_merge():
    a, b = LatencyHistogram(), LatencyHistogram()
    assert a.quantile(0.5) == 0.0 and a.mean_ms == 0.0
    a.record(1.0)
    b.record(100.0)
    a.merge(b)
    assert a.count == 2 and a.max_ms == 100.0
    assert a.sum_ms == pytest.approx(101.0)


# ---------------------------------------------------------------------------
# tenant specs
# ---------------------------------------------------------------------------
def test_parse_tenant_specs():
    specs = parse_tenant_specs("strict:0.95:4:200,lax:0.85")
    assert specs[0] == TenantSpec("strict", 0.95, 4.0, 200.0)
    assert specs[1] == TenantSpec("lax", 0.85, 1.0, None)
    assert [dataclasses.asdict(s) for s in specs] == [
        dataclasses.asdict(s)
        for s in jax_serve.parse_tenant_specs("strict:0.95:4:200,lax:0.85")]


@pytest.mark.parametrize("bad", ["strict", "a:0.9,a:0.8", "a:1.5", "a:0.9:0",
                                 "a:0.9:1:-5", "a:0.9:1:2:3", "",
                                 "a:recall"])
def test_parse_tenant_specs_rejects(bad):
    with pytest.raises(ValueError) as got:
        parse_tenant_specs(bad)
    with pytest.raises(ValueError) as want:
        jax_serve.parse_tenant_specs(bad)
    assert str(got.value) == str(want.value)


def _op(ef, recall, qps):
    return OperatingPoint(backend="ivf", params=SearchParams(k=10, ef=ef),
                          recall=recall, qps=qps, p50_ms=1.0,
                          memory_bytes=1000, device_memory_bytes=1000)


def test_resolve_tenants_frontier_picks_and_infeasible():
    frontier = frontier_from_points(
        [_op(8, 0.80, 4000.0), _op(32, 0.92, 2000.0), _op(128, 0.99, 500.0)],
        dataset="d", n_base=100, n_query=10, k=10)
    tenants = resolve_tenants(
        [TenantSpec("strict", 0.95), TenantSpec("lax", 0.75)],
        frontier=frontier)
    assert tenants["strict"].params.ef == 128
    assert tenants["lax"].params.ef == 8
    assert all(t.params.ef in EF_LADDER for t in tenants.values())
    with pytest.raises(InfeasibleSLO):
        resolve_tenants([TenantSpec("impossible", 0.999)], frontier=frontier)


def test_attach_drift_monitors_names_verdicts():
    tenants = resolve_tenants([TenantSpec("strict", 0.9)],
                              frontier=frontier_from_points(
                                  [_op(16, 0.95, 1000.0)], dataset="d",
                                  n_base=1, n_query=1, k=10))
    attach_drift_monitors(tenants, recall_margin=0.02, min_observations=1)
    st_ = tenants["strict"]
    assert st_.monitor is not None and st_.monitor.name == "strict"
    v = st_.observe_served(recall=0.5, latency_ms=1.0)
    assert v.triggered and v.name == "strict"
    assert v.describe().startswith("[strict] ")


# ---------------------------------------------------------------------------
# batch-k policy and the shapes that reach the kernels
# ---------------------------------------------------------------------------
def test_snap_down_to_ladder_and_batch_k_policy():
    assert [snap_down_to_ladder(v, EF_LADDER)
            for v in (8, 100, 512, 10_000, 5)] == [8, 96, 512, 512, 5]
    assert batch_k_policy(10, 10, None) == 10
    assert batch_k_policy(10, 50, None) == round_ef(50)
    assert batch_k_policy(10, 64, 5000) == 64
    assert batch_k_policy(10, 64, 43) == 32
    assert batch_k_policy(10, 64, 64) == 64
    assert batch_k_policy(10, 64, 5) == 5


def _record_shapes(monkeypatch):
    """Every shape the streaming and ivf searches hand their kernels."""
    from repro_torch.anns.backends import ivf as ivf_mod
    from repro_torch.anns.stream import search as stream_mod
    shapes = set()
    for mod in (stream_mod, ivf_mod):
        for name in ("pairwise_distance", "topk_smallest",
                     "quantized_cell_scan"):
            real = getattr(mod, name)

            def rec(*args, _real=real, _name=name, **kw):
                shapes.add((_name, *(tuple(a.shape) if hasattr(a, "shape")
                                     else a for a in args)))
                return _real(*args, **kw)

            monkeypatch.setattr(mod, name, rec)
    return shapes


def test_stream_kclamp_adds_no_shape_per_live_n(monkeypatch):
    """AnnsServer on a mutating backend: inserts change ``n_live`` between
    flushes while requests ask for k > n.  The ladder-snapped clamp keeps
    the search on one (B, k, m) shape — ``min(k, n)`` would mint one per
    distinct live n."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((40, 32)).astype(np.float32)
    v = dataclasses.replace(family_baseline("stream_ivf"), nlist=4,
                            kmeans_iters=2, tail_cap=64)
    b = registry.create("stream_ivf", v, metric="l2", seed=0, device="cpu")
    b.build(base)
    server = AnnsServer(b, max_batch=4, params=SearchParams(k=10, ef=8))
    shapes = _record_shapes(monkeypatch)

    def flush_k64():
        for q in base[:3]:
            server.submit(q, k=64)
        return server.run()

    out = flush_k64()                       # n_live 40 -> k snaps to 32
    assert out[0].ids.shape[0] <= 64
    before = set(shapes)
    for _ in range(3):                      # n_live walks 42, 44, 46
        b.insert(rng.standard_normal((2, 32)).astype(np.float32))
        b.delete([int(b.live_vectors()[1][0])])
        flush_k64()
    assert shapes == before


def test_validate_query_shapes_and_dtypes():
    assert validate_query([1.0, 2.0, 3.0]).shape == (3,)
    with pytest.raises(ValueError, match=r"pass query\[0\]"):
        validate_query(np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="1-D"):
        validate_query(np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="dim 4 but the index holds 8"):
        validate_query(np.zeros(4, np.float32), dim=8)
    with pytest.raises(TypeError, match="not numeric"):
        validate_query(np.array(["a", "b"]))


def test_batcher_submit_validates_and_knows_tenants(ds, ivf):
    b = ContinuousBatcher(ivf, _tenants(TenantSpec("a")), max_batch=MAX_BATCH)
    with pytest.raises(KeyError, match="unknown tenant"):
        b.submit(ds.queries[0], "nope")
    with pytest.raises(ValueError, match=r"pass query\[0\]"):
        b.submit(ds.queries[:1], "a")
    with pytest.raises(ValueError, match="index holds 128"):
        b.submit(np.zeros(3, np.float32), "a")
    assert b.pending() == 0


# ---------------------------------------------------------------------------
# admission queue: bound + typed rejection invariants
# ---------------------------------------------------------------------------
def _req(tenant="t", group=P16):
    return ServeRequest(tenant=tenant, query=np.zeros(4, np.float32), k=10,
                        group=group, ticket=Ticket())


def test_queue_bound_closed_and_fifo():
    q = AdmissionQueue(3)
    for _ in range(3):
        q.admit(_req())
    with pytest.raises(Overloaded) as ei:
        q.admit(_req())
    assert (ei.value.depth, ei.value.bound, ei.value.tenant) == (3, 3, "t")
    assert q.depth == 3
    q.close()
    with pytest.raises(ServerClosed):
        q.admit(_req())
    q = AdmissionQueue(8)
    reqs = [_req() for _ in range(4)]
    reqs[1].deadline, reqs[3].deadline = 1.0, 5.0
    for r in reqs:
        q.admit(r)
    assert q.shed_expired(now=2.0) == [reqs[1]]
    assert q.pop_batch(P16, 10) == [reqs[0], reqs[2], reqs[3]]
    assert q.depth == 0


@settings(max_examples=40, deadline=None)
@given(ops=st.lists(st.integers(0, 3), min_size=5, max_size=60),
       bound=st.integers(1, 8))
def test_queue_depth_accounting_property(ops, bound):
    """Both packages' queues under one random admit / pop / drain
    interleaving: never past the bound, depth exact, equal."""
    queues = (AdmissionQueue(bound), jax_serve.AdmissionQueue(bound))
    admitted = removed = 0
    for op in ops:
        got = []
        for q in queues:
            if op <= 1:
                try:
                    q.admit(_req())
                    got.append(1)
                except (ServeRejection, jax_serve.ServeRejection):
                    got.append(0)
            elif op == 2:
                got.append(-len(q.pop_batch(P16, 3)))
            else:
                got.append(-len(q.pop_all()))
        assert got[0] == got[1]
        admitted += max(got[0], 0)
        removed -= min(got[0], 0)
        for q in queues:
            assert 0 <= q.depth <= bound
            assert q.depth == admitted - removed == q.tenant_depth("t")


def test_ticket_resolves_once_and_get_raises_typed():
    t = Ticket()
    t.reject(Overloaded("full", tenant="a", depth=1, bound=1))
    assert t.done
    with pytest.raises(Overloaded):
        t.get()
    with pytest.raises(AssertionError, match="twice"):
        t.resolve("r")
    t2 = Ticket()
    t2.resolve("r")
    assert t2.get() == "r"


# ---------------------------------------------------------------------------
# the continuous batcher, twinned with the reference's
# ---------------------------------------------------------------------------
def test_batcher_serves_and_accounts(ds, indexes, monkeypatch):
    tw = _Twin(indexes, _tenants(TenantSpec("a")), monkeypatch=monkeypatch)
    tks = []
    for i in range(20):
        tw.clock.t = i * 1e-3
        tks.append(tw.submit(ds.queries[i % N_QUERY], "a"))
    assert tw.both("drain") == 20
    tw.check(tks)
    found = np.stack([t[1].get().ids for t in tks])
    assert found.shape == (20, 10)
    assert recall_at_k(found, np.asarray(ds.gt)[np.arange(20) % N_QUERY],
                       10) > 0.5
    tot = tw.port.telemetry.totals()
    assert tot.admitted == tot.served == 20
    assert tot.queue_wait.count == tot.compute.count == 20


def test_batcher_close_drain_and_nodrain(ds, indexes, monkeypatch):
    tw = _Twin(indexes, _tenants(TenantSpec("a")), monkeypatch=monkeypatch)
    tks = [tw.submit(ds.queries[i % N_QUERY], "a") for i in range(13)]
    assert tw.both("close", True) == 13
    assert all(p.done and p.error is None for _, p in tks)
    for b in (tw.ref, tw.port):
        with pytest.raises(Exception) as ei:
            b.submit(ds.queries[0], "a")
        assert type(ei.value).__name__ == "ServerClosed"
    tw.check(tks)
    tw = _Twin(indexes, _tenants(TenantSpec("a")), monkeypatch=monkeypatch)
    tks = [tw.submit(ds.queries[i % N_QUERY], "a") for i in range(5)]
    tw.both("close", False)
    for _, t in tks:
        with pytest.raises(ServerClosed):
            t.get()
    tw.check(tks)
    tot = tw.port.telemetry.totals()
    assert tot.shed_closed == 5 and tot.served == 0


class _HostOnly:
    """A result tensor that may be moved to the host and converted, but
    not sliced on its device."""

    def __init__(self, a):
        self._a = np.asarray(a)
        self.is_cuda = False

    def __getitem__(self, key):
        raise AssertionError("result sliced on device, not host")

    def cpu(self):
        return SimpleNamespace(numpy=lambda: self._a)


def test_execute_search_batch_pads_and_slices_on_host():
    seen = {}

    def fake_search(padded, params):
        seen["shape"] = padded.shape
        ids = np.tile(np.arange(params.k), (len(padded), 1))
        return SimpleNamespace(ids=_HostOnly(ids),
                               dists=_HostOnly(ids.astype(np.float32)))

    ids, dists, compute_s = execute_search_batch(
        fake_search, np.zeros((3, 4), np.float32), P16, max_batch=8)
    assert seen["shape"] == (8, 4)
    assert ids.shape == dists.shape == (3, 10) and compute_s >= 0.0


def test_failing_batch_rejects_its_tickets(ds, ivf, monkeypatch):
    b = ContinuousBatcher(ivf, _tenants(TenantSpec("a")), max_batch=MAX_BATCH)
    tks = [b.submit(ds.queries[i], "a") for i in range(3)]

    def boom(*a, **kw):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(scheduler, "execute_search_batch", boom)
    with pytest.raises(RuntimeError, match="device fell over"):
        b.step()
    for t in tks:
        assert t.done
        with pytest.raises(RuntimeError, match="device fell over"):
            t.get()
    assert b.telemetry.totals().accounted()


def test_serve_loop_failure_rejects_queue_typed(ds, ivf, monkeypatch):
    async def main():
        tier = AsyncServeTier(ivf, _tenants(TenantSpec("a")), max_batch=4,
                              max_queue=64)
        tier.start()

        def boom(*a, **kw):
            raise RuntimeError("device fell over")

        monkeypatch.setattr(scheduler, "execute_search_batch", boom)
        futs = [tier.submit(ds.queries[i], "a") for i in range(6)]
        res = await asyncio.gather(*futs, return_exceptions=True)
        assert {type(r) for r in res} <= {RuntimeError, ServerClosed}
        assert all(isinstance(r, BaseException) for r in res)
        with pytest.raises(ServerClosed):
            tier.submit(ds.queries[0], "a")
        with pytest.raises(RuntimeError, match="device fell over"):
            await tier.close(drain=True)
        assert tier.telemetry.totals().accounted()

    asyncio.run(main())


def test_batcher_deadline_shed_typed(ds, indexes, monkeypatch):
    tw = _Twin(indexes, _tenants(TenantSpec("a")), monkeypatch=monkeypatch)
    live = tw.submit(ds.queries[0], "a")
    doomed = tw.submit(ds.queries[1], "a", deadline_ms=10.0)
    tw.clock.t = 1.0                             # the 10 ms budget is gone
    tw.both("step")
    with pytest.raises(DeadlineExceeded) as ei:
        doomed[1].get()
    assert ei.value.waited_ms == pytest.approx(1000.0)
    assert live[1].error is None
    tw.check([live, doomed])
    tot = tw.port.telemetry.totals()
    assert tot.shed_deadline == 1 and tot.served == 1


def test_tenant_default_deadline_applies(ds, indexes, monkeypatch):
    tw = _Twin(indexes, _tenants(TenantSpec("a", deadline_ms=50.0)),
               monkeypatch=monkeypatch)
    tk = tw.submit(ds.queries[0], "a")
    tw.clock.t = 1.0
    tw.both("step")
    with pytest.raises(DeadlineExceeded):
        tk[1].get()
    tw.check([tk])


def test_continuous_batching_adds_no_shape(ds, ivf, monkeypatch):
    """Partial batches of every size pad to the one (max_batch, d) shape
    at the tenant's params: no new shape reaches a kernel once warm."""
    b = ContinuousBatcher(ivf, _tenants(TenantSpec("a"), TenantSpec("b")),
                          max_batch=MAX_BATCH, max_queue=64)
    shapes = _record_shapes(monkeypatch)
    b.submit(ds.queries[0], "a")
    b.drain()
    before = set(shapes)
    for size in (1, 3, 5, 8, 2, 7):
        for i in range(size):
            b.submit(ds.queries[i % N_QUERY], "a" if i % 2 else "b")
        b.drain()
    assert shapes == before
    assert b.telemetry.totals().accounted()


# ---------------------------------------------------------------------------
# multi-tenancy: shared batches, weighted scheduling, SLO isolation
# ---------------------------------------------------------------------------
def test_tenants_sharing_params_share_one_batch(ds, indexes, monkeypatch):
    tw = _Twin(indexes, _tenants(TenantSpec("a"), TenantSpec("b")),
               monkeypatch=monkeypatch)
    tks = []
    for i in range(4):
        tks += [tw.submit(ds.queries[i], "a"), tw.submit(ds.queries[i], "b")]
    assert tw.both("step") == 8
    tw.check(tks)
    snap = tw.port.telemetry.snapshot()
    assert snap["queue"]["batches"] == 1
    assert snap["tenants"]["a"]["served"] == snap["tenants"]["b"]["served"] == 4


def test_distinct_picks_never_mix_in_a_batch(ds, indexes, monkeypatch):
    tenants = {**_tenants(TenantSpec("hi"), params=P64),
               **_tenants(TenantSpec("lo"), params=P8)}
    tw = _Twin(indexes, tenants, monkeypatch=monkeypatch)
    tks = []
    for i in range(6):
        tks += [tw.submit(ds.queries[i], "hi"), tw.submit(ds.queries[i], "lo")]
    while tw.port.pending():
        assert tw.both("step") <= 6
    tw.check(tks)
    assert sorted(tw.batches["port"]) == [(8, 10, 6), (64, 10, 6)]


def test_weighted_stride_scheduling_ratio(ds, indexes, monkeypatch):
    tenants = {**_tenants(TenantSpec("a", weight=4.0), params=P16),
               **_tenants(TenantSpec("b", weight=1.0), params=P8)}
    tw = _Twin(indexes, tenants, max_batch=4, max_queue=128,
               monkeypatch=monkeypatch)
    for i in range(40):
        tw.submit(ds.queries[i % N_QUERY], "a")
        tw.submit(ds.queries[i % N_QUERY], "b")
    while tenants["a"].served < 40:
        tw.both("step")
    assert tenants["b"].served <= 40 / 4 + 4
    tw.both("close", True)
    tw.check()


def test_slo_isolation_lax_flood_cannot_dilute_strict_recall(ds, indexes,
                                                            monkeypatch):
    tenants = {**_tenants(TenantSpec("strict", 0.9), params=P64),
               **_tenants(TenantSpec("lax", 0.5, weight=8.0), params=P8)}
    tw = _Twin(indexes, tenants, max_queue=256, monkeypatch=monkeypatch)
    rng = np.random.default_rng(0)
    strict = []
    for i in range(N_QUERY):
        for _ in range(4):
            tw.submit(ds.queries[int(rng.integers(N_QUERY))], "lax")
        strict.append(tw.submit(ds.queries[i], "strict"))
    tw.both("close", True)
    tw.check(strict)
    found = np.stack([t[1].get().ids for t in strict])
    assert recall_at_k(found, ds.gt, 10) >= 0.9


def test_mid_stream_shed_does_not_shift_recall_rows(ds, indexes,
                                                   monkeypatch):
    tw = _Twin(indexes, _tenants(TenantSpec("a")), monkeypatch=monkeypatch)
    n, shed_at = 6, 2
    toks = [(i, tw.submit(ds.queries[i], "a",
                          deadline_ms=10.0 if i == shed_at else None))
            for i in range(n)]
    tw.clock.t = 1.0
    while any(not tk[1].done for _, tk in toks):
        tw.both("step")
    tw.check([tk for _, tk in toks])
    found, served = [], []
    for i, tk in toks:
        try:
            r = tk[1].get()
        except ServeRejection:
            continue
        found.append(r.ids)
        served.append(i)
    assert served == [i for i in range(n) if i != shed_at]
    rec = launch.served_recall(found, served, ds.gt, 10)
    assert rec == jax_launch.served_recall(found, served, ds.gt, 10)
    naive = recall_at_k(np.stack(found), np.asarray(ds.gt)[:len(found)], 10)
    assert rec > naive + 0.3


def test_served_recall_scores_responses_against_their_own_gt_rows():
    gt = np.asarray([[10, 11], [20, 21], [30, 31]])
    found = [np.asarray([10, 11]), np.asarray([30, 31])]
    assert launch.served_recall(found, [0, 2], gt, 2) == 1.0
    assert recall_at_k(np.stack(found), gt[:2], 2) == 0.5
    assert np.isnan(launch.served_recall([], [], gt, 2))


# ---------------------------------------------------------------------------
# the asyncio front door (in-process)
# ---------------------------------------------------------------------------
def test_async_overload_burst_is_deterministic_and_typed(ds, ivf):
    max_queue = 16

    async def episode():
        tier = AsyncServeTier(ivf, _tenants(TenantSpec("a")),
                              max_batch=MAX_BATCH, max_queue=max_queue)
        futs, overloaded = [], 0
        for i in range(3 * max_queue):
            try:
                futs.append(tier.submit(ds.queries[i % N_QUERY], "a"))
            except Overloaded:
                overloaded += 1
        assert (len(futs), overloaded) == (max_queue, 2 * max_queue)
        tier.start()
        res = await asyncio.gather(*futs)
        assert all(r.ids.shape == (10,) for r in res)
        await tier.close(drain=True)
        return tier

    tier = asyncio.run(episode())
    assert tier.telemetry.snapshot()["queue"]["depth_max"] <= max_queue
    tot = tier.telemetry.totals()
    assert (tot.served, tot.shed_overload) == (max_queue, 2 * max_queue)
    assert tot.accounted()


def test_async_deadline_shed_returns_typed_rejection(ds, ivf):
    async def episode():
        tier = AsyncServeTier(ivf, _tenants(TenantSpec("a")),
                              max_batch=MAX_BATCH, max_queue=64)
        futs = [tier.submit(ds.queries[i], "a", deadline_ms=1e-4)
                for i in range(6)]
        tier.start()
        res = await asyncio.gather(*futs, return_exceptions=True)
        await tier.close(drain=True)
        assert all(isinstance(r, DeadlineExceeded) and r.tenant == "a"
                   for r in res)
        return tier

    tot = asyncio.run(episode()).telemetry.totals()
    assert tot.shed_deadline == 6 and tot.served == 0 and tot.accounted()


def test_async_mixed_tenants_under_load(ds, indexes):
    tenants = {**_tenants(TenantSpec("hi", 0.9), params=P64),
               **_tenants(TenantSpec("lo", 0.5), params=P16)}

    async def episode():
        tier = AsyncServeTier(indexes[1], tenants, max_batch=MAX_BATCH,
                              max_queue=128)
        tier.start()
        futs = {"hi": [], "lo": []}
        for i in range(N_QUERY):
            futs["hi"].append(tier.submit(ds.queries[i], "hi"))
            futs["lo"].append(tier.submit(ds.queries[i], "lo"))
        out = {n: await asyncio.gather(*fs) for n, fs in futs.items()}
        await tier.close(drain=True)
        return tier, out

    tier, out = asyncio.run(episode())
    for name, params in (("hi", P64), ("lo", P16)):
        found = np.stack([r.ids for r in out[name]])
        want = np.asarray(indexes[0].search(
            ds.queries, JaxParams(k=10, ef=params.ef)).ids)
        np.testing.assert_array_equal(found, want)
        assert recall_at_k(found, ds.gt, 10) >= (0.9 if name == "hi" else 0.5)
    assert tier.telemetry.totals().accounted()


# ---------------------------------------------------------------------------
# the scripted CLI episodes, both packages as subprocesses
# ---------------------------------------------------------------------------
def _run(module, args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def _both_clis(args):
    """The reference's and the port's serve CLI on ``args``, started
    together; returns their stdouts."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-m", mod, *args, *extra],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for mod, extra in (("repro.launch.serve", []),
                                ("repro_torch.launch.serve",
                                 ["--device", "cpu"]))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


def _frontier_file(tmp_path, *, n_base, n_query, backend, nlist, ef_cap,
                   tail_cap=None):
    """A frontier of the CLI's own index with real recall and a QPS that
    falls with ef (1e5 / ef), so each SLO pick is the same in both
    packages whatever the machine's timing."""
    ds = jax_make_dataset("sift-128-euclidean", n_base=n_base,
                          n_query=n_query)
    v = dataclasses.replace(GLASS_BASELINE, backend=backend, nlist=nlist,
                            **({"tail_cap": tail_cap} if tail_cap else {}))
    b = jax_registry.create(backend, JaxVariant(**dataclasses.asdict(v)),
                            metric=ds.metric)
    b.build(ds.base)

    def measure(target, ds_, params, repeats, build_seconds):
        p = jax_measure_point(target, ds_, params=params, repeats=1,
                              build_seconds=build_seconds)
        return dataclasses.replace(p, qps=1e5 / params.ef, p50_ms=0.0)

    fr = jax_sweep_frontier(ds, backends=(), targets=[b], k=10, repeats=1,
                            ef_cap=ef_cap, measure_fn=measure)
    path = str(tmp_path / "frontier.json")
    jax_ckpt.save_frontier(path, fr)
    return path


_TIMING = re.compile(r"(lat=|p50=|p99=|p95=|qps=|in )[0-9.,na/]+(ms|s)?")


def _lines(out, prefix):
    return [_TIMING.sub(r"\1*", ln) for ln in out.splitlines()
            if ln.startswith(prefix)]


def test_serve_async_multitenant_both_packages(tmp_path):
    path = _frontier_file(tmp_path, n_base=800, n_query=48, backend="ivf",
                          nlist=16, ef_cap=64)
    ref, port = _both_clis(
        ["--backend", "ivf", "--nlist", "16", "--n-base", "800",
         "--n-query", "48", "--load-frontier", path, "--async", "--tenants",
         "strict:0.9:4,lax:0.7", "--max-queue", "32", "--max-batch", "16",
         "--k", "10"])
    assert re.search(r"serve: overload burst admitted=32 shed=64 "
                     r"\(typed Overloaded\)", port), port
    for name, target in (("strict", 0.9), ("lax", 0.7)):
        m = re.search(rf"serve: tenant {name} recall=([\d.]+) "
                      rf"target=([\d.]+) (ok|MISS)", port)
        assert m and float(m.group(1)) >= target and m.group(3) == "ok", port
    assert "serve: accounting ok" in port and "serve: episode ok" in port
    m = re.search(r"serve: closed served=(\d+) shed_overload=(\d+) "
                  r"shed_deadline=(\d+) shed_closed=(\d+)", port)
    assert m and int(m.group(4)) == 0, port
    # the deterministic lines: picks, the burst, recalls, accounting
    keep = ("serve: tenant", "serve: overload", "serve: accounting",
            "serve: episode", "serve: closed served")

    def det(out):
        return [re.sub(r" depth_max=\d+ batches=\d+", "", ln)
                for ln in _lines(out, "serve:") if ln.startswith(keep)]

    assert det(port) == det(ref)


def test_serve_drift_episode_both_packages(tmp_path):
    """SLO pick -> tail growth triggers a background compaction ->
    drifted queries drop the recall EWMA below the pick -> ladder-local
    re-sweep re-picks -> served recall meets the SLO again; every line up
    to the re-sweep (whose pick weighs measured QPS) is the reference's."""
    path = _frontier_file(tmp_path, n_base=2500, n_query=64,
                          backend="stream_ivf", nlist=16, ef_cap=24,
                          tail_cap=512)
    ref, port = _both_clis(
        ["--backend", "stream_ivf", "--dataset", "sift-128-euclidean",
         "--n-base", "2500", "--n-query", "64", "--k", "10",
         "--max-batch", "32", "--nlist", "16", "--tail-cap", "512",
         "--load-frontier", path, "--target-recall", "0.8",
         "--drift-retune", "0.1", "--max-tail-frac", "0.1",
         "--stream-demo", "400"])
    for out in (ref, port):
        assert "-> tail_frac" in out and "drift: compacted" in out
        assert "-> recall_drift" in out and "slo restored" in out
        assert re.search(r"drift: retune ef (\d+) -> (\d+)", out)
        m = re.search(r"drift: post-retune recall=([0-9.]+) "
                      r"target=([0-9.]+)", out)
        assert m and float(m.group(1)) >= float(m.group(2))
    det = [ln for ln in _lines(ref, "drift:")
           if not ln.startswith(("drift: retune", "drift: post-retune"))]
    assert det == [ln for ln in _lines(port, "drift:")
                   if not ln.startswith(("drift: retune",
                                         "drift: post-retune"))]
    assert _lines(ref, "slo pick") == _lines(port, "slo pick")


def _cli_error(main, argv, monkeypatch):
    """(exit code, stderr) of a serve main refusing ``argv``."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as ei:
        if main is jax_launch.main:
            monkeypatch.setattr(sys, "argv", ["serve", *argv])
            main()
        else:
            main(argv)
    return ei.value.code, err.getvalue().splitlines()[-1].split("error: ")[1]


@pytest.mark.parametrize("argv", [
    ["--tenants", "a:0.9"],
    ["--async", "--tenants", "a:0.9"],
    ["--max-queue", "8"],
    ["--deadline-ms", "5"],
    ["--async", "--stream-demo", "10", "--drift-retune", "0.1",
     "--max-tail-frac", "0.1", "--tune", "--target-recall", "0.9"],
    ["--stream-demo", "0"],
    ["--stream-demo", "10", "--tune", "--target-recall", "0.9"],
    ["--drift-retune", "0.1"],
    ["--async", "--tenants", "a:0.9", "--tune", "--target-recall", "0.9"],
])
def test_serve_flag_validation_matches_the_reference(argv, monkeypatch):
    got = _cli_error(launch.main, argv, monkeypatch)
    want = _cli_error(jax_launch.main, argv, monkeypatch)
    assert got == want and got[0] == 2


def test_stream_demo_refuses_a_read_only_backend(capsys):
    with pytest.raises(SystemExit):
        launch.main(["--backend", "ivf", "--nlist", "8", "--n-base", "300",
                     "--n-query", "8", "--tune", "--target-recall", "0.5",
                     "--drift-retune", "0.1", "--max-tail-frac", "0.1",
                     "--stream-demo", "10", "--device", "cpu"])
    assert "needs a mutable backend" in capsys.readouterr().err
