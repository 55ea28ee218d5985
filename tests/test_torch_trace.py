"""The port's spans (``repro_torch.trace``) on the CPU: a shared no-op
with no profiler recording, and under ``torch.profiler`` the serving
tier's and the ivf search's ranges, one admission a request, one step a
batch, each nested in the layer that calls it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.anns import SearchParams, registry  # noqa: E402
from repro_torch.anns.engine import VariantConfig  # noqa: E402
from repro_torch.serve import (ContinuousBatcher, TenantSpec,  # noqa: E402
                               resolve_tenants)

MAX_BATCH = 4
BATCHES = 3
IVF_STAGES = ("rt.ivf.coarse", "rt.ivf.scan", "rt.ivf.mcut", "rt.ivf.rerank")


def test_span_off_is_the_shared_null_context(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "_RecordFunctionFast",
                        lambda *a, **kw: calls.append(a))
    a, b = trace.span("serve.admit"), trace.span("ivf.scan")
    assert a is b is trace._OFF
    with a:
        with b:
            pass
    assert calls == []


@pytest.fixture(scope="module")
def served_events():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((256, 8)).astype(np.float32)
    ivf = registry.create("ivf", VariantConfig(backend="ivf", nlist=8,
                                               nprobe=2, kmeans_iters=2),
                          device="cpu")
    ivf.build(base)
    tenants = resolve_tenants([TenantSpec("a")],
                              default_params=SearchParams(k=3, ef=64))
    b = ContinuousBatcher(ivf, tenants, max_batch=MAX_BATCH)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(BATCHES * MAX_BATCH):
            b.submit(base[i], "a")
        served = 0
        while b.pending():
            served += b.step()
    assert served == BATCHES * MAX_BATCH
    return sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("rt.")))


def _named(events, name):
    return [(s, e) for s, e, n in events if n == name]


def _inside(outer, inner) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_one_admission_a_request_and_one_step_a_batch(served_events):
    assert len(_named(served_events, "rt.serve.admit")) == \
        BATCHES * MAX_BATCH
    assert len(_named(served_events, "rt.serve.step")) == BATCHES


def test_spans_nest_in_the_layer_that_calls_them(served_events):
    steps = _named(served_events, "rt.serve.step")
    execs = _named(served_events, "rt.serve.execute")
    for child in ("rt.serve.form", "rt.serve.execute", "rt.serve.resolve"):
        spans = _named(served_events, child)
        assert len(spans) == BATCHES
        assert all(_inside(st, c) for st, c in zip(steps, spans))
    # no card here: the search's results need no synchronize
    for child in ("rt.serve.sync", "rt.serve.copy_out"):
        spans = _named(served_events, child)
        assert all(any(_inside(x, c) for x in execs) for c in spans)
    assert len(_named(served_events, "rt.serve.copy_out")) == BATCHES
    for x in execs:
        stages = [(s, n) for s, e, n in served_events
                  if n in IVF_STAGES and _inside(x, (s, e))]
        assert tuple(n for _, n in sorted(stages)) == IVF_STAGES
