"""The port's SLO autotuner (``repro_torch.anns.tune``, ``ckpt.frontier_io``,
bench's sweep helpers, ``AnnsServer``'s SLO mode, ``serve``'s tuning and
filter flags) against the JAX package's on the CPU.

A sweep's wall clock is its only nondeterministic input, so the sweep is
compared under the reference's own deterministic ``measure_fn``
(``tests/test_tune.py``): the frontier JSON must then be the reference's
byte for byte.  Everything downstream of a measurement (pruning, the
constrained pick, drift verdicts, the served ids) must agree exactly.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import make_dataset as jax_make_dataset  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns import tune as jax_tune  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro.ckpt import frontier_io as jax_frontier_io  # noqa: E402
from repro.runtime.server import AnnsServer as JaxServer  # noqa: E402
from repro_torch import ckpt  # noqa: E402
from repro_torch.anns import SearchParams, make_dataset  # noqa: E402
from repro_torch.anns import bench, tune  # noqa: E402
from repro_torch.anns.engine import IVF_BASELINE  # noqa: E402
from repro_torch.anns.state import from_reference_state  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.server import AnnsServer  # noqa: E402

from test_tune import _deterministic_measure  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "frontier_small.json")
N_BASE, N_QUERY = 800, 32


def _port_frontier(jax_frontier):
    return tune.Frontier.from_json_dict(jax_frontier.to_json_dict())


@pytest.fixture(scope="module")
def pair():
    """The reference's ivf at 800 vectors and the port's holding its
    state, with both packages' datasets: (jds, ds, ref, port)."""
    v = dataclasses.replace(IVF_BASELINE, nlist=16, kmeans_iters=3)
    jds = jax_make_dataset("sift-128-euclidean", n_base=N_BASE,
                           n_query=N_QUERY)
    ds = make_dataset("sift-128-euclidean", n_base=N_BASE, n_query=N_QUERY,
                      device="cpu")
    ref = jax_registry.create("ivf", JaxVariant(**dataclasses.asdict(v)),
                              metric=jds.metric, seed=0)
    ref.build(jds.base)
    port = from_reference_state(ref.to_state_dict(), "cpu", variant=v)
    return jds, ds, ref, port


# ---------------------------------------------------------------------------
# the frontier: sweeps, JSON, the fixture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ef_cap", [None, 64])
def test_sweep_frontier_json_byte_equal_to_the_reference(pair, ef_cap):
    jds, ds, ref, port = pair
    want = jax_tune.sweep_frontier(jds, backends=(), targets=[ref], k=10,
                                   ef_cap=ef_cap, meta={"label": "x"},
                                   measure_fn=_deterministic_measure)
    got = tune.sweep_frontier(ds, backends=(), targets=[port], k=10,
                              ef_cap=ef_cap, meta={"label": "x"},
                              measure_fn=_deterministic_measure)
    assert ckpt.frontier_json(got) == jax_frontier_io.frontier_json(want)
    assert got.n_swept == len(tune.sweep_target(
        port, ds, k=10, ef_cap=ef_cap, measure_fn=_deterministic_measure))


def test_sweep_frontier_builds_backends_on_the_device_asked(pair):
    """Backends named by ``backends`` are built here (family baselines),
    on the CPU when asked; the frontier equals the reference's but for
    the build's wall clock, which rides on every point."""
    jds, ds, _, _ = pair
    variants = {"brute_force": None}
    want = jax_tune.sweep_frontier(jds, backends=("brute_force",), k=10,
                                   variants=variants,
                                   measure_fn=_deterministic_measure)
    got = tune.sweep_frontier(ds, backends=("brute_force",), k=10,
                              variants=variants, device="cpu",
                              measure_fn=_deterministic_measure)

    def unclocked(f):
        d = f.to_json_dict()
        assert all(p.pop("build_seconds") > 0 for p in d["points"])
        return d
    assert unclocked(got) == unclocked(want)


def test_fixture_round_trips_byte_identical(tmp_path):
    f = ckpt.load_frontier(FIXTURE)
    out = str(tmp_path / "rt.json")
    ckpt.save_frontier(out, f)
    assert open(out, "rb").read() == open(FIXTURE, "rb").read()
    assert f == _port_frontier(jax_frontier_io.load_frontier(FIXTURE))


def test_frontier_format_and_age_checks_match_the_reference(tmp_path):
    payload = json.load(open(FIXTURE))
    payload["frontier_format"] = tune.FRONTIER_FORMAT + 1
    (tmp_path / "future.json").write_text(json.dumps(payload))
    with pytest.raises(ckpt.ArtifactFormatError, match="newer"):
        ckpt.load_frontier(str(tmp_path / "future.json"))
    (tmp_path / "notf.json").write_text(json.dumps({"hello": 1}))
    with pytest.raises(ValueError, match="not a frontier"):
        ckpt.load_frontier(str(tmp_path / "notf.json"))
    payload = json.load(open(FIXTURE))
    payload["meta"]["epoch"] = 2
    path = str(tmp_path / "epoch.json")
    (tmp_path / "epoch.json").write_text(json.dumps(payload))
    with pytest.raises(ckpt.StaleArtifactError, match="behind"):
        ckpt.load_frontier(path, current_epoch=4)
    with pytest.warns(UserWarning, match="stale"):
        ckpt.load_frontier(path, current_epoch=4, stale_ok=True)
    with pytest.warns(UserWarning, match="behind"):
        ckpt.load_frontier(path, current_epoch=3, max_epoch_age=1)
    with pytest.raises(ckpt.StaleArtifactError, match="future"):
        ckpt.load_frontier(path, current_epoch=1)


def _random_frontier(seed, n):
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n):
        backend = ("graph", "ivf", "sharded")[i % 3]
        pts.append(jax_tune.OperatingPoint(
            backend=backend, params=JaxParams(k=10, ef=int(rng.choice(
                (8, 16, 32, 64, 128)))),
            recall=float(np.round(rng.uniform(0.5, 1.0), 2)),
            qps=float(np.round(rng.uniform(100, 5000), -1)),
            device_memory_bytes=int(rng.choice((1, 2, 3))) * 10**6,
            memory_bytes=3 * 10**6))
    return jax_tune.frontier_from_points(pts, dataset="d", n_base=1,
                                         n_query=1, k=10)


def _pick(mod, frontier, slo, backend):
    try:
        p = mod.choose(frontier, slo, backend=backend)
        return ("ok", p.to_json_dict())
    except mod.InfeasibleSLO as e:
        return ("infeasible", str(e), e.best_recall, e.min_memory_bytes)


@settings(max_examples=60, deadline=None)
@given(target=st.floats(0.0, 1.0), budget=st.sampled_from(
    [None, 500_000, 1_000_000, 1_500_000, 2_000_000, 3_000_000]),
       backend=st.sampled_from([None, "graph", "ivf", "sharded"]),
       seed=st.integers(0, 50))
def test_choose_picks_equal_the_reference(target, budget, backend, seed):
    """Over recall targets, memory budgets and backend restrictions, on
    the fixture and on random frontiers: the same pick, or the same
    infeasibility with the same diagnostics."""
    for jf in (jax_frontier_io.load_frontier(FIXTURE),
               _random_frontier(seed, 12)):
        f = _port_frontier(jf)
        assert tuple(p.to_json_dict() for p in f.points) == tuple(
            p.to_json_dict() for p in jf.points)
        assert _pick(tune, f, tune.RecallSLO(target, budget), backend) == \
            _pick(jax_tune, jf, jax_tune.RecallSLO(target, budget), backend)
        assert len(tune.feasible_points(f, tune.RecallSLO(target, budget),
                                        backend)) == \
            len(jax_tune.feasible_points(jf, jax_tune.RecallSLO(
                target, budget), backend))


@pytest.mark.parametrize("seed", range(4))
def test_pareto_prune_and_dominates_equal_the_reference(seed):
    jf = _random_frontier(seed, 30)
    raw = [tune.OperatingPoint.from_json_dict(p.to_json_dict())
           for p in jf.points]
    assert [p.to_json_dict() for p in tune.pareto_prune(raw)] == \
        [p.to_json_dict() for p in jax_tune.pareto_prune(jf.points)]
    for a, ja in zip(raw[:6], jf.points[:6]):
        for b, jb in zip(raw[:6], jf.points[:6]):
            assert tune.dominates(a, b) == jax_tune.dominates(ja, jb)


def test_recall_slo_validates_like_the_reference():
    for args in [(1.5,), (-0.1,), (0.9, 0), (0.9, -5)]:
        with pytest.raises(ValueError) as e:
            tune.RecallSLO(*args)
        with pytest.raises(ValueError) as je:
            jax_tune.RecallSLO(*args)
        assert str(e.value) == str(je.value)
    assert tune.RecallSLO(0.9, 2_000_000).describe() == \
        jax_tune.RecallSLO(0.9, 2_000_000).describe()


def test_drift_monitor_verdicts_equal_the_reference():
    jf = jax_frontier_io.load_frontier(FIXTURE)
    jpoint = jf.points[2]
    point = tune.OperatingPoint.from_json_dict(jpoint.to_json_dict())
    kw = dict(recall_margin=0.03, max_tail_frac=0.2, alpha=0.4,
              min_observations=2, name="t")
    mon, jmon = tune.DriftMonitor(point, **kw), jax_tune.DriftMonitor(
        jpoint, **kw)
    script = [dict(recall=0.95), dict(recall=0.9, latency_ms=2.0),
              dict(recall=0.5, latency_ms=float("nan")),
              dict(recall=0.6, latency_ms=1.0, tail_fraction=0.1),
              dict(recall=0.99, tail_fraction=0.3),
              "compaction_started", dict(recall=0.1, tail_fraction=0.5),
              "compaction_finished", "rebase", dict(recall=0.4),
              dict(recall=0.3, latency_ms=4.0)]
    for step in script:
        if step == "rebase":
            mon.rebase(point)
            jmon.rebase(jpoint)
        elif isinstance(step, str):
            getattr(mon, step)()
            getattr(jmon, step)()
        else:
            v, jv = mon.observe(**step), jmon.observe(**step)
            assert dataclasses.asdict(v) == dataclasses.asdict(jv)
            assert v.describe() == jv.describe()
    with pytest.raises(ValueError, match="alpha"):
        tune.DriftMonitor(point, alpha=0.0)


def test_resweep_and_choose_equals_the_reference(pair):
    jds, ds, ref, port = pair
    jf = jax_tune.sweep_frontier(jds, backends=(), targets=[ref], k=10,
                                 measure_fn=_deterministic_measure)
    jpoint = jax_tune.choose(jf, jax_tune.RecallSLO(0.5), backend="ivf")
    point = tune.OperatingPoint.from_json_dict(jpoint.to_json_dict())
    for target in (0.8, 0.99):
        jp, jfront = jax_tune.resweep_and_choose(
            ref, jds, jax_tune.RecallSLO(target), jpoint,
            measure_fn=_deterministic_measure)
        p, front = tune.resweep_and_choose(
            port, ds, tune.RecallSLO(target), point,
            measure_fn=_deterministic_measure)
        assert p.to_json_dict() == jp.to_json_dict()
        assert ckpt.frontier_json(front) == \
            jax_frontier_io.frontier_json(jfront)


# ---------------------------------------------------------------------------
# bench's sweep helpers
# ---------------------------------------------------------------------------
def test_bench_helpers_match_the_reference(pair):
    from repro.anns import bench as jax_bench
    jds, ds, ref, port = pair
    base = SearchParams(k=5, rerank_factor=3)
    for ef in (16, 95, 96, 256):
        got = bench.sweep_params(base, ef)
        want = jax_bench.sweep_params(JaxParams(k=5, rerank_factor=3), ef)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert bench.DEFAULT_EF_SWEEP == jax_bench.DEFAULT_EF_SWEEP
    pts = bench.qps_recall_curve(port, ds, ef_sweep=(16, 64), repeats=1,
                                 build_seconds=1.5)
    jpts = jax_bench.qps_recall_curve(ref, jds, ef_sweep=(16, 64), repeats=1,
                                      build_seconds=1.5)
    for p, jp in zip(pts, jpts):
        assert (p.ef, p.recall, p.backend, p.build_seconds, p.memory_bytes,
                p.device_memory_bytes, p.selectivity) == (
            jp.ef, jp.recall, jp.backend, jp.build_seconds, jp.memory_bytes,
            jp.device_memory_bytes, jp.selectivity)
    for target in (0.0, 0.5, 0.99, 1.1):
        r = bench.qps_at_recall_result(jpts, target)
        jr = jax_bench.qps_at_recall_result(jpts, target)
        assert dataclasses.asdict(r) == dataclasses.asdict(jr)
        assert bench.qps_at_recall(jpts, target) == \
            jax_bench.qps_at_recall(jpts, target)
    with pytest.raises(ValueError, match="empty"):
        bench.qps_at_recall([], 0.9)


def test_build_timed_and_device_memory_of_sharded(pair):
    jds, ds, _, _ = pair
    from repro.anns.bench import build_timed as jax_build_timed
    v = dataclasses.replace(IVF_BASELINE, backend="sharded", nlist=16,
                            n_shards=2, kmeans_iters=3)
    from repro_torch.anns import registry
    port = registry.create("sharded", v, metric=ds.metric, device="cpu")
    ref = jax_registry.create("sharded", JaxVariant(**dataclasses.asdict(v)),
                              metric=jds.metric)
    assert bench.build_timed(port, ds.base) > 0
    assert jax_build_timed(ref, jds.base) > 0
    p = bench.measure_point(port, ds, params=SearchParams(k=10, ef=64),
                            repeats=1)
    assert p.device_memory_bytes == ref.device_memory_bytes()
    assert p.memory_bytes == ref.memory_bytes() > p.device_memory_bytes


# ---------------------------------------------------------------------------
# AnnsServer's SLO mode, CrinnOptimizer(frontier=)
# ---------------------------------------------------------------------------
def test_slo_server_picks_and_serves_as_the_reference(pair):
    jds, ds, ref, port = pair
    jf = jax_tune.sweep_frontier(jds, backends=(), targets=[ref], k=10,
                                 measure_fn=_deterministic_measure)
    f = _port_frontier(jf)
    for target in (0.5, 0.8, 0.9):
        srv = AnnsServer(port, max_batch=16, slo=tune.RecallSLO(target),
                         frontier=f)
        jsrv = JaxServer(ref, max_batch=16, slo=jax_tune.RecallSLO(target),
                         frontier=jf)
        assert srv.operating_point.to_json_dict() == \
            jsrv.operating_point.to_json_dict()
        assert dataclasses.asdict(srv.params) == dataclasses.asdict(
            jsrv.params)
        for q in jds.queries:
            srv.submit(q)
            jsrv.submit(q)
        for a, b in zip(srv.run(), jsrv.run()):
            np.testing.assert_array_equal(a.ids, b.ids)
    with pytest.raises(ValueError, match="needs a swept frontier"):
        AnnsServer(port, slo=tune.RecallSLO(0.9))
    with pytest.raises(ValueError, match="not both"):
        AnnsServer(port, slo=tune.RecallSLO(0.9), frontier=f,
                   params=SearchParams())
    with pytest.raises(tune.InfeasibleSLO):
        AnnsServer(port, slo=tune.RecallSLO(1.0, memory_budget_bytes=1),
                   frontier=f)


def test_slo_server_drift_hooks_equal_the_reference(pair):
    jds, ds, ref, port = pair
    jf = jax_frontier_io.load_frontier(FIXTURE)
    jf = dataclasses.replace(jf, points=jf.for_backend("ivf"))
    f = _port_frontier(jf)
    srv = AnnsServer(port, slo=tune.RecallSLO(0.9), frontier=f)
    jsrv = JaxServer(ref, slo=jax_tune.RecallSLO(0.9), frontier=jf)
    assert srv.observe_served(recall=0.5) is None
    srv.attach_drift_monitor(tune.DriftMonitor(srv.operating_point,
                                               min_observations=1))
    jsrv.attach_drift_monitor(jax_tune.DriftMonitor(jsrv.operating_point,
                                                    min_observations=1))
    for rec in (0.95, 0.7):
        v = srv.observe_served(recall=rec, latency_ms=1.0)
        jv = jsrv.observe_served(recall=rec, latency_ms=1.0)
        assert dataclasses.asdict(v) == dataclasses.asdict(jv)
    # an off-ladder ef re-snaps onto the backend's ladder on adoption
    off = tune.replace_params(f.points[-1], ef=50)
    srv.apply_operating_point(off)
    jsrv.apply_operating_point(jax_tune.replace_params(jf.points[-1], ef=50))
    assert srv.params.ef == jsrv.params.ef != 50
    assert srv.drift_monitor.n_observations == 0


def test_crinn_optimizer_frontier_seeds_the_reference_s_baselines():
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.core import CrinnOptimizer as JaxOptimizer
    from repro.core import LoopConfig as JaxLoopConfig
    from repro.core import Policy as JaxPolicy
    from repro.models import Runtime as JaxRuntime
    from repro.models import model as jax_model
    from repro_torch.configs import get_config
    from repro_torch.core import CrinnOptimizer, LoopConfig, Policy
    from repro_torch.models import Runtime
    from repro_torch.models.convert import from_reference_params

    small = dict(num_layers=1, d_model=64, num_heads=2, num_kv_heads=2,
                 head_dim=32, d_ff=128, dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("crinn-policy-100m"), **small)
    cfg = dataclasses.replace(get_config("crinn-policy-100m"), **small)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    jf = _random_frontier(3, 20)
    jopt = JaxOptimizer(JaxPolicy(jcfg, params, JaxRuntime(
        mesh=None, attn_chunk=64, logit_chunk=64, remat="none")), None,
        JaxLoopConfig(), frontier=jf)
    opt = CrinnOptimizer(Policy(cfg, from_reference_params(params, cfg,
                                                           device="cpu"),
                                Runtime(attn_chunk=64, logit_chunk=64,
                                        remat="none")),
                         None, LoopConfig(), frontier=_port_frontier(jf))
    for family in ("graph", "ivf", "sharded", "brute_force"):
        assert opt.baselines.has(family) == jopt.baselines.has(family)
        assert opt.baselines.get(family) == jopt.baselines.get(family)
    assert opt.baselines.has("ivf")


# ---------------------------------------------------------------------------
# serve: tuning, SLO and filter flags
# ---------------------------------------------------------------------------
def _reference_main(argv, monkeypatch):
    from repro.launch import serve as jax_serve
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    return jax_serve.main()


@pytest.mark.parametrize("argv", [
    ["--tune", "--load-frontier", "f.json"],
    ["--save-frontier", "x.json"],
    ["--target-recall", "0.9"],
    ["--memory-budget-mb", "10"],
    ["--filter", "cat=1", "--target-recall", "0.9", "--tune"],
    ["--backend", "nope"],
])
def test_serve_flag_errors_match_the_reference(argv, monkeypatch, capsys):
    common = ["--n-base", "50", "--n-query", "4", "--n-requests", "4"]
    with pytest.raises(SystemExit) as e:
        serve.main([*common, *argv, "--device", "cpu"])
    got = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as je:
        _reference_main([*common, *argv], monkeypatch)
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert e.value.code == je.value.code == 2
    # the registered lists differ (the port has no streaming backends yet)
    assert got.split("error: ", 1)[1].split("; registered")[0] == \
        want.split("error: ", 1)[1].split("; registered")[0]


def test_serve_rejects_a_k_the_frontier_was_not_swept_at(capsys):
    common = ["--backend", "ivf", "--n-base", "300", "--n-query", "8",
              "--n-requests", "8", "--device", "cpu", "--load-frontier",
              FIXTURE]
    with pytest.raises(SystemExit):
        serve.main([*common, "--target-recall", "0.9", "--k", "20"])
    assert "swept at k=10" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main([*common, "--frontier-label", "nope"])
    assert "no points labeled" in capsys.readouterr().err
    serve.main([*common, "--frontier-label", "glass", "--target-recall",
                "0.9"])
    out = capsys.readouterr().out
    assert "slo pick" in out and "note: frontier was swept on" in out


def test_serve_tune_then_slo_serve(tmp_path, capsys):
    """``--tune --save-frontier`` then ``--load-frontier --target-recall``:
    the served pick is the frontier's choose() pick for the backend."""
    import re
    fpath = str(tmp_path / "frontier.json")
    common = ["--backend", "ivf", "--nlist", "16", "--n-base", "500",
              "--n-query", "16", "--n-requests", "16", "--device", "cpu"]
    serve.main([*common, "--tune", "--tune-ef-cap", "256",
                "--save-frontier", fpath])
    assert "frontier saved" in capsys.readouterr().out
    f = ckpt.load_frontier(fpath)
    assert (f.dataset, f.n_base, f.k) == ("sift-128-euclidean", 500, 10)
    expected = tune.choose(f, tune.RecallSLO(0.9), backend="ivf")
    rec = serve.main([*common, "--load-frontier", fpath,
                      "--target-recall", "0.9"])
    out = capsys.readouterr().out
    m = re.search(r"slo pick \[[^\]]*\]: backend=(\S+) ef=(\d+) k=(\d+)", out)
    assert m and (m.group(1), int(m.group(2))) == ("ivf",
                                                   expected.params.ef)
    assert rec >= 0.9


@pytest.mark.parametrize("backend", ["brute_force", "ivf"])
def test_filter_demo_recalls_equal_the_reference(backend, monkeypatch,
                                                 capsys):
    import re
    argv = ["--filter-demo", "--backend", backend, "--n-base", "800",
            "--n-query", "32", "--n-requests", "64", "--nlist", "16"]
    got = serve.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    _reference_main(argv, monkeypatch)
    want = capsys.readouterr().out

    def recalls(text):
        return [(m.group(1), m.group(2)) for m in re.finditer(
            r"filter: (\S+).*?recall@10=([\d.]+)", text)]
    assert len(recalls(out)) == 4
    assert recalls(out) == recalls(want)
    assert len(got) == 4 and all(0.0 <= r <= 1.0 for r in got.values())
