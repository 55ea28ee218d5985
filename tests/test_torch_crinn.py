"""Parity of the port's CRINN core (grammar, prompts, exemplar DB, reward,
the module loop) with the JAX package's on the CPU, and the port's RL loop
end to end at small size.

The module-loop comparison replaces ``evaluate`` in both optimizers by one
deterministic function of the variant and samples at temperature 0, so the
two loops see the same rewards and take the same decisions; what differs
is only the arithmetic of the policy, GRPO and AdamW.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.anns.engine import GLASS_BASELINE as JAX_GLASS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import CrinnOptimizer as JaxOptimizer  # noqa: E402
from repro.core import LoopConfig as JaxLoopConfig  # noqa: E402
from repro.core import Policy as JaxPolicy  # noqa: E402
from repro.core import exemplar_db as jax_db  # noqa: E402
from repro.core import prompting as jax_prompting  # noqa: E402
from repro.core import reward as jax_reward  # noqa: E402
from repro.core import variant_space as jax_vs  # noqa: E402
from repro.core.reward import RewardResult as JaxRewardResult  # noqa: E402
from repro.models import Runtime as JaxRuntime  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.anns import make_dataset  # noqa: E402
from repro_torch.anns.engine import GLASS_BASELINE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import CrinnOptimizer, LoopConfig, Policy  # noqa: E402
from repro_torch.core import exemplar_db, prompting, reward  # noqa: E402
from repro_torch.core import variant_space as vs  # noqa: E402
from repro_torch.core.reward import RewardResult  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.models import Runtime  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.convert import from_reference_params  # noqa: E402

SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
             head_dim=32, d_ff=256, dtype="float32")


def _programs(module):
    return list(vs.all_programs(module))[:: max(1, vs.program_space_size(module) // 50)]


# ---------------------------------------------------------------------------
# the reward's sensor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sel", [None, 0.1])
def test_measure_point_matches_the_reference(sel):
    """Recall (against the filtered ground truth when filtered), backend
    name and resident bytes equal the reference's on a GLASS graph built
    from one seed on both sides; the time is the median of the repeats."""
    from repro.anns import SearchParams as JaxParams
    from repro.anns import make_dataset as jax_make_dataset
    from repro.anns import registry as jax_registry
    from repro.anns.bench import measure_point as jax_measure
    from repro.anns.datasets import selectivity_filter as jax_selectivity
    from repro_torch.anns import SearchParams, registry
    from repro_torch.anns.bench import measure_point
    from repro_torch.anns.datasets import selectivity_filter

    ds = make_dataset("sift-128-euclidean", n_base=400, n_query=16,
                      device="cpu")
    jds = jax_make_dataset("sift-128-euclidean", n_base=400, n_query=16)
    port = registry.create("graph", GLASS_BASELINE, metric=ds.metric, seed=0,
                           device="cpu")
    port.build(ds.base)
    port.set_attributes(ds.attrs)
    ref = jax_registry.create("graph", JAX_GLASS, metric=jds.metric, seed=0)
    ref.build(jds.base)
    ref.set_attributes(jds.attrs)
    for ef in (16, 64):
        params = SearchParams(k=10, ef=ef, filter=None if sel is None
                              else selectivity_filter(ds, sel))
        jparams = JaxParams(k=10, ef=ef, filter=None if sel is None
                            else jax_selectivity(jds, sel))
        got = measure_point(port, ds, params=params, repeats=2)
        want = jax_measure(ref, jds, params=jparams, repeats=2)
        assert (got.ef, got.recall, got.backend, got.memory_bytes) == (
            want.ef, want.recall, want.backend, want.memory_bytes)
        assert got.qps > 0
        assert got.p50_ms == pytest.approx(1e3 / got.qps)


# ---------------------------------------------------------------------------
# grammar, prompts, DB, reward: identical to the reference
# ---------------------------------------------------------------------------
def test_vocab_and_grammar_identical():
    assert prompting.VOCAB_SIZE == jax_prompting.VOCAB_SIZE
    assert vs.MODULE_ORDER == jax_vs.MODULE_ORDER
    assert vs.BACKEND_CHOICES == jax_vs.BACKEND_CHOICES
    assert vs.MODULES == jax_vs.MODULES
    for module in vs.MODULE_ORDER:
        for pos in range(vs.knob_count(module)):
            np.testing.assert_array_equal(
                prompting.valid_token_mask(module, pos),
                jax_prompting.valid_token_mask(module, pos))


@pytest.mark.parametrize("module", ["backend", "graph_construction", "search",
                                    "ivf", "refinement"])
def test_prompt_tokens_and_decode_identical(module):
    progs = _programs(module)
    rng = np.random.default_rng(0)
    ex = [(p, float(s)) for p, s in zip(progs[:6], rng.uniform(0, 2.2, 6))]
    jex = [(jax_vs.Program(p.module, p.choices), s) for p, s in ex]
    assert prompting.build_prompt(module, ex) == jax_prompting.build_prompt(
        module, jex)
    for p in progs:
        toks = prompting.program_tokens(p)
        assert toks == jax_prompting.program_tokens(
            jax_vs.Program(p.module, p.choices))
        got = prompting.decode_program(module, toks)
        assert got.choices == jax_prompting.decode_program(module, toks).choices
    bad = [prompting.VOCAB_SIZE - 1] * vs.knob_count(module)
    assert prompting.decode_program(module, bad) is None
    assert jax_prompting.decode_program(module, bad) is None
    for score in (-1.0, 0.0, 0.49, 1.0, 1.97, 2.0, 5.0):
        assert prompting.score_token(score) == jax_prompting.score_token(score)


def test_exemplar_db_sampling_identical():
    db, jdb = exemplar_db.ExemplarDB(tau=0.25), jax_db.ExemplarDB(tau=0.25)
    rng = np.random.default_rng(3)
    for p in _programs("graph_construction"):
        s = float(rng.uniform(0, 2))
        db.add(p, s)
        jdb.add(jax_vs.Program(p.module, p.choices), s)
    db.add(vs.Program("search", (0, 0)), 0.0)        # rejected: score 0
    np.testing.assert_array_equal(db.probabilities("graph_construction"),
                                  jdb.probabilities("graph_construction"))
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        got = db.sample("graph_construction", 4, r1)
        want = jdb.sample("graph_construction", 4, r2)
        assert [(p.choices, s) for p, s in got] == [(p.choices, s) for p, s in want]
    assert db.size("search") == 0


def test_banded_auc_and_speed_reward_identical():
    rng = np.random.default_rng(4)

    class P:
        def __init__(self, r, q):
            self.recall, self.qps = r, q
    for _ in range(30):
        n = int(rng.integers(1, 9))
        rec = np.sort(rng.uniform(0.7, 1.0, n))
        qps = np.sort(rng.uniform(100, 5000, n))[::-1]
        assert reward.banded_auc(rec, qps) == jax_reward.banded_auc(rec, qps)
        pts = [P(r, q) for r, q in zip(rec, qps)]
        base = float(rng.uniform(0, 300))
        assert reward.speed_reward(pts, base).__dict__ == \
            jax_reward.speed_reward(pts, base).__dict__


# ---------------------------------------------------------------------------
# the module loop against the reference's, with a shared evaluate
# ---------------------------------------------------------------------------
def _fake_evaluate(cls):
    """A deterministic reward of the variant's knobs (no engine run)."""
    def evaluate(v):
        r = (0.6 + 0.1 * v.gather_width + 0.03 * v.patience
             + 0.2 * v.quantized_prefilter + 0.05 * v.rerank_factor
             + 0.07 * vs.BACKEND_CHOICES.index(v.backend))
        return cls(auc=r, rel=r, reward=r, n_band_points=3, valid=True)
    return evaluate


@pytest.fixture(scope="module")
def loop_pair():
    jcfg = dataclasses.replace(jax_get_config("crinn-policy-100m"), **SMALL)
    cfg = dataclasses.replace(get_config("crinn-policy-100m"), **SMALL)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    jrt = JaxRuntime(mesh=None, attn_chunk=64, logit_chunk=64, remat="none")
    rt = Runtime(attn_chunk=64, logit_chunk=64, remat="none")
    kw = dict(group_size=4, iterations_per_module=2, temperature=0.0)
    jopt = JaxOptimizer(JaxPolicy(jcfg, params, jrt), None, JaxLoopConfig(**kw))
    opt = CrinnOptimizer(
        Policy(cfg, from_reference_params(params, cfg, device="cpu"), rt),
        None, LoopConfig(**kw))
    jopt.evaluate = _fake_evaluate(JaxRewardResult)
    opt.evaluate = _fake_evaluate(RewardResult)
    return jopt, opt


@pytest.mark.parametrize("module", ["search", "refinement"])
def test_run_module_matches_the_reference(loop_pair, module):
    jopt, opt = loop_pair
    n0 = len(opt.history)
    jv = jopt.run_module(module, verbose=False)
    v = opt.run_module(module, verbose=False)
    assert v.describe() == jv.describe()
    assert dataclasses.asdict(v) == dataclasses.asdict(jv)
    got, want = opt.history[n0:], jopt.history[n0:]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.rewards == w.rewards
        assert g.best_so_far == w.best_so_far
        np.testing.assert_allclose(g.loss, w.loss, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.kl, w.kl, rtol=0, atol=1e-4)
        assert min(g.rollout_s, g.reward_s, g.update_s) >= 0
    for m in ("search", "refinement"):
        assert [(e.program.choices, e.score, e.step) for e in opt.db.entries.get(m, [])] \
            == [(e.program.choices, e.score, e.step)
                for e in jopt.db.entries.get(m, [])]


def test_run_module_backend_matches_the_reference(loop_pair):
    """The ``backend`` module runs (every family it can choose is
    registered) and takes the reference's decisions."""
    jopt, opt = loop_pair
    n0 = len(opt.history)
    jv = jopt.run_module("backend", verbose=False)
    v = opt.run_module("backend", verbose=False)
    assert dataclasses.asdict(v) == dataclasses.asdict(jv)
    assert v.backend in vs.BACKEND_CHOICES
    got, want = opt.history[n0:], jopt.history[n0:]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.rewards == w.rewards and g.best_so_far == w.best_so_far
    assert [(e.program.choices, e.score, e.step)
            for e in opt.db.entries.get("backend", [])] \
        == [(e.program.choices, e.score, e.step)
            for e in jopt.db.entries.get("backend", [])]


def test_construction_key_matches_the_reference(loop_pair):
    """The build cache keys every family by the knobs its build consumes,
    as the reference does (an inert knob never forces a rebuild)."""
    jopt, opt = loop_pair
    knobs = [{}, {"nlist": 128, "kmeans_iters": 4}, {"n_shards": 4},
             {"max_cell": 512, "degree": 48, "alpha": 1.2},
             {"rerank_factor": 8, "nprobe": 32, "gather_width": 4}]
    for family in vs.BACKEND_CHOICES:
        for kw in knobs:
            v = dataclasses.replace(GLASS_BASELINE, backend=family, **kw)
            jv = dataclasses.replace(JAX_GLASS, backend=family, **kw)
            assert opt._construction_key(v) == jopt._construction_key(jv)


# ---------------------------------------------------------------------------
# the port's loop for real on the CPU (test_system.py's assertions)
# ---------------------------------------------------------------------------
def test_crinn_loop_runs_on_the_cpu():
    cfg = dataclasses.replace(get_config("crinn-policy-100m"), **SMALL)
    rt = Runtime(attn_chunk=64, logit_chunk=64, remat="none")
    m = model.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    ds = make_dataset("sift-128-euclidean", n_base=2000, n_query=64,
                      device="cpu")
    loop = LoopConfig(group_size=4, iterations_per_module=2,
                      ef_sweep=(16, 24, 32, 48, 64), bench_repeats=1)
    opt = CrinnOptimizer(Policy(cfg, m, rt), ds, loop)
    flash_ops.launches = 0
    variant = opt.run_module("search", verbose=False)
    assert flash_ops.launches == 0           # CPU tensors: the plain version
    assert variant.backend == GLASS_BASELINE.backend
    assert opt.db.size("search") >= 1
    assert opt.db.best("search").score >= 0.85
    assert opt.baseline_auc > 0
    assert len(opt.history) == 2
    for rec in opt.history:
        assert len(rec.rewards) == 4
        assert all(0.0 <= r < 2.0 for r in rec.rewards)
        assert np.isfinite(rec.loss) and rec.kl >= 0
    assert any(not torch.equal(p, before[n]) for n, p in m.named_parameters())
    assert JAX_GLASS.describe() == GLASS_BASELINE.describe()


def test_train_crinn_driver_runs_all_five_modules(tmp_path, monkeypatch):
    """The driver runs every module in the reference's order, ``backend``
    first, and skips none.  The engine work is replaced by the
    deterministic reward (a real graph_construction pass builds
    alpha-pruned degree-64 graphs, too heavy for a unit test here)."""
    import json

    from repro_torch.launch import train_crinn
    monkeypatch.setattr(CrinnOptimizer, "evaluate",
                        lambda self, v: _fake_evaluate(RewardResult)(v))
    out = train_crinn.main(["--fast", "--device", "cpu", "--n-base", "300",
                            "--out", str(tmp_path / "run.json")])
    assert out["modules"] == list(vs.MODULE_ORDER)
    assert out["modules"][0] == "backend"
    assert out["skipped_modules"] == []
    assert [h["module"] for h in out["history"]] == out["modules"]
    saved = json.loads((tmp_path / "run.json").read_text())
    assert saved["modules"] == out["modules"] and saved["param_count"] > 0
    assert saved["skipped_modules"] == []
