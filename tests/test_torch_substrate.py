"""Parity of the port's training substrate with the JAX package's on the
CPU: data pipelines, learning-rate schedules, gradient compression, fault
primitives, checkpoints and the rotating checkpoint manager, and the
dense configs of the model zoo.

The reference and the port run on the same numpy inputs in one process.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.ckpt import CheckpointManager as JaxManager  # noqa: E402
from repro.ckpt import load_checkpoint as jax_load  # noqa: E402
from repro.ckpt import save_checkpoint as jax_save  # noqa: E402
from repro.data import PromptPipeline as JaxPrompts  # noqa: E402
from repro.data import TokenPipeline as JaxTokens  # noqa: E402
from repro.optim import grad_compress as jax_gc  # noqa: E402
from repro.optim import schedule as jax_schedule  # noqa: E402
from repro.runtime import fault as jax_fault  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.ckpt import (CheckpointManager, load_checkpoint,  # noqa: E402
                              save_checkpoint)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import PromptPipeline, TokenPipeline  # noqa: E402
from repro_torch.optim import grad_compress, schedule  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402


# ---------------------------------------------------------------------------
# data pipelines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 8, 0),
                                                  (32000, 64, 4, 3),
                                                  (97, 7, 6, 11)])
def test_token_pipeline_is_byte_equal_to_the_reference(vocab, seq, batch,
                                                       seed):
    mine = TokenPipeline(vocab, seq, batch, seed=seed)
    ref = JaxTokens(vocab, seq, batch, seed=seed)
    for step in (0, 1, 5, 1000):
        got, want = mine.batch(step), ref.batch(step)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
    for shards in (1, 2, batch):
        if batch % shards:
            continue
        for i in range(shards):
            got = mine.reshard(shards, i).batch(7)
            want = ref.reshard(shards, i).batch(7)
            assert got.tobytes() == want.tobytes()
            assert got.tobytes() == mine.batch(7)[
                i * batch // shards:(i + 1) * batch // shards].tobytes()


def test_token_pipeline_rejects_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        TokenPipeline(64, 8, 6, num_shards=4).batch(0)


@pytest.mark.parametrize("seq,batch,seed", [(96, 4, 0), (128, 8, 1),
                                            (24, 6, 9)])
def test_prompt_pipeline_is_byte_equal_to_the_reference(seq, batch, seed):
    for shards in (1, 2):
        for shard in range(shards):
            mine = PromptPipeline(seq, batch, seed=seed, num_shards=shards,
                                  shard_id=shard)
            ref = JaxPrompts(seq, batch, seed=seed, num_shards=shards,
                             shard_id=shard)
            for step in (0, 3, 17):
                got, want = mine.batch(step), ref.batch(step)
                assert list(got) == list(want)
                for key in want:
                    assert got[key].dtype == want[key].dtype, key
                    assert got[key].shape == want[key].shape, key
                    assert got[key].tobytes() == want[key].tobytes(), key


def test_prompt_pipeline_schema():
    b = PromptPipeline(seq_len=96, global_batch=4).batch(0)
    assert b["tokens"].shape == b["mask"].shape == (4, 96)
    assert b["advantages"].shape == (4,)
    assert abs(float(b["advantages"].mean())) < 1e-5
    assert (b["mask"].sum(axis=1) > 0).all()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(2, 24), (10, 100), (1, 5),
                                          (0, 7), (100, 1000), (3, 2),
                                          (50, 5000)])
def test_warmup_cosine_is_equal_in_float32_at_every_step(warmup, total):
    """Bit-equal to the reference as its trainer evaluates it: inside jit
    (one step at a time there; over all steps at once here too)."""
    jitted = jax.jit(lambda s: jax_schedule.linear_warmup_cosine(
        s, warmup, total))
    steps = np.arange(total + 4)
    want = np.asarray(jitted(jnp.asarray(steps, jnp.int32)))
    got = np.stack([schedule.linear_warmup_cosine(int(s), warmup, total)
                    .numpy() for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for s in steps[:: max(1, total // 16)]:
        j = np.asarray(jitted(jnp.asarray(s, jnp.int32)))
        assert j.view(np.int32) == got[s].view(np.int32), s


@pytest.mark.parametrize("total,final", [(1, 0.1), (50, 0.1), (333, 0.0),
                                         (1000, 0.25)])
def test_cosine_schedule_is_equal_in_float32(total, final):
    jitted = jax.jit(lambda s: jax_schedule.cosine_schedule(s, total, final))
    steps = np.arange(total + 2)
    want = np.asarray(jitted(jnp.asarray(steps, jnp.int32)))
    got = np.stack([schedule.cosine_schedule(int(s), total, final).numpy()
                    for s in steps])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((33, 65)) * 3).astype(np.float32),
            "b": (rng.standard_normal(257) * 1e-4).astype(np.float32),
            "zero": np.zeros(9, np.float32),
            "half": np.array([0.5, -1.5, 2.5, 127.0], np.float32)}


def test_compression_matches_the_reference_over_steps():
    jres = jax_gc.init_residual({k: jnp.asarray(v)
                                 for k, v in _grads(0).items()})
    res = grad_compress.init_residual({k: torch.from_numpy(v)
                                       for k, v in _grads(0).items()})
    for step in range(6):
        g = _grads(step)
        jc, jres = jax_gc.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jres)
        c, res = grad_compress.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, res)
        jd, d = jax_gc.decompress(jc), grad_compress.decompress(c)
        for k in g:
            assert c[k].q.dtype == torch.int8
            np.testing.assert_array_equal(c[k].q.numpy(), np.asarray(jc[k].q))
            assert (c[k].scale.numpy().view(np.int32)
                    == np.asarray(jc[k].scale).view(np.int32))
            np.testing.assert_array_equal(d[k].numpy(), np.asarray(jd[k]))
            ulp = np.abs(res[k].numpy().view(np.int32).astype(np.int64)
                         - np.asarray(jres[k]).view(np.int32).astype(np.int64))
            assert ulp.max() <= 1, (k, step)


def test_error_feedback_unbiased_over_steps():
    """Constant gradient: the EF-compressed sum converges to the true sum."""
    g = {"w": torch.from_numpy(np.random.default_rng(0)
                               .standard_normal(256).astype(np.float32))}
    res = grad_compress.init_residual(g)
    total = torch.zeros_like(g["w"])
    n = 50
    for _ in range(n):
        comp, res = grad_compress.compress_with_feedback(g, res)
        total = total + grad_compress.decompress(comp)["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(), atol=2e-2)


def test_compression_ratio():
    g = {"w": torch.zeros(1024)}
    comp, _ = grad_compress.compress_with_feedback(
        g, grad_compress.init_residual(g))
    assert comp["w"].q.dtype == torch.int8      # 4x smaller than fp32
    assert comp["w"].q.element_size() * 4 == g["w"].element_size()


# ---------------------------------------------------------------------------
# fault primitives
# ---------------------------------------------------------------------------
def test_straggler_verdicts_match_the_reference():
    rng = np.random.default_rng(2)
    dts = 0.1 * (1 + 0.1 * rng.random(400))
    for start in rng.choice(390, 30, replace=False):     # slow bursts
        dts[start:start + rng.integers(1, 5)] *= 5
    for kw in ({}, {"threshold": 1.5, "patience": 2, "decay": 0.5}):
        mine, ref = fault.StragglerMonitor(**kw), jax_fault.StragglerMonitor(**kw)
        got = [mine.observe(s, float(dt)) for s, dt in enumerate(dts)]
        want = [ref.observe(s, float(dt)) for s, dt in enumerate(dts)]
        assert got == want
        assert {"ok", "straggler", "mitigate"} <= set(got)
        assert mine.events == ref.events and mine.ema == ref.ema


def test_straggler_monitor_detects():
    m = fault.StragglerMonitor(threshold=2.0, patience=2)
    for s in range(10):
        assert m.observe(s, 0.1) == "ok"
    assert m.observe(10, 0.5) == "straggler"
    assert m.observe(11, 0.5) == "mitigate"
    assert m.observe(12, 0.1) == "ok"


def test_failure_injector_and_elastic_plan_match_the_reference():
    mine = fault.FailureInjector(fail_at_steps=(2, 5))
    ref = jax_fault.FailureInjector(fail_at_steps=(2, 5))
    for step in (0, 1, 2, 2, 3, 5, 5, 6):
        raised = []
        for inj, exc in ((mine, fault.SimulatedFailure),
                         (ref, jax_fault.SimulatedFailure)):
            try:
                inj.check(step)
                raised.append(None)
            except exc as e:
                raised.append(str(e))
        assert raised[0] == raised[1]
    for old, new, gb in ((16, 8, 256), (16, 12, 256), (4, 3, 10), (2, 7, 7)):
        a = fault.ElasticPlan(old, new, gb)
        b = jax_fault.ElasticPlan(old, new, gb)
        assert (a.batch_ok, a.accum_steps) == (b.batch_ok, b.accum_steps)


# ---------------------------------------------------------------------------
# checkpoints and the manager
# ---------------------------------------------------------------------------
def test_manager_rotation_and_latest(tmp_path):
    tree = {"a": torch.zeros(2)}
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(tree, s)
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]            # rotated
    assert mgr.restore(tree)[1] == 4
    assert mgr.restore(tree, step=3)[1] == 3
    assert CheckpointManager(str(tmp_path / "empty")).restore() is None


@pytest.mark.parametrize("async_save", [True, False])
def test_manager_snapshots_before_the_write(tmp_path, async_save):
    """save() copies to the host on the caller's thread: writes to the
    live tensors after it (an optimizer step in place) do not reach the
    checkpoint, for CPU tensors (whose .numpy() aliases) too."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    b = torch.ones(5, dtype=torch.bfloat16)
    arr = np.arange(4, dtype=np.int64)
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save({"w": w, "b": b, "arr": arr}, step=3)
    with torch.no_grad():
        w.mul_(-7.0)
        b.add_(3.0)
    arr += 100
    mgr.wait()
    got, step, _ = mgr.restore({"w": w, "b": b, "arr": arr})
    assert step == 3
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(12, dtype=np.float32).reshape(3, 4))
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].float().numpy(), np.ones(5))
    np.testing.assert_array_equal(got["arr"], np.arange(4))


def test_manager_surfaces_a_failed_write(tmp_path, monkeypatch):
    from repro_torch.ckpt import manager

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(manager, "save_checkpoint", broken)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": torch.zeros(2)}, step=2)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    mgr.wait()                                   # reported once
    assert mgr.latest_step() is None


def test_bfloat16_checkpoints_cross_both_ways(tmp_path):
    """bf16 leaves: the port writes the reference's dtype name and bytes
    (without numpy knowing bfloat16) and reads the reference's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"p": jnp.asarray(x, jnp.bfloat16), "n": jnp.arange(4, dtype=jnp.int32)}
    jax_save(str(tmp_path / "ref"), jtree, step=5)
    got, step, _ = load_checkpoint(str(tmp_path / "ref"))
    assert step == 5 and got["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["p"].float().numpy(),
                                  np.asarray(jtree["p"], np.float32))
    mine = {"p": torch.from_numpy(x).to(torch.bfloat16),
            "n": torch.arange(4, dtype=torch.int32)}
    save_checkpoint(str(tmp_path / "port"), mine, step=6)
    back, step, _ = jax_load(str(tmp_path / "port"), jtree)
    assert step == 6 and back["p"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["p"], np.float32),
                                  mine["p"].float().numpy())
    np.testing.assert_array_equal(np.asarray(back["n"]), np.arange(4))


def test_reference_manager_reads_the_port_managers_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (2, 4, 6):
        mgr.save({"a": torch.full((3,), float(s))}, s)
    mgr.wait()
    ref = JaxManager(str(tmp_path), keep_n=2)
    assert ref.all_steps() == mgr.all_steps() == [4, 6]
    tree, step, _ = ref.restore({"a": jnp.zeros(3)})
    assert step == 6
    np.testing.assert_array_equal(np.asarray(tree["a"]), np.full(3, 6.0))


# ---------------------------------------------------------------------------
# the dense configs of the zoo
# ---------------------------------------------------------------------------
def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)}


@pytest.mark.parametrize("arch", list(configs.ASSIGNED_ARCHS)
                         + ["crinn-policy-100m"])
def test_dense_configs_equal_the_references_field_for_field(arch):
    for reduced in (False, True):
        mine = configs.get_config(arch, reduced=reduced)
        ref = jax_configs.get_config(arch, reduced=reduced)
        assert set(_fields(mine)) == {f.name for f in dataclasses.fields(ref)}
        assert _fields(mine) == {k: getattr(ref, k) for k in _fields(mine)}
        assert mine.param_count() == ref.param_count()
        assert mine.num_periods() == ref.num_periods()
        assert [dataclasses.astuple(s) for s in mine.block_specs()] == [
            dataclasses.astuple(s) for s in ref.block_specs()]
        assert configs.shape_applicable(mine, configs.SHAPES["long_500k"]) == \
            jax_configs.shape_applicable(ref, jax_configs.SHAPES["long_500k"])
    assert mine.reduced(d_model=32).d_model == 32


def test_registry_lists_the_dense_archs_and_the_shapes():
    """The registry and ASSIGNED_ARCHS are the reference's (all ten
    assigned archs, in its order, and the policy), and so are the shapes."""
    assert configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    assert configs.list_archs() == jax_configs.list_archs()
    assert set(configs.list_archs()) == set(configs.ASSIGNED_ARCHS) | {
        "crinn-policy-100m"}
    assert {configs.get_config(a).family for a in configs.ASSIGNED_ARCHS} == {
        "dense", "moe", "hybrid", "ssm", "audio", "vlm"}
    assert configs.SHAPES == {k: configs.InputShape(**dataclasses.asdict(v))
                              for k, v in jax_configs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("dbrx-133b")
    assert not hasattr(configs.ModelConfig, "require_dense")
