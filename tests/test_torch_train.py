"""Parity of the port's single-device training slice with the JAX
package's on the CPU: the triangle attention schedule, block remat and
``lm_loss``; the dense configs of the zoo at reduced size on converted
reference weights; the Trainer (its checkpoints crossing both ways,
failure replay, resume, and a 5-step run beside the reference's);
``GenerateServer``; and the ``launch.train`` entry point.

The reference's ``init_params`` draws the weights and
``from_reference_params`` carries them into the port; token inputs come
from numpy seeds.  Tolerances are ``tests/test_torch_policy.py``'s (1e-4
on activations and logits, rtol 1e-5 on losses) and the reference's own
(``tests/test_models_smoke.py``: 1e-5 triangle vs masked, rtol 1e-6 remat
vs none, 1e-3 decode vs forward; ``tests/test_trainer.py``: rtol 1e-6 on
a replayed loss).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.grpo import GRPOConfig as JaxGRPOConfig  # noqa: E402
from repro.data import PromptPipeline as JaxPrompts  # noqa: E402
from repro.models import Runtime as JaxRuntime  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.layers import apply_norm as jax_apply_norm  # noqa: E402
from repro.models.layers import unembed as jax_unembed  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro.runtime.server import GenerateServer as JaxGenerateServer  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.core.grpo import GRPOConfig  # noqa: E402
from repro_torch.data import PromptPipeline, TokenPipeline  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import Runtime, model  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.convert import (from_reference_params,  # noqa: E402
                                        reference_leaves)
from repro_torch.models.layers import Norm  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig  # noqa: E402
from repro_torch.runtime.server import GenerateServer  # noqa: E402

#: the dense configs of the zoo (tests/test_torch_zoo.py holds the others)
DENSE_ARCHS = [a for a in ASSIGNED_ARCHS if get_config(a).family == "dense"]
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
            head_dim=16, d_ff=128, dtype="float32")


def _pair(arch, *, reduced=True, dtype="float32", seed=0, **over):
    jcfg = jax_get_config(arch, reduced=reduced)
    cfg = get_config(arch, reduced=reduced)
    jcfg = dataclasses.replace(jcfg, dtype=dtype, **over)
    cfg = dataclasses.replace(cfg, dtype=dtype, **over)
    params = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, params


def _tiny_pair(seed=0, dtype="float32"):
    small = {**TINY, "dtype": dtype}
    jcfg = dataclasses.replace(jax_get_config("crinn-policy-100m"), **small)
    cfg = dataclasses.replace(get_config("crinn-policy-100m"), **small)
    return jcfg, cfg, jax_model.init_params(jax.random.PRNGKey(seed), jcfg)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _rt(**kw):
    return (JaxRuntime(mesh=None, **{"remat": "none", **kw}),
            Runtime(**{"remat": "none", **kw}))


# ---------------------------------------------------------------------------
# attention schedules, remat, lm_loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,softcap,G", [(0, 0.0, 1), (0, 50.0, 2),
                                              (12, 0.0, 4), (5, 30.0, 2),
                                              (40, 0.0, 1)])
def test_chunked_attention_triangle_equals_masked_and_the_reference(
        window, softcap, G):
    rng = np.random.default_rng(window + G)
    B, S, Hk, D = 2, 32, 2, 16
    q, k, v = (rng.standard_normal((B, S, Hk * g, D)).astype(np.float32)
               for g in (G, 1, 1))
    kw = dict(q_scale=D ** -0.5, window=window, softcap=softcap, chunk=8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    masked = chunked_attention(tq, tk, tv, impl="masked", **kw)
    tri = chunked_attention(tq, tk, tv, impl="triangle", **kw)
    _close(tri, masked, 1e-5)
    want = jax_attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="triangle", **kw)
    _close(tri, want, 1e-5)


@pytest.mark.parametrize("arch", ["glm4-9b", "h2o-danube-1.8b", "gemma2-27b"])
def test_forward_triangle_equals_masked(arch):
    jcfg, cfg, params = _pair(arch)
    m = from_reference_params(params, cfg, device="cpu")
    toks = _tokens(1, 2, 32, cfg.vocab_size)
    hs = {}
    for impl in ("masked", "triangle"):
        jrt, rt = _rt(attn_chunk=8, logit_chunk=8, attn_impl=impl)
        with torch.no_grad():
            hs[impl], _ = model.forward_train(m, torch.from_numpy(toks), rt)
        jh, _ = jax_model.forward_train(params, {"tokens": jnp.asarray(toks)},
                                        jcfg, jrt)
        _close(hs[impl], jh, 1e-4)
    _close(hs["triangle"], hs["masked"], 1e-5)


@pytest.mark.parametrize("arch,scan_groups", [("stablelm-1.6b", 1),
                                              ("stablelm-1.6b", 2),
                                              ("gemma2-27b", 1)])
def test_remat_block_matches_none(arch, scan_groups):
    over = {"num_layers": 4} if scan_groups > 1 else {}
    jcfg, cfg, params = _pair(arch, **over)
    m = from_reference_params(params, cfg, device="cpu")
    batch = {"tokens": _tokens(2, 2, 16, cfg.vocab_size)}
    out = {}
    for remat in ("none", "block"):
        rt = Runtime(attn_chunk=8, logit_chunk=8, remat=remat,
                     scan_groups=scan_groups)
        loss, _ = model.lm_loss(m, {"tokens": torch.from_numpy(batch["tokens"])},
                                rt)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out[remat] = (float(loss.detach()), grads)
        jrt = JaxRuntime(mesh=None, attn_chunk=8, logit_chunk=8, remat=remat,
                         scan_groups=scan_groups)
        jloss, _ = jax_model.lm_loss(params, {"tokens": jnp.asarray(
            batch["tokens"])}, jcfg, jrt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out["block"][0], out["none"][0], rtol=1e-6)
    for a, b in zip(out["block"][1], out["none"][1]):
        _close(a, b, 1e-6)


def test_runtime_defaults_are_the_references_and_knobs_are_checked():
    mine, ref = Runtime(), JaxRuntime()
    assert (mine.attn_impl, mine.remat, mine.scan_groups, mine.attn_chunk,
            mine.logit_chunk) == (ref.attn_impl, ref.remat, ref.scan_groups,
                                  ref.attn_chunk, ref.logit_chunk)
    with pytest.raises(ValueError, match="attn_impl"):
        Runtime(attn_impl="flash")
    with pytest.raises(ValueError, match="remat"):
        Runtime(remat="full")


def test_lm_loss_takes_labels_and_a_loss_mask():
    jcfg, cfg, params = _tiny_pair()
    m = from_reference_params(params, cfg, device="cpu")
    jrt, rt = _rt(attn_chunk=8, logit_chunk=8)
    toks = _tokens(3, 3, 12, cfg.vocab_size)
    labels = _tokens(4, 3, 12, cfg.vocab_size)
    mask = (np.random.default_rng(5).random((3, 12)) < 0.6).astype(np.float32)
    for batch in ({"tokens": toks}, {"tokens": toks, "labels": labels},
                  {"tokens": toks, "loss_mask": mask},
                  {"tokens": toks, "labels": labels, "loss_mask": mask}):
        jloss, _ = jax_model.lm_loss(params, {k: jnp.asarray(v) for k, v in
                                              batch.items()}, jcfg, jrt)
        with torch.no_grad():
            loss, aux = model.lm_loss(m, {k: torch.from_numpy(v) for k, v in
                                          batch.items()}, rt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# the dense zoo at reduced size
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_zoo_matches_the_reference(arch):
    jcfg, cfg, params = _pair(arch, seed=1)
    m = from_reference_params(params, cfg, device="cpu")
    assert cfg.param_count() == jcfg.param_count()
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    jrt, rt = _rt(attn_chunk=8, logit_chunk=8)
    toks = _tokens(6, 2, 16, cfg.vocab_size)
    jh, _ = jax_model.forward_train(params, {"tokens": jnp.asarray(toks)},
                                    jcfg, jrt)
    jloss, _ = jax_model.lm_loss(params, {"tokens": jnp.asarray(toks)}, jcfg,
                                 jrt)
    with torch.no_grad():
        h, _ = model.forward_train(m, torch.from_numpy(toks), rt)
        loss, _ = model.lm_loss(m, {"tokens": torch.from_numpy(toks)}, rt)
    assert np.isfinite(h.numpy()).all()
    _close(h, jh, 1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_zoo_decode_matches_forward(arch):
    """prefill + decode == the full forward's last logits (fp32), as the
    reference's test_decode_matches_forward_fp32 holds it."""
    jcfg, cfg, params = _pair(arch)
    m = from_reference_params(params, cfg, device="cpu")
    rt = Runtime(attn_chunk=8, logit_chunk=8, remat="none")
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(7, B, S, cfg.vocab_size))
    with torch.no_grad():
        hidden, _ = model.forward_train(m, toks, rt)
        want = m.embed.logits(hidden[:, -1:])[:, 0]
    caches = model.init_cache(cfg, B, S + 8, device="cpu")
    _, caches, clen = model.prefill(m, toks[:, :-1], rt, caches)
    got, _, _ = model.decode_step(m, toks[:, -1:], rt, caches, clen)
    _close(got, want, 1e-3)
    jwant = jax_unembed(params["embed"], jax_model.forward_train(
        params, {"tokens": jnp.asarray(toks.numpy())}, jcfg,
        JaxRuntime(mesh=None, attn_chunk=8, logit_chunk=8,
                   remat="none"))[0][:, -1:], jcfg)[:, 0]
    _close(got, jwant, 1e-3)


def test_gemma2_norms_match_the_reference():
    """gemma2's unit-offset RMSNorm: both packages store the scale zero-
    centred and apply 1 + scale, so rmsnorm_unit_offset is data."""
    jcfg, cfg, _ = _pair("gemma2-27b")
    assert cfg.rmsnorm_unit_offset and jcfg.rmsnorm_unit_offset
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32) * 3
    scale = rng.standard_normal(cfg.d_model).astype(np.float32) * 0.2
    norm = Norm(cfg, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x))
    want = jax_apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), jcfg)
    _close(got, want, 1e-6)
    with torch.no_grad():
        norm.scale.zero_()
        unit = norm(torch.from_numpy(x))
    rms = np.sqrt((x * x).mean(-1, keepdims=True) + cfg.norm_eps)
    _close(unit, x / rms, 1e-5)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------
def _trainer(cfg, params, d, *, rt=None, **kw):
    tcfg_kw = {k: kw.pop(k) for k in list(kw) if k in
               {f.name for f in dataclasses.fields(TrainerConfig)}}
    m = from_reference_params(params, cfg, device="cpu")
    rt = rt or Runtime(attn_chunk=32, logit_chunk=32, remat="none")
    return Trainer(cfg, rt, m, tcfg=TrainerConfig(ckpt_dir=str(d), **tcfg_kw),
                   gcfg=GRPOConfig(), **kw)


def test_failure_recovery_and_exact_replay(tmp_path):
    _, cfg, params = _tiny_pair()
    pipe = PromptPipeline(seq_len=64, global_batch=4)
    t1 = _trainer(cfg, params, tmp_path, total_steps=10, warmup_steps=2,
                  ckpt_every=4,
                  failure_injector=FailureInjector(fail_at_steps=(6,)))
    log1 = t1.run(pipe.batch)
    assert t1.step == 10
    # the failure forced a rollback to step 4: steps 4 and 5 appear twice;
    # replayed losses must match (determinism)
    by_step = {}
    for rec in log1:
        by_step.setdefault(rec["step"], []).append(rec["loss"])
    assert len(by_step[4]) == len(by_step[5]) == 2
    np.testing.assert_allclose(by_step[4][0], by_step[4][1], rtol=1e-6)
    assert [r["step"] for r in log1] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9]
    assert set(log1[0]) == {"step", "loss", "dt", "straggler", "pg", "kl",
                            "ratio_max", "aux", "grad_norm", "lr"}


def test_resume_from_checkpoint_continues(tmp_path):
    _, cfg, params = _tiny_pair()
    _, _, other = _tiny_pair(seed=9)
    pipe = PromptPipeline(seq_len=64, global_batch=4)
    t1 = _trainer(cfg, params, tmp_path, total_steps=8, warmup_steps=2,
                  ckpt_every=4)
    t1.run(pipe.batch, steps=8)
    t1.ckpt.wait()
    # a "new process": fresh trainer, restore, continue
    t2 = _trainer(cfg, other, tmp_path, total_steps=8, warmup_steps=2,
                  ckpt_every=4)
    assert t2.try_restore()
    assert t2.step == 8
    for name, p in t2.params.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      t1.params[name].detach().numpy())
    t2.run(pipe.batch, steps=2)
    assert t2.step == 10


def test_lm_loss_decreases_on_structured_data(tmp_path):
    """End-to-end sanity: CE training on the bigram-structured pipeline
    learns (loss drops against step 0)."""
    _, cfg, params = _tiny_pair()
    rt = Runtime(attn_chunk=32, logit_chunk=32, remat="none")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=8)
    tr = _trainer(cfg, params, tmp_path, total_steps=30, warmup_steps=3,
                  ckpt_every=1000, opt_cfg=AdamWConfig(lr=3e-3,
                                                       weight_decay=0.0),
                  loss_fn=lambda m, batch: model.lm_loss(m, batch, rt))
    log = tr.run(lambda s: {"tokens": pipe.batch(s)}, steps=30)
    first = np.mean([r["loss"] for r in log[:3]])
    last = np.mean([r["loss"] for r in log[-3:]])
    assert last < first - 0.2, (first, last)


def _jax_trainer(jcfg, params, d, **tcfg_kw):
    jrt = JaxRuntime(mesh=None, attn_chunk=32, logit_chunk=32, remat="block")
    return JaxTrainer(jcfg, jrt, params, tcfg=JaxTrainerConfig(
        ckpt_dir=str(d), **tcfg_kw), gcfg=JaxGRPOConfig())


def _assert_state_equal(port: Trainer, ref, cfg):
    assert port.opt_state["step"] == int(ref.opt_state["step"])
    for group, want in (("params", ref.params), ("m", ref.opt_state["m"]),
                        ("v", ref.opt_state["v"]),
                        ("master", ref.opt_state["master"])):
        mine = port.params if group == "params" else port.opt_state[group]
        want = reference_leaves(want, cfg)
        assert set(mine) == set(want)
        for name, t in mine.items():
            np.testing.assert_array_equal(
                t.detach().float().numpy(), np.asarray(want[name], np.float32),
                err_msg=f"{group} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_trainer_checkpoint_restores_into_the_port(tmp_path, dtype):
    jcfg, cfg, params = _tiny_pair(dtype=dtype)
    _, _, other = _tiny_pair(seed=9, dtype=dtype)
    pipe = JaxPrompts(seq_len=32, global_batch=4)
    ref = _jax_trainer(jcfg, params, tmp_path, total_steps=6, warmup_steps=1,
                       ckpt_every=4)
    ref.run(pipe.batch, steps=4)
    ref.ckpt.wait()
    port = _trainer(cfg, other, tmp_path, total_steps=6, warmup_steps=1,
                    ckpt_every=4)
    assert port.try_restore()
    assert port.step == 4
    _assert_state_equal(port, ref, cfg)
    assert port.params["blocks.1.mixer.wq"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_trainer_checkpoint_restores_into_the_reference(tmp_path, dtype):
    jcfg, cfg, params = _tiny_pair(dtype=dtype)
    _, _, other = _tiny_pair(seed=9, dtype=dtype)
    port = _trainer(cfg, params, tmp_path, total_steps=6, warmup_steps=1,
                    ckpt_every=4)
    port.run(PromptPipeline(seq_len=32, global_batch=4).batch, steps=4)
    port.ckpt.wait()
    ref = _jax_trainer(jcfg, other, tmp_path, total_steps=6, warmup_steps=1,
                       ckpt_every=4)
    assert ref.try_restore()
    assert ref.step == 4
    _assert_state_equal(port, ref, cfg)


def test_five_steps_match_the_reference_trainer(tmp_path):
    """Both trainers from the same weights on the same PromptPipeline
    batches: per-step losses within rtol 1e-4 and the final weights within
    1e-5 on >= 99.9% of elements (a near-zero gradient whose sign differs
    moves an Adam weight by up to ~2 lr a step)."""
    jcfg, cfg, params = _tiny_pair()
    m_rt = Runtime(attn_chunk=32, logit_chunk=32, remat="block")
    port = _trainer(cfg, params, tmp_path / "port", rt=m_rt, total_steps=5,
                    warmup_steps=1, ckpt_every=100)
    ref = _jax_trainer(jcfg, params, tmp_path / "ref", total_steps=5,
                       warmup_steps=1, ckpt_every=100)
    jlog = ref.run(JaxPrompts(seq_len=48, global_batch=4).batch)
    log = port.run(PromptPipeline(seq_len=48, global_batch=4).batch)
    assert [r["step"] for r in log] == [r["step"] for r in jlog] == list(range(5))
    for a, b in zip(log, jlog):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        for key in ("lr", "grad_norm", "pg", "kl"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, atol=1e-6,
                                       err_msg=key)
        assert np.float32(a["lr"]) == np.float32(b["lr"])
    want = reference_leaves(ref.params, cfg)
    diff = np.concatenate([np.abs(p.detach().numpy() - want[n]).ravel()
                           for n, p in port.params.items()])
    lr = AdamWConfig().lr
    assert (diff <= 1e-5).mean() >= 0.999, (diff <= 1e-5).mean()
    assert diff.max() <= 2.5 * lr * 5


# ---------------------------------------------------------------------------
# GenerateServer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["crinn-policy-100m", "h2o-danube-1.8b",
                                  "gemma2-27b"])
def test_generate_server_greedy_tokens_match_the_reference(arch):
    jcfg, cfg, params = _pair(arch, seed=2)
    jrt, rt = _rt(attn_chunk=8, logit_chunk=8)
    prompts = _tokens(9, 3, 10, cfg.vocab_size)
    want = JaxGenerateServer(jcfg, params, jrt, batch=3, max_seq=24).generate(
        prompts, 8)
    m = from_reference_params(params, cfg, device="cpu")
    flash_ops.launches = 0
    got = GenerateServer(cfg, m, rt, batch=3, max_seq=24).generate(prompts, 8)
    assert flash_ops.launches == 0           # CPU tensors: the plain version
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_server_sampling_follows_the_generator():
    _, cfg, params = _tiny_pair()
    m = from_reference_params(params, cfg, device="cpu")
    srv = GenerateServer(cfg, m, Runtime(remat="none"), batch=4, max_seq=20)
    prompts = _tokens(10, 4, 6, cfg.vocab_size)
    runs = [srv.generate(prompts, 10, temperature=1.0,
                         generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < cfg.padded_vocab)).all()
    with pytest.raises(ValueError, match="max_seq"):
        srv.generate(prompts, 15)


# ---------------------------------------------------------------------------
# the launch.train entry point
# ---------------------------------------------------------------------------
def test_launch_train_reduced_on_the_cpu_and_resume(tmp_path, capsys):
    base = ["--reduced", "--device", "cpu", "--seq", "32",
            "--global-batch", "4", "--ckpt-dir", str(tmp_path)]
    log = train_main.main(base + ["--steps", "8"])
    out = capsys.readouterr().out
    assert [r["step"] for r in log] == list(range(8))
    assert all(np.isfinite(r["loss"]) for r in log)
    assert f"done: 8 steps, loss {log[0]['loss']:.3f} -> " in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_5"]
    log2 = train_main.main(base + ["--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 5" in out
    assert [r["step"] for r in log2] == [5, 6, 7]
    assert "done: 3 steps" in out


@pytest.mark.parametrize("flag", [["--debug-mesh", "1x2"],
                                  ["--debug-mesh", "2x1"]])
def test_launch_train_mesh_flags(tmp_path, flag, capfd):
    """--debug-mesh trains on Gloo processes with --device cpu (a model-only
    and a data-only mesh): rank 0 alone prints, and the records it returns
    are finite."""
    log = train_main.main(["--reduced", "--device", "cpu", "--seq", "16",
                           "--steps", "2", "--global-batch", "2",
                           "--ckpt-dir", str(tmp_path), *flag])
    out = capfd.readouterr().out
    assert [r["step"] for r in log] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert out.count("done: 2 steps") == 1
    assert not any(tmp_path.iterdir())
