"""Parity of the port's policy LM, GRPO loss and AdamW with the JAX
package's on the CPU, at the small config of ``tests/test_system.py``.

The reference's ``init_params`` draws the weights; ``from_reference_params``
carries them into the port, so both sides compute with the same numbers.
Token inputs come from numpy seeds.  The port's prefill runs the flash
op's plain version here (a CPU tensor); the reference's runs its jnp
chunked attention.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import grpo as jax_grpo  # noqa: E402
from repro.core.policy import Policy as JaxPolicy  # noqa: E402
from repro.models import Runtime as JaxRuntime  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import grpo  # noqa: E402
from repro_torch.core.policy import Policy  # noqa: E402
from repro_torch.core.prompting import VOCAB_SIZE, build_prompt  # noqa: E402
from repro_torch.core.variant_space import Program, knob_count  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.models import Runtime  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.convert import from_reference_params, reference_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
             head_dim=32, d_ff=256, dtype="float32")
LR = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_get_config("crinn-policy-100m"), **SMALL)
    cfg = dataclasses.replace(get_config("crinn-policy-100m"), **SMALL)
    jrt = JaxRuntime(mesh=None, attn_chunk=64, logit_chunk=64, remat="none")
    rt = Runtime(attn_chunk=64, logit_chunk=64)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    m = from_reference_params(params, cfg, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jrt=jrt, rt=rt, params=params, model=m)


def _dense_config(jcfg) -> ModelConfig:
    """The port's config from the reference's dense fields only."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _tokens(seed, B, T):
    return np.random.default_rng(seed).integers(0, VOCAB_SIZE, (B, T)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_config_and_param_count_match_the_reference():
    jcfg, cfg = jax_get_config("crinn-policy-100m"), get_config("crinn-policy-100m")
    assert cfg.param_count() == jcfg.param_count()
    assert 113e6 < cfg.param_count() < 115e6
    assert (cfg.padded_vocab, cfg.q_scale, cfg.num_periods()) == (
        jcfg.padded_vocab, jcfg.q_scale, jcfg.num_periods())
    assert all(s.kind == "attention" and not s.moe
               for s in jcfg.layer_pattern())
    assert [s.attn_window for s in cfg.layer_pattern()] == [
        s.attn_window for s in jcfg.layer_pattern()]


def test_other_families_raise():
    cfg = dataclasses.replace(get_config("crinn-policy-100m"), family="moe")
    with pytest.raises(NotImplementedError, match="queue item 8"):
        model.DecoderLM(cfg, device="cpu")


def test_init_params_follow_the_reference_scales(pair):
    cfg = pair["cfg"]
    m = model.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mine = dict(m.named_parameters())
    ref = reference_leaves(pair["params"], cfg)
    assert set(mine) == set(ref)
    for name, p in mine.items():
        assert tuple(p.shape) == ref[name].shape, name
        assert p.dtype == torch.float32
        want = float(np.std(ref[name]))
        got = float(p.detach().std()) if p.numel() > 1 else 0.0
        assert abs(got - want) <= 0.1 * want + 1e-7, (name, got, want)


def test_forward_train_and_token_logprobs_match(pair):
    toks = _tokens(0, 3, 20)
    jh, _ = jax_model.forward_train(pair["params"], {"tokens": jnp.asarray(toks)},
                                    pair["jcfg"], pair["jrt"])
    jlp = jax_model.token_logprobs(pair["params"], jh[:, :-1],
                                   jnp.asarray(toks[:, 1:]), pair["jcfg"],
                                   pair["jrt"])
    t = torch.from_numpy(toks)
    with torch.no_grad():
        h, _ = model.forward_train(pair["model"], t, pair["rt"])
        lp = model.token_logprobs(pair["model"], h[:, :-1], t[:, 1:], pair["rt"])
    _close(h, jh, 1e-4)
    _close(lp, jlp, 1e-4)


def test_prefill_and_decode_match(pair):
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    toks = _tokens(1, 6, 17)
    steps = _tokens(2, 6, 6)
    size = 17 + 6 + 1
    jc = jax_model.init_cache(jcfg, 6, size)
    jlog, jc, jlen = jax_model.prefill(pair["params"], {"tokens": jnp.asarray(toks)},
                                       jcfg, pair["jrt"], jc)
    caches = model.init_cache(cfg, 6, size, device="cpu")
    flash_ops.launches = 0
    log, caches, clen = model.prefill(pair["model"], torch.from_numpy(toks),
                                      pair["rt"], caches)
    assert flash_ops.launches == 0 and clen == int(jlen) == 17
    _close(log, jlog, 1e-4)
    for s in range(6):
        jlog, jc, jlen = jax_model.decode_step(
            pair["params"], {"tokens": jnp.asarray(steps[:, s:s + 1])}, jcfg,
            pair["jrt"], jc, jlen)
        log, caches, clen = model.decode_step(
            pair["model"], torch.from_numpy(steps[:, s:s + 1]), pair["rt"],
            caches, clen)
        _close(log, jlog, 1e-4)
    assert clen == int(jlen)
    _close(caches[1]["k"], jc["pattern"][0]["k"][1], 1e-4)


@pytest.mark.parametrize("module", ["search", "graph_construction",
                                    "refinement"])
def test_sample_group_at_temperature_zero_matches(pair, module):
    jpol = JaxPolicy(pair["jcfg"], pair["params"], pair["jrt"])
    pol = Policy(pair["cfg"], pair["model"], pair["rt"])
    ex = [(Program(module, (0,) * knob_count(module)), 1.3)]
    prompt = build_prompt(module, ex)
    want = jpol.sample_group(module, prompt, 6, jax.random.PRNGKey(0),
                             temperature=0.0)
    got = pol.sample_group(module, prompt, 6, None, temperature=0.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.mask, w.mask)
        assert g.program is not None
        assert (g.program.module, g.program.choices) == (w.program.module,
                                                         w.program.choices)
        _close(g.logps, w.logps, 1e-4)


def test_sampling_follows_the_generator(pair):
    pol = Policy(pair["cfg"], pair["model"], pair["rt"])
    prompt = build_prompt("graph_construction", [])
    runs = [pol.sample_group("graph_construction", prompt, 8,
                             torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    toks = [np.stack([r.tokens for r in run]) for run in runs]
    np.testing.assert_array_equal(toks[0], toks[1])
    assert not np.array_equal(toks[0], toks[2])
    for r in runs[0]:
        assert r.program is not None and np.isfinite(r.logps).all()
        assert (r.logps <= 0).all()


def _grpo_batch(seed=3, B=6, T=14, n_comp=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB_SIZE, (B, T)).astype(np.int32)
    mask = np.zeros((B, T), np.float32)
    mask[:, T - n_comp:] = 1.0
    mask[0, -1] = 0.0                       # a ragged (padded) row
    old = (-6.0 + 0.4 * rng.standard_normal((B, T))).astype(np.float32) * mask
    ref = (old + 0.2 * rng.standard_normal((B, T)).astype(np.float32)) * mask
    adv = rng.standard_normal(B).astype(np.float32)
    return {"tokens": toks, "mask": mask, "advantages": adv,
            "old_logps": old, "ref_logps": ref}


def test_grpo_loss_metrics_and_grads_match(pair):
    gcfg = jax_grpo.GRPOConfig(group_size=6)
    batch = _grpo_batch()
    (jloss, jm), jgrads = jax_grpo.grpo_loss_and_grad(
        pair["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        pair["jcfg"], pair["jrt"], gcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, m), grads = grpo.grpo_loss_and_grad(
        pair["model"], tb, pair["rt"], grpo.GRPOConfig(group_size=6))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for key in ("pg", "kl", "ratio_max"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    assert float(m["kl"]) > 0 and float(m["ratio_max"]) > 1.2   # clip engaged
    want = reference_leaves(jgrads, pair["cfg"])
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3 * scale,
                                   err_msg=name)


def test_one_adamw_step_matches(pair):
    gcfg = jax_grpo.GRPOConfig(group_size=6)
    batch = _grpo_batch(seed=4)
    _, jgrads = jax_grpo.grpo_loss_and_grad(
        pair["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        pair["jcfg"], pair["jrt"], gcfg)
    jcfg_opt = jax_adamw.AdamWConfig(lr=LR, weight_decay=0.0)
    jstate = jax_adamw.adamw_init(pair["params"], jcfg_opt)
    jnew, _, jmet = jax_adamw.adamw_update(pair["params"], jgrads, jstate,
                                           jcfg_opt)

    m = from_reference_params(pair["params"], pair["cfg"], device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = grpo.grpo_loss_and_grad(m, tb, pair["rt"],
                                       grpo.GRPOConfig(group_size=6))
    params = dict(m.named_parameters())
    ocfg = adamw.AdamWConfig(lr=LR, weight_decay=0.0)
    state = adamw.adamw_init(params, ocfg)
    met = adamw.adamw_update(params, grads, state, ocfg)
    assert state["step"] == 1
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=1e-4)
    want = reference_leaves(jnew, pair["cfg"])
    n_close = n_all = 0
    for name, p in params.items():
        diff = np.abs(p.detach().numpy() - want[name])
        # step 1 moves a weight by lr * g / (|g| + eps): a near-zero gradient
        # of the other sign moves it by up to 2 lr
        assert diff.max() <= 2.5 * LR, name
        n_close += int((diff <= 1e-6).sum())
        n_all += diff.size
    assert n_close >= 0.999 * n_all
    init = reference_leaves(pair["params"], pair["cfg"])
    assert all(np.abs(p.detach().numpy() - init[n]).max() > 0
               for n, p in params.items())


@pytest.mark.parametrize("quant", [False, True])
def test_adamw_update_matches_reference_on_random_trees(quant):
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 300), "b": (130,), "c": (3, 4, 7)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
          for _ in range(3)]
    jc = jax_adamw.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=5.0,
                               quant_state=quant)
    tc = adamw.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=5.0,
                           quant_state=quant)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jax_adamw.adamw_init(jp, jc)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = adamw.adamw_init(tp, tc)
    for g in gs:
        jp, js, _ = jax_adamw.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                           js, jc)
        adamw.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tc)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(float(adamw.global_norm(tp.values())),
                               float(jax_adamw.global_norm(jp)), rtol=1e-6)


def test_group_advantages_use_population_std():
    r = np.array([0.0, 1.2, 0.9, 1.0, 0.0, 1.7], np.float32)
    got = grpo.group_advantages(torch.from_numpy(r)).numpy()
    want = np.asarray(jax_grpo.group_advantages(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # ddof 1 would give a different answer: the trap this guards
    ddof1 = (r - r.mean()) / (r.std(ddof=1) + 1e-6)
    assert np.abs(got - ddof1).max() > 1e-2
    const = grpo.group_advantages(torch.full((4,), 0.7)).numpy()
    np.testing.assert_allclose(const, 0.0, atol=1e-6)


@pytest.mark.parametrize("arch", ["gemma2-27b", "stablelm-1.6b",
                                  "h2o-danube-1.8b"])
def test_other_dense_configs_match(arch):
    """The dense family's other features at reduced size: sliding windows
    with a ring cache, logit softcaps, post-block norms, GeGLU, embedding
    scale, query scale (gemma2), LayerNorm and partial RoPE (stablelm),
    GQA (h2o-danube)."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32")
    cfg = _dense_config(jcfg)
    assert [s.attn_window for s in cfg.block_specs()] == [
        s.attn_window for s in jcfg.layer_pattern() * jcfg.num_periods()]
    jrt = JaxRuntime(mesh=None, attn_chunk=4, logit_chunk=4, remat="none")
    rt = Runtime(attn_chunk=4, logit_chunk=4)
    params = jax_model.init_params(jax.random.PRNGKey(1), jcfg)
    m = from_reference_params(params, cfg, device="cpu")
    toks = _tokens(5, 2, 12) % 256
    jh, _ = jax_model.forward_train(params, {"tokens": jnp.asarray(toks)},
                                    jcfg, jrt)
    h, _ = model.forward_train(m, torch.from_numpy(toks), rt)
    _close(h.detach(), jh, 1e-4)
    size = 16
    jc = jax_model.init_cache(jcfg, 2, size)
    jlog, jc, jlen = jax_model.prefill(params, {"tokens": jnp.asarray(toks)},
                                       jcfg, jrt, jc)
    caches = model.init_cache(cfg, 2, size, device="cpu")
    log, caches, clen = model.prefill(m, torch.from_numpy(toks), rt, caches)
    _close(log, jlog, 1e-4)
    for s in range(3):
        nxt = toks[:, s:s + 1]
        jlog, jc, jlen = jax_model.decode_step(
            params, {"tokens": jnp.asarray(nxt)}, jcfg, jrt, jc, jlen)
        log, caches, clen = model.decode_step(m, torch.from_numpy(nxt), rt,
                                              caches, clen)
        _close(log, jlog, 1e-4)
