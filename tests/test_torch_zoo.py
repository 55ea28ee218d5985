"""Parity of the port's moe, hybrid (Mamba), ssm (RWKV6), audio and vlm
families with the JAX package's on the CPU, at the reduced configs
(``ModelConfig.reduced``) in fp32: the forward's hidden states, the LM
loss, the MoE aux and every gradient; prefill then decode step by step,
fed the reference's tokens; GenerateServer's greedy tokens; Trainer
checkpoints of a prefix config (deepseek) and of a period-8 one (jamba)
restored across both packages; the analytic parameter counts of every
full config.

The reference's ``init_params`` draws the weights and
``from_reference_params`` carries them into the port; tokens come from
numpy seeds; the audio and vlm inputs are the reference's stub embeddings
(``repro.models.frontend.make_embeds``) carried across as arrays.
Tolerance 1e-4 (``tests/test_torch_train.py``'s on activations and
logits; ``tests/test_torch_policy.py``'s on gradients).
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.core.grpo import GRPOConfig as JaxGRPOConfig  # noqa: E402
from repro.data import PromptPipeline as JaxPrompts  # noqa: E402
from repro.models import Runtime as JaxRuntime  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.frontend import make_embeds as jax_make_embeds  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro.runtime.server import GenerateServer as JaxGenerateServer  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.grpo import GRPOConfig  # noqa: E402
from repro_torch.data import PromptPipeline  # noqa: E402
from repro_torch.models import Runtime, frontend, model  # noqa: E402
from repro_torch.models.convert import (from_reference_params,  # noqa: E402
                                        reference_key, reference_leaves)
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.runtime.server import GenerateServer  # noqa: E402

FAMILIES = ["musicgen-medium", "internvl2-26b", "deepseek-moe-16b",
            "dbrx-132b", "jamba-v0.1-52b", "rwkv6-1.6b"]
KNOBS = dict(attn_chunk=8, logit_chunk=8, mamba_chunk=8)
TOL = 1e-4


def _pair(arch, seed=0, **over):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32", **over)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32", **over)
    params = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, params


def _rts(remat="none", **kw):
    return (JaxRuntime(mesh=None, remat=remat, **{**KNOBS, **kw}),
            Runtime(remat=remat, **{**KNOBS, **kw}))


def _batch(jcfg, seed, B, S):
    """The reference's inputs for ``jcfg`` as numpy: tokens, and for the
    frontends the stub embeddings with the tokens as labels."""
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    if jcfg.frontend == "none":
        return {"tokens": toks}
    emb = jax_make_embeds(jax.random.PRNGKey(seed), jcfg, B, S)
    return {"embeds": np.asarray(emb, np.float32), "labels": toks}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_param_counts_and_block_specs_equal_the_references(arch):
    assert list_archs() == sorted(jax_list_archs())
    for reduced in (False, True):
        mine = get_config(arch, reduced=reduced)
        ref = jax_get_config(arch, reduced=reduced)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        assert [dataclasses.astuple(s) for s in mine.block_specs()] == [
            dataclasses.astuple(s) for s in ref.block_specs()]
        assert len(mine.prefix_pattern()) == len(ref.prefix_pattern())
        assert (mine.num_periods(), mine._period_len()) == (
            ref.num_periods(), ref._period_len())


def test_chip_smoke_param_counts_are_the_references():
    """chip_smoke's zoo phase holds each row's param_count against
    constants (the card's machine has no JAX): they are the reference's."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_zoo", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert sorted(a for a, _ in smoke.ZOO_ROWS.values()) == sorted(FAMILIES)
    assert set(smoke.ZOO_ROWS.values()) <= set(smoke.REF_PARAM_COUNT)
    for (arch, layers), n in smoke.REF_PARAM_COUNT.items():
        ref = dataclasses.replace(jax_get_config(arch), num_layers=layers)
        assert n == ref.param_count(), (arch, layers)


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_build_from_the_references_parameters(arch):
    jcfg, cfg, params = _pair(arch)
    m = from_reference_params(params, cfg, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    # init_params draws the same leaves at the reference's scales
    mine = dict(model.init_params(torch.Generator().manual_seed(0), cfg,
                                  device="cpu").named_parameters())
    ref = reference_leaves(params, cfg)
    assert set(mine) == set(ref)
    for name, p in mine.items():
        assert tuple(p.shape) == ref[name].shape, name
        want = float(np.std(ref[name]))
        got = float(p.detach().std()) if p.numel() > 1 else 0.0
        assert abs(got - want) <= 0.15 * want + 1e-6, (name, got, want)
        if want == 0.0:      # constants (a_log, dt_bias, w0, ln_scale, ...)
            np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                       rtol=1e-6, err_msg=name)
    # the checkpoint keys cover the reference's leaves one to one
    keys = {}
    for name in mine:
        key, t = reference_key(name, cfg)
        keys.setdefault(key, set()).add(t)
    flat = {}
    jax_model_leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in jax_model_leaves:
        k = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        flat[k] = leaf.shape
    assert set(keys) == set(flat)
    for key, ts in keys.items():
        if ts == {None}:
            assert not key.startswith("blocks/")
        else:
            assert ts == set(range(flat[key][0])), key


# ---------------------------------------------------------------------------
# forward, loss, aux, gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_loss_aux_and_gradients_match_the_reference(arch):
    """The port with remat none and with block (deepseek's prefix outside
    the remat, jamba's 8-layer period inside it) against the reference's
    values (its remat changes none of them)."""
    jcfg, cfg, params = _pair(arch, seed=1)
    m = from_reference_params(params, cfg, device="cpu")
    jrt, _ = _rts()
    batch = _batch(jcfg, 2, 2, 16)
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    jh, jaux = jax_model.forward_train(params, _j(fwd), jcfg, jrt)

    def objective(p):
        loss, aux = jax_model.lm_loss(p, _j(batch), jcfg, jrt)
        return loss + 0.01 * aux, (loss, aux)

    (_, (jloss, jaux2)), jgrads = jax.value_and_grad(
        objective, has_aux=True)(params)
    want = reference_leaves(jgrads, cfg)
    tb = _t(batch)
    named = dict(m.named_parameters())
    assert set(want) == set(named)
    for remat in ("none", "block"):
        rt = Runtime(remat=remat, **KNOBS)
        with torch.no_grad():
            h, aux = model.forward_train(m, tb.get("tokens"), rt,
                                         embeds=tb.get("embeds"))
        loss, aux2 = model.lm_loss(m, tb, rt)
        grads = torch.autograd.grad(loss + 0.01 * aux2,
                                    list(named.values()),
                                    materialize_grads=True)
        _close(h, jh)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        _close(float(aux), float(jaux), 1e-5)
        _close(float(aux2.detach()), float(jaux2), 1e-5)
        if cfg.moe_num_experts:
            assert float(aux) > 0.0
        else:
            assert float(aux) == 0.0
        for name, g in zip(named, grads):
            _close(g, want[name], TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_the_reference_step_by_step(arch):
    jcfg, cfg, params = _pair(arch, seed=3)
    m = from_reference_params(params, cfg, device="cpu")
    jrt, rt = _rts()
    B, S, steps = 2, 12, 3
    batch = _batch(jcfg, 4, B, S)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, steps)).astype(np.int32)
    prompt = ({"tokens": batch["tokens"]} if "tokens" in batch
              else {"embeds": batch["embeds"]})
    jcaches = jax_model.init_cache(jcfg, B, S + steps + 2)
    jlogits, jcaches, jlen = jax_model.prefill(params, _j(prompt), jcfg, jrt,
                                               jcaches)
    caches = model.init_cache(cfg, B, S + steps + 2, device="cpu")
    tp = _t(prompt)
    logits, caches, clen = model.prefill(m, tp.get("tokens"), rt, caches,
                                         embeds=tp.get("embeds"))
    _close(logits, jlogits)
    assert clen == int(jlen) == S
    for i in range(steps):
        jlogits, jcaches, jlen = jax_model.decode_step(
            params, {"tokens": jnp.asarray(toks[:, i:i + 1])}, jcfg, jrt,
            jcaches, jlen)
        logits, caches, clen = model.decode_step(
            m, torch.from_numpy(toks[:, i:i + 1]), rt, caches, clen)
        _close(logits, jlogits)
    # the recurrent state each layer carries equals the reference's
    ref_state = jcaches["prefix"] + [
        jax.tree.map(lambda a, t=t: a[t], pos)
        for t in range(jcfg.num_periods()) for pos in jcaches["pattern"]]
    for layer, (mine, ref) in enumerate(zip(caches, ref_state)):
        assert set(mine) == set(ref), layer
        for key in ("conv", "ssm", "shift_tm", "shift_cm", "wkv"):
            if key in mine:
                _close(mine[key], ref[key])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-1.6b"])
def test_decode_matches_forward_fp32(arch):
    """The reference's own check (tests/test_models_smoke.py), on the port:
    prefill + one decode step = the forward's last logits, at
    capacity_factor 8 (no MoE drops on either side)."""
    _, cfg, params = _pair(arch)
    m = from_reference_params(params, cfg, device="cpu")
    rt = Runtime(remat="none", capacity_factor=8.0, **KNOBS)
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    with torch.no_grad():
        hidden, _ = model.forward_train(m, toks, rt)
        want = m.embed.logits(hidden[:, -1:])[:, 0]
    caches = model.init_cache(cfg, B, S + 8, device="cpu")
    _, caches, clen = model.prefill(m, toks[:, :-1], rt, caches)
    got, _, _ = model.decode_step(m, toks[:, -1:], rt, caches, clen)
    _close(got, want, 1e-3)


# ---------------------------------------------------------------------------
# GenerateServer and the frontends
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-moe-16b",
                                  "rwkv6-1.6b"])
def test_generate_server_greedy_tokens_match_the_reference(arch):
    jcfg, cfg, params = _pair(arch, seed=2)
    jrt, rt = _rts()
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (3, 10)).astype(np.int32)
    want = JaxGenerateServer(jcfg, params, jrt, batch=3, max_seq=16).generate(
        prompts, 5)
    m = from_reference_params(params, cfg, device="cpu")
    got = GenerateServer(cfg, m, rt, batch=3, max_seq=16).generate(prompts, 5)
    assert got.dtype == np.int32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-26b"])
def test_generate_server_from_embeddings_matches_prefill_and_decode(arch):
    jcfg, cfg, params = _pair(arch, seed=4)
    jrt, rt = _rts()
    emb = _batch(jcfg, 7, 2, 9)["embeds"]
    jcaches = jax_model.init_cache(jcfg, 2, 16)
    logits, jcaches, jlen = jax_model.prefill(
        params, {"embeds": jnp.asarray(emb)}, jcfg, jrt, jcaches)
    want = []
    for _ in range(5):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(nxt))
        logits, jcaches, jlen = jax_model.decode_step(
            params, {"tokens": nxt[:, None]}, jcfg, jrt, jcaches, jlen)
    m = from_reference_params(params, cfg, device="cpu")
    got = GenerateServer(cfg, m, rt, batch=2, max_seq=16).generate(emb, 5)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-26b"])
def test_frontend_stubs_draw_the_references_distribution(arch):
    cfg = get_config(arch)
    g = torch.Generator().manual_seed(0)
    x = frontend.make_embeds(g, cfg, 4, 256)
    assert x.shape == (4, 256, cfg.d_model) and x.dtype == torch.bfloat16
    assert abs(float(x.float().std()) - 0.02) < 0.001
    again = frontend.make_embeds(torch.Generator().manual_seed(0), cfg, 4, 256)
    assert torch.equal(x, again)
    ref = np.asarray(jax_make_embeds(jax.random.PRNGKey(0), jax_get_config(
        arch), 2, 8))
    assert ref.shape == (2, 8, cfg.d_model) and str(ref.dtype) == "bfloat16"
    with pytest.raises(ValueError):
        frontend.make_embeds(g, get_config("glm4-9b"), 1, 1)


# ---------------------------------------------------------------------------
# Trainer checkpoints across both packages
# ---------------------------------------------------------------------------
def _trainers(arch, tmp, seed_port, seed_ref):
    jcfg, cfg, params = _pair(arch, seed=seed_port)
    _, _, other = _pair(arch, seed=seed_ref)
    jrt, rt = _rts("block", attn_chunk=32, logit_chunk=32)
    tk = dict(total_steps=4, warmup_steps=1, ckpt_every=2)
    port = Trainer(cfg, rt, from_reference_params(params, cfg, device="cpu"),
                   tcfg=TrainerConfig(ckpt_dir=str(tmp), **tk),
                   gcfg=GRPOConfig())
    ref = JaxTrainer(jcfg, jrt, other, tcfg=JaxTrainerConfig(
        ckpt_dir=str(tmp), **tk), gcfg=JaxGRPOConfig())
    return cfg, port, ref


def _assert_state_equal(port, ref, cfg):
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


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_trainer_checkpoints_restore_across_both_packages(tmp_path, arch):
    cfg, port, ref = _trainers(arch, tmp_path / "a", 0, 9)
    log = port.run(PromptPipeline(seq_len=32, global_batch=4).batch, steps=2)
    assert all(np.isfinite(r["loss"]) and r["aux"] > 0 for r in log)
    port.ckpt.wait()
    assert ref.try_restore() and ref.step == 2
    _assert_state_equal(port, ref, cfg)

    cfg, port, ref = _trainers(arch, tmp_path / "b", 9, 0)
    ref.run(JaxPrompts(seq_len=32, global_batch=4).batch, steps=2)
    ref.ckpt.wait()
    assert port.try_restore() and port.step == 2
    _assert_state_equal(port, ref, cfg)
