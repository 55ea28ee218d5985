"""Parity of the port's Mamba and RWKV6 mixers (``repro_torch.models.
{mamba,rwkv}``) with the JAX package's on the CPU, at the reduced jamba
and rwkv6 configs in fp32.

Mamba: train (output and every gradient), prefill (output and state) and
3 decode steps from the prefill's state, at S 16, 20 and 21 with chunk 8
(one chunk of 8 twice; two chunks of 10; one chunk of 21, as the
reference's arithmetic splits them), and prefill at S 2, shorter than the
conv's history.  RWKV6: the time mix and the channel mix, train (output
and gradients), then a prefill and 3 decodes carrying the state.  The
reference's init is zero for the token-shift mixes and the ``u`` bonus;
both packages get the same random values there, so those paths count.
Tolerance 1e-4 (rtol and atol; 1e-5 on outputs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mamba, rwkv  # noqa: E402


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, reduced=True),
                                dtype="float32"))


def _load(mod, p):
    with torch.no_grad():
        for name, t in mod.named_parameters():
            t.copy_(torch.from_numpy(np.array(p[name], np.float32)))


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _grads(jfn, p, x, mod, fn, cot):
    """Gradients of sum(out * cot) over the parameters and the input, in
    both packages: (reference {name: array}, port {name: tensor})."""
    jg = jax.grad(lambda p, x: jnp.sum(jfn(p, x) * cot), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt)
    named = dict(mod.named_parameters())
    g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                            list(named.values()) + [xt],
                            materialize_grads=True)
    return ({**jg[0], "x": jg[1]}, {**dict(zip(named, g[:-1])), "x": g[-1]})


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------
def _mamba(seed=0):
    jcfg, cfg = _cfgs("jamba-v0.1-52b")
    p = jax_mamba.init_mamba(jax.random.PRNGKey(seed), jcfg)
    p = {k: np.array(v, np.float32) for k, v in p.items()}
    p["conv_b"] = _x(seed + 100, p["conv_b"].shape, 0.1)
    mod = mamba.Mamba(cfg, device="cpu")
    _load(mod, p)
    return jcfg, cfg, p, mod


@pytest.mark.parametrize("S,chunks", [(16, [8, 8]), (20, [10, 10]),
                                      (21, [21])])
def test_mamba_train_matches_the_reference(S, chunks):
    jcfg, cfg, p, mod = _mamba()
    csz = mamba.chunk_size(S, 8)
    assert [csz] * (S // csz) == chunks
    x = _x(S, (2, S, cfg.d_model))
    cot = _x(S + 1, (2, S, cfg.d_model))

    def jfn(p, x):
        return jax_mamba.apply_mamba(p, x, jcfg, mode="train", chunk=8)[0]

    want = jfn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    with torch.no_grad():
        out, state = mod(torch.from_numpy(x), mode="train", chunk=8)
    assert state is None
    _close(out, want)
    jg, g = _grads(jfn, p, x, mod,
                   lambda xt: mod(xt, mode="train", chunk=8)[0], cot)
    assert set(jg) == set(g)
    for name in g:
        _close(g[name], jg[name], 1e-4)


@pytest.mark.parametrize("S", [2, 16, 20, 21])
def test_mamba_prefill_then_decode_matches_the_reference(S):
    jcfg, cfg, p, mod = _mamba(seed=1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    B = 2
    x = _x(S + 7, (B, S, cfg.d_model))
    h0 = _x(S + 8, (B, 2 * cfg.d_model, cfg.mamba_d_state), 0.1)
    jstate = {"conv": jnp.zeros((B, cfg.mamba_d_conv - 1, 2 * cfg.d_model)),
              "ssm": jnp.asarray(h0)}
    jout, jstate = jax_mamba.apply_mamba(jp, jnp.asarray(x), jcfg,
                                         mode="prefill", state=jstate, chunk=8)
    state = mamba.make_state(cfg, B, torch.float32, "cpu")
    state["ssm"] = torch.from_numpy(h0)
    with torch.no_grad():
        out, state = mod(torch.from_numpy(x), mode="prefill", state=state,
                         chunk=8)
    _close(out, jout)
    assert state["conv"].shape == (B, cfg.mamba_d_conv - 1, 2 * cfg.d_model)
    _close(state["conv"], jstate["conv"])
    _close(state["ssm"], jstate["ssm"])
    if S < cfg.mamba_d_conv - 1:       # the tail keeps the zero pad
        assert not state["conv"][:, : cfg.mamba_d_conv - 1 - S].any()
    for i in range(3):
        xt = _x(100 + i, (B, 1, cfg.d_model))
        jout, jstate = jax_mamba.apply_mamba(jp, jnp.asarray(xt), jcfg,
                                             mode="decode", state=jstate)
        with torch.no_grad():
            out, state = mod(torch.from_numpy(xt), mode="decode", state=state)
        _close(out, jout)
        _close(state["conv"], jstate["conv"])
        _close(state["ssm"], jstate["ssm"])


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_the_sequential_recurrence(n):
    a = torch.from_numpy(_x(n, (3, n, 4), 0.5)).abs()
    b = torch.from_numpy(_x(n + 1, (3, n, 4)))
    _, h = mamba.associative_scan(a, b)
    want = jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]),
        (jnp.asarray(a.numpy()), jnp.asarray(b.numpy())), axis=1)[1]
    _close(h, want, 1e-6)
    carry, seq = torch.zeros(3, 4), []
    for t in range(n):
        carry = a[:, t] * carry + b[:, t]
        seq.append(carry)
    _close(h, torch.stack(seq, dim=1), 1e-5)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
def _rwkv(seed=0):
    jcfg, cfg = _cfgs("rwkv6-1.6b")
    kt, kc = jax.random.split(jax.random.PRNGKey(seed))
    tm = {k: np.array(v, np.float32) for k, v in
          jax_rwkv.init_rwkv_time_mix(kt, jcfg).items()}
    cm = {k: np.array(v, np.float32) for k, v in
          jax_rwkv.init_rwkv_channel_mix(kc, jcfg).items()}
    for i, key in enumerate(("mu", "mu_x", "u")):
        tm[key] = _x(seed + 10 + i, tm[key].shape, 0.5)
    for i, key in enumerate(("mu_k", "mu_r")):
        cm[key] = _x(seed + 20 + i, cm[key].shape, 0.5)
    t_mod, c_mod = rwkv.TimeMix(cfg, device="cpu"), rwkv.ChannelMix(cfg, "cpu")
    _load(t_mod, tm)
    _load(c_mod, cm)
    return jcfg, cfg, tm, cm, t_mod, c_mod


def test_rwkv_reduced_config_is_attention_free():
    _, cfg = _cfgs("rwkv6-1.6b")
    assert cfg.num_heads == 0 and all(s.kind == "rwkv6"
                                      for s in cfg.block_specs())
    full = get_config("rwkv6-1.6b")
    assert full.num_heads == full.head_dim == 0
    with pytest.raises(ZeroDivisionError):
        full.q_scale          # nothing on the rwkv path may touch it


@pytest.mark.parametrize("which", ["time", "channel"])
def test_rwkv_train_matches_the_reference(which):
    jcfg, cfg, tm, cm, t_mod, c_mod = _rwkv()
    jf = jax_rwkv.apply_time_mix if which == "time" else jax_rwkv.apply_channel_mix
    p, mod = (tm, t_mod) if which == "time" else (cm, c_mod)
    x = _x(1, (2, 11, cfg.d_model))
    cot = _x(2, (2, 11, cfg.d_model))

    def jfn(p, x):
        return jf(p, x, jcfg, mode="train")[0]

    with torch.no_grad():
        out, state = mod(torch.from_numpy(x), mode="train")
    assert state is None
    _close(out, jfn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    jg, g = _grads(jfn, p, x, mod, lambda xt: mod(xt, mode="train")[0], cot)
    for name in g:
        _close(g[name], jg[name], 1e-4)


def test_rwkv_prefill_then_decode_carries_the_state():
    jcfg, cfg, tm, cm, t_mod, c_mod = _rwkv(seed=3)
    jtm = {k: jnp.asarray(v) for k, v in tm.items()}
    jcm = {k: jnp.asarray(v) for k, v in cm.items()}
    B = 2
    jstate = jax_rwkv.make_state(jcfg, B, jnp.float32)
    state = rwkv.make_state(cfg, B, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: v.shape for k, v in jstate.items()}
    for step, S in enumerate([9, 1, 1, 1]):
        mode = "prefill" if step == 0 else "decode"
        x = _x(30 + step, (B, S, cfg.d_model))
        jy, jnew = jax_rwkv.apply_time_mix(jtm, jnp.asarray(x), jcfg,
                                           mode=mode, state=jstate)
        jz, jcm_state = jax_rwkv.apply_channel_mix(
            jcm, jnp.asarray(x), jcfg, mode=mode,
            state=jstate if mode == "decode" else None)
        jstate = {**jstate, **jnew, **jcm_state}
        with torch.no_grad():
            y, new = t_mod(torch.from_numpy(x), mode=mode, state=state)
            z, cm_state = c_mod(torch.from_numpy(x), mode=mode,
                                state=state if mode == "decode" else None)
        state = {**state, **new, **cm_state}
        _close(y, jy)
        _close(z, jz)
        for key in ("shift_tm", "shift_cm", "wkv"):
            _close(state[key], jstate[key])
