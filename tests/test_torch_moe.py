"""Parity of the port's MoE layer (``repro_torch.models.moe``) with the
JAX package's local path (``repro.models.moe``) on the CPU, on the MoE
blocks of the reduced deepseek, dbrx and jamba configs in fp32: the
router's expert ids (also with a zero router, where every probability
ties), weights and aux loss; each assignment's position within its expert
and the set of assignments capacity drops; ``apply_moe``'s output and aux
at capacity factors that drop (0.25) and that do not (8.0).

The reference's positions are read from its own
``_dispatch_compute_combine``, probed at every capacity: with one-hot
tokens, identity experts scaled per expert and the weight of one slot
at a time, token t's output is non-zero exactly when its assignment to
that slot was kept, so an assignment's position is the least capacity
that keeps it, less one.  Tolerances rtol 1e-5 / atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["deepseek-moe-16b", "dbrx-132b", "jamba-v0.1-52b"]
RTOL, ATOL = 1e-5, 1e-6


def _pair(arch, seed=0, zero_router=False):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    p = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    p = {k: np.array(v, np.float32) for k, v in p.items()}
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    layer = moe.MoE(cfg, device="cpu")
    _load(layer, p)
    return jcfg, cfg, p, layer


def _load(layer, p):
    with torch.no_grad():
        for name, t in layer.named_parameters():
            t.copy_(torch.from_numpy(p[name]))


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_ids_weights_and_aux_match_the_reference(arch, zero_router):
    jcfg, cfg, p, _ = _pair(arch, zero_router=zero_router)
    x = _x(1, (40, cfg.d_model))
    jw, jids, jaux = jax_moe._route(jnp.asarray(p["router"]), jnp.asarray(x),
                                    jcfg.moe_top_k)
    w, ids, aux = moe.route(torch.from_numpy(p["router"]), torch.from_numpy(x),
                            cfg.moe_top_k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)
    _close(float(aux), float(jaux))
    if zero_router:          # all probabilities tie: the lowest ids win
        np.testing.assert_array_equal(
            ids.numpy(), np.broadcast_to(np.arange(cfg.moe_top_k), ids.shape))
        _close(w, np.full(ids.shape, 1.0 / cfg.moe_top_k))


def _probe_weights(e, d, ff):
    """One-hot-preserving experts: y = silu(10) * (expert + 1) * buf."""
    eye = np.eye(d, ff, dtype=np.float32)
    return {"w_gate": np.broadcast_to(10 * eye, (e, d, ff)).copy(),
            "w_in": np.broadcast_to(eye, (e, d, ff)).copy(),
            "w_out": (np.arange(1, e + 1, dtype=np.float32)[:, None, None]
                      * np.eye(ff, d, dtype=np.float32))}


def _kept(dispatch, T, k, caps):
    """kept[c][t, j]: whether slot j of token t survives capacity c."""
    out = {}
    for c in caps:
        keep = np.zeros((T, k), bool)
        for j in range(k):
            w = np.zeros((T, k), np.float32)
            w[:, j] = 1.0
            y = dispatch(np.eye(T, dtype=np.float32), w, c)
            keep[:, j] = np.diagonal(y) > 0
        out[c] = keep
    return out


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_positions_and_dropped_assignments_match_the_reference(arch,
                                                               zero_router):
    jcfg, cfg, p, layer = _pair(arch, seed=2, zero_router=zero_router)
    e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
    T = 24
    x = _x(3, (T, d))
    _, jids, _ = jax_moe._route(jnp.asarray(p["router"]), jnp.asarray(x), k)
    ids = np.asarray(jids)
    probe = _probe_weights(e, d, cfg.moe_d_ff)
    _load(layer, {**p, **probe})
    jprobe = {k_: jnp.asarray(v) for k_, v in probe.items()}

    def ref_dispatch(xe, w, c):
        xe = np.pad(xe, ((0, 0), (0, d - T)))
        return np.asarray(jax_moe._dispatch_compute_combine(
            jprobe, jnp.asarray(xe), jnp.asarray(w), jnp.asarray(ids), jcfg,
            c, 0, e))[:, :T]

    def port_dispatch(xe, w, c):
        xe = np.pad(xe, ((0, 0), (0, d - T)))
        with torch.no_grad():
            return layer.dispatch_compute_combine(
                torch.from_numpy(xe), torch.from_numpy(w),
                torch.from_numpy(ids).long(), c).numpy()[:, :T]

    caps = range(1, T + 2)
    ref, mine = _kept(ref_dispatch, T, k, caps), _kept(port_dispatch, T, k,
                                                        caps)
    for c in caps:
        np.testing.assert_array_equal(mine[c], ref[c], err_msg=f"capacity {c}")
    # an assignment's position is the least capacity that keeps it, less one
    ref_pos = np.full((T, k), -1)
    for c in reversed(caps):
        ref_pos[ref[c]] = c - 1
    pos = moe.positions(torch.from_numpy(ids).long(), e).numpy().reshape(T, k)
    np.testing.assert_array_equal(pos, ref_pos)
    assert (~ref[1]).any() and ref[T + 1].all(), "the probe is idle"
    if zero_router:          # experts 0..k-1 take every token in order
        np.testing.assert_array_equal(pos, np.repeat(np.arange(T)[:, None], k,
                                                     axis=1))


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_the_reference(arch, zero_router, cf):
    jcfg, cfg, p, layer = _pair(arch, seed=4, zero_router=zero_router)
    x = _x(5, (2, 12, cfg.d_model))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jout, jaux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg,
                                   capacity_factor=cf)
    with torch.no_grad():
        out, aux = layer(torch.from_numpy(x), cf)
    _close(out, jout)
    _close(float(aux), float(jaux))
    T, k, e = 24, cfg.moe_top_k, cfg.moe_num_experts
    cap = moe.capacity(T, k, e, cf)
    assert cap == jax_moe._capacity(T, k, e, cf)
    _, ids, _ = moe.route(layer.router.detach(), torch.from_numpy(x).reshape(
        T, -1), k)
    dropped = int((moe.positions(ids, e) >= cap).sum())
    if cf == 0.25 and zero_router:
        assert dropped == T * k - k * cap > 0
    if cf == 8.0:
        assert dropped == 0


def test_capacity_is_the_references():
    for T in (1, 4, 24, 1024, 2048):
        for k, e in ((2, 16), (6, 64), (4, 16)):
            for cf in (0.25, 1.25, 8.0):
                assert moe.capacity(T, k, e, cf) == jax_moe._capacity(
                    T, k, e, cf)
