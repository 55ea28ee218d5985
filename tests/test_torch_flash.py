"""Parity of the port's flash-attention op with the JAX package's on the
CPU: the port's ``causal_attention`` runs its plain version for a CPU
tensor; the JAX op runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it.  Inputs come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash.ops import causal_attention as jax_attention  # noqa: E402
from repro.kernels.flash.ref import flash_ref as jax_flash_ref  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels.flash import ops  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402


def _qkv(B, S, Hq, Hk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hk, D)).astype(np.float32),
            rng.standard_normal((B, S, Hk, D)).astype(np.float32))


@pytest.fixture(autouse=True)
def _zero_counter():
    ops.launches = 0
    yield
    assert ops.launches == 0      # CPU tensors never reach the kernel


# the reference's five shapes (tests/test_kernels.py) and the policy's
# prefill shape
SHAPES = [
    (2, 256, 4, 2, 64, 0, 0.0),
    (1, 256, 8, 8, 128, 0, 50.0),
    (2, 256, 4, 1, 80, 128, 0.0),
    (1, 512, 2, 2, 64, 0, 0.0),
    (1, 128, 16, 4, 128, 64, 30.0),
    (6, 35, 12, 12, 64, 0, 0.0),
]


@pytest.mark.parametrize("B,S,Hq,Hk,D,win,cap", SHAPES)
def test_causal_attention_matches_jax(B, S, Hq, Hk, D, win, cap):
    q, k, v = _qkv(B, S, Hq, Hk, D)
    got = ops.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), q_scale=D ** -0.5,
                               window=win, softcap=cap).numpy()
    assert got.shape == (B, S, Hq, D) and got.dtype == np.float32
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(q_scale=D ** -0.5, window=win, softcap=cap)
    for want in (jax_attention(*args, **kw), jax_flash_ref(*args, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


def test_causality():
    """Changing future kv must not change past outputs."""
    B, S, H, D = 1, 256, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, S, H, H, D))
    o1 = ops.causal_attention(q, k, v, q_scale=D ** -0.5)
    k2, v2 = k.clone(), v.clone()
    k2[:, S // 2:] = 0.0
    v2[:, S // 2:] = 9.0
    o2 = ops.causal_attention(q, k2, v2, q_scale=D ** -0.5)
    np.testing.assert_allclose(o1[:, : S // 2], o2[:, : S // 2],
                               rtol=1e-5, atol=1e-5)


def test_bf16_inputs_give_bf16_output():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(2, 35, 4, 2, 80))
    got = ops.causal_attention(q, k, v, q_scale=80 ** -0.5)
    assert got.dtype == torch.bfloat16
    want = jax_flash_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                         q_scale=80 ** -0.5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("B,S,Hq,Hk,D,win,cap", [
    (2, 64, 4, 2, 32, 0, 0.0), (1, 96, 4, 1, 16, 40, 30.0)])
@pytest.mark.parametrize("impl", ["masked", "triangle"])
def test_train_path_chunked_attention_matches_jax(B, S, Hq, Hk, D, win, cap,
                                                  impl):
    """The port's one train-path form (every chunk pair, masked) against
    both of the reference's pair schedules."""
    q, k, v = _qkv(B, S, Hq, Hk, D, seed=3)
    kw = dict(q_scale=D ** -0.5, window=win, softcap=cap, chunk=32)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw)
    want = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       impl=impl, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bad", ["rank", "dtype", "mixed", "group", "dim",
                                 "strided", "shape", "device"])
def test_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, 16))
    if bad == "rank":
        q = q[0]
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed":
        v = v.bfloat16()
    elif bad == "group":
        q = torch.zeros(1, 8, 3, 16)
    elif bad == "dim":
        q, k, v = (torch.zeros(t.shape[:3] + (136,)) for t in (q, k, v))
    elif bad == "strided":
        k = torch.zeros(1, 8, 2, 32)[..., ::2]
    elif bad == "shape":
        v = v[:, :4]
    elif bad == "device":
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.causal_attention(q, k, v, q_scale=0.25)
