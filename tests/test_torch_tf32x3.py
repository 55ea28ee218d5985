"""The numerics that the port's tensor-core kernels (``csrc/distance.cu``,
``csrc/flash.cu``, through ``csrc/tf32x3.cuh``) rely on, emulated on the
CPU.

A TF32 product keeps 10 mantissa bits of each operand.  The kernels split
each fp32 operand into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi)
and take lo*hi + hi*lo + hi*hi in fp32 (3xTF32).  Here cvt.rna is bit
arithmetic, each product of TF32 values is exact in fp32, and the sums run
in fp32 over k-chunks of 8 as an m16n8k8 product does.  The emulated kernels
are held at chip_smoke.py's shapes, within the tolerances the reference
holds its own kernels to, against the plain versions and the JAX package's
kernels (Pallas in interpret mode, as ``tests/test_kernels.py`` runs them).
One TF32 pass is emulated too: its error goes into the failure message and
the test's properties, as the reason for three passes, and is not asserted.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.distance.ops import pairwise_distance as jax_pairwise  # noqa: E402
from repro.kernels.flash.ops import causal_attention as jax_attention  # noqa: E402
from repro.kernels.qdist.ops import quantized_distance as jax_qdist  # noqa: E402
from repro_torch.kernels.distance.ref import distance_ref  # noqa: E402
from repro_torch.kernels.flash.ref import flash_ref  # noqa: E402
from repro_torch.kernels.qdist.ref import qdist_ref, quantize_ref  # noqa: E402


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
NEG_INF = -2.0 ** 30


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round fp32 to 10 mantissa bits, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def product(a, b, eq: str, passes: int, k_axis_a: int, k_axis_b: int):
    """einsum(eq, a, b) in TF32 passes over k-chunks of 8, summed in fp32:
    3 = lo*hi + hi*lo + hi*hi (distance, flash), 2 = lo*hi + hi*hi (b
    exact in TF32: qdist's int8 codes), 1 = hi*hi alone."""
    ah, al = split(a)
    bh, bl = split(b)
    k = a.shape[k_axis_a]
    out = None
    for k0 in range(0, k, 8):
        def cut(t, axis):
            return t.narrow(axis, k0, min(8, k - k0))
        terms = {1: [(ah, bh)], 2: [(al, bh), (ah, bh)],
                 3: [(al, bh), (ah, bl), (ah, bh)]}[passes]
        for x, y in terms:
            part = torch.einsum(eq, cut(x, k_axis_a), cut(y, k_axis_b))
            out = part if out is None else out + part
    return out


def distance_tf32(q, x, metric, passes):
    dots = product(q, x, "mk,nk->mn", passes, 1, 1)
    if metric == "ip":
        return -dots
    qn = torch.sum(q * q, dim=1, keepdim=True)
    xn = torch.sum(x * x, dim=1, keepdim=True)
    return qn + xn.T - 2.0 * dots


def qdist_tf32(q, xq, scale, metric, passes):
    """The qdist kernel's arithmetic: q . codes in TF32 passes (the codes
    exact), the scale applied once per output, the norm s^2 * sum(code^2)
    from an exact integer sum."""
    dots = product(q, xq.float(), "mk,nk->mn", passes, 1, 1)
    if metric == "ip":
        return -scale[None, :] * dots
    qn = torch.sum(q * q, dim=1, keepdim=True)
    cn = torch.sum(xq.int() * xq.int(), dim=1).float()
    return qn + (scale * scale * cn)[None, :] - 2.0 * scale[None, :] * dots


def attention_tf32(q, k, v, *, q_scale, window, softcap, passes):
    """The kernel's arithmetic in one kv tile: scores in TF32 passes, a
    finite NEG_INF mask, p = exp(s - max) in fp32, P V in TF32 passes,
    divided by max(l, 1e-30)."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    qf = q.reshape(B, S, Hk, Hq // Hk, D)
    s = product(qf, k, "bqhgd,bkhd->bhgqk", passes, 4, 3) * q_scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.tensor(NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = product(p, v, "bhgqk,bkhd->bqhgd", passes, 4, 1)
    o = o / torch.clamp(p.sum(-1), min=1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, Hq, D)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    def f(bits):
        return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
            torch.float32)
    one = 0x3F800000
    for bits, want in [(one + 0x0FFF, one), (one + 0x1000, one + 0x2000),
                       (one + 0x2FFF, one + 0x2000), (one + 0x3000, one + 0x4000)]:
        got = to_tf32(f(bits)).view(torch.int32).item() & 0xFFFFFFFF
        assert got == want, (hex(bits), hex(got), hex(want))
        neg = to_tf32(-f(bits)).view(torch.int32).item() & 0xFFFFFFFF
        assert neg == want | 0x80000000          # symmetric in the sign
    x = torch.from_numpy(_normal(0, 100_000)) * 1e3
    assert torch.all(to_tf32(x).view(torch.int32) & 0x1FFF == 0)


def test_hi_plus_lo_reconstructs_x_to_2_pow_minus_22():
    x = torch.from_numpy(_normal(1, 200_000)) * torch.from_numpy(
        np.exp(_normal(2, 200_000) * 5).astype(np.float32))
    hi, lo = split(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    rel = ((x.double() - hi.double() - lo.double()).abs() / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -22
    # one TF32 value alone keeps about 2^-11
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("nq,nx,d", SMOKE.DISTANCE_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distance_3xtf32_within_tolerance(nq, nx, d, metric, record_property):
    q, x = _normal(3, (nq, d)), _normal(4, (nx, d))
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    got = distance_tf32(qt, xt, metric, passes=3).numpy()
    one = distance_tf32(qt, xt, metric, passes=1).numpy()
    want_ref = distance_ref(qt, xt, metric).numpy()
    one_pass_err = float(np.abs(one - want_ref).max())
    record_property("one_pass_max_abs_err", one_pass_err)
    why = (f"3xTF32 distance at {nq}x{nx}x{d} {metric}; one TF32 pass would "
           f"be off by up to {one_pass_err:.3g}")
    np.testing.assert_allclose(got, want_ref, rtol=1e-4, atol=2e-3, err_msg=why)
    want_jax = np.asarray(jax_pairwise(jnp.asarray(q), jnp.asarray(x),
                                       metric=metric))
    np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=2e-3, err_msg=why)


@pytest.mark.parametrize("B,S,Hq,Hk,D,win,cap", SMOKE.FLASH_SHAPES)
def test_attention_3xtf32_within_tolerance(B, S, Hq, Hk, D, win, cap,
                                           record_property):
    q = _normal(5, (B, S, Hq, D))
    k = _normal(6, (B, S, Hk, D))
    v = _normal(7, (B, S, Hk, D))
    args = [torch.from_numpy(t) for t in (q, k, v)]
    kw = dict(q_scale=D ** -0.5, window=win, softcap=cap)
    got = attention_tf32(*args, **kw, passes=3).numpy()
    one = attention_tf32(*args, **kw, passes=1).numpy()
    want_ref = flash_ref(*args, **kw).numpy()
    one_pass_err = float(np.abs(one - want_ref).max())
    record_property("one_pass_max_abs_err", one_pass_err)
    why = (f"3xTF32 attention at {(B, S, Hq, Hk, D)}; one TF32 pass would be "
           f"off by up to {one_pass_err:.3g}")
    np.testing.assert_allclose(got, want_ref, rtol=2e-3, atol=2e-3, err_msg=why)
    # the Pallas kernel takes S <= 128 or a multiple of 128: pad the
    # sequence at its end, which no earlier position attends to (causal)
    Sp = S if S <= 128 else -(-S // 128) * 128
    pad = [(0, 0), (0, Sp - S), (0, 0), (0, 0)]
    want_jax = np.asarray(jax_attention(
        *(jnp.pad(jnp.asarray(t), pad) for t in (q, k, v)), **kw))[:, :S]
    np.testing.assert_allclose(got, want_jax, rtol=2e-3, atol=2e-3, err_msg=why)


def test_int8_codes_are_exact_in_tf32():
    """Every code in [-127, 127] is a TF32 value: its hi is itself and its
    lo is 0, so the code operand's lo pass drops out of qdist's product."""
    codes = torch.arange(-127, 128, dtype=torch.float32)
    hi, lo = split(codes)
    assert torch.equal(hi, codes)
    assert torch.equal(lo, torch.zeros_like(codes))


@pytest.mark.parametrize("nq,nx,d", SMOKE.QDIST_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_qdist_2xtf32_within_tolerance(nq, nx, d, metric, record_property):
    q = _normal(8, (nq, d))
    xq, s = quantize_ref(torch.from_numpy(_normal(9, (nx, d))))
    qt = torch.from_numpy(q)
    got = qdist_tf32(qt, xq, s, metric, passes=2).numpy()
    one = qdist_tf32(qt, xq, s, metric, passes=1).numpy()
    want_ref = qdist_ref(qt, xq, s, metric).numpy()
    one_pass_err = float(np.abs(one - want_ref).max())
    record_property("one_pass_max_abs_err", one_pass_err)
    why = (f"2xTF32 qdist at {nq}x{nx}x{d} {metric}; one TF32 pass would be "
           f"off by up to {one_pass_err:.3g}")
    np.testing.assert_allclose(got, want_ref, **SMOKE.QDIST_TOL, err_msg=why)
    want_jax = np.asarray(jax_qdist(jnp.asarray(q), jnp.asarray(xq.numpy()),
                                    jnp.asarray(s.numpy()), metric=metric))
    np.testing.assert_allclose(got, want_jax, **SMOKE.QDIST_TOL, err_msg=why)
