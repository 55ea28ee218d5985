"""Parity of the port's kernel ops (``repro_torch.kernels``) with the JAX
package's on the CPU.

On a CPU tensor each port op runs its plain PyTorch version; the JAX ops
run their Pallas kernels in interpret mode, as ``tests/test_kernels.py``
runs them.  Inputs are made with numpy from a seed and handed to both.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.distance.ops import pairwise_distance as jax_pairwise  # noqa: E402
from repro.kernels.distance.ref import distance_ref as jax_distance_ref  # noqa: E402
from repro.kernels.qdist.ref import quantize_ref as jax_quantize_ref  # noqa: E402
from repro.kernels.topk.ops import topk_smallest as jax_topk  # noqa: E402
from repro.kernels.topk.ref import topk_smallest_ref as jax_topk_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.distance import ops as dist_ops  # noqa: E402
from repro_torch.kernels.qdist.ops import quantize_int8  # noqa: E402
from repro_torch.kernels.topk import ops as topk_ops  # noqa: E402
from repro_torch.kernels.topk.ref import topk_smallest_ref  # noqa: E402

BIG = 3.0e38


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.fixture(autouse=True)
def _zero_counters():
    dist_ops.launches = 0
    topk_ops.launches = 0
    yield
    # CPU tensors never reach a kernel: the launch counts stay 0
    assert dist_ops.launches == 0 and topk_ops.launches == 0


# ---------------------------------------------------------------------------
# distance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nq,nx,d", [
    (128, 256, 128), (100, 300, 96), (8, 1000, 25), (256, 512, 960),
    (1, 128, 784), (17, 33, 100),
])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distance_matches_jax(nq, nx, d, metric):
    q, x = _normal(0, (nq, d)), _normal(1, (nx, d))
    got = dist_ops.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x),
                                     metric=metric).numpy()
    assert got.shape == (nq, nx) and got.dtype == np.float32
    for want in (jax_pairwise(jnp.asarray(q), jnp.asarray(x), metric=metric),
                 jax_distance_ref(jnp.asarray(q), jnp.asarray(x), metric)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=2e-3)


def test_distance_bf16_matches_jax():
    q, x = _normal(0, (64, 128)), _normal(1, (128, 128))
    got = dist_ops.pairwise_distance(torch.from_numpy(q).bfloat16(),
                                     torch.from_numpy(x).bfloat16(),
                                     metric="l2")
    assert got.dtype == torch.float32
    want = jax_distance_ref(jnp.asarray(q).astype(jnp.bfloat16),
                            jnp.asarray(x).astype(jnp.bfloat16), "l2")
    # same bf16 inputs, fp32 arithmetic on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-3)


def test_distance_l2_nonnegative_and_zero_diag():
    x = torch.from_numpy(_normal(0, (64, 32)))
    d = dist_ops.pairwise_distance(x, x, metric="l2")
    assert float(d.min()) > -1e-3
    np.testing.assert_allclose(np.diag(d.numpy()), 0.0, atol=1e-3)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "rank", "strided", "dim",
                                 "metric", "device"])
def test_distance_rejects_what_the_kernel_does_not_take(bad):
    q = torch.from_numpy(_normal(0, (8, 16)))
    x = torch.from_numpy(_normal(1, (32, 16)))
    kw = {"metric": "l2"}
    if bad == "dtype":
        q, x = q.double(), x.double()
    elif bad == "mixed":
        x = x.bfloat16()
    elif bad == "rank":
        q = q[None]
    elif bad == "strided":
        x = torch.from_numpy(_normal(1, (16, 32))).T
    elif bad == "dim":
        x = x[:, :8].contiguous()
    elif bad == "metric":
        kw = {"metric": "cosine"}
    elif bad == "device":
        # neither CPU nor CUDA: no plain-version fallback, no kernel
        q, x = q.to("meta"), x.to("meta")
    with pytest.raises((TypeError, ValueError)):
        dist_ops.pairwise_distance(q, x, **kw)


# ---------------------------------------------------------------------------
# topk
# ---------------------------------------------------------------------------
def _check_topk(d: np.ndarray, k: int):
    v, i = topk_ops.topk_smallest(torch.from_numpy(d), k)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    wv, wi = jax_topk_ref(jnp.asarray(d), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("nq,nx,k", [
    (8, 128, 10), (5, 1000, 32), (16, 333, 100), (1, 50, 5), (9, 2048, 64),
])
def test_topk_matches_jax(nq, nx, k):
    d = _normal(2, (nq, nx))
    v, i = _check_topk(d, k)
    # the Pallas kernel (interpret mode) agrees on rows without BIG
    kv, ki = jax_topk(jnp.asarray(d), k)
    np.testing.assert_array_equal(i, np.asarray(ki))
    np.testing.assert_allclose(v, np.asarray(kv), rtol=1e-6)
    assert (np.diff(v, axis=1) >= 0).all()


def test_topk_with_ties():
    d = np.zeros((8, 64), np.float32)
    d[:, 10] = -1.0
    _, i = _check_topk(d, 3)
    # the remaining picks are the lowest indices among ties (stable)
    assert (i == [10, 0, 1]).all()


def test_topk_mostly_big_row_gives_distinct_ids():
    """Past the finite values the port follows ``lax.top_k`` (distinct
    ids), not the Pallas body, which repeats the lowest BIG index."""
    d = np.full((3, 16), BIG, np.float32)
    d[:, 5], d[:, 9] = 1.0, 2.0
    _, i = _check_topk(d, 5)
    assert (i == [5, 9, 0, 1, 2]).all()
    for row in i:
        assert len(set(row.tolist())) == 5


def test_topk_plain_version_is_a_stable_sort():
    d = torch.tensor([[0.0, -0.0, 1.0, float("nan"), -1.0, 0.0]])
    v, i = topk_smallest_ref(d, 6)
    assert i.tolist() == [[4, 0, 1, 5, 2, 3]]


@pytest.mark.parametrize("bad", ["k0", "kbig", "dtype", "strided", "device"])
def test_topk_rejects_what_the_kernel_does_not_take(bad):
    d, k = torch.from_numpy(_normal(0, (4, 32))), 4
    if bad == "k0":
        k = 0
    elif bad == "kbig":
        k = 33
    elif bad == "dtype":
        d = d.double()
    elif bad == "strided":
        d = torch.from_numpy(_normal(0, (32, 4))).T
    elif bad == "device":
        d = d.to("meta")
    with pytest.raises((TypeError, ValueError)):
        topk_ops.topk_smallest(d, k)


# ---------------------------------------------------------------------------
# quantize_int8
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((128, 64), 3.0), ((300, 25), 1.0),
                                         ((64, 960), 0.01)])
def test_quantize_bit_equal_to_jax(shape, scale):
    x = _normal(4, shape, scale)
    q, s = quantize_int8(torch.from_numpy(x))
    wq, ws = jax_quantize_ref(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(ws).view(np.int32))


def test_quantize_rounds_half_to_even_like_jax():
    # scale = 127/127 = 1: the codes are round(x) with ties to even
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    q, _ = quantize_int8(torch.from_numpy(x))
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jax_quantize_ref(jnp.asarray(x))[0]))


# ---------------------------------------------------------------------------
# the nvcc loader (pure Python here: nothing is compiled on the CPU)
# ---------------------------------------------------------------------------
def test_library_path_is_keyed_by_source_under_the_build_dir():
    p = _build.library_path("distance")
    assert p.parent == _build.BUILD_DIR and p.parts[-3:-1] == ("build", "repro_torch")
    assert p.name.startswith("distance-") and p.suffix == ".so"
    assert _build.library_path("topk") != p
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS


def test_loader_raises_with_the_cuda_error_text():
    class ErrorString:                  # stands in for the ctypes entry
        argtypes = restype = None

        def __call__(self, err):
            return b"invalid argument"

    lib = types.SimpleNamespace(cuda_error_string=ErrorString())
    _build.check(lib, 0, "launch")
    with pytest.raises(RuntimeError, match="invalid argument"):
        _build.check(lib, 1, "launch")
