"""The port's CUDA kernels against their plain versions on the card.

Skipped where torch sees no card.  On a machine with one (and without
JAX), run them with::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda")


@pytest.mark.parametrize("nq,nx,d", [(64, 8192, 128), (17, 33, 100),
                                     (8, 1000, 25), (256, 512, 960)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distance_kernel_matches_plain(dev, nq, nx, d, dtype, metric):
    from repro_torch.kernels.distance import ops
    from repro_torch.kernels.distance.ref import distance_ref
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(nq, d, generator=g, device=dev).to(getattr(torch, dtype))
    x = torch.randn(nx, d, generator=g, device=dev).to(getattr(torch, dtype))
    before = ops.launches
    got = ops.pairwise_distance(q, x, metric=metric)
    assert ops.launches == before + 1
    torch.testing.assert_close(got, distance_ref(q, x, metric), rtol=1e-4,
                               atol=2e-3)


@pytest.mark.parametrize("nq,nx,k", [(64, 8192, 10), (64, 8192, 100),
                                     (9, 2048, 64), (64, 1230, 10),
                                     (3, 40000, 1)])
def test_topk_kernel_matches_plain(dev, nq, nx, k):
    from repro_torch.kernels.topk import ops
    from repro_torch.kernels.topk.ref import topk_smallest_ref
    g = torch.Generator(device=dev).manual_seed(1)
    d = torch.randn(nq, nx, generator=g, device=dev)
    d[:, 7] = d[:, 3]                      # a tie: the lower index first
    before = ops.launches
    v, i = ops.topk_smallest(d, k)
    assert ops.launches == before + 1
    wv, wi = topk_smallest_ref(d, k)
    assert torch.equal(i, wi) and torch.equal(v, wv)


def test_topk_kernel_gives_distinct_ids_past_big(dev):
    from repro_torch.kernels.topk import ops
    d = torch.full((4, 512), 3.0e38, device=dev)
    d[:, 5], d[:, 9] = 1.0, 2.0
    _, i = ops.topk_smallest(d, 5)
    assert i.tolist() == [[5, 9, 0, 1, 2]] * 4
