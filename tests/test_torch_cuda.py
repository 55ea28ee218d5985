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


def _offset_view(t):
    """A copy of ``t`` starting one element past an aligned address (the
    kernels' 4-byte-staging variant)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# views one float off 16 bytes, nq not a multiple of 16, the k-means shape
@pytest.mark.parametrize("nq,nx,d,offset", [(64, 8192, 128, True),
                                            (17, 33, 100, True),
                                            (100, 5000, 128, False),
                                            (4096, 1024, 128, False)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distance_kernel_alignment_and_shapes(dev, nq, nx, d, offset, metric):
    from repro_torch.kernels.distance import ops
    from repro_torch.kernels.distance.ref import distance_ref
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(nq, d, generator=g, device=dev)
    x = torch.randn(nx, d, generator=g, device=dev)
    if offset:
        q, x = _offset_view(q), _offset_view(x)
        assert q.data_ptr() % 16 and x.data_ptr() % 16
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


def _check_topk_once(d, k):
    """One call: one launch, or the step sort's one per step plus a merge
    per halving of the runs; ids equal and value bits equal to the plain
    version's."""
    from repro_torch.kernels.topk import ops
    from repro_torch.kernels.topk import topk as kernel
    from repro_torch.kernels.topk.ref import topk_smallest_ref
    nx = d.shape[1]
    want = 1
    if k > kernel.K_WARP_MAX and nx > kernel.SORT_MAX_NX:
        want += (-(-nx // kernel.STEP_NX) - 1).bit_length()
    before = ops.launches
    v, i = ops.topk_smallest(d, k)
    assert ops.launches == before + want
    wv, wi = topk_smallest_ref(d, k)
    assert torch.equal(i, wi)
    assert torch.equal(v.view(torch.int32), wv.view(torch.int32))


# k = nx (the row sort), a row past the old kernel's 57,856 values, the
# k-means assignment (k = 1), a step boundary with the k smallest last, a
# brute-force merge of 123 chunks at k = 300 and 471, and k = nx past the
# row sort (the step sort, to 100,000 values)
@pytest.mark.parametrize("nq,nx,k", [(64, 1569, 1569), (2, 100_000, 10),
                                     (4096, 1024, 1), (3, 60_000, 256),
                                     (5, 28672, 300), (64, 123 * 300, 300),
                                     (2, 40_000, 40_000), (64, 123 * 471, 471),
                                     (2, 100_000, 100_000), (3, 57_857, 257)])
def test_topk_kernel_shapes(dev, nq, nx, k):
    g = torch.Generator(device=dev).manual_seed(5)
    d = torch.randn(nq, nx, generator=g, device=dev)
    if nx > 8192:
        d[:, -3:] = -10.0                  # the smallest in the last step
    _check_topk_once(d, k)


@pytest.mark.parametrize("edge", [1024, 8192])
def test_topk_kernel_ties_across_an_edge(dev, edge):
    """Equal values on both sides of a warp's (1,024) or a step's (8,192)
    edge, cut in their middle: the lower columns first."""
    g = torch.Generator(device=dev).manual_seed(6)
    d = torch.rand(4, 20_000, generator=g, device=dev) + 1.0
    d[:, edge - 5:edge + 5] = 0.5
    _check_topk_once(d, 7)


def test_topk_kernel_ties_across_a_step_sort_edge(dev):
    """k > 256 past the row sort: equal values across each 8,192-value
    step of the step sort, cut in their middle."""
    g = torch.Generator(device=dev).manual_seed(8)
    d = torch.rand(3, 41_000, generator=g, device=dev) + 1.0
    for e in range(8192, 41_000, 8192):
        d[:, e - 200:e + 200] = 0.5
    _check_topk_once(d, 307)
    _check_topk_once(d, 2100)


@pytest.mark.parametrize("nx", [8192, 1230])
def test_topk_kernel_mostly_big_rows(dev, nx):
    """A selective filter: each row holds 4 values below BIG, so every
    BIG ties at the bound; the k lowest of their columns follow."""
    g = torch.Generator(device=dev).manual_seed(9)
    d = torch.full((64, nx), 3.0e38, device=dev)
    cols = torch.randint(0, nx, (64, 4), generator=g, device=dev)
    d.scatter_(1, cols, torch.rand(64, 4, generator=g, device=dev))
    _check_topk_once(d, 10)


@pytest.mark.parametrize("k", [3, 10, 300])
def test_topk_kernel_nan_and_signed_zero(dev, k):
    d = torch.randn(3, 3000, generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev)
    d[:, 7], d[:, 9], d[:, 11] = float("nan"), -0.0, 0.0
    d[:, 13], d[:, 15] = float("inf"), float("-inf")
    d[1] = float("nan")
    d[1, 100], d[1, 50] = -0.0, 0.0
    _check_topk_once(d, k)


def _qkv(dev, B, S, Hq, Hk, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, Hq, D, generator=g, device=dev)
    k = torch.randn(B, S, Hk, D, generator=g, device=dev)
    v = torch.randn(B, S, Hk, D, generator=g, device=dev)
    return (t.to(getattr(torch, dtype)) for t in (q, k, v))


# the reference's five shapes (tests/test_kernels.py), ragged S and D, a
# wider group, and the policy LM's prefill shapes
@pytest.mark.parametrize("B,S,Hq,Hk,D,win,cap", [
    (2, 256, 4, 2, 64, 0, 0.0),
    (1, 256, 8, 8, 128, 0, 50.0),
    (2, 256, 4, 1, 80, 128, 0.0),
    (1, 512, 2, 2, 64, 0, 0.0),
    (1, 128, 16, 4, 128, 64, 30.0),
    (2, 333, 6, 2, 32, 0, 0.0),
    (1, 200, 4, 1, 80, 64, 30.0),
    (6, 35, 12, 12, 64, 0, 0.0),
    (6, 128, 12, 12, 64, 0, 0.0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(dev, B, S, Hq, Hk, D, win, cap, dtype):
    from repro_torch.kernels.flash import ops
    from repro_torch.kernels.flash.ref import flash_ref
    q, k, v = _qkv(dev, B, S, Hq, Hk, D, dtype)
    before = ops.launches
    got = ops.causal_attention(q, k, v, q_scale=D ** -0.5, window=win,
                               softcap=cap)
    assert ops.launches == before + 1
    want = flash_ref(q, k, v, q_scale=D ** -0.5, window=win, softcap=cap)
    # fp32: the reference's tolerance; bf16: one bf16 ulp of |o| < 4
    tol = 2e-3 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_reads_strided_inputs_in_place(dev):
    """q, k, v as views into one fused projection, as the policy's prefill
    could hand them over: the same answer as contiguous copies."""
    from repro_torch.kernels.flash import ops
    qkv = torch.randn(2, 35, 3, 4, 64, device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = ops.causal_attention(q, k, v, q_scale=0.125)
    want = ops.causal_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), q_scale=0.125)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# G 4 and G 64 folding, S 1 and S 65 (one key in a second kv tile), a
# window across tiles
@pytest.mark.parametrize("B,S,Hq,Hk,D,win", [(3, 65, 16, 4, 64, 0),
                                             (2, 65, 64, 1, 64, 0),
                                             (4, 1, 12, 12, 64, 0),
                                             (1, 65, 8, 8, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_folding_and_edges(dev, B, S, Hq, Hk, D, win, dtype):
    from repro_torch.kernels.flash import ops
    from repro_torch.kernels.flash.ref import flash_ref
    q, k, v = _qkv(dev, B, S, Hq, Hk, D, dtype, seed=5)
    got = ops.causal_attention(q, k, v, q_scale=D ** -0.5, window=win)
    want = flash_ref(q, k, v, q_scale=D ** -0.5, window=win)
    tol = 2e-3 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("D", [64, 25])
def test_flash_kernel_offset_views(dev, D):
    """q, k and v one float off 16 bytes (the 4-byte-staging variant)."""
    from repro_torch.kernels.flash import ops
    from repro_torch.kernels.flash.ref import flash_ref
    q, k, v = (_offset_view(t) for t in _qkv(dev, 6, 35, 12, 4, D, "float32"))
    assert q.data_ptr() % 16
    got = ops.causal_attention(q, k, v, q_scale=D ** -0.5)
    torch.testing.assert_close(got, flash_ref(q, k, v, q_scale=D ** -0.5),
                               rtol=2e-3, atol=2e-3)


def test_flash_kernel_is_causal(dev):
    """Changing future kv must not change past outputs."""
    from repro_torch.kernels.flash import ops
    q, k, v = _qkv(dev, 1, 256, 2, 2, 64, "float32")
    o1 = ops.causal_attention(q, k, v, q_scale=0.125)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] = 0.0
    v2[:, 128:] = 9.0
    o2 = ops.causal_attention(q, k2, v2, q_scale=0.125)
    torch.testing.assert_close(o1[:, :128], o2[:, :128], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,nx,d", [(16, 256, 128), (7, 300, 25),
                                     (64, 128, 960), (64, 8192, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_qdist_kernel_matches_plain(dev, nq, nx, d, dtype, metric):
    from repro_torch.kernels.qdist import ops
    from repro_torch.kernels.qdist.ref import qdist_ref
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(nq, d, generator=g, device=dev).to(getattr(torch, dtype))
    xq, s = ops.quantize_int8(torch.randn(nx, d, generator=g, device=dev))
    before = ops.launches
    got = ops.quantized_distance(q, xq, s, metric=metric)
    assert ops.launches == before + 1
    torch.testing.assert_close(got, qdist_ref(q, xq, s, metric), rtol=1e-4,
                               atol=2e-3)


# d = 960 and d = 25 (element-wise staging), views one element off 16
# bytes (element-wise staging at d = 128), ragged nq and nx
@pytest.mark.parametrize("nq,nx,d,offset", [(64, 4096, 960, False),
                                            (9, 1000, 25, False),
                                            (64, 8192, 128, True),
                                            (33, 65, 48, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_qdist_kernel_staging_variants(dev, nq, nx, d, offset, dtype, metric):
    from repro_torch.kernels.qdist import ops
    from repro_torch.kernels.qdist.ref import qdist_ref
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(nq, d, generator=g, device=dev).to(getattr(torch, dtype))
    xq, s = ops.quantize_int8(torch.randn(nx, d, generator=g, device=dev))
    if offset:
        q, xq = _offset_view(q), _offset_view(xq)
        assert q.data_ptr() % 16 and xq.data_ptr() % 16
    before = ops.launches
    got = ops.quantized_distance(q, xq, s, metric=metric)
    assert ops.launches == before + 1
    torch.testing.assert_close(got, qdist_ref(q, xq, s, metric), rtol=1e-4,
                               atol=2e-3)


def _cell_table(g, dev, nlist, pad):
    """A cell table of ragged cells (-1 padded) over consecutive rows."""
    sizes = torch.randint(0, pad + 1, (nlist,), generator=g, device=dev)
    offsets = torch.cumsum(sizes, 0) - sizes
    t = torch.arange(pad, device=dev)
    cells = torch.where(t[None, :] < sizes[:, None], offsets[:, None] + t, -1)
    return cells.to(torch.int32).contiguous(), int(sizes.sum())


# the 1M x 128 ivf layout's shapes (64 queries, 16 probed cells of a
# 2,048-wide table over 1,024 cells), the tune sweep's widest rungs over
# its 1,569 cells (256 and all of them), ragged d and a small table
@pytest.mark.parametrize("B,nprobe,nlist,pad,d", [(64, 16, 1024, 2048, 128),
                                                  (8, 256, 1569, 2048, 128),
                                                  (2, 1569, 1569, 2048, 128),
                                                  (9, 5, 40, 24, 25),
                                                  (3, 7, 12, 16, 64)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_qdist_cell_scan_kernel_matches_plain(dev, B, nprobe, nlist, pad, d,
                                              metric):
    from repro_torch.kernels.qdist import ops
    from repro_torch.kernels.qdist.ref import BIG, qdist_cells_ref
    g = torch.Generator(device=dev).manual_seed(3)
    cells, n = _cell_table(g, dev, nlist, pad)
    xq, s = ops.quantize_int8(torch.randn(n, d, generator=g, device=dev))
    q = torch.randn(B, d, generator=g, device=dev)
    rows = torch.randint(0, nlist, (B, nprobe), generator=g, device=dev,
                         dtype=torch.int32)
    rows[torch.rand(B, nprobe, generator=g, device=dev) < 0.2] = -1
    rows[0] = -1
    before = ops.launches
    got = ops.quantized_cell_scan(q, xq, s, cells, rows, metric=metric)
    assert ops.launches == before + 1
    want = qdist_cells_ref(q, xq, s, cells, rows, metric)
    dead = want == BIG
    assert dead.any() and torch.equal(got[dead], want[dead])
    torch.testing.assert_close(got[~dead], want[~dead], rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("name", ["brute_force", "ivf", "sharded"])
def test_index_checkpoint_round_trip_on_the_card(dev, tmp_path, name):
    """save_index of a card index, load_index onto the card (its default
    device): the same ids, and the same ids as the CPU copy's."""
    import dataclasses

    import numpy as np
    from repro_torch import ckpt
    from repro_torch.anns import SearchParams, make_dataset, registry
    from repro_torch.anns.engine import family_baseline
    ds = make_dataset("sift-128-euclidean", n_base=3000, n_query=64,
                      device=dev)
    v = dataclasses.replace(family_baseline(name), nlist=32)
    b = registry.create(name, v, metric=ds.metric, device=dev)
    b.build(ds.base)
    ckpt.save_index(str(tmp_path / "idx"), b)
    loaded = ckpt.load_index(str(tmp_path / "idx"))
    on_cpu = ckpt.load_index(str(tmp_path / "idx"), device="cpu")
    assert loaded.device.type == "cuda"
    p = SearchParams(k=10, ef=64)
    want = b.search(ds.queries, p).ids
    assert torch.equal(loaded.search(ds.queries, p).ids, want)
    np.testing.assert_array_equal(on_cpu.search(ds.queries, p).ids.numpy(),
                                  want.cpu().numpy())


def test_tune_sweep_and_slo_server_on_the_card(dev):
    import dataclasses

    import numpy as np
    from repro_torch.anns import make_dataset, registry, tune
    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.anns.engine import IVF_BASELINE
    from repro_torch.runtime.server import AnnsServer
    ds = make_dataset("sift-128-euclidean", n_base=5000, n_query=128,
                      device=dev)
    b = registry.create("ivf", dataclasses.replace(IVF_BASELINE, nlist=64),
                        metric=ds.metric, device=dev)
    b.build(ds.base)
    f = tune.sweep_frontier(ds, backends=(), targets=[b], repeats=1)
    assert f.points and f.max_recall("ivf") >= 0.99
    srv = AnnsServer(b, slo=tune.RecallSLO(0.9), frontier=f)
    for q in ds.queries:
        srv.submit(q)
    found = np.stack([r.ids for r in srv.run()])
    assert recall_at_k(found, ds.gt, 10) == pytest.approx(
        srv.operating_point.recall, abs=1e-9)


def _stream_on_card(dev, name="stream_ivf", n_base=3000):
    import dataclasses

    from repro_torch.anns import make_dataset, registry
    from repro_torch.anns.engine import family_baseline
    ds = make_dataset("sift-128-euclidean", n_base=n_base, n_query=64,
                      device=dev)
    v = dataclasses.replace(family_baseline(name), nlist=32, tail_cap=256)
    b = registry.create(name, v, metric=ds.metric, device=dev)
    b.build(ds.base)
    return ds, b


@pytest.mark.parametrize("name", ["stream_ivf", "stream_sharded"])
def test_stream_lifecycle_on_the_card(dev, tmp_path, name):
    """Insert, delete, base + delta checkpoint and compaction of a card
    index: the kernels launch, inserted vectors come back as their own
    ids, no tombstone surfaces, the replay and the CPU copy agree."""
    import numpy as np
    from repro_torch import ckpt
    from repro_torch.anns import SearchParams
    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.anns.stream import exact_live_gt
    from repro_torch.kernels.qdist import ops as qdist_ops
    ds, b = _stream_on_card(dev, name)
    ckpt.save_index(str(tmp_path / "idx"), b)
    rng = np.random.default_rng(1)
    extra = rng.standard_normal((100, 128)).astype(np.float32)
    new = b.insert(extra)
    dead = rng.choice(3000, 200, replace=False)
    assert b.delete(dead) == 200
    ckpt.save_index_delta(str(tmp_path / "idx"), b)
    p = SearchParams(k=10, ef=64)
    for stage in ("mutated", "compacted"):
        before = qdist_ops.scan_launches
        ids = b.search(extra, SearchParams(k=1, ef=64)).ids.cpu().numpy()
        assert qdist_ops.scan_launches > before
        np.testing.assert_array_equal(ids[:, 0], new)
        got = b.search(ds.queries, p).ids.cpu().numpy()
        assert not set(got.ravel().tolist()) & set(dead.tolist())
        exact = b.search(ds.queries, SearchParams(
            k=10, ef=64 * b.index.nlist, rerank_factor=8)).ids.cpu().numpy()
        assert recall_at_k(exact, exact_live_gt(b, ds.queries, 10),
                           10) >= 0.99
        if stage == "mutated":
            loaded = ckpt.load_index(str(tmp_path / "idx"))
            on_cpu = ckpt.load_index(str(tmp_path / "idx"), device="cpu")
            assert torch.equal(loaded.search(ds.queries, p).ids.cpu(),
                               torch.from_numpy(got))
            assert loaded.n_live() == on_cpu.n_live() == b.n_live()
            b.compact()
            assert b.epoch == 1 and b.tail_fraction() == 0.0


def test_stream_fenced_swap_on_the_card(dev):
    """Searches on the card racing background compactions (prepare, warm
    and commit on another thread, the default stream) return ids of the
    live set only, at exact-search recall."""
    import numpy as np
    from repro_torch.anns import SearchParams
    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.anns.stream import BackgroundCompactor, exact_live_gt
    ds, b = _stream_on_card(dev)
    rng = np.random.default_rng(2)
    b.insert(rng.standard_normal((120, 128)).astype(np.float32))
    b.delete(rng.choice(3000, 100, replace=False))
    live = set(b.live_vectors()[1].tolist())
    params = SearchParams(k=10, ef=64 * b.index.nlist, rerank_factor=8)
    gt = exact_live_gt(b, ds.queries, 10)
    comp = BackgroundCompactor(b, warm=(ds.queries, params), nice=None)
    results = []
    for _ in range(3):
        assert comp.schedule()
        while comp.in_flight:
            results.append(b.search(ds.queries, params).ids.cpu().numpy())
        assert comp.join(timeout=120)
    assert b.epoch == 3 and comp.runs == 3 and results
    for ids in results:
        assert set(ids.ravel().tolist()) <= live
        assert recall_at_k(ids, gt, 10) >= 0.99


def test_mesh_path_at_world_one_over_nccl(dev, tmp_path, monkeypatch):
    """A one-rank NCCL group and a 1x1 mesh: the expert-parallel MoE equals
    the local branch bit for bit (a one-rank all-reduce is the identity),
    a cache placed on it stays whole and decodes as the plain decode, and
    compressed_allreduce returns the dequantized codes."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import comm
    from repro_torch.dist.seq_decode import place_cache
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.models import Runtime
    from repro_torch.models.attention import Attention
    from repro_torch.models.moe import MoE
    from repro_torch.optim.grad_compress import (compress_with_feedback,
                                                 compressed_allreduce,
                                                 decompress)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    init_distributed("cuda", init_method=f"file://{tmp_path}/store",
                     timeout_s=60)
    try:
        mesh = make_debug_mesh(1, 1)
        cfg = dataclasses.replace(get_config("deepseek-moe-16b", reduced=True),
                                  dtype="float32")
        g = torch.Generator(device=dev).manual_seed(0)
        layer = MoE(cfg, device=dev)
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
        x = torch.randn(2, 16, cfg.d_model, generator=g, device=dev)
        want, waux = layer(x, 8.0)
        with comm.count_collectives() as counted:
            got, aux = layer(x, 8.0, mesh=mesh, dp_axes=("data",))
        assert torch.equal(got, want) and torch.equal(aux, waux)
        assert counted["all-reduce"]["count"] == 1

        # a 64-slot cache does not split over one model rank: place_cache
        # leaves it whole and the plain decode runs
        attn = Attention(cfg, device=dev)
        with torch.no_grad():
            for p in attn.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
            xs = torch.randn(2, 1, cfg.d_model, generator=g, device=dev)
            shape = (2, 64, cfg.num_kv_heads, cfg.head_dim)
            cache = {n: torch.randn(shape, generator=g, device=dev)
                     for n in "kv"}
            plain = {n: t.clone() for n, t in cache.items()}
            placed = place_cache(cache, mesh)
            assert placed is cache
            kw = dict(window=0, positions=torch.full((2, 1), 40, device=dev),
                      mode="decode", cache_len=40)
            o = attn(xs, cache=placed, rt=Runtime(mesh=mesh,
                                                  seq_shard_decode=True), **kw)
            assert torch.equal(o, attn(xs, cache=plain, **kw))
            assert all(torch.equal(cache[n], plain[n]) for n in "kv")

        grads = {"a": torch.randn(300, generator=g, device=dev)}
        res = {"a": torch.zeros(300, device=dev)}
        red, _ = compressed_allreduce(grads, res, mesh, "data")
        comp, _ = compress_with_feedback(grads, res)
        assert torch.equal(red["a"], decompress(comp)["a"])
    finally:
        dist.destroy_process_group()
