"""Parity of the port's IVF family (``repro_torch.anns.ivf``,
``repro_torch.anns.backends.ivf``) with the JAX package's on the CPU.

k-means is held to the reference's own tolerances (``tests/test_ivf.py``):
its assignment runs the plain distance / top-k versions here and the
Pallas kernels in interpret mode there, so a near-tie may land in another
cell.  The layout, given the reference's centroids and assignments, is
byte-equal.  Search runs on the reference's built index, moved across with
``to_state_dict()`` / ``from_reference_state``: ids equal at every rung of
the nprobe ladder, int8 and fp32 scans, with and without a filter.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import make_dataset as jax_make_dataset  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.backends import ivf as jax_ivf  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro.anns.filters import FilterPredicate as JaxPredicate  # noqa: E402
from repro.anns.ivf import kmeans as jax_kmeans  # noqa: E402
from repro.anns.ivf import layout as jax_layout  # noqa: E402
from repro_torch.anns import SearchParams, from_reference_state, registry  # noqa: E402
from repro_torch.anns.api import AnnsIndex  # noqa: E402
from repro_torch.anns.backends import ivf as ivf_backend  # noqa: E402
from repro_torch.anns.engine import IVF_BASELINE, VariantConfig  # noqa: E402
from repro_torch.anns.filters import FilterPredicate  # noqa: E402
from repro_torch.anns.ivf import kmeans, layout  # noqa: E402
from repro_torch.kernels.qdist import ops as qdist_ops  # noqa: E402

CPU = "cpu"
K = 10


def _fields(v) -> dict:
    return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}


@pytest.fixture(scope="module")
def blobs():
    """The reference test's clustered 3000 x 48 set."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((12, 48)).astype(np.float32) * 3.0
    x = (centers[rng.integers(0, 12, size=3000)]
         + rng.standard_normal((3000, 48)).astype(np.float32))
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_assign_matches_the_reference(blobs, metric):
    """The port's ops-backed assignment against the reference's numpy
    oracle and its Pallas assignment: >= 99.5% of vectors in the same
    cell, and equal distances where they agree."""
    rng = np.random.default_rng(0)
    centroids = blobs[rng.choice(len(blobs), 32, replace=False)]
    a, d = kmeans.assign(blobs, centroids, metric=metric, chunk=1000,
                         device=CPU)
    assert a.dtype == np.int32 and d.dtype == np.float32
    for want_a, want_d in (jax_kmeans.assign_ref(blobs, centroids,
                                                 metric=metric),
                           jax_kmeans.assign(blobs, centroids, metric=metric)):
        agree = a == want_a
        assert agree.mean() >= 0.995, agree.mean()
        np.testing.assert_allclose(d[agree], want_d[agree], rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("metric,batch_size", [("l2", 4096), ("l2", 1000),
                                               ("ip", 4096)])
def test_kmeans_fit_matches_the_reference(blobs, metric, batch_size):
    """Same seed, same RNG stream, same float64 sums: centroids within the
    reference's 1e-3 (full batch, and mini-batch running means)."""
    x = blobs if metric == "l2" else blobs / np.linalg.norm(
        blobs, axis=1, keepdims=True)
    got = kmeans.kmeans_fit(x, 16, iters=5, seed=3, metric=metric,
                            batch_size=batch_size, device=CPU)
    want = jax_kmeans.kmeans_fit(x, 16, iters=5, seed=3, metric=metric,
                                 batch_size=batch_size)
    assert got.dtype == np.float32 and got.shape == (16, 48)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_numpy_twins_are_byte_equal(blobs):
    """kmeans_ref and split_oversized are numpy in both packages."""
    got = kmeans.kmeans_ref(blobs, 24, iters=4, seed=11, batch_size=1000)
    want = jax_kmeans.kmeans_ref(blobs, 24, iters=4, seed=11, batch_size=1000)
    assert got.tobytes() == want.tobytes()
    a, _ = jax_kmeans.assign_ref(blobs, want)
    for cap in (100, 180, 400):
        gc, ga = kmeans.split_oversized(blobs, want, a, cap=cap)
        wc, wa = jax_kmeans.split_oversized(blobs, want, a, cap=cap)
        assert gc.tobytes() == wc.tobytes() and ga.tobytes() == wa.tobytes()
        assert np.bincount(ga).max() <= cap


def test_lloyd_step_reseeds_empty_cells_like_the_reference(blobs):
    """A centroid stranded far from all data attracts nothing; one step
    moves it onto the batch's farthest point, as in the reference."""
    start = np.concatenate(
        [blobs[:7], np.full((1, blobs.shape[1]), 1e4, np.float32)])
    got_c, want_c = start.copy(), start.copy()
    got_n, want_n = np.zeros(8, np.int64), np.zeros(8, np.int64)
    info = kmeans.lloyd_step(blobs[:500], got_c, got_n, device=CPU)
    want = jax_kmeans.lloyd_step(blobs[:500], want_c, want_n,
                                 use_kernel=False)
    assert info["n_reseeded"] == want["n_reseeded"] >= 1
    assert info["batch_counts"][7] == 0
    np.testing.assert_array_equal(info["assign"], want["assign"])
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-6, atol=1e-5)
    assert (got_c[7][None, :] == blobs[:500]).all(axis=1).any()


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_cell", [None, 150])
def test_layout_from_reference_assignments_is_byte_equal(blobs, max_cell):
    cent = jax_kmeans.kmeans_fit(blobs, 32, iters=3, seed=0)
    a, _ = jax_kmeans.assign(blobs, cent)
    if max_cell:
        cent, a = jax_kmeans.split_oversized(blobs, cent, a, cap=max_cell)
    want = jax_layout.layout_from_assignments(blobs, a, cent, metric="l2")
    got = layout.layout_from_assignments(blobs, a, cent, metric="l2",
                                         device=CPU)
    for leaf in ("centroids", "cells", "ids", "base", "base_q"):
        g, w = getattr(got, leaf).numpy(), np.asarray(getattr(want, leaf))
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), leaf
    assert got.offsets.tobytes() == want.offsets.tobytes()
    # the reference's jitted quantizer multiplies by 1/127 where its plain
    # version (and the port) divides: scales may sit 1 ulp apart
    np.testing.assert_array_max_ulp(got.scales.numpy(),
                                    np.asarray(want.scales), maxulp=1)
    assert got.cell_pad % 8 == 0
    assert layout.ivf_stats(got) == jax_layout.ivf_stats(want)
    for k in (1, 10, 100, 3000):
        assert got.min_cells_for(k) == want.min_cells_for(k)


def test_build_from_one_seed_matches_the_reference(blobs):
    """The port's own build (plain assignment) lays the base out as the
    reference's does (Pallas assignment) on a well-separated set."""
    got = layout.build_ivf(blobs, nlist=32, kmeans_iters=3, seed=0,
                           max_cell=150, device=CPU)
    want = jax_layout.build_ivf(blobs, nlist=32, kmeans_iters=3, seed=0,
                                max_cell=150)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-3,
                               atol=1e-3)
    same = got.ids.numpy() == np.asarray(want.ids)
    print(f"cell-major positions equal to the reference's: {same.mean():.4f}")
    assert same.mean() >= 0.99
    assert sorted(got.ids.tolist()) == list(range(len(blobs)))


def test_build_raises_without_a_card_unless_cpu_is_named(blobs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        layout.build_ivf(blobs[:100], nlist=4)


# ---------------------------------------------------------------------------
# the ef -> nprobe ladder
# ---------------------------------------------------------------------------
def test_nprobe_ladder_helpers_match_the_reference():
    assert ivf_backend.NPROBE_LADDER == jax_ivf.NPROBE_LADDER
    for p in range(1, 600):
        assert ivf_backend.round_nprobe(p) == jax_ivf.round_nprobe(p)
    for nprobe in (1, 3, 8, 32):
        for coef in (0.0, 14.5):
            v = dataclasses.replace(IVF_BASELINE, nprobe=nprobe,
                                    adaptive_ef_coef=coef)
            jv = JaxVariant(**_fields(v))
            for nlist in (5, 64, 1000):
                assert (ivf_backend.ef_ladder_for_nprobe(v, nlist)
                        == jax_ivf.ef_ladder_for_nprobe(jv, nlist))
                for ef in (1, 16, 64, 100, 256, 4096):
                    for tr in (0.0, 0.95):
                        assert (ivf_backend.nprobe_for(
                            v, SearchParams(ef=ef, target_recall=tr), nlist)
                            == jax_ivf.nprobe_for(
                                jv, JaxParams(ef=ef, target_recall=tr), nlist))
    for rf in (1, 2, 8):
        for args in ((10, 3000, 4, 96), (10, 5, 1, 8), (50, 3000, 1, 8)):
            assert (ivf_backend.shortlist_width(SearchParams(rerank_factor=rf),
                                                *args)
                    == jax_ivf.shortlist_width(JaxParams(rerank_factor=rf),
                                               *args))


# ---------------------------------------------------------------------------
# search on the reference's index
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["blobs-l2", "glove-25-angular"])
def built(request, blobs):
    """(base, queries, metric, variant, reference backend) with attribute
    columns set."""
    if request.param == "blobs-l2":
        rng = np.random.default_rng(1)
        base, metric = blobs[:2000], "l2"
        queries = blobs[2000:2064] + 0.1 * rng.standard_normal(
            (64, 48)).astype(np.float32)
        variant = dataclasses.replace(IVF_BASELINE, nlist=32, kmeans_iters=4,
                                      max_cell=120)
    else:
        ds = jax_make_dataset("glove-25-angular", n_base=1500, n_query=64,
                              seed=2)
        base, queries, metric = ds.base, ds.queries, ds.metric
        variant = dataclasses.replace(IVF_BASELINE, nlist=24, nprobe=4)
    ref = jax_registry.create("ivf", JaxVariant(**_fields(variant)),
                              metric=metric, seed=4)
    ref.build(base)
    attrs = {"cat": np.random.default_rng(9).integers(0, 7, len(base))}
    ref.set_attributes(attrs)
    return base, queries.astype(np.float32), metric, variant, ref


CASES = {"int8": {}, "fp32": {"quantized": False},
         "filtered": {"filter": ("cat", (1, 4))},
         "int8-rerank4": {"rerank_factor": 4}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_on_reference_index_matches_at_every_rung(built, case):
    _, queries, _, variant, ref = built
    port = from_reference_state(ref.to_state_dict(), CPU, variant=variant)
    assert port.name == "ivf" and port.attributes is not None
    extra = dict(CASES[case])
    jextra = dict(extra)
    if "filter" in extra:
        extra["filter"] = FilterPredicate(*extra["filter"])
        jextra["filter"] = JaxPredicate(*jextra["filter"])
    ladder = port.search_ef_ladder()
    assert ladder == ref.search_ef_ladder()
    qdist_ops.launches = 0
    for ef in ladder:
        got = port.search(queries, SearchParams(k=K, ef=ef, **extra))
        want = ref.search(queries, JaxParams(k=K, ef=ef, **jextra))
        assert got.ids.dtype == torch.int32 and got.ids.shape == (64, K)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids),
                                      err_msg=f"{case} ef={ef}")
        # matmul-form fp32 distances, summed in another order than XLA's:
        # the reference's kernel tolerance (tests/test_kernels.py)
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-4, atol=2e-3)
        assert int(got.steps) == int(want.steps)
        assert int(got.expansions) == int(want.expansions)
    assert qdist_ops.launches == 0          # CPU tensors: the plain version


def test_state_round_trips_without_aliasing(built):
    _, queries, _, variant, ref = built
    state = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in ref.to_state_dict().items()}          # writable
    port = from_reference_state(state, CPU, variant=variant)
    back = port.to_state_dict()
    assert sorted(back) == sorted(state)
    for key, leaf in state.items():
        if isinstance(leaf, np.ndarray):
            assert back[key].dtype == leaf.dtype, key
            np.testing.assert_array_equal(back[key], leaf, err_msg=key)
        else:
            assert back[key] == leaf, key
    assert port.memory_bytes() == ref.memory_bytes()
    assert isinstance(port, AnnsIndex)
    before = port.search(queries, SearchParams(k=K))
    state["base"][:] = 0.0
    back["base_q"][:] = 0
    after = port.search(queries, SearchParams(k=K))
    assert torch.equal(before.ids, after.ids)


# ---------------------------------------------------------------------------
# the port's own build and search (the reference's regressions)
# ---------------------------------------------------------------------------
def test_small_probed_block_still_returns_k(blobs):
    """nprobe=1 over singleton cells: the probe floor widens the probe
    until the block holds k distinct vectors."""
    v = dataclasses.replace(IVF_BASELINE, nlist=64, nprobe=1, kmeans_iters=2)
    b = registry.create("ivf", v, device=CPU)
    b.build(blobs[:64])
    res = b.search(blobs[:4], SearchParams(k=10, ef=64))
    assert res.ids.shape == (4, 10)
    for row in res.ids.tolist():
        assert len(set(row)) == 10


def test_pad_slots_never_displace_real_neighbors(blobs):
    v = dataclasses.replace(IVF_BASELINE, nlist=16, nprobe=1, kmeans_iters=2,
                            rerank_factor=8)
    b = registry.create("ivf", v, device=CPU)
    b.build(blobs[:64])
    res = b.search(blobs[:8], SearchParams(k=10, ef=4))
    for row in res.ids.tolist():
        assert len(set(row)) == 10, row


def test_recall_grows_with_nprobe_and_matches_brute_force_at_all_cells(blobs):
    base, queries = blobs[:2500], blobs[2500:2564]
    exact = registry.create("brute_force", device=CPU)
    exact.build(base)
    gt = exact.search(queries, SearchParams(k=K)).ids.numpy()
    b = registry.create("ivf", VariantConfig(backend="ivf", nlist=32,
                                             nprobe=2), device=CPU)
    b.build(base)

    def recall(ids):
        return np.mean([len(set(r) & set(g)) / K for r, g in zip(ids, gt)])

    recs = [recall(b.search(queries, SearchParams(k=K, ef=ef)).ids.numpy())
            for ef in b.search_ef_ladder()]
    assert all(r2 >= r1 - 0.02 for r1, r2 in zip(recs, recs[1:])), recs
    top = b.search(queries, SearchParams(k=K, ef=b.search_ef_ladder()[-1],
                                         quantized=False))
    np.testing.assert_array_equal(np.sort(top.ids.numpy(), 1), np.sort(gt, 1))
