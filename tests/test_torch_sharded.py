"""The port's sharded backend (``repro_torch.anns.backends.sharded``,
single-device form) against the port's ivf and the JAX package's sharded
backend on the CPU.

``n_shards=1`` is bit-identical to ``ivf`` (ids and distances), any shard
count returns ivf's ids at the all-cells probe, the reference's sharded
states of format v1 and v3 load and search to the reference's ids, and the
shard layout equals the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro.anns.filters import FilterPredicate as JaxPredicate  # noqa: E402
from repro.anns.ivf import sharding as jax_sharding  # noqa: E402
from repro_torch.anns import SearchParams, from_reference_state, registry  # noqa: E402
from repro_torch.anns.engine import IVF_BASELINE, SHARDED_BASELINE  # noqa: E402
from repro_torch.anns.filters import FilterPredicate  # noqa: E402
from repro_torch.anns.ivf import sharding  # noqa: E402

CPU = "cpu"
K = 10


def _fields(v) -> dict:
    return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}


def _blobs(seed: int, n: int, d: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 2.5
    return (centers[rng.integers(0, 8, size=n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def _ivf_and_sharded(x, *, nlist: int, n_shards: int, seed: int = 0,
                     metric: str = "l2"):
    v = dataclasses.replace(IVF_BASELINE, nlist=nlist, kmeans_iters=2)
    ivf = registry.create("ivf", v, metric=metric, seed=seed, device=CPU)
    ivf.build(x)
    vs = dataclasses.replace(v, backend="sharded", n_shards=n_shards)
    sh = registry.create("sharded", vs, metric=metric, seed=seed, device=CPU)
    sh.build(x)
    return ivf, sh


# ---------------------------------------------------------------------------
# equivalence with the port's ivf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d,nlist,metric", [(256, 16, 8, "l2"),
                                              (900, 32, 24, "l2"),
                                              (640, 24, 16, "ip")])
def test_one_shard_is_bit_identical_to_ivf(n, d, nlist, metric):
    x = _blobs(n, n, d)
    ivf, sh = _ivf_and_sharded(x, nlist=nlist, n_shards=1, metric=metric)
    attrs = {"cat": np.arange(n) % 5}
    ivf.set_attributes(attrs)
    sh.set_attributes(attrs)
    for ef in (16, 64, 256):
        for extra in ({}, {"quantized": False},
                      {"filter": FilterPredicate("cat", (0, 3))}):
            p = SearchParams(k=K, ef=ef, **extra)
            a, b = ivf.search(x[:16], p), sh.search(x[:16], p)
            assert torch.equal(a.ids, b.ids), (ef, extra)
            assert torch.equal(a.dists, b.dists), (ef, extra)
            assert int(a.expansions) == int(b.expansions)
            assert a.steps == b.steps


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("n,nlist", [(640, 16), (300, 4)])
def test_merged_ids_match_ivf_at_the_all_cells_probe(n_shards, n, nlist):
    """Every cell is probed on its owning shard; the merged shortlists give
    ivf's answer.  nlist 4 with 8 shards leaves shards with no cell."""
    x = _blobs(n_shards + n, n, 24)
    ivf, sh = _ivf_and_sharded(x, nlist=nlist, n_shards=n_shards)
    if nlist < n_shards:
        assert 0 in np.diff(sh.index.cell_bounds)
    for extra in ({}, {"quantized": False}):
        p = SearchParams(k=K, ef=64 * ivf.index.nlist, rerank_factor=4,
                         **extra)
        a, b = ivf.search(x[:16], p), sh.search(x[:16], p)
        assert torch.equal(a.ids, b.ids)
        assert torch.equal(a.dists, b.dists)


@pytest.mark.parametrize("n_shards,rerank_factor", [(2, 4), (4, 8)])
def test_rerank_never_returns_a_pad_slot_on_ragged_shortlists(
        n_shards, rerank_factor):
    x = _blobs(3, 64, 16)
    v = dataclasses.replace(SHARDED_BASELINE, nlist=64, nprobe=1,
                            kmeans_iters=2, rerank_factor=rerank_factor,
                            n_shards=n_shards)
    sh = registry.create("sharded", v, device=CPU)
    sh.build(x)                         # nlist == n -> singleton cells
    res = sh.search(x[:8], SearchParams(k=10, ef=4))
    for row in res.ids.tolist():
        assert len(set(row)) == 10, row


# ---------------------------------------------------------------------------
# the layout against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("counts,n_shards", [
    ([5, 0, 7, 3, 9, 1], 3), ([0, 0, 0], 2), ([4, 4], 5), ([10], 1),
    ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 4), ([0, 8, 0, 8], 8),
])
def test_balanced_cell_ranges_equal_the_reference(counts, n_shards):
    got = sharding.balanced_cell_ranges(np.asarray(counts), n_shards)
    want = jax_sharding.balanced_cell_ranges(np.asarray(counts), n_shards)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", [1, 3, 40])
def test_shard_ivf_equals_the_reference_layout(n_shards):
    x = _blobs(1, 700, 20)
    ref = jax_registry.create("ivf", JaxVariant(backend="ivf", nlist=24,
                                                kmeans_iters=2), metric="l2")
    ref.build(x)
    port = from_reference_state(ref.to_state_dict(), CPU)
    got = sharding.shard_ivf(port.index, n_shards)
    want = jax_sharding.shard_ivf(ref.index, n_shards)
    for leaf in ("centroids", "cell_shard", "cell_row", "cells", "vec_start",
                 "base_q", "scales", "base_f", "ids"):
        g, w = getattr(got, leaf).numpy(), np.asarray(getattr(want, leaf))
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), leaf
    for leaf in ("offsets", "cell_bounds", "vec_bounds"):
        np.testing.assert_array_equal(getattr(got, leaf), getattr(want, leaf))
    assert sharding.sharded_stats(got) == jax_sharding.sharded_stats(want)


# ---------------------------------------------------------------------------
# the reference's sharded states
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[2, 3])
def ref_sharded(request):
    x = _blobs(5, 1200, 32)
    queries = x[:48] + 0.05
    variant = dataclasses.replace(SHARDED_BASELINE, nlist=24, nprobe=4,
                                  n_shards=request.param)
    ref = jax_registry.create("sharded", JaxVariant(**_fields(variant)),
                              metric="l2", seed=1)
    ref.build(x)
    ref.set_attributes({"cat": np.arange(len(x)) % 6})
    return queries.astype(np.float32), variant, ref


def _v1(state: dict, ref) -> dict:
    """The reference's v1 shape of a snapshot: a replicated ``base``, no
    ``shardN/base_f`` leaves and no ``state_format``."""
    v1 = {k: v for k, v in state.items()
          if not k.endswith("/base_f") and k != "state_format"}
    vb = ref.index.vec_bounds
    v1["base"] = np.concatenate([np.asarray(ref.index.base_f[j])[: vb[j + 1] - vb[j]]
                                 for j in range(ref.index.n_shards)])
    return v1


@pytest.mark.parametrize("fmt", ["v3", "v1"])
@pytest.mark.parametrize("case", ["int8", "fp32", "filtered"])
def test_reference_states_load_and_search_to_its_ids(ref_sharded, fmt, case):
    queries, variant, ref = ref_sharded
    state = ref.to_state_dict()
    assert state["state_format"] == 3
    if fmt == "v1":
        state = _v1(state, ref)
    port = from_reference_state(state, CPU, variant=variant)
    assert port.name == "sharded" and port.index.n_shards == ref.index.n_shards
    np.testing.assert_array_equal(port.index.base_f.numpy(),
                                  np.asarray(ref.index.base_f))
    extra, jextra = {}, {}
    if case == "fp32":
        extra = jextra = {"quantized": False}
    elif case == "filtered":
        extra = {"filter": FilterPredicate("cat", (2,))}
        jextra = {"filter": JaxPredicate("cat", (2,))}
    for ef in port.search_ef_ladder():
        got = port.search(queries, SearchParams(k=K, ef=ef, **extra))
        want = ref.search(queries, JaxParams(k=K, ef=ef, **jextra))
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids),
                                      err_msg=f"{fmt} {case} ef={ef}")
        # matmul-form fp32 distances, summed in another order than XLA's:
        # the reference's kernel tolerance (tests/test_kernels.py)
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-4, atol=2e-3)
        assert int(got.expansions) == int(want.expansions)


def test_state_round_trips_and_memory_matches(ref_sharded):
    _, variant, ref = ref_sharded
    state = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in ref.to_state_dict().items()}
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
    assert port.device_memory_bytes() == ref.device_memory_bytes()
    assert port.stats() == ref.stats()
    state["shard0/base_f"][:] = 0.0
    assert port.index.base_f[0].abs().sum() > 0
