"""Parity of the port's ANNS engine (``repro_torch.anns``) with the JAX
package on the CPU: datasets, the exact anchor, graph and int8 search on a
shared graph, graph construction from one seed, and the port's own
graph-vs-anchor differential.

Both packages get the same numpy inputs; built state moves from the
reference to the port through ``to_state_dict()`` /
``from_reference_state``, so both search the very same graph.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import make_dataset as jax_make_dataset  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.datasets import selectivity_filter as jax_selectivity  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro_torch.anns import (SearchParams, VariantConfig,  # noqa: E402
                              from_reference_state, make_dataset, registry)
from repro_torch.anns.api import search_ef_ladder  # noqa: E402
from repro_torch.anns.datasets import selectivity_filter  # noqa: E402
from repro_torch.anns.engine import GLASS_BASELINE, family_baseline  # noqa: E402

CPU = "cpu"
DATASETS = ("sift-128-euclidean", "glove-25-angular")
SELECTIVITIES = (0.5, 0.1, 0.02)
N_BASE, N_QUERY, K = 240, 16, 10


def _fields(v) -> dict:
    return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}


def _jax_variant(v: VariantConfig) -> JaxVariant:
    """The reference's VariantConfig with the same knobs."""
    return JaxVariant(**_fields(v))


def _jax_params(p: SearchParams) -> JaxParams:
    """The reference's SearchParams with the same knobs (a filter is
    rebuilt as the reference's predicate over the same values)."""
    f = _fields(p)
    if p.filter is not None:
        from repro.anns.filters import FilterPredicate
        f["filter"] = FilterPredicate(p.filter.attr, p.filter.values)
    return JaxParams(**f)


def _assert_same_ids(got_ids, got_d, want_ids, want_d, what: str) -> None:
    """Identical ids row by row, except where two distances round apart
    (within rtol 1e-5), in at most 1% of rows."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    assert got_ids.shape == want_ids.shape, what
    bad = np.flatnonzero((got_ids != want_ids).any(axis=1))
    print(f"{what}: {len(bad)} of {len(got_ids)} rows differ at a rounding tie")
    for r in bad:
        np.testing.assert_allclose(got_d[r], want_d[r], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: row {r} is no tie")
    assert len(bad) <= len(got_ids) // 100, (what, bad)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,n_base,n_query", [
    ("sift-128-euclidean", N_BASE, N_QUERY),
    ("glove-25-angular", N_BASE, N_QUERY),
    ("sift-128-euclidean", 2000, 64),
])
def test_dataset_bytes_equal_reference(name, n_base, n_query):
    want = jax_make_dataset(name, n_base=n_base, n_query=n_query, seed=3)
    got = make_dataset(name, n_base=n_base, n_query=n_query, seed=3,
                       device=CPU)
    for leaf in ("base", "queries", "gt"):
        a, b = getattr(got, leaf), getattr(want, leaf)
        assert a.dtype == b.dtype and a.shape == b.shape, leaf
        assert a.tobytes() == b.tobytes(), leaf
    assert sorted(got.attrs) == sorted(want.attrs)
    for c in want.attrs:
        assert got.attrs[c].tobytes() == want.attrs[c].tobytes(), c
    got_f = got.filtered_gt(selectivity_filter(got, 0.1), k=K)
    want_f = want.filtered_gt(jax_selectivity(want, 0.1), k=K)
    np.testing.assert_array_equal(got_f, want_f)


# ---------------------------------------------------------------------------
# the exact anchor
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=DATASETS)
def anchors(request):
    """(port dataset, port brute_force, reference brute_force)."""
    ds = make_dataset(request.param, n_base=N_BASE, n_query=N_QUERY, k_gt=K,
                      seed=3, device=CPU)
    ref_ds = jax_make_dataset(request.param, n_base=N_BASE, n_query=N_QUERY,
                              k_gt=K, seed=3)
    port = registry.create("brute_force", metric=ds.metric, device=CPU)
    port.build(ds.base)
    port.set_attributes(ds.attrs)
    ref = jax_registry.create("brute_force", metric=ref_ds.metric)
    ref.build(ref_ds.base)
    ref.set_attributes(ref_ds.attrs)
    return ds, port, ref


@pytest.mark.parametrize("sel", (None,) + SELECTIVITIES)
def test_brute_force_matches_gt_and_reference(anchors, sel):
    ds, port, ref = anchors
    pred = None if sel is None else selectivity_filter(ds, sel)
    params = SearchParams(k=K, filter=pred)
    got = port.search(ds.queries, params)
    want = ref.search(ds.queries, _jax_params(params))
    ids = got.ids.numpy()
    assert ids.dtype == np.int32 and ids.shape == (N_QUERY, K)
    gt = ds.gt[:, :K] if pred is None else ds.filtered_gt(pred, k=K)
    np.testing.assert_array_equal(np.sort(ids, axis=1), np.sort(gt, axis=1))
    np.testing.assert_array_equal(np.sort(ids, axis=1),
                                  np.sort(np.asarray(want.ids), axis=1))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5, atol=1e-4)
    if pred is not None:
        real = ids[ids >= 0]
        assert pred.mask(ds.attrs, N_BASE)[real].all()


def test_brute_force_chunked_merge_matches_one_chunk(anchors):
    """The running merge over 8192-row chunks (here 64) equals one scan."""
    ds, port, _ = anchors
    one = port.search(ds.queries, SearchParams(k=K))
    small = registry.create("brute_force", metric=ds.metric, device=CPU)
    small.chunk = 64
    small.build(ds.base)
    many = small.search(ds.queries, SearchParams(k=K))
    np.testing.assert_array_equal(many.ids.numpy(), one.ids.numpy())
    np.testing.assert_array_equal(many.dists.numpy(), one.dists.numpy())


# ---------------------------------------------------------------------------
# graph and int8 search on the reference's graph
# ---------------------------------------------------------------------------
SHARED_N, SHARED_Q = 1500, 128
SHARED_VARIANT = dataclasses.replace(
    GLASS_BASELINE, backend="quantized_prefilter", num_entry_points=3,
    rerank_factor=2)

#: name -> (backend, variant, params minus ef)
SEARCH_CASES = {
    "graph-fp32": ("graph", GLASS_BASELINE, {}),
    "graph-int8-rerank": ("graph", GLASS_BASELINE,
                          {"quantized": True, "rerank_factor": 2}),
    "quantized_prefilter": ("quantized_prefilter",
                            family_baseline("quantized_prefilter"), {}),
    "graph-g2-patience": ("graph", dataclasses.replace(
        GLASS_BASELINE, gather_width=2, patience=4, adaptive_ef_coef=14.5),
        {"target_recall": 0.95}),
    "graph-filtered": ("graph", GLASS_BASELINE, {"filter": 0.1}),
}


@pytest.fixture(scope="module")
def shared():
    """A reference graph with int8 codes and 3 entry points, its state,
    and the dataset of both packages."""
    ref_ds = jax_make_dataset("sift-128-euclidean", n_base=SHARED_N,
                              n_query=SHARED_Q, k_gt=K, seed=5)
    ds = make_dataset("sift-128-euclidean", n_base=SHARED_N,
                      n_query=SHARED_Q, k_gt=K, seed=5, device=CPU)
    ref = jax_registry.create("quantized_prefilter",
                              _jax_variant(SHARED_VARIANT),
                              metric=ref_ds.metric, seed=5)
    ref.build(ref_ds.base)
    ref.set_attributes(ref_ds.attrs)
    return ds, ref_ds, ref.to_state_dict()


@pytest.mark.parametrize("ef", [16, 64, 256])
@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_on_reference_graph_matches_reference(shared, case, ef):
    ds, ref_ds, state = shared
    name, variant, extra = SEARCH_CASES[case]
    extra = dict(extra)
    if "filter" in extra:
        extra["filter"] = selectivity_filter(ds, extra["filter"])
    params = SearchParams(k=K, ef=ef, **extra)
    ref = jax_registry.create(name, _jax_variant(variant), metric="l2")
    ref.from_state_dict({**state, "backend": name})
    port = from_reference_state({**state, "backend": name}, CPU,
                                variant=variant)
    assert port.name == name and port.index.base_q is not None
    assert port.attributes is not None
    want = ref.search(ref_ds.queries, _jax_params(params))
    got = port.search(ds.queries, params)
    _assert_same_ids(got.ids.numpy(), got.dists.numpy(), want.ids,
                     want.dists, f"{case} ef={ef}")
    if np.array_equal(got.ids.numpy(), np.asarray(want.ids)):
        assert int(got.steps) == int(want.steps)


def test_state_round_trips_without_aliasing(shared):
    _, _, ref_state = shared
    state = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in ref_state.items()}          # writable copies
    port = from_reference_state(state, CPU, variant=SHARED_VARIANT)
    back = port.to_state_dict()
    for key, leaf in state.items():
        if isinstance(leaf, np.ndarray):
            np.testing.assert_array_equal(back[key], leaf)
    # the index holds copies: writing either snapshot's buffers moves nothing
    before = port.index.base.clone()
    state["base"][0] += 1.0
    back["base"][0] += 1.0
    assert torch.equal(port.index.base, before)


# ---------------------------------------------------------------------------
# construction from one seed
# ---------------------------------------------------------------------------
def _row_overlap(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean([len(set(x) & set(y)) / len(y)
                          for x, y in zip(a.tolist(), b.tolist())]))


def test_build_matches_reference_from_same_seed(shared):
    ds, _, state = shared
    port = registry.create("quantized_prefilter", SHARED_VARIANT,
                           metric=ds.metric, seed=5, device=CPU)
    port.build(ds.base)
    idx = port.index
    overlap = _row_overlap(idx.neighbors.numpy(), state["neighbors"])
    print(f"NN-descent neighbor overlap with the reference: {overlap:.4f}")
    assert overlap >= 0.98
    np.testing.assert_array_equal(idx.entry_points.numpy(),
                                  state["entry_points"])
    np.testing.assert_array_equal(idx.base_q.numpy(), state["base_q"])
    # the reference's jitted quantizer multiplies by 1/127 where its plain
    # version (and the port) divides by 127: scales may sit 1 ulp apart
    np.testing.assert_array_max_ulp(idx.scales.numpy(), state["scales"],
                                    maxulp=1)
    assert idx.neighbors.dtype == torch.int32


def test_alpha_prune_build_matches_reference_from_same_seed():
    variant = VariantConfig(degree=8, ef_construction=32, nn_descent_rounds=2,
                            alpha=1.2, num_entry_points=3)
    ref_ds = jax_make_dataset("sift-128-euclidean", n_base=400, n_query=8,
                              k_gt=K, seed=7)
    ref = jax_registry.create("graph", _jax_variant(variant),
                              metric=ref_ds.metric, seed=7)
    ref.build(ref_ds.base)
    port = registry.create("graph", variant, metric=ref_ds.metric, seed=7,
                           device=CPU)
    port.build(ref_ds.base)
    overlap = _row_overlap(port.index.neighbors.numpy(),
                           np.asarray(ref.index.neighbors))
    print(f"alpha-pruned neighbor overlap with the reference: {overlap:.4f}")
    assert overlap >= 0.98


def test_alpha_prune_in_row_slices_builds_the_same_graph(monkeypatch):
    """Each node prunes on its own, so cutting the (B, C, C) cross
    distances into slices of rows (how a degree-64 build fits in memory)
    changes nothing."""
    from repro_torch.anns import construction
    base = np.random.default_rng(5).standard_normal((300, 24)).astype(np.float32)
    kw = dict(metric="l2", degree=12, ef_construction=32, rounds=2,
              alpha=1.2, num_entry_points=2, quantize=False, device=CPU)
    whole = construction.build_graph(base, **kw)
    monkeypatch.setattr(construction, "_prune_rows", lambda C, device: 7)
    sliced = construction.build_graph(base, **kw)
    assert torch.equal(whole.neighbors, sliced.neighbors)


# ---------------------------------------------------------------------------
# the port's own differential: graph at max effort == brute force
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=DATASETS)
def port_stack(request):
    ds = make_dataset(request.param, n_base=N_BASE, n_query=N_QUERY, k_gt=K,
                      seed=3, device=CPU)
    backends = {}
    for name in registry.available():
        b = registry.create(name, family_baseline(name), metric=ds.metric,
                            seed=3, device=CPU)
        b.build(ds.base)
        b.set_attributes(ds.attrs)
        backends[name] = b
    return ds, backends


def _max_effort_ids(backend, ds, predicate) -> np.ndarray:
    ef = search_ef_ladder(backend)[-1]
    res = backend.search(ds.queries, SearchParams(
        k=K, ef=ef, quantized=False, filter=predicate))
    return np.sort(res.ids.numpy(), axis=1)


@pytest.mark.parametrize("sel", (None,) + SELECTIVITIES)
@pytest.mark.parametrize("name", ["graph", "quantized_prefilter", "ivf",
                                  "sharded"])
def test_max_effort_graph_matches_port_brute_force(port_stack, name, sel):
    ds, backends = port_stack
    pred = None if sel is None else selectivity_filter(ds, sel)
    want = _max_effort_ids(backends["brute_force"], ds, pred)
    got = _max_effort_ids(backends[name], ds, pred)
    bad = np.flatnonzero((want != got).any(axis=1))
    assert not len(bad), (name, sel, bad[:5])
