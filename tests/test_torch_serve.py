"""Parity of the port's serving front (``repro_torch.runtime.server``,
``repro_torch.launch.serve``) with the JAX package's on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.anns import make_dataset as jax_make_dataset  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro_torch.anns import SearchParams, from_reference_state  # noqa: E402
from repro_torch.anns.engine import family_baseline  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import server  # noqa: E402

CPU = "cpu"
N_BASE, N_QUERY = 800, 48


def _jax_variant(v):
    import dataclasses
    return JaxVariant(**{f.name: getattr(v, f.name)
                         for f in dataclasses.fields(v)})


@pytest.fixture(scope="module", params=["graph", "brute_force",
                                        "quantized_prefilter", "ivf",
                                        "sharded"])
def pair(request):
    """(queries, reference backend, port backend holding its state)."""
    name = request.param
    ds = jax_make_dataset("sift-128-euclidean", n_base=N_BASE,
                          n_query=N_QUERY, seed=1)
    variant = family_baseline(name)
    ref = jax_registry.create(name, _jax_variant(variant), metric=ds.metric,
                              seed=1)
    ref.build(ds.base)
    port = from_reference_state(ref.to_state_dict(), CPU, variant=variant)
    return ds.queries, ref, port


def _serve(server_cls, target, queries, ks, max_batch):
    srv = server_cls(target, max_batch=max_batch, ef=64, k=10)
    for q, k in zip(queries, ks):
        srv.submit(q, k=k)
    out = srv.run()
    assert srv.served == len(queries)
    return out


def test_served_ids_match_reference(pair):
    """The same request stream — heterogeneous k, a ragged last batch —
    gives the same ids from both servers."""
    queries, ref, port = pair
    ks = np.random.default_rng(0).choice([1, 5, 10, 10, 17, 32],
                                         size=len(queries)).tolist()
    want = _serve(jax_server.AnnsServer, ref, queries, ks, max_batch=20)
    got = _serve(server.AnnsServer, port, queries, ks, max_batch=20)
    assert len(got) == len(want) == len(queries)
    for g, w, k in zip(got, want, ks):
        assert g.ids.shape == (k,) and g.ids.dtype == np.int32
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.dists, w.dists, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k_default,kmax,n", [
    (10, 10, 800), (10, 17, 800), (10, 600, 500), (10, 3, 2), (64, 100, None),
])
def test_batch_k_policy_matches_reference(k_default, kmax, n):
    assert (server.batch_k_policy(k_default, kmax, n)
            == jax_server.batch_k_policy(k_default, kmax, n))


@pytest.mark.parametrize("query,exc", [
    (np.zeros((1, 8)), ValueError), (np.array(["a"] * 8), TypeError),
    (np.zeros(7), ValueError),
])
def test_validate_query_rejects_like_reference(query, exc):
    for fn in (server.validate_query, jax_server.validate_query):
        with pytest.raises(exc):
            fn(query, 8)


def test_execute_search_batch_pads_and_slices(pair):
    queries, _, port = pair
    ids, dists, compute_s = server.execute_search_batch(
        port.search, queries[:5], SearchParams(k=10), max_batch=16)
    assert ids.shape == (5, 10) and dists.shape == (5, 10) and compute_s >= 0
    full = port.search(queries[:5], SearchParams(k=10))
    np.testing.assert_array_equal(ids, full.ids.numpy())
    with pytest.raises(ValueError):
        server.execute_search_batch(port.search, queries[:20],
                                    SearchParams(k=10), max_batch=16)


@pytest.mark.parametrize("backend", ["brute_force", "graph", "ivf"])
def test_serve_main_runs_on_cpu(backend, capsys):
    rec = serve.main(["--n-base", "800", "--n-query", "32", "--n-requests",
                      "64", "--backend", backend, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "recall@10=" in out and "QPS" in out
    assert rec >= (0.999 if backend == "brute_force" else 0.9)
