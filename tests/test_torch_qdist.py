"""Parity of the port's ``qdist`` ops (``repro_torch.kernels.qdist``) with
the JAX package's on the CPU.

On a CPU tensor the port's ops run their plain versions; the JAX op runs
its Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it.
Inputs are made with numpy from a seed and handed to both.  The cell scan
is held against the reference's own IVF scan arithmetic (the gather and
``repro.anns.search._qdist`` of ``backends/ivf.py``) on a built reference
index.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns import search as jax_search  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro.kernels.qdist.ops import quantize_int8 as jax_quantize  # noqa: E402
from repro.kernels.qdist.ops import quantized_distance as jax_qdist  # noqa: E402
from repro.kernels.qdist.ref import qdist_ref as jax_qdist_ref  # noqa: E402
from repro_torch.kernels.qdist import ops  # noqa: E402
from repro_torch.kernels.qdist.ref import BIG, qdist_cells_ref, qdist_ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=2e-3)     # the reference's (tests/test_kernels.py)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _zero_counter():
    ops.launches = 0
    yield
    # CPU tensors never reach a kernel: the launch count stays 0
    assert ops.launches == 0


def _codes(x: np.ndarray):
    """The reference quantizer's codes and scales, as numpy."""
    xq, s = jax_quantize(jnp.asarray(x))
    return np.array(xq), np.array(s)


# ---------------------------------------------------------------------------
# all pairs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nq,nx,d", [(16, 256, 128), (7, 300, 25),
                                     (64, 128, 960)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_quantized_distance_matches_jax(nq, nx, d, metric):
    q = _normal(0, (nq, d))
    xq, s = _codes(_normal(1, (nx, d)))
    got = ops.quantized_distance(torch.from_numpy(q), torch.from_numpy(xq),
                                 torch.from_numpy(s), metric=metric).numpy()
    assert got.shape == (nq, nx) and got.dtype == np.float32
    for want in (jax_qdist(jnp.asarray(q), jnp.asarray(xq), jnp.asarray(s),
                           metric=metric),
                 jax_qdist_ref(jnp.asarray(q), jnp.asarray(xq), jnp.asarray(s),
                               metric)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_quantized_distance_bf16_queries_match_jax():
    q = _normal(0, (32, 64))
    xq, s = _codes(_normal(1, (200, 64)))
    got = ops.quantized_distance(torch.from_numpy(q).bfloat16(),
                                 torch.from_numpy(xq), torch.from_numpy(s))
    want = jax_qdist(jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(xq),
                     jnp.asarray(s))
    # the same bf16 queries, fp32 arithmetic on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the cell scan
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ivf_state():
    """A reference IVF index over clustered 40-d vectors: its state, with
    padded cells of uneven sizes."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((10, 40)).astype(np.float32) * 3.0
    base = (centers[rng.integers(0, 10, size=900)]
            + rng.standard_normal((900, 40)).astype(np.float32))
    ref = jax_registry.create("ivf", JaxVariant(
        backend="ivf", nlist=24, nprobe=4, kmeans_iters=4), metric="l2")
    ref.build(base.astype(np.float32))
    state = ref.to_state_dict()
    assert (state["cells"] == -1).any()
    return state


def _probes(state, B, nprobe, seed):
    """(B, nprobe) int32 rows of the cell table, some of them -1."""
    rng = np.random.default_rng(seed)
    C = state["cells"].shape[0]
    rows = np.stack([rng.choice(C, size=nprobe, replace=False)
                     for _ in range(B)]).astype(np.int32)
    rows[rng.random(rows.shape) < 0.25] = -1
    rows[0] = -1                                  # a query no shard owns
    return rows


def _jax_cell_scan(state, q, rows, metric):
    """The reference's scan arithmetic (backends/ivf.py:111-121 and the
    sharded backend's "not my shard" rows, sharded.py:96-98)."""
    cells = jnp.asarray(state["cells"])
    B = q.shape[0]
    mine = rows >= 0
    cand = cells[jnp.where(mine, rows, 0)]
    cand = jnp.where(mine[..., None], cand, -1).reshape(B, -1)
    valid = cand >= 0
    pos = jnp.where(valid, cand, 0)
    vecs = (jnp.asarray(state["base_q"])[pos].astype(jnp.float32)
            * jnp.asarray(state["scales"])[pos][..., None])
    d = jax_search._qdist(jnp.asarray(q), vecs, metric)
    return np.asarray(jnp.where(valid, d, jax_search.BIG)), np.asarray(valid)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("B,nprobe", [(9, 3), (16, 8), (5, 24)])
def test_cell_scan_matches_the_reference_scan(ivf_state, metric, B, nprobe):
    q = _normal(11, (B, ivf_state["base"].shape[1]))
    rows = _probes(ivf_state, B, nprobe, seed=B)
    got = ops.quantized_cell_scan(
        torch.from_numpy(q), torch.tensor(ivf_state["base_q"]),
        torch.tensor(ivf_state["scales"]),
        torch.tensor(ivf_state["cells"]), torch.from_numpy(rows),
        metric=metric).numpy()
    want, valid = _jax_cell_scan(ivf_state, q, rows, metric)
    assert got.shape == (B, nprobe * ivf_state["cells"].shape[1])
    assert (got[~valid] == np.float32(BIG)).all()
    assert (got[valid] < BIG).all()
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cell_scan_equals_all_pairs_at_each_slot(ivf_state, metric):
    """Both plain versions compute one function: slot (b, j, t) of the scan
    is the all-pairs distance from q[b] to the row at cells[rows[b, j], t]."""
    q = torch.from_numpy(_normal(5, (12, ivf_state["base"].shape[1])))
    xq = torch.tensor(ivf_state["base_q"])
    s = torch.tensor(ivf_state["scales"])
    cells = torch.tensor(ivf_state["cells"])
    rows = torch.from_numpy(_probes(ivf_state, 12, 6, seed=2))
    scan = qdist_cells_ref(q, xq, s, cells, rows, metric)
    full = qdist_ref(q, xq, s, metric)
    pos = torch.where(rows[..., None] >= 0, cells[rows.clamp(min=0).long()],
                      -1).reshape(12, -1)
    want = torch.where(pos >= 0, full.gather(1, pos.clamp(min=0).long()),
                       torch.tensor(BIG))
    torch.testing.assert_close(scan, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# checks and dispatch
# ---------------------------------------------------------------------------
def _args(d=16, n=40, B=3):
    q = torch.from_numpy(_normal(0, (B, d)))
    xq = torch.zeros((n, d), dtype=torch.int8)
    s = torch.ones(n)
    cells = torch.arange(n, dtype=torch.int32).reshape(4, -1)
    rows = torch.zeros((B, 2), dtype=torch.int32)
    return q, xq, s, cells, rows


@pytest.mark.parametrize("bad,exc", [
    ({"xq": torch.zeros((40, 16))}, TypeError),             # not int8
    ({"xq": torch.zeros((40, 15), dtype=torch.int8)}, ValueError),  # d
    ({"s": torch.ones(39)}, ValueError),                    # scale length
    ({"s": torch.ones(40, dtype=torch.float64)}, ValueError),
    ({"q": torch.zeros((3, 16), dtype=torch.float64)}, TypeError),
    ({"cells": torch.zeros((4, 10), dtype=torch.int64)}, TypeError),
    ({"rows": torch.zeros((2, 2), dtype=torch.int32)}, ValueError),  # B
    ({"metric": "cos"}, ValueError),
])
def test_ops_reject_bad_inputs(bad, exc):
    q, xq, s, cells, rows = _args()
    kw = dict(q=q, xq=xq, s=s, cells=cells, rows=rows, metric="l2")
    kw.update(bad)
    with pytest.raises(exc):
        ops.quantized_cell_scan(kw["q"], kw["xq"], kw["s"], kw["cells"],
                                kw["rows"], metric=kw["metric"])
    if "cells" not in bad and "rows" not in bad:
        with pytest.raises(exc):
            ops.quantized_distance(kw["q"], kw["xq"], kw["s"],
                                   metric=kw["metric"])


def test_ops_raise_on_a_device_without_a_kernel():
    q, xq, s, cells, rows = (t.to("meta") for t in _args())
    with pytest.raises(ValueError, match="no qdist kernel"):
        ops.quantized_distance(q, xq, s)
    with pytest.raises(ValueError, match="no qdist kernel"):
        ops.quantized_cell_scan(q, xq, s, cells, rows)
