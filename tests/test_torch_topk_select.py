"""The topk kernel's algorithm (``csrc/topk.cu``), emulated in numpy on the
CPU.

The kernel is CUDA only; this file repeats its arithmetic step by step at
its own constants (read from the source and held equal to
``repro_torch.kernels.topk.topk``'s): the threshold select (each lane's 32
values in the kernel's load layout, the warps' bounds, the row's, the
candidates placed by rank or by the virtually padded bitonic network, rows
in steps with the running k smallest), the k = 1 argmin, the row sort and
the k rounds.
Each emulated result must equal, ids and value bits, the plain version's
(a stable sort cut at k) and the JAX package's (its plain version, and its
Pallas kernel in interpret mode at the main path's shapes) where the rows
hold no NaN and no -0, on which the two packages differ by design.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.kernels.topk.ops import topk_smallest as jax_topk  # noqa: E402
from repro.kernels.topk.ref import topk_smallest_ref as jax_topk_ref  # noqa: E402
from repro_torch.kernels.topk import topk as kt  # noqa: E402
from repro_torch.kernels.topk.ref import topk_smallest_ref  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "topk.cu").read_text()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"no constexpr int {name} in topk.cu"
    return int(m.group(1))


CHUNK, WARPS = _constant("CHUNK"), _constant("WARPS")
K_WARP_MAX, SORT_MAX_NX = _constant("K_WARP_MAX"), _constant("SORT_MAX_NX")
ROUND_MAX_NX, THREADS = _constant("ROUND_MAX_NX"), 32 * WARPS
NAN_KEY, PAD_KEY = np.uint32(0xFFFFFFFE), np.uint32(0xFFFFFFFF)
TAKEN = np.uint32(0xFFFFFFFF)
NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
LOW = np.uint64(0xFFFFFFFF)


def warps_per_row(nx: int) -> int:
    """The launcher's warps a row: a power of two, at most WARPS, one per
    CHUNK values."""
    w = 1
    while w < WARPS and w * CHUNK < nx:
        w *= 2
    return w


def test_constants_match_the_binding():
    assert (CHUNK, WARPS, K_WARP_MAX, SORT_MAX_NX, ROUND_MAX_NX) == (
        kt.CHUNK, kt.WARPS, kt.K_WARP_MAX, kt.SORT_MAX_NX, kt.ROUND_MAX_NX)
    # the k rounds' keys and its static words fit the 227 KB a block may have
    assert 4 * ROUND_MAX_NX + 8 * (WARPS + 1) <= 232448
    assert CHUNK // 32 == 32          # a lane holds 32 values
    assert "while (W < WARPS && (long long)W * CHUNK < nx) W *= 2;" in SOURCE
    for nx, w in [(1, 1), (1024, 1), (1025, 2), (1230, 2), (1569, 2),
                  (8192, 8), (8193, 8), (10**6, 8)]:
        assert warps_per_row(nx) == w


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------
def keys(v: np.ndarray) -> np.ndarray:
    """float_key: unsigned order = float order, -0 onto +0, NaN above inf."""
    v = np.asarray(v, np.float32)
    u = v.view(np.uint32).copy()
    u[v == 0] = 0
    k = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    k[np.isnan(v)] = NAN_KEY
    return k


def words(v, cols) -> np.ndarray:
    return (keys(v).astype(np.uint64) << np.uint64(32)) | cols.astype(np.uint64)


def lane_columns(base: int, vec: bool) -> np.ndarray:
    """(32 lanes, 32 values) columns of a warp's step (column<VEC>)."""
    lane = np.arange(32)[:, None]
    s = np.arange(32)[None, :]
    if vec:
        return base + 4 * (lane + 32 * (s // 4)) + s % 4
    return base + lane + 32 * s


def bitonic(a: np.ndarray, n: int) -> np.ndarray:
    """The kernels' network: every comparator puts the smaller word first
    (each merge opens with a flip), comparators past n skipped."""
    a = a.copy()
    p2 = 1
    while p2 < n:
        p2 *= 2
    u = np.arange(p2 // 2)

    def layer(i, j):
        m = j < n
        i, j = i[m], j[m]
        lo, hi = np.minimum(a[i], a[j]), np.maximum(a[i], a[j])
        a[i], a[j] = lo, hi

    size = 2
    while size <= p2:
        half = size // 2
        blk, o = u // half, u % half
        layer(blk * size + o, blk * size + size - 1 - o)
        stride = half // 2
        while stride > 0:
            i = 2 * u - (u & (stride - 1))
            layer(i, i + stride)
            stride //= 2
        size *= 2
    return a


def warp_bound(v: np.ndarray, valid: np.ndarray, k: int) -> np.uint32:
    """The warp's upper bound on its k-th smallest key."""
    c = (k + 31) // 32
    m = (k + c - 1) // c
    if c == 1:
        x = np.full(32, PAD_KEY, np.uint32)
        for lane in range(32):
            if valid[lane, 0]:
                vals = v[lane][valid[lane]]
                finite = vals[~np.isnan(vals)]
                lo = finite.min() if len(finite) else np.float32("nan")
                x[lane] = keys(np.array([lo]))[0]
    else:
        kk = np.where(valid, keys(v), PAD_KEY)
        x = np.zeros(32, np.uint32)
        for p in range(c):
            x = np.array([min((q for q in kk[lane] if p == 0 or q > x[lane]),
                              default=PAD_KEY) for lane in range(32)], np.uint32)
    return x.min() if m == 1 else np.sort(x)[m - 1]


def tie_order(vec: bool) -> np.ndarray:
    """(lane, value) of a warp's step in the order the kernel's ballots
    rank ties: j, lane, s % 4 for 16-byte loads, s, lane for scalar."""
    lane, s = (a.ravel() for a in np.meshgrid(np.arange(32), np.arange(32),
                                              indexing="ij"))
    order = np.lexsort((s % 4, lane, s // 4) if vec else (lane, s))
    return np.stack([lane[order], s[order]], 1)


def threshold_select(row: np.ndarray, k: int, vec: bool,
                     paths: list | None = None) -> np.ndarray:
    """One row through the threshold select: its k columns."""
    nx = len(row)
    W = warps_per_row(nx)
    nt = 32 * W
    step = W * CHUNK
    R = np.zeros(0, np.uint64)          # the running k smallest, once held
    for s0 in range(0, nx, step):
        lanes = []
        for part in range(W):
            cols = lane_columns(s0 + part * CHUNK, vec)
            valid = cols < nx
            v = np.where(valid, row[np.minimum(cols, nx - 1)], np.float32(0))
            lanes.append((cols, valid, v))
        bound = min(warp_bound(v, valid, k) for _, valid, v in lanes)
        below, ties = [R], []
        for cols, valid, v in lanes:
            kk = keys(v)
            w = words(v, cols)
            ok = valid & (kk <= bound)
            if len(R):
                ok &= w < R[k - 1]
            below.append(w[ok & (kk < bound)])
            # the ties by their ballot rank: the warps in order, each in
            # its ballots' order, which must be column order
            at = ok & (kk == bound)
            ties += [w[ln, s] for ln, s in tie_order(vec) if at[ln, s]]
        ties = np.array(ties, np.uint64)
        assert (np.diff((ties & LOW).astype(np.int64)) > 0).all()
        cand = np.concatenate(below + [ties[:k]])
        n = len(cand)
        assert n >= k, "the bound fell below the step's k-th word"
        assert n <= step + k, "more candidates than the buffer holds"
        if n <= 2 * nt:
            rank = np.array([(cand < w).sum() for w in cand])
            out = np.full(k, NONE)
            for w, r in zip(cand, rank):
                if r < k:
                    out[r] = w
        else:
            out = bitonic(cand, n)[:k]
        if paths is not None:
            paths.append("rank" if n <= 2 * nt else "bitonic")
        assert (out[1:] > out[:-1]).all()
        R = out
    return (R & LOW).astype(np.int64)


def argmin_select(row: np.ndarray, vec: bool) -> np.ndarray:
    """k = 1: each lane's least value and lowest column holding it, the
    warp's minimum word, the row's."""
    nx = len(row)
    W = warps_per_row(nx)
    best = NONE
    for part in range(W):
        for base in range(part * CHUNK, nx, W * CHUNK):
            cols = lane_columns(base, vec)
            valid = cols < nx
            for lane in range(32):
                c = cols[lane][valid[lane]]
                if not len(c):
                    continue
                vals = row[c]
                finite = vals[~np.isnan(vals)]
                lo = finite.min() if len(finite) else np.float32("nan")
                hold = c[np.isnan(vals)] if np.isnan(lo) else c[vals == lo]
                w = words(np.array([lo]), np.array([hold.min()]))[0]
                best = min(best, w)
    return np.array([int(best & LOW)])


def row_sort(row: np.ndarray, k: int) -> np.ndarray:
    nx = len(row)
    w = bitonic(words(row, np.arange(nx)), nx)
    assert (w[1:] > w[:-1]).all()
    return (w[:k] & LOW).astype(np.int64)


def rounds(row: np.ndarray, k: int) -> np.ndarray:
    """k rounds of the block's least word, its slot then taken."""
    nx = len(row)
    kk = keys(row).astype(np.uint64)
    lane_best = np.full(THREADS, NONE)      # each thread's strided slots
    w = (kk << np.uint64(32)) | np.arange(nx, dtype=np.uint64)
    for t in range(THREADS):
        lane_best[t] = w[t::THREADS].min(initial=NONE)
    out = []
    for _ in range(k):
        win = lane_best.min()
        col = int(win & LOW)
        out.append(col)
        w[col] = (np.uint64(TAKEN) << np.uint64(32)) | np.uint64(col)
        t = col % THREADS                   # only its owner rescans
        lane_best[t] = w[t::THREADS].min()
    return np.array(out, np.int64)


def emulated_topk(d: np.ndarray, k: int):
    """(values, ids) of the kernel chosen for k, on each row."""
    vec = d.shape[1] % 4 == 0
    ids = []
    for row in d:
        if k == 1:
            ids.append(argmin_select(row, vec))
        elif k <= K_WARP_MAX:
            ids.append(threshold_select(row, k, vec))
        elif len(row) <= SORT_MAX_NX:
            ids.append(row_sort(row, k))
        else:
            assert len(row) <= ROUND_MAX_NX
            ids.append(rounds(row, k))
    ids = np.stack(ids)
    return np.take_along_axis(d, ids, 1), ids.astype(np.int32)


def check(d: np.ndarray, k: int, pallas: bool = False):
    v, i = emulated_topk(d, k)
    wv, wi = topk_smallest_ref(torch.from_numpy(d), k)
    np.testing.assert_array_equal(i, wi.numpy())
    np.testing.assert_array_equal(v.view(np.int32), wv.numpy().view(np.int32))
    # the JAX package orders -0 below +0 and leaves NaN's place open: the
    # port follows the plain version there (a stable sort)
    if np.isnan(d).any() or np.signbit(d[d == 0]).any():
        return
    rv, ri = jax_topk_ref(jnp.asarray(d), k)
    np.testing.assert_array_equal(i, np.asarray(ri))
    np.testing.assert_array_equal(v, np.asarray(rv))
    if pallas:
        pv, pi = jax_topk(jnp.asarray(d), k)
        np.testing.assert_array_equal(i, np.asarray(pi))
        np.testing.assert_array_equal(v, np.asarray(pv))


# ---------------------------------------------------------------------------
# the cases chip_smoke.py holds the kernel to on the card
# ---------------------------------------------------------------------------
def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("nq,nx,k", [(2, 8192, 10), (3, 1230, 10),
                                     (2, 1569, 16), (2, 1569, 1569),
                                     (8, 1024, 1), (2, 1000, 32),
                                     (1, 333, 100), (2, 9000, 256),
                                     (2, 9001, 257), (2, 4097, 1)])
def test_main_path_shapes(nq, nx, k):
    d = _rng(nx + k).standard_normal((nq, nx)).astype(np.float32)
    check(d, k, pallas=nx <= 8192 and k <= 256)


def test_a_row_past_the_old_limit():
    d = _rng(1).standard_normal((1, 60_000)).astype(np.float32)
    d[0, -3:] = -10.0                    # the smallest in the last step
    check(d, 10)


@pytest.mark.parametrize("edge", [1024, 8192])
def test_ties_across_an_edge(edge):
    d = (_rng(2).random((2, 20_000)) + 1.0).astype(np.float32)
    d[:, edge - 5:edge + 5] = 0.5
    check(d, 7)


def test_all_tied_rows_cut_ties_by_column():
    """A row at one value: the bound sits on it, and of its 8,191 ties the
    10 of lowest column are candidates, ranked, not a step sorted."""
    d = np.zeros((2, 8192), np.float32)
    d[:, 10] = -1.0
    d[0, 4000] = -0.0
    paths = []
    threshold_select(d[0], 10, True, paths)
    assert paths == ["rank"]
    check(d, 10, pallas=True)


@pytest.mark.parametrize("nx,vec", [(8192, True), (1230, True), (8191, False)])
def test_mostly_big_rows_give_few_candidates(nx, vec):
    """A selective filter: 4 values a row below BIG, all else ties at the
    bound; in both load layouts the ballots rank them by column."""
    rng = _rng(nx)
    d = np.full((3, nx), 3.0e38, np.float32)
    for r in range(3):
        d[r, rng.choice(nx, 4, replace=False)] = rng.random(4)
    paths = []
    threshold_select(d[0], 10, vec, paths)
    assert paths == ["rank"]
    check(d, 10)          # the Pallas kernel repeats an index past BIG


def test_large_k_takes_the_bitonic_sort():
    paths = []
    d = _rng(5).standard_normal(9000).astype(np.float32)
    threshold_select(d, 256, True, paths)
    assert "bitonic" in paths


@pytest.mark.parametrize("nx,k", [(123 * 300, 300), (SORT_MAX_NX + 1, 257)])
def test_large_k_past_the_row_sort_takes_k_rounds(nx, k):
    """A brute-force merge of 123 chunks at k = 300: past the row sort's
    28,672 values, so k rounds over the row's keys."""
    d = _rng(nx).standard_normal((1, nx)).astype(np.float32)
    d[0, ::7] = 0.5                      # ties among the k smallest
    check(d, k)


def test_the_k_smallest_in_the_last_values():
    d = (_rng(3).random((2, 8192 + 777)) + 1.0).astype(np.float32)
    d[:, -10:] = -np.arange(10, dtype=np.float32)
    check(d, 10)


@pytest.mark.parametrize("k", [1, 3, 10, 300])
def test_nan_and_signed_zero(k):
    d = _rng(4).standard_normal((3, 3000)).astype(np.float32)
    d[:, 7], d[:, 9], d[:, 11] = np.nan, -0.0, 0.0
    d[:, 13], d[:, 15] = np.inf, -np.inf
    d[1] = np.nan
    d[1, 100], d[1, 50] = -0.0, 0.0
    check(d, k)


def test_mostly_big_rows_keep_distinct_ids():
    d = np.full((2, 8192), 3.0e38, np.float32)
    d[:, 5], d[:, 9] = 1.0, 2.0
    v, i = emulated_topk(d, 5)
    assert i[0].tolist() == [5, 9, 0, 1, 2]
    check(d, 100)


def test_bitonic_network_sorts_with_virtual_padding():
    for n in [1, 2, 3, 5, 31, 100, 1569, 4097]:
        a = _rng(n).permutation(10 * n)[:n].astype(np.uint64)
        np.testing.assert_array_equal(bitonic(a, n), np.sort(a))


@settings(max_examples=30, deadline=None)
@given(nx=st.integers(1, 20_000), kfrac=st.floats(0.0, 1.0),
       levels=st.sampled_from([1, 2, 7, 300, 0]), seed=st.integers(0, 2**16),
       odd=st.booleans())
def test_select_matches_a_stable_sort(nx, kfrac, levels, seed, odd):
    """Random widths (ragged and scalar-load rows too), k from 1 to 300,
    and tie patterns from one value to none."""
    if odd and nx % 4 == 0:
        nx += 1
    k = 1 + int(kfrac * (min(nx, 300) - 1))
    rng = _rng(seed)
    d = (rng.integers(0, levels, (2, nx)) if levels
         else rng.standard_normal((2, nx))).astype(np.float32)
    check(d, k)
