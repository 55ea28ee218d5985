"""The plain reference against NumPy at a tiny size, and the import guard:
nothing the harness runs loads JAX or the JAX package, and the reference
loads nothing of the port."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.reference import ivf as ref  # noqa: E402


def _data(n=600, nq=25, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def _brute(base, q, k):
    d = ((q[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


def test_exact_knn_matches_numpy():
    base, q = _data()
    ids, d = ref.exact_knn(torch.from_numpy(base), torch.from_numpy(q), 10)
    want_ids, want_d = _brute(base, q, 10)
    assert np.array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-12)


def _ivf_numpy(base, q, cent, cell, nprobe, m, k):
    """The search the configurations state, one query at a time."""
    codes, scales = ref.quantize_int8(torch.from_numpy(base))
    deq = codes.numpy().astype(np.float64) * scales.numpy()[:, None]
    out = []
    for x in q.astype(np.float64):
        dc = ((cent.astype(np.float64) - x) ** 2).sum(1)
        cand = np.concatenate([np.flatnonzero(cell == c) for c in
                               np.argsort(dc, kind="stable")[:nprobe]])
        ds = ((deq[cand] - x) ** 2).sum(1)
        short = cand[np.argsort(ds, kind="stable")[:m]]
        dr = ((base[short].astype(np.float64) - x) ** 2).sum(1)
        out.append(short[np.argsort(dr, kind="stable")[:k]])
    return np.stack(out)


@pytest.mark.parametrize("nprobe,m", [(3, 20), (16, 600)])
def test_ivf_reference_matches_numpy(nprobe, m):
    base, q = _data()
    rng = np.random.default_rng(1)
    cent = base[rng.choice(len(base), 16, replace=False)]
    cell = np.argmin(((base[:, None] - cent[None]) ** 2).sum(-1), 1)
    r = ref.IvfReference(torch.from_numpy(base), torch.from_numpy(cent),
                         torch.from_numpy(cell), nprobe=nprobe, m=m, k=10)
    ids, d = r.search(torch.from_numpy(q))
    assert np.array_equal(ids.numpy(), _ivf_numpy(base, q, cent, cell,
                                                   nprobe, m, 10))
    if m == len(base):      # every cell, every row: the exact answer
        assert np.array_equal(ids.numpy(), _brute(base, q, 10)[0])
    assert ref.cell_error_ratio(torch.from_numpy(base),
                                torch.from_numpy(cent),
                                torch.from_numpy(cell)) == pytest.approx(1.0)
    assert ref.cell_error_ratio(torch.from_numpy(base),
                                torch.from_numpy(cent),
                                torch.from_numpy((cell + 1) % 16)) > 1.5


def test_centroid_gap_matches_numpy():
    # cells of a fixed assignment: 0 at their rows' means; the share of
    # the error the means would take away, worked out directly, elsewhere
    base, _ = _data(n=300, d=6, seed=3)
    cell = np.arange(len(base)) % 7
    mean = np.stack([base[cell == c].astype(np.float64).mean(0)
                     for c in range(7)])
    gap = ref.centroid_gap(torch.from_numpy(base), torch.from_numpy(mean),
                           torch.from_numpy(cell))
    assert gap == pytest.approx(0.0, abs=1e-12)
    cent = base[[list(cell).index(c) for c in range(7)]]    # one row each
    err = ((base.astype(np.float64) - cent[cell]) ** 2).sum()
    moved = sum((cell == c).sum() * ((mean[c] - cent[c]) ** 2).sum()
                for c in range(7))
    gap = ref.centroid_gap(torch.from_numpy(base), torch.from_numpy(cent),
                           torch.from_numpy(cell))
    assert gap == pytest.approx(moved / err, rel=1e-9)
    assert 0.3 < gap < 0.7


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -11, 3.0], dtype=torch.float32)
    want = [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9, 3.0]
    assert ref.tf32(x).tolist() == want


def test_quantize_matches_numpy():
    base, _ = _data(n=50)
    codes, scales = ref.quantize_int8(torch.from_numpy(base))
    s = np.maximum(np.abs(base).max(1), 1e-12).astype(np.float32) \
        / np.float32(127)
    want = np.clip(np.round(base / s[:, None]), -127, 127)
    assert np.array_equal(codes.numpy(), want.astype(np.int8))
    assert np.array_equal(scales.numpy(), s)


def _modules_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in"
                          " sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300, check=True).stdout
    return set(out.split())


def test_harness_loads_no_jax():
    mods = _modules_after(
        "import copy, time\n"
        "from portbench import cell, check, control, loadgen, roofline, "
        "specs, tracing\n"
        "from portbench import run\n"
        "c = specs.find_cell('gist1m-ivf.closed256')\n"
        "cfg = copy.deepcopy(c.config)\n"
        "cfg['dataset'].update(n_base=3000, n_query=64, dim=16)\n"
        "cfg['index'].update(nlist=16, max_cell=400)\n"
        "cfg['operating_point'].update(ef=64, nprobe=16)\n"
        "t = dict(c.traffic, clients=32, max_batch=8)\n"
        "c = specs.Cell(c.name, 1, c.config_name, cfg, c.traffic_name, t, "
        "c.end_to_end, c.per_layer)\n"
        "out = cell.run(c, 3, 0.3, False, 'cpu',\n"
        "               t_start=time.perf_counter())\n"
        "assert out['correct'], out['checks']\n"
        "assert not run.forbidden_modules()\n")
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after("import portbench.reference.ivf")
    assert not mods & {"repro_torch", "repro", "jax"}
