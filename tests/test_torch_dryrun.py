"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch/specs.py``,
``configs.dryrun_cells``) against the JAX package's on the CPU.

The reference lowers every cell on 512 forced host devices; its input
specs and sharding rules run here on ``AbstractMesh``es without devices.
The port's fake process group belongs to the whole process, so whatever
runs on one goes through a subprocess: ``tests/_torch_fake_world.py``
(reduced configs on a fake 2x4) and the CLI itself (full width, fake
16x16 and 2x16x16).
"""
import json
import os
import resource
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import dryrun_cells as jax_dryrun_cells  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import sharding as jax_sharding  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, dryrun_cells,  # noqa: E402
                                 get_config)
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.fsdp import shard_specs  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import production_axes  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.convert import reference_key  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
MESHES = {"pod16x16": False, "pod2x16x16": True}
#: the keys of the reference's artifact (``lower_cell``, then ``main``)
ARTIFACT_KEYS = {"arch", "shape", "mesh", "num_devices", "lower_s",
                 "compile_s", "compile_costing_s", "flops", "bytes_accessed",
                 "attn_adjustment", "memory", "collectives", "params",
                 "active_params", "runtime_overrides", "fsdp", "microbatch",
                 "tp"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes"}


@pytest.fixture(scope="module", autouse=True)
def _subprocesses(tmp_path_factory):
    """Start this file's two subprocesses with its first test, so they run
    beside the in-process tests: the fake-world costing and the CLI."""
    tmp = tmp_path_factory.mktemp("dryrun")
    before = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    procs = {
        "fake": subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_torch_fake_world.py"),
             str(tmp / "fake.json")], env=ENV, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "glm4-9b", "--shape", "decode_32k", "--both-meshes", "--out",
             str(tmp / "cli")], env=ENV, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE),
    }
    yield tmp, procs, before
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _finish(subprocesses, name: str):
    tmp, procs, _ = subprocesses
    _, err = procs[name].communicate(timeout=300)
    assert procs[name].returncode == 0, err.decode()[-2000:]
    return tmp


def _abstract(multi_pod: bool):
    axes = production_axes(multi_pod=multi_pod)
    return AbstractMesh(tuple(axes.values()), tuple(axes)), axes


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def test_dryrun_cells_equal_the_references():
    assert dryrun_cells() == jax_dryrun_cells()
    assert len(dryrun_cells()) == 34
    assert {a for a, s in dryrun_cells() if s == "long_500k"} == {
        a for a in ASSIGNED_ARCHS if get_config(a).sub_quadratic}


# ---------------------------------------------------------------------------
# input stand-ins and their specs
# ---------------------------------------------------------------------------
def _same_leaf(mine: torch.Tensor, want) -> None:
    assert mine.device.type == "meta"
    assert tuple(mine.shape) == tuple(want.shape)
    assert str(mine.dtype).removeprefix("torch.") == want.dtype.name


def _ref_layer_caches(jcache: dict, cfg) -> list:
    """The reference's stacked cache pytree as the port's per-layer list of
    (leaf name -> (ShapeDtypeStruct of the layer, its stacked path))."""
    out = []
    period = len(cfg.layer_pattern())
    for i, spec in enumerate(cfg.block_specs()):
        if i < cfg.first_k_dense:
            out.append({n: (s, ("prefix", i, n))
                        for n, s in jcache["prefix"][i].items()})
        else:
            j = (i - cfg.first_k_dense) % period
            out.append({n: (jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
                            ("pattern", j, n))
                        for n, s in jcache["pattern"][j].items()})
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", jax_dryrun_cells())
def test_specs_equal_the_references(arch, shape_name, mesh_name):
    """Stand-ins: the reference's shapes and dtypes, on meta.  Batch and
    cache-length specs: the reference's.  Caches, layer by layer: the
    reference's rule (``cache_shardings``) on the layer's KV leaves,
    recurrent state whole, the batch dim over the DP axes as the inputs';
    the reference's own tree gives the same sequence split on its 4-D
    (prefix) KV leaves and replicates its 5-D (stacked) ones."""
    am, axes = _abstract(MESHES[mesh_name])
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        want, want_sh = jax_specs.train_specs(jcfg, shape, am)
        got, got_sh = specs.train_specs(cfg, shape, axes)
        assert set(got) == set(want)
        for k in want:
            _same_leaf(got[k], want[k])
            assert got_sh[k] == tuple(want_sh[k].spec), k
        return
    if shape.kind == "prefill":
        (wx, wc), (wxs, wcs) = jax_specs.prefill_specs(jcfg, shape, am)
        (gx, gc), (gxs, gcs) = specs.prefill_specs(cfg, shape, axes)
    else:
        (wx, wc, wl), (wxs, wcs, wls) = jax_specs.decode_specs(jcfg, shape, am)
        (gx, gc, gl), (gxs, gcs, gls) = specs.decode_specs(cfg, shape, axes)
        _same_leaf(gl, wl)
        assert gls == tuple(wls.spec) == ()
    assert set(gx) == set(wx)
    for k in wx:
        _same_leaf(gx[k], wx[k])
        assert gxs[k] == tuple(wxs[k].spec), k
    dp = gxs[next(iter(gx))][0]
    layers = _ref_layer_caches(wc, cfg)
    assert len(gc) == len(gcs) == len(layers)
    for i, (blk, mine, mine_sh, ref) in enumerate(
            zip(cfg.block_specs(), gc, gcs, layers)):
        assert set(mine) == set(ref), i
        for n, (leaf, path) in ref.items():
            _same_leaf(mine[n], leaf)
            if blk.kind == "attention":
                rule = tuple(jax_sharding.cache_shardings(leaf, am).spec)
            else:
                rule = (None,) * len(leaf.shape)
            assert mine_sh[n] == (dp,) + rule[1:], (i, n)
            kind, j, _ = path
            tree = tuple(wcs[kind][j][n].spec)
            if kind == "prefix":
                assert tree[1:] == mine_sh[n][1:], (i, n)
            elif blk.kind == "attention":
                assert all(e is None for e in tree), (i, n)


# ---------------------------------------------------------------------------
# per-rank parameter and AdamW bytes
# ---------------------------------------------------------------------------
def _port_bytes(cfg, axes) -> tuple[dict, dict]:
    """Per stacked reference leaf: this rank's parameter and AdamW (m, v,
    fp32 master) bytes in the port, summed over its layers."""
    lm = model.DecoderLM(cfg, device="meta")
    pspecs, zspecs, _ = shard_specs(lm, axes, dp_axes=("data", "pod"))
    pb, ob = {}, {}
    for n, p in lm.named_parameters():
        key, _ = reference_key(n, cfg)
        pb[key] = pb.get(key, 0) + _numel(sharding.local_shape(
            tuple(p.shape), pspecs[n], axes)) * p.element_size()
        ob[key] = ob.get(key, 0) + _numel(sharding.local_shape(
            tuple(p.shape), zspecs[n], axes)) * 12
    return pb, ob


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_per_rank_param_and_adamw_bytes_equal_the_references(arch, mesh_name):
    """Leaf by leaf, this rank's parameter bytes are those of the
    reference's ``param_shardings`` and its AdamW bytes those of
    ``zero_shardings``, but where the reference's ZeRO spec slices the
    period axis of a stacked leaf that no per-layer dim divides (the
    port's layers are not stacked): there the port holds the layer's
    state whole over the DP axes, the DP size times the reference's.
    That happens only for the 48-period configs' norm scales at 16x16."""
    am, axes = _abstract(MESHES[mesh_name])
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    pshape = jax.eval_shape(
        lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(pshape)[0]}
    jp = jax_sharding.param_shardings(flat, am)
    jz = jax_sharding.zero_shardings(jp, flat, am)
    pb, ob = _port_bytes(cfg, axes)
    assert set(pb) == set(flat)
    dp = _numel([axes[a] for a in axes if a != "model"])
    period_sliced = []
    for key, leaf in flat.items():
        local = sharding.local_shape(tuple(leaf.shape), tuple(jp[key].spec),
                                     axes)
        assert pb[key] == _numel(local) * leaf.dtype.itemsize, key
        zlocal = sharding.local_shape(tuple(leaf.shape), tuple(jz[key].spec),
                                      axes)
        want = _numel(zlocal) * 12
        if key.startswith("blocks/") and tuple(jz[key].spec)[0] is not None:
            period_sliced.append(key)
            assert ob[key] in (want, want * dp), key
            if ob[key] != want:
                assert tuple(jp[key].spec)[0] is None
        else:
            assert ob[key] == want, key
    wide = {k for k in period_sliced if ob[k] != _numel(
        sharding.local_shape(tuple(flat[k].shape), tuple(jz[k].spec),
                             axes)) * 12}
    if arch in ("musicgen-medium", "internvl2-26b") and mesh_name == "pod16x16":
        assert wide and all("norm" in k for k in wide), wide
    else:
        assert not wide, wide


# ---------------------------------------------------------------------------
# the costing passes on a fake world (a subprocess)
# ---------------------------------------------------------------------------
FAKE_CASES = 10


@pytest.fixture(scope="module")
def fake_world(_subprocesses):
    tmp = _finish(_subprocesses, "fake")
    res = json.loads((tmp / "fake.json").read_text())
    assert len(res) == FAKE_CASES
    return res


@pytest.mark.parametrize("case", range(FAKE_CASES))
def test_costing_extrapolated_from_two_depths_equals_full_depth(fake_world,
                                                                case):
    """Reduced configs at small inputs on a fake 2x4: the FLOPs, bytes and
    collective bytes extrapolated from depths ``first_k_dense + 1`` and
    ``+ 2`` periods equal the full-depth counts."""
    r = fake_world[case]
    assert r["extrap"] == r["full"], r["case"]
    assert r["extrap_coll"] == r["full_coll"], r["case"]
    assert r["full"]["flops"] > 0 and r["full"]["bytes"] > 0


@pytest.mark.parametrize("case", range(FAKE_CASES))
def test_counted_collectives_equal_gather_on_use_closed_form(fake_world,
                                                             case):
    """``count_collectives`` over a full-depth step (train at remat
    block, microbatch 1 and 2, fsdp; prefill; decode over a
    sequence-sharded cache) equals ``gather_on_use_bytes``."""
    r = fake_world[case]
    assert r["full_coll"] == r["closed_form"] > 0, r["case"]


# ---------------------------------------------------------------------------
# the CLI at full width (a subprocess)
# ---------------------------------------------------------------------------
def test_cli_writes_the_references_artifacts_without_allocating(
        _subprocesses):
    """``--arch glm4-9b --shape decode_32k --both-meshes`` writes one JSON
    a mesh with the reference's keys; argument bytes are the local_shape
    sum of the parameters, the token and the caches; collective bytes
    the closed form; the process never holds the model (its peak RSS
    stays far below glm4-9b's 18.8 GB of bf16 weights)."""
    tmp_path = _finish(_subprocesses, "cli") / "cli"
    before = _subprocesses[2]
    peak_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    assert max(peak_kb, before) < 3 * 2 ** 20
    cfg, shape = get_config("glm4-9b"), SHAPES["decode_32k"]
    for tag, mp in (("sp", False), ("mp", True)):
        art = json.loads((tmp_path / f"glm4-9b__decode_32k__{tag}.json")
                         .read_text())
        assert set(art) == ARTIFACT_KEYS and set(art["memory"]) == MEMORY_KEYS
        assert art["memory"]["temp_bytes"] is None
        axes = production_axes(multi_pod=mp)
        assert art["num_devices"] == _numel(list(axes.values()))
        lm = model.DecoderLM(cfg, device="meta")
        pspecs, _, _ = shard_specs(lm, axes, dp_axes=("pod", "data"))
        params = sum(_numel(sharding.local_shape(tuple(p.shape), pspecs[n],
                                                 axes)) * p.element_size()
                     for n, p in lm.named_parameters())
        (x, caches, _), (xs, cs, _) = specs.decode_specs(cfg, shape, axes)
        inputs = sum(_numel(sharding.local_shape(tuple(t.shape), s, axes))
                     * t.element_size()
                     for leaves, sp in ((x, xs), *zip(caches, cs))
                     for t, s in zip(leaves.values(), sp.values()))
        assert art["memory"]["argument_bytes"] == params + inputs + 4
        assert art["collectives"]["total_bytes"] == dryrun.gather_on_use_bytes(
            cfg, shape, axes)
        assert art["flops"] > 0 and art["bytes_accessed"] > 0
