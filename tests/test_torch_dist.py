"""The port's distributed substrate (``repro_torch.dist``,
``repro_torch.launch.mesh``, the expert-parallel MoE, the sequence-sharded
decode, ``compressed_allreduce``, the sharded Trainer and
``launch.train``'s mesh flags) against the JAX package on the CPU.

The reference's multi-device paths do not run under this JAX
(``tests/test_dist_train.py`` fails at the seed), so the oracle is its
single-device result, which is also what those tests compare against; its
sharding rules run on ``AbstractMesh``es without devices.  The port's
many-rank cases run as Gloo CPU processes (the counterpart of the
reference's forced host devices): each test spawns one group, rendezvous
through a FileStore under ``tmp_path``, and the ranks
(``tests/_torch_dist_ranks.py``) import only ``repro_torch``; the
reference's arrays reach them as numpy.
"""
import dataclasses
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import _torch_dist_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.grpo import GRPOConfig as JaxGRPOConfig  # noqa: E402
from repro.core.grpo import grpo_loss as jax_grpo_loss  # noqa: E402
from repro.dist import sharding as jax_sharding  # noqa: E402
from repro.models import Runtime as JaxRuntime  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.optim import grad_compress as jax_gc  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.grpo import GRPOConfig, grpo_loss_and_grad  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import Runtime, model  # noqa: E402
from repro_torch.models.convert import (from_reference_params,  # noqa: E402
                                        reference_key, reference_leaves)
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402


def _spawn(tmp_path, world: int, fn, *args) -> None:
    """Run ``fn(rank, *args)`` on ``world`` Gloo ranks; fail when a rank
    raises or the group outlives its timeout."""
    args_file = tmp_path / "args.pkl"
    args_file.write_bytes(pickle.dumps(args))
    ctx = mp.start_processes(
        ranks.entry, args=(fn, world, str(tmp_path / "store"), str(args_file)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + ranks.TIMEOUT_S + 30
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__}: ranks still running at the deadline")


def _f32(arch, **over):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32", **over)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32", **over)
    return jcfg, cfg


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


# ---------------------------------------------------------------------------
# the sharding rules, spec for spec
# ---------------------------------------------------------------------------
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          (tuple(port_mesh.tuned_axes(4).values()),
           tuple(port_mesh.tuned_axes(4)))]


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in leaves}


def _stacked_shapes(cfg) -> tuple[dict, dict]:
    """The port's parameter shapes, from a model on the meta device, in the
    reference's layout (pattern blocks stacked under num_periods), and
    per layer."""
    lm = model.DecoderLM(cfg, device="meta")
    per_layer = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    stacked = {}
    for n, shape in per_layer.items():
        key, t = reference_key(n, cfg)
        stacked[key] = shape if t is None else (cfg.num_periods(),) + shape
    return stacked, per_layer


@pytest.mark.parametrize("arch", list_archs())
def test_sharding_specs_equal_the_references(arch):
    """param / zero / cache / batch specs equal the reference's on
    AbstractMeshes (2,4), (4,2), (16,16), (2,16,16) and make_tuned_mesh(4)'s
    axes, fsdp on and off; the port's per-layer placement is the stacked
    spec less its period entry wherever fsdp is off."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    pshape = _flat(jax.eval_shape(
        lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg)))
    pshape = {k: v for k, v in pshape.items()
              if k.split("/")[0] in ("embed", "final_norm", "prefix", "blocks")}
    stacked, per_layer = _stacked_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in pshape.items()} == stacked
    jcache = _flat(jax.eval_shape(lambda: jax_model.init_cache(jcfg, 2, 64)))
    cshape = {k: tuple(v.shape) for k, v in jcache.items()}
    per_layer_caches = sorted(
        s[1:] if k.startswith("pattern") else s
        for k, s in cshape.items()
        for _ in range(cfg.num_periods() if k.startswith("pattern") else 1))
    assert per_layer_caches == sorted(
        tuple(t.shape) for c in model.init_cache(cfg, 2, 64, device="meta")
        for t in c.values())
    assert port_mesh.tuned_axes(4) == {"data": 16, "replica": 4, "model": 4}

    for shape, names in MESHES:
        am = AbstractMesh(shape, names)
        sizes = dict(zip(names, shape))
        for fsdp in (False, True):
            jp = jax_sharding.param_shardings(
                {k: v for k, v in pshape.items()}, am, fsdp=fsdp)
            mine = sharding.param_shardings(stacked, sizes, fsdp=fsdp)
            assert {k: tuple(v.spec) for k, v in jp.items()} == mine, (shape, fsdp)
            if fsdp:      # ZeRO over FSDP specs names a DP axis twice
                continue
            jz = jax_sharding.zero_shardings(jp, pshape, am)
            assert ({k: tuple(v.spec) for k, v in jz.items()}
                    == sharding.zero_shardings(mine, stacked, sizes))
        layer = sharding.param_shardings(per_layer, sizes)
        for n, spec in layer.items():
            key, t = reference_key(n, cfg)
            whole = sharding.param_shardings({key: stacked[key]}, sizes)[key]
            if t is not None:
                assert whole[0] is None, (key, whole)
                whole = whole[1:]
            assert spec == whole, (n, shape)
        jc = jax_sharding.cache_shardings(jcache, am)
        assert ({k: tuple(v.spec) for k, v in jc.items()}
                == sharding.cache_shardings(cshape, sizes))
        for ndim, batch in ((2, None), (3, 32), (2, 1)):
            assert (tuple(jax_sharding.batch_sharding(am, ndim, batch).spec)
                    == sharding.batch_sharding(sizes, ndim, batch))
        assert sharding.scalar_sharding(sizes) == tuple(
            jax_sharding.scalar_sharding(am).spec)


def test_slices_and_placements_agree_with_dtensor(tmp_path):
    """local_slice / placements on a one-rank mesh: a DTensor distributed
    with the placements has the slice as its local tensor."""
    import os

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    os.environ.update(RANK="0", WORLD_SIZE="1")
    port_mesh.init_distributed("cpu", init_method=f"file://{tmp_path}/s",
                               timeout_s=30)
    try:
        m = port_mesh.make_debug_mesh(1, 1)
        x = torch.arange(24.0).reshape(2, 3, 4)
        for spec in [(None, None, "model"), ("data", None, None), ()]:
            pl = sharding.placements(spec, m)
            assert torch.equal(distribute_tensor(x, m, pl).to_local(),
                               sharding.local_slice(x, spec, m))
        sizes = {"data": 2, "model": 4}
        y = torch.arange(64.0).reshape(8, 8)
        parts = [sharding.local_slice(y, (("data", "model"), None), sizes,
                                      {"data": d, "model": k})
                 for d in range(2) for k in range(4)]
        assert torch.equal(torch.cat(parts), y)
        assert sharding.local_shape((8, 6), ("model", "data"), sizes) == (2, 3)
        with pytest.raises(ValueError, match="needs 8 ranks.*world has 1"):
            port_mesh.make_debug_mesh(2, 4)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the expert-parallel MoE
# ---------------------------------------------------------------------------
def test_expert_parallel_moe_matches_the_local_branch(tmp_path):
    """dbrx reduced, fp32, capacity 8, x (4, 8, d) on 2x4: the output within
    1e-4 of the reference's apply_moe(mesh=None), aux equal (every rank's);
    the gradients of sum(out) within 1e-5 of the port's local branch."""
    jcfg, cfg = _f32("dbrx-132b")
    p = _np_tree(jax_moe.init_moe(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(1).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)
    want, jaux = jax_moe.apply_moe(p, jnp.asarray(x), jcfg, mesh=None,
                                   capacity_factor=8.0)
    out = str(tmp_path / "moe.npz")
    _spawn(tmp_path, 8, ranks.moe_rank, cfg, p, x, 8.0, out)
    got = np.load(out)

    np.testing.assert_allclose(got["y"], np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["aux"], float(jaux), rtol=1e-6)
    assert list(got["fwd_ops"]) == ["all-reduce"]

    layer = MoE(cfg, device="cpu")
    with torch.no_grad():
        for name, t in layer.named_parameters():
            t.copy_(torch.from_numpy(p[name]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = layer(xt, 8.0)
    names = ["router", "w_gate", "w_in", "w_out"]
    g = torch.autograd.grad(y.sum(), [getattr(layer, n) for n in names] + [xt])
    for n, gl in zip(names + ["x"], g):
        np.testing.assert_allclose(got["g_" + n], gl.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# the sequence-sharded decode
# ---------------------------------------------------------------------------
def test_seq_sharded_decode_matches_the_plain_decode(tmp_path):
    """glm4 reduced, fp32, B 2, S 32, cache S + 8, on 2x4 with
    seq_shard_decode: logits within 1e-3 of the reference's decode_step (its
    own bar) and 1e-5 of the port's plain decode; one step's counted bytes
    equal at cache 40 and 72 (O(B * Hq * D), not the context)."""
    jcfg, cfg = _f32("glm4-9b")
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    B, S = 2, 32
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         jcfg.vocab_size))
    rt0 = JaxRuntime(mesh=None, attn_chunk=16, logit_chunk=16, remat="none")
    caches = jax_model.init_cache(jcfg, B, S + 8)
    _, caches, clen = jax_model.prefill(params, {"tokens": toks[:, :-1]},
                                        jcfg, rt0, caches)
    want, _, _ = jax_model.decode_step(params, {"tokens": toks[:, -1:]},
                                       jcfg, rt0, caches, clen)
    params = _np_tree(params)

    lm = from_reference_params(params, cfg, device="cpu")
    prt = Runtime(attn_chunk=16, logit_chunk=16, remat="none")
    t = torch.from_numpy(toks)
    pc = model.init_cache(cfg, B, S + 8, device="cpu")
    _, pc, plen = model.prefill(lm, t[:, :-1], prt, pc)
    plain, _, _ = model.decode_step(lm, t[:, -1:], prt, pc, plen)

    out = str(tmp_path / "decode.npz")
    _spawn(tmp_path, 8, ranks.seq_decode_rank, cfg, params, toks,
           (S + 8, S + 40), out)
    got = np.load(out)
    np.testing.assert_allclose(got["logits"][0], np.asarray(want), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got["logits"][0], plain.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["logits"][1], plain.numpy(), atol=1e-5,
                               rtol=0)
    assert got["bytes"][0] == got["bytes"][1] > 0
    n = len(got["ops"]) // 2
    np.testing.assert_array_equal(got["ops"][:n], got["ops"][n:])


# ---------------------------------------------------------------------------
# the sharded training step
# ---------------------------------------------------------------------------
def test_sharded_train_step_matches_single_device(tmp_path):
    """deepseek reduced, fp32, vocab 256, capacity 8, B 4 x S 32 (the
    reference's own inputs) on 2x4: the loss within 1e-4 of the reference's
    single-device grpo_loss, the gathered gradients within 1e-4 of the
    port's single-device ones, each rank's parameter and AdamW bytes those
    of its specs, and the losses and weights of 3 Trainer steps (the
    last two at a learning rate above 0) those of the one-device
    Trainer's after each step."""
    jcfg, cfg = _f32("deepseek-moe-16b", vocab_size=256)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    B, S = 4, 32
    batch = {
        "tokens": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S),
                                                0, 256)),
        "mask": np.ones((B, S), np.float32),
        "advantages": np.asarray([1.0, -1.0, 0.5, -0.5], np.float32),
        "old_logps": np.zeros((B, S), np.float32),
        "ref_logps": np.zeros((B, S), np.float32),
    }
    rt_kw = dict(attn_chunk=16, logit_chunk=16, remat="none",
                 capacity_factor=8.0)
    l0, _ = jax_grpo_loss(params, batch, jcfg, JaxRuntime(mesh=None, **rt_kw),
                          JaxGRPOConfig())
    params = _np_tree(params)

    out = str(tmp_path / "train.npz")
    _spawn(tmp_path, 8, ranks.train_step_rank, cfg, params, batch, rt_kw, out)
    got = np.load(out)
    assert abs(float(got["loss"]) - float(l0)) < 1e-4
    assert abs(float(got["step_loss"][0]) - float(l0)) < 1e-4

    lm = from_reference_params(params, cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, _), grads = grpo_loss_and_grad(lm, tb, Runtime(**rt_kw),
                                          GRPOConfig())
    assert abs(float(loss) - float(l0)) < 1e-4
    for n, g in grads.items():
        np.testing.assert_allclose(got["g/" + n], g.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=n)

    # bytes: the 8 ranks hold what the specs give rank 0
    sizes = {"data": 2, "model": 4}
    specs = sharding.param_shardings({n: g.shape for n, g in grads.items()},
                                     sizes)
    for prefix, mod in model.DecoderLM(cfg, device="meta").named_modules():
        if isinstance(mod, MoE):                  # the E-sharded experts
            for leaf in ("w_gate", "w_in", "w_out"):
                specs[f"{prefix}.{leaf}"] = ("model", None, None)
    zspecs = sharding.zero_shardings(specs, {n: g.shape for n, g in
                                             grads.items()}, sizes)
    held = sum(int(np.prod(sharding.local_shape(g.shape, specs[n], sizes))) * 4
               for n, g in grads.items())
    held_opt = sum(int(np.prod(sharding.local_shape(g.shape, zspecs[n],
                                                    sizes))) * 4 * 3
                   for n, g in grads.items())
    assert int(got["held"]) == held and int(got["held_opt"]) == held_opt
    total = sum(g.numel() * 4 for g in grads.values())
    assert held < total / 2 and held_opt < 3 * total / 4

    one = Trainer(cfg, Runtime(**rt_kw),
                  from_reference_params(params, cfg, device="cpu"),
                  tcfg=TrainerConfig(ckpt_dir=str(tmp_path),
                                     **ranks.TRAIN_TCFG),
                  gcfg=GRPOConfig())
    for i in range(ranks.TRAIN_STEPS):
        one.run(lambda step: batch, steps=1)
        assert abs(got["step_loss"][i] - one.metrics_log[i]["loss"]) < 1e-5, i
        for n, p in one.params.items():
            np.testing.assert_allclose(got[f"p{i}/{n}"], p.detach().numpy(),
                                       atol=2e-5, rtol=0,
                                       err_msg=f"step {i}: {n}")


# ---------------------------------------------------------------------------
# compressed all-reduce
# ---------------------------------------------------------------------------
def test_compressed_allreduce_sums_the_references_codes(tmp_path):
    """4 ranks on a 2x2 mesh, reduced over both axes: every rank's result is
    the reference's per-rank compress_with_feedback codes summed in int32
    times the mean scale, and each residual the reference's (1 ulp on the
    scales, as the quantizer allows).  A 2x4 mesh on these 4 ranks raises."""
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b": (33,), "c": (2, 3, 4)}
    grads = [{k: (rng.standard_normal(s) * (r + 1)).astype(np.float32)
              for k, s in shapes.items()} for r in range(4)]
    residuals = [{k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
                  for k, s in shapes.items()} for r in range(4)]
    codes, scales, jres = [], [], []
    for g, r in zip(grads, residuals):
        comp, res = jax_gc.compress_with_feedback(g, r)
        codes.append({k: np.asarray(c.q, np.int32) for k, c in comp.items()})
        scales.append({k: np.float32(c.scale) for k, c in comp.items()})
        jres.append({k: np.asarray(v) for k, v in res.items()})
    out = str(tmp_path / "compress_{rank}.npz")
    _spawn(tmp_path, 4, ranks.compress_rank, grads, residuals, out)
    for r in range(4):
        got = np.load(out.format(rank=r))
        for k in shapes:
            acc = sum(c[k] for c in codes).astype(np.int32)
            mean = np.float32(sum(s[k] for s in scales) / np.float32(4))
            near = (mean, np.nextafter(mean, np.float32(np.inf)),
                    np.nextafter(mean, np.float32(-np.inf)))
            assert any(np.array_equal(got["sum/" + k],
                                      acc.astype(np.float32) * m)
                       for m in near), k
            np.testing.assert_allclose(got["res/" + k], jres[r][k],
                                       rtol=0, atol=1e-6 * np.abs(
                                           grads[r][k]).max())


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------
def test_checkpoint_saved_on_2x4_restores_on_4x2_one_device_and_the_reference(
        tmp_path):
    """stablelm reduced (bf16 weights): a sharded Trainer on 2x4 takes 2
    steps and saves; one on 4x2 restores every leaf bit-equal (in the
    ranks), and so do the port's one-device Trainer and the reference's."""
    jcfg = jax_get_config("stablelm-1.6b", reduced=True)
    cfg = get_config("stablelm-1.6b", reduced=True)
    params = _np_tree(jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    ck = tmp_path / "ck"
    out = str(tmp_path / "state.npz")
    _spawn(tmp_path, 8, ranks.checkpoint_rank, cfg, params, str(ck), out)
    saved = np.load(out)
    assert sorted(p.name for p in ck.iterdir()) == ["step_2"]

    tk = dict(total_steps=4, warmup_steps=1, ckpt_every=2)
    one = Trainer(cfg, Runtime(attn_chunk=16, logit_chunk=16, remat="none"),
                  model.DecoderLM(cfg, device="cpu"),
                  tcfg=TrainerConfig(ckpt_dir=str(ck), **tk),
                  gcfg=GRPOConfig())
    assert one.try_restore() and one.step == 2
    ref = JaxTrainer(jcfg, JaxRuntime(remat="none"),
                     jax_model.init_params(jax.random.PRNGKey(5), jcfg),
                     tcfg=JaxTrainerConfig(ckpt_dir=str(ck), **tk),
                     gcfg=JaxGRPOConfig())
    assert ref.try_restore() and ref.step == 2
    for group, want in (("p", ref.params), ("m", ref.opt_state["m"]),
                        ("v", ref.opt_state["v"]),
                        ("master", ref.opt_state["master"])):
        mine = one.params if group == "p" else one.opt_state[group]
        want = reference_leaves(want, cfg)
        assert set(want) == set(mine)
        for n, t in mine.items():
            s = saved[f"{group}/{n}"]
            np.testing.assert_array_equal(t.detach().float().numpy(), s,
                                          err_msg=f"{group} {n}")
            np.testing.assert_array_equal(np.asarray(want[n], np.float32), s,
                                          err_msg=f"{group} {n}")


# ---------------------------------------------------------------------------
# launch.train's mesh flags
# ---------------------------------------------------------------------------
def test_launch_train_debug_mesh_2x4_on_gloo(tmp_path, capfd):
    """``--debug-mesh 2x4 --device cpu`` trains 4 steps and prints ``done: 4
    steps``; the first two losses are within 1e-4 of the one-device run's
    (after that the reduced policy's bf16 weights round the two runs'
    differently summed gradients apart) and every loss is finite."""
    argv = ["--arch", "crinn-policy-100m", "--reduced", "--steps", "4",
            "--seq", "64", "--global-batch", "4", "--device", "cpu"]
    one = train_main.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    capfd.readouterr()
    log = train_main.main(argv + ["--ckpt-dir", str(tmp_path / "mesh"),
                                  "--debug-mesh", "2x4"])
    out = capfd.readouterr().out
    assert "done: 4 steps" in out and out.count("done:") == 1
    assert [r["step"] for r in log] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in log)
    for a, b in zip(one[:2], log[:2]):
        assert abs(a["loss"] - b["loss"]) < 1e-4, (a["loss"], b["loss"])
    assert not any((tmp_path / "mesh").iterdir())      # ckpt_every is 5


@pytest.mark.parametrize("world", [None, "8"])
def test_production_raises_off_a_world_of_256(tmp_path, monkeypatch, world):
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(RuntimeError,
                       match=f"over 256 ranks; this world has {world or 1}"):
        train_main.main(["--reduced", "--device", "cpu", "--production",
                         "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
