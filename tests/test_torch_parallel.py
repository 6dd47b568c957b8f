"""PyTorch port, pixel sharding over torch.distributed on the CPU.

Ranks are spawned processes joined over gloo through a ``FileStore``
under the test's temporary directory (``parallel/dryrun.run_ranks``);
each builds its scene itself and renders its contiguous slice of the
image at its global pixel offset.  Held to:
- the port in one process: the gathered passes bit for bit (no op of a
  sample sums across rays), the all-reduced loss and gradients within
  rtol 1e-5 (only the order of the sums differs);
- the JAX package's ``shard_map_render_step(config, mesh)(ir)(ir,
  state)`` on 2 of its virtual CPU devices: the port's same call on each
  of 2 ranks' meshes, its slices side by side, at the tolerance below;
- the JAX package: ``render_sample`` at 32x32 on the Cornell box (12
  tris, the brute-force trace) within rtol 1e-4 / atol 1e-5 on every
  value (as the JAX package holds its own sharded render to one device,
  tests/test_grad_and_sharding.py); on the textured, lit heightfield
  (1,058 tris) within the same on >= 99% of pixels and the means within
  1e-4 relative, test_torch_integrator.py's rule for this scene: XLA
  contracts a*b+c into FMA, the port rounds every op, and a path that
  meets a tri edge may then take the other tri (3 of 20,480 values
  differ by up to 4e-4 relative here); and ``render_loss_and_grad`` at
  test_torch_grad.py's tolerance (rtol 1e-4, atol 1e-6 x the leaf's
  largest entry).

Every spawn has a join deadline (``run_ranks``' ``timeout``) on top of
the collectives' own timeout, so a lost rank fails the test instead of
hanging it.
"""

from torch_threads import children  # first: torch's threads a worker

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from elevenrender_tpu.parallel import mesh as jax_mesh
from elevenrender_tpu.render import grad as jax_grad
from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu.render.integrator import render_sample as jax_render
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.parallel import distributed, dryrun
from elevenrender_tpu_torch.parallel import mesh as pm
from elevenrender_tpu_torch.render.integrator import init_state

from scenes import cornell_scene, textured_heightfield_scene

RES = 32
SCENES = {"cornell": {"scene": "cornell", "res": RES},
          "textured": {"scene": "textured", "res": RES, "grid": 24}}
TASKS = [{"kind": "render", "samples": 1, **SCENES["cornell"]},
         {"kind": "render", "samples": 1, **SCENES["textured"]},
         {"kind": "grad", "samples": 1, **SCENES["cornell"]}]
JOIN_S = 120.0


def _jax_scene(name):
    if name == "cornell":
        _, config, ir = cornell_scene(res=RES)
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ELEVENRT_NATIVE", "0")  # the numpy build, bit-equal
            _, config, ir = textured_heightfield_scene(grid=24, res=RES)
    return config.replace(compat=False), ir


@pytest.fixture(scope="module")
def one_process():
    return dryrun.run_tasks(pm.make_mesh(device="cpu"), TASKS)


def _spawn(world, tmp_path_factory):
    store = tmp_path_factory.mktemp(f"store{world}") / "store"
    with children():
        return world, dryrun.run_ranks(TASKS, world, "cpu",
                                       init_method=f"file://{store}",
                                       timeout=JOIN_S)


@pytest.fixture(scope="module")
def sharded2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def sharded4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@pytest.fixture(params=[2, 4])
def sharded(request):
    return request.getfixturevalue(f"sharded{request.param}")


@pytest.mark.parametrize("task", [0, 1], ids=["cornell", "textured"])
def test_sharded_forward_equals_one_process(sharded, one_process, task):
    world, ranks = sharded
    got = ranks[0][task]["passes"]
    want = one_process[task]["passes"]
    assert got.shape == want.shape == (want.shape[0], RES * RES, 4)
    assert np.isfinite(got).all() and got[0, :, :3].max() > 0.0
    np.testing.assert_array_equal(got, want)


def test_gather_image_is_none_off_rank_0(sharded):
    world, ranks = sharded
    assert len(ranks) == world
    for r in ranks[1:]:
        assert r[0]["passes"] is None and r[1]["passes"] is None
    assert ranks[0][0]["tris"] == 12 and ranks[0][1]["tris"] == 1058


def test_sharded_gradients_equal_one_process(sharded, one_process):
    world, ranks = sharded
    want = one_process[2]
    for r in ranks:  # every rank holds the all-reduced numbers
        assert r[2]["loss"] == ranks[0][2]["loss"]
        np.testing.assert_allclose(r[2]["loss"], want["loss"], rtol=1e-5)
        for k, g in want["grads"]["materials"].items():
            got = r[2]["grads"]["materials"][k]
            assert np.isfinite(got).all(), k
            np.testing.assert_allclose(
                got, g, rtol=1e-5, atol=1e-5 * max(np.abs(g).max(), 1e-30),
                err_msg=k)


@pytest.mark.parametrize("task", [0, 1], ids=["cornell", "textured"])
def test_sharded_forward_equals_jax(sharded2, task):
    """At 2 ranks; 4 ranks equal one process, and so 2 ranks, above."""
    _, ranks = sharded2
    config, ir = _jax_scene(["cornell", "textured"][task])
    state = jax.jit(jax_render, static_argnums=0)(config, ir,
                                                  jax_init_state(config))
    want = np.asarray(state["passes"])
    got = ranks[0][task]["passes"]
    if task == 0:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        return
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean(axis=1).min() >= 0.99, close.mean(axis=1)
    np.testing.assert_allclose(got.mean(axis=1), want.mean(axis=1),
                               rtol=1e-4)


def test_sharded_gradients_equal_jax(sharded2):
    _, ranks = sharded2
    config, ir = _jax_scene("cornell")
    params = {"materials": jax_grad.float_subtree(ir["materials"])}
    loss, grads = jax_grad.render_loss_and_grad(
        config, ir, params, jnp.zeros((RES * RES, 3), jnp.float32), 1)
    got = ranks[0][2]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    want = jax.tree.map(np.asarray, grads)["materials"]
    assert got["grads"]["materials"].keys() == want.keys()
    for k, g in want.items():
        np.testing.assert_allclose(
            got["grads"]["materials"][k], g, rtol=1e-4,
            atol=1e-6 * max(np.abs(g).max(), 1e-30), err_msg=k)


def test_shard_map_render_step_takes_the_jax_call():
    """``shard_map_render_step(config, mesh)`` returns ``make(ir_tree) ->
    step(ir, state)`` in both packages; one sample of each rank's step,
    its slices side by side, against the JAX package's on a mesh of 2
    devices (the Cornell box, as ``test_sharded_forward_equals_jax``)."""
    config, ir = _jax_scene("cornell")
    jmesh = jax_mesh.make_mesh(2)
    ir_r = jax_mesh.replicate_ir(ir, jmesh)
    want = jax_mesh.shard_map_render_step(config, jmesh)(ir_r)(
        ir_r, jax_mesh.shard_render_state(jax_init_state(config), jmesh))
    want = jax.tree.map(np.asarray, want)
    cfg, tir = ir_from_numpy(dataclasses.asdict(config),
                             jax.tree.map(np.asarray, ir), device="cpu")
    got = []
    for rank in range(2):
        mesh = pm.PixelMesh(rank, 2, torch.device("cpu"))
        step = pm.shard_map_render_step(cfg, mesh)(tir)
        out = step(tir, pm.shard_render_state(init_state(cfg, "cpu"), mesh))
        got.append({k: v.numpy().copy() for k, v in out.items()})
    np.testing.assert_array_equal(
        np.concatenate([g["samples"] for g in got]), want["samples"])
    np.testing.assert_array_equal(np.concatenate([g["rng"] for g in got]),
                                  want["rng"].astype(np.int64))
    passes = np.concatenate([g["passes"] for g in got], axis=1)
    np.testing.assert_allclose(passes, want["passes"], rtol=1e-4, atol=1e-5)
    assert passes[0, :, :3].max() > 0.0


def test_port_cornell_scene_is_the_jax_one():
    """The ranks build ``scene/demo.cornell_scene``; it is the JAX test
    scene, table for table."""
    from elevenrender_tpu_torch.scene import demo
    config, ir = _jax_scene("cornell")
    cfg_c, ir_c = ir_from_numpy(dataclasses.asdict(config),
                                jax.tree.map(np.asarray, ir), device="cpu")
    _, cfg_p, ir_p = demo.cornell_scene(res=RES, device="cpu")
    assert dataclasses.asdict(cfg_p.replace(compat=False)) == \
        dataclasses.asdict(cfg_c)
    for grp in ir_c:
        for k in ir_c[grp]:
            np.testing.assert_array_equal(ir_p[grp][k].numpy(),
                                          ir_c[grp][k].numpy(),
                                          err_msg=f"{grp}.{k}")


def test_shard_render_state_slices_and_indivisible_counts_raise():
    from elevenrender_tpu_torch.scene import demo
    _, config, _ = demo.cornell_scene(res=RES, device="cpu")
    config = config.replace(compat=False, count_rays=True)
    state = init_state(config, device="cpu")
    state["ray_count"] += 7.0
    shards = [pm.shard_render_state(state, pm.PixelMesh(r, 4, "cpu"))
              for r in range(4)]
    for k in ("samples", "rng"):
        assert torch.equal(torch.cat([s[k] for s in shards]), state[k])
    assert torch.equal(torch.cat([s["passes"] for s in shards], dim=1),
                       state["passes"])
    assert [float(s["ray_count"]) for s in shards] == [7.0, 0.0, 0.0, 0.0]
    assert pm.PixelMesh(3, 4, "cpu").pixel_offset(RES * RES) == 768
    odd = pm.PixelMesh(0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by 3"):
        pm.sharded_render_step(config, odd)
    with pytest.raises(ValueError, match="not divisible by 3"):
        pm.shard_render_state(state, odd)
    with pytest.raises(ValueError, match="not divisible by 3"):
        pm.shard_map_render_step(config, odd)


def test_initialize_twice_is_a_no_op_and_one_rank_gathers_as_is(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    distributed.initialize(store, 1, 0, device="cpu")
    try:
        group = dist.group.WORLD
        # A second call with other arguments changes nothing.
        distributed.initialize("file:///nonexistent/store", 5, 3,
                               backend="nccl", device="cpu")
        assert dist.group.WORLD is group
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = distributed.global_mesh("cpu")
        assert (mesh.rank, mesh.world, mesh.device.type) == (0, 1, "cpu")
        # A group of one still runs the collectives.
        passes = torch.rand((5, 16, 4))
        gathered = distributed.gather_image(passes, mesh)
        assert gathered is not passes and torch.equal(gathered, passes)
        t = torch.ones(3)
        assert torch.equal(pm.all_reduce_sum(t, mesh), t)
        with pytest.raises(ValueError, match="mesh of 2 devices"):
            pm.make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()
    alone = pm.make_mesh(device="cpu")
    assert alone.world == 1 and alone.group is None
    assert distributed.gather_image(passes, alone) is passes


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pm.make_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        distributed.initialize("file:///nonexistent/store", 1, 0)
    assert not dist.is_initialized()


def test_a_failing_rank_fails_the_run_within_its_deadline(tmp_path):
    """A rank that raises (here: an unknown scene) ends the run with its
    traceback; the other rank, which may wait for it in a collective, is
    ended too."""
    tasks = [{"kind": "render", "samples": 1, "scene": "no such scene",
              "res": RES}]
    with children(), pytest.raises(RuntimeError, match="no such scene"):
        dryrun.run_ranks(tasks, 2, "cpu",
                         init_method=f"file://{tmp_path / 'store'}",
                         timeout=JOIN_S)


def test_dryrun_multichip_runs_on_the_cpu(tmp_path, capsys):
    with children():
        line = dryrun.dryrun_multichip(
            4, device="cpu", init_method=f"file://{tmp_path / 'store'}")
    assert line.startswith("dryrun_multichip(4, cpu): image bit-equal")
    assert line.endswith("OK") and line in capsys.readouterr().out
