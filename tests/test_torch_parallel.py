"""Rows sharded over torch.distributed (blackhole_tpu_torch.parallel)
against the JAX package's shard_map mesh, on the cases of
tests/test_parallel.py.

One world of 2 gloo ranks on the CPU (parallel.launch.run_world) runs
every case of this file once (_world_cases); the tests compare its
results with the JAX package's render_image_sharded and
loss_and_grad_sharded on a 2-device mesh of conftest's virtual CPU
devices (recorded once: tests/jax_refs.py, case parallel_sharded) and
with the port's own single-process calls:
- the XLA engine's sharded render: atol 1e-5 against JAX's, bit for bit
  the port's render_image(engine="xla");
- the kernel engine (K1's plain version on the CPU): atol 2e-5 against
  JAX's engine="pallas_interpret"; depth-sorted bit for bit unsorted;
- the gradients (16x8, 96 steps, log_mass + 0.05, float64): loss and
  every gradient within rtol 1e-9 of JAX's (its own test allows rtol
  1e-4, atol 1e-7; the largest relative gap measured is 5.1e-11, on
  d/d spin_raw);
- one make_train_step_sharded step: the single-process
  inverse.make_train_step step within rtol 1e-9 (float64);
- the forward-mode sharded value and gradient
  (scene_value_and_grad_sharded, K2's plain version, float32, 16x8):
  the single-process scene_value_and_grad over the whole image within
  rtol 1e-6 and bhbench's plain reference within rtol 1e-5 (see
  test_sharded_forward_grad_matches_single_process_and_reference).
Single-process cases beside the world: the row blocks' local values
add up to the whole image's, a block's depth order is a permutation
that leaves colours bit for bit unchanged.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_tpu.geom import types as jtypes
from blackhole_tpu.grad import diff_trace as jdiff
from blackhole_tpu.grad import inverse as jinverse
from bhbench.reference import geodesic as G
from blackhole_tpu.parallel import mesh as jmesh
from blackhole_tpu_torch.geom.types import (
    BlackHole, Camera, Disk, Scene, SimConfig,
)
from blackhole_tpu_torch.grad import diff_trace, fast_grad, inverse
from blackhole_tpu_torch.parallel import launch
from blackhole_tpu_torch.parallel import mesh as pmesh
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image, trace_kernel

import jax_refs as recorded

torch.set_num_threads(1)  # see tests/test_torch_step.py

F64 = torch.float64


def jscene_and_camera(max_steps=150, dtype=jnp.float32):
    scene = jtypes.Scene(
        blackhole=jtypes.BlackHole.create(1.0, 0.9, dtype=dtype),
        disk=jtypes.Disk.create(6.0, 20.0, dtype=dtype),
        config=jtypes.SimConfig.create(
            time_step=0.1, max_ray_distance=80.0, max_steps=max_steps,
            dtype=dtype,
        ),
        disk_enabled=True,
    )
    camera = jtypes.Camera.create(
        position=(0.0, -30.0, 8.0), direction=(0.0, 30.0, -8.0),
        up=(0.0, 0.0, 1.0), fov_deg=25.0, dtype=dtype,
    )
    return scene, camera


def port_case(device, max_steps=150, dtype=torch.float32):
    """jscene_and_camera's case in the port's records (made here, not
    from the JAX ones: the ranks run without conftest's float64 JAX)."""
    kw = dict(device=device, dtype=dtype)
    scene = Scene(
        blackhole=BlackHole.create(1.0, 0.9, **kw),
        disk=Disk.create(6.0, 20.0, **kw),
        config=SimConfig.create(time_step=0.1, max_ray_distance=80.0,
                                max_steps=max_steps, **kw),
        disk_enabled=True,
    )
    camera = Camera.create(position=(0.0, -30.0, 8.0),
                           direction=(0.0, 30.0, -8.0), up=(0.0, 0.0, 1.0),
                           fov_deg=25.0, **kw)
    return scene, camera


def grad_case(device):
    """The gradient case: float64, 96 steps, target at the true scene,
    params with log_mass + 0.05."""
    scene, camera = port_case(device, 96, F64)
    target = diff_trace.render_image_diff(scene, camera, 16, 8)
    params = inverse.pack_params(scene, camera)
    params = dict(params, log_mass=params["log_mass"] + 0.05)
    return scene, camera, target, params


# The forward-mode case: float32, a close camera and a coarse step, so
# that after 48 steps of the 16x8 rays one has crossed the horizon, 56
# have hit the disk and 71 are still in flight; at (mass, spin) =
# (1.02, 0.88).
FWD_POSITION = (0.0, -25.0, 8.0)
FWD = dict(fov_deg=40.0, time_step=1.0, max_steps=48, mass=1.02, spin=0.88)


def fwd_case(device):
    """(scene, camera, params) of the forward-mode case."""
    kw = dict(device=device)
    scene = Scene(
        blackhole=BlackHole.create(1.0, 0.9, **kw),
        disk=Disk.create(6.0, 20.0, **kw),
        config=SimConfig.create(time_step=FWD["time_step"],
                                max_ray_distance=150.0,
                                max_steps=FWD["max_steps"], **kw),
        disk_enabled=True,
    )
    camera = Camera.create(position=FWD_POSITION,
                           direction=tuple(-p for p in FWD_POSITION),
                           up=(0.0, 0.0, 1.0), fov_deg=FWD["fov_deg"], **kw)
    params = {k: torch.tensor(FWD[k], device=device)
              for k in ("mass", "spin")}
    return scene, camera, params


def fwd_loss(hit):
    """The bench loss on 16x8: a sum over rays over the whole image's
    3 W H colour components."""
    return hit.color.sum() / (3 * 16 * 8)


def mass_spin(scene):
    def scene_fn(p):
        return dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=p["mass"], spin=p["spin"]))

    return scene_fn


def _floats(loss, grads):
    return float(loss), {k: float(v) for k, v in grads.items()}


def _adam(params):
    return torch.optim.Adam(list(params.values()), lr=1e-2,
                            betas=(0.9, 0.999), eps=1e-8)


def _world_cases(mesh):
    """Every case of the file on one rank; host data back."""
    out, times = {}, {}
    scene, camera = port_case(mesh.device)
    t0 = time.perf_counter()
    out["xla"] = pmesh.render_image_sharded(scene, camera, 16, 16, mesh)
    times["xla"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["kernel"] = pmesh.render_image_sharded(scene, camera, 16, 16, mesh,
                                               engine="auto")
    out["kernel_sorted"] = pmesh.render_image_sharded(
        scene, camera, 16, 16, mesh, engine="auto", depth_sort=True)
    times["kernel"] = time.perf_counter() - t0

    gscene, gcamera, target, params = grad_case(mesh.device)
    t0 = time.perf_counter()
    out["loss"], out["grads"] = pmesh.loss_and_grad_sharded(
        params, target, gscene, gcamera, 16, 8, mesh)
    times["grad"] = time.perf_counter() - t0
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    step = pmesh.make_train_step_sharded(16, 8, mesh)
    leaves, _, out["step_loss"] = step(leaves, _adam(leaves), target, gscene,
                                       gcamera)
    out["step_params"] = {k: v.detach() for k, v in leaves.items()}

    fscene, fcamera, fparams = fwd_case(mesh.device)
    t0 = time.perf_counter()
    vg = pmesh.scene_value_and_grad_sharded(fwd_loss, mass_spin(fscene),
                                            fcamera, 16, 8, mesh)
    before = (pmesh.collectives, pmesh.collective_bytes)
    out["fwd"] = _floats(*vg(fparams))
    times["fwd"] = time.perf_counter() - t0
    out["fwd_collectives"] = (pmesh.collectives - before[0],
                              pmesh.collective_bytes - before[1])
    out["fwd_timings"] = pmesh.step_timings()

    # JAX's case is 12 rows on 8 devices; 12 rows divide among 2 ranks,
    # 15 do not.
    try:
        pmesh.render_image_sharded(scene, camera, 16, 15, mesh)
        out["uneven"] = "no error"
    except ValueError as e:
        out["uneven"] = str(e)
    out["times"] = times
    return out


def _fail_on_rank_one(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()
    return "rank 0 passed the barrier"


@pytest.fixture(scope="module")
def world():
    t0 = time.perf_counter()
    ranks = launch.run_world(_world_cases, 2, device="cpu", timeout_s=600)
    print(f"world of 2 gloo ranks: {time.perf_counter() - t0:.1f} s, "
          f"rank 0 cases {ranks[0]['times']}")
    return ranks


def jax_sharded_refs():
    """JAX's sharded renders and gradients on a 2-device mesh."""
    mesh = jmesh.make_mesh(2)
    js, jc = jscene_and_camera()
    refs = {"xla": np.asarray(jmesh.render_image_sharded(js, jc, 16, 16,
                                                          mesh))}
    refs["pallas"] = np.asarray(jmesh.render_image_sharded(
        js, jc, 16, 16, mesh, engine="pallas_interpret"))
    js64, jc64 = jscene_and_camera(96, jnp.float64)
    params = jinverse.pack_params(js64, jc64)
    target = jdiff.render_image_diff(js64, jc64, 16, 8)
    params = dict(params, log_mass=params["log_mass"] + 0.05)
    loss, grads = jmesh.loss_and_grad_sharded(params, target, js64, jc64, 16,
                                              8, mesh)
    refs["loss"] = float(loss)
    refs["grads"] = {k: np.asarray(v) for k, v in grads.items()}
    return refs


@pytest.fixture(scope="module")
def jax_refs():
    """jax_sharded_refs(), recorded once (tests/jax_refs.py, case
    parallel_sharded)."""
    rec = recorded.load("parallel_sharded")
    return {"xla": rec["xla"], "pallas": rec["pallas"],
            "loss": float(rec["loss"]),
            "grads": {k[len("grads."):]: v for k, v in rec.items()
                      if k.startswith("grads.")}}


def test_sharded_render_matches_jax_and_single_process(world, jax_refs):
    for r in world:
        np.testing.assert_allclose(r["xla"].numpy(), jax_refs["xla"],
                                   atol=1e-5)
    scene, camera = port_case("cpu")
    single = image.render_image(scene, camera, 16, 16, engine="xla")
    for r in world:
        np.testing.assert_array_equal(r["xla"].numpy(), single.numpy())


def test_sharded_kernel_engine_matches_jax_pallas(world, jax_refs):
    for r in world:
        np.testing.assert_allclose(r["kernel"].numpy(), jax_refs["pallas"],
                                   atol=2e-5)


def test_sharded_depth_sort_is_identity_on_colors(world):
    for r in world:
        np.testing.assert_array_equal(r["kernel_sorted"].numpy(),
                                      r["kernel"].numpy())


def test_sharded_grad_matches_jax(world, jax_refs):
    for r in world:
        np.testing.assert_allclose(float(r["loss"]), jax_refs["loss"],
                                   rtol=1e-9)
        assert set(r["grads"]) == set(jax_refs["grads"])
        for k, want in jax_refs["grads"].items():
            np.testing.assert_allclose(r["grads"][k].numpy(), want,
                                       rtol=1e-9, err_msg=k)


def test_sharded_train_step_matches_single_process(world):
    scene, camera, target, params = grad_case("cpu")
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    step = inverse.make_train_step(16, 8)
    leaves, _, loss = step(leaves, _adam(leaves), target, scene, camera)
    for r in world:
        np.testing.assert_allclose(float(r["step_loss"]), float(loss),
                                   rtol=1e-9)
        for k, v in leaves.items():
            np.testing.assert_allclose(r["step_params"][k].numpy(),
                                       v.detach().numpy(), rtol=1e-9,
                                       err_msg=k)


def test_uneven_height_rejected(world):
    for r in world:
        assert "divisible by mesh size 2" in r["uneven"]


def test_failing_rank_raises_without_hanging():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        launch.run_world(_fail_on_rank_one, 2, device="cpu", timeout_s=120)
    assert time.perf_counter() - t0 < 120


@pytest.fixture(scope="module")
def fwd_whole():
    """The forward-mode case over the whole image in one process:
    scene_value_and_grad in predicted_depth_order (K2's plain version),
    and bhbench's plain reference on its own rays."""
    scene, camera, params = fwd_case("cpu")
    o, d = cam.generate_rays(camera, 16, 8)
    order = image.predicted_depth_order(mass_spin(scene)(params), camera,
                                        16, 8)
    got = fast_grad.scene_value_and_grad(fwd_loss, mass_spin(scene))(
        params, o.reshape(-1, 3), d.reshape(-1, 3), order)
    ro, rd = G.image_rays({"position": FWD_POSITION,
                           "direction": tuple(-p for p in FWD_POSITION),
                           "up": (0.0, 0.0, 1.0), "fov_deg": FWD["fov_deg"]},
                          16, 8)

    def ref_scene(m, s):
        return G.RefScene(mass=m, spin=s, charge=0.0, disk_inner=6.0,
                          disk_outer=20.0, temperature_scale=1.0,
                          inclination=0.0, time_step=FWD["time_step"],
                          max_ray_distance=150.0,
                          max_steps=FWD["max_steps"])

    loss, (gm, gs), _ = G.loss_and_grad(ro, rd, ref_scene, FWD["mass"],
                                        FWD["spin"], clip=15.0)
    return {"single": _floats(*got),
            "reference": (loss, {"mass": gm, "spin": gs})}


def _assert_value_and_grad(got, want, rtol):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    assert set(got[1]) == set(want[1])
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k], v, rtol=rtol, err_msg=k)


def test_sharded_forward_grad_matches_single_process_and_reference(
        world, fwd_whole):
    """Every rank returns the same all-reduced value: the single-process
    one within rtol 1e-6 (float32 sums over 64 + 64 rays against one
    over 128: the additions' order differs; two blocks' sum measured
    1.3e-7 off, on d/d spin) and the plain reference's within rtol 1e-5
    (its float64 sums of the same float32 per-ray arithmetic; 9.4e-7
    measured, on d/d spin)."""
    assert world[0]["fwd"] == world[1]["fwd"]
    for r in world:
        _assert_value_and_grad(r["fwd"], fwd_whole["single"], 1e-6)
        _assert_value_and_grad(r["fwd"], fwd_whole["reference"], 1e-5)
        # One all_reduce of [loss, dmass, dspin] in float32.
        assert r["fwd_collectives"] == (1, 12)
        assert r["fwd_timings"][-1]["local_ms"] > 0.0


def test_row_blocks_add_up_to_the_whole_image(fwd_whole):
    """Without a process group each rank's call returns its rows' own
    value: a world of one rank is bit for bit the single-process call,
    and two blocks' values add up to it (rtol 1e-6: float32 sums in
    another order)."""
    scene, camera, params = fwd_case("cpu")

    def local(rank, size):
        m = pmesh.Mesh(None, rank, size, torch.device("cpu"))
        return _floats(*pmesh.scene_value_and_grad_sharded(
            fwd_loss, mass_spin(scene), camera, 16, 8, m)(params))

    assert local(0, 1) == fwd_whole["single"]
    blocks = [local(r, 2) for r in range(2)]
    total = (sum(b[0] for b in blocks),
             {k: sum(b[1][k] for b in blocks) for k in ("mass", "spin")})
    _assert_value_and_grad(total, fwd_whole["single"], 1e-6)


def test_row_block_depth_order_is_a_permutation_that_keeps_colors():
    scene, camera, _ = fwd_case("cpu")
    o, d = cam.generate_rays(camera, 16, 16)
    for rows in (slice(0, 8), slice(8, 16), slice(2, 10)):
        order = image.predicted_depth_order(scene, camera, 16, 16, block=4,
                                            rows=rows)
        assert sorted(order.tolist()) == list(range(8 * 16))
        ob, db = o[rows].reshape(-1, 3), d[rows].reshape(-1, 3)
        raster = trace_kernel.trace_rays_kernel(ob, db, scene)
        ordered = trace_kernel.trace_rays_kernel(ob, db, scene, order=order)
        for f in dataclasses.fields(raster):
            assert torch.equal(getattr(raster, f.name),
                               getattr(ordered, f.name)), f.name
