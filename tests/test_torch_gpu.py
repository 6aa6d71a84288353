"""The CUDA geodesic kernels on the card (marker `gpu`; skips without one).

Repeats chip_smoke.py's checks at 32x32: K1 against its plain PyTorch
version on the same CUDA inputs under the parity contracts, K2 against
its plain version (RK4: K2's contract, chip_smoke.fwdgrad_stats), the
tracking variants K1-track and K2-track against theirs, both kernels
after one and two steps (the one-step check), depth-sorted traces
(forward and fwdgrad) bitwise equal to raster ones, launches of two
scenes queued on one stream and on two streams each reading its own
scene scalars from the constant bank, and torch.func.jvp of a trace launching K2 once with one
tangent (and a second derivative through it raising); and the eager XLA
engine and reverse mode on the card against the CPU; the bh_* API's
five rays and its bench frame (bit for bit trace_rays_fast's); and the
front ends (phase 18 at small sizes: a served session, the adaptive
render's selection and sample, an orbit animation).  Run
on a machine with a GPU (and without jax, which the suite's conftest
imports):

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def test_kernel_matches_plain_on_card(cuda):
    from blackhole_tpu_torch.render import trace_kernel

    before = trace_kernel.launches
    stats = chip_smoke.check_kernel_vs_plain(cuda, size=32)
    assert len(stats) == 6
    assert trace_kernel.launches == before + 6


def test_depth_sorted_equals_raster_on_card(cuda):
    stats = chip_smoke.check_depth_sorted(cuda, size=32)
    assert stats["elementwise_mismatch"] == 0


def test_fwdgrad_kernel_matches_plain_on_card(cuda):
    from blackhole_tpu_torch.render import trace_kernel

    before = trace_kernel.fwdgrad_launches
    stats = chip_smoke.check_fwdgrad_vs_plain(cuda, size=32,
                                              integrators=("rk4",))
    assert len(stats) == 3
    assert all(s["codes_vs_k1"] == 0 for s in stats)
    assert trace_kernel.fwdgrad_launches == before + 3


def test_track_kernels_match_plain_on_card(cuda):
    """K1-track and K2-track (2 tangents and 1) against their plain
    versions at the soft parity cases, RK4 (chip_smoke phases 3-4,
    track; the RKF45 contracts need the 64x64 sample)."""
    from blackhole_tpu_torch.render import trace_kernel

    before = (trace_kernel.track_launches,
              trace_kernel.fwdgrad_track_launches)
    stats = chip_smoke.check_track_vs_plain(cuda, size=32,
                                            integrators=("rk4",))
    assert len(stats) == 6
    assert all(s.get("codes_vs_k1", 0) == 0 for s in stats)
    assert trace_kernel.track_launches == before[0] + 2
    assert trace_kernel.fwdgrad_track_launches == before[1] + 4


def test_jvp_of_trace_launches_k2_once_with_one_tangent(cuda, monkeypatch):
    import dataclasses

    from blackhole_tpu_torch import cuda_lib
    from blackhole_tpu_torch.render import trace_kernel

    seen = []
    launch = cuda_lib.trace_planes_fwdgrad

    def spy(*args):
        seen.append(args[6])  # n_tan
        return launch(*args)

    monkeypatch.setattr(cuda_lib, "trace_planes_fwdgrad", spy)
    scene, _, o, d = chip_smoke.parity_scene(0.9, True, "rk4", cuda, 16,
                                             max_steps=60)
    m0 = scene.blackhole.mass

    def loss(m):
        s = dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=m))
        return trace_kernel.trace_rays_kernel(o, d, s).color.mean()

    _, dl = torch.func.jvp(loss, (m0,), (torch.ones_like(m0),))
    assert seen == [1]
    assert bool(torch.isfinite(dl))

    # A second derivative through the kernel is not ported: forward over
    # forward raises rather than returning a silent zero.
    def dloss(m):
        return torch.func.jvp(loss, (m,), (torch.ones_like(m),))[1]

    with pytest.raises(NotImplementedError):
        torch.func.jvp(dloss, (m0,), (torch.ones_like(m0),))


def test_one_step_matches_plain_on_card(cuda):
    """K1 and K2 after one and two steps against their plain versions
    (chip_smoke phase 5b) at 32x32."""
    stats = chip_smoke.check_one_step(cuda, size=32)
    assert len(stats) == 16
    assert all(s["codes_differ"] == 0 for s in stats)


def _two_scenes_launched(cuda, size, max_steps, streams):
    """K1 and K2 of two scenes (mass 1 and 1.2), each launched alone and
    synchronised, then launched again without a synchronise, the first
    scene's on streams[0] and the second's on streams[1]; returns the
    (alone, queued) pairs of (K1 planes, (K2 planes, tangents))."""
    import dataclasses

    from blackhole_tpu_torch.render import trace_kernel as tk

    scene, _, o, d = chip_smoke.parity_scene(0.9, True, "rk4", cuda, size,
                                             max_steps=max_steps)
    other = dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, mass=torch.tensor(1.2, device=cuda)))
    args = tk.planes_args(scene)
    inputs = [tk.prepare_fwdgrad(o, d, s, chip_smoke.mass_spin_tangents(s))[0]
              for s in (scene, other)]

    def launch(scal, dscals, inp, dinps):
        return (tk.trace_planes(scal, inp, *args),
                tk.trace_planes_fwdgrad(scal, dscals, inp, dinps, *args))

    alone = []
    for planes_in in inputs:
        alone.append(launch(*planes_in))
        torch.cuda.synchronize()
    queued = []
    for stream, planes_in in zip(streams, inputs):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            queued.append(launch(*planes_in))
    torch.cuda.synchronize()
    assert not torch.equal(alone[0][0], alone[1][0])
    return alone, queued


def _assert_same(alone, queued):
    for (k1_a, (out_a, dout_a)), (k1_q, (out_q, dout_q)) in zip(alone,
                                                                queued):
        assert torch.equal(k1_a.nan_to_num(), k1_q.nan_to_num())
        assert torch.equal(out_a.nan_to_num(), out_q.nan_to_num())
        assert torch.equal(dout_a.nan_to_num(), dout_q.nan_to_num())


def test_back_to_back_launches_keep_their_scene_scalars(cuda):
    """The scene scalars go to the constant bank on the launch's stream
    right before each launch: launches with two scenes queued back to
    back on one stream, without a synchronise, give each scene's own
    planes (bitwise those of a launch alone)."""
    stream = torch.cuda.current_stream()
    _assert_same(*_two_scenes_launched(cuda, 32, 120, (stream, stream)))


def test_launches_on_two_streams_keep_their_scene_scalars(cuda):
    """A library's launches take turns on its constant bank whatever
    their streams: a long launch of one scene on one stream and a launch
    of another scene on a second stream, without a synchronise, give
    each scene's own planes (bitwise those of a launch alone)."""
    streams = (torch.cuda.Stream(cuda), torch.cuda.Stream(cuda))
    _assert_same(*_two_scenes_launched(cuda, 256, 600, streams))


def test_kernel_rejects_grad_and_bad_layout(cuda):
    from blackhole_tpu_torch.render import trace_kernel

    scal = torch.zeros(12, device=cuda)
    inp = torch.zeros(16, 8, device=cuda)
    with pytest.raises(NotImplementedError):
        trace_kernel.trace_planes(scal.requires_grad_(True), inp, True, 4,
                                  False)
    with pytest.raises(ValueError):
        trace_kernel.trace_planes(torch.zeros(12, device=cuda),
                                  torch.zeros(15, 8, device=cuda), True, 4,
                                  False)
    with pytest.raises(TypeError):
        trace_kernel.trace_planes(torch.zeros(12, device=cuda),
                                  inp.double(), True, 4, False)
    # K2's wrapper: reverse mode, layout and tangent count.
    dscals = torch.zeros(1, 12, device=cuda)
    dinps = torch.zeros(1, 16, 8, device=cuda)
    with pytest.raises(NotImplementedError):
        trace_kernel.trace_planes_fwdgrad(
            torch.zeros(12, device=cuda), dscals.requires_grad_(True), inp,
            dinps, True, 4, False)
    with pytest.raises(ValueError):
        trace_kernel.trace_planes_fwdgrad(
            torch.zeros(12, device=cuda), torch.zeros(0, 12, device=cuda),
            inp, torch.zeros(0, 16, 8, device=cuda), True, 4, False)
    with pytest.raises(ValueError):
        trace_kernel.trace_planes_fwdgrad(
            torch.zeros(12, device=cuda), torch.zeros(1, 12, device=cuda),
            inp, torch.zeros(2, 16, 8, device=cuda), True, 4, False)


def test_xla_engine_and_reverse_mode_on_card(cuda):
    """The XLA engine and reverse mode (eager torch, no kernel of their
    own) on the card against the same calls on the CPU:
    trace_rays_fast(engine="xla") at the 32x32 parity case under the RK4
    contract (chip_smoke.parity_stats), and grad_over_chunks'
    d/d(mass, spin) of the JAX package's gradient-test case (16x16, 150
    steps, float64, 4 chunks) within rtol 1e-6."""
    from blackhole_tpu_torch.grad import bucketed
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image

    hits = []
    for dev in (cuda, torch.device("cpu")):
        scene, _, o, d = chip_smoke.parity_scene(0.9, True, "rk4", dev, 32)
        hits.append(image.trace_rays_fast(o, d, scene, engine="xla").map(
            lambda x: x.cpu()))
    chip_smoke.parity_stats(hits[0], hits[1], exact=True)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        scene, camera = chip_smoke.small_diff_scene(dev, torch.float64)
        o, d = cam.generate_rays(camera, 16, 16)

        def scene_fn(p, scene=scene):
            return dataclasses.replace(scene, blackhole=dataclasses.replace(
                scene.blackhole, mass=p["mass"], spin=p["spin"]))

        params = {k: v.clone() for k, v in (("mass", scene.blackhole.mass),
                                            ("spin", scene.blackhole.spin))}
        grads.append(bucketed.grad_over_chunks(
            scene_fn, params, o.reshape(-1, 3), d.reshape(-1, 3),
            lambda c, i: c.sum(), chunks=4)[1])
    for k in ("mass", "spin"):
        assert abs(float(grads[0][k]) - float(grads[1][k])) <= 1e-6 * abs(
            float(grads[1][k])), (k, grads)


def test_api_on_card(cuda):
    """The bh_* API on the card (chip_smoke phase 17a-b): the five rays
    of the CLI's tests through bh_trace_rays_batch (K1) against a CPU
    context under the RK4 contract; the bench camera's 128x128 rays
    through a context set to the bench scene by the setters, bit for
    bit image.trace_rays_fast's Hit, one K1 launch per call."""
    from blackhole_tpu_torch.render import camera as cam
    from blackhole_tpu_torch.render import image

    _, rays = chip_smoke.check_api_rays(cuda)
    assert rays["launches"] == 1 and rays["result_mismatch"] == 0
    scene, camera = chip_smoke.bench_scene(cuda)
    o, d = cam.generate_rays(camera, 128, 128)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    stats = chip_smoke.check_api_frame(cuda, o, d,
                                       image.trace_rays_fast(o, d, scene))
    assert stats["elementwise_mismatch"] == 0 and stats["launches"] == 4


def test_front_ends_on_card(cuda):
    """chip_smoke's phase 18 at small sizes: every served frame launches
    K1 and the first accumulation frame is trace_rays_fast's; the
    adaptive selection is the CPU's; the orbit frames read back."""
    served, launches = chip_smoke.check_served_session(cuda, 128, 72, 60)
    assert launches >= served["frames"] >= 8
    adapt, launches = chip_smoke.check_adaptive(cuda, size=64)
    # 64^2 takes no depth-sort prepass: the base render and 4 passes.
    assert launches == 5 and adapt["sample_parity"]["result_mismatch"] == 0
    orbit, launches = chip_smoke.check_orbit(cuda, size=32, n_frames=2)
    assert launches == 2 and orbit["frames"] == 2
