"""CUDA graphs of the fwd+bwd host stages (render.trace_kernel:
prepare_fwdgrad's stages as graph P, its finish's as graph F, captured
once per static signature and replayed, K2 launched eagerly between).

On the card (marker `gpu`; skips without one): a replayed step is
bitwise the eager step at the same inputs (loss, gradients, every Hit
field) for the bench scene at two (mass, spin) draws with their depth
orders, a soft scene, RKF45 and render_value_and_grad's ray tangents;
the counters; results that later replays leave alone; two prepares
before their finishes; a changed static captures anew; the spans of a
replayed step.  On the CPU: the signature splits on each static the
stages decide on the host and nothing else, and CPU calls stay eager.
Run the card's share on a machine with a GPU:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_fwdgrad_graph.py
"""

import dataclasses

import pytest
import torch

from blackhole_tpu_torch.geom.types import (
    BlackHole, Camera, Disk, Scene, SimConfig,
)
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image, trace_kernel
from blackhole_tpu_torch.utils import profiling

torch.set_num_threads(1)  # see tests/test_torch_step.py

SIZE = 64  # rays per side on the card: an 8x8 depth-order prepass
SMALL = 16
STEPS = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh(monkeypatch):
    """No graphs kept and the counters at 0, before and after."""
    trace_kernel._FWDGRAD_GRAPHS.clear()
    monkeypatch.setattr(trace_kernel, "fwdgrad_captures", 0)
    monkeypatch.setattr(trace_kernel, "fwdgrad_replays", 0)
    yield
    trace_kernel._FWDGRAD_GRAPHS.clear()


def _scene(device, mass=1.0, spin=0.9, softness=0.0, integrator="rk4",
           max_steps=None, inclination=0.0, kinematics="auto"):
    """The bench scene (chip_smoke.bench_scene) at max_steps (STEPS)."""
    return Scene(
        BlackHole.create(mass, spin, device=device),
        Disk.create(6.0, 20.0, 1.0, 1.0, inclination=inclination,
                    device=device),
        SimConfig.create(time_step=0.1, max_ray_distance=150.0,
                         max_steps=max_steps or STEPS, integrator=integrator,
                         tolerance=1e-6, shadow_softness=softness,
                         disk_kinematics=kinematics, device=device),
    )


def _camera(device, y=-35.0):
    return Camera.create(position=(0.0, y, 12.0), direction=(0.0, 35.0, -12.0),
                         up=(0.0, 0.0, 1.0), fov_deg=22.0, device=device)


def _rays(camera, size):
    o, d = cam.generate_rays(camera, size, size)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _with(scene, p):
    return dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, mass=p["mass"], spin=p["spin"]))


def _mass_spin_tangents(scene):
    def build(m, a):
        return _with(scene, {"mass": m, "spin": a})

    m0, a0 = scene.blackhole.mass, scene.blackhole.spin
    one, zero = torch.ones_like(m0), torch.zeros_like(m0)
    return [torch.func.jvp(build, (m0, a0), (one, zero))[1],
            torch.func.jvp(build, (m0, a0), (zero, one))[1]]


def _loss(hit):
    return hit.color.sum() / hit.color.numel()


def _bits(t):
    """A tensor's bits (NaNs compare by payload)."""
    t = t.detach().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _hits(step):
    """The Hit and the Hit tangents of a recorded step, as one list."""
    return [step["hit"], *step["dhits"]]


def _assert_same(got, ref):
    """Two recorded steps are bit for bit the same."""
    assert _bits_equal(got["loss"], ref["loss"])
    for k in ref["grads"]:
        assert _bits_equal(got["grads"][k], ref["grads"][k]), k
    for i, (h, r) in enumerate(zip(_hits(got), _hits(ref))):
        for f in dataclasses.fields(r):
            assert _bits_equal(getattr(h, f.name), getattr(r, f.name)), (
                i, f.name)


@pytest.fixture
def recorded(monkeypatch):
    """Records each step's Hit and Hit tangents (fast_grad._losses)."""
    seen = []
    losses = fast_grad._losses

    def record(loss_of_hit, hit, dhits, tangent_clip, rebuild):
        seen.append((hit, dhits))
        return losses(loss_of_hit, hit, dhits, tangent_clip, rebuild)

    monkeypatch.setattr(fast_grad, "_losses", record)
    return seen


def _scene_stepper(device, seen, size=None, **scene_kw):
    """step(mass, spin) -> the recorded scene_value_and_grad step of the
    bench loss over {mass, spin}, in the draw's predicted depth order."""
    size = size or SIZE
    camera = _camera(device)
    o, d = _rays(camera, size)
    base = _scene(device, **scene_kw)
    vg = fast_grad.scene_value_and_grad(_loss, lambda p: _with(base, p))

    def step(mass, spin):
        p = {"mass": torch.tensor(mass, device=device),
             "spin": torch.tensor(spin, device=device)}
        order = image.predicted_depth_order(_with(base, p), camera, size,
                                            size)
        loss, grads = vg(p, o, d, order)
        hit, dhits = seen[-1]
        return {"loss": loss, "grads": grads, "hit": hit, "dhits": dhits,
                "order": order}

    return step


def _clone(step):
    return {"loss": step["loss"].clone(),
            "grads": {k: v.clone() for k, v in step["grads"].items()},
            "hit": step["hit"].map(torch.clone),
            "dhits": [h.map(torch.clone) for h in step["dhits"]]}


# ---- on the card --------------------------------------------------------

CASES = [("rk4", 0.0), ("rk4", 0.3), ("rkf45", 0.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("integrator,softness", CASES)
def test_replayed_step_is_the_eager_step(cuda, fresh, recorded, integrator,
                                         softness):
    step = _scene_stepper(cuda, recorded, integrator=integrator,
                          softness=softness)
    first = step(0.95, 0.85)  # eager, then captured
    assert (trace_kernel.fwdgrad_captures,
            trace_kernel.fwdgrad_replays) == (1, 0)
    replayed = step(1.05, 0.95)
    assert (trace_kernel.fwdgrad_captures,
            trace_kernel.fwdgrad_replays) == (1, 1)
    assert not torch.equal(first["order"], replayed["order"])
    trace_kernel._FWDGRAD_GRAPHS.clear()
    eager = step(1.05, 0.95)
    assert trace_kernel.fwdgrad_captures == 2
    _assert_same(replayed, eager)


@pytest.mark.gpu
def test_replayed_render_value_and_grad_is_the_eager_step(cuda, fresh,
                                                          recorded):
    base = _scene(cuda)
    camera = _camera(cuda)

    def setup(p):
        pos = camera.position
        c = dataclasses.replace(
            camera, position=torch.stack([pos[0], p["cam_y"], pos[2]]))
        o, d = cam.generate_rays(c, SIZE, SIZE)
        s = dataclasses.replace(base, blackhole=dataclasses.replace(
            base.blackhole, mass=p["mass"]))
        return s, o.reshape(-1, 3), d.reshape(-1, 3)

    vg = fast_grad.render_value_and_grad(_loss, setup)

    def step(mass, y):
        loss, grads = vg({"mass": torch.tensor(mass, device=cuda),
                          "cam_y": torch.tensor(y, device=cuda)})
        hit, dhits = recorded[-1]
        return {"loss": loss, "grads": grads, "hit": hit, "dhits": dhits}

    step(1.0, -35.0)
    replayed = step(1.02, -34.0)
    assert (trace_kernel.fwdgrad_captures,
            trace_kernel.fwdgrad_replays) == (1, 1)
    assert float(replayed["grads"]["cam_y"]) != 0.0  # ray tangents rode
    trace_kernel._FWDGRAD_GRAPHS.clear()
    _assert_same(replayed, step(1.02, -34.0))


@pytest.mark.gpu
def test_counters_and_held_results(cuda, fresh, recorded):
    step = _scene_stepper(cuda, recorded)
    draws = [(0.96, 0.86), (1.01, 0.9), (1.03, 0.94), (0.99, 0.87)]
    held = None
    for i, (m, s) in enumerate(draws):
        got = step(m, s)
        assert (trace_kernel.fwdgrad_captures,
                trace_kernel.fwdgrad_replays) == (1, i)
        if held is not None:
            # The last call's results are its own: this replay left them.
            _assert_same(held[0], held[1])
            assert got["hit"].steps is not held[0]["hit"].steps
            assert (got["hit"].color.data_ptr()
                    != held[0]["hit"].color.data_ptr())
        held = (got, _clone(got))


@pytest.mark.gpu
def test_two_prepares_before_their_finishes(cuda, fresh):
    camera = _camera(cuda)
    o, d = _rays(camera, SIZE)
    base = _scene(cuda)
    a = _with(base, {"mass": torch.tensor(0.97, device=cuda),
                     "spin": torch.tensor(0.88, device=cuda)})
    b = _with(base, {"mass": torch.tensor(1.04, device=cuda),
                     "spin": torch.tensor(0.93, device=cuda)})

    def planes(planes_in, scene):
        return trace_kernel.trace_planes_fwdgrad(
            *planes_in, *trace_kernel.planes_args(scene))

    def interleaved():
        pa, fa = trace_kernel.prepare_fwdgrad(o, d, a, _mass_spin_tangents(a))
        pb, fb = trace_kernel.prepare_fwdgrad(o, d, b, _mass_spin_tangents(b))
        return fa(*planes(pa, a)), fb(*planes(pb, b))

    def alone(scene):
        trace_kernel._FWDGRAD_GRAPHS.clear()
        return trace_kernel.trace_rays_kernel_fwdgrad(
            o, d, scene, _mass_spin_tangents(scene))

    def same(x, y):
        for h, r in zip([x[0], *x[1]], [y[0], *y[1]]):
            for f in dataclasses.fields(r):
                assert _bits_equal(getattr(h, f.name), getattr(r, f.name))

    # P captured by a, replayed by b; F captured by a, replayed by b.
    ra, rb = interleaved()
    assert (trace_kernel.fwdgrad_captures,
            trace_kernel.fwdgrad_replays) == (1, 1)
    ra2, rb2 = interleaved()  # every stage replayed
    assert trace_kernel.fwdgrad_replays == 3
    ref_a, ref_b = alone(a), alone(b)
    for got, ref in ((ra, ref_a), (rb, ref_b), (ra2, ref_a), (rb2, ref_b)):
        same(got, ref)


@pytest.mark.gpu
def test_a_changed_static_captures_anew(cuda, fresh):
    o, d = _rays(_camera(cuda), SMALL)

    def call(scene, n_tan=2):
        tangents = _mass_spin_tangents(scene)[:n_tan]
        return trace_kernel.trace_rays_kernel_fwdgrad(o, d, scene, tangents)

    base = _scene(cuda)
    for scene, n_tan, counts in [
            (base, 2, (1, 0)), (base, 2, (1, 1)),
            (_scene(cuda, max_steps=STEPS + 1), 2, (2, 1)),
            (_scene(cuda, softness=0.3), 2, (3, 1)),
            (base, 1, (4, 1)), (base, 2, (4, 2)),
            (_scene(cuda, max_steps=STEPS + 2), 2, (5, 2))]:
        call(scene, n_tan)
        assert (trace_kernel.fwdgrad_captures,
                trace_kernel.fwdgrad_replays) == counts
    # The least recently used signature went: max_steps = STEPS + 1.
    assert len(trace_kernel._FWDGRAD_GRAPHS) == trace_kernel.MAX_FWDGRAD_GRAPHS
    call(_scene(cuda, max_steps=STEPS + 1))
    assert trace_kernel.fwdgrad_captures == 6


@pytest.mark.gpu
def test_spans_of_capture_and_replay(cuda, fresh):
    o, d = _rays(_camera(cuda), SMALL)
    base = _scene(cuda)
    vg = fast_grad.scene_value_and_grad(_loss, lambda p: _with(base, p))
    p = {"mass": torch.tensor(1.0, device=cuda),
         "spin": torch.tensor(0.9, device=cuda)}
    profiling.clear()
    for _ in range(2):
        vg(p, o, d)
    records = profiling.spans()
    roots = [r for r in records if r.name == "grad.value_and_grad"]
    assert len(roots) == 2
    for root, kind in zip(roots, ("fwdgrad.capture", "fwdgrad.replay")):
        inside = [r for r in records if root.start <= r.start
                  and r.end <= root.end]
        stages = [r for r in inside if r.parent == root.id
                  and r.name in ("fwdgrad.prepare", "fwdgrad.finish")]
        assert [r.name for r in stages] == ["fwdgrad.prepare",
                                            "fwdgrad.finish"]
        for stage in stages:
            kids = [r for r in inside if r.parent == stage.id]
            assert [r.name for r in kids if r.name.startswith(
                "fwdgrad.")] == (["fwdgrad.jvp"] * 2 + [kind]
                                 if kind == "fwdgrad.capture" else [kind])
        jvps = [r for r in inside if r.name == "fwdgrad.jvp"]
        assert len(jvps) == (8 if kind == "fwdgrad.capture" else 0)
        assert [r.name for r in inside if r.name == "kernel.k2"] == [
            "kernel.k2"]
    profiling.clear()


# ---- on the CPU ---------------------------------------------------------

def _signature_args(device="cpu", n=6, dtype=torch.float32, **scene_kw):
    scene = _scene("cpu", **scene_kw)
    o, d = _rays(_camera("cpu"), 3)
    o, d = o[:n].to(device, dtype), d[:n].to(device, dtype)
    return o, d, scene, _mass_spin_tangents(scene)


def _triples(o, d, scene, tangents):
    return [(t, torch.zeros_like(o), torch.zeros_like(d)) for t in tangents]


SPLITS = {
    "max_steps": lambda o, d, s, t: (o, d, _scene("cpu", max_steps=301), t),
    "integrator": lambda o, d, s, t: (o, d, _scene("cpu",
                                                   integrator="rkf45"), t),
    "softness": lambda o, d, s, t: (o, d, _scene("cpu", softness=0.3), t),
    "kinematics": lambda o, d, s, t: (o, d, _scene("cpu",
                                                   kinematics="compat"), t),
    "inclination": lambda o, d, s, t: (o, d, _scene("cpu", inclination=0.3),
                                       t),
    "show_disk": lambda o, d, s, t: (o, d, dataclasses.replace(
        s, config=dataclasses.replace(s.config, show_disk=False)), t),
    "disk_enabled": lambda o, d, s, t: (o, d, dataclasses.replace(
        s, disk_enabled=False), t),
    "n_rays": lambda o, d, s, t: (o[:5], d[:5], s, t),
    "ray_dtype": lambda o, d, s, t: (o.double(), d, s, t),
    "tangent_count": lambda o, d, s, t: (o, d, s, t[:1]),
    "ray_tangents": lambda o, d, s, t: (o, d, s, _triples(o, d, s, t)),
    "order": lambda o, d, s, t: (o, d, s, t, torch.arange(o.shape[0])),
}


@pytest.mark.parametrize("static", sorted(SPLITS))
def test_signature_splits_on_each_static(static):
    args = _signature_args()
    base = trace_kernel.stage_signature(*args)
    assert trace_kernel.stage_signature(*args) == base
    assert trace_kernel.stage_signature(*SPLITS[static](*args)) != base


def test_signature_holds_over_draws_and_reads_cpu_leaves_elsewhere():
    o, d, scene, _ = _signature_args()
    sigs = []
    for m, s in ((0.96, 0.86), (1.04, 0.93)):
        drawn = _with(scene, {"mass": torch.tensor(m),
                              "spin": torch.tensor(s)})
        args = (o, d, drawn, _mass_spin_tangents(drawn),
                torch.randperm(o.shape[0]))
        # Rays on the CPU: one signature for both draws.  Rays elsewhere
        # (meta) with the scene on the CPU: a capture would bake the
        # scene's values, so they split.
        sigs.append((trace_kernel.stage_signature(*args),
                     trace_kernel.stage_signature(
                         o.to("meta"), d.to("meta"), *args[2:4],
                         args[4].to("meta"))))
    assert sigs[0][0] == sigs[1][0]
    assert sigs[0][1] != sigs[1][1]


def test_cpu_calls_stay_eager(fresh):
    o, d = _rays(_camera("cpu"), 1)
    base = _scene("cpu", max_steps=2)
    vg = fast_grad.scene_value_and_grad(_loss, lambda p: _with(base, p))
    p = {"mass": torch.tensor(1.0), "spin": torch.tensor(0.9)}
    profiling.clear()
    first = vg(p, o, d)
    second = vg(p, o, d)
    assert torch.equal(first[0], second[0])
    assert (trace_kernel.fwdgrad_captures,
            trace_kernel.fwdgrad_replays) == (0, 0)
    assert not trace_kernel._FWDGRAD_GRAPHS
    names = {r.name for r in profiling.spans()}
    assert "fwdgrad.jvp" in names
    assert not names & {"fwdgrad.capture", "fwdgrad.replay"}
    profiling.clear()
