"""CUDA graphs of K1's host stages (render.trace_kernel:
trace_rays_kernel's stages before K1 as graph P, those after it as graph
F, captured once per static signature and replayed, K1 launched eagerly
between).

On the card (marker `gpu`; skips without one): every replayed
trace_rays_kernel call equals the eager call at the same inputs on every
Hit field, bit for bit, with as many K1 launches, for the bench frame
in depth order and its prepass, each viewer tier and the accumulation
frame, a soft (K1-track) scene and RKF45; results that later replays
leave alone; the counters; a changed static captures anew; the spans of
a capture and a replay.  On the CPU: the signature splits on each static
the stages decide on the host and holds over drawn values; CPU calls,
torch.func.jvp through the trace, inputs that require grad and
torch.export stay eager.  Run the card's share on a machine with a GPU:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_k1_graph.py
"""

import dataclasses

import pytest
import torch

from blackhole_tpu_torch import export
from blackhole_tpu_torch.geom.types import (
    BlackHole, Camera, Disk, Scene, SimConfig,
)
from blackhole_tpu_torch.render import camera as cam
from blackhole_tpu_torch.render import image, trace_kernel
from blackhole_tpu_torch.utils import profiling
from blackhole_tpu_torch.viz import animate, viewer

torch.set_num_threads(1)  # see tests/test_torch_step.py

STEPS = 1000
SMALL = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh(monkeypatch):
    """No K1 graphs kept and the counters at 0, before and after."""
    trace_kernel._K1_GRAPHS.clear()
    monkeypatch.setattr(trace_kernel, "k1_captures", 0)
    monkeypatch.setattr(trace_kernel, "k1_replays", 0)
    yield
    trace_kernel._K1_GRAPHS.clear()


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


def _camera(device, az=0.0):
    return animate.orbit_camera(37.0, 18.9, az, 22.0, device=device)


def _rays(camera, size):
    o, d = cam.generate_rays(camera, size, size)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _bits(t):
    """A tensor's bits (NaNs compare by payload)."""
    t = t.detach().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_hit(got, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, torch.Tensor):
            assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), (
                f.name)
        else:
            assert a == b, f.name


@pytest.fixture
def recorded(monkeypatch):
    """Records every trace_rays_kernel call's Hit (a copy) and its K1
    launches, through the module attribute the callers look up."""
    seen = []
    trace = trace_kernel.trace_rays_kernel

    def record(*args, **kw):
        before = trace_kernel.launches
        hit = trace(*args, **kw)
        seen.append((hit.map(torch.clone), trace_kernel.launches - before))
        return hit

    monkeypatch.setattr(trace_kernel, "trace_rays_kernel", record)
    return seen


# ---- on the card --------------------------------------------------------

def _bench(device, draw, size=1024, **scene_kw):
    """render_image of the bench scene (its prepass, then the frame in
    depth order at size 256 and up) at a (mass, azimuth) draw."""
    mass, az = draw
    image.render_image(_scene(device, mass=mass, **scene_kw),
                       _camera(device, az), size, size)


def _viewer(device, draw):
    """A served session's frames (viz.viewer): each ladder tier, then
    one accumulation frame, at a (mass, azimuth) draw."""
    mass, az = draw
    state = viewer.ViewerState(mass=mass, spin=0.9, distance=40.0,
                               azimuth=az, steps=1000, device=str(device))
    scene, camera = state.scene(), state.camera()
    for divisor, steps in animate.QUALITY_LADDER:
        animate.tier_frame(scene, camera, 1280, 720, divisor, steps)
    viewer.accumulation_frame(scene, camera, 1280, 720, 3, 32)


CASES = {
    "bench": (_bench, 2),
    "viewer": (_viewer, 7),
    "soft": (lambda dev, draw: _bench(dev, draw, 256, softness=0.3), 2),
    "rkf45": (lambda dev, draw: _bench(dev, draw, 256, integrator="rkf45"),
              2),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_calls_are_the_eager_calls(cuda, fresh, recorded, case):
    drive, calls = CASES[case]
    drive(cuda, (0.97, 0.0))  # eager, then captured
    assert (trace_kernel.k1_captures, trace_kernel.k1_replays) == (calls, 0)
    del recorded[:]
    drive(cuda, (1.02, 25.0))
    assert (trace_kernel.k1_captures,
            trace_kernel.k1_replays) == (calls, calls)
    replayed = list(recorded)
    trace_kernel._K1_GRAPHS.clear()
    del recorded[:]
    drive(cuda, (1.02, 25.0))
    assert trace_kernel.k1_captures == 2 * calls
    assert len(replayed) == len(recorded) == calls
    for (got, got_launches), (ref, ref_launches) in zip(replayed, recorded):
        _same_hit(got, ref)
        assert got_launches == ref_launches == 1


@pytest.mark.gpu
def test_counters_and_held_results(cuda, fresh):
    o, d = _rays(_camera(cuda), 64)
    held = None
    for i, mass in enumerate((0.96, 1.01, 1.03, 0.99)):
        hit = trace_kernel.trace_rays_kernel(o, d, _scene(cuda, mass=mass))
        assert (trace_kernel.k1_captures, trace_kernel.k1_replays) == (1, i)
        if held is not None:
            # The last call's results are its own: this replay left them.
            _same_hit(held[0], held[1])
            assert hit.color.data_ptr() != held[0].color.data_ptr()
        held = (hit, hit.map(torch.clone))


@pytest.mark.gpu
def test_a_changed_static_captures_anew(cuda, fresh):
    o, d = _rays(_camera(cuda), SMALL)
    order = torch.randperm(o.shape[0], device=cuda)
    base = _scene(cuda)
    for args, counts in [
            ((o, d, base), (1, 0)), ((o, d, base), (1, 1)),
            ((o, d, _scene(cuda, max_steps=STEPS + 1)), (2, 1)),
            ((o, d, _scene(cuda, softness=0.3)), (3, 1)),
            ((o, d, base, order), (4, 1)), ((o[:-1], d[:-1], base), (5, 1)),
            ((o, d, base), (5, 2)), ((o, d, base, order), (5, 3))]:
        trace_kernel.trace_rays_kernel(*args)
        assert (trace_kernel.k1_captures, trace_kernel.k1_replays) == counts
    # Five kept; one past MAX_K1_GRAPHS the least recently used goes:
    # max_steps = STEPS + 1, touched once.
    for k in range(trace_kernel.MAX_K1_GRAPHS - 4):
        trace_kernel.trace_rays_kernel(
            o, d, _scene(cuda, max_steps=STEPS + 2 + k))
    assert len(trace_kernel._K1_GRAPHS) == trace_kernel.MAX_K1_GRAPHS
    captures = trace_kernel.k1_captures
    trace_kernel.trace_rays_kernel(o, d, _scene(cuda, softness=0.3))
    assert trace_kernel.k1_captures == captures  # still kept
    trace_kernel.trace_rays_kernel(o, d, _scene(cuda, max_steps=STEPS + 1))
    assert trace_kernel.k1_captures == captures + 1


@pytest.mark.gpu
def test_spans_of_capture_and_replay(cuda, fresh):
    o, d = _rays(_camera(cuda), SMALL)
    scene = _scene(cuda)
    profiling.clear()
    for _ in range(2):
        trace_kernel.trace_rays_kernel(o, d, scene)
    records = profiling.spans()
    stages = [r for r in records if r.parent is None
              and r.name in ("kernel.prepare", "kernel.finish")]
    assert [r.name for r in stages] == ["kernel.prepare",
                                        "kernel.finish"] * 2
    slot = next(iter(trace_kernel._K1_GRAPHS.values())).slot
    for i, stage in enumerate(stages):
        kind = "kernel.capture" if i < 2 else "kernel.replay"
        kids = [r for r in records if r.parent == stage.id
                and r.name.startswith("kernel.")]
        assert [(r.name, r.key) for r in kids] == [(kind, slot)]
    launches = [r for r in records if r.name == "kernel.k1"]
    assert len(launches) == 2
    for k1, (prep, fin) in zip(launches, (stages[:2], stages[2:])):
        assert prep.end <= k1.start and k1.end <= fin.start
    profiling.clear()


@pytest.mark.gpu
def test_card_calls_under_transforms_and_grad_stay_eager(cuda, fresh):
    o, d = _rays(_camera(cuda), SMALL)
    scene = _scene(cuda)
    m0 = scene.blackhole.mass

    def color(m):
        s = dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=m))
        return trace_kernel.trace_rays_kernel(o, d, s).color.sum()

    torch.func.jvp(color, (m0,), (torch.ones_like(m0),))
    color(m0.clone().requires_grad_())
    assert (trace_kernel.k1_captures, trace_kernel.k1_replays) == (0, 0)
    assert not trace_kernel._K1_GRAPHS


# ---- on the CPU ---------------------------------------------------------

def _signature_args(n=6, **scene_kw):
    o, d = _rays(_camera("cpu"), 3)
    return o[:n], d[:n], _scene("cpu", **scene_kw)


SPLITS = {
    "max_steps": lambda o, d, s: (o, d, _scene("cpu", max_steps=301)),
    "integrator": lambda o, d, s: (o, d, _scene("cpu", integrator="rkf45")),
    "softness": lambda o, d, s: (o, d, _scene("cpu", softness=0.3)),
    "kinematics": lambda o, d, s: (o, d, _scene("cpu", kinematics="compat")),
    "inclination": lambda o, d, s: (o, d, _scene("cpu", inclination=0.3)),
    "show_disk": lambda o, d, s: (o, d, dataclasses.replace(
        s, config=dataclasses.replace(s.config, show_disk=False))),
    "disk_enabled": lambda o, d, s: (o, d, dataclasses.replace(
        s, disk_enabled=False)),
    "n_rays": lambda o, d, s: (o[:5], d[:5], s),
    "batch_shape": lambda o, d, s: (o.reshape(2, 3, 3), d.reshape(2, 3, 3),
                                    s),
    "ray_dtype": lambda o, d, s: (o.double(), d, s),
    "order": lambda o, d, s: (o, d, s, torch.arange(o.shape[0])),
}


def _signature(o, d, scene, order=None):
    """trace_rays_kernel's signature: the stages' with no tangents."""
    return trace_kernel.stage_signature(o, d, scene, [], order)


@pytest.mark.parametrize("static", sorted(SPLITS))
def test_signature_splits_on_each_static(static):
    args = _signature_args()
    base = _signature(*args)
    assert _signature(*args) == base
    assert _signature(*SPLITS[static](*args)) != base


def test_signature_holds_over_draws_and_reads_cpu_leaves_elsewhere():
    sigs = []
    for mass, az in ((0.96, 0.0), (1.04, 40.0)):
        o, d = _rays(_camera("cpu", az), 3)
        scene = _scene("cpu", mass=mass)
        order = torch.randperm(o.shape[0])
        # Rays on the CPU: one signature for both draws.  Rays elsewhere
        # (meta) with the scene on the CPU: a capture would bake the
        # scene's values, so they split.
        sigs.append((_signature(o, d, scene, order),
                     _signature(o.to("meta"), d.to("meta"), scene,
                                order.to("meta"))))
    assert sigs[0][0] == sigs[1][0]
    assert sigs[0][1] != sigs[1][1]


def test_cpu_calls_stay_eager(fresh):
    o, d = _rays(_camera("cpu"), 2)
    scene = _scene("cpu", max_steps=4)
    profiling.clear()
    first = trace_kernel.trace_rays_kernel(o, d, scene)
    second = trace_kernel.trace_rays_kernel(o, d, scene,
                                            torch.arange(3, -1, -1))
    _same_hit(first, second)
    assert (trace_kernel.k1_captures, trace_kernel.k1_replays) == (0, 0)
    assert not trace_kernel._K1_GRAPHS
    names = {r.name for r in profiling.spans()}
    assert {"kernel.prepare", "kernel.finish"} <= names
    assert not names & {"kernel.capture", "kernel.replay"}
    profiling.clear()


class _Pair:
    """Stands in for trace_kernel._GraphPair where no card is: runs the
    stages eagerly and counts the calls that would have replayed."""

    calls = 0

    def __init__(self, span, counter, slot, prepare_stages, finish_stages,
                 equatorial):
        self.stages = prepare_stages, finish_stages

    def prepare(self, args):
        _Pair.calls += 1
        return self.stages[0](*args)

    def finish(self, args):
        return self.stages[1](*args)


def _with_mass(scene, m):
    return dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, mass=m))


def _jvp(o, d, scene):
    m = scene.blackhole.mass
    _, dc = torch.func.jvp(
        lambda m_: trace_kernel.trace_rays_kernel(
            o, d, _with_mass(scene, m_)).color.sum(),
        (m,), (torch.ones_like(m),))
    assert torch.isfinite(dc)


def _requires_grad(o, d, scene):
    m = scene.blackhole.mass.clone().requires_grad_()
    hit = trace_kernel.trace_rays_kernel(o, d, _with_mass(scene, m))
    assert hit.color.requires_grad


def _export(o, d, scene):
    export.export_trace(scene, n_rays=o.shape[0], device="cpu")


EAGER = {"jvp": _jvp, "requires_grad": _requires_grad, "export": _export}


@pytest.mark.parametrize("call", ["plain"] + sorted(EAGER))
def test_transforms_grad_and_export_stay_eager(monkeypatch, fresh, call):
    """With the rays taken for a card's, a plain call reaches the graphs
    (the control) and the others do not."""
    monkeypatch.setattr(trace_kernel, "_on_cuda", lambda x: True)
    monkeypatch.setattr(trace_kernel, "_GraphPair", _Pair)
    monkeypatch.setattr(_Pair, "calls", 0)
    o, d = _rays(_camera("cpu"), 2)
    scene = _scene("cpu", max_steps=4)
    if call == "plain":
        trace_kernel.trace_rays_kernel(o, d, scene)
        trace_kernel.trace_rays_kernel(o, d, scene)
        assert _Pair.calls == 2 and len(trace_kernel._K1_GRAPHS) == 1
    else:
        EAGER[call](o, d, scene)
        assert _Pair.calls == 0 and not trace_kernel._K1_GRAPHS
