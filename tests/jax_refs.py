"""Recorded outputs of the JAX package for the port's parity tests.

The JAX package (blackhole_tpu/) is frozen: the port's tests hold the
port to it, and nothing changes it.  Its references that run a Pallas
kernel in interpret mode, or that take over 20 s to compile, are
therefore constants, and the tests read them from
tests/data/jax_refs/<case>.npz instead of compiling them on every run.

Each function below decorated with @case is the JAX code a port test
ran live, with the same scene, rays, steps, tangents and interpret-mode
calls; it returns the compared arrays as numpy arrays.  Each record
carries a manifest (the case's name, the jax and jaxlib versions, a
SHA-256 over blackhole_tpu/'s files and the XLA_FLAGS and x64 setting
it ran under); load() checks it against the running process and fails
on any mismatch.

Rewrite the records (under the suite's own JAX configuration:
tests/conftest.py is imported first):

    python tests/jax_refs.py            # every case
    python tests/jax_refs.py CASE ...   # some cases

tests/test_jax_refs.py checks the manifests (tier-1) and rebuilds every
record live against its file (marked slow: pytest -m slow
tests/test_jax_refs.py).
"""

import dataclasses
import fnmatch
import functools
import hashlib
import importlib.util
import json
import os
import sys
import time
import types
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
DATA = TESTS / "data" / "jax_refs"
REWRITE = "python tests/jax_refs.py"

CASES = {}
TOLERANCES = {}


def case(tolerances=None):
    """Register a case.  tolerances maps fnmatch patterns of the keys of
    its float arrays to (rtol, atol), a tenth of the tightest tolerance
    any test applies to them (an input of the port's side is held
    exactly, a bound with a floor scaled by the data's largest value by
    its relative part alone): the live rebuild is held to it
    (tests/test_jax_refs.py).  Integer arrays (result codes, step counts,
    orders) are held equal."""
    def register(fn):
        CASES[fn.__name__] = fn
        TOLERANCES[fn.__name__] = tolerances or {}
        return fn
    return register


def tolerance(name, key):
    """(rtol, atol) of float array `key` of case `name`."""
    for pattern, tol in TOLERANCES[name].items():
        if fnmatch.fnmatchcase(key, pattern):
            return tol
    raise KeyError(f"no tolerance for {key!r} of case {name!r}")


@functools.lru_cache(maxsize=None)
def sources_sha256():
    """SHA-256 over blackhole_tpu/'s files in sorted path order (each
    file's path relative to the repo, then its bytes)."""
    h = hashlib.sha256()
    paths = sorted(p for p in (ROOT / "blackhole_tpu").rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts
                   and p.suffix != ".pyc")
    for p in paths:
        h.update(p.relative_to(ROOT).as_posix().encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest()


def manifest(name):
    """The manifest of a record of case `name` made in this process."""
    import jax
    import jaxlib

    return {"case": name, "jax": jax.__version__,
            "jaxlib": jaxlib.__version__,
            "blackhole_tpu_sha256": sources_sha256(),
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
            "jax_enable_x64": bool(jax.config.jax_enable_x64)}


def path(name):
    return DATA / f"{name}.npz"


def read(name):
    """(manifest, arrays) of the record of case `name`."""
    with np.load(path(name), allow_pickle=False) as f:
        arrays = {k: f[k] for k in f.files}
    return json.loads(str(arrays.pop("manifest"))), arrays


def load(name):
    """The recorded arrays of case `name` (a dict of numpy arrays),
    after checking the record's manifest against this process."""
    if name not in CASES:
        raise KeyError(f"no JAX reference case {name!r} in tests/jax_refs.py")
    if not path(name).exists():
        raise AssertionError(
            f"no record of JAX reference {name!r} at {path(name)}; "
            f"write it with `{REWRITE} {name}`")
    recorded, arrays = read(name)
    now = manifest(name)
    if recorded != now:
        diff = {k: (recorded.get(k), now[k]) for k in now
                if recorded.get(k) != now[k]}
        raise AssertionError(
            f"the record of JAX reference {name!r} was made under another "
            f"configuration (field: (record, this process)): {diff}; "
            f"rewrite the records with `{REWRITE}` (or `{REWRITE} {name}`)")
    return arrays


def _hit(hit, fields, prefix=""):
    return {prefix + f: np.asarray(getattr(hit, f)) for f in fields}


def _grad(value_and_grad):
    v, g = value_and_grad
    out = {"loss": np.asarray(v)}
    out.update({f"grad.{k}": np.asarray(x) for k, x in g.items()})
    return out


def hit(rec, prefix=""):
    """The fields of a record written by _hit, by attribute."""
    return types.SimpleNamespace(**{k[len(prefix):]: v for k, v in rec.items()
                                    if k.startswith(prefix)})


def value_and_grad(rec):
    """(loss, {param: gradient}) of a record written by _grad."""
    return rec["loss"], {k[len("grad."):]: v for k, v in rec.items()
                         if k.startswith("grad.")}


def _inverse_fit_losses(method):
    """examples/inverse_fit.py's losses at test_torch_examples.py's
    arguments: the JAX package's fits wrapped to keep each run's losses,
    the forward fit's kernel in interpret mode."""
    from blackhole_tpu.grad import inverse as jinverse
    from test_torch_examples import fit_args

    runs = []

    def record(fit):
        def run(*a, **k):
            out = fit(*a, **k)
            runs.append(out[2])
            return out
        return run

    fits = types.SimpleNamespace(
        fit=record(jinverse.fit),
        fit_forward=record(functools.partial(jinverse.fit_forward,
                                             interpret=True)))
    run_example("inverse_fit", fit_args(method), inverse=fits)
    (want,) = runs
    return {"losses": np.asarray(want)}


def run_example(name, argv, **patches):
    """Run examples/<name>.py's main() with argv, its module globals
    named in patches replaced (the JAX twins of the port's examples)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr, value in patches.items():
        setattr(mod, attr, value)
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = saved


# ---------------------------------------------------------------- cases

SLICE_FIELDS = ("result", "steps", "color", "distance", "position", "min_r")

# test_torch_slice.py's traces: key -> (_case args, _case kwargs, rays).
SLICE_TRACES = {
    "rk4-schw-disk": ((0.0, True), dict(time_step=0.1), None),
    "rk4-kerr-disk": ((0.9, True), dict(time_step=0.1), None),
    "rk4-kerr-no-disk": ((0.9, False), dict(time_step=0.1), None),
    "rk4-kerr-disk-wide-step": ((0.9, True), dict(time_step=0.5), None),
    "outward": ((0.9, True), dict(max_steps=250, time_step=0.5), "outward"),
    "rkf45-0.9-True": ((0.9, True, "rkf45"), dict(max_steps=192), None),
    "rkf45-0.0-False": ((0.0, False, "rkf45"), dict(max_steps=192), None),
    "non-tile": ((0.9, True), dict(max_steps=100), 777),
}


def slice_rays(o, d, rays):
    """The rays a test of test_torch_slice.py traces of its _case."""
    if rays == "outward":
        return o[::16], -d[::16]
    if rays is not None:
        return o[:rays], d[:rays]
    return o, d


@case({"*.color": (0.0, 2e-5), "*.distance": (1e-6, 1e-4),
       "*.position": (1e-6, 1e-4), "*.min_r": (1e-6, 0.0)})
def slice_trace():
    """test_torch_slice.py's _trace_both: trace_rays_pallas in interpret
    mode on each test's rays."""
    import jax.numpy as jnp
    from blackhole_tpu.render import pallas_kernel
    from test_torch_slice import _case

    out = {}
    for key, (args, kwargs, rays) in SLICE_TRACES.items():
        scene, _, o, d = _case(*args, **kwargs)
        o, d = slice_rays(o, d, rays)
        ref = pallas_kernel.trace_rays_pallas(jnp.asarray(o), jnp.asarray(d),
                                              scene, interpret=True)
        out.update(_hit(ref, SLICE_FIELDS, key + "."))
    return out


@case()
def slice_depth_order():
    """test_torch_slice.py's test_predicted_depth_order_matches_jax."""
    from blackhole_tpu.render import image as jimage
    from test_torch_slice import _case

    scene, camera, _, _ = _case(0.9, True, max_steps=150)
    return {"order": np.asarray(jimage.predicted_depth_order(
        scene, camera, 32, 30, block=4, interpret=True))}


@case({"color": (0.0, 2e-6), "min_r": (3e-6, 0.0)})
def soft_slice_trace():
    """test_torch_soft_slice.py's test_trace_rays_kernel_soft_matches_pallas."""
    import jax.numpy as jnp
    from blackhole_tpu.render import pallas_kernel
    from test_torch_slice import _case
    from test_torch_soft_slice import _soft

    scene, _, o, d = _case(0.9, True, max_steps=400)
    scene = _soft(scene, 0.25)
    ref = pallas_kernel.trace_rays_pallas(jnp.asarray(o), jnp.asarray(d),
                                          scene, interpret=True)
    return _hit(ref, ("result", "min_r", "color"))


@case()
def xla_engine_depth_order_rays():
    """test_torch_xla_engine.py's test_render_entry_points_match_jax: the
    depth order's prepass through the JAX package's kernel."""
    import jax.numpy as jnp
    from blackhole_tpu.render import image as jimage
    from test_torch_xla_engine import _case

    scene, camera, o, d = _case(max_steps=60, time_step=0.5, size=16)
    return {"order": np.asarray(jimage.predicted_depth_order_rays(
        jnp.asarray(o), jnp.asarray(d), scene, stride=8, interpret=True))}


@case({"color": (0.0, 2e-5), "position": (5e-5, 0.0),
       "distance": (5e-5, 0.0)})
def api_five_rays():
    """test_torch_api.py's five_rays: the JAX API's batch trace through
    the geodesic kernel in interpret mode."""
    from blackhole_tpu import api as japi
    from test_torch_api import DIRS, ORIGINS, _jax_ctx

    ref = japi.bh_trace_rays_batch(_jax_ctx(), ORIGINS, DIRS,
                                   engine="pallas_interpret")
    return _hit(ref, ("result", "steps", "color", "position", "distance"))


@case({"loss": (1e-6, 0.0), "grad.*": (1e-4, 1e-9),
       "dcolor.*": (1e-3, 0.0)})
def fwdgrad_slice_rk4():
    """test_torch_fwdgrad_slice.py's rk4 fixture: scene_value_and_grad
    and trace_rays_pallas_fwdgrad's result codes and colour tangents."""
    import jax.numpy as jnp
    from test_torch_fwdgrad_slice import _jax_rk4, parity_case

    scene, camera, o, d = parity_case()
    vg, result, dcolors = _jax_rk4(scene, jnp.asarray(o), jnp.asarray(d))
    out = _grad(vg)
    out["result"] = np.asarray(result)
    out.update({f"dcolor.{i}": np.asarray(c) for i, c in enumerate(dcolors)})
    return out


@case({"loss": (1e-6, 0.0), "grad.*": (1e-4, 1e-9)})
def fwdgrad_rkf45():
    """test_torch_fwdgrad_rkf45.py: scene_value_and_grad, RKF45."""
    import jax
    import jax.numpy as jnp
    from blackhole_tpu.grad import fast_grad as jfast_grad
    from test_torch_fwdgrad_slice import (
        jax_loss, jax_params, jax_scene_fn, parity_case,
    )

    scene, _, o, d = parity_case("rkf45", max_steps=192)
    vg = jfast_grad.scene_value_and_grad(jax_loss, jax_scene_fn(scene),
                                         interpret=True)
    return _grad(jax.jit(lambda p: vg(p, jnp.asarray(o), jnp.asarray(d)))(
        jax_params()))


@case({"loss": (1e-6, 0.0), "grad.*": (1e-4, 1e-9)})
def fwdgrad_render():
    """test_torch_fwdgrad_render.py: render_value_and_grad with ray
    tangents (the camera's y) beside the mass."""
    import jax
    import jax.numpy as jnp
    from blackhole_tpu.grad import fast_grad as jfast_grad
    from blackhole_tpu.render import camera as jcam
    from test_torch_fwdgrad_render import P0
    from test_torch_fwdgrad_slice import jax_loss, parity_case

    scene, camera, _, _ = parity_case()

    def jsetup(p):
        c = dataclasses.replace(
            camera, position=camera.position.at[1].set(p["cam_y"]))
        o, d = jcam.generate_rays(c, 8, 8)
        s = dataclasses.replace(scene, blackhole=dataclasses.replace(
            scene.blackhole, mass=p["mass"]))
        return s, o.reshape(-1, 3), d.reshape(-1, 3)

    vg = jfast_grad.render_value_and_grad(jax_loss, jsetup, interpret=True)
    return _grad(jax.jit(vg)({k: jnp.float32(v) for k, v in P0.items()}))


@case({"loss": (1e-6, 0.0), "grad.*": (1e-4, 1e-9),
       "dcolor.*": (1e-3, 0.0)})
def soft_grad():
    """test_torch_soft_grad.py: scene_value_and_grad with the soft
    boundary, and trace_rays_pallas_fwdgrad's result codes and colour
    tangents for the scene tangents and a ray tangent."""
    import jax
    import jax.numpy as jnp
    from blackhole_tpu.grad import fast_grad as jfast_grad
    from blackhole_tpu.render import pallas_kernel
    from test_torch_fwdgrad_slice import P0, jax_loss, jax_params, \
        jax_scene_fn
    from test_torch_soft_grad import soft_case

    scene, _, o, d = soft_case()
    scene_fn = jax_scene_fn(scene)
    vg = jfast_grad.scene_value_and_grad(jax_loss, scene_fn, interpret=True)
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    def run(p):
        tangents = [jax.jvp(scene_fn, (p,), ({k: jnp.float32(k == name)
                                              for k in P0},))[1]
                    for name in P0]
        hit, dhits = pallas_kernel.trace_rays_pallas_fwdgrad(
            jo, jd, scene_fn(p), tangents, interpret=True)
        # A ray tangent: the camera moving along x.
        _, ray_dhits = pallas_kernel.trace_rays_pallas_fwdgrad(
            jo, jd, scene_fn(p), [(jax.tree_util.tree_map(
                jnp.zeros_like, scene_fn(p)),
                jnp.broadcast_to(jnp.float32([1.0, 0.0, 0.0]), jo.shape),
                jnp.zeros_like(jd))], interpret=True)
        return (vg(p, jo, jd), hit.result,
                [dh.color for dh in dhits] + [ray_dhits[0].color])

    vgr, result, dcolors = jax.jit(run)(jax_params())
    out = _grad(vgr)
    out["result"] = np.asarray(result)
    out.update({f"dcolor.{i}": np.asarray(c) for i, c in enumerate(dcolors)})
    return out


@case({"loss": (1e-6, 0.0), "grad.*": (1e-4, 1e-9)})
def soft_rkf45():
    """test_torch_soft_rkf45.py: scene_value_and_grad with the soft
    boundary, RKF45."""
    import jax
    import jax.numpy as jnp
    from blackhole_tpu.grad import fast_grad as jfast_grad
    from test_torch_fwdgrad_slice import jax_loss, jax_params, jax_scene_fn
    from test_torch_soft_grad import soft_case

    scene, _, o, d = soft_case("rkf45", max_steps=192)
    vg = jfast_grad.scene_value_and_grad(jax_loss, jax_scene_fn(scene),
                                         interpret=True)
    return _grad(jax.jit(lambda p: vg(p, jnp.asarray(o), jnp.asarray(d)))(
        jax_params()))


@case({"losses": (1e-5, 0.0), "target": (0.0, 0.0)})
def soft_fit():
    """test_torch_soft_fit.py's test_fit_forward_matches_jax: the target
    image (the port's input) and the JAX fit_forward's three losses."""
    import jax.numpy as jnp
    from blackhole_tpu.grad import inverse as jinverse
    from blackhole_tpu.render import camera as jcam
    from blackhole_tpu.render import pallas_kernel
    from test_torch_soft_fit import LR, SIZE, _case

    target_scene, camera = _case(1.0)
    o, d = jcam.generate_rays(camera, SIZE, SIZE)
    target = np.asarray(pallas_kernel.trace_rays_pallas(
        o.reshape(-1, 3), d.reshape(-1, 3), target_scene,
        interpret=True).color, np.float32).reshape(SIZE, SIZE, 3)
    init_scene, _ = _case(1.03)
    _, _, ref = jinverse.fit_forward(jnp.asarray(target), init_scene, camera,
                                     SIZE, SIZE, steps=3, learning_rate=LR,
                                     interpret=True)
    return {"target": target, "losses": np.asarray(ref)}


@case({"losses": (1e-5, 0.0)})
def examples_inverse_fit_forward():
    """test_torch_examples.py's test_inverse_fit_matches_jax[forward]."""
    return _inverse_fit_losses("forward")


@case({"xla": (0.0, 1e-6), "pallas": (0.0, 2e-6), "loss": (1e-10, 0.0),
       "grads.*": (1e-10, 0.0)})
def parallel_sharded():
    """test_torch_parallel.py's jax_refs fixture: JAX's sharded renders
    (XLA engine and the kernel in interpret mode) and sharded gradient
    on a 2-device mesh."""
    from test_torch_parallel import jax_sharded_refs

    refs = jax_sharded_refs()
    out = {k: refs[k] for k in ("xla", "pallas")}
    out["loss"] = np.asarray(refs["loss"])
    out.update({f"grads.{k}": v for k, v in refs["grads"].items()})
    return out


@case({"losses": (1e-5, 0.0)})
def examples_inverse_fit_reverse():
    """test_torch_examples.py's test_inverse_fit_matches_jax[reverse]."""
    return _inverse_fit_losses("reverse")


@case({"image": (0.0, 4e-4), "loss": (0.0, 1e-11)})
def examples_distributed_render():
    """test_torch_examples.py's test_distributed_render_matches_jax:
    examples/distributed_render.py's sharded 64x64 image and step loss on
    conftest's 8 virtual devices."""
    from blackhole_tpu.parallel import mesh as jmesh

    seen = {}

    def render(*a, **k):
        image = jmesh.render_image_sharded(*a, **k)
        seen["image"] = np.asarray(image)
        return image

    def train_step(*a, **k):
        step = jmesh.make_train_step_sharded(*a, **k)

        def run(*sa):
            out = step(*sa)
            seen["loss"] = float(out[2])
            return out
        return run

    shim = types.SimpleNamespace(make_mesh=jmesh.make_mesh,
                                 render_image_sharded=render,
                                 make_train_step_sharded=train_step)
    run_example("distributed_render", [], pmesh=shim)
    return {"image": seen["image"], "loss": np.asarray(seen["loss"])}


@case({"*": (1e-7, 0.0)})
def diff_trace_grad():
    """test_torch_diff_trace.py's test_render_image_diff_grad_matches_jax,
    hard and soft: jax.grad of the mean 8x8 differentiable image over
    (mass, spin) at (1.0, 0.5)."""
    import jax
    import jax.numpy as jnp
    from blackhole_tpu.grad import diff_trace as jdiff
    from test_torch_diff_trace import SOFTNESS, small_case

    out = {}
    for key, softness in SOFTNESS.items():
        jscene, jcamera, _, _ = small_case(softness=softness)

        def jloss(m, s):
            bh = dataclasses.replace(jscene.blackhole, mass=m, spin=s)
            return jnp.mean(jdiff.render_image_diff(
                dataclasses.replace(jscene, blackhole=bh), jcamera, 8, 8))

        want = jax.grad(jloss, (0, 1))(jnp.float64(1.0), jnp.float64(0.5))
        out[f"{key}.mass"], out[f"{key}.spin"] = map(np.asarray, want)
    return out


@case({"target": (0.0, 0.0), "loss": (1e-10, 0.0),
       "grad.*": (1e-7, 1e-15), "step_loss": (1e-10, 0.0),
       "new.*": (1e-13, 0.0)})
def fit_image_loss_and_train_step():
    """test_torch_fit.py's test_image_loss_and_train_step_match_jax: the
    target image (the port's input), image_loss's value and gradient
    and one make_train_step step (optax.inject_hyperparams(adam), rate
    2e-2, the freeze mask of fit(optimize=("log_mass",)))."""
    import jax
    import jax.numpy as jnp
    import optax
    from blackhole_tpu.geom import types as jtypes
    from blackhole_tpu.grad import diff_trace as jdiff
    from blackhole_tpu.grad import inverse as jinverse
    from test_torch_fit import small_case

    jscene, jcamera, _, _ = small_case()
    target_scene = dataclasses.replace(
        jscene, blackhole=jtypes.BlackHole.create(1.0, 0.5,
                                                  dtype=jnp.float64))
    target = jdiff.render_image_diff(target_scene, jcamera, 8, 8)
    bad = dataclasses.replace(
        jscene, blackhole=jtypes.BlackHole.create(1.15, 0.5,
                                                  dtype=jnp.float64))
    jparams = jinverse.pack_params(bad, jcamera)
    want_loss, want_grads = jax.value_and_grad(jinverse.image_loss)(
        jparams, target, jscene, jcamera, 8, 8)
    mask = {k: float(k == "log_mass") for k in jparams}
    jopt = optax.inject_hyperparams(optax.adam)(learning_rate=2e-2)
    jstep = jinverse.make_train_step(jopt, 8, 8)
    jmask = {k: jnp.asarray(v, jnp.float64) for k, v in mask.items()}
    jnew, _, jloss = jstep(jparams, jopt.init(jparams), target, jscene,
                           jcamera, jmask)
    out = _grad((want_loss, want_grads))
    out.update({"target": np.asarray(target),
                "step_loss": np.asarray(jloss)})
    out.update({f"new.{k}": np.asarray(v) for k, v in jnew.items()})
    return out


@case({"loss": (1e-10, 0.0), "grad.*": (1e-7, 0.0)})
def fit_grad_over_chunks():
    """test_torch_fit.py's test_grad_over_chunks_matches_jax: 16x16 rays
    in 4 chunks, the loss sum(colour) per chunk, d/d(mass, spin)."""
    import jax.numpy as jnp
    from blackhole_tpu.grad import bucketed as jbucketed
    from blackhole_tpu.render import camera as jcam
    from test_torch_fit import small_case

    jscene, jcamera, _, _ = small_case(spin=0.9, max_steps=64)
    o, d = jcam.generate_rays(jcamera, 16, 16)
    o, d = np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)

    def jscene_fn(p):
        return dataclasses.replace(jscene, blackhole=dataclasses.replace(
            jscene.blackhole, mass=p["mass"], spin=p["spin"]))

    return _grad(jbucketed.grad_over_chunks(
        jscene_fn, {"mass": jnp.float64(1.0), "spin": jnp.float64(0.9)},
        jnp.asarray(o), jnp.asarray(d), lambda c, i: jnp.sum(c), chunks=4))


@case({"last": (0.0, 2e-5), "plain_last": (0.0, 2e-5)})
def frontends_viewer_run():
    """test_torch_frontends.py's jax_viewer_run fixture: the JAX viewer
    run with particles on, its stats (frames, tiers, resets), its last
    frame as saved and its last frame before the particle overlay."""
    import pytest
    from blackhole_tpu.viz import effects as jeffects
    from blackhole_tpu.viz import io as jio
    from blackhole_tpu.viz import viewer as jviewer
    from test_torch_frontends import VIEW_KW, VIEW_RUN

    saved, plain = {}, []
    overlay = jeffects.particle_overlay

    def keep(frame, *args, **kw):
        plain.append(np.asarray(frame))
        return overlay(frame, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jio, "write_image", lambda path, img: saved.update(
            last=np.asarray(img)))
        mp.setattr(jeffects, "particle_overlay", keep)
        stats = jviewer.run(jviewer.ViewerState(**VIEW_KW, particles=True),
                            **VIEW_RUN)
    assert len(plain) == stats["frames"]
    return {"frames": np.asarray(stats["frames"]),
            "tiers": np.asarray(stats["tiers"]),
            "resets": np.asarray(stats["resets"]),
            "last": saved["last"], "plain_last": plain[-1]}


def write(name):
    t0 = time.perf_counter()
    arrays = CASES[name]()
    seconds = time.perf_counter() - t0
    DATA.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path(name), manifest=np.array(json.dumps(
        manifest(name), sort_keys=True)), **arrays)
    print(f"{name}: {seconds:.1f} s, {path(name).stat().st_size} bytes",
          flush=True)


def main(argv):
    names = argv or list(CASES)
    unknown = [n for n in names if n not in CASES]
    if unknown:
        raise SystemExit(f"unknown cases {unknown}; cases: {list(CASES)}")
    for name in names:
        write(name)


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(TESTS)]
    import conftest  # noqa: F401  (the suite's JAX configuration)
    import jax_refs

    jax_refs.main(sys.argv[1:])
