"""The port's examples (blackhole_tpu_torch.examples) against their JAX
twins in examples/, at tiny arguments on the CPU.

Each JAX twin is loaded by path with importlib and run through its own
main() with sys.argv set; the values it computes are read where it hands
them on (its image writer, its fit, its sharded step), which the test
wraps without changing them.  The JAX forward fit runs its kernel in
interpret mode on the CPU, as the JAX package's own tests do.  Images:
uint8 (viz.io.to_uint8) within 1 on all but n/500 pixels.  Losses:
rtol 1e-4.
"""

import functools
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from blackhole_tpu.grad import inverse as jinverse
from blackhole_tpu.parallel import mesh as jmesh
from blackhole_tpu_torch.examples import (
    distributed_render, inverse_fit, lensed_starfield, render_kerr,
)
from blackhole_tpu_torch.viz import io as viz_io

torch.set_num_threads(1)  # see tests/test_torch_step.py

ROOT = Path(__file__).resolve().parent.parent


def _jax_example(name, argv, monkeypatch, **patches):
    """Run examples/<name>.py's main() with argv, its module globals
    named in patches replaced."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr, value in patches.items():
        monkeypatch.setattr(mod, attr, value)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()


def _close_images(got, want):
    a = viz_io.to_uint8(np.asarray(got)).astype(int)
    b = viz_io.to_uint8(np.asarray(want)).astype(int)
    assert a.shape == b.shape
    off = np.abs(a - b)
    assert off.max() <= 1 or (off > 1).sum() <= a.size // 500, off.max()


def _captured_image(name, argv, monkeypatch):
    images = []
    writer = types.SimpleNamespace(
        write_image=lambda path, img: images.append(np.asarray(img)))
    _jax_example(name, argv, monkeypatch, viz_io=writer)
    (image,) = images
    return image


@pytest.mark.parametrize("example, name", [(render_kerr, "render_kerr"),
                                           (lensed_starfield,
                                            "lensed_starfield")])
def test_image_examples_match_jax(example, name, tmp_path, monkeypatch):
    args = ["--size", "16", "--steps", "60", "--out",
            str(tmp_path / f"{name}.png")]
    want = _captured_image(name, args, monkeypatch)
    got = example.main([*args, "--device", "cpu"])
    assert (tmp_path / f"{name}.png").exists()
    _close_images(got.numpy(), want)


@pytest.mark.parametrize("method", ["forward", "reverse"])
def test_inverse_fit_matches_jax(method, monkeypatch):
    args = ["--method", method, "--size", "8", "--steps", "100",
            "--fit-steps", "2"]
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
    _jax_example("inverse_fit", args, monkeypatch, inverse=fits)
    (want,) = runs
    fitted, got = inverse_fit.main([*args, "--device", "cpu"])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(float(fitted.blackhole.mass))


def test_distributed_render_matches_jax(monkeypatch):
    """JAX's twin on conftest's 8 virtual devices, the port on a world of
    2 gloo ranks: the sharded 64x64 render, and one step's loss, which
    at the target's own parameters is rounding noise in both."""
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
    _jax_example("distributed_render", [], monkeypatch, pmesh=shim)
    image, loss = distributed_render.main(["--world", "2", "--device", "cpu"])
    _close_images(image.numpy(), seen["image"])
    assert abs(loss) < 1e-10 and abs(seen["loss"]) < 1e-10, (loss, seen)
