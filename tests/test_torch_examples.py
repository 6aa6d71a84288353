"""The port's examples (blackhole_tpu_torch.examples) against their JAX
twins in examples/, at tiny arguments on the CPU.

Each JAX twin is loaded by path and run through its own main() with
sys.argv set (jax_refs.run_example); the values it computes are read
where it hands them on (its image writer, its fit, its sharded step),
which the test wraps without changing them.  The JAX forward fit runs
its kernel in interpret mode on the CPU, as the JAX package's own tests
do.  The fits' losses and the distributed render are recorded once
(tests/jax_refs.py).  Images: uint8 (viz.io.to_uint8) within 1 on all
but n/500 pixels.  Losses: rtol 1e-4.
"""

import types

import numpy as np
import pytest
import torch

from blackhole_tpu_torch.examples import (
    distributed_render, inverse_fit, lensed_starfield, render_kerr,
)
from blackhole_tpu_torch.viz import io as viz_io

import jax_refs

torch.set_num_threads(1)  # see tests/test_torch_step.py


def _close_images(got, want):
    a = viz_io.to_uint8(np.asarray(got)).astype(int)
    b = viz_io.to_uint8(np.asarray(want)).astype(int)
    assert a.shape == b.shape
    off = np.abs(a - b)
    assert off.max() <= 1 or (off > 1).sum() <= a.size // 500, off.max()


def _captured_image(name, argv):
    images = []
    writer = types.SimpleNamespace(
        write_image=lambda path, img: images.append(np.asarray(img)))
    jax_refs.run_example(name, argv, viz_io=writer)
    (image,) = images
    return image


@pytest.mark.parametrize("example, name", [(render_kerr, "render_kerr"),
                                           (lensed_starfield,
                                            "lensed_starfield")])
def test_image_examples_match_jax(example, name, tmp_path):
    args = ["--size", "16", "--steps", "60", "--out",
            str(tmp_path / f"{name}.png")]
    want = _captured_image(name, args)
    got = example.main([*args, "--device", "cpu"])
    assert (tmp_path / f"{name}.png").exists()
    _close_images(got.numpy(), want)


def fit_args(method):
    return ["--method", method, "--size", "8", "--steps", "100",
            "--fit-steps", "2"]


@pytest.mark.parametrize("method", ["forward", "reverse"])
def test_inverse_fit_matches_jax(method):
    args = fit_args(method)
    want = jax_refs.load(f"examples_inverse_fit_{method}")["losses"]
    fitted, got = inverse_fit.main([*args, "--device", "cpu"])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(float(fitted.blackhole.mass))


def test_distributed_render_matches_jax():
    """JAX's twin on conftest's 8 virtual devices (recorded once:
    tests/jax_refs.py, case examples_distributed_render), the port on a
    world of 2 gloo ranks: the sharded 64x64 render, and one step's loss,
    which at the target's own parameters is rounding noise in both."""
    rec = jax_refs.load("examples_distributed_render")
    seen = {"image": rec["image"], "loss": float(rec["loss"])}
    image, loss = distributed_render.main(["--world", "2", "--device", "cpu"])
    _close_images(image.numpy(), seen["image"])
    assert abs(loss) < 1e-10 and abs(seen["loss"]) < 1e-10, (loss, seen)
