"""scene_value_and_grad of the PyTorch port against the JAX package, RKF45.

The case of test_torch_fwdgrad_slice.py (the first 64 rays of the 32x32
parity camera, Kerr a = 0.9, disk on, params {mass, spin}) with the
adaptive integrator at tolerance 1e-6 and the 192-step budget of the
forward RKF45 parity tests (test_torch_slice.py), under the reference's
contract: loss rtol 1e-5, both gradients rtol 1e-3, atol 1e-8.  The
JAX package's value and gradient are recorded once (tests/jax_refs.py,
case fwdgrad_rkf45).

Why not 48 steps: there every ray ends at MAX_STEPS, so its colour (the
sky along the last chord) depends on how far the fixed number of steps
carried it, and its tangent on the sum of d(h)/d(param) over the
steps.  That is the derivative of the step-size controller, whose error
estimate |y5 - y4| is the difference of two nearly equal numbers with
rounding noise of an ulp over the tolerance (~10% at 1e-6 in float32);
an ulp of log/exp between torch and XLA moves d/dmass far outside the
contract there.  At 192 steps these rays end on their path budget, and
the tangent no longer rides on the controller's noise.
"""

import torch

from blackhole_tpu_torch.geom.types import scene_from_reference
from blackhole_tpu_torch.geom.types import RayResult
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.render import trace_kernel

import jax_refs
from test_torch_fwdgrad_slice import (
    assert_grad_contract, parity_case, torch_loss, torch_params,
    torch_scene_fn,
)

torch.set_num_threads(1)  # see tests/test_torch_step.py


def test_scene_value_and_grad_rkf45_matches_jax():
    scene, _, o, d = parity_case("rkf45", max_steps=192)
    ref = jax_refs.value_and_grad(jax_refs.load("fwdgrad_rkf45"))
    tscene = scene_from_reference(scene, device="cpu")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = fast_grad.scene_value_and_grad(torch_loss, torch_scene_fn(tscene))(
        torch_params(), to, td)
    assert_grad_contract(got, ref)
    # The rays end on their path budget, not on the step budget.
    hit = trace_kernel.trace_rays_kernel(to, td, tscene)
    assert bool((hit.result == RayResult.MAX_DISTANCE).all())
