"""scene_value_and_grad with the soft boundary against the JAX package,
RKF45.

test_torch_soft_grad.py's case (the first 64 rays of the 32x32 parity
camera, a = 0.9, disk on, softness 0.3, params {mass, spin}) with the
adaptive integrator at tolerance 1e-6 and the 192-step budget, for the
reason test_torch_fwdgrad_rkf45.py gives (at 48 steps every ray ends on
the step budget and its tangent is the step-size controller's rounding
noise), under the reference's contract: loss rtol 1e-5, gradients rtol
1e-3, atol 1e-8.  The JAX package's value and gradient are recorded
once (tests/jax_refs.py, case soft_rkf45).
"""

import torch

from blackhole_tpu_torch.geom.types import scene_from_reference
from blackhole_tpu_torch.grad import fast_grad
from blackhole_tpu_torch.render import trace

import jax_refs
from test_torch_fwdgrad_slice import (
    assert_grad_contract, torch_loss, torch_params, torch_scene_fn,
)
from test_torch_soft_grad import soft_case

torch.set_num_threads(1)  # see tests/test_torch_step.py


def test_soft_scene_value_and_grad_rkf45_matches_jax():
    scene, _, o, d = soft_case("rkf45", max_steps=192)
    ref = jax_refs.value_and_grad(jax_refs.load("soft_rkf45"))
    tscene = scene_from_reference(scene, device="cpu")
    assert trace.track_crossing(tscene)
    got = fast_grad.scene_value_and_grad(torch_loss, torch_scene_fn(tscene))(
        torch_params(), torch.from_numpy(o), torch.from_numpy(d))
    assert_grad_contract(got, ref)
