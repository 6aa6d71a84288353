"""Gradient engines of the port (forward mode).

+----------------------+--------------------------------------------+
| workload             | engine                                     |
+----------------------+--------------------------------------------+
| few params (<= ~10)  | fast_grad.scene_value_and_grad /           |
|                      | render_value_and_grad: all tangents in one |
|                      | pass of the multi-tangent kernel (K2)      |
| few params, opaque   | fast_grad.value_and_grad_fwd: one          |
| loss                 | torch.func.jvp per parameter, each through |
|                      | K2 with one tangent (K3)                   |
| fitting an image     | inverse.fit_forward: Adam, one             |
|                      | render_value_and_grad pass per step        |
+----------------------+--------------------------------------------+

Reverse mode (the JAX package's diff_trace, bucketed, and inverse's
image_loss, make_train_step, fit) is not ported yet: a .backward()
through the geodesic kernel raises.
"""
