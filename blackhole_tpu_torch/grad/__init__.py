"""Gradient engines of the port.

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
| many params          | diff_trace (reverse mode through the       |
|                      | checkpointed step loop) or                 |
|                      | bucketed.grad_over_chunks (per-chunk step  |
|                      | budgets sized by one kernel pass);         |
|                      | inverse.fit: Adam on image_loss            |
+----------------------+--------------------------------------------+

Reverse mode runs the XLA engine's trace_step in plain torch;
.backward() through the geodesic kernel itself raises.
"""
