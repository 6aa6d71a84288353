"""PyTorch/CUDA port of blackhole_tpu: the forward render (hard and soft
shadow boundary) by the geodesic kernel and by the XLA engine's
counterpart, forward- and reverse-mode gradients, both fits, the bh_*
API (api), the particle simulator (particles) and the command line
(cli).

Module paths and public names follow blackhole_tpu.  The geodesic loops
run in hand-written CUDA kernels (csrc/) for tensors on a GPU and in
their plain PyTorch versions (render.trace_kernel) for tensors on the
CPU; the XLA engine (render.trace) and reverse mode (grad.diff_trace)
are plain torch on either device.  This package never imports jax.
"""
