"""PyTorch/CUDA port of blackhole_tpu: the forward render (hard and soft
shadow boundary) by the geodesic kernel and by the XLA engine's
counterpart, forward- and reverse-mode gradients, both fits, the bh_*
API (api), the particle simulator (particles), the command line (cli),
rays sharded over torch.distributed (parallel), torch.export artifacts
(export) and the examples (examples).

Module paths and public names follow blackhole_tpu.  The geodesic loops
run in hand-written CUDA kernels (csrc/) for tensors on a GPU and in
their plain PyTorch versions (render.trace_kernel) for tensors on the
CPU; the XLA engine (render.trace) and reverse mode (grad.diff_trace)
are plain torch on either device.  This package never imports jax.

Importing the package registers the operators that exported programs
call (blackhole_tpu_torch::trace_planes, ::init_null_rays).
"""

from blackhole_tpu_torch.render import trace_kernel as _operators  # noqa: F401
