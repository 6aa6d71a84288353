"""PyTorch/CUDA port of blackhole_tpu: the forward render (hard and soft
shadow boundary), its forward-mode gradients and the forward-mode fit.

Module paths and public names follow blackhole_tpu.  The geodesic loops
run in hand-written CUDA kernels (csrc/) for tensors on a GPU and in
their plain PyTorch versions (render.trace_kernel) for tensors on the
CPU.  This package never imports jax.
"""
