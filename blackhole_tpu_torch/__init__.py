"""PyTorch/CUDA port of blackhole_tpu: the forward render path.

Module paths and public names follow blackhole_tpu.  The geodesic loop
runs in a hand-written CUDA kernel (csrc/) for tensors on a GPU and in
its plain PyTorch version (render.trace_kernel) for tensors on the CPU.
This package never imports jax.
"""
