"""Runnable examples, the PyTorch counterparts of the JAX package's
examples/: python -m blackhole_tpu_torch.examples.<name> [--device cpu].
Each main(argv) returns what it computed."""
