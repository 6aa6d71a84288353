"""Rays sharded across ranks (torch.distributed): mesh holds the sharded
render and gradients, launch a world of ranks on one host, scaling the
scaling harness."""
