"""The port's scaling harness (blackhole_tpu_torch.parallel.scaling) at
worlds of 1 and 2 gloo ranks on the CPU, 32x32, 48 steps.

The records are complete and world 2's image is bit for bit world 1's.
No efficiency is gated here, unlike tests/test_scaling.py's >= 0.85 per
CPU-second: the port's eager XLA engine pays a host cost per operation
whatever the batch, and both ranks pay every step's, so per-CPU-second
efficiency sits near 0.5 by construction; it is printed.
"""

import numpy as np
import torch

from blackhole_tpu_torch.parallel import scaling

torch.set_num_threads(1)  # see tests/test_torch_step.py

KEYS = ("mesh", "fwd_rays_per_s_wall", "fwd_rays_per_cpu_s",
        "fwdbwd_rays_per_s_wall", "fwdbwd_rays_per_cpu_s", "eff_fwd_wall",
        "eff_fwd_cpu", "eff_fwdbwd_wall", "eff_fwdbwd_cpu")


def test_measure_worlds_one_and_two():
    out = scaling.measure(width=32, height=32, steps=48, sizes=[1, 2],
                          repeats=1, fwdbwd=True, device="cpu")
    assert out["platform"] == "cpu" and out["max_steps"] == 48
    recs = {r["mesh"]: r for r in out["records"]}
    assert sorted(recs) == [1, 2]
    for r in recs.values():
        assert set(KEYS) <= set(r), r
        assert all(np.isfinite(r[k]) and r[k] > 0 for k in KEYS), r
    assert recs[1]["eff_fwd_cpu"] == 1.0
    print(f"world 2 efficiency: {recs[2]}")
    images = out["images"]
    assert images[1].shape == (32, 32, 3)
    np.testing.assert_array_equal(images[2], images[1])
