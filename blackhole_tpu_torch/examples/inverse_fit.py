"""Inverse rendering: recover (mass, spin) from a target image.

Both gradient engines:
  --method forward   one multi-tangent kernel pass (K2) per step
                     (the fast path for few parameters)
  --method reverse   reverse mode through the checkpointed trace
                     (any device, any number of parameters)

    python -m blackhole_tpu_torch.examples.inverse_fit --method reverse
"""

import argparse
import dataclasses

from blackhole_tpu_torch.geom.types import BlackHole, Camera, Disk, Scene, SimConfig
from blackhole_tpu_torch.grad import diff_trace, inverse


def main(argv=None):
    """Returns (fitted scene, losses)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=("forward", "reverse"),
                    default="reverse")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fit-steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dict(device=args.device)

    scene = Scene(
        blackhole=BlackHole.create(1.0, 0.8, **dev),
        disk=Disk.create(6.0, 20.0, **dev),
        config=SimConfig.create(
            time_step=0.1, max_ray_distance=80.0, max_steps=args.steps, **dev
        ),
        disk_enabled=True,
    )
    camera = Camera.create(
        position=(0.0, -30.0, 8.0),
        direction=(0.0, 30.0, -8.0),
        up=(0.0, 0.0, 1.0),
        fov_deg=25.0,
        **dev
    )
    target = diff_trace.render_image_diff(scene, camera, args.size,
                                          args.size)
    bad = dataclasses.replace(
        scene, blackhole=BlackHole.create(1.2, 0.6, **dev)
    )
    fit = inverse.fit_forward if args.method == "forward" else inverse.fit
    fitted, _, losses = fit(
        target, bad, camera, args.size, args.size,
        steps=args.fit_steps, learning_rate=3e-2,
        optimize=("log_mass", "spin_raw"),
    )
    print(
        f"start mass=1.200 spin=0.600 -> fitted "
        f"mass={float(fitted.blackhole.mass):.4f} "
        f"spin={float(fitted.blackhole.spin):.4f} "
        f"(loss {losses[0]:.3e} -> {losses[-1]:.3e}; true 1.0 / 0.8)"
    )
    return fitted, losses


if __name__ == "__main__":
    main()
