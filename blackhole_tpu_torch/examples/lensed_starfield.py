"""Render a charged, spinning black hole against a lensed starfield.

The Kerr-Newman metric family (Delta = r^2 - 2Mr + a^2 + Q^2) and a
gravitationally lensed environment map: escaped rays sample an equirect
panorama along their final deflected direction, so stars smear into
tangential arcs around the photon ring.

    python -m blackhole_tpu_torch.examples.lensed_starfield --size 512 \
        --spin 0.6 --charge 0.5
"""

import argparse

from blackhole_tpu_torch.geom.types import BlackHole, Camera, Disk, Scene, SimConfig
from blackhole_tpu_torch.render import image
from blackhole_tpu_torch.viz import effects
from blackhole_tpu_torch.viz import io as viz_io


def main(argv=None):
    """Returns the image (H, W, 3) on the device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spin", type=float, default=0.6)
    ap.add_argument("--charge", type=float, default=0.5)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--density", type=float, default=0.004)
    ap.add_argument("--no-disk", action="store_true")
    ap.add_argument("--out", default="lensed_starfield.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dict(device=args.device)

    if (args.spin**2 + args.charge**2) > 1.0:
        raise SystemExit("need spin^2 + charge^2 <= 1 (sub-extremal)")

    env = effects.starfield_envmap(512, 1024, density=args.density, seed=7,
                                   **dev)
    scene = Scene(
        blackhole=BlackHole.create(1.0, args.spin, args.charge, **dev),
        disk=Disk.create(6.0, 20.0, **dev),
        config=SimConfig.create(
            time_step=0.1, max_ray_distance=200.0, max_steps=args.steps,
            **dev
        ),
        disk_enabled=not args.no_disk,
        env_map=env,
    )
    camera = Camera.create(
        position=(0.0, -35.0, 12.0),
        direction=(0.0, 35.0, -12.0),
        up=(0.0, 0.0, 1.0),
        fov_deg=22.0,
        **dev
    )
    img = image.render_image(
        scene, camera, width=args.size, height=args.size
    )
    viz_io.write_image(args.out, img.cpu().numpy())
    print(f"wrote {args.out}")
    return img


if __name__ == "__main__":
    main()
