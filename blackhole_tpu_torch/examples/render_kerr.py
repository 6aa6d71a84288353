"""Render a Kerr a=0.9 accretion-disk image and write a PNG.

On a card the geodesic kernel (K1) traces the rays
(render.image.trace_rays_fast); --device cpu runs its plain version.

    python -m blackhole_tpu_torch.examples.render_kerr --size 512 --spin 0.9
"""

import argparse

from blackhole_tpu_torch.geom.types import BlackHole, Camera, Disk, Scene, SimConfig
from blackhole_tpu_torch.render import image
from blackhole_tpu_torch.viz import io as viz_io


def main(argv=None):
    """Returns the image (H, W, 3) on the device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spin", type=float, default=0.9)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default="kerr.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = dict(device=args.device)

    scene = Scene(
        blackhole=BlackHole.create(1.0, args.spin, **dev),
        disk=Disk.create(6.0, 20.0, **dev),
        config=SimConfig.create(
            time_step=0.1, max_ray_distance=150.0, max_steps=args.steps,
            **dev
        ),
        disk_enabled=True,
    )
    camera = Camera.create(
        position=(0.0, -35.0, 12.0),
        direction=(0.0, 35.0, -12.0),
        up=(0.0, 0.0, 1.0),
        fov_deg=22.0,
        **dev
    )
    img = image.render_image(
        scene, camera, width=args.size, height=args.size, spp=args.spp
    )
    viz_io.write_image(args.out, img.cpu().numpy())
    print(f"wrote {args.out}")
    return img


if __name__ == "__main__":
    main()
