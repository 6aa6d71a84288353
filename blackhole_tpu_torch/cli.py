"""The command line: the reference test program's tables, a render,
an inverse-rendering fit, the terminal viewer and the browser server.

PyTorch counterpart of blackhole_tpu.cli.  Every command runs on the
card unless --device names another device (--device cpu runs the
kernels' plain versions on the CPU).

Run: python -m blackhole_tpu_torch.cli [tests|render|fit|view|serve]
     [--device D]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import numpy as np

from blackhole_tpu_torch import api
from blackhole_tpu_torch.geom.types import RayResult

RESULT_NAMES = {
    RayResult.HORIZON: "Hit event horizon",
    RayResult.DISK: "Hit accretion disk",
    RayResult.BACKGROUND: "Reached background",
    RayResult.MAX_DISTANCE: "Reached maximum distance",
    RayResult.MAX_STEPS: "Reached maximum steps",
    RayResult.ERROR: "Error during ray tracing",
}

# The 5 canonical rays: direct hit, graze, far miss, toward the disk,
# from the side.
TEST_RAYS = [
    ((0.0, 0.0, 30.0), (0.0, 0.0, -1.0)),
    ((0.0, 0.0, 30.0), (0.2, 0.0, -1.0)),
    ((0.0, 0.0, 30.0), (0.5, 0.0, -1.0)),
    ((0.0, 0.0, 30.0), (0.3, 0.0, -1.0)),
    ((30.0, 0.0, 0.0), (-1.0, 0.0, 0.1)),
]


def configure_tests(context) -> None:
    """The test program's configuration: Schwarzschild M = 1, the disk
    6..20 M, step 0.1, path 100, 1000 steps, tolerance 1e-6."""
    for rc in (api.bh_configure_black_hole(context, 1.0, 0.0, 0.0),
               api.bh_configure_accretion_disk(context, 6.0, 20.0, 1.0, 1.0),
               api.bh_configure_simulation(context, 0.1, 100.0, 1000, 1e-6)):
        if rc != api.BHError.SUCCESS:
            raise RuntimeError(f"configuration failed with code {rc}")


def print_ray_result(hit):
    print(f"Ray result: {RESULT_NAMES.get(int(hit.result), 'Unknown')}")
    p = hit.position.tolist()
    print(f"  Hit position: ({p[0]:.3f}, {p[1]:.3f}, {p[2]:.3f})")
    print(f"  Distance traveled: {float(hit.distance):.3f}")
    print(f"  Steps: {int(hit.steps)}")
    print(f"  Time dilation: {float(hit.time_dilation):.3f}")
    if int(hit.result) in (RayResult.BACKGROUND, RayResult.MAX_DISTANCE):
        s = hit.sky_direction.tolist()
        print(f"  Sky direction: ({s[0]:.3f}, {s[1]:.3f}, {s[2]:.3f})")
    print()


def print_ray_table(hits):
    """The five rays' section of the tests output, from their Hit."""
    for i, (o, d) in enumerate(TEST_RAYS):
        print(f"Ray {i + 1}:")
        print(f"  Origin: ({o[0]:.3f}, {o[1]:.3f}, {o[2]:.3f})")
        print(f"  Direction: ({d[0]:.3f}, {d[1]:.3f}, {d[2]:.3f})")
        print_ray_result(hits[i])


def test_ray_tracing(context):
    print("Testing ray tracing...")
    origins = np.array([r[0] for r in TEST_RAYS])
    dirs = np.array([r[1] for r in TEST_RAYS])
    print_ray_table(api.bh_trace_rays_batch(context, origins, dirs))


def test_particle_orbits(context):
    print("Testing particle orbit calculation...")
    print()
    print("Calculating velocity for circular orbits at various radii:")
    print("-" * 54)
    print("Radius (M)   |   Orbital Velocity (c)   |   Period (M)")
    print("-" * 54)
    for r in (20.0, 30.0, 40.0, 50.0, 60.0):
        v = api.bh_calculate_orbital_velocity(context, r)
        period = 2.0 * math.pi * r / v
        print(f"{r:10.2f}   |   {v:20.6f}   |   {period:10.2f}")


def test_time_dilation(context):
    print("Testing time dilation...")
    print()
    print("Time dilation ratio vs observer at r=1000 M:")
    print("-" * 44)
    far = (1000.0, 0.0, 0.0)
    for r in (3.0, 5.0, 10.0, 30.0, 100.0):
        ratio = api.bh_calculate_time_dilation(context, (r, 0.0, 0.0), far)
        print(f"  r = {r:7.1f} M : dtau_far/dtau = {ratio:.6f}")


def run_tests(device="cuda"):
    print("Black Hole Physics Engine - Test Program")
    print("-" * 40)
    print()
    major, minor, patch = api.bh_get_version()
    print(f"API Version: {major}.{minor}.{patch}")
    print()
    context = api.bh_initialize(device=device)
    configure_tests(context)

    test_ray_tracing(context)
    print()
    test_particle_orbits(context)
    print()
    test_time_dilation(context)
    print()
    api.bh_shutdown(context)
    print("Tests completed.")


def run_render(args):
    from blackhole_tpu_torch.geom.types import Camera
    from blackhole_tpu_torch.render import image
    from blackhole_tpu_torch.viz import io as viz_io

    context = api.bh_initialize(device=args.device)
    rc = api.bh_configure_black_hole(context, 1.0, args.spin, args.charge)
    if rc != api.BHError.SUCCESS:
        raise SystemExit(
            f"invalid black hole: spin={args.spin} charge={args.charge} "
            "(need (spin*M)^2 + Q^2 <= M^2)"
        )
    api.bh_configure_accretion_disk(context, 6.0, 20.0, 1.0, 1.0)
    api.bh_configure_simulation(context, 0.1, 150.0, args.steps, 1e-6)
    camera = Camera.create(
        position=(0.0, -35.0, 12.0),
        direction=(0.0, 35.0, -12.0),
        up=(0.0, 0.0, 1.0),
        fov_deg=22.0,
        device=args.device,
    )
    scene = context.scene()
    if args.starfield:
        from blackhole_tpu_torch.viz import effects

        scene = dataclasses.replace(
            scene, env_map=effects.starfield_envmap(512, 1024, seed=7,
                                                    device=args.device)
        )
    img = image.render_image(
        scene, camera, width=args.width, height=args.height, spp=args.spp,
    )
    viz_io.write_image(args.out, img.cpu().numpy())
    print(f"wrote {args.out} ({args.width}x{args.height}, spp={args.spp})")


def run_fit(args):
    """Inverse rendering: render a target at the true parameters,
    perturb them, recover them by gradient descent."""
    import torch

    from blackhole_tpu_torch.geom.types import (
        BlackHole, Camera, Disk, Scene, SimConfig,
    )
    from blackhole_tpu_torch.grad import diff_trace, inverse

    dev = dict(device=args.device)
    scene = Scene(
        blackhole=BlackHole.create(args.mass, args.spin, **dev),
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
        **dev,
    )
    print(f"target: mass={args.mass} spin={args.spin}")
    target = diff_trace.render_image_diff(scene, camera, args.size,
                                          args.size)
    bad = dataclasses.replace(
        scene,
        blackhole=BlackHole.create(
            args.mass * 1.2, min(0.95, args.spin + 0.2), **dev
        ),
    )
    print(
        f"start:  mass={float(bad.blackhole.mass):.4f} "
        f"spin={float(bad.blackhole.spin):.4f}"
    )

    def cb(i, params, loss):
        if (i + 1) % 10 == 0:
            m = float(torch.exp(params["log_mass"]))
            s = float(inverse.MAX_SPIN * torch.tanh(params["spin_raw"]))
            print(
                f"  step {i + 1:4d}: loss={float(loss):.3e} "
                f"mass={m:.4f} spin={s:.4f}"
            )

    fitted, _, losses = inverse.fit(
        target, bad, camera, args.size, args.size,
        steps=args.fit_steps, learning_rate=args.lr,
        optimize=("log_mass", "spin_raw"), callback=cb,
    )
    print(
        f"fitted: mass={float(fitted.blackhole.mass):.4f} "
        f"spin={float(fitted.blackhole.spin):.4f} "
        f"(loss {losses[0]:.3e} -> {losses[-1]:.3e})"
    )


def run_view(args):
    """The interactive refining terminal viewer (viz.viewer)."""
    from blackhole_tpu_torch.viz import viewer

    state = viewer.ViewerState(
        mass=args.mass, spin=args.spin, fov=args.fov,
        distance=args.dist, steps=args.steps, device=args.device,
    )
    stats = viewer.run(
        state, width=args.width, height=args.height,
        max_frames=args.frames,
        commands=args.script.split(";") if args.script else None,
        draw=not args.headless,
    )
    if args.headless:
        print(
            f"viewer: {stats['frames']} frames, {stats['resets']} resets, "
            f"tiers {stats['tiers'][:6]}..., "
            f"median fps {sorted(stats['fps'])[len(stats['fps']) // 2]:.2f}"
        )


def run_serve(args):
    """The browser front end (viz.server)."""
    from blackhole_tpu_torch.viz import server, viewer

    state = viewer.ViewerState(
        mass=args.mass, spin=args.spin, fov=args.fov,
        distance=args.dist, steps=args.steps, device=args.device,
    )
    server.serve(
        host=args.host, port=args.port, state=state,
        width=args.width, height=args.height,
    )


def main(argv=None):
    help_device = "torch device to run on (default: cuda)"
    parser = argparse.ArgumentParser(prog="blackhole_tpu_torch",
                                     description=__doc__)
    parser.add_argument("--device", type=str, default="cuda",
                        help=help_device)
    # Given after the command, --device overrides the one before it.
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", type=str, default=argparse.SUPPRESS,
                        help=help_device)
    sub = parser.add_subparsers(dest="cmd")
    sub.add_parser("tests", parents=[device],
                   help="run the test program's tables")
    pv = sub.add_parser("view", parents=[device],
                        help="interactive refining terminal viewer")
    pv.add_argument("--width", type=int, default=128)
    pv.add_argument("--height", type=int, default=72)
    pv.add_argument("--mass", type=float, default=1.0)
    pv.add_argument("--spin", type=float, default=0.5)
    pv.add_argument("--fov", type=float, default=22.0)
    pv.add_argument("--dist", type=float, default=35.0)
    pv.add_argument("--steps", type=int, default=400)
    pv.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: run until quit)")
    pv.add_argument("--script", type=str, default=None,
                    help="';'-separated commands consumed one per frame")
    pv.add_argument("--headless", action="store_true",
                    help="no terminal drawing; print stats at the end")
    pr = sub.add_parser("render", parents=[device], help="render an image")
    pr.add_argument("--width", type=int, default=256)
    pr.add_argument("--height", type=int, default=256)
    pr.add_argument("--spp", type=int, default=1)
    pr.add_argument("--spin", type=float, default=0.0)
    pr.add_argument("--charge", type=float, default=0.0,
                    help="Kerr-Newman charge Q (geometric units)")
    pr.add_argument("--steps", type=int, default=1000)
    pr.add_argument("--starfield", action="store_true",
                    help="lensed starfield env map instead of the "
                         "gradient sky")
    pr.add_argument("--out", type=str, default="render.png")
    ps = sub.add_parser(
        "serve", parents=[device],
        help="interactive browser viewer (progressive PNG streaming and "
             "parameter controls)",
    )
    ps.add_argument("--host", type=str, default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8000)
    ps.add_argument("--width", type=int, default=480)
    ps.add_argument("--height", type=int, default=270)
    ps.add_argument("--mass", type=float, default=1.0)
    ps.add_argument("--spin", type=float, default=0.5)
    ps.add_argument("--fov", type=float, default=22.0)
    ps.add_argument("--dist", type=float, default=35.0)
    ps.add_argument("--steps", type=int, default=400)
    pf = sub.add_parser(
        "fit", parents=[device],
        help="inverse rendering: recover mass/spin from an image"
    )
    pf.add_argument("--mass", type=float, default=1.0)
    pf.add_argument("--spin", type=float, default=0.5)
    pf.add_argument("--size", type=int, default=32)
    pf.add_argument("--steps", type=int, default=300)
    pf.add_argument("--fit-steps", type=int, default=60)
    pf.add_argument("--lr", type=float, default=3e-2)
    args = parser.parse_args(argv)
    if args.cmd in (None, "tests"):
        run_tests(args.device)
    elif args.cmd == "render":
        run_render(args)
    elif args.cmd == "fit":
        run_fit(args)
    elif args.cmd == "view":
        run_view(args)
    elif args.cmd == "serve":
        run_serve(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
