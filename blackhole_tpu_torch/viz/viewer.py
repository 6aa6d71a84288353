"""Interactive terminal viewer: the live front end.

PyTorch counterpart of blackhole_tpu.viz.viewer.  A refining render
that takes live parameter changes, drawn as ANSI truecolor half-blocks
(so it runs over ssh and in CI alike):

* the progressive quality ladder 1/32 -> 1/2 resolution with rising
  step budgets (viz.animate.QUALITY_LADDER), then full-resolution
  temporal accumulation with Halton jitter (capped at 32 frames,
  blend 0.1);
* a stdin command language (`spin 0.9`, `mass 1.2`, `fov 30`,
  `az +10`, ...), applied between frames; any change restarts the
  ladder and the accumulation;
* a status bar (shadow radius, ISCO, FPS, tier);
* an optional live particle overlay (a disk-particle pool stepped every
  frame and splatted over it).

Every frame renders on the state's device (the card unless
ViewerState is given another): the tiers through image.render_image,
the accumulation frames through image.trace_rays_fast, so each frame
launches K1 on the card.

Run: python -m blackhole_tpu_torch.cli view --spin 0.9
Scripted/headless operation (tests, demos): pass `commands` and
`max_frames`, and `draw=False` to suppress terminal output.
"""

from __future__ import annotations

import select
import sys
import time

import numpy as np
import torch

from blackhole_tpu_torch.geom.types import BlackHole, Disk, Scene, SimConfig
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.render import camera as cam_mod
from blackhole_tpu_torch.render import image as image_mod
from blackhole_tpu_torch.viz import animate

HELP = """commands:
  mass <v> | spin <v> | charge <v>   set black hole parameter
  fov <v>                            set field of view
  dist <v> | el <v> | az <v>         orbit camera (+d/-d relative,
                                     =v absolute, bare v absolute)
  steps <n>                          integration budget
  disk on|off                        toggle accretion disk
  sky on|off                         lensed starfield background
  particles on|off                   live disk-particle overlay
  save <path.png>                    write current frame
  help | quit
"""


class ViewerState:
    """Mutable parameter set, reconfigured live by apply(); scene() and
    camera() build records on `device`."""

    def __init__(self, mass=1.0, spin=0.5, fov=22.0, distance=35.0,
                 elevation=18.0, azimuth=0.0, steps=400, disk=True,
                 particles=False, n_particles=600, charge=0.0,
                 sky=False, device="cuda"):
        self.mass = mass
        self.spin = spin
        self.charge = charge
        self.sky = sky
        self._env = None
        self.fov = fov
        self.distance = distance
        self.elevation = elevation
        self.azimuth = azimuth
        self.steps = steps
        self.disk = disk
        self.particles = particles
        self.n_particles = n_particles
        self.device = device

    def scene(self) -> Scene:
        dev = dict(device=self.device)
        if self.sky and self._env is None:
            from blackhole_tpu_torch.viz import effects

            self._env = effects.starfield_envmap(256, 512, seed=7, **dev)
        return Scene(
            blackhole=BlackHole.create(self.mass, self.spin, self.charge,
                                       **dev),
            disk=Disk.create(6.0 * self.mass, 20.0 * self.mass, **dev),
            config=SimConfig.create(
                time_step=0.1,
                max_ray_distance=5.0 * self.distance,
                max_steps=self.steps,
                **dev,
            ),
            disk_enabled=self.disk,
            env_map=self._env if self.sky else None,
        )

    def camera(self):
        return animate.orbit_camera(
            self.distance, self.elevation, self.azimuth, self.fov,
            device=self.device,
        )

    def apply(self, line: str) -> str:
        """Apply one command; returns 'changed'/'quit'/'noop'/an error."""
        parts = line.strip().split()
        if not parts:
            return "noop"
        cmd = parts[0].lower()
        if cmd in ("quit", "exit", "q"):
            return "quit"
        if cmd == "help":
            return "help"
        if cmd == "save" and len(parts) == 2:
            return f"save:{parts[1]}"
        if cmd == "disk" and len(parts) == 2:
            self.disk = parts[1].lower() in ("on", "1", "true")
            return "changed"
        if cmd == "particles" and len(parts) == 2:
            self.particles = parts[1].lower() in ("on", "1", "true")
            return "changed"
        if cmd == "sky" and len(parts) == 2:
            self.sky = parts[1].lower() in ("on", "1", "true")
            return "changed"
        if len(parts) != 2:
            return f"error: bad command {line!r} (try: help)"
        try:
            # "=v" forces ABSOLUTE for az/el/dist (whose bare +/- means
            # a relative nudge): without it a negative absolute such as
            # "el -10" could not be said.
            raw = parts[1]
            absolute = raw.startswith("=")
            if absolute:
                raw = raw[1:]
            rel = (not absolute) and raw[:1] in ("+", "-") \
                and cmd in ("az", "el", "dist")
            v = float(raw)
        except ValueError:
            return f"error: bad value {parts[1]!r}"
        if cmd == "mass" and v > 0:
            self.mass = v
        elif cmd == "spin" and 0.0 <= v <= 0.998:
            self.spin = v
        elif cmd == "charge":
            # Sub-extremality: (spin*M)^2 + Q^2 <= M^2.
            if (self.spin**2 + (v / max(self.mass, 1e-9)) ** 2) > 0.999:
                return f"error: charge {v} super-extremal at spin {self.spin}"
            self.charge = v
        elif cmd == "fov" and 1.0 <= v <= 120.0:
            self.fov = v
        elif cmd == "dist":
            self.distance = self.distance + v if rel else v
            self.distance = max(5.0, self.distance)
        elif cmd == "el":
            self.elevation = (self.elevation + v) if rel else v
        elif cmd == "az":
            self.azimuth = (self.azimuth + v) if rel else v
        elif cmd == "steps" and v >= 20:
            self.steps = int(v)
        else:
            return f"error: bad command {line!r} (try: help)"
        return "changed"


def radii(mass: float, spin: float) -> tuple[float, float]:
    """(shadow radius, ISCO radius) in M for the status line: float64
    host arithmetic, touching no device."""
    m = torch.tensor(float(mass), dtype=torch.float64)
    a = torch.tensor(float(spin), dtype=torch.float64)
    return (float(derived.shadow_radius(m, a)),
            float(derived.isco_radius(m, a)))


def accumulation_frame(scene: Scene, camera, width: int, height: int,
                       jitter_idx: int, accum_frames: int):
    """One full-resolution frame at the jitter_idx-th Halton offset of
    accum_frames, traced in raster order by image.trace_rays_fast."""
    ox, oy = cam_mod.jitter_offsets(jitter_idx, accum_frames)
    origins, dirs = cam_mod.generate_rays(camera, width, height, ox, oy)
    hit = image_mod.trace_rays_fast(
        origins.reshape(-1, 3), dirs.reshape(-1, 3), scene
    )
    return hit.color.reshape(height, width, 3)


def seed_particles(n: int, scene: Scene):
    """The overlay's pool: n disk particles drawn from a torch.Generator
    seeded 0 on the scene's device (the JAX package draws from
    PRNGKey(0): the draws differ, the transform is the same)."""
    from blackhole_tpu_torch.particles import generators
    from blackhole_tpu_torch.particles import system as psys_mod

    device = scene.blackhole.mass.device
    system = psys_mod.ParticleSystem.create(n, device=device)
    system, _ = generators.create_accretion_disk(
        system, torch.Generator(device).manual_seed(0), n,
        scene.blackhole, scene.disk,
    )
    return system


def overlay_particles(frame, psystem, scene: Scene, camera,
                      n_particles: int):
    """Seed the pool on first use (seed_particles), step it once and
    splat it over the frame.  Returns (frame, pool)."""
    from blackhole_tpu_torch.particles import dynamics
    from blackhole_tpu_torch.viz import effects

    if psystem is None:
        psystem = seed_particles(n_particles, scene)
    psystem = dynamics.update_particles(psystem, scene.blackhole,
                                        scene.config)
    frame = effects.particle_overlay(
        frame, psystem.position, psystem.temperature, psystem.active, camera,
    )
    return frame, psystem


def ansi_frame(img: np.ndarray) -> str:
    """Encode an (H, W, 3) float image as ANSI truecolor half-blocks.

    Each character cell shows two vertical pixels ('▀' with fg = upper
    row, bg = lower row)."""
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    h = u8.shape[0] - (u8.shape[0] % 2)
    rows = []
    for y in range(0, h, 2):
        top, bot = u8[y], u8[y + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
            f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def _poll_stdin(timeout=0.0):
    """Non-blocking line read from stdin; None when nothing is pending."""
    try:
        r, _, _ = select.select([sys.stdin], [], [], timeout)
    except (OSError, ValueError):
        return None
    if r:
        line = sys.stdin.readline()
        return line if line else None
    return None


def run(
    state: ViewerState | None = None,
    width: int = 128,
    height: int = 72,
    max_frames: int | None = None,
    commands=None,
    draw: bool = True,
    accum_frames: int = 32,
    out=sys.stdout,
):
    """The frame loop.

    commands: optional iterable of scripted command strings, consumed one
    per frame *instead of* stdin (headless/test mode).  max_frames stops
    the loop after N rendered frames (None = run until 'quit'/EOF).
    Returns a stats dict (frames rendered, resets, tiers, fps history).
    """
    state = state or ViewerState()
    script = iter(commands) if commands is not None else None
    stats = {"frames": 0, "resets": 0, "tiers": [], "fps": []}

    ladder = iter(animate.QUALITY_LADDER)
    history = None
    accum_idx = 0
    jitter_idx = 0
    psystem = None  # the particle pool, made on first use
    status = "viewer ready (type: help)"

    while max_frames is None or stats["frames"] < max_frames:
        t0 = time.perf_counter()
        scene = state.scene()
        camera = state.camera()

        tier = next(ladder, None)
        if tier is not None:
            divisor, steps = tier
            frame = animate.tier_frame(scene, camera, width, height, divisor,
                                        steps)
            history = None
            tier_label = f"1/{divisor}"
        else:
            new = accumulation_frame(scene, camera, width, height,
                                     jitter_idx, accum_frames)
            jitter_idx += 1
            if history is None:
                history, accum_idx = new, 1
            else:
                history, _ = image_mod.temporal_accumulate(
                    history, new, accum_idx, max_frames=accum_frames,
                )
                # temporal_accumulate's index, kept on the host.
                accum_idx = min(accum_idx + 1, accum_frames)
            frame = history
            tier_label = f"full+{accum_idx}"

        if state.particles:
            frame, psystem = overlay_particles(frame, psystem, scene, camera,
                                               state.n_particles)
        else:
            psystem = None
        frame_np = frame.cpu().numpy()

        dt = time.perf_counter() - t0
        stats["frames"] += 1
        stats["tiers"].append(tier_label)
        stats["fps"].append(1.0 / max(dt, 1e-9))

        if draw:
            shadow, isco = radii(state.mass, state.spin)
            out.write("\x1b[H\x1b[2J")  # clear
            out.write(ansi_frame(frame_np) + "\n")
            out.write(
                f" M={state.mass:.2f} a={state.spin:.3f} "
                f"fov={state.fov:.0f} dist={state.distance:.0f} "
                f"| shadow={shadow:.2f}M isco={isco:.2f}M "
                f"| tier={tier_label} {1.0 / max(dt, 1e-9):5.1f} fps\n"
            )
            out.write(f" {status}\n> ")
            out.flush()

        # --- live parameter input ---
        if script is not None:
            line = next(script, None)
            if line is None and commands is not None and max_frames is None:
                break
        else:
            line = _poll_stdin(0.0 if tier is not None else 0.05)
        if line is None:
            continue
        action = state.apply(line)
        if action == "quit":
            break
        if action == "help":
            status = HELP if draw else "help"
            continue
        if action.startswith("save:"):
            from blackhole_tpu_torch.viz import io as viz_io

            path = action[5:]
            viz_io.write_image(path, frame_np)
            status = f"wrote {path}"
            continue
        if action == "changed":
            # Restart the progressive ladder and the accumulation.
            ladder = iter(animate.QUALITY_LADDER)
            history = None
            accum_idx = 0
            jitter_idx = 0
            stats["resets"] += 1
            status = "parameters updated; restarting refinement"
        elif action.startswith("error"):
            status = action
    return stats
