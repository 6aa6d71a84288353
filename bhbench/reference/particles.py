"""The plain reference of the viewer's particle overlay.

A disk pool drawn as the upstream visualizer seeds it (radii spaced for
a uniform surface density from the ISCO out, a random azimuth, a z
jitter of the disk's thickness, Keplerian velocity with 5% turbulence,
T = 10^4 K (r_in / r)^0.75), its uniforms from a torch.Generator seeded
as the viewer seeds its pool; disk particles then take Newtonian Euler
steps under M / r^2; each frame splats the visible particles through
the flat pinhole camera with a blackbody colour faded by distance.
"""

from __future__ import annotations

import math

import torch

from bhbench.reference import geodesic as G

EPS = 1e-9
BRIGHTNESS = 0.8


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def isco(M, chi):
    """Bardeen-Press-Teukolsky prograde ISCO radius."""
    one = torch.ones_like(chi)
    z1 = 1.0 + _cbrt(torch.clamp(1.0 - chi * chi, min=0.0)) * (
        _cbrt(one + chi) + _cbrt(one - chi))
    z2 = torch.sqrt(3.0 * chi * chi + z1 * z1)
    inner = torch.clamp((3.0 - z1) * (3.0 + z1 + 2.0 * z2), min=0.0)
    sign = torch.where(chi >= 0.0, 1.0, -1.0)
    return M * (3.0 + z2 - sign * torch.sqrt(inner))


def disk_pool(n, mass, spin, inner_radius, outer_radius, thickness,
              temperature_scale, device, seed=0):
    """(positions (n, 3), velocities (n, 3), temperatures (n,)) of n
    disk particles drawn from a torch.Generator seeded `seed` on the
    device, in float32."""
    f32 = dict(dtype=torch.float32, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    u_phi = torch.empty((n,), **f32).uniform_(0.0, 1.0, generator=gen)
    u_z = torch.empty((n,), **f32).uniform_(0.0, 1.0, generator=gen)
    u_turb = torch.empty((n, 3), **f32).uniform_(0.0, 1.0, generator=gen)
    M = torch.tensor(mass, **f32)
    inner = torch.maximum(torch.tensor(inner_radius, **f32),
                          isco(M, torch.tensor(spin, **f32)))
    inner = torch.maximum(inner, 1.1 * (2.0 * M))
    outer = torch.tensor(outer_radius, **f32)
    t = torch.linspace(0.0, 1.0, n, **f32)
    r = inner + (outer - inner) * torch.sqrt(t)
    phi = u_phi * (2.0 * math.pi)
    z = (u_z - 0.5) * torch.tensor(thickness, **f32) * r
    pos = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    v = torch.sqrt(M / r)
    vel = torch.stack([-pos[:, 1] * v / r, pos[:, 0] * v / r,
                       torch.zeros_like(r)], dim=-1)
    vel = vel + (u_turb - 0.5) * (0.05 * v)[:, None]
    temp = torch.tensor(temperature_scale, **f32) * 10000.0 * (
        inner / r) ** 0.75
    return pos, vel, temp


def newton_steps(pos, vel, mass, dt, steps):
    """`steps` Euler steps of disk particles under M / r^2; those that
    come within r_s go inactive.  Returns (positions, active)."""
    f32 = dict(dtype=pos.dtype, device=pos.device)
    M = torch.tensor(mass, **f32)
    dt = torch.tensor(dt, **f32)
    active = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    for _ in range(steps):
        r = torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
        accel = -M * pos / torch.clamp(r, min=EPS) ** 3
        new_vel = vel + dt * accel
        new_pos = pos + dt * new_vel
        pos = torch.where(active[:, None], new_pos, pos)
        vel = torch.where(active[:, None], new_vel, vel)
        active = active & ~(torch.linalg.vector_norm(pos, dim=-1)
                            <= 2.0 * M)
    return pos, active


def splat(pos, temp, active, camera: dict, width: int, height: int):
    """(rows, cols, colours (m, 3)) the visible particles add to a
    width x height frame."""
    f32 = dict(dtype=torch.float32, device=pos.device)
    cpos = torch.tensor(camera["position"], **f32)
    fwd = G._normalize(torch.tensor(camera["direction"], **f32))
    right = G._normalize(torch.linalg.cross(
        fwd, torch.tensor(camera["up"], **f32)))
    up = torch.linalg.cross(right, fwd)
    rel = pos - cpos
    z, x, y = rel @ fwd, rel @ right, rel @ up
    plane_h = 2.0 * torch.tan(0.5 * (torch.tensor(camera["fov_deg"], **f32)
                                     * (math.pi / 180.0)))
    plane_w = plane_h * (width / height)
    zs = torch.clamp(z, min=1e-3)
    px = ((x / zs / (0.5 * plane_w) + 1.0) * 0.5 * width).to(torch.int32)
    py = ((1.0 - y / zs / (0.5 * plane_h)) * 0.5 * height).to(torch.int32)
    vis = (active & (z > 0.1) & (px >= 0) & (px < width) & (py >= 0)
           & (py < height))
    rgb = torch.stack(G._temperature_rgb(torch.clamp(temp, min=1.0)), -1)
    rgb = torch.where((temp > 0.0)[:, None], rgb, torch.ones_like(rgb))
    col = rgb * (BRIGHTNESS / (1.0 + 0.001 * zs * zs))[:, None]
    return py[vis].long(), px[vis].long(), col[vis]
