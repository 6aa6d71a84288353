"""A configuration file as the program's records and as the reference's.

Both sides read the same numbers from the configuration; neither takes
anything the other made.
"""

from __future__ import annotations

import dataclasses
import math

from bhbench.reference import geodesic as G


def port_scene(cfg: dict, device, mass=None, spin=None):
    """The program's Scene of a bench configuration (mass and spin may
    be tensors, as a fit's parameters are)."""
    from blackhole_tpu_torch.geom.types import (BlackHole, Disk, Scene,
                                                SimConfig)

    bh, dk, sim = cfg["black_hole"], cfg["disk"], cfg["sim"]
    scene = Scene(
        BlackHole.create(bh["mass"], bh["spin"], bh["charge"], device=device),
        Disk.create(dk["inner_radius"], dk["outer_radius"],
                    dk["temperature_scale"], dk["density_scale"],
                    inclination=dk["inclination"], device=device),
        SimConfig.create(time_step=sim["time_step"],
                         max_ray_distance=sim["max_ray_distance"],
                         tolerance=sim["tolerance"],
                         max_steps=sim["max_steps"],
                         integrator=sim["integrator"],
                         shadow_softness=sim["shadow_softness"],
                         device=device),
        disk_enabled=cfg["disk_enabled"],
    )
    if mass is None and spin is None:
        return scene
    return with_mass_spin(scene, mass, spin)


def with_mass_spin(scene, mass, spin):
    return dataclasses.replace(scene, blackhole=dataclasses.replace(
        scene.blackhole, mass=mass, spin=spin))


def port_camera(cam: dict, device, position=None):
    from blackhole_tpu_torch.geom.types import Camera

    pos = tuple(position) if position is not None else tuple(cam["position"])
    direction = tuple(-p for p in pos) if position is not None else tuple(
        cam["direction"])
    return Camera.create(position=pos, direction=direction,
                         up=tuple(cam["up"]), fov_deg=cam["fov_deg"],
                         device=device)


def ref_scene(cfg: dict, mass=None, spin=None) -> G.RefScene:
    """The reference's scene of a bench configuration."""
    bh, dk, sim = cfg["black_hole"], cfg["disk"], cfg["sim"]
    if sim["integrator"] != "rk4" or sim["shadow_softness"] != 0.0:
        raise ValueError("the reference integrates RK4 with a hard shadow")
    return G.RefScene(
        mass=bh["mass"] if mass is None else mass,
        spin=bh["spin"] if spin is None else spin,
        charge=bh["charge"], disk_inner=dk["inner_radius"],
        disk_outer=dk["outer_radius"],
        temperature_scale=dk["temperature_scale"],
        inclination=dk["inclination"],
        time_step=sim["time_step"],
        max_ray_distance=sim["max_ray_distance"],
        max_steps=sim["max_steps"], disk_on=cfg["disk_enabled"])


def orbit(cam: dict, azimuth_deg: float):
    """The configuration camera's distance and elevation at another
    azimuth: its position (looking at the origin)."""
    x, y, z = cam["position"]
    dist = math.sqrt(x * x + y * y + z * z)
    el = math.degrees(math.asin(z / dist))
    return G.orbit_position(dist, el, azimuth_deg)


def ref_camera(cam: dict, position=None) -> dict:
    if position is None:
        return dict(cam)
    return dict(cam, position=tuple(position),
                direction=tuple(-p for p in position))
