"""Scene records: black hole, accretion disk, camera, simulation config.

PyTorch counterpart of blackhole_tpu.geom.types.  Each record is a
frozen dataclass: numeric fields are 0-d (or (3,)) tensors on one
device, static fields (the ones the JAX package marks
pytree_node=False) are plain Python values.  Derived quantities
(a, r_plus) are computed from the primaries, as in the JAX package.

Records are made on the card unless the caller asks for another device
(device="cpu" for a CPU run); without a GPU a record made without a
device raises, through torch's own error, instead of quietly landing
on the CPU.

scene_from_reference / camera_from_reference carry a scene from any
object with the JAX dataclasses' attribute names into this package, and
params_from_reference a dict of arrays (such as the JAX package's
grad.inverse.pack_params gives) into tensors, reading each leaf
through numpy (so they never import jax).

The records are registered as pytrees (torch.utils._pytree): their
tensor fields are the leaves, their static fields the context.  So a
Scene is a valid primal of torch.func.jvp, and a Scene whose leaves
are tangents is its tangent, as a JAX Scene is under jax.jvp.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

Tensor = torch.Tensor


class RayResult:
    """Ray trace outcome codes."""

    HORIZON = 0
    DISK = 1
    BACKGROUND = 2
    MAX_DISTANCE = 3
    MAX_STEPS = 4
    ERROR = 5


class Integrator:
    """Integration methods (the kernel implements RK4 and RKF45)."""

    RK4 = "rk4"
    RKF45 = "rkf45"
    LEAPFROG = "leapfrog"
    YOSHIDA = "yoshida"


class Jitter:
    """Sub-pixel jitter methods."""

    NONE = "none"
    REGULAR_GRID = "grid"
    RANDOM = "random"
    HALTON = "halton"
    BLUE_NOISE = "blue_noise"


def _scalar(v, device, dtype=torch.float32) -> Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class BlackHole:
    """mass M (geometric units), dimensionless spin a/M, charge Q."""

    mass: Tensor
    spin: Tensor
    charge: Tensor

    @classmethod
    def create(cls, mass=1.0, spin=0.0, charge=0.0, device="cuda",
               dtype=torch.float32):
        return cls(_scalar(mass, device, dtype), _scalar(spin, device, dtype),
                   _scalar(charge, device, dtype))

    @property
    def a(self) -> Tensor:
        """Spin in length units: a = spin * M."""
        return self.spin * self.mass

    @property
    def schwarzschild_radius(self) -> Tensor:
        return 2.0 * self.mass

    @property
    def r_plus(self) -> Tensor:
        """Outer horizon M + sqrt(M^2 - a^2 - Q^2)."""
        a = self.a
        disc = torch.clamp(self.mass**2 - a**2 - self.charge**2, min=0.0)
        return self.mass + torch.sqrt(disc)

    @property
    def r_minus(self) -> Tensor:
        """Inner horizon M - sqrt(M^2 - a^2 - Q^2); 0 for Schwarzschild."""
        a = self.a
        disc = torch.clamp(self.mass**2 - a**2 - self.charge**2, min=0.0)
        return torch.where((self.spin == 0.0) & (self.charge == 0.0),
                           torch.zeros_like(self.mass),
                           self.mass - torch.sqrt(disc))

    @property
    def ergosphere_radius(self) -> Tensor:
        """Equatorial ergosphere radius (2M)."""
        return 2.0 * self.mass


@dataclasses.dataclass(frozen=True)
class Disk:
    """Thin accretion disk; inclination rotates its plane about x."""

    inner_radius: Tensor
    outer_radius: Tensor
    temperature_scale: Tensor
    density_scale: Tensor
    thickness_factor: Tensor
    alpha_viscosity: Tensor
    inclination: Tensor

    @classmethod
    def create(cls, inner_radius=6.0, outer_radius=20.0,
               temperature_scale=1.0, density_scale=1.0,
               thickness_factor=0.05, alpha_viscosity=0.1, inclination=0.0,
               device="cuda", dtype=torch.float32):
        vals = (inner_radius, outer_radius, temperature_scale, density_scale,
                thickness_factor, alpha_viscosity, inclination)
        return cls(*(_scalar(v, device, dtype) for v in vals))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera; fov_deg is the vertical field of view."""

    position: Tensor
    direction: Tensor
    up: Tensor
    fov_deg: Tensor

    @classmethod
    def create(cls, position=(0.0, 0.0, 75.0), direction=(0.0, 0.0, -1.0),
               up=(0.0, 1.0, 0.0), fov_deg=40.0, device="cuda",
               dtype=torch.float32):
        return cls(_scalar(position, device, dtype),
                   _scalar(direction, device, dtype),
                   _scalar(up, device, dtype), _scalar(fov_deg, device, dtype))


_KINEMATICS = ("auto", "compat", "kerr")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Numerical integration configuration.

    time_step, max_ray_distance and tolerance are tensors; the rest are
    static Python values that select code paths.  disk_kinematics:
    "auto" (exact Kerr circular-orbit g-factor where valid, compat
    factors otherwise), "compat" (flat-space Keplerian factors) or
    "kerr" (like auto, but warns when an inclined disk forces the
    fallback)."""

    time_step: Tensor
    max_ray_distance: Tensor
    tolerance: Tensor
    max_steps: int = 1000
    integrator: str = Integrator.RK4
    enable_doppler: bool = True
    enable_redshift: bool = True
    enable_beaming: bool = True
    show_disk: bool = True
    shadow_softness: float = 0.0
    disk_kinematics: str = "auto"

    def __post_init__(self):
        if self.disk_kinematics not in _KINEMATICS:
            raise ValueError(
                f"disk_kinematics must be 'auto', 'compat' or 'kerr', "
                f"got {self.disk_kinematics!r}"
            )

    @classmethod
    def create(cls, time_step=0.1, max_ray_distance=100.0, tolerance=1e-6,
               max_steps=1000, integrator=Integrator.RK4,
               enable_doppler=True, enable_redshift=True,
               enable_beaming=True, show_disk=True, shadow_softness=0.0,
               disk_kinematics="auto", device="cuda", dtype=torch.float32):
        return cls(
            time_step=_scalar(time_step, device, dtype),
            max_ray_distance=_scalar(max_ray_distance, device, dtype),
            tolerance=_scalar(tolerance, device, dtype),
            max_steps=int(max_steps),
            integrator=integrator,
            enable_doppler=bool(enable_doppler),
            enable_redshift=bool(enable_redshift),
            enable_beaming=bool(enable_beaming),
            show_disk=bool(show_disk),
            shadow_softness=float(shadow_softness),
            disk_kinematics=str(disk_kinematics),
        )


@dataclasses.dataclass(frozen=True)
class Scene:
    """Black hole + disk + config; env_map: optional (H, W, 3) equirect
    sky panorama sampled by escaped rays."""

    blackhole: BlackHole
    disk: Disk
    config: SimConfig
    disk_enabled: bool = True
    env_map: Any = None


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray trace result; every field shares the leading batch shape."""

    result: Tensor  # int32 RayResult code
    position: Tensor  # (..., 3) cartesian hit / termination position
    distance: Tensor  # cartesian chord-sum path length
    steps: Tensor  # int32 integration steps taken
    time_dilation: Tensor  # 1/sqrt(1 - rs/r) at termination
    sky_direction: Tensor  # (..., 3) unit direction of the last chord
    doppler: Tensor  # doppler factor at disk hit (1 elsewhere)
    temperature: Tensor  # disk temperature at hit (0 elsewhere)
    redshift: Tensor  # gravitational redshift factor at hit
    color: Tensor  # (..., 3) shaded RGB
    optical_depth: Tensor  # slant optical depth at the crossing
    min_r: Tensor  # closest Boyer-Lindquist radial approach

    def map(self, fn) -> "Hit":
        """A Hit with fn applied to every field."""
        return Hit(*(fn(getattr(self, f.name))
                     for f in dataclasses.fields(self)))

    def __getitem__(self, idx) -> "Hit":
        """Every field indexed by idx along the batch dims."""
        return self.map(lambda x: x[idx])


# --- state carry from the JAX package -----------------------------------


def _leaf(x, device, dtype=torch.float32) -> Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _record(cls, ref, device, dtype):
    return cls(*(_leaf(getattr(ref, f.name), device, dtype)
                 for f in dataclasses.fields(cls)))


def camera_from_reference(camera_like, device="cuda",
                          dtype=torch.float32) -> Camera:
    """Camera from any object with Camera's attribute names."""
    return _record(Camera, camera_like, device, dtype)


def params_from_reference(params_like, device="cuda",
                          dtype=torch.float32) -> dict:
    """A parameter dict (name -> array, such as the JAX package's
    pack_params gives) as tensors."""
    return {k: _leaf(v, device, dtype) for k, v in params_like.items()}


def scene_from_reference(scene_like, device="cuda",
                         dtype=torch.float32) -> Scene:
    """Scene from any object with the JAX Scene's attribute names
    (blackhole, disk, config, disk_enabled, env_map); the environment
    map stays float32."""
    cfg = scene_like.config
    config = SimConfig(
        time_step=_leaf(cfg.time_step, device, dtype),
        max_ray_distance=_leaf(cfg.max_ray_distance, device, dtype),
        tolerance=_leaf(cfg.tolerance, device, dtype),
        max_steps=int(cfg.max_steps),
        integrator=str(cfg.integrator),
        enable_doppler=bool(cfg.enable_doppler),
        enable_redshift=bool(cfg.enable_redshift),
        enable_beaming=bool(cfg.enable_beaming),
        show_disk=bool(cfg.show_disk),
        shadow_softness=float(cfg.shadow_softness),
        disk_kinematics=str(cfg.disk_kinematics),
    )
    env = getattr(scene_like, "env_map", None)
    return Scene(
        blackhole=_record(BlackHole, scene_like.blackhole, device, dtype),
        disk=_record(Disk, scene_like.disk, device, dtype),
        config=config,
        disk_enabled=bool(scene_like.disk_enabled),
        env_map=None if env is None else _leaf(env, device),
    )


# --- pytree registration -------------------------------------------------


def _register(cls, static=()):
    """Register a frozen dataclass: fields named in `static` go to the
    context, every other field is a child (a field that is None, such as
    a Scene without env_map, is left out of the children and marked in
    the context: torch.func.jvp takes tensors only)."""
    names = [f.name for f in dataclasses.fields(cls)]
    children = [n for n in names if n not in static]

    def flatten(obj):
        present = tuple(getattr(obj, n) is not None for n in children)
        values = [getattr(obj, n) for n, p in zip(children, present) if p]
        return values, (present,) + tuple(getattr(obj, n) for n in static)

    def unflatten(values, context):
        present, statics = context[0], context[1:]
        it = iter(values)
        kids = {n: next(it) if p else None for n, p in zip(children, present)}
        return cls(**kids, **dict(zip(static, statics)))

    pytree.register_pytree_node(
        cls, flatten, unflatten,
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}",
    )


for _cls in (BlackHole, Disk, Camera, Hit):
    _register(_cls)
_register(SimConfig, static=(
    "max_steps", "integrator", "enable_doppler", "enable_redshift",
    "enable_beaming", "show_disk", "shadow_softness", "disk_kinematics",
))
_register(Scene, static=("disk_enabled",))
