"""Keplerian orbital mechanics for test particles.

PyTorch counterpart of blackhole_tpu.particles.orbits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from blackhole_tpu_torch.constants import EPSILON
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.tangent_rules import jabs, jclip, jmax


class OrbitalParams(NamedTuple):
    """Orbital elements."""

    semi_major_axis: torch.Tensor
    eccentricity: torch.Tensor
    inclination: torch.Tensor
    specific_angular_momentum: torch.Tensor
    specific_energy: torch.Tensor


def orbit_parameters(position, velocity, M) -> OrbitalParams:
    """Keplerian elements from a state vector, batched over the leading
    dims of position and velocity (..., 3).  The semi-major axis is
    -M/2E when bound, M/2E when unbound and inf when parabolic."""
    r = torch.linalg.vector_norm(position, dim=-1)
    v = torch.linalg.vector_norm(velocity, dim=-1)
    l_vec = torch.linalg.cross(position, velocity, dim=-1)
    L = torch.linalg.vector_norm(l_vec, dim=-1)
    safe_r = jmax(r, EPSILON)
    E = 0.5 * v * v - M / safe_r

    r_hat = position / safe_r[..., None]
    term1 = r_hat * (v * v - M / safe_r)[..., None]
    r_dot_v = (position * velocity).sum(dim=-1)
    term2 = velocity * r_dot_v[..., None]
    e_vec = (term1 - term2) / M
    e = torch.linalg.vector_norm(e_vec, dim=-1)

    a = torch.where(
        jabs(E) < EPSILON,
        math.inf,
        torch.where(E < 0, -M / (2.0 * E), M / (2.0 * E)),
    )
    cos_i = l_vec[..., 2] / jmax(L, EPSILON)
    inclination = torch.arccos(jclip(cos_i, -1.0, 1.0))
    return OrbitalParams(a, e, inclination, L, E)


def circular_orbit_velocity(r, blackhole):
    """Tangential velocity of a circular orbit at radius r on the +x
    axis.  Returns (velocity, exists): exists is False inside the ISCO."""
    isco = derived.isco_radius(blackhole.mass, blackhole.spin)
    v = torch.sqrt(blackhole.mass / jmax(r, EPSILON))
    zero = torch.zeros_like(v)
    return torch.stack([zero, v, zero], dim=-1), r > isco


def orbital_period(r, M):
    """Newtonian period 2 pi r / v = 2 pi sqrt(r^3 / M)."""
    v = torch.sqrt(M / jmax(r, EPSILON))
    return 2.0 * math.pi * r / v
