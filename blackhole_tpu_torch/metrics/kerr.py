"""Kerr-Newman metric in Boyer-Lindquist coordinates.

PyTorch counterpart of blackhole_tpu.metrics.kerr.
Component convention (t, r, theta, phi); nonzero entries g_tt, g_tphi,
g_rr, g_thth, g_phph.  tm = 2 M r - Q^2 replaces every 2 M r mass term.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from blackhole_tpu_torch.constants import EPSILON
from blackhole_tpu_torch.tangent_rules import jmax


class Metric(NamedTuple):
    """Nonzero Kerr metric components (covariant)."""

    g_tt: torch.Tensor
    g_tphi: torch.Tensor
    g_rr: torch.Tensor
    g_thth: torch.Tensor
    g_phph: torch.Tensor


class InverseMetric(NamedTuple):
    """Nonzero Kerr metric components (contravariant)."""

    g_tt: torch.Tensor
    g_tphi: torch.Tensor
    g_rr: torch.Tensor
    g_thth: torch.Tensor
    g_phph: torch.Tensor


def sigma_delta(r, theta, M, a, Q=0.0):
    """Sigma = r^2 + a^2 cos^2(theta), Delta = r^2 - 2 M r + a^2 + Q^2."""
    ct = torch.cos(theta)
    sigma = r * r + a * a * ct * ct
    delta = r * r - 2.0 * M * r + a * a + Q * Q
    return sigma, delta


def metric(r, theta, M, a, Q=0.0):
    """Covariant Kerr-Newman metric components."""
    st = torch.sin(theta)
    st2 = st * st
    sigma, delta = sigma_delta(r, theta, M, a, Q)
    tm = 2.0 * M * r - Q * Q
    g_tt = -(1.0 - tm / sigma)
    g_tphi = -tm * a * st2 / sigma
    g_rr = sigma / delta
    g_thth = sigma
    g_phph = (r * r + a * a + tm * a * a * st2 / sigma) * st2
    return Metric(g_tt, g_tphi, g_rr, g_thth, g_phph)


def inverse_metric(r, theta, M, a, Q=0.0):
    """Contravariant Kerr-Newman metric components:
    g^tt = -A / (Sigma Delta), A = (r^2+a^2)^2 - Delta a^2 sin^2;
    g^tphi = -tm a / (Sigma Delta); g^rr = Delta / Sigma;
    g^thth = 1 / Sigma; g^phph = (Delta - a^2 sin^2) / (Sigma Delta sin^2)."""
    st = torch.sin(theta)
    st2 = st * st
    sigma, delta = sigma_delta(r, theta, M, a, Q)
    r2a2 = r * r + a * a
    A = r2a2 * r2a2 - delta * a * a * st2
    inv_sd = 1.0 / (sigma * delta)
    g_tt = -A * inv_sd
    g_tphi = -(2.0 * M * r - Q * Q) * a * inv_sd
    g_rr = delta / sigma
    g_thth = 1.0 / sigma
    st2_safe = jmax(st2, EPSILON)
    g_phph = (delta - a * a * st2) * inv_sd / st2_safe
    return InverseMetric(g_tt, g_tphi, g_rr, g_thth, g_phph)


def _matrix(g):
    """(..., 4, 4) matrix of the five nonzero components."""
    zeros = torch.zeros_like(g.g_tt)
    return torch.stack([
        torch.stack([g.g_tt, zeros, zeros, g.g_tphi], dim=-1),
        torch.stack([zeros, g.g_rr, zeros, zeros], dim=-1),
        torch.stack([zeros, zeros, g.g_thth, zeros], dim=-1),
        torch.stack([g.g_tphi, zeros, zeros, g.g_phph], dim=-1),
    ], dim=-2)


def metric_matrix(r, theta, M, a, Q=0.0):
    """Full covariant metric as a (..., 4, 4) tensor."""
    return _matrix(metric(r, theta, M, a, Q))


def inverse_metric_matrix(r, theta, M, a, Q=0.0):
    """Full contravariant metric as a (..., 4, 4) tensor."""
    return _matrix(inverse_metric(r, theta, M, a, Q))
