"""Kerr-Newman metric in Boyer-Lindquist coordinates (covariant part).

PyTorch counterpart of blackhole_tpu.metrics.kerr.metric/sigma_delta.
Component convention (t, r, theta, phi); nonzero entries g_tt, g_tphi,
g_rr, g_thth, g_phph.  tm = 2 M r - Q^2 replaces every 2 M r mass term.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Metric(NamedTuple):
    """Nonzero Kerr metric components (covariant)."""

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
