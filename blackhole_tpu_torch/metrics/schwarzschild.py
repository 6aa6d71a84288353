"""Schwarzschild metric, the analytic special case kept as a test oracle.

PyTorch counterpart of blackhole_tpu.metrics.schwarzschild (with the
full r^2 sin^2(theta) for g_phph off the equator).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SchwarzschildMetric(NamedTuple):
    g_tt: torch.Tensor
    g_rr: torch.Tensor
    g_thth: torch.Tensor
    g_phph: torch.Tensor


def metric(r, theta, M):
    """Diagonal Schwarzschild components at (r, theta)."""
    rs = 2.0 * M
    f = 1.0 - rs / r
    st = torch.sin(theta)
    return SchwarzschildMetric(
        g_tt=-f,
        g_rr=1.0 / f,
        g_thth=r * r,
        g_phph=r * r * st * st,
    )


def metric_equatorial(r, M):
    """Equatorial-plane components (theta = pi/2)."""
    rs = 2.0 * M
    f = 1.0 - rs / r
    return SchwarzschildMetric(
        g_tt=-f, g_rr=1.0 / f, g_thth=r * r, g_phph=r * r
    )
