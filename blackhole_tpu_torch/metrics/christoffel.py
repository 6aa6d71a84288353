"""Christoffel symbols and the covariant geodesic right-hand side.

PyTorch counterpart of blackhole_tpu.metrics.christoffel.  The complete
symbol set of the stationary axisymmetric Kerr-Newman metric comes from
forward-mode autodiff of the metric matrix (torch.func.jacfwd):

    Gamma^mu_ab = 1/2 g^{mu nu} (d_a g_{nu b} + d_b g_{nu a} - d_nu g_{ab})

with d/dt = d/dphi = 0.  The analytic Schwarzschild set is the oracle.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from blackhole_tpu_torch.metrics import kerr


def christoffel(r, theta, M, a, Q=0.0):
    """Complete Christoffel symbols Gamma[..., mu, alpha, beta] at
    (r, theta), broadcast over their leading dims: (...) -> (..., 4, 4, 4).
    Scalar inputs give (4, 4, 4), as the JAX function does."""
    r, theta = torch.broadcast_tensors(torch.as_tensor(r),
                                       torch.as_tensor(theta))
    shape = r.shape

    def g(rr, th):
        return kerr.metric_matrix(rr, th, M, a, Q)

    # d g / d r and d g / d theta, one jacfwd per point.  Each point is
    # a (1,) row: torch.func's tangent of a 0-d tensor times a Python
    # float comes out float64.
    rf, thf = r.reshape(-1, 1), theta.reshape(-1, 1)
    dg_dr = vmap(jacfwd(g, argnums=0))(rf, thf).reshape(shape + (4, 4))
    dg_dth = vmap(jacfwd(g, argnums=1))(rf, thf).reshape(shape + (4, 4))
    zeros = torch.zeros_like(dg_dr)
    # partial[..., c, a, b] = d_c g_{ab}; only c = r (1), theta (2) nonzero.
    partial = torch.stack([zeros, dg_dr, dg_dth, zeros], dim=-3)
    ginv = kerr.inverse_metric_matrix(r, theta, M, a, Q)
    term = (
        torch.einsum("...anb->...nab", partial)
        + torch.einsum("...bna->...nab", partial)
        - partial
    )
    return 0.5 * torch.einsum("...mn,...nab->...mab", ginv, term)


def geodesic_acceleration(position, velocity, M, a, Q=0.0):
    """a^mu = -Gamma^mu_ab v^a v^b.

    position: (..., 4) = (t, r, theta, phi); velocity: (..., 4)
    coordinate 4-velocity."""
    gamma = christoffel(position[..., 1], position[..., 2], M, a, Q)
    return -torch.einsum("...mab,...a,...b->...m", gamma, velocity, velocity)


def schwarzschild_christoffel_analytic(r, theta, M):
    """Hand-derived Schwarzschild symbols (fully index-symmetrised),
    the oracle for the autodiff path: (...) -> (..., 4, 4, 4)."""
    r, theta = torch.broadcast_tensors(torch.as_tensor(r),
                                       torch.as_tensor(theta))
    rs = 2.0 * M
    st, ct = torch.sin(theta), torch.cos(theta)
    g = torch.zeros(r.shape + (4, 4, 4), dtype=r.dtype, device=r.device)
    g[..., 0, 0, 1] = g[..., 0, 1, 0] = rs / (2.0 * r * (r - rs))
    g[..., 1, 0, 0] = rs * (r - rs) / (2.0 * r**3)
    g[..., 1, 1, 1] = -rs / (2.0 * r * (r - rs))
    g[..., 1, 2, 2] = -(r - rs)
    g[..., 1, 3, 3] = -(r - rs) * st * st
    g[..., 2, 1, 2] = g[..., 2, 2, 1] = 1.0 / r
    g[..., 2, 3, 3] = -st * ct
    g[..., 3, 1, 3] = g[..., 3, 3, 1] = 1.0 / r
    g[..., 3, 2, 3] = g[..., 3, 3, 2] = ct / st
    return g
