"""Geodesic kernel path: prepare -> integrate -> postprocess.

PyTorch counterpart of blackhole_tpu.render.pallas_kernel (forward
mode).  The loop that integrates every ray to its end is a Pallas
kernel on the TPU; here it is a hand-written CUDA kernel for tensors on
a GPU, and its plain PyTorch version for tensors on the CPU.  The
wrappers pick between them by the tensors' device alone: a CUDA tensor
launches the kernel or raises.

  trace_planes (K1, csrc/trace_kernel.cu; plain: trace_planes_plain)
    replaces _make_kernel: the primal integration.  It is the registered
    operator blackhole_tpu_torch::trace_planes, so torch.export records
    it (export.py).
  trace_planes_fwdgrad (K2, csrc/trace_fwdgrad.cu; plain:
    trace_planes_fwdgrad_plain) replaces _make_kernel_jvp_multi: one
    primal and n forward tangents sharing it.  With n = 1 it replaces
    _make_kernel_jvp (K3), reached through torch.func.jvp of the planes
    pass (_Planes), as jax.jvp of trace_rays_pallas reaches K3.

Layouts (structure of arrays, one column per ray):
  inp (16, n): BL state (r, th, ph, p_r, p_th), conserved L, cartesian
    origin (3), initial direction (3), sin/cos theta0, sin/cos phi0.
  scal (12,): M, a, Q, time_step, max_ray_distance, r_capture,
    disk_inner, disk_outer, sin_incl, cos_incl, tol, r_shell_min.
  out (P, n): result, dist, steps, hit xyz, last-dir xyz, final r,
    sin/cos th, sin/cos ph, min_r; P = 15, or 22 with crossing-opacity
    tracking (track, the soft boundary with the disk on: + min |z'| in
    the disk's band, the position and the chord direction there).

Tangent layouts: dscals (n_tan, 12) and dinps (n_tan, 16, n) carry one
tangent direction per row (dL rides in plane 5 of dinp); the tangent
planes come back as douts (n_tan, P, n).

Forward mode only: reverse mode through the planes pass raises
NotImplementedError (at trace_planes when called directly with a tensor
that requires grad, at .backward() through trace_rays_kernel), so no
gradient can come back silently as zero.
"""

from __future__ import annotations

import torch
from torch.func import jvp

from blackhole_tpu_torch.constants import EPSILON, HORIZON_CAPTURE_FACTOR
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.geom.types import Hit, Integrator, RayResult, Scene
from blackhole_tpu_torch.integrate import sensitivity
from blackhole_tpu_torch.integrate import steppers as sp_mod
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.render import geodesic, trace
from blackhole_tpu_torch.tangent_rules import jabs, jclip, jmax, jmin
from blackhole_tpu_torch.utils import profiling

N_SCAL = 12
N_INP_PLANES = 16
N_OUT_PLANES = 15
N_TRACK = 7  # tracking slots and planes

# State-tuple slots of step_update (the JAX package's _S_* order); the
# tracking slots follow under track.
(S_R, S_TH, S_PH, S_PR, S_PTH, S_ST, S_CT, S_SP, S_CP,
 S_DIST, S_STEPS, S_RESULT, S_HX, S_HY, S_HZ,
 S_LX, S_LY, S_LZ, S_T, S_H, S_MINR,
 S_MINAZ, S_GX, S_GY, S_GZ, S_GDX, S_GDY, S_GDZ) = range(28)
N_STATE = 21


def n_out(track: bool) -> int:
    """Output planes per ray set: 15, or 22 with tracking."""
    return N_OUT_PLANES + (N_TRACK if track else 0)


# Kernel launches since the last reset: the operator's CUDA kernel
# (_launch_k1) adds one per K1 launch, whether eager or from an exported
# program, trace_planes_fwdgrad one per K2 launch; the track_ counts add
# one more per launch of the tracking variant.
launches = 0
fwdgrad_launches = 0
track_launches = 0
fwdgrad_track_launches = 0

# Tangent directions one K2 launch carries (the kernel is instantiated
# for 1 and 2); more tangents take several passes, each recomputing the
# same primal.
MAX_TANGENTS_PER_PASS = 2

_ACTIVE = float(trace.ACTIVE)


def _rhs(r, pr, pth, st, ct, sp, cp, L, M, a, Q):
    """Closed-form Kerr-Newman geodesic RHS on the trig-augmented state
    (E = 1), transcendental-free.  Returns
    (dr, dth, dph, dpr, dpth, dt, dst, dct, dsp, dcp)."""
    st2 = jmax(st * st, EPSILON)
    a2 = a * a
    sigma = r * r + a2 * ct * ct
    delta = r * r - 2.0 * M * r + a2 + Q * Q
    tm = 2.0 * M * r - Q * Q
    r2a2 = r * r + a2
    A = r2a2 * r2a2 - delta * a2 * st2
    inv_sd = 1.0 / (sigma * delta)
    inv_sigma = 1.0 / sigma

    g_rr_up = delta * inv_sigma
    g_thth_up = inv_sigma
    g_tphi_up = -tm * a * inv_sd
    g_tt_up = -A * inv_sd
    g_phph_up = (delta - a2 * st2) * inv_sd / st2

    dr = g_rr_up * pr
    dth = g_thth_up * pth
    dph = -g_tphi_up + g_phph_up * L
    dtt = -g_tt_up + g_tphi_up * L

    # dH/dr
    dsigma = 2.0 * r
    ddelta = 2.0 * r - 2.0 * M
    dA = 4.0 * r * r2a2 - ddelta * a2 * st2
    dinv_sd = -(dsigma * delta + sigma * ddelta) * inv_sd * inv_sd
    dg_tt = -(dA * inv_sd + A * dinv_sd)
    dg_tphi = -a * (2.0 * M * inv_sd + tm * dinv_sd)
    dg_rr = (ddelta * sigma - delta * dsigma) * inv_sigma * inv_sigma
    dg_thth = -dsigma * inv_sigma * inv_sigma
    dg_phph = (ddelta * inv_sd + (delta - a2 * st2) * dinv_sd) / st2
    dH_dr = 0.5 * (
        dg_tt
        - 2.0 * dg_tphi * L
        + dg_phph * L * L
        + dg_rr * pr * pr
        + dg_thth * pth * pth
    )

    # dH/dtheta
    dst2 = 2.0 * st * ct
    dsigma_th = -a2 * dst2
    dA_th = -delta * a2 * dst2
    dinv_sd_th = -(dsigma_th * delta) * inv_sd * inv_sd
    dg_tt_th = -(dA_th * inv_sd + A * dinv_sd_th)
    dg_tphi_th = -tm * a * dinv_sd_th
    dg_rr_th = -delta * dsigma_th * inv_sigma * inv_sigma
    dg_thth_th = -dsigma_th * inv_sigma * inv_sigma
    num = delta - a2 * st2
    dnum = -a2 * dst2
    dg_phph_th = (
        dnum * inv_sd / st2
        + num * dinv_sd_th / st2
        - num * inv_sd * dst2 / (st2 * st2)
    )
    dH_dth = 0.5 * (
        dg_tt_th
        - 2.0 * dg_tphi_th * L
        + dg_phph_th * L * L
        + dg_rr_th * pr * pr
        + dg_thth_th * pth * pth
    )
    # Slaved trig dynamics: d(sin x)/dl = cos x dx/dl, etc.
    return (dr, dth, dph, -dH_dr, -dH_dth, dtt,
            ct * dth, -st * dth, cp * dph, -sp * dph)


def _cart(r, st, ct, sp, cp, a):
    """Quasi-cartesian position from the carried trig."""
    w = torch.sqrt(r * r + a * a)
    rho = w * st
    return rho * cp, rho * sp, r * ct


def _advance(c, *terms):
    """c + sum(coeff * k) per component, terms added in order."""
    out = []
    for comp in range(10):
        acc = c[comp]
        for coeff, k in terms:
            acc = acc + coeff * k[comp]
        out.append(acc)
    return tuple(out)


def step_update(state, scal, disk_enabled: bool, adaptive: bool = False,
                track: bool = False, slave: bool = False):
    """One masked integration step on tuples of (n,) tensors — the plain
    version of csrc/geodesic_step.cuh's step_update, mirroring the JAX
    package's pallas_kernel._step_update.  Its max, min, clip and abs
    follow jax.jvp's tangent rules, so torch.func.jvp of it is the
    tangent recurrence of K2; slave=True slaves the trig tangents
    (trace.slave_trig) after the renormalisation, as the JAX package's
    differentiated kernels do.

    state: the 21 S_* slots, + the 7 tracking slots under track (the
    closest in-band approach to the disk plane, updated with the disk
    on); scal: (M, a, Q, dt, max_dist, r_capture,
    disk_inner, disk_outer, sin_incl, cos_incl, tol, r_shell_min, L),
    L per ray, the rest 0-d.  adaptive=False: RK4 on the radius
    schedule; True: embedded Fehlberg 4(5) with per-ray h and
    accept/reject."""
    (r, th, ph, pr, pth, sth, cth, sph, cph,
     dist, steps, result, hx, hy, hz, lx, ly, lz,
     tt, h_carry, min_r) = state[:N_STATE]
    if track:
        (min_az, gx, gy, gz, gdx, gdy, gdz) = state[N_STATE:]
    (M, a, Q, dt, max_dist, r_capture, disk_inner, disk_outer,
     sin_incl, cos_incl, tol, r_shell_min, L) = scal
    active = result == _ACTIVE
    rs = 2.0 * M

    if adaptive:
        h = h_carry
    else:
        h = dt * jclip(r / (7.5 * rs), 0.05, 20.0)
        h = jmin(h, 0.5 * (r - r_capture) + 1e-3 * dt)
        h = jmax(h, 1e-4 * dt)

    cur = (r, th, ph, pr, pth, tt, sth, cth, sph, cph)

    def eval_rhs(c):
        return _rhs(c[0], c[3], c[4], c[6], c[7], c[8], c[9], L, M, a, Q)

    if not adaptive:
        k1 = eval_rhs(cur)
        k2 = eval_rhs(_advance(cur, (0.5 * h, k1)))
        k3 = eval_rhs(_advance(cur, (0.5 * h, k2)))
        k4 = eval_rhs(_advance(cur, (h, k3)))
        sixth = h / 6.0
        new = tuple(
            cur[c] + sixth * (k1[c] + 2.0 * (k2[c] + k3[c]) + k4[c])
            for c in range(10)
        )
        accepted = torch.ones_like(active)
        h_next = h_carry
    else:
        sp = sp_mod
        k1 = eval_rhs(cur)
        k2 = eval_rhs(_advance(cur, (h * sp._B21, k1)))
        k3 = eval_rhs(_advance(cur, (h * sp._B31, k1), (h * sp._B32, k2)))
        k4 = eval_rhs(_advance(cur, (h * sp._B41, k1), (h * sp._B42, k2),
                               (h * sp._B43, k3)))
        k5 = eval_rhs(_advance(cur, (h * sp._B51, k1), (h * sp._B52, k2),
                               (h * sp._B53, k3), (h * sp._B54, k4)))
        k6 = eval_rhs(_advance(cur, (h * sp._B61, k1), (h * sp._B62, k2),
                               (h * sp._B63, k3), (h * sp._B64, k4),
                               (h * sp._B65, k5)))
        y4 = _advance(cur, (h * sp._C[0], k1), (h * sp._C[2], k3),
                      (h * sp._C[3], k4), (h * sp._C[4], k5))
        new = _advance(cur, (h * sp._D[0], k1), (h * sp._D[2], k3),
                       (h * sp._D[3], k4), (h * sp._D[4], k5),
                       (h * sp._D[5], k6))
        # Max relative error over the 6 physical components, scale
        # max(|y|, |y5|) floored at 1e-12.
        err = None
        for c in range(trace.N_ERR_COMPONENTS):
            scale = jmax(jmax(jabs(cur[c]), jabs(new[c])), 1e-12)
            e = jabs(new[c] - y4[c]) / scale
            err = e if err is None else jmax(err, e)
        accepted = err <= tol
        # Step-size controller with the trace clamps.
        log_ratio = torch.log(jmax(err / tol, 1e-30))
        scale_ok = sp.SAFETY * torch.exp(-0.2 * log_ratio)
        scale_bad = sp.SAFETY * torch.exp(-0.25 * log_ratio)
        sc = torch.where(accepted, scale_ok, scale_bad)
        sc = torch.where(err / tol <= 0.0, sp.MAX_SCALE, sc)
        h_next = h * jclip(sc, sp.MIN_SCALE, sp.MAX_SCALE)
        h_next = jclip(h_next, 1e-4 * dt, 50.0 * dt)
        h_next = jmin(h_next, 0.5 * (r - r_capture) + 1e-3 * dt)
        h_next = jmax(h_next, 1e-5 * dt)

    (r_t, th_t, ph_t, pr_t, pth_t, t_t, sth_t, cth_t, sph_t, cph_t) = new
    finite = (
        torch.isfinite(r_t) & torch.isfinite(th_t) & torch.isfinite(ph_t)
        & torch.isfinite(pr_t) & torch.isfinite(pth_t)
    )
    advance = active & accepted & finite
    r_n = torch.where(advance, r_t, r)
    th_n = torch.where(advance, th_t, th)
    ph_n = torch.where(advance, ph_t, ph)
    pr_n = torch.where(advance, pr_t, pr)
    pth_n = torch.where(advance, pth_t, pth)
    t_n = torch.where(advance, t_t, tt)
    sth_n = torch.where(advance, sth_t, sth)
    cth_n = torch.where(advance, cth_t, cth)
    sph_n = torch.where(advance, sph_t, sph)
    cph_n = torch.where(advance, cph_t, cph)
    h_new = torch.where(active, h_next, h_carry)

    # Unit-circle renormalisation of the trig pairs.
    n_th = torch.rsqrt(jmax(sth_n * sth_n + cth_n * cth_n, 0.25))
    sth_n = sth_n * n_th
    cth_n = cth_n * n_th
    n_ph = torch.rsqrt(jmax(sph_n * sph_n + cph_n * cph_n, 0.25))
    sph_n = sph_n * n_ph
    cph_n = cph_n * n_ph
    if slave:
        sth_n, cth_n, sph_n, cph_n = trace.slave_trig(
            sth_n, cth_n, sph_n, cph_n, th_n, ph_n)

    cx, cy, cz = _cart(r, sth, cth, sph, cph, a)
    cx_n, cy_n, cz_n = _cart(r_n, sth_n, cth_n, sph_n, cph_n, a)
    dxc = cx_n - cx
    dyc = cy_n - cy
    dzc = cz_n - cz
    step_len = torch.sqrt(dxc * dxc + dyc * dyc + dzc * dzc + 1e-24)
    inv_len = 1.0 / jmax(step_len, EPSILON)
    dist_n = dist + torch.where(advance, step_len, 0.0)
    lx_n = torch.where(advance, dxc * inv_len, lx)
    ly_n = torch.where(advance, dyc * inv_len, ly)
    lz_n = torch.where(advance, dzc * inv_len, lz)

    if disk_enabled:
        z_prev = -sin_incl * cy + cos_incl * cz
        z_new = -sin_incl * cy_n + cos_incl * cz_n
        crossed = (z_prev * z_new < 0.0) & advance
        denom = z_prev - z_new
        frac = z_prev / torch.where(torch.abs(denom) < EPSILON, EPSILON,
                                    denom)
        px = cx + frac * dxc
        py = cy + frac * dyc
        pz = cz + frac * dzc
        yp = cos_incl * py + sin_incl * pz
        r_plane = torch.sqrt(px * px + yp * yp)
        in_annulus = (r_plane >= disk_inner) & (r_plane <= disk_outer)
        disk_hit = crossed & in_annulus
        result = torch.where(disk_hit, float(RayResult.DISK), result)
        hx = torch.where(disk_hit, px, hx)
        hy = torch.where(disk_hit, py, hy)
        hz = torch.where(disk_hit, pz, hz)
        dist_n = torch.where(disk_hit, dist + frac * step_len, dist_n)
        if track:
            # Crossing-opacity tracking: the least sampled |z'| while
            # radially inside the annulus, and the position and chord
            # direction there.
            z_abs = jabs(z_new)
            yp_n = cos_incl * cy_n + sin_incl * cz_n
            r_plane_n = torch.sqrt(cx_n * cx_n + yp_n * yp_n)
            in_band = (r_plane_n >= disk_inner) & (r_plane_n <= disk_outer)
            cand = advance & in_band & (z_abs < min_az)
            min_az = torch.where(cand, z_abs, min_az)
            gx = torch.where(cand, cx_n, gx)
            gy = torch.where(cand, cy_n, gy)
            gz = torch.where(cand, cz_n, gz)
            gdx = torch.where(cand, dxc * inv_len, gdx)
            gdy = torch.where(cand, dyc * inv_len, gdy)
            gdz = torch.where(cand, dzc * inv_len, gdz)
        if adaptive:
            # Disk-aware clamp: an approaching ray inside the disk's
            # radial band caps its next step at ~1.25x the estimated
            # plane-crossing time.
            dz = z_new - z_prev
            approaching = z_new * dz < 0.0
            lam_cross = h * jabs(z_new) / jmax(jabs(dz), EPSILON)
            near = r_n < 1.5 * disk_outer
            h_cap = jmax(1.25 * lam_cross, 0.05 * dt)
            h_new = torch.where(active & approaching & near,
                                jmin(h_new, h_cap), h_new)

    still = result == _ACTIVE

    # Horizon capture, momentum pinning, NaN scrub, early ingoing shell
    # capture (r_shell_min ignores charge, as in the JAX package).
    pinned = (pr_n < -1e6) | (torch.abs(pr_n) > 1e7)
    shell_capture = (pr_n < 0.0) & (r_n < 0.999 * r_shell_min)
    captured = still & active & (
        (r_n <= r_capture) | shell_capture | pinned | ~finite
    )
    result = torch.where(captured, float(RayResult.HORIZON), result)
    hx = torch.where(captured, cx_n, hx)
    hy = torch.where(captured, cy_n, hy)
    hz = torch.where(captured, cz_n, hz)
    still = result == _ACTIVE

    budget = still & advance & (dist_n >= max_dist)
    result = torch.where(budget, float(RayResult.MAX_DISTANCE), result)
    hx = torch.where(budget, cx_n, hx)
    hy = torch.where(budget, cy_n, hy)
    hz = torch.where(budget, cz_n, hz)
    still = result == _ACTIVE

    escaped = still & advance & (r_n >= max_dist) & (pr_n > 0.0)
    result = torch.where(escaped, float(RayResult.BACKGROUND), result)
    hx = torch.where(escaped, cx_n, hx)
    hy = torch.where(escaped, cy_n, hy)
    hz = torch.where(escaped, cz_n, hz)

    steps_n = steps + active.to(steps.dtype)
    min_r_n = torch.where(advance, jmin(min_r, r_n), min_r)
    out = (r_n, th_n, ph_n, pr_n, pth_n, sth_n, cth_n, sph_n, cph_n,
           dist_n, steps_n, result, hx, hy, hz, lx_n, ly_n, lz_n,
           t_n, h_new, min_r_n)
    if track:
        out = out + (min_az, gx, gy, gz, gdx, gdy, gdz)
    return out


def _out_slots(track: bool):
    """State slots stored as the output planes, in plane order."""
    base = (S_RESULT, S_DIST, S_STEPS, S_HX, S_HY, S_HZ, S_LX, S_LY, S_LZ,
            S_R, S_ST, S_CT, S_SP, S_CP, S_MINR)
    return base + (tuple(range(S_MINAZ, S_GDZ + 1)) if track else ())


def _init_state(scal, inp, result0, track: bool = False, min_az0=1e9):
    """The state slots at the start of a trace (the JAX package's
    _load_init): BL state and trig from inp, hit position and last
    direction from the ray's origin and direction, min_r = r0, h = dt;
    dist, steps and t start at 0 and result at result0; under track
    min_az at min_az0 and the tracked position and direction at the
    origin and direction.  Fed tangent planes with result0 = 0 and
    min_az0 = 0 it gives the initial tangent (the JAX package's
    _zero_ctrl_tangents)."""
    zeros = torch.zeros_like(inp[0])
    state = (inp[0], inp[1], inp[2], inp[3], inp[4],
             inp[12], inp[13], inp[14], inp[15],
             zeros, zeros, zeros + result0,
             inp[6], inp[7], inp[8], inp[9], inp[10], inp[11],
             zeros, zeros + scal[3], inp[0])
    if track:
        state = state + (zeros + min_az0, inp[6], inp[7], inp[8], inp[9],
                         inp[10], inp[11])
    return state


def _scal_tuple(scal, inp):
    """step_update's scalars: the 12 scene scalars and the per-ray L."""
    return tuple(scal[k] for k in range(N_SCAL)) + (inp[5],)


def trace_planes_plain(scal, inp, disk_enabled: bool, max_steps: int,
                       adaptive: bool, track: bool = False):
    """Plain version of the kernel: integrate every ray of inp (16, n)
    until it retires or max_steps.  A retired ray's state is frozen,
    as in the kernel's per-ray loop.  Returns out (n_out(track), n)."""
    state = _init_state(scal, inp, _ACTIVE, track)
    sc = _scal_tuple(scal, inp)
    for _ in range(max_steps):
        active = state[S_RESULT] == _ACTIVE
        if not bool(active.any()):
            break
        new = step_update(state, sc, disk_enabled, adaptive, track)
        state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
    return torch.stack([state[i] for i in _out_slots(track)])


def step_update_jvp(state, dstates, scal, dscals, disk_enabled: bool,
                    adaptive: bool = False, track: bool = False):
    """The plain version of K2's step: torch.func.jvp of
    tangent_guard(step_update(..., slave=True)), once per tangent
    direction, as the JAX package's multi-tangent kernel applies jax.jvp
    per direction; the guard spans every slot, the tracking slots
    included.  dstates / dscals: one tangent tuple per direction.
    Returns (new state, [new tangent per direction])."""

    def f(st, sc):
        return sensitivity.tangent_guard(
            1, step_update(st, sc, disk_enabled, adaptive, track,
                           slave=True)
        )

    new, dnews = None, []
    for dst, dsc in zip(dstates, dscals):
        new, dnew = jvp(f, (tuple(state), tuple(scal)),
                        (tuple(dst), tuple(dsc)))
        dnews.append(dnew)
    return new, dnews


def trace_planes_fwdgrad_plain(scal, dscals, inp, dinps, disk_enabled: bool,
                               max_steps: int, adaptive: bool,
                               track: bool = False):
    """Plain version of K2: integrate every ray of inp (16, n) with the
    tangent directions dscals (n_tan, 12), dinps (n_tan, 16, n) riding
    beside the one primal.  A retired ray's primal and tangents are
    frozen.  Returns (out (P, n), douts (n_tan, P, n)), P = n_out(track)."""
    state = _init_state(scal, inp, _ACTIVE, track)
    sc = _scal_tuple(scal, inp)
    dstates = [_init_state(ds, di, 0.0, track, 0.0)
               for ds, di in zip(dscals, dinps)]
    dscs = [_scal_tuple(ds, di) for ds, di in zip(dscals, dinps)]
    for _ in range(max_steps):
        active = state[S_RESULT] == _ACTIVE
        if not bool(active.any()):
            break
        new, dnews = step_update_jvp(state, dstates, sc, dscs, disk_enabled,
                                     adaptive, track)
        state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
        dstates = [tuple(torch.where(active, n, o) for n, o in zip(dn, do))
                   for dn, do in zip(dnews, dstates)]
    slots = _out_slots(track)
    return (torch.stack([state[i] for i in slots]),
            torch.stack([torch.stack([ds[i] for i in slots])
                         for ds in dstates]))


def trace_planes(scal, inp, disk_enabled: bool, max_steps: int,
                 adaptive: bool, track: bool = False):
    """Integrate every ray of inp (16, n) with scene scalars scal (12,).

    Calls the registered operator blackhole_tpu_torch::trace_planes:
    CPU tensors go through trace_planes_plain; CUDA tensors launch the
    hand-written kernel (csrc/trace_kernel.cu, its tracking variant
    under track) on the current stream or raise.  torch.export records
    the operator itself.  Returns out (n_out(track), n) float32."""
    _check_planes(scal, inp, disk_enabled, track)
    return _Launch.apply(torch.ops.blackhole_tpu_torch.trace_planes, scal,
                         inp, bool(disk_enabled), int(max_steps),
                         bool(adaptive), bool(track))


def trace_planes_fwdgrad(scal, dscals, inp, dinps, disk_enabled: bool,
                         max_steps: int, adaptive: bool, track: bool = False):
    """Integrate every ray of inp (16, n) with n_tan forward tangents
    dscals (n_tan, 12), dinps (n_tan, 16, n).

    CPU tensors go through trace_planes_fwdgrad_plain; CUDA tensors
    launch K2 (csrc/trace_fwdgrad.cu, its tracking variant under track)
    on the current stream, in passes of at most MAX_TANGENTS_PER_PASS
    tangents (each pass recomputes the same primal), or raise.  Returns
    (out (P, n), douts (n_tan, P, n)) float32, P = n_out(track)."""
    global fwdgrad_launches, fwdgrad_track_launches
    _check_planes(scal, inp, disk_enabled, track)
    n_tan = dscals.shape[0] if dscals.dim() == 2 else -1
    if dscals.shape != (n_tan, N_SCAL) or n_tan < 1:
        raise ValueError(f"dscals must be (n_tan >= 1, {N_SCAL}), got "
                         f"{tuple(dscals.shape)}")
    if dinps.shape != (n_tan,) + tuple(inp.shape):
        raise ValueError(f"dinps must be ({n_tan}, {N_INP_PLANES}, "
                         f"{inp.shape[1]}), got {tuple(dinps.shape)}")
    for t in (dscals, dinps):
        if t.dtype != torch.float32:
            raise TypeError("dscals and dinps must be float32")
        if t.device != inp.device:
            raise ValueError("tangents and primal must be on one device")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(
                "the geodesic kernels are forward-mode only; reverse mode "
                "runs the XLA engine (grad.diff_trace)"
            )
    if inp.device.type == "cpu":
        return trace_planes_fwdgrad_plain(scal, dscals, inp, dinps,
                                          disk_enabled, max_steps, adaptive,
                                          track)
    n = inp.shape[1]
    p = n_out(track)
    if n == 0:
        return (torch.empty((p, 0), device=inp.device),
                torch.empty((n_tan, p, 0), device=inp.device))
    out = None
    douts = []
    for t0 in range(0, n_tan, MAX_TANGENTS_PER_PASS):
        k = min(MAX_TANGENTS_PER_PASS, n_tan - t0)
        buf = _Launch.apply(_launch_k2, scal, dscals[t0:t0 + k], inp,
                            dinps[t0:t0 + k], disk_enabled, max_steps,
                            adaptive, track)
        fwdgrad_launches += 1
        fwdgrad_track_launches += int(track)
        if out is None:
            out = buf[:p]
        douts.append(buf[p:].view(k, p, n))
    return out, torch.cat(douts) if len(douts) > 1 else douts[0]


class _Launch(torch.autograd.Function):
    """A kernel launch, launch(*args), as one autograd node without a
    derivative.  Its forward receives plain tensors under torch.func
    transforms too (they unwrap every tensor that carries no tangent of
    theirs), so the launch can hand raw device pointers to the kernel;
    a tangent or a cotangent that reaches the node raises instead of
    passing on a silent zero (forward-over-forward through _Planes'
    rule, say)."""

    @staticmethod
    def forward(launch, *args):
        return launch(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "the geodesic kernels have no derivative of their own: "
            "differentiate trace_rays_kernel once with torch.func.jvp, or "
            "use trace_planes_fwdgrad / grad.fast_grad"
        )

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the geodesic kernel has no reverse mode: use grad.diff_trace "
            "(the XLA engine), or torch.func.jvp / grad.fast_grad"
        )


@torch.library.custom_op("blackhole_tpu_torch::trace_planes", mutates_args=(),
                         device_types="cpu")
def _planes_op(scal: torch.Tensor, inp: torch.Tensor, disk_on: bool,
               max_steps: int, adaptive: bool, track: bool) -> torch.Tensor:
    """K1 as an operator: on the CPU, its plain version."""
    return trace_planes_plain(scal, inp, disk_on, max_steps, adaptive, track)


@_planes_op.register_kernel("cuda")
def _launch_k1(scal, inp, disk_on, max_steps, adaptive, track):
    """K1 as an operator on the card: one launch on the current stream
    (none for n = 0), counted."""
    global launches, track_launches
    from blackhole_tpu_torch import cuda_lib

    scal, inp = scal.contiguous(), inp.contiguous()
    n = inp.shape[1]
    out = torch.empty((n_out(track), n), dtype=torch.float32,
                      device=inp.device)
    if n == 0:
        return out
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        with profiling.span("kernel.k1", launches + 1):
            cuda_lib.trace_planes(scal, inp, out, n, max_steps, disk_on,
                                  adaptive, track, stream)
    launches += 1
    track_launches += int(track)
    return out


@_planes_op.register_fake
def _planes_shape(scal, inp, disk_on, max_steps, adaptive, track):
    return inp.new_empty((n_out(track), inp.shape[1]))


def _launch_k2(scal, dscals, inp, dinps, disk_enabled, max_steps, adaptive,
               track):
    from blackhole_tpu_torch import cuda_lib

    scal, inp = scal.contiguous(), inp.contiguous()
    dscals, dinps = dscals.contiguous(), dinps.contiguous()
    k, n = dscals.shape[0], inp.shape[1]
    buf = torch.empty(((1 + k) * n_out(track), n), dtype=torch.float32,
                      device=inp.device)
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        with profiling.span("kernel.k2", fwdgrad_launches + 1):
            cuda_lib.trace_planes_fwdgrad(
                scal, dscals, inp, dinps, buf, n, k, max_steps,
                disk_enabled, adaptive, track, stream,
            )
    return buf


def _check_planes(scal, inp, disk_enabled, track):
    """Shape, type and device checks shared by the kernels' wrappers;
    tracking needs the disk (its updates live in the disk block)."""
    if track and not disk_enabled:
        raise ValueError("crossing-opacity tracking needs the disk on")
    if torch.is_grad_enabled() and (scal.requires_grad or inp.requires_grad):
        raise NotImplementedError(
            "the geodesic kernels are forward-mode only; reverse mode runs "
            "the XLA engine (grad.diff_trace)"
        )
    if inp.dim() != 2 or inp.shape[0] != N_INP_PLANES:
        raise ValueError(f"inp must be ({N_INP_PLANES}, n), got "
                         f"{tuple(inp.shape)}")
    if scal.shape != (N_SCAL,):
        raise ValueError(f"scal must be ({N_SCAL},), got {tuple(scal.shape)}")
    if scal.dtype != torch.float32 or inp.dtype != torch.float32:
        raise TypeError("scal and inp must be float32")
    if scal.device != inp.device:
        raise ValueError("scal and inp must be on one device")
    if inp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {inp.device}")


def _f32(t):
    """A tangent in float32.  torch.func.jvp gives a 0-d tensor times a
    Python float a float64 tangent (plain forward AD does not), so the
    scene scalars' tangents can arrive as float64; the kernel takes
    float32, as the JAX package computes them."""
    return t.to(torch.float32)


class _Planes(torch.autograd.Function):
    """The planes pass with a forward-mode rule (the JAX package's
    _get_core custom_jvp): forward runs K1 (the plain version on the
    CPU); under torch.func.jvp its tangent comes from K2 with one
    tangent, which stands for K3.  Reverse mode raises."""

    @staticmethod
    def forward(scal, inp, disk_enabled, max_steps, adaptive, track):
        return trace_planes(scal, inp, disk_enabled, max_steps, adaptive,
                            track)

    @staticmethod
    def setup_context(ctx, inputs, output):
        scal, inp, *args = inputs
        ctx.save_for_forward(scal, inp)
        ctx.args = tuple(args)

    @staticmethod
    def jvp(ctx, dscal, dinp, *_):
        scal, inp = ctx.saved_tensors
        dscal = torch.zeros_like(scal) if dscal is None else _f32(dscal)
        dinp = torch.zeros_like(inp) if dinp is None else _f32(dinp)
        _, douts = trace_planes_fwdgrad(scal, dscal[None], inp, dinp[None],
                                        *ctx.args)
        return douts[0]

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the geodesic kernel has no reverse mode: use grad.diff_trace "
            "(the XLA engine), or torch.func.jvp / grad.fast_grad"
        )


def _check_integrator(scene: Scene) -> bool:
    if scene.config.integrator not in (Integrator.RK4, Integrator.RKF45):
        raise ValueError(
            "the geodesic kernel supports the RK4 and RKF45 integrators only"
        )
    return scene.config.integrator == Integrator.RKF45


def _soft(scene: Scene) -> bool:
    return float(scene.config.shadow_softness) > 0.0


def _needs_L(scene: Scene) -> bool:
    """finalize reads the per-ray conserved L: its sign for the soft
    shadow boundary, its value for exact Kerr kinematics."""
    return _soft(scene) or scene.config.disk_kinematics in ("auto", "kerr")


def prepare(origins, directions, scene: Scene):
    """Pre-kernel stage: exact null init and the kernel's inputs.

    Returns (scal (12,), inp (16, n)) float32 on the rays' device."""
    o = origins.to(torch.float32).reshape(-1, 3)
    d = directions.to(torch.float32).reshape(-1, 3)
    bh = scene.blackhole
    cfg = scene.config
    disk = scene.disk
    ld = coords.normalize(d)
    y, _, L, _ = geodesic.init_null_rays_aug(o, ld, bh.mass, bh.a, bh.charge)
    inp = torch.stack(
        [
            y[:, 0], y[:, 1], y[:, 2], y[:, 3], y[:, 4], L,
            o[:, 0], o[:, 1], o[:, 2], ld[:, 0], ld[:, 1], ld[:, 2],
            y[:, geodesic.IST], y[:, geodesic.ICT],
            y[:, geodesic.ISP], y[:, geodesic.ICP],
        ],
        dim=0,
    ).to(torch.float32)
    r_capture = HORIZON_CAPTURE_FACTOR * bh.r_plus
    scal = torch.stack(
        [
            bh.mass, bh.a, bh.charge, cfg.time_step, cfg.max_ray_distance,
            r_capture, disk.inner_radius, disk.outer_radius,
            torch.sin(disk.inclination), torch.cos(disk.inclination),
            jmax(cfg.tolerance, 1e-12),
            derived.kerr_photon_orbit_radius(bh.mass, jabs(bh.spin), 1.0),
        ]
    ).to(device=o.device, dtype=torch.float32)
    return scal, inp


def postprocess(out, n: int, batch_shape, scene: Scene, inv_order=None,
                L=None, margin=None) -> Hit:
    """Post-kernel stage: output planes (n_out(track), n) -> shaded Hit.

    inv_order restores the caller's ray order after a depth-sorted
    trace; L is the per-ray conserved L and margin the (margin, valid)
    pair of trace.compute_capture_margin, both in the caller's order."""
    track = trace.track_crossing(scene)
    flat = out[:, :n]
    if inv_order is not None:
        flat = flat[:, inv_order]
    result = flat[0].to(torch.int32)
    result = torch.where(result == trace.ACTIVE, RayResult.MAX_STEPS, result)
    # finalize's aug_to_cartesian reads r and the trig planes only.
    zcol = torch.zeros_like(flat[9])
    y_fin = torch.stack(
        [flat[9], zcol, zcol, zcol, zcol, zcol,
         flat[10], flat[11], flat[12], flat[13]],
        dim=-1,
    )
    carry = trace.TraceCarry(
        y=y_fin,
        h=zcol,
        L=zcol if L is None else L,
        dist=flat[1],
        steps=flat[2].to(torch.int32),
        result=result,
        hit_pos=flat[3:6].T,
        last_dir=flat[6:9].T,
        min_r=flat[14],
        iter=0,
        min_az=flat[15] if track else None,
        gpos=flat[16:19].T if track else None,
        gdir=flat[19:22].T if track else None,
    )
    hit = trace.finalize(carry, scene, margin=margin)
    return hit.map(lambda x: x.reshape(tuple(batch_shape) + x.shape[1:]))


def trace_rays_kernel(origins, directions, scene: Scene, order=None) -> Hit:
    """Trace rays (..., 3) through the geodesic kernel (RK4 or RKF45).

    order: optional (n,) permutation of the flattened rays (deepest
    first, see image.predicted_depth_order); the Hit is always in the
    caller's ray order.  With shadow_softness > 0 the capture margin
    comes from the caller-order rays, outside the kernel."""
    with profiling.span("kernel.prepare"):
        args = planes_args(scene)
        batch_shape = origins.shape[:-1]
        o = origins.to(torch.float32).reshape(-1, 3)
        d = directions.to(torch.float32).reshape(-1, 3)
        n = o.shape[0]
        o0, d0 = o, d
        inv_order = None
        if order is not None:
            o, d = o[order], d[order]
            inv_order = torch.argsort(order)
        scal, inp = prepare(o, d, scene)
    out = _Planes.apply(scal, inp, *args)
    with profiling.span("kernel.finish"):
        L = _L_of(scene, o0, d0) if _needs_L(scene) else None
        margin = (trace.compute_capture_margin(o0, d0, scene)
                  if _soft(scene) else None)
        return postprocess(out, n, batch_shape, scene, inv_order, L, margin)


def _disk_on(scene: Scene) -> bool:
    return bool(scene.disk_enabled and scene.config.show_disk)


def _L_of(scene: Scene, o, d):
    """Conserved L of the rays (caller's order), recomputed from them."""
    bh = scene.blackhole
    return geodesic.init_null_rays_aug(o, coords.normalize(d), bh.mass, bh.a,
                                       bh.charge)[2]


def trace_rays_kernel_fwdgrad(origins, directions, scene: Scene, tangents,
                              order=None):
    """One K2 pass propagating several tangent directions (the JAX
    package's trace_rays_pallas_fwdgrad).

    tangents: a sequence of scene tangents (a Scene whose tensor leaves
    are tangents, as torch.func.jvp of a function returning a Scene
    gives), or (dscene, dorigins, ddirections) triples when the rays
    themselves depend on the differentiated parameters.  order: optional
    depth-sort permutation, applied to the primal rays and to the ray
    tangents alike.  Returns (hit, [hit tangent per direction])."""
    planes_in, finish = prepare_fwdgrad(origins, directions, scene, tangents,
                                        order)
    return finish(*trace_planes_fwdgrad(*planes_in, *planes_args(scene)))


def planes_args(scene: Scene):
    """(disk on, max steps, adaptive, track) of a scene's planes pass."""
    return (_disk_on(scene), int(scene.config.max_steps),
            _check_integrator(scene), trace.track_crossing(scene))


def prepare_fwdgrad(origins, directions, scene: Scene, tangents, order=None):
    """The host stages around trace_rays_kernel_fwdgrad's planes pass.

    Returns ((scal, dscals, inp, dinps), finish): the planes pass's
    inputs, the tangents from torch.func.jvp of prepare, and finish(out,
    douts) -> (hit, [hit tangent per direction]), which shades the
    planes and takes each Hit tangent from torch.func.jvp of postprocess
    given the tangent planes (dL and, under shadow_softness > 0, the
    capture margin's tangent dm from those of the caller-order L and
    margin along the ray tangents)."""
    _check_integrator(scene)
    batch_shape = origins.shape[:-1]

    def rays(x):
        # torch.func.jvp refuses primals and tangents whose elements share
        # memory, such as broadcast camera origins.
        return x.to(torch.float32).reshape(-1, 3).contiguous()

    def pre(s, o_, d_):
        return prepare(o_, d_, s)

    with profiling.span("fwdgrad.prepare"):
        o, d = rays(origins), rays(directions)
        n = o.shape[0]
        o0, d0 = o, d  # caller order
        inv_order = None
        if order is not None:
            o, d = o[order], d[order]
            inv_order = torch.argsort(order)
        scal, inp = pre(scene, o, d)
        dscals, dinps, ray_tangents = [], [], []
        for i, tan in enumerate(tangents):
            with profiling.span("fwdgrad.jvp", i):
                if isinstance(tan, tuple) and len(tan) == 3:
                    ds, do, dd = tan[0], rays(tan[1]), rays(tan[2])
                else:
                    ds, do, dd = (tan, torch.zeros_like(o0),
                                  torch.zeros_like(d0))
                ray_tangents.append((ds, do, dd))
                if order is not None:
                    do, dd = do[order], dd[order]
                _, (dscal, dinp) = jvp(pre, (scene, o, d), (ds, do, dd))
            dscals.append(dscal)
            dinps.append(dinp)
        planes_in = (scal, _f32(torch.stack(dscals)), inp,
                     _f32(torch.stack(dinps)))

    def finish(out, douts):
        with profiling.span("fwdgrad.finish"):
            return _finish(out, douts)

    def _finish(out, douts):
        if not _needs_L(scene):
            def post(out_, s):
                return postprocess(out_, n, batch_shape, s, inv_order)

            dhits = []
            for i, (dout, (ds, _, _)) in enumerate(zip(douts,
                                                       ray_tangents)):
                with profiling.span("fwdgrad.jvp", i):
                    dhits.append(jvp(post, (out, scene), (dout, ds))[1])
            return post(out, scene), dhits

        soft = _soft(scene)
        if soft:
            # valid is a primal-only predicate, closed over.
            m_arr, m_valid = trace.compute_capture_margin(o0, d0, scene)
        else:
            m_arr = torch.zeros_like(o0[:, 0])

        def margin_of(s, o_, d_):
            return trace.compute_capture_margin(o_, d_, s)[0]

        def post_L(out_, s, L_, m_):
            margin = (m_, m_valid) if soft else None
            return postprocess(out_, n, batch_shape, s, inv_order, L_, margin)

        L = _L_of(scene, o0, d0)
        dhits = []
        for i, (dout, rtan) in enumerate(zip(douts, ray_tangents)):
            with profiling.span("fwdgrad.jvp", i):
                # dL and dm ride the jvp so the Kerr-mode shading and the
                # analytic shadow boundary see their tangents.
                _, dL = jvp(_L_of, (scene, o0, d0), rtan)
                dm = (jvp(margin_of, (scene, o0, d0), rtan)[1] if soft
                      else torch.zeros_like(m_arr))
                dhits.append(jvp(post_L, (out, scene, L, m_arr),
                                 (dout, rtan[0], dL, dm))[1])
        return post_L(out, scene, L, m_arr), dhits

    return planes_in, finish
