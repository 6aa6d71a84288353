"""Geodesic kernel path: prepare -> integrate -> postprocess.

PyTorch counterpart of blackhole_tpu.render.pallas_kernel (forward
only).  The loop that integrates every ray to its end is the Pallas
kernel `_make_kernel` on the TPU; here it is the hand-written CUDA
kernel in csrc/trace_kernel.cu for tensors on a GPU, and its plain
PyTorch version (step_update, trace_planes_plain) for tensors on the
CPU.  trace_planes picks between them by the tensors' device alone: a
CUDA tensor launches the kernel or raises.

Layouts (structure of arrays, one column per ray):
  inp (16, n): BL state (r, th, ph, p_r, p_th), conserved L, cartesian
    origin (3), initial direction (3), sin/cos theta0, sin/cos phi0.
  scal (12,): M, a, Q, time_step, max_ray_distance, r_capture,
    disk_inner, disk_outer, sin_incl, cos_incl, tol, r_shell_min.
  out (15, n): result, dist, steps, hit xyz, last-dir xyz, final r,
    sin/cos th, sin/cos ph, min_r.

Forward only: a tensor that requires grad raises NotImplementedError at
trace_planes, so no gradient can come back silently as zero.
"""

from __future__ import annotations

import torch

from blackhole_tpu_torch.constants import EPSILON, HORIZON_CAPTURE_FACTOR
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.geom.types import Hit, Integrator, RayResult, Scene
from blackhole_tpu_torch.integrate import steppers as sp_mod
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.render import geodesic, trace

N_SCAL = 12
N_INP_PLANES = 16
N_OUT_PLANES = 15

# State-tuple slots of step_update (the JAX package's _S_* order).
(S_R, S_TH, S_PH, S_PR, S_PTH, S_ST, S_CT, S_SP, S_CP,
 S_DIST, S_STEPS, S_RESULT, S_HX, S_HY, S_HZ,
 S_LX, S_LY, S_LZ, S_T, S_H, S_MINR) = range(21)
N_STATE = 21

# Kernel launches since the last reset; trace_planes adds one per launch.
launches = 0

_ACTIVE = float(trace.ACTIVE)


def _rhs(r, pr, pth, st, ct, sp, cp, L, M, a, Q):
    """Closed-form Kerr-Newman geodesic RHS on the trig-augmented state
    (E = 1), transcendental-free.  Returns
    (dr, dth, dph, dpr, dpth, dt, dst, dct, dsp, dcp)."""
    st2 = torch.clamp(st * st, min=EPSILON)
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


def step_update(state, scal, disk_enabled: bool, adaptive: bool = False):
    """One masked integration step on tuples of (n,) tensors — the plain
    version of csrc/geodesic_step.cuh's step_update, mirroring the JAX
    package's pallas_kernel._step_update (forward, no tracking).

    state: the 21 S_* slots; scal: (M, a, Q, dt, max_dist, r_capture,
    disk_inner, disk_outer, sin_incl, cos_incl, tol, r_shell_min, L),
    L per ray, the rest 0-d.  adaptive=False: RK4 on the radius
    schedule; True: embedded Fehlberg 4(5) with per-ray h and
    accept/reject."""
    (r, th, ph, pr, pth, sth, cth, sph, cph,
     dist, steps, result, hx, hy, hz, lx, ly, lz,
     tt, h_carry, min_r) = state
    (M, a, Q, dt, max_dist, r_capture, disk_inner, disk_outer,
     sin_incl, cos_incl, tol, r_shell_min, L) = scal
    active = result == _ACTIVE
    rs = 2.0 * M

    if adaptive:
        h = h_carry
    else:
        h = dt * torch.clamp(r / (7.5 * rs), 0.05, 20.0)
        h = torch.minimum(h, 0.5 * (r - r_capture) + 1e-3 * dt)
        h = torch.maximum(h, 1e-4 * dt)

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
            scale = torch.clamp(
                torch.maximum(torch.abs(cur[c]), torch.abs(new[c])),
                min=1e-12,
            )
            e = torch.abs(new[c] - y4[c]) / scale
            err = e if err is None else torch.maximum(err, e)
        accepted = err <= tol
        # Step-size controller with the trace clamps.
        log_ratio = torch.log(torch.clamp(err / tol, min=1e-30))
        scale_ok = sp.SAFETY * torch.exp(-0.2 * log_ratio)
        scale_bad = sp.SAFETY * torch.exp(-0.25 * log_ratio)
        sc = torch.where(accepted, scale_ok, scale_bad)
        sc = torch.where(err / tol <= 0.0, sp.MAX_SCALE, sc)
        h_next = h * torch.clamp(sc, sp.MIN_SCALE, sp.MAX_SCALE)
        h_next = torch.clamp(h_next, 1e-4 * dt, 50.0 * dt)
        h_next = torch.minimum(h_next, 0.5 * (r - r_capture) + 1e-3 * dt)
        h_next = torch.maximum(h_next, 1e-5 * dt)

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
    n_th = torch.rsqrt(torch.clamp(sth_n * sth_n + cth_n * cth_n, min=0.25))
    sth_n = sth_n * n_th
    cth_n = cth_n * n_th
    n_ph = torch.rsqrt(torch.clamp(sph_n * sph_n + cph_n * cph_n, min=0.25))
    sph_n = sph_n * n_ph
    cph_n = cph_n * n_ph

    cx, cy, cz = _cart(r, sth, cth, sph, cph, a)
    cx_n, cy_n, cz_n = _cart(r_n, sth_n, cth_n, sph_n, cph_n, a)
    dxc = cx_n - cx
    dyc = cy_n - cy
    dzc = cz_n - cz
    step_len = torch.sqrt(dxc * dxc + dyc * dyc + dzc * dzc + 1e-24)
    inv_len = 1.0 / torch.clamp(step_len, min=EPSILON)
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
        if adaptive:
            # Disk-aware clamp: an approaching ray inside the disk's
            # radial band caps its next step at ~1.25x the estimated
            # plane-crossing time.
            dz = z_new - z_prev
            approaching = z_new * dz < 0.0
            lam_cross = h * torch.abs(z_new) / torch.clamp(torch.abs(dz),
                                                           min=EPSILON)
            near = r_n < 1.5 * disk_outer
            h_cap = torch.maximum(1.25 * lam_cross, 0.05 * dt)
            h_new = torch.where(active & approaching & near,
                                torch.minimum(h_new, h_cap), h_new)

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
    min_r_n = torch.where(advance, torch.minimum(min_r, r_n), min_r)
    return (r_n, th_n, ph_n, pr_n, pth_n, sth_n, cth_n, sph_n, cph_n,
            dist_n, steps_n, result, hx, hy, hz, lx_n, ly_n, lz_n,
            t_n, h_new, min_r_n)


def trace_planes_plain(scal, inp, disk_enabled: bool, max_steps: int,
                       adaptive: bool):
    """Plain version of the kernel: integrate every ray of inp (16, n)
    until it retires or max_steps.  A retired ray's state is frozen,
    as in the kernel's per-ray loop.  Returns out (15, n)."""
    zeros = torch.zeros_like(inp[0])
    state = (inp[0], inp[1], inp[2], inp[3], inp[4],
             inp[12], inp[13], inp[14], inp[15],
             zeros, zeros, zeros + _ACTIVE,
             inp[6], inp[7], inp[8], inp[9], inp[10], inp[11],
             zeros, zeros + scal[3], inp[0])
    sc = tuple(scal[k] for k in range(N_SCAL)) + (inp[5],)
    for _ in range(max_steps):
        active = state[S_RESULT] == _ACTIVE
        if not bool(active.any()):
            break
        new = step_update(state, sc, disk_enabled, adaptive)
        state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
    return torch.stack(
        [state[i] for i in (S_RESULT, S_DIST, S_STEPS, S_HX, S_HY, S_HZ,
                            S_LX, S_LY, S_LZ, S_R, S_ST, S_CT, S_SP, S_CP,
                            S_MINR)]
    )


def trace_planes(scal, inp, disk_enabled: bool, max_steps: int,
                 adaptive: bool):
    """Integrate every ray of inp (16, n) with scene scalars scal (12,).

    CPU tensors go through trace_planes_plain; CUDA tensors launch the
    hand-written kernel (csrc/trace_kernel.cu) on the current stream or
    raise.  Returns out (15, n) float32."""
    global launches
    if scal.requires_grad or inp.requires_grad:
        raise NotImplementedError(
            "the geodesic kernel is forward-only; gradients are not "
            "ported yet"
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
    if inp.device.type == "cpu":
        return trace_planes_plain(scal, inp, disk_enabled, max_steps,
                                  adaptive)
    if inp.device.type != "cuda":
        raise ValueError(f"unsupported device {inp.device}")
    from blackhole_tpu_torch import cuda_lib

    scal = scal.contiguous()
    inp = inp.contiguous()
    n = inp.shape[1]
    out = torch.empty((N_OUT_PLANES, n), dtype=torch.float32,
                      device=inp.device)
    if n == 0:
        return out
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_lib.trace_planes(scal, inp, out, n, max_steps, disk_enabled,
                              adaptive, stream)
    launches += 1
    return out


def _check_integrator(scene: Scene) -> bool:
    if scene.config.integrator not in (Integrator.RK4, Integrator.RKF45):
        raise ValueError(
            "the geodesic kernel supports the RK4 and RKF45 integrators only"
        )
    return scene.config.integrator == Integrator.RKF45


def _needs_L(scene: Scene) -> bool:
    """finalize reads the per-ray conserved L for exact Kerr kinematics."""
    return scene.config.disk_kinematics in ("auto", "kerr")


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
            torch.clamp(cfg.tolerance, min=1e-12),
            derived.kerr_photon_orbit_radius(bh.mass, torch.abs(bh.spin),
                                             1.0),
        ]
    ).to(device=o.device, dtype=torch.float32)
    return scal, inp


def postprocess(out, n: int, batch_shape, scene: Scene, inv_order=None,
                L=None) -> Hit:
    """Post-kernel stage: output planes (15, n) -> shaded Hit.

    inv_order restores the caller's ray order after a depth-sorted
    trace; L is the per-ray conserved L in the caller's order."""
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
    )
    hit = trace.finalize(carry, scene)
    return hit.map(lambda x: x.reshape(tuple(batch_shape) + x.shape[1:]))


def trace_rays_kernel(origins, directions, scene: Scene, order=None) -> Hit:
    """Trace rays (..., 3) through the geodesic kernel (RK4 or RKF45).

    order: optional (n,) permutation of the flattened rays (deepest
    first, see image.predicted_depth_order); the Hit is always in the
    caller's ray order."""
    adaptive = _check_integrator(scene)
    trace.check_hard_edge(scene)
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
    out = trace_planes(
        scal, inp, bool(scene.disk_enabled and scene.config.show_disk),
        int(scene.config.max_steps), adaptive,
    )
    L = None
    if _needs_L(scene):
        # Conserved L in the caller's order, recomputed from the rays.
        bh = scene.blackhole
        _, _, L, _ = geodesic.init_null_rays_aug(
            o0, coords.normalize(d0), bh.mass, bh.a, bh.charge
        )
    return postprocess(out, n, batch_shape, scene, inv_order, L)
