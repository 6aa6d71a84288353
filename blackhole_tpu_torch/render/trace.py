"""Batched geodesic tracing with masked lockstep termination.

PyTorch counterpart of blackhole_tpu.render.trace.  Two engines share
its records and its post-loop stage (TraceCarry, compute_capture_margin,
finalize):

* the geodesic kernel (render.trace_kernel), which integrates each ray
  to its end in one launch;
* the XLA engine's counterpart here, plain PyTorch: trace_step advances
  every ray of the batch by one masked step (per-ray divergence by
  masks, not control flow), and trace_rays repeats it until no ray is
  active or the step budget is spent, checking both on the host before
  every step (one synchronisation per step), so it stops exactly where
  the JAX package's while_loop does; under torch.export the same step
  runs inside a traced while_loop instead (export.py).  grad.diff_trace
  re-drives the same trace_step for reverse mode.

The state is trig-augmented (geodesic.rhs_aug): sin/cos of theta and
phi ride as slaved components, renormalised to the unit circle every
step, so a step evaluates no transcendental.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from blackhole_tpu_torch.constants import EPSILON, HORIZON_CAPTURE_FACTOR
from blackhole_tpu_torch.geom import coords
from blackhole_tpu_torch.geom.types import Hit, Integrator, RayResult, Scene
from blackhole_tpu_torch.integrate import sensitivity, steppers
from blackhole_tpu_torch.metrics import derived
from blackhole_tpu_torch.render import geodesic, shading
from blackhole_tpu_torch.tangent_rules import jabs, jclip, jmax, jmin

ACTIVE = -1  # result code while a ray is still integrating

# The RKF45 error criterion spans the 6 physical components only.
N_ERR_COMPONENTS = 6


class TraceCarry(NamedTuple):
    y: torch.Tensor  # (N, 10) trig-augmented geodesic state
    h: torch.Tensor  # (N,) current step size
    L: torch.Tensor  # (N,) conserved angular momentum (E = 1)
    dist: torch.Tensor  # (N,) accumulated cartesian path length
    steps: torch.Tensor  # (N,) int32 steps taken
    result: torch.Tensor  # (N,) int32; ACTIVE while integrating
    hit_pos: torch.Tensor  # (N, 3) recorded hit position
    last_dir: torch.Tensor  # (N, 3) unit direction of the last chord
    min_r: torch.Tensor  # (N,) closest BL radial approach
    iter: int  # global iteration counter
    # Crossing-opacity tracking (None unless track_crossing): the
    # closest sampled approach |z'| to the disk plane while radially
    # inside the annulus, and the position and chord direction there.
    min_az: torch.Tensor | None = None  # (N,)
    gpos: torch.Tensor | None = None  # (N, 3)
    gdir: torch.Tensor | None = None  # (N, 3)


def track_crossing(scene: Scene) -> bool:
    """Carry the crossing-opacity planes?  Only for soft-boundary
    rendering with the disk on."""
    return bool(
        scene.disk_enabled
        and scene.config.show_disk
        and float(scene.config.shadow_softness) > 0.0
    )


def _disk_plane_z(cart, incl):
    """Signed coordinate normal to the disk plane rotated by incl about
    x: z' = -sin(incl) y + cos(incl) z."""
    return -torch.sin(incl) * cart[..., 1] + torch.cos(incl) * cart[..., 2]


def _disk_plane_radius(cart, incl):
    """In-plane radius of a point in the disk frame rotated by incl."""
    x = cart[..., 0]
    yp = torch.cos(incl) * cart[..., 1] + torch.sin(incl) * cart[..., 2]
    return torch.sqrt(x * x + yp * yp)


def aug_to_cartesian(y, a):
    """Quasi-cartesian position from the trig-augmented state:
    x = sqrt(r^2+a^2) sin th cos ph, y = ... sin ph, z = r cos th."""
    r, _, _, _, _, _, st, ct, sp, cp = y.unbind(-1)
    w = torch.sqrt(r * r + a * a)
    rho = w * st
    return torch.stack([rho * cp, rho * sp, r * ct], dim=-1)


def renormalize_trig(y):
    """Project the slaved (sin, cos) pairs of y (..., 10) back to the
    unit circle (the flow keeps s^2 + c^2 = 1 only up to the step's
    truncation error)."""
    st, ct, sp, cp = y[..., geodesic.IST:].unbind(-1)
    n_th = torch.rsqrt(jmax(st * st + ct * ct, 0.25))
    n_ph = torch.rsqrt(jmax(sp * sp + cp * cp, 0.25))
    trig = torch.stack([st * n_th, ct * n_th, sp * n_ph, cp * n_ph], dim=-1)
    return torch.cat([y[..., :geodesic.IST], trig], dim=-1)


class _SlaveTrig(torch.autograd.Function):
    """Identity on (st, ct, sp, cp).  Under torch.func.jvp their tangents
    are overwritten with cos th dth, -sin th dth, cos ph dph,
    -sin ph dph (the JAX package's slave_trig_tangent, a custom_jvp);
    backward is that linear rule's transpose, which jax.grad takes: the
    trig cotangents go to theta (cos th g_st - sin th g_ct) and phi
    (cos ph g_sp - sin ph g_cp), and none to the trig inputs."""

    @staticmethod
    def forward(st, ct, sp, cp, th, ph):
        # Views, not the inputs themselves: autograd refuses to save an
        # input returned as-is.
        return st.view_as(st), ct.view_as(ct), sp.view_as(sp), cp.view_as(cp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs[:4])
        ctx.save_for_backward(*inputs[:4])
        ctx.set_materialize_grads(False)

    @staticmethod
    def jvp(ctx, _dst, _dct, _dsp, _dcp, dth, dph):
        st, ct, sp, cp = ctx.saved_tensors
        dth = torch.zeros_like(st) if dth is None else dth
        dph = torch.zeros_like(sp) if dph is None else dph
        return ct * dth, -st * dth, cp * dph, -sp * dph

    @staticmethod
    def backward(ctx, g_st, g_ct, g_sp, g_cp):
        st, ct, sp, cp = ctx.saved_tensors

        def pair(c, gs, s, gc):
            out = None if gs is None else c * gs
            if gc is not None:
                out = -(s * gc) if out is None else out - s * gc
            return out

        return (None, None, None, None, pair(ct, g_st, st, g_ct),
                pair(cp, g_sp, sp, g_cp))


def slave_trig(st, ct, sp, cp, th, ph):
    """Trig-tangent slaving on separate components: identity on the
    primal (see _SlaveTrig).  The geodesic kernel's plain step takes
    this form."""
    return _SlaveTrig.apply(st, ct, sp, cp, th, ph)


def slave_trig_tangent(y):
    """slave_trig on the trig-augmented state y (..., 10)."""
    _, th, ph, _, _, _, st, ct, sp, cp = y.unbind(-1)
    trig = slave_trig(st, ct, sp, cp, th, ph)
    return torch.cat([y[..., :geodesic.IST], torch.stack(trig, dim=-1)],
                     dim=-1)


def step_size_schedule(r, time_step, M, r_capture):
    """Smooth per-ray step size: ~ r in the far field, shrinking toward
    the capture radius, clamped to [0.05, 20] x time_step."""
    rs = 2.0 * M
    h = time_step * jclip(r / (7.5 * rs), 0.05, 20.0)
    h = jmin(h, 0.5 * (r - r_capture) + 1e-3 * time_step)
    return jmax(h, 1e-4 * time_step)


# State components of the split (symplectic) integrators: positions
# (r, theta, phi, t and the trig planes) and momenta (p_r, p_theta).
_POS = (geodesic.IR, geodesic.ITH, geodesic.IPH, geodesic.IT,
        geodesic.IST, geodesic.ICT, geodesic.ISP, geodesic.ICP)
_MOM = (geodesic.IPR, geodesic.IPT)


def make_step_fn(scene: Scene):
    """(step, adaptive) for the configured integrator: step(y, h, L) ->
    (y_trial, err), every integrator advancing the trig-augmented state
    through geodesic.rhs_aug (err is 0 but for RKF45)."""
    M = scene.blackhole.mass
    a = scene.blackhole.a
    Qc = scene.blackhole.charge

    def f(t, y, L):
        return geodesic.rhs_aug(y, 1.0, L, M, a, Qc)

    def no_err(y):
        return torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)

    integ = scene.config.integrator
    if integ == Integrator.RK4:
        def step(y, h, L):
            return steppers.rk4_step(f, 0.0, y, h[..., None], L), no_err(y)
        return step, False
    if integ == Integrator.RKF45:
        def step(y, h, L):
            return steppers.rkf45_step(f, 0.0, y, h[..., None], L,
                                       n_err=N_ERR_COMPONENTS)
        return step, True
    if integ in (Integrator.LEAPFROG, Integrator.YOSHIDA):
        # The Hamiltonian is not separable: positions drift with dH/dp
        # at the current momenta, momenta kick with -dH/dx (a
        # semi-explicit composition).
        def assemble(x, v):
            comps = [None] * geodesic.NAUG
            for i, idx in enumerate(_POS):
                comps[idx] = x[..., i]
            for i, idx in enumerate(_MOM):
                comps[idx] = v[..., i]
            return torch.stack(comps, dim=-1)

        def accel(x, v, L):
            d = geodesic.rhs_aug(assemble(x, v), 1.0, L, M, a, Qc)
            return torch.stack([d[..., i] for i in _MOM], dim=-1)

        def drift(x, v, h, L):
            d = geodesic.rhs_aug(assemble(x, v), 1.0, L, M, a, Qc)
            dx = torch.stack([d[..., i] for i in _POS], dim=-1)
            return x + h * dx

        def split(y):
            return (torch.stack([y[..., i] for i in _POS], dim=-1),
                    torch.stack([y[..., i] for i in _MOM], dim=-1))

        if integ == Integrator.LEAPFROG:
            def step(y, h, L):
                hh = h[..., None]
                x, v = split(y)
                v = v + 0.5 * hh * accel(x, v, L)
                x = drift(x, v, hh, L)
                v = v + 0.5 * hh * accel(x, v, L)
                return assemble(x, v), no_err(y)
        else:
            def step(y, h, L):
                hh = h[..., None]
                x, v = split(y)
                for i in range(3):
                    x = drift(x, v, steppers._YOSHIDA_C[i] * hh, L)
                    v = v + steppers._YOSHIDA_D[i] * hh * accel(x, v, L)
                x = drift(x, v, steppers._YOSHIDA_C[3] * hh, L)
                return assemble(x, v), no_err(y)
        return step, False
    raise ValueError(f"unknown integrator {integ!r}")


def trace_step(carry: TraceCarry, scene: Scene, step_fn, adaptive: bool
               ) -> TraceCarry:
    """One masked integration step for every ray (the loop body shared
    by trace_rays and grad.diff_trace).  Its max, min, clip and abs
    follow JAX's derivative rules (tangent_rules)."""
    bh = scene.blackhole
    disk = scene.disk
    cfg = scene.config
    M, a = bh.mass, bh.a
    r_capture = HORIZON_CAPTURE_FACTOR * bh.r_plus
    active = carry.result == ACTIVE

    r = carry.y[..., geodesic.IR]
    if adaptive:
        h = carry.h
    else:
        h = step_size_schedule(r, cfg.time_step, M, r_capture)

    y_trial, err = step_fn(carry.y, h, carry.L)

    if adaptive:
        tol = jmax(cfg.tolerance, 1e-12)
        accepted = err <= tol
        h_next = steppers.rkf45_next_h(h, err / tol, accepted)
        h_next = jclip(h_next, 1e-4 * cfg.time_step, 50.0 * cfg.time_step)
        # The horizon-approach clamp keeps adaptive lanes from
        # overshooting through the horizon.
        h_next = jmin(h_next, 0.5 * (r - r_capture) + 1e-3 * cfg.time_step)
        h_next = jmax(h_next, 1e-5 * cfg.time_step)
    else:
        accepted = torch.ones_like(active)
        h_next = h

    # A non-finite trial state never enters the carry: the lane freezes
    # this step and the capture test below retires it.
    finite = torch.isfinite(y_trial).all(dim=-1)
    advance = active & accepted & finite
    y_new = slave_trig_tangent(renormalize_trig(
        torch.where(advance[..., None], y_trial, carry.y)
    ))
    h_new = torch.where(active, h_next, carry.h)

    cart_prev = aug_to_cartesian(carry.y, a)
    cart_new = aug_to_cartesian(y_new, a)
    chord = cart_new - cart_prev
    # Frozen lanes have a chord of ~0 (renormalize_trig nudges their
    # trig at ulp level); the 1e-24 floor keeps the norm's derivative
    # finite there.
    step_len = torch.sqrt(torch.sum(chord * chord, dim=-1) + 1e-24)
    unit_dir = chord / jmax(step_len, EPSILON)[..., None]
    dist_new = carry.dist + torch.where(advance, step_len, 0.0)
    last_dir = torch.where(advance[..., None], unit_dir, carry.last_dir)

    result = carry.result
    hit_pos = carry.hit_pos
    min_az, gpos, gdir = carry.min_az, carry.gpos, carry.gdir

    # Disk crossing: a sign change of the disk-plane coordinate.
    if scene.disk_enabled and cfg.show_disk:
        incl = disk.inclination
        z_prev = _disk_plane_z(cart_prev, incl)
        z_new = _disk_plane_z(cart_new, incl)
        crossed = (z_prev * z_new < 0.0) & advance
        frac = z_prev / torch.where(
            torch.abs(z_prev - z_new) < EPSILON, EPSILON, z_prev - z_new
        )
        cross_pt = cart_prev + frac[..., None] * chord
        r_plane = _disk_plane_radius(cross_pt, incl)
        in_annulus = (r_plane >= disk.inner_radius) & (
            r_plane <= disk.outer_radius
        )
        disk_hit = crossed & in_annulus
        result = torch.where(disk_hit, RayResult.DISK, result)
        hit_pos = torch.where(disk_hit[..., None], cross_pt, hit_pos)
        # The travelled distance ends at the crossing point.
        dist_new = torch.where(
            disk_hit, carry.dist + frac * step_len, dist_new
        )
        if track_crossing(scene):
            # Closest sampled approach to the disk plane while radially
            # inside the annulus, and the position and chord there.
            z_abs = jabs(z_new)
            r_plane_new = _disk_plane_radius(cart_new, incl)
            in_band = (r_plane_new >= disk.inner_radius) & (
                r_plane_new <= disk.outer_radius
            )
            cand = advance & in_band & (z_abs < min_az)
            min_az = torch.where(cand, z_abs, min_az)
            gpos = torch.where(cand[..., None], cart_new, gpos)
            gdir = torch.where(cand[..., None], unit_dir, gdir)
        if adaptive:
            # An approaching ray inside the disk's radial band caps its
            # next step at ~1.25x the estimated plane-crossing time, so
            # a step crosses the plane at most once.
            dz = z_new - z_prev
            approaching = z_new * dz < 0.0
            lam_cross = h * jabs(z_new) / jmax(jabs(dz), EPSILON)
            near = y_new[..., geodesic.IR] < 1.5 * disk.outer_radius
            h_cap = jmax(1.25 * lam_cross, 0.05 * cfg.time_step)
            h_new = torch.where(
                active & approaching & near, jmin(h_new, h_cap), h_new
            )

    still = result == ACTIVE

    # Horizon capture, by radius; by diverging ingoing p_r (pinned at
    # the capture radius); by an ingoing ray below the prograde photon
    # shell, which cannot turn around (the shell radius ignores charge,
    # as in the JAX package); or by a non-finite trial.
    r_new = y_new[..., geodesic.IR]
    p_r_new = y_new[..., geodesic.IPR]
    pinned = (p_r_new < -1e6) | (torch.abs(p_r_new) > 1e7)
    r_shell_min = derived.kerr_photon_orbit_radius(M, jabs(bh.spin), 1.0)
    shell_capture = (p_r_new < 0.0) & (r_new < 0.999 * r_shell_min)
    captured = still & active & (
        (r_new <= r_capture) | shell_capture | pinned | ~finite
    )
    result = torch.where(captured, RayResult.HORIZON, result)
    hit_pos = torch.where(captured[..., None], cart_new, hit_pos)
    still = result == ACTIVE

    # Path-length budget.
    budget = still & advance & (dist_new >= cfg.max_ray_distance)
    result = torch.where(budget, RayResult.MAX_DISTANCE, result)
    hit_pos = torch.where(budget[..., None], cart_new, hit_pos)
    still = result == ACTIVE

    # Radial escape: far away and outgoing.
    escaped = (
        still & advance & (r_new >= cfg.max_ray_distance)
        & (y_new[..., geodesic.IPR] > 0.0)
    )
    result = torch.where(escaped, RayResult.BACKGROUND, result)
    hit_pos = torch.where(escaped[..., None], cart_new, hit_pos)

    return TraceCarry(
        y=y_new,
        h=h_new,
        L=carry.L,
        dist=dist_new,
        steps=carry.steps + active.to(carry.steps.dtype),
        result=result.to(carry.result.dtype),
        hit_pos=hit_pos,
        last_dir=last_dir,
        min_r=torch.where(advance, jmin(carry.min_r, r_new), carry.min_r),
        iter=carry.iter + 1,
        min_az=min_az,
        gpos=gpos,
        gdir=gdir,
    )


def init_carry(origins, directions, scene: Scene) -> TraceCarry:
    """The initial carry of flat rays (n, 3)."""
    bh = scene.blackhole
    y, _, L, _ = geodesic.init_null_rays_aug(
        origins, coords.normalize(directions), bh.mass, bh.a, bh.charge
    )
    dtype = y.dtype
    track = track_crossing(scene)
    zeros = torch.zeros_like(y[..., geodesic.IR])
    izeros = torch.zeros(zeros.shape, dtype=torch.int32, device=y.device)
    hit_pos = origins.to(dtype)
    last_dir = coords.normalize(directions.to(dtype))
    return TraceCarry(
        y=y,
        h=zeros + scene.config.time_step,
        L=L,
        dist=zeros,
        steps=izeros,
        result=izeros + ACTIVE,
        hit_pos=hit_pos,
        last_dir=last_dir,
        min_r=y[..., geodesic.IR],
        iter=0,
        min_az=zeros + 1e9 if track else None,
        gpos=hit_pos if track else None,
        gdir=last_dir if track else None,
    )


# The carry's per-ray floating-point fields, which the tangent and
# cotangent guards span (steps, result and iter carry no derivative).
_FLOAT_FIELDS = ("y", "h", "L", "dist", "hit_pos", "last_dir", "min_r",
                 "min_az", "gpos", "gdir")


def guard_carry(carry: TraceCarry, guard) -> TraceCarry:
    """carry with guard(1, fields) applied to its floating-point fields
    (sensitivity.tangent_guard or cotangent_guard): per ray, the
    magnitude spans every slot, L's included."""
    names = [f for f in _FLOAT_FIELDS if getattr(carry, f) is not None]
    out = guard(1, tuple(getattr(carry, f) for f in names))
    return carry._replace(**dict(zip(names, out)))


def _advance(carry: TraceCarry, scene: Scene, step_fn, adaptive: bool,
             guard) -> TraceCarry:
    """The loop body of trace_rays: one trace_step, then guard (the
    tangent guard, or its primal under export) on the float fields."""
    return guard_carry(trace_step(carry, scene, step_fn, adaptive), guard)


def _primal(ray_ndim: int, tree):
    """tangent_guard's primal, for the exported loop: the guard is the
    identity there, and the program is not differentiated (a default
    jax.export artifact is not either)."""
    return tree


def _while_loop(carry: TraceCarry, scene: Scene, step_fn, adaptive: bool,
                max_steps: int) -> TraceCarry:
    """trace_rays's loop as torch._higher_order_ops.while_loop, which
    torch.export captures (the JAX package's while_loop: the same cond
    and body).  The carry is the counter (a 0-d int32 tensor) and
    TraceCarry's tensor fields.  The initial fields must have the
    body's strides (init_carry's min_r is a column view of y), and the
    body may not return one of its inputs (L passes through
    trace_step): so the fields start contiguous and the body returns
    copies."""
    names = [f for f in TraceCarry._fields
             if f != "iter" and getattr(carry, f) is not None]

    def unpack(fields):
        return carry._replace(iter=0, **dict(zip(names, fields)))

    def cond(it, *fields):
        return (it < max_steps) & (unpack(fields).result == ACTIVE).any()

    def body(it, *fields):
        c = _advance(unpack(fields), scene, step_fn, adaptive, _primal)
        return (it + 1,) + tuple(getattr(c, f).clone() for f in names)

    it = torch.zeros((), dtype=torch.int32, device=carry.y.device)
    it, *fields = torch._higher_order_ops.while_loop(
        cond, body,
        (it,) + tuple(getattr(carry, f).contiguous() for f in names))
    return unpack(fields)


def trace_rays(origins, directions, scene: Scene) -> Hit:
    """Trace rays (..., 3) to completion on their device (the XLA
    engine).  Before every step the host checks the step budget and
    whether any ray is still active, as the JAX package's while_loop
    cond does; the tangent guard (identity on the primal) follows every
    step, so torch.func.jvp through this engine guards each ray's
    tangent.  Reverse mode through it raises, as jax.grad through the
    while_loop does: grad.diff_trace is the reverse-mode trace.

    Under torch.export the same step runs inside a traced while_loop
    (_while_loop), which syncs the host once a step when called as the
    Python loop does."""
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    step_fn, adaptive = make_step_fn(scene)
    carry = init_carry(o, d, scene)
    max_steps = scene.config.max_steps
    if torch.compiler.is_exporting():
        carry = _while_loop(carry, scene, step_fn, adaptive, max_steps)
    else:
        while carry.iter < max_steps and bool((carry.result == ACTIVE).any()):
            carry = _advance(carry, scene, step_fn, adaptive,
                             sensitivity.tangent_guard)
    margin = (compute_capture_margin(o, d, scene)
              if float(scene.config.shadow_softness) > 0.0 else None)
    hit = finalize(carry, scene, margin=margin)
    return hit.map(lambda x: x.reshape(tuple(batch_shape) + x.shape[1:]))


def compute_capture_margin(origins, directions, scene: Scene):
    """(margin, valid) of the rays for the analytic soft shadow boundary.

    margin: derived.capture_margin_length from the conserved (L, Qc),
    positive = captured, differentiable in the rays and the scene.
    valid: the ray starts ingoing with C = Qc + (L - a)^2 > EPSILON; a
    primal-only predicate (finalize falls back to min_r elsewhere)."""
    bh = scene.blackhole
    y0, _, L, Qc = geodesic.init_null_rays_aug(
        origins, coords.normalize(directions), bh.mass, bh.a, bh.charge
    )
    margin = derived.capture_margin_length(L, Qc, bh.mass, bh.a, bh.charge)
    C = Qc + (L - bh.a) * (L - bh.a)
    valid = (y0[..., geodesic.IPR] < 0.0) & (C > EPSILON)
    return margin, valid


def finalize(carry: TraceCarry, scene: Scene, margin=None) -> Hit:
    """Convert the final carry into a shaded Hit.

    Under shadow_softness > 0 every visibility flip is softened: the disk
    emission is composited over the sky by the annulus window, over
    non-disk rays by the crossing opacity (when the carry tracks it), and
    the colour is scaled by a survival sigmoid of the capture margin
    (margin = (margin, valid) from compute_capture_margin) or of min_r.
    With a margin given the hard trapped-ray test is switched off for
    every ray, as in the JAX package (a known fault of the reference)."""
    bh = scene.blackhole
    cfg = scene.config
    result = torch.where(
        carry.result == ACTIVE, RayResult.MAX_STEPS, carry.result
    )
    final_cart = aug_to_cartesian(carry.y, bh.a)
    is_disk = result == RayResult.DISK
    pos = torch.where(is_disk[..., None], carry.hit_pos, final_cart)
    r_term = torch.linalg.vector_norm(pos, dim=-1)
    tdil = derived.time_dilation(r_term, bh.mass)
    is_horizon = result == RayResult.HORIZON

    disk_rgb, temp, doppler, grav = shading.shade_disk_hit(
        carry.hit_pos, carry.last_dir, bh, scene.disk, cfg, L=carry.L
    )
    if scene.env_map is not None:
        sky_rgb = shading.sample_environment(carry.last_dir, scene.env_map)
    else:
        sky_rgb = shading.sky_color(carry.last_dir)
    # Budget-exhausted rays that ended inside ~4M are trapped: paint them
    # black like captures instead of sky.
    is_trapped = (result == RayResult.MAX_STEPS) & (r_term < 4.0 * bh.mass)
    if margin is not None:
        is_trapped = torch.zeros_like(is_trapped)
    dark = (is_horizon | is_trapped)[..., None]
    soft = float(cfg.shadow_softness)
    if soft > 0.0:
        # Soft disk edges: emission over the straight-on sky by the
        # annulus window.
        window = shading.disk_edge_window(
            carry.hit_pos, scene.disk, soft * bh.mass
        )[..., None]
        disk_rgb = disk_rgb * window + sky_rgb * (1.0 - window)
    color = torch.where(
        is_disk[..., None], disk_rgb,
        torch.where(dark, torch.zeros_like(sky_rgb), sky_rgb),
    )
    if track_crossing(scene) and carry.min_az is not None:
        # Crossing opacity: disk emission at the closest in-band approach
        # to the plane, over every non-disk ray, by alpha(min_az) times
        # the annulus window (alpha -> sigmoid(3) at a graze).
        w = soft * bh.mass
        g_rgb, _, _, _ = shading.shade_disk_hit(
            carry.gpos, carry.gdir, bh, scene.disk, cfg, L=carry.L
        )
        window_g = shading.disk_edge_window(carry.gpos, scene.disk, w)
        alpha = torch.sigmoid(3.0 - carry.min_az / w)
        cw = (alpha * window_g)[..., None]
        color = torch.where(
            is_disk[..., None], color, color * (1.0 - cw) + g_rgb * cw
        )
    if soft > 0.0:
        # Survival of the shadow boundary: sigmoid(x - 3) of the ray's
        # height above the (prograde / retrograde by the sign of L)
        # photon orbit in units of softness * M; the analytic margin where
        # it is valid and the ray is not a disk hit, min_r elsewhere.
        sgn = torch.where(carry.L.detach() * bh.a >= 0.0, 1.0, -1.0)
        r_ph = derived.kerr_photon_orbit_radius(bh.mass, bh.spin, sgn)
        x_minr = (carry.min_r - r_ph) / (soft * bh.mass)
        if margin is not None:
            m_arr, m_valid = margin
            x_analytic = -m_arr / (soft * bh.mass)
            x = torch.where(m_valid & ~is_disk, x_analytic, x_minr)
        else:
            x = x_minr
        color = color * torch.sigmoid(x - 3.0)[..., None]
    one = torch.ones_like(tdil)

    # Slant optical depth of Sigma(r) = density_scale (r_in/r)^(3/5)
    # through the (possibly inclined) disk plane.
    disk = scene.disk
    incl = disk.inclination
    normal = torch.stack(
        [torch.zeros_like(incl), -torch.sin(incl), torch.cos(incl)], dim=-1
    )
    cos_slant = jabs(torch.sum(carry.last_dir * normal, dim=-1))
    r_plane = _disk_plane_radius(carry.hit_pos, incl)
    sigma = disk.density_scale * (
        disk.inner_radius / jmax(r_plane, EPSILON)
    ) ** 0.6
    tau = sigma / jmax(cos_slant, 1e-3)

    return Hit(
        result=result,
        position=pos,
        distance=carry.dist,
        steps=carry.steps,
        time_dilation=tdil,
        sky_direction=carry.last_dir,
        doppler=torch.where(is_disk, doppler, one),
        temperature=torch.where(is_disk, temp, torch.zeros_like(temp)),
        redshift=torch.where(is_disk, grav, one),
        color=color,
        optical_depth=torch.where(is_disk, tau, torch.zeros_like(tau)),
        min_r=carry.min_r,
    )
