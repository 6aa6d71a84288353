"""The plain reference: Kerr-Newman null geodesics, RK4, disk shading.

Plain PyTorch, with no import from the program under test.  It follows
the published algorithm the program implements (the upstream project's
Boyer-Lindquist Hamiltonian flow on the trig-augmented state, the
radius-scheduled RK4 step, the thin disk crossed between two steps, the
blackbody disk with the Kerr circular-orbit g-factor and Doppler
beaming, the sky gradient): a frozen, independent restatement of one
integration step, written once over plain tensors and over Duals
(reference.dual), so the same code gives colours and their forward
tangents.

Rays retire as they finish; every `check` steps the batch is compacted
to the rays still integrating, so the work follows the steps the rays
need and not the longest ray's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from bhbench.reference import dual as D
from bhbench.reference.dual import Dual

EPS = 1e-9
HORIZON_CAPTURE_FACTOR = 1.01
TANGENT_LIMIT = 1.0e6

ACTIVE, HORIZON, DISK, BACKGROUND, MAX_DISTANCE, MAX_STEPS = -1, 0, 1, 2, 3, 4

# Disk temperature and palette (K).
MIN_TEMP_K, MAX_TEMP_K = 1000.0, 40000.0
DISK_TEMP_BASE_K, DISK_TEMP_RANGE_K = 2000.0, 18000.0


@dataclasses.dataclass(frozen=True)
class RefScene:
    """What a trace reads of a configuration.  mass and spin may be
    Duals (the gradient reference); the rest are numbers."""

    mass: object
    spin: object
    charge: float
    disk_inner: float
    disk_outer: float
    temperature_scale: float
    inclination: float
    time_step: float
    max_ray_distance: float
    max_steps: int
    disk_on: bool = True


# ---- cameras ---------------------------------------------------------


def halton(index: int, base: int) -> float:
    """Radical inverse of index in base, in float32 as the program's
    jitter is (32 digits)."""
    i = int(index)
    f = torch.tensor(1.0, dtype=torch.float32)
    out = torch.tensor(0.0, dtype=torch.float32)
    for _ in range(32):
        f = f / base
        out = out + f * float(i % base)
        i //= base
    return float(out)


def jitter(sample: int, samples: int):
    """The Halton sub-pixel offset of one sample (0.5, 0.5 for one)."""
    if samples <= 1:
        return 0.5, 0.5
    half = torch.tensor(0.5, dtype=torch.float32)
    return tuple(float(half + (torch.tensor(halton(sample, b)) - half) * 1.0)
                 for b in (2, 3))


def _normalize(v):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n < EPS, torch.zeros_like(v),
                       v / torch.clamp(n, min=EPS))


def orbit_position(distance, elevation_deg, azimuth_deg):
    """Camera position on an orbit around the origin (z up)."""
    el = math.radians(elevation_deg)
    az = math.radians(azimuth_deg)
    return (distance * math.cos(el) * math.sin(az),
            -distance * math.cos(el) * math.cos(az),
            distance * math.sin(el))


def pixel_rays(position, direction, up, fov_deg, width, height, px, py,
               ox=0.5, oy=0.5, device="cpu", dtype=torch.float32):
    """Pinhole rays (origins, directions), each (N, 3), through the
    pixels (px, py) (int tensors (N,), row 0 at the top) at the
    sub-pixel offset (ox, oy).  The pixel grid is float32, the image
    plane's extent the camera's type."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(position, **f32)
    fwd = _normalize(torch.tensor(direction, **f32))
    right = _normalize(torch.linalg.cross(fwd, torch.tensor(up, **f32)))
    upv = torch.linalg.cross(right, fwd)
    plane_h = 2.0 * torch.tan(0.5 * (torch.tensor(fov_deg, **f32)
                                     * (math.pi / 180.0)))
    plane_w = plane_h * (width / height)
    x = px.to(**f32)
    y = py.to(**f32)
    ndc_x = (2.0 * (x + ox) / width - 1.0) * plane_w
    ndc_y = (1.0 - 2.0 * (y + oy) / height) * plane_h
    d = fwd[None] + ndc_x[:, None] * right[None] + ndc_y[:, None] * upv[None]
    d = _normalize(d)
    o = pos.expand_as(d)
    return o.to(dtype).contiguous(), d.to(dtype).contiguous()


def image_rays(camera: dict, width: int, height: int, ox=0.5, oy=0.5,
               device="cpu", dtype=torch.float32):
    """Rays of every pixel of a width x height image, in raster order."""
    yy, xx = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    return pixel_rays(camera["position"], camera["direction"],
                      camera["up"], camera["fov_deg"], width, height,
                      xx.reshape(-1), yy.reshape(-1), ox, oy, device, dtype)


# ---- the scene's scalars ----------------------------------------------


def scene_scalars(s: RefScene):
    """(M, a, Q, r_capture, r_shell_min) of a scene; Duals where mass or
    spin are."""
    M, spin = s.mass, s.spin
    a = spin * M
    Q = s.charge
    r_plus = M + D.sqrt(D.clamp_min(M * M - a * a - Q * Q, 0.0))
    r_capture = HORIZON_CAPTURE_FACTOR * r_plus
    # Prograde equatorial photon orbit (Bardeen 1972), the early shell
    # capture's radius.
    r_shell = 2.0 * M * (1.0 + D.cos(
        (2.0 / 3.0) * D.arccos(D.jclip(-D.jabs(spin), -1.0, 1.0))))
    return M, a, Q, r_capture, r_shell


# ---- initial photon state ---------------------------------------------


def init_rays(o, d, M, a, Q):
    """Boyer-Lindquist state (r, th, ph, p_r, p_th), trig and the
    conserved L (E = 1) of photons leaving o along d (N, 3).  The BL
    velocity is the directional derivative of the exact cartesian ->
    BL map along the unit direction, written out by hand."""
    d = _normalize(d)
    x, yy, z = o[:, 0], o[:, 1], o[:, 2]
    # Off the polar axis, where the map is not smooth.
    rel = 2e-3 if o.dtype != torch.float64 else 1e-6
    rho2 = x * x + yy * yy
    r2o = rho2 + z * z
    nudge = torch.where(rho2 < (rel * rel) * r2o,
                        rel * torch.sqrt(torch.clamp(r2o, min=EPS)),
                        torch.zeros_like(x))
    x = x + nudge
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    rho2 = x * x + yy * yy + z * z
    drho2 = 2.0 * (x * dx + yy * dy + z * dz)
    a2 = a * a
    half = 0.5 * (rho2 - a2)
    dhalf = 0.5 * drho2
    S = D.sqrt(half * half + a2 * z * z)
    dS = (half * dhalf + a2 * z * dz) / S
    r2 = half + S
    r = D.sqrt(D.clamp_min(r2, EPS))
    dr = 0.5 * (dhalf + dS) / r
    rs = D.clamp_min(r, EPS)
    c = D.clamp(z / rs, -1.0, 1.0)
    th = D.arccos(c)
    dc = (dz - (z / rs) * dr) / rs
    dth = -dc * D.rsqrt(1.0 - c * c)
    ph = torch.atan2(yy, x)
    ph = torch.where(ph < 0.0, ph + 2.0 * math.pi, ph)
    dph = (x * dy - yy * dx) / (x * x + yy * yy)

    st, ct = D.sin(th), D.cos(th)
    st2 = st * st
    sigma = r * r + a2 * ct * ct
    delta = r * r - 2.0 * M * r + a2 + Q * Q
    tm = 2.0 * M * r - Q * Q
    g_tt = -(1.0 - tm / sigma)
    g_tphi = -tm * a * st2 / sigma
    g_rr = sigma / delta
    g_thth = sigma
    g_phph = (r * r + a2 + tm * a2 * st2 / sigma) * st2
    # Null condition for dt; E, L, p_r, p_th; then E scaled to 1.
    S2 = g_rr * dr * dr + g_thth * dth * dth + g_phph * dph * dph
    disc = D.clamp_min(g_tphi * g_tphi * dph * dph - g_tt * S2, 0.0)
    dt = (g_tphi * dph + D.sqrt(disc)) / D.clamp_min(-g_tt, EPS)
    E = -(g_tt * dt + g_tphi * dph)
    L = g_tphi * dt + g_phph * dph
    inv_E = 1.0 / D.clamp_min(E, EPS)
    return dict(r=r, th=th, ph=ph, pr=g_rr * dr * inv_E,
                pth=g_thth * dth * inv_E, st=st, ct=ct,
                sp=torch.sin(ph), cp=torch.cos(ph)), L * inv_E


# ---- one step ----------------------------------------------------------


def _rhs(r, pr, pth, st, ct, sp, cp, L, M, a, Q):
    """Closed-form geodesic RHS on the trig-augmented state (E = 1):
    (dr, dth, dph, dpr, dpth, dt, dst, dct, dsp, dcp)."""
    st2 = D.jmax(st * st, EPS)
    a2 = a * a
    rr = r * r
    sigma = rr + a2 * ct * ct
    delta = rr - 2.0 * M * r + a2 + Q * Q
    tm = 2.0 * M * r - Q * Q
    r2a2 = rr + a2
    A = r2a2 * r2a2 - delta * a2 * st2
    inv_sd = 1.0 / (sigma * delta)
    inv_s = 1.0 / sigma
    num = delta - a2 * st2

    dr = delta * inv_s * pr
    dth = inv_s * pth
    g_tphi = -tm * a * inv_sd
    dph = -g_tphi + num * inv_sd / st2 * L
    dtt = A * inv_sd + g_tphi * L

    ds = 2.0 * r
    ddel = 2.0 * r - 2.0 * M
    dA = 4.0 * r * r2a2 - ddel * a2 * st2
    dinv_sd = -(ds * delta + sigma * ddel) * inv_sd * inv_sd
    dH_dr = 0.5 * (
        -(dA * inv_sd + A * dinv_sd)
        + 2.0 * a * (2.0 * M * inv_sd + tm * dinv_sd) * L
        + (ddel * inv_sd + num * dinv_sd) / st2 * L * L
        + (ddel * sigma - delta * ds) * inv_s * inv_s * pr * pr
        - ds * inv_s * inv_s * pth * pth
    )
    dst2 = 2.0 * st * ct
    ds_th = -a2 * dst2
    dA_th = -delta * a2 * dst2
    dinv_sd_th = -(ds_th * delta) * inv_sd * inv_sd
    dH_dth = 0.5 * (
        -(dA_th * inv_sd + A * dinv_sd_th)
        + 2.0 * tm * a * dinv_sd_th * L
        + (ds_th * inv_sd / st2 + num * dinv_sd_th / st2
           - num * inv_sd * dst2 / (st2 * st2)) * L * L
        - delta * ds_th * inv_s * inv_s * pr * pr
        - ds_th * inv_s * inv_s * pth * pth
    )
    return (dr, dth, dph, -dH_dr, -dH_dth, dtt,
            ct * dth, -st * dth, cp * dph, -sp * dph)


_Y = ("r", "th", "ph", "pr", "pth", "t", "st", "ct", "sp", "cp")
# The per-ray floating slots whose tangents the guard spans.
_GUARDED = _Y + ("dist", "hx", "hy", "hz", "lx", "ly", "lz", "min_r")


def _cart(r, st, ct, sp, cp, a):
    rho = D.sqrt(r * r + a * a) * st
    return rho * cp, rho * sp, r * ct


def _slave(s):
    """Trig tangents slaved to the angles' (d sin = cos d, ...)."""
    def tan(x):
        return x.d if isinstance(x, Dual) else None

    dth, dph = tan(s["th"]), tan(s["ph"])
    for name, base, dang, sign, other in (
            ("st", "ct", dth, 1.0, None), ("ct", "st", dth, -1.0, None),
            ("sp", "cp", dph, 1.0, None), ("cp", "sp", dph, -1.0, None)):
        v = D.value(s[name])
        if dang is None:
            s[name] = v
        else:
            s[name] = Dual(v, sign * dang * D.value(s[base]))
    return s


def _guard(s):
    """Per ray and direction: tangents rescaled to magnitude at most
    TANGENT_LIMIT over every slot, non-finite ones zeroed."""
    ds = [s[k].d for k in _GUARDED if isinstance(s[k], Dual)
          and s[k].d is not None]
    if not ds:
        return s
    mag = None
    for d in ds:
        a = torch.abs(d)
        mag = a if mag is None else torch.maximum(mag, a)
    factor = torch.full_like(mag, TANGENT_LIMIT) / torch.clamp(
        mag, min=TANGENT_LIMIT)
    factor = torch.where(torch.isfinite(mag), factor, 0.0)
    for k in _GUARDED:
        x = s[k]
        if isinstance(x, Dual) and x.d is not None:
            s[k] = Dual(x.v, torch.where(torch.isfinite(x.d), x.d, 0.0)
                        * factor)
    return s


def step(s, L, sc, gradient: bool):
    """One masked RK4 step of every ray in the state dict s (slots _Y,
    dist, steps, result, hx..hz, lx..lz, min_r), the disk crossing and
    the retirement tests.  sc: the scene's scalars (scalars())."""
    M, a, Q = sc["M"], sc["a"], sc["Q"]
    dt, max_dist, r_cap = sc["dt"], sc["max_dist"], sc["r_capture"]
    result = s["result"]
    active = result == ACTIVE
    r = s["r"]
    h = dt * D.jclip(r / (7.5 * (2.0 * M)), 0.05, 20.0)
    h = D.jmin(h, 0.5 * (r - r_cap) + 1e-3 * dt)
    h = D.jmax(h, 1e-4 * dt)

    cur = tuple(s[k] for k in _Y)

    def f(c):
        return _rhs(c[0], c[3], c[4], c[6], c[7], c[8], c[9], L, M, a, Q)

    def adv(c, coef, k):
        return tuple(ci + coef * ki for ci, ki in zip(c, k))

    k1 = f(cur)
    k2 = f(adv(cur, 0.5 * h, k1))
    k3 = f(adv(cur, 0.5 * h, k2))
    k4 = f(adv(cur, h, k3))
    sixth = h / 6.0
    new = tuple(c + sixth * (a1 + 2.0 * (a2 + a3) + a4)
                for c, a1, a2, a3, a4 in zip(cur, k1, k2, k3, k4))
    finite = D.isfinite(new[0])
    for c in new[1:5]:
        finite = finite & D.isfinite(c)
    advance = active & finite
    n = {k: D.where(advance, v, s[k]) for k, v in zip(_Y, new)}
    nth = D.rsqrt(D.jmax(n["st"] * n["st"] + n["ct"] * n["ct"], 0.25))
    nph = D.rsqrt(D.jmax(n["sp"] * n["sp"] + n["cp"] * n["cp"], 0.25))
    n["st"], n["ct"] = n["st"] * nth, n["ct"] * nth
    n["sp"], n["cp"] = n["sp"] * nph, n["cp"] * nph
    if gradient:
        n = _slave(n)

    cx, cy, cz = _cart(s["r"], s["st"], s["ct"], s["sp"], s["cp"], a)
    nx, ny, nz = _cart(n["r"], n["st"], n["ct"], n["sp"], n["cp"], a)
    ddx, ddy, ddz = nx - cx, ny - cy, nz - cz
    step_len = D.sqrt(ddx * ddx + ddy * ddy + ddz * ddz + 1e-24)
    inv_len = 1.0 / D.jmax(step_len, EPS)
    zero = torch.zeros_like(D.value(r))
    n["dist"] = s["dist"] + D.where(advance, step_len, zero)
    n["lx"] = D.where(advance, ddx * inv_len, s["lx"])
    n["ly"] = D.where(advance, ddy * inv_len, s["ly"])
    n["lz"] = D.where(advance, ddz * inv_len, s["lz"])
    hx, hy, hz = s["hx"], s["hy"], s["hz"]

    if sc["disk_on"]:
        si, ci = sc["sin_incl"], sc["cos_incl"]
        z0 = -si * cy + ci * cz
        z1 = -si * ny + ci * nz
        crossed = (D.value(z0) * D.value(z1) < 0.0) & advance
        den = z0 - z1
        frac = z0 / D.where(torch.abs(D.value(den)) < EPS, EPS, den)
        px, py, pz = cx + frac * ddx, cy + frac * ddy, cz + frac * ddz
        yp = ci * py + si * pz
        pxv, ypv = D.value(px), D.value(yp)
        r_plane = torch.sqrt(pxv * pxv + ypv * ypv)
        hit = crossed & (r_plane >= sc["disk_inner"]) & (
            r_plane <= sc["disk_outer"])
        result = torch.where(hit, DISK, result)
        hx, hy, hz = (D.where(hit, p, q) for p, q in
                      ((px, hx), (py, hy), (pz, hz)))
        n["dist"] = D.where(hit, s["dist"] + frac * step_len, n["dist"])

    rn, prn = D.value(n["r"]), D.value(n["pr"])

    def retire(cond, code):
        nonlocal result, hx, hy, hz
        result = torch.where(cond, code, result)
        hx, hy, hz = (D.where(cond, p, q) for p, q in
                      ((nx, hx), (ny, hy), (nz, hz)))

    still = result == ACTIVE
    captured = still & active & (
        (rn <= D.value(r_cap)) | ((prn < 0.0) & (
            rn < 0.999 * D.value(sc["r_shell"])))
        | (prn < -1e6) | (torch.abs(prn) > 1e7) | ~finite)
    retire(captured, HORIZON)
    still = result == ACTIVE
    retire(still & advance & (D.value(n["dist"]) >= max_dist), MAX_DISTANCE)
    still = result == ACTIVE
    retire(still & advance & (rn >= max_dist) & (prn > 0.0), BACKGROUND)

    n.update(result=result, hx=hx, hy=hy, hz=hz,
             steps=s["steps"] + active.to(s["steps"].dtype),
             min_r=D.where(advance, D.jmin(s["min_r"], n["r"]),
                           s["min_r"]))
    if gradient:
        n = _guard(n)
    return n


def scalars(scene: RefScene, dtype, device):
    """The scene's scalars for step(): M, a, Q and the radii as (1,)
    tensors (or Duals) of dtype on device, the rest numbers."""
    scene = dataclasses.replace(scene, mass=_to(scene.mass, dtype, device),
                                spin=_to(scene.spin, dtype, device))
    M, a, Q, r_cap, r_shell = scene_scalars(scene)
    incl = scene.inclination
    return dict(M=M, a=a, Q=Q, r_capture=r_cap, r_shell=r_shell,
                dt=scene.time_step, max_dist=scene.max_ray_distance,
                disk_inner=scene.disk_inner, disk_outer=scene.disk_outer,
                sin_incl=math.sin(incl), cos_incl=math.cos(incl),
                disk_on=scene.disk_on)


def _to(x, dtype, device):
    """A number or a Dual as a (1,) tensor of dtype on device."""
    if isinstance(x, Dual):
        return Dual(_to(x.v, dtype, device),
                    None if x.d is None else x.d.to(dtype=dtype,
                                                    device=device))
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(1)


def trace(o, d, scene: RefScene, check: int = 8):
    """Integrate the rays (N, 3) of a scene to retirement or its step
    budget.  Returns the final state dict and L in the rays' order."""
    gradient = isinstance(scene.mass, Dual) or isinstance(scene.spin, Dual)
    dtype, device = o.dtype, o.device
    sc = scalars(scene, dtype, device)
    y, L = init_rays(o, d, sc["M"], sc["a"], sc["Q"])
    n = o.shape[0]
    zero = torch.zeros(n, dtype=dtype, device=device)
    dn = _normalize(d)
    s = dict(y, t=zero, dist=zero, min_r=y["r"],
             steps=torch.zeros(n, dtype=torch.int32, device=device),
             result=torch.full((n,), ACTIVE, dtype=torch.int32,
                               device=device),
             hx=o[:, 0], hy=o[:, 1], hz=o[:, 2],
             lx=dn[:, 0], ly=dn[:, 1], lz=dn[:, 2])
    idx = torch.arange(n, device=device)
    done = []
    for i in range(scene.max_steps):
        if i % check == 0:
            live = s["result"] == ACTIVE
            n_live = int(live.sum())
            if n_live == 0:
                break
            if n_live < 0.9 * idx.shape[0]:
                done.append((idx[~live], {k: D.take(v, ~live)
                                          for k, v in s.items()},
                             D.take(L, ~live)))
                idx, L = idx[live], D.take(L, live)
                s = {k: D.take(v, live) for k, v in s.items()}
        active = s["result"] == ACTIVE
        new = step(s, L, sc, gradient)
        s = {k: (new[k] if k in ("result", "steps") else
                 D.where(active, new[k], s[k])) for k in s}
    done.append((idx, s, L))
    order = torch.argsort(torch.cat([i for i, _, _ in done]))
    final = {k: D.take(D.cat([st[k] for _, st, _ in done]), order)
             for k in s}
    return final, D.take(D.cat([l for _, _, l in done]), order), sc


# ---- shading -----------------------------------------------------------


def _temperature_rgb(temp):
    t = (D.jclip(temp, MIN_TEMP_K, MAX_TEMP_K) - MIN_TEMP_K) / (
        MAX_TEMP_K - MIN_TEMP_K)
    tv = D.value(t)
    one = torch.ones_like(tv)
    zero = torch.zeros_like(tv)
    r = D.where(tv < 0.5, t * 2.0, one)
    g = D.where(tv < 0.25, zero, D.where(tv < 0.75, (t - 0.25) * 2.0, one))
    b = D.where(tv < 0.5, zero, (t - 0.5) * 2.0)
    bright = 0.2 + 0.8 * t * t
    return r * bright, g * bright, b * bright


def shade(final, L, scene: RefScene, sc):
    """Colours (r, g, b) of the final states: the disk's blackbody
    emission shifted by the Kerr circular-orbit g-factor and beamed,
    black for captured and trapped rays, the sky gradient elsewhere."""
    M, a, Q = sc["M"], sc["a"], sc["Q"]
    result = torch.where(final["result"] == ACTIVE, MAX_STEPS,
                         final["result"])
    fx, fy, fz = _cart(final["r"], final["st"], final["ct"], final["sp"],
                       final["cp"], a)
    is_disk = result == DISK
    hx, hy, hz = final["hx"], final["hy"], final["hz"]
    px, py, pz = (D.where(is_disk, h, f) for h, f in
                  ((hx, fx), (hy, fy), (hz, fz)))
    r_term = D.value(D.sqrt(px * px + py * py + pz * pz))
    dark = (result == HORIZON) | ((result == MAX_STEPS)
                                  & (r_term < 4.0 * D.value(M)))

    r_cyl = D.sqrt(hx * hx + hy * hy)
    rn = D.jclip((r_cyl - scene.disk_inner) / max(
        scene.disk_outer - scene.disk_inner, EPS), 0.0, 1.0)
    temp = scene.temperature_scale * (
        DISK_TEMP_BASE_K + DISK_TEMP_RANGE_K
        * D.jmax(1.0 - rn, 1e-9) ** 0.75)
    cr, cg, cb = _temperature_rgb(temp)
    if abs(math.sin(scene.inclination)) >= 1e-6:
        raise ValueError("the reference shades equatorial disks only")
    # Equatorial BL radius, the prograde circular orbit's g-factor and
    # the static observer's redshift.
    rb = D.jmax(D.sqrt(D.jmax(r_cyl * r_cyl - a * a, EPS)), EPS)
    sqM = D.sqrt(D.jmax(M, EPS))
    omega = sqM / (D.jmax(rb, EPS) ** 1.5 + a * sqM)
    tm = 2.0 * M * rb - Q * Q
    g_tt = -(1.0 - tm / (rb * rb))
    g_tphi = -tm * a / (rb * rb)
    g_phph = rb * rb + a * a + tm * a * a / (rb * rb)
    u2 = -(g_tt + 2.0 * omega * g_tphi + omega * omega * g_phph)
    den = 1.0 - omega * L
    g = D.sqrt(D.jmax(u2, EPS)) / D.where(
        torch.abs(D.value(den)) < EPS, EPS, den)
    g = D.jclip(g, 1e-3, 1e3)
    grav = 1.0 / D.sqrt(D.jmax(1.0 - (2.0 * M * rb - Q * Q) / (rb * rb),
                               EPS))
    doppler = g * grav
    shift = doppler / D.jmax(grav, EPS)
    redder = D.value(shift) < 1.0
    cr = D.where(redder, D.jmin(cr * (2.0 - shift), 1.0), cr * (2.0 - shift))
    cb = D.where(redder, cb * shift, D.jmin(cb * shift, 1.0))
    beam = doppler ** 4
    disk_rgb = [D.jclip(c * beam, 0.0, 1.0) for c in (cr, cg, cb)]

    t = 0.5 * (final["ly"] + 1.0)
    sky = [(1.0 - t) + 0.5 * t, (1.0 - t) + 0.7 * t,
           torch.ones_like(D.value(t))]
    zero = torch.zeros_like(r_term)
    return [D.where(is_disk, dc, D.where(dark, zero, sc_))
            for dc, sc_ in zip(disk_rgb, sky)]


def colours(o, d, scene: RefScene, check: int = 8):
    """(colour (N, 3) tensor or list of 3 Duals, steps (N,), result (N,))
    of rays (N, 3) under the scene."""
    final, L, sc = trace(o, d, scene, check)
    rgb = shade(final, L, scene, sc)
    result = torch.where(final["result"] == ACTIVE, MAX_STEPS,
                         final["result"])
    if not any(isinstance(c, Dual) for c in rgb):
        rgb = torch.stack(rgb, dim=-1)
    return rgb, final["steps"], result


def loss_and_grad(o, d, scene_of, mass: float, spin: float,
                  clip: float = 15.0, chunk: int | None = None):
    """The bench loss sum(colour) / 3N of rays (N, 3) and its derivative
    in (mass, spin) by forward mode, each ray's colour tangent
    winsorised to [-clip, clip].  scene_of(mass, spin) -> RefScene.
    Sums in float64.  chunk: rays per pass (None: all at once).
    Returns (loss, (dmass, dspin), steps (N,))."""
    dtype, device = o.dtype, o.device
    eye = torch.eye(2, dtype=dtype, device=device)
    m = Dual(torch.tensor([mass], dtype=dtype, device=device),
             eye[:, 0:1].clone())
    s = Dual(torch.tensor([spin], dtype=dtype, device=device),
             eye[:, 1:2].clone())
    n = o.shape[0]
    chunk = chunk or n
    total = torch.zeros((), dtype=torch.float64, device=device)
    dtotal = torch.zeros(2, dtype=torch.float64, device=device)
    steps = []
    for i in range(0, n, chunk):
        rgb, st, _ = colours(o[i:i + chunk], d[i:i + chunk],
                             scene_of(m, s))
        for c in rgb:
            total = total + D.value(c).double().sum()
            if isinstance(c, Dual) and c.d is not None:
                dtotal = dtotal + torch.clamp(c.d, -clip, clip).double().sum(
                    dim=tuple(range(1, c.d.dim())))
        steps.append(st)
    return (float(total) / (3 * n), tuple(float(x) / (3 * n)
                                          for x in dtotal), torch.cat(steps))
