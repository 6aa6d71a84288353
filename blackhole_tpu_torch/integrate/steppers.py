"""ODE steppers: RK4, RKF45 (embedded 4/5 pair), leapfrog, Yoshida-4.

PyTorch counterpart of blackhole_tpu.integrate.steppers.  The steppers
are pure functions of (f, t, y, h, args); accept/reject control lives
in the caller's loop (render.trace.trace_step).  The RKF45 tableau and
the step-size constants are also what the geodesic kernel takes
(render.trace_kernel and csrc/geodesic_step.cuh).
"""

import torch

from blackhole_tpu_torch.tangent_rules import jabs, jclip, jmax

# --- RKF45 Fehlberg tableau ---
_A = (0.0, 1.0 / 4.0, 3.0 / 8.0, 12.0 / 13.0, 1.0, 1.0 / 2.0)
_B21 = 1.0 / 4.0
_B31, _B32 = 3.0 / 32.0, 9.0 / 32.0
_B41, _B42, _B43 = 1932.0 / 2197.0, -7200.0 / 2197.0, 7296.0 / 2197.0
_B51, _B52, _B53, _B54 = 439.0 / 216.0, -8.0, 3680.0 / 513.0, -845.0 / 4104.0
_B61, _B62, _B63, _B64, _B65 = (
    -8.0 / 27.0,
    2.0,
    -3544.0 / 2565.0,
    1859.0 / 4104.0,
    -11.0 / 40.0,
)
_C = (25.0 / 216.0, 0.0, 1408.0 / 2565.0, 2197.0 / 4104.0, -1.0 / 5.0, 0.0)
_D = (
    16.0 / 135.0,
    0.0,
    6656.0 / 12825.0,
    28561.0 / 56430.0,
    -9.0 / 50.0,
    2.0 / 55.0,
)

# Step-size control constants.
SAFETY = 0.9
MIN_SCALE = 0.2
MAX_SCALE = 10.0


def rk4_step(f, t, y, h, args):
    """Classic fixed-step RK4.  f(t, y, args) -> dy/dt; y (..., n)."""
    k1 = f(t, y, args)
    k2 = f(t + 0.5 * h, y + 0.5 * h * k1, args)
    k3 = f(t + 0.5 * h, y + 0.5 * h * k2, args)
    k4 = f(t + h, y + h * k3, args)
    return y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rkf45_step(f, t, y, h, args, eps=1e-12, n_err=None):
    """One embedded Fehlberg 4(5) trial step.

    Returns (y5, max_rel_error): the 5th-order solution and the largest
    per-component relative difference between the embedded 4th and 5th
    order solutions, each over max(|y|, |y5|) floored at eps.  n_err:
    number of leading components in the error (default all; the trace
    passes 6, leaving out the slaved trig components)."""
    k1 = f(t, y, args)
    k2 = f(t + _A[1] * h, y + h * (_B21 * k1), args)
    k3 = f(t + _A[2] * h, y + h * (_B31 * k1 + _B32 * k2), args)
    k4 = f(t + _A[3] * h, y + h * (_B41 * k1 + _B42 * k2 + _B43 * k3), args)
    k5 = f(
        t + _A[4] * h,
        y + h * (_B51 * k1 + _B52 * k2 + _B53 * k3 + _B54 * k4),
        args,
    )
    k6 = f(
        t + _A[5] * h,
        y + h * (_B61 * k1 + _B62 * k2 + _B63 * k3 + _B64 * k4 + _B65 * k5),
        args,
    )
    y4 = y + h * (_C[0] * k1 + _C[2] * k3 + _C[3] * k4 + _C[4] * k5)
    y5 = y + h * (
        _D[0] * k1 + _D[2] * k3 + _D[3] * k4 + _D[4] * k5 + _D[5] * k6
    )
    ye, y4e, y5e = (
        (y, y4, y5) if n_err is None
        else (y[..., :n_err], y4[..., :n_err], y5[..., :n_err])
    )
    scale = jmax(jmax(jabs(ye), jabs(y5e)), eps)
    err = torch.amax(jabs(y5e - y4e) / scale, dim=-1)
    return y5, err


def rkf45_next_h(h, error_ratio, accepted):
    """Step-size update: accepted h *= SAFETY ratio^-0.2, rejected
    h *= SAFETY ratio^-0.25, the factor clamped to [MIN_SCALE,
    MAX_SCALE]; ratio 0 gives MAX_SCALE."""
    ratio = jmax(error_ratio, 1e-30)
    scale_ok = SAFETY * ratio**-0.2
    scale_bad = SAFETY * ratio**-0.25
    scale = torch.where(accepted, scale_ok, scale_bad)
    scale = torch.where(error_ratio <= 0.0, MAX_SCALE, scale)
    return h * jclip(scale, MIN_SCALE, MAX_SCALE)


def leapfrog_step(accel, t, x, v, h, args):
    """Kick-drift-kick leapfrog.  accel(t, x, v, args) -> a.
    Returns (x_new, v_new)."""
    a0 = accel(t, x, v, args)
    v_half = v + 0.5 * h * a0
    x_new = x + h * v_half
    a1 = accel(t + h, x_new, v_half, args)
    v_new = v_half + 0.5 * h * a1
    return x_new, v_new


# Yoshida 4th-order symplectic coefficients.
_CBRT2 = 2.0 ** (1.0 / 3.0)
_W1 = 1.0 / (2.0 - _CBRT2)
_W0 = -_CBRT2 * _W1
_YOSHIDA_C = (0.5 * _W1, 0.5 * (_W0 + _W1), 0.5 * (_W0 + _W1), 0.5 * _W1)
_YOSHIDA_D = (_W1, _W0, _W1)


def yoshida4_step(accel, t, x, v, h, args):
    """4th-order Yoshida symplectic composition.  Returns (x, v)."""
    for i in range(3):
        x = x + _YOSHIDA_C[i] * h * v
        a = accel(t, x, v, args)
        v = v + _YOSHIDA_D[i] * h * a
    x = x + _YOSHIDA_C[3] * h * v
    return x, v
