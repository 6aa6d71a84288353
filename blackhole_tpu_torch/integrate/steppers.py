"""RKF45 Fehlberg tableau and step-size control constants.

PyTorch counterpart of the constants of blackhole_tpu.integrate.steppers
that the geodesic kernel takes (render.trace_kernel and
csrc/geodesic_step.cuh).  The steppers themselves belong to the XLA
engine's counterpart, not yet ported.
"""

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
