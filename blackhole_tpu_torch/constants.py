"""Physical and numerical constants for the black hole engine.

PyTorch counterpart of blackhole_tpu.constants.  Geometric units
G = c = 1 throughout.
"""

import math

PI = math.pi
TWO_PI = 2.0 * math.pi
HALF_PI = 0.5 * math.pi

# Numerical guard used throughout.
EPSILON = 1e-9

# Rays are considered captured once r <= HORIZON_CAPTURE_FACTOR * r_+.
HORIZON_CAPTURE_FACTOR = 1.01

# Blackbody color-mapping temperature range in Kelvin.
MIN_TEMP_K = 1000.0
MAX_TEMP_K = 40000.0

# Default disk temperature model constants.
DISK_TEMP_BASE_K = 2000.0
DISK_TEMP_RANGE_K = 18000.0
