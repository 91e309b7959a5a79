"""time_to_noise_s: seconds for the cell's render to reach a relative
variance of 0.01, extrapolated from the window's own image: its even and
odd units make two half-images, whose difference estimates the variance
(harness/noise.py)."""
from pgbench.harness.noise import time_to_noise


def read(run):
    return time_to_noise(run.window_s, run.relvar)
