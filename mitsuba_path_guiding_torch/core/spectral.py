"""N-bin spectral support: CIE tables, spectrum <-> RGB, blackbody, .spd
files, Cauchy dispersion (a copy of the reference's core/spectral.py,
numpy float64 only, so its values are the reference's).

Spectra are host-side bin vectors: the spectral integrators
(integrators/spectral.py) render one wave per bin (or three bins packed in
the RGB channels) with bin-evaluated material parameters and combine the
bins through the CIE colour matching functions.

Tables: CIE 1931 2-degree standard observer sampled at 10 nm over
380-730 nm (public colorimetric data), linear-sRGB conversion via the
standard D65 matrix.
"""
from __future__ import annotations

import numpy as np

LAMBDA_MIN = 380.0
LAMBDA_MAX = 730.0

# CIE 1931 2-deg observer, 380..730 nm step 10 (x̄, ȳ, z̄)
_CIE = np.array([
    [0.0014, 0.0000, 0.0065], [0.0042, 0.0001, 0.0201], [0.0143, 0.0004, 0.0679],
    [0.0435, 0.0012, 0.2074], [0.1344, 0.0040, 0.6456], [0.2839, 0.0116, 1.3856],
    [0.3483, 0.0230, 1.7471], [0.3362, 0.0380, 1.7721], [0.2908, 0.0600, 1.6692],
    [0.1954, 0.0910, 1.2876], [0.0956, 0.1390, 0.8130], [0.0320, 0.2080, 0.4652],
    [0.0049, 0.3230, 0.2720], [0.0093, 0.5030, 0.1582], [0.0633, 0.7100, 0.0782],
    [0.1655, 0.8620, 0.0422], [0.2904, 0.9540, 0.0203], [0.4334, 0.9950, 0.0087],
    [0.5945, 0.9950, 0.0039], [0.7621, 0.9520, 0.0021], [0.9163, 0.8700, 0.0017],
    [1.0263, 0.7570, 0.0011], [1.0622, 0.6310, 0.0008], [1.0026, 0.5030, 0.0003],
    [0.8544, 0.3810, 0.0002], [0.6424, 0.2650, 0.0000], [0.4479, 0.1750, 0.0000],
    [0.2835, 0.1070, 0.0000], [0.1649, 0.0610, 0.0000], [0.0874, 0.0320, 0.0000],
    [0.0468, 0.0170, 0.0000], [0.0227, 0.0082, 0.0000], [0.0114, 0.0041, 0.0000],
    [0.0058, 0.0021, 0.0000], [0.0029, 0.0010, 0.0000], [0.0014, 0.0005, 0.0000],
])
_CIE_LAMBDA = np.arange(380.0, 740.0, 10.0)


def _trapezoid(y, x):
    """numpy's trapezoid rule, written out (np.trapezoid needs numpy 2)."""
    return (np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum()


# integral of ybar over the range (for luminance normalization)
_CIE_Y_INT = float(_trapezoid(_CIE[:, 1], _CIE_LAMBDA))

_XYZ_TO_SRGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
])
_SRGB_TO_XYZ = np.linalg.inv(_XYZ_TO_SRGB)


def bin_edges(n_bins: int):
    return np.linspace(LAMBDA_MIN, LAMBDA_MAX, n_bins + 1)


def bin_centers(n_bins: int):
    e = bin_edges(n_bins)
    return 0.5 * (e[:-1] + e[1:])


def cmf_at(lam):
    """CIE (x̄, ȳ, z̄) at wavelengths lam (nm), linear interpolation."""
    lam = np.asarray(lam, dtype=np.float64)
    out = np.stack(
        [np.interp(lam, _CIE_LAMBDA, _CIE[:, i], left=0.0, right=0.0)
         for i in range(3)], axis=-1
    )
    return out


def spectrum_to_xyz(values, n_bins: int | None = None):
    """Bin spectrum (radiance per nm, piecewise constant) -> CIE XYZ.
    values (..., B)."""
    values = np.asarray(values, dtype=np.float64)
    B = values.shape[-1] if n_bins is None else n_bins
    lam = bin_centers(B)
    width = (LAMBDA_MAX - LAMBDA_MIN) / B
    cmf = cmf_at(lam)  # (B, 3)
    return (values[..., None] * cmf).sum(-2) * width / _CIE_Y_INT


def spectrum_to_rgb(values, n_bins: int | None = None):
    xyz = spectrum_to_xyz(values, n_bins)
    return xyz @ _XYZ_TO_SRGB.T


def rgb_to_spectrum(rgb, n_bins: int):
    """Smits-style smooth spectral upsampling of linear sRGB reflectances:
    non-negative least squares over {white, cyan, magenta, yellow, r, g, b}
    box basis functions (spectrum.cpp's RGB->Spectrum path)."""
    lam = bin_centers(n_bins)
    # smooth triangular basis: blue ~440, green ~545, red ~620
    blue = np.clip(1.0 - np.abs(lam - 440.0) / 80.0, 0.0, 1.0)
    green = np.clip(1.0 - np.abs(lam - 545.0) / 80.0, 0.0, 1.0)
    red = np.clip(1.0 - np.abs(lam - 620.0) / 90.0, 0.0, 1.0)
    basis = np.stack([red, green, blue], axis=0)  # (3, B)
    # normalize each basis so its own rgb projection is ~ the unit channel
    M = np.stack([spectrum_to_rgb(b, n_bins) for b in basis])  # (3, 3)
    rgb = np.asarray(rgb, dtype=np.float64)
    coef = np.linalg.solve(M.T, rgb.reshape(-1, 3).T).T  # (N, 3)
    spec = np.maximum(coef @ basis, 0.0)
    return spec.reshape(rgb.shape[:-1] + (n_bins,))


def blackbody(temperature: float, n_bins: int, normalize: bool = True):
    """Planck emitter spectrum over the bins (spectrum.cpp BlackBodySpectrum);
    normalized to unit luminance by default."""
    lam = bin_centers(n_bins) * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    rad = (2 * h * c * c) / (lam**5 * (np.exp(h * c / (lam * kb * temperature)) - 1.0))
    if normalize:
        y = spectrum_to_xyz(rad, n_bins)[1]
        rad = rad / max(y, 1e-30)
    return rad


def load_spd(path: str, n_bins: int):
    """Read a reference .spd file (data/ior/*.spd: "wavelength value" per
    line, '#' comments — InterpolatedSpectrum file format) and resample to
    the bin centers."""
    lams, vals = [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        a, b = line.split()[:2]
        lams.append(float(a))
        vals.append(float(b))
    return np.interp(bin_centers(n_bins), lams, vals)


def cauchy_ior(lam_nm, b: float = 1.5046, c: float = 0.00420):
    """Cauchy dispersion model eta(lambda) = B + C / lambda_um^2 (the
    standard glass fit; the reference exposes measured .spd IORs, this is
    the analytic equivalent for the dispersive integrator)."""
    lam_um = np.asarray(lam_nm, dtype=np.float64) * 1e-3
    return b + c / (lam_um * lam_um)
