"""Host-side microfacet-averaged transmittance tables (numpy quadrature);
a copy of the JAX package's models/microfacet_tables.py.

The reference ships precomputed rough-transmittance data
(data/microfacet, loaded by roughcoating.cpp as m_roughTransmittance and
validated by test_rtrans.cpp); here the table is
computed at scene-compile time by direct quadrature of the Walter 2007
single-scattering GGX BTDF.  Round-3 measurement: the smooth-Fresnel
stand-in (1 - F) underestimates the rough transmittance by up to ~48% at
grazing incidence for alpha >= 0.2 — hence the full model.
"""
from __future__ import annotations

import numpy as np

N_COS = 16  # table resolution over cos(theta) in [0, 1] (grid i/(N-1))


def fresnel_dielectric(cos_i, eta):
    """Unpolarized Fresnel reflectance, external incidence, eta = n2/n1."""
    cos_i = np.clip(cos_i, 0.0, 1.0)
    st2 = (1.0 - cos_i**2) / eta**2
    tir = st2 > 1.0
    cos_t = np.sqrt(np.maximum(1.0 - st2, 0.0))
    rs = (cos_i - eta * cos_t) / np.maximum(cos_i + eta * cos_t, 1e-12)
    rp = (eta * cos_i - cos_t) / np.maximum(eta * cos_i + cos_t, 1e-12)
    return np.where(tir, 1.0, 0.5 * (rs**2 + rp**2))


def _ggx_d(cos_m, alpha):
    c2 = np.clip(cos_m, 0.0, 1.0) ** 2
    denom = np.pi * (c2 * (alpha**2 - 1.0) + 1.0) ** 2
    return np.where(cos_m > 0, alpha**2 / np.maximum(denom, 1e-12), 0.0)


def _smith_g1(cos_v, alpha):
    c = np.clip(np.abs(cos_v), 1e-6, 1.0)
    t2 = (1.0 - c**2) / c**2
    return 2.0 / (1.0 + np.sqrt(1.0 + alpha**2 * t2))


def rough_transmittance(cos_i: float, alpha: float, eta: float,
                        n_th: int = 128, n_ph: int = 64) -> float:
    """Directional-hemispherical transmittance of a rough dielectric
    interface (Walter 2007 eq. 21 BTDF integrated over the transmission
    hemisphere)."""
    cos_i = float(max(cos_i, 2e-2))
    wi = np.array([np.sqrt(max(1.0 - cos_i**2, 0.0)), 0.0, cos_i])
    th = (np.arange(n_th) + 0.5) / n_th * (np.pi / 2)
    ph = (np.arange(n_ph) + 0.5) / n_ph * (2 * np.pi)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    wo = np.stack(
        [np.sin(TH) * np.cos(PH), np.sin(TH) * np.sin(PH), -np.cos(TH)], -1
    )
    eta_i, eta_o = 1.0, float(eta)
    m = -(eta_i * wi[None, None] + eta_o * wo)
    m /= np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-12)
    m = np.where(m[..., 2:3] < 0, -m, m)
    idm = np.abs((wi * m).sum(-1))
    odm = np.abs((wo * m).sum(-1))
    F = fresnel_dielectric(idm, eta_o)
    D = _ggx_d(m[..., 2], alpha)
    G = _smith_g1(wi[2], alpha) * _smith_g1(wo[..., 2], alpha)
    denom = (eta_i * (wi * m).sum(-1) + eta_o * (wo * m).sum(-1)) ** 2
    jac = idm * odm / (cos_i * np.abs(wo[..., 2]))
    ft = jac * eta_o**2 * (1.0 - F) * G * D / np.maximum(denom, 1e-12)
    integ = (
        (ft * np.abs(wo[..., 2]) * np.sin(TH)).sum()
        * (np.pi / 2 / n_th) * (2 * np.pi / n_ph)
    )
    # single-scattering quadrature can slightly exceed 1 at grazing
    return float(min(integ, 1.0))


def coat_transmittance_table(alpha: float, eta: float) -> np.ndarray:
    """(N_COS,) transmittance over the cos grid i/(N_COS-1); rough
    quadrature for alpha above the smooth threshold, exact (1 - F) below."""
    cos_grid = np.arange(N_COS) / (N_COS - 1)
    if alpha <= 1e-3:
        return (1.0 - fresnel_dielectric(cos_grid, eta)).astype(np.float32)
    return np.array(
        [rough_transmittance(c, alpha, eta) for c in cos_grid], np.float32
    )
