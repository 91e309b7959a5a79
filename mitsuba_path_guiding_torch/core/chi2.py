"""Chi-square goodness-of-fit tester for spherical sampling routines (a
copy of the reference's core/chi2.py, numpy only).

The reference's signature statistical test (Mitsuba's
include/mitsuba/core/chisquare.h and src/tests/test_chisquare.cpp):
histogram samples from ``sample_fn`` over a (theta, phi) grid, numerically
integrate ``pdf_fn`` over each bin, and run a Pearson chi-square test with
low-count cell pooling.  The tests use it on the guiding mixtures.
"""
from __future__ import annotations

import numpy as np


def _chi2_sf_impl(x: float, k: int) -> float:
    """Survival function of the chi-square distribution via the regularized
    upper incomplete gamma function Q(k/2, x/2), computed with a
    series/continued-fraction split (Numerical Recipes gammq)."""
    a = 0.5 * k
    x = 0.5 * x
    if x < 0 or a <= 0:
        return 1.0
    if x == 0:
        return 1.0
    import math

    gln = math.lgamma(a)
    if x < a + 1.0:
        # series for P(a,x); Q = 1 - P
        ap = a
        summ = 1.0 / a
        delt = summ
        for _ in range(500):
            ap += 1.0
            delt *= x / ap
            summ += delt
            if abs(delt) < abs(summ) * 1e-12:
                break
        p = summ * math.exp(-x + a * math.log(x) - gln)
        return max(0.0, min(1.0, 1.0 - p))
    # continued fraction for Q(a,x)
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        de = d * c
        h *= de
        if abs(de - 1.0) < 1e-12:
            break
    q = math.exp(-x + a * math.log(x) - gln) * h
    return max(0.0, min(1.0, q))


chi2_sf = _chi2_sf_impl


def chi2_test_sphere(
    sample_dirs: np.ndarray,
    pdf_fn,
    n_theta: int = 20,
    n_phi: int = 40,
    sample_count: int | None = None,
    significance: float = 0.0025,
    min_exp_count: float = 5.0,
    quad_res: int = 8,
):
    """Run the test.  Returns (passed, p_value, message).

    ``sample_dirs``: (N, 3) unit vectors drawn from the sampler under test.
    ``pdf_fn``: maps (M, 3) directions -> (M,) pdf values (solid-angle
    measure).  The pdf is integrated per bin with a midpoint rule on a
    ``quad_res x quad_res`` sub-grid (the reference uses adaptive
    Gauss-Lobatto; midpoint at 8x8 on a 20x40 grid is accurate to ~1e-4
    for the smooth pdfs tested here).
    """
    n = sample_count if sample_count is not None else len(sample_dirs)
    d = np.asarray(sample_dirs, dtype=np.float64)
    theta = np.arccos(np.clip(d[:, 2], -1, 1))
    phi = np.arctan2(d[:, 1], d[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    ti = np.minimum((theta / np.pi * n_theta).astype(int), n_theta - 1)
    pi_ = np.minimum((phi / (2 * np.pi) * n_phi).astype(int), n_phi - 1)
    obs = np.zeros((n_theta, n_phi))
    np.add.at(obs, (ti, pi_), 1.0)

    # integrate pdf over each bin (midpoint in theta/phi with jacobian sin)
    tq = (np.arange(n_theta * quad_res) + 0.5) / (n_theta * quad_res) * np.pi
    pq = (np.arange(n_phi * quad_res) + 0.5) / (n_phi * quad_res) * (2 * np.pi)
    TT, PP = np.meshgrid(tq, pq, indexing="ij")
    dirs = np.stack(
        [np.sin(TT) * np.cos(PP), np.sin(TT) * np.sin(PP), np.cos(TT)], axis=-1
    ).reshape(-1, 3)
    pdf_vals = np.asarray(pdf_fn(dirs.astype(np.float32)), dtype=np.float64).reshape(TT.shape)
    dA = (np.pi / (n_theta * quad_res)) * (2 * np.pi / (n_phi * quad_res))
    cell_int = pdf_vals * np.sin(TT) * dA
    exp = cell_int.reshape(n_theta, quad_res, n_phi, quad_res).sum(axis=(1, 3)) * n

    # the pdf's total mass must match the mass of histogrammed samples —
    # samplers with rejection (e.g. VNDF below-horizon) pass only accepted
    # samples plus the total draw count, and the pdf integrates to <1
    total_exp = exp.sum()
    if not (0.9 <= total_exp / max(len(d), 1) <= 1.1):
        return (
            False,
            0.0,
            f"pdf mass {total_exp / n:.4f} != histogrammed fraction {len(d) / n:.4f}",
        )

    # pool low-expectation cells (reference chisquare.cpp pooling)
    obs_f = obs.ravel()
    exp_f = exp.ravel()
    order = np.argsort(exp_f)
    obs_f, exp_f = obs_f[order], exp_f[order]
    pooled_obs, pooled_exp = [], []
    acc_o = acc_e = 0.0
    for o, e in zip(obs_f, exp_f):
        acc_o += o
        acc_e += e
        if acc_e >= min_exp_count:
            pooled_obs.append(acc_o)
            pooled_exp.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e > 0 and pooled_exp:
        pooled_obs[-1] += acc_o
        pooled_exp[-1] += acc_e
    pooled_obs = np.array(pooled_obs)
    pooled_exp = np.array(pooled_exp)
    if len(pooled_exp) < 2:
        return False, 0.0, "too few usable bins"

    stat = np.sum((pooled_obs - pooled_exp) ** 2 / np.maximum(pooled_exp, 1e-12))
    dof = len(pooled_exp) - 1
    p = chi2_sf(float(stat), int(dof))
    passed = p >= significance
    msg = f"chi2={stat:.2f} dof={dof} p={p:.5f} (significance {significance})"
    return passed, p, msg
