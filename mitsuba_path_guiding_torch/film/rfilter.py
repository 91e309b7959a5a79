"""Reconstruction filters (port of the reference's film/rfilter.py): box,
tent, gaussian, mitchell, catmullrom and lanczos, as weight functions
w(dx) evaluated at splat time (``film.splat``)."""
from __future__ import annotations

import math

import torch

FILTERS = {}


def _register(name, radius):
    def deco(fn):
        FILTERS[name] = (fn, radius)
        return fn

    return deco


@_register("box", 0.5)
def box(x):
    return torch.where(torch.abs(x) <= 0.5, 1.0, 0.0)


@_register("tent", 1.0)
def tent(x):
    return torch.clamp_min(1.0 - torch.abs(x), 0.0)


@_register("gaussian", 2.0)
def gaussian(x, stddev=0.5):
    alpha = -1.0 / (2.0 * stddev * stddev)
    r = 2.0
    return torch.clamp_min(torch.exp(alpha * x * x) - math.exp(alpha * r * r), 0.0)


def _mitchell_family(x, B, C):
    ax = torch.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    y1 = ((12 - 9 * B - 6 * C) * ax3 + (-18 + 12 * B + 6 * C) * ax2 + (6 - 2 * B)) / 6
    y2 = ((-B - 6 * C) * ax3 + (6 * B + 30 * C) * ax2 + (-12 * B - 48 * C) * ax
          + (8 * B + 24 * C)) / 6
    return torch.where(ax < 1.0, y1, torch.where(ax < 2.0, y2, 0.0))


@_register("mitchell", 2.0)
def mitchell(x):
    return _mitchell_family(x, 1.0 / 3.0, 1.0 / 3.0)


@_register("catmullrom", 2.0)
def catmullrom(x):
    return _mitchell_family(x, 0.0, 0.5)


@_register("lanczos", 3.0)
def lanczos(x, tau=3.0):
    px = math.pi * torch.abs(x)
    core = torch.where(
        px < 1e-6, 1.0,
        torch.sin(px) / torch.clamp_min(px, 1e-6) * torch.sin(px / tau)
        / torch.clamp_min(px / tau, 1e-6))
    return torch.where(torch.abs(x) < tau, core, 0.0)


def get_filter(name: str):
    """(weight_fn, integer support radius) for a filter name."""
    if name not in FILTERS:
        raise ValueError(f"unknown reconstruction filter '{name}'")
    fn, radius = FILTERS[name]
    return fn, int(math.ceil(radius - 1e-6))
