"""Sensor ray generation (port of the reference's models/sensor.py
``generate_rays`` and ``connect_to_sensor``): the perspective pinhole,
the thin lens and the radially distorted perspective, the orthographic,
spherical and telecentric cameras, and the irradiance, radiance and
fluence meters.

Camera space: x right, y up, +z forward; pixel (0, 0) is the top-left.
"""
from __future__ import annotations

import math

import torch

from mitsuba_path_guiding_torch.core.math import normalize
from mitsuba_path_guiding_torch.core.warp import (
    square_to_cosine_hemisphere,
    square_to_uniform_disk_concentric,
    square_to_uniform_sphere,
)
from mitsuba_path_guiding_torch.scene.types import Sensor, SensorKind


def _rotate(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """v @ r.T for (N, 3) v and a (3, 3) matrix, summed in a fixed order."""
    return torch.stack(
        [v[:, 0] * r[j, 0] + v[:, 1] * r[j, 1] + v[:, 2] * r[j, 2] for j in range(3)],
        dim=-1,
    )


def _film_plane(sensor: Sensor, ndc_x, ndc_y, aspect, z):
    """Points (N, 3) of the image plane at camera-space depth ``z``."""
    return torch.stack([ndc_x * sensor.tan_half_fov_x,
                        ndc_y * sensor.tan_half_fov_x * aspect, z], dim=-1)


def generate_rays(
    sensor: Sensor,
    width: int,
    height: int,
    pixel_id: torch.Tensor,
    u_pos: torch.Tensor,
    u_lens: torch.Tensor | None = None,
    kind: int = SensorKind.PERSPECTIVE,
):
    """Primary rays for flat pixel ids with sub-pixel jitter.

    pixel_id: (N,) int = y*width + x; u_pos: (N, 2) jitter in [0, 1);
    u_lens: (N, 2) aperture uniforms (the thin lens and the telecentric
    camera).  Returns (origin (N, 3), direction (N, 3), film_xy (N, 2))."""
    px = (pixel_id % width).to(torch.float32)
    py = torch.div(pixel_id, width, rounding_mode="floor").to(torch.float32)
    fx = px + u_pos[..., 0]
    fy = py + u_pos[..., 1]
    ndc_x = 2.0 * fx / width - 1.0
    ndc_y = 1.0 - 2.0 * fy / height
    aspect = height / width
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    n = fx.shape[0]
    film_xy = torch.stack([fx, fy], dim=-1)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=fx.device)

    def at_t(d_cam):
        return t.expand(n, 3).clone(), normalize(_rotate(d_cam, R)), film_xy

    if kind == SensorKind.ORTHOGRAPHIC:
        # parallel rays along +z; tan_half_fov_x is the half-width
        o_cam = _film_plane(sensor, ndc_x, ndc_y, aspect, torch.zeros_like(ndc_x))
        return _rotate(o_cam, R) + t, normalize(_rotate(z_axis.expand(n, 3), R)), film_xy

    if kind == SensorKind.SPHERICAL:
        # latitude-longitude capture: u -> phi, v -> theta
        theta = (fy / height) * math.pi
        phi = (fx / width) * 2.0 * math.pi - math.pi
        st = torch.sin(theta)
        return at_t(torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)],
                                dim=-1))

    if kind == SensorKind.TELECENTRIC:
        # orthographic, focused on the plane at focus_distance; points off
        # it blur with the aperture
        o_cam = _film_plane(sensor, ndc_x, ndc_y, aspect, torch.zeros_like(ndc_x))
        if u_lens is None:
            u_lens = torch.flip(u_pos, dims=[-1]) * 0.0 + 0.5  # the aperture's centre
        lens = square_to_uniform_disk_concentric(u_lens) * sensor.aperture_radius
        focus_p = o_cam + z_axis * sensor.focus_distance
        o_cam = o_cam + torch.cat([lens, torch.zeros_like(lens[..., :1])], dim=-1)
        return _rotate(o_cam, R) + t, normalize(_rotate(focus_p - o_cam, R)), film_xy

    if kind == SensorKind.RADIANCEMETER:
        # one fixed look direction: every sample measures the same ray
        return at_t(z_axis.expand(n, 3))

    if kind == SensorKind.FLUENCEMETER:
        # uniform sphere directions; meas_scale carries the 4 pi
        return at_t(square_to_uniform_sphere(u_pos))

    if kind == SensorKind.IRRADIANCEMETER:
        # cosine-weighted about +z; meas_scale carries the pi
        return at_t(square_to_cosine_hemisphere(u_pos))

    d_cam = _film_plane(sensor, ndc_x, ndc_y, aspect, torch.ones_like(ndc_x))
    if sensor.kc is not None:
        # radial distortion: the image-plane offset scaled by the kc
        # polynomial in r^2
        r2 = d_cam[..., 0] ** 2 + d_cam[..., 1] ** 2
        f = 1.0 + sensor.kc[0] * r2 + sensor.kc[1] * r2 * r2
        d_cam = torch.stack([d_cam[..., 0] * f, d_cam[..., 1] * f, d_cam[..., 2]], dim=-1)
    o_cam = torch.zeros_like(d_cam)
    if u_lens is not None:
        # thin lens: the origin on the aperture disk, refocused (with a
        # zero aperture and unit focus distance this is the pinhole's ray)
        lens = square_to_uniform_disk_concentric(u_lens) * sensor.aperture_radius
        focus_p = d_cam * (sensor.focus_distance / d_cam[..., 2:3])
        o_cam = torch.cat([lens, torch.zeros_like(lens[..., :1])], dim=-1)
        d_cam = focus_p - o_cam
    return _rotate(o_cam, R) + t, normalize(_rotate(d_cam, R)), film_xy


def connect_to_sensor(sensor: Sensor, width: int, height: int, p: torch.Tensor):
    """Adjoint query of a perspective pinhole (the light-image strategies'
    hook): project world points onto the film.

    Returns (film_xy (N, 2), dir_to_cam (N, 3), dist (N,), importance
    (N,), valid (N,)), importance = 1 / (A_pix * cos^3(theta) * d^2): the
    film-area Jacobian's cos^3 and the camera side's cos / d^2, with the
    point's cosine left to the caller's BSDF eval."""
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    w = p - t
    d_cam = _rotate(w, R.T)  # R^T w
    z = d_cam[..., 2]
    valid = z > sensor.near_clip
    zs = torch.where(valid, z, 1.0)
    aspect = height / width
    tanx = sensor.tan_half_fov_x
    ndc_x = d_cam[..., 0] / (zs * tanx)
    ndc_y = d_cam[..., 1] / (zs * tanx * aspect)
    fx = (ndc_x + 1.0) * 0.5 * width
    fy = (1.0 - ndc_y) * 0.5 * height
    valid = valid & (fx >= 0) & (fx < width) & (fy >= 0) & (fy < height)
    dist = torch.linalg.vector_norm(w, dim=-1)
    dir_to_cam = -w / torch.clamp_min(dist, 1e-12)[..., None]
    cos_t = zs / torch.clamp_min(dist, 1e-12)
    a_pix = (2.0 * tanx / width) * (2.0 * tanx * aspect / height)
    imp = 1.0 / torch.clamp_min(a_pix * cos_t ** 3 * dist * dist, 1e-12)
    return torch.stack([fx, fy], dim=-1), dir_to_cam, dist, torch.where(valid, imp, 0.0), valid
