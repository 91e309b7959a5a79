"""Keyframed animated transforms and deformable shapes.

Port of ``mitsuba_path_guiding_tpu/scene/animation.py`` (Mitsuba's
AnimatedTransform, track.h:151,335-420): each keyframe decomposes into
translation, rotation quaternion and scale, interpolated by lerp, slerp
and lerp.  Animation stays on the host in numpy float64, as in the
reference, so a baked matrix is the reference's bit for bit: the scene
compiler bakes geometry at a concrete time, and motion blur renders
time-jittered waves (integrators/motion.py).
"""
from __future__ import annotations

import numpy as np


def _decompose(m):
    """4x4 -> (translation (3,), rotation quaternion wxyz (4,), scale (3,)).
    Polar-decomposition-free variant for TRS matrices (track.h keyframes
    are built from TRS in practice)."""
    m = np.asarray(m, dtype=np.float64)
    t = m[:3, 3].copy()
    r = m[:3, :3].copy()
    s = np.linalg.norm(r, axis=0)
    if np.linalg.det(r) < 0:
        s[0] = -s[0]
    r = r / s
    # rotation matrix -> quaternion (w, x, y, z)
    tr = np.trace(r)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2.0
        q = np.array([
            w,
            (r[2, 1] - r[1, 2]) / (4 * w),
            (r[0, 2] - r[2, 0]) / (4 * w),
            (r[1, 0] - r[0, 1]) / (4 * w),
        ])
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        sq = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2.0
        q = np.zeros(4)
        q[0] = (r[k, j] - r[j, k]) / sq
        q[1 + i] = sq / 4.0
        q[1 + j] = (r[j, i] + r[i, j]) / sq
        q[1 + k] = (r[k, i] + r[i, k]) / sq
    return t, q / np.linalg.norm(q), s


def _compose(t, q, s):
    w, x, y, z = q
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    m = np.eye(4)
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = t
    return m


def _slerp(q0, q1, f):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + f * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - f) * th) * q0 + np.sin(f * th) * q1) / np.sin(th)


class AnimatedTransform:
    """Keyframed transform track (track.h AnimatedTransform parity)."""

    def __init__(self, times, transforms):
        order = np.argsort(np.asarray(times, dtype=np.float64))
        self.times = np.asarray(times, dtype=np.float64)[order]
        self.keys = [
            _decompose(np.asarray(transforms[i], dtype=np.float64)) for i in order
        ]
        self.mats = [np.asarray(transforms[i], dtype=np.float64) for i in order]
        if len(self.times) == 0:
            raise ValueError("AnimatedTransform needs >= 1 keyframe")

    @staticmethod
    def from_spec(spec):
        """{"times": [...], "transforms": [4x4,...]} or a plain matrix."""
        if isinstance(spec, dict) and "times" in spec:
            return AnimatedTransform(spec["times"], spec["transforms"])
        return AnimatedTransform([0.0], [spec])

    def eval(self, t: float) -> np.ndarray:
        """Interpolated 4x4 at time t (track.h:335-420 eval: lerp T/S,
        slerp R; clamped outside the keyframe range)."""
        ts = self.times
        if len(ts) == 1 or t <= ts[0]:
            return self.mats[0]
        if t >= ts[-1]:
            return self.mats[-1]
        i = int(np.searchsorted(ts, t, side="right")) - 1
        f = (t - ts[i]) / max(ts[i + 1] - ts[i], 1e-12)
        t0, q0, s0 = self.keys[i]
        t1, q1, s1 = self.keys[i + 1]
        return _compose(
            t0 + f * (t1 - t0), _slerp(q0, q1, f), s0 + f * (s1 - s0)
        )

    @property
    def is_static(self) -> bool:
        return len(self.times) == 1 or all(
            np.allclose(m, self.mats[0]) for m in self.mats
        )


def scene_at_time(desc: dict, t: float) -> dict:
    """Bake a scene description at time ``t``: every shape/sensor with an
    "animation" spec gets its to_world evaluated there."""
    out = dict(desc)
    shapes = []
    for sh in desc.get("shapes", []):
        if sh.get("type") == "deformable":
            sh = deformable_at(sh, t)
        if "animation" in sh:
            sh = dict(sh)
            sh["to_world"] = AnimatedTransform.from_spec(sh["animation"]).eval(t)
        shapes.append(sh)
    out["shapes"] = shapes
    sensor = desc.get("sensor", {})
    if "animation" in sensor:
        sensor = dict(sensor)
        sensor["to_world"] = AnimatedTransform.from_spec(sensor["animation"]).eval(t)
        out["sensor"] = sensor
    return out


def deformable_at(sh: dict, t: float) -> dict:
    """Bake a "deformable" shape (keyframed vertex positions — reference
    src/shapes/deformable.cpp's space-time mesh, re-designed as per-slice
    vertex lerp for the stratified-time wavefronts of integrators/motion.py)
    into a concrete trimesh at time ``t``."""
    frames = [np.asarray(v, np.float64) for v in sh["vertices_frames"]]
    times = np.asarray(
        sh.get("times", np.linspace(0.0, 1.0, len(frames))), np.float64
    )
    t = float(np.clip(t, times[0], times[-1]))
    i = int(np.searchsorted(times, t, side="right") - 1)
    i = max(0, min(i, len(frames) - 2)) if len(frames) > 1 else 0
    if len(frames) == 1:
        v = frames[0]
    else:
        w = (t - times[i]) / max(times[i + 1] - times[i], 1e-12)
        v = frames[i] * (1.0 - w) + frames[i + 1] * w
    out = {k: val for k, val in sh.items() if k not in ("vertices_frames", "times")}
    out["type"] = "trimesh"
    out["vertices"] = v
    return out
