"""4x4 homogeneous transforms of the frozen scene descriptions (numpy,
float64): translate, scale, rotate (Rodrigues, degrees) and look_at
(camera space x right, y up, +z towards the target)."""
import numpy as np


def translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = [x, y, z]
    return m


def scale(x, y=None, z=None):
    return np.diag([x, x if y is None else y, x if z is None else z, 1.0])


def rotate(axis, angle_deg):
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    t = np.deg2rad(angle_deg)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) * np.cos(t) + np.sin(t) * k + (1 - np.cos(t)) * np.outer(a, a)
    return m


def look_at(origin, target, up=(0.0, 1.0, 0.0)):
    origin = np.asarray(origin, dtype=np.float64)
    forward = np.asarray(target, dtype=np.float64) - origin
    forward = forward / np.linalg.norm(forward)
    right = np.cross(np.asarray(up, dtype=np.float64), forward)
    right = right / np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = np.cross(forward, right)
    m[:3, 2] = forward
    m[:3, 3] = origin
    return m
