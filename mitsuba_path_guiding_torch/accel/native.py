"""The native binned-SAH BVH builder (``cpp/bvh_builder.cpp``), loaded
with ctypes.

The source is shared with the JAX package and used as it is.  It compiles
at first use with

    g++ -O3 -march=native -shared -fPIC

(the reference's flags, so both packages build the same tree on one
machine) into ``build/torch_kernels/libbvh_builder-<hash>.so`` at the
repository root; the hash covers the source.  Without a C++ compiler
``native_available`` is False and ``build_bvh_native`` raises
(``accel/bvh.py`` then builds the same tree in numpy).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from mitsuba_path_guiding_torch.ops.build import BUILD_DIR, REPO_ROOT

SRC = os.path.join(REPO_ROOT, "cpp", "bvh_builder.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LOCK = threading.Lock()
_STATE: dict = {}


def _lib_path() -> str:
    with open(SRC, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libbvh_builder-{h}.so")


def _load():
    with _LOCK:
        if "lib" in _STATE:
            return _STATE["lib"]
        if "error" in _STATE:  # a failed build is not tried again
            raise RuntimeError(_STATE["error"])
        so = _lib_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # a per-process temporary name: processes that build at the same
            # moment never write one file, and the rename is atomic
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                               check=True, capture_output=True, text=True, timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                _STATE["error"] = (f"cannot build {SRC} with g++: "
                                   f"{getattr(e, 'stderr', None) or e}")
                raise RuntimeError(_STATE["error"]) from e
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        f = lib.build_bvh_native
        f.restype = ctypes.c_int
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        f.argtypes = [fp, fp, fp, ctypes.c_int, ctypes.c_float, fp, fp, ip, ip, ip,
                      ctypes.c_int, ip, ip]
        _STATE["lib"] = lib
        return lib


def native_available() -> bool:
    """Whether the library builds (or was built) and loads."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def build_bvh_native(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray, box_pad: float):
    """(node_min, node_max, child0, child1, prim_idx, max_depth) as numpy
    arrays."""
    lib = _load()
    t = int(p0.shape[0])
    max_nodes = max(2 * t, 4)
    p0f, e1f, e2f = (np.ascontiguousarray(a, dtype=np.float32) for a in (p0, e1, e2))
    node_min = np.empty((max_nodes, 3), dtype=np.float32)
    node_max = np.empty((max_nodes, 3), dtype=np.float32)
    child0 = np.empty((max_nodes,), dtype=np.int32)
    child1 = np.empty((max_nodes,), dtype=np.int32)
    prim_idx = np.empty((t,), dtype=np.int32)
    n_nodes = np.zeros((1,), dtype=np.int32)
    max_depth = np.zeros((1,), dtype=np.int32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    rc = lib.build_bvh_native(fp(p0f), fp(e1f), fp(e2f), t, ctypes.c_float(box_pad),
                              fp(node_min), fp(node_max), ip(child0), ip(child1),
                              ip(prim_idx), max_nodes, ip(n_nodes), ip(max_depth))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed on {t} triangles")
    n = int(n_nodes[0])
    return (node_min[:n].copy(), node_max[:n].copy(), child0[:n].copy(), child1[:n].copy(),
            prim_idx, int(max_depth[0]))
