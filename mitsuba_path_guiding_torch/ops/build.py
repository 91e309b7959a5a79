"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` compiles at first use into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC

The hash covers the source and every header under ``csrc/``, so an edited
source rebuilds.  ``-fmad=false`` keeps each multiply and add separately
rounded, as PyTorch's elementwise operators round them, so a kernel and its
plain version agree bit for bit wherever no transcendental function is
involved.  No ``--use_fast_math``: the kernels use IEEE ``expf``/``logf``/
``sinf``/``cosf``/``sqrtf``.  The ptxas report (registers, spills) of each
build is kept beside the library as ``<name>.log``.

Every wrapper counts its launches in ``LAUNCHES`` (one per kernel launch,
nowhere else), so a run can show that the main path went through the
kernels.  ``gather_rows_t_large`` counts, among the ``gather_rows_t``
launches, those on a table of more than 512 rows (a scene's shading
table; the JAX package gives only smaller tables to its Pallas kernel);
``intersect_pairs_mt_bf16`` the MT pair tiles' launches on bfloat16 pair
data (``PAIR_DATA_BF16``), apart from ``intersect_pairs_mt``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
KERNEL_SOURCES = ("gather_rows", "intersect_tiled", "fused_path", "intersect_pairs",
                  "intersect_blocklist", "intersect_twolevel", "intersect_bvh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES = {"gather_rows_t": 0, "gather_rows_t_large": 0, "intersect_tiled": 0,
            "trace_fused": 0, "intersect_pairs_mt": 0, "intersect_pairs_mt_bf16": 0,
            "intersect_pairs_plk": 0, "intersect_blocklist": 0, "intersect_twolevel": 0,
            "intersect_bvh": 0}

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha1()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, target, log path) or
    None when the library is already built."""
    target = _lib_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    log = os.path.join(BUILD_DIR, f"{name}.log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", target + ".tmp", os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, target, log


def _finish_build(name: str, started) -> None:
    proc, target, log = started
    out, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(target + ".tmp", target)


def build_all(names=KERNEL_SOURCES) -> None:
    """Build every kernel library in parallel: one nvcc per source, all
    started together."""
    with _LOCK:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish_build(n, s)


def build_log(name: str) -> str:
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {status}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input of a kernel without a
    backward requires grad: a ctypes launch writes into a fresh tensor with
    no ``grad_fn``, so its output would silently carry no gradient."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and an input requires "
                           "grad (run it under torch.no_grad(), or take a differentiable route)")
