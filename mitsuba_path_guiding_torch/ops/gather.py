"""Transposed row gather of the material, emitter and shading tables.

Port of ``mitsuba_path_guiding_tpu/ops/gather_pallas.py`` ``gather_rows_t``:
(R, C) table and (N,) indices -> (C, N) rows, indices clamped to the table.
On a CUDA tensor it launches ``csrc/gather_rows.cu`` (whole rows read into
a shared-memory tile, written transposed with coalesced stores; bit-equal
to the plain gather, see the note there); on a CPU tensor it takes the
plain version.  There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_path_guiding_torch.ops import build

_FN: dict = {}
# the largest table the JAX package sends to its Pallas kernel
# (mitsuba_path_guiding_tpu/ops/gather_pallas.py); launches on larger
# tables are counted apart
SMALL_ROWS = 512


def gather_rows_t_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``table[clamp(idx, 0, R-1)].T``."""
    r = table.shape[0]
    return table[torch.clamp(idx.to(torch.int64), 0, r - 1)].T


def _kernel_fn(index_dtype):
    key = "i64" if index_dtype == torch.int64 else "i32"
    f = _FN.get(key)
    if f is None:
        f = getattr(build.load("gather_rows"), f"gather_rows_t_{key}")
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN[key] = f
    return f


def gather_rows_t_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError(f"gather_rows_t: table must be 2-D float32, got {table.dtype} {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows_t: idx must be 1-D int32/int64, got {idx.dtype} {tuple(idx.shape)}")
    if not (table.is_cuda and idx.is_cuda) or table.device != idx.device:
        raise ValueError("gather_rows_t: table and idx must be on the same CUDA device")
    table = table.contiguous()
    idx = idx.contiguous()
    r, c = table.shape
    n = idx.shape[0]
    out = torch.empty((c, n), dtype=torch.float32, device=table.device)
    fn = _kernel_fn(idx.dtype)
    build.check(fn(build.ptr(table), build.ptr(idx), build.ptr(out), r, c, n,
                   build.stream_ptr(table.device)), "gather_rows_t")
    build.LAUNCHES["gather_rows_t"] += 1
    if r > SMALL_ROWS:
        build.LAUNCHES["gather_rows_t_large"] += 1
    return out


def gather_rows_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) table, (N,) indices -> (C, N) gathered and transposed."""
    if table.is_cuda:
        return gather_rows_t_cuda(table, idx)
    return gather_rows_t_plain(table, idx)
