"""Transposed row gather of the material, emitter and shading tables.

Port of ``mitsuba_path_guiding_tpu/ops/gather_pallas.py`` ``gather_rows_t``:
(R, C) table and (N,) indices -> (C, N) rows, indices clamped to the table.
On a CUDA tensor it launches ``csrc/gather_rows.cu`` (whole rows read into
a shared-memory tile, written transposed with coalesced stores; bit-equal
to the plain gather, see the note there); on a CPU tensor it takes the
plain version.  There is no fallback between the two.

It is differentiable with respect to the table, as the reference's
``custom_vjp`` is (gather_pallas.py:77-93): when grad mode is on and the
table requires grad, the gather runs through ``GatherRowsT``, whose
backward scatter-adds the cotangent's columns into a zero table in an
order fixed by the data (``core/math.py`` ``scatter_add_rows``).  The
backward is plain PyTorch, as the reference's is plain XLA.
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_path_guiding_torch.core.math import scatter_add_rows
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
    build.refuse_grad("gather_rows_t", table)
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


class GatherRowsT(torch.autograd.Function):
    """The gather with the reference's backward (gather_pallas.py:84-89):
    the table's gradient is a zero (R, C) table with the cotangent's
    columns added at the clamped indices; the indices get none."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = tuple(table.shape)
        if table.is_cuda:
            return gather_rows_t_cuda(table, idx)
        return gather_rows_t_plain(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows_t_vjp(ctx.table_shape, idx, g), None


def gather_rows_t_vjp(table_shape, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The table's cotangent of the gather: a zero (R, C) table with the
    columns of g (C, N) added at the clamped indices."""
    r, c = table_shape
    gt = torch.zeros((r, c), dtype=g.dtype, device=g.device)
    return scatter_add_rows(gt, torch.clamp(idx.to(torch.int64), 0, r - 1), g.T)


def gather_rows_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) table, (N,) indices -> (C, N) gathered and transposed;
    through ``GatherRowsT`` when a gradient with respect to the table is
    wanted."""
    if table.requires_grad and torch.is_grad_enabled():
        return GatherRowsT.apply(table, idx)
    if table.is_cuda:
        return gather_rows_t_cuda(table, idx)
    return gather_rows_t_plain(table, idx)
