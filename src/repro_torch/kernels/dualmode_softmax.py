"""The dual-mode unit's two kernels and their plain versions (port of
``repro.kernels.dualmode_softmax``).

``softmax_rows``  replaces ``softmax_pallas``   (dualmode_softmax.py:82)
``pair_act``      replaces ``pair_act_pallas``  (dualmode_softmax.py:121)

Each wrapper launches its CUDA kernel (``csrc/softmax_rows.cu``,
``csrc/pair_act.cu``) for a CUDA tensor, or raises; for a CPU tensor it
runs the plain version below.  The float modes are bound by memory on
the H100, the int modes near int32 issue (see the notes in the CUDA
sources); the int words are bitwise the plain versions' on any input,
since the kernels take the float input as given and every int reduction
is exact.  ``softmax_rows`` covers a row as ``tiling.softmax_rows_plan``
says (held by a warp or a block, or streamed); both kernels move 16
bytes at a time where the pointers allow.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import softmax_unit as unit
from repro_torch.core.fixedpoint import EXP_FRAC, IN_FRAC, dequantize, quantize

from . import _build
from . import datapath as dp
from . import tiling

_P, _I = _build.P, _build.I

SOFTMAX_ROWS = _build.Kernel(
    "softmax_rows", "softmax_rows_launch",
    [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    source="src/repro_torch/csrc/softmax_rows.cu",
    replaces="src/repro/kernels/dualmode_softmax.py:82")
PAIR_ACT = _build.Kernel(
    "pair_act", "pair_act_launch",
    [_P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P],
    source="src/repro_torch/csrc/pair_act.cu",
    replaces="src/repro/kernels/dualmode_softmax.py:121")

_PRECISIONS = ("int", "float")
_MODES = ("gelu", "silu")


def _check_f32(name: str, x: torch.Tensor, ndim: int | None = None) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if ndim is not None and x.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {x.device}")


# ---- plain versions ---------------------------------------------------------

def softmax_rows_plain(x: torch.Tensor, precision: str = "int") -> torch.Tensor:
    """Row softmax over the last axis of (rows, n): the unit's normal mode
    (int words, guard shift from the unpadded n) or the float datapath."""
    if precision == "int":
        return dequantize(unit.softmax_int(quantize(x), dim=-1), EXP_FRAC)
    return dp.row_softmax(x)


def pair_act_plain(z: torch.Tensor, mode: str = "gelu",
                   precision: str = "int") -> torch.Tensor:
    """Elementwise GELU/SiLU through the unit's pair mode (Eq. 8)."""
    if precision == "int":
        zq = quantize(z)
        y = unit.gelu_int(zq) if mode == "gelu" else unit.silu_int(zq)
        return dequantize(y, IN_FRAC)
    return dp.pair_act(z, mode)


# ---- kernel wrappers --------------------------------------------------------

def softmax_rows(x: torch.Tensor, precision: str = "int") -> torch.Tensor:
    """Row softmax of a (rows, n) float32 tensor through the unit."""
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    _check_f32("softmax_rows", x, ndim=2)
    if x.device.type == "cpu":
        return softmax_rows_plain(x, precision)
    rows, n = x.shape
    if n < 1 or rows < 1:
        raise ValueError(f"softmax_rows: empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("softmax_rows: input must be contiguous")
    y = torch.empty_like(x)
    plan = tiling.softmax_rows_plan(n, tiling.aligned16(x, y))
    SOFTMAX_ROWS(x.data_ptr(), y.data_ptr(), rows, n,
                 1 if precision == "int" else 0, unit.guard_shift_for(n),
                 plan.row_threads, plan.words, plan.vec,
                 _build.stream_ptr(x.device))
    return y


def pair_act(z: torch.Tensor, mode: str = "gelu",
             precision: str = "int") -> torch.Tensor:
    """Elementwise GELU/SiLU of a float32 tensor (any shape) through the
    unit's pair mode."""
    if mode not in _MODES:
        raise ValueError(f"unknown pair-act mode {mode!r}")
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    _check_f32("pair_act", z)
    if z.device.type == "cpu":
        return pair_act_plain(z, mode, precision)
    if not z.is_contiguous():
        raise ValueError("pair_act: input must be contiguous")
    y = torch.empty_like(z)
    if z.numel():
        PAIR_ACT(z.data_ptr(), y.data_ptr(), z.numel(), _MODES.index(mode),
                 1 if precision == "int" else 0,
                 4 if tiling.aligned16(z, y) else 1,
                 tiling.sm_count(z.device), _build.stream_ptr(z.device))
    return y
