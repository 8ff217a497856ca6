"""The gated FFN with its activation epilogue fused (port of
``repro.kernels.fused_ffn``, forward).

``fused_glu``  replaces ``_fused_glu_jit`` (fused_ffn.py:133), registered
               as the ffn impl ``'fused_pallas'``

    Y = pair_act(X @ Wg, mode) * (X @ Wu),   mode 'silu' or 'gelu'

``pair_act`` is the float datapath's pair mode (Eq. 8 in the unit's
log-domain float form, ``datapath.pair_act``).  The kernel
(``csrc/glu.cu``) keeps both products of an output tile in registers,
so the (M, F) gate activations never reach device memory.  The wrapper
runs the plain version :func:`_glu_reference` (the reference's unfused
graph with the same epilogue) for CPU tensors, and launches the kernel
for CUDA tensors, or raises.  The two agree up to f32 summation order.

The fused backward (``_glu_bwd_call``) belongs to the training slice.
"""
from __future__ import annotations

import torch

from . import _build
from . import datapath as dp
from . import dispatch, tiling

_P, _I = _build.P, _build.I

GLU = _build.Kernel(
    "glu", "glu_launch", [_P] * 4 + [_I] * 6 + [_P],
    source="src/repro_torch/csrc/glu.cu",
    replaces="src/repro/kernels/fused_ffn.py:133")

MODES = ("gelu", "silu")


def _glu_reference(x, wg, wu, mode: str):
    """Unfused float graph with the SAME epilogue arithmetic: the plain
    version of the kernel, x (M, K), wg / wu (K, F) -> (M, F)."""
    g = x.to(torch.float32) @ wg.to(torch.float32)
    u = x.to(torch.float32) @ wu.to(torch.float32)
    return (dp.pair_act(g, mode) * u).to(x.dtype)


def fused_glu(x, wg, wu, *, mode: str = "silu"):
    """x (M, K) @ wg / wu (K, F) with the fused activation epilogue ->
    (M, F)."""
    if mode not in MODES:
        raise ValueError(f"unknown pair-act mode {mode!r}")
    if x.device.type == "cpu":
        return _glu_reference(x, wg, wu, mode)
    for name, t in (("x", x), ("wg", wg), ("wu", wu)):
        if t.dtype != torch.float32 or t.device != x.device or t.ndim != 2:
            raise ValueError(f"fused_glu: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; the kernel "
                             f"takes 2-D float32 on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_glu: {name} must be contiguous")
    m, k = x.shape
    if wg.shape != wu.shape or wg.shape[0] != k:
        raise ValueError(f"fused_glu: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}")
    out = torch.empty((m, wg.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel():
        GLU(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr(), m, k,
            wg.shape[1], MODES.index(mode),
            *tiling.matmul_blocks(m, norm_prologue=False),
            _build.stream_ptr(x.device))
    return out


dispatch.register_ffn("fused_pallas",
                      lambda x, wg, wu, mode: fused_glu(x, wg, wu, mode=mode))
