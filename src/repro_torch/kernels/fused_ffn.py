"""The gated FFN with its activation epilogue fused (port of
``repro.kernels.fused_ffn``).

``fused_glu``  replaces ``_fused_glu_jit`` (fused_ffn.py:133), registered
               as the ffn impl ``'fused_pallas'``
``glu_bwd``    replaces ``_glu_bwd_call`` (fused_ffn.py:79)

    Y = pair_act(X @ Wg, mode) * (X @ Wu),   mode 'silu' or 'gelu'

``pair_act`` is the float datapath's pair mode (Eq. 8 in the unit's
log-domain float form, ``datapath.pair_act``).  The kernel
(``csrc/glu.cu`` on the pipelined Hopper body ``csrc/norm_gemm_sm90.cuh``,
without its norm prologue) keeps both products of an output tile in
registers, so the (M, F) gate activations never reach device memory.
The wrapper runs the plain version :func:`_glu_reference` (the
reference's unfused graph with the same epilogue) for CPU tensors, and
launches the kernel for CUDA tensors, or raises.  The two agree up to
f32 summation order.

``fused_glu`` is a ``torch.autograd.Function`` (on either device) with
the reference's custom VJP: ``glu_bwd`` recomputes the (g, u) tiles and
writes d_gate = dY u pair_act'(g) and d_up = dY pair_act(g)
(``csrc/glu_bwd.cu``, the same kernel with another epilogue; plain
version :func:`_glu_bwd_plain`); the four products around it (dx, dWg,
dWu) are ``torch.matmul``, as they are plain XLA dots in the reference.

Both kernels take their tile, K split and copy width from
:func:`tiling.norm_gemm_plan` (``glu=True``: the bands of the norm ->
gated-GLU kernel) and their split-K scratch from ``torch.empty``; one
call is one counted launch.
"""
from __future__ import annotations

import torch

from . import _build
from . import datapath as dp
from . import dispatch, tiling

_P, _I = _build.P, _build.I

GLU = _build.Kernel(
    "glu", "glu_launch", [_P] * 5 + [_I] * 8 + [_P],
    source="src/repro_torch/csrc/glu.cu",
    replaces="src/repro/kernels/fused_ffn.py:133")

GLU_BWD = _build.Kernel(
    "glu_bwd", "glu_bwd_launch", [_P] * 7 + [_I] * 8 + [_P],
    source="src/repro_torch/csrc/glu_bwd.cu",
    replaces="src/repro/kernels/fused_ffn.py:79")

MODES = ("gelu", "silu")


def _glu_reference(x, wg, wu, mode: str):
    """Unfused float graph with the SAME epilogue arithmetic: the plain
    version of the kernel, x (M, K), wg / wu (K, F) -> (M, F)."""
    g = x.to(torch.float32) @ wg.to(torch.float32)
    u = x.to(torch.float32) @ wu.to(torch.float32)
    return (dp.pair_act(g, mode) * u).to(x.dtype)


def _glu_bwd_plain(x, wg, wu, dy, mode: str):
    """Plain version of the backward kernel (the reference's
    ``_ffn_bwd_body``): recompute g and u -> (d_gate, d_up) f32."""
    g = x.to(torch.float32) @ wg.to(torch.float32)
    u = x.to(torch.float32) @ wu.to(torch.float32)
    dy = dy.to(torch.float32)
    return dy * u * dp.pair_act_grad(g, mode), dy * dp.pair_act(g, mode)


def _check_2d(name: str, dev, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.float32 or t.device != dev or t.ndim != 2:
            raise ValueError(f"{name}: {key} is {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}; the kernel takes 2-D float32 "
                             f"on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_glu_shapes(name: str, x, wg, wu) -> None:
    if wg.shape != wu.shape or wg.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}")


def _plan(x, wg, *outs):
    """The kernels' tile, K split and copy width for x (M, K), wg (K, F)
    and the tensors they write or read besides."""
    return tiling.norm_gemm_plan(
        x.shape[0], x.shape[1], (wg.shape[1],), glu=True,
        aligned=tiling.aligned16(x, wg, *outs))


def _glu_fwd(x, wg, wu, mode: str):
    """The forward kernel (CUDA tensors) or its plain version (CPU)."""
    if x.device.type == "cpu":
        return _glu_reference(x, wg, wu, mode)
    _check_2d("fused_glu", x.device, x=x, wg=wg, wu=wu)
    _check_glu_shapes("fused_glu", x, wg, wu)
    m, k = x.shape
    f = wg.shape[1]
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if out.numel():
        plan = _plan(x, wg, wu, out)
        part = tiling.split_partials(x, plan.split, m, 2 * f)
        GLU(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), m, k, f,
            MODES.index(mode), plan.bm, plan.bn, plan.split, plan.vec,
            _build.stream_ptr(x.device))
    return out


def glu_bwd(x, wg, wu, dy, *, mode: str):
    """(d_gate, d_up), each (M, F) f32: the backward kernel (CUDA
    tensors) or :func:`_glu_bwd_plain` (CPU tensors); x (M, K), wg / wu
    (K, F), dy (M, F)."""
    if mode not in MODES:
        raise ValueError(f"unknown pair-act mode {mode!r}")
    if x.device.type == "cpu":
        return _glu_bwd_plain(x, wg, wu, dy, mode)
    _check_2d("glu_bwd", x.device, x=x, wg=wg, wu=wu, dy=dy)
    _check_glu_shapes("glu_bwd", x, wg, wu)
    m, k = x.shape
    f = wg.shape[1]
    if dy.shape != (m, f):
        raise ValueError(f"glu_bwd: dy {tuple(dy.shape)}, expected {(m, f)}")
    d_gate = torch.empty((m, f), device=x.device)
    d_up = torch.empty_like(d_gate)
    if d_gate.numel():
        plan = _plan(x, wg, wu, dy, d_gate, d_up)
        part = tiling.split_partials(x, plan.split, m, 2 * f)
        GLU_BWD(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), dy.data_ptr(),
                d_gate.data_ptr(), d_up.data_ptr(),
                None if part is None else part.data_ptr(), m, k, f,
                MODES.index(mode), plan.bm, plan.bn, plan.split, plan.vec,
                _build.stream_ptr(x.device))
    return d_gate, d_up


class _FusedGLU(torch.autograd.Function):
    """``_fused_glu_jit``'s custom VJP: saves (x, wg, wu)."""

    @staticmethod
    def forward(ctx, x, wg, wu, mode):
        ctx.save_for_backward(x, wg, wu)
        ctx.mode = mode
        return _glu_fwd(x, wg, wu, mode)

    @staticmethod
    def backward(ctx, gy):
        x, wg, wu = ctx.saved_tensors
        dg, du = glu_bwd(x, wg, wu, gy.contiguous(), mode=ctx.mode)
        xf = x.to(torch.float32)
        dx = dg @ wg.to(torch.float32).T + du @ wu.to(torch.float32).T
        return (dx.to(x.dtype), (xf.T @ dg).to(wg.dtype),
                (xf.T @ du).to(wu.dtype), None)


def fused_glu(x, wg, wu, *, mode: str = "silu"):
    """x (M, K) @ wg / wu (K, F) with the fused activation epilogue ->
    (M, F); differentiable."""
    if mode not in MODES:
        raise ValueError(f"unknown pair-act mode {mode!r}")
    return _FusedGLU.apply(x, wg, wu, mode)


dispatch.register_ffn("fused_pallas",
                      lambda x, wg, wu, mode: fused_glu(x, wg, wu, mode=mode))
