"""The block's norm seams as kernels (port of ``repro.kernels.fused_norm``).

``fused_residual_norm``  replaces ``_resnorm_jit``     (fused_norm.py:134)
``fused_norm_linear``    replaces ``_norm_linear_jit`` (fused_norm.py:217)
``fused_norm_glu``       replaces ``_norm_glu_jit``    (fused_norm.py:302)

  residual_norm  (x, r)    -> (x + r, norm(x + r) * g + b)
                 the attention-output epilogue: the new residual stream
                 and the FFN's input from one read of x and r, each row
                 held in registers by a warp or a block as
                 :func:`tiling.resnorm_plan` says
                 (``csrc/resnorm.cu``).
  norm_linear    x, [W...] -> norm(x) @ [W0 | W1 | W2]
                 the norm -> QKV prologue: the normalized stream is made
                 in shared memory as each x chunk lands and never reaches
                 device memory (``csrc/norm_linear.cu`` on the pipelined
                 body ``csrc/norm_gemm_sm90.cuh``).  The weights are read in
                 place: ``ws`` is a sequence of up to three matrices
                 whose columns land side by side, so [wq|wk|wv] is never
                 concatenated on the card.
  norm_glu       x, Wg, Wu -> pair_act(h @ Wg) * (h @ Wu), h = norm(x)
                 the FFN seam of blocks whose attention epilogue made no
                 normed stream ('none' mixers, cross-attention
                 sublayers): norm_linear's prologue under the fused
                 GLU's epilogue, so neither h nor the gate and up
                 products reach device memory (``csrc/norm_glu.cu``).

All three inline the datapath's norm arithmetic (:func:`_hat`: f32
moments, rsqrt as exp2(-0.5 log2 v), gain and bias in f32, one downcast
of the finished result), for ``kind`` 'rms' (``b`` None) or 'layer'.
The plain versions below are the reference's kernel bodies in PyTorch
(the norm_linear one concatenates the weights, as the reference does;
the norm_glu one is that norm followed by ``fused_ffn._glu_reference``);
each wrapper runs its plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors, or raises.  The kernels agree with the
plain versions up to f32 summation order.  norm_linear and norm_glu
take their tile, K split and copy width from
:func:`tiling.norm_gemm_plan`, and their scratch -- (mu, rs) a row, the
split partials -- from ``torch.empty``; one call is one counted launch.

The seams are ``torch.autograd.Function``s, on either device, with the
reference's custom VJPs as their backwards: the norm's VJP is plain
PyTorch through ``datapath.rmsnorm_vjp`` / ``layernorm_vjp`` (the
reference's are jnp, not Pallas); norm_linear and norm_glu recompute the
normalized stream with the dense norm and take the products around it
(dW = h^T dO, dh = dO W^T) as ``torch.matmul``; norm_glu's d_gate /
d_up come from the GLU backward kernel (``fused_ffn.glu_bwd``), as the
reference's come from ``_glu_bwd_call``.  A bias that is None gets no
gradient.
"""
from __future__ import annotations

import torch

from . import _build
from . import datapath as dp
from . import dispatch, fused_ffn, tiling

_P, _I, _F = _build.P, _build.I, _build.F

RESNORM = _build.Kernel(
    "resnorm", "resnorm_launch", [_P] * 6 + [_I] * 3 + [_F] + [_I] * 3 + [_P],
    source="src/repro_torch/csrc/resnorm.cu",
    replaces="src/repro/kernels/fused_norm.py:134")
NORM_LINEAR = _build.Kernel(
    "norm_linear", "norm_linear_launch",
    [_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F]
    + [_I] * 4 + [_P],
    source="src/repro_torch/csrc/norm_linear.cu",
    replaces="src/repro/kernels/fused_norm.py:217")
NORM_GLU = _build.Kernel(
    "norm_glu", "norm_glu_launch",
    [_P] * 8 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
    source="src/repro_torch/csrc/norm_glu.cu",
    replaces="src/repro/kernels/fused_norm.py:302")

KINDS = ("rms", "layer")
MAX_MATRICES = 3          # weight matrices norm_linear reads in place


def _hat(xn: torch.Tensor, *, kind: str, eps: float) -> torch.Tensor:
    """Normalized rows (no gain / bias) of f32 ``xn`` over its last axis:
    the reference's in-kernel moment datapath."""
    inv_n = 1.0 / xn.shape[-1]
    if kind == "rms":
        ms = torch.sum(xn * xn, dim=-1, keepdim=True) * inv_n
        return xn * torch.exp2(-0.5 * torch.log2(ms + eps))
    if kind == "layer":
        mu = torch.sum(xn, dim=-1, keepdim=True) * inv_n
        var = torch.clamp(torch.sum(xn * xn, dim=-1, keepdim=True) * inv_n
                          - mu * mu, min=0.0)
        return (xn - mu) * torch.exp2(-0.5 * torch.log2(var + eps))
    raise ValueError(f"unknown norm kind {kind!r}")


def _scaled(xn, g, b, *, kind: str, eps: float) -> torch.Tensor:
    h = _hat(xn, kind=kind, eps=eps) * g.to(torch.float32)
    return h if b is None else h + b.to(torch.float32)


def _matrices(ws) -> list[torch.Tensor]:
    ws = list(ws)
    if not 1 <= len(ws) <= MAX_MATRICES:
        raise ValueError(f"norm_linear takes 1..{MAX_MATRICES} weight "
                         f"matrices, got {len(ws)}")
    return ws


# ---- plain versions ---------------------------------------------------------

def fused_residual_norm_plain(x, r, g, b=None, *, kind: str, eps: float):
    """(x + r, norm(x + r) * g + b) in x's dtype; x, r (..., d)."""
    xn = x.to(torch.float32) + r.to(torch.float32)
    h = _scaled(xn, g, b, kind=kind, eps=eps)
    return xn.to(x.dtype), h.to(x.dtype)


def fused_norm_linear_plain(x, g, b, ws, *, kind: str, eps: float):
    """norm(x) @ cat(ws, axis=1): x (..., d), each matrix (d, n_i) ->
    (..., sum n_i) in x's dtype."""
    wc = torch.cat([m.to(torch.float32) for m in _matrices(ws)], dim=1)
    h = _scaled(x.to(torch.float32), g, b, kind=kind, eps=eps)
    return (h @ wc).to(x.dtype)


def fused_norm_glu_plain(x, g, b, wg, wu, *, kind: str, eps: float,
                         mode: str):
    """pair_act(h @ wg) * (h @ wu), h = norm(x) * g + b: x (..., d), wg /
    wu (d, F) -> (..., F) in x's dtype."""
    d = x.shape[-1]
    h = _scaled(x.to(torch.float32), g, b, kind=kind, eps=eps)
    y = fused_ffn._glu_reference(h.reshape(-1, d), wg, wu, mode)
    return y.reshape(x.shape[:-1] + (wg.shape[1],)).to(x.dtype)


# ---- kernel wrappers --------------------------------------------------------

def _check(name: str, kind: str, **tensors) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown norm kind {kind!r}")
    dev = tensors["x"].device
    for key, t in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}; the "
                             f"kernel takes float32 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _scratch(x, m: int, split: int, cols: int):
    """The norm GEMM kernels' scratch: (mu, rs) of each row, and the
    split-K partial sums (None for one split)."""
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)
    return stats, tiling.split_partials(x, split, m, cols)


def _resnorm_fwd(x, r, g, b, *, kind: str, eps: float):
    """The kernel (CUDA tensors) or the plain version (CPU tensors)."""
    if x.device.type == "cpu":
        return fused_residual_norm_plain(x, r, g, b, kind=kind, eps=eps)
    _check("fused_residual_norm", kind, x=x, r=r, g=g, b=b)
    d = x.shape[-1]
    if r.shape != x.shape or g.shape != (d,) or (
            b is not None and b.shape != (d,)):
        raise ValueError(f"fused_residual_norm: x {tuple(x.shape)}, r "
                         f"{tuple(r.shape)}, g {tuple(g.shape)}")
    xo, ho = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        plan = tiling.resnorm_plan(d, tiling.aligned16(x, r, g, b, xo, ho))
        RESNORM(x.data_ptr(), r.data_ptr(), g.data_ptr(),
                None if b is None else b.data_ptr(), xo.data_ptr(),
                ho.data_ptr(), x.numel() // d, d, KINDS.index(kind), eps,
                plan.row_threads, plan.words, plan.vec,
                _build.stream_ptr(x.device))
    return xo, ho


def _norm_linear_fwd(x, g, b, ws, *, kind: str, eps: float):
    """The kernel (CUDA tensors) or the plain version (CPU tensors)."""
    if x.device.type == "cpu":
        return fused_norm_linear_plain(x, g, b, ws, kind=kind, eps=eps)
    ws = _matrices(ws)
    _check("fused_norm_linear", kind, x=x, g=g, b=b,
           **{f"w{i}": m for i, m in enumerate(ws)})
    d = x.shape[-1]
    if g.shape != (d,) or (b is not None and b.shape != (d,)) or any(
            m.ndim != 2 or m.shape[0] != d for m in ws):
        raise ValueError(f"fused_norm_linear: x {tuple(x.shape)}, weights "
                         f"{[tuple(m.shape) for m in ws]}")
    widths = tuple(m.shape[1] for m in ws)
    out = torch.empty(x.shape[:-1] + (sum(widths),), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        m = out.numel() // out.shape[-1]
        plan = tiling.norm_gemm_plan(
            m, d, widths, aligned=tiling.aligned16(x, g, b, out, *ws))
        stats, part = _scratch(x, m, plan.split, sum(widths))
        slots = [(t.data_ptr(), n) for t, n in zip(ws, widths)]
        slots += [(None, 0)] * (MAX_MATRICES - len(slots))
        NORM_LINEAR(x.data_ptr(), g.data_ptr(),
                    None if b is None else b.data_ptr(),
                    *[v for s in slots for v in s], len(ws), out.data_ptr(),
                    stats.data_ptr(),
                    None if part is None else part.data_ptr(), m, d,
                    KINDS.index(kind), eps, plan.bm, plan.bn, plan.split,
                    plan.vec, _build.stream_ptr(x.device))
    return out


def _norm_glu_fwd(x, g, b, wg, wu, *, kind: str, eps: float, mode: str):
    """The kernel (CUDA tensors) or the plain version (CPU tensors)."""
    if x.device.type == "cpu":
        return fused_norm_glu_plain(x, g, b, wg, wu, kind=kind, eps=eps,
                                    mode=mode)
    _check("fused_norm_glu", kind, x=x, g=g, b=b, wg=wg, wu=wu)
    d = x.shape[-1]
    if g.shape != (d,) or (b is not None and b.shape != (d,)) or (
            wg.ndim != 2 or wg.shape != wu.shape or wg.shape[0] != d):
        raise ValueError(f"fused_norm_glu: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}")
    f = wg.shape[1]
    out = torch.empty(x.shape[:-1] + (f,), dtype=x.dtype, device=x.device)
    if out.numel():
        m = out.numel() // f
        plan = tiling.norm_gemm_plan(
            m, d, (f,), glu=True,
            aligned=tiling.aligned16(x, g, b, out, wg, wu))
        stats, part = _scratch(x, m, plan.split, 2 * f)
        NORM_GLU(x.data_ptr(), g.data_ptr(),
                 None if b is None else b.data_ptr(), wg.data_ptr(),
                 wu.data_ptr(), out.data_ptr(), stats.data_ptr(),
                 None if part is None else part.data_ptr(), m, d, f,
                 KINDS.index(kind), eps, fused_ffn.MODES.index(mode),
                 plan.bm, plan.bn, plan.split, plan.vec,
                 _build.stream_ptr(x.device))
    return out


# ---- autograd ---------------------------------------------------------------

def _dense_h(x, g, b, *, kind: str, eps: float):
    """The dense f32 normalized-and-scaled stream the backward recomputes
    (the reference's ``_dense_h``)."""
    if kind == "rms":
        return dp.rmsnorm(x, g, eps)
    return dp.layernorm(x, g, b, eps)


def _norm_vjp(x, g, b, dy, *, kind: str, eps: float):
    """(dx, dg, db) through the datapath's VJPs, dg / db reduced over the
    leading axes; db None without a bias."""
    d = x.shape[-1]
    if kind == "rms":
        dx, dg_hat = dp.rmsnorm_vjp(x, g, eps, dy)
        db = None
    else:
        dx, dg_hat, db_hat = dp.layernorm_vjp(x, g, eps, dy)
        db = None if b is None else db_hat.reshape(-1, d).sum(0).to(b.dtype)
    return dx, dg_hat.reshape(-1, d).sum(0).to(g.dtype), db


class _ResidualNorm(torch.autograd.Function):
    """``_resnorm_jit``'s custom VJP: saves (x, r, g, b), recomputes x + r."""

    @staticmethod
    def forward(ctx, x, r, g, b, kind, eps):
        ctx.save_for_backward(x, r, g, b)
        ctx.kind, ctx.eps = kind, eps
        return _resnorm_fwd(x, r, g, b, kind=kind, eps=eps)

    @staticmethod
    def backward(ctx, d_xnew, dh):
        x, r, g, b = ctx.saved_tensors
        xn = x.to(torch.float32) + r.to(torch.float32)
        dxn, dg, db = _norm_vjp(xn, g, b, dh, kind=ctx.kind, eps=ctx.eps)
        dxn = dxn + d_xnew.to(torch.float32)
        return dxn.to(x.dtype), dxn.to(r.dtype), dg, db, None, None


class _NormLinear(torch.autograd.Function):
    """``_norm_linear_jit``'s custom VJP; the matrices ride as separate
    inputs so each gets its own gradient."""

    @staticmethod
    def forward(ctx, x, g, b, kind, eps, *ws):
        ctx.save_for_backward(x, g, b, *ws)
        ctx.kind, ctx.eps = kind, eps
        return _norm_linear_fwd(x, g, b, ws, kind=kind, eps=eps)

    @staticmethod
    def backward(ctx, do):
        x, g, b, *ws = ctx.saved_tensors
        kind, eps = ctx.kind, ctx.eps
        do32 = do.to(torch.float32).reshape(-1, do.shape[-1])
        wc = torch.cat([m.to(torch.float32) for m in ws], dim=1)
        dh = (do32 @ wc.T).reshape(x.shape)
        h = _dense_h(x, g, b, kind=kind, eps=eps).reshape(-1, x.shape[-1])
        dws = torch.split(h.T @ do32, [m.shape[1] for m in ws], dim=1)
        dx, dg, db = _norm_vjp(x, g, b, dh, kind=kind, eps=eps)
        return (dx.to(x.dtype), dg, db, None, None,
                *(dw.to(m.dtype) for dw, m in zip(dws, ws)))


class _NormGLU(torch.autograd.Function):
    """``_norm_glu_jit``'s custom VJP: recompute h with the dense norm,
    (d_gate, d_up) from the GLU backward kernel, the rest as matmuls."""

    @staticmethod
    def forward(ctx, x, g, b, wg, wu, kind, eps, mode):
        ctx.save_for_backward(x, g, b, wg, wu)
        ctx.kind, ctx.eps, ctx.mode = kind, eps, mode
        return _norm_glu_fwd(x, g, b, wg, wu, kind=kind, eps=eps, mode=mode)

    @staticmethod
    def backward(ctx, dy):
        x, g, b, wg, wu = ctx.saved_tensors
        kind, eps = ctx.kind, ctx.eps
        d, f = x.shape[-1], wg.shape[1]
        h = _dense_h(x, g, b, kind=kind, eps=eps).reshape(-1, d).contiguous()
        dgm, dum = fused_ffn.glu_bwd(
            h, wg.to(torch.float32).contiguous(),
            wu.to(torch.float32).contiguous(),
            dy.to(torch.float32).reshape(-1, f).contiguous(), mode=ctx.mode)
        dh = dgm @ wg.to(torch.float32).T + dum @ wu.to(torch.float32).T
        dx, dg, db = _norm_vjp(x, g, b, dh.reshape(x.shape), kind=kind,
                               eps=eps)
        return (dx.to(x.dtype), dg, db, (h.T @ dgm).to(wg.dtype),
                (h.T @ dum).to(wu.dtype), None, None, None)


def fused_residual_norm(x, r, g, b=None, *, kind: str, eps: float):
    """(x + r, norm(x + r) * g + b); x, r (..., d), g / b (d,), b None
    for rms.  Both outputs in x's dtype; differentiable.  Where no input
    needs a gradient (serving), the forward runs without the autograd
    Function, whose host time would outweigh the kernel at a decode
    tick."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, r, g, b)):
        return _ResidualNorm.apply(x, r, g, b, kind, eps)
    return _resnorm_fwd(x, r, g, b, kind=kind, eps=eps)


def fused_norm_linear(x, g, b, ws, *, kind: str, eps: float):
    """norm(x) @ [W0 | W1 | W2] without the normalized stream in memory:
    x (..., d), ``ws`` a sequence of up to three (d, n_i) matrices ->
    (..., sum n_i); differentiable."""
    return _NormLinear.apply(x, g, b, kind, eps, *_matrices(ws))


def fused_norm_glu(x, g, b, wg, wu, *, kind: str, eps: float, mode: str):
    """pair_act(norm(x) @ wg) * (norm(x) @ wu) without the normalized
    stream or the products in memory: x (..., d), wg / wu (d, F) ->
    (..., F); differentiable."""
    if mode not in fused_ffn.MODES:
        raise ValueError(f"unknown pair-act mode {mode!r}")
    return _NormGLU.apply(x, g, b, wg, wu, kind, eps, mode)


dispatch.register_norm("fused_pallas", {
    "residual_norm": fused_residual_norm,
    "norm_linear": fused_norm_linear,
    "norm_glu": fused_norm_glu,
})
