"""The recurrent mixers' scans as kernels: RWKV-6's WKV and Mamba's
selective scan, and their backward passes.

``wkv6``                replaces the ``jax.lax.scan`` of ``rwkv_time_mix``
                        (repro/models/rwkv.py:124, its step at :114-120)
``selective_scan``      replaces the ``jax.lax.scan`` of ``_ssm_scan``
                        (repro/models/mamba.py:76, its step at :64-70)
``wkv6_bwd``            replaces ``jax.grad`` through the first (the
                        chunked_time_scan of repro/models/scan_utils.py:17)
``selective_scan_bwd``  replaces ``jax.grad`` through the second

The reference has no ``pallas_call`` here: XLA compiles each scan into
one loop on the device.  Eager PyTorch has no such loop, and a step loop
would launch some eight small ops a step in each layer, so each scan is
one hand-written CUDA kernel a layer call (``csrc/wkv6.cu``,
``csrc/selective_scan.cu``) that holds the state on chip over all the
steps of the call.  A decode tick is a call of one step.

  wkv6(r, k, v, w, u, S0) -> (y, S)
      r, k, v, w (B, S, H, hd) f32 (w the per-channel decay in (0, 1)),
      u (H, hd), S0 (B, H, hd, hd):
        y_t[j] = sum_k r_t[k] (S[k, j] + u[k] k_t[k] v_t[j])
        S[k, j] <- S[k, j] w_t[k] + k_t[k] v_t[j]
  selective_scan(xc, dt, A, Bm, Cm, h0) -> (y, h)
      xc, dt (B, S, di), A (di, ds) (= -exp(A_log)), Bm, Cm (B, S, ds),
      h0 (B, di, ds):
        h[c, s] <- h[c, s] exp(dt_t[c] A[c, s]) + dt_t[c] xc_t[c] Bm_t[s]
        y_t[c] = sum_s h[c, s] Cm_t[s]

Training: on CUDA tensors that need a gradient, each scan runs as an
autograd Function (:class:`WKV6Fn`, :class:`SelectiveScanFn`).  Its
forward launches the same kernel, which then also writes the chunk-
boundary states, the state before every ``SCAN_CHUNK``-th step and the
final one, ``ceil(S / 64) + 1`` of them, the reference's
``chunked_time_scan`` plan.  Only those and the inputs are saved.  Its
backward launches the backward kernel (``csrc/wkv6_bwd.cu``,
``csrc/selective_scan_bwd.cu``), which walks the chunks in reverse and
recomputes each one's steps from its boundary state.  Without a gradient
the serving paths launch the forward kernel alone, as before.

The plain versions are the reference's step functions looped over time
in f32 through :func:`repro_torch.models.scan.chunked_time_scan`; the
backward's plain versions are ``torch.autograd.grad`` through them.  Each
wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors, or raises: there is no fallback.  The kernels sum in a
fixed order, so a call repeats bit for bit, and S steps in one call
equal S1 then S - S1 steps with the carried state, bit for bit; against
the plain versions they differ by f32 rounding (fused multiply-adds,
sum order).
"""
from __future__ import annotations

import torch

from repro_torch.models.scan import chunked_time_scan

from . import _build

_P, _I = _build.P, _build.I

WKV6 = _build.Kernel(
    "wkv6", "wkv6_launch", [_P] * 9 + [_I] * 4 + [_P],
    source="src/repro_torch/csrc/wkv6.cu",
    replaces="src/repro/models/rwkv.py:124")
SELECTIVE_SCAN = _build.Kernel(
    "selective_scan", "selective_scan_launch", [_P] * 9 + [_I] * 4 + [_P],
    source="src/repro_torch/csrc/selective_scan.cu",
    replaces="src/repro/models/mamba.py:76")
WKV6_BWD = _build.Kernel(
    "wkv6_bwd", "wkv6_bwd_launch", [_P] * 15 + [_I] * 4 + [_P],
    source="src/repro_torch/csrc/wkv6_bwd.cu",
    replaces="src/repro/models/rwkv.py:124")
SELECTIVE_SCAN_BWD = _build.Kernel(
    "selective_scan_bwd", "selective_scan_bwd_launch", [_P] * 17 + [_I] * 4
    + [_P], source="src/repro_torch/csrc/selective_scan_bwd.cu",
    replaces="src/repro/models/mamba.py:76")

# the widths the CUDA sources instantiate (a template parameter each)
WKV6_HEAD_DIMS = (16, 32, 64)
SCAN_STATE_DIMS = (8, 16)
# the reference's chunk (scan_utils.chunked_time_scan); csrc/scan_common.cuh
SCAN_CHUNK = 64
# channels a block of the selective scan's backward (its dB / dC partials)
SCAN_BWD_THREADS = 64


def n_boundaries(sl: int) -> int:
    """Boundary states a training forward writes for ``sl`` steps."""
    return -(-sl // SCAN_CHUNK) + 1


# ---- plain versions ---------------------------------------------------------

def wkv6_plain(r, k, v, w, u, s0):
    """The reference's WKV step over time, in f32 -> (y (B,S,H,hd), S)."""
    f32 = torch.float32
    uk = u.to(f32)[..., None]                                # (H, hd, 1)

    def step(s, inp):
        r_t, k_t, v_t, w_t = inp                             # (B, H, hd)
        kv = k_t[..., :, None] * v_t[..., None, :]           # (B, H, hd, hd)
        y = torch.einsum("bhk,bhkv->bhv", r_t, s + uk * kv)
        return s * w_t[..., :, None] + kv, y

    xs = tuple(t.to(f32).transpose(0, 1) for t in (r, k, v, w))
    s, ys = chunked_time_scan(step, s0.to(f32), xs)
    return ys.transpose(0, 1), s


def selective_scan_plain(xc, dt, a, bm, cm, h0):
    """The reference's selective-scan step over time, in f32 -> (y (B,S,
    di), h (B, di, ds))."""
    f32 = torch.float32
    a = a.to(f32)

    def step(h, inp):
        x_t, dt_t, b_t, c_t = inp                            # (B, di | ds)
        da = torch.exp(dt_t[..., None] * a)                  # (B, di, ds)
        h = h * da + (dt_t * x_t)[..., None] * b_t[:, None, :]
        return h, torch.einsum("bds,bs->bd", h, c_t)

    xs = tuple(t.to(f32).transpose(0, 1) for t in (xc, dt, bm, cm))
    h, ys = chunked_time_scan(step, h0.to(f32), xs)
    return ys.transpose(0, 1), h


def _plain_grads(plain, inputs, dy, dstate):
    """``torch.autograd.grad`` of (y . dy + state . dstate) through
    ``plain`` -> the gradient of every input, in order."""
    with torch.enable_grad():
        live = [t.detach().requires_grad_(True) for t in inputs]
        y, st = plain(*live)
        return torch.autograd.grad((y, st), live, (dy, dstate),
                                   materialize_grads=True)


def wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds):
    """The WKV's backward by autograd through :func:`wkv6_plain`: the
    incoming gradients dy (B, S, H, hd) and ds (of the final state) ->
    (dr, dk, dv, dw, du, ds0)."""
    return _plain_grads(wkv6_plain, (r, k, v, w, u, s0), dy, ds)


def selective_scan_bwd_plain(xc, dt, a, bm, cm, h0, dy, dh):
    """The selective scan's backward by autograd through
    :func:`selective_scan_plain`: dy (B, S, di) and dh (of the final
    state) -> (dxc, ddt, dA, dBm, dCm, dh0)."""
    return _plain_grads(selective_scan_plain, (xc, dt, a, bm, cm, h0), dy,
                        dh)


# ---- kernel wrappers --------------------------------------------------------

def _check(name: str, shapes: dict, **tensors) -> None:
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}; "
                             f"the kernel takes float32 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected "
                             f"{shapes[key]}")


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _wkv6_shapes(r):
    b, sl, nh, hd = r.shape
    if hd not in WKV6_HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd}; the kernel instantiates "
                         f"{WKV6_HEAD_DIMS}")
    seq, state = (b, sl, nh, hd), (b, nh, hd, hd)
    return dict(r=seq, k=seq, v=seq, w=seq, u=(nh, hd), s0=state, dy=seq,
                ds=state, bnd=(b, nh, n_boundaries(sl), hd, hd))


def _wkv6_fwd(r, k, v, w, u, s0, boundary: bool):
    """Launch the forward kernel -> (y, S, the boundary states or None)."""
    b, sl, nh, hd = r.shape
    shapes = _wkv6_shapes(r)
    _check("wkv6", shapes, r=r, k=k, v=v, w=w, u=u, s0=s0)
    y, s = torch.empty_like(r), torch.empty_like(s0)
    bnd = (torch.empty(shapes["bnd"], device=r.device) if boundary
           else None)
    if b:
        WKV6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s0.data_ptr(), y.data_ptr(), s.data_ptr(),
             None if bnd is None else bnd.data_ptr(), b, sl, nh, hd,
             _build.stream_ptr(r.device))
    return y, s, bnd


def wkv6_bwd(r, k, v, w, u, bnd, dy, ds):
    """The WKV's backward: the kernel (CUDA tensors) or the plain version
    (CPU tensors, from ``bnd[:, :, 0]``, the initial state) -> (dr, dk,
    dv, dw, du, ds0).  ``bnd`` is the training forward's boundary states
    (:class:`WKV6Fn`), dy (B, S, H, hd) and ds (B, H, hd, hd) the
    incoming gradients of y and of the final state."""
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, bnd[:, :, 0], dy, ds)
    b, sl, nh, hd = r.shape
    _check("wkv6_bwd", _wkv6_shapes(r), r=r, k=k, v=v, w=w, u=u, bnd=bnd,
           dy=dy, ds=ds)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    ds0 = torch.empty_like(ds)
    if b:
        du_part = torch.empty((b, nh, hd), device=r.device)
        WKV6_BWD(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), bnd.data_ptr(), dy.data_ptr(), ds.data_ptr(),
                 dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                 du.data_ptr(), du_part.data_ptr(), ds0.data_ptr(), b, sl,
                 nh, hd, _build.stream_ptr(r.device))
    else:
        du.zero_()
    return dr, dk, dv, dw, du, ds0


class WKV6Fn(torch.autograd.Function):
    """The WKV with its backward kernel: the forward saves the inputs and
    the boundary states (under a block's remat, PyTorch's checkpoint drops
    them and the recomputed forward writes them anew)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, s, bnd = _wkv6_fwd(r, k, v, w, u, s0, boundary=True)
        ctx.save_for_backward(r, k, v, w, u, bnd)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, bnd = ctx.saved_tensors
        return wkv6_bwd(r, k, v, w, u, bnd, dy.contiguous(),
                        ds.contiguous())


def wkv6(r, k, v, w, u, s0):
    """The WKV recurrence: the kernel (CUDA tensors) or the plain version
    (CPU tensors) -> (y (B, S, H, hd), S (B, H, hd, hd)); differentiable
    in every input (:class:`WKV6Fn` on CUDA)."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    if _needs_grad(r, k, v, w, u, s0):
        return WKV6Fn.apply(r, k, v, w, u, s0)
    y, s, _ = _wkv6_fwd(r, k, v, w, u, s0, boundary=False)
    return y, s


def _scan_shapes(xc, a):
    b, sl, di = xc.shape
    ds = a.shape[-1]
    if ds not in SCAN_STATE_DIMS:
        raise ValueError(f"selective_scan: d_state {ds}; the kernel "
                         f"instantiates {SCAN_STATE_DIMS}")
    return dict(xc=(b, sl, di), dt=(b, sl, di), a=(di, ds), bm=(b, sl, ds),
                cm=(b, sl, ds), h0=(b, di, ds), dy=(b, sl, di), dh=(b, di, ds),
                bnd=(b, n_boundaries(sl), di, ds))


def _scan_fwd(xc, dt, a, bm, cm, h0, boundary: bool):
    """Launch the forward kernel -> (y, h, the boundary states or None)."""
    b, sl, di = xc.shape
    ds = a.shape[-1]
    shapes = _scan_shapes(xc, a)
    _check("selective_scan", shapes, xc=xc, dt=dt, a=a, bm=bm, cm=cm, h0=h0)
    y, h = torch.empty_like(xc), torch.empty_like(h0)
    bnd = (torch.empty(shapes["bnd"], device=xc.device) if boundary
           else None)
    if b and di:
        SELECTIVE_SCAN(xc.data_ptr(), dt.data_ptr(), a.data_ptr(),
                       bm.data_ptr(), cm.data_ptr(), h0.data_ptr(),
                       y.data_ptr(), h.data_ptr(),
                       None if bnd is None else bnd.data_ptr(), b, sl, di, ds,
                       _build.stream_ptr(xc.device))
    return y, h, bnd


def selective_scan_bwd(xc, dt, a, bm, cm, bnd, dy, dh):
    """The selective scan's backward: the kernel (CUDA tensors) or the
    plain version (CPU tensors, from ``bnd[:, 0]``, the initial state) ->
    (dxc, ddt, dA, dBm, dCm, dh0).  ``bnd`` is the training forward's
    boundary states (:class:`SelectiveScanFn`), dy (B, S, di) and dh (B,
    di, ds) the incoming gradients of y and of the final state."""
    if xc.device.type == "cpu":
        return selective_scan_bwd_plain(xc, dt, a, bm, cm, bnd[:, 0], dy, dh)
    b, sl, di = xc.shape
    ds = a.shape[-1]
    _check("selective_scan_bwd", _scan_shapes(xc, a), xc=xc, dt=dt, a=a,
           bm=bm, cm=cm, bnd=bnd, dy=dy, dh=dh)
    dxc, ddt = torch.empty_like(xc), torch.empty_like(dt)
    da, dbm, dcm = (torch.empty_like(t) for t in (a, bm, cm))
    dh0 = torch.empty_like(dh)
    if b and di:
        nblk = -(-di // SCAN_BWD_THREADS)
        da_part = torch.empty((b, di, ds), device=xc.device)
        db_part, dc_part = (torch.empty((b, sl, nblk, ds), device=xc.device)
                            for _ in range(2))
        SELECTIVE_SCAN_BWD(
            xc.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), bnd.data_ptr(), dy.data_ptr(), dh.data_ptr(),
            dxc.data_ptr(), ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(),
            dcm.data_ptr(), da_part.data_ptr(), db_part.data_ptr(),
            dc_part.data_ptr(), dh0.data_ptr(), b, sl, di, ds,
            _build.stream_ptr(xc.device))
    else:
        for t in (da, dbm, dcm):
            t.zero_()
    return dxc, ddt, da, dbm, dcm, dh0


class SelectiveScanFn(torch.autograd.Function):
    """The selective scan with its backward kernel: the forward saves the
    inputs and the boundary states (re-written by a remat's recompute)."""

    @staticmethod
    def forward(ctx, xc, dt, a, bm, cm, h0):
        y, h, bnd = _scan_fwd(xc, dt, a, bm, cm, h0, boundary=True)
        ctx.save_for_backward(xc, dt, a, bm, cm, bnd)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        xc, dt, a, bm, cm, bnd = ctx.saved_tensors
        return selective_scan_bwd(xc, dt, a, bm, cm, bnd, dy.contiguous(),
                                  dh.contiguous())


def selective_scan(xc, dt, a, bm, cm, h0):
    """The selective scan: the kernel (CUDA tensors) or the plain version
    (CPU tensors) -> (y (B, S, di), h (B, di, ds)); differentiable in
    every input (:class:`SelectiveScanFn` on CUDA)."""
    if xc.device.type == "cpu":
        return selective_scan_plain(xc, dt, a, bm, cm, h0)
    if _needs_grad(xc, dt, a, bm, cm, h0):
        return SelectiveScanFn.apply(xc, dt, a, bm, cm, h0)
    y, h, _ = _scan_fwd(xc, dt, a, bm, cm, h0, boundary=False)
    return y, h
