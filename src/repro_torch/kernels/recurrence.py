"""The recurrent mixers' scans as kernels: RWKV-6's WKV and Mamba's
selective scan.

``wkv6``            replaces the ``jax.lax.scan`` of ``rwkv_time_mix``
                    (repro/models/rwkv.py:124, its step at :114-120)
``selective_scan``  replaces the ``jax.lax.scan`` of ``_ssm_scan``
                    (repro/models/mamba.py:76, its step at :64-70)

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

The plain versions are the reference's step functions looped over time
in f32 (:func:`repro_torch.models.scan.time_scan`).  Each wrapper runs
its plain version for CPU tensors and launches its kernel for CUDA
tensors, or raises: there is no fallback.  The kernels sum in a fixed
order, so a call repeats bit for bit, and S steps in one call equal S1
then S - S1 steps with the carried state, bit for bit; against the plain
versions they differ by f32 rounding (fused multiply-adds, sum order).
"""
from __future__ import annotations

import torch

from repro_torch.models.scan import time_scan

from . import _build

_P, _I = _build.P, _build.I

WKV6 = _build.Kernel(
    "wkv6", "wkv6_launch", [_P] * 8 + [_I] * 4 + [_P],
    source="src/repro_torch/csrc/wkv6.cu",
    replaces="src/repro/models/rwkv.py:124")
SELECTIVE_SCAN = _build.Kernel(
    "selective_scan", "selective_scan_launch", [_P] * 8 + [_I] * 4 + [_P],
    source="src/repro_torch/csrc/selective_scan.cu",
    replaces="src/repro/models/mamba.py:76")

# the widths the CUDA sources instantiate (a template parameter each)
WKV6_HEAD_DIMS = (16, 32, 64)
SCAN_STATE_DIMS = (8, 16)


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
    s, ys = time_scan(step, s0.to(f32), xs)
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
    h, ys = time_scan(step, h0.to(f32), xs)
    return ys.transpose(0, 1), h


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


def wkv6(r, k, v, w, u, s0):
    """The WKV recurrence: the kernel (CUDA tensors) or the plain version
    (CPU tensors) -> (y (B, S, H, hd), S (B, H, hd, hd))."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    b, sl, nh, hd = r.shape
    if hd not in WKV6_HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd}; the kernel instantiates "
                         f"{WKV6_HEAD_DIMS}")
    seq, state = (b, sl, nh, hd), (b, nh, hd, hd)
    _check("wkv6", dict(r=seq, k=seq, v=seq, w=seq, u=(nh, hd), s0=state),
           r=r, k=k, v=v, w=w, u=u, s0=s0)
    y, s = torch.empty_like(r), torch.empty_like(s0)
    if b:
        WKV6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s0.data_ptr(), y.data_ptr(), s.data_ptr(), b, sl,
             nh, hd, _build.stream_ptr(r.device))
    return y, s


def selective_scan(xc, dt, a, bm, cm, h0):
    """The selective scan: the kernel (CUDA tensors) or the plain version
    (CPU tensors) -> (y (B, S, di), h (B, di, ds))."""
    if xc.device.type == "cpu":
        return selective_scan_plain(xc, dt, a, bm, cm, h0)
    b, sl, di = xc.shape
    ds = a.shape[-1]
    if ds not in SCAN_STATE_DIMS:
        raise ValueError(f"selective_scan: d_state {ds}; the kernel "
                         f"instantiates {SCAN_STATE_DIMS}")
    _check("selective_scan", dict(xc=(b, sl, di), dt=(b, sl, di),
                                  a=(di, ds), bm=(b, sl, ds),
                                  cm=(b, sl, ds), h0=(b, di, ds)),
           xc=xc, dt=dt, a=a, bm=bm, cm=cm, h0=h0)
    y, h = torch.empty_like(xc), torch.empty_like(h0)
    if b and di:
        SELECTIVE_SCAN(xc.data_ptr(), dt.data_ptr(), a.data_ptr(),
                       bm.data_ptr(), cm.data_ptr(), h0.data_ptr(),
                       y.data_ptr(), h.data_ptr(), b, sl, di, ds,
                       _build.stream_ptr(xc.device))
    return y, h
