"""Blocked flash attention, float (port of
``repro.kernels.flash_attention``).

``flash_fwd``  replaces the forward pallas_call of ``_flash_fwd_call``
               (flash_attention.py:192), registered as ``'flash_pallas'``

The kernel (``csrc/flash_fwd.cu`` on ``csrc/flash_fwd_sm90.cuh``)
streams K / V tiles through a cp.async ring in shared memory with the
running (m, l, acc) state in registers, so the (S, T) score matrix never
reaches device memory; its per-tile step is
``datapath.online_softmax_update``, as the reference's.  It is bound by
operations on the H100 (see the source note).  Its tiles, copy width and
tile order are :func:`tiling.flash_fwd_plan`'s, not ``block_kv``.

Shapes (the reference's): q (B, S, K, G, h), k (B, T, K, h),
v (B, T, K, hv) -> (B, S, K, G, hv); on a GPU h and hv up to 128, or MLA's
h up to 192 against hv up to 128 (deepseek-v2-lite: nope 128 + rope 64,
v 128), and anything else raises ValueError.  Masking is
:func:`masked_score_block`'s: invalid or causally masked keys score
``MASK_VALUE`` (as in naive attention), keys past T (tile padding) are
phantoms scoring -inf.

Causal tail: a block stops after the kernel tile that holds its q tile's
largest q_pos; every later key is past every row's q_pos and scores
exactly MASK_VALUE, so the kernel folds them in closed form at the end:
n keys of one score update the state as n copies of one key, from sums
of V at the kernel's tile width that its own pre-pass writes into a
scratch this wrapper allocates.  The plain version is the reference's
full sweep of every ``block_kv`` tile (``models.flash``), so it holds the
fold to account at any shape -- also for a row whose every visible key is
masked, where that tail carries most of the mass.  The two agree up to
f32 summation order.  (The int kernel ``flash_snap`` runs on the same body
and folds its tail the same way.)

Gradients: :func:`flash_attention_pallas` runs the kernel inside a
``torch.autograd.Function`` whenever grad is needed (on either device).
Its forward then also writes the (m, l) row statistics, saves (qf, k,
v, o, m, l), and its backward calls the dq and dk/dv kernels of
``flash_attention_bwd.py``.  The scale is folded into q outside the
Function, so its chain rule is PyTorch's, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models import flash as _flash

from . import _build
from . import datapath as dp
from . import dispatch, tiling

_P, _I = _build.P, _build.I

FLASH_FWD = _build.Kernel(
    "flash_fwd", "flash_fwd_launch", [_P] * 9 + [_I] * 14 + [_P],
    source="src/repro_torch/csrc/flash_fwd.cu",
    replaces="src/repro/kernels/flash_attention.py:192")

MAX_HEAD_DIM = 128       # h and hv of rows 3, 4, 9, 10, 11 (their instances)
# rows 5-8 also take MLA's h up to 192 against hv up to 128
# (``tiling.head_width``'s 192 class)
WIDE_HEAD_DIMS = (192, 128)


def head_dims_ok(h: int, hv: int, wide: bool) -> bool:
    """Whether a kernel's instances take head dims h, hv: 1..MAX_HEAD_DIM
    both, or with ``wide`` (rows 5-8) also h up to 192 with hv up to 128."""
    mh, mv = WIDE_HEAD_DIMS if wide else (MAX_HEAD_DIM, MAX_HEAD_DIM)
    return 1 <= h <= mh and 1 <= hv <= mv


def masked_score_block(qf, kb, q_pos, valid, kv_tile: int, *, block_kv: int,
                       causal: bool, t_kv: int, return_mask: bool = False):
    """Masked scores of one KV tile -- ONE definition of the flash masking
    (the reference's, batched): qf (B, S, K, G, h) pre-scaled, kb (B,
    bkv, K, h), q_pos (B, S), valid (B, bkv) -> scores (B, K, G, S, bkv)
    with MASK_VALUE at invalid / causally masked keys and -inf at phantom
    keys (position >= t_kv).  ``return_mask`` also returns where the
    score is the dot product itself (the backward zeroes dS elsewhere)."""
    s = torch.einsum("bskgh,btkh->bkgst", qf, kb.to(torch.float32))
    kv_pos = kv_tile * block_kv + torch.arange(kb.shape[1], device=qf.device)
    mask = (valid != 0)[:, None, None, None, :]
    if causal:
        mask = mask & (kv_pos[None, None, None, None, :]
                       <= q_pos[:, None, None, :, None])
    s = torch.where(mask, s, torch.full_like(s, dp.MASK_VALUE))
    s = torch.where(kv_pos < t_kv, s, torch.full_like(s, -torch.inf))
    if return_mask:
        return s, mask & (kv_pos < t_kv)
    return s


def flash_fwd_plain(qf, k, v, q_pos, kv_valid, *, causal: bool,
                    block_kv: int, return_stats: bool = False):
    """Plain version of the kernel, the full sweep of every KV tile: qf
    (B, S, K, G, h) pre-scaled f32, q_pos (B, S) int32, kv_valid (B, T)
    -> (B, S, K, G, hv) f32 [, m, l (B, K, G, S)]."""
    res = _flash.flash_attention(
        qf, k.to(torch.float32), v.to(torch.float32), q_pos=q_pos,
        kv_valid=kv_valid.bool(), causal=causal, block=block_kv, scale=1.0,
        return_stats=return_stats)
    if return_stats:
        return res[0].contiguous(), res[1], res[2]
    return res.contiguous()


def _check_operands(name, qf, k, v, q_pos, kv_valid, wide: bool = False):
    """Raise ValueError unless the operands are what the blocked kernels
    take; ``wide``: the entry has the 192 class (rows 7 and 8)."""
    b, s_q, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    want = {"qf": (torch.float32, (b, s_q, kh, g, h)),
            "k": (torch.float32, (b, t, kh, h)),
            "v": (torch.float32, (b, t, kh, hv)),
            "q_pos": (torch.int32, (b, s_q)),
            "kv_valid": (torch.uint8, (b, t))}
    got = {"qf": qf, "k": k, "v": v, "q_pos": q_pos, "kv_valid": kv_valid}
    for key, (dtype, shape) in want.items():
        x = got[key]
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {key} is {x.dtype} {tuple(x.shape)}, "
                             f"expected {dtype} {shape}")
        if x.device != qf.device or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on "
                             f"{qf.device}")
    if not head_dims_ok(h, hv, wide):
        lim = ("h 1..192 and hv 1..128" if wide
               else f"1..{MAX_HEAD_DIM}")
        raise ValueError(f"{name}: head dims {h}/{hv}; the kernel takes "
                         f"{lim}")
    if min(b, s_q, kh, g, t) < 1:
        raise ValueError(f"{name}: empty operand")


def check_block_kv(block_kv: int) -> None:
    if not 1 <= block_kv <= tiling.ATTN_BLOCK_KV:
        raise ValueError(f"block_kv={block_kv}: the kernels take "
                         f"1..{tiling.ATTN_BLOCK_KV} keys a tile")


def flash_fwd(qf, k, v, q_pos, kv_valid, *, causal: bool, block_kv: int,
              return_stats: bool = False):
    """The blocked forward through the CUDA kernel (CUDA tensors) or the
    plain version (CPU tensors); arguments as :func:`flash_fwd_plain`."""
    check_block_kv(block_kv)
    if qf.device.type == "cpu":
        return flash_fwd_plain(qf, k, v, q_pos, kv_valid, causal=causal,
                               block_kv=block_kv, return_stats=return_stats)
    _check_operands("flash_fwd", qf, k, v, q_pos, kv_valid, wide=True)
    b, s_q, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    out = torch.empty((b, s_q, kh, g, hv), device=qf.device)
    m = l = None
    if return_stats:
        m = torch.empty((b, kh, g, s_q), device=qf.device)
        l = torch.empty_like(m)
    aligned = all(x.data_ptr() % 16 == 0 for x in (qf, k, v, out))
    plan = tiling.flash_fwd_plan(h, hv, causal=causal, aligned=aligned)
    # the pre-pass's V sums, one row of hv a kernel tile
    vsum = (torch.empty((b, tiling.cdiv(t, plan.block_kv), kh, hv),
                        device=qf.device) if causal else None)
    FLASH_FWD(qf.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
              kv_valid.data_ptr(), None if vsum is None else vsum.data_ptr(),
              out.data_ptr(), None if m is None else m.data_ptr(),
              None if l is None else l.data_ptr(),
              b, s_q, kh, g, h, hv, t, block_kv, int(causal), plan.block_q,
              plan.block_kv, plan.stages, plan.vec, int(plan.reverse),
              _build.stream_ptr(qf.device))
    return (out, m, l) if return_stats else out


class _FlashAttention(torch.autograd.Function):
    """The reference's custom VJP around the blocked forward."""

    @staticmethod
    def forward(ctx, qf, k, v, q_pos, kv_valid, causal, block_kv):
        o, m, l = flash_fwd(qf, k, v, q_pos, kv_valid, causal=causal,
                            block_kv=block_kv, return_stats=True)
        ctx.save_for_backward(qf, k, v, o, m, l, q_pos, kv_valid)
        ctx.causal, ctx.block_kv = causal, block_kv
        return o

    @staticmethod
    def backward(ctx, do):
        from .flash_attention_bwd import flash_attention_bwd_pallas
        qf, k, v, o, m, l, q_pos, kv_valid = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_pallas(
            qf, k, v, o, m, l, do, q_pos=q_pos, kv_valid=kv_valid,
            causal=ctx.causal, block_kv=ctx.block_kv)
        return dq, dk, dv, None, None, None, None


def flash_attention_pallas(q, k, v, *, q_pos, kv_valid, causal: bool = True,
                           scale: float | None = None,
                           block_kv: int | None = None,
                           return_stats: bool = False):
    """Blocked flash attention (the reference's contract): the scale is
    folded into q in f32 before the kernel; ``return_stats`` also returns
    the (B, K, G, S) per-row (m, l) of the pre-scaled scores.  The tiles
    are the kernel's own (``tiling.flash_fwd_plan``); ``block_kv`` (at
    most ``tiling.ATTN_BLOCK_KV``, the plain version's tile) defaults to
    the tiling policy.
    Differentiable in q, k and v; ``return_stats`` is the forward-only
    form and raises ValueError when grad is needed."""
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    if block_kv is None:
        block_kv = tiling.attention_blocks(q.shape[1], k.shape[1])[1]
    qf = (q.to(torch.float32) * scale).contiguous()
    args = (qf, k.to(torch.float32).contiguous(),
            v.to(torch.float32).contiguous(),
            q_pos.to(torch.int32).contiguous(),
            kv_valid.to(torch.uint8).contiguous())
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in args[:3])
    if return_stats:
        if needs_grad:
            raise ValueError(
                "flash_attention_pallas: return_stats is forward-only; "
                "call it under torch.no_grad() or without return_stats")
        o, m, l = flash_fwd(*args, causal=causal, block_kv=block_kv,
                            return_stats=True)
        return o.to(v.dtype), m, l
    if needs_grad:
        return _FlashAttention.apply(*args, causal, block_kv).to(v.dtype)
    return flash_fwd(*args, causal=causal, block_kv=block_kv).to(v.dtype)


def _attention_entry(q, k, v, *, q_pos, kv_valid, causal, scale,
                     softmax_impl="float"):
    if softmax_impl != "float":
        raise ValueError(
            "attn_impl='flash_pallas' is the float blocked kernel and "
            f"cannot honor softmax_impl={softmax_impl!r} (a dualmode word "
            "contract) -- use 'naive' or 'flash_pallas_int'")
    return flash_attention_pallas(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                                  causal=causal, scale=scale)


dispatch.register_attention("flash_pallas", _attention_entry,
                            modes=("float",), grad=True)
