"""Blocked attention on the unit's bit-accurate int datapath (port of
``repro.kernels.flash_attention_int``).

``flash_snap``  replaces the pallas_call of ``_flash_snap_jit``
                (flash_attention_int.py:218), registered as
                ``'flash_pallas_int'``
``flash_int3``  replaces the pallas_call of ``_flash_int_jit``
                (flash_attention_int.py:354), registered as
                ``'flash_pallas_int3'``

One KV sweep of the snapped-max recurrence: the running max is
ceil-snapped to a power of two, so every rescale is an exact shift of
int words, the normalizer carry is one int32 partial sum per depth (16
buckets) and the f32 accumulator rescales by exact powers of two.  The
output is the naive ``softmax_impl='dualmode_snap'`` attention with
identical (p, d, l) words; only the f32 numerator @ v summation order
differs, and not at all under an identity-v probe.  The kernel
(``csrc/flash_snap.cu``) runs on the float forward's Hopper body
(``csrc/flash_fwd_sm90.cuh``: its tiles, ring, scores, mask, p tile, P V
product and pre-pass) with the snapped int row state in registers
(``csrc/flash_snap_sm90.cuh``); its tiles, copy width and tile order
are row 7's, :func:`tiling.flash_fwd_plan`'s, not ``block_kv``.

Masking is the float kernel's (:mod:`.flash_attention`): invalid or
causally masked keys score ``MASK_VALUE`` before quantization, phantom
keys take ``PHANTOM_Q``, whose exponential is the literal 0 word; scores
quantize as ``quantize((q * scale) . k)``, the naive path's order.  The
kernel folds the causal tail (every key past its q tile's causal end,
one score word each) in closed form as the float kernel does, from the
chunk-local V sums of its own pre-pass (a scratch this wrapper
allocates): its (m, S) words are the full sweep's exactly.  The plain
version is that full sweep of every tile, so the fold is held to it at
any shape.

Three sweeps of the classic unit: the unsnapped rescale is not
multiplicative in words, so ``flash_int3`` runs the row max, the
guard-shifted sum and the emit of the probability words as three sweeps
over the same KV tiles (``softmax_unit.online_max_int`` /
``online_sum_int`` / ``online_probs_int``).  Its probability words are
the whole-row ``softmax_int`` words of naive ``softmax_impl='dualmode'``
attention bit for bit; only the f32 p @ v order differs.  It sweeps
every tile, causal or not, so it needs no tail fold.  The kernel
(``csrc/flash_int3.cu``) runs on the same Hopper body with the classic
int row state (``csrc/flash_int3_sm90.cuh``): where a q tile's score
words fit in shared memory (:func:`tiling.flash_int3_plan`), one sweep of
K keeps them and the sum and the P V sweep read them back, so K is read
once and each score computed once; past that, each sweep recomputes
them.
"""
from __future__ import annotations

import torch

from repro_torch.core import softmax_unit as unit
from repro_torch.core.fixedpoint import EXP_FRAC, T_FRAC, dequantize, quantize

from . import _build
from . import dispatch, tiling
from .flash_attention import (_check_operands, check_block_kv,
                              masked_score_block)

_P, _I = _build.P, _build.I

FLASH_SNAP = _build.Kernel(
    "flash_snap", "flash_snap_launch", [_P] * 9 + [_I] * 15 + [_P],
    source="src/repro_torch/csrc/flash_snap.cu",
    replaces="src/repro/kernels/flash_attention_int.py:218")
FLASH_INT3 = _build.Kernel(
    "flash_int3", "flash_int3_launch", [_P] * 6 + [_I] * 15 + [_P],
    source="src/repro_torch/csrc/flash_int3.cu",
    replaces="src/repro/kernels/flash_attention_int.py:354")


def int_score_words(qf, kb, q_pos, valid, kv_tile: int, *, block_kv: int,
                    causal: bool, t_kv: int):
    """One KV tile of S5.10 score WORDS (the int twin of
    ``masked_score_block``, shapes as there): mask to ``MASK_VALUE``,
    quantize, then overwrite phantom keys with ``PHANTOM_Q``."""
    s = masked_score_block(qf, kb, q_pos, valid, kv_tile, block_kv=block_kv,
                           causal=causal, t_kv=t_kv)
    phantom = torch.isneginf(s)
    sq = quantize(torch.where(phantom, torch.zeros_like(s), s))
    return torch.where(phantom, torch.full_like(sq, unit.PHANTOM_Q), sq)


def slide_lanes(S, k):
    """Bucket slide S'[..., d] = S[..., d - k] (0-fill, drop past the last
    bucket), built from static shifts selected by the bits of k, as the
    reference's kernel builds it; the same words as
    ``softmax_unit.slide_buckets_int``."""
    nb = unit.N_SNAP_BUCKETS
    S = torch.where(k >= nb, torch.zeros_like(S), S)
    kc = torch.clamp(k, max=nb - 1)
    for b in (1, 2, 4, 8):
        shifted = torch.cat([torch.zeros(S.shape[:-1] + (b,), dtype=S.dtype,
                                         device=S.device), S[..., :nb - b]],
                            dim=-1)
        S = torch.where((kc & b) != 0, shifted, S)
    return S


def snap_tile_update(m, S, acc, sq, vb, guard_shift: int):
    """One KV tile of the snapped online recurrence, batched over leading
    dims: m (..., 1) i32 snapped carry, S (..., 16) i32 buckets, acc (...,
    hv) f32, sq (..., bkv) S5.10 score words, vb (..., bkv, hv) f32.
    Words are bit-identical to folding ``online_partial_int`` of the tile
    into the carry with ``online_merge_int``."""
    t = unit.to_snap_domain(sq)
    m_new = torch.maximum(
        m, unit.snap_max_int(torch.amax(t, dim=-1, keepdim=True)))
    k_corr = (m_new - m) >> T_FRAC
    p = unit.snap_prob_word(t, guard_shift)
    d = (m_new >> T_FRAC) - (t >> T_FRAC)
    S_new = slide_lanes(S, k_corr) + unit.depth_buckets(p, d, -1)
    num = p.to(torch.float32) * unit.snap_scale_f32(d)
    acc_new = acc * unit.snap_scale_f32(k_corr) + torch.einsum(
        "...t,...tv->...v", num, vb)
    return m_new, S_new, acc_new


def flash_snap_plain(qf, k, v, q_pos, kv_valid, *, causal: bool,
                     block_kv: int, guard_shift: int,
                     return_partial: bool = False):
    """Plain version of the kernel, the full sweep of every KV tile: qf
    (B, S, K, G, h) pre-scaled f32, q_pos (B, S) int32, kv_valid (B, T)
    -> (B, S, K, G, hv) f32, or with ``return_partial`` the unnormalized
    (acc, m (B, K, G, S) i32, S (B, K, G, S, 16) i32)."""
    b, s_q, kh, g, _ = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    _, qp, kp, vp, valid = tiling.pad_attention_operands(
        qf, q_pos, k, v, kv_valid, 1, block_kv)
    dev = qf.device
    m = torch.full((b, kh, g, s_q, 1), unit.SNAP_MIN, dtype=torch.int32,
                   device=dev)
    S = torch.zeros((b, kh, g, s_q, unit.N_SNAP_BUCKETS), dtype=torch.int32,
                    device=dev)
    acc = torch.zeros((b, kh, g, s_q, hv), device=dev)
    for j in range(tiling.cdiv(t, block_kv)):
        sl = slice(j * block_kv, (j + 1) * block_kv)
        sq = int_score_words(qf, kp[:, sl], qp, valid[:, sl], j,
                             block_kv=block_kv, causal=causal, t_kv=t)
        vb = vp[:, sl].to(torch.float32).permute(0, 2, 1, 3)[:, :, None,
                                                                None]
        m, S, acc = snap_tile_update(m, S, acc, sq, vb, guard_shift)
    if return_partial:
        return acc.movedim(3, 1).contiguous(), m[..., 0], S
    l = unit.online_finish_int(S)
    return (acc / l[..., None].to(torch.float32)).movedim(3, 1).contiguous()


def flash_snap(qf, k, v, q_pos, kv_valid, *, causal: bool, block_kv: int,
               guard_shift: int, return_partial: bool = False):
    """The one-sweep int sweep through the CUDA kernel (CUDA tensors) or
    the plain version (CPU tensors); arguments as
    :func:`flash_snap_plain`."""
    check_block_kv(block_kv)
    if not 0 <= guard_shift <= 31:
        raise ValueError(f"guard_shift={guard_shift} outside [0, 31]")
    if qf.device.type == "cpu":
        return flash_snap_plain(qf, k, v, q_pos, kv_valid, causal=causal,
                                block_kv=block_kv, guard_shift=guard_shift,
                                return_partial=return_partial)
    _check_operands("flash_snap", qf, k, v, q_pos, kv_valid, wide=True)
    b, s_q, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    dev = qf.device
    out = torch.empty((b, s_q, kh, g, hv), device=dev)
    m = S = None
    if return_partial:
        m = torch.empty((b, kh, g, s_q), dtype=torch.int32, device=dev)
        S = torch.empty((b, kh, g, s_q, unit.N_SNAP_BUCKETS),
                        dtype=torch.int32, device=dev)
    plan = tiling.flash_fwd_plan(h, hv, causal=causal,
                                 aligned=tiling.aligned16(qf, k, v, out))
    # the pre-pass's V sums, one row of hv a kernel tile
    vsum = (torch.empty((b, tiling.cdiv(t, plan.block_kv), kh, hv),
                        device=dev) if causal else None)
    FLASH_SNAP(qf.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
               kv_valid.data_ptr(), None if vsum is None else vsum.data_ptr(),
               out.data_ptr(), None if m is None else m.data_ptr(),
               None if S is None else S.data_ptr(),
               b, s_q, kh, g, h, hv, t, block_kv, int(causal), guard_shift,
               plan.block_q, plan.block_kv, plan.stages, plan.vec,
               int(plan.reverse), _build.stream_ptr(dev))
    return (out, m, S) if return_partial else out


def flash_attention_pallas_int(q, k, v, *, q_pos, kv_valid,
                               causal: bool = True,
                               scale: float | None = None,
                               block_kv: int | None = None,
                               guard_shift: int | None = None,
                               return_partial: bool = False):
    """ONE-sweep blocked dual-mode attention (the reference's contract).

    ``guard_shift`` defaults to the whole-row rule for a row of the FULL
    key extent T (not the valid length).  ``return_partial`` returns the
    unnormalized (acc (B, S, K, G, hv) f32, m (B, K, G, S) i32, S (B, K,
    G, S, 16) i32) monoid partial the ring folds."""
    t = k.shape[1]
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    if guard_shift is None:
        guard_shift = unit.guard_shift_for(t)
    if block_kv is None:
        block_kv = tiling.attention_blocks(q.shape[1], t)[1]
    qf = (q.to(torch.float32) * scale).contiguous()
    res = flash_snap(qf, k.to(torch.float32).contiguous(),
                     v.to(torch.float32).contiguous(),
                     q_pos.to(torch.int32).contiguous(),
                     kv_valid.to(torch.uint8).contiguous(), causal=causal,
                     block_kv=block_kv, guard_shift=guard_shift,
                     return_partial=return_partial)
    return res if return_partial else res.to(v.dtype)


# --------------------------------------------------------------------------
# three-sweep classic int flash ('flash_pallas_int3')
# --------------------------------------------------------------------------

def flash_int3_plain(qf, k, v, q_pos, kv_valid, *, causal: bool,
                     block_kv: int, guard_shift: int):
    """Plain version of the kernel, the three sweeps over every KV tile:
    qf (B, S, K, G, h) pre-scaled f32, q_pos (B, S) int32, kv_valid (B, T)
    -> (B, S, K, G, hv) f32."""
    b, s_q, kh, g, _ = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    _, qp, kp, vp, valid = tiling.pad_attention_operands(
        qf, q_pos, k, v, kv_valid, 1, block_kv)
    dev = qf.device
    n_tiles = tiling.cdiv(t, block_kv)

    def words(j):
        sl = slice(j * block_kv, (j + 1) * block_kv)
        return int_score_words(qf, kp[:, sl], qp, valid[:, sl], j,
                               block_kv=block_kv, causal=causal, t_kv=t)
    m = torch.full((b, kh, g, s_q, 1), unit.PHANTOM_Q, dtype=torch.int32,
                   device=dev)
    for j in range(n_tiles):
        m = unit.online_max_int(m, words(j))
    l = torch.zeros_like(m)
    for j in range(n_tiles):
        l = unit.online_sum_int(l, m, words(j), guard_shift)
    acc = torch.zeros((b, kh, g, s_q, hv), device=dev)
    for j in range(n_tiles):
        p = dequantize(unit.online_probs_int(m, l, words(j), guard_shift),
                       EXP_FRAC)
        vb = vp[:, j * block_kv:(j + 1) * block_kv].to(torch.float32)
        acc = acc + torch.einsum("bkgst,btkv->bkgsv", p, vb)
    return acc.movedim(3, 1).contiguous()


def flash_int3(qf, k, v, q_pos, kv_valid, *, causal: bool, block_kv: int,
               guard_shift: int):
    """The three-sweep int attention through the CUDA kernel (CUDA
    tensors) or the plain version (CPU tensors); arguments as
    :func:`flash_int3_plain`."""
    check_block_kv(block_kv)
    if not 0 <= guard_shift <= 31:
        raise ValueError(f"guard_shift={guard_shift} outside [0, 31]")
    if qf.device.type == "cpu":
        return flash_int3_plain(qf, k, v, q_pos, kv_valid, causal=causal,
                                block_kv=block_kv, guard_shift=guard_shift)
    _check_operands("flash_int3", qf, k, v, q_pos, kv_valid)
    b, s_q, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    out = torch.empty((b, s_q, kh, g, hv), device=qf.device)
    plan = tiling.flash_int3_plan(h, hv, t,
                                  aligned=tiling.aligned16(qf, k, v, out))
    FLASH_INT3(qf.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
               kv_valid.data_ptr(), out.data_ptr(), b, s_q, kh, g, h, hv, t,
               block_kv, int(causal), guard_shift, plan.block_q,
               plan.block_kv, plan.stages, plan.vec, int(plan.cache),
               _build.stream_ptr(qf.device))
    return out


def flash_attention_pallas_int3(q, k, v, *, q_pos, kv_valid,
                                causal: bool = True,
                                scale: float | None = None,
                                block_kv: int | None = None):
    """THREE-sweep blocked dual-mode attention (the reference's contract):
    the naive ``softmax_impl='dualmode'`` attention with identical int
    probability words; only the f32 p @ v order differs.  The guard shift
    is the whole-row rule for the full key extent T."""
    t = k.shape[1]
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    if block_kv is None:
        block_kv = tiling.attention_blocks(q.shape[1], t)[1]
    qf = (q.to(torch.float32) * scale).contiguous()
    out = flash_int3(qf, k.to(torch.float32).contiguous(),
                     v.to(torch.float32).contiguous(),
                     q_pos.to(torch.int32).contiguous(),
                     kv_valid.to(torch.uint8).contiguous(), causal=causal,
                     block_kv=block_kv, guard_shift=unit.guard_shift_for(t))
    return out.to(v.dtype)


def _attention_entry(q, k, v, *, q_pos, kv_valid, causal, scale,
                     softmax_impl="dualmode"):
    # the one-sweep kernel runs on snap words, so it honors BOTH int
    # contracts: 'dualmode' and 'dualmode_snap' give the same words here
    if softmax_impl not in ("dualmode", "dualmode_snap"):
        raise ValueError(
            "attn_impl='flash_pallas_int' IS the bit-accurate unit; it "
            f"cannot honor softmax_impl={softmax_impl!r} (use 'dualmode', "
            "or a float impl: 'flash'/'flash_pallas')")
    return flash_attention_pallas_int(q, k, v, q_pos=q_pos,
                                      kv_valid=kv_valid, causal=causal,
                                      scale=scale)


dispatch.register_attention("flash_pallas_int", _attention_entry,
                            modes=("dualmode", "dualmode_snap"), grad=False)


def _attention_entry3(q, k, v, *, q_pos, kv_valid, causal, scale,
                      softmax_impl="dualmode"):
    if softmax_impl != "dualmode":
        raise ValueError(
            "attn_impl='flash_pallas_int3' IS the bit-accurate unit; it "
            f"cannot honor softmax_impl={softmax_impl!r} (use 'dualmode', "
            "or a float impl: 'flash'/'flash_pallas')")
    return flash_attention_pallas_int3(q, k, v, q_pos=q_pos,
                                       kv_valid=kv_valid, causal=causal,
                                       scale=scale)


dispatch.register_attention("flash_pallas_int3", _attention_entry3,
                            modes=("dualmode",), grad=False)
