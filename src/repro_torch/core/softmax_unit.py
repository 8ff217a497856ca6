"""The dual-mode softmax unit, bit-accurate on int32 tensors (port of
``repro.core.softmax_unit``).

Normal mode is Eq. (10), division in the log2 domain; GELU/SiLU mode is
Eq. (8), z * softmax_1^2([k, -k]) on the same exp/log datapath.  The
blocked three-sweep folds evaluate normal mode over KV tiles with the
whole-row words (the three-sweep int flash kernel's oracle).  The
snapped-max monoid (ceil-snap the running max to a multiple of 2**T_FRAC
so every rescale is an exact shift, keep one int32 partial sum per depth
bucket) is what the dual-mode decode kernel streams.

This module is the port's single PLAIN definition of the unit's int
arithmetic: the CPU path of every kernel wrapper and the oracle the CUDA
kernels (``csrc/unit.cuh``) are held to, word for word.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.datapath import GELU_CUBIC, LOG2E, SQRT_2_OVER_PI

from .fixedpoint import (EXP_FRAC, I32, IN_FRAC, IN_MAX, IN_MIN, T_FRAC,
                         dequantize, floor_log2, mantissa_frac, quantize,
                         sat_rshift)
from .pwl import exp2_frac_int, log2_mant_int

# the ROM words of the datapath, quantized from the float home's constants
LOG2E_FRAC = 12
LOG2E_Q = int(round(LOG2E * (1 << LOG2E_FRAC)))                     # 5909
GELU_A_Q = int(round(GELU_CUBIC * (1 << 16)))                       # cubic
GELU_C_Q = int(round(SQRT_2_OVER_PI * (1 << 14)))                   # sqrt(2/pi)

# sentinel word of positions that carry exactly zero mass (see reference)
PHANTOM_Q = -(1 << 20)
SNAP_MIN = -(1 << 30)     # snapped-carry sentinel (a multiple of 2**T_FRAC)
N_SNAP_BUCKETS = 16       # depth range = the unit's 16-octave dynamic range


def guard_shift_for(n: int) -> int:
    """Down-shift before the int32 sum so that rows of n elements cannot
    overflow it (the reference's rule, from the UNPADDED row length)."""
    return max(0, n.bit_length() - 16)


def _to_log2_domain(d: torch.Tensor, in_frac: int) -> torch.Tensor:
    """t = d*log2(e) @ 2**-T_FRAC for d <= 0 @ 2**-in_frac, d saturated at
    -32 so the int32 product stays in range."""
    d = torch.clamp(d.to(I32), min=-(32 << in_frac))
    return (d * LOG2E_Q) >> (in_frac + LOG2E_FRAC - T_FRAC)


def _exp2_int(t: torch.Tensor) -> torch.Tensor:
    """2**t for t <= 0 @ 2**-T_FRAC -> @ 2**-EXP_FRAC (shift of a PWL)."""
    u = t >> T_FRAC
    v = t - (u << T_FRAC)
    return sat_rshift(exp2_frac_int(v), -u)


def _log2_int(s: torch.Tensor, s_frac: int) -> torch.Tensor:
    """log2 of s (int > 0 @ 2**-s_frac) @ 2**-T_FRAC."""
    e_pos = floor_log2(s)
    log2m = log2_mant_int(mantissa_frac(s, e_pos, T_FRAC))
    return ((e_pos - s_frac) << T_FRAC) + log2m


def softmax_int(x_fx: torch.Tensor, dim: int = -1,
                guard_shift: int | None = None) -> torch.Tensor:
    """Normal mode, Eq. (10), over ``dim``: S5.10 words -> probability
    words @ 2**-EXP_FRAC."""
    if guard_shift is None:
        guard_shift = guard_shift_for(x_fx.shape[dim])
    x_fx = x_fx.to(I32)
    m = torch.amax(x_fx, dim=dim, keepdim=True)
    t = _to_log2_domain(x_fx - m, IN_FRAC)
    e = _exp2_int(t)
    s = torch.sum(e >> guard_shift, dim=dim, keepdim=True).to(I32)
    s = torch.clamp(s, min=1)
    log2s = _log2_int(s, EXP_FRAC - guard_shift)
    return _exp2_int(torch.clamp(t - log2s, max=0))


def _pair_softmax_first_int(k_fx: torch.Tensor, k_frac: int) -> torch.Tensor:
    """softmax_1^2([k, -k]) = sigma(2k) @ 2**-EXP_FRAC through the shared
    exp/log datapath (k_fx @ 2**-k_frac)."""
    amax = torch.abs(k_fx)
    t1 = _to_log2_domain(k_fx - amax, k_frac)
    t2 = _to_log2_domain(-k_fx - amax, k_frac)
    s = torch.clamp(_exp2_int(t1) + _exp2_int(t2), min=1)
    log2s = _log2_int(s, EXP_FRAC)
    return _exp2_int(torch.clamp(t1 - log2s, max=0))


def gelu_k_int(z_fx: torch.Tensor) -> torch.Tensor:
    """k = sqrt(2/pi) (z + GELU_CUBIC z^3), S5.10 in and out; |z| <= 8."""
    z = torch.clamp(z_fx.to(I32), -(8 << IN_FRAC), 8 << IN_FRAC)
    z2 = (z * z) >> IN_FRAC
    z3 = (z2 * z) >> IN_FRAC
    az3 = (z3 * GELU_A_Q) >> 16
    return ((z + az3) * GELU_C_Q) >> 14


def gelu_int(z_fx: torch.Tensor) -> torch.Tensor:
    """GELU mode (Eq. 8): z * softmax_1^2([k, -k]).  S5.10 -> S5.10."""
    sig = _pair_softmax_first_int(gelu_k_int(z_fx), IN_FRAC)
    return (z_fx.to(I32) * sig) >> EXP_FRAC


def silu_int(z_fx: torch.Tensor) -> torch.Tensor:
    """SiLU mode: z * softmax_1^2([z/2, -z/2]) (z read at scale 2**-11)."""
    sig = _pair_softmax_first_int(z_fx.to(I32), IN_FRAC + 1)
    return (z_fx.to(I32) * sig) >> EXP_FRAC


# --- blocked / online evaluation of normal mode -----------------------------
#
# The PWL exp2 is not multiplicative, so a one-sweep rescale of old sums
# would change words.  The max fold and the guard-shifted sum fold are
# associative int32 reductions and the emit is elementwise given the
# final (m, l): three KV sweeps -- max, sum, emit -- telescope to the
# whole-row softmax_int words for any blocking.  The three-sweep kernel
# (``kernels/flash_attention_int.flash_int3``) computes these steps.

def online_max_int(m: torch.Tensor, x_blk: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Sweep 1 fold: running row max (init the carry with PHANTOM_Q)."""
    return torch.maximum(m, torch.amax(x_blk.to(I32), dim=dim, keepdim=True))


def online_sum_int(l: torch.Tensor, m: torch.Tensor, x_blk: torch.Tensor,
                   guard_shift: int, dim: int = -1) -> torch.Tensor:
    """Sweep 2 fold: guard-shifted int32 row-sum carry (init 0) against
    the FINAL sweep-1 max ``m``."""
    e = _exp2_int(_to_log2_domain(x_blk.to(I32) - m, IN_FRAC))
    return l + torch.sum(e >> guard_shift, dim=dim, keepdim=True).to(I32)


def online_probs_int(m: torch.Tensor, l: torch.Tensor, x_blk: torch.Tensor,
                     guard_shift: int) -> torch.Tensor:
    """Sweep 3 emit: this block's probability words @ 2**-EXP_FRAC, the
    whole-row tail of :func:`softmax_int` given the final (m, l)."""
    t = _to_log2_domain(x_blk.to(I32) - m, IN_FRAC)
    log2s = _log2_int(torch.clamp(l, min=1), EXP_FRAC - guard_shift)
    return _exp2_int(torch.clamp(t - log2s, max=0))


def softmax_int_blocked(x_fx: torch.Tensor, block: int,
                        guard_shift: int | None = None) -> torch.Tensor:
    """Whole-row normal mode over the last axis as the three blocked
    sweeps; bitwise :func:`softmax_int` for any ``block``."""
    n = x_fx.shape[-1]
    if guard_shift is None:
        guard_shift = guard_shift_for(n)
    x_fx = x_fx.to(I32)
    blocks = [x_fx[..., i:i + block] for i in range(0, n, block)]
    m = torch.full(x_fx.shape[:-1] + (1,), PHANTOM_Q, dtype=I32,
                   device=x_fx.device)
    for b in blocks:
        m = online_max_int(m, b)
    l = torch.zeros_like(m)
    for b in blocks:
        l = online_sum_int(l, m, b, guard_shift)
    return torch.cat([online_probs_int(m, l, b, guard_shift)
                      for b in blocks], dim=-1)


# --- snapped-max mode: the word-exact online-softmax monoid ----------------

def to_snap_domain(x_fx: torch.Tensor) -> torch.Tensor:
    """Absolute log2-domain word t = x*log2(e) @ 2**-T_FRAC; PHANTOM_Q
    sentinels map to SNAP_MIN."""
    x = x_fx.to(I32)
    t = (torch.clamp(x, IN_MIN, IN_MAX) * LOG2E_Q) \
        >> (IN_FRAC + LOG2E_FRAC - T_FRAC)
    return torch.where(x <= PHANTOM_Q, torch.full_like(t, SNAP_MIN), t)


def snap_max_int(t_max: torch.Tensor) -> torch.Tensor:
    """Ceil-snap a log2-domain word up to a multiple of 2**T_FRAC."""
    t_max = t_max.to(I32)
    return ((t_max + ((1 << T_FRAC) - 1)) >> T_FRAC) << T_FRAC


def snap_prob_word(t: torch.Tensor, guard_shift: int) -> torch.Tensor:
    """Max-independent guard-shifted probability word of ``t`` (0 for
    SNAP_MIN sentinels)."""
    p = exp2_frac_int(t & ((1 << T_FRAC) - 1)) >> guard_shift
    return torch.where(t > SNAP_MIN, p, torch.zeros_like(p))


def snap_scale_f32(d: torch.Tensor) -> torch.Tensor:
    """Exact float32 2**-d for int depth d >= 0, by exponent-field
    construction; depths past the normal range give +0.0."""
    e = torch.clamp(127 - d.to(I32), 0, 254)
    return (e << 23).view(torch.float32)


def slide_buckets_int(S: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """S'[d] = S[d - k] with zero fill (k >= 0), over the last axis."""
    idx = torch.arange(N_SNAP_BUCKETS, dtype=I32, device=S.device)
    src = idx - k
    take = torch.gather(
        S, -1, torch.clamp(src, 0, N_SNAP_BUCKETS - 1).long().expand(
            S.shape))
    return torch.where(src >= 0, take, torch.zeros_like(take))


def depth_buckets(p: torch.Tensor, d: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-depth sums of the words ``p`` over ``dim``; bucket axis last."""
    return torch.stack(
        [torch.sum(torch.where(d == kk, p, torch.zeros_like(p)),
                   dim=dim).to(I32) for kk in range(N_SNAP_BUCKETS)], dim=-1)


def online_partial_int(x_blk: torch.Tensor, guard_shift: int, v=None,
                       dim: int = -1):
    """Self-contained snapped partial (m, S, acc) of one block of words
    over ``dim`` (m keepdim, S bucket axis last, acc f32)."""
    t = to_snap_domain(x_blk)
    m = snap_max_int(torch.amax(t, dim=dim, keepdim=True))
    p = snap_prob_word(t, guard_shift)
    d = (m >> T_FRAC) - (t >> T_FRAC)
    S = depth_buckets(p, d, dim)
    num = p.to(torch.float32) * snap_scale_f32(d)
    acc = num if v is None else torch.einsum("...n,...nd->...d", num, v)
    return m, S, acc


def online_merge_int(part_a, part_b):
    """Word-exact merge of two snapped partials (the int monoid fold)."""
    m_a, S_a, acc_a = part_a
    m_b, S_b, acc_b = part_b
    m = torch.maximum(m_a, m_b)
    k_a = (m - m_a) >> T_FRAC
    k_b = (m - m_b) >> T_FRAC
    S = slide_buckets_int(S_a, k_a) + slide_buckets_int(S_b, k_b)
    acc = acc_a * snap_scale_f32(k_a) + acc_b * snap_scale_f32(k_b)
    return m, S, acc


def online_merge_n_int(m: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                       dim: int = 0):
    """n-way fold of snapped partials stacked along ``dim`` (kept as a
    singleton); the decode kernel's split fold."""
    m_all = torch.amax(m, dim=dim, keepdim=True)
    k = (m_all - m) >> T_FRAC
    S = torch.sum(slide_buckets_int(S, k), dim=dim, keepdim=True).to(I32)
    acc = torch.sum(acc * snap_scale_f32(k), dim=dim, keepdim=True)
    return m_all, S, acc


def online_finish_int(S: torch.Tensor) -> torch.Tensor:
    """Exact bucketed normalizer l = sum_d (S_d >> d), clamped >= 1."""
    sh = torch.arange(N_SNAP_BUCKETS, dtype=I32, device=S.device)
    l = torch.sum(torch.bitwise_right_shift(S, sh), dim=-1).to(I32)
    return torch.clamp(l, min=1)


def snap_row_stats(x_fx: torch.Tensor, dim: int = -1,
                   guard_shift: int | None = None):
    """Whole-row snapped statistics (p, d, l), l keepdim at ``dim``."""
    if guard_shift is None:
        guard_shift = guard_shift_for(x_fx.shape[dim])
    m, S, _ = online_partial_int(x_fx, guard_shift, dim=dim)
    t = to_snap_domain(x_fx)
    p = snap_prob_word(t, guard_shift)
    d = (m >> T_FRAC) - (t >> T_FRAC)
    return p, d, online_finish_int(S).unsqueeze(dim)


def softmax_snap(x_fx: torch.Tensor, dim: int = -1,
                 guard_shift: int | None = None) -> torch.Tensor:
    """Snapped-max normal mode: S5.10 words -> f32 probabilities, one
    f32 division of exact numerators."""
    p, d, l = snap_row_stats(x_fx, dim=dim, guard_shift=guard_shift)
    return p.to(torch.float32) * snap_scale_f32(d) / l.to(torch.float32)


def softmax_snap_blocked(x_fx: torch.Tensor, block: int,
                         guard_shift: int | None = None) -> torch.Tensor:
    """Whole-row snapped mode over the last axis as a blocked monoid fold
    (partials merged with :func:`online_merge_int`); bitwise
    :func:`softmax_snap` for any ``block``."""
    n = x_fx.shape[-1]
    if guard_shift is None:
        guard_shift = guard_shift_for(n)
    x_fx = x_fx.to(I32)
    lead, dev = x_fx.shape[:-1], x_fx.device
    zero_acc = torch.zeros(lead + (1,), device=dev)
    part = (torch.full(lead + (1,), SNAP_MIN, dtype=I32, device=dev),
            torch.zeros(lead + (N_SNAP_BUCKETS,), dtype=I32, device=dev),
            zero_acc)
    for i in range(0, n, block):
        m_b, S_b, _ = online_partial_int(x_fx[..., i:i + block], guard_shift)
        part = online_merge_int(part, (m_b, S_b, zero_acc))
    m, S, _ = part
    t = to_snap_domain(x_fx)
    p = snap_prob_word(t, guard_shift)
    d = (m >> T_FRAC) - (t >> T_FRAC)
    l = online_finish_int(S).unsqueeze(-1)
    return p.to(torch.float32) * snap_scale_f32(d) / l.to(torch.float32)


# --- float wrappers (quantize -> int unit -> dequantize) --------------------

def softmax_dualmode(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float in/out softmax through the bit-accurate unit (normal mode)."""
    return dequantize(softmax_int(quantize(x), dim=dim), EXP_FRAC)


def softmax_dualmode_snap(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float in/out softmax through the snapped-max unit."""
    return softmax_snap(quantize(x), dim=dim)


def gelu_dualmode(z: torch.Tensor) -> torch.Tensor:
    """float in/out GELU through the bit-accurate unit (GELU mode)."""
    return dequantize(gelu_int(quantize(z)), IN_FRAC)


def silu_dualmode(z: torch.Tensor) -> torch.Tensor:
    """float in/out SiLU through the bit-accurate unit (SiLU mode)."""
    return dequantize(silu_int(quantize(z)), IN_FRAC)
