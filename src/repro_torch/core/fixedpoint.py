"""Fixed-point arithmetic helpers on int32 tensors (port of
``repro.core.fixedpoint``).

Formats: inputs S5.10 (scale 2**-10, range [-32, 32)), int32 internals.
Semantics kept from the reference: ``quantize`` rounds half-to-even,
``>>`` is an arithmetic shift on int32, and every variable shift is
clamped so that no shift amount reaches 32.
"""
from __future__ import annotations

import torch

IN_FRAC = 10          # S5.10 input fraction bits
IN_BITS = 16
IN_MIN = -(1 << (IN_BITS - 1))          # -32768
IN_MAX = (1 << (IN_BITS - 1)) - 1       # +32767
EXP_FRAC = 14         # scale of PWL-exp2 outputs
T_FRAC = 16           # scale of the log2-domain quantities

I32 = torch.int32


def quantize(x: torch.Tensor, frac_bits: int = IN_FRAC) -> torch.Tensor:
    """float -> saturating S(15-frac).frac int32 (16-bit range).

    ``torch.round`` is half-to-even like ``jnp.round``; the clamp happens
    in float before the cast so that out-of-range values saturate
    instead of hitting an undefined float->int conversion.
    """
    r = torch.round(x.to(torch.float32) * (1 << frac_bits))
    return torch.clamp(r, IN_MIN, IN_MAX).to(I32)


def dequantize(q: torch.Tensor, frac_bits: int = IN_FRAC) -> torch.Tensor:
    return q.to(torch.float32) * (1.0 / (1 << frac_bits))


def floor_log2(v: torch.Tensor) -> torch.Tensor:
    """Leading-one position of v (v >= 1): floor(log2(v)); 0 for v < 1."""
    v = v.to(I32)
    r = torch.zeros_like(v)
    for shift in (16, 8, 4, 2, 1):
        cond = v >= (1 << shift)
        v = torch.where(cond, v >> shift, v)
        r = r + torch.where(cond, shift, 0).to(I32)
    return r


def mantissa_frac(s: torch.Tensor, e_pos: torch.Tensor,
                  frac_bits: int = T_FRAC) -> torch.Tensor:
    """(s / 2**e_pos - 1) at scale 2**-frac_bits, in [0, 2**frac_bits)."""
    s = s.to(I32)
    rem = s - torch.bitwise_left_shift(torch.ones_like(s), e_pos)
    up = torch.clamp(frac_bits - e_pos, min=0)
    down = torch.clamp(e_pos - frac_bits, min=0)
    return torch.bitwise_right_shift(torch.bitwise_left_shift(rem, up), down)


def sat_rshift(x: torch.Tensor, n) -> torch.Tensor:
    """Arithmetic right shift with the shift amount clamped to [0, 31]."""
    if isinstance(n, int):
        return x >> min(max(n, 0), 31)
    return torch.bitwise_right_shift(x, torch.clamp(n, 0, 31).to(x.dtype))
