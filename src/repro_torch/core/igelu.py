"""i-GELU, the integer-only GELU of I-BERT [Kim et al., ICML 2021] (port
of ``repro.core.igelu``): the baseline the paper compares its unit with
(the 'i-GELU' model of Table I).

erf is approximated by the clipped second-order polynomial

    erf(x) ~= sign(x) * [ a (min(|x|, -b) + b)^2 + 1 ],   a=-0.2888, b=-1.769

and GELU(x) = x * 0.5 * (1 + erf(x / sqrt(2))), in float and bit-level in
int32 on S5.10 words, the dual-mode unit's input format.
"""
from __future__ import annotations

import math

import torch

from .fixedpoint import I32, IN_FRAC, dequantize, quantize

_A = -0.2888
_B = -1.769
_INV_SQRT2_Q = int(round((1.0 / math.sqrt(2.0)) * (1 << 15)))   # Q0.15
_B_Q = int(round(-_B * (1 << IN_FRAC)))                         # 1.769 @ S5.10
_A_Q = int(round(-_A * (1 << 14)))                              # 0.2888 @ Q.14
_ONE = 1 << IN_FRAC


def igelu_float(x: torch.Tensor) -> torch.Tensor:
    """Float i-GELU (I-BERT eq. 5)."""
    s = x / math.sqrt(2.0)
    l = torch.sign(s) * (_A * (torch.clamp(torch.abs(s), max=-_B) + _B) ** 2
                         + 1.0)
    return x * 0.5 * (1.0 + l)


def igelu_int(x_fx: torch.Tensor) -> torch.Tensor:
    """Bit-level int32 i-GELU.  S5.10 -> S5.10."""
    x = x_fx.to(I32)
    s = (x * _INV_SQRT2_Q) >> 15                      # x/sqrt2 @ 2**-IN_FRAC
    t = torch.clamp(torch.abs(s), max=_B_Q) - _B_Q    # <= 0
    sq = (t * t) >> IN_FRAC
    poly = _ONE - ((sq * _A_Q) >> 14)                 # a*sq+1 @ 2**-IN_FRAC
    erf = torch.sign(s) * poly
    # x * (1 + erf) / 2: the product @ 2**-2*IN_FRAC, shifted by IN_FRAC+1
    return (x * (_ONE + erf)) >> (IN_FRAC + 1)


def igelu_quant(x: torch.Tensor) -> torch.Tensor:
    """float in/out through the int form (the Table I 'i-GELU' model)."""
    return dequantize(igelu_int(quantize(x)), IN_FRAC)
