"""Eight-piece piecewise-linear approximations (port of ``repro.core.pwl``).

2**v for v in [0, 1) and log2(1 + f) for f in [0, 1), each with 8
segments selected by the top 3 bits of the fraction.  The reference fits
the coefficients with ``np.polyfit`` at import; here they are the ROM
words themselves, written out as literals: the quantized Q2.14 tables
are what the hardware (and the CUDA kernels, through a header generated
from this module at build time) store.  ``tests/test_torch_unit.py``
holds every table equal to the reference's.
"""
from __future__ import annotations

import torch

from .fixedpoint import EXP_FRAC, I32, T_FRAC

N_SEG = 8
COEF_FRAC = 14          # coefficient quantization (Q2.14)

# quantized coefficients: the bits the hardware stores
EXP2_SLOPE_Q = (11861, 12935, 14106, 15382, 16775, 18293, 19948, 21754)
EXP2_INTERCEPT_Q = (16373, 16238, 15945, 15465, 14768, 13818, 12575, 10994)
LOG2_SLOPE_Q = (22262, 19916, 18018, 16450, 15133, 14011, 13044, 12202)
LOG2_INTERCEPT_Q = (28, 317, 788, 1374, 2030, 2730, 3454, 4190)

# float coefficients of the same fits (the algorithm-faithful float path)
EXP2_SLOPE_F = (
    0.7239636272362729, 0.7894879336695473, 0.8609426965125566,
    0.9388646679286211, 1.0238391803023597, 1.1165045431253837,
    1.2175568378341215, 1.3277551466175712)
EXP2_INTERCEPT_F = (
    0.9993527284639213, 0.991115886341336, 0.973201700958538,
    0.9439258968471885, 0.9013785920370531, 0.8433972567846555,
    0.7675366255030678, 0.6710352318876972)
LOG2_SLOPE_F = (
    1.358791238895692, 1.2155905997357621, 1.0997080048492076,
    1.0040043527085218, 0.9236295184545741, 0.8551728182964516,
    0.7961657713000333, 0.7447776994435271)
LOG2_INTERCEPT_F = (
    0.0017055102722067584, 0.019337650849201814, 0.0481130587815231,
    0.08385525468700647, 0.12392967924270393, 0.16662621719440554,
    0.21081029339174404, 0.2557169302368182)


def _mux8(seg: torch.Tensor, table) -> torch.Tensor:
    """8-way coefficient mux; out-of-range selects fall to entry 0, as the
    reference's select chain does."""
    t = torch.tensor(table, dtype=I32, device=seg.device)
    ok = (seg >= 0) & (seg < N_SEG)
    return t[torch.where(ok, seg, 0).long()]


def _pwl_int(frac, slope_q, intercept_q, frac_bits: int, out_frac: int):
    """Quantized 8-segment PWL at ``frac`` (scale 2**-frac_bits), output
    at scale 2**-out_frac: one mux, one multiply, one shift, one add."""
    frac = frac.to(I32)
    seg = frac >> (frac_bits - 3)
    a = _mux8(seg, slope_q)
    b = _mux8(seg, intercept_q)
    prod = (a * frac) >> (COEF_FRAC + frac_bits - out_frac)
    return prod + (b >> (COEF_FRAC - out_frac) if COEF_FRAC >= out_frac
                   else b << (out_frac - COEF_FRAC))


def exp2_frac_int(v: torch.Tensor) -> torch.Tensor:
    """2**v for v in [0,1) at scale 2**-T_FRAC -> scale 2**-EXP_FRAC."""
    return _pwl_int(v, EXP2_SLOPE_Q, EXP2_INTERCEPT_Q, T_FRAC, EXP_FRAC)


def log2_mant_int(f: torch.Tensor) -> torch.Tensor:
    """log2(1+f) for f in [0,1) at scale 2**-T_FRAC -> scale 2**-T_FRAC."""
    return _pwl_int(f, LOG2_SLOPE_Q, LOG2_INTERCEPT_Q, T_FRAC, T_FRAC)


def _pwl_float(x: torch.Tensor, slope, intercept) -> torch.Tensor:
    seg = torch.clamp((x * N_SEG).to(torch.int32), 0, N_SEG - 1).long()
    a = torch.tensor(slope, dtype=x.dtype, device=x.device)[seg]
    b = torch.tensor(intercept, dtype=x.dtype, device=x.device)[seg]
    return a * x + b


def exp2_frac_float(v: torch.Tensor) -> torch.Tensor:
    return _pwl_float(v, EXP2_SLOPE_F, EXP2_INTERCEPT_F)


def log2_mant_float(f: torch.Tensor) -> torch.Tensor:
    return _pwl_float(f, LOG2_SLOPE_F, LOG2_INTERCEPT_F)
