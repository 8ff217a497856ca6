"""Activation registry of the port (counterpart of
``repro.core.activations``; paper Table I naming).

  'gelu_exact'        float32 erf GELU (the 'FP32' model)
  'gelu_tanh'         tanh-approximated GELU (Eq. 4)
  'gelu_via_softmax'  Eq. 8 in float (the datapath's pair mode)
  'gelu_dualmode'     Eq. 8 through the bit-accurate unit (the 'Proposed'
                      model)
  'igelu'             I-BERT integer GELU (the 'i-GELU' model)
  'igelu_float'       its float form
  'silu' / 'silu_via_softmax' / 'silu_dualmode'  the same for SiLU
  'relu2'             squared ReLU

The quantized variants are straight-through estimators: the forward
value is the reference's ``surrogate + (q - surrogate)`` in float32 --
not always exactly ``q`` -- and the backward is the surrogate's
gradient.  The dual-mode ones take q from the unit's ``pair_act`` kernel
(int words); i-GELU has no kernel in the reference and is plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.kernels import datapath as _dp
from repro_torch.kernels.dualmode_softmax import pair_act

from . import igelu as _igelu


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(_dp.gelu_k(x)))


def gelu_via_softmax(x: torch.Tensor) -> torch.Tensor:
    """Eq. (8): z * softmax_1^2([k, -k]) == z * sigmoid(2k), float."""
    return _dp.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def silu_via_softmax(x: torch.Tensor) -> torch.Tensor:
    """Exact identity: z * softmax_1^2([z/2, -z/2])."""
    return _dp.silu(x)


def relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


_SURROGATE = {"gelu": gelu_tanh, "silu": silu, "igelu": gelu_tanh}


def _quantized(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "igelu":
        return _igelu.igelu_quant(x)
    return pair_act(x.contiguous(), mode=mode, precision="int")


class _QuantizedSTE(torch.autograd.Function):
    """Forward: the quantized words (the unit's through the pair_act
    kernel, or i-GELU's) in the reference's STE form; backward: the float
    surrogate's gradient."""

    @staticmethod
    def forward(ctx, x, mode: str):
        ctx.save_for_backward(x)
        ctx.mode = mode
        s = _SURROGATE[mode](x)
        return s + (_quantized(x, mode) - s)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(_SURROGATE[ctx.mode](xg), xg, gy)
        return gx, None


def gelu_dualmode(x: torch.Tensor) -> torch.Tensor:
    return _QuantizedSTE.apply(x, "gelu")


def silu_dualmode(x: torch.Tensor) -> torch.Tensor:
    return _QuantizedSTE.apply(x, "silu")


def igelu(x: torch.Tensor) -> torch.Tensor:
    return _QuantizedSTE.apply(x, "igelu")


ACTIVATIONS: dict[str, Callable] = {
    "gelu_exact": gelu_exact,
    "gelu_tanh": gelu_tanh,
    "gelu_via_softmax": gelu_via_softmax,
    "gelu_dualmode": gelu_dualmode,
    "igelu": igelu,
    "igelu_float": _igelu.igelu_float,
    "silu": silu,
    "silu_via_softmax": silu_via_softmax,
    "silu_dualmode": silu_dualmode,
    "relu2": relu2,
}


def get_activation(name: str) -> Callable:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; the port has "
                         f"{sorted(ACTIVATIONS)}")
