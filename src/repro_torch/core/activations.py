"""Activation registry of the port (counterpart of
``repro.core.activations``, for the variants the ported slice serves).

  'gelu_tanh'         tanh-approximated GELU (Eq. 4)
  'gelu_via_softmax'  Eq. 8 in float (the datapath's pair mode)
  'gelu_dualmode'     Eq. 8 through the bit-accurate unit
  'silu' / 'silu_via_softmax' / 'silu_dualmode'  the same for SiLU

The dual-mode variants run the unit's ``pair_act`` kernel (int words)
and are straight-through estimators: the forward value is the
reference's ``surrogate + (q - surrogate)`` in float32 -- not always
exactly ``q`` -- and the backward is the surrogate's gradient.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import datapath as _dp
from repro_torch.kernels.dualmode_softmax import pair_act


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


_SURROGATE = {"gelu": gelu_tanh, "silu": silu}


class _DualmodeSTE(torch.autograd.Function):
    """Forward: the unit's words (through the pair_act kernel) in the
    reference's STE form; backward: the float surrogate's gradient."""

    @staticmethod
    def forward(ctx, x, mode: str):
        ctx.save_for_backward(x)
        ctx.mode = mode
        s = _SURROGATE[mode](x)
        q = pair_act(x.contiguous(), mode=mode, precision="int")
        return s + (q - s)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(_SURROGATE[ctx.mode](xg), xg, gy)
        return gx, None


def gelu_dualmode(x: torch.Tensor) -> torch.Tensor:
    return _DualmodeSTE.apply(x, "gelu")


def silu_dualmode(x: torch.Tensor) -> torch.Tensor:
    return _DualmodeSTE.apply(x, "silu")


ACTIVATIONS: dict[str, Callable] = {
    "gelu_tanh": gelu_tanh,
    "gelu_via_softmax": gelu_via_softmax,
    "gelu_dualmode": gelu_dualmode,
    "silu": silu,
    "silu_via_softmax": silu_via_softmax,
    "silu_dualmode": silu_dualmode,
}


def get_activation(name: str) -> Callable:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; the port has "
                         f"{sorted(ACTIVATIONS)}")
