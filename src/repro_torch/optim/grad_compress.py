"""Gradient compression: int8 quantization with error feedback (port of
``repro.optim.grad_compress``).

    c_t = Q(g_t + e_{t-1})      e_t = (g_t + e_{t-1}) - c_t

The update uses c_t; the residual stays local.  Off by default
(``TrainConfig.grad_compress``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any
_QMAX = 127.0


def ef_state_init(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _quant_leaf(g, e):
    x = g.to(torch.float32) + e
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / _QMAX
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX)   # int8-valued
    c = q * scale
    return c, x - c


def compress_decompress(grads: Params, ef: Params):
    """(grads, ef) -> (int8-valued grads, new ef residuals)."""
    out = [_quant_leaf(g, e)
           for g, e in zip(tree_leaves(grads), tree_leaves(ef))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
