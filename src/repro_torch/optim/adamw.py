"""AdamW, the warmup-cosine schedule and global-norm clipping (port of
``repro.optim.adamw``).

The state is a plain tree {m, v, step}, as the reference's.  The update
returns new tensors, as the reference's pure function does; the train
step drops the old ones, so the peak is two copies of params and
moments for the length of an update.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

Params = Any


class OptState(NamedTuple):
    m: Params
    v: Params
    step: int


def adamw_init(params: Params) -> OptState:
    return OptState(
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        step=0)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's traced scalars are."""
    return float(torch.tensor(x, dtype=torch.float32))


def wsd_schedule(step: int, *, lr: float, warmup: int, total: int,
                 min_frac: float = 0.1) -> float:
    """Linear warmup -> cosine decay to min_frac * lr (float32 words)."""
    s = torch.tensor(float(step), dtype=torch.float32)
    if step < warmup:
        return _f32(float(lr * (s + 1.0) / max(warmup, 1)))
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return _f32(float(lr * (min_frac + (1 - min_frac) * 0.5
                            * (1 + torch.cos(math.pi * t)))))


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, float32."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def _decays(path: str, p: torch.Tensor) -> bool:
    """The reference's rule, decay for >= 2-D parameters, on its layout:
    there each layer's leaves are stacked on a leading period axis, so a
    leaf under ``layers`` counts one dimension more than it has here."""
    return p.ndim + (path.split("/", 1)[0] == "layers") >= 2


def adamw_update(grads: Params, state: OptState, params: Params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step -> (new_params, new_state, {'grad_norm'}).  Decay
    applies where :func:`_decays` says, as in the reference; gradients
    are clipped to ``grad_clip`` by their global norm."""
    step = state.step + 1
    gn = global_norm(grads)
    scale = torch.clamp(grad_clip / (gn + 1e-6), max=1.0)
    bc1 = _f32(1.0 - float(torch.tensor(b1, dtype=torch.float32) ** step))
    bc2 = _f32(1.0 - float(torch.tensor(b2, dtype=torch.float32) ** step))

    def upd(g, m, v, path, p):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if _decays(path, p):
            delta = delta + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = [upd(g, m, v, *pp) for g, m, v, pp in zip(
        tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
        tree_paths(params))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gn}
