"""Mamba-1 selective SSM block of the port (counterpart of
``repro.models.mamba``), the jamba mixer: in_proj -> causal depthwise
conv -> SiLU -> the selective (dt, B, C) projections -> the discretized
diagonal SSM scan -> + D skip -> SiLU(z) gate -> out_proj.

The scan is one ``kernels.recurrence.selective_scan`` call a layer (the
CUDA kernel on the card, its plain version on the CPU; in training, its
autograd Function, whose backward is the ``selective_scan_bwd`` kernel,
the gradients flowing back through the ``.contiguous()`` copies), so the
(B, S, d_inner, d_state) tensor never exists.  A decode step carries the conv
window and the SSM state, O(1) in the sequence length.  The SiLUs are
plain ``F.silu``, as the reference's are ``jax.nn.silu``, not the unit's.
The reference's mesh pins (``axes``) belong to the multi-card slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.recurrence import selective_scan

from .layers import Params, dense_init, linear, linear_init


class MambaSpec(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0          # 0 -> ceil(d_model / 16)

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def mamba_init(gen: torch.Generator, s: MambaSpec, device) -> Params:
    """The reference's leaves and distributions (dt bias -4.6: softplus
    ~0.01; A_log = log(1..d_state) on every channel; D ones)."""
    a_log = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": linear_init(gen, s.d_model, 2 * s.d_inner, device),
        "conv_w": torch.randn((s.d_conv, s.d_inner), generator=gen,
                              device=device) * 0.1,
        "conv_b": torch.zeros((s.d_inner,), device=device),
        "x_proj": linear_init(gen, s.d_inner, s.rank + 2 * s.d_state, device),
        "dt_proj": {"w": dense_init(gen, s.rank, s.d_inner, device),
                    "b": torch.full((s.d_inner,), -4.6, device=device)},
        "A_log": a_log.expand(s.d_inner, s.d_state).contiguous(),
        "D": torch.ones((s.d_inner,), device=device),
        "out_proj": linear_init(gen, s.d_inner, s.d_model, device),
    }


def mamba_state_init(s: MambaSpec, batch: int, device) -> Params:
    return {"conv": torch.zeros((batch, s.d_conv - 1, s.d_inner),
                                device=device),
            "ssm": torch.zeros((batch, s.d_inner, s.d_state), device=device)}


def mamba_apply(p: Params, s: MambaSpec, x, *, state=None):
    """x (B, S, d); ``state`` the decode carry {'conv', 'ssm'} (None: from
    zeros) -> (y (B, S, d), {'conv', 'ssm'}).  The new conv state is the
    last d_conv - 1 rows of [conv state, x_in], also when S is shorter."""
    b, sl, _ = x.shape
    x_in, z = torch.chunk(linear(p["in_proj"], x), 2, dim=-1)  # (B,S,di)
    if state is None:
        state = mamba_state_init(s, b, x.device)
    xpad = torch.cat([state["conv"].to(x.dtype), x_in], dim=1)
    new_conv = xpad[:, -(s.d_conv - 1):, :]
    xc = sum(xpad[:, i:i + sl, :] * p["conv_w"][i] for i in range(s.d_conv))
    xc = F.silu(xc + p["conv_b"])

    proj = linear(p["x_proj"], xc)
    dt, bm, cm = torch.split(proj, [s.rank, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(linear(p["dt_proj"], dt))                 # (B,S,di)
    a = -torch.exp(p["A_log"].to(torch.float32))               # (di,ds)
    f32 = torch.float32
    y, h = selective_scan(xc.to(f32).contiguous(), dt.to(f32).contiguous(),
                          a, bm.to(f32).contiguous(),
                          cm.to(f32).contiguous(),
                          state["ssm"].to(f32).contiguous())
    y = y.to(x.dtype) + xc * p["D"]
    y = y * F.silu(z)
    return linear(p["out_proj"], y), {"conv": new_conv, "ssm": h}
