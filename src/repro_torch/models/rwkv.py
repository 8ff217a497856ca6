"""RWKV-6 "Finch" block of the port (counterpart of
``repro.models.rwkv``): the time mix with its data-dependent decay and
the channel mix.

  * token shift with data-dependent lerps (ddlerp, low rank)
  * r / k / v / g projections; the per-channel decay
    w_t = exp(-exp(w_base + lora(x))) in f32
  * a per-head hd x hd matrix state S: y_t = r_t (S + diag(u) k_t^T v_t),
    S <- diag(w_t) S + k_t^T v_t -- one ``kernels.recurrence.wkv6`` call a
    layer (the CUDA kernel on the card, its plain version on the CPU; in
    training, its autograd Function, whose backward is the ``wkv6_bwd``
    kernel)
  * a group norm per head (f32, eps 64e-5) and a SiLU(g) gate
  * the channel mix: a squared-ReLU FFN with token shift, sigmoid gate

The gate is a plain ``F.silu`` and the channel mix a relu^2, as in the
reference: neither is the unit's (relu^2 is not of the sigmoid family),
so the arch runs float only.  Both sublayers take the normed sublayer
input and return the state's ``tm_x`` / ``cm_x`` as its last row, and
the time mix the new ``wkv`` state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.recurrence import wkv6

from .layers import Params, dense_init, linear, linear_init


class RWKVSpec(NamedTuple):
    d_model: int
    n_heads: int
    d_ff: int
    lora_r: int = 64      # decay / ddlerp low-rank width

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def rwkv_tm_init(gen: torch.Generator, s: RWKVSpec, device) -> Params:
    """The reference's time-mix leaves and distributions."""
    d, r = s.d_model, s.lora_r
    return {
        "mu": torch.rand((5, d), generator=gen, device=device) * 0.5,
        "dd_w1": dense_init(gen, d, 5 * r, device, scale=0.01),
        "dd_w2": torch.randn((5, r, d), generator=gen, device=device) * 0.01,
        "wr": linear_init(gen, d, d, device),
        "wk": linear_init(gen, d, d, device),
        "wv": linear_init(gen, d, d, device),
        "wg": linear_init(gen, d, d, device),
        "wo": linear_init(gen, d, d, device),
        "w_base": torch.full((d,), -6.0, device=device),
        "w_lora1": dense_init(gen, d, r, device, scale=0.01),
        "w_lora2": dense_init(gen, r, d, device, scale=0.01),
        "u": torch.randn((s.n_heads, s.head_dim), generator=gen,
                         device=device) * 0.1,
        "ln_g": torch.ones((d,), device=device),
        "ln_b": torch.zeros((d,), device=device),
    }


def rwkv_cm_init(gen: torch.Generator, s: RWKVSpec, device) -> Params:
    """The reference's channel-mix leaves; it draws mu_k and mu_r from one
    key, so they are equal, and so they are here."""
    d = s.d_model
    mu = torch.rand((d,), generator=gen, device=device) * 0.5
    return {"mu_k": mu, "mu_r": mu.clone(),
            "wk": linear_init(gen, d, s.d_ff, device),
            "wv": linear_init(gen, s.d_ff, d, device),
            "wr": linear_init(gen, d, d, device)}


def rwkv_state_init(s: RWKVSpec, batch: int, device) -> Params:
    return {"tm_x": torch.zeros((batch, s.d_model), device=device),
            "cm_x": torch.zeros((batch, s.d_model), device=device),
            "wkv": torch.zeros((batch, s.n_heads, s.head_dim, s.head_dim),
                               device=device)}


def _shift(x, x_prev):
    """Token shift: the previous token's row (``x_prev`` (B, d) at t=0)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _group_norm(y, g, b, n_heads: int, eps: float = 64e-5):
    bsz, sl, d = y.shape
    yh = y.reshape(bsz, sl, n_heads, d // n_heads).to(torch.float32)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, unbiased=False, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return yh.reshape(bsz, sl, d).to(y.dtype) * g + b


def rwkv_time_mix(p: Params, s: RWKVSpec, x, *, state):
    """x (B, S, d), ``state`` with tm_x (B, d) and wkv (B, H, hd, hd) ->
    (out (B, S, d), {'tm_x', 'wkv'})."""
    b, sl, d = x.shape
    hp, hd = s.n_heads, s.head_dim
    xx = _shift(x, state["tm_x"]) - x

    # ddlerp: data-dependent mix factors of the five branches
    base = x + xx * p["mu"][0]
    dd = torch.tanh(base @ p["dd_w1"]).reshape(b, sl, 5, s.lora_r)
    delta = torch.einsum("bsfr,frd->bsfd", dd, p["dd_w2"])   # (B,S,5,d)
    mix = p["mu"][None, None] + delta
    xr, xk, xv, xw, xg = [x + xx * mix[:, :, i] for i in range(5)]

    r = linear(p["wr"], xr).reshape(b, sl, hp, hd)
    k = linear(p["wk"], xk).reshape(b, sl, hp, hd)
    v = linear(p["wv"], xv).reshape(b, sl, hp, hd)
    g = linear(p["wg"], xg)
    # the data-dependent decay, per channel, in (0, 1)
    lora = torch.tanh(xw @ p["w_lora1"]) @ p["w_lora2"]
    w = torch.exp(-torch.exp(p["w_base"].to(torch.float32)
                             + lora.to(torch.float32)))
    f32 = torch.float32
    y, wkv = wkv6(r.to(f32), k.to(f32), v.to(f32),
                  w.reshape(b, sl, hp, hd), p["u"].to(f32),
                  state["wkv"].to(f32))
    y = _group_norm(y.reshape(b, sl, d).to(x.dtype), p["ln_g"], p["ln_b"], hp)
    y = y * F.silu(g)
    return linear(p["wo"], y), {"tm_x": x[:, -1, :], "wkv": wkv}


def rwkv_channel_mix(p: Params, s: RWKVSpec, x, *, state):
    """x (B, S, d), ``state`` with cm_x (B, d) -> (out, {'cm_x'})."""
    xx = _shift(x, state["cm_x"]) - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = torch.square(torch.relu(linear(p["wk"], xk)))       # relu^2
    kv = linear(p["wv"], k)
    return torch.sigmoid(linear(p["wr"], xr)) * kv, {"cm_x": x[:, -1, :]}
