"""Primitive layers of the port (counterpart of ``repro.models.layers``):
plain functions on tensors, parameters in plain dicts laid out as the
reference's pytrees, so converted JAX weights drop in unchanged.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.activations import get_activation
from repro_torch.kernels import datapath as dp
from repro_torch.kernels import dispatch

Params = dict[str, Any]


# ---------------- init helpers (the reference's distributions) ----------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device: torch.device, scale: float | None = None):
    scale = scale if scale is not None else (1.0 / math.sqrt(d_in))
    return torch.randn((d_in, d_out), generator=gen, device=device) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int,
               device: torch.device):
    return torch.randn((vocab, d), generator=gen, device=device) * 0.02


def linear_init(gen, d_in: int, d_out: int, device, bias: bool = False
                ) -> Params:
    p = {"w": dense_init(gen, d_in, d_out, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def rmsnorm_init(d: int, device) -> Params:
    return {"g": torch.ones((d,), device=device)}


def mlp_init(gen, d: int, d_ff: int, device, gated: bool = True) -> Params:
    p = {"up": linear_init(gen, d, d_ff, device),
         "down": linear_init(gen, d_ff, d, device)}
    if gated:
        p["gate"] = linear_init(gen, d, d_ff, device)
    return p


# ---------------- apply ----------------

def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return dp.rmsnorm(x, p["g"], eps).to(x.dtype)


def layernorm_init(d: int, device) -> Params:
    return {"g": torch.ones((d,), device=device),
            "b": torch.zeros((d,), device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return dp.layernorm(x, p["g"], p["b"], eps).to(x.dtype)


def make_norm(kind: str):
    """(init, apply) of the norm ``kind``: 'rms' or 'layer'."""
    if kind == "rms":
        return rmsnorm_init, rmsnorm
    if kind == "layer":
        return layernorm_init, layernorm
    raise ValueError(f"unknown norm kind {kind!r}; have 'rms', 'layer'")


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd) rotate-half RoPE; positions: (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(n_pos: int, d: int, device=None,
                       dtype=torch.float32) -> torch.Tensor:
    """(n_pos, d) fixed positions: sin of pos / 10000^(2i/d) in the first
    half, cos in the second."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# activations the fused epilogue (datapath.pair_act, float log-domain
# form) agrees with mathematically -- gelu_tanh is the tanh-form identity
# tanh(k) = 2*sigma(2k)-1 of the same curve, so fused-vs-dense parity is
# a small-ULP tolerance, not bitwise.  The bit-accurate dual-mode
# variants stay on the dense path (their unit kernel, pair_act).
_FUSABLE_ACT = {"gelu_tanh": "gelu", "gelu_via_softmax": "gelu",
                "silu": "silu", "silu_via_softmax": "silu"}


def mlp(p: Params, x: torch.Tensor, activation: str = "silu",
        impl: str = "dense", prenorm=None, norm_impl: str = "dense"
        ) -> torch.Tensor:
    """(Gated) MLP; the activation (the unit's GELU/SiLU mode when it is a
    dual-mode variant) applies to the gate path.

    ``impl`` resolves through the ffn registry for x's device: 'dense' is
    the plain graph; 'fused_pallas' runs a bias-free gated pair with a
    fusable activation through the fused GLU (the CUDA kernel on a GPU,
    its plain version on the CPU); 'auto' picks 'fused_pallas' on a GPU
    and 'dense' on the CPU.

    ``prenorm=(norm_params, kind, eps)`` makes this sublayer own its input
    norm: with a fused norm provider (``norm_impl``), a fusable
    activation and a bias-free gate / up, the provider's norm -> gated-GLU
    seam computes the norm and both products in one kernel; otherwise the
    dense norm applies here and the body proceeds unchanged."""
    fused = dispatch.get_ffn(dispatch.resolve_ffn(impl, x.device))
    mode = _FUSABLE_ACT.get(activation)
    bias_free_glu = ("gate" in p and "b" not in p["gate"]
                     and "b" not in p["up"])
    if prenorm is not None:
        np_, kind, eps = prenorm
        nprov = dispatch.get_norm(dispatch.resolve_norm(norm_impl, x.device))
        if nprov is not None and mode is not None and bias_free_glu:
            h = nprov["norm_glu"](x, np_["g"], np_.get("b"), p["gate"]["w"],
                                  p["up"]["w"], kind=kind, eps=eps, mode=mode)
            return linear(p["down"], h)
        x = make_norm(kind)[1](np_, x, eps)
    if fused is not None and mode is not None and bias_free_glu:
        x2 = x.reshape(-1, x.shape[-1])
        h = fused(x2, p["gate"]["w"], p["up"]["w"], mode)
        return linear(p["down"], h.reshape(*x.shape[:-1], h.shape[-1]))
    act = get_activation(activation)
    up = linear(p["up"], x)
    h = act(linear(p["gate"], x)) * up if "gate" in p else act(up)
    return linear(p["down"], h)
