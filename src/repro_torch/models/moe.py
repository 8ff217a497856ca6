"""Mixture-of-Experts of the port (counterpart of ``repro.models.moe``):
token-choice top-k routing with two dispatch paths.

  'sort'  -- the production path, GROUP-LOCAL: every sequence (one row of
             B) routes its own S tokens.  Each slot's rank within its
             expert comes from a stable sort of the group's expert ids;
             the slots below the capacity C are written into an
             expert-major (E, B*C, d) buffer, the expert FFNs run as
             three batched products over E, and each token gathers its k
             slots back.  Capacity is per group: C = S when dropless and
             S <= ``dropless_max_seq``, else ceil(S*k/E * cf) capped at
             S; a slot at rank >= C is dropped (its gate is zeroed).
  'dense' -- the oracle: every expert for every token, weighted by the
             scattered gates.  Exact (no capacity drops); the tests hold
             the sort path to it.

Shared experts (DeepSeek-V2) go through ``layers.mlp`` with the
configured ``ffn_impl``, and the Switch load-balance aux loss comes back
beside the output.  The expert FFNs use the configured activation, so
the paper's dual-mode unit serves the experts too: with
``'silu_dualmode'`` the unit's pair-mode kernel (``pair_act``) runs once
a layer, over the whole (E, B*C, d_ff) buffer.

The router's softmax is ``torch.softmax`` (the reference's
``jax.nn.softmax``), never the unit.  Top-k breaks ties as
``jax.lax.top_k`` does, lower index first, by a stable descending sort.

The reference's mesh -- the ``axes`` pins on the dispatch buffers and
``_ambient_axis_size`` -- belongs to the port's Distributed slice; this
module runs on one device.

Dispatch and combine are autograd Functions whose backwards are each
other's forwards, as the reference's custom VJPs are: each direction is
a write of unique (expert, rank) rows or a gather of them, summed over k
in a fixed order.  Autograd's own backward of a gather is a scatter-add,
which may sum with atomics on a GPU; these keep a train step bitwise
repeatable.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.activations import get_activation

from .layers import Params, dense_init, mlp, mlp_init


class MoESpec(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0         # DeepSeek-style always-on experts
    capacity_factor: float = 1.25
    activation: str = "silu"
    ffn_impl: str = "dense"   # shared-expert MLP execution (ffn registry)
    dispatch: str = "sort"    # 'sort' | 'dense'
    ep_pad: int = 0           # padded stack size (0 = n_experts)
    # inference capacity: dropless (C = S) up to this length; past it
    # capacity is bounded at inference_cf x the balanced load
    dropless_max_seq: int = 1024
    inference_cf: float = 2.0


def moe_init(gen: torch.Generator, s: MoESpec, device) -> Params:
    """The reference's keys: a bare (d, E) router (normal x 0.02) and
    gate / up / down stacks of max(ep_pad, n_experts) experts (normal /
    sqrt(d_in); the padded experts are drawn like the others and are
    never routed to), plus a gated ``shared`` MLP when n_shared > 0."""
    e = max(s.ep_pad, s.n_experts)
    p = {"router": dense_init(gen, s.d_model, s.n_experts, device,
                              scale=0.02),
         "gate": _stack_init(gen, e, s.d_model, s.d_ff, device),
         "up": _stack_init(gen, e, s.d_model, s.d_ff, device),
         "down": _stack_init(gen, e, s.d_ff, s.d_model, device)}
    if s.n_shared:
        p["shared"] = mlp_init(gen, s.d_model, s.d_ff * s.n_shared, device,
                               gated=True)
    return p


def _stack_init(gen, e: int, d_in: int, d_out: int, device):
    return (torch.randn((e, d_in, d_out), generator=gen, device=device)
            * (1.0 / math.sqrt(d_in)))


def _route(p: Params, s: MoESpec, x):
    """(B,S,d) -> gates (B,S,k), expert idx (B,S,k), aux loss (0-d)."""
    logits = (x @ p["router"]).to(torch.float32)             # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with jax.lax.top_k's order: among equal values the lower
    # index first (a stable sort keeps the original order of ties)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :s.top_k], order[..., :s.top_k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    # Switch Transformer eq. 4: E * sum_e f_e * p_e
    me = torch.mean(probs, dim=(0, 1))                       # (E,)
    ce = torch.nn.functional.one_hot(idx, s.n_experts).to(
        torch.float32).sum(dim=(0, 1, 2))
    ce = ce / (x.shape[0] * x.shape[1] * s.top_k)
    aux = s.n_experts * torch.sum(me * ce)
    return gates.to(x.dtype), idx, aux


def capacity(s: MoESpec, seq: int, dropless: bool) -> int:
    """Slots each expert takes from one group of ``seq`` tokens."""
    if dropless and seq <= s.dropless_max_seq:
        return seq          # an expert can receive at most S slots
    cf = s.inference_cf if dropless else s.capacity_factor
    return min(int(math.ceil(seq * s.top_k / s.n_experts * cf)), seq)


def slot_ranks(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(B,S,k) expert ids -> each slot's rank within its expert in its
    group (row of B), in the order of a stable sort of the group's flat
    (S*k) ids: the reference's argsort minus the expert's start."""
    b, sl, k = idx.shape
    flat = idx.reshape(b, sl * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    e_sorted = torch.gather(flat, 1, order)
    experts = torch.arange(n_experts, device=idx.device).expand(b, -1)
    starts = torch.searchsorted(e_sorted, experts.contiguous())  # (B,E)
    rank = (torch.arange(sl * k, device=idx.device)[None, :]
            - torch.gather(starts, 1, e_sorted))
    return torch.empty_like(rank).scatter_(1, order, rank).reshape(b, sl, k)


class _Dispatch(torch.autograd.Function):
    """(T,d) tokens -> (rows, d) expert buffer: slot j of token t goes to
    row dest[t*k + j] when keep[t*k + j]; every kept row is unique."""

    @staticmethod
    def forward(ctx, x, dest, keep, rows: int):
        t, d = x.shape
        k = dest.numel() // t
        ctx.save_for_backward(dest, keep)
        ctx.k = k
        buf = x.new_zeros((rows + 1, d))        # the last row takes drops
        buf.index_copy_(0, torch.where(keep, dest, rows),
                        x[:, None, :].expand(t, k, d).reshape(t * k, d))
        return buf[:rows]

    @staticmethod
    def backward(ctx, dbuf):
        dest, keep = ctx.saved_tensors
        dx = _gather_rows(dbuf, dest, keep).view(-1, ctx.k, dbuf.shape[-1])
        return dx.sum(dim=1), None, None, None


class _Combine(torch.autograd.Function):
    """y[t] = sum_j gk[t,j] * h[dest[t*k + j]] over the kept slots."""

    @staticmethod
    def forward(ctx, h, gk, dest, keep):
        t, k = gk.shape
        ctx.save_for_backward(h, gk, dest, keep)
        hk = _gather_rows(h, dest, keep).view(t, k, h.shape[-1])
        return torch.sum(hk * gk[..., None], dim=1)

    @staticmethod
    def backward(ctx, dy):
        h, gk, dest, keep = ctx.saved_tensors
        t, k = gk.shape
        rows, d = h.shape
        dh = dgk = None
        if ctx.needs_input_grad[0]:
            dyk = (dy[:, None, :] * gk[..., None]).reshape(t * k, d)
            dh = dy.new_zeros((rows + 1, d))
            dh.index_copy_(0, torch.where(keep, dest, rows), dyk)
            dh = dh[:rows]
        if ctx.needs_input_grad[1]:
            hk = _gather_rows(h, dest, keep).view(t, k, d)
            dgk = torch.sum(dy[:, None, :] * hk, dim=-1)
        return dh, dgk, None, None


def _gather_rows(buf, dest, keep):
    """buf's rows at ``dest``, zeros where a slot was dropped."""
    rows = buf[torch.clamp(dest, max=buf.shape[0] - 1)]
    return torch.where(keep[:, None], rows, torch.zeros((), dtype=buf.dtype,
                                                        device=buf.device))


def experts(p: Params, s: MoESpec, xb):
    """The batched expert FFN over the expert-major buffer xb (E, R, d)
    -> (E, R, d)."""
    act = get_activation(s.activation)
    g = torch.bmm(xb, p["gate"])
    u = torch.bmm(xb, p["up"])
    return torch.bmm(act(g) * u, p["down"])


def slots(s: MoESpec, e_buf: int, gates, idx, cap: int):
    """The dispatch plan of (B,S,k) gates / expert ids at capacity
    ``cap``: (gk (B*S,k) the gates with dropped slots zeroed, dest
    (B*S*k,) each slot's row in the expert-major (E, B, C) buffer, keep
    (B*S*k,) whether the slot is below capacity, rows the buffer's)."""
    b, sl, k = idx.shape
    rank = slot_ranks(idx, s.n_experts)
    kept = rank < cap
    gk = (gates * kept).reshape(b * sl, k)
    group = torch.arange(b, device=idx.device)[:, None, None]
    dest = ((idx * b + group) * cap + rank).reshape(-1)
    return gk, dest, kept.reshape(-1), e_buf * b * cap


dispatch = _Dispatch.apply
combine = _Combine.apply


def _moe_sort(p: Params, s: MoESpec, x, gates, idx, dropless: bool):
    """Group-local dispatch over the batch axis: x (B,S,d) -> (B,S,d)."""
    b, sl, d = x.shape
    cap = capacity(s, sl, dropless)
    e_buf = p["gate"].shape[0]
    gk, dest, keep, rows = slots(s, e_buf, gates, idx, cap)
    buf = dispatch(x.reshape(b * sl, d), dest, keep, rows)
    h = experts(p, s, buf.view(e_buf, b * cap, d))
    return combine(h.view(rows, d), gk, dest, keep).view(b, sl, d)


def _moe_dense(p: Params, s: MoESpec, x_flat, gates, idx):
    """(T,d) through every expert, weighted by the scattered gates."""
    h = experts(p, s, x_flat[None].expand(p["gate"].shape[0], -1, -1))
    w = torch.zeros((x_flat.shape[0], p["gate"].shape[0]),
                    dtype=x_flat.dtype, device=x_flat.device)
    w = w.scatter(1, idx, gates)                 # top-k ids are distinct
    return torch.einsum("etd,te->td", h, w)


def moe_apply(p: Params, s: MoESpec, x, dropless: bool = False):
    """x: (B,S,d) -> (y, aux loss).

    dropless=True (inference): no token drops up to ``dropless_max_seq``
    tokens a group, so an output never depends on what shares the batch;
    longer prefills fall back to ``inference_cf``-bounded capacity."""
    b, sl, d = x.shape
    gates, idx, aux = _route(p, s, x)
    if s.dispatch == "dense":
        y = _moe_dense(p, s, x.reshape(-1, d), gates.reshape(-1, s.top_k),
                       idx.reshape(-1, s.top_k)).reshape(b, sl, d)
    elif s.dispatch == "sort":
        y = _moe_sort(p, s, x, gates, idx, dropless)
    else:
        raise ValueError(f"unknown MoE dispatch {s.dispatch!r}; have "
                         "'sort', 'dense'")
    if s.n_shared:
        y = y + mlp(p["shared"], x, s.activation, impl=s.ffn_impl)
    return y, aux
