"""Attention of the port (counterpart of ``repro.models.attention``):
GQA (with qk-norm and a QKV bias where the config asks), MLA and cross
attention over one scores -> softmax -> combine core, so the attention
softmax goes through the configured implementation (float, or the
dual-mode unit's kernel); the two KV cache layouts the serving engine
uses (paged pools behind block tables, and contiguous (B, max_seq, ...)
rows); the cross attention of the VLM's image layers and of the
encoder-decoder's decoder (non-causal, over K/V made from the image
embeddings or the encoder's output once per request).

Cache tensors are updated IN PLACE (``paged_write``, ``_write_seq``),
where the reference returns new arrays: the caches are the largest
tensors of a serving process, and a functional update would double them
for the length of every step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import datapath as dp
from repro_torch.kernels import dispatch

from . import flash as _flash
from .layers import (Params, apply_rope, linear, linear_init, make_norm,
                     rmsnorm, rmsnorm_init)


class AttnSpec(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    softmax_impl: str = "float"
    causal: bool = True
    use_rope: bool = True
    attn_impl: str = "auto"
    norm_eps: float = 1e-6


class MLASpec(NamedTuple):
    d_model: int
    n_heads: int
    q_lora_rank: int      # 0 = full-rank q projection
    kv_lora_rank: int
    nope_dim: int
    rope_dim: int
    v_dim: int
    rope_theta: float = 10000.0
    softmax_impl: str = "float"
    attn_impl: str = "auto"
    norm_eps: float = 1e-6


# ---------------- shared core ----------------

def _naive_sdpa(q, k, v, *, q_pos, kv_valid, causal=True,
                scale: float | None = None, softmax_impl: str = "float"):
    """Materialized-scores attention: scale folded into q before the dot,
    masked scores at MASK_VALUE, whole-row softmax through dispatch."""
    b, s_q, t = q.shape[0], q.shape[1], k.shape[1]
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    qf = q.to(torch.float32) * scale
    scores = torch.einsum("bskgh,btkh->bkgst", qf, k.to(torch.float32))
    t_pos = torch.arange(t, device=q.device)[None, :]
    mask = kv_valid[:, None, :]
    if causal:
        mask = mask & (t_pos[:, None, :] <= q_pos[:, :, None])
    else:
        mask = mask.expand(b, s_q, t)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, dp.MASK_VALUE))
    probs = dispatch.get_softmax(softmax_impl)(scores).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


def _flash_entry(q, k, v, *, q_pos, kv_valid, causal, scale,
                 softmax_impl="float"):
    if softmax_impl != "float":
        raise ValueError("attn_impl='flash' is the float blocked path and "
                         f"cannot honor softmax_impl={softmax_impl!r}")
    return _flash.flash_attention(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                                  causal=causal, scale=scale)


dispatch.register_attention(
    "naive",
    lambda q, k, v, *, q_pos, kv_valid, causal, scale, softmax_impl="float":
    _naive_sdpa(q, k, v, q_pos=q_pos, kv_valid=kv_valid, causal=causal,
                scale=scale, softmax_impl=softmax_impl),
    modes=("float", "dualmode", "dualmode_snap"), grad=True)
dispatch.register_attention("flash", _flash_entry, modes=("float",),
                            grad=True)


def _sdpa(q, k, v, *, q_pos, kv_valid, softmax_impl, causal=True,
          scale: float | None = None, attn_impl: str = "auto"):
    """Dense attention through the registry: (B,S,K,G,h) -> (B,S,K,G,hv)."""
    impl = dispatch.resolve_attention(attn_impl, q.shape[1], k.shape[1],
                                      softmax_impl=softmax_impl,
                                      device=q.device)
    if (torch.is_grad_enabled() and not dispatch.attention_grad(impl)
            and any(t.requires_grad for t in (q, k, v))):
        raise ValueError(f"attn_impl {impl!r} is forward-only and cannot "
                         "pass gradients; train with a float impl")
    return dispatch.get_attention(impl)(
        q, k, v, q_pos=q_pos, kv_valid=kv_valid, causal=causal, scale=scale,
        softmax_impl=softmax_impl)


def _sdpa_paged(q, k_pool, v_pool, *, block_tables, q_pos, kv_valid,
                softmax_impl, causal=True, scale: float | None = None,
                attn_impl: str = "auto"):
    """Paged twin of :func:`_sdpa`: resolution at the logical cache
    extent; an impl with a block-table variant gets the pools untouched,
    any other reads a dense gather (identical words, pure data movement).
    """
    s_q = q.shape[1]
    t = block_tables.shape[1] * k_pool.shape[1]
    impl = dispatch.resolve_attention(attn_impl, s_q, t,
                                      softmax_impl=softmax_impl,
                                      device=q.device)
    fn = dispatch.get_paged_attention(impl) if s_q == 1 else None
    if fn is not None:
        return fn(q, k_pool, v_pool, block_tables=block_tables, q_pos=q_pos,
                  kv_valid=kv_valid, causal=causal, scale=scale,
                  softmax_impl=softmax_impl)
    return dispatch.get_attention(impl)(
        q, paged_gather(k_pool, block_tables),
        paged_gather(v_pool, block_tables), q_pos=q_pos, kv_valid=kv_valid,
        causal=causal, scale=scale, softmax_impl=softmax_impl)


def _positions_from(pos, b: int, sl: int, device) -> torch.Tensor:
    """(B, S) logical positions from a scalar or (B,) offset."""
    ar = torch.arange(sl, device=device)[None, :]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        return (pos.to(device)[:, None] + ar).expand(b, sl)
    return (int(pos) + ar).expand(b, sl)


def paged_write(pool: torch.Tensor, new: torch.Tensor, pos,
                block_tables: torch.Tensor) -> torch.Tensor:
    """Scatter ``new`` (B,S,...) into the (N,bs,...) pool IN PLACE at
    logical offset ``pos`` (scalar or (B,)) through each row's table.
    Positions past the table's extent, and sentinel table entries, land
    in block 0, which no valid key reads."""
    n, bs = pool.shape[:2]
    b, sl = new.shape[:2]
    nblk = block_tables.shape[1]
    logpos = _positions_from(pos, b, sl, pool.device)
    blk, off = logpos // bs, logpos % bs
    phys = torch.gather(block_tables.long(), 1, blk.clamp(0, nblk - 1))
    phys = torch.where((blk >= 0) & (blk < nblk), phys, 0)
    flat = (phys * bs + off).reshape(-1)
    pool.view((n * bs,) + pool.shape[2:])[flat] = new.to(pool.dtype).reshape(
        (b * sl,) + new.shape[2:])
    return pool


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """The dense (B, max_blocks*bs, ...) view of a paged cache."""
    b, nblk = block_tables.shape
    dense = pool[block_tables.long()]
    return dense.reshape((b, nblk * pool.shape[1]) + pool.shape[2:])


def _write_seq(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B,S,...) into ``buf`` (B,Smax,...) IN PLACE at offset
    ``pos``: a scalar (lockstep) or (B,) (every slot at its own depth).
    A start past Smax - S clamps back, as the reference's
    ``dynamic_update_slice`` clamps it."""
    b, sl = new.shape[:2]
    hi = buf.shape[1] - sl
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        start = torch.clamp(pos.to(buf.device).long(), 0, hi)
        idx = start[:, None] + torch.arange(sl, device=buf.device)[None, :]
        buf[torch.arange(b, device=buf.device)[:, None], idx] = new.to(
            buf.dtype)
    else:
        start = min(max(int(pos), 0), hi)
        buf[:, start:start + sl].copy_(new)
    return buf


def _update_cache(cache, k_new, v_new, pos):
    """Write (B,S,K,h) at sequence offset ``pos`` into the (B,Smax,K,h)
    buffers of ``cache``, in place; returns ``cache``."""
    _write_seq(cache["k"], k_new, pos)
    _write_seq(cache["v"], v_new, pos)
    return cache


def _kv_valid_mask(t: int, pos, sl: int, b: int, device) -> torch.Tensor:
    """(B, T) validity: cache rows [0, pos+sl) hold data."""
    t_idx = torch.arange(t, device=device)[None, :]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        end = pos.to(device)[:, None] + sl
    else:
        end = int(pos) + sl
    return (t_idx < end).expand(b, t)


# ---------------- GQA ----------------

def gqa_apply(p: Params, s: AttnSpec, x, *, positions, cache=None, pos=0,
              paged=None, prenorm=None):
    """x: (B,S,d).  Without a cache: full attention over x.  With
    ``cache`` the layer's {'k','v'} (B,Smax,K,h) rows: write the new K/V
    at ``pos`` (in place) and attend over the whole rows, keys past each
    row's pos + S invalid.  With ``paged`` (B, max_blocks) int32 block
    tables and ``cache`` the layer's {'k','v'} (N,bs,K,h) pools: write
    the new K/V through the tables (in place) and attend over the paged
    cache.  Returns (out, cache).

    ``prenorm=(norm_params, kind, eps, provider)`` hands this sublayer
    its input norm (the block's norm1): with bias-free projections the
    provider's norm -> QKV seam computes norm(x) @ [wq|wk|wv] in one
    kernel that reads the three matrices in place; otherwise the dense
    norm applies here and the three projections proceed unchanged."""
    b, sl, _ = x.shape
    g = s.n_heads // s.n_kv_heads
    if prenorm is not None and not s.qkv_bias:
        np_, kind, eps, nprov = prenorm
        qkv = nprov["norm_linear"](
            x, np_["g"], np_.get("b"),
            (p["wq"]["w"], p["wk"]["w"], p["wv"]["w"]), kind=kind, eps=eps)
        # split the (B, S, nq + 2 nk) panel; contiguous copies, as the
        # attention kernels take contiguous operands
        nk = s.n_kv_heads * s.head_dim
        q, k, v = (t.contiguous() for t in torch.split(
            qkv, [s.n_heads * s.head_dim, nk, nk], dim=-1))
        q = q.reshape(b, sl, s.n_heads, s.head_dim)
        k = k.reshape(b, sl, s.n_kv_heads, s.head_dim)
        v = v.reshape(b, sl, s.n_kv_heads, s.head_dim)
    else:
        if prenorm is not None:
            np_, kind, eps, _ = prenorm
            x = make_norm(kind)[1](np_, x, eps)
        q = linear(p["wq"], x).reshape(b, sl, s.n_heads, s.head_dim)
        k = linear(p["wk"], x).reshape(b, sl, s.n_kv_heads, s.head_dim)
        v = linear(p["wv"], x).reshape(b, sl, s.n_kv_heads, s.head_dim)
    if s.qk_norm:
        q = rmsnorm(p["qn"], q, s.norm_eps)
        k = rmsnorm(p["kn"], k, s.norm_eps)
    if s.use_rope:
        q = apply_rope(q, positions, s.rope_theta)
        k = apply_rope(k, positions, s.rope_theta)
    qg = q.reshape(b, sl, s.n_kv_heads, g, s.head_dim)
    if paged is not None:
        paged_write(cache["k"], k, pos, paged)
        paged_write(cache["v"], v, pos, paged)
        t = paged.shape[1] * cache["k"].shape[1]
        kv_valid = _kv_valid_mask(t, pos, sl, b, x.device)
        o = _sdpa_paged(qg, cache["k"], cache["v"], block_tables=paged,
                        q_pos=positions, kv_valid=kv_valid,
                        softmax_impl=s.softmax_impl, causal=s.causal,
                        attn_impl=s.attn_impl)
    else:
        if cache is not None:
            _update_cache(cache, k, v, pos)
            k, v = cache["k"], cache["v"]
            kv_valid = _kv_valid_mask(k.shape[1], pos, sl, b, x.device)
        else:
            kv_valid = torch.ones((b, sl), dtype=torch.bool, device=x.device)
        o = _sdpa(qg, k, v, q_pos=positions, kv_valid=kv_valid,
                  softmax_impl=s.softmax_impl, causal=s.causal,
                  attn_impl=s.attn_impl)
    o = o.reshape(b, sl, s.n_heads * s.head_dim)
    return linear(p["wo"], o), cache


# ---------------- MLA (DeepSeek-V2 / MiniCPM3 style) ----------------

def mla_init(gen: torch.Generator, s: MLASpec, device) -> Params:
    qk_head = s.nope_dim + s.rope_dim
    p: Params = {}
    if s.q_lora_rank:
        p["wq_a"] = linear_init(gen, s.d_model, s.q_lora_rank, device)
        p["q_norm"] = rmsnorm_init(s.q_lora_rank, device)
        p["wq_b"] = linear_init(gen, s.q_lora_rank, s.n_heads * qk_head,
                                device)
    else:
        p["wq"] = linear_init(gen, s.d_model, s.n_heads * qk_head, device)
    p["wkv_a"] = linear_init(gen, s.d_model, s.kv_lora_rank + s.rope_dim,
                             device)
    p["kv_norm"] = rmsnorm_init(s.kv_lora_rank, device)
    p["wkv_b"] = linear_init(gen, s.kv_lora_rank,
                             s.n_heads * (s.nope_dim + s.v_dim), device)
    p["wo"] = linear_init(gen, s.n_heads * s.v_dim, s.d_model, device)
    return p


def mla_cache_init(s: MLASpec, batch: int, max_seq: int, device) -> Params:
    """MLA caches the compressed latent and the shared rope key."""
    return {"ckv": torch.zeros((batch, max_seq, s.kv_lora_rank),
                               device=device),
            "krope": torch.zeros((batch, max_seq, s.rope_dim),
                                 device=device)}


def mla_apply(p: Params, s: MLASpec, x, *, positions, cache=None, pos=0,
              paged=None):
    """x: (B,S,d).  The latent ``ckv`` (B,S,kv_lora_rank) and the shared
    rope key ``krope`` (B,S,rope_dim) are what a cache holds: the
    contiguous {'ckv','krope'} (B,Smax,...) rows, written at ``pos`` in
    place, or with ``paged`` (B, max_blocks) block tables the (N,bs,...)
    pools, written through the tables and gathered dense.  The naive
    expanded form of the reference: every cached latent goes through
    wkv_b to per-head k_nope / v, then [q_nope, q_rope] against [k_nope,
    krope] through the shared core with K = n_heads, G = 1, scale
    1/sqrt(nope + rope).  Returns (out, cache)."""
    b, sl, _ = x.shape
    qk_head = s.nope_dim + s.rope_dim
    if s.q_lora_rank:
        q = linear(p["wq_b"],
                   rmsnorm(p["q_norm"], linear(p["wq_a"], x), s.norm_eps))
    else:
        q = linear(p["wq"], x)
    q = q.reshape(b, sl, s.n_heads, qk_head)
    q_nope, q_rope = q[..., :s.nope_dim], q[..., s.nope_dim:]
    q_rope = apply_rope(q_rope, positions, s.rope_theta)

    kv_a = linear(p["wkv_a"], x)                       # (B,S,kv_lora+rope)
    ckv = rmsnorm(p["kv_norm"], kv_a[..., :s.kv_lora_rank], s.norm_eps)
    k_rope = apply_rope(kv_a[..., s.kv_lora_rank:][:, :, None, :],
                        positions, s.rope_theta)[:, :, 0, :]

    if paged is not None:
        paged_write(cache["ckv"], ckv, pos, paged)
        paged_write(cache["krope"], k_rope, pos, paged)
        ckv_all = paged_gather(cache["ckv"], paged)
        krope_all = paged_gather(cache["krope"], paged)
    elif cache is not None:
        ckv_all = _write_seq(cache["ckv"], ckv, pos)
        krope_all = _write_seq(cache["krope"], k_rope, pos)
    else:
        ckv_all, krope_all = ckv, k_rope
    t = ckv_all.shape[1]
    if cache is not None:
        kv_valid = _kv_valid_mask(t, pos, sl, b, x.device)
    else:
        kv_valid = torch.ones((b, sl), dtype=torch.bool, device=x.device)

    kv = linear(p["wkv_b"], ckv_all).reshape(b, t, s.n_heads,
                                             s.nope_dim + s.v_dim)
    k_nope, v = kv[..., :s.nope_dim], kv[..., s.nope_dim:]
    q_cat = torch.cat([q_nope, q_rope], dim=-1).reshape(b, sl, s.n_heads, 1,
                                                        qk_head)
    k_cat = torch.cat([k_nope, krope_all[:, :, None, :].expand(
        b, t, s.n_heads, s.rope_dim)], dim=-1)
    o = _sdpa(q_cat, k_cat, v, q_pos=positions, kv_valid=kv_valid,
              softmax_impl=s.softmax_impl, causal=True,
              scale=1.0 / qk_head ** 0.5, attn_impl=s.attn_impl)
    o = o.reshape(b, sl, s.n_heads * s.v_dim)
    return linear(p["wo"], o), cache


# ---------------- cross attention (VLM, encoder-decoder) ----------------

def cross_init(gen: torch.Generator, s: AttnSpec, device) -> Params:
    return {"wq": linear_init(gen, s.d_model, s.n_heads * s.head_dim, device),
            "wk": linear_init(gen, s.d_model, s.n_kv_heads * s.head_dim,
                              device),
            "wv": linear_init(gen, s.d_model, s.n_kv_heads * s.head_dim,
                              device),
            "wo": linear_init(gen, s.n_heads * s.head_dim, s.d_model,
                              device)}


def cross_kv(p: Params, s: AttnSpec, enc) -> Params:
    """Cross K/V (B, T, K, h) from ``enc`` (B, T, d), the image embeddings
    or the encoder's output: computed at prefill and cached for decode."""
    b, t, _ = enc.shape
    k = linear(p["wk"], enc).reshape(b, t, s.n_kv_heads, s.head_dim)
    v = linear(p["wv"], enc).reshape(b, t, s.n_kv_heads, s.head_dim)
    return {"k": k, "v": v}


def cross_apply(p: Params, s: AttnSpec, x, kv: Params):
    """x (B, S, d) attends over every cross key, non-causally, through
    the attention impl ``s.attn_impl`` (the engine's pick for the phase:
    a concrete name is taken as it is, not resolved for this shape)."""
    b, sl, _ = x.shape
    g = s.n_heads // s.n_kv_heads
    q = linear(p["wq"], x).reshape(b, sl, s.n_kv_heads, g, s.head_dim)
    t = kv["k"].shape[1]
    valid = torch.ones((b, t), dtype=torch.bool, device=x.device)
    o = _sdpa(q, kv["k"], kv["v"],
              q_pos=torch.zeros((b, sl), dtype=torch.int32, device=x.device),
              kv_valid=valid, softmax_impl=s.softmax_impl, causal=False,
              attn_impl=s.attn_impl)
    return linear(p["wo"], o.reshape(b, sl, s.n_heads * s.head_dim))
