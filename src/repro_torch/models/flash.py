"""Blocked online-softmax attention in plain PyTorch (port of
``repro.models.flash``): the 'flash' impl and the oracles the decode
kernels are held to.

Shapes: q (B,S,K,G,h), k (B,T,K,h), v (B,T,K,hv) -> (B,S,K,G,hv).  Masked
scores take ``datapath.MASK_VALUE``; keys added by padding take -inf.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import datapath as dp


def flash_attention(q, k, v, *, q_pos, kv_valid, causal: bool = True,
                    block: int = 1024, scale: float | None = None,
                    return_stats: bool = False):
    """Blocked online-softmax attention; ``return_stats`` also returns the
    per-row (m, l) laid out (B, K, G, S)."""
    b, s_q, kh, g, hd = q.shape
    t = k.shape[1]
    hv = v.shape[-1]
    block = min(block, t)
    pad = (-t) % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid = torch.nn.functional.pad(kv_valid, (0, pad), value=False)
    scale = (1.0 / hd ** 0.5) if scale is None else scale
    qf = q.to(torch.float32) * scale
    dev = q.device
    m = torch.full((b, kh, g, s_q, 1), dp.MASK_VALUE, device=dev)
    l = torch.zeros((b, kh, g, s_q, 1), device=dev)
    acc = torch.zeros((b, kh, g, s_q, hv), device=dev)
    t_idx = torch.arange(block, device=dev)
    for i in range(k.shape[1] // block):
        sl = slice(i * block, (i + 1) * block)
        sc = torch.einsum("bskgh,btkh->bkgst", qf, k[:, sl].to(torch.float32))
        pos_b = i * block + t_idx
        mask = kv_valid[:, None, sl]
        if causal:
            mask = mask & (pos_b[None, None, :] <= q_pos[:, :, None])
        sc = torch.where(mask[:, None, None], sc,
                         torch.full_like(sc, dp.MASK_VALUE))
        if pad:
            sc = torch.where(pos_b < t, sc, torch.full_like(sc, -torch.inf))
        m, l, p, corr = dp.online_softmax_update(m, l, sc)
        acc = acc * corr + torch.einsum("bkgst,btkh->bkgsh", p,
                                        v[:, sl].to(torch.float32))
    out = dp.online_softmax_finish(l, acc).movedim(3, 1).to(v.dtype)
    if return_stats:
        return out, m[..., 0], l[..., 0]
    return out


def flash_attention_merged(q, k, v, *, q_pos, kv_valid, n_splits: int,
                           causal: bool = True, scale: float | None = None,
                           block: int = 1024):
    """Split KV into ``n_splits`` shards, run the blocked reference per
    shard and fold the (m, l, o*l) partials with the pairwise merge: the
    oracle of the split-invariance of every split-KV path."""
    t = k.shape[1]
    if t % n_splits:
        raise ValueError(f"{t} keys do not split into {n_splits}")
    t_loc = t // n_splits
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    qf = q.to(torch.float32) * scale
    part = None
    for i in range(n_splits):
        sl = slice(i * t_loc, (i + 1) * t_loc)
        o_i, m_i, l_i = flash_attention(
            qf, k[:, sl], v[:, sl], q_pos=q_pos - i * t_loc,
            kv_valid=kv_valid[:, sl], causal=causal, scale=1.0,
            block=min(block, t_loc), return_stats=True)
        m_i = m_i.movedim(3, 1)[..., None]
        l_i = l_i.movedim(3, 1)[..., None]
        part_i = (m_i, l_i, o_i.to(torch.float32) * l_i)
        part = part_i if part is None else dp.online_softmax_merge(part, part_i)
    _, l, acc = part
    return dp.online_softmax_finish(l, acc).to(v.dtype)


def flash_attention_paged_ref(q, k_pool, v_pool, *, block_tables, q_pos,
                              kv_valid, causal: bool = True,
                              scale: float | None = None):
    """Paged fold oracle: a loop over LOGICAL blocks, each gathered
    through the table, reduced to its (m, l, o*l) partial and folded with
    the pairwise merge.  Only the logical block index enters the mask."""
    nblk, bs = block_tables.shape[1], k_pool.shape[1]
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    qf = q.to(torch.float32) * scale
    part = None
    for j in range(nblk):
        idx = block_tables[:, j].long()
        kb = k_pool[idx].to(torch.float32)                 # (B,bs,K,h)
        vb = v_pool[idx].to(torch.float32)                 # (B,bs,K,hv)
        s = torch.einsum("bskgh,btkh->bskgt", qf, kb)
        kv_pos = j * bs + torch.arange(bs, device=q.device)
        mask = kv_valid[:, j * bs:(j + 1) * bs][:, None, None, None, :]
        if causal:
            mask = mask & (kv_pos[None, None, None, None, :]
                           <= q_pos[:, :, None, None, None])
        s = torch.where(mask, s, torch.full_like(s, dp.MASK_VALUE))
        part_j = dp.online_softmax_partial(
            s, vb.movedim(1, 2)[:, None, :, None])
        part = part_j if part is None else dp.online_softmax_merge(
            part, part_j)
    _, l, acc = part
    return dp.online_softmax_finish(l, acc).to(v_pool.dtype)
