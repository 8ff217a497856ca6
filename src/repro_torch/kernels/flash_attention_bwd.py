"""Backward kernels of blocked flash attention, float (port of
``repro.kernels.flash_attention_bwd``).

``flash_bwd_dq``    replaces the dq pallas_call of
                    ``flash_attention_bwd_pallas`` (flash_attention_bwd.py:234)
``flash_bwd_dkdv``  replaces its dk/dv pallas_call (flash_attention_bwd.py:266)

From the forward's saved (o, m, l) each tile re-derives the forward's
probabilities through the datapath's own steps and takes Dao et al.'s
recompute (``csrc/flash_bwd.cu``, plain versions below):

    p  = online_softmax_finish(l, online_softmax_update(m, l, s).p)
    D  = rowsum(dO * O)
    dS = P * (dO V^T - D),  zeroed where the score is MASK_VALUE
    dQ = dS K      dK = dS^T Q      dV = P^T dO   (G groups summed)

q arrives pre-scaled, so dq is the cotangent of the pre-scaled q; the
scale's chain rule is the caller's (``flash_attention.py``).  Masking is
:func:`flash_attention.masked_score_block`'s: a masked key gets no dS,
but its probability ``exp(MASK_VALUE - m) / l`` still reaches dV, as in
the reference VJP; a phantom key (past T) gets nothing.

Causal tail: both kernels skip the (q tile, kv tile) pairs that lie
wholly past the diagonal.  dq loses nothing there (dS is 0 at masked
keys), but dV does: every key of a kv tile that starts past a row's
q_pos receives that row's ``exp(MASK_VALUE - m) / l * dO``, the same
vector for every key of the tile.  Each entry point first runs a row
pre-pass into scratch the wrapper allocates: every row's (m, 1 / l, D,
q_pos) and, for dk/dv, each q tile's largest q_pos and its masked-tail
vector (the sum of those vectors over its rows).  A dk/dv block adds
the tail vectors of the q tiles it skips to every key's dV -- the dV
twin of the forward's folded V tail.  The kernels' tiles are the
policy's (:func:`tiling.flash_bwd_plan`), not the forward's
``block_kv``; the mask is per key, so the results do not depend on
them.  The plain versions sweep every tile, as the reference does, and
hold the fold to account.
"""
from __future__ import annotations

import torch

from . import _build
from . import datapath as dp
from . import tiling
from .flash_attention import _check_operands, check_block_kv, masked_score_block

_P, _I = _build.P, _build.I

FLASH_BWD_DQ = _build.Kernel(
    "flash_bwd_dq", "flash_bwd_dq_launch", [_P] * 11 + [_I] * 14 + [_P],
    source="src/repro_torch/csrc/flash_bwd.cu",
    replaces="src/repro/kernels/flash_attention_bwd.py:234")
FLASH_BWD_DKDV = _build.Kernel(
    "flash_bwd_dkdv", "flash_bwd_dkdv_launch", [_P] * 14 + [_I] * 14 + [_P],
    source="src/repro_torch/csrc/flash_bwd.cu",
    replaces="src/repro/kernels/flash_attention_bwd.py:266")


# ---- plain versions ---------------------------------------------------------

def _tile_grads(qf, k, v, o, m, l, do, q_pos, kv_valid, *, causal: bool,
                block_kv: int):
    """The reference's per-tile recompute, batched over q: yields (kv
    slice, p, dS) for every KV tile, p and dS (B, K, G, S, nk)."""
    t = k.shape[1]
    d_row = torch.sum(do * o, dim=-1).permute(0, 2, 3, 1)[..., None]
    m_row, l_row = m[..., None], l[..., None]
    for j in range(tiling.cdiv(t, block_kv)):
        sl = slice(j * block_kv, min(t, (j + 1) * block_kv))
        s, live = masked_score_block(qf, k[:, sl], q_pos, kv_valid[:, sl], j,
                                     block_kv=block_kv, causal=causal,
                                     t_kv=t, return_mask=True)
        _, _, p, _ = dp.online_softmax_update(m_row, l_row, s)
        p = dp.online_softmax_finish(l_row, p)
        dpv = torch.einsum("bskgd,btkd->bkgst", do, v[:, sl])
        ds = torch.where(live, p * (dpv - d_row), torch.zeros_like(p))
        yield sl, p, ds


def flash_bwd_dq_plain(qf, k, v, o, m, l, do, q_pos, kv_valid, *,
                       causal: bool, block_kv: int):
    """dq (B, S, K, G, h) f32 from the saved forward: qf (B, S, K, G, h)
    pre-scaled, k (B, T, K, h), v (B, T, K, hv), o / do (B, S, K, G, hv),
    m / l (B, K, G, S), q_pos (B, S), kv_valid (B, T)."""
    dq = torch.zeros_like(qf)
    for sl, _, ds in _tile_grads(qf, k, v, o, m, l, do, q_pos, kv_valid,
                                 causal=causal, block_kv=block_kv):
        dq += torch.einsum("bkgst,btkh->bskgh", ds, k[:, sl])
    return dq


def flash_bwd_dkdv_plain(qf, k, v, o, m, l, do, q_pos, kv_valid, *,
                         causal: bool, block_kv: int):
    """(dk (B, T, K, h), dv (B, T, K, hv)) f32, the G groups summed;
    arguments as :func:`flash_bwd_dq_plain`."""
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for sl, p, ds in _tile_grads(qf, k, v, o, m, l, do, q_pos, kv_valid,
                                 causal=causal, block_kv=block_kv):
        dk[:, sl] = torch.einsum("bkgst,bskgh->btkh", ds, qf)
        dv[:, sl] = torch.einsum("bkgst,bskgd->btkd", p, do)
    return dk, dv


# ---- kernel wrappers --------------------------------------------------------

def _check_saved(name, qf, v, o, m, l, do):
    b, s_q, kh, g, _ = qf.shape
    hv = v.shape[-1]
    for key, x, shape in (("o", o, (b, s_q, kh, g, hv)),
                          ("do", do, (b, s_q, kh, g, hv)),
                          ("m", m, (b, kh, g, s_q)), ("l", l, (b, kh, g, s_q))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {key} is {x.dtype} {tuple(x.shape)}, "
                             f"expected float32 {shape}")
        if x.device != qf.device or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on "
                             f"{qf.device}")


def _plan(kernel, qf, k, v, o, do, out, causal):
    """The policy's plan, its ints as the C entry takes them, and the row
    state scratch (B, K, S G, 4)."""
    b, s_q, kh, g, h = qf.shape
    aligned = all(x.data_ptr() % 16 == 0 for x in (qf, k, v, o, do, *out))
    plan = tiling.flash_bwd_plan(kernel, h, v.shape[-1], causal=causal,
                                 aligned=aligned)
    rows = torch.empty((b, kh, s_q * g, 4), dtype=torch.float32,
                       device=qf.device)
    return plan, (plan.block_q, plan.block_kv, plan.stages, plan.vec,
                  int(plan.reverse)), rows


def flash_bwd_dq(qf, k, v, o, m, l, do, q_pos, kv_valid, *, causal: bool,
                 block_kv: int):
    """dq through the CUDA kernel (CUDA tensors) or the plain version (CPU
    tensors); arguments as :func:`flash_bwd_dq_plain`, kv_valid uint8."""
    check_block_kv(block_kv)
    if qf.device.type == "cpu":
        return flash_bwd_dq_plain(qf, k, v, o, m, l, do, q_pos, kv_valid,
                                  causal=causal, block_kv=block_kv)
    _check_operands("flash_bwd_dq", qf, k, v, q_pos, kv_valid)
    _check_saved("flash_bwd_dq", qf, v, o, m, l, do)
    b, s_q, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    dq = torch.empty_like(qf)
    _, ints, rows = _plan("dq", qf, k, v, o, do, (dq,), causal)
    FLASH_BWD_DQ(qf.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), m.data_ptr(), l.data_ptr(), q_pos.data_ptr(),
                 kv_valid.data_ptr(), rows.data_ptr(), dq.data_ptr(), b, s_q,
                 kh, g, h, hv, t, block_kv, int(causal), *ints,
                 _build.stream_ptr(qf.device))
    return dq


def flash_bwd_dkdv(qf, k, v, o, m, l, do, q_pos, kv_valid, *, causal: bool,
                   block_kv: int):
    """(dk, dv) through the CUDA kernel (CUDA tensors) or the plain
    version (CPU tensors); arguments as :func:`flash_bwd_dq`."""
    check_block_kv(block_kv)
    if qf.device.type == "cpu":
        return flash_bwd_dkdv_plain(qf, k, v, o, m, l, do, q_pos, kv_valid,
                                    causal=causal, block_kv=block_kv)
    _check_operands("flash_bwd_dkdv", qf, k, v, q_pos, kv_valid)
    _check_saved("flash_bwd_dkdv", qf, v, o, m, l, do)
    b, s_q, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan, ints, rows = _plan("dkdv", qf, k, v, o, do, (dk, dv), causal)
    n_qt = tiling.cdiv(s_q * g, plan.block_q)
    qmax = torch.empty((b, n_qt), dtype=torch.int32, device=qf.device)
    tail = torch.empty((b, n_qt, kh, hv), dtype=torch.float32,
                       device=qf.device)
    FLASH_BWD_DKDV(qf.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   do.data_ptr(), m.data_ptr(), l.data_ptr(),
                   q_pos.data_ptr(), kv_valid.data_ptr(), rows.data_ptr(),
                   qmax.data_ptr(), tail.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), b, s_q, kh, g, h, hv, t, block_kv,
                   int(causal), *ints, _build.stream_ptr(qf.device))
    return dk, dv


def flash_attention_bwd_pallas(q, k, v, o, m, l, do, *, q_pos, kv_valid,
                               causal: bool, block_kv: int):
    """(dq, dk, dv) f32 through the two backward kernels (the reference's
    entry point; its ``block_q`` / ``interpret`` have no counterpart: the
    q tile is the kernels' own).  ``q`` is the pre-scaled f32 query and
    (o, m, l) the forward's output and (B, K, G, S) row statistics;
    ``block_kv`` must be the forward's."""
    args = (q.to(torch.float32).contiguous(),
            k.to(torch.float32).contiguous(),
            v.to(torch.float32).contiguous(),
            o.to(torch.float32).contiguous(), m.contiguous(), l.contiguous(),
            do.to(torch.float32).contiguous(),
            q_pos.to(torch.int32).contiguous(),
            kv_valid.to(torch.uint8).contiguous())
    kw = dict(causal=causal, block_kv=block_kv)
    dq = flash_bwd_dq(*args, **kw)
    dk, dv = flash_bwd_dkdv(*args, **kw)
    return dq, dk, dv
