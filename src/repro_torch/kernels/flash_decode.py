"""Split-KV decode, float and int, over a paged or a contiguous KV cache
(port of ``repro.kernels.flash_decode``).

``decode_paged``      replaces the paged float body (pallas_call at :365)
``decode_paged_int``  replaces the paged snapped int body (pallas_call at :440)
``decode_dense``      replaces the contiguous float body (pallas_call at :162)
``decode_dense_int``  replaces the contiguous int body (pallas_call at :283)

The kernels emit one partial state per KV split -- (m, l, o*l) float, or
(m snapped, S[16] buckets, acc) int -- and the split fold runs here in
PyTorch, as the reference runs it outside its kernel:
``online_softmax_merge_n`` + finish, or ``online_merge_n_int`` +
``online_finish_int`` + one f32 division.  The kernels are bound by
memory on the H100: each visited K/V key is read once.  All four run on
one Hopper kernel (``csrc/decode_dense_sm90.cuh`` under
``csrc/decode_dense.cu`` and ``csrc/decode_paged.cu``:
per-warp key runs, each warp's cp.async ring and online state -- float, or
the snapped m and a bucket a lane -- and a fixed-order merge of the warps)
with a row-state policy (float, int) and a KV-layout policy (contiguous,
or paged through the block table).  On a GPU the split count is
:func:`tiling.decode_dense_plan`'s, with its 64-key tiles on a contiguous
cache and the page as the tile on a paged one (:func:`tiling.decode_splits`);
the CPU keeps the reference's split rule.

Shapes (the reference's): q (B, 1, K, G, h); paged pools (N, bs, K,
h|hv) with block_tables (B, nblk) int32 and kv_valid (B, nblk*bs);
contiguous k (B, T, K, h), v (B, T, K, hv), kv_valid (B, T); q_pos (B, 1)
-> (B, 1, K, G, hv).  On a GPU the kernels take G up to 8 and h, hv up to
128; the contiguous ones also MLA's h up to 192 against hv up to 128 (an
MLA tick attends densely over its gathered latent, so the paged rows keep
128).  Anything else raises ValueError.  Split s covers its share of each
row's LIVE tiles (pages, paged: up to its q_pos when causal), so a shallow
slot in a deep cache still spreads its work over every split.  The fold
does not depend on where the splits fall: the int words are exact, float
changes only in f32 order.
"""
from __future__ import annotations

import torch

from repro_torch.core import softmax_unit as unit
from repro_torch.core.fixedpoint import T_FRAC, quantize

from . import _build
from . import datapath as dp
from . import dispatch, tiling
from .flash_attention import MAX_HEAD_DIM, head_dims_ok
from .flash_attention_int import snap_tile_update

_P, _I = _build.P, _build.I

DECODE_PAGED = _build.Kernel(
    "decode_paged", "decode_paged_launch", [_P] * 9 + [_I] * 11 + [_P],
    source="src/repro_torch/csrc/decode_paged.cu",
    replaces="src/repro/kernels/flash_decode.py:365")
DECODE_PAGED_INT = _build.Kernel(
    "decode_paged_int", "decode_paged_int_launch", [_P] * 9 + [_I] * 12 + [_P],
    source="src/repro_torch/csrc/decode_paged.cu",
    replaces="src/repro/kernels/flash_decode.py:440")
DECODE_DENSE = _build.Kernel(
    "decode_dense", "decode_dense_launch", [_P] * 8 + [_I] * 10 + [_P],
    source="src/repro_torch/csrc/decode_dense.cu",
    replaces="src/repro/kernels/flash_decode.py:162")
DECODE_DENSE_INT = _build.Kernel(
    "decode_dense_int", "decode_dense_int_launch", [_P] * 8 + [_I] * 11 + [_P],
    source="src/repro_torch/csrc/decode_dense.cu",
    replaces="src/repro/kernels/flash_decode.py:283")

MAX_GROUPS = 8          # GQA rows per kv head the kernels hold (kMaxG)


# ---------------- the split sweep of both plain versions ----------------

def dense_split_tiles(q_pos, nblk: int, block_kv: int, num_splits: int,
                      causal: bool):
    """Per row: (live tiles, tiles per split) of the split-KV decodes --
    each row's live range (tiles, or pages, up to its q_pos when causal)
    cut into ``num_splits`` shares, as the kernels cut it."""
    if causal:
        live = torch.where(q_pos < 0, torch.zeros_like(q_pos),
                           torch.clamp(q_pos // block_kv + 1, max=nblk))
    else:
        live = torch.full_like(q_pos, nblk)
    return live, (live + num_splits - 1) // num_splits


def _split_partials_plain(qf, tile, t: int, hv: int, q_pos, kv_valid, *,
                          num_splits: int, block_kv: int, causal: bool,
                          int_mode: bool, guard_shift: int):
    """The split-KV sweep of both plain versions over a t-key cache:
    split s folds its share of each row's live tiles (dense_split_tiles),
    tile by tile.  ``tile(jt, idx)`` gives the K and V rows (B, block_kv,
    K, h|hv) of tile jt (B,) of each row, keys idx (B, block_kv) (0 past
    the cache); kv_valid (B, t) and the causal test read the logical
    position."""
    b, kh, g, _ = qf.shape
    nblk = tiling.cdiv(t, block_kv)
    dev = qf.device
    qp = q_pos.to(torch.int64)
    live, inner = dense_split_tiles(qp, nblk, block_kv, num_splits, causal)
    offs = torch.arange(block_kv, device=dev)
    parts = []
    for sp in range(num_splits):
        if int_mode:
            m = torch.full((b, kh, g, 1), unit.SNAP_MIN, dtype=torch.int32,
                           device=dev)
            l = torch.zeros((b, kh, g, unit.N_SNAP_BUCKETS),
                            dtype=torch.int32, device=dev)
        else:
            m = torch.full((b, kh, g, 1), dp.MASK_VALUE, device=dev)
            l = torch.zeros((b, kh, g, 1), device=dev)
        acc = torch.zeros((b, kh, g, hv), device=dev)
        n_steps = int(inner.max()) if b else 0
        for i in range(n_steps):
            jt = sp * inner + i                                   # (B,)
            on = (i < inner) & (jt < live)
            kv_pos = jt[:, None] * block_kv + offs[None, :]       # (B, bkv)
            real = kv_pos < t
            idx = torch.where(real, kv_pos, torch.zeros_like(kv_pos))
            kb, vb = tile(jt, idx)
            kb = kb.to(torch.float32)                             # (B,bkv,K,h)
            vb = vb.to(torch.float32).permute(0, 2, 1, 3)
            vb = torch.where(real[:, None, :, None], vb, torch.zeros_like(vb))
            s = torch.einsum("bkgh,btkh->bkgt", qf, kb)
            mask = torch.gather(kv_valid, 1, idx).bool()
            if causal:
                mask = mask & (kv_pos <= qp[:, None])
            s = torch.where(mask[:, None, None, :], s,
                            torch.full_like(s, dp.MASK_VALUE))
            ph = ~real[:, None, None, :]
            vb = vb[:, :, None]                              # (B,K,1,bkv,hv)
            if int_mode:
                sq = torch.where(ph, torch.full_like(s, 0.0), s)
                sq = torch.where(ph, torch.full((), unit.PHANTOM_Q,
                                                dtype=torch.int32,
                                                device=dev), quantize(sq))
                m_n, l_n, acc_n = snap_tile_update(m, l, acc, sq, vb,
                                                   guard_shift)
            else:
                s = torch.where(ph, torch.full_like(s, -torch.inf), s)
                m_n, l_n, p, corr = dp.online_softmax_update(m, l, s)
                acc_n = acc * corr + torch.einsum("bkgt,bkgtv->bkgv", p, vb)
            on = on[:, None, None, None]
            m = torch.where(on, m_n, m)
            l = torch.where(on, l_n, l)
            acc = torch.where(on, acc_n, acc)
        parts.append((m[..., 0], l if int_mode else l[..., 0], acc))
    return tuple(torch.stack(x, dim=1) for x in zip(*parts))


# ---------------- paged cache ----------------

def decode_paged_partials_plain(qf, k_pool, v_pool, tables, q_pos, kv_valid,
                                *, num_splits: int, causal: bool,
                                int_mode: bool, guard_shift: int):
    """Plain version of both paged decode kernels: the per-split partials,
    the page as the tile (the contiguous sweep of
    :func:`decode_dense_partials_plain`, each page read through the
    table; an entry outside the pool reads the sentinel block 0).

    qf (B, K, G, h) pre-scaled; q_pos (B,) int32; kv_valid (B, nblk*bs).
    Returns (m, l | S, acc) shaped (B, S, K, G), (B, S, K, G[, 16]),
    (B, S, K, G, hv).
    """
    n_pool, bs = k_pool.shape[:2]
    nblk = tables.shape[1]
    blocks = tables.to(torch.int64)
    blocks = torch.where((blocks >= 0) & (blocks < n_pool), blocks, 0)
    rows = torch.arange(qf.shape[0], device=qf.device)

    def tile(jt, idx):
        blk = blocks[rows, torch.clamp(jt, max=nblk - 1)]
        return k_pool[blk], v_pool[blk]
    return _split_partials_plain(
        qf, tile, nblk * bs, v_pool.shape[-1], q_pos, kv_valid,
        num_splits=num_splits, block_kv=bs, causal=causal,
        int_mode=int_mode, guard_shift=guard_shift)


def decode_paged_partials(qf, k_pool, v_pool, tables, q_pos, kv_valid, *,
                          num_splits: int, causal: bool, int_mode: bool,
                          guard_shift: int):
    """Per-split partials through the CUDA kernel (CUDA tensors) or the
    plain version (CPU tensors); arguments as
    :func:`decode_paged_partials_plain`.  The kernels copy K / V at
    :func:`tiling.decode_dense_vec`'s width."""
    if qf.device.type == "cpu":
        return decode_paged_partials_plain(
            qf, k_pool, v_pool, tables, q_pos, kv_valid,
            num_splits=num_splits, causal=causal, int_mode=int_mode,
            guard_shift=guard_shift)
    b, kh, g, h = qf.shape
    n_pool, bs = k_pool.shape[:2]
    hv = v_pool.shape[-1]
    nblk = tables.shape[1]
    _check_decode_operands(qf, k_pool, v_pool, tables, q_pos, kv_valid)
    if not 1 <= num_splits <= nblk:
        raise ValueError(f"num_splits={num_splits} outside [1, {nblk}]")
    if not head_dims_ok(h, hv, wide=False):
        raise ValueError(f"decode_paged: head dims {h}/{hv}; the kernels "
                         f"take 1..{MAX_HEAD_DIM}")
    dev = qf.device
    part_m = torch.empty((b, num_splits, kh, g), device=dev,
                         dtype=torch.int32 if int_mode else torch.float32)
    part_l = (torch.empty((b, num_splits, kh, g, unit.N_SNAP_BUCKETS),
                          device=dev, dtype=torch.int32) if int_mode
              else torch.empty((b, num_splits, kh, g), device=dev))
    part_acc = torch.empty((b, num_splits, kh, g, hv), device=dev)
    ptrs = (qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), q_pos.data_ptr(), kv_valid.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            b, n_pool, bs, kh, g, h, hv, nblk, num_splits, int(causal))
    vec = tiling.decode_dense_vec(h, hv, tiling.aligned16(k_pool, v_pool))
    if int_mode:
        DECODE_PAGED_INT(*ptrs, guard_shift, vec, _build.stream_ptr(dev))
    else:
        DECODE_PAGED(*ptrs, vec, _build.stream_ptr(dev))
    return part_m, part_l, part_acc


def _check_decode_operands(qf, k_pool, v_pool, tables, q_pos, kv_valid):
    b, kh, g, h = qf.shape
    n_pool, bs = k_pool.shape[:2]
    nblk = tables.shape[1]
    want = {"qf": (torch.float32, (b, kh, g, h)),
            "k_pool": (torch.float32, (n_pool, bs, kh, h)),
            "v_pool": (torch.float32, (n_pool, bs, kh, v_pool.shape[-1])),
            "tables": (torch.int32, (b, nblk)),
            "q_pos": (torch.int32, (b,)),
            "kv_valid": (torch.uint8, (b, nblk * bs))}
    got = {"qf": qf, "k_pool": k_pool, "v_pool": v_pool, "tables": tables,
           "q_pos": q_pos, "kv_valid": kv_valid}
    for name, (dtype, shape) in want.items():
        t = got[name]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"decode_paged: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
        if t.device != qf.device or not t.is_contiguous():
            raise ValueError(f"decode_paged: {name} must be contiguous on "
                             f"{qf.device}")
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"decode_paged: {g} query groups per kv head; the "
                         f"kernel holds 1..{MAX_GROUPS}")


def finish_partials(part_m, part_l, part_acc, int_mode: bool):
    """The split fold + normalization (outside the kernel, as in the
    reference): partials (B, S, K, G, ...) -> (B, 1, K, G, hv)."""
    if int_mode:
        _, S, acc = unit.online_merge_n_int(part_m[..., None], part_l,
                                            part_acc, dim=1)
        l = unit.online_finish_int(S)
        return acc / l[..., None].to(torch.float32)
    _, l, acc = dp.online_softmax_merge_n(part_m[..., None],
                                          part_l[..., None], part_acc, dim=1)
    return dp.online_softmax_finish(l, acc)


def flash_decode_paged(q, k_pool, v_pool, *, block_tables, q_pos, kv_valid,
                       causal: bool = True, scale: float | None = None,
                       num_splits: int | None = None,
                       softmax_impl: str = "float"):
    """Block-table split-KV decode; ``softmax_impl='dualmode'`` runs the
    snapped int recurrence (the reference's contract and arguments)."""
    if q.shape[1] != 1:
        raise ValueError(
            f"flash_decode is the s_q=1 decode kernel; got s_q={q.shape[1]}")
    if softmax_impl not in ("float", "dualmode"):
        raise ValueError(f"flash_decode_paged softmax_impl={softmax_impl!r}: "
                         "expected 'float' or 'dualmode'")
    b, _, kh, g, h = q.shape
    nblk, bs = block_tables.shape[1], k_pool.shape[1]
    if kv_valid.shape[1] != nblk * bs:
        raise ValueError(
            f"kv_valid covers {kv_valid.shape[1]} keys but the table maps "
            f"{nblk} blocks x {bs} = {nblk * bs}")
    scale = (1.0 / h ** 0.5) if scale is None else scale
    qf = (q.to(torch.float32) * scale)[:, 0].contiguous()
    if num_splits is None:
        num_splits = tiling.decode_splits(nblk, bs, b * kh, q.device)
    num_splits = max(1, min(num_splits, nblk))
    int_mode = softmax_impl == "dualmode"
    parts = decode_paged_partials(
        qf, k_pool.contiguous(), v_pool.contiguous(),
        block_tables.to(torch.int32).contiguous(),
        q_pos.reshape(b).to(torch.int32).contiguous(),
        kv_valid.to(torch.uint8).contiguous(), num_splits=num_splits,
        causal=causal, int_mode=int_mode,
        # guard from the LOGICAL cache extent, as the whole-row unit would
        guard_shift=unit.guard_shift_for(nblk * bs))
    return finish_partials(*parts, int_mode=int_mode).to(v_pool.dtype)


# ---------------- contiguous cache ----------------

def decode_dense_partials_plain(qf, k, v, q_pos, kv_valid, *,
                                num_splits: int, block_kv: int, causal: bool,
                                int_mode: bool, guard_shift: int):
    """Plain version of both contiguous decode kernels: the per-split
    partials.  qf (B, K, G, h) pre-scaled; k (B, T, K, h); v (B, T, K,
    hv); q_pos (B,) int32; kv_valid (B, T).  Returns (m, l | S, acc)
    shaped (B, S, K, G), (B, S, K, G[, 16]), (B, S, K, G, hv)."""
    rows = torch.arange(qf.shape[0], device=qf.device)[:, None]

    def tile(jt, idx):
        return k[rows, idx], v[rows, idx]
    return _split_partials_plain(
        qf, tile, k.shape[1], v.shape[-1], q_pos, kv_valid,
        num_splits=num_splits, block_kv=block_kv, causal=causal,
        int_mode=int_mode, guard_shift=guard_shift)


def decode_dense_partials(qf, k, v, q_pos, kv_valid, *, num_splits: int,
                          block_kv: int, causal: bool, int_mode: bool,
                          guard_shift: int):
    """Per-split partials of the contiguous decode through the CUDA
    kernel (CUDA tensors) or the plain version (CPU tensors); arguments
    as :func:`decode_dense_partials_plain`.  The kernels copy K / V at
    :func:`tiling.decode_dense_vec`'s width."""
    if qf.device.type == "cpu":
        return decode_dense_partials_plain(
            qf, k, v, q_pos, kv_valid, num_splits=num_splits,
            block_kv=block_kv, causal=causal, int_mode=int_mode,
            guard_shift=guard_shift)
    b, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    _check_dense_operands(qf, k, v, q_pos, kv_valid)
    if num_splits < 1 or not 1 <= block_kv <= 1024:
        raise ValueError(f"num_splits={num_splits}, block_kv={block_kv}")
    if not head_dims_ok(h, hv, wide=True):
        raise ValueError(f"decode_dense: head dims {h}/{hv}; the kernels "
                         "take h 1..192 and hv 1..128")
    dev = qf.device
    part_m = torch.empty((b, num_splits, kh, g), device=dev,
                         dtype=torch.int32 if int_mode else torch.float32)
    part_l = (torch.empty((b, num_splits, kh, g, unit.N_SNAP_BUCKETS),
                          device=dev, dtype=torch.int32) if int_mode
              else torch.empty((b, num_splits, kh, g), device=dev))
    part_acc = torch.empty((b, num_splits, kh, g, hv), device=dev)
    ptrs = (qf.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_valid.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), b, t, kh, g, h, hv, block_kv, num_splits,
            int(causal))
    vec = tiling.decode_dense_vec(h, hv, tiling.aligned16(k, v))
    if int_mode:
        DECODE_DENSE_INT(*ptrs, guard_shift, vec, _build.stream_ptr(dev))
    else:
        DECODE_DENSE(*ptrs, vec, _build.stream_ptr(dev))
    return part_m, part_l, part_acc


def _check_dense_operands(qf, k, v, q_pos, kv_valid):
    b, kh, g, h = qf.shape
    t = k.shape[1]
    want = {"qf": (torch.float32, (b, kh, g, h)),
            "k": (torch.float32, (b, t, kh, h)),
            "v": (torch.float32, (b, t, kh, v.shape[-1])),
            "q_pos": (torch.int32, (b,)),
            "kv_valid": (torch.uint8, (b, t))}
    got = {"qf": qf, "k": k, "v": v, "q_pos": q_pos, "kv_valid": kv_valid}
    for name, (dtype, shape) in want.items():
        x = got[name]
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"decode_dense: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {dtype} {shape}")
        if x.device != qf.device or not x.is_contiguous():
            raise ValueError(f"decode_dense: {name} must be contiguous on "
                             f"{qf.device}")
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"decode_dense: {g} query groups per kv head; the "
                         f"kernel holds 1..{MAX_GROUPS}")


def dense_decode_splits(t: int, rows: int, device) -> int:
    """Split count of the contiguous decode's plain version on the CPU:
    the reference's off-TPU rule (one split per DECODE_SPLIT_KEYS keys of
    DECODE_BLOCK_KV-key tiles)."""
    return tiling.decode_splits(tiling.cdiv(t, tiling.DECODE_BLOCK_KV),
                                tiling.DECODE_BLOCK_KV, rows, device)


def dense_decode_tiles(t: int, rows: int, device, *,
                       num_splits: int | None = None):
    """(num_splits, block_kv) of :func:`flash_decode_pallas` over a t-key
    cache of ``rows`` (batch x kv heads) sweeps: the kernels on a GPU, float
    and int, take :func:`tiling.decode_dense_plan`'s; the plain version on
    the CPU keeps the reference's rule, :func:`dense_decode_splits` and
    :func:`tiling.decode_kv_block`.  A given ``num_splits`` is kept."""
    if device.type == "cuda":
        plan = tiling.decode_dense_plan(t, rows, sms=tiling.sm_count(device))
        return (plan.splits if num_splits is None else num_splits,
                plan.block_kv)
    if num_splits is None:
        num_splits = dense_decode_splits(t, rows, device)
    return num_splits, tiling.decode_kv_block(t, max(1, num_splits))


def flash_decode_pallas(q, k, v, *, q_pos, kv_valid, causal: bool = True,
                        scale: float | None = None,
                        num_splits: int | None = None,
                        block_kv: int | None = None,
                        softmax_impl: str = "float"):
    """Contiguous split-KV decode (the reference's contract and
    arguments); ``softmax_impl='dualmode'`` runs the snapped int
    recurrence, its guard shift from the full cache extent T."""
    if q.shape[1] != 1:
        raise ValueError(
            f"flash_decode is the s_q=1 decode kernel; got s_q={q.shape[1]}")
    if softmax_impl not in ("float", "dualmode"):
        raise ValueError(f"flash_decode_pallas softmax_impl={softmax_impl!r}"
                         ": expected 'float' or 'dualmode'")
    b, _, kh, _, h = q.shape
    t = k.shape[1]
    int_mode = softmax_impl == "dualmode"
    num_splits, tile = dense_decode_tiles(t, b * kh, q.device,
                                          num_splits=num_splits)
    num_splits = max(1, num_splits)
    block_kv = tile if block_kv is None else block_kv
    scale = (1.0 / h ** 0.5) if scale is None else scale
    qf = (q.to(torch.float32) * scale)[:, 0].contiguous()
    parts = decode_dense_partials(
        qf, k.to(torch.float32).contiguous(), v.to(torch.float32).contiguous(),
        q_pos.reshape(b).to(torch.int32).contiguous(),
        kv_valid.to(torch.uint8).contiguous(), num_splits=num_splits,
        block_kv=block_kv, causal=causal, int_mode=int_mode,
        guard_shift=unit.guard_shift_for(t))
    return finish_partials(*parts, int_mode=int_mode).to(v.dtype)


def _int_impl(softmax_impl: str) -> str:
    # both int contracts run the snapped int recurrence: a snap request
    # never falls back to the float path
    return ("dualmode" if softmax_impl in ("dualmode", "dualmode_snap")
            else "float")


def _attention_entry(q, k, v, *, q_pos, kv_valid, causal, scale,
                     softmax_impl="float"):
    return flash_decode_pallas(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                               causal=causal, scale=scale,
                               softmax_impl=_int_impl(softmax_impl))


def _paged_attention_entry(q, k_pool, v_pool, *, block_tables, q_pos,
                           kv_valid, causal, scale, softmax_impl="float"):
    return flash_decode_paged(q, k_pool, v_pool, block_tables=block_tables,
                              q_pos=q_pos, kv_valid=kv_valid, causal=causal,
                              scale=scale,
                              softmax_impl=_int_impl(softmax_impl))


dispatch.register_attention("flash_decode", _attention_entry,
                            modes=("float", "dualmode", "dualmode_snap"),
                            grad=False)
dispatch.register_paged_attention("flash_decode", _paged_attention_entry)
