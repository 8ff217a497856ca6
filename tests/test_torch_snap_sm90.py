"""The tile policies and the int arithmetic of the one-sweep snapped int
flash's and the snapped int contiguous decode's Hopper bodies (rows 8 and
6, ``csrc/flash_snap_sm90.cuh`` on ``csrc/flash_fwd_sm90.cuh``, and
``csrc/decode_dense_sm90.cuh``), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).  Here a torch int32 emulation of each scheme is held to the
plain version (the reference's sweeps):

- row 8: per q tile of the plan's rows, the 64-key tiles up to the tile
  holding the tile's largest q_pos (causal) with the per-key mask; a
  lane a bucket -- lane tx holds bucket tx of its rows -- slid by one
  shuffle (S'[tx] = S[tx - k], zero where tx < k) and filled by shared
  atomics (a scatter-add of each key's word at its depth); p V in the
  plan's key groups summed at the end; the causal tail folded from the
  pre-pass's chunk-local V sums at the kernel's width; the partial;
- row 6: per split, the warps' key runs (whole steps of 16 keys at head
  dims up to 64, else 8), each with its own snapped state, merged at the
  end (the int words in any order, acc in warp order);
- row 4: row 6's scheme over a paged cache, the page as the tile, each
  step's keys resolved once through the block table to their pool rows.

Tolerances: m and S words bitwise; outputs, and accumulators over the
row's l, 1e-5 (f32 sums in another order); the identity-v probe bitwise.  q and k are grid-valued
(multiples of 2^-4), so every score is exact in any summation order and
the score words match the plain version's.  One case each also meets the
JAX reference's Pallas kernels in interpret mode.  Each case draws its
inputs from its own seeded ``np.random.RandomState``.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention_int import \
    flash_attention_pallas_int as j_fapi
from repro.kernels.flash_decode import flash_decode_pallas as j_fdp
from repro_torch.core import softmax_unit as unit
from repro_torch.core.fixedpoint import T_FRAC, quantize
from repro_torch.kernels import datapath as dp
from repro_torch.kernels import flash_attention_int as fai
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import tiling
from torch_paged_cases import PAGED, kv_rows, paged_case

NB = unit.N_SNAP_BUCKETS
TOL = 1e-5
cdiv = tiling.cdiv
I32 = torch.int32


# ---------------- (a) the decode tiles ----------------

@pytest.mark.parametrize("t,rows,want_gpu,want_cpu", [
    # the long-context tick (B4 K16) and the vision cross / self ticks
    # (B4 K8): the plan's splits of 64-key tiles on the card, the
    # reference's rule (2048 keys a split, 128-key tiles) on the CPU
    (16384, 64, (17, 64), (8, 128)),
    (1601, 32, (7, 64), (1, 128)),
    (4096, 32, (16, 64), (2, 128)),
])
def test_contiguous_decode_tiles_float_and_int(t, rows, want_gpu, want_cpu):
    """Both contiguous decodes take tiling.decode_dense_plan's (splits,
    tile) on a GPU; the plain version on the CPU keeps the reference's
    rule, so CPU parity with the JAX package does not move."""
    with mock.patch.object(tiling, "sm_count", lambda dev: 132):
        assert fd.dense_decode_tiles(t, rows, torch.device("cuda")) == \
            want_gpu
    assert fd.dense_decode_tiles(t, rows, torch.device("cpu")) == want_cpu


# ---------------- (b) row 8: the snapped flash's scheme, emulated -------------

def lane_slide(S, k):
    """S'[..., tx] = S[..., tx - k] (the shuffle from lane tx - k), zero
    where tx < k; k (...,) int32."""
    tx = torch.arange(NB, dtype=I32)
    src = tx - k[..., None]
    take = torch.gather(S, -1, torch.clamp(src, 0, NB - 1).long())
    return torch.where(src >= 0, take, torch.zeros_like(take))


def bucket_fill(p, d):
    """A tile's words by depth, (R, 16): atomicAdd(tile[row][d], p) a key
    whose word is nonzero and whose depth is a bucket's."""
    out = torch.zeros(p.shape[0], NB + 1, dtype=I32)
    keep = (p != 0) & (d < NB)
    return out.scatter_add_(1, torch.where(keep, d, NB).long(),
                            torch.where(keep, p, 0))[:, :NB]


def emulate_flash_snap(qf, k, v, q_pos, kv_valid, *, causal, guard_shift,
                       bq, bk=64, chunk=16, groups=2):
    """(acc, m, S) and out as the kernel computes them, rows flattened r =
    s G + g; ``groups`` key groups of the p V product."""
    b, s, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    rows = s * g
    qr = qf.permute(0, 2, 1, 3, 4).reshape(b, kh, rows, h)
    qp = q_pos.repeat_interleave(g, dim=1).long()
    n_kt = cdiv(t, bk)
    vt = v.permute(0, 2, 1, 3)
    vsum = torch.zeros(b, kh, n_kt, hv)
    for c0 in range(0, n_kt, chunk):
        run = torch.zeros(b, kh, hv)
        for j in reversed(range(c0, min(n_kt, c0 + chunk))):
            run = run + vt[:, :, j * bk:(j + 1) * bk].sum(dim=2)
            vsum[:, :, j] = run
    tm = unit.to_snap_domain(quantize(torch.tensor([dp.MASK_VALUE])))[0]
    acc_o = torch.zeros(b, kh, rows, hv)
    m_o = torch.zeros(b, kh, rows, dtype=I32)
    S_o = torch.zeros(b, kh, rows, NB, dtype=I32)
    for bi in range(b):
        for hd in range(kh):
            for r0 in range(0, rows, bq):
                rs = slice(r0, min(rows, r0 + bq))
                q, qpr = qr[bi, hd, rs], qp[bi, rs]
                nr = q.shape[0]
                n_tiles = n_kt
                if causal:
                    top = int(qpr.max())
                    n_tiles = 0 if top < 0 else min(n_kt, top // bk + 1)
                m = torch.full((nr,), unit.SNAP_MIN, dtype=I32)
                S = torch.zeros(nr, NB, dtype=I32)
                accs = [torch.zeros(nr, hv) for _ in range(groups)]
                for jt in range(n_tiles):
                    keys = jt * bk + torch.arange(bk)
                    here = keys < t
                    kb, vb = torch.zeros(bk, h), torch.zeros(bk, hv)
                    kb[here] = k[bi, keys[here], hd]
                    vb[here] = v[bi, keys[here], hd]
                    valid = torch.zeros(bk, dtype=torch.bool)
                    valid[here] = kv_valid[bi, keys[here]] != 0
                    live = valid[None, :].expand(nr, bk)
                    if causal:
                        live = live & (keys[None, :] <= qpr[:, None])
                    sc = torch.where(live, q @ kb.T,
                                     torch.full((), dp.MASK_VALUE))
                    tw = torch.where(here[None, :],
                                     unit.to_snap_domain(quantize(sc)),
                                     torch.full((), unit.SNAP_MIN, dtype=I32))
                    m_new = torch.maximum(m, unit.snap_max_int(tw.amax(1)))
                    kc = (m_new - m) >> T_FRAC
                    p = unit.snap_prob_word(tw, guard_shift)
                    d = (m_new >> T_FRAC)[:, None] - (tw >> T_FRAC)
                    num = p.to(torch.float32) * unit.snap_scale_f32(d)
                    S = lane_slide(S, kc) + bucket_fill(p, d)
                    m = m_new
                    half = bk // groups
                    corr = unit.snap_scale_f32(kc)[:, None]
                    for gi in range(groups):
                        ks = slice(gi * half, (gi + 1) * half)
                        accs[gi] = accs[gi] * corr + num[:, ks] @ vb[ks]
                n_tail = t - n_tiles * bk if causal else 0
                if n_tail > 0:
                    tail = vsum[bi, hd, n_tiles].clone()
                    for c0 in range((n_tiles // chunk + 1) * chunk, n_kt,
                                    chunk):
                        tail = tail + vsum[bi, hd, c0]
                    m_new = torch.maximum(m, unit.snap_max_int(tm))
                    kc = (m_new - m) >> T_FRAC
                    p = unit.snap_prob_word(tm, guard_shift)
                    d = (m_new >> T_FRAC) - (tm >> T_FRAC)
                    lane = torch.arange(NB, dtype=I32)[None, :]
                    S = lane_slide(S, kc) + torch.where(
                        lane == d[:, None], n_tail * p, 0).to(I32)
                    m = m_new
                    corr = unit.snap_scale_f32(kc)[:, None]
                    num = p.to(torch.float32) * unit.snap_scale_f32(d)
                    accs = [a * corr for a in accs]
                    accs[0] = accs[0] + num[:, None] * tail[None, :]
                acc = accs[0]
                for a in accs[1:]:
                    acc = acc + a
                acc_o[bi, hd, rs], m_o[bi, hd, rs], S_o[bi, hd, rs] = (
                    acc, m, S)

    def per_row(x):        # (B, K, S G, ...) -> (B, K, G, S, ...)
        return x.reshape(b, kh, s, g, *x.shape[3:]).transpose(2, 3)
    l = unit.online_finish_int(S_o).to(torch.float32)
    out = (acc_o / l[..., None]).reshape(b, kh, s, g, hv).permute(
        0, 2, 1, 3, 4)
    acc = acc_o.reshape(b, kh, s, g, hv).permute(0, 2, 1, 3, 4)
    return (acc.contiguous(), per_row(m_o), per_row(S_o)), out.contiguous()


def _attn_case(seed, b, s, t, kh, g, h, hv, kind, end=None):
    """Grid-valued q (pre-scaled) and k: every score exact."""
    rs = np.random.RandomState(seed)
    q = np.round(rs.randn(b, s, kh, g, h) * 4) / 16 * h ** -0.5
    k = np.round(rs.randn(b, t, kh, h) * 4) / 16
    v = rs.randn(b, t, kh, hv)
    end = t if end is None else end
    qp = np.broadcast_to(np.arange(end - s, end, dtype=np.int32),
                         (b, s)).copy()
    valid = np.ones((b, t), np.uint8)
    if kind in ("ragged", "all_masked", "negative"):
        valid = (rs.rand(b, t) > 0.25).astype(np.uint8)
    if kind == "all_masked":    # row 0 sees only key 0, which is invalid
        valid[:, 0] = 0
    if kind == "negative":      # rows before the cache: every key masked
        qp = qp - 3
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(k.astype(np.float32)),
            torch.from_numpy(v.astype(np.float32)), torch.from_numpy(qp),
            torch.from_numpy(valid))


def _close(got, want, tol=TOL):
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


# (b, s, t, kh, g, h, hv, causal, block_kv, inputs, q_pos end): the edge
# shapes chip_smoke.py holds the kernel to, at these sizes
SNAP = [
    (1, 127, 127, 2, 1, 64, 64, True, 64, "plain", None),     # S G off 128
    (1, 43, 257, 2, 3, 64, 64, True, 64, "ragged", None),     # S G 129
    (2, 70, 200, 2, 2, 64, 64, True, 16, "ragged", None),     # S != T
    (1, 33, 129, 3, 4, 128, 72, True, 16, "ragged", None),    # G 4, h 128
    (2, 64, 100, 1, 3, 32, 32, False, 37, "ragged", None),    # not causal
    (2, 40, 300, 2, 2, 64, 64, True, 64, "all_masked", 40),   # all masked
    (1, 40, 1300, 1, 2, 64, 64, True, 64, "all_masked", 40),  # tail chunks
    (1, 20, 1100, 2, 1, 128, 128, True, 16, "negative", 20),  # q_pos < 0
    (1, 67, 401, 2, 4, 128, 128, False, 64, "plain", None),   # S G off 64
    (1, 50, 90, 2, 3, 30, 62, True, 37, "ragged", None),      # 4-byte copies
]


@pytest.mark.parametrize("gs", [0, 9])
@pytest.mark.parametrize("shape", SNAP)
def test_flash_snap_emulated_scheme_vs_plain(shape, gs):
    """The kernel's scheme at row 7's tiles (the plan it takes) against the
    plain full sweep over the caller's block_kv tiles, at guard shifts 0
    and 9: the partial's m and S words bitwise, its acc over the row's l
    and the output within 1e-5."""
    b, s, t, kh, g, h, hv, causal, bkv, kind, end = shape
    args = _attn_case(41, b, s, t, kh, g, h, hv, kind, end)
    plan = tiling.flash_fwd_plan(h, hv, causal=causal)
    groups = 2 if max(h, hv) <= 64 else 1
    part, out = emulate_flash_snap(*args, causal=causal, guard_shift=gs,
                                   bq=plan.block_q, bk=plan.block_kv,
                                   groups=groups)
    kw = dict(causal=causal, block_kv=bkv, guard_shift=gs)
    want = fai.flash_snap_plain(*args, return_partial=True, **kw)
    assert torch.equal(part[1], want[1]) and torch.equal(part[2], want[2])
    l = unit.online_finish_int(want[2]).to(torch.float32)
    l = l.permute(0, 3, 1, 2)[..., None]                  # (B, S, K, G, 1)
    _close(part[0] / l, want[0] / l)
    _close(out, fai.flash_snap_plain(*args, **kw))


@pytest.mark.parametrize("bq,groups", [(128, 2), (64, 1)])
@pytest.mark.parametrize("causal,bkv", [(True, 64), (True, 16), (False, 64)])
def test_flash_snap_emulated_identity_v_bitwise(causal, bkv, bq, groups):
    """V the identity: every output is one p 2^-d / l word, bitwise the
    plain version's through the folded tail and the group sums, at both of
    row 7's tile shapes (h up to 64: 128 rows, two key groups; h 128: 64
    rows, one)."""
    qf, k, _, qp, valid = _attn_case(42, 2, 40, 128, 2, 2, 64, 64, "ragged")
    eye = torch.eye(128)[None, :, None, :].expand(2, 128, 2, 128)
    eye = eye.contiguous()
    _, out = emulate_flash_snap(qf, k, eye, qp, valid, causal=causal,
                                guard_shift=0, bq=bq, groups=groups)
    assert torch.equal(out, fai.flash_snap_plain(
        qf, k, eye, qp, valid, causal=causal, block_kv=bkv, guard_shift=0))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_snap_emulated_guard_shift_70000_keys(causal):
    """The guard shift from the full extent (1 at 70000 keys), the causal
    tail over many pre-pass chunks; reduced width."""
    args = _attn_case(43, 1, 16, 70000, 1, 1, 8, 8, "ragged", end=70000)
    gs = unit.guard_shift_for(70000)
    assert gs == 1
    part, out = emulate_flash_snap(*args, causal=causal, guard_shift=gs,
                                   bq=128)
    kw = dict(causal=causal, block_kv=64, guard_shift=gs)
    want = fai.flash_snap_plain(*args, return_partial=True, **kw)
    assert torch.equal(part[1], want[1]) and torch.equal(part[2], want[2])
    _close(out, fai.flash_snap_plain(*args, **kw))


def test_atomic_bucket_fill_is_depth_buckets():
    """The atomic fill equals the reference's per-depth sums on random words
    and depths, depths past the last bucket included."""
    rs = np.random.RandomState(44)
    p = torch.from_numpy(rs.randint(0, 1 << 14, size=(37, 64))).to(I32)
    d = torch.from_numpy(rs.randint(0, 20, size=(37, 64))).to(I32)
    p[:, ::7] = 0
    want = unit.depth_buckets(p, d, -1)
    assert torch.equal(bucket_fill(p, d), want)


def test_lane_slide_is_the_bucket_slide():
    rs = np.random.RandomState(45)
    S = torch.from_numpy(rs.randint(0, 1 << 20, size=(40, NB))).to(I32)
    k = torch.from_numpy(rs.randint(0, 40, size=(40,))).to(I32)
    assert torch.equal(lane_slide(S, k),
                       unit.slide_buckets_int(S, k[:, None]))


def test_flash_snap_emulated_vs_pallas_interpret():
    """The scheme against the reference's Pallas kernel (interpret mode)."""
    qf, k, v, qp, valid = _attn_case(46, 1, 12, 150, 2, 2, 8, 8, "ragged")
    h = qf.shape[-1]
    want = j_fapi(jnp.asarray(qf.numpy() * h ** 0.5), jnp.asarray(k.numpy()),
                  jnp.asarray(v.numpy()), q_pos=jnp.asarray(qp.numpy()),
                  kv_valid=jnp.asarray(valid.numpy().astype(bool)),
                  block_q=8, block_kv=128, guard_shift=0, interpret=True)
    _, out = emulate_flash_snap(qf, k, v, qp, valid, causal=True,
                                guard_shift=0, bq=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL)


# ---------------- (c) row 6: the snapped decode's scheme, emulated ------------

def emulate_decode_dense_int(qf, k, v, q_pos, kv_valid, *, num_splits,
                             block_kv, causal, guard_shift, warps=4,
                             tables=None):
    """The per-split partials (m, S, acc) as the kernel computes them: the
    split's keys cut into ``warps`` runs of whole steps (16 keys at head
    dims up to 64, else 8), each run its own snapped state, merged at the
    end (the words exactly, acc in warp order).  With ``tables`` k and v
    are the pools and the tile is the page (block_kv = bs)."""
    b, kh, g, h = qf.shape
    t = k.shape[1] if tables is None else tables.shape[1] * k.shape[1]
    hv = v.shape[-1]
    step = 16 if max(h, hv) <= 64 else 8
    nblk = cdiv(t, block_kv)
    part_m = torch.zeros(b, num_splits, kh, g, dtype=I32)
    part_S = torch.zeros(b, num_splits, kh, g, NB, dtype=I32)
    part_acc = torch.zeros(b, num_splits, kh, g, hv)
    for bi in range(b):
        qp = int(q_pos[bi])
        live = nblk if not causal else 0 if qp < 0 else min(
            nblk, qp // block_kv + 1)
        inner = cdiv(live, num_splits)
        for sp in range(num_splits):
            tile0 = min(sp * inner, live)
            tile1 = min(tile0 + inner, live)
            k0, k1 = tile0 * block_kv, min(tile1 * block_kv, t)
            run = cdiv(cdiv(k1 - k0, warps), step) * step
            states = []
            for w in range(warps):
                r0 = min(k0 + w * run, k1)
                r1 = min(r0 + run, k1)
                m = torch.full((kh, g), unit.SNAP_MIN, dtype=I32)
                S = torch.zeros(kh, g, NB, dtype=I32)
                acc = torch.zeros(kh, g, hv)
                for key0 in range(r0, r1, step):
                    keys = torch.arange(key0, min(key0 + step, r1))
                    kr, vr = kv_rows(k, v, tables, bi, keys)
                    sc = torch.einsum("kgh,nkh->kgn", qf[bi], kr)
                    live_k = kv_valid[bi, keys] != 0
                    if causal:
                        live_k = live_k & (keys <= qp)
                    sc = torch.where(live_k, sc,
                                     torch.full((), dp.MASK_VALUE))
                    tw = unit.to_snap_domain(quantize(sc))
                    m_new = torch.maximum(m, unit.snap_max_int(tw.amax(-1)))
                    kc = (m_new - m) >> T_FRAC
                    p = unit.snap_prob_word(tw, guard_shift)
                    d = (m_new >> T_FRAC)[..., None] - (tw >> T_FRAC)
                    S = lane_slide(S, kc) + unit.depth_buckets(p, d, -1)
                    num = p.to(torch.float32) * unit.snap_scale_f32(d)
                    acc = acc * unit.snap_scale_f32(kc)[..., None] + \
                        torch.einsum("kgn,nkv->kgv", num, vr)
                    m = m_new
                states.append((m, S, acc))
            m_all = torch.stack([x[0] for x in states]).amax(dim=0)
            S_all = torch.zeros(kh, g, NB, dtype=I32)
            acc_all = torch.zeros(kh, g, hv)
            for m_w, S_w, acc_w in states:
                kc = (m_all - m_w) >> T_FRAC
                S_all = S_all + lane_slide(S_w, kc)
                acc_all = acc_all + acc_w * unit.snap_scale_f32(kc)[..., None]
            part_m[bi, sp], part_S[bi, sp] = m_all, S_all
            part_acc[bi, sp] = acc_all
    return part_m, part_S, part_acc


def _dec_case(seed, b, t, kh, g, h, hv, q_pos, ragged):
    rs = np.random.RandomState(seed)
    q = np.round(rs.randn(b, kh, g, h) * 4) / 16 * h ** -0.5
    k = np.round(rs.randn(b, t, kh, h) * 4) / 16
    v = rs.randn(b, t, kh, hv)
    valid = np.ones((b, t), np.uint8)
    if ragged:
        valid = (rs.rand(b, t) > 0.25).astype(np.uint8)
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(k.astype(np.float32)),
            torch.from_numpy(v.astype(np.float32)),
            torch.tensor(q_pos, dtype=I32), torch.from_numpy(valid))


# (b, t, kh, g, h, hv, q_pos, causal, num_splits, block_kv, ragged)
DECODE = [
    # the path's scheme at small scale: the plan's tile, many splits,
    # shallow slots leave splits with no tile
    (4, 600, 2, 1, 64, 64, [5, 127, 300, 599], True, 17, 64, False),
    # the old rule's 128-key tiles
    (4, 600, 2, 1, 64, 64, [5, 127, 300, 599], True, 3, 128, True),
    # the cross tick: G 4 at h 128, non-causal, the last tile ragged
    (2, 333, 2, 4, 128, 128, [0, 0], False, 7, 64, False),
    # hv != h, block_kv 16 and 37, 4-byte copies (h 30, hv 62), G 8
    (3, 257, 1, 2, 64, 32, [40, 200, 256], True, 5, 16, True),
    (2, 190, 3, 3, 30, 62, [100, 189], True, 4, 37, True),
    (2, 120, 2, 8, 128, 96, [70, 119], True, 2, 37, True),
    # q_pos < 0 (every split the identity) beside a live slot
    (2, 300, 2, 2, 64, 64, [-1, 40], True, 8, 64, True),
]


@pytest.mark.parametrize("shape", DECODE)
def test_decode_dense_int_emulated_scheme_vs_plain(shape):
    """The warps' runs and their merge against the plain version's
    tile-by-tile partials at the same (splits, tile): m and S bitwise, each
    split's acc over its l and the folded outputs within 1e-5."""
    b, t, kh, g, h, hv, q_pos, causal, ns, bkv, ragged = shape
    args = _dec_case(51, b, t, kh, g, h, hv, q_pos, ragged)
    kw = dict(num_splits=ns, block_kv=bkv, causal=causal,
              guard_shift=unit.guard_shift_for(t))
    got = emulate_decode_dense_int(*args, **kw)
    want = fd.decode_dense_partials_plain(*args, int_mode=True, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    l = unit.online_finish_int(want[1]).to(torch.float32)[..., None]
    _close(got[2] / l, want[2] / l)
    _close(fd.finish_partials(*got, int_mode=True),
           fd.finish_partials(*want, int_mode=True))


def test_decode_dense_int_emulated_vs_pallas_interpret():
    """The scheme at the GPU plan's 64-key tiles against the reference's
    Pallas kernel (interpret mode) at its own 128-key tiles: every masked
    key past q_pos sits at depth >= 16 here, so the words agree and the
    outputs differ only in f32 order (ROADMAP Queue 3, split-KV decode)."""
    b, t, kh, g, h = 2, 700, 2, 2, 16
    qf, k, v, qp, _ = _dec_case(52, b, t, kh, g, h, h, [300, 699], False)
    valid = (torch.arange(t)[None, :] <= qp[:, None]).to(torch.uint8)
    parts = emulate_decode_dense_int(qf, k, v, qp, valid, num_splits=3,
                                     block_kv=64, causal=True,
                                     guard_shift=unit.guard_shift_for(t))
    want = j_fdp(jnp.asarray(qf.numpy()[:, None] * h ** 0.5),
                 jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                 q_pos=jnp.asarray(qp.numpy()[:, None]),
                 kv_valid=jnp.asarray(valid.numpy().astype(bool)),
                 num_splits=2, interpret=True, softmax_impl="dualmode")
    np.testing.assert_allclose(
        fd.finish_partials(*parts, int_mode=True).numpy(), np.asarray(want),
        atol=TOL)


# ---------------- (d) row 4: the paged snapped decode's scheme, emulated -----

@pytest.mark.parametrize("shape", PAGED)
def test_decode_paged_int_emulated_scheme_vs_plain(shape):
    """Row 6's warps and merge through the paged address, the page as the
    tile, against the paged plain version at the same splits: m and S
    bitwise, each split's acc over its l and the folded outputs within
    1e-5."""
    b, kh, g, h, hv, bs, nblk, q_pos, causal, ns, tails = shape
    qf, kp, vp, tab, qp, valid = paged_case(53, b, kh, g, h, hv, bs, nblk,
                                            q_pos, tails, grid=True)
    kw = dict(num_splits=ns, causal=causal,
              guard_shift=unit.guard_shift_for(nblk * bs))
    got = emulate_decode_dense_int(qf, kp, vp, qp, valid, block_kv=bs,
                                   tables=tab, **kw)
    want = fd.decode_paged_partials_plain(qf, kp, vp, tab, qp, valid,
                                          int_mode=True, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    l = unit.online_finish_int(want[1]).to(torch.float32)[..., None]
    _close(got[2] / l, want[2] / l)
    _close(fd.finish_partials(*got, int_mode=True),
           fd.finish_partials(*want, int_mode=True))
