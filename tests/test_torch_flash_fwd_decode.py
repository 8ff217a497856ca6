"""The tile policies and the arithmetic of the float flash forward's and the
float contiguous decode's Hopper bodies (rows 7 and 5,
``csrc/flash_fwd_sm90.cuh`` and ``csrc/decode_dense_sm90.cuh``), on the
CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).  Here a torch emulation of each scheme is held to the
plain version (the reference's sweeps):

- row 7: per q tile of the plan's rows, the 64-key tiles up to the tile
  holding the tile's largest q_pos (causal) with the per-key mask, the p V
  product in two key halves summed at the end, and the causal tail folded
  from the pre-pass's chunk-local V sums at the kernel's width; the (m, l)
  statistics;
- row 5: per split, the warps' key runs (multiples of the step's keys),
  each with its own online state, merged in warp order into the split's
  partial;
- row 3: row 5's scheme over a paged cache, the page as the tile, each
  step's keys resolved once through the block table to their pool rows.

Tolerance: 1e-5, the limit the kernels are held to on the card (f32 sums
in another order); l as l / plain l.  (The plain versions meet the
reference's oracles and Pallas kernels in tests/test_torch_flash.py.)  Each
case draws its inputs from its own seeded ``np.random.RandomState``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import datapath as dp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import tiling
from torch_paged_cases import PAGED, kv_rows, paged_case

TOL = 1e-5
cdiv = tiling.cdiv


# ---------------- (a) the plans ----------------

@pytest.mark.parametrize("h,hv,causal,aligned,want", [
    # head dims up to 64: 128 rows held, three stages; causal grids walk
    # their late (heaviest) q tiles first
    (64, 64, True, True, (128, 64, 3, 4, True)),
    (32, 48, False, True, (128, 64, 3, 4, False)),
    # past 64 (either dim): 64 rows, two stages
    (128, 128, False, True, (64, 64, 2, 4, False)),
    (128, 72, True, True, (64, 64, 2, 4, True)),
    (64, 128, True, True, (64, 64, 2, 4, True)),
    # 4-byte copies: a head dim or a pointer off 16 bytes, same tiles
    (30, 62, True, True, (128, 64, 3, 1, True)),
    (64, 64, True, False, (128, 64, 3, 1, True)),
    (128, 126, False, True, (64, 64, 2, 1, False)),
    # MLA's h past 128 against hv up to 128 (deepseek-v2-lite: 192 / 128):
    # 64 rows, one operand a stage through three
    (192, 128, True, True, (64, 64, 3, 4, True)),
    (132, 64, False, True, (64, 64, 3, 4, False)),
    (190, 126, True, True, (64, 64, 3, 1, True)),
    (192, 128, True, False, (64, 64, 3, 1, True)),
])
def test_flash_fwd_plan(h, hv, causal, aligned, want):
    plan = tiling.flash_fwd_plan(h, hv, causal=causal, aligned=aligned)
    assert tuple(plan) == want
    width = 64 if max(h, hv) <= 64 else 128 if h <= 128 else 192
    assert tiling.head_width(h, hv) == width
    assert (plan.block_q, plan.stages) == tiling.FLASH_FWD_TILES[width]


@pytest.mark.parametrize("h,hv", [(200, 128), (192, 136), (136, 136),
                                  (0, 64)])
def test_head_dims_past_the_instances_raise(h, hv):
    with pytest.raises(ValueError, match="head dims"):
        tiling.head_width(h, hv)
    with pytest.raises(ValueError, match="head dims"):
        tiling.flash_fwd_plan(h, hv, causal=True)
    assert not fa.head_dims_ok(h, hv, wide=True)


@pytest.mark.parametrize("h,hv,snap", [(64, 64, False), (128, 128, False),
                                       (192, 128, False), (64, 64, True),
                                       (128, 128, True), (192, 128, True)])
def test_flash_fwd_tile_fits_shared_memory(h, hv, snap):
    """Every class's tile fits a block's shared memory with row 8's
    buckets; in the 192 class two stages of K and V would not (235 520
    bytes), which is why its ring holds one operand a stage."""
    assert tiling.flash_fwd_smem(h, hv, snap=snap) <= tiling.SMEM_MAX_BYTES
    if h == 192:
        assert tiling.flash_fwd_smem(h, hv, snap=snap) == (
            222336 if snap else 218112)
        # Q, two stages of K [64][196] and V [64][132], the p tile
        two_kv_stages = 4 * (64 * 196 + 2 * 64 * (196 + 132) + 64 * 68)
        assert two_kv_stages == 235520 > tiling.SMEM_MAX_BYTES


@pytest.mark.parametrize("h,hv", [(64, 64), (128, 128), (192, 128),
                                  (96, 64)])
def test_decode_dense_blocks_fit_an_sm(h, hv):
    """Two blocks of the contiguous decodes fit an SM's shared memory in
    every width class, float and int."""
    for int_mode in (False, True):
        smem = tiling.decode_dense_smem(h, hv, int_mode)
        assert tiling.DECODE_DENSE_SLOTS * (
            smem + tiling.SMEM_BLOCK_RESERVED) <= tiling.SM_SMEM_BYTES
    assert tiling.decode_dense_smem(192, 128, True) == 99456


@pytest.mark.parametrize("t,rows,sms,want", [
    # the long-context path (B4 K16, a 16384-key cache): 4 x 2 x 132 blocks
    # asked for, past DECODE_MAX_SPLITS
    (16384, 64, 132, (17, 64)),
    # the vision cross tick (B4 K8, 1601 image keys): 256 keys a split
    (1601, 32, 132, (7, 64)),
    # the vision self tick (B4 K8, a 4096-key cache)
    (4096, 32, 132, (16, 64)),
    # a card with fewer SMs asks for fewer blocks
    (16384, 64, 114, (15, 64)),
    # deepseek-v2-lite's tick (B4 K16, a 2048-key cache): 256 keys a
    # split; the head dims do not enter the rule
    (2048, 64, 132, (8, 64)),
    # short caches: one split; many rows: one split
    (100, 4, 132, (1, 64)),
    (16384, 4096, 132, (1, 64)),
])
def test_decode_dense_plan(t, rows, sms, want):
    plan = tiling.decode_dense_plan(t, rows, sms=sms)
    assert tuple(plan) == want
    assert plan.splits <= cdiv(t, plan.block_kv)


@pytest.mark.parametrize("h,hv,aligned,want", [
    (64, 64, True, 4), (128, 96, True, 4), (192, 128, True, 4),
    (190, 126, True, 1), (192, 128, False, 1),
    # 4-byte copies: a head dim, or the K / V pointers, off 16 bytes
    (30, 62, True, 1), (64, 62, True, 1), (128, 128, False, 1),
])
def test_decode_dense_copy_width(h, hv, aligned, want):
    assert tiling.decode_dense_vec(h, hv, aligned) == want


def test_decode_tiles_on_cpu_keep_the_reference_rule():
    """The plain version on the CPU folds the reference's off-TPU split
    rule, float and int alike, so CPU parity with the JAX package does not
    move; the plan applies to the kernels on a GPU only."""
    cpu = torch.device("cpu")
    for t in (1601, 4096, 16384):
        ns = fd.dense_decode_splits(t, 64, cpu)
        assert fd.dense_decode_tiles(t, 64, cpu) == (
            ns, tiling.decode_kv_block(t, ns))
        assert fd.dense_decode_tiles(t, 64, cpu, num_splits=3) == (
            3, tiling.decode_kv_block(t, 3))


# ---------------- (b) row 7: the forward's scheme, emulated ----------------

def emulate_flash_fwd(qf, k, v, q_pos, kv_valid, *, causal, bq, bk=64,
                      chunk=16, groups=2):
    """(out, m, l) as the kernel computes them, rows flattened r = s G + g;
    ``groups`` key groups of the p V product (2 at head dims up to 64)."""
    b, s, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    rows = s * g
    qr = qf.permute(0, 2, 1, 3, 4).reshape(b, kh, rows, h)
    qp = q_pos.repeat_interleave(g, dim=1).long()
    n_kt = cdiv(t, bk)
    # the pre-pass: each tile's sum of V to the end of its chunk, tiles
    # walked from the last
    vt = v.permute(0, 2, 1, 3)
    vsum = torch.zeros(b, kh, n_kt, hv)
    for c0 in range(0, n_kt, chunk):
        run = torch.zeros(b, kh, hv)
        for j in reversed(range(c0, min(n_kt, c0 + chunk))):
            run = run + vt[:, :, j * bk:(j + 1) * bk].sum(dim=2)
            vsum[:, :, j] = run
    out = torch.zeros(b, kh, rows, hv)
    m_out, l_out = torch.zeros(b, kh, rows), torch.zeros(b, kh, rows)
    for bi in range(b):
        for hd in range(kh):
            for r0 in range(0, rows, bq):
                rs = slice(r0, min(rows, r0 + bq))
                q, qpr = qr[bi, hd, rs], qp[bi, rs]
                n_tiles = n_kt
                if causal:
                    top = int(qpr.max())
                    n_tiles = 0 if top < 0 else min(n_kt, top // bk + 1)
                m = torch.full((q.shape[0],), dp.MASK_VALUE)
                l = torch.zeros(q.shape[0])
                accs = [torch.zeros(q.shape[0], hv) for _ in range(groups)]
                for jt in range(n_tiles):
                    keys = jt * bk + torch.arange(bk)
                    here = keys < t
                    kb, vb = torch.zeros(bk, h), torch.zeros(bk, hv)
                    kb[here] = k[bi, keys[here], hd]
                    vb[here] = v[bi, keys[here], hd]
                    valid = torch.zeros(bk, dtype=torch.bool)
                    valid[here] = kv_valid[bi, keys[here]] != 0
                    live = valid[None, :].expand(q.shape[0], bk)
                    if causal:
                        live = live & (keys[None, :] <= qpr[:, None])
                    sc = torch.where(live, q @ kb.T,
                                     torch.full((), dp.MASK_VALUE))
                    sc = torch.where(here[None, :], sc,
                                     torch.full((), -torch.inf))
                    m_new = torch.maximum(m, sc.amax(dim=1))
                    corr = torch.exp2((m - m_new) * dp.LOG2E)
                    p = torch.exp2((sc - m_new[:, None]) * dp.LOG2E)
                    l = l * corr + p.sum(dim=1)
                    m = m_new
                    half = bk // groups
                    for gi in range(groups):
                        ks = slice(gi * half, (gi + 1) * half)
                        accs[gi] = accs[gi] * corr[:, None] + p[:, ks] @ vb[ks]
                n_tail = t - n_tiles * bk if causal else 0
                if n_tail > 0:
                    tail = vsum[bi, hd, n_tiles].clone()
                    for c0 in range((n_tiles // chunk + 1) * chunk, n_kt,
                                    chunk):
                        tail = tail + vsum[bi, hd, c0]
                    m_new = torch.clamp(m, min=dp.MASK_VALUE)
                    p = torch.exp2((dp.MASK_VALUE - m_new) * dp.LOG2E)
                    corr = torch.exp2((m - m_new) * dp.LOG2E)
                    l = l * corr + n_tail * p
                    m = m_new
                    accs = [a * corr[:, None] for a in accs]
                    accs[0] = accs[0] + p[:, None] * tail[None, :]
                acc = accs[0]
                for a in accs[1:]:
                    acc = acc + a
                out[bi, hd, rs] = acc / torch.clamp(l, min=1e-30)[:, None]
                m_out[bi, hd, rs], l_out[bi, hd, rs] = m, l

    def stat(x):
        return x.reshape(b, kh, s, g).permute(0, 1, 3, 2)
    out = out.reshape(b, kh, s, g, hv).permute(0, 2, 1, 3, 4)
    return out, stat(m_out), stat(l_out)


def _attn_case(seed, b, s, t, kh, g, h, hv, kind, end=None):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, s, kh, g, h) * h ** -0.5).astype(np.float32)
    k = rs.randn(b, t, kh, h).astype(np.float32)
    v = rs.randn(b, t, kh, hv).astype(np.float32)
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
    return tuple(torch.from_numpy(x) for x in (q, k, v, qp, valid)), (
        q, k, v, qp, valid)


def _close(got, want, tol=TOL):
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


# (b, s, t, kh, g, h, hv, causal, block_kv, inputs, q_pos end): several q
# tiles and kernel tiles, so causal blocks stop early and fold the tail
FWD = [
    (1, 300, 300, 2, 1, 64, 64, True, 64, "plain", None),     # S = T
    (2, 70, 200, 2, 2, 64, 64, True, 64, "ragged", None),     # S != T, G 2
    (1, 33, 129, 3, 4, 128, 72, True, 16, "ragged", None),    # G 4, hv != h
    (2, 64, 100, 1, 3, 32, 32, False, 37, "ragged", None),    # not causal
    (2, 40, 300, 2, 2, 64, 64, True, 64, "all_masked", 40),   # all masked
    (1, 50, 90, 2, 3, 30, 62, True, 64, "ragged", None),      # 4-byte copies
    (1, 130, 1200, 1, 1, 64, 64, True, 64, "plain", 130),     # long tail
    (1, 20, 70, 2, 2, 64, 64, True, 16, "negative", 20),      # q_pos < 0
    # the tail carries all of a row's mass past one pre-pass chunk
    (1, 40, 1300, 1, 2, 64, 64, True, 64, "all_masked", 40),
    (1, 20, 1100, 2, 1, 128, 128, True, 64, "negative", 20),
    (1, 67, 1601, 2, 4, 128, 128, False, 64, "plain", None),  # cross edge
    # MLA's h 192 / hv 128 (deepseek-v2-lite): a ragged last tile with key
    # 0 masked, a chunk at the end of a table, G 2, not causal
    (1, 100, 100, 2, 1, 192, 128, True, 64, "all_masked", None),
    (1, 30, 300, 2, 1, 192, 128, True, 64, "ragged", None),
    (1, 33, 129, 1, 2, 192, 128, True, 16, "ragged", None),
    (1, 40, 90, 1, 1, 190, 126, False, 37, "plain", None),
]


@pytest.mark.parametrize("tiles", ["plan", "small"])
@pytest.mark.parametrize("shape", FWD)
def test_flash_fwd_emulated_scheme_vs_plain(shape, tiles):
    """The kernel's scheme at the plan's tiles (and at small tiles and
    chunks, many of them at these sizes) against the plain full sweep over
    the caller's block_kv tiles: out, m and l / plain l."""
    b, s, t, kh, g, h, hv, causal, bkv, kind, end = shape
    args, _ = _attn_case(21, b, s, t, kh, g, h, hv, kind, end)
    plan = tiling.flash_fwd_plan(h, hv, causal=causal)
    groups = 2 if max(h, hv) <= 64 else 1
    tw = dict(bq=plan.block_q, bk=plan.block_kv, chunk=16, groups=groups) \
        if tiles == "plan" else dict(bq=8, bk=16, chunk=2, groups=2)
    got = emulate_flash_fwd(*args, causal=causal, **tw)
    want = fa.flash_fwd_plain(*args, causal=causal, block_kv=bkv,
                              return_stats=True)
    _close(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2] / want[2], torch.ones_like(want[2]))


def test_flash_fwd_wrapper_on_cpu_is_the_plain_version():
    args, _ = _attn_case(22, 1, 40, 90, 1, 2, 64, 64, "ragged")
    for causal in (True, False):
        kw = dict(causal=causal, block_kv=37)
        for got, want in zip(fa.flash_fwd(*args, return_stats=True, **kw),
                             fa.flash_fwd_plain(*args, return_stats=True,
                                                **kw)):
            assert torch.equal(got, want)


# ---------------- (c) row 5: the decode's scheme, emulated ----------------

def emulate_decode_dense(qf, k, v, q_pos, kv_valid, *, num_splits, block_kv,
                         causal, warps=4, tables=None):
    """The per-split partials (m, l, acc) as the kernel computes them: the
    split's keys cut into ``warps`` runs of whole steps (16 keys at head
    dims up to 64, else 8, the 192 class's too), each run its own online
    state, the states
    merged in warp order.  With ``tables`` k and v are the pools and the
    tile is the page (block_kv = bs)."""
    b, kh, g, h = qf.shape
    t = k.shape[1] if tables is None else tables.shape[1] * k.shape[1]
    hv = v.shape[-1]
    step = 16 if max(h, hv) <= 64 else 8
    nblk = cdiv(t, block_kv)
    part_m = torch.zeros(b, num_splits, kh, g)
    part_l = torch.zeros(b, num_splits, kh, g)
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
                m = torch.full((kh, g), dp.MASK_VALUE)
                l = torch.zeros(kh, g)
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
                    m_new = torch.maximum(m, sc.amax(dim=-1))
                    corr = torch.exp2((m - m_new) * dp.LOG2E)
                    p = torch.exp2((sc - m_new[..., None]) * dp.LOG2E)
                    l = l * corr + p.sum(dim=-1)
                    acc = acc * corr[..., None] + torch.einsum(
                        "kgn,nkv->kgv", p, vr)
                    m = m_new
                states.append((m, l, acc))
            m_all = torch.stack([x[0] for x in states]).amax(dim=0)
            l_all, acc_all = torch.zeros(kh, g), torch.zeros(kh, g, hv)
            for m_w, l_w, acc_w in states:
                sc = torch.exp2((m_w - m_all) * dp.LOG2E)
                l_all = l_all + l_w * sc
                acc_all = acc_all + acc_w * sc[..., None]
            part_m[bi, sp], part_l[bi, sp] = m_all, l_all
            part_acc[bi, sp] = acc_all
    return part_m, part_l, part_acc


def _dec_case(seed, b, t, kh, g, h, hv, q_pos, ragged):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, kh, g, h) * h ** -0.5).astype(np.float32)
    k = rs.randn(b, t, kh, h).astype(np.float32)
    v = rs.randn(b, t, kh, hv).astype(np.float32)
    qp = np.asarray(q_pos, np.int32)
    valid = np.ones((b, t), np.uint8)
    if ragged:
        valid = (rs.rand(b, t) > 0.25).astype(np.uint8)
    return tuple(torch.from_numpy(x) for x in (q, k, v, qp, valid)), (
        q, k, v, qp, valid)


# (b, t, kh, g, h, hv, q_pos, causal, num_splits, block_kv, ragged)
DECODE = [
    # the path's scheme at small scale: the plan's tile, many splits,
    # shallow slots leave splits with no tile
    (4, 600, 2, 1, 64, 64, [5, 127, 300, 599], True, 17, 64, False),
    (4, 600, 2, 1, 64, 64, [5, 127, 300, 599], True, 3, 128, True),
    # the cross tick: G 4 at h 128, non-causal, the last tile ragged
    (2, 333, 2, 4, 128, 128, [0, 0], False, 7, 64, False),
    (2, 333, 2, 4, 128, 128, [0, 0], False, 1, 128, True),
    # hv != h, block_kv 16 and 37, 4-byte copies (h 30, hv 62)
    (3, 257, 1, 2, 64, 32, [40, 200, 256], True, 5, 16, True),
    (2, 190, 3, 3, 30, 62, [100, 189], True, 4, 37, True),
    (2, 120, 2, 8, 128, 96, [70, 119], True, 2, 37, True),
    # deepseek-v2-lite's tick at h 192 / hv 128: 4 lanes a key, 8 keys a
    # step; G 2, and 4-byte copies at 190 / 126
    (4, 300, 2, 1, 192, 128, [20, 100, 250, 299], True, 5, 64, False),
    (2, 200, 1, 2, 192, 128, [60, 199], True, 3, 64, True),
    (2, 130, 1, 1, 190, 126, [129, 77], True, 2, 37, True),
    # q_pos < 0 (every split the identity) beside a live slot; more splits
    # than the live range has tiles
    (2, 300, 2, 2, 64, 64, [-1, 40], True, 8, 64, True),
]


@pytest.mark.parametrize("shape", DECODE)
def test_decode_dense_emulated_scheme_vs_plain(shape):
    """The warps' runs and their fixed-order merge against the plain
    version's tile-by-tile partials: each partial (m; l and acc relative to
    the plain's scale), and the folded outputs at 1e-5."""
    b, t, kh, g, h, hv, q_pos, causal, ns, bkv, ragged = shape
    args, _ = _dec_case(31, b, t, kh, g, h, hv, q_pos, ragged)
    kw = dict(num_splits=ns, block_kv=bkv, causal=causal)
    got = emulate_decode_dense(*args, **kw)
    want = fd.decode_dense_partials_plain(*args, int_mode=False,
                                          guard_shift=0, **kw)
    _close(got[0], want[0])
    empty = want[1] == 0            # splits with no key: the identity
    assert torch.equal(got[1] == 0, empty)
    assert torch.all(got[0][empty] == dp.MASK_VALUE)
    _close(torch.where(empty, 1.0, got[1] / want[1]),
           torch.ones_like(want[1]))
    _close(got[2] / torch.clamp(want[1], min=1e-30)[..., None],
           want[2] / torch.clamp(want[1], min=1e-30)[..., None])
    _close(fd.finish_partials(*got, int_mode=False),
           fd.finish_partials(*want, int_mode=False))


def test_decode_dense_wrapper_on_cpu_is_the_plain_version():
    args, _ = _dec_case(32, 2, 300, 2, 2, 64, 64, [10, 299], True)
    kw = dict(num_splits=4, block_kv=64, causal=True, guard_shift=0)
    for int_mode in (False, True):
        for got, want in zip(
                fd.decode_dense_partials(*args, int_mode=int_mode, **kw),
                fd.decode_dense_partials_plain(*args, int_mode=int_mode,
                                               **kw)):
            assert torch.equal(got, want)


# ---------------- (d) row 3: the paged decode's scheme, emulated -------------

@pytest.mark.parametrize("shape", PAGED)
def test_decode_paged_emulated_scheme_vs_plain(shape):
    """Row 5's warps and merge through the paged address, the page as the
    tile, against the paged plain version at the same splits: each
    partial's m, l and acc relative to the plain's scale, and the folded
    outputs, within 1e-5."""
    b, kh, g, h, hv, bs, nblk, q_pos, causal, ns, tails = shape
    qf, kp, vp, tab, qp, valid = paged_case(33, b, kh, g, h, hv, bs, nblk,
                                            q_pos, tails)
    got = emulate_decode_dense(qf, kp, vp, qp, valid, num_splits=ns,
                               block_kv=bs, causal=causal, tables=tab)
    want = fd.decode_paged_partials_plain(
        qf, kp, vp, tab, qp, valid, num_splits=ns, causal=causal,
        int_mode=False, guard_shift=0)
    _close(got[0], want[0])
    empty = want[1] == 0
    assert torch.equal(got[1] == 0, empty)
    _close(torch.where(empty, 1.0, got[1] / want[1]),
           torch.ones_like(want[1]))
    scale = torch.clamp(want[1], min=1e-30)[..., None]
    _close(got[2] / scale, want[2] / scale)
    _close(fd.finish_partials(*got, int_mode=False),
           fd.finish_partials(*want, int_mode=False))


# ---------------- (e) the head dims each kernel takes ----------------

def _meta_attn(b, s, t, kh, g, h, hv):
    meta = torch.device("meta")
    return (torch.empty(b, s, kh, g, h, device=meta),
            torch.empty(b, t, kh, h, device=meta),
            torch.empty(b, t, kh, hv, device=meta),
            torch.empty(b, s, dtype=torch.int32, device=meta),
            torch.empty(b, t, dtype=torch.uint8, device=meta))


def test_rows_past_their_head_dims_raise_before_a_launch():
    """Off the CPU (meta tensors here: no launch, no build) every wrapper
    refuses head dims its instances do not take with ValueError: rows 3 /
    4 (paged decode), 9 (three-sweep int) and 10 / 11 (flash backward)
    past 128, rows 5-8 past h 192 or hv 128 -- never the plain version."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import flash_attention_int as fai
    assert fa.head_dims_ok(192, 128, wide=True)
    assert not fa.head_dims_ok(192, 128, wide=False)
    assert not fa.head_dims_ok(129, 64, wide=False)
    qf, k, v, qp, valid = _meta_attn(1, 8, 70, 2, 1, 192, 128)
    with pytest.raises(ValueError, match="head dims"):
        fai.flash_int3(qf, k, v, qp, valid, causal=True, block_kv=64,
                       guard_shift=0)
    o = torch.empty(1, 8, 2, 1, 128, device="meta")
    m = torch.empty(1, 2, 1, 8, device="meta")
    for bwd in (fab.flash_bwd_dq, fab.flash_bwd_dkdv):
        with pytest.raises(ValueError, match="head dims"):
            bwd(qf, k, v, o, m, m, o, qp, valid, causal=True, block_kv=64)
    meta = torch.device("meta")
    pool = torch.empty(5, 16, 2, 192, device=meta)
    with pytest.raises(ValueError, match="head dims"):
        fd.decode_paged_partials(
            torch.empty(1, 2, 1, 192, device=meta), pool,
            torch.empty(5, 16, 2, 128, device=meta),
            torch.empty(1, 4, dtype=torch.int32, device=meta),
            torch.empty(1, dtype=torch.int32, device=meta),
            torch.empty(1, 64, dtype=torch.uint8, device=meta),
            num_splits=2, causal=True, int_mode=False, guard_shift=0)
    for h, hv in ((200, 128), (192, 136)):
        qf, k, v, qp, valid = _meta_attn(1, 8, 70, 2, 1, h, hv)
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_fwd(qf, k, v, qp, valid, causal=True, block_kv=64)
        with pytest.raises(ValueError, match="head dims"):
            fai.flash_snap(qf, k, v, qp, valid, causal=True, block_kv=64,
                           guard_shift=0)
        with pytest.raises(ValueError, match="head dims"):
            fd.decode_dense_partials(
                qf[:, 0], k, v, qp[:, 0], valid, num_splits=2, block_kv=64,
                causal=True, int_mode=False, guard_shift=0)
