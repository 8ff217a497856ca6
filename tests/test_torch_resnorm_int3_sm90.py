"""The plans and the schemes of the residual-norm epilogue's and the
three-sweep int flash's Hopper bodies (rows 14 and 9: ``csrc/resnorm.cu``,
and ``csrc/flash_int3_sm90.cuh`` on ``csrc/flash_fwd_sm90.cuh``), on the
CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).  Here a torch emulation of each scheme is held to the
plain version:

- row 14: the plan's row partition -- thread t of the RT threads that
  share a row holds chunk j of VEC floats at (j RT + t) VEC -- each
  thread's moments in j order, the xor butterfly of a warp, the block's
  warps in order; the sum bitwise, h
  within 1e-6 of ``fused_residual_norm_plain`` (f32 sums in another
  order);
- row 9: the body's tiles (64 q rows, 64-key tiles, the per-key mask,
  phantoms past T), the max over each thread's keys then its row set's
  16 lanes, the guard-shifted int32 sum, the emit, and P V in the body's
  key groups; with the word cache (one sweep of K, the words kept in 16
  bits, phantoms told by position) and without (every sweep recomputes
  the words).  Every probability word bitwise on grid-valued q and k (an
  identity v makes each output one word), acc within 1e-5 on random v.

Each test draws its inputs from its own seeded ``np.random.RandomState``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import softmax_unit as unit
from repro_torch.core.fixedpoint import (EXP_FRAC, IN_MAX, IN_MIN,
                                         dequantize, quantize)
from repro_torch.kernels import datapath as dp
from repro_torch.kernels import flash_attention_int as fai
from repro_torch.kernels import fused_norm as fn
from repro_torch.kernels import tiling

cdiv = tiling.cdiv
I32 = torch.int32
EPS = 1e-6


# ---------------- (a) row 14's plan ----------------

@pytest.mark.parametrize("d,want", [
    # (scheme, row threads, words, vec) with 16-byte pointers
    (1, ("warp", 32, 1, 1)),
    (3, ("warp", 32, 1, 1)),
    (200, ("warp", 32, 8, 4)),
    (203, ("warp", 32, 8, 1)),
    (768, ("warp", 32, 32, 4)),                # bert
    (1024, ("warp", 32, 32, 4)),
    (1028, ("block", 256, 8, 4)),
    (1100, ("block", 256, 8, 4)),
    (4096, ("block", 256, 16, 4)),             # yi-6b
    (4097, ("block", 256, 32, 1)),
    (8192, ("block", 256, 32, 4)),
    (8196, ("stream", 256, 0, 4)),
    (14000, ("stream", 256, 0, 4)),
    (14001, ("stream", 256, 0, 1)),
])
def test_resnorm_plan_bands(d, want):
    """The bands by d, the words a power of two covering the row."""
    plan = tiling.resnorm_plan(d, True)
    assert tuple(plan) == want
    if plan.words:
        assert plan.words * plan.row_threads >= d


@pytest.mark.parametrize("d", [4096, 768, 200, 14000, 203, 1])
def test_resnorm_plan_four_byte_copies(d):
    """Unaligned pointers (or d % 4 != 0) move a float at a time on the
    same bands."""
    plan = tiling.resnorm_plan(d, False)
    aligned = tiling.resnorm_plan(d, True)
    assert plan.vec == 1
    assert plan.scheme == aligned.scheme
    assert plan.row_threads == aligned.row_threads
    if d % 4:
        assert aligned.vec == 1


# ---------------- (b) row 14's scheme, emulated ----------------

def emulate_resnorm(x, r, g, b, *, kind, eps, plan):
    """(xo, ho) as the kernel computes them on ``plan``: each thread's
    moments over its chunks in order, then the fixed-order fold."""
    m, d = x.shape
    nt, vec = plan.row_threads, plan.vec
    nch = plan.words // vec if plan.words else cdiv(d, nt * vec)
    v = x + r
    held = torch.zeros(m, nch * nt * vec)
    held[:, :d] = v
    held = held.view(m, nch, nt, vec)
    s, ss = torch.zeros(m, nt), torch.zeros(m, nt)
    for j in range(nch):
        for e in range(vec):
            w = held[:, j, :, e]
            s, ss = s + w, ss + w * w
    # the warps' xor butterflies; every lane ends with lane 0's bits
    lanes = torch.arange(32)
    s, ss = s.view(m, -1, 32), ss.view(m, -1, 32)
    for o in (16, 8, 4, 2, 1):
        s, ss = s + s[..., lanes ^ o], ss + ss[..., lanes ^ o]
    s, ss = s[..., 0], ss[..., 0]                # (m, warps of the row)
    s0, ss0 = s[:, 0], ss[:, 0]                   # the warps in order
    for w in range(1, s.shape[1]):
        s0, ss0 = s0 + s[:, w], ss0 + ss[:, w]
    s, ss = s0, ss0
    inv_n = torch.tensor(1.0, dtype=torch.float32) / d
    mu, var = torch.zeros_like(s), ss * inv_n
    if kind == "layer":
        mu = s * inv_n
        var = torch.clamp(var - mu * mu, min=0.0)
    rs = torch.exp2(-0.5 * torch.log2(var + eps))
    h = (v - mu[:, None]) * rs[:, None] * g
    return v, h if b is None else h + b


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("m,d,aligned", [
    (4, 4096, True), (64, 4096, True), (6, 4096, False),   # yi: blocks
    (37, 768, True), (3, 200, True), (5, 203, True),       # bert, warps
    (2, 14000, True), (2, 14001, False), (7, 1, True),     # stream, edges
    (3, 1100, True)])
def test_resnorm_emulated_scheme_vs_plain(kind, m, d, aligned):
    rs = np.random.RandomState(61)
    x = torch.from_numpy(rs.randn(m, d).astype(np.float32) * 3)
    r = torch.from_numpy(rs.randn(m, d).astype(np.float32))
    g = torch.from_numpy(1 + 0.1 * rs.randn(d).astype(np.float32))
    b = torch.from_numpy(0.1 * rs.randn(d).astype(np.float32)) \
        if kind == "layer" else None
    plan = tiling.resnorm_plan(d, aligned)
    xo, ho = emulate_resnorm(x, r, g, b, kind=kind, eps=EPS, plan=plan)
    pxo, pho = fn.fused_residual_norm_plain(x, r, g, b, kind=kind, eps=EPS)
    assert torch.equal(xo, pxo)
    torch.testing.assert_close(ho, pho, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_resnorm_routes_with_and_without_autograd_agree(kind):
    """Inputs that need no gradient skip the autograd Function; both
    routes give the same outputs, and only the Function's records a
    graph."""
    rs = np.random.RandomState(62)
    x, r = (torch.from_numpy(rs.randn(3, 64).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy(1 + 0.1 * rs.randn(64).astype(np.float32))
    b = torch.from_numpy(rs.randn(64).astype(np.float32)) \
        if kind == "layer" else None
    plain = fn.fused_residual_norm(x, r, g, b, kind=kind, eps=EPS)
    xg = x.clone().requires_grad_(True)
    graph = fn.fused_residual_norm(xg, r, g, b, kind=kind, eps=EPS)
    assert all(t.grad_fn is None for t in plain)
    assert all(t.grad_fn is not None for t in graph)
    for a, c in zip(plain, graph):
        assert torch.equal(a, c.detach())
    with torch.no_grad():
        again = fn.fused_residual_norm(xg, r, g, b, kind=kind, eps=EPS)
    assert all(torch.equal(a, c) for a, c in zip(plain, again))


# ---------------- (c) row 9's plan ----------------

@pytest.mark.parametrize("h,hv,t,want", [
    # (block_q, block_kv, stages, vec, cache)
    (64, 64, 512, (64, 64, 3, 4, True)),       # bert
    (64, 64, 1088, (64, 64, 3, 4, True)),
    (64, 64, 1089, (64, 64, 3, 4, False)),     # past the word cache
    (64, 32, 70000, (64, 64, 3, 4, False)),
    (128, 128, 832, (64, 64, 2, 4, True)),
    (128, 72, 833, (64, 64, 2, 4, False)),
    (30, 62, 200, (64, 64, 3, 1, True)),       # 4-byte copies
])
def test_flash_int3_plan(h, hv, t, want):
    plan = tiling.flash_int3_plan(h, hv, t)
    assert tuple(plan) == want
    assert (tiling.flash_int3_smem(h, hv, t, True)
            <= tiling.SMEM_MAX_BYTES) == plan.cache
    assert tiling.flash_int3_smem(h, hv, t, False) <= tiling.SMEM_MAX_BYTES
    assert tiling.flash_int3_plan(h, hv, t, aligned=False).vec == 1


# ---------------- (d) row 9's scheme, emulated ----------------

def emulate_flash_int3(qf, k, v, q_pos, kv_valid, *, causal, guard_shift,
                       cache, bq=64, bk=64, groups=2):
    """The output as the kernel computes it, rows flattened r = s G + g:
    per q tile, the max over every 64-key tile (each thread's keys tx +
    16 c, then its row set's lanes), the guard-shifted sum, the emit; with
    ``cache`` the words of the first sweep kept in 16 bits and read back
    (phantoms by position), else recomputed each sweep; P V in ``groups``
    key groups summed at the end."""
    b, s, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    rows = s * g
    qr = qf.permute(0, 2, 1, 3, 4).reshape(b, kh, rows, h)
    qp = q_pos.repeat_interleave(g, dim=1).long()
    n_kt = cdiv(t, bk)
    lane_of = torch.arange(bk) % 16             # key tx + 16 c -> lane tx
    out = torch.zeros(b, kh, rows, hv)
    for bi in range(b):
        for hd in range(kh):
            for r0 in range(0, rows, bq):
                rs = slice(r0, min(rows, r0 + bq))
                q, qpr = qr[bi, hd, rs], qp[bi, rs]
                nr = q.shape[0]

                def operands(jt):
                    keys = jt * bk + torch.arange(bk)
                    here = keys < t
                    kb, vb = torch.zeros(bk, h), torch.zeros(bk, hv)
                    kb[here] = k[bi, keys[here], hd]
                    vb[here] = v[bi, keys[here], hd]
                    return keys, here, kb, vb

                def scored(jt):
                    keys, here, kb, _ = operands(jt)
                    valid = torch.zeros(bk, dtype=torch.bool)
                    valid[here] = kv_valid[bi, keys[here]] != 0
                    live = valid[None, :].expand(nr, bk)
                    if causal:
                        live = live & (keys[None, :] <= qpr[:, None])
                    sc = torch.where(live, q @ kb.T,
                                     torch.full((), dp.MASK_VALUE))
                    return torch.where(here[None, :], quantize(sc),
                                       torch.full((), unit.PHANTOM_Q,
                                                  dtype=I32))

                kept = {}

                def words(jt):
                    if not cache:
                        return scored(jt)
                    here = operands(jt)[1]
                    return torch.where(here[None, :],
                                       kept[jt].to(I32),
                                       torch.full((), unit.PHANTOM_Q,
                                                  dtype=I32))

                # sweep 1: the thread's max, then its row set's 16 lanes
                m_lane = torch.full((nr, 16), unit.PHANTOM_Q, dtype=I32)
                for jt in range(n_kt):
                    w = scored(jt)
                    if cache:
                        here = operands(jt)[1]
                        assert int(w[:, here].min()) >= IN_MIN
                        assert int(w[:, here].max()) <= IN_MAX
                        kept[jt] = w.to(torch.int16)
                    for lane in range(16):
                        m_lane[:, lane] = torch.maximum(
                            m_lane[:, lane], w[:, lane_of == lane].amax(1))
                m = m_lane.amax(1, keepdim=True)
                # the sum against the final max, lane partials then lanes
                l_lane = torch.zeros(nr, 16, dtype=I32)
                for jt in range(n_kt):
                    e = unit._exp2_int(unit._to_log2_domain(
                        words(jt) - m, unit.IN_FRAC)) >> guard_shift
                    for lane in range(16):
                        l_lane[:, lane] += e[:, lane_of == lane].sum(
                            1, dtype=I32)
                l = l_lane.sum(1, keepdim=True, dtype=I32)
                log2s = unit._log2_int(torch.clamp(l, min=1),
                                       EXP_FRAC - guard_shift)
                # the emit and P V in key groups
                accs = [torch.zeros(nr, hv) for _ in range(groups)]
                half = bk // groups
                for jt in range(n_kt):
                    vb = operands(jt)[3]
                    tt = unit._to_log2_domain(words(jt) - m, unit.IN_FRAC)
                    p = dequantize(unit._exp2_int(
                        torch.clamp(tt - log2s, max=0)), EXP_FRAC)
                    for gi in range(groups):
                        ks = slice(gi * half, (gi + 1) * half)
                        accs[gi] = accs[gi] + p[:, ks] @ vb[ks]
                acc = accs[0]
                for a in accs[1:]:
                    acc = acc + a
                out[bi, hd, rs] = acc
    return out.reshape(b, kh, s, g, hv).permute(0, 2, 1, 3, 4).contiguous()


def _case(seed, b, s, t, kh, g, h, hv, *, end=None, only_invalid=False):
    """Grid-valued q (pre-scaled) and k, so every score is exact; a quarter
    of the keys invalid; q_pos ending at ``end`` (default T)."""
    rs = np.random.RandomState(seed)
    q = np.round(rs.randn(b, s, kh, g, h) * 4) / 16 * h ** -0.5
    k = np.round(rs.randn(b, t, kh, h) * 4) / 16
    v = rs.randn(b, t, kh, hv)
    end = t if end is None else end
    qp = np.broadcast_to(np.arange(end - s, end, dtype=np.int32),
                         (b, s)).copy()
    valid = (rs.rand(b, t) > 0.25).astype(np.uint8)
    if only_invalid:            # row 0 sees only key 0, which is invalid
        valid[:, 0] = 0
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(k.astype(np.float32)),
            torch.from_numpy(v.astype(np.float32)), torch.from_numpy(qp),
            torch.from_numpy(valid))


def _eye(b, t, kh):
    return torch.eye(t)[None, :, None, :].expand(b, t, kh, t).contiguous()


# (b, s, t, kh, g, h, hv, causal, block_kv, q_pos end, only-invalid row, gs)
INT3 = [
    (1, 40, 130, 2, 1, 64, 64, False, 64, None, False, 0),   # T off 64
    (1, 40, 130, 2, 1, 64, 64, True, 16, None, False, 0),
    (2, 21, 77, 1, 2, 64, 64, True, 37, None, False, 0),     # G 2
    (1, 10, 90, 2, 8, 128, 128, False, 37, None, False, 0),  # G 8, h 128
    (1, 12, 70, 1, 8, 128, 72, True, 16, None, False, 0),
    (1, 30, 100, 2, 3, 30, 62, True, 37, None, False, 0),    # 4-byte copies
    (2, 24, 150, 1, 2, 64, 64, True, 64, 24, True, 0),       # only invalid
    (1, 33, 129, 1, 2, 64, 64, False, 64, None, False, 1),   # guard shift 1
]


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("shape", INT3)
def test_flash_int3_emulated_words_bitwise_identity_v(shape, cache):
    """V the identity: every output is one probability word, bitwise the
    plain three sweeps' over the caller's block_kv tiles, on both word
    paths."""
    b, s, t, kh, g, h, hv, causal, bkv, end, only, gs = shape
    qf, k, _, qp, valid = _case(71, b, s, t, kh, g, h, hv, end=end,
                                only_invalid=only)
    eye = _eye(b, t, kh)
    groups = 2 if max(h, hv) <= 64 else 1
    got = emulate_flash_int3(qf, k, eye, qp, valid, causal=causal,
                             guard_shift=gs, cache=cache, groups=groups)
    want = fai.flash_int3_plain(qf, k, eye, qp, valid, causal=causal,
                                block_kv=bkv, guard_shift=gs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("shape", INT3)
def test_flash_int3_emulated_random_v_vs_plain(shape, cache):
    """Random v: acc within 1e-5 of the plain version's (f32 p V in
    another order)."""
    b, s, t, kh, g, h, hv, causal, bkv, end, only, gs = shape
    args = _case(72, b, s, t, kh, g, h, hv, end=end, only_invalid=only)
    groups = 2 if max(h, hv) <= 64 else 1
    got = emulate_flash_int3(*args, causal=causal, guard_shift=gs,
                             cache=cache, groups=groups)
    want = fai.flash_int3_plain(*args, causal=causal, block_kv=bkv,
                                guard_shift=gs)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_int3_emulated_past_the_word_cache(causal):
    """T past the word cache's limit at h 64 (the plan recomputes the
    words): the recompute path's words bitwise on the identity-v probe,
    and the kept words would give the same."""
    t = 1100
    assert not tiling.flash_int3_plan(64, 64, t).cache
    qf, k, _, qp, valid = _case(73, 1, 6, t, 1, 1, 64, 64)
    eye = _eye(1, t, 1)
    want = fai.flash_int3_plain(qf, k, eye, qp, valid, causal=causal,
                                block_kv=64, guard_shift=0)
    for cache in (False, True):
        assert torch.equal(emulate_flash_int3(
            qf, k, eye, qp, valid, causal=causal, guard_shift=0,
            cache=cache), want)
