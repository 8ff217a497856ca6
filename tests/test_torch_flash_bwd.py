"""The flash backward's tile policy and the arithmetic of its Hopper body
(rows 10 and 11, ``csrc/flash_bwd_sm90.cuh``), on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).  Here a torch emulation of their scheme -- the row-state
pre-pass (m, 1 / l, D, q_pos a row; each q tile's largest q_pos and
masked-tail vector), the q tiles a causal dk/dv block visits and the fold
of the tail vectors of those it skips, dq's causal end and its two key
halves, with the plan's tiles -- is held to the plain versions (the
reference's full sweeps over ``block_kv`` tiles), and at one tiny shape to
the reference's Pallas kernels in interpret mode.  Tolerance: 1e-5 of
max(1, max |plain|), the limit the kernels are held to on the card (f32
sums over the rows and keys of a tile in another order).

Each case draws its inputs from its own seeded ``np.random.RandomState``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention_bwd as J_fb
from repro_torch.kernels import datapath as dp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import tiling

TOL = 1e-5


# ---------------- (a) the plan ----------------

@pytest.mark.parametrize("kernel,h,hv,causal,aligned,want", [
    # head dims up to 64: dq holds 128 rows, dk/dv 128 keys; causal dq
    # walks its late (heaviest) q tiles first
    ("dq", 64, 64, True, True, (128, 64, 3, 4, True)),
    ("dkdv", 64, 64, True, True, (64, 128, 2, 4, False)),
    ("dq", 32, 32, False, True, (128, 64, 3, 4, False)),
    # past 64 (either dim): 64 rows / 64 keys, 32-row q tiles for dk/dv
    ("dq", 128, 128, True, True, (64, 64, 2, 4, True)),
    ("dkdv", 128, 72, True, True, (32, 64, 3, 4, False)),
    ("dkdv", 64, 128, False, True, (32, 64, 3, 4, False)),
    # 4-byte copies: a head dim or a pointer off 16 bytes, same tiles
    ("dq", 30, 64, True, True, (128, 64, 3, 1, True)),
    ("dkdv", 64, 62, True, True, (64, 128, 2, 1, False)),
    ("dkdv", 128, 128, True, False, (32, 64, 3, 1, False)),
])
def test_flash_bwd_plan(kernel, h, hv, causal, aligned, want):
    plan = tiling.flash_bwd_plan(kernel, h, hv, causal=causal,
                                 aligned=aligned)
    assert tuple(plan) == want
    assert (plan.block_q, plan.block_kv, plan.stages) == \
        tiling.FLASH_BWD_TILES[(kernel, 64 if max(h, hv) <= 64 else 128)]


def test_flash_bwd_plan_refuses_unknown_kernel():
    with pytest.raises(ValueError, match="dq"):
        tiling.flash_bwd_plan("dqk", 64, 64, causal=True)


# ---------------- (b) the kernels' scheme, emulated ----------------

def _rows(qf, o, m, l, do, q_pos):
    """The pre-pass: each flattened row r = s G + g of a (batch row, kv
    head) -> q, dO, m, 1 / max(l, 1e-30), D and q_pos."""
    b, s, kh, g, _ = qf.shape

    def flat(x):
        return x.permute(0, 2, 1, 3, 4).reshape(b, kh, s * g, x.shape[-1])

    def stat(x):
        return x.permute(0, 1, 3, 2).reshape(b, kh, s * g)
    inv_l = 1.0 / torch.clamp(stat(l), min=1e-30)
    d = torch.sum(flat(do) * flat(o), dim=-1)
    return flat(qf), flat(do), stat(m), inv_l, d, q_pos.repeat_interleave(
        g, dim=1)


def _p_ds(qr, dor, m, inv_l, d, qp, kb, vb, validb, key0, causal):
    """p and dS (kh, rows, keys) of one row tile against one key tile of
    one batch row, as the kernels' score step computes them."""
    s = torch.einsum("krh,jkh->krj", qr, kb)
    keys = key0 + torch.arange(kb.shape[0])
    live = (validb != 0)[None, None, :].expand_as(s)
    if causal:
        live = live & (keys[None, None, :] <= qp[None, :, None])
    s = torch.where(live, s, torch.full_like(s, dp.MASK_VALUE))
    p = torch.exp2((s - m[..., None]) * dp.LOG2E) * inv_l[..., None]
    dpv = torch.einsum("krd,jkd->krj", dor, vb)
    ds = torch.where(live, p * (dpv - d[..., None]), torch.zeros_like(p))
    return p, ds


def _unflat(x, b, s, kh, g):
    return x.reshape(b, kh, s, g, x.shape[-1]).permute(0, 2, 1, 3, 4)


def emulate_dq(qf, k, v, o, m, l, do, q_pos, kv_valid, *, causal, bq, bkv):
    """dq as the kernel computes it: per q tile of bq rows, the key tiles
    of bkv keys up to the tile holding its largest q_pos (causal), each
    tile's dS K split into two key halves summed apart and added at the
    end."""
    b, s, kh, g, h = qf.shape
    t = k.shape[1]
    qr, dor, mr, inv_l, d, qp = _rows(qf, o, m, l, do, q_pos)
    dq = torch.zeros_like(qr)
    for r0 in range(0, s * g, bq):
        rs = slice(r0, min(s * g, r0 + bq))
        for bi in range(b):
            n_tiles = tiling.cdiv(t, bkv)
            if causal:
                qmax = int(qp[bi, rs].max())
                n_tiles = 0 if qmax < 0 else min(n_tiles, qmax // bkv + 1)
            halves = [torch.zeros_like(qr[bi, :, rs]) for _ in range(2)]
            for jt in range(n_tiles):
                key0 = jt * bkv
                ks = slice(key0, min(t, key0 + bkv))
                _, ds = _p_ds(qr[bi, :, rs], dor[bi, :, rs], mr[bi, :, rs],
                              inv_l[bi, :, rs], d[bi, :, rs], qp[bi, rs],
                              k[bi, ks], v[bi, ks], kv_valid[bi, ks], key0,
                              causal)
                kb = k[bi, ks].permute(1, 0, 2)
                half = bkv // 2
                halves[0] += ds[..., :half] @ kb[:, :half]
                halves[1] += ds[..., half:] @ kb[:, half:]
            dq[bi, :, rs] = halves[0] + halves[1]
    return _unflat(dq, b, s, kh, g)


def emulate_dkdv(qf, k, v, o, m, l, do, q_pos, kv_valid, *, causal, bq,
                 bkv):
    """(dk, dv) as the kernel computes them: per key block of bkv keys,
    the q tiles of bq rows whose largest q_pos reaches its first key
    (all of them when not causal), each tile summed on its own and added
    to the running sums in tile order; the pre-pass's tail vectors of the
    skipped tiles, summed in tile order, added to every key's dV."""
    b, s, kh, g, h = qf.shape
    t, hv = k.shape[1], v.shape[-1]
    qr, dor, mr, inv_l, d, qp = _rows(qf, o, m, l, do, q_pos)
    n_qt = tiling.cdiv(s * g, bq)
    tiles = [slice(r0, min(s * g, r0 + bq)) for r0 in range(0, s * g, bq)]
    p_tail = torch.exp2((dp.MASK_VALUE - mr) * dp.LOG2E) * inv_l
    tail = torch.stack([torch.einsum("bkr,bkrd->bkd", p_tail[:, :, rs],
                                     dor[:, :, rs]) for rs in tiles], 1)
    qmax = torch.stack([qp[:, rs].max(dim=1).values for rs in tiles], 1)
    assert tail.shape == (b, n_qt, kh, hv) and qmax.shape == (b, n_qt)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for key0 in range(0, t, bkv):
        ks = slice(key0, min(t, key0 + bkv))
        nk = ks.stop - key0
        for bi in range(b):
            run_k = torch.zeros(kh, nk, h)
            run_v = torch.zeros(kh, nk, hv)
            folded = torch.zeros(kh, hv)
            for qt, rs in enumerate(tiles):
                if causal and int(qmax[bi, qt]) < key0:
                    folded += tail[bi, qt]
                    continue
                p, ds = _p_ds(qr[bi, :, rs], dor[bi, :, rs], mr[bi, :, rs],
                              inv_l[bi, :, rs], d[bi, :, rs], qp[bi, rs],
                              k[bi, ks], v[bi, ks], kv_valid[bi, ks], key0,
                              causal)
                run_v += p.transpose(1, 2) @ dor[bi, :, rs]
                run_k += ds.transpose(1, 2) @ qr[bi, :, rs]
            dk[bi, ks] = run_k.permute(1, 0, 2)
            dv[bi, ks] = (run_v + folded[:, None, :]).permute(1, 0, 2)
    return dk, dv


def _case(seed, b, s, t, kh, g, h, hv, causal, bkv, kind):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, s, kh, g, h) * h ** -0.5).astype(np.float32)
    k = rs.randn(b, t, kh, h).astype(np.float32)
    v = rs.randn(b, t, kh, hv).astype(np.float32)
    do = rs.randn(b, s, kh, g, hv).astype(np.float32)
    qp = np.broadcast_to(np.arange(t - s, t, dtype=np.int32), (b, s)).copy()
    valid = np.ones((b, t), np.uint8)
    if kind in ("ragged", "shuffled"):
        valid = (rs.rand(b, t) > 0.25).astype(np.uint8)
    if kind == "shuffled":      # q tiles whose rows are not in q_pos order
        qp = np.stack([rs.permutation(row) for row in qp]).astype(np.int32)
    if kind == "all_masked":    # row 0 sees only key 0, which is invalid
        qp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
        valid[:, 0] = 0
    args = tuple(torch.from_numpy(x) for x in (q, k, v))
    qp_t, valid_t = torch.from_numpy(qp), torch.from_numpy(valid)
    o, m, l = fa.flash_fwd_plain(*args, qp_t, valid_t, causal=causal,
                                 block_kv=bkv, return_stats=True)
    return (*args, o, m, l, torch.from_numpy(do), qp_t, valid_t), (
        q, k, v, do, qp, valid)


def _close_rel(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=TOL * max(1.0, float(want.abs().max())))


# (b, s, t, kh, g, h, hv, causal, block_kv, inputs): several q tiles and
# key blocks at the plan's tiles, so causal blocks skip and fold
SCHEME = [
    (1, 300, 300, 2, 1, 64, 64, True, 64, "plain"),       # skipped tiles
    (2, 150, 280, 1, 3, 64, 64, True, 16, "ragged"),      # G 3, S != T
    (1, 40, 300, 2, 8, 128, 128, True, 64, "ragged"),     # G 8, wide heads
    (1, 90, 200, 2, 2, 128, 72, True, 37, "ragged"),      # hv != h
    (2, 100, 150, 1, 2, 32, 32, False, 37, "ragged"),     # not causal
    (2, 150, 300, 2, 1, 64, 64, True, 64, "all_masked"),  # all-masked row
    (2, 200, 260, 1, 2, 64, 48, True, 64, "shuffled"),    # q_pos unordered
]


@pytest.mark.parametrize("tiles", ["plan", "small"])
@pytest.mark.parametrize("shape", SCHEME)
def test_emulated_scheme_vs_plain(shape, tiles):
    """The kernels' scheme at the plan's tiles, and at small tiles (many
    of them at these sizes), against the plain full sweeps over the
    forward's block_kv tiles."""
    *dims, causal, bkv, kind = shape
    args, _ = _case(11, *dims, causal, bkv, kind)
    h, hv = dims[5], dims[6]
    kw = dict(causal=causal, block_kv=bkv)
    plan_q = tiling.flash_bwd_plan("dq", h, hv, causal=causal)
    plan_kv = tiling.flash_bwd_plan("dkdv", h, hv, causal=causal)
    t_q = (plan_q.block_q, plan_q.block_kv) if tiles == "plan" else (16, 24)
    t_kv = (plan_kv.block_q, plan_kv.block_kv) if tiles == "plan" else (
        8, 40)
    _close_rel(emulate_dq(*args, causal=causal, bq=t_q[0], bkv=t_q[1]),
               fb.flash_bwd_dq_plain(*args, **kw))
    dk, dv = emulate_dkdv(*args, causal=causal, bq=t_kv[0], bkv=t_kv[1])
    want_k, want_v = fb.flash_bwd_dkdv_plain(*args, **kw)
    _close_rel(dk, want_k)
    _close_rel(dv, want_v)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrappers return the plain versions' results."""
    args, _ = _case(12, 1, 70, 90, 1, 2, 64, 64, True, 64, "ragged")
    kw = dict(causal=True, block_kv=64)
    assert torch.equal(fb.flash_bwd_dq(*args, **kw),
                       fb.flash_bwd_dq_plain(*args, **kw))
    for got, want in zip(fb.flash_bwd_dkdv(*args, **kw),
                         fb.flash_bwd_dkdv_plain(*args, **kw)):
        assert torch.equal(got, want)


# ---------------- (c) the reference's kernels, interpret mode ----------------

def test_emulated_scheme_vs_pallas_interpret_tiny():
    """One tiny causal GQA shape: the emulation (at small tiles, so a
    block skips and folds) against the reference's two pallas_calls run
    in interpret mode on the same saved forward."""
    args, (q, k, v, do, qp, valid) = _case(13, 1, 20, 40, 1, 2, 8, 8, True,
                                           16, "ragged")
    _, _, _, o, m, l, *_ = args
    want = J_fb.flash_attention_bwd_pallas(
        *map(jnp.asarray, (q, k, v, o.numpy(), m.numpy(), l.numpy(), do)),
        q_pos=jnp.asarray(qp), kv_valid=jnp.asarray(valid.astype(bool)),
        causal=True, block_q=8, block_kv=16, interpret=True)
    got = (emulate_dq(*args, causal=True, bq=8, bkv=16),
           *emulate_dkdv(*args, causal=True, bq=8, bkv=8))
    for a, w in zip(got, want):
        _close_rel(a, torch.from_numpy(np.array(w)))
