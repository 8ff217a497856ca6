"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a CUDA device every test here skips, with
the reason, from inside the ``cuda`` fixture (``REPRO_TORCH_REQUIRE_CUDA=1``
turns that skip into a failure, so a run on the GPU machine cannot pass
by skipping).  This file imports no JAX, so it runs where only PyTorch
is installed:

    REPRO_TORCH_REQUIRE_CUDA=1 PYTHONPATH=src python -m pytest -m gpu \
        tests/test_torch_gpu.py

Tolerances: int words bitwise; float softmax 1e-6, float GELU/SiLU 2e-6
(a few ulps of |z| <= ~10), float decode and blocked attention 1e-5 (dot
and sum order); int decode outputs 1e-5 on exact (grid-valued) scores,
1e-4 on random ones, where a score can round to the neighbouring S5.10
word; int blocked attention on exact scores only.  The block's seams:
the residual sum bitwise (one f32 add either way), the normalized row
1e-5 (moment sum order, exp2/log2 ulps, unit-scale outputs); the norm ->
QKV prologue and the fused GLU 1e-4 (f32 dot products over up to 4096
terms in two orders -- the kernels' chunks and K splits against cuBLAS
-- give ~1e-5 on outputs of magnitude up to ~5, and the GLU multiplies
one such error by |u| up to ~5); the norm -> gated-GLU prologue (row
16) likewise 1e-4, its autograd gradients within 1e-4 of the dense
graph's.  The
three-sweep int flash (row 9): its words bitwise under an identity-v
probe on grid-valued q and k, outputs within 5e-3 on random inputs (a
score word can flip between two f32 dot orders).  Training (rows 10,
11, 13 and the autograd Functions):
dq, dk, dv and d_gate / d_up within 1e-5 / 2e-5 of max(1, max |plain|)
(f32 sums over up to thousands of rows in two orders), the Functions'
gradients on CUDA tensors within 1e-4 of the dense graph's (the
kernels' and cuBLAS's orders of f32 products).
"""
import os
from unittest import mock

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import dualmode_softmax as ds
from repro_torch.kernels import flash_decode as fd

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        if os.environ.get("REPRO_TORCH_REQUIRE_CUDA") == "1":
            pytest.fail("REPRO_TORCH_REQUIRE_CUDA=1 but no CUDA device")
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dev)


@pytest.mark.parametrize("shape", [(1, 1), (5, 33), (64, 2048), (2, 70000)])
def test_softmax_rows_kernel(cuda, shape):
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, cuda, *shape, scale=6.0)
    x[0, : shape[1] // 2] = -30.0
    before = ds.SOFTMAX_ROWS.launches
    assert torch.equal(ds.softmax_rows(x, "int"),
                       ds.softmax_rows_plain(x, "int"))
    torch.testing.assert_close(ds.softmax_rows(x, "float"),
                               ds.softmax_rows_plain(x, "float"),
                               atol=1e-6, rtol=0)
    assert ds.SOFTMAX_ROWS.launches == before + 2


@pytest.mark.parametrize("mode", ["gelu", "silu"])
def test_pair_act_kernel(cuda, mode):
    gen = torch.Generator().manual_seed(1)
    z = _randn(gen, cuda, 64, 2816, scale=4.0)
    z[0, :7] = torch.tensor([-40.0, 40.0, 0.5 / 1024, 1.5 / 1024,
                             -2.5 / 1024, 0.0, 31.999])
    assert torch.equal(ds.pair_act(z, mode, "int"),
                       ds.pair_act_plain(z, mode, "int"))
    torch.testing.assert_close(ds.pair_act(z, mode, "float"),
                               ds.pair_act_plain(z, mode, "float"),
                               atol=2e-6, rtol=0)


# every edge of tiling.softmax_rows_plan: warp rows (1-1024), block rows
# (1025-8192), streamed rows past that; odd n takes the 4-byte loads
@pytest.mark.parametrize("off", [False, True])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 512, 513, 1024, 1025, 2048,
                               2049, 8192, 8193, 70000])
def test_softmax_rows_kernel_at_plan_edges(cuda, n, off):
    gen = torch.Generator().manual_seed(n)
    rows = 2 if n > 8192 else 11
    x = _randn(gen, cuda, rows, n, scale=6.0)
    x[0] = -30.0                                 # an all-masked row
    x[1, : n // 2] = -30.0
    xin = _off_by_one_float(x) if off else x
    for prec in ("int", "float"):
        before = ds.SOFTMAX_ROWS.launches
        a, b = ds.softmax_rows(xin, prec), ds.softmax_rows(xin, prec)
        assert ds.SOFTMAX_ROWS.launches == before + 2
        assert torch.equal(a, b)                 # two calls, the same bits
        want = ds.softmax_rows_plain(x, prec)
        if prec == "int":
            assert torch.equal(a, want)
        else:
            torch.testing.assert_close(a, want, atol=1e-6, rtol=0)


def test_softmax_rows_refuses_16_byte_loads_when_unaligned(cuda):
    from repro_torch.kernels import tiling
    x = torch.randn(9, 512, device=cuda)
    four = tiling.softmax_rows_plan(512, True)
    assert four.vec == 4
    with mock.patch.object(tiling, "softmax_rows_plan", lambda *a: four):
        with pytest.raises(RuntimeError):
            ds.softmax_rows(_off_by_one_float(x), "int")     # a pointer off 16 bytes
        with pytest.raises(RuntimeError):
            ds.softmax_rows(torch.randn(9, 510, device=cuda), "int")
        assert torch.equal(ds.softmax_rows(x, "int"),
                           ds.softmax_rows_plain(x, "int"))


@pytest.mark.parametrize("off", [False, True])
@pytest.mark.parametrize("mode", ["gelu", "silu"])
def test_pair_act_kernel_every_word(cuda, mode, off):
    """Every S5.10 word (and a 3-word tail past the last float4), bitwise
    to the plain version: the one-exponent pair form against the plain
    version's two exponents."""
    w = torch.arange(65536 + 3, device=cuda).remainder(65536) - 32768
    z = w.to(torch.float32) / 1024
    zin = _off_by_one_float(z) if off else z
    before = ds.PAIR_ACT.launches
    a, b = ds.pair_act(zin, mode, "int"), ds.pair_act(zin, mode, "int")
    assert ds.PAIR_ACT.launches == before + 2
    assert torch.equal(a, b)
    assert torch.equal(a, ds.pair_act_plain(z, mode, "int"))
    torch.testing.assert_close(ds.pair_act(zin, mode, "float"),
                               ds.pair_act_plain(z, mode, "float"),
                               atol=2e-6, rtol=0)


def test_pair_act_refuses_16_byte_copies_when_unaligned(cuda):
    from repro_torch.kernels import tiling
    z = _off_by_one_float(torch.randn(1000, device=cuda))
    with mock.patch.object(tiling, "aligned16", lambda *a: True):
        with pytest.raises(RuntimeError):
            ds.pair_act(z, "gelu", "int")


def _case(dev, g, grid, seed=2, b=4, kh=4, h=64, bs=128, nblk=16, hv=None,
          q_pos=None, tails="sentinel"):
    """Pools of 1 + b nblk blocks behind shuffled tables; the entries past
    each row's q_pos page are the sentinel 0 (``tails`` 'sentinel') or
    outside the pool ('out', with one live entry outside it too)."""
    gen = torch.Generator().manual_seed(seed)
    n_pool = 1 + b * nblk
    hv = hv or h
    q = _randn(gen, dev, b, kh, g, h)
    k = _randn(gen, dev, n_pool, bs, kh, h)
    if grid:                  # multiples of 2^-4: exact scores
        q = torch.round(q * 4) / 16
        k = torch.round(k * 4) / 16
    v = _randn(gen, dev, n_pool, bs, kh, hv)
    ids = (torch.randperm(n_pool - 1, generator=gen) + 1).reshape(b, nblk)
    q_pos = torch.tensor([5, 127, 900, nblk * bs - 1] if q_pos is None
                         else q_pos, dtype=torch.int32)
    past = (q_pos.clamp(min=0)[:, None] // bs) < torch.arange(nblk)[None, :]
    if tails == "sentinel":
        ids = torch.where(past, 0, ids)
    else:
        far = torch.tensor([-5, -1, n_pool, n_pool + 9])[
            torch.randint(0, 4, ids.shape, generator=gen)]
        ids = torch.where(past, far, ids)
        ids[0, 0] = -1
    tables = ids.to(torch.int32).to(dev)
    valid = (torch.arange(nblk * bs)[None, :] <= q_pos[:, None]).to(
        torch.uint8).to(dev)
    return (q * h ** -0.5).contiguous(), k, v, tables, q_pos.to(dev), valid


def _paged_checks(args, num_splits, grid):
    """Rows 3 and 4 against the paged plain version at ``num_splits``: the
    folded outputs (float 1e-5; int 1e-5 on exact scores, 1e-4 on random
    ones, where a score can round to the neighbouring S5.10 word), m and S
    bitwise on exact scores, one counted launch a call, two calls the same
    bits."""
    kw = dict(num_splits=num_splits, causal=True, guard_shift=0)
    for int_mode, kernel in ((False, fd.DECODE_PAGED),
                             (True, fd.DECODE_PAGED_INT)):
        before = kernel.launches
        got = fd.decode_paged_partials(*args, int_mode=int_mode, **kw)
        assert kernel.launches == before + 1
        want = fd.decode_paged_partials_plain(*args, int_mode=int_mode, **kw)
        if int_mode and grid:
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        torch.testing.assert_close(
            fd.finish_partials(*got, int_mode=int_mode),
            fd.finish_partials(*want, int_mode=int_mode),
            atol=1e-4 if int_mode and not grid else 1e-5, rtol=0)
        again = fd.decode_paged_partials(*args, int_mode=int_mode, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


# (bs, nblk, h, hv, q_pos, tails, pools off 16 bytes): qwen's 128-key
# pages; 8-key pages (smaller than a 16-key step) and 40-key ones (not a
# power of two) with entries outside the pool and a row at q_pos -1; the
# 4-byte copies (h 30, hv 62; pools one float off 16 bytes)
PAGED_LAYOUTS = [
    (128, 16, 64, 64, None, "sentinel", False),
    (8, 40, 64, 64, [-1, 100, 200, 319], "out", False),
    (40, 10, 64, 64, [3, 130, 250, 399], "out", False),
    (16, 20, 30, 62, [0, 100, 200, 319], "sentinel", False),
    (128, 16, 64, 64, None, "out", True),
]


@pytest.mark.parametrize("layout", PAGED_LAYOUTS)
@pytest.mark.parametrize("g", [1, 2, 4])
def test_decode_paged_kernels(cuda, g, layout):
    """Rows 3 and 4 on the contiguous decodes' body through the block
    table, at 1 and 4 splits, the plan's (tiling.decode_splits) and one a
    page (more splits than the shallow rows have live pages)."""
    from repro_torch.kernels import tiling
    bs, nblk, h, hv, q_pos, tails, off = layout
    for grid in (False, True):
        qf, k, v, tables, qp, valid = _case(cuda, g, grid, bs=bs, nblk=nblk,
                                            h=h, hv=hv, q_pos=q_pos,
                                            tails=tails)
        if off:
            k, v = _off_by_one_float(k), _off_by_one_float(v)
        plan = tiling.decode_splits(nblk, bs, qf.shape[0] * qf.shape[1],
                                    cuda)
        for num_splits in sorted({1, 4, plan, nblk}):
            _paged_checks((qf, k, v, tables, qp, valid), num_splits, grid)


@pytest.mark.parametrize("grid", [False, True])
def test_decode_paged_kernels_at_yi_shape(cuda, grid):
    """yi-6b's decode: 4 kv heads x G 8 query heads, h 128, 128-key
    blocks, a 4096-key table, at 1 and 8 splits and the plan's (16 on 132
    SMs), also with the pools off 16 bytes; head dims past 128 and G past
    8 refused."""
    from repro_torch.kernels import tiling
    args = _case(cuda, 8, grid, b=4, kh=4, h=128, bs=128, nblk=32,
                 q_pos=[250, 1300, 2900, 4095], tails="out")
    plan = tiling.decode_splits(32, 128, 16, cuda)
    if tiling.sm_count(cuda) == 132:
        assert plan == 16
    for num_splits in sorted({1, 8, plan}):
        _paged_checks(args, num_splits, grid)
    qf, k, v, tables, qp, valid = args
    _paged_checks((qf, _off_by_one_float(k), _off_by_one_float(v), tables,
                   qp, valid), plan, grid)
    kw = dict(num_splits=plan, causal=True, int_mode=False, guard_shift=0)
    wide = _case(cuda, 2, grid, b=2, kh=2, h=136, bs=16, nblk=4,
                 q_pos=[10, 63])
    with pytest.raises(ValueError, match="head dims"):
        fd.decode_paged_partials(*wide, **dict(kw, num_splits=2))
    many = _case(cuda, 9, grid, b=2, kh=2, h=64, bs=16, nblk=4,
                 q_pos=[10, 63])
    with pytest.raises(ValueError, match="query groups"):
        fd.decode_paged_partials(*many, **dict(kw, num_splits=2))


def test_decode_paged_refuses_16_byte_copies_when_unaligned(cuda):
    """16-byte copies forced where h is off four floats, or where a pool
    pointer is off 16 bytes, make the C entries refuse."""
    from repro_torch.kernels import tiling
    kw = dict(num_splits=2, causal=True, guard_shift=0)
    qf, k, v, tables, qp, valid = _case(cuda, 2, False, b=2, kh=2, h=32,
                                        bs=16, nblk=4, q_pos=[10, 63])
    odd = _case(cuda, 2, False, b=2, kh=2, h=30, bs=16, nblk=4,
                q_pos=[10, 63])
    with mock.patch.object(tiling, "decode_dense_vec", lambda *a: 4):
        for ops in (odd, (qf, _off_by_one_float(k), v, tables, qp, valid),
                    (qf, k, _off_by_one_float(v), tables, qp, valid)):
            for int_mode, name in ((False, "decode_paged"),
                                   (True, "decode_paged_int")):
                with pytest.raises(RuntimeError, match=name):
                    fd.decode_paged_partials(*ops, int_mode=int_mode, **kw)


def test_unit_kernels_at_yi_shape(cuda):
    """A yi-6b prefill chunk's score rows (32 heads x 64 queries against a
    4096-key table) and its FFN gate (64 x 11008)."""
    gen = torch.Generator().manual_seed(5)
    x = _randn(gen, cuda, 2048, 4096, scale=3.0)
    x[:, 3000:] = -30.0
    assert torch.equal(ds.softmax_rows(x, "int"),
                       ds.softmax_rows_plain(x, "int"))
    z = _randn(gen, cuda, 64, 11008, scale=3.0)
    assert torch.equal(ds.pair_act(z, "silu", "int"),
                       ds.pair_act_plain(z, "silu", "int"))


# ---------------- the block's seams: rows 14, 15 and 12 ----------------

@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("m,d", [(4, 4096), (64, 4096), (1, 1), (37, 200),
                                 (5, 14000), (4096, 768), (200, 4096),
                                 (5, 203), (40, 1100), (33, 4096)])
def test_resnorm_kernel(cuda, kind, m, d):
    """Row 14 in every band of tiling.resnorm_plan (a warp or a block a
    row, the stream) on 16-byte copies and,
    with every input one float off 16 bytes, on 4-byte ones: the sum
    bitwise, h within 1e-5, one counted launch a call, two calls the same
    bits."""
    from repro_torch.kernels import fused_norm as fn
    gen = torch.Generator().manual_seed(6)
    x, r = _randn(gen, cuda, m, d, scale=3.0), _randn(gen, cuda, m, d)
    g = 1.0 + _randn(gen, cuda, d, scale=0.1)
    b = _randn(gen, cuda, d, scale=0.1) if kind == "layer" else None
    pxo, pho = fn.fused_residual_norm_plain(x, r, g, b, kind=kind, eps=1e-6)
    for off in (False, True):
        ops = [None if t is None else _off_by_one_float(t) if off else t
               for t in (x, r, g, b)]
        before = fn.RESNORM.launches
        xo, ho = fn.fused_residual_norm(*ops, kind=kind, eps=1e-6)
        assert fn.RESNORM.launches == before + 1
        assert torch.equal(xo, pxo)
        torch.testing.assert_close(ho, pho, atol=1e-5, rtol=0)
        xo2, ho2 = fn.fused_residual_norm(*ops, kind=kind, eps=1e-6)
        assert torch.equal(xo, xo2) and torch.equal(ho, ho2)


def test_resnorm_refuses_what_it_does_not_instantiate(cuda):
    """The C entry refuses 16-byte copies off 16 bytes, held words that do
    not cover the row and row threads it has no instance for."""
    from repro_torch.kernels import fused_norm as fn
    from repro_torch.kernels import tiling
    gen = torch.Generator().manual_seed(16)
    x, r = _randn(gen, cuda, 4, 4096), _randn(gen, cuda, 4, 4096)
    g = 1.0 + _randn(gen, cuda, 4096, scale=0.1)
    bad = [tiling.ResnormPlan("block", 256, 16, 4),     # x off 16 bytes
           tiling.ResnormPlan("block", 256, 8, 4),      # 2048 words
           tiling.ResnormPlan("block", 128, 32, 4)]     # 128 threads a row
    for i, plan in enumerate(bad):
        xi = _off_by_one_float(x) if i == 0 else x
        with mock.patch.object(tiling, "resnorm_plan", lambda *a, **k: plan):
            with pytest.raises(RuntimeError, match="resnorm"):
                fn.fused_residual_norm(xi, r, g, kind="rms", eps=1e-6)


# every band of tiling.norm_gemm_plan: decode ticks (<= 16), prefill chunks
# (< 128, split K), prefill buckets
NORM_ROWS = (1, 4, 16, 17, 64, 65, 129, 512)
# 4-byte copies (K or a width not a multiple of 4), three matrices of
# unequal width, and bert-base's QKV
NORM_LINEAR_EDGES = [(23, 200, (130, 17, 40)), (100, 72, (5,)),
                     (1, 33, (64, 64)), (17, 33, (1, 5, 17)),
                     (130, 200, (130,)), (4096, 768, (768, 768, 768))]


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("m,d,widths", [
    (m, 4096, (4096, 512, 512)) for m in NORM_ROWS] + NORM_LINEAR_EDGES)
def test_norm_linear_kernel(cuda, kind, m, d, widths):
    from repro_torch.kernels import fused_norm as fn
    gen = torch.Generator().manual_seed(7)
    x = _randn(gen, cuda, m, d)
    g = 1.0 + _randn(gen, cuda, d, scale=0.1)
    b = _randn(gen, cuda, d, scale=0.1) if kind == "layer" else None
    ws = [_randn(gen, cuda, d, n, scale=d ** -0.5) for n in widths]
    before = fn.NORM_LINEAR.launches
    got = fn.fused_norm_linear(x, g, b, ws, kind=kind, eps=1e-6)
    assert fn.NORM_LINEAR.launches == before + 1
    torch.testing.assert_close(
        got, fn.fused_norm_linear_plain(x, g, b, ws, kind=kind, eps=1e-6),
        atol=1e-4, rtol=0)


# the fused GLU's (and its backward's) edges on the 4-byte copies: K or F
# not a multiple of 4, ragged tiles, one column
GLU_EDGES = [(23, 200, 130), (70, 37, 33), (1, 64, 1)]


@pytest.mark.parametrize("mode", ["silu", "gelu"])
@pytest.mark.parametrize("m,k,f", [(m, 4096, 11008) for m in NORM_ROWS]
                         + GLU_EDGES + [(4096, 4096, 14336)])
def test_glu_kernel(cuda, mode, m, k, f):
    """Row 12 at yi-6b's widths in every band of tiling.norm_gemm_plan
    (decode ticks and prefill chunks with a split K among them), on the
    4-byte edges, and at llama-3.2-vision's bucket-4096 prefill."""
    from repro_torch.kernels import fused_ffn as ff
    gen = torch.Generator().manual_seed(8)
    x = _randn(gen, cuda, m, k)
    wg = _randn(gen, cuda, k, f, scale=k ** -0.5)
    wu = _randn(gen, cuda, k, f, scale=k ** -0.5)
    before = ff.GLU.launches
    got = ff.fused_glu(x, wg, wu, mode=mode)
    assert ff.GLU.launches == before + 1
    torch.testing.assert_close(got, ff._glu_reference(x, wg, wu, mode),
                               atol=1e-4, rtol=0)


def test_kernel_registry(cuda):
    import repro_torch.kernels.flash_attention_int  # noqa: F401
    import repro_torch.kernels.fused_ffn  # noqa: F401
    import repro_torch.kernels.fused_norm  # noqa: F401
    import repro_torch.kernels.flash_attention_bwd  # noqa: F401
    assert set(_build.KERNELS) == {"softmax_rows", "pair_act",
                                   "decode_paged", "decode_paged_int",
                                   "decode_dense", "decode_dense_int",
                                   "flash_fwd", "flash_snap", "resnorm",
                                   "norm_linear", "glu", "flash_bwd_dq",
                                   "flash_bwd_dkdv", "glu_bwd",
                                   "flash_int3", "norm_glu"}
    x = torch.zeros(2, 3, device=cuda)
    with pytest.raises(ValueError):
        ds.softmax_rows(x.t())                  # not contiguous


# ---------------- long context: blocked flash and contiguous decode ----

def _attn(dev, b, s, t, kh, g, h, hv, grid, seed=3, causal_end=None):
    gen = torch.Generator().manual_seed(seed)
    qf = _randn(gen, dev, b, s, kh, g, h) * h ** -0.5
    k = _randn(gen, dev, b, t, kh, h)
    if grid:                  # multiples of 2^-4 (x h^-0.5 = 2^-3): exact
        qf = torch.round(qf * 32) / 32
        k = torch.round(k * 4) / 16
    v = _randn(gen, dev, b, t, kh, hv)
    end = t if causal_end is None else causal_end
    qp = torch.arange(end - s, end, dtype=torch.int32)[None].expand(
        b, s).contiguous().to(dev)
    valid = (torch.rand(b, t, generator=gen) > 0.25).to(torch.uint8).to(dev)
    return qf.contiguous(), k, v, qp, valid


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 130, 200, 2, 1, 64, 64, None),
                                   (2, 33, 129, 3, 4, 128, 72, None),
                                   (2, 40, 300, 2, 2, 64, 64, 40)])
def test_flash_kernels(cuda, shape, causal):
    """The kernels (causal: skip and closed-form tail fold) against the
    plain full sweeps; the last shape has rows whose one visible key is
    masked, where the folded tail carries all the mass."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    *dims, end = shape

    def operands(grid):
        args = _attn(cuda, *dims, grid=grid, causal_end=end)
        if end is not None:
            args[4][:, 0] = 0
        return args
    for bkv in (16, 64):
        kw = dict(causal=causal, block_kv=bkv)
        args = operands(False)
        before = fa.FLASH_FWD.launches
        torch.testing.assert_close(fa.flash_fwd(*args, **kw),
                                   fa.flash_fwd_plain(*args, **kw),
                                   atol=1e-5, rtol=0)
        assert fa.FLASH_FWD.launches == before + 1
        args = operands(True)
        got = fai.flash_snap(*args, guard_shift=0, return_partial=True, **kw)
        want = fai.flash_snap_plain(*args, guard_shift=0,
                                    return_partial=True, **kw)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(
            fai.flash_snap(*args, guard_shift=0, **kw),
            fai.flash_snap_plain(*args, guard_shift=0, **kw), atol=1e-5,
            rtol=0)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("num_splits", [1, 3])
def test_decode_dense_kernels(cuda, g, num_splits):
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator().manual_seed(4)
    b, t, kh, h, bkv = 4, 3000, 4, 64, 128
    for grid in (False, True):
        qf = _randn(gen, cuda, b, kh, g, h) * h ** -0.5
        k = _randn(gen, cuda, b, t, kh, h)
        if grid:
            qf, k = torch.round(qf * 32) / 32, torch.round(k * 4) / 16
        v = _randn(gen, cuda, b, t, kh, h)
        qp = torch.tensor([5, 127, 1000, t - 1], dtype=torch.int32).to(cuda)
        valid = (torch.arange(t, device=cuda)[None] <= qp[:, None]).to(
            torch.uint8)
        args = (qf.contiguous(), k, v, qp, valid)
        kw = dict(num_splits=num_splits, block_kv=bkv, causal=True,
                  guard_shift=0)
        kf = fd.decode_dense_partials(*args, int_mode=False, **kw)
        pf = fd.decode_dense_partials_plain(*args, int_mode=False, **kw)
        torch.testing.assert_close(fd.finish_partials(*kf, int_mode=False),
                                   fd.finish_partials(*pf, int_mode=False),
                                   atol=1e-5, rtol=0)
        ki = fd.decode_dense_partials(*args, int_mode=True, **kw)
        pi = fd.decode_dense_partials_plain(*args, int_mode=True, **kw)
        if grid:
            assert torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1])
        torch.testing.assert_close(fd.finish_partials(*ki, int_mode=True),
                                   fd.finish_partials(*pi, int_mode=True),
                                   atol=1e-5 if grid else 1e-4, rtol=0)


def _off_by_one_float(x):
    """x's values in a contiguous tensor whose data pointer is one float past
    a 16-byte boundary (the kernels' 4-byte copies)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("shape", [
    # (b, s, t, kh, g, h, hv, causal, block_kv, q_pos end, all-masked row)
    (1, 127, 127, 2, 1, 64, 64, True, 64, None, False),     # S G one off 128
    (1, 43, 257, 2, 3, 64, 64, True, 64, None, False),      # S G 129, T 257
    (2, 40, 1300, 2, 2, 64, 64, True, 64, 40, True),        # tail past a chunk
    (1, 20, 1100, 2, 1, 128, 128, True, 16, 17, False),     # q_pos < 0
    (1, 67, 1601, 2, 4, 128, 128, False, 64, None, False),  # S G off 64, h 128
    (1, 50, 90, 2, 3, 30, 62, True, 37, None, False)])      # 4-byte copies
def test_flash_fwd_kernel_at_tile_edges(cuda, shape):
    """Row 7 on its Hopper body across the plan's tile edges: out, m and
    l / plain l within 1e-5 of the plain full sweep, one counted launch a
    call, two calls the same bits; again with every pointer one float off
    16 bytes (the 4-byte entries)."""
    from repro_torch.kernels import flash_attention as fa
    b, s, t, kh, g, h, hv, causal, bkv, end, all_masked = shape
    qf, k, v, qp, valid = _attn(cuda, b, s, t, kh, g, h, hv, False,
                                causal_end=end)
    if all_masked:
        valid[:, 0] = 0
    kw = dict(causal=causal, block_kv=bkv, return_stats=True)
    for off in (False, True):
        ops = tuple(_off_by_one_float(x) for x in (qf, k, v)) if off else (
            qf, k, v)
        before = fa.FLASH_FWD.launches
        got = fa.flash_fwd(*ops, qp, valid, **kw)
        assert fa.FLASH_FWD.launches == before + 1
        want = fa.flash_fwd_plain(*ops, qp, valid, **kw)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[2] / want[2], torch.ones_like(want[2]),
                                   atol=1e-5, rtol=0)
        again = fa.flash_fwd(*ops, qp, valid, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_fwd_refuses_16_byte_copies_when_unaligned(cuda):
    """A head dim off four floats takes the 4-byte copies; the plan forced
    to 16-byte copies there makes the C entry refuse."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tiling
    qf, k, v, qp, valid = _attn(cuda, 1, 40, 70, 1, 2, 30, 30, False)
    assert tiling.flash_fwd_plan(30, 30, causal=True).vec == 1
    forced = tiling.flash_fwd_plan(32, 32, causal=True)
    assert forced.vec == 4
    with mock.patch.object(tiling, "flash_fwd_plan", lambda *a, **k_: forced):
        with pytest.raises(RuntimeError, match="flash_fwd"):
            fa.flash_fwd(qf, k, v, qp, valid, causal=True, block_kv=64)


@pytest.mark.parametrize("shape", [
    # (b, t, kh, g, h, hv, q_pos, causal, splits, block_kv); None: the plan's
    (4, 16384, 16, 1, 64, 64, [1100, 2500, 3900, 4015], True, None, None),
    (4, 1601, 8, 4, 128, 128, [0, 0, 0, 0], False, None, None),
    (3, 1000, 2, 4, 128, 96, [-1, 500, 999], True, 8, 64),
    (4, 600, 2, 1, 64, 64, [5, 127, 300, 599], True, 40, 16),
    (2, 333, 2, 4, 128, 128, [0, 0], False, 7, 64),
    (2, 190, 3, 3, 30, 62, [100, 189], True, 4, 37)])
def test_decode_dense_kernel_new_body(cuda, shape):
    """Row 5 on its Hopper body at the path's and the cross tick's plan and
    at edges (T off 64, q_pos < 0, splits with no tile, block_kv 16 / 37,
    the 4-byte copies): each split's m and the folded output within 1e-5
    of the plain version, one counted launch a call, two calls the same
    bits; again with every pointer one float off 16 bytes."""
    b, t, kh, g, h, hv, q_pos, causal, n_s, bkv = shape
    if n_s is None:
        n_s, bkv = fd.dense_decode_tiles(t, b * kh, cuda)
    gen = torch.Generator().manual_seed(15)
    qf = _randn(gen, cuda, b, kh, g, h) * h ** -0.5
    k, v = _randn(gen, cuda, b, t, kh, h), _randn(gen, cuda, b, t, kh, hv)
    qp = torch.tensor(q_pos, dtype=torch.int32).to(cuda)
    valid = (torch.rand(b, t, generator=gen) > 0.25).to(torch.uint8).to(cuda)
    kw = dict(num_splits=n_s, block_kv=bkv, causal=causal, int_mode=False,
              guard_shift=0)
    for off in (False, True):
        ops = tuple(_off_by_one_float(x) for x in (qf.contiguous(), k, v)) \
            if off else (qf.contiguous(), k, v)
        before = fd.DECODE_DENSE.launches
        got = fd.decode_dense_partials(*ops, qp, valid, **kw)
        assert fd.DECODE_DENSE.launches == before + 1
        want = fd.decode_dense_partials_plain(*ops, qp, valid, **kw)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(fd.finish_partials(*got, int_mode=False),
                                   fd.finish_partials(*want, int_mode=False),
                                   atol=1e-5, rtol=0)
        again = fd.decode_dense_partials(*ops, qp, valid, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_decode_dense_refuses_16_byte_copies_when_unaligned(cuda):
    """16-byte copies forced where h is off four floats, or where the K or
    V pointer is off 16 bytes, raise; an unaligned q does not stop them
    (it is read a float at a time)."""
    from repro_torch.kernels import tiling
    gen = torch.Generator().manual_seed(16)
    kw = dict(num_splits=2, block_kv=64, causal=True, int_mode=False,
              guard_shift=0)
    qp = torch.tensor([50, 199], dtype=torch.int32).to(cuda)
    valid = torch.ones(2, 200, dtype=torch.uint8, device=cuda)
    q30 = _randn(gen, cuda, 2, 2, 2, 30)
    k30, v30 = (_randn(gen, cuda, 2, 200, 2, 30) for _ in range(2))
    qf = _randn(gen, cuda, 2, 2, 2, 32)
    k, v = _randn(gen, cuda, 2, 200, 2, 32), _randn(gen, cuda, 2, 200, 2, 32)
    with mock.patch.object(tiling, "decode_dense_vec", lambda *a: 4):
        for ops in ((q30, k30, v30), (qf, _off_by_one_float(k), v),
                    (qf, k, _off_by_one_float(v))):
            with pytest.raises(RuntimeError, match="decode_dense"):
                fd.decode_dense_partials(*ops, qp, valid, **kw)
        got = fd.decode_dense_partials(_off_by_one_float(qf), k, v, qp,
                                       valid, **kw)
    want = fd.decode_dense_partials_plain(qf, k, v, qp, valid, **kw)
    torch.testing.assert_close(fd.finish_partials(*got, int_mode=False),
                               fd.finish_partials(*want, int_mode=False),
                               atol=1e-5, rtol=0)


# ---- rows 8 / 6: the snapped int flash and contiguous decode, Hopper bodies

SNAP_EDGES = [
    # (b, s, t, kh, g, h, hv, causal, block_kv, q_pos end, all-masked row)
    (1, 127, 127, 2, 1, 64, 64, True, 64, None, False),     # S G one off 128
    (1, 43, 257, 2, 3, 64, 64, True, 64, None, False),      # S G 129, T 257
    (2, 40, 1300, 2, 2, 64, 64, True, 64, 40, True),        # tail past a chunk
    (1, 20, 1100, 2, 1, 128, 128, True, 16, 17, False),     # q_pos < 0
    (1, 33, 129, 3, 4, 128, 72, True, 16, None, False),     # G 4 at h 128
    (1, 67, 1601, 2, 4, 128, 128, False, 64, None, False),  # S G off 64
    (1, 50, 90, 2, 3, 30, 62, True, 37, None, False)]       # 4-byte copies


def _snap_call(fai, ops, kw):
    """Row 8's partial (acc, m, S) and output, one counted launch each."""
    before = fai.FLASH_SNAP.launches
    part = fai.flash_snap(*ops, return_partial=True, **kw)
    out = fai.flash_snap(*ops, **kw)
    assert fai.FLASH_SNAP.launches == before + 2
    return part, out


@pytest.mark.parametrize("shape", SNAP_EDGES)
def test_flash_snap_kernel_at_tile_edges(cuda, shape):
    """Row 8 on row 7's Hopper body across the plan's tile edges, on
    grid-valued q and k (exact scores): the m and S words bitwise the plain
    full sweep's, the output within 1e-5, two calls the same bits; again
    with every pointer one float off 16 bytes (the 4-byte entries)."""
    from repro_torch.kernels import flash_attention_int as fai
    b, s, t, kh, g, h, hv, causal, bkv, end, all_masked = shape
    qf, k, v, qp, valid = _attn(cuda, b, s, t, kh, g, h, hv, True,
                                causal_end=end)
    if all_masked:
        valid[:, 0] = 0
    kw = dict(causal=causal, block_kv=bkv, guard_shift=0)
    want = fai.flash_snap_plain(qf, k, v, qp, valid, return_partial=True,
                                **kw)
    want_out = fai.flash_snap_plain(qf, k, v, qp, valid, **kw)
    for off in (False, True):
        ops = tuple(_off_by_one_float(x) for x in (qf, k, v)) if off else (
            qf, k, v)
        part, out = _snap_call(fai, ops + (qp, valid), kw)
        assert torch.equal(part[1], want[1]) and torch.equal(part[2], want[2])
        torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
        again = _snap_call(fai, ops + (qp, valid), kw)
        assert all(torch.equal(x, y) for x, y in zip(part, again[0]))
        assert torch.equal(out, again[1])


@pytest.mark.parametrize("causal,bkv", [(True, 64), (True, 16), (False, 37)])
def test_flash_snap_identity_v_bitwise(cuda, causal, bkv):
    """V the identity: every output is one exact probability word over the
    row's l, so the kernel's output is the plain version's bit for bit."""
    from repro_torch.kernels import flash_attention_int as fai
    qf, k, _, qp, valid = _attn(cuda, 2, 40, 128, 2, 2, 64, 64, True,
                                causal_end=128)
    eye = torch.eye(128, device=cuda)[None, :, None, :].expand(
        2, 128, 2, 128).contiguous()
    kw = dict(causal=causal, block_kv=bkv, guard_shift=0)
    assert torch.equal(fai.flash_snap(qf, k, eye, qp, valid, **kw),
                       fai.flash_snap_plain(qf, k, eye, qp, valid, **kw))


@pytest.mark.parametrize("h", [64, 128])
def test_flash_snap_partial_vs_plain(cuda, h):
    """The partial at both tile shapes: the words bitwise and the
    accumulators within 1e-5 of the plain version's over the row's l."""
    from repro_torch.kernels import flash_attention_int as fai
    args = _attn(cuda, 1, 150, 300, 2, 2, h, h, True)
    kw = dict(causal=True, block_kv=64, guard_shift=0, return_partial=True)
    got = fai.flash_snap(*args, **kw)
    want = fai.flash_snap_plain(*args, **kw)
    l = fai.unit.online_finish_int(want[2]).to(torch.float32)
    l = l.permute(0, 3, 1, 2)[..., None]                  # (B, S, K, G, 1)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0] / l, want[0] / l, atol=1e-5, rtol=0)


def test_flash_snap_refuses_what_it_does_not_instantiate(cuda):
    """16-byte copies forced where h is off four floats make the C entry
    refuse."""
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import tiling
    args = _attn(cuda, 1, 40, 70, 1, 2, 30, 30, False)
    assert tiling.flash_fwd_plan(30, 30, causal=True).vec == 1
    plan = tiling.flash_fwd_plan(32, 32, causal=True)
    with mock.patch.object(tiling, "flash_fwd_plan",
                           lambda *a, **k_: plan):
        with pytest.raises(RuntimeError, match="flash_snap"):
            fai.flash_snap(*args, causal=True, block_kv=64, guard_shift=0)


@pytest.mark.parametrize("shape", [
    # (b, t, kh, g, h, hv, q_pos, causal, splits, block_kv); None: the plan's
    (4, 16384, 16, 1, 64, 64, [1100, 2500, 3900, 4015], True, None, None),
    (4, 1601, 8, 4, 128, 128, [0, 0, 0, 0], False, None, None),
    (3, 1000, 2, 4, 128, 96, [-1, 500, 999], True, 8, 64),
    (4, 600, 2, 1, 64, 64, [5, 127, 300, 599], True, 40, 16),
    (2, 333, 2, 4, 128, 128, [0, 0], False, 7, 64),
    (2, 190, 3, 3, 30, 62, [100, 189], True, 4, 37),
    (2, 120, 2, 8, 128, 96, [70, 119], True, 2, 37)])
def test_decode_dense_int_kernel_new_body(cuda, shape):
    """Row 6 on row 5's Hopper body at the plan's splits and 64-key tiles
    (the path, the cross tick) and at edges (T off 64, q_pos < 0, splits
    with no tile, G 4 and 8 at h 128, block_kv 16 / 37, the 4-byte copies),
    on grid-valued q and k: each split's m and S words bitwise the plain
    version's at the same (splits, tile), the folded output within 1e-5,
    one counted launch a call, two calls the same bits; again with every
    pointer one float off 16 bytes."""
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import tiling
    b, t, kh, g, h, hv, q_pos, causal, n_s, bkv = shape
    if n_s is None:
        n_s, bkv = fd.dense_decode_tiles(t, b * kh, cuda)
        assert (n_s, bkv) == tuple(tiling.decode_dense_plan(
            t, b * kh, sms=tiling.sm_count(cuda)))
    gen = torch.Generator().manual_seed(17)
    qf = torch.round(_randn(gen, cuda, b, kh, g, h) * h ** -0.5 * 32) / 32
    k = torch.round(_randn(gen, cuda, b, t, kh, h) * 4) / 16
    v = _randn(gen, cuda, b, t, kh, hv)
    qp = torch.tensor(q_pos, dtype=torch.int32).to(cuda)
    valid = (torch.rand(b, t, generator=gen) > 0.25).to(torch.uint8).to(cuda)
    kw = dict(num_splits=n_s, block_kv=bkv, causal=causal, int_mode=True,
              guard_shift=unit.guard_shift_for(t))
    want = fd.decode_dense_partials_plain(qf.contiguous(), k, v, qp, valid,
                                          **kw)
    for off in (False, True):
        ops = tuple(_off_by_one_float(x) for x in (qf.contiguous(), k, v)) \
            if off else (qf.contiguous(), k, v)
        before = fd.DECODE_DENSE_INT.launches
        got = fd.decode_dense_partials(*ops, qp, valid, **kw)
        assert fd.DECODE_DENSE_INT.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(fd.finish_partials(*got, int_mode=True),
                                   fd.finish_partials(*want, int_mode=True),
                                   atol=1e-5, rtol=0)
        again = fd.decode_dense_partials(*ops, qp, valid, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_decode_dense_int_refuses_16_byte_copies_when_unaligned(cuda):
    """16-byte copies forced where h is off four floats, or where the K or
    V pointer is off 16 bytes, raise."""
    from repro_torch.kernels import tiling
    gen = torch.Generator().manual_seed(18)
    kw = dict(num_splits=2, block_kv=64, causal=True, int_mode=True,
              guard_shift=0)
    qp = torch.tensor([50, 199], dtype=torch.int32).to(cuda)
    valid = torch.ones(2, 200, dtype=torch.uint8, device=cuda)
    q30 = _randn(gen, cuda, 2, 2, 2, 30)
    k30, v30 = (_randn(gen, cuda, 2, 200, 2, 30) for _ in range(2))
    qf = _randn(gen, cuda, 2, 2, 2, 32)
    k, v = _randn(gen, cuda, 2, 200, 2, 32), _randn(gen, cuda, 2, 200, 2, 32)
    with mock.patch.object(tiling, "decode_dense_vec", lambda *a: 4):
        for ops in ((q30, k30, v30), (qf, _off_by_one_float(k), v),
                    (qf, k, _off_by_one_float(v))):
            with pytest.raises(RuntimeError, match="decode_dense_int"):
                fd.decode_dense_partials(*ops, qp, valid, **kw)


# ---------------- training: backward kernels and autograd ----------------

def _close_rel(got, want, tol):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=tol * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("shape", [
    (1, 130, 200, 2, 1, 64, 64, True, 64, None),     # S != T, ragged tile
    (2, 33, 129, 3, 4, 128, 72, True, 16, None),     # GQA, hv != h
    (2, 40, 300, 2, 2, 64, 64, True, 64, 40),        # all-masked rows
    (2, 64, 100, 1, 3, 32, 32, False, 37, None),     # non-causal
    (1, 256, 256, 2, 1, 64, 64, True, 64, None),     # skipped tiles
    # the plan's tile edges: S G and T one below / above 128
    (1, 127, 127, 2, 1, 64, 64, True, 64, None),
    (1, 43, 129, 2, 3, 64, 64, True, 64, None),
    (2, 255, 257, 1, 1, 64, 64, False, 64, None),
    (1, 40, 300, 2, 8, 128, 128, True, 64, None),    # G 8, h 128
    (1, 50, 90, 2, 3, 30, 62, True, 64, None)])      # 4-byte copies
def test_flash_bwd_kernels(cuda, shape):
    """Rows 10 / 11: dq and dk/dv (causal skip and the folded dV tail)
    against the plain full sweeps."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    b, s, t, kh, g, h, hv, causal, bkv, end = shape
    qf, k, v, qp, valid = _attn(cuda, b, s, t, kh, g, h, hv, False,
                                causal_end=end)
    if end is not None:
        valid[:, 0] = 0
    o, m, l = fa.flash_fwd(qf, k, v, qp, valid, causal=causal, block_kv=bkv,
                           return_stats=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(5)).to(
        cuda)
    args, kw = (qf, k, v, o, m, l, do, qp, valid), dict(causal=causal,
                                                        block_kv=bkv)
    before = (fb.FLASH_BWD_DQ.launches, fb.FLASH_BWD_DKDV.launches)
    dq = fb.flash_bwd_dq(*args, **kw)
    dk, dv = fb.flash_bwd_dkdv(*args, **kw)
    assert (fb.FLASH_BWD_DQ.launches, fb.FLASH_BWD_DKDV.launches) == (
        before[0] + 1, before[1] + 1)
    _close_rel(dq, fb.flash_bwd_dq_plain(*args, **kw), 1e-5)
    for got, want in zip((dk, dv), fb.flash_bwd_dkdv_plain(*args, **kw)):
        _close_rel(got, want, 1e-5)
    again = fb.flash_bwd_dkdv(*args, **kw)          # no atomics: same bits
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    assert torch.equal(fb.flash_bwd_dq(*args, **kw), dq)


def test_flash_bwd_refuses_16_byte_copies_when_unaligned(cuda):
    """A head dim off four floats takes the 4-byte copies; the plan
    forced to 16-byte copies there makes both C entries refuse."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import tiling
    qf, k, v, qp, valid = _attn(cuda, 1, 40, 70, 1, 2, 30, 30, False)
    o, m, l = fa.flash_fwd(qf, k, v, qp, valid, causal=True, block_kv=64,
                           return_stats=True)
    args, kw = (qf, k, v, o, m, l, o, qp, valid), dict(causal=True,
                                                       block_kv=64)
    assert tiling.flash_bwd_plan("dq", 30, 30, causal=True).vec == 1
    for name in ("dq", "dkdv"):
        forced = tiling.flash_bwd_plan(name, 32, 32, causal=True)
        assert forced.vec == 4
        with mock.patch.object(tiling, "flash_bwd_plan",
                               lambda *a, f=forced, **k_: f):
            with pytest.raises(RuntimeError, match=f"flash_bwd_{name}"):
                getattr(fb, f"flash_bwd_{name}")(*args, **kw)


@pytest.mark.parametrize("mode", ["silu", "gelu"])
@pytest.mark.parametrize("m,k,f", [(m, 1024, 2816) for m in NORM_ROWS]
                         + GLU_EDGES + [(8192, 1024, 2816),
                                        (64, 4096, 11008)])
def test_glu_bwd_kernel(cuda, mode, m, k, f):
    """Row 13 at qwen1.5-0.5b's training widths in every band of the plan
    (a split K among them), at its training shape, at yi-6b's chunk and on
    the 4-byte edges."""
    from repro_torch.kernels import fused_ffn as ff
    gen = torch.Generator().manual_seed(6)
    x, dy = _randn(gen, cuda, m, k), _randn(gen, cuda, m, f)
    wg = _randn(gen, cuda, k, f, scale=k ** -0.5)
    wu = _randn(gen, cuda, k, f, scale=k ** -0.5)
    before = ff.GLU_BWD.launches
    got = ff.glu_bwd(x, wg, wu, dy, mode=mode)
    assert ff.GLU_BWD.launches == before + 1
    for a, b in zip(got, ff._glu_bwd_plain(x, wg, wu, dy, mode)):
        _close_rel(a, b, 2e-5)


@pytest.mark.parametrize("m", [4, 64, 512])
def test_glu_kernels_repeat_bitwise(cuda, m):
    """Rows 12 and 13 give the same bits twice on the same inputs, in each
    band (a split K included): no float atomics, splits summed in order."""
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import tiling
    gen = torch.Generator().manual_seed(16)
    x, dy = _randn(gen, cuda, m, 4096), _randn(gen, cuda, m, 11008)
    wg, wu = (_randn(gen, cuda, 4096, 11008, scale=1 / 64) for _ in range(2))
    if m < 128:
        assert tiling.norm_gemm_plan(m, 4096, (11008,), glu=True).split > 1
    assert torch.equal(ff.fused_glu(x, wg, wu, mode="silu"),
                       ff.fused_glu(x, wg, wu, mode="silu"))
    for a, b in zip(ff.glu_bwd(x, wg, wu, dy, mode="gelu"),
                    ff.glu_bwd(x, wg, wu, dy, mode="gelu")):
        assert torch.equal(a, b)


def test_glu_kernels_take_unaligned_pointers(cuda):
    """Base pointers off the 16-byte grid (contiguous views one float in)
    take the 4-byte copies, and the C entries refuse 16-byte copies for
    them."""
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import tiling
    gen = torch.Generator().manual_seed(17)
    x = _randn(gen, cuda, 64 * 256 + 1)[1:].view(64, 256)
    w = _randn(gen, cuda, 256 * 128, scale=1 / 16).view(256, 128)
    dy = _randn(gen, cuda, 64, 128)
    assert x.data_ptr() % 16 == 4
    torch.testing.assert_close(ff.fused_glu(x, w, w, mode="gelu"),
                               ff._glu_reference(x, w, w, "gelu"),
                               atol=1e-4, rtol=0)
    for a, b in zip(ff.glu_bwd(x, w, w, dy, mode="silu"),
                    ff._glu_bwd_plain(x, w, w, dy, "silu")):
        _close_rel(a, b, 2e-5)
    four = tiling.NormGemmPlan("chunk", 64, 64, 1, 4)
    with mock.patch.object(tiling, "norm_gemm_plan", lambda *a, **k: four):
        with pytest.raises(RuntimeError, match="kernel glu:"):
            ff.fused_glu(x, w, w, mode="gelu")
        with pytest.raises(RuntimeError, match="kernel glu_bwd:"):
            ff.glu_bwd(x, w, w, dy, mode="silu")


def test_autograd_functions_on_cuda(cuda):
    """The Functions around flash_pallas, the fused norms and the fused
    GLU: their gradients on CUDA tensors against torch.autograd of the
    dense graph, and each backward through its kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_norm as fn
    from repro_torch.models.attention import _naive_sdpa
    gen = torch.Generator().manual_seed(7)
    q = _randn(gen, cuda, 2, 70, 2, 2, 64)
    k, v = _randn(gen, cuda, 2, 70, 2, 64), _randn(gen, cuda, 2, 70, 2, 64)
    qp = torch.arange(70, device=cuda)[None].expand(2, 70)
    valid = torch.rand(2, 70, generator=gen).to(cuda) > 0.2
    do = _randn(gen, cuda, 2, 70, 2, 2, 64)
    grads = []
    before = (fb.FLASH_BWD_DQ.launches, fb.FLASH_BWD_DKDV.launches)
    for attn in (fa.flash_attention_pallas, _naive_sdpa):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = attn(*ins, q_pos=qp, kv_valid=valid, causal=True, scale=0.125)
        grads.append(torch.autograd.grad(o, ins, do))
    assert (fb.FLASH_BWD_DQ.launches, fb.FLASH_BWD_DKDV.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)

    x, r = _randn(gen, cuda, 2, 33, 256), _randn(gen, cuda, 2, 33, 256)
    g = 1.0 + _randn(gen, cuda, 256, scale=0.1)
    wg = _randn(gen, cuda, 256, 300, scale=256 ** -0.5)
    wu = _randn(gen, cuda, 256, 300, scale=256 ** -0.5)
    dy = _randn(gen, cuda, 66, 300)

    def run(fused):
        ins = [t.clone().requires_grad_(True) for t in (x, r, g, wg, wu)]
        if fused:
            xo, h = fn.fused_residual_norm(ins[0], ins[1], ins[2],
                                           kind="rms", eps=1e-6)
            y = ff.fused_glu(h.reshape(66, 256), ins[3], ins[4], mode="silu")
        else:
            xo = ins[0] + ins[1]
            h = fn._scaled(xo, ins[2], None, kind="rms", eps=1e-6)
            y = ff._glu_reference(h.reshape(66, 256), ins[3], ins[4], "silu")
        loss = (y * dy).sum() + xo.sum()
        return torch.autograd.grad(loss, ins)
    before = (ff.GLU_BWD.launches, fn.RESNORM.launches)
    fused = run(True)
    assert ff.GLU_BWD.launches == before[0] + 1
    assert fn.RESNORM.launches == before[1] + 1
    for a, b in zip(fused, run(False)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


# ---------------- bert-base: row 9 and the unit's GELU mode ----------------

def test_pair_act_gelu_kernel_at_bert_shape(cuda):
    """The FFN activation of one bert-base forward of 8 x 512 tokens."""
    gen = torch.Generator().manual_seed(11)
    z = _randn(gen, cuda, 4096, 3072, scale=3.0)
    before = ds.PAIR_ACT.launches
    assert torch.equal(ds.pair_act(z, "gelu", "int"),
                       ds.pair_act_plain(z, "gelu", "int"))
    torch.testing.assert_close(ds.pair_act(z, "gelu", "float"),
                               ds.pair_act_plain(z, "gelu", "float"),
                               atol=2e-6, rtol=0)
    assert ds.PAIR_ACT.launches == before + 2


def _eye_chunks(dev, b, t, kh, width=128):
    """The identity v over T keys in slices of at most ``width`` value
    columns (the kernels take hv <= 128): each output column is one key's
    probability word."""
    eye = torch.eye(t, device=dev)
    for j in range(0, t, width):
        yield eye[:, j:j + width][None, :, None, :].expand(
            b, t, kh, min(width, t - j)).contiguous()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 130, 200, 2, 1, 64, 64, None),
                                   (1, 33, 129, 3, 4, 128, 72, None),
                                   (2, 40, 300, 2, 2, 64, 64, 40),
                                   (1, 512, 512, 12, 1, 64, 64, None)])
def test_flash_int3_kernel(cuda, shape, causal):
    """Row 9 against its plain three sweeps: random inputs within 5e-3,
    and bitwise on the identity-v probe (grid-valued q and k); the third
    shape has rows whose one visible key is masked."""
    from repro_torch.kernels import flash_attention_int as fai
    *dims, end = shape
    b, s, t, kh = dims[:4]
    for bkv in (16, 64):
        kw = dict(causal=causal, block_kv=bkv, guard_shift=0)
        args = _attn(cuda, *dims, grid=False, causal_end=end)
        if end is not None:
            args[4][:, 0] = 0
        before = fai.FLASH_INT3.launches
        torch.testing.assert_close(fai.flash_int3(*args, **kw),
                                   fai.flash_int3_plain(*args, **kw),
                                   atol=5e-3, rtol=0)
        assert fai.FLASH_INT3.launches == before + 1
        qf, k, _, qp, valid = _attn(cuda, *dims, grid=True, causal_end=end)
        if end is not None:
            valid[:, 0] = 0
        for eye in _eye_chunks(cuda, b, t, kh):
            assert torch.equal(
                fai.flash_int3(qf, k, eye, qp, valid, **kw),
                fai.flash_int3_plain(qf, k, eye, qp, valid, **kw))


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("shape", [
    # (b, s, t, kh, g, h, hv, causal, block_kv, q_pos end, only-invalid row)
    (2, 512, 512, 12, 1, 64, 64, False, 64, None, False),   # bert's plan
    (1, 40, 130, 2, 1, 64, 64, True, 16, None, False),      # T off 64
    (1, 12, 70, 1, 8, 128, 72, True, 16, None, False),      # G 8, h 128
    (1, 30, 100, 2, 3, 30, 62, True, 37, None, False),      # 4-byte copies
    (2, 24, 150, 1, 2, 64, 64, True, 64, 24, True)])        # only invalid
def test_flash_int3_kernel_word_paths(cuda, shape, cache):
    """Row 9 on row 7's Hopper body, with the word cache and with words
    recomputed in each sweep (the plan forced to either), on grid-valued q
    and k: the identity-v words bitwise the plain three sweeps', random v
    within 1e-5, two calls the same bits; again with every pointer one
    float off 16 bytes (the 4-byte entries)."""
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import tiling
    b, s, t, kh, g, h, hv, causal, bkv, end, only = shape
    qf, k, v, qp, valid = _attn(cuda, b, s, t, kh, g, h, hv, True,
                                causal_end=end)
    if only:
        valid[:, 0] = 0
    if s == 512:
        assert tiling.flash_int3_plan(h, hv, t) == tiling.FlashInt3Plan(
            64, 64, 3, 4, True)
    kw = dict(causal=causal, block_kv=bkv, guard_shift=0)
    real = tiling.flash_int3_plan

    def plan(*a, **k_):
        return real(*a, **k_)._replace(cache=cache)
    with mock.patch.object(tiling, "flash_int3_plan", plan):
        for off in (False, True):
            ops = tuple(_off_by_one_float(x) for x in (qf, k)) if off else (
                qf, k)
            for eye in _eye_chunks(cuda, b, t, kh):
                eye = _off_by_one_float(eye) if off else eye
                before = fai.FLASH_INT3.launches
                got = fai.flash_int3(*ops, eye, qp, valid, **kw)
                assert fai.FLASH_INT3.launches == before + 1
                assert torch.equal(got, fai.flash_int3_plain(
                    qf, k, eye, qp, valid, **kw))
            vv = _off_by_one_float(v) if off else v
            got = fai.flash_int3(*ops, vv, qp, valid, **kw)
            torch.testing.assert_close(
                got, fai.flash_int3_plain(qf, k, v, qp, valid, **kw),
                atol=1e-5, rtol=0)
            assert torch.equal(got, fai.flash_int3(*ops, vv, qp, valid, **kw))


def test_flash_int3_refuses_what_it_does_not_instantiate(cuda):
    """h > 128 is refused; the C entry refuses 16-byte copies where h is
    off four floats and a word cache that does not fit."""
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import tiling
    kw = dict(causal=True, block_kv=64, guard_shift=0)
    with pytest.raises(ValueError):
        fai.flash_int3(*_attn(cuda, 1, 8, 40, 1, 1, 136, 64, False), **kw)
    args = _attn(cuda, 1, 40, 70, 1, 2, 30, 30, False)
    assert tiling.flash_int3_plan(30, 30, 70).vec == 1
    forced = tiling.FlashInt3Plan(64, 64, 3, 4, True)
    with mock.patch.object(tiling, "flash_int3_plan", lambda *a, **k_: forced):
        with pytest.raises(RuntimeError, match="flash_int3"):
            fai.flash_int3(*args, **kw)
    args = _attn(cuda, 1, 8, 1200, 1, 1, 64, 64, False)
    assert not tiling.flash_int3_plan(64, 64, 1200).cache
    with mock.patch.object(tiling, "flash_int3_plan", lambda *a, **k_: forced):
        with pytest.raises(RuntimeError, match="flash_int3"):
            fai.flash_int3(*args, **kw)


def test_flash_int3_kernel_guard_shift(cuda):
    """70000 keys: the guard shift (1, from the unpadded T) on the card."""
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import flash_attention_int as fai
    t = 70000
    qf, k, _, qp, valid = _attn(cuda, 1, 64, t, 1, 1, 64, 64, grid=True)
    v = torch.zeros(1, t, 1, 8, device=cuda)
    v[0, :, 0, 0] = 1.0                   # the sum of the row's words
    v[0, t - 7:, 0, 1:] = torch.eye(7, device=cuda)
    for causal in (True, False):
        kw = dict(causal=causal, block_kv=64,
                  guard_shift=unit.guard_shift_for(t))
        assert kw["guard_shift"] == 1
        assert torch.equal(fai.flash_int3(qf, k, v, qp, valid, **kw),
                           fai.flash_int3_plain(qf, k, v, qp, valid, **kw))


# ---------------- llama-3.2-vision: row 16 and the cross shapes ----------

@pytest.mark.parametrize("kind,mode", [("rms", "silu"), ("layer", "gelu")])
@pytest.mark.parametrize("m,d,f", [(m, 4096, 14336) for m in NORM_ROWS] + [
    (5, 72, 1000), (67, 200, 130), (1, 33, 1), (17, 33, 5), (130, 200, 17)])
def test_norm_glu_kernel(cuda, kind, mode, m, d, f):
    """Row 16 at the vision path's widths in every band of M (decode
    ticks, prefill chunks with a split K, prefill buckets) and ragged
    edges on the 4-byte copies (M, F not a multiple of the tile; d or F not
    a multiple of 4; a layer norm with a bias)."""
    from repro_torch.kernels import fused_norm as fn
    gen = torch.Generator().manual_seed(12)
    x = _randn(gen, cuda, m, d, scale=2.0)
    g = 1.0 + _randn(gen, cuda, d, scale=0.1)
    b = _randn(gen, cuda, d, scale=0.1) if kind == "layer" else None
    wg = _randn(gen, cuda, d, f, scale=d ** -0.5)
    wu = _randn(gen, cuda, d, f, scale=d ** -0.5)
    before = fn.NORM_GLU.launches
    got = fn.fused_norm_glu(x, g, b, wg, wu, kind=kind, eps=1e-6, mode=mode)
    assert fn.NORM_GLU.launches == before + 1
    torch.testing.assert_close(
        got, fn.fused_norm_glu_plain(x, g, b, wg, wu, kind=kind, eps=1e-6,
                                     mode=mode), atol=1e-4, rtol=0)


@pytest.mark.parametrize("m", [4, 64, 512])
def test_norm_kernels_repeat_bitwise(cuda, m):
    """Rows 15 and 16 give the same bits twice on the same inputs, in each
    band (a split K included): no float atomics, splits summed in order."""
    from repro_torch.kernels import fused_norm as fn
    gen = torch.Generator().manual_seed(14)
    x = _randn(gen, cuda, m, 4096)
    g, b = 1.0 + _randn(gen, cuda, 4096, scale=0.1), _randn(gen, cuda, 4096)
    ws = [_randn(gen, cuda, 4096, n, scale=1 / 64) for n in (4096, 512, 512)]
    wg, wu = (_randn(gen, cuda, 4096, 14336, scale=1 / 64) for _ in range(2))
    for kind, b_ in (("rms", None), ("layer", b)):
        assert torch.equal(fn.fused_norm_linear(x, g, b_, ws, kind=kind,
                                                eps=1e-6),
                           fn.fused_norm_linear(x, g, b_, ws, kind=kind,
                                                eps=1e-6))
        assert torch.equal(
            fn.fused_norm_glu(x, g, b_, wg, wu, kind=kind, eps=1e-6,
                              mode="silu"),
            fn.fused_norm_glu(x, g, b_, wg, wu, kind=kind, eps=1e-6,
                              mode="silu"))


def test_norm_kernels_take_unaligned_pointers(cuda):
    """Base pointers off the 16-byte grid (contiguous views one float in)
    take the 4-byte copies, and the C side refuses 16-byte copies for
    them."""
    from repro_torch.kernels import fused_norm as fn
    from repro_torch.kernels import tiling
    gen = torch.Generator().manual_seed(15)
    x = _randn(gen, cuda, 64 * 256 + 1)[1:].view(64, 256)
    g = 1.0 + _randn(gen, cuda, 256, scale=0.1)
    w = _randn(gen, cuda, 256 * 128 + 1, scale=1 / 16)[1:].view(256, 128)
    assert x.data_ptr() % 16 == 4
    torch.testing.assert_close(
        fn.fused_norm_linear(x, g, None, [w, w], kind="rms", eps=1e-6),
        fn.fused_norm_linear_plain(x, g, None, [w, w], kind="rms", eps=1e-6),
        atol=1e-4, rtol=0)
    torch.testing.assert_close(
        fn.fused_norm_glu(x, g, None, w, w, kind="rms", eps=1e-6,
                          mode="gelu"),
        fn.fused_norm_glu_plain(x, g, None, w, w, kind="rms", eps=1e-6,
                                mode="gelu"), atol=1e-4, rtol=0)
    four = tiling.NormGemmPlan("chunk", 64, 128, 1, 4)
    with mock.patch.object(tiling, "norm_gemm_plan", lambda *a, **k: four):
        with pytest.raises(RuntimeError, match="norm_linear"):
            fn.fused_norm_linear(x, g, None, [w], kind="rms", eps=1e-6)


def test_norm_glu_autograd_on_cuda(cuda):
    """The Function's gradients on CUDA tensors (the GLU backward kernel
    inside) against torch.autograd of the dense graph."""
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_norm as fn
    gen = torch.Generator().manual_seed(13)
    x = _randn(gen, cuda, 2, 33, 256)
    g, b = 1.0 + _randn(gen, cuda, 256, scale=0.1), _randn(gen, cuda, 256)
    wg = _randn(gen, cuda, 256, 300, scale=256 ** -0.5)
    wu = _randn(gen, cuda, 256, 300, scale=256 ** -0.5)
    dy = _randn(gen, cuda, 2, 33, 300)

    def run(fused):
        ins = [t.clone().requires_grad_(True) for t in (x, g, b, wg, wu)]
        if fused:
            y = fn.fused_norm_glu(*ins, kind="layer", eps=1e-6, mode="silu")
        else:
            h = fn._scaled(ins[0], ins[1], ins[2], kind="layer", eps=1e-6)
            y = ff._glu_reference(h.reshape(66, 256), ins[3], ins[4],
                                  "silu").reshape(2, 33, 300)
        return torch.autograd.grad((y * dy).sum(), ins)
    before = (fn.NORM_GLU.launches, ff.GLU_BWD.launches)
    fused = run(True)
    assert (fn.NORM_GLU.launches, ff.GLU_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b_ in zip(fused, run(False)):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=0)


@pytest.mark.parametrize("s", [512, 67])
def test_flash_kernels_at_cross_shape(cuda, s):
    """Rows 7 and 8 as the cross sublayer runs them: non-causal over the
    1601 image keys (a ragged last tile), q_pos 0, K 8 G 4 h 128."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    for grid in (False, True):
        qf, k, v, _, _ = _attn(cuda, 1, s, 1601, 8, 4, 128, 128, grid=grid)
        qp = torch.zeros(1, s, dtype=torch.int32, device=cuda)
        valid = torch.ones(1, 1601, dtype=torch.uint8, device=cuda)
        kw = dict(causal=False, block_kv=64)
        args = (qf, k, v, qp, valid)
        if not grid:
            torch.testing.assert_close(fa.flash_fwd(*args, **kw),
                                       fa.flash_fwd_plain(*args, **kw),
                                       atol=1e-5, rtol=0)
            continue
        gs = fai.unit.guard_shift_for(1601)
        got = fai.flash_snap(*args, guard_shift=gs, return_partial=True,
                             **kw)
        want = fai.flash_snap_plain(*args, guard_shift=gs,
                                    return_partial=True, **kw)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(
            fai.flash_snap(*args, guard_shift=gs, **kw),
            fai.flash_snap_plain(*args, guard_shift=gs, **kw), atol=1e-5,
            rtol=0)


@pytest.mark.parametrize("num_splits", [1, 3, 8])
def test_decode_dense_kernels_at_cross_shape(cuda, num_splits):
    """Rows 5 and 6 as a cross decode tick runs them: 4 slots, K 8 G 4 h
    128, 1601 keys (the last 128-key tile ragged), non-causal, q_pos 0."""
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator().manual_seed(14)
    b, t, kh, g, h = 4, 1601, 8, 4, 128
    for grid in (False, True):
        qf = _randn(gen, cuda, b, kh, g, h) * h ** -0.5
        k = _randn(gen, cuda, b, t, kh, h)
        if grid:
            qf, k = torch.round(qf * 32) / 32, torch.round(k * 4) / 16
        v = _randn(gen, cuda, b, t, kh, h)
        qp = torch.zeros(b, dtype=torch.int32, device=cuda)
        valid = torch.ones(b, t, dtype=torch.uint8, device=cuda)
        args = (qf.contiguous(), k, v, qp, valid)
        kw = dict(num_splits=num_splits, block_kv=128, causal=False,
                  guard_shift=unit.guard_shift_for(t))
        kf = fd.decode_dense_partials(*args, int_mode=False, **kw)
        pf = fd.decode_dense_partials_plain(*args, int_mode=False, **kw)
        torch.testing.assert_close(fd.finish_partials(*kf, int_mode=False),
                                   fd.finish_partials(*pf, int_mode=False),
                                   atol=1e-5, rtol=0)
        ki = fd.decode_dense_partials(*args, int_mode=True, **kw)
        pi = fd.decode_dense_partials_plain(*args, int_mode=True, **kw)
        if grid:
            assert torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1])
        torch.testing.assert_close(fd.finish_partials(*ki, int_mode=True),
                                   fd.finish_partials(*pi, int_mode=True),
                                   atol=1e-5 if grid else 1e-4, rtol=0)


# ---------------- mixture of experts (granite-moe) ----------------
#
# The MoE sublayer has no kernel of its own (its expert products are
# cuBLAS batched products, as the reference's are einsums); on the card
# it runs the unit's pair mode (row 2) in dual-mode.  Limits: the same
# call on the CPU within 1e-4 (float, the GEMM limit above: f32 dots over
# d in two orders) and 5e-3 (dual-mode, a flipped SiLU word), on equal
# routes; the drop set of a capacity-bound call equal to the CPU's.


def _moe_case(dev, s, *, e=40, k=8, pad=48, d=256, f=128, b=2,
              shift=0.0, act="silu", seed=21):
    from repro_torch.models import moe
    spec = moe.MoESpec(d, f, e, k, activation=act, ep_pad=pad)
    gen = torch.Generator().manual_seed(seed)
    p = moe.moe_init(gen, spec, torch.device("cpu"))
    x = (torch.randn((b, s, d), generator=gen)
         + shift * torch.randn((d,), generator=gen))
    return spec, p, x, ({kk: v.to(dev) for kk, v in p.items()}, x.to(dev))


@pytest.mark.parametrize("act,tol", [("silu", 1e-4), ("silu_dualmode", 5e-3)])
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_sublayer_on_the_card_matches_the_cpu(cuda, act, tol, dropless):
    from repro_torch.models import moe
    spec, p, x, (pc, xc) = _moe_case(cuda, 64, act=act)
    before = ds.PAIR_ACT.launches
    y_c, aux_c = moe.moe_apply(pc, spec, xc, dropless=dropless)
    assert ds.PAIR_ACT.launches == before + (act == "silu_dualmode")
    y, aux = moe.moe_apply(p, spec, x, dropless=dropless)
    assert torch.equal(moe._route(pc, spec, xc)[1].cpu(),
                       moe._route(p, spec, x)[1])
    torch.testing.assert_close(y_c.cpu(), y, atol=tol, rtol=0)
    torch.testing.assert_close(aux_c.cpu(), aux, atol=1e-6, rtol=0)


def test_moe_capacity_bound_drop_set_equals_the_cpus(cuda):
    """S 1100 > dropless_max_seq: inference capacity ceil(S k / E * 2.0);
    a direction every token shares overloads some experts, and the
    dropped (t, k) slots on the card are the CPU's."""
    from repro_torch.models import moe
    spec, p, x, (pc, xc) = _moe_case(cuda, 1100, b=1, shift=2.0)
    cap = moe.capacity(spec, 1100, dropless=True)
    assert cap == 440
    drops = []
    for pp, xx in ((pc, xc), (p, x)):
        _, idx, _ = moe._route(pp, spec, xx)
        drops.append((moe.slot_ranks(idx, spec.n_experts) >= cap).cpu())
    assert drops[0].any() and torch.equal(drops[0], drops[1])
    y_c, _ = moe.moe_apply(pc, spec, xc, dropless=True)
    y, _ = moe.moe_apply(p, spec, x, dropless=True)
    torch.testing.assert_close(y_c.cpu(), y, atol=1e-4, rtol=0)


def test_granite_train_step_repeats_bitwise_on_the_card(cuda):
    """Reduced granite-moe, remat, fused impls: one step from one state,
    twice, gives the same bits (dispatch and combine sum in a fixed
    order; no atomics in their backwards)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import make_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = registry.reduced_config("granite-moe-3b-a800m").replace(
        norm_impl="fused_pallas", ffn_impl="fused_pallas")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, remat=True)
    state = make_train_state(cfg, tcfg, cuda)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, tcfg, cuda)
    (s1, m1), (s2, m2) = step(state, batch), step(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s1.params),
                                                  tree_leaves(s2.params)))
    assert all(float(m1[k]) == float(m2[k]) for k in m1)
    assert 1.5 < float(m1["aux"]) < 2.5


# ---------------- the remaining attention families ----------------
#
# minicpm3's MLA attends with q.k over h = nope + rope = 96 and v at hv
# 64, over K 40 heads of G 1 (the expanded latent); whisper's encoder runs
# rows 7 / 8 non-causal over its 1500 frames (not a multiple of the
# 64-key tile: a phantom tail); qwen3's paged decode runs G 5, which the
# decode kernel rounds up to 8 rows.  The limits above.

@pytest.mark.parametrize("causal_end", [None, 40])
def test_flash_kernels_at_mla_shape(cuda, causal_end):
    """Rows 7 and 8 at MLA's head dims: a 64-token chunk against a
    2048-key table (causal, ragged kv_valid), and a whole 300-token
    prompt whose first rows see one masked key."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    s, t = (64, 2048) if causal_end is None else (300, 300)
    for grid in (False, True):
        qf, k, v, qp, valid = _attn(cuda, 1, s, t, 40, 1, 96, 64, grid,
                                    causal_end=causal_end)
        if causal_end is not None:
            valid[:, 0] = 0
        args = (qf, k, v, qp, valid)
        kw = dict(causal=True, block_kv=64)
        if not grid:
            before = fa.FLASH_FWD.launches
            torch.testing.assert_close(fa.flash_fwd(*args, **kw),
                                       fa.flash_fwd_plain(*args, **kw),
                                       atol=1e-5, rtol=0)
            assert fa.FLASH_FWD.launches == before + 1
            continue
        gs = fai.unit.guard_shift_for(t)
        part, out = _snap_call(fai, args, dict(kw, guard_shift=gs))
        want = fai.flash_snap_plain(*args, guard_shift=gs,
                                    return_partial=True, **kw)
        assert torch.equal(part[1], want[1]) and torch.equal(part[2], want[2])
        torch.testing.assert_close(
            out, fai.flash_snap_plain(*args, guard_shift=gs, **kw),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_splits", [None, 1, 5])
def test_decode_dense_kernels_at_mla_shape(cuda, num_splits):
    """Rows 5 and 6 as an MLA decode tick runs them: 4 slots at ragged
    depths of a 2048-key cache, K 40, G 1, h 96, hv 64, at the plan's
    splits (tiling.decode_dense_plan), 1 and 5."""
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import tiling
    gen = torch.Generator().manual_seed(31)
    b, t, kh, h, hv = 4, 2048, 40, 96, 64
    plan = tiling.decode_dense_plan(t, b * kh, sms=tiling.sm_count(cuda))
    splits = plan.splits if num_splits is None else num_splits
    for grid in (False, True):
        qf = _randn(gen, cuda, b, kh, 1, h) * h ** -0.5
        k = _randn(gen, cuda, b, t, kh, h)
        if grid:
            qf, k = torch.round(qf * 32) / 32, torch.round(k * 4) / 16
        v = _randn(gen, cuda, b, t, kh, hv)
        qp = torch.tensor([70, 700, 1500, t - 1], dtype=torch.int32).to(cuda)
        valid = (torch.arange(t, device=cuda)[None] <= qp[:, None]).to(
            torch.uint8)
        args = (qf.contiguous(), k, v, qp, valid)
        kw = dict(num_splits=splits, block_kv=plan.block_kv, causal=True,
                  guard_shift=unit.guard_shift_for(t))
        before = fd.DECODE_DENSE.launches
        kf = fd.decode_dense_partials(*args, int_mode=False, **kw)
        assert fd.DECODE_DENSE.launches == before + 1
        pf = fd.decode_dense_partials_plain(*args, int_mode=False, **kw)
        torch.testing.assert_close(fd.finish_partials(*kf, int_mode=False),
                                   fd.finish_partials(*pf, int_mode=False),
                                   atol=1e-5, rtol=0)
        ki = fd.decode_dense_partials(*args, int_mode=True, **kw)
        pi = fd.decode_dense_partials_plain(*args, int_mode=True, **kw)
        if grid:
            assert torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1])
        torch.testing.assert_close(fd.finish_partials(*ki, int_mode=True),
                                   fd.finish_partials(*pi, int_mode=True),
                                   atol=1e-5 if grid else 1e-4, rtol=0)


def test_flash_kernels_at_whisper_encoder_shape(cuda):
    """Rows 7 and 8 non-causal over 1500 frames, as whisper's encoder
    runs them: 1500 = 23 x 64 + 28, so the last key tile holds 36 phantom
    keys; K 8, G 1, h 64, every key valid."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    for grid in (False, True):
        qf, k, v, _, _ = _attn(cuda, 1, 1500, 1500, 8, 1, 64, 64, grid)
        qp = torch.arange(1500, dtype=torch.int32, device=cuda)[None]
        valid = torch.ones(1, 1500, dtype=torch.uint8, device=cuda)
        args = (qf, k, v, qp, valid)
        kw = dict(causal=False, block_kv=64)
        if not grid:
            torch.testing.assert_close(fa.flash_fwd(*args, **kw),
                                       fa.flash_fwd_plain(*args, **kw),
                                       atol=1e-5, rtol=0)
            continue
        gs = fai.unit.guard_shift_for(1500)
        part, out = _snap_call(fai, args, dict(kw, guard_shift=gs))
        want = fai.flash_snap_plain(*args, guard_shift=gs,
                                    return_partial=True, **kw)
        assert torch.equal(part[1], want[1]) and torch.equal(part[2], want[2])
        torch.testing.assert_close(
            out, fai.flash_snap_plain(*args, guard_shift=gs, **kw),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("grid", [False, True])
def test_decode_paged_kernels_at_qwen3_shape(cuda, grid):
    """Rows 3 and 4 at qwen3-14b's decode: 8 kv heads x G 5 query heads
    (the kernel's 8-row instantiation, 3 rows idle), h 128, 128-key
    blocks, a 2048-key table, at 1 split and the plan's."""
    from repro_torch.kernels import tiling
    args = _case(cuda, 5, grid, b=4, kh=8, h=128, bs=128, nblk=16,
                 q_pos=[100, 700, 1300, 2047], tails="out")
    plan = tiling.decode_splits(16, 128, 32, cuda)
    for num_splits in sorted({1, plan}):
        _paged_checks(args, num_splits, grid)


# ---------------- the recurrence kernels (wkv6, selective_scan) ----------------

def _wkv6_args(dev, b, sl, h, hd, seed):
    gen = torch.Generator().manual_seed(seed)
    r, k, v = (_randn(gen, dev, b, sl, h, hd) for _ in range(3))
    w = torch.exp(-torch.exp(_randn(gen, dev, b, sl, h, hd) - 3.0))
    return (r, k, v, w.clamp(max=0.9995).contiguous(),
            _randn(gen, dev, h, hd, scale=0.1),
            _randn(gen, dev, b, h, hd, hd, scale=0.3))


def _scan_args(dev, b, sl, di, ds, seed):
    gen = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(_randn(gen, dev, b, sl, di) - 2.0)
    a = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        di, ds).contiguous()
    return (_randn(gen, dev, b, sl, di), dt.contiguous(), a,
            _randn(gen, dev, b, sl, ds), _randn(gen, dev, b, sl, ds),
            _randn(gen, dev, b, di, ds, scale=0.3))


def _recurrence_checks(kernel, fn, plain, args, seq):
    """One launch a call; y and the final state within 1e-5 of max(1,
    max |plain|); S1 then S - S1 steps with the carried state equal one
    call bit for bit; two calls give the same bits."""
    before = kernel.launches
    got = fn(*args)
    assert kernel.launches == before + 1
    for a, b in zip(got, plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(
            1.0, float(b.abs().max())))
    sl = args[0].shape[1]
    for s1 in sorted({1, sl // 2 + 1} - {sl}):
        head, tail = list(args), list(args)
        for i in seq:
            head[i] = args[i][:, :s1].contiguous()
            tail[i] = args[i][:, s1:].contiguous()
        y1, st1 = fn(*head)
        tail[-1] = st1
        y2, st2 = fn(*tail)
        assert torch.equal(torch.cat([y1, y2], dim=1), got[0])
        assert torch.equal(st2, got[1])
    again = fn(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


# rwkv6's tick and prefill (32 heads of 64), S 8192 at one layer, and steps
# that are no multiple of the kernel's 32-step tile at the other widths
@pytest.mark.parametrize("b,sl,h,hd", [(4, 1, 32, 64), (1, 1500, 32, 64),
                                       (1, 8192, 32, 64), (2, 77, 4, 16),
                                       (3, 33, 8, 32)])
def test_wkv6_kernel(cuda, b, sl, h, hd):
    from repro_torch.kernels import recurrence as rec
    _recurrence_checks(rec.WKV6, rec.wkv6, rec.wkv6_plain,
                       _wkv6_args(cuda, b, sl, h, hd, sl), (0, 1, 2, 3))


# jamba's tick and prefill (d_inner 8192, d_state 16), channels that are no
# multiple of the kernel's 128, the reduced d_state 8
@pytest.mark.parametrize("b,sl,di,ds", [(4, 1, 8192, 16), (1, 1500, 8192, 16),
                                        (2, 77, 200, 16), (3, 33, 130, 8)])
def test_selective_scan_kernel(cuda, b, sl, di, ds):
    from repro_torch.kernels import recurrence as rec
    _recurrence_checks(rec.SELECTIVE_SCAN, rec.selective_scan,
                       rec.selective_scan_plain,
                       _scan_args(cuda, b, sl, di, ds, sl), (0, 1, 3, 4))


def test_recurrence_kernels_refuse_what_they_do_not_take(cuda):
    """Head dims and state widths the sources do not instantiate, and
    strided operands, raise before any launch."""
    from repro_torch.kernels import recurrence as rec
    before = (rec.WKV6.launches, rec.SELECTIVE_SCAN.launches)
    args = _wkv6_args(cuda, 1, 4, 2, 48, 0)
    with pytest.raises(ValueError, match="head dim"):
        rec.wkv6(*args)
    args = list(_wkv6_args(cuda, 1, 4, 2, 64, 0))
    args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rec.wkv6(*args)
    with pytest.raises(ValueError, match="d_state"):
        rec.selective_scan(*_scan_args(cuda, 1, 4, 64, 12, 0))
    assert (rec.WKV6.launches, rec.SELECTIVE_SCAN.launches) == before


# ---------------- deepseek-v2-lite: rows 5-8 at MLA's h 192 / hv 128 ------
#
# deepseek's q.k runs over nope + rope = 128 + 64 = 192 and its v at 128,
# G 1 (K = n_heads 16): the 192 class of rows 5-8 (tiling.head_width).
# Rows 7 / 8 there stream one operand a ring stage (K(0), V(0), K(1), ...);
# rows 5 / 6 dot a key's 192 dims on 4 lanes.  The limits above; the other
# rows keep refusing past 128.

DEEPSEEK_FLASH = [
    # (b, s, t, kh, g, h, hv, causal, block_kv, q_pos end, masked key 0)
    (1, 300, 300, 16, 1, 192, 128, True, 64, None, True),   # ragged tile
    (1, 64, 2048, 16, 1, 192, 128, True, 64, None, False),  # a chunk
    (2, 33, 129, 3, 2, 192, 128, True, 16, None, False),    # G 2
    (1, 67, 170, 2, 1, 192, 128, False, 37, None, False),   # non-causal
    (1, 40, 1300, 2, 1, 192, 128, True, 64, 40, True),      # tail past a chunk
    (1, 50, 90, 2, 1, 190, 126, True, 64, None, False),     # 4-byte copies
    (1, 70, 140, 2, 1, 132, 100, True, 64, None, False)]    # h just past 128


@pytest.mark.parametrize("shape", DEEPSEEK_FLASH)
def test_flash_kernels_at_deepseek_shape(cuda, shape):
    """Rows 7 and 8 in the 192 class against their plain versions: row 7
    on random operands (1e-5, one counted launch), row 8's m and S words
    bitwise and its output within 1e-5 on grid-valued q and k; both repeat
    bitwise."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import tiling
    b, s, t, kh, g, h, hv, causal, bkv, end, masked = shape
    assert tiling.flash_fwd_plan(h, hv, causal=causal).stages == 3
    kw = dict(causal=causal, block_kv=bkv)
    for grid in (False, True):
        args = _attn(cuda, b, s, t, kh, g, h, hv, grid, seed=41,
                     causal_end=end)
        if masked:
            args[4][:, 0] = 0
        if not grid:
            before = fa.FLASH_FWD.launches
            got = fa.flash_fwd(*args, **kw)
            assert fa.FLASH_FWD.launches == before + 1
            torch.testing.assert_close(got, fa.flash_fwd_plain(*args, **kw),
                                       atol=1e-5, rtol=0)
            assert torch.equal(got, fa.flash_fwd(*args, **kw))
            continue
        gs = fai.unit.guard_shift_for(t)
        part, out = _snap_call(fai, args, dict(kw, guard_shift=gs))
        want = fai.flash_snap_plain(*args, guard_shift=gs,
                                    return_partial=True, **kw)
        assert torch.equal(part[1], want[1]) and torch.equal(part[2], want[2])
        torch.testing.assert_close(
            out, fai.flash_snap_plain(*args, guard_shift=gs, **kw),
            atol=1e-5, rtol=0)
        assert torch.equal(out, fai.flash_snap(*args, guard_shift=gs, **kw))


@pytest.mark.parametrize("case", [
    # (b, t, kh, g, h, hv, q_pos, splits); None: the plan's
    (4, 2048, 16, 1, 192, 128, [70, 700, 1500, 2047], None),
    (4, 2048, 16, 1, 192, 128, [70, 700, 1500, 2047], 1),
    (4, 2048, 16, 1, 192, 128, [70, 700, 1500, 2047], 5),
    (2, 333, 3, 2, 192, 128, [100, 332], 3),                # G 2
    (2, 190, 2, 1, 190, 126, [50, 189], 4)])                # 4-byte copies
def test_decode_dense_kernels_at_deepseek_shape(cuda, case):
    """Rows 5 and 6 in the 192 class as deepseek's tick runs them (4
    slots at ragged depths of a 2048-key cache, K 16, G 1) and at edges:
    float 1e-5, int m / S words bitwise on grid-valued q and k (outputs
    1e-5) and within 1e-4 on random ones; one counted launch each."""
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import tiling
    b, t, kh, g, h, hv, q_pos, splits = case
    gen = torch.Generator().manual_seed(43)
    plan = tiling.decode_dense_plan(t, b * kh, sms=tiling.sm_count(cuda))
    kw = dict(num_splits=plan.splits if splits is None else splits,
              block_kv=plan.block_kv, causal=True,
              guard_shift=unit.guard_shift_for(t))
    qp = torch.tensor(q_pos, dtype=torch.int32).to(cuda)
    valid = (torch.arange(t, device=cuda)[None] <= qp[:, None]).to(
        torch.uint8)
    for grid in (False, True):
        qf = _randn(gen, cuda, b, kh, g, h) * h ** -0.5
        k = _randn(gen, cuda, b, t, kh, h)
        if grid:
            qf, k = torch.round(qf * 32) / 32, torch.round(k * 4) / 16
        args = (qf.contiguous(), k, _randn(gen, cuda, b, t, kh, hv), qp,
                valid)
        before = (fd.DECODE_DENSE.launches, fd.DECODE_DENSE_INT.launches)
        kf = fd.decode_dense_partials(*args, int_mode=False, **kw)
        ki = fd.decode_dense_partials(*args, int_mode=True, **kw)
        assert (fd.DECODE_DENSE.launches, fd.DECODE_DENSE_INT.launches) == (
            before[0] + 1, before[1] + 1)
        pf = fd.decode_dense_partials_plain(*args, int_mode=False, **kw)
        torch.testing.assert_close(fd.finish_partials(*kf, int_mode=False),
                                   fd.finish_partials(*pf, int_mode=False),
                                   atol=1e-5, rtol=0)
        pi = fd.decode_dense_partials_plain(*args, int_mode=True, **kw)
        if grid:
            assert torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1])
        torch.testing.assert_close(fd.finish_partials(*ki, int_mode=True),
                                   fd.finish_partials(*pi, int_mode=True),
                                   atol=1e-5 if grid else 1e-4, rtol=0)


def test_only_rows_5_to_8_take_the_192_class(cuda):
    """Past h 128 rows 3 / 4, 9, 10 / 11 raise ValueError before any
    launch, rows 5-8 past h 192 or hv 128 too; the 192 class's plan
    forced at h 128, or the 128 class's at h 192, makes the C entry
    refuse."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import tiling

    def counts():
        return {n: k.launches for n, k in _build.KERNELS.items()}
    before = counts()
    qf, k, v, qp, valid = _attn(cuda, 1, 20, 70, 2, 1, 192, 128, False)
    with pytest.raises(ValueError, match="head dims"):
        fai.flash_int3(qf, k, v, qp, valid, causal=True, block_kv=64,
                       guard_shift=0)
    o = torch.ones(1, 20, 2, 1, 128, device=cuda)
    m = torch.zeros(1, 2, 1, 20, device=cuda)
    for bwd in (fab.flash_bwd_dq, fab.flash_bwd_dkdv):
        with pytest.raises(ValueError, match="head dims"):
            bwd(qf, k, v, o, m, m + 1, o, qp, valid, causal=True,
                block_kv=64)
    with pytest.raises(ValueError, match="head dims"):
        fd.decode_paged_partials(*_case(cuda, 1, False, h=192, hv=128),
                                 num_splits=2, causal=True, int_mode=False,
                                 guard_shift=0)
    for h, hv in ((200, 128), (192, 136), (136, 136)):
        bad = _attn(cuda, 1, 20, 70, 2, 1, h, hv, False)
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_fwd(*bad, causal=True, block_kv=64)
        with pytest.raises(ValueError, match="head dims"):
            fai.flash_snap(*bad, causal=True, block_kv=64, guard_shift=0)
        with pytest.raises(ValueError, match="head dims"):
            fd.decode_dense_partials(
                bad[0][:, 0].contiguous(), bad[1], bad[2],
                bad[3][:, -1].contiguous(), bad[4], num_splits=2,
                block_kv=64, causal=True, int_mode=False, guard_shift=0)
    assert counts() == before
    for h, other in ((128, (192, 128)), (192, (128, 128))):
        ops = _attn(cuda, 1, 20, 70, 2, 1, h, 128, False)
        forced = tiling.flash_fwd_plan(*other, causal=True)
        with mock.patch.object(tiling, "flash_fwd_plan",
                               lambda *a, **k_: forced):
            with pytest.raises(RuntimeError, match="flash_fwd"):
                fa.flash_fwd(*ops, causal=True, block_kv=64)


def _deepseek_wide(dev):
    """Reduced deepseek with the published MLA head dims (nope 128, rope
    64, v 128): its attention runs the 192 class of rows 5-8."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import MLACfg
    from repro_torch.models.transformer import init_lm
    cfg = registry.reduced_config("deepseek-v2-lite-16b").replace(
        mla=MLACfg(q_lora_rank=0, kv_lora_rank=32, nope_dim=128, rope_dim=64,
                   v_dim=128))
    return cfg, init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def _plain_attention():
    """Patches that put the plain versions in rows 1, 2, 5-8's place."""
    from contextlib import ExitStack

    from repro_torch.core import activations
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    stack = ExitStack()
    for mod, name, plain in (
            (fd, "decode_dense_partials", fd.decode_dense_partials_plain),
            (fa, "flash_fwd", fa.flash_fwd_plain),
            (fai, "flash_snap", fai.flash_snap_plain),
            (dispatch, "softmax_rows", ds.softmax_rows_plain),
            (activations, "pair_act", ds.pair_act_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


@pytest.mark.parametrize("mode", ["float", "dualmode"])
def test_deepseek_engine_on_the_card_equals_the_plain_versions(cuda, mode):
    """Reduced deepseek at MLA's h 192 / hv 128 on the contiguous engine,
    its prefill through rows 7 / 8 and its ticks through rows 5 / 6 by
    name: float, the greedy streams equal the same engine's on the plain
    versions; dual-mode, the first prefill's and tick's logits within
    5e-3 of the plain versions' (a flipped score word moves a logit)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.models.transformer import init_caches
    from repro_torch.serve import Request, ServeEngine
    cfg, params = _deepseek_wide(cuda)
    if mode == "dualmode":
        cfg = cfg.replace(softmax_impl="dualmode", activation="silu_dualmode")
    kw = dict(n_slots=3, max_seq=96, prefill_buckets=(32, 96),
              cache_mode="contiguous",
              prefill_attn_impl="flash_pallas" if mode == "float"
              else "flash_pallas_int", decode_attn_impl="flash_decode")
    reqs = [(0, [1, 2, 3, 4, 5], 9), (1, list(range(7, 47)), 7),
            (2, [4] * 10, 12), (3, [2, 3], 6)]
    fwd, dec = ((fa.FLASH_FWD, fd.DECODE_DENSE) if mode == "float"
                else (fai.FLASH_SNAP, fd.DECODE_DENSE_INT))

    def run():
        eng = ServeEngine(cfg, params, device=cuda, **kw)
        if mode == "float":
            return eng.run([Request(rid=r, prompt=p, max_new=n)
                            for r, p, n in reqs])
        row = init_caches(cfg, 1, kw["max_seq"], cuda)
        toks = torch.tensor([list(range(7, 39))], device=cuda)
        pre = eng.prefill_logits(toks, row, torch.tensor([31], device=cuda))
        eng.caches = row
        tick = eng.decode_logits(torch.argmax(pre, -1)[:, None],
                                 torch.tensor([32], dtype=torch.int32,
                                              device=cuda))
        return pre, tick
    before = (fwd.launches, dec.launches)
    got = run()
    assert fwd.launches > before[0] and dec.launches > before[1]
    with _plain_attention():
        want = run()
    if mode == "float":
        assert got == want
    else:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=5e-3, rtol=0)
