"""The fused GLU and its backward on the pipelined Hopper body (rows 12
and 13: ``csrc/glu.cu``, ``csrc/glu_bwd.cu`` on ``csrc/glu_sm90.cuh`` and
``csrc/norm_gemm_sm90.cuh``), their scheme emulated on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).  Here a torch emulation of their arithmetic -- K walked in
16-deep chunks within each of the plan's K ranges, the ranges' partial
sums added in range order, then the forward epilogue pair_act(g) * u or
the backward's dY u pair_act'(g), dY pair_act(g) -- is held to the plain
versions over every band of ``tiling.norm_gemm_plan(..., glu=True)``, at
forced split counts (one range left empty), and on the 4-byte-copy edge
shapes; and at one tiny shape each to the reference's two pallas_calls in
interpret mode.  Tolerance: 1e-5 of max(1, max |plain|) against the plain
versions (f32 sums over at most 512 terms in another order), 2e-5 against
the reference (its own pin for the GLU, tests/test_fused_ffn.py).

Each case draws its inputs from its own seeded ``np.random.RandomState``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ffn as J_ffn
from repro_torch.kernels import datapath as dp
from repro_torch.kernels import fused_ffn as ff
from repro_torch.kernels import tiling

TOL = 1e-5
MODES = ("silu", "gelu")


def _case(seed: int, m: int, k: int, f: int):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wg, wu = (rng.normal(scale=k ** -0.5, size=(k, f)).astype(np.float32)
              for _ in range(2))
    dy = rng.normal(size=(m, f)).astype(np.float32)
    return x, wg, wu, dy


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def emulate(x, wg, wu, split: int, mode: str, dy=None):
    """The kernels' arithmetic: split z sums the 16-deep K chunks z * per
    .. (z + 1) * per - 1 in order (per = cdiv(chunks, split); a range past
    the last chunk stays zero), the finish adds the ranges in order, then
    the epilogue.  Returns the forward's output, or (d_gate, d_up) given
    dy."""
    m, k = x.shape
    bk = tiling.NORM_GEMM_BK
    chunks = tiling.cdiv(k, bk)
    per = tiling.cdiv(chunks, split)
    parts = []
    for z in range(split):
        g = torch.zeros(m, wg.shape[1])
        u = torch.zeros_like(g)
        for c in range(z * per, min((z + 1) * per, chunks)):
            ks = slice(c * bk, min((c + 1) * bk, k))
            g = g + x[:, ks] @ wg[ks]
            u = u + x[:, ks] @ wu[ks]
        parts.append((g, u))
    g, u = parts[0]
    for pg, pu in parts[1:]:
        g, u = g + pg, u + pu
    if dy is None:
        return dp.pair_act(g, mode) * u
    return dy * u * dp.pair_act_grad(g, mode), dy * dp.pair_act(g, mode)


def _close_rel(got, want, tol=TOL):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=tol * max(1.0, float(want.abs().max())))


# (m, k, f): every band of the plan at a depth of 32 chunks (decode,
# chunk and prefill rows, split K in each), and the 4-byte-copy edges
BANDS = [(4, 512, 96), (16, 512, 200), (17, 512, 96), (64, 512, 130),
         (128, 256, 64), (200, 512, 136)]
EDGES = [(23, 200, 130), (70, 37, 33), (1, 64, 1)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,f", BANDS + EDGES)
def test_emulated_scheme_at_the_plan_vs_plain(m, k, f, mode):
    """The plan's split for this shape, forward and backward, against
    ``_glu_reference`` / ``_glu_bwd_plain``."""
    x, wg, wu, dy = _t(*_case(m * 7 + k + f, m, k, f))
    plan = tiling.norm_gemm_plan(m, k, (f,), glu=True)
    band = "decode" if m <= 16 else "chunk" if m < 128 else "prefill"
    assert plan.band == band
    _close_rel(emulate(x, wg, wu, plan.split, mode),
               ff._glu_reference(x, wg, wu, mode))
    for got, want in zip(emulate(x, wg, wu, plan.split, mode, dy),
                         ff._glu_bwd_plain(x, wg, wu, dy, mode)):
        _close_rel(got, want)


def test_plan_bands_split_k():
    """The BANDS above reach every band with a split K (so the emulation
    runs the fixed-order finish in each), and the edges take the 4-byte
    copies on the middle tile."""
    plans = {s: tiling.norm_gemm_plan(s[0], s[1], (s[2],), glu=True)
             for s in BANDS + EDGES}
    assert {p.band for s, p in plans.items()
            if s in BANDS and p.split > 1} == {"decode", "chunk", "prefill"}
    for s in EDGES[:2]:
        assert (plans[s].bm, plans[s].bn, plans[s].vec) == (64, 64, 1)


@pytest.mark.parametrize("split", [1, 2, 3, 4, 5])
def test_emulated_scheme_at_forced_splits_vs_plain(split):
    """K 144 is nine chunks: split 4 takes three a range and leaves the
    last range empty (its partials are zeros), split 5 two a range."""
    x, wg, wu, dy = _t(*_case(40 + split, 33, 144, 70))
    for mode in MODES:
        _close_rel(emulate(x, wg, wu, split, mode),
                   ff._glu_reference(x, wg, wu, mode))
        for got, want in zip(emulate(x, wg, wu, split, mode, dy),
                             ff._glu_bwd_plain(x, wg, wu, dy, mode)):
            _close_rel(got, want)


def test_wrappers_on_cpu_are_the_plain_versions():
    x, wg, wu, dy = _t(*_case(50, 9, 40, 24))
    assert torch.equal(ff.fused_glu(x, wg, wu, mode="gelu"),
                       ff._glu_reference(x, wg, wu, "gelu"))
    for got, want in zip(ff.glu_bwd(x, wg, wu, dy, mode="silu"),
                         ff._glu_bwd_plain(x, wg, wu, dy, "silu")):
        assert torch.equal(got, want)


# ---------------- the reference's kernels, interpret mode ----------------

def test_emulated_forward_vs_pallas_interpret_tiny():
    """Row 12: the emulation (two K ranges) against the reference's
    ``_fused_glu_jit`` run in interpret mode."""
    x, wg, wu, _ = _case(51, 9, 40, 24)
    want = J_ffn._fused_glu_jit(*map(jnp.asarray, (x, wg, wu)), mode="gelu",
                                interpret=True, bm=8, bf=128)
    got = emulate(*_t(x, wg, wu), 2, "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_emulated_backward_vs_pallas_interpret_tiny():
    """Row 13: the emulation (two K ranges) against the reference's
    ``_glu_bwd_call`` run in interpret mode."""
    x, wg, wu, dy = _case(52, 9, 40, 24)
    want = J_ffn._glu_bwd_call(*map(jnp.asarray, (x, wg, wu, dy)),
                               mode="silu", bm=8, bf=128, interpret=True)
    got = emulate(*_t(x, wg, wu), 2, "silu", torch.from_numpy(dy))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
