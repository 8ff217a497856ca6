"""Rows 1 and 2 of the port (the unit's row softmax and its GELU / SiLU
pair mode) as their CUDA bodies compute them, emulated in torch on the
CPU and held to the plain versions and the JAX reference.

* ``tiling.softmax_rows_plan``: which rows a warp holds, which a block
  holds, which are streamed, and the load width.
* A torch emulation of the row softmax's schemes (``csrc/softmax_rows.cu``)
  that follows the lane partition (a thread's words, VEC at a time), the
  xor-shuffle butterfly and the block's one exchange (warps folded in
  order): int words bitwise to ``softmax_rows_plain`` and the reference's
  ``softmax_dualmode``, float within 1e-6 of the port's ``row_softmax``
  (the sum order and exp2 / log2 ulps).
* The one-exponent pair form (``csrc/unit.cuh:pair_softmax_first_int``)
  written in torch int32 as the kernel does it -- the shared-memory ROM
  lookup (segment & 7), the fraction as t's low bits, the constant
  exponent word PAIR_C0 -- bitwise to the reference's ``gelu_int`` /
  ``silu_int`` over every S5.10 word.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import softmax_unit as J
from repro_torch.core import fixedpoint as fx
from repro_torch.core import pwl
from repro_torch.core import softmax_unit as T
from repro_torch.kernels import _build
from repro_torch.kernels import datapath as dp
from repro_torch.kernels import dualmode_softmax as ds
from repro_torch.kernels import tiling

I32 = torch.int32
MASK = -30.0

# ---- the plan ---------------------------------------------------------------

PLANS = {  # n: (aligned plan, unaligned plan) as (scheme, threads, words, vec)
    1: (("warp", 32, 1, 1), ("warp", 32, 1, 1)),
    31: (("warp", 32, 1, 1), ("warp", 32, 1, 1)),
    32: (("warp", 32, 4, 4), ("warp", 32, 1, 1)),
    33: (("warp", 32, 2, 1), ("warp", 32, 2, 1)),
    512: (("warp", 32, 16, 4), ("warp", 32, 16, 1)),
    513: (("warp", 32, 32, 1), ("warp", 32, 32, 1)),
    2048: (("block", 256, 8, 4), ("block", 256, 8, 1)),
    2049: (("block", 256, 16, 1), ("block", 256, 16, 1)),
    70000: (("stream", 256, 0, 1), ("stream", 256, 0, 1)),
}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", sorted(PLANS))
def test_softmax_rows_plan(n, aligned):
    plan = tiling.softmax_rows_plan(n, aligned)
    assert tuple(plan) == PLANS[n][0 if aligned else 1]
    if plan.words:
        # a held row fits its threads, and a thread holds whole groups
        assert plan.row_threads * plan.words >= n
        assert plan.words % plan.vec == 0
        assert plan.words & (plan.words - 1) == 0 and plan.words <= 32


# ---- a torch emulation of the row softmax's schemes -------------------------

def _layout(n: int, plan):
    """(threads, words) element index of each held word, and its mask: word
    j * VEC + c of thread l is element VEC * (j * R + l) + c.  The streamed
    scheme's strided sweeps (thread l: l, l + 256, ...) are the same
    layout with VEC 1."""
    r = plan.row_threads
    vec, words = plan.vec, plan.words or tiling.cdiv(n, r)
    i = torch.arange(words)
    idx = vec * ((i // vec)[None, :] * r + torch.arange(r)[:, None]) + i % vec
    return idx, idx < n


def _row_reduce(v: torch.Tensor, op, r: int) -> torch.Tensor:
    """(rows, threads) partials -> (rows,) as the kernel folds them: the xor
    butterfly within each warp (every lane ends with the same value), then
    for a block row the warps' partials in warp order."""
    lanes = torch.arange(v.shape[1])
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[:, lanes ^ o])
    out = v[:, 0]
    for w in range(1, r // 32):
        out = op(out, v[:, 32 * w])
    return out


def _emulate(x: torch.Tensor, precision: str) -> torch.Tensor:
    rows, n = x.shape
    plan = tiling.softmax_rows_plan(n, True)
    idx, valid = _layout(n, plan)
    r = plan.row_threads
    held = x[:, idx.clamp(max=n - 1)]                    # (rows, R, W)
    out = torch.zeros(rows, r, idx.shape[1])
    if precision == "int":
        gs = T.guard_shift_for(n)
        q = torch.where(valid, fx.quantize(held), fx.IN_MIN)
        m = _row_reduce(q.amax(-1), torch.maximum, r)
        t = T._to_log2_domain(q - m[:, None, None], fx.IN_FRAC)
        e = torch.where(valid, T._exp2_int(t) >> gs, 0)
        s = _row_reduce(e.sum(-1, dtype=I32), torch.add, r)
        log2s = T._log2_int(s.clamp(min=1), fx.EXP_FRAC - gs)
        p = T._exp2_int((t - log2s[:, None, None]).clamp(max=0))
        out = fx.dequantize(p, fx.EXP_FRAC)
    else:
        v = torch.where(valid, held, -torch.inf)
        m = _row_reduce(v.amax(-1), torch.maximum, r)
        t = (v - m[:, None, None]) * dp.LOG2E
        s = torch.zeros(rows, r)
        for i in range(idx.shape[1]):                    # a thread's words
            s = s + torch.where(valid[:, i], torch.exp2(t[..., i]), 0.0)
        s = _row_reduce(s, torch.add, r)
        out = torch.exp2(t - torch.log2(s)[:, None, None])
    y = torch.empty(rows, n)
    y[:, idx[valid]] = out[:, valid]
    return y


SHAPES = [(6, 1), (6, 31), (6, 32), (6, 33), (9, 512), (6, 513), (5, 1024),
          (4, 1025), (3, 2048), (3, 2049), (2, 8192), (2, 70000)]


@pytest.mark.parametrize("rows,n", SHAPES)
def test_emulated_softmax_rows_schemes(rows, n):
    rng = np.random.RandomState(n)
    x = (rng.randn(rows, n) * 6.0).astype(np.float32)
    x[0] = MASK                                          # all masked
    x[1, : n // 2] = MASK
    xt = torch.from_numpy(x)
    got = _emulate(xt, "int")
    assert torch.equal(got, ds.softmax_rows_plain(xt, "int"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.softmax_dualmode(jnp.asarray(x))))
    # the float mode against the port's row_softmax (which
    # tests/test_torch_unit.py holds to the reference's)
    np.testing.assert_allclose(_emulate(xt, "float").numpy(),
                               ds.softmax_rows_plain(xt, "float").numpy(),
                               atol=1e-6, rtol=0)


def test_emulated_softmax_guard_shift_at_70000():
    """A 70000-word row sets the guard shift to 1: rows of near-equal words
    whose unshifted sum would pass 2**31."""
    assert T.guard_shift_for(70000) == 1
    x = np.full((2, 70000), 31.0, np.float32)
    x[1, ::7] = MASK
    xt = torch.from_numpy(x)
    got = _emulate(xt, "int")
    assert torch.equal(got, ds.softmax_rows_plain(xt, "int"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.softmax_dualmode(jnp.asarray(x))))


# ---- the one-exponent pair form ---------------------------------------------

# unit::rom_fill's 16 (slope, intercept) pairs: exp2's 8, then log2's 8
ROM = torch.tensor(list(zip(pwl.EXP2_SLOPE_Q, pwl.EXP2_INTERCEPT_Q))
                   + list(zip(pwl.LOG2_SLOPE_Q, pwl.LOG2_INTERCEPT_Q)),
                   dtype=I32)
C0 = _build.pair_c0()


def _pwl(ab, frac, frac_bits, out_frac):
    prod = (ab[..., 0] * frac) >> (pwl.COEF_FRAC + frac_bits - out_frac)
    if pwl.COEF_FRAC >= out_frac:
        return prod + (ab[..., 1] >> (pwl.COEF_FRAC - out_frac))
    return prod + (ab[..., 1] << (out_frac - pwl.COEF_FRAC))


def _exp2_int(t):
    frac = t & ((1 << fx.T_FRAC) - 1)
    e = _pwl(ROM[((frac >> (fx.T_FRAC - 3)) & 7).long()], frac, fx.T_FRAC,
             fx.EXP_FRAC)
    return fx.sat_rshift(e, -(t >> fx.T_FRAC))


def _log2_int(s, s_frac):
    e_pos = (torch.frexp(s.to(torch.float64)).exponent - 1).to(I32)  # s >= 1
    f = fx.mantissa_frac(s, e_pos)
    log2m = _pwl(ROM[8 + ((f >> (fx.T_FRAC - 3)) & 7).long()], f, fx.T_FRAC,
                 fx.T_FRAC)
    return ((e_pos - s_frac) << fx.T_FRAC) + log2m


def _pair_one_exp(k, k_frac):
    a = k.abs()
    t = T._to_log2_domain(-a - a, k_frac)
    s = C0 + _exp2_int(t)
    w = torch.where(k < 0, t, 0) - _log2_int(s, fx.EXP_FRAC)
    return _exp2_int(w.clamp(max=0))


ALL_WORDS = np.arange(fx.IN_MIN, fx.IN_MAX + 1, dtype=np.int32)


@pytest.mark.parametrize("mode", ["gelu", "silu"])
def test_one_exponent_pair_form_every_word(mode):
    q = torch.from_numpy(ALL_WORDS)
    if mode == "gelu":
        sig = _pair_one_exp(T.gelu_k_int(q), fx.IN_FRAC)
        want_j, want_t = J.gelu_int(jnp.asarray(ALL_WORDS)), T.gelu_int(q)
    else:
        sig = _pair_one_exp(q, fx.IN_FRAC + 1)
        want_j, want_t = J.silu_int(jnp.asarray(ALL_WORDS)), T.silu_int(q)
    got = (q * sig) >> fx.EXP_FRAC
    assert got.dtype == I32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_j))
    assert torch.equal(got, want_t)
    # the pair sum never falls below PAIR_C0, so the reference's clamp of
    # the sum at 1 never acts
    k = T.gelu_k_int(q) if mode == "gelu" else q
    kf = fx.IN_FRAC if mode == "gelu" else fx.IN_FRAC + 1
    assert int((C0 + _exp2_int(T._to_log2_domain(-2 * k.abs(), kf))).min()) \
        >= C0 >= 1


def test_pair_c0_is_exp2_of_zero():
    assert C0 == int(J._exp2_int(jnp.int32(0)))
    assert C0 == int(T._exp2_int(torch.zeros(1, dtype=I32))[0])
    assert f"constexpr int32_t PAIR_C0 = {C0};" in _build.generated_header()


def test_rom_table_lookups_equal_the_select_chains():
    """The shared-memory lookup (segment & 7) against the plain version's
    mux over every fraction word the two PWLs see."""
    v = torch.arange(1 << fx.T_FRAC, dtype=I32)
    assert torch.equal(_exp2_int(-v), T._exp2_int(-v))
    s = torch.arange(1, 1 << 17, dtype=I32)
    assert torch.equal(_log2_int(s, fx.EXP_FRAC), T._log2_int(s, fx.EXP_FRAC))
