"""The port's unit numerics (repro_torch.core, kernels.datapath) held to
the JAX reference on the same inputs.

Tolerances: int words bitwise; float datapath functions <= 1e-6 absolute
(exp2/log2/sigmoid differ between XLA and PyTorch by a few ulps).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import activations as J_act
from repro.core import fixedpoint as J_fx
from repro.core import pwl as J_pwl
from repro.core import softmax_unit as J
from repro.kernels import datapath as J_dp
from repro_torch.core import activations as T_act
from repro_torch.core import fixedpoint as T_fx
from repro_torch.core import pwl as T_pwl
from repro_torch.core import softmax_unit as T
from repro_torch.kernels import datapath as T_dp


def _same(a, b):
    """Bitwise: same dtype, same words."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _words(seed, shape, scale=6.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return x, J_fx.quantize(jnp.asarray(x)), T_fx.quantize(torch.from_numpy(x))


ALL_WORDS = np.arange(J_fx.IN_MIN, J_fx.IN_MAX + 1, dtype=np.int32)


@pytest.mark.parametrize("name", ["EXP2_SLOPE_Q", "EXP2_INTERCEPT_Q",
                                  "LOG2_SLOPE_Q", "LOG2_INTERCEPT_Q",
                                  "EXP2_SLOPE_F", "EXP2_INTERCEPT_F",
                                  "LOG2_SLOPE_F", "LOG2_INTERCEPT_F"])
def test_pwl_rom_tables_equal_reference(name):
    """The port's literal ROM words are the reference's polyfit tables."""
    np.testing.assert_array_equal(np.asarray(getattr(T_pwl, name)),
                                  getattr(J_pwl, name))


def test_unit_constants_equal_reference():
    for n in ("LOG2E_Q", "GELU_A_Q", "GELU_C_Q", "PHANTOM_Q", "SNAP_MIN",
              "N_SNAP_BUCKETS"):
        assert getattr(T, n) == getattr(J, n), n
    for n in ("IN_FRAC", "IN_MIN", "IN_MAX", "EXP_FRAC", "T_FRAC"):
        assert getattr(T_fx, n) == getattr(J_fx, n), n
    for n in ("LOG2E", "SQRT_2_OVER_PI", "GELU_CUBIC", "MASK_VALUE"):
        assert getattr(T_dp, n) == getattr(J_dp, n), n


def test_quantize_ties_and_rails_bitwise():
    """Round half-to-even at the .5 ties, saturation at the S5.10 rails."""
    ties = np.array([k + 0.5 for k in range(-6, 6)], np.float64) / 1024
    x = np.concatenate([ties, [-1e9, -40.0, -32.0, -32.0005, 31.999,
                               32.0, 40.0, 1e9, 0.0, -0.0]]).astype(
        np.float32)
    _same(J_fx.quantize(jnp.asarray(x)), T_fx.quantize(torch.from_numpy(x)))
    _same(J_fx.dequantize(J_fx.quantize(jnp.asarray(x))),
          T_fx.dequantize(T_fx.quantize(torch.from_numpy(x))))


def test_fixedpoint_helpers_bitwise():
    v = np.concatenate([np.arange(-3, 70000, 7), [2 ** 30, 2 ** 31 - 1]]
                       ).astype(np.int32)
    e_j, e_t = J_fx.floor_log2(jnp.asarray(v)), T_fx.floor_log2(
        torch.from_numpy(v))
    _same(e_j, e_t)
    pos = np.maximum(v, 1)
    _same(J_fx.mantissa_frac(jnp.asarray(pos), J_fx.floor_log2(
        jnp.asarray(pos))), T_fx.mantissa_frac(
        torch.from_numpy(pos), T_fx.floor_log2(torch.from_numpy(pos))))
    n = np.arange(-5, 40, dtype=np.int32)
    x = np.full_like(n, -123457)
    _same(J_fx.sat_rshift(jnp.asarray(x), jnp.asarray(n)),
          T_fx.sat_rshift(torch.from_numpy(x), torch.from_numpy(n)))


@pytest.mark.parametrize("fn", ["exp2_frac_int", "log2_mant_int"])
def test_pwl_int_bitwise_whole_domain(fn):
    f = np.arange(0, 1 << 16, dtype=np.int32)
    _same(getattr(J_pwl, fn)(jnp.asarray(f)),
          getattr(T_pwl, fn)(torch.from_numpy(f)))


@pytest.mark.parametrize("fn", ["exp2_frac_float", "log2_mant_float"])
def test_pwl_float_twins(fn):
    v = np.linspace(0, 1, 4097, endpoint=False).astype(np.float32)
    np.testing.assert_allclose(np.asarray(getattr(J_pwl, fn)(jnp.asarray(v))),
                               getattr(T_pwl, fn)(torch.from_numpy(v)),
                               atol=1e-7)


@pytest.mark.parametrize("shape", [(3, 1), (5, 7), (4, 300), (2, 70000)])
def test_softmax_int_bitwise(shape):
    """Whole-row normal mode, incl. a row long enough for guard_shift 1."""
    _, qj, qt = _words(0, shape)
    _same(J.softmax_int(qj), T.softmax_int(qt))


@pytest.mark.parametrize("fn", ["gelu_int", "silu_int"])
def test_pair_modes_bitwise_every_word(fn):
    """GELU/SiLU mode over all 65536 S5.10 words."""
    _same(getattr(J, fn)(jnp.asarray(ALL_WORDS)),
          getattr(T, fn)(torch.from_numpy(ALL_WORDS)))


@pytest.mark.parametrize("fn", ["softmax_dualmode", "softmax_dualmode_snap",
                                "gelu_dualmode", "silu_dualmode"])
def test_float_wrappers_bitwise(fn):
    x, _, _ = _words(1, (6, 130))
    _same(getattr(J, fn)(jnp.asarray(x)), getattr(T, fn)(torch.from_numpy(x)))


def test_snap_monoid_bitwise():
    """Partials, pairwise and n-way merges, the bucket finish and the
    whole-row snapped probabilities, with PHANTOM_Q sentinels mixed in."""
    _, qj, qt = _words(2, (3, 96), scale=10.0)
    qj = qj.at[:, -5:].set(J.PHANTOM_Q)
    qt[:, -5:] = T.PHANTOM_Q
    v = np.random.RandomState(8).randn(3, 96, 4).astype(np.float32)
    blocks = [(0, 40), (40, 41), (41, 96)]
    pj = [J.online_partial_int(qj[:, a:b], 0, v=jnp.asarray(v[:, a:b]))
          for a, b in blocks]
    pt = [T.online_partial_int(qt[:, a:b], 0, v=torch.from_numpy(v[:, a:b]))
          for a, b in blocks]
    for a, b in zip(pj, pt):
        _same(a[0], b[0])
        _same(a[1], b[1])
        # acc = exact (unnormalized) numerators @ v: the f32 dot order
        # differs, relative 1e-6
        np.testing.assert_allclose(np.asarray(a[2]), b[2], rtol=1e-6)
    mj = J.online_merge_int(J.online_merge_int(pj[0], pj[1]), pj[2])
    mt = T.online_merge_int(T.online_merge_int(pt[0], pt[1]), pt[2])
    _same(mj[0], mt[0])
    _same(mj[1], mt[1])
    np.testing.assert_allclose(np.asarray(mj[2]), mt[2], rtol=1e-6)
    nj = J.online_merge_n_int(*[jnp.stack([p[i] for p in pj])
                                for i in range(3)])
    nt = T.online_merge_n_int(*[torch.stack([p[i] for p in pt])
                                for i in range(3)])
    _same(nj[0], nt[0])
    _same(nj[1], nt[1])
    np.testing.assert_allclose(np.asarray(nj[2]), nt[2], rtol=1e-6)
    _same(J.online_finish_int(nj[1]), T.online_finish_int(nt[1]))
    _same(J.softmax_snap(qj), T.softmax_snap(qt))
    S = np.random.RandomState(3).randint(0, 1 << 20, (4, 16)).astype(np.int32)
    k = np.array([[0], [3], [15], [40]], np.int32)
    _same(J.slide_buckets_int(jnp.asarray(S), jnp.asarray(k)),
          T.slide_buckets_int(torch.from_numpy(S), torch.from_numpy(k)))
    d = np.arange(-2, 300, dtype=np.int32)
    _same(J.snap_scale_f32(jnp.asarray(d)),
          T.snap_scale_f32(torch.from_numpy(d)))


@pytest.mark.parametrize("fn", ["row_softmax", "gelu", "silu",
                                "pair_sigmoid", "gelu_k"])
def test_float_datapath(fn):
    x, _, _ = _words(4, (5, 64), scale=3.0)
    np.testing.assert_allclose(np.asarray(getattr(J_dp, fn)(jnp.asarray(x))),
                               getattr(T_dp, fn)(torch.from_numpy(x)),
                               atol=1e-6, rtol=1e-6)


def test_online_softmax_fold_and_rmsnorm():
    rs = np.random.RandomState(5)
    m = rs.randn(4, 3, 1).astype(np.float32)
    l = rs.rand(4, 3, 1).astype(np.float32) + 0.5
    acc = rs.randn(4, 3, 8).astype(np.float32)
    for x, y in zip(J_dp.online_softmax_merge_n(*map(jnp.asarray, (m, l, acc))),
                    T_dp.online_softmax_merge_n(*map(torch.from_numpy,
                                                    (m, l, acc)))):
        np.testing.assert_allclose(np.asarray(x), y, atol=1e-6, rtol=1e-6)
    s = rs.randn(3, 16).astype(np.float32)
    for x, y in zip(J_dp.online_softmax_partial(jnp.asarray(s)),
                    T_dp.online_softmax_partial(torch.from_numpy(s))):
        np.testing.assert_allclose(np.asarray(x), y, atol=1e-6, rtol=1e-6)
    g = rs.rand(16).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        np.asarray(J_dp.rmsnorm(jnp.asarray(s), jnp.asarray(g), 1e-6)),
        T_dp.rmsnorm(torch.from_numpy(s), torch.from_numpy(g), 1e-6),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["gelu_dualmode", "silu_dualmode",
                                  "gelu_tanh", "silu"])
def test_activations_forward_and_ste_gradient(name):
    """Forward: the reference's STE expression s + (q - s), which is not
    always exactly q; a surrogate that differs by an ulp between XLA and
    PyTorch can move it by one ulp of the output, so <= 1e-6.  Backward:
    the float surrogate's gradient, <= 1e-5."""
    x, _, _ = _words(6, (4, 50), scale=3.0)
    jf = getattr(J_act, name)
    tf = getattr(T_act, name)
    np.testing.assert_allclose(np.asarray(jf(jnp.asarray(x))),
                               tf(torch.from_numpy(x)).detach(), atol=1e-6)
    gj = jax.grad(lambda v: jnp.sum(jf(v) * jnp.arange(v.size).reshape(
        v.shape)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tf(xt) * torch.arange(x.size).reshape(x.shape)).sum().backward()
    np.testing.assert_allclose(np.asarray(gj), xt.grad.numpy(), rtol=1e-5,
                               atol=1e-5 * x.size)


def test_dualmode_ste_forward_is_the_unit_words_up_to_the_surrogate():
    """s + (q - s) equals q to within one f32 rounding of s."""
    x, _, _ = _words(7, (3, 40), scale=3.0)
    q = T.silu_dualmode(torch.from_numpy(x))
    y = T_act.silu_dualmode(torch.from_numpy(x))
    assert float((y - q).abs().max()) <= 4 * float(
        torch.finfo(torch.float32).eps) * (1 + float(q.abs().max()))
    assert math.isfinite(float(y.sum()))
