"""The port's bert-base path held to the JAX reference on the same inputs:
reduced bert-base through ``lm_apply`` (converted weights, numpy tokens),
the i-GELU integers, the blocked three-sweep int folds and the plain
version of the three-sweep int flash kernel (row 9), and its dispatch
contract.

Tolerances: float logits and hidden states <= 1e-5 (f32 matmul and
reduction orders).  The dual-mode and i-GELU configurations quantize
activations to S5.10 words: a q.k score or an FFN activation within an
ulp of a quantize boundary rounds to the neighbouring word when XLA and
PyTorch sum a dot product in other orders, and each flip moves one
value by ~2^-10.  i-GELU is held at 2e-3.  Dual-mode bert flips words in
both the attention softmax and the GELU mode; on reduced bert its logits
moved by 2.8e-4 to 2.17e-3 over 8 seeds (2 x 40 tokens), so it is held
at 5e-3, the full-width dual-mode limit of chip_smoke.py.  Int words are
bitwise.  Row 9 is held to the naive ``softmax_impl='dualmode'``
attention (not to the reference's Pallas kernel): bitwise under an
identity-v probe with grid-valued q and k (multiples of 2^-4 and a
power-of-two scale, so every score is exact in f32), 5e-3 on random
inputs (a flipped score word).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as J_registry
from repro.core import igelu as J_igelu
from repro.core import softmax_unit as J_unit
from repro.kernels.flash_attention_int import \
    flash_attention_pallas_int3 as j_fapi3
from repro.models import transformer as J_tf
from repro.models.attention import _naive_sdpa as j_naive
from repro_torch.configs import registry as T_registry
from repro_torch.core import activations as T_act
from repro_torch.core import igelu as T_igelu
from repro_torch.core import softmax_unit as T_unit
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention_int import \
    flash_attention_pallas_int3
from repro_torch.models.attention import _naive_sdpa as t_naive
from repro_torch.models.attention import _sdpa as t_sdpa
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_lm, lm_apply

TOL_FLOAT = 1e-5
TOL_IGELU = 2e-3
TOL_DUALMODE = 5e-3
TOL_FLASH_I = 5e-3

# (softmax_impl, activation, limit): the float, erf, 'Proposed' and
# 'i-GELU' models of the paper's Table I
CONFIGS = {"gelu_tanh": ("float", "gelu_tanh", TOL_FLOAT),
           "gelu_exact": ("float", "gelu_exact", TOL_FLOAT),
           "dualmode": ("dualmode", "gelu_dualmode", TOL_DUALMODE),
           "igelu": ("float", "igelu", TOL_IGELU)}


def _bert(seed, **over):
    jcfg = J_registry.reduced_config("bert-base").replace(**over)
    jp = J_tf.init_lm(jax.random.PRNGKey(seed), jcfg)
    tcfg = T_registry.reduced_config("bert-base").replace(**over)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.RandomState(seed).randint(0, jcfg.vocab, (2, 40))
    return jcfg, tcfg, jp, tp, toks


def _both(jcfg, tcfg, jp, tp, toks, t_over=None, **kw):
    """(reference, port) outputs of lm_apply on the same tokens."""
    want = J_tf.lm_apply(jp, jcfg, jnp.asarray(toks, jnp.int32), **kw)[0]
    got = lm_apply(tp, tcfg if t_over is None else tcfg.replace(**t_over),
                   torch.from_numpy(toks), device="cpu", **kw)[0]
    return np.asarray(want), got.numpy()


# ---------------- the model ----------------

def test_bert_config_and_params_layout():
    cfg = T_registry.get_config("bert-base")
    assert "bert-base" not in T_registry.ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab,
            cfg.max_seq) == (12, 768, 12, 3072, 30522, 512)
    jcfg, tcfg, jp, tp, _ = _bert(0)
    np.testing.assert_array_equal(tp["pos"].numpy(), np.asarray(jp["pos"]))
    own = init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa
    assert shapes(own) == shapes(tp)
    assert float(own["layers"][0]["norm1"]["b"].abs().sum()) == 0.0
    assert own["pos"].shape == (tcfg.max_seq, tcfg.d_model)


@pytest.mark.parametrize("norm_impl", ["dense", "fused_pallas"])
@pytest.mark.parametrize("path", list(CONFIGS))
def test_bert_lm_apply_matches_reference(path, norm_impl):
    """Logits and the Table I hidden states (return_hidden); the port's
    'fused_pallas' seams (their plain versions on the CPU, layer-norm
    kind) against the reference's dense norms."""
    sm, act, tol = CONFIGS[path]
    jcfg, tcfg, jp, tp, toks = _bert(0, softmax_impl=sm, activation=act)
    over = {"norm_impl": norm_impl}
    for kw in ({}, {"return_hidden": True}):
        want, got = _both(jcfg, tcfg, jp, tp, toks, t_over=over, **kw)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_bert_int3_path_matches_reference_naive_dualmode():
    """attn_impl='flash_pallas_int3' (the plain version on the CPU)
    against the reference's naive dual-mode model: the same words."""
    jcfg, tcfg, jp, tp, toks = _bert(2, softmax_impl="dualmode",
                                     activation="gelu_dualmode")
    want, got = _both(jcfg, tcfg, jp, tp, toks,
                      t_over={"attn_impl": "flash_pallas_int3"},
                      return_hidden=True)
    np.testing.assert_allclose(got, want, atol=TOL_DUALMODE, rtol=0)


def test_prenorm_fallback_applies_the_layer_norm():
    """A QKV bias keeps the norm -> QKV seam unfused; the fallback must
    apply the block's own norm kind (layer here), as the reference."""
    jcfg, tcfg, jp, tp, toks = _bert(3, qkv_bias=True)
    rs = np.random.RandomState(3)
    for lp in tp["layers"]:                 # non-zero gains and biases
        for key in ("norm1", "norm2"):
            lp[key]["g"] += torch.from_numpy(
                rs.randn(tcfg.d_model).astype(np.float32) * 0.1)
            lp[key]["b"] += torch.from_numpy(
                rs.randn(tcfg.d_model).astype(np.float32) * 0.1)
    periods = jax.tree.map(np.asarray, jp["periods"])
    for key in ("norm1", "norm2"):
        for w in ("g", "b"):
            periods[0][key][w] = np.stack(
                [lp[key][w].numpy() for lp in tp["layers"]])
    jp = dict(jp, periods=jax.tree.map(jnp.asarray, periods))
    want, got = _both(jcfg, tcfg, jp, tp, toks,
                      t_over={"norm_impl": "fused_pallas"})
    np.testing.assert_allclose(got, want, atol=TOL_FLOAT, rtol=0)


# ---------------- integers ----------------

def test_igelu_int_bitwise_every_word():
    words = np.arange(-(1 << 15), 1 << 15, dtype=np.int32)
    np.testing.assert_array_equal(
        T_igelu.igelu_int(torch.from_numpy(words)).numpy(),
        np.asarray(J_igelu.igelu_int(jnp.asarray(words))))


def test_igelu_float_and_activations_match_reference():
    from repro.core import activations as J_act
    z = np.random.RandomState(4).randn(4096).astype(np.float32) * 4
    # XLA's and PyTorch's f32 erf differ by a few ulps near +-1, which
    # 0.5 |x| (up to ~8 here) scales: gelu_exact within 4e-6
    for name, atol in (("igelu_float", 1e-6), ("igelu", 1e-6),
                       ("gelu_exact", 4e-6), ("relu2", 1e-6)):
        np.testing.assert_allclose(
            T_act.get_activation(name)(torch.from_numpy(z)).numpy(),
            np.asarray(J_act.get_activation(name)(jnp.asarray(z))),
            atol=atol, rtol=0)
    # the i-GELU STE: the quantized forward, gelu_tanh's gradient (1e-5,
    # as the unit's STE gradients in tests/test_torch_unit.py)
    x = torch.from_numpy(z).requires_grad_(True)
    (g,) = torch.autograd.grad(T_act.igelu(x).sum(), x)
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jax.grad(lambda a: J_act.igelu_st(a).sum())(
            jnp.asarray(z))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("block", [3, 16, 64, 100])
def test_blocked_folds_bitwise(block):
    """The three-sweep folds and the snapped monoid fold, any block (a
    ragged last one included), against the reference's and the whole
    row's."""
    rs = np.random.RandomState(5)
    x = rs.randint(-(1 << 15), 1 << 15, size=(3, 100)).astype(np.int32)
    x[1, :60] = J_unit.PHANTOM_Q                 # phantom keys: no mass
    x[2] = -30 << 10                             # an all-masked row
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    got = T_unit.softmax_int_blocked(tx, block)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J_unit.softmax_int_blocked(jx, block)))
    np.testing.assert_array_equal(got.numpy(),
                                  T_unit.softmax_int(tx).numpy())
    snap = T_unit.softmax_snap_blocked(tx, block)
    np.testing.assert_array_equal(
        snap.numpy(), np.asarray(J_unit.softmax_snap_blocked(jx, block)))
    np.testing.assert_array_equal(snap.numpy(),
                                  T_unit.softmax_snap(tx).numpy())
    m = torch.full((3, 1), T_unit.PHANTOM_Q, dtype=torch.int32)
    jm = jnp.full((3, 1), J_unit.PHANTOM_Q, jnp.int32)
    for i in range(0, 100, block):
        m = T_unit.online_max_int(m, tx[:, i:i + block])
        jm = J_unit.online_max_int(jm, jx[:, i:i + block])
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    l, jl = torch.zeros_like(m), jnp.zeros_like(jm)
    for i in range(0, 100, block):
        l = T_unit.online_sum_int(l, m, tx[:, i:i + block], 2)
        jl = J_unit.online_sum_int(jl, jm, jx[:, i:i + block], 2)
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        T_unit.online_probs_int(m, l, tx, 2).numpy(),
        np.asarray(J_unit.online_probs_int(jm, jl, jx, 2)))


# ---------------- row 9: the three-sweep int flash, plain version ------

def _attn(seed, b, s, t, kh, g, h, hv=None, grid=False, causal_end=None):
    """q (B,S,K,G,h), k (B,T,K,h), v (B,T,K,hv); q_pos ending at
    ``causal_end`` (default T); a quarter of the keys invalid."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, kh, g, h)
    k = rs.randn(b, t, kh, h)
    if grid:                       # multiples of 2^-4: exact scores
        q, k = np.round(q * 4) / 16, np.round(k * 4) / 16
    v = rs.randn(b, t, kh, hv or h)
    end = t if causal_end is None else causal_end
    qp = np.broadcast_to(np.arange(end - s, end)[None], (b, s))
    valid = rs.rand(b, t) > 0.25
    return (q.astype(np.float32), k.astype(np.float32), v.astype(np.float32),
            np.ascontiguousarray(qp, np.int32), valid)


def _eye(b, t, kh):
    return np.broadcast_to(np.eye(t, dtype=np.float32)[None, :, None, :],
                           (b, t, kh, t)).copy()


def _row9(q, k, v, qp, valid, causal, block_kv=None):
    return flash_attention_pallas_int3(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v)),
        q_pos=torch.from_numpy(qp), kv_valid=torch.from_numpy(valid),
        causal=causal, block_kv=block_kv).numpy()


def _naive_dualmode(q, k, v, qp, valid, causal):
    return np.asarray(j_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_pos=jnp.asarray(qp),
                              kv_valid=jnp.asarray(valid), causal=causal,
                              softmax_impl="dualmode"))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_kv", [7, 16, 64])
def test_int3_plain_words_bitwise_identity_v(causal, block_kv):
    """Every output is one probability word: bitwise the whole-row
    softmax_int words, G > 1, T off the tile grid, the causal tail and a
    row whose only visible key is masked included."""
    b, s, t, kh, g, h = 2, 24, 40, 2, 2, 16
    q, k, _, qp, valid = _attn(6, b, s, t, kh, g, h, grid=True,
                               causal_end=s)
    valid[:, 0] = False
    v = _eye(b, t, kh)
    np.testing.assert_array_equal(
        _row9(q, k, v, qp, valid, causal, block_kv),
        _naive_dualmode(q, k, v, qp, valid, causal))


@pytest.mark.parametrize("shape", [(2, 24, 40, 2, 2, 16, None),
                                   (1, 17, 133, 2, 1, 64, 24),
                                   (1, 70, 70, 2, 1, 16, None)])
@pytest.mark.parametrize("causal", [True, False])
def test_int3_plain_vs_naive_dualmode_random(shape, causal):
    b, s, t, kh, g, h, hv = shape
    args = _attn(7, b, s, t, kh, g, h, hv)
    np.testing.assert_allclose(_row9(*args, causal),
                               _naive_dualmode(*args, causal),
                               atol=TOL_FLASH_I, rtol=0)


def test_int3_plain_guard_shift_long_row():
    """65600 keys: the guard shift turns on (1), from the unpadded T."""
    t = 65600
    assert T_unit.guard_shift_for(t) == 1
    q, k, _, qp, valid = _attn(8, 1, 3, t, 1, 1, 16, grid=True)
    v = np.zeros((1, t, 1, 4), np.float32)
    v[0, :, 0, 0] = 1.0                        # the row sums of the words
    v[0, t - 4:, 0, 1:] = np.eye(4, dtype=np.float32)[:, 1:]
    np.testing.assert_array_equal(_row9(q, k, v, qp, valid, True),
                                  _naive_dualmode(q, k, v, qp, valid, True))


def test_int3_plain_vs_pallas_interpret_tiny():
    """One tiny case against the reference's Pallas kernel (interpret
    mode) on the grid-valued identity-v probe."""
    b, s, t, kh, g, h = 1, 12, 20, 2, 2, 16
    q, k, _, qp, valid = _attn(9, b, s, t, kh, g, h, grid=True)
    v = _eye(b, t, kh)
    want = np.asarray(j_fapi3(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), q_pos=jnp.asarray(qp),
                              kv_valid=jnp.asarray(valid), block_q=8,
                              block_kv=128, interpret=True))
    np.testing.assert_array_equal(_row9(q, k, v, qp, valid, True, 16), want)


# ---------------- dispatch ----------------

def test_int3_dispatch_contract():
    """'flash_pallas_int3' honors 'dualmode' only and refuses a gradient,
    as the reference's table says; 'auto' never picks it."""
    assert dispatch.resolve_attention("flash_pallas_int3", 64, 64,
                                      softmax_impl="dualmode") == \
        "flash_pallas_int3"
    for sm in ("float", "dualmode_snap"):
        with pytest.raises(ValueError):
            dispatch.resolve_attention("flash_pallas_int3", 64, 64,
                                       softmax_impl=sm)
    q, k, v, qp, valid = (torch.from_numpy(np.ascontiguousarray(a))
                          for a in _attn(11, 1, 4, 8, 1, 1, 16))
    entry = dispatch.get_attention("flash_pallas_int3")
    for sm in ("float", "dualmode_snap"):
        with pytest.raises(ValueError):
            entry(q, k, v, q_pos=qp, kv_valid=valid, causal=True, scale=None,
                  softmax_impl=sm)
    assert not dispatch.attention_grad("flash_pallas_int3")
    with pytest.raises(ValueError, match="forward-only"):
        t_sdpa(q.requires_grad_(True), k, v, q_pos=qp, kv_valid=valid,
               softmax_impl="dualmode", attn_impl="flash_pallas_int3")
    with torch.no_grad():
        got = t_sdpa(q, k, v, q_pos=qp, kv_valid=valid,
                     softmax_impl="dualmode", attn_impl="flash_pallas_int3")
    want = t_naive(q, k, v, q_pos=qp, kv_valid=valid,
                   softmax_impl="dualmode")
    torch.testing.assert_close(got, want, atol=TOL_FLASH_I, rtol=0)
