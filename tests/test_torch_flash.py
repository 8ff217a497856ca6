"""The port's blocked attention and contiguous decode kernels, through
their wrappers on CPU tensors (the plain versions), held to the JAX
reference on the same inputs:

  flash_fwd         vs models.flash.flash_attention and _naive_sdpa
  flash_snap        vs naive 'dualmode_snap' (the whole-row snapped unit)
  decode_dense(_int) vs flash_attention_merged / naive 'dualmode_snap'

plus one tiny case of each against the reference's Pallas kernel in
interpret mode.

Tolerances: float attention <= 1e-5 (f32 dot and sum orders); int words
(m, S, l and, under the identity-v probe, every output) bitwise; int
outputs <= 1e-6 (equal words, only the f32 numerator @ v summation order
differs).  The int cases use grid-valued q and k (multiples of 2^-4), so
every score is exact in both frameworks: with random q.k a score within
an ulp of an S5.10 quantize boundary can round to the other word when
XLA and PyTorch sum the dot in other orders (ROADMAP Queue 3).  The
blocked plain versions sweep every KV tile, as the reference does (the
CUDA kernels skip a causal row's masked tail and fold it back in closed
form; the GPU tests hold that fold to these sweeps).  The decode kernels
and their plain versions skip, per row, the tiles that start past its
q_pos, as the reference's decode does, so against a full sweep the
identity-v probe compares the visited keys bitwise and finds zeros on
the skipped ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import softmax_unit as J
from repro.kernels import datapath as J_dp
from repro.kernels.flash_attention import flash_attention_pallas as j_fap
from repro.kernels.flash_attention_int import \
    flash_attention_pallas_int as j_fapi
from repro.kernels.flash_decode import flash_decode_pallas as j_fdp
from repro.models.attention import _naive_sdpa
from repro.models.flash import flash_attention as j_flash
from repro.models.flash import flash_attention_merged as j_merged
from repro_torch.core import softmax_unit as T
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import tiling
from repro_torch.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels.flash_attention_int import (
    flash_attention_pallas_int, slide_lanes, snap_tile_update)


def _case(seed, b, s, t, kh, g, h, hv=None, grid=False, ragged=True,
          q_pos=None):
    """q (B,S,K,G,h), k (B,T,K,h), v (B,T,K,hv), q_pos (B,S) ending at the
    cache end, kv_valid (B,T) with invalid keys when ``ragged``."""
    rs = np.random.RandomState(seed)
    hv = hv or h
    q = rs.randn(b, s, kh, g, h)
    k = rs.randn(b, t, kh, h)
    if grid:                       # multiples of 2^-4: exact scores
        q, k = np.round(q * 4) / 16, np.round(k * 4) / 16
    v = rs.randn(b, t, kh, hv)
    if q_pos is None:
        q_pos = np.broadcast_to(np.arange(t - s, t)[None], (b, s))
    valid = rs.rand(b, t) > (0.25 if ragged else -1.0)
    return (q.astype(np.float32), k.astype(np.float32), v.astype(np.float32),
            np.ascontiguousarray(q_pos, np.int32), valid)


def _identity_v(b, t, kh):
    """v = per-head identity: the output IS the probability words."""
    return np.broadcast_to(np.eye(t, dtype=np.float32)[None, :, None, :],
                           (b, t, kh, t)).copy()


def _j(*a):
    return tuple(jnp.asarray(x) for x in a)


def _t(*a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)


def _visited(q_pos, bkv, t):
    """Per (b, s): keys of the tiles a causal sweep visits."""
    return np.minimum((q_pos // bkv + 1) * bkv, t)


SHAPES = [
    # b, s, t, kh, g, h, hv
    (2, 24, 40, 2, 2, 8, None),     # G > 1, T off the tile grid
    (1, 17, 133, 2, 1, 16, None),   # ragged last tile
    (2, 8, 64, 1, 3, 8, 12),        # G = 3, hv != h
    (1, 70, 70, 2, 1, 16, None),    # prefill: S = T, > one q tile
]


# ---------------- row 7: blocked float ----------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block_kv", [16, 64])
def test_flash_fwd_plain_vs_reference_flash_and_naive(shape, causal,
                                                      block_kv):
    b, s, t, kh, g, h, hv = shape
    q, k, v, qp, valid = _case(0, b, s, t, kh, g, h, hv)
    jq, jk, jv, jqp, jvalid = _j(q, k, v, qp, valid)
    got = flash_attention_pallas(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                 kv_valid=torch.from_numpy(valid),
                                 causal=causal, block_kv=block_kv).numpy()
    for want in (j_flash(jq, jk, jv, q_pos=jqp, kv_valid=jvalid,
                         causal=causal, block=32),
                 _naive_sdpa(jq, jk, jv, q_pos=jqp, kv_valid=jvalid,
                             causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_flash_fwd_stats_match_reference():
    """The (m, l) row statistics of the pre-scaled scores, (B, K, G, S)."""
    q, k, v, qp, valid = _case(1, 2, 24, 40, 2, 2, 8)
    want = j_flash(*_j(q, k, v), q_pos=jnp.asarray(qp),
                   kv_valid=jnp.asarray(valid), block=16, return_stats=True)
    got = flash_attention_pallas(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                 kv_valid=torch.from_numpy(valid),
                                 block_kv=16, return_stats=True)
    for a, b_ in zip(want, got):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a), atol=1e-5)


def test_flash_fwd_vs_pallas_interpret_tiny():
    q, k, v, qp, valid = _case(2, 1, 12, 20, 2, 2, 8)
    want = j_fap(*_j(q, k, v), q_pos=jnp.asarray(qp),
                 kv_valid=jnp.asarray(valid), block_q=8, block_kv=128,
                 interpret=True)
    got = flash_attention_pallas(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                 kv_valid=torch.from_numpy(valid),
                                 block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flash_fwd_all_masked_rows_and_empty_causal_rows():
    """A row whose every key is invalid attends uniformly (MASK_VALUE
    carries mass, as in naive); keys past T carry none."""
    q, k, v, qp, valid = _case(3, 1, 6, 37, 1, 1, 8)
    valid[:] = False
    want = _naive_sdpa(*_j(q, k, v), q_pos=jnp.asarray(qp),
                       kv_valid=jnp.asarray(valid), causal=False)
    got = flash_attention_pallas(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                 kv_valid=torch.from_numpy(valid),
                                 causal=False, block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------- row 8: one-sweep snapped int ----------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_snap_plain_vs_naive_dualmode_snap(shape, causal):
    b, s, t, kh, g, h, hv = shape
    q, k, v, qp, valid = _case(4, b, s, t, kh, g, h, hv, grid=True)
    want = _naive_sdpa(*_j(q, k, v), q_pos=jnp.asarray(qp),
                       kv_valid=jnp.asarray(valid), causal=causal,
                       softmax_impl="dualmode_snap")
    got = flash_attention_pallas_int(
        *_t(q, k, v), q_pos=torch.from_numpy(qp),
        kv_valid=torch.from_numpy(valid), causal=causal, block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_kv", [7, 16, 64])
def test_flash_snap_words_bitwise_identity_v(causal, block_kv):
    """Every output is one p * 2^-d / l word: bitwise the whole-row
    snapped unit's for any tile width, the masked causal tail included."""
    b, s, t, kh, g, h = 2, 24, 40, 2, 2, 8
    q, k, _, qp, valid = _case(5, b, s, t, kh, g, h, grid=True)
    v = _identity_v(b, t, kh)
    want = np.asarray(_naive_sdpa(*_j(q, k, v), q_pos=jnp.asarray(qp),
                                  kv_valid=jnp.asarray(valid), causal=causal,
                                  softmax_impl="dualmode_snap"))
    got = flash_attention_pallas_int(
        *_t(q, k, v), q_pos=torch.from_numpy(qp),
        kv_valid=torch.from_numpy(valid), causal=causal,
        block_kv=block_kv).numpy()
    np.testing.assert_array_equal(got, want)


def test_flash_snap_partial_words_tile_invariant_and_whole_row():
    """(m, S) words do not depend on the tile; l equals the whole-row
    unit's over the masked score words."""
    b, s, t, kh, g, h = 2, 10, 45, 2, 2, 8
    q, k, v, qp, valid = _case(6, b, s, t, kh, g, h, grid=True)
    parts = [flash_attention_pallas_int(
        *_t(q, k, v), q_pos=torch.from_numpy(qp),
        kv_valid=torch.from_numpy(valid), block_kv=bkv, return_partial=True)
        for bkv in (5, 16, 64)]
    l0 = T.online_finish_int(parts[0][2]).to(torch.float32)
    l0 = l0.permute(0, 3, 1, 2)[..., None]                  # (B, S, K, G, 1)
    for acc, m, S in parts[1:]:
        assert torch.equal(m, parts[0][1]) and torch.equal(S, parts[0][2])
        np.testing.assert_allclose((acc / l0).numpy(),
                                   (parts[0][0] / l0).numpy(), atol=1e-6)
    sc = np.einsum("bskgh,btkh->bkgst", q * h ** -0.5, k)
    live = valid[:, None, :] & (np.arange(t)[None, None, :] <= qp[:, :, None])
    sc = np.where(live[:, None, None], sc, J_dp.MASK_VALUE)
    _, _, l_ref = J.snap_row_stats(J.quantize(jnp.asarray(sc.astype(
        np.float32))), guard_shift=0)
    np.testing.assert_array_equal(T.online_finish_int(parts[0][2]).numpy(),
                                  np.asarray(l_ref)[..., 0])


def test_flash_snap_guard_shift_from_the_full_extent():
    """T = 70000 keys: guard_shift = 1 from T, however few are valid."""
    b, s, t, kh, g, h = 1, 2, 70000, 1, 1, 8
    q, k, v, qp, valid = _case(7, b, s, t, kh, g, h, grid=True)
    valid[:, 300:] = False
    assert T.guard_shift_for(t) == 1
    want = _naive_sdpa(*_j(q, k, v), q_pos=jnp.asarray(qp),
                       kv_valid=jnp.asarray(valid), causal=False,
                       softmax_impl="dualmode_snap")
    got = flash_attention_pallas_int(
        *_t(q, k, v), q_pos=torch.from_numpy(qp),
        kv_valid=torch.from_numpy(valid), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_flash_snap_vs_pallas_interpret_tiny():
    q, k, v, qp, valid = _case(8, 1, 12, 20, 2, 2, 8, grid=True)
    want = j_fapi(*_j(q, k, v), q_pos=jnp.asarray(qp),
                  kv_valid=jnp.asarray(valid), block_q=8, block_kv=128,
                  interpret=True)
    got = flash_attention_pallas_int(
        *_t(q, k, v), q_pos=torch.from_numpy(qp),
        kv_valid=torch.from_numpy(valid), block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_slide_lanes_and_tile_update_match_reference():
    """The kernel-shaped slide equals the gather slide; one tile update
    equals the reference's word for word."""
    from repro.kernels import flash_attention_int as J_fai
    rs = np.random.RandomState(9)
    S = rs.randint(0, 1 << 20, size=(5, 16)).astype(np.int32)
    kk = np.array([[0], [1], [7], [15], [40000]], np.int32)
    got = slide_lanes(torch.from_numpy(S), torch.from_numpy(kk))
    assert torch.equal(got, T.slide_buckets_int(torch.from_numpy(S),
                                                torch.from_numpy(kk)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J_fai.slide_lanes(*_j(S, kk))))
    sq = rs.randint(-30720, 9000, size=(4, 24)).astype(np.int32)
    vb = rs.randn(24, 8).astype(np.float32)
    m = np.array([[J.SNAP_MIN], [0], [1 << 16], [-(3 << 16)]], np.int32)
    S0 = rs.randint(0, 1 << 14, size=(4, 16)).astype(np.int32)
    acc = rs.randn(4, 8).astype(np.float32)
    want = J_fai.snap_tile_update(*_j(m, S0, acc, sq, vb), 0)
    have = snap_tile_update(*_t(m, S0, acc, sq, vb), 0)
    for a, b_ in zip(want[:2], have[:2]):
        np.testing.assert_array_equal(b_.numpy(), np.asarray(a))
    np.testing.assert_allclose(have[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)


# ---------------- rows 5 / 6: contiguous decode ----------------

def _decode_case(seed, b, t, kh, g, h, grid=False, hv=None):
    rs = np.random.RandomState(seed)
    qp = rs.randint(0, t, size=(b, 1))
    qp[0, 0] = t - 1
    q, k, v, _, _ = _case(seed, b, 1, t, kh, g, h, hv, grid=grid,
                          q_pos=qp)
    valid = np.arange(t)[None, :] <= qp
    return q, k, v, qp.astype(np.int32), valid


@pytest.mark.parametrize("num_splits", [1, 2, 5])
@pytest.mark.parametrize("g", [1, 2])
def test_decode_dense_float_vs_merged_and_naive(num_splits, g):
    q, k, v, qp, valid = _decode_case(10, 3, 120, 2, g, 16)
    jargs = dict(q_pos=jnp.asarray(qp), kv_valid=jnp.asarray(valid))
    got = fd.flash_decode_pallas(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                 kv_valid=torch.from_numpy(valid),
                                 num_splits=num_splits, block_kv=16).numpy()
    for want in (j_merged(*_j(q, k, v), n_splits=4, **jargs),
                 _naive_sdpa(*_j(q, k, v), **jargs)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("g", [1, 2])
def test_decode_dense_int_vs_naive_snapped_unit(num_splits, g):
    q, k, v, qp, valid = _decode_case(11, 3, 100, 2, g, 16, grid=True)
    want = _naive_sdpa(*_j(q, k, v), q_pos=jnp.asarray(qp),
                       kv_valid=jnp.asarray(valid),
                       softmax_impl="dualmode_snap")
    got = fd.flash_decode_pallas(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                 kv_valid=torch.from_numpy(valid),
                                 num_splits=num_splits, block_kv=16,
                                 softmax_impl="dualmode")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("num_splits", [1, 4])
def test_decode_dense_int_words_bitwise(num_splits):
    """m / S words of the folded partials equal the whole-row unit's over
    the masked score words, for any split count; under the identity-v
    probe every output word is bitwise too."""
    b, t, kh, g, h, bkv = 3, 90, 2, 2, 16, 16
    q, k, _, qp, valid = _decode_case(12, b, t, kh, g, h, grid=True)
    v = _identity_v(b, t, kh)
    qf = torch.from_numpy(q[:, 0] * h ** -0.5)
    m, S, _ = fd.decode_dense_partials(
        qf, *_t(k, v), torch.from_numpy(qp[:, 0]),
        torch.from_numpy(valid.astype(np.uint8)), num_splits=num_splits,
        block_kv=bkv, causal=True, int_mode=True, guard_shift=0)
    m_all, S_all, _ = T.online_merge_n_int(m[..., None], S,
                                           torch.zeros(S.shape[:-1] + (1,)),
                                           dim=1)
    sc = np.einsum("bkgh,btkh->bkgt", q[:, 0] * h ** -0.5, k)
    sc = np.where(valid[:, None, None, :], sc, J_dp.MASK_VALUE)
    m_ref, S_ref, _ = J.online_partial_int(
        J.quantize(jnp.asarray(sc.astype(np.float32))), 0)
    np.testing.assert_array_equal(m_all[:, 0, ..., 0].numpy(),
                                  np.asarray(m_ref)[..., 0])
    np.testing.assert_array_equal(S_all[:, 0].numpy(), np.asarray(S_ref))
    got = fd.flash_decode_pallas(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                 kv_valid=torch.from_numpy(valid),
                                 num_splits=num_splits, block_kv=bkv,
                                 softmax_impl="dualmode").numpy()
    want = np.asarray(_naive_sdpa(*_j(q, k, v), q_pos=jnp.asarray(qp),
                                  kv_valid=jnp.asarray(valid),
                                  softmax_impl="dualmode_snap"))
    seen = _visited(qp[:, 0], bkv, t)
    for bb in range(b):
        np.testing.assert_array_equal(got[bb, ..., :seen[bb]],
                                      want[bb, ..., :seen[bb]])
        assert not got[bb, ..., seen[bb]:].any()


@pytest.mark.parametrize("softmax_impl", ["float", "dualmode"])
def test_decode_dense_vs_pallas_interpret_tiny(softmax_impl):
    """The reference kernel keeps its one 128-key tile whole; compare the
    keys both visit under the identity-v probe (int) or the outputs at
    1e-5 (float)."""
    b, t, kh, g, h = 2, 40, 2, 2, 8
    q, k, v, qp, valid = _decode_case(13, b, t, kh, g, h,
                                      grid=softmax_impl != "float")
    if softmax_impl == "dualmode":
        v = _identity_v(b, t, kh)
    want = np.asarray(j_fdp(*_j(q, k, v), q_pos=jnp.asarray(qp),
                            kv_valid=jnp.asarray(valid), num_splits=2,
                            interpret=True, softmax_impl=softmax_impl))
    got = fd.flash_decode_pallas(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                 kv_valid=torch.from_numpy(valid),
                                 num_splits=2, block_kv=16,
                                 softmax_impl=softmax_impl).numpy()
    if softmax_impl == "float":
        np.testing.assert_allclose(got, want, atol=1e-5)
        return
    seen = _visited(qp[:, 0], 16, t)
    for bb in range(b):
        np.testing.assert_array_equal(got[bb, ..., :seen[bb]],
                                      want[bb, ..., :seen[bb]])


def test_decode_dense_splits_cut_the_live_range():
    """Every split of a shallow row in a deep cache gets work; the fold
    does not depend on the split count (l words bitwise, float 1e-6), and
    an empty split writes the merge identity."""
    b, t, kh, g, h, bkv = 2, 256, 2, 1, 16, 16
    q, k, v, qp, valid = _decode_case(14, b, t, kh, g, h, grid=True)
    qp[:, 0] = [40, 200]
    valid = np.arange(t)[None, :] <= qp
    live, inner = fd.dense_split_tiles(torch.from_numpy(qp[:, 0]),
                                       tiling.cdiv(t, bkv), bkv, 4, True)
    assert live.tolist() == [3, 13] and inner.tolist() == [1, 4]
    qf = torch.from_numpy(q[:, 0] * h ** -0.5)
    args = (qf, *_t(k, v), torch.from_numpy(qp[:, 0]),
            torch.from_numpy(valid.astype(np.uint8)))
    outs = {}
    for int_mode in (False, True):
        for ns in (1, 4):
            parts = fd.decode_dense_partials(
                *args, num_splits=ns, block_kv=bkv, causal=True,
                int_mode=int_mode, guard_shift=0)
            if ns == 4 and int_mode:           # row 0: 3 tiles, 4 splits
                assert int(parts[0][0, 3].max()) == J.SNAP_MIN
                assert not parts[1][0, 3].any()
            outs[int_mode, ns] = fd.finish_partials(*parts,
                                                    int_mode=int_mode)
    np.testing.assert_allclose(outs[False, 4].numpy(),
                               outs[False, 1].numpy(), atol=1e-6)
    np.testing.assert_allclose(outs[True, 4].numpy(),
                               outs[True, 1].numpy(), atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, qp, valid = _case(15, 1, 4, 20, 1, 1, 8)
    tq, tk, tv = _t(q, k, v)
    with pytest.raises(ValueError):
        flash_attention_pallas(tq, tk, tv, q_pos=torch.from_numpy(qp),
                               kv_valid=torch.from_numpy(valid), block_kv=65)
    with pytest.raises(ValueError):
        fd.flash_decode_pallas(tq, tk, tv, q_pos=torch.from_numpy(qp),
                               kv_valid=torch.from_numpy(valid))
    with pytest.raises(ValueError):
        fd.flash_decode_pallas(tq[:, :1], tk, tv,
                               q_pos=torch.from_numpy(qp[:, :1]),
                               kv_valid=torch.from_numpy(valid),
                               softmax_impl="dualmode_snap")
    assert tiling.attention_blocks(4096, 16384) == (64, 64)
    assert tiling.attention_blocks(5, 20) == (16, 32)
    assert tiling.decode_kv_block(16384, 3) == 128
    assert tiling.decode_kv_block(40, 2) == 32
