"""The port's kernel modules, through their wrappers on CPU tensors (the
plain versions), held to the JAX reference; dispatch and tiling.

Tolerances: int words bitwise; float softmax / GELU / SiLU <= 1e-6
(XLA and PyTorch exp2/log2 differ by ulps); float decode <= 1e-5 (the
reference's own decode tolerance: f32 summation order); int decode
outputs on random inputs <= 1e-6 (the probability words are equal, the
f32 numerator @ v sum order is not), bitwise on grid-valued inputs under
an identity-v probe.  The CUDA kernels themselves are held to these
plain versions by tests/test_torch_gpu.py and chip_smoke.py on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import softmax_unit as J
from repro.kernels import datapath as J_dp
from repro.kernels import tiling as J_tiling
from repro.models.attention import _naive_sdpa, paged_gather
from repro.models.flash import flash_attention_paged_ref
from repro_torch.core import softmax_unit as T
from repro_torch.kernels import dispatch, tiling
from repro_torch.kernels.dualmode_softmax import pair_act, softmax_rows
from repro_torch.kernels.flash_decode import (decode_paged_partials,
                                              finish_partials,
                                              flash_decode_paged)


def _x(seed, shape, scale=4.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(1, 1), (7, 33), (64, 2048), (2, 70000)])
def test_softmax_rows_int_bitwise_vs_unit(shape):
    """Guard shift from the unpadded row length (70000 keys -> 1)."""
    x = _x(0, shape)
    x[0, : shape[1] // 2] = J_dp.MASK_VALUE
    got = softmax_rows(torch.from_numpy(x), precision="int")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.softmax_dualmode(jnp.asarray(x))))


def test_softmax_rows_float_vs_datapath():
    x = _x(1, (9, 300))
    np.testing.assert_allclose(
        softmax_rows(torch.from_numpy(x), precision="float").numpy(),
        np.asarray(J_dp.row_softmax(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("mode", ["gelu", "silu"])
def test_pair_act_int_bitwise_vs_unit(mode):
    x = _x(2, (16, 2816 // 8), scale=6.0)
    x[0, :6] = [-40.0, 40.0, 0.5 / 1024, 1.5 / 1024, -2.5 / 1024, 0.0]
    want = (J.gelu_dualmode if mode == "gelu" else J.silu_dualmode)(
        jnp.asarray(x))
    np.testing.assert_array_equal(
        pair_act(torch.from_numpy(x), mode=mode, precision="int").numpy(),
        np.asarray(want))


@pytest.mark.parametrize("mode", ["gelu", "silu"])
def test_pair_act_float_vs_datapath(mode):
    x = _x(3, (5, 77), scale=3.0)
    np.testing.assert_allclose(
        pair_act(torch.from_numpy(x), mode=mode, precision="float").numpy(),
        np.asarray(J_dp.pair_act(jnp.asarray(x), mode)), atol=1e-6,
        rtol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        softmax_rows(torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        softmax_rows(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        softmax_rows(torch.zeros(2, 3), precision="half")
    with pytest.raises(ValueError):
        pair_act(torch.zeros(2, 3), mode="relu")


# ---------------- paged decode ----------------

def _paged_case(seed, b, kh, g, h, bs, nblk, grid=False, sentinel_tail=False,
                hv=None):
    rs = np.random.RandomState(seed)
    hv = hv or h
    n_pool = 1 + b * nblk
    if grid:                  # multiples of 2^-4: exact products and sums
        q = np.round(rs.randn(b, 1, kh, g, h) * 4) / 16
        k = np.round(rs.randn(n_pool, bs, kh, h) * 4) / 16
    else:
        q = rs.randn(b, 1, kh, g, h)
        k = rs.randn(n_pool, bs, kh, h)
    v = rs.randn(n_pool, bs, kh, hv)
    tables = (rs.permutation(n_pool - 1) + 1).reshape(b, nblk)
    t = nblk * bs
    q_pos = rs.randint(0, t, size=(b, 1))
    q_pos[0, 0] = t - 1                      # one row at the last key
    if sentinel_tail:
        used = (q_pos // bs) >= np.arange(nblk)[None, :]
        tables = np.where(used, tables, 0)
    kv_valid = np.arange(t)[None, :] <= q_pos
    return tuple(a.astype(np.float32) for a in (q, k, v)) + (
        tables.astype(np.int32), q_pos.astype(np.int32), kv_valid)


def _both(case):
    j = tuple(jnp.asarray(a) for a in case)
    t = tuple(torch.from_numpy(np.asarray(a)) for a in case)
    return j, t


@pytest.mark.parametrize("num_splits", [1, 2, 4])
@pytest.mark.parametrize("g", [1, 2])
def test_decode_paged_float_vs_paged_oracle(num_splits, g):
    """Shuffled tables, ragged q_pos, sentinel block 0 in the tails."""
    (q, k, v, tab, qp, valid), (tq, tk, tv, ttab, tqp, tvalid) = _both(
        _paged_case(1, b=3, kh=2, g=g, h=16, bs=16, nblk=6,
                    sentinel_tail=True))
    want = flash_attention_paged_ref(q, k, v, block_tables=tab, q_pos=qp,
                                     kv_valid=valid)
    got = flash_decode_paged(tq, tk, tv, block_tables=ttab, q_pos=tqp,
                             kv_valid=tvalid, num_splits=num_splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("g", [1, 2])
def test_decode_paged_int_vs_naive_snapped_unit(num_splits, g):
    (q, k, v, tab, qp, valid), (tq, tk, tv, ttab, tqp, tvalid) = _both(
        _paged_case(2, b=3, kh=2, g=g, h=16, bs=16, nblk=6))
    want = _naive_sdpa(q, paged_gather(k, tab), paged_gather(v, tab),
                       q_pos=qp, kv_valid=valid, softmax_impl="dualmode_snap")
    got = flash_decode_paged(tq, tk, tv, block_tables=ttab, q_pos=tqp,
                             kv_valid=tvalid, num_splits=num_splits,
                             softmax_impl="dualmode")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("num_splits", [1, 4])
def test_decode_paged_int_words_bitwise_identity_v(num_splits):
    """Grid-valued q/k make every score exact, and v = one-hot of the
    logical key makes each output dim one exact numerator / l: the
    probabilities are then bitwise the whole-row snapped unit's, over the
    tiles the causal skip visits (later tiles carry no mass here)."""
    b, kh, g, h, bs, nblk = 2, 2, 2, 16, 16, 8
    q, k, _, tab, qp, valid = _paged_case(3, b, kh, g, h, bs, nblk,
                                          grid=True)
    t = nblk * bs
    v = np.zeros((1 + b * nblk, bs, kh, t), np.float32)
    for bb in range(b):
        for j in range(nblk):
            v[tab[bb, j], np.arange(bs), :, j * bs + np.arange(bs)] = 1.0
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(_naive_sdpa(
        jq, paged_gather(jk, jnp.asarray(tab)), paged_gather(
            jv, jnp.asarray(tab)), q_pos=jnp.asarray(qp),
        kv_valid=jnp.asarray(valid), softmax_impl="dualmode_snap"))
    got = flash_decode_paged(*map(torch.from_numpy, (q, k, v)),
                             block_tables=torch.from_numpy(tab),
                             q_pos=torch.from_numpy(qp),
                             kv_valid=torch.from_numpy(valid),
                             num_splits=num_splits,
                             softmax_impl="dualmode").numpy()
    for bb in range(b):
        live = (int(qp[bb, 0]) // bs + 1) * bs
        np.testing.assert_array_equal(got[bb, ..., :live],
                                      want[bb, ..., :live])
        assert not got[bb, ..., live:].any()


def test_decode_paged_int_split_invariance_and_l_words():
    """The snapped monoid: m, S and the l words do not depend on where
    the cache splits; they equal the whole-row unit's l on exact scores."""
    q, k, v, tab, qp, valid = _paged_case(4, 3, 2, 2, 16, 16, 6, grid=True)
    qf = torch.from_numpy(q * 16 ** -0.5)[:, 0].contiguous()
    args = (qf, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tab), torch.from_numpy(qp[:, 0]),
            torch.from_numpy(valid.astype(np.uint8)))
    ls = []
    for ns in (1, 2, 6):
        m, S, acc = decode_paged_partials(*args, num_splits=ns, causal=True,
                                          int_mode=True, guard_shift=0)
        _, S_all, _ = T.online_merge_n_int(m[..., None], S, acc, dim=1)
        ls.append(T.online_finish_int(S_all)[:, 0])          # (B, K, G)
    for l in ls[1:]:
        np.testing.assert_array_equal(l.numpy(), ls[0].numpy())
    # whole-row l over the masked score words, the reference's way
    sc = np.einsum("bkgh,btkh->bkgt", q[:, 0] * 16 ** -0.5,
                   np.asarray(paged_gather(jnp.asarray(k), jnp.asarray(tab))))
    t = tab.shape[1] * 16
    live = np.arange(t)[None, :] <= qp               # causal == valid here
    sc = np.where(live[:, None, None, :], sc, J_dp.MASK_VALUE)
    # the kernel never visits tiles past q_pos; their masked words sit
    # >= 16 octaves below the max and add no l anyway
    _, _, l_ref = J.snap_row_stats(J.quantize(jnp.asarray(sc.astype(
        np.float32))), guard_shift=0)
    np.testing.assert_array_equal(ls[0].numpy(), np.asarray(l_ref)[..., 0])


def test_decode_paged_refuses_wide_queries_and_bad_extent():
    q, k, v, tab, qp, valid = (torch.from_numpy(np.asarray(a)) for a in
                               _paged_case(5, 2, 2, 1, 16, 16, 4))
    with pytest.raises(ValueError):
        flash_decode_paged(torch.cat([q, q], 1), k, v, block_tables=tab,
                           q_pos=qp, kv_valid=valid)
    with pytest.raises(ValueError):
        flash_decode_paged(q, k, v, block_tables=tab, q_pos=qp,
                           kv_valid=valid[:, :-1])
    with pytest.raises(ValueError):
        flash_decode_paged(q, k, v, block_tables=tab, q_pos=qp,
                           kv_valid=valid, softmax_impl="dualmode_snap")


def test_finish_partials_folds_sentinel_splits_exactly():
    """Empty splits write the merge identity; folding it is a no-op."""
    q, k, v, tab, qp, valid = _paged_case(6, 2, 2, 1, 16, 16, 4)
    qp[:] = 5                                 # every row lives in tile 0
    qf = torch.from_numpy(q * 0.25)[:, 0].contiguous()
    args = (qf, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(tab), torch.from_numpy(qp[:, 0]),
            torch.from_numpy((np.arange(64)[None] <= qp).astype(np.uint8)))
    for int_mode in (False, True):
        one = finish_partials(*decode_paged_partials(
            *args, num_splits=1, causal=True, int_mode=int_mode,
            guard_shift=0), int_mode=int_mode)
        four = finish_partials(*decode_paged_partials(
            *args, num_splits=4, causal=True, int_mode=int_mode,
            guard_shift=0), int_mode=int_mode)
        np.testing.assert_array_equal(one.numpy(), four.numpy())


# ---------------- dispatch / tiling ----------------

def test_resolution_matches_reference_where_ported():
    """On the CPU the port resolves every shape as the reference does on
    its CPU backend: blocked float shapes to the plain 'flash', blocked
    dual-mode shapes to 'flash_pallas_int'.  On a GPU the blocked float
    pick is the CUDA kernel 'flash_pallas' (the reference's TPU pick)."""
    from repro.kernels import dispatch as J_dispatch
    for s_q, t in ((1, 64), (1, 2048), (64, 2048), (1, 1 << 16), (1, 1023),
                   (4096, 4096), (512, 16384), (2049, 2048)):
        for sm in ("float", "dualmode", "dualmode_snap"):
            assert dispatch.resolve_attention("auto", s_q, t, sm,
                                              device="cpu") == \
                J_dispatch.resolve_attention("auto", s_q, t, sm), (s_q, t, sm)
    assert dispatch.resolve_attention("auto", 4096, 4096,
                                      device="cpu") == "flash"
    assert dispatch.blocked_impl("cuda") == "flash_pallas"
    assert dispatch.auto_rule(4096, 4096, "cuda") == "flash_pallas"
    assert dispatch.resolve_attention("auto", 512, 16384, "dualmode",
                                      device="cpu") == "flash_pallas_int"


def test_resolution_refusals_are_two_sided():
    with pytest.raises(ValueError):
        dispatch.resolve_attention("flash", 64, 64, softmax_impl="dualmode")
    with pytest.raises(ValueError):
        dispatch.resolve_attention("flash_pallas", 64, 64,
                                   softmax_impl="dualmode")
    with pytest.raises(ValueError):
        dispatch.resolve_attention("flash_pallas_int", 64, 64,
                                   softmax_impl="float")
    with pytest.raises(ValueError):
        dispatch.resolve_attention("auto", 1, 64, softmax_impl="fp8")
    with pytest.raises(ValueError):
        dispatch.resolve_attention("nope", 1, 64)
    with pytest.raises(ValueError):
        dispatch.get_softmax("nope")
    # the reference's impls that no slice has ported yet refuse instead
    # of running something else; the three-sweep int kernel is ported and
    # honors the classic unit only
    with pytest.raises(NotImplementedError):
        dispatch.resolve_attention("flash_ring", 64, 64, softmax_impl="float")
    assert dispatch.resolve_attention("flash_pallas_int3", 64, 64,
                                      softmax_impl="dualmode") == \
        "flash_pallas_int3"
    with pytest.raises(ValueError):
        dispatch.resolve_attention("flash_pallas_int3", 64, 64,
                                   softmax_impl="float")
    assert set(dispatch.NOT_PORTED) == {"flash_ring"}


def test_softmax_registry_matches_reference():
    from repro.kernels import dispatch as J_dispatch
    x = _x(7, (2, 3, 40))
    for impl, tol in (("float", 1e-6), ("dualmode", 0.0),
                      ("dualmode_snap", 0.0)):
        np.testing.assert_allclose(
            dispatch.get_softmax(impl)(torch.from_numpy(x)).numpy(),
            np.asarray(J_dispatch.get_softmax(impl)(jnp.asarray(x))),
            atol=tol, rtol=0)


@pytest.mark.parametrize("max_seq", [32, 128, 1000, 2048, 1 << 16])
def test_tiling_policy(max_seq):
    bs = tiling.paged_block_size(max_seq)
    assert bs == J_tiling.paged_block_size(max_seq)
    nblk = tiling.cdiv(max_seq, bs)
    # the CPU split rule is the reference's off-TPU rule
    assert tiling.decode_splits(nblk, bs, 8, torch.device("cpu")) == min(
        J_tiling.decode_splits(nblk * bs), nblk)
    assert tiling.DECODE_FLASH_MIN_KV == J_tiling.DECODE_FLASH_MIN_KV
