"""The paged split-KV decodes (rows 3 and 4) on the CPU: their plain
version, the split count on a GPU, and the reference.

On the card rows 3 / 4 run on the contiguous decodes' Hopper body through
the block table, the page as the tile (``csrc/decode_dense_sm90.cuh``;
held to the plain version in tests/test_torch_gpu.py and chip_smoke.py).
Here:

- the paged plain version is the contiguous sweep on the paged_gather'ed
  cache at block_kv = bs, bitwise in every partial, float and int, so the
  two layouts cut the splits alike (each row's live pages);
- ``tiling.decode_splits`` gives the contiguous decodes' plan on a GPU,
  capped at the pages, and the reference's rule on the CPU;
- the wrapper at pages of 8 and 40 keys meets the JAX reference (float
  1e-5, the reference's decode tolerance; int 1e-6 on exact scores, the
  words equal and the f32 numerator sum in another order).

(The kernels' scheme through the paged address is emulated in
tests/test_torch_flash_fwd_decode.py and tests/test_torch_snap_sm90.py.)
Each case draws its inputs from its own seeded ``np.random.RandomState``.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _naive_sdpa
from repro.models.attention import paged_gather as j_paged_gather
from repro.models.flash import flash_attention_paged_ref
from repro_torch.core import softmax_unit as unit
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import tiling
from repro_torch.models.attention import paged_gather
from torch_paged_cases import PAGED
from torch_paged_cases import paged_case as _case

# the shared layouts, and 16-key pages at one split
CASES = PAGED + [
    (2, 2, 1, 16, 16, 16, 4, [10, 63], True, 1, "sentinel"),
]


@pytest.mark.parametrize("int_mode", [False, True])
@pytest.mark.parametrize("shape", CASES)
def test_paged_plain_is_the_contiguous_sweep_on_the_gathered_cache(
        shape, int_mode):
    """Every partial (m, l | S, acc) of the paged plain version equals,
    bit for bit, the contiguous plain version's on the cache gathered
    through the table (entries outside the pool read block 0) with the
    page as its tile: the same live pages, cut into the same shares."""
    b, kh, g, h, hv, bs, nblk, q_pos, causal, ns, tails = shape
    qf, kp, vp, tab, qp, valid = _case(61, b, kh, g, h, hv, bs, nblk, q_pos,
                                       tails)
    kw = dict(num_splits=ns, causal=causal, int_mode=int_mode,
              guard_shift=unit.guard_shift_for(nblk * bs))
    got = fd.decode_paged_partials_plain(qf, kp, vp, tab, qp, valid, **kw)
    sane = torch.where((tab >= 0) & (tab < kp.shape[0]), tab, 0)
    want = fd.decode_dense_partials_plain(
        qf, paged_gather(kp, sane), paged_gather(vp, sane), qp, valid,
        block_kv=bs, **kw)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("nblk,bs,rows,want_gpu,want_cpu", [
    # qwen1.5-0.5b's paged tick (B4 K16, 16 pages of 128 keys): the plan's
    # 8 splits of 256 keys; yi-6b's (B4 K4, 32 pages): 16
    (16, 128, 64, 8, 1),
    (32, 128, 16, 16, 2),
    # one page a split at most: 8-key pages, a 128-key table
    (16, 8, 4, 1, 1),
    # many rows: one split
    (16, 128, 4096, 1, 1),
    # a long table of small pages, few rows: the plan's 256-key floor
    (512, 16, 8, 32, 4),
])
def test_paged_split_count(nblk, bs, rows, want_gpu, want_cpu):
    """On a GPU (132 SMs) the paged decodes take the contiguous decodes'
    plan for the same cache, capped at the pages; on the CPU the
    reference's off-TPU rule (so CPU parity holds at its count)."""
    with mock.patch.object(tiling, "sm_count", lambda dev: 132):
        got = tiling.decode_splits(nblk, bs, rows, torch.device("cuda"))
    plan = tiling.decode_dense_plan(nblk * bs, rows, sms=132)
    assert got == min(plan.splits, nblk) == want_gpu
    assert tiling.decode_splits(nblk, bs, rows, torch.device("cpu")) == \
        want_cpu


@pytest.mark.parametrize("bs,nblk,g", [(8, 20, 2), (40, 5, 8)])
@pytest.mark.parametrize("num_splits", [None, 3])
def test_paged_decode_small_pages_vs_reference(bs, nblk, g, num_splits):
    """The wrapper at pages smaller than a step (8 keys) and not a power
    of two (40), sentinel tails, against the JAX reference: float vs the
    paged oracle, int vs the naive snapped unit on the gathered cache.  q
    and k are grid-valued (multiples of 2^-5 and 2^-4), so every score,
    and with it every int word, is exact in any summation order."""
    b, kh, h = 3, 2, 16
    qf, kp, vp, tab, qp, _ = _case(62, b, kh, g, h, h, bs, nblk,
                                   [7, 77, nblk * bs - 1], "sentinel")
    qf, kp = torch.round(qf * 32) / 32, torch.round(kp * 4) / 16
    valid = (torch.arange(nblk * bs)[None, :] <= qp[:, None])
    q = (qf * h ** 0.5)[:, None]
    jq, jk, jv, jt = (jnp.asarray(x.numpy()) for x in (q, kp, vp, tab))
    jqp, jvalid = jnp.asarray(qp.numpy()[:, None]), jnp.asarray(
        valid.numpy())
    for impl in ("float", "dualmode"):
        got = fd.flash_decode_paged(q, kp, vp, block_tables=tab,
                                    q_pos=qp[:, None], kv_valid=valid,
                                    num_splits=num_splits, softmax_impl=impl)
        if impl == "float":
            want = flash_attention_paged_ref(jq, jk, jv, block_tables=jt,
                                             q_pos=jqp, kv_valid=jvalid)
        else:
            want = _naive_sdpa(jq, j_paged_gather(jk, jt),
                               j_paged_gather(jv, jt), q_pos=jqp,
                               kv_valid=jvalid, softmax_impl="dualmode_snap")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 if impl == "float" else 1e-6)


def test_paged_wrapper_on_cpu_is_the_plain_version():
    qf, kp, vp, tab, qp, valid = _case(63, 2, 2, 2, 16, 16, 16, 6,
                                       [30, 95], "out")
    kw = dict(num_splits=4, causal=True, guard_shift=0)
    for int_mode in (False, True):
        for got, want in zip(
                fd.decode_paged_partials(qf, kp, vp, tab, qp, valid,
                                         int_mode=int_mode, **kw),
                fd.decode_paged_partials_plain(qf, kp, vp, tab, qp, valid,
                                               int_mode=int_mode, **kw)):
            assert torch.equal(got, want)
