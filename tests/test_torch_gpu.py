"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a CUDA device every test here skips, with
the reason, from inside the ``cuda`` fixture (``REPRO_TORCH_REQUIRE_CUDA=1``
turns that skip into a failure, so a run on the GPU machine cannot pass
by skipping).  This file imports no JAX, so it runs where only PyTorch
is installed:

    REPRO_TORCH_REQUIRE_CUDA=1 PYTHONPATH=src python -m pytest -m gpu \
        tests/test_torch_gpu.py

Tolerances: int words bitwise; float softmax 1e-6, float GELU/SiLU 2e-6
(a few ulps of |z| <= ~10), float decode 1e-5 (dot and sum order); int
decode outputs 1e-5 on exact (grid-valued) scores, 1e-4 on random ones,
where a score can round to the neighbouring S5.10 word.
"""
import os

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


def _case(dev, g, grid, seed=2, b=4, kh=4, h=64, bs=128, nblk=16):
    gen = torch.Generator().manual_seed(seed)
    n_pool = 1 + b * nblk
    q = _randn(gen, dev, b, kh, g, h)
    k = _randn(gen, dev, n_pool, bs, kh, h)
    if grid:                  # multiples of 2^-4: exact scores
        q = torch.round(q * 4) / 16
        k = torch.round(k * 4) / 16
    v = _randn(gen, dev, n_pool, bs, kh, h)
    ids = (torch.randperm(n_pool - 1, generator=gen) + 1).reshape(b, nblk)
    q_pos = torch.tensor([5, 127, 900, nblk * bs - 1], dtype=torch.int32)
    used = (q_pos[:, None] // bs) >= torch.arange(nblk)[None, :]
    tables = torch.where(used, ids, 0).to(torch.int32).to(dev)
    valid = (torch.arange(nblk * bs)[None, :] <= q_pos[:, None]).to(
        torch.uint8).to(dev)
    return (q * h ** -0.5).contiguous(), k, v, tables, q_pos.to(dev), valid


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("num_splits", [1, 4])
def test_decode_paged_kernels(cuda, g, num_splits):
    for grid in (False, True):
        args = _case(cuda, g, grid)
        kw = dict(num_splits=num_splits, causal=True, guard_shift=0)
        kf = fd.decode_paged_partials(*args, int_mode=False, **kw)
        pf = fd.decode_paged_partials_plain(*args, int_mode=False, **kw)
        torch.testing.assert_close(fd.finish_partials(*kf, int_mode=False),
                                   fd.finish_partials(*pf, int_mode=False),
                                   atol=1e-5, rtol=0)
        ki = fd.decode_paged_partials(*args, int_mode=True, **kw)
        pi = fd.decode_paged_partials_plain(*args, int_mode=True, **kw)
        if grid:
            assert torch.equal(ki[0], pi[0]) and torch.equal(ki[1], pi[1])
        # random scores can flip an S5.10 word between two dot orders
        torch.testing.assert_close(fd.finish_partials(*ki, int_mode=True),
                                   fd.finish_partials(*pi, int_mode=True),
                                   atol=1e-5 if grid else 1e-4, rtol=0)


def test_kernel_registry(cuda):
    assert set(_build.KERNELS) == {"softmax_rows", "pair_act",
                                   "decode_paged", "decode_paged_int"}
    x = torch.zeros(2, 3, device=cuda)
    with pytest.raises(ValueError):
        ds.softmax_rows(x.t())                  # not contiguous
