"""Tiling policy for the port's kernels on Hopper (counterpart of
``repro.kernels.tiling``, whose TPU constants -- lane 128, sublane 8,
VMEM budgets -- do not apply to a GPU).

What carries over unchanged is the paged-KV block rule (the engine's
block size is also the decode kernel's KV tile width), the
decode-vs-naive threshold and the blocked-attention pad rule
(:func:`pad_attention_operands`, used by the plain versions).  The
split-KV decode split count is sized from the card's streaming
multiprocessor count instead of the TPU core probe: splits are added
until (batch x kv-heads x splits) blocks cover every SM, and never more
than the cache has tiles.

Blocked attention tiles are Hopper-sized, not the TPU's 128 x 512: a
block of 256 threads holds ATTN_BLOCK_Q query rows against
ATTN_BLOCK_KV keys (64 x 64 f32 scores, 16 a thread), small enough that
K, V, Q and the score tile all sit in shared memory at head dims up to
128.  The CUDA kernels read the ragged edge of the last tile as phantom
keys themselves instead of padding the operands in device memory.
Results do not depend on the tile: int words are bitwise equal for any
(bq, bkv), float outputs equal up to f32 summation order.

Matmul-epilogue kernels (the fused GLU, the norm -> linear and norm ->
gated-GLU prologues; ``csrc/norm_gemm.cuh``) take the place of the reference's
``matmul_blocks`` (128 x 512 MXU tiles with the whole contraction dim
in VMEM): 32-column output tiles, so a decode tick's few rows still give
every SM a column tile at yi-6b's widths, row tiles of 16, 32 or 64
sized to M, and K walked in chunks staged in shared memory, never held
whole (:func:`matmul_blocks`).  The residual-norm epilogue takes one
block per row, in place of the reference's ``norm_rows``.  The
pad-and-slice rule is kept, done in registers: the kernels load the
ragged rows, columns and K tail as zeros and never store them, so no
operand is padded in device memory.
"""
from __future__ import annotations

import torch

DECODE_FLASH_MIN_KV = 1024   # below this the s_q=1 'auto' pick stays naive
DECODE_MAX_SPLITS = 8        # partial-merge fan-in cap
DECODE_SPLIT_KEYS = 2048     # CPU rule: keys per split
PAGED_MIN_BLOCK = 8          # block-size window of the paged pool
PAGED_MAX_BLOCK = 128
ATTN_BLOCK_Q = 64            # blocked attention: query rows per tile
ATTN_BLOCK_KV = 64           # blocked attention: keys per tile
DECODE_BLOCK_KV = 128        # contiguous split-KV decode: keys per tile


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(n: int, multiple: int) -> int:
    return cdiv(n, multiple) * multiple


def paged_block_size(max_seq: int) -> int:
    """Tokens per paged-KV block: ~16 blocks per maximal sequence, a
    multiple of 8, clamped to [8, 128] (the reference's rule)."""
    want = round_up(cdiv(max_seq, 16), PAGED_MIN_BLOCK)
    return int(max(PAGED_MIN_BLOCK, min(PAGED_MAX_BLOCK, want)))


def attention_blocks(s_q: int, t_kv: int) -> tuple[int, int]:
    """(bq, bkv) for blocked attention: the Hopper tile, shrunk (to a
    multiple of 16) only where the whole extent is smaller."""
    return (min(ATTN_BLOCK_Q, round_up(s_q, 16)),
            min(ATTN_BLOCK_KV, round_up(t_kv, 16)))


def pad_dim(x: torch.Tensor, dim: int, multiple: int, value=0):
    """Pad ``x`` along ``dim`` with ``value`` up to a multiple."""
    pad = (-x.shape[dim]) % multiple
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def pad_attention_operands(q, q_pos, k, v, kv_valid, bq: int, bkv: int):
    """Pad the five blocked-attention operands up to the (bq, bkv) grid
    (the reference's rule): q / q_pos along the query axis, k / v /
    kv_valid along the key axis, validity padded with 0 so padded keys
    are invalid.  Callers tell padded keys (phantoms) from invalid ones
    by position: a key at or past the unpadded extent is a phantom."""
    return (pad_dim(q, 1, bq), pad_dim(q_pos.to(torch.int32), 1, bq),
            pad_dim(k, 1, bkv), pad_dim(v, 1, bkv),
            pad_dim(kv_valid.to(torch.int32), 1, bkv))


def matmul_blocks(m: int, *, norm_prologue: bool,
                  glu: bool | None = None) -> tuple[int, int]:
    """(bm, bk) of the matmul-epilogue kernels for m rows: rows per tile
    and the K chunk staged in shared memory (tiles are 32 columns wide).
    ``glu`` says whether the kernel reads two weight matrices a chunk
    (the GLU's gate and up); it defaults to ``not norm_prologue``, so
    ``norm_prologue=True`` alone is the norm -> linear kernel and
    ``norm_prologue=True, glu=True`` the norm -> gated-GLU kernel.

    A decode tick (m <= 16) is bound by the weight bytes: one 16-row
    tile, and the norm -> linear kernel (one weight matrix a tile) walks
    K 128 deep to keep 16 KB of weights in flight a block; the GLU reads
    two matrices a chunk and stays at 32 (at 128 its staging registers
    leave one block an SM, and it ran slower).  More rows are bound by
    the FMAs: 32-row tiles up to a prefill chunk for the norm -> linear
    kernel (twice the blocks of 64-row ones at yi-6b's QKV width),
    64-row tiles past 32 rows for the GLU.  The norm -> gated-GLU kernel
    takes the GLU's pairs: its prologue adds shared memory for two words
    a row, not staging registers.  The kernels instantiate exactly these
    pairs (their H100 timings are in PERF.md)."""
    if glu is None:
        glu = not norm_prologue
    if m <= 16:
        return 16, 32 if glu else 128
    if m <= (32 if glu else 64):
        return 32, 32
    return 64, 32


def decode_kv_block(t_kv: int, num_splits: int) -> int:
    """KV tile width of the contiguous split-KV decode: DECODE_BLOCK_KV
    keys, shrunk (to a multiple of 16) where a split holds fewer."""
    return min(DECODE_BLOCK_KV, round_up(cdiv(t_kv, max(num_splits, 1)), 16))


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` names."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


_SM_COUNT: dict[int, int] = {}    # per card index: a property of the card


def decode_splits(nblk: int, block_size: int, rows: int,
                  device: torch.device) -> int:
    """Split count for the split-KV decode kernels: ``rows`` (batch x
    kv-heads) independent sweeps over ``nblk`` tiles of ``block_size``
    keys.

    On a GPU: enough splits for rows x splits blocks to cover the SMs,
    capped at DECODE_MAX_SPLITS and at one tile per split.  On the CPU
    (the plain version): the reference's off-TPU rule, one split per
    DECODE_SPLIT_KEYS keys, so the two fold the same partials.
    """
    if device.type == "cuda":
        want = cdiv(sm_count(device), max(rows, 1))
    else:
        want = nblk * block_size // DECODE_SPLIT_KEYS
    return int(max(1, min(want, DECODE_MAX_SPLITS, nblk)))
