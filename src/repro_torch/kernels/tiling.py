"""Tiling policy for the port's kernels on Hopper (counterpart of
``repro.kernels.tiling``, whose TPU constants -- lane 128, sublane 8,
VMEM budgets -- do not apply to a GPU).

What carries over unchanged is the paged-KV block rule (the engine's
block size is also the decode kernel's KV tile width) and the
decode-vs-naive threshold.  The split-KV decode split count is sized
from the card's streaming multiprocessor count instead of the TPU core
probe: splits are added until (batch x kv-heads x splits) blocks cover
every SM, and never more than the table has tiles.
"""
from __future__ import annotations

import torch

DECODE_FLASH_MIN_KV = 1024   # below this the s_q=1 'auto' pick stays naive
DECODE_MAX_SPLITS = 8        # partial-merge fan-in cap
DECODE_SPLIT_KEYS = 2048     # CPU rule: keys per split
PAGED_MIN_BLOCK = 8          # block-size window of the paged pool
PAGED_MAX_BLOCK = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(n: int, multiple: int) -> int:
    return cdiv(n, multiple) * multiple


def paged_block_size(max_seq: int) -> int:
    """Tokens per paged-KV block: ~16 blocks per maximal sequence, a
    multiple of 8, clamped to [8, 128] (the reference's rule)."""
    want = round_up(cdiv(max_seq, 16), PAGED_MIN_BLOCK)
    return int(max(PAGED_MIN_BLOCK, min(PAGED_MAX_BLOCK, want)))


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
    """Split count for the paged decode kernel: ``rows`` (batch x kv-heads)
    independent sweeps over ``nblk`` tiles of ``block_size`` keys.

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
