"""Tiling policy for the port's kernels on Hopper (counterpart of
``repro.kernels.tiling``, whose TPU constants -- lane 128, sublane 8,
VMEM budgets -- do not apply to a GPU).

What carries over unchanged is the paged-KV block rule (the engine's
block size is also the decode kernel's KV tile width), the
decode-vs-naive threshold and the blocked-attention pad rule
(:func:`pad_attention_operands`, used by the plain versions).  The
split-KV decode split count is sized from the card's streaming
multiprocessor count instead of the TPU core probe: splits are added
until (batch x kv-heads x splits) blocks fill several waves of the SMs'
resident slots, and never more than the cache has tiles.

Blocked attention's caller tile is Hopper-sized, not the TPU's 128 x
512: ATTN_BLOCK_Q query rows against ATTN_BLOCK_KV keys
(:func:`attention_blocks`), the plain versions' tile and the block_kv
the reference checks.  The CUDA kernels take their own tiles from their
plans and read the ragged edge of the last tile as phantom keys
themselves instead of padding the operands in device memory.  Results
do not depend on the tile: int words are bitwise equal for any (bq,
bkv), float outputs equal up to f32 summation order.

The norm -> QKV and norm -> gated-GLU kernels (rows 15 and 16) and the
fused GLU and its backward (rows 12 and 13) run on
``csrc/norm_gemm_sm90.cuh``, a pipelined f32 GEMM body sized for Hopper
(:func:`norm_gemm_plan`): a cp.async ring of raw x / weight chunks in
shared memory, moved k-major after landing (rows 15 / 16 compute the
moments once per row first and normalize in that pass), and register
tiles of 128 rows from 128 rows up; smaller row tiles and a split K fill
the SMs for a prefill chunk or a decode tick.  Edges are zero-filled by
the copies, so no operand is padded in device memory.

The flash backward (rows 10 and 11) runs on ``csrc/flash_bwd_sm90.cuh``
with its own tiles (:func:`flash_bwd_plan`), not the forward's: a row
pre-pass, a cp.async ring of the streamed operand, 8 x 8 register tiles.
The float flash forward (row 7) and the one-sweep snapped int flash (row
8) run on ``csrc/flash_fwd_sm90.cuh`` with the tiles of
:func:`flash_fwd_plan` (128 or 64 q rows held, 64-key K / V tiles
streamed; at MLA's h up to 192 one operand a ring stage, the 192 class
of :func:`head_width`); the three-sweep int kernel (row 9) runs on the
same body with the tiles and the word cache of :func:`flash_int3_plan`
(64 q rows, the score words of a q tile kept in shared memory where they
fit).  The
contiguous decodes (rows 5 and 6) run on
``csrc/decode_dense_sm90.cuh`` with the split count and tile of
:func:`decode_dense_plan` and the copy width of :func:`decode_dense_vec`;
the paged decodes (rows 3, 4) run on the same body through the block
table, the page as the tile, at :func:`decode_splits`' count -- the same
plan on a GPU.

The residual-norm epilogue (row 14) and the unit's row softmax (row 1)
hold each row in registers -- a warp a row, or a block a row -- up to
the lengths of :func:`resnorm_plan` and :func:`softmax_rows_plan`, and
stream longer rows.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

DECODE_FLASH_MIN_KV = 1024   # below this the s_q=1 'auto' pick stays naive
DECODE_MAX_SPLITS = 8        # CPU rule: splits at most
DECODE_SPLIT_KEYS = 2048     # CPU rule: keys per split
PAGED_MIN_BLOCK = 8          # block-size window of the paged pool
PAGED_MAX_BLOCK = 128
ATTN_BLOCK_Q = 64            # blocked attention: query rows per tile
ATTN_BLOCK_KV = 64           # blocked attention: keys per tile
DECODE_BLOCK_KV = 128        # contiguous decode's plain version: keys a tile


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


NORM_GEMM_SLOTS = 2 * 132    # H100 SXM: two resident blocks on each SM
NORM_GEMM_BK = 16            # K depth of a ring stage (csrc kBK)
NORM_GEMM_MIN_CHUNKS = 8     # K chunks a split walks at least
NORM_GEMM_CHUNK_SPLITS = 8   # a gated-GLU chunk's K ranges at most: past
#                              that the partial sums' traffic outweighs
#                              the fuller waves
# (bm, bn) per band: one matrix a tile (row 15), or bn columns of each of
# the two matrices (row 16); the 4-byte path takes the middle tile
NORM_GEMM_TILES = {False: {"decode": (16, 256), "chunk": (64, 128),
                           "prefill": (128, 128)},
                   True: {"decode": (16, 128), "chunk": (64, 64),
                          "prefill": (128, 64)}}


def aligned16(*tensors) -> bool:
    """Whether every base pointer is a multiple of 16 bytes, as the
    kernels' 16-byte copies, loads and stores need (None counts: the
    kernel never reads it)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


SOFTMAX_ROWS_THREADS = 256    # threads of a block of the unit's row softmax
SOFTMAX_WARP_WORDS = 1024     # longest row a warp holds (32 words a lane)
SOFTMAX_BLOCK_WORDS = 8192    # longest row a block holds (32 a thread)


class SoftmaxRowsPlan(NamedTuple):
    scheme: str        # 'warp', 'block' (the row held) or 'stream'
    row_threads: int   # threads that share a row: 32 or 256
    words: int         # words a thread holds (0: streamed)
    vec: int           # floats a load or store moves: 4 (16 bytes) or 1


@functools.lru_cache(maxsize=256)
def softmax_rows_plan(n: int, aligned: bool = True) -> SoftmaxRowsPlan:
    """How the unit's row softmax (row 1, ``csrc/softmax_rows.cu``) covers
    rows of ``n`` words; ``aligned`` says whether both base pointers are
    multiples of 16 bytes.

    Rows up to SOFTMAX_WARP_WORDS: a warp a row, 8 rows a block; up to
    SOFTMAX_BLOCK_WORDS: a block of SOFTMAX_ROWS_THREADS a row.  Either
    way each thread holds ``words`` words (a power of two, at least
    ``vec``) read once from device memory, so the row is read once and
    written once.  Longer rows are streamed: three sweeps of one block
    that re-read the row, a float at a time.  A held row takes 16-byte
    loads and stores where n % 4 == 0 (every row then starts on 16 bytes)
    and ``aligned``; anything else moves a float at a time, the ragged
    edge masked in the kernel.
    ``csrc/softmax_rows.cu`` instantiates exactly these."""
    if n > SOFTMAX_BLOCK_WORDS:
        return SoftmaxRowsPlan("stream", SOFTMAX_ROWS_THREADS, 0, 1)
    vec = 4 if aligned and n % 4 == 0 else 1
    threads = 32 if n <= SOFTMAX_WARP_WORDS else SOFTMAX_ROWS_THREADS
    words = max(vec, 1 << (cdiv(n, threads) - 1).bit_length())
    return SoftmaxRowsPlan("warp" if threads == 32 else "block", threads,
                           words, vec)


RESNORM_THREADS = 256       # threads of a block of the residual norm
RESNORM_WARP_WORDS = 1024   # longest row a warp holds (32 words a lane)
RESNORM_BLOCK_WORDS = 8192  # longest row a block holds (32 a thread)


class ResnormPlan(NamedTuple):
    scheme: str       # 'warp', 'block' (the row held) or 'stream'
    row_threads: int  # threads of a block that share a row: 32 or 256
    words: int        # words a thread holds (0: streamed)
    vec: int          # floats a load or store moves: 4 (16 bytes) or 1


@functools.lru_cache(maxsize=256)
def resnorm_plan(d: int, aligned: bool = True) -> ResnormPlan:
    """How the residual-norm epilogue (row 14, ``csrc/resnorm.cu``) covers
    rows of d words; ``aligned`` says whether all six base pointers are
    multiples of 16 bytes.

    Rows up to RESNORM_WARP_WORDS: a warp a row, 8 rows a block; up to
    RESNORM_BLOCK_WORDS: a block of RESNORM_THREADS a row.  Each thread
    holds ``words`` words (a power of two, at least ``vec``), read once,
    so the row is read once and written once.  Longer rows are streamed
    by one block, the sums read back from the first output.  16-byte
    loads and stores where d % 4 == 0 and ``aligned``; anything else moves
    a float at a time.  A row stays in one block however few rows there
    are: spreading it over a thread-block cluster ran slower on the H100
    (PERF.md section 6).  ``csrc/resnorm.cu`` instantiates exactly
    these."""
    vec = 4 if aligned and d % 4 == 0 else 1
    if d > RESNORM_BLOCK_WORDS:
        return ResnormPlan("stream", RESNORM_THREADS, 0, vec)
    threads = 32 if d <= RESNORM_WARP_WORDS else RESNORM_THREADS
    words = max(vec, 1 << (cdiv(d, threads) - 1).bit_length())
    return ResnormPlan("warp" if threads == 32 else "block", threads, words,
                       vec)


def split_partials(like: torch.Tensor, split: int, m: int, cols: int):
    """The GEMM kernels' (split, m, cols) f32 scratch of split-K partial
    sums on ``like``'s device, or None for one split."""
    if split == 1:
        return None
    return torch.empty((split, m, cols), dtype=torch.float32,
                       device=like.device)


class NormGemmPlan(NamedTuple):
    band: str      # 'decode' (m <= 16), 'chunk' (m < 128), 'prefill'
    bm: int        # rows of a tile
    bn: int        # columns of a tile (of each matrix for the GLU)
    split: int     # K ranges, summed in order by a second pass
    vec: int       # floats a cp.async copy moves: 4 (16 bytes) or 1


@functools.lru_cache(maxsize=1024)
def norm_gemm_plan(m: int, k: int, widths: tuple[int, ...], *,
                   glu: bool = False, aligned: bool = True) -> NormGemmPlan:
    """The tile, K split and copy width of the norm -> QKV (``glu``
    False: ``widths`` the matrices read side by side) or of the gated-GLU
    kernels -- norm -> gated GLU, the fused GLU and its backward (``glu``
    True: ``widths`` the one width F of Wg and Wu) -- for m rows of depth
    k.  ``aligned`` says whether every base pointer is a
    multiple of 16 bytes.

    16-byte copies need k, every width and every pointer a multiple of
    four floats; anything else takes 4-byte copies on the middle tile.
    Bands of m: a decode tick (m <= 16) is bound by the weight bytes and
    takes 16-row tiles over wide column strips; a prefill chunk (m < 128)
    64-row tiles; a prefill bucket or an encoder batch 128-row tiles (8 x 8
    outputs a thread).  Where the tiles leave resident-block slots free
    (two blocks an SM: the kernels' registers and shared memory allow no
    more), K is split into as many ranges as fill them in one wave, each
    range at least NORM_GEMM_MIN_CHUNKS chunks deep.  A gated-GLU chunk is
    bound by its FMAs and its blocks all walk one depth, so its time goes
    in whole waves: it takes the split with the fewest waves per unit of
    depth (the fewest ranges among equals, at most NORM_GEMM_CHUNK_SPLITS),
    which may fill more than one wave -- yi-6b's 172 column tiles take
    three ranges, two full waves of a third of K, where one range would
    leave a wave 35% empty.
    ``csrc/norm_linear.cu`` and ``csrc/glu_sm90.cuh`` (under
    ``norm_glu.cu``, ``glu.cu``, ``glu_bwd.cu``) instantiate exactly these
    (bm, bn, vec)."""
    vec = 4 if aligned and k % 4 == 0 and all(n % 4 == 0 for n in widths) \
        else 1
    band = "decode" if m <= 16 else "chunk" if m < 128 else "prefill"
    bm, bn = NORM_GEMM_TILES[glu]["chunk" if vec == 1 else band]
    tiles = cdiv(m, bm) * sum(cdiv(n, bn) for n in widths)
    chunks = cdiv(k, NORM_GEMM_BK)
    most = max(1, chunks // NORM_GEMM_MIN_CHUNKS)
    if glu and band == "chunk":
        split = min(range(1, min(most, NORM_GEMM_CHUNK_SPLITS) + 1),
                    key=lambda s: (cdiv(tiles * s, NORM_GEMM_SLOTS) / s, s))
    else:
        split = max(1, min(NORM_GEMM_SLOTS // tiles, most))
    return NormGemmPlan(band, bm, bn, split, vec)


FLASH_BWD_TILES = {  # (kernel, head dims up to) -> (block_q, block_kv, stages)
    ("dq", 64): (128, 64, 3), ("dq", 128): (64, 64, 2),
    ("dkdv", 64): (64, 128, 2), ("dkdv", 128): (32, 64, 3)}


class FlashBwdPlan(NamedTuple):
    block_q: int    # rows of a q tile: dq holds it, dk/dv streams it
    block_kv: int   # keys of a kv tile: dq streams it, dk/dv holds it
    stages: int     # depth of the cp.async ring of the streamed operand
    vec: int        # floats a cp.async copy moves: 4 (16 bytes) or 1
    reverse: bool   # walk the grid's tiles from the last


@functools.lru_cache(maxsize=256)
def flash_bwd_plan(kernel: str, h: int, hv: int, *, causal: bool,
                   aligned: bool = True) -> FlashBwdPlan:
    """The tiles, ring depth, copy width and tile order of the flash
    backward's ``kernel`` ('dq' or 'dkdv', rows 10 and 11, on
    ``csrc/flash_bwd_sm90.cuh``) for head dims h (q, k) and hv (v).
    ``aligned`` says whether every base pointer is a multiple of 16 bytes.

    Head dims up to 64: dq holds 128 q rows and streams 64-key tiles
    through three stages, dk/dv holds 128 keys and streams 64-row q tiles
    through two -- the two accumulator sets of 128 x 64 fit the registers
    of 256 threads.  Up to 128: 64 rows (dq) and 64 keys with 32-row q
    tiles (dk/dv), so the K and V (or Q and dO) tiles fit shared memory.
    16-byte copies need h, hv and every pointer a multiple of four
    floats; anything else takes 4-byte copies on the same tiles.  A causal
    dq grid runs its late q tiles first, since they visit the most keys;
    a dk/dv grid already starts at its heaviest, the first key block.
    The tiles are independent of the forward's ``block_kv``: the mask is
    per key.  ``csrc/flash_bwd.cu`` instantiates exactly these."""
    if kernel not in ("dq", "dkdv"):
        raise ValueError(f"flash_bwd_plan: kernel {kernel!r} is not 'dq' "
                         "or 'dkdv'")
    width = 64 if max(h, hv) <= 64 else 128
    bq, bkv, stages = FLASH_BWD_TILES[(kernel, width)]
    vec = 4 if aligned and h % 4 == 0 and hv % 4 == 0 else 1
    return FlashBwdPlan(bq, bkv, stages, vec, bool(causal) and kernel == "dq")


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
    """Split count of the paged split-KV decodes (rows 3 and 4): ``rows``
    (batch x kv-heads) sweeps over ``nblk`` pages of ``block_size`` keys.

    On a GPU: the contiguous decodes' rule, :func:`decode_dense_plan`'s
    splits for a cache of nblk x block_size keys, capped at one page a
    split (the page is the tile the splits cut).  On the CPU (the plain
    versions, paged and contiguous): the reference's off-TPU rule, one
    split per DECODE_SPLIT_KEYS keys, at most DECODE_MAX_SPLITS, so CPU
    parity with the reference holds at its own split count.
    """
    if device.type == "cuda":
        want = decode_dense_plan(nblk * block_size, rows,
                                 sms=sm_count(device)).splits
    else:
        want = min(nblk * block_size // DECODE_SPLIT_KEYS, DECODE_MAX_SPLITS)
    return int(max(1, min(want, nblk)))


FLASH_FWD_BK = 64    # keys of a streamed K / V tile of the float forward
# width class -> (block_q, stages) of the float forward; the 192 class (MLA's
# h up to 192 against hv up to 128) streams one operand a stage
FLASH_FWD_TILES = {64: (128, 3), 128: (64, 2), 192: (64, 3)}
SMEM_MAX_BYTES = 232448     # shared memory a block may use (H100)
SM_SMEM_BYTES = 233472      # shared memory of an SM (H100: 228 KB)
SMEM_BLOCK_RESERVED = 1024  # of it, reserved for each resident block


def head_width(h: int, hv: int) -> int:
    """The width class of rows 5-8's instances (``csrc/flash_fwd_sm90.cuh``
    and ``csrc/decode_dense_sm90.cuh``'s ``Cfg<D, ...>``) for head dims h
    (q, k) and hv (v): 64 where both are at most 64, 128 where both are at
    most 128, and 192 where h is at most 192 and hv at most 128 (MLA's
    nope + rope against its v: the Q / K rows 192 wide, the V rows 128).
    Raises ValueError past those."""
    if min(h, hv) < 1 or h > 192 or hv > 128:
        raise ValueError(f"head dims {h}/{hv}: rows 5-8 take h up to 192 "
                         "and hv up to 128")
    if max(h, hv) <= 64:
        return 64
    return 128 if h <= 128 else 192


class FlashFwdPlan(NamedTuple):
    block_q: int    # rows of the q tile a block holds
    block_kv: int   # keys of a K / V tile streamed through the ring
    stages: int     # depth of the cp.async ring
    vec: int        # floats a cp.async copy moves: 4 (16 bytes) or 1
    reverse: bool   # walk the q tiles from the last


@functools.lru_cache(maxsize=256)
def flash_fwd_plan(h: int, hv: int, *, causal: bool,
                   aligned: bool = True) -> FlashFwdPlan:
    """The tiles, ring depth, copy width and tile order of the float flash
    forward (row 7, ``csrc/flash_fwd_sm90.cuh``; row 8 runs on the same
    plan) for head dims h (q, k) and hv (v); ``aligned`` says whether every
    base pointer is a multiple of 16 bytes.

    Head dims up to 64: a block holds 128 q rows (8 x 4 scores and 8 x 8
    outputs a thread) and streams 64-key tiles through three stages; up
    to 128: 64 rows and two stages, so Q, the ring and the p tile fit one
    block's shared memory.  MLA's h up to 192 against hv up to 128 (the 192
    class): 64 rows, and two stages of K and V would not fit
    (:func:`flash_fwd_smem`), so the ring holds one operand a stage and
    streams K(0), V(0), K(1), ... through three.  16-byte copies need h,
    hv and every pointer a multiple of four floats; anything else takes
    4-byte copies on the same tiles.  A causal grid runs its late q tiles
    first, since they visit the most keys.  The tiles are independent of
    the caller's ``block_kv``: the mask is per key and the causal tail is
    folded at the kernel's own width.  ``csrc/flash_fwd.cu`` instantiates
    exactly these; other head dims raise ValueError."""
    bq, stages = FLASH_FWD_TILES[head_width(h, hv)]
    vec = 4 if aligned and h % 4 == 0 and hv % 4 == 0 else 1
    return FlashFwdPlan(bq, FLASH_FWD_BK, stages, vec, bool(causal))


def flash_fwd_smem(h: int, hv: int, *, snap: bool = False) -> int:
    """Shared-memory bytes of a block of the float flash forward (or, with
    ``snap``, of row 8 on its body) at :func:`flash_fwd_plan`'s tile for
    head dims h, hv: Q [BQ][DK + 4]; the ring, each stage K [64][DK + 4]
    and V [64][DV + 4], or one of them a stage in the 192 class; the p
    tile [64][BQ + 4]; row 8's per-warp bucket tiles and the ROM's pairs
    (``csrc/flash_fwd_sm90.cuh``'s Smem, ``csrc/flash_snap_sm90.cuh``'s
    EXTRA)."""
    d = head_width(h, hv)
    bq, ns = FLASH_FWD_TILES[d]
    dk, dv = d, min(d, 128)
    ldk, ldv, bk = dk + 4, dv + 4, FLASH_FWD_BK
    stage = bk * ldk if dk != dv else bk * (ldk + ldv)
    floats = bq * ldk + ns * stage + bk * (bq + 4)
    if snap:
        floats += 8 * (bq // 16) * 2 * 16 + 32
    return 4 * floats


FLASH_INT3_BQ = 64          # q rows a block of the three-sweep int flash holds
FLASH_INT3_STAGES = {64: 3, 128: 2}   # head dims up to -> ring depth


class FlashInt3Plan(NamedTuple):
    block_q: int    # rows of the q tile a block holds
    block_kv: int   # keys of a K or V tile streamed through the ring
    stages: int     # depth of the cp.async ring
    vec: int        # floats a cp.async copy moves: 4 (16 bytes) or 1
    cache: bool     # the q tile's score words kept in shared memory


def flash_int3_smem(h: int, hv: int, t_kv: int, cache: bool) -> int:
    """Shared-memory bytes of a block of the three-sweep int flash: Q, the
    ring (one operand a stage with the word cache, K and V without), the p
    tile, the ROM's 16 pairs, and with the cache 16 bits a score word of
    every key tile (``csrc/flash_fwd_sm90.cuh``'s Smem and
    ``csrc/flash_int3_sm90.cuh``'s dyn_bytes)."""
    d = 64 if max(h, hv) <= 64 else 128
    ld, ns = d + 4, FLASH_INT3_STAGES[d]
    floats = (FLASH_INT3_BQ * ld + ns * (1 if cache else 2) * FLASH_FWD_BK * ld
              + FLASH_FWD_BK * (FLASH_INT3_BQ + 4) + 32)
    words = cdiv(t_kv, FLASH_FWD_BK) * FLASH_FWD_BK * FLASH_INT3_BQ if cache \
        else 0
    return 4 * floats + 2 * words


@functools.lru_cache(maxsize=256)
def flash_int3_plan(h: int, hv: int, t_kv: int, *,
                    aligned: bool = True) -> FlashInt3Plan:
    """The tiles, ring depth, copy width and word cache of the three-sweep
    int flash (row 9, ``csrc/flash_int3.cu`` on ``csrc/flash_fwd_sm90.cuh``)
    for head dims h (q, k) and hv (v) over t_kv keys; ``aligned`` says
    whether every base pointer is a multiple of 16 bytes.

    A block holds FLASH_INT3_BQ q rows (4 x 4 scores and 4 x 8 outputs a
    thread) and streams 64-key tiles through three stages at head dims up
    to 64, two up to 128.  Where the q tile's S5.10 score words fit in
    shared memory beside Q, the ring and the p tile (t_kv up to 1088 at
    head dims up to 64, 832 up to 128), one sweep of K keeps them and the
    sum and the P V sweep read them back; otherwise every sweep recomputes
    them.  Every tile is swept, causal or not, so the q tiles cost the
    same and run in grid order.  16-byte copies need h, hv and every
    pointer a multiple of four floats; anything else takes 4-byte copies
    on the same tiles.  The words do not depend on the tiles or on the
    caller's block_kv (the mask is per key).  ``csrc/flash_int3.cu``
    instantiates exactly these."""
    stages = FLASH_INT3_STAGES[64 if max(h, hv) <= 64 else 128]
    vec = 4 if aligned and h % 4 == 0 and hv % 4 == 0 else 1
    cache = flash_int3_smem(h, hv, t_kv, True) <= SMEM_MAX_BYTES
    return FlashInt3Plan(FLASH_INT3_BQ, FLASH_FWD_BK, stages, vec, cache)


DECODE_DENSE_BLOCK_KV = 64   # contiguous decode on a GPU: keys a tile
DECODE_DENSE_SLOTS = 2       # resident blocks an SM (its shared memory)
DECODE_DENSE_WAVES = 4       # blocks the split rule asks for, per slot
DECODE_DENSE_MIN_KEYS = 256  # cache keys a split covers at least


class DecodeDensePlan(NamedTuple):
    splits: int     # KV splits, folded outside the kernel
    block_kv: int   # keys of a tile: the unit the splits cut


def decode_dense_vec(h: int, hv: int, aligned: bool) -> int:
    """Floats a K / V copy of the contiguous decodes moves: 4 (16
    bytes) where h, hv are multiples of four floats and ``aligned`` (the K
    and V base pointers are multiples of 16 bytes; q is read a float at a
    time), else 1 -- in every width class of :func:`head_width`, MLA's h
    192 / hv 128 included.  The kernel's wrapper applies it at each
    launch, to the pointers it is given."""
    return 4 if aligned and h % 4 == 0 and hv % 4 == 0 else 1


def decode_dense_smem(h: int, hv: int, int_mode: bool) -> int:
    """Shared-memory bytes of a block of the split-KV decodes
    (``csrc/decode_dense_sm90.cuh``'s Smem) at the width class of h, hv:
    q [8][DK]; each of the 4 warps' two-stage ring of 32 / LPK keys, K
    [.][DK + 4 LPK] and V [.][DV + 4 LPK], LPK = DV / 32, and its p
    [8][32 / LPK]; the int policy's ROM pairs and per-warp [8][16] bucket
    tiles.  DECODE_DENSE_SLOTS blocks of it fit an SM in every class."""
    d = head_width(h, hv)
    dk, dv = d, min(d, 128)
    lpk = dv // 32
    kw = 32 // lpk
    warp = 2 * kw * (dk + dv + 8 * lpk) + 8 * kw + (8 * 16 if int_mode else 0)
    return 4 * (8 * dk + (32 if int_mode else 0) + 4 * warp)


@functools.lru_cache(maxsize=1024)
def decode_dense_plan(t_kv: int, rows: int, *, sms: int) -> DecodeDensePlan:
    """Split count and tile of the contiguous decodes (rows 5 and 6,
    ``csrc/decode_dense_sm90.cuh``; their copy width is
    :func:`decode_dense_vec`'s) on a card of ``sms`` SMs: ``rows`` (batch
    x kv heads) sweeps over a t_kv-key cache.

    The kernel is bound by the K / V bytes, so the rule asks for enough
    blocks to keep every SM's resident slots busy for several waves --
    DECODE_DENSE_WAVES x DECODE_DENSE_SLOTS x sms blocks -- and for no
    split of fewer than DECODE_DENSE_MIN_KEYS keys of the cache or of
    less than one tile.  It may pass DECODE_MAX_SPLITS, the cap of the
    reference's CPU rule.  The paged decodes take the same count, capped
    at their pages (:func:`decode_splits`).  The kernel's warps and ring
    depth are fixed; ``csrc/decode_dense.cu`` (and ``decode_paged.cu``)
    instantiate both copy widths and take any split count and tile, at
    head dims up to 64 or 128 and -- the contiguous rows only -- MLA's h up
    to 192 against hv up to 128 (:func:`head_width`; two blocks of each
    fit an SM, :func:`decode_dense_smem`).  The split rule does not depend
    on the head dims: the bytes a key does, not the blocks.  The
    int words differ from the reference decode's 128-key tiles only
    through the masked keys past q_pos inside the last visited tile
    (ROADMAP Queue 3)."""
    nblk = cdiv(t_kv, DECODE_DENSE_BLOCK_KV)
    want = cdiv(DECODE_DENSE_WAVES * DECODE_DENSE_SLOTS * sms, max(rows, 1))
    splits = max(1, min(want, nblk, cdiv(t_kv, DECODE_DENSE_MIN_KEYS)))
    return DecodeDensePlan(splits, DECODE_DENSE_BLOCK_KV)
