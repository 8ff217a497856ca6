"""Paged-cache cases shared by the CPU tests of the paged decodes (rows 3
and 4): the per-key pool address the kernel resolves, the inputs behind a
shuffled block table, and the layouts they are held at."""
import numpy as np
import torch


def kv_rows(k, v, tables, bi, keys):
    """The K and V rows (n, K, h|hv) of logical keys ``keys`` of batch row
    bi: contiguous, or (``tables`` given, k and v the pools) each key
    resolved once to its pool row -- blk bs + key % bs, blk =
    tables[bi, key // bs], an entry outside the pool reading block 0 --
    which serves both K and V, as the paged kernel resolves a step."""
    if tables is None:
        return k[bi, keys], v[bi, keys]
    n_pool, bs = k.shape[:2]
    blk = tables[bi, keys // bs].long()
    blk = torch.where((blk >= 0) & (blk < n_pool), blk, 0)
    row = blk * bs + keys % bs
    return k.flatten(0, 1)[row], v.flatten(0, 1)[row]


def paged_case(seed, b, kh, g, h, hv, bs, nblk, q_pos, tails, grid=False):
    """(q pre-scaled, k pool, v pool, tables, q_pos, kv_valid): pools of
    1 + b nblk blocks behind shuffled tables; ``tails``: the entries past
    each row's q_pos page are the sentinel 0 ('sentinel') or outside the
    pool ('out', with one live entry outside it too); a quarter of the
    keys invalid.  ``grid``: q and k on multiples of 2^-4 before q's
    scale, so the int scores are exact."""
    rs = np.random.RandomState(seed)
    n_pool = 1 + b * nblk
    q = rs.randn(b, kh, g, h)
    k = rs.randn(n_pool, bs, kh, h)
    if grid:
        q, k = np.round(q * 4) / 16, np.round(k * 4) / 16
    q = q * h ** -0.5
    v = rs.randn(n_pool, bs, kh, hv)
    tables = (rs.permutation(n_pool - 1) + 1).reshape(b, nblk)
    qp = np.asarray(q_pos, np.int32)
    past = (np.maximum(qp, 0)[:, None] // bs) < np.arange(nblk)[None, :]
    if tails == "sentinel":
        tables = np.where(past, 0, tables)
    elif tails == "out":
        far = rs.choice([-5, -1, n_pool, n_pool + 9], size=tables.shape)
        tables = np.where(past, far, tables)
        tables[0, 0] = -1
    valid = (rs.rand(b, nblk * bs) > 0.25).astype(np.uint8)
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(k.astype(np.float32)),
            torch.from_numpy(v.astype(np.float32)),
            torch.from_numpy(tables.astype(np.int32)), torch.from_numpy(qp),
            torch.from_numpy(valid))


# (b, kh, g, h, hv, bs, nblk, q_pos, causal, num_splits, tails)
PAGED = [
    # qwen's tick at small scale: 128-key pages, the plan's many splits
    (4, 2, 1, 64, 64, 128, 4, [5, 127, 300, 511], True, 3, "sentinel"),
    # 8-key pages, smaller than a step (16 keys): a step spans two pages;
    # entries outside the pool read block 0
    (3, 2, 2, 64, 64, 8, 12, [3, 40, 95], True, 5, "out"),
    # 40-key pages (not a power of two), G 8 at h 128 (8-key steps)
    (2, 1, 8, 128, 128, 40, 5, [150, 199], True, 4, "sentinel"),
    # 4-byte copies (h 30, hv 62)
    (2, 3, 2, 30, 62, 40, 4, [70, 159], True, 3, "out"),
    # not causal: every page visited, the out-of-pool tails too
    (2, 2, 2, 64, 64, 16, 6, [0, 0], False, 4, "out"),
    # q_pos -1 (every split the identity); more splits than live pages
    (3, 2, 2, 64, 64, 16, 8, [-1, 20, 127], True, 6, "sentinel"),
]
