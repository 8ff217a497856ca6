"""Host-side block pool for the paged KV cache (vLLM-style).

The device side is dumb on purpose: per-layer (N, block_size, ...) pools
plus one (B, max_blocks) int32 block table threaded through
``lm_apply(..., paged=tables)``.  Everything stateful lives here, in
plain python, outside every compiled program:

  * a free list over blocks 1..N-1 — block 0 is the WRITE SENTINEL: the
    kernels clamp out-of-table scatter targets to it, so it is never
    handed out and its contents are never read as valid keys;
  * per-block refcounts — admission takes references, retirement drops
    them, and a block is shared whenever two requests' tables point at
    the same id (prefix caching);
  * a prefix index keyed by CHAIN hashes of full prompt blocks
    (hash of (parent hash, block tokens) — a block is only reusable when
    its entire left context matches, because K/V at a position depends on
    every position before it);
  * an LRU of "cached" blocks: refcount hit 0 but the block still holds
    registered prefix content, so it stays matchable until capacity
    pressure actually evicts it — free-list blocks are preferred for
    allocation, cached blocks are cannibalized oldest-first.

Admission cost is O(blocks touched) of pure bookkeeping — no cache-tree
copies (the contiguous engine's ``_splice_slot`` copied whole rows).
"""
from __future__ import annotations

from collections import OrderedDict


def chain_hashes(tokens, block_size: int) -> list:
    """Chain hash per FULL block of ``tokens``: h_j = hash((h_{j-1},
    block_j tokens)).  Partial trailing blocks get no hash — only full,
    immutable blocks are shareable."""
    out: list = []
    h = 0
    n_full = len(tokens) // block_size
    for j in range(n_full):
        h = hash((h, tuple(tokens[j * block_size:(j + 1) * block_size])))
        out.append(h)
    return out


class BlockPool:
    """Ref-counted fixed-size block allocator with a prefix-hash index."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least one sentinel + one data block")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list over 1..N-1 (0 is the sentinel)
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}
        self._hash_to_block: dict = {}
        self._block_hash: dict[int, object] = {}
        # refcount-0 blocks whose prefix content is still matchable;
        # insertion order = LRU order (oldest evicted first)
        self._cached: OrderedDict[int, None] = OrderedDict()
        self.hwm = 0                      # high-water mark of in_use

    # ---- capacity ----

    def available(self) -> int:
        """Blocks allocatable right now (free + evictable cached)."""
        return len(self._free) + len(self._cached)

    def in_use(self) -> int:
        """Blocks holding live (refcounted) data."""
        return len(self._ref)

    # ---- allocation ----

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` blocks at refcount 1, or None if capacity is short
        (all-or-nothing: a partial admission would deadlock the step
        loop).  Free-list blocks first; then the LRU cached blocks are
        evicted, dropping their prefix index entries."""
        if self.available() < n:
            return None
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._cached.popitem(last=False)   # oldest
                self._drop_hash(b)
            self._ref[b] = 1
            out.append(b)
        self.hwm = max(self.hwm, self.in_use())
        return out

    def ensure_reach(self, held: list[int], tokens: int) -> list[int] | None:
        """Grow ``held`` (a request's block list, mutated in place) until
        it reaches ``tokens`` positions.  Returns the newly allocated
        blocks ([] when the reach is already covered) or None on
        shortfall — all-or-nothing, like :meth:`alloc`, and ``held`` is
        untouched on failure.  This is the reactive-admission growth
        primitive: decode ticks call it right before writing position
        ``tokens - 1`` so the table always covers the scatter target
        (out-of-table writes clamp to the sentinel and silently lose
        data)."""
        need = -(-tokens // self.block_size) - len(held)
        if need <= 0:
            return []
        fresh = self.alloc(need)
        if fresh is None:
            return None
        held.extend(fresh)
        return fresh

    def incref(self, block: int) -> None:
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        """Drop one reference.  At zero the block goes to the cached LRU
        when it still backs a registered prefix (matchable until
        evicted), else straight to the free list."""
        r = self._ref[block] - 1
        if r > 0:
            self._ref[block] = r
            return
        del self._ref[block]
        if block in self._block_hash:
            self._cached[block] = None
            self._cached.move_to_end(block)
        else:
            self._free.append(block)

    # ---- prefix sharing ----

    def match_prefix(self, hashes) -> list[int]:
        """Longest run of ``hashes`` present in the index, as blocks with
        a reference TAKEN on each (cached blocks are revived to refcount
        1).  The caller owns the references — roll back with decref if
        the rest of the admission fails."""
        out = []
        for h in hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            if b in self._cached:
                del self._cached[b]
                self._ref[b] = 1
            else:
                self._ref[b] += 1
            out.append(b)
        self.hwm = max(self.hwm, self.in_use())
        return out

    def peek_prefix(self, hashes) -> list[int]:
        """Longest indexed run of ``hashes`` as blocks — NO references
        taken, nothing mutated.  The feasibility half of :meth:`reserve`."""
        out = []
        for h in hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def reserve(self, hashes, total: int):
        """Atomic admission: take references on the longest indexed
        prefix of ``hashes`` AND allocate the remaining
        ``total - len(prefix)`` fresh blocks, or return None with the
        pool BYTE-IDENTICAL to before the call.

        Feasibility is checked on a reference-free peek first: matched
        blocks sitting in the cached LRU would be revived (leaving the
        evictable set), so they are subtracted from capacity before the
        fresh demand is compared.  The old shape — match_prefix, alloc,
        decref-rollback on shortfall — restored every refcount but
        rotated the revived blocks to the LRU tail, so a failed
        admission silently reordered evictions."""
        shared = self.peek_prefix(hashes)
        need = total - len(shared)
        revive = sum(1 for b in shared if b in self._cached)
        if len(self._free) + len(self._cached) - revive < need:
            return None
        shared = self.match_prefix(hashes)
        fresh = self.alloc(need)
        if fresh is None:           # unreachable: feasibility was checked
            for b in shared:
                self.decref(b)
            return None
        return shared, fresh

    def register(self, hashes, blocks) -> None:
        """Index ``blocks`` (just-prefilled FULL prompt blocks) under
        their chain hashes.  First writer wins: a hash already indexed
        keeps its existing block (concurrent identical prompts prefill
        privately; the duplicate simply stays unshared)."""
        for h, b in zip(hashes, blocks):
            if h not in self._hash_to_block:
                self._hash_to_block[h] = b
                self._block_hash[b] = h

    def _drop_hash(self, block: int) -> None:
        h = self._block_hash.pop(block, None)
        if h is not None and self._hash_to_block.get(h) == block:
            del self._hash_to_block[h]
