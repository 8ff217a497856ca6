"""Batched serving engine of the port: continuous batching over a paged
or a contiguous KV cache (counterpart of ``repro.serve.engine``).

``paged`` (the default for the attention-only archs the port runs) --
per engine step: admit queued requests into free slots (reactive
admission: reserve each prompt's block reach with ``BlockPool.reserve``,
sharing full prompt blocks already cached), advance the oldest
mid-prefill slot by one ``prefill_chunk``-token chunk, grow every
decoding slot's block table to cover its next write (``ensure_reach``),
then run one lockstep decode tick over all decoding slots.

``contiguous`` -- per-slot (n_slots, max_seq, ...) rows: a request is
admitted by a whole-prompt prefill at batch 1, padded to the smallest
``prefill_buckets`` entry that holds it, into a fresh row cache that is
then copied into the slot's row (``stats['cache_copies']``); each step
then runs one lockstep decode tick over every slot at its own depth.
This is the long-context layout: at max_seq 16384 the buckets prefill
through the blocked kernels and decode through the contiguous split-KV
kernels.  It is also the only layout of the cross-attention arch
(llama-3.2-vision): a request's ``cross_src`` image embeddings (1,
n_img_tokens, d) go to its prefill, which writes their K/V into the row's
cross caches; decode ticks read them from there, and a request without
embeddings attends over the fresh row's zero cross cache, as in the
reference.  ``cache_mode='auto'`` is paged where every cached layer can
be paged (``paged_supported``) and contiguous otherwise; ``'paged'`` on
a cross arch raises ValueError.

Attention impls (and the softmax of each phase) are resolved once per
phase through the dispatch registry, for the engine's device, at the
phase's widest shape: paged (prefill_chunk, table extent) and (1, table
extent); contiguous (largest bucket, max_seq) and (1, max_seq).

Not in the port yet (a later slice brings them): preemption (recompute
or swap), deadlines, skip-ahead admission (``hol_window``), the per-step
isfinite quarantine, the fault harness, and the other archs that need
the contiguous cache (mamba / rwkv state, encoder-decoder stacks).  Where
a decode tick would need a preemption -- the pool cannot grow a slot's
table -- the engine raises NotImplementedError instead of dropping or
stalling the request.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import dispatch, tiling
from repro_torch.models.transformer import (check_supported, init_caches,
                                            init_paged_caches, lm_apply,
                                            paged_supported)

from .paged_cache import BlockPool, chain_hashes

Params = Any


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: torch.Generator | None = None) -> int:
    """Greedy argmax at temperature <= 0, else a draw from
    softmax(logits / temperature) with ``generator``."""
    if temperature <= 0.0:
        return int(torch.argmax(logits, dim=-1))
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    temperature: float = 0.0
    cross_src: Any = None            # (1, n_img_tokens, d) image embeddings


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    pos: int = 0
    remaining: int = 0
    out: list = dataclasses.field(default_factory=list)
    temperature: float = 0.0
    # while `prompt` is set the slot is mid-prefill (`filled` tokens
    # written); `blocks` are the table entries it holds references on
    prompt: list | None = None
    filled: int = 0
    blocks: list = dataclasses.field(default_factory=list)
    seq: int = 0                     # admission order (FCFS prefill)

    @property
    def free(self) -> bool:
        return self.rid < 0

    @property
    def decoding(self) -> bool:
        return self.rid >= 0 and self.prompt is None


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Params, *,
                 n_slots: int = 4, max_seq: int = 512,
                 eos_id: int | None = None,
                 prefill_attn_impl: str | None = None,
                 decode_attn_impl: str | None = None,
                 prefill_softmax_impl: str | None = None,
                 decode_softmax_impl: str | None = None,
                 seed: int = 0, cache_mode: str = "auto",
                 prefill_buckets: tuple[int, ...] = (32, 128, 512),
                 block_size: int | None = None,
                 num_blocks: int | None = None,
                 prefill_chunk: int | None = None, device=None):
        self.device = resolve_device(device)
        check_on(self.device, embed=params["embed"])
        if cache_mode not in ("auto", "paged", "contiguous"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        check_supported(cfg)
        if cache_mode == "paged" and not paged_supported(cfg):
            raise ValueError(
                "cache_mode='paged' requires attention-only cached layers "
                "(no cross-attention) -- use 'auto' or 'contiguous'")
        self.cache_mode = ("paged" if cache_mode == "paged" or (
            cache_mode == "auto" and paged_supported(cfg)) else "contiguous")
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.eos_id = eos_id
        self.buckets = tuple(b for b in sorted(prefill_buckets)
                             if b <= max_seq) or (max_seq,)
        if self.cache_mode == "paged":
            self.block_size = block_size or tiling.paged_block_size(max_seq)
            self.max_blocks = tiling.cdiv(max_seq, self.block_size)
            # default pool = the contiguous budget (+1 sentinel)
            self.num_blocks = num_blocks or (n_slots * self.max_blocks + 1)
            self.prefill_chunk = min(prefill_chunk or 64, max_seq)
            self.pool = BlockPool(self.num_blocks, self.block_size)
            self.caches = init_paged_caches(cfg, self.num_blocks,
                                            self.block_size, self.device)
            self._tables = np.zeros((n_slots, self.max_blocks), np.int32)
            prefill_sq = self.prefill_chunk
            t_kv = self.max_blocks * self.block_size
        else:
            self.pool = None
            self.caches = init_caches(cfg, n_slots, max_seq, self.device)
            prefill_sq, t_kv = self.buckets[-1], max_seq

        # per-phase softmax and attention impls, resolved once at each
        # phase's widest shape: a prefill chunk (paged) or the largest
        # bucket (contiguous) against the whole cache, one decode row
        # against it
        self.prefill_softmax_impl = (prefill_softmax_impl
                                     or cfg.softmax_impl)
        self.decode_softmax_impl = decode_softmax_impl or cfg.softmax_impl
        self.prefill_attn_impl = dispatch.resolve_attention(
            prefill_attn_impl or cfg.attn_impl, prefill_sq, t_kv,
            softmax_impl=self.prefill_softmax_impl, device=self.device)
        self.decode_attn_impl = dispatch.resolve_attention(
            decode_attn_impl or cfg.attn_impl, 1, t_kv,
            softmax_impl=self.decode_softmax_impl, device=self.device)
        self._prefill_cfg = cfg.replace(attn_impl=self.prefill_attn_impl,
                                        softmax_impl=self.prefill_softmax_impl)
        self._decode_cfg = cfg.replace(attn_impl=self.decode_attn_impl,
                                       softmax_impl=self.decode_softmax_impl)
        self._slots = [_Slot() for _ in range(n_slots)]
        self._admit_seq = 0
        self._queue: list[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.finished: dict[int, list[int]] = {}
        self.reasons: dict[int, str] = {}
        self._last_tok = torch.zeros((n_slots, 1), dtype=torch.long,
                                     device=self.device)
        self.stats = {"prefills": 0, "decode_steps": 0, "admitted": 0,
                      "prefill_chunks": 0, "cache_copies": 0,
                      "shared_blocks": 0,
                      "blocks_hwm": 0, "engine_steps": 0, "nonfinite": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    # ---- compiled-step counterparts ----

    def prefill_chunk_logits(self, tokens, pos: int, tables, last_idx):
        """One prompt chunk (1, C) written at ``pos`` through a (1,
        max_blocks) table -> (1, V) logits at row ``last_idx``."""
        logits, self.caches = lm_apply(
            self.params, self._prefill_cfg, tokens, pos=pos,
            caches=self.caches, last_pos=last_idx, paged=tables,
            device=self.device)
        return logits[:, -1, :]

    def prefill_logits(self, tokens, row_caches, last_idx, cross_src=None):
        """Contiguous mode: one whole prompt (1, L), padded to its bucket,
        written at 0 into the batch-1 ``row_caches`` (with the cross K/V of
        ``cross_src`` (1, n_img_tokens, d), if given) -> (1, V) logits at
        row ``last_idx``."""
        logits, _ = lm_apply(self.params, self._prefill_cfg, tokens, pos=0,
                             caches=row_caches, cross_src=cross_src,
                             last_pos=last_idx, device=self.device)
        return logits[:, -1, :]

    def decode_logits(self, tokens, pos, tables=None):
        """One lockstep decode tick: tokens (B, 1) at depths ``pos`` (B,)
        through (B, max_blocks) tables (paged) or the slot rows
        (contiguous, ``tables`` None) -> (B, V) logits."""
        logits, self.caches = lm_apply(
            self.params, self._decode_cfg, tokens, pos=pos,
            caches=self.caches, paged=tables, device=self.device)
        return logits[:, -1, :]

    # ---- host-side bookkeeping ----

    def submit(self, req: Request) -> None:
        n = len(req.prompt)
        if n < 1:
            raise ValueError("empty prompt")
        if self.cache_mode == "contiguous":
            self._bucket(n)
            self._queue.append(req)
            return
        if n > self.max_seq:
            raise ValueError(f"prompt length {n} exceeds max_seq "
                             f"{self.max_seq}")
        need = tiling.cdiv(min(n + max(req.max_new, 0), self.max_seq),
                           self.block_size)
        if need > self.num_blocks - 1:
            raise ValueError(f"request needs {need} blocks, exceeds pool "
                             f"of {self.num_blocks - 1}")
        self._queue.append(req)

    def _bucket(self, n: int) -> int:
        """The smallest prefill bucket that holds an n-token prompt."""
        if n > self.max_seq:
            raise ValueError(f"prompt length {n} exceeds max_seq "
                             f"{self.max_seq}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _drain_zero_tokens(self) -> None:
        """Finish max_new <= 0 requests at the queue head with empty
        outputs: they never take a slot or a prefill."""
        while self._queue and self._queue[0].max_new <= 0:
            req = self._queue.pop(0)
            self.finished[req.rid] = []
            self.reasons[req.rid] = "max_new"
            self.stats["admitted"] += 1

    def _admit(self) -> None:
        self._drain_zero_tokens()
        for i, slot in enumerate(self._slots):
            if not self._queue:
                break
            if not slot.free:
                continue
            if self.cache_mode == "contiguous":
                self._admit_contiguous(i, self._queue.pop(0))
            elif self._admit_paged(i, self._queue[0]):
                self._queue.pop(0)
            else:
                break                      # strict FCFS: wait for blocks
            self._drain_zero_tokens()

    def _admit_contiguous(self, i: int, req: Request) -> None:
        """Prefill the whole prompt at its bucket into a fresh batch-1 row
        cache, copy that row into slot ``i`` of the batch cache, and
        sample the first token."""
        t0 = time.perf_counter()
        plen = len(req.prompt)
        bucket = self._bucket(plen)
        toks = torch.tensor([req.prompt + [0] * (bucket - plen)],
                            dtype=torch.long, device=self.device)
        row = init_caches(self.cfg, 1, self.max_seq, self.device)
        cross = (None if req.cross_src is None else torch.as_tensor(
            req.cross_src, dtype=torch.float32).to(self.device))
        logits = self.prefill_logits(
            toks, row, torch.tensor([plen - 1], device=self.device), cross)
        for full, one in zip(self.caches, row):
            for pair in ("kv", "cross_kv"):
                if pair in full:
                    full[pair]["k"][i].copy_(one[pair]["k"][0])
                    full[pair]["v"][i].copy_(one[pair]["v"][0])
        self.stats["cache_copies"] += 1
        self._check_logits(logits)
        s = _Slot(rid=req.rid, pos=plen, remaining=req.max_new,
                  temperature=req.temperature, seq=self._admit_seq)
        self._slots[i] = s
        self._admit_seq += 1
        tok = sample_token(logits[0], s.temperature, self._gen)
        s.out.append(tok)
        s.remaining -= 1
        self._last_tok[i, 0] = tok
        self.stats["prefills"] += 1
        self.stats["admitted"] += 1
        self._retire(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _admit_paged(self, i: int, req: Request) -> bool:
        """Zero-copy admission: reserve the prompt's block reach (shared
        full-block prefix by reference, the rest fresh) and write the
        slot's table row.  False, with the pool untouched, when short."""
        plen = len(req.prompt)
        total = tiling.cdiv(plen, self.block_size)
        # never share the block holding the last prompt token: at least
        # one token must run through prefill to give the first logits
        hashes = chain_hashes(req.prompt, self.block_size)
        got = self.pool.reserve(hashes[:(plen - 1) // self.block_size],
                                total)
        if got is None:
            return False
        shared, fresh = got
        blocks = shared + fresh
        self._tables[i, :] = 0
        self._tables[i, :len(blocks)] = blocks
        self._slots[i] = _Slot(rid=req.rid, pos=plen, remaining=req.max_new,
                               temperature=req.temperature,
                               prompt=list(req.prompt),
                               filled=len(shared) * self.block_size,
                               blocks=blocks, seq=self._admit_seq)
        self._admit_seq += 1
        self.stats["admitted"] += 1
        self.stats["shared_blocks"] += len(shared)
        self.stats["blocks_hwm"] = max(self.stats["blocks_hwm"],
                                       self.pool.in_use())
        return True

    def _grow_decode_tables(self) -> None:
        """Every decoding slot's table must cover position ``pos`` before
        the tick writes there (out-of-table writes land in the sentinel
        block and would lose the token's K/V)."""
        for _, i in sorted((s.seq, i) for i, s in enumerate(self._slots)
                           if s.decoding):
            s = self._slots[i]
            fresh = self.pool.ensure_reach(s.blocks, s.pos + 1)
            if fresh is None:
                raise NotImplementedError(
                    f"request {s.rid} needs a KV block and the pool is "
                    "exhausted: preemption is not ported yet (a later slice "
                    "of the port brings it); size num_blocks for the "
                    "traffic")
            if fresh:
                self._tables[i, :len(s.blocks)] = s.blocks
                self.stats["blocks_hwm"] = max(self.stats["blocks_hwm"],
                                               self.pool.in_use())

    def _check_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Count rows with a non-finite logit (stats['nonfinite'])."""
        finite = torch.isfinite(logits).all(dim=-1)
        self.stats["nonfinite"] += int((~finite).sum())
        return finite

    def _prefill_tick(self) -> None:
        """Advance the OLDEST mid-prefill slot by one chunk."""
        filling = [(s.seq, i) for i, s in enumerate(self._slots)
                   if not s.free and s.prompt is not None]
        if not filling:
            return
        _, i = min(filling)
        s = self._slots[i]
        c0 = s.filled
        real = s.prompt[c0:c0 + self.prefill_chunk]
        toks = torch.tensor([real + [0] * (self.prefill_chunk - len(real))],
                            dtype=torch.long, device=self.device)
        last_idx = torch.tensor([len(real) - 1], device=self.device)
        tables = torch.from_numpy(self._tables[i:i + 1]).to(self.device)
        t0 = time.perf_counter()
        logits = self.prefill_chunk_logits(toks, c0, tables, last_idx)
        s.filled = c0 + len(real)
        self.stats["prefill_chunks"] += 1
        if s.filled >= len(s.prompt):
            self._check_logits(logits)
            # the prompt's full blocks are written and immutable now
            n_full = len(s.prompt) // self.block_size
            self.pool.register(chain_hashes(s.prompt, self.block_size),
                               [int(b) for b in self._tables[i, :n_full]])
            s.prompt = None
            tok = sample_token(logits[0], s.temperature, self._gen)
            s.out.append(tok)
            s.remaining -= 1
            self._last_tok[i, 0] = tok
            self.stats["prefills"] += 1
            self._retire(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _finish_slot(self, i: int, reason: str) -> None:
        s = self._slots[i]
        self.finished[s.rid] = s.out
        self.reasons[s.rid] = reason
        if self.pool is not None:
            for b in s.blocks:
                self.pool.decref(b)
            self._tables[i, :] = 0
        self._slots[i] = _Slot()

    def _retire(self, i: int) -> None:
        s = self._slots[i]
        if self.eos_id is not None and s.out and s.out[-1] == self.eos_id:
            self._finish_slot(i, "eos")
        elif s.remaining <= 0:
            self._finish_slot(i, "max_new")
        elif s.pos >= self.max_seq - 1:
            self._finish_slot(i, "max_seq")

    @property
    def active(self) -> int:
        return sum(not s.free for s in self._slots)

    def pending(self) -> int:
        return len(self._queue) + self.active

    # ---- one engine step = admit + prefill chunk + one lockstep decode ----

    def step(self) -> None:
        self.stats["engine_steps"] += 1
        self._admit()
        if self.cache_mode == "paged":
            self._prefill_tick()
            self._grow_decode_tables()
        decoding = np.array([s.decoding for s in self._slots])
        if not decoding.any():
            return
        t0 = time.perf_counter()
        pos = torch.tensor([s.pos if s.decoding else 0 for s in self._slots],
                           dtype=torch.int32, device=self.device)
        tables = None
        if self.cache_mode == "paged":
            # non-decoding rows get all-sentinel tables: their writes land
            # in block 0, never in a mid-prefill slot's blocks
            tables = torch.from_numpy(np.where(
                decoding[:, None], self._tables, 0)).to(self.device)
        # contiguous: a free slot writes its own row at 0, which the next
        # admission into it overwrites whole
        logits = self.decode_logits(self._last_tok, pos, tables)
        self._check_logits(logits[torch.from_numpy(decoding).to(
            self.device)])
        self.stats["decode_steps"] += 1
        toks = torch.argmax(logits, dim=-1).tolist()      # one host pull
        for i, s in enumerate(self._slots):
            if s.decoding and s.temperature > 0.0:
                toks[i] = sample_token(logits[i], s.temperature, self._gen)
        for i, s in enumerate(self._slots):
            if not s.decoding:
                continue
            s.out.append(toks[i])
            s.pos += 1
            s.remaining -= 1
            self._last_tok[i, 0] = toks[i]
            self._retire(i)
        self.stats["decode_s"] += time.perf_counter() - t0

    def run(self, requests: list[Request], max_steps: int = 100_000
            ) -> dict[int, list[int]]:
        for r in requests:
            self.submit(r)
        steps = 0
        while self.pending():
            if steps >= max_steps:
                raise RuntimeError(
                    f"{self.pending()} requests still pending after "
                    f"{max_steps} engine steps")
            self.step()
            steps += 1
        return dict(self.finished)
