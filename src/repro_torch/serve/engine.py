"""Batched serving engine of the port: continuous batching over a paged
or a contiguous KV cache (counterpart of ``repro.serve.engine``).

``paged`` (the default for the attention-only archs the port runs) --
per engine step: check every occupied slot's table row against its host
block list, expire deadlines, admit queued requests into free slots,
advance the oldest mid-prefill slot by one ``prefill_chunk``-token chunk,
grow every decoding slot's block table to cover its next write
(``ensure_reach``), then run one lockstep decode tick over all decoding
slots.

``contiguous`` -- per-slot (n_slots, max_seq, ...) rows: a request is
admitted by a whole-prompt prefill at batch 1, padded to the smallest
``prefill_buckets`` entry that holds it, into a fresh row cache that is
then copied into the slot's row (``stats['cache_copies']``); each step
then runs one lockstep decode tick over every slot at its own depth.
This is the long-context layout: at max_seq 16384 the buckets prefill
through the blocked kernels and decode through the contiguous split-KV
kernels.  It is also the only layout of the cross-attention archs
(llama-3.2-vision, and the encoder-decoder whisper-base): a request's
``cross_src`` -- image embeddings (1, n_img_tokens, d), or frame
embeddings (1, n_frames, d) that the encoder (``encoder_apply``) turns
into the decoder's context at admission -- goes to its prefill, which
writes their K/V into the row's cross caches; decode ticks read them from
there, and a request without one attends over the fresh row's zero cross
cache, as in the reference.  ``cache_mode='auto'`` is paged where every
cached layer can be paged (``paged_supported``: attention and MLA
layers; an MLA layer pages its latent and rope key) and contiguous
otherwise; ``'paged'`` on a cross arch or a recurrent one raises
ValueError.

The archs with a recurrent mixer (rwkv6; jamba's mamba layers) carry a
state that integrates every input token, so a right-padded bucket would
fold its pad tokens into the state: they prefill at the prompt's own
length (``_bucket`` returns it), as the reference does, and the prefill's
attention impl (jamba's attention layer) is resolved at (max_seq,
max_seq).  Admission copies every cache tensor of the row, the states
included, over the slot's old contents; a free slot's state drifts
through the lockstep ticks until then, and nothing reads it.

Attention impls (and the softmax of each phase) are resolved once per
phase through the dispatch registry, for the engine's device, at the
phase's widest shape: paged (prefill_chunk, table extent) and (1, table
extent); contiguous (largest bucket, max_seq) and (1, max_seq); the
encoder (n_frames, n_frames) with the prefill's softmax and impl.

Serving under pressure (paged mode), as the reference serves it:
``admission='reactive'`` (the default) reserves only a request's PROMPT
reach (``BlockPool.reserve``, sharing full prompt blocks already cached)
and grows its table a block at a time before the decode tick writes past
it; ``'worst_case'`` reserves prompt + max_new up front.  When the pool
cannot grow a slot, the engine preempts a victim (``preempt_policy``:
lowest priority first, then the youngest or oldest admission; a grower
that would have to evict a slot of higher priority yields instead),
either dropping its blocks so that prompt + generated tokens re-enter
the queue head as one chunked prefill (``preempt_mode='recompute'``) or
copying its blocks' K/V rows to host memory, pinned on a GPU, and
restoring them on resume (``'swap'``).  Admission may skip past a
blocked queue head to the first entry within ``hol_window`` that fits
(1 = strict FCFS).  Requests carry a ``deadline_s`` budget on the
injected ``clock`` and a ``priority``.  Each step checks the host tables
(a mismatch retires the slot, reason ``'corrupt'``) and every sampled
row's logits (a non-finite row retires only its slot, reason
``'numeric'``; sampling at temperature > 0 draws from a generator keyed
by (seed, engine step, slot index), so the neighbours' draws do not
move).  ``run(max_steps)`` finishes whatever is left when the steps run
out with reason ``'starved'``.  ``finished[rid]`` always holds every
token a request produced, across its preemptions, and
``reasons[rid]`` why it left.  Faults are injected through
``repro_torch.serve.faults``.

Not in the port yet: a device mesh.
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
from repro_torch.models.transformer import (check_supported,
                                            encoder_apply, init_caches,
                                            init_paged_caches, lm_apply,
                                            paged_supported,
                                            recurrent_mixers)

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
    # (1, n_img_tokens, d) image embeddings (vlm) or (1, n_frames, d)
    # frame embeddings, run through the encoder at admission (encdec)
    cross_src: Any = None
    deadline_s: float | None = None  # wall-clock budget from submission
    priority: int = 0                # higher = preempted later


@dataclasses.dataclass
class _QEntry:
    """A queued request: fresh, or preempted and waiting to resume.  A
    recompute resume carries ``resume_prompt`` (the original prompt and
    every token generated so far: one chunked prefill rewrites the dropped
    K/V); a swap resume carries the saved block rows and re-enters decode
    at ``pos``."""
    req: Request
    deadline_at: float | None = None
    prior_out: list = dataclasses.field(default_factory=list)
    resume_prompt: list | None = None
    swap: Any = None                 # {'saved': per-layer host rows, 'n'}
    pos: int = 0                     # swap resume: decode depth
    out: list = dataclasses.field(default_factory=list)  # swap resume

    @property
    def is_resume(self) -> bool:
        return self.resume_prompt is not None or self.swap is not None


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
    # the original prompt and the tokens of earlier incarnations (before
    # a preemption): `finished[rid]` is always prior_out + out
    full_prompt: list = dataclasses.field(default_factory=list)
    prior_out: list = dataclasses.field(default_factory=list)
    priority: int = 0
    deadline_at: float | None = None

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
                 prefill_chunk: int | None = None,
                 admission: str = "reactive",
                 preempt_policy: str = "youngest",
                 preempt_mode: str = "recompute",
                 hol_window: int = 4,
                 faults=None, clock=None, device=None):
        self.device = resolve_device(device)
        check_on(self.device, embed=params["embed"])
        if cache_mode not in ("auto", "paged", "contiguous"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if admission not in ("reactive", "worst_case"):
            raise ValueError(f"unknown admission {admission!r}")
        if preempt_policy not in ("youngest", "oldest"):
            raise ValueError(f"unknown preempt_policy {preempt_policy!r}")
        if preempt_mode not in ("recompute", "swap"):
            raise ValueError(f"unknown preempt_mode {preempt_mode!r}")
        check_supported(cfg)
        if cache_mode == "paged" and not paged_supported(cfg):
            raise ValueError(
                "cache_mode='paged' requires attention-only cached layers "
                "(no mamba / rwkv state, no cross-attention, no encoder) -- "
                "use 'auto' or 'contiguous'")
        self.cache_mode = ("paged" if cache_mode == "paged" or (
            cache_mode == "auto" and paged_supported(cfg)) else "contiguous")
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_seq = n_slots, max_seq
        self.eos_id = eos_id
        self.admission = admission
        self.preempt_policy = preempt_policy
        self.preempt_mode = preempt_mode
        self.hol_window = max(1, hol_window)
        self.faults = faults
        self._now = clock or time.monotonic
        self.seed = seed
        self.buckets = tuple(b for b in sorted(prefill_buckets)
                             if b <= max_seq) or (max_seq,)
        # a recurrent state integrates every input token: those archs
        # prefill at the prompt's own length, never a padded bucket
        self._exact_prefill = bool(recurrent_mixers(cfg))
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
            prefill_sq = max_seq if self._exact_prefill else self.buckets[-1]
            t_kv = max_seq

        # per-phase softmax and attention impls, resolved once at each
        # phase's widest shape: a prefill chunk (paged) or the largest
        # bucket (contiguous; max_seq for an exact-length prefill)
        # against the whole cache, one decode row against it
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
        self.encoder_attn_impl = None
        if cfg.enc_layers:
            self.encoder_attn_impl = dispatch.resolve_attention(
                prefill_attn_impl or cfg.attn_impl, cfg.n_frames,
                cfg.n_frames, softmax_impl=self.prefill_softmax_impl,
                device=self.device)
            self._encoder_cfg = self._prefill_cfg.replace(
                attn_impl=self.encoder_attn_impl)
        self._slots = [_Slot() for _ in range(n_slots)]
        self._admit_seq = 0
        self._queue: list[_QEntry] = []
        self.finished: dict[int, list[int]] = {}
        self.reasons: dict[int, str] = {}
        self._last_tok = torch.zeros((n_slots, 1), dtype=torch.long,
                                     device=self.device)
        self.stats = {"prefills": 0, "decode_steps": 0, "admitted": 0,
                      "prefill_chunks": 0, "cache_copies": 0,
                      "shared_blocks": 0, "blocks_hwm": 0, "engine_steps": 0,
                      "preemptions": 0, "swap_outs": 0, "swap_ins": 0,
                      "resumes": 0, "hol_skips": 0, "admit_blocked": 0,
                      "numeric": 0, "corrupt": 0, "deadlines": 0,
                      "starved": [], "prefill_s": 0.0, "decode_s": 0.0,
                      "swap_s": 0.0, "swap_bytes": 0}

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
        ``cross_src`` (1, T, d), image embeddings or the encoder's output,
        if given) -> (1, V) logits at row ``last_idx``."""
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
        else:
            if n > self.max_seq:
                raise ValueError(f"prompt length {n} exceeds max_seq "
                                 f"{self.max_seq}")
            need = self._blocks_needed(req)
            if need > self.num_blocks - 1:
                raise ValueError(f"request needs {need} blocks, exceeds "
                                 f"pool of {self.num_blocks - 1}")
        ddl = (None if req.deadline_s is None
               else self._now() + req.deadline_s)
        self._queue.append(_QEntry(req=req, deadline_at=ddl))

    def _bucket(self, n: int) -> int:
        """The smallest prefill bucket that holds an n-token prompt (n
        itself for an arch with a recurrent mixer)."""
        if n > self.max_seq:
            raise ValueError(f"prompt length {n} exceeds max_seq "
                             f"{self.max_seq}")
        if self._exact_prefill:
            return n
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _blocks_needed(self, req: Request) -> int:
        """Worst-case table entries: prompt + max_new tokens, clipped by
        the max_seq retire guard."""
        cap = min(len(req.prompt) + max(req.max_new, 0), self.max_seq)
        return tiling.cdiv(max(cap, 1), self.block_size)

    def _sample(self, logits: torch.Tensor, i: int, phase: int) -> int:
        """Slot ``i``'s token from its (V,) logits.  At temperature > 0
        the draw comes from a generator keyed by (seed, engine step, slot
        index, phase: 0 prefill completion, 1 decode tick), so retiring
        one slot moves no other slot's draw."""
        s = self._slots[i]
        if s.temperature <= 0.0:
            return sample_token(logits, s.temperature)
        key = np.random.SeedSequence(
            (self.seed, self.stats["engine_steps"], i, phase))
        gen = torch.Generator(device=self.device).manual_seed(
            int(key.generate_state(1)[0]))
        return sample_token(logits, s.temperature, gen)

    def _finish_queued(self, e: _QEntry, reason: str) -> None:
        self.finished[e.req.rid] = e.prior_out + e.out
        self.reasons[e.req.rid] = reason

    def _drain_zero_tokens(self) -> None:
        """Finish fresh max_new <= 0 requests at the queue head with empty
        outputs: they never take a slot or a prefill.  A resume always
        has tokens left (a done slot retires instead of preempting)."""
        while (self._queue and not self._queue[0].is_resume
               and self._queue[0].req.max_new <= 0):
            self._finish_queued(self._queue.pop(0), "max_new")
            self.stats["admitted"] += 1

    def _expire_queue_deadlines(self) -> None:
        """Retire queued entries whose budget ran out before they reached
        a slot (reason 'deadline'; a preempted resume keeps the tokens it
        produced)."""
        if not any(e.deadline_at is not None for e in self._queue):
            return
        now = self._now()
        kept = []
        for e in self._queue:
            if e.deadline_at is not None and now >= e.deadline_at:
                self._finish_queued(e, "deadline")
                self.stats["deadlines"] += 1
            else:
                kept.append(e)
        self._queue = kept

    def _expire_running_deadlines(self) -> None:
        now = None
        for i, s in enumerate(self._slots):
            if s.free or s.deadline_at is None:
                continue
            now = self._now() if now is None else now
            if now >= s.deadline_at:
                self.stats["deadlines"] += 1
                self._finish_slot(i, "deadline")

    def _admit(self) -> None:
        self._expire_queue_deadlines()
        self._drain_zero_tokens()
        for i, slot in enumerate(self._slots):
            if not self._queue:
                break
            if not slot.free:
                continue
            if self.cache_mode == "contiguous":
                self._admit_contiguous(i, self._queue.pop(0))
            elif not self._admit_paged_window(i):
                # nothing in the skip-ahead window fits the pool
                self.stats["admit_blocked"] += 1
                break
            self._drain_zero_tokens()

    def _admit_paged_window(self, i: int) -> bool:
        """Admit the first queue entry within ``hol_window`` that the pool
        can take: a small request may skip past a blocked large one
        (stats['hol_skips']).  The admission order still sets the prefill
        order, so whoever is admitted first registers its prefix first."""
        for j in range(min(len(self._queue), self.hol_window)):
            entry = self._queue[j]
            if j > 0 and not entry.is_resume and entry.req.max_new <= 0:
                continue            # drains at the head, never via a slot
            admitted = (self._admit_swapped(i, entry)
                        if entry.swap is not None
                        else self._admit_paged(i, entry))
            if admitted:
                self._queue.pop(j)
                if j > 0:
                    self.stats["hol_skips"] += 1
                return True
        return False

    def _admit_contiguous(self, i: int, entry: _QEntry) -> None:
        """Prefill the whole prompt at its bucket into a fresh batch-1 row
        cache, copy that row (K / V rows, cross K / V, recurrent states)
        over slot ``i`` of the batch cache, and sample the first token."""
        t0 = time.perf_counter()
        req = entry.req
        plen = len(req.prompt)
        bucket = self._bucket(plen)
        toks = torch.tensor([req.prompt + [0] * (bucket - plen)],
                            dtype=torch.long, device=self.device)
        row = init_caches(self.cfg, 1, self.max_seq, self.device)
        cross = (None if req.cross_src is None else torch.as_tensor(
            req.cross_src, dtype=torch.float32).to(self.device))
        if cross is not None and self.cfg.enc_layers:
            cross = encoder_apply(self.params, self._encoder_cfg, cross,
                                  device=self.device)
        logits = self.prefill_logits(
            toks, row, torch.tensor([plen - 1], device=self.device), cross)
        for full, one in zip(self.caches, row):
            for name, pair in full.items():
                for key, rows in pair.items():
                    rows[i].copy_(one[name][key][0])
        self.stats["cache_copies"] += 1
        self._slots[i] = _Slot(rid=req.rid, pos=plen, remaining=req.max_new,
                               temperature=req.temperature,
                               seq=self._admit_seq,
                               full_prompt=list(req.prompt),
                               priority=req.priority,
                               deadline_at=entry.deadline_at)
        self._admit_seq += 1
        self.stats["prefills"] += 1
        self.stats["admitted"] += 1
        if self._prefill_sentry(i, logits):
            self._first_token(i, logits)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _admit_paged(self, i: int, entry: _QEntry) -> bool:
        """Zero-copy admission: reserve the block reach (shared full-block
        prefix by reference, the rest fresh) and write the slot's table
        row.  Reactive admission reserves the prompt's reach and lets the
        decode tick grow it; 'worst_case' reserves prompt + max_new.
        False, with the pool untouched, when short."""
        req = entry.req
        prompt = (entry.resume_prompt if entry.resume_prompt is not None
                  else req.prompt)
        plen = len(prompt)
        budget = max(req.max_new, 0) - len(entry.prior_out)
        if self.admission == "worst_case":
            cap = min(plen + max(budget, 0), self.max_seq)
        else:
            cap = plen
        total = tiling.cdiv(max(cap, 1), self.block_size)
        if (self.faults is not None and self.faults.alloc_shortfall(
                "admit", self.stats["engine_steps"])):
            return False
        # never share the block holding the last prompt token: at least
        # one token must run through prefill to give the first logits
        hashes = chain_hashes(prompt, self.block_size)
        got = self.pool.reserve(hashes[:(plen - 1) // self.block_size],
                                total)
        if got is None:
            return False
        shared, fresh = got
        blocks = shared + fresh
        self._tables[i, :] = 0
        self._tables[i, :len(blocks)] = blocks
        self._slots[i] = _Slot(rid=req.rid, pos=plen, remaining=budget,
                               temperature=req.temperature,
                               prompt=list(prompt),
                               filled=len(shared) * self.block_size,
                               blocks=blocks, seq=self._admit_seq,
                               full_prompt=list(req.prompt),
                               prior_out=list(entry.prior_out),
                               priority=req.priority,
                               deadline_at=entry.deadline_at)
        self._admit_seq += 1
        self.stats["resumes" if entry.is_resume else "admitted"] += 1
        self.stats["shared_blocks"] += len(shared)
        self.stats["blocks_hwm"] = max(self.stats["blocks_hwm"],
                                       self.pool.in_use())
        return True

    def _admit_swapped(self, i: int, entry: _QEntry) -> bool:
        """Resume a swapped-out request: allocate as many blocks as it
        held, restore their saved rows and re-enter decode at the position
        it left."""
        n = entry.swap["n"]
        forced = (self.faults is not None and self.faults.alloc_shortfall(
            "admit", self.stats["engine_steps"]))
        fresh = None if forced else self.pool.alloc(n)
        if fresh is None:
            return False
        self._swap_in(fresh, entry.swap["saved"])
        req = entry.req
        self._tables[i, :] = 0
        self._tables[i, :n] = fresh
        remaining = req.max_new - len(entry.prior_out) - len(entry.out)
        self._slots[i] = _Slot(rid=req.rid, pos=entry.pos,
                               remaining=remaining, out=list(entry.out),
                               temperature=req.temperature,
                               blocks=fresh, seq=self._admit_seq,
                               full_prompt=list(req.prompt),
                               prior_out=list(entry.prior_out),
                               priority=req.priority,
                               deadline_at=entry.deadline_at)
        self._admit_seq += 1
        self._last_tok[i, 0] = entry.out[-1]
        self.stats["swap_ins"] += 1
        self.stats["resumes"] += 1
        self.stats["blocks_hwm"] = max(self.stats["blocks_hwm"],
                                       self.pool.in_use())
        return True

    # ---- preemption ----

    def _swap_out(self, blocks: list[int]) -> list[dict]:
        """The blocks' rows of every layer's pools (K / V, or an MLA
        layer's latent and rope key), one gather a pool tensor, in host
        memory (pinned on a GPU)."""
        t0 = time.perf_counter()
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        saved = []
        for layer in self.caches:
            if "kv" not in layer:
                saved.append({})
                continue
            pair = {}
            for name, pool in layer["kv"].items():
                rows = pool.index_select(0, idx)
                if self.device.type == "cuda":
                    host = torch.empty(rows.shape, dtype=rows.dtype,
                                       pin_memory=True)
                    host.copy_(rows, non_blocking=True)
                    rows = host
                pair[name] = rows
                self.stats["swap_bytes"] += rows.numel() * rows.element_size()
            saved.append({"kv": pair})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["swap_s"] += time.perf_counter() - t0
        return saved

    def _swap_in(self, blocks: list[int], saved: list[dict]) -> None:
        t0 = time.perf_counter()
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        for layer, rows in zip(self.caches, saved):
            for name, pool in layer.get("kv", {}).items():
                pool.index_copy_(0, idx, rows["kv"][name].to(
                    self.device, non_blocking=True))
                self.stats["swap_bytes"] += (rows["kv"][name].numel()
                                             * pool.element_size())
        if self.device.type == "cuda":
            # the pinned rows must outlive their copies
            torch.cuda.synchronize(self.device)
        self.stats["swap_s"] += time.perf_counter() - t0

    def _pick_victim(self, i: int) -> int | None:
        """The slot to preempt so that slot ``i`` can grow: lowest
        priority first, then the youngest (or oldest) admission.  None
        when there is no other slot or every other outranks the grower."""
        s = self._slots[i]
        sign = -1 if self.preempt_policy == "youngest" else 1
        cands = [(c.priority, sign * c.seq, j)
                 for j, c in enumerate(self._slots)
                 if j != i and not c.free]
        if not cands:
            return None
        prio, _, j = min(cands)
        return None if prio > s.priority else j

    def _preempt(self, i: int) -> None:
        """Evict slot ``i`` to the queue head.  A decoding slot under
        preempt_mode='swap' keeps its K/V on the host and resumes in
        place; any other (and every mid-prefill slot) drops its blocks
        and resumes by prefilling prompt + generated tokens again."""
        s = self._slots[i]
        gen = s.prior_out + s.out
        req = Request(rid=s.rid, prompt=list(s.full_prompt),
                      max_new=len(gen) + max(s.remaining, 0),
                      temperature=s.temperature, priority=s.priority)
        if self.preempt_mode == "swap" and s.decoding:
            entry = _QEntry(req=req, deadline_at=s.deadline_at,
                            prior_out=list(s.prior_out), out=list(s.out),
                            pos=s.pos,
                            swap={"saved": self._swap_out(s.blocks),
                                  "n": len(s.blocks)})
            self.stats["swap_outs"] += 1
        else:
            base = s.prompt if s.prompt is not None else (
                s.full_prompt + s.prior_out)
            entry = _QEntry(req=req, deadline_at=s.deadline_at,
                            prior_out=s.prior_out + s.out,
                            resume_prompt=list(base) + list(s.out))
        for b in s.blocks:
            self.pool.decref(b)
        self._tables[i, :] = 0
        self._slots[i] = _Slot()
        self._queue.insert(0, entry)
        self.stats["preemptions"] += 1

    def _grow_decode_tables(self) -> None:
        """Every decoding slot's table must cover position ``pos`` before
        the tick writes there (out-of-table writes land in the sentinel
        block and would lose the token's K/V).  Oldest admission first,
        so the oldest grower always outranks its victims."""
        order = sorted((s.seq, i) for i, s in enumerate(self._slots)
                       if s.decoding)
        for seq, i in order:
            s = self._slots[i]
            if s.decoding and s.seq == seq:    # not preempted meanwhile
                self._grow_or_preempt(i)

    def _grow_or_preempt(self, i: int) -> bool:
        s = self._slots[i]
        while True:
            forced = (self.faults is not None and
                      self.faults.alloc_shortfall(
                          "grow", self.stats["engine_steps"]))
            fresh = (None if forced
                     else self.pool.ensure_reach(s.blocks, s.pos + 1))
            if fresh is not None:
                if fresh:
                    self._tables[i, :len(s.blocks)] = s.blocks
                    self.stats["blocks_hwm"] = max(
                        self.stats["blocks_hwm"], self.pool.in_use())
                return True
            v = self._pick_victim(i)
            if v is None:
                self._preempt(i)            # nobody cheaper to evict: yield
                return False
            self._preempt(v)

    def _validate_tables(self) -> None:
        """Every occupied slot's table row must mirror its host block list
        exactly; a mismatch retires the slot (reason 'corrupt') before any
        kernel reads the row, refunding the blocks of the host list."""
        for i, s in enumerate(self._slots):
            if s.free:
                continue
            want = np.zeros_like(self._tables[i])
            want[:len(s.blocks)] = s.blocks
            if not np.array_equal(self._tables[i], want):
                self.stats["corrupt"] += 1
                self._finish_slot(i, "corrupt")

    def _prefill_sentry(self, i: int, logits: torch.Tensor) -> bool:
        """Prefill completion of slot ``i``: the fault hook, then the
        numeric sentry.  A non-finite row retires the slot (reason
        'numeric') before its blocks are indexed; False then."""
        if self.faults is not None:
            logits = self.faults.prefill_logits(
                self.stats["engine_steps"], self._slots[i].rid, logits)
        if bool(torch.isfinite(logits).all()):
            return True
        self.stats["numeric"] += 1
        self._finish_slot(i, "numeric")
        return False

    def _first_token(self, i: int, logits: torch.Tensor) -> None:
        s = self._slots[i]
        tok = self._sample(logits[0], i, 0)
        s.out.append(tok)
        s.remaining -= 1
        self._last_tok[i, 0] = tok
        self._retire(i)

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
        if s.filled >= len(s.prompt) and self._prefill_sentry(i, logits):
            # the prompt's full blocks are written and immutable now
            n_full = len(s.prompt) // self.block_size
            self.pool.register(chain_hashes(s.prompt, self.block_size),
                               [int(b) for b in self._tables[i, :n_full]])
            s.prompt = None
            self.stats["prefills"] += 1
            self._first_token(i, logits)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["prefill_s"] += time.perf_counter() - t0

    def _finish_slot(self, i: int, reason: str) -> None:
        """Retire slot ``i`` with a reason: its tokens (earlier
        incarnations' included) are delivered and its blocks refunded."""
        s = self._slots[i]
        self.finished[s.rid] = s.prior_out + s.out
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
        if self.cache_mode == "paged":
            if self.faults is not None:
                self.faults.corrupt_tables(self.stats["engine_steps"],
                                           self._tables, self._slots)
            self._validate_tables()
        self._expire_running_deadlines()
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
        if self.faults is not None:
            logits = self.faults.decode_logits(
                self.stats["engine_steps"],
                [s.rid if s.decoding else -1 for s in self._slots], logits)
        self.stats["decode_steps"] += 1
        # the numeric sentry and the greedy tokens in one host pull: a
        # non-finite row retires only its own slot
        greedy, finite = torch.stack((
            torch.argmax(logits, dim=-1),
            torch.isfinite(logits).all(dim=-1).long())).tolist()
        for i, s in enumerate(self._slots):
            if not s.decoding:
                continue
            if not finite[i]:
                self.stats["numeric"] += 1
                self._finish_slot(i, "numeric")
                continue
            tok = (self._sample(logits[i], i, 1) if s.temperature > 0.0
                   else greedy[i])
            s.out.append(tok)
            s.pos += 1
            s.remaining -= 1
            self._last_tok[i, 0] = tok
            self._retire(i)
        self.stats["decode_s"] += time.perf_counter() - t0

    def run(self, requests: list[Request], max_steps: int = 10_000
            ) -> dict[int, list[int]]:
        """Submit ``requests`` and step until nothing is pending.  When
        ``max_steps`` run out first, every live or queued request finishes
        with reason 'starved' (its partial output delivered, its blocks
        refunded) and its rid goes to stats['starved']."""
        for r in requests:
            self.submit(r)
        steps = 0
        while self.pending() and steps < max_steps:
            self.step()
            steps += 1
        if self.pending():
            starved = []
            for i, s in enumerate(self._slots):
                if not s.free:
                    starved.append(s.rid)
                    self._finish_slot(i, "starved")
            while self._queue:
                e = self._queue.pop(0)
                starved.append(e.req.rid)
                self._finish_queued(e, "starved")
            self.stats["starved"].extend(starved)
        return dict(self.finished)
