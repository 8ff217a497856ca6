"""Deterministic fault injection for the port's serve engine:
``python -m repro_torch.serve.faults --soak | --fixture NAME [--device
cpu]`` (counterpart of ``repro.serve.faults``).

Every failure mode the engine claims to contain has a seeded injector
here, and each fixture proves that its containment still fires by the
exit code it returns:

  exit 0   --soak: the chaos soak's invariants held
  exit 1   --fixture: the seeded fault was detected and contained
  exit 2   --fixture: the fault ran but the engine did NOT contain it
           (a sentry or the validator has gone blind)

The injector is host-side state that the engine's hooks consult, drawing
only from its seeded ``random.Random``:

  alloc_shortfall(where, step)   force a pool shortfall at admission
                                 ('admit') or at decode growth ('grow');
                                 a scheduled hit fires ONCE, so the
                                 engine's preempt-and-retry loop then
                                 sees the real pool and cannot livelock
  decode_logits(step, rids, x)   poison one decoding row with NaN
  prefill_logits(step, rid, x)   poison a prefill-completion row
  corrupt_tables(step, t, slots) scribble an out-of-range block id into
                                 an occupied slot's table row

``affected`` collects the rids whose output the faults changed; the
soak holds every other request to the fault-free run's tokens.

The chaos soak runs one seeded workload twice -- fault-free, then with
every injector armed and the pool at ``pool_frac`` of the worst-case
block demand -- and checks: nothing starved, ``pool.in_use() == 0``
after the drain, every request finished with a reason, and every
unaffected request's tokens equal to the fault-free run's (preempted and
resumed requests included: preemption must not show in the tokens).
"""
from __future__ import annotations

import argparse
import random
import sys

import torch

FIXTURES = ("nan_logits", "pool_exhaustion", "preempt_storm",
            "table_corrupt", "oversize_prompt")


class FaultInjector:
    """Seeded, scheduled fault source consulted by engine hooks."""

    def __init__(self, seed: int = 0, *,
                 shortfall_admit_steps=(), shortfall_grow_steps=(),
                 storm_rate: float = 0.0, storm_until: int = 0,
                 nan_decode_step: int | None = None,
                 nan_prefill_step: int | None = None,
                 corrupt_step: int | None = None):
        self._rng = random.Random(seed)
        self._admit_steps = set(shortfall_admit_steps)
        self._grow_steps = set(shortfall_grow_steps)
        self.storm_rate = storm_rate
        self.storm_until = storm_until
        self._storm_fired: set[int] = set()
        self.nan_decode_step = nan_decode_step
        self.nan_prefill_step = nan_prefill_step
        self.corrupt_step = corrupt_step
        self.affected: set[int] = set()   # rids whose OUTPUT faults changed
        self.log: list[tuple] = []

    # ---- engine hooks ----

    def alloc_shortfall(self, where: str, step: int) -> bool:
        """Force the pool to report a shortfall.  A scheduled step fires
        once and is consumed: the engine retries after preempting a
        victim, and the retry must see the real pool.  The storm fires at
        most once an engine step (a seeded coin) up to ``storm_until``:
        each hit forces one preemption, which changes no request's final
        tokens, so storm targets are not marked affected."""
        sched = self._admit_steps if where == "admit" else self._grow_steps
        if step in sched:
            sched.discard(step)
            self.log.append(("shortfall", where, step))
            return True
        if (where == "grow" and step <= self.storm_until
                and step not in self._storm_fired
                and self._rng.random() < self.storm_rate):
            self._storm_fired.add(step)
            self.log.append(("storm", where, step))
            return True
        return False

    def decode_logits(self, step: int, rids: list[int],
                      logits: torch.Tensor) -> torch.Tensor:
        """NaN-poison the first decoding row at ``nan_decode_step`` (or
        the first tick after it with a decoding row).  One-shot."""
        if self.nan_decode_step is None or step < self.nan_decode_step:
            return logits
        rows = [i for i, r in enumerate(rids) if r >= 0]
        if not rows:
            return logits
        self.nan_decode_step = None
        i = rows[0]
        self.affected.add(rids[i])
        self.log.append(("nan_decode", step, rids[i]))
        logits = logits.clone()
        logits[i] = float("nan")
        return logits

    def prefill_logits(self, step: int, rid: int,
                       logits: torch.Tensor) -> torch.Tensor:
        if self.nan_prefill_step is None or step < self.nan_prefill_step:
            return logits
        self.nan_prefill_step = None
        self.affected.add(rid)
        self.log.append(("nan_prefill", step, rid))
        return torch.full_like(logits, float("nan"))

    def corrupt_tables(self, step: int, tables, slots) -> None:
        """Scribble an impossible block id into the first occupied slot's
        host table row, before the engine validates it.  One-shot."""
        if self.corrupt_step is None or step < self.corrupt_step:
            return
        for i, s in enumerate(slots):
            if not s.free:
                self.corrupt_step = None
                tables[i, 0] = 2 ** 20
                self.affected.add(s.rid)
                self.log.append(("corrupt", step, s.rid))
                return


# ---------------------------------------------------------------------------
# workload + soak
# ---------------------------------------------------------------------------


def _workload(seed: int, n_requests: int, max_seq: int, vocab: int):
    """Seeded mixed workload: ragged lengths, a shared prefix family
    (exercises prefix-cache refcounts under preemption), varied
    max_new."""
    rng = random.Random(seed)
    from .engine import Request
    base = [rng.randrange(1, vocab) for _ in range(max_seq)]
    reqs = []
    for i in range(n_requests):
        if rng.random() < 0.35:         # prefix family
            plen = rng.randrange(10, min(34, max_seq - 12))
            prompt = base[:plen]
        else:
            plen = rng.randrange(4, min(40, max_seq - 12))
            prompt = [rng.randrange(1, vocab) for _ in range(plen)]
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new=rng.randrange(4, 11)))
    return reqs


def _mk_engine(cfg, params, *, seed, num_blocks, device, faults=None,
               n_slots=3, max_seq=64, preempt_mode="recompute"):
    from .engine import ServeEngine
    return ServeEngine(cfg, params, n_slots=n_slots, max_seq=max_seq,
                       cache_mode="paged", prefill_chunk=16, seed=seed,
                       num_blocks=num_blocks, admission="reactive",
                       preempt_mode=preempt_mode, faults=faults,
                       device=device)


def _setup(seed: int, n_requests: int = 10, max_seq: int = 64,
           pool_frac: float = 0.5, n_slots: int = 3, device=None,
           model=None):
    """(cfg, params, requests, num_blocks).  ``model`` is a (cfg, params)
    pair to serve; by default reduced qwen1.5-0.5b with weights drawn
    from ``seed``."""
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.kernels import tiling
    from repro_torch.models.transformer import init_lm

    dev = resolve_device(device)
    if model is None:
        cfg = registry.reduced_config("qwen1.5-0.5b")
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    else:
        cfg, params = model
    reqs = _workload(seed, n_requests, max_seq, cfg.vocab)
    bs = tiling.paged_block_size(max_seq)
    worst = max(tiling.cdiv(min(len(r.prompt) + r.max_new, max_seq), bs)
                for r in reqs)
    # pool_frac of the worst-case demand of a full slot complement,
    # floored so a single request always fits (the submit guard)
    num_blocks = max(worst, int(pool_frac * n_slots * worst)) + 1
    return cfg, params, reqs, num_blocks


def chaos_soak(seed: int = 0, *, pool_frac: float = 0.5,
               n_requests: int = 10, n_slots: int = 3, max_seq: int = 64,
               preempt_mode: str = "recompute", max_steps: int = 4000,
               device=None, model=None) -> dict:
    """Fault-free run, then the same workload with every injector armed.
    Returns a report dict with ``ok`` and the violated invariants."""
    cfg, params, reqs, num_blocks = _setup(
        seed, n_requests=n_requests, max_seq=max_seq,
        pool_frac=pool_frac, n_slots=n_slots, device=device, model=model)
    kw = dict(seed=seed, num_blocks=num_blocks, n_slots=n_slots,
              max_seq=max_seq, preempt_mode=preempt_mode, device=device)
    base = _mk_engine(cfg, params, **kw)
    base_out = base.run(list(reqs), max_steps=max_steps)

    inj = FaultInjector(seed, storm_rate=0.5, storm_until=25,
                        shortfall_admit_steps=(3, 7),
                        nan_decode_step=12, corrupt_step=20)
    eng = _mk_engine(cfg, params, faults=inj, **kw)
    from .engine import Request
    oversize_rejected = False
    try:
        eng.submit(Request(rid=10 ** 6,
                           prompt=list(range(1, max_seq + 2)), max_new=1))
    except ValueError:
        oversize_rejected = True
    out = eng.run(list(reqs), max_steps=max_steps)

    violations = []
    if not oversize_rejected:
        violations.append("oversized prompt was admitted")
    if eng.stats["starved"] or base.stats["starved"]:
        violations.append(f"deadlock/starvation: {eng.stats['starved']} "
                          f"(baseline {base.stats['starved']})")
    for e, tag in ((base, "baseline"), (eng, "armed")):
        if e.pool.in_use() != 0:
            violations.append(f"{tag}: {e.pool.in_use()} blocks leaked")
    for r in reqs:
        if r.rid not in out or r.rid not in eng.reasons:
            violations.append(f"rid {r.rid} never terminated with a reason")
    for r in reqs:
        if r.rid in inj.affected:
            continue
        if out.get(r.rid) != base_out.get(r.rid):
            violations.append(
                f"rid {r.rid} unaffected by faults but tokens diverged: "
                f"{out.get(r.rid)} != {base_out.get(r.rid)}")
    return {"ok": not violations, "violations": violations,
            "stats": {k: v for k, v in eng.stats.items()
                      if not k.endswith("_s")},
            "affected": sorted(inj.affected),
            "reasons": dict(eng.reasons),
            "injections": len(inj.log)}


# ---------------------------------------------------------------------------
# fixtures: each proves one containment path still fires
# ---------------------------------------------------------------------------


def _fixture_nan_logits(seed: int, device):
    """NaN decode logits at step k must quarantine exactly one slot
    (reason 'numeric') while its neighbours' tokens stay bitwise equal
    to the fault-free run."""
    cfg, params, reqs, _ = _setup(seed, n_requests=4, device=device)
    base_out = _mk_engine(cfg, params, seed=seed, num_blocks=None,
                          device=device).run(list(reqs))
    inj = FaultInjector(seed, nan_decode_step=6)
    eng = _mk_engine(cfg, params, seed=seed, num_blocks=None, faults=inj,
                     device=device)
    out = eng.run(list(reqs))
    quarantined = [r for r, why in eng.reasons.items() if why == "numeric"]
    ok = (len(quarantined) == 1 and quarantined[0] in inj.affected
          and eng.pool.in_use() == 0
          and all(out[r.rid] == base_out[r.rid] for r in reqs
                  if r.rid not in inj.affected))
    return ok, {"quarantined": quarantined, "affected": sorted(inj.affected),
                "numeric": eng.stats["numeric"]}


def _fixture_pool_exhaustion(seed: int, device):
    """A pool that only fits one worst-case request at a time must block
    admission (backpressure, counted) yet drain every request with a
    reason and zero leaked blocks."""
    cfg, params, reqs, _ = _setup(seed, n_requests=6, device=device)
    from repro_torch.kernels import tiling
    bs = tiling.paged_block_size(64)
    worst = max(tiling.cdiv(min(len(r.prompt) + r.max_new, 64), bs)
                for r in reqs)
    eng = _mk_engine(cfg, params, seed=seed, num_blocks=worst + 1,
                     device=device)
    out = eng.run(list(reqs))
    ok = (eng.stats["admit_blocked"] > 0 and eng.pool.in_use() == 0
          and all(r.rid in out and r.rid in eng.reasons for r in reqs)
          and not eng.stats["starved"])
    return ok, {"admit_blocked": eng.stats["admit_blocked"],
                "reasons": dict(eng.reasons)}


def _fixture_preempt_storm(seed: int, device):
    """Every decode growth forced short for the first 15 steps: the
    engine must preempt and resume again and again, and the storm must
    not show in the tokens (greedy recompute is exact)."""
    cfg, params, reqs, _ = _setup(seed, n_requests=5, device=device)
    base_out = _mk_engine(cfg, params, seed=seed, num_blocks=None,
                          device=device).run(list(reqs))
    inj = FaultInjector(seed, storm_rate=1.0, storm_until=15)
    eng = _mk_engine(cfg, params, seed=seed, num_blocks=None, faults=inj,
                     device=device)
    out = eng.run(list(reqs))
    ok = (eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0
          and eng.pool.in_use() == 0 and out == base_out)
    return ok, {"preemptions": eng.stats["preemptions"],
                "resumes": eng.stats["resumes"],
                "match": out == base_out}


def _fixture_table_corrupt(seed: int, device):
    """An out-of-range block id scribbled into a live table row must be
    caught by the per-step validator before any kernel reads it."""
    cfg, params, reqs, _ = _setup(seed, n_requests=4, device=device)
    inj = FaultInjector(seed, corrupt_step=8)
    eng = _mk_engine(cfg, params, seed=seed, num_blocks=None, faults=inj,
                     device=device)
    out = eng.run(list(reqs))
    corrupted = [r for r, why in eng.reasons.items() if why == "corrupt"]
    ok = (len(corrupted) == 1 and corrupted[0] in inj.affected
          and eng.stats["corrupt"] == 1 and eng.pool.in_use() == 0
          and all(r.rid in out for r in reqs))
    return ok, {"corrupted": corrupted, "affected": sorted(inj.affected)}


def _fixture_oversize_prompt(seed: int, device):
    """A prompt past max_seq (and one past the pool's worst-case reach)
    must be rejected at submit, leaving the engine state untouched."""
    cfg, params, reqs, num_blocks = _setup(seed, n_requests=2,
                                           device=device)
    from .engine import Request
    eng = _mk_engine(cfg, params, seed=seed, num_blocks=num_blocks,
                     device=device)
    rejected = 0
    try:                               # past max_seq
        eng.submit(Request(rid=100, prompt=list(range(1, 66)), max_new=1))
    except ValueError:
        rejected += 1
    # within max_seq but past a small pool's worst-case reach
    small = _mk_engine(cfg, params, seed=seed, num_blocks=3, device=device)
    try:
        small.submit(Request(rid=101, prompt=list(range(1, 11)),
                             max_new=30))
    except ValueError:
        rejected += 1
    out = eng.run(list(reqs))
    ok = (rejected == 2 and 100 not in out and 101 not in out
          and all(r.rid in out for r in reqs)
          and eng.pool.in_use() == 0)
    return ok, {"rejected": rejected}


_FIXTURE_RUNNERS = {
    "nan_logits": _fixture_nan_logits,
    "pool_exhaustion": _fixture_pool_exhaustion,
    "preempt_storm": _fixture_preempt_storm,
    "table_corrupt": _fixture_table_corrupt,
    "oversize_prompt": _fixture_oversize_prompt,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.faults",
        description="deterministic fault injection for the port's serve "
                    "engine (chaos soak + seeded containment fixtures)")
    ap.add_argument("--soak", action="store_true",
                    help="run the chaos soak; exit 0 iff invariants held")
    ap.add_argument("--fixture", choices=FIXTURES,
                    help="run one seeded fault; exit 1 iff contained as "
                         "documented, 2 if the engine has gone blind")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool-frac", type=float, default=0.5)
    ap.add_argument("--preempt-mode", default="recompute",
                    choices=("recompute", "swap"))
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if not args.soak and not args.fixture:
        ap.error("pick --soak or --fixture NAME")

    if args.soak:
        report = chaos_soak(args.seed, pool_frac=args.pool_frac,
                            preempt_mode=args.preempt_mode,
                            device=args.device)
        print(f"chaos soak: {'OK' if report['ok'] else 'FAIL'} -- "
              f"{report['injections']} injections, "
              f"affected rids {report['affected']}, "
              f"stats {report['stats']}")
        for v in report["violations"]:
            print(f"  VIOLATION: {v}", file=sys.stderr)
        return 0 if report["ok"] else 1

    ok, detail = _FIXTURE_RUNNERS[args.fixture](args.seed, args.device)
    if ok:
        print(f"fixture {args.fixture!r} contained as intended: {detail}")
        return 1
    print(f"fixture {args.fixture!r} NOT contained -- the engine has "
          f"gone blind: {detail}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
