"""Serving under pressure in the port against the JAX engine: reactive
admission and preemption (recompute and swap), priorities, head-of-line
skip-ahead, deadlines, the numeric sentry, starvation, table corruption,
the chaos soak and its fixtures, and the admission-rollback property.

Reduced qwen1.5-0.5b on the CPU, the same weights in both packages
(``models/convert.py``), the reference's own workloads
(tests/test_serve_pressure.py).  Every greedy stream is held token for
token to the JAX engine's on the same requests and engine settings, and
the pressure counters (preemptions, resumes, swaps, skips) to its
counters: the two engines make the same scheduling decisions.  Each JAX
run is made once and shared (``jax_run``).
"""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import registry as J_registry
from repro.models.transformer import init_lm as j_init_lm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve.faults import FaultInjector as JFaultInjector
from repro_torch.configs import registry as T_registry
from repro_torch.kernels import tiling
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BlockPool, Request, ServeEngine, chain_hashes
from repro_torch.serve.engine import _QEntry
from repro_torch.serve.faults import FIXTURES, FaultInjector, chaos_soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's _mk_reqs
REQS = [dict(rid=0, prompt=list(range(5, 25)), max_new=6),
        dict(rid=1, prompt=list(range(7, 40)), max_new=8),
        dict(rid=2, prompt=[3, 1, 4, 1, 5, 9, 2, 6], max_new=5),
        dict(rid=3, prompt=list(range(5, 25)), max_new=4)]
PRIORITY_REQS = [dict(REQS[0], priority=1)] + REQS[1:]
PRESSURE_COUNTERS = ("preemptions", "resumes", "swap_outs", "swap_ins",
                     "hol_skips", "numeric", "corrupt", "deadlines")


def _reqs(cls, spec):
    return [cls(**dict(d, prompt=list(d["prompt"]))) for d in spec]


@pytest.fixture(scope="module")
def model():
    jcfg = J_registry.reduced_config("qwen1.5-0.5b")
    tcfg = T_registry.reduced_config("qwen1.5-0.5b")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _kw(kw):
    kw = dict(kw)
    for k, v in (("n_slots", 3), ("max_seq", 64), ("prefill_chunk", 16),
                 ("seed", 0)):
        kw.setdefault(k, v)
    return kw


def _paged(model, **kw):
    """The port's engine with the reference test's defaults."""
    return ServeEngine(model[2], model[3], cache_mode="paged", device="cpu",
                       **_kw(kw))


@pytest.fixture(scope="module")
def jax_run(model):
    """jax_run(name, spec, max_steps=..., **engine kw) -> the JAX engine
    after running ``spec``, made once per name."""
    done = {}

    def run(name, spec, max_steps=10_000, **kw):
        if name not in done:
            eng = JEngine(model[0], model[1], cache_mode="paged", **_kw(kw))
            eng.run(_reqs(JRequest, spec), max_steps=max_steps)
            done[name] = eng
        return done[name]
    return run


def _same_schedule(te, je):
    assert te.finished == je.finished
    assert te.reasons == je.reasons
    for k in PRESSURE_COUNTERS:
        assert te.stats[k] == je.stats[k], k
    assert te.stats["starved"] == je.stats["starved"]


# ---------------- preemption parity ----------------

@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_tight_pool_preempts_and_matches_ample(model, jax_run, mode):
    """A pool well under the worst-case demand preempts (the ample pool
    never does) and still gives the ample run's tokens, as the JAX
    engine does with the same decisions; every request finishes with a
    reason and nothing leaks."""
    ample = _paged(model)
    out_a = ample.run(_reqs(Request, REQS))
    assert ample.stats["preemptions"] == 0
    assert out_a == jax_run("ample", REQS).finished
    tight = _paged(model, num_blocks=9, preempt_mode=mode)
    out_t = tight.run(_reqs(Request, REQS))
    _same_schedule(tight, jax_run(f"tight_{mode}", REQS, num_blocks=9,
                                  preempt_mode=mode))
    assert out_t == out_a
    assert tight.stats["preemptions"] > 0 and tight.stats["resumes"] > 0
    assert tight.pool.in_use() == 0
    assert all(tight.reasons[d["rid"]] for d in REQS)
    assert not tight.stats["starved"]


def test_swap_preemption_matches_recompute(model, jax_run):
    """preempt_mode='swap' restores the saved block rows instead of
    prefilling again: the same tokens, the swap counters move, nothing
    leaks."""
    base = _paged(model, num_blocks=9).run(_reqs(Request, REQS))
    sw = _paged(model, num_blocks=9, preempt_mode="swap")
    out = sw.run(_reqs(Request, REQS))
    assert out == base == jax_run("tight_swap", REQS, num_blocks=9,
                                  preempt_mode="swap").finished
    assert sw.stats["preemptions"] > 0
    assert sw.stats["swap_outs"] > 0 and sw.stats["swap_ins"] > 0
    assert sw.stats["swap_bytes"] > 0
    assert sw.pool.in_use() == 0


def test_reactive_beats_worst_case_concurrency(model, jax_run):
    """At the same undersized pool, reactive admission reaches a higher
    concurrency than worst-case reservation, with the same tokens.  Each
    request's worst-case reach is 6 blocks (16 prompt + 30 new, bs 8):
    the 8-block pool holds one worst-case reservation but all three
    2-block prompt reaches."""
    spec = [dict(rid=i, prompt=[100 * i + j + 1 for j in range(16)],
                 max_new=30) for i in range(3)]
    bs = tiling.paged_block_size(64)
    assert all(tiling.cdiv(16 + 30, bs) == 6 for _ in spec)
    hwm, outs = {}, {}
    for adm in ("worst_case", "reactive"):
        eng = _paged(model, num_blocks=9, admission=adm)
        for r in _reqs(Request, spec):
            eng.submit(r)
        h = 0
        while eng.pending():
            eng.step()
            h = max(h, eng.active)
        hwm[adm], outs[adm] = h, dict(eng.finished)
        assert eng.pool.in_use() == 0, adm
        if adm == "reactive":
            _same_schedule(eng, jax_run("reactive_hwm", spec, num_blocks=9))
    assert outs["reactive"] == outs["worst_case"]
    assert hwm["reactive"] > hwm["worst_case"], hwm


def test_priority_protects_high_priority_victim(model, jax_run):
    """Victims are chosen lowest priority first, and a grower never
    evicts a slot of higher priority (it yields instead): the JAX
    engine's decisions, and the ample run's tokens."""
    eng = _paged(model, num_blocks=9)
    out = eng.run(_reqs(Request, PRIORITY_REQS))
    assert eng.stats["preemptions"] > 0
    _same_schedule(eng, jax_run("priority", PRIORITY_REQS, num_blocks=9))
    assert out == _paged(model).run(_reqs(Request, PRIORITY_REQS))
    assert eng.pool.in_use() == 0


def test_pick_victim_yields_to_higher_priority(model):
    """_pick_victim: lowest priority, then the youngest (or oldest)
    admission; None when every other slot outranks the grower."""
    for policy, want in (("youngest", 2), ("oldest", 1)):
        eng = _paged(model, preempt_policy=policy)
        eng.run([Request(rid=9, prompt=[1, 2], max_new=1)])
        for j, (prio, seq) in enumerate(((1, 0), (0, 1), (0, 2))):
            eng._slots[j].rid, eng._slots[j].priority = j, prio
            eng._slots[j].seq = seq
        assert eng._pick_victim(0) == want
        assert eng._pick_victim(1) == 2   # the lower priority goes first
        eng._slots[1].priority = eng._slots[2].priority = 5
        assert eng._pick_victim(0) is None


# ---------------- starvation surfaced ----------------

def test_starvation_is_surfaced_not_silent(model, jax_run):
    """When max_steps run out, everything still live or queued finishes
    with reason 'starved', its partial output delivered, every block
    refunded, its rid in stats['starved']."""
    eng = _paged(model)
    out = eng.run(_reqs(Request, REQS), max_steps=3)
    assert eng.stats["starved"]
    _same_schedule(eng, jax_run("starved", REQS, max_steps=3))
    for d in REQS:
        assert d["rid"] in out and d["rid"] in eng.reasons
    assert all(eng.reasons[rid] == "starved"
               for rid in eng.stats["starved"])
    assert eng.pool.in_use() == 0 and eng.pending() == 0


# ---------------- head-of-line skip-ahead ----------------

def _hol_script(eng, req_cls):
    eng.submit(req_cls(rid=0, prompt=list(range(1, 31)), max_new=4))
    while not any(s.decoding for s in eng._slots):
        eng.step()                        # rid 0 holds 4 of 7 blocks
    # disjoint from rid 0's prompt: a shared prefix would collapse the
    # large request's fresh-block demand below the pool
    eng.submit(req_cls(rid=1, prompt=list(range(100, 140)), max_new=4))
    eng.submit(req_cls(rid=2, prompt=[9, 8, 7], max_new=3))
    eng.step()
    skips = eng.stats["hol_skips"]
    slots = [s.rid for s in eng._slots]
    return skips, slots, eng.run([])


@pytest.mark.parametrize("window", [4, 1])
def test_hol_skip_ahead_and_strict_fcfs(model, window):
    """hol_window 4: a small request admits past a pool-blocked large
    one (stats['hol_skips']), which still completes once blocks free
    up.  hol_window 1: strict FCFS, no skip.  The JAX engine makes the
    same moves."""
    kw = dict(n_slots=2, num_blocks=8, hol_window=window)
    te = _paged(model, **kw)
    je = JEngine(model[0], model[1], cache_mode="paged", **_kw(kw))
    got = _hol_script(te, Request)
    assert got == _hol_script(je, JRequest)
    skips, slots, out = got
    if window == 1:
        assert skips == 0 and 2 not in slots
    else:
        assert skips >= 1 and 2 in slots  # rid 2 skipped past rid 1
    assert sorted(out) == [0, 1, 2]       # the large one is not starved
    assert all(len(out[r]) == n for r, n in ((0, 4), (1, 4), (2, 3)))
    assert te.pool.in_use() == 0


# ---------------- deadlines ----------------

def _deadline_script(eng, req_cls, clk):
    eng.submit(req_cls(rid=0, prompt=[1, 2, 3], max_new=50,
                       deadline_s=5.0))
    eng.submit(req_cls(rid=1, prompt=[4, 5, 6], max_new=4))
    for _ in range(6):
        eng.step()
    decoded = len(eng._slots[0].out)
    clk["t"] = 10.0                       # past rid 0's budget
    eng.submit(req_cls(rid=2, prompt=[7, 8], max_new=5, deadline_s=-1.0))
    eng.step()
    return decoded, eng.run([])


def test_deadline_expires_queued_and_running(model):
    """On an injected clock: a running request past its budget retires
    with its partial output, a queued one with none, the others are
    untouched; as in the JAX engine."""
    t_clk, j_clk = {"t": 0.0}, {"t": 0.0}
    te = _paged(model, n_slots=2, clock=lambda: t_clk["t"])
    je = JEngine(model[0], model[1], cache_mode="paged",
                 **_kw(dict(n_slots=2, clock=lambda: j_clk["t"])))
    decoded, out = _deadline_script(te, Request, t_clk)
    assert (decoded, out) == _deadline_script(je, JRequest, j_clk)
    _same_schedule(te, je)
    assert decoded > 0                    # rid 0 was decoding
    assert te.reasons[0] == "deadline" and 0 < len(out[0]) < 50
    assert te.reasons[2] == "deadline" and out[2] == []
    assert te.reasons[1] in ("max_new", "eos") and len(out[1]) <= 4
    assert te.pool.in_use() == 0 and te.stats["deadlines"] == 2


# ---------------- numeric sentry + table corruption ----------------

def test_numeric_sentry_quarantines_single_slot(model, jax_run):
    """NaN logits on one decode row retire only that slot (reason
    'numeric', blocks refunded); every other request's tokens equal the
    fault-free run's, and the JAX engine quarantines the same one."""
    base = _paged(model).run(_reqs(Request, REQS))
    inj = FaultInjector(0, nan_decode_step=6)
    eng = _paged(model, faults=inj)
    out = eng.run(_reqs(Request, REQS))
    bad = [r for r, why in eng.reasons.items() if why == "numeric"]
    assert bad == sorted(inj.affected) and len(bad) == 1
    assert eng.stats["numeric"] == 1
    for d in REQS:
        if d["rid"] not in inj.affected:
            assert out[d["rid"]] == base[d["rid"]], d["rid"]
    assert eng.pool.in_use() == 0
    _same_schedule(eng, jax_run("nan", REQS,
                                faults=JFaultInjector(0, nan_decode_step=6)))


def test_numeric_sentry_at_prefill_completion(model, jax_run):
    """A non-finite prefill-completion row retires its slot before its
    blocks are indexed for sharing; the others run on."""
    inj = FaultInjector(0, nan_prefill_step=1)
    eng = _paged(model, faults=inj)
    out = eng.run(_reqs(Request, REQS))
    assert [r for r, why in eng.reasons.items() if why == "numeric"] == [0]
    assert out[0] == [] and sorted(out) == [0, 1, 2, 3]
    # rid 3 shares rid 0's prompt: nothing of rid 0's was indexed, so it
    # prefilled its own blocks
    assert eng.stats["shared_blocks"] == 0
    assert eng.pool.in_use() == 0
    _same_schedule(eng, jax_run(
        "nan_prefill", REQS, faults=JFaultInjector(0, nan_prefill_step=1)))


def test_sampled_quarantine_leaves_neighbours_bitwise(model):
    """At temperature > 0 each slot draws from its own generator keyed
    by (seed, engine step, slot index): a NaN in one slot leaves the
    other slots' sampled tokens bitwise unchanged."""
    spec = [dict(rid=i, prompt=[10 * i + j + 1 for j in range(6)],
                 max_new=10, temperature=0.8) for i in range(3)]
    base_eng = _paged(model)
    base = base_eng.run(_reqs(Request, spec))
    greedy = _paged(model).run(
        _reqs(Request, [dict(d, temperature=0.0) for d in spec]))
    assert base != greedy                 # the draws are real
    assert base == _paged(model).run(_reqs(Request, spec))   # seeded
    inj = FaultInjector(0, nan_decode_step=base_eng.stats["engine_steps"]
                        // 2)
    eng = _paged(model, faults=inj)
    out = eng.run(_reqs(Request, spec))
    assert len(inj.affected) == 1
    (hit,) = inj.affected
    assert eng.reasons[hit] == "numeric"
    assert len(out[hit]) < len(base[hit])
    for d in spec:
        if d["rid"] != hit:
            assert out[d["rid"]] == base[d["rid"]], d["rid"]


def test_table_corruption_detected_and_contained(model, jax_run):
    """An impossible block id in a live table row retires exactly that
    request (reason 'corrupt') before a kernel reads it."""
    inj = FaultInjector(0, corrupt_step=4)
    eng = _paged(model, faults=inj)
    out = eng.run(_reqs(Request, REQS))
    bad = [r for r, why in eng.reasons.items() if why == "corrupt"]
    assert bad == sorted(inj.affected) and len(bad) == 1
    assert eng.stats["corrupt"] == 1
    assert sorted(out) == [0, 1, 2, 3]
    assert eng.pool.in_use() == 0
    _same_schedule(eng, jax_run("corrupt", REQS,
                                faults=JFaultInjector(0, corrupt_step=4)))


# ---------------- the BENCH_serve.json pressure shape ----------------

@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_bench_serve_pressure_shape(model, jax_run, mode):
    """The pressure rows of BENCH_serve.json (benchmarks/bench_kernels.py,
    written out here; the file is not read): max_seq 256 (blocks of 16),
    prefill_chunk 32, 4 slots, 8 requests of 2-block prompts and 64 new
    tokens each (a 6-block worst-case reach), on a pool of 12 blocks
    and the sentinel -- half the worst-case demand of 24.  The prompts
    are disjoint, as there; their ids are 1 + 32 i + j, inside the
    reduced vocabulary (the benchmark's 1000 i + j + 1 lie past it, where
    JAX clamps the embedding gather and torch raises).  Reactive
    admission preempts and matches the JAX engine's decisions and
    tokens; worst-case admission never preempts and gives the same
    tokens."""
    bs = tiling.paged_block_size(256)
    spec = [dict(rid=i, prompt=[2 * bs * i + j + 1 for j in range(2 * bs)],
                 max_new=4 * bs) for i in range(8)]
    kw = dict(n_slots=4, max_seq=256, prefill_chunk=32, num_blocks=13)
    eng = _paged(model, preempt_mode=mode, **kw)
    out = eng.run(_reqs(Request, spec))
    _same_schedule(eng, jax_run(f"bench_{mode}", spec, preempt_mode=mode,
                                **kw))
    assert eng.stats["preemptions"] > 0 and eng.pool.in_use() == 0
    assert all(len(v) == 4 * bs for v in out.values())
    worst = _paged(model, admission="worst_case", **kw)
    assert worst.run(_reqs(Request, spec)) == out
    assert worst.stats["preemptions"] == 0


# ---------------- chaos soak and the fault CLI ----------------

@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_chaos_soak_invariants(mode):
    report = chaos_soak(seed=0, preempt_mode=mode, device="cpu")
    assert report["ok"], report["violations"]
    assert report["stats"]["preemptions"] > 0     # the pressure was real
    assert report["injections"] > 0
    if mode == "swap":
        assert report["stats"]["swap_outs"] > 0


@pytest.mark.parametrize("args,code", [
    pytest.param(["--soak"], 0, id="soak")] + [
    pytest.param(["--fixture", name], 1, id=name) for name in FIXTURES])
def test_faults_cli_exit_codes(args, code):
    """python -m repro_torch.serve.faults: 0 when the soak holds, 1 when
    a fixture's fault was contained (2 would mean it was not)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.faults", *args,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == code, run.stdout + run.stderr


def test_serve_cli_preempts_on_a_small_pool(monkeypatch, capsys):
    from repro_torch.launch import serve as cli
    for mode in ("recompute", "swap"):
        monkeypatch.setattr(sys, "argv", [
            "serve", "--reduced", "--device", "cpu", "--max-seq", "64",
            "--requests", "6", "--max-new", "12", "--num-blocks", "7",
            "--preempt-mode", mode, "--hol-window", "2"])
        cli.main()
        out = capsys.readouterr().out
        assert "6 requests, 72 tokens" in out
        assert int(re.search(r"'preemptions': (\d+)", out).group(1)) > 0
        assert "'starved': []" in out


# ---------------- admission rollback ----------------

def _snapshot(pool: BlockPool):
    """Full observable pool state, LRU order included."""
    return (dict(pool._ref), list(pool._free), list(pool._cached),
            dict(pool._hash_to_block), dict(pool._block_hash))


@pytest.mark.parametrize("seed", range(100))
def test_reserve_shortfall_leaves_pool_byte_identical(seed):
    """A failed reserve() (the admission shortfall path) leaves the pool
    byte-identical: refcounts, free list, cached-LRU order and both
    prefix indexes."""
    rng = np.random.RandomState(seed)
    pool = BlockPool(num_blocks=int(rng.randint(4, 13)), block_size=4)
    registered = []
    for _ in range(rng.randint(0, 4)):
        n = int(rng.randint(1, 4))
        blocks = pool.alloc(n)
        if blocks is None:
            break
        toks = rng.randint(0, 1000, size=4 * n).tolist()
        pool.register(chain_hashes(toks, 4), blocks)
        registered.append(toks)
        if rng.rand() < 0.6:
            for b in blocks:
                pool.decref(b)            # park in the cached LRU
    if pool.available() > 1:
        pool.alloc(int(rng.randint(0, pool.available())))   # hog
    snap = _snapshot(pool)
    if registered and rng.rand() < 0.7:
        prompt = (registered[rng.randint(len(registered))]
                  + [int(rng.randint(1000))])
    else:
        prompt = rng.randint(0, 1000, size=rng.randint(1, 10)).tolist()
    hashes = chain_hashes(prompt, 4)[:(len(prompt) - 1) // 4]
    total = len(hashes) + int(rng.randint(1, pool.num_blocks + 1))
    got = pool.reserve(hashes, total)
    if got is None:
        assert _snapshot(pool) == snap
    else:
        shared, fresh = got
        assert len(shared) + len(fresh) == total
        assert all(pool._ref[b] >= 1 for b in shared + fresh)


def test_admit_rollback_engine_level(model):
    """Through the engine's admission: a shortfall that matched indexed
    prefix blocks restores the pool exactly."""
    eng = _paged(model, n_slots=2, num_blocks=9, admission="worst_case")
    base = list(range(5, 45))                         # 5 full blocks (bs 8)
    eng.run([Request(rid=0, prompt=base, max_new=4)])
    assert len(eng.pool._cached) == 5                 # indexed, parked
    eng.submit(Request(rid=1, prompt=[1, 2, 3, 4, 5, 6, 7, 8], max_new=8))
    eng._admit()                                      # takes 2 more blocks
    snap = _snapshot(eng.pool)
    entry = _QEntry(req=Request(rid=2, prompt=base + [77], max_new=30))
    assert not eng._admit_paged(1, entry)  # 8 blocks: 1 free + 5 cached
    assert _snapshot(eng.pool) == snap
    out = eng.run([])
    assert len(out[1]) == 8
    assert eng.pool.in_use() == 0


def test_engine_refuses_unknown_pressure_knobs(model):
    for kw in (dict(admission="lazy"), dict(preempt_policy="random"),
               dict(preempt_mode="drop")):
        with pytest.raises(ValueError):
            _paged(model, **kw)
