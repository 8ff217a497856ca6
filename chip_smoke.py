"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped or caught):

1. build    nvcc builds src/repro_torch/csrc/*.cu (one process per source,
            all started together) into src/repro_torch/build/.
2. kernels  each kernel against its plain PyTorch version on the card, at
            the main path's shapes and at edge shapes, with the tolerances
            stated below; its time beside its bound, the plain version's
            time and a PyTorch library call's time where one computes the
            same function.
3. serve    repro_torch.serve.ServeEngine on full-width qwen1.5-0.5b (random
            weights from a seeded generator), float and dual-mode, paged
            cache, max_seq 2048: every request finishes, the pool drains,
            logits are finite, and every kernel of the configuration's path
            launched.  Then one prefill chunk and the first decode step at
            full width through the kernels against the same step with the
            plain versions called in their place.

The last lines are the card's name and power limit, one JSON line with
every kernel's numbers, and the result line.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS = 67e12                # H100 SXM float32 rate outside tensor cores

# tolerances (max |kernel - plain|):
TOL_INT = 0.0          # int words: bitwise
TOL_SOFTMAX_F = 1e-6   # float row softmax: exp2/log2 ulps, sum order
TOL_PAIR_F = 2e-6      # float GELU/SiLU: |z| up to ~10, a few ulps of z
TOL_DECODE_F = 1e-5    # float decode: dot/sum order (the reference's 1e-5)
TOL_DECODE_I = 1e-4    # int decode on random inputs: a score word can flip
#                        on a quantize boundary between two f32 dot orders,
#                        moving that key's probability by ~1e-3 relative
TOL_LOGITS_F = 2e-5    # full-width logits, float: f32 reduction orders
TOL_LOGITS_D = 5e-3    # full-width logits, dual-mode: flipped score words
#                        (one S5.10 step of a score) through 24 layers


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise AssertionError(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def check(name: str, a, b, tol: float) -> float:
    torch.cuda.synchronize()
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    if not torch.isfinite(a.to(torch.float32)).all():
        fail(f"{name}: non-finite kernel output")
    e = max_err(a, b)
    if tol == 0.0 and not torch.equal(a, b):
        fail(f"{name}: not bitwise equal (max |diff| {e:.3e})")
    if e > tol:
        fail(f"{name}: max |diff| {e:.3e} > {tol:.1e}")
    log(f"  ok {name}: max|diff| {e:.3e} (tol {tol:.0e})")
    return e


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------- phase 2: kernels ----------------

def kernel_phase(dev, results):
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tiling
    from repro_torch.models.attention import paged_gather
    gen = torch.Generator(device="cpu").manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    # -- softmax_rows: rows of one prefill chunk's scores (16 heads x 64
    #    queries against a 2048-key table), causal MASK_VALUE tail
    log("[kernels] softmax_rows")
    x = randn(1024, 2048, scale=3.0)
    qpos = torch.arange(1024, device=dev) % 64 + 1000
    x = torch.where(torch.arange(2048, device=dev)[None, :] <= qpos[:, None],
                    x, torch.full_like(x, -30.0))
    err = check("softmax_rows int (1024, 2048)", ds.softmax_rows(x, "int"),
                ds.softmax_rows_plain(x, "int"), TOL_INT)
    check("softmax_rows float (1024, 2048)", ds.softmax_rows(x, "float"),
          ds.softmax_rows_plain(x, "float"), TOL_SOFTMAX_F)
    for shape in ((3, 1), (5, 33), (7, 2049), (2, 70000)):
        xe = randn(*shape, scale=8.0)
        xe[0, :] = -30.0                                     # all masked row
        check(f"softmax_rows int {shape}", ds.softmax_rows(xe, "int"),
              ds.softmax_rows_plain(xe, "int"), TOL_INT)
        check(f"softmax_rows float {shape}", ds.softmax_rows(xe, "float"),
              ds.softmax_rows_plain(xe, "float"), TOL_SOFTMAX_F)
    ms = time_ms(lambda: ds.softmax_rows(x, "int"))
    ms_f = time_ms(lambda: ds.softmax_rows(x, "float"))
    plain = time_ms(lambda: ds.softmax_rows_plain(x, "int"), iters=10)
    lib = time_ms(lambda: torch.softmax(x, dim=-1))
    n = x.numel()
    # int ops per element: 3 sweeps of quantize + log2-domain + PWL exp2
    # (~25 int ops each) plus the reductions; counted at the f32 rate
    b_ms, b_by = bound(8 * n, 80 * n)
    log(f"  softmax_rows (1024, 2048): int {ms * 1e3:.1f} us, float "
        f"{ms_f * 1e3:.1f} us, plain int {plain * 1e3:.1f} us, torch.softmax "
        f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by})")
    results["softmax_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=lib)

    # -- pair_act: the gate of one prefill chunk (64 tokens x d_ff 2816)
    #    and of one decode tick (4 slots)
    log("[kernels] pair_act")
    z = randn(64, 2816, scale=3.0)
    err = 0.0
    for mode in ("silu", "gelu"):
        for shape in ((64, 2816), (4, 2816), (3, 5), (1, 1)):
            ze = z if shape == (64, 2816) else randn(*shape, scale=3.0)
            e = check(f"pair_act {mode} int {shape}",
                      ds.pair_act(ze, mode, "int"),
                      ds.pair_act_plain(ze, mode, "int"), TOL_INT)
            err = max(err, e)
            check(f"pair_act {mode} float {shape}",
                  ds.pair_act(ze, mode, "float"),
                  ds.pair_act_plain(ze, mode, "float"), TOL_PAIR_F)
    # saturation rails and round-half-to-even ties of the S5.10 quantizer
    edge = torch.tensor([[-40.0, -32.0, -8.5, -0.5 / 1024, 0.0, 0.5 / 1024,
                          1.5 / 1024, 2.5 / 1024, 8.0, 31.99, 40.0]],
                        device=dev)
    for mode in ("silu", "gelu"):
        check(f"pair_act {mode} int rails/ties", ds.pair_act(edge, mode, "int"),
              ds.pair_act_plain(edge, mode, "int"), TOL_INT)
    ms = time_ms(lambda: ds.pair_act(z, "silu", "int"))
    ms_f = time_ms(lambda: ds.pair_act(z, "silu", "float"))
    plain = time_ms(lambda: ds.pair_act_plain(z, "silu", "int"), iters=10)
    lib = time_ms(lambda: torch.nn.functional.silu(z))
    lib_g = time_ms(lambda: torch.nn.functional.gelu(z, approximate="tanh"))
    n = z.numel()
    b_ms, b_by = bound(8 * n, 60 * n)
    log(f"  pair_act silu (64, 2816): int {ms * 1e3:.1f} us, float "
        f"{ms_f * 1e3:.1f} us, plain int {plain * 1e3:.1f} us, F.silu "
        f"{lib * 1e3:.1f} us, F.gelu(tanh) {lib_g * 1e3:.1f} us, bound "
        f"{b_ms * 1e3:.2f} us ({b_by})")
    results["pair_act"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=b_by, library_ms=lib)

    # -- decode: 4 slots x 16 kv heads x G, h 64, 128-key blocks, 2048 keys
    log("[kernels] decode_paged / decode_paged_int")

    def case(b, kh, g, h, bs, nblk, q_pos, grid=False, sentinel_tail=False):
        n_pool = 1 + b * nblk
        if grid:      # multiples of 2^-4: every product and sum is exact
            q = torch.round(randn(b, 1, kh, g, h, scale=4.0)) / 16
            kp = torch.round(randn(n_pool, bs, kh, h, scale=4.0)) / 16
        else:
            q = randn(b, 1, kh, g, h)
            kp = randn(n_pool, bs, kh, h)
        vp = randn(n_pool, bs, kh, h)
        ids = (torch.randperm(n_pool - 1, generator=gen) + 1).reshape(b, nblk)
        qp = torch.tensor(q_pos, dtype=torch.int32)
        if sentinel_tail:          # table entries past a row's length -> 0
            used = (qp[:, None] // bs) >= torch.arange(nblk)[None, :]
            ids = torch.where(used, ids, 0)
        tables = ids.to(torch.int32).to(dev)
        qp = qp.to(dev)
        valid = (torch.arange(nblk * bs, device=dev)[None, :]
                 <= qp[:, None]).to(torch.uint8)
        qf = (q * h ** -0.5)[:, 0].contiguous()
        return q, qf, kp, vp, tables, qp, valid

    def partials(kern, args, ns, int_mode, guard=0):
        qf, kp, vp, tables, qp, valid = args
        fn = fd.decode_paged_partials if kern else \
            fd.decode_paged_partials_plain
        return fn(qf, kp, vp, tables, qp, valid, num_splits=ns, causal=True,
                  int_mode=int_mode, guard_shift=guard)

    main_qpos = [300, 800, 1400, 2000]
    err_f = err_i = 0.0
    for g, grid in ((1, False), (1, True), (2, False), (4, True)):
        q, qf, kp, vp, tables, qp, valid = case(
            4, 16, g, 64, 128, 16, main_qpos if g == 1 else [5, 127, 128, 2047],
            grid=grid, sentinel_tail=(g > 1))
        args = (qf, kp, vp, tables, qp, valid)
        outs = {}
        for ns in (1, 4):
            pk = partials(True, args, ns, False)
            pp = partials(False, args, ns, False)
            o_k = fd.finish_partials(*pk, int_mode=False)
            e = check(f"decode_paged G={g} grid={grid} splits={ns}", o_k,
                      fd.finish_partials(*pp, int_mode=False), TOL_DECODE_F)
            err_f = max(err_f, e) if g == 1 and not grid else err_f
            outs[("f", ns)] = o_k
            ik = partials(True, args, ns, True)
            ip = partials(False, args, ns, True)
            o_ik = fd.finish_partials(*ik, int_mode=True)
            o_ip = fd.finish_partials(*ip, int_mode=True)
            if grid:          # exact scores: the int words are bitwise
                check(f"decode_paged_int m G={g} splits={ns}", ik[0], ip[0],
                      TOL_INT)
                check(f"decode_paged_int S G={g} splits={ns}", ik[1], ip[1],
                      TOL_INT)
            e = check(f"decode_paged_int out G={g} grid={grid} splits={ns}",
                      o_ik, o_ip, TOL_DECODE_I)
            if g == 1 and not grid:
                err_i = max(err_i, e)
            outs[("i", ns)] = (o_ik, ik)
        check(f"decode_paged split invariance G={g}", outs[("f", 4)],
              outs[("f", 1)], TOL_DECODE_F)
        from repro_torch.core import softmax_unit as unit
        l1 = unit.online_finish_int(unit.online_merge_n_int(
            outs[("i", 1)][1][0][..., None], outs[("i", 1)][1][1],
            outs[("i", 1)][1][2], dim=1)[1])
        l4 = unit.online_finish_int(unit.online_merge_n_int(
            outs[("i", 4)][1][0][..., None], outs[("i", 4)][1][1],
            outs[("i", 4)][1][2], dim=1)[1])
        check(f"decode_paged_int split invariance l words G={g}", l4, l1,
              TOL_INT)
    # identity-v probe: each value dim collects one key's exact numerator,
    # so the int kernel's accumulator words are bitwise too
    b, kh, g, h, bs, nblk = 2, 2, 2, 16, 16, 8
    q, qf, kp, vp, tables, qp, valid = case(b, kh, g, h, bs, nblk, [70, 127],
                                            grid=True)
    t = nblk * bs
    eye = torch.zeros(1 + b * nblk, bs, kh, t, device=dev)
    for bb in range(b):
        for j in range(nblk):
            blk = int(tables[bb, j])
            eye[blk, torch.arange(bs), :, j * bs + torch.arange(bs)] = 1.0
    args = (qf, kp, eye, tables, qp, valid)
    for ns in (1, 3):
        check(f"decode_paged_int identity-v acc splits={ns}",
              partials(True, args, ns, True, guard=0)[2],
              partials(False, args, ns, True, guard=0)[2], TOL_INT)

    # timing at the main path's shape, random inputs
    q, qf, kp, vp, tables, qp, valid = case(4, 16, 1, 64, 128, 16, main_qpos)
    args = (qf, kp, vp, tables, qp, valid)
    ns = tiling.decode_splits(16, 128, 4 * 16, dev)
    visited = sum(min(16, p // 128 + 1) for p in main_qpos)  # tiles read
    keys = visited * 128
    nbytes = (keys * 16 * (64 + 64) * 4 + qf.numel() * 4 + visited * 4
              + keys + 4 * 4 + 4 * ns * 16 * (64 + 2) * 4)
    flops = keys * 16 * (2 * 64 + 2 * 64)
    b_ms, b_by = bound(nbytes, flops)
    k_dense = paged_gather(kp, tables).permute(0, 2, 1, 3)
    v_dense = paged_gather(vp, tables).permute(0, 2, 1, 3)
    mask = valid.bool()[:, None, None, :]
    q_sdpa = q[:, 0].reshape(4, 16, 1, 64)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_sdpa, k_dense, v_dense, attn_mask=mask))
    for name, int_mode, e, lib_ms in (("decode_paged", False, err_f, lib),
                                      ("decode_paged_int", True, err_i, None)):
        ms = time_ms(lambda: partials(True, args, ns, int_mode))
        plain = time_ms(lambda: partials(False, args, ns, int_mode), iters=5)
        fold = time_ms(lambda: fd.finish_partials(
            *partials(True, args, ns, int_mode), int_mode=int_mode))
        log(f"  {name} (B4 K16 G1 h64 bs128 2048 keys, {ns} splits, "
            f"{visited} tiles): {ms * 1e3:.1f} us (+fold {fold * 1e3:.1f} "
            f"us total), plain {plain * 1e3:.1f} us, bound "
            f"{b_ms * 1e3:.1f} us ({b_by})"
            + (f", SDPA {lib_ms * 1e3:.1f} us" if lib_ms else ""))
        results[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


# ---------------- phase 3: serve ----------------

PATHS = {"float": ("float", "silu", ("decode_paged",)),
         "dualmode": ("dualmode", "silu_dualmode",
                      ("softmax_rows", "pair_act", "decode_paged_int"))}


def serve_phase(dev, launches):
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Request, ServeEngine
    base = registry.get_config("qwen1.5-0.5b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_lm(base, gen, dev)
    torch.cuda.synchronize()
    log(f"[serve] qwen1.5-0.5b full width: {base.n_layers} layers d "
        f"{base.d_model} heads {base.n_heads}/{base.n_kv_heads} d_ff "
        f"{base.d_ff} vocab {base.vocab}; init {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    lens = rng.randint(100, 1501, size=6)
    prompts = [rng.randint(0, base.vocab, size=n).tolist() for n in lens]
    for name, (sm, act, kernels) in PATHS.items():
        cfg = base.replace(softmax_impl=sm, activation=act)
        eng = ServeEngine(cfg, params, n_slots=4, max_seq=2048, device=dev)
        if eng.decode_attn_impl != "flash_decode":
            fail(f"{name}: decode resolved {eng.decode_attn_impl}")
        reqs = [Request(rid=i, prompt=p, max_new=16)
                for i, p in enumerate(prompts)]
        for k in _build.KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        for k in kernels:
            launches[k] = launches.get(k, 0) + counts[k]
        done = all(len(outs.get(r.rid, [])) == 16 for r in reqs)
        new = sum(len(v) for v in outs.values())
        log(f"[serve] {name}: {len(outs)}/{len(reqs)} requests, {new} new "
            f"tokens, prompts {int(lens.sum())} tokens, {dt:.2f} s "
            f"({(new + int(lens.sum())) / dt:.0f} tok/s all, "
            f"{new / eng.stats['decode_s']:.1f} tok/s decode); prefill "
            f"{eng.stats['prefill_s'] * 1e3:.0f} ms in "
            f"{eng.stats['prefill_chunks']} chunks, decode "
            f"{eng.stats['decode_s'] * 1e3:.0f} ms in "
            f"{eng.stats['decode_steps']} ticks "
            f"({eng.stats['decode_s'] * 1e3 / eng.stats['decode_steps']:.1f} "
            f"ms/tick); launches {counts}")
        if not done:
            fail(f"{name}: unfinished requests {outs}")
        if eng.pool.in_use() != 0:
            fail(f"{name}: pool did not drain ({eng.pool.in_use()} blocks)")
        if eng.stats["nonfinite"]:
            fail(f"{name}: {eng.stats['nonfinite']} non-finite logit rows")
        for k in kernels:
            if counts[k] == 0:
                fail(f"{name}: kernel {k} never launched on its path")
        parity(cfg, params, dev, prompts[0])


def parity(cfg, params, dev, prompt):
    """One prefill chunk + the first decode step at full width, through
    the kernels and with the plain versions called in their place."""
    from repro_torch.core import activations
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serve import ServeEngine

    def step():
        eng = ServeEngine(cfg, params, n_slots=1, max_seq=2048, device=dev)
        eng.pool.alloc(2)
        tables = torch.tensor([[1, 2] + [0] * (eng.max_blocks - 2)],
                              dtype=torch.int32, device=dev)
        toks = torch.tensor([prompt[:64]], device=dev)
        chunk = eng.prefill_chunk_logits(toks, 0, tables,
                                         torch.tensor([63], device=dev))
        nxt = torch.argmax(chunk, dim=-1)[:, None]
        dec = eng.decode_logits(nxt, torch.tensor([64], dtype=torch.int32,
                                                  device=dev), tables)
        torch.cuda.synchronize()
        return chunk, dec

    kern = step()
    with mock.patch.object(dispatch, "softmax_rows", ds.softmax_rows_plain), \
            mock.patch.object(activations, "pair_act", ds.pair_act_plain), \
            mock.patch.object(fd, "decode_paged_partials",
                              fd.decode_paged_partials_plain):
        plain = step()
    tol = TOL_LOGITS_F if cfg.softmax_impl == "float" else TOL_LOGITS_D
    for what, a, b in (("prefill chunk", kern[0], plain[0]),
                       ("first decode step", kern[1], plain[1])):
        check(f"{cfg.softmax_impl} full-width logits, {what}", a, b, tol)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (sets the float32 matmul policy)
    from repro_torch.kernels import _build
    import repro_torch.kernels.dualmode_softmax  # noqa: F401  (registers)
    import repro_torch.kernels.flash_decode  # noqa: F401  (registers)
    dev = torch.device("cuda")
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    _build.LIBRARY.get()
    info = _build.LIBRARY.info
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f}"
        f" s, cached={info['cached']}) -> {info['dir']}")
    for src, text in info["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    results: dict = {}
    kernel_phase(dev, results)
    launches: dict = {}
    serve_phase(dev, launches)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi: {smi.stderr.strip()}")
    rows = []
    for name, k in _build.KERNELS.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces,
                     "launches": launches.get(name, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
