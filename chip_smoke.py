"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (no phase is skipped or caught):

1. build    nvcc builds src/repro_torch/csrc/*.cu (one process per source,
            all started together) into src/repro_torch/build/.
2. kernels  each kernel against its plain PyTorch version on the card, at
            the main path's shapes and at edge shapes, with the tolerances
            stated below; its time beside its bound, the plain version's
            time and a PyTorch library call's time where one computes the
            same function.  Rows 1 and 2 at every edge of the row
            softmax's plan and over every S5.10 word, on the 16-byte and
            the 4-byte paths, held to the same bits over two calls.
            Rows 3 and 4 (the paged decodes) at 1 split and at the plan's
            (tiling.decode_splits), back to back and under CUDA-graph
            replay, alone and with their split fold.
3. serve    repro_torch.serve.ServeEngine on full-width qwen1.5-0.5b (random
            weights from a seeded generator), float and dual-mode, paged
            cache, max_seq 2048: every request finishes, the pool drains,
            logits are finite, and every kernel of the configuration's path
            launched.  Then one prefill chunk and the first decode step at
            full width through the kernels against the same step with the
            plain versions called in their place.
   pressure the same model cut to its first 8 layers (PRESSURE_LAYERS)
            and the same prompts with 144 new tokens each (every
            request grows its table past a 128-token block) on an ample
            pool, then on a pool of half the worst-case demand of 4 slots
            (as serve.faults sizes it) with preempt_mode 'recompute' and
            'swap', float and dual-mode: every request finishes with all
            its tokens, the pool drains, nothing starves, each tight run
            preempts (the swap runs swap out and in) and launches every
            kernel of the path; swap streams equal the ample run's token
            for token, and a recompute stream that diverges does so only
            where the ample run's top-2 logit margin is under the mode's
            logit limit (RECOMPUTE_MARGIN).  ms a tick, preemptions and
            swap bytes and seconds are logged ("[pressure]").  Then
            serve.faults.chaos_soak at full width (float, recompute and
            swap, max_seq 64): its invariants hold.
4. long     the long-context kernels (blocked float flash, one-sweep snapped
            int flash, contiguous split-KV decode float and int) against
            their plain versions at the long-context path's shapes and at
            edge shapes (their Hopper bodies' tile edges, q_pos < 0,
            splits with no tile and pointers one float off 16 bytes; the
            int kernels' m and S words bitwise on grid-valued q and k; all
            held to the same bits over two calls), timed beside their
            bounds at the tiles and split count the path's wrappers pick,
            also under CUDA-graph replay (the decodes also with their split
            fold, beside a probe of split counts); then the contiguous
            engine at max_seq 16384 (buckets 512 / 1024 / 4096, 4 slots),
            float and dual-mode, on 6 prompts of 1000-4000 tokens: prefill
            resolves to the blocked kernels and decode to the contiguous
            split-KV kernels, each launches, every request finishes with
            finite logits; then one bucket-4096 prefill and the first decode
            step through the kernels against the plain versions.

5. yi       yi-6b's path: the residual-norm epilogue, the norm -> QKV
            prologue and the fused GLU against their plain versions at the
            path's shapes (a decode tick's 4 rows and a prefill chunk's 64,
            d 4096, F 5120 and 11008) and at edge shapes, timed beside their
            bounds (the norm -> QKV prologue and the fused GLU also under
            CUDA-graph replay, and held to the same bits over two calls;
            the GLU's chunk also at each K split count); the unit and paged
            decode kernels at h 128, G 8 (rows 3 / 4 also timed there, at
            the plan's splits, row 3 beside SDPA over the gathered cache);
            the residual norm's wrapper host time split by part.  Then,
            with the qwen weights freed, ServeEngine on full-width yi-6b
            (random weights from a seeded generator), float and dual-mode
            with norm_impl / ffn_impl 'fused_pallas', paged cache at max_seq
            4096, 4 slots, 64-token chunks, 6 prompts of 200-3000 tokens:
            every request finishes, the pool drains, logits are finite and
            every kernel of the path launched; then one prefill chunk and the
            first decode step through the kernels against the plain versions.
6. train    the training kernels (flash backward dq and dk/dv, the fused
            GLU backward) against their plain versions at qwen1.5-0.5b's
            training shape (B 2, S = T = 4096, 16 heads, h 64; M 8192, d
            1024, F 2816), at yi-6b's heads (h 128, G 8) and widths, and at
            edge shapes (ragged kv_valid, a row whose visible keys are all
            masked, S != T, hv != h, non-causal, ragged M and F), timed
            beside their bounds (the GLU backward also under CUDA-graph
            replay, and held to the same bits over two calls); the float
            forward with its statistics at
            the training shape, held to its plain version and to the same
            bits over two calls, timed beside SDPA's forward.  Then, with
            the serve weights freed, the
            Trainer on full-width, full-depth qwen1.5-0.5b (norm / ffn
            'fused_pallas', float, remat) for 8 steps on 2 rows of 4096
            tokens: the loss is finite and falls, every kernel of the path
            launched the number of times a step implies, one step from one
            state gives the same bits twice, one step's loss and gradients
            through the kernels match the plain versions', and a save and
            resume (depth cut to 2 layers, in a temporary directory removed
            afterwards) continues with the uninterrupted run's loss.  The one
            cut: batches come from an 8192-token bigram stream (the table at
            the full vocabulary would be ~92 GB on the host); the model and
            its head keep all 151936 rows.
7. bert     bert-base's path: the three-sweep int flash (row 9) against its
            plain version at bert's shape (B 8, S = T = 512, 12 heads, h
            64, non-causal) and at edge shapes (causal with ragged
            kv_valid, S != T, G 8 / h 128, a row whose one visible key is
            masked, 70000 keys), bitwise on the grid-valued identity-v
            probe, held to the same bits over two calls and timed back to
            back and under CUDA-graph replay beside two bounds (the float
            work alone, and that plus the int instructions a score its
            entry's SASS counts); the unit's row softmax on 49152 rows of
            512, its GELU mode on 4096 x 3072, the residual-norm and norm
            -> QKV seams with kind='layer' at d 768, timed beside their
            bounds.  Then,
            with the training state freed, lm_apply(..., return_hidden=True)
            on full-width bert-base (random weights from a seeded
            generator, 8 x 512 tokens, norm_impl 'fused_pallas') in four
            configurations: float GELU, dual-mode (the unit's softmax and
            GELU modes), dual-mode through the three-sweep kernel, and the
            i-GELU baseline.  Each kernel of a configuration launches once a
            layer; hidden states are finite and match the same forward with
            the plain versions called in the kernels' place, and the
            three-sweep path matches the naive dual-mode path.
8. vision   llama-3.2-vision's path: the norm -> gated-GLU prologue (row
            16) against its plain version at d 4096, F 14336 and the
            path's rows (a decode tick's 4, a bucket-512 and a bucket-4096
            prefill) and at edge shapes (a layer norm with a bias, GELU,
            ragged M and F, small d), held to the same bits over two calls,
            timed also under CUDA-graph replay, its backward against the
            plain VJP; the norm -> QKV prologue timed at M 4096, F 6144;
            the contiguous decode kernels (rows 5 / 6: 4 slots, 8 kv heads
            of 4 queries, h 128) and the blocked kernels (rows 7 / 8: S
            4096 and 512, and S 67 against row 7's 64-row tile, also with
            pointers one float off 16 bytes) non-causal over the 1601
            image keys, as the cross sublayer runs them; the fused GLU
            (row 12) at the bucket-4096 prefill against its plain version,
            held to the same bits over two calls; each timed beside
            its bound (rows 5-8 at the wrappers' tiles and splits, under
            CUDA-graph replay, rows 5 / 7 beside SDPA), also at the
            self-attention shapes: a causal bucket-4096 prefill (row 8's
            words there too) and a decode tick of
            a 4096-key cache.  Then,
            with the bert weights freed, ServeEngine on full-width
            llama-3.2-vision-11b (random weights from a seeded generator,
            every cross_gate 0.5), float (norm / ffn 'fused_pallas') and
            dual-mode (norm 'fused_pallas'), on the contiguous cache that
            'auto' picks for it (max_seq 4096, 4 slots, buckets 512 /
            1024 / 4096), 6 prompts of 200-3000 tokens, five of them with
            (1, 1601, 4096) image embeddings: every request finishes,
            logits are finite, each kernel of the path launches exactly
            the number of times the prefills and ticks imply (40, 32 or 8
            a forward) and no other kernel launches; then one bucket-1024
            prefill with image embeddings and the first decode step
            through the kernels against the plain versions.
9. granite  with the vision weights freed, ServeEngine on full-width,
            full-depth granite-moe-3b-a800m (32 layers, 40 experts top-8
            in stacks of 48, d 1536, random weights from a seeded
            generator), float and dual-mode with norm_impl / ffn_impl
            'fused_pallas', paged at max_seq 2048, 4 slots, 64-token
            chunks, the serve phase's 6 prompts, 16 new tokens each:
            every request finishes, the pool drains, each kernel launches
            exactly the number of times a layer of a chunk and of a tick
            implies; then one chunk and the first decode step block by
            block, each block given the kernel path's input through the
            plain versions and through the kernels, held on the tokens
            whose expert sets agree (route flips counted, each within
            the flip rule: a margin at most twice the largest router-
            probability difference on the layer's agreeing tokens),
            logits finite; greedy streams reported; the MoE sublayer's
            parts (route, sort, dispatch, experts, combine) timed at a
            tick ("[granite moe tick]"); a tight pool in 'recompute' and
            'swap' with streams equal to the ample run's; then the
            Trainer at full width and 8 of the 32 layers (1 x 2048
            tokens of the 8192-token bigram stream, remat, CE + 0.01 x
            the load-balance loss): exact launches, aux 1 a layer with a
            zero router, a step bitwise repeatable, one step's loss and
            gradients through the kernels against the plain versions'.
10. whisper  the kernels at whisper-base's shapes against their plain
            versions (rows 7 / 8 non-causal over the 1500 frames, whose
            last 64-key tile is 36 keys short, and causal over a 448-key
            row; rows 5 / 6 over the 1500 cross keys and a self tick;
            rows 14, 15 and 2 at d 512, F 2048); then, with every earlier
            phase's weights freed, ServeEngine on full-width whisper-base
            (6 + 6 layers, every cross_gate 0.5), float and dual-mode
            (the unit's softmax and GELU modes), norm_impl 'fused_pallas',
            on the contiguous cache at max_seq 448, 4 slots, one bucket
            of 16, the blocked kernels for prefill and the encoder and
            the contiguous decode asked for by name: 6 requests, each with
            its own (1, 1500, 512) frames through the encoder at
            admission, prompts of 4-16 tokens, 64 new tokens each; exact
            launches a layer of an encoder pass, a prefill and a tick;
            the encoder's output, one prefill and the first decode step
            through the kernels against the plain versions.
11. minicpm3 rows 5-8 at MLA's head dims (q.k over 96, v over 64, K 40,
            G 1; rows 7 / 8 over a 2048-token prompt and a 64-token chunk,
            rows 5 / 6 at a 4-slot tick), rows 5 and 7 timed beside their
            bounds and SDPA ("[mla attention]"), rows 1, 2, 12, 14 at its
            widths; then full-width minicpm3-4b (62 layers, 4.07 B
            parameters), float and dual-mode with the fused impls, paged
            at max_seq 2048, 4 slots, 64-token chunks, the serve phase's 6
            prompts with 16 new tokens each: exact launches a layer of a
            chunk and a tick (the tick's attention is row 5 / 6 on the
            gathered, expanded latent); one chunk and the first decode
            step against the plain versions.
12. qwen3    rows 3 / 4 at qwen3-14b's tick (G 5, h 128) and rows 1, 2,
            12, 14, 15 at its widths; then, alone on the card, full-width
            qwen3-14b (40 layers, 14.77 B parameters, 55 GiB), as
            minicpm3 but on yi's path with qk-norm.
13. rwkv6    the WKV kernel (wkv6) against its plain step loop at
            rwkv6's tick (B 4, S 1, 32 heads of 64), a batch-1 prefill
            of 1500 steps, S 77 and 33 (no multiple of its 32-step tile)
            and S 8192: y and the final state within TOL_SCAN, a split
            of the steps in two carried through the state and a repeat
            bitwise; timed at the tick and the prefill beside its bound.
            Then full-width, full-depth rwkv6-1.6b (24 layers, 1.6 B),
            float only (relu^2 and a plain SiLU gate: no unit mode), the
            residual-norm epilogue fused, on the contiguous cache that
            'auto' picks (max_seq 16384, 4 slots, each prompt prefilled
            at its own length): the serve phase's 6 prompts and one of
            8192 tokens, 16 new each; exact launches a layer of a
            prefill and a tick; the first prefill and tick against the
            plain versions.
14. jamba    the selective-scan kernel against its plain step loop at
            jamba's tick (B 4, d_inner 8192, d_state 16), a 1500-step
            prefill, d_inner 200 and d_state 8, with the same checks and
            times.  Then full-width jamba-v0.1-52b at 8 of its 32 layers
            (one period: 7 mamba layers and 1 attention layer over 4
            dense and 4 MoE FFNs, 16 experts top-2; 13.30 B, 49.5 GiB),
            float and dual-mode with the fused impls, contiguous at
            max_seq 4096, 4 slots, the serve phase's prompts at their own
            lengths, 16 new each: exact launches a prefill and a tick;
            the first prefill and tick block by block (the kernels and
            the plain versions on the same input and cache, held on the
            tokens whose expert sets agree with granite's flip rule, the
            mamba states within TOL_SCAN) and their logits against the
            plain versions.
15. deepseek full-width deepseek-v2-lite-16b (below, at its phase).
16. rwkv6-train  the WKV backward kernel (wkv6_bwd) against autograd
            through the plain scan at rwkv6's training shape (B 2, S 2048,
            32 heads of 64), every gradient within TOL_SCAN_BWD, a repeat
            bitwise, timed back to back and under CUDA-graph replay
            beside its bound.  Then the Trainer on full-width,
            full-depth rwkv6-1.6b (24 layers, remat, the fused residual
            norm) for 2 steps of 2 x 2048 tokens of the 8192-token bigram
            stream: exact launches a layer of a step (wkv6 2, wkv6_bwd 1,
            resnorm 2), a step repeated from one state bitwise, one
            step's loss on 1 x 512 tokens kernels vs plain (its gradients
            reported beside the plain path's own f32 noise), every block
            given the kernel path's input held kernels vs plain, a save
            and resume at 2 layers.
17. jamba-train  the selective scan's backward kernel likewise at jamba's
            training shape (B 1, S 2048, d_inner 8192, d_state 16); the
            Trainer on full-width jamba-v0.1-52b at depth 1 (its layer 0,
            a mamba mixer over the dense MLP, 0.82 B parameters), 2 steps
            of 1 x 2048: exact launches (selective_scan 2,
            selective_scan_bwd 1, resnorm 2, glu 2, glu_bwd 1), a step
            bitwise twice, one step's loss and every gradient kernels vs
            plain, the block held, a save and resume.

``python3 chip_smoke.py PHASE[,PHASE]`` runs the build and the named
phases only (qwen, long, yi, train, bert, vision, granite, whisper,
minicpm3, qwen3, rwkv6, jamba, deepseek, rwkv6-train, jamba-train; qwen is
phases 2, 3 and the pressure run) and ends with
``{"ok": true, "phases": [...]}`` instead of the kernels line and the
device line.

The last lines are the card's name and power limit, one JSON line with
every kernel's numbers, and the result line; before them, one JSON line
each for rows 12, 13, 15, 16 ("[norm gemm]"), row 7 ("[flash fwd]"),
row 5 ("[decode dense]"), row 8 ("[flash snap]"), row 6 ("[decode
dense int]"), rows 3 / 4 ("[decode paged]") and row 9 ("[flash int3]")
at every shape they were timed at, rows 7 and 5 at MLA's head dims
("[mla attention]"), the two recurrence kernels at a tick and a prefill
("[recurrence]") and their backward kernels at the training shapes
("[recurrence bwd]"), a "[resnorm host]" line (row 14's
wrapper, µs a call to issue, by part), and a
"[unit rows]" line from the kernels, yi and bert phases: rows 1 and 2 at
qwen's and bert's shapes (int and float modes beside torch.softmax,
F.silu, F.gelu) and row 14 at yi's and bert's (beside its two-call
equivalent, torch.add then F.rms_norm / F.layer_norm: no one PyTorch call
computes it, so its library_ms is null), each back to back and under
CUDA-graph replay.  After the build, a "[sass]" line counts the
instructions of rows 1 and 2's int entries (cuobjdump -sass), and another
the int instructions a score that row 8's entries add over row 7's, which
row 8's bound counts at the f32 rate, and a third those of row 9's
entries, for row 9's int-aware bound.
Without a CUDA device the script exits non-zero before printing any
result.
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
TOL_FLASH_F = 1e-5     # blocked float attention: dot / sum / exp2 orders
TOL_FLASH_I = 5e-3     # int prefill outputs on random inputs: a score word
#                        can flip between two f32 dot orders, and in a row
#                        of a few keys one flip moves the output by up to
#                        ~2^-10 log2(e) |v| (exact scores are held bitwise)
TOL_NORM = 1e-5        # the normalized row: moment sum order, exp2/log2
#                        ulps, unit-scale outputs (the residual sum: bitwise)
TOL_GEMM = 1e-4        # norm -> QKV and the fused GLU: f32 dots over 4096
#                        terms in two orders (32-deep chunks vs cuBLAS) give
#                        ~1e-5 on outputs up to ~5; the GLU scales one by |u|
TOL_YI_LOGITS_F = 1e-4  # full-width yi-6b logits, float: every QKV and FFN
#                        product of 32 layers at d 4096 in another f32 order
# training kernels, relative to max(1, max |plain|) of the output:
TOL_FLASH_BWD = 1e-5   # dq, dk, dv: f32 sums over up to 16384 rows (dk/dv)
#                        or 4096 keys (dq) of h-deep products in two orders
TOL_GLU_BWD = 2e-5     # d_gate, d_up: the forward's dots over up to 4096
#                        terms in two orders, times |dY| and pair_act'
TOL_TRAIN_LOSS = 1e-5  # one step's loss, kernels vs plain, relative
TOL_TRAIN_GRAD = 1e-3  # each gradient tensor, kernels vs plain, relative to
#                        its own max |plain|
TOL_BERT_F = 1e-4      # full-width bert-base hidden states, float: the
#                        norm -> QKV products of 12 layers at d 768 in
#                        another f32 order (yi's limit).  The quantized
#                        configurations (dual-mode, i-GELU) take
#                        TOL_LOGITS_D: an FFN input that the kernels' f32
#                        order moves across an S5.10 boundary flips its
#                        i-GELU word as it flips the unit's (i-GELU
#                        measured 1.35e-3 on the H100)
TOL_VISION_F = 1e-4    # full-width llama-3.2-vision logits, float: yi's
#                        limit (every QKV, FFN and norm -> GLU product of 40
#                        layers at d 4096 in another f32 order); dual-mode
#                        takes TOL_LOGITS_D


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


def host_ms(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """(host, wall) ms a call: the host's time to issue ``iters`` calls
    back to back, and the time until the card has finished them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3 / iters, (t2 - t0) * 1e3 / iters


def graph_ms(fn, calls: int = 10, iters: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    the graph replayed ``iters`` times, so host dispatch is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, iters=iters, warmup=1) / calls
    del graph
    return ms


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


def check_rel(name: str, a, b, tol: float) -> float:
    """check() with the limit ``tol`` x max(1, max |b|); returns the
    absolute max |a - b|."""
    scale = max(1.0, float(b.abs().max()))
    e = check(f"{name} (limit x {scale:.3g})", a, b, tol * scale)
    return e


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_repeat(name: str, fn) -> None:
    """Two calls on the same inputs give the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name}: two calls differ (max |diff| {max_err(a, b):.3e})")
    log(f"  ok {name}: two calls bitwise equal")


def off_by_one_float(x):
    """x's values in a contiguous tensor whose data pointer is one float past
    a 16-byte boundary: the kernels take their 4-byte copies there."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def fwd_checks(fa, name: str, args, causal: bool, bkv: int) -> float:
    """Row 7 with its statistics against the plain version: out, m and
    l / plain l; returns the out error."""
    got = fa.flash_fwd(*args, causal=causal, block_kv=bkv, return_stats=True)
    want = fa.flash_fwd_plain(*args, causal=causal, block_kv=bkv,
                              return_stats=True)
    e = check(f"flash_fwd out {name}", got[0], want[0], TOL_FLASH_F)
    check(f"flash_fwd m {name}", got[1], want[1], TOL_FLASH_F)
    check(f"flash_fwd l / plain l {name}", got[2] / want[2],
          torch.ones_like(want[2]), TOL_FLASH_F)
    return e


def snap_checks(fai, name: str, args, causal: bool, bkv: int,
                gs: int = 0) -> None:
    """Row 8 against the plain version on grid-valued q and k (exact
    scores): the partial's m and S words bitwise, the output within
    TOL_FLASH_F; two calls give the same bits."""
    kw = dict(causal=causal, block_kv=bkv, guard_shift=gs)
    got = fai.flash_snap(*args, return_partial=True, **kw)
    want = fai.flash_snap_plain(*args, return_partial=True, **kw)
    check(f"flash_snap m {name}", got[1], want[1], TOL_INT)
    check(f"flash_snap S {name}", got[2], want[2], TOL_INT)
    check(f"flash_snap out {name}", fai.flash_snap(*args, **kw),
          fai.flash_snap_plain(*args, **kw), TOL_FLASH_F)
    check_repeat(f"flash_snap {name} repeat", lambda: torch.cat(
        [x.flatten().to(torch.float32) for x in fai.flash_snap(
            *args, return_partial=True, **kw)]
        + [fai.flash_snap(*args, **kw).flatten()]))


def snap_int_a_score(results, h: int, hv: int, causal: bool) -> float:
    """The int instructions a score of the row-8 entry the plan picks for
    16-byte copies at head dims h, hv (:func:`snap_int_ops`)."""
    from repro_torch.kernels import tiling
    plan = tiling.flash_fwd_plan(h, hv, causal=causal)
    key = ",".join(str(x) for x in (
        tiling.head_width(h, hv), plan.block_q, plan.stages, plan.vec))
    if key not in results["snap_sass"]:
        fail(f"no SASS count of row 8's entry {key}: its bound needs one")
    return results["snap_sass"][key]["int_ops_a_score"]


def kernel_row(table: dict, key: str, fn, plain_fn, b_ms: float, b_by: str,
               lib_ms, iters: int = 10, plain_iters: int = 2, **extra):
    """One shape of rows 5-8 into ``table``: back-to-back and CUDA-graph
    replay times of the wrapper, the plain version's, the bound and the
    library call's time; returns the entry."""
    ms = time_ms(fn, iters=iters, warmup=2)
    r_ = dict(ms=ms, graph_ms=graph_ms(fn, calls=2 if ms > 1.0 else 10),
              plain_ms=time_ms(plain_fn, iters=plain_iters, warmup=1),
              bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
              bound_share=b_ms / ms, **extra)
    table[key] = r_
    log(f"  {key}: {ms * 1e3:.1f} us (graph {r_['graph_ms'] * 1e3:.1f}), "
        f"plain {r_['plain_ms'] * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us "
        f"({b_by}; {100 * r_['bound_share']:.1f}% of it reached)"
        + (f", library {lib_ms * 1e3:.1f} us" if lib_ms is not None else "")
        + "".join(f", {k} {v}" for k, v in extra.items()))
    return r_


def glu_times(results, key: str, x, wg, wu, iters: int):
    """Row 12 (silu) at one shape through norm_gemm_row, beside its plain
    version and two torch.matmul; returns (ms, plain, bound, bound_by,
    library)."""
    from repro_torch.kernels import fused_ffn as ff
    (m, k), f = x.shape, wg.shape[1]
    ms = time_ms(lambda: ff.fused_glu(x, wg, wu, mode="silu"), iters=iters)
    plain = time_ms(lambda: ff._glu_reference(x, wg, wu, "silu"),
                    iters=iters)

    def library():
        return torch.matmul(x, wg), torch.matmul(x, wu)
    lib = time_ms(library, iters=iters)
    b_ms, b_by = bound((m * k + 2 * k * f + m * f) * 4,
                       4 * m * k * f + 20 * m * f)
    log(f"  glu silu M{m} d{k} F{f}: {ms * 1e3:.1f} us, plain "
        f"{plain * 1e3:.1f} us, two torch.matmul {lib * 1e3:.1f} us, "
        f"bound {b_ms * 1e3:.1f} us ({b_by})")
    norm_gemm_row(results, key, ms, plain, b_ms, b_by, lib,
                  lambda: ff.fused_glu(x, wg, wu, mode="silu"), library)
    return ms, plain, b_ms, b_by, lib


def norm_gemm_row(results, key: str, ms: float, plain: float, b_ms: float,
                  b_by: str, lib: float, kernel_fn, lib_fn) -> None:
    """One shape of rows 12, 13, 15 or 16 into results['norm_gemm_ms'],
    with the kernel's and the library call's device times under CUDA-graph
    replay
    beside the back-to-back times (which include host dispatch)."""
    calls = 2 if b_ms > 1.0 else 10
    results.setdefault("norm_gemm_ms", {})[key] = r_ = dict(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        graph_ms=graph_ms(kernel_fn, calls),
        library_graph_ms=graph_ms(lib_fn, calls))
    log(f"  {key}: {ms * 1e3:.1f} us (graph {r_['graph_ms'] * 1e3:.1f}), "
        f"plain {plain * 1e3:.1f} us, library {lib * 1e3:.1f} us (graph "
        f"{r_['library_graph_ms'] * 1e3:.1f}), bound {b_ms * 1e3:.1f} us "
        f"({b_by})")


def unit_row(table: dict, key: str, fn, b_ms: float, lib_fn=None,
             lib: str | None = None, iters: int = 50) -> dict:
    """One shape of rows 1, 2 or 14 into ``table``: the wrapper's time back
    to back and its device time under CUDA-graph replay, beside its bound
    and, where ``lib_fn`` is given, the same two times of the PyTorch
    call(s) ``lib`` names; returns the entry."""
    ms = time_ms(fn, iters=iters)
    r_ = dict(ms=ms, graph_ms=graph_ms(fn), bound_ms=b_ms)
    if lib_fn is not None:
        r_.update(library=lib, library_ms=time_ms(lib_fn, iters=iters),
                  library_graph_ms=graph_ms(lib_fn))
    r_["bound_share_graph"] = b_ms / r_["graph_ms"]
    table[key] = r_
    log(f"  {key}: {ms * 1e3:.1f} us (graph {r_['graph_ms'] * 1e3:.1f}), "
        f"bound {b_ms * 1e3:.2f} us ({100 * r_['bound_share_graph']:.1f}% of "
        "it reached under graph)" + (
            f", {lib} {r_['library_ms'] * 1e3:.1f} us (graph "
            f"{r_['library_graph_ms'] * 1e3:.1f})" if lib_fn else ""))
    return r_


_SASS_FAMILIES = {
    "int": ("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP",
            "SEL", "IMNMX", "VIMNMX", "IABS", "FLO", "LEA", "PRMT", "SGXT",
            "BMSK", "POPC", "BREV", "ICMP", "IMNMX3"),
    "imad": ("IMAD", "IMUL", "IMADSP"),
    "fp": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "FADD32I",
           "FMUL32I", "FFMA32I"),
    "mufu": ("MUFU",),
    "conv": ("F2I", "I2F", "F2F", "I2FP", "F2IP", "FRND"),
    "mem": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ULDC"),
}


def sass_entries(text: str, keep) -> dict:
    """Each entry of ``cuobjdump -sass`` output whose mangled name holds
    one of ``keep``: its instructions (NOPs and the closing self-branch
    left out), the length of each loop (a backward branch's span), the
    opcode mix of the longest loop, or of the whole entry where it has
    none, and the mix of each outermost loop (``outer``, in code order)."""
    import re
    fam = {op: f for f, ops in _SASS_FAMILIES.items() for op in ops}
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split()[0]
        if not any(k in name for k in keep):
            continue
        body, labels, pending = [], {}, []
        for line in chunk.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m_ = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not m_:
                continue
            a = int(m_.group(1), 16)
            for lab_ in pending:
                labels[lab_] = a
            pending = []
            t = re.sub(r"^@!?U?P\w+\s+", "", m_.group(2))
            if not t.startswith("NOP"):
                body.append((a, t))

        def target(t):
            b_ = re.match(r"BRA(?:\.\w+)*\s+(?:[!\w]+\s*,\s*)?"
                          r"(?:0x([0-9a-f]+)|`\((\.L_x_\d+)\))", t)
            if not b_:
                return None
            return int(b_.group(1), 16) if b_.group(1) else labels.get(
                b_.group(2))
        while body and target(body[-1][1]) == body[-1][0]:
            body.pop()                           # the closing self-branch
        loops = [(target(t), a) for a, t in body
                 if target(t) is not None and target(t) <= a]
        span = max(loops, key=lambda lo: lo[1] - lo[0], default=None)

        def mix_of(lo, hi):
            mix_: dict = {}
            for a, t in body:
                if lo <= a <= hi:
                    f = fam.get(t.split()[0].split(".")[0], "other")
                    mix_[f] = mix_.get(f, 0) + 1
            return mix_
        mix = mix_of(*span) if span else mix_of(0, body[-1][0] if body else 0)
        outer = sorted({(lo, hi) for lo, hi in loops if not any(
            lo2 <= lo and hi <= hi2 and (lo2, hi2) != (lo, hi)
            for lo2, hi2 in loops)})
        short = re.sub(r"^_ZN12_GLOBAL__N_1\d+", "", name)
        targs = re.findall(r"L[bi](\d+)E", short)
        short = re.sub(r"I.*$|Ev.*$", "", short) + (
            f"<{','.join(targs)}>" if targs else "")
        out[short] = dict(n=len(body), loops=[
            sum(1 for a, _ in body if lo <= a <= hi) for lo, hi in loops],
            mix=mix, outer=[mix_of(lo, hi) for lo, hi in outer])
    return out


def sass_report(build_dir: str, sources=("pair_act", "softmax_rows"),
                keep=("Lb1ELb1E", "Lb0ELb1E", "softmax_held_kernelILb1E",
                      "softmax_stream_kernelILb1E", "softmax_rows_int")) -> dict:
    """:func:`sass_entries` of the int kernel entries of rows 1 and 2
    (their objects ``sources`` in ``build_dir``), by source.  A loop run
    once an element (or a float4) gives the instructions an element.  {}
    where the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    return {src: sass_entries(subprocess.run(
        [tool, "-sass", os.path.join(build_dir, src + ".o")],
        capture_output=True, text=True, timeout=120).stdout, keep)
        for src in sources}


SNAP_INT_FAMILIES = ("int", "imad", "conv")


def snap_int_ops(build_dir: str) -> dict:
    """Row 8's int instructions a score, by entry: the int-ALU, IMAD and
    conversion instructions (:data:`SNAP_INT_FAMILIES`) in the key-tile
    loop of each ``flash_snap`` entry (the longest loop of ``fwd_kernel``)
    less those of row 7's entry of the same tile shape, over the SR x SC
    scores a thread computes a tile.  The two loops share the score, P V and
    ring code, so the difference is what the snapped recurrence adds.
    Keys: "D,BQ,NS,VEC"; each with the count, the two mixes and the
    scores a trip.  {} where the toolkit has no cuobjdump."""
    rep = sass_report(build_dir, sources=("flash_fwd", "flash_snap"),
                      keep=("fwd_kernel",))
    if not rep:
        return {}
    fwd = {k.split("<")[1].rstrip(">"): v
           for k, v in rep["flash_fwd"].items()}
    out = {}
    for name, e in rep["flash_snap"].items():
        args = name.split("<")[1].rstrip(">")
        d, bq = (int(x) for x in args.split(",")[:2])
        base = fwd[",".join(args.split(",")[:4])]
        scores = (bq // 16) * 4            # SR x SC of the thread
        extra = sum(e["mix"].get(f, 0) - base["mix"].get(f, 0)
                    for f in SNAP_INT_FAMILIES)
        out[args] = dict(int_ops_a_score=extra / scores, scores=scores,
                         mix=e["mix"], fwd_mix=base["mix"],
                         loops=e["loops"], fwd_loops=base["loops"])
    return out


INT3_SCORES = 16   # scores a thread of row 9 handles a key tile (4 x 4)


def int3_int_ops(build_dir: str) -> dict:
    """Row 9's int instructions a score, by entry: the int-ALU, IMAD and
    conversion instructions (:data:`SNAP_INT_FAMILIES`) of each outermost
    loop of a ``flash_int3`` entry of ``fwd_kernel`` -- its sweeps of K,
    the sum over the kept words, its P V sweep -- over the
    :data:`INT3_SCORES` scores a thread handles a trip, summed over the
    loops, less row 7's a score (the key-tile loop of its entry of the
    same head width and copy width, over its 32 or 16 scores a trip): the
    ring and tile bookkeeping the float bound leaves out.  Static counts:
    an inner loop's instructions count once a trip of the loop around it.
    Keys: "D,BQ,NS,VEC,CACHE"; each with the count and the loops' mixes.
    {} where the toolkit has no cuobjdump."""
    rep = sass_report(build_dir, sources=("flash_fwd", "flash_int3"),
                      keep=("fwd_kernel",))
    if not rep:
        return {}
    fwd = {k.split("<")[1].rstrip(">"): v
           for k, v in rep["flash_fwd"].items()}
    out = {}
    for name, e in rep["flash_int3"].items():
        args = name.split("<")[1].rstrip(">")
        d, _, _, vec, _ = args.split(",")
        f_bq, f_ns = (128, 3) if d == "64" else (64, 2)
        base = fwd[f"{d},{f_bq},{f_ns},{vec}"]
        f_int = sum(base["mix"].get(f, 0) for f in SNAP_INT_FAMILIES)
        own = sum(m_.get(f, 0) for m_ in e["outer"]
                  for f in SNAP_INT_FAMILIES)
        out[args] = dict(int_ops_a_score=own / INT3_SCORES
                         - f_int / (f_bq // 16 * 4), loops=e["outer"],
                         fwd_mix=base["mix"])
    return out


def int3_int_a_score(results, h: int, hv: int, t: int) -> float:
    """The int instructions a score of the row-9 entry the plan picks for
    16-byte copies at head dims h, hv over t keys (:func:`int3_int_ops`)."""
    from repro_torch.kernels import tiling
    plan = tiling.flash_int3_plan(h, hv, t)
    key = ",".join(str(x) for x in (
        64 if max(h, hv) <= 64 else 128, plan.block_q, plan.stages, plan.vec,
        int(plan.cache)))
    if key not in results["int3_sass"]:
        fail(f"no SASS count of row 9's entry {key}: its bound needs one")
    return results["int3_sass"][key]["int_ops_a_score"]


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
    for prec in ("int", "float"):
        check_repeat(f"softmax_rows {prec} (1024, 2048)",
                     lambda: ds.softmax_rows(x, prec))
    # the plan's edges (tiling.softmax_rows_plan): warp rows up to 1024,
    # block rows up to 8192, streamed past it; odd n and a pointer one
    # float off 16 bytes take the 4-byte loads
    for shape in ((3, 1), (4, 31), (4, 32), (5, 33), (9, 512), (6, 513),
                  (3, 1024), (3, 1025), (7, 2049), (3, 8192), (2, 8193),
                  (2, 70000)):
        xe = randn(*shape, scale=8.0)
        xe[0, :] = -30.0                                     # all masked row
        for off in (False, True) if shape[1] in (512, 8192) else (False,):
            xo = off_by_one_float(xe) if off else xe
            what = f"{shape}{' off 16 B' if off else ''}"
            check(f"softmax_rows int {what}", ds.softmax_rows(xo, "int"),
                  ds.softmax_rows_plain(xe, "int"), TOL_INT)
            check(f"softmax_rows float {what}",
                  ds.softmax_rows(xo, "float"),
                  ds.softmax_rows_plain(xe, "float"), TOL_SOFTMAX_F)
    plain = time_ms(lambda: ds.softmax_rows_plain(x, "int"), iters=10)
    n = x.numel()
    # int ops per element: 3 sweeps of quantize + log2-domain + PWL exp2
    # (~25 int ops each) plus the reductions; counted at the f32 rate
    b_ms, b_by = bound(8 * n, 80 * n)
    unit_ms = results.setdefault("unit_rows", {})
    ms = unit_row(unit_ms, "softmax_rows int (1024, 2048)",
                  lambda: ds.softmax_rows(x, "int"), b_ms)["ms"]
    lib = unit_row(unit_ms, "softmax_rows float (1024, 2048)",
                   lambda: ds.softmax_rows(x, "float"), bound(8 * n, 8 * n)[0],
                   lambda: torch.softmax(x, dim=-1), "torch.softmax")[
        "library_ms"]
    log(f"  softmax_rows (1024, 2048): plain int {plain * 1e3:.1f} us, "
        f"bound {b_ms * 1e3:.1f} us ({b_by})")
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
    # every S5.10 word (the one-exponent pair form against the plain
    # version's two exponents), on the 16-byte path with a 3-word tail and
    # on the 4-byte path (a pointer one float off 16 bytes)
    words = torch.arange(-32768, 32768 + 3, device=dev).remainder(65536)
    words = (words - 32768).to(torch.float32) / 1024
    for mode in ("silu", "gelu"):
        want = ds.pair_act_plain(words, mode, "int")
        check(f"pair_act {mode} int every S5.10 word",
              ds.pair_act(words, mode, "int"), want, TOL_INT)
        check(f"pair_act {mode} int every S5.10 word off 16 B",
              ds.pair_act(off_by_one_float(words), mode, "int"), want,
              TOL_INT)
    for mode in ("silu", "gelu"):
        check_repeat(f"pair_act {mode} int (64, 2816)",
                     lambda: ds.pair_act(z, mode, "int"))
    plain = time_ms(lambda: ds.pair_act_plain(z, "silu", "int"), iters=10)
    n = z.numel()
    b_ms, b_by = bound(8 * n, 60 * n)
    lib = None
    for mode, lib_name, lib_fn in (
            ("silu", "F.silu", lambda: torch.nn.functional.silu(z)),
            ("gelu", "F.gelu(tanh)",
             lambda: torch.nn.functional.gelu(z, approximate="tanh"))):
        for prec in ("int", "float"):
            r_ = unit_row(unit_ms, f"pair_act {mode} {prec} (64, 2816)",
                          lambda: ds.pair_act(z, mode, prec), b_ms,
                          lib_fn if prec == "float" else None, lib_name)
            if mode == "silu" and prec == "int":
                ms = r_["ms"]
            if mode == "silu" and prec == "float":
                lib = r_["library_ms"]
    log(f"  pair_act silu (64, 2816): plain int {plain * 1e3:.1f} us, bound "
        f"{b_ms * 1e3:.2f} us ({b_by})")
    log("[unit rows] qwen shapes: " + json.dumps(unit_ms))
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
    # the plan's split count at the path's shape (tiling.decode_splits: the
    # contiguous decodes' rule, capped at the 16 pages)
    plan_ns = tiling.decode_splits(16, 128, 4 * 16, dev)
    err_f = err_i = 0.0
    for g, grid in ((1, False), (1, True), (2, False), (4, True)):
        q, qf, kp, vp, tables, qp, valid = case(
            4, 16, g, 64, 128, 16, main_qpos if g == 1 else [5, 127, 128, 2047],
            grid=grid, sentinel_tail=(g > 1))
        args = (qf, kp, vp, tables, qp, valid)
        outs = {}
        for ns in (1, plan_ns):
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
        check(f"decode_paged split invariance G={g}", outs[("f", plan_ns)],
              outs[("f", 1)], TOL_DECODE_F)
        from repro_torch.core import softmax_unit as unit
        l1 = unit.online_finish_int(unit.online_merge_n_int(
            outs[("i", 1)][1][0][..., None], outs[("i", 1)][1][1],
            outs[("i", 1)][1][2], dim=1)[1])
        l_plan = unit.online_finish_int(unit.online_merge_n_int(
            outs[("i", plan_ns)][1][0][..., None], outs[("i", plan_ns)][1][1],
            outs[("i", plan_ns)][1][2], dim=1)[1])
        check(f"decode_paged_int split invariance l words G={g}", l_plan, l1,
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
    for ns in (1, 3, nblk):
        check(f"decode_paged_int identity-v acc splits={ns}",
              partials(True, args, ns, True, guard=0)[2],
              partials(False, args, ns, True, guard=0)[2], TOL_INT)

    # timing at the main path's shape, random inputs, at the plan's splits
    q, qf, kp, vp, tables, qp, valid = case(4, 16, 1, 64, 128, 16, main_qpos)
    args = (qf, kp, vp, tables, qp, valid)
    ns = plan_ns
    b_ms, b_by, visited = paged_bound(main_qpos, 16, 128, 16, 1, 64, 64, ns)
    k_dense = paged_gather(kp, tables).permute(0, 2, 1, 3)
    v_dense = paged_gather(vp, tables).permute(0, 2, 1, 3)
    mask = valid.bool()[:, None, None, :]
    q_sdpa = q[:, 0].reshape(4, 16, 1, 64)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_sdpa, k_dense, v_dense, attn_mask=mask))
    table = results.setdefault("paged_ms", {})
    for name, int_mode, e, lib_ms in (("decode_paged", False, err_f, lib),
                                      ("decode_paged_int", True, err_i, None)):
        r_ = paged_row(table, f"{name} qwen", fd, args, ns, int_mode, b_ms,
                       b_by, lib_ms, f"B4 K16 G1 h64 bs128 2048 keys, {ns} "
                       f"splits, {visited} pages")
        results[name] = dict(max_abs_err=e, ms=r_["ms"],
                             plain_ms=r_["plain_ms"], bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms)


def paged_bound(q_pos, nblk: int, bs: int, kh: int, g: int, h: int, hv: int,
                ns: int) -> tuple[float, str, int]:
    """Rows 3 / 4's bound at one causal call: the K and V rows and the
    kv_valid byte of each key the mask keeps (keys 0 .. q_pos; those past
    it in the last live page score MASK_VALUE whatever they hold, so the
    function needs neither their rows nor their products), read once, q,
    the live pages' table entries and the partials; 2 G (h + hv) flops a
    kept key and kv head.  Returns (ms, by, pages visited)."""
    b = len(q_pos)
    visited = sum(min(nblk, p // bs + 1) for p in q_pos if p >= 0)
    keys = sum(min(nblk * bs, p + 1) for p in q_pos if p >= 0)
    nbytes = (keys * kh * (h + hv) * 4 + b * kh * g * h * 4 + visited * 4
              + keys + b * 4 + b * ns * kh * g * (hv + 2) * 4)
    flops = keys * kh * g * (2 * h + 2 * hv)
    b_ms, b_by = bound(nbytes, flops)
    return b_ms, b_by, visited


def paged_row(table: dict, key: str, fd, args, ns: int, int_mode: bool,
              b_ms: float, b_by: str, lib_ms, shape: str) -> dict:
    """Rows 3 / 4 at one shape into ``table``: the partials wrapper back to
    back and under CUDA-graph replay, the same with the split fold, and the
    plain version; returns the entry."""
    def kern():
        return fd.decode_paged_partials(*args, num_splits=ns, causal=True,
                                        int_mode=int_mode, guard_shift=0)

    def folded():
        return fd.finish_partials(*kern(), int_mode=int_mode)
    r_ = kernel_row(table, key, kern, lambda: fd.decode_paged_partials_plain(
        *args, num_splits=ns, causal=True, int_mode=int_mode, guard_shift=0),
        b_ms, b_by, lib_ms, iters=50, plain_iters=3, splits=ns)
    r_.update(with_fold_ms=time_ms(folded),
              with_fold_graph_ms=graph_ms(folded))
    log(f"  {key} ({shape}): with its split fold "
        f"{r_['with_fold_ms'] * 1e3:.1f} us (graph "
        f"{r_['with_fold_graph_ms'] * 1e3:.1f})")
    return r_


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
        if eng.stats["numeric"]:
            fail(f"{name}: {eng.stats['numeric']} non-finite rows quarantined")
        for k in kernels:
            if counts[k] == 0:
                fail(f"{name}: kernel {k} never launched on its path")
        parity(cfg, params, dev, prompts[0])
    return params, prompts


# ---------------- phase 3b: serving under pressure ----------------

PRESSURE_NEW = 144       # past a 128-token block: every request grows
PRESSURE_POOL_FRAC = 0.5  # of a full slot complement's worst-case demand
# the pressure runs' depth: the first 8 of qwen's 24 layers at full
# width.  Preemption, swap and the stream rules do not depend on depth,
# and the six runs took ~250 s of the script's 1200 s limit at 24 layers
# (PERF.md section 6)
PRESSURE_LAYERS = 8
# The recompute rule, stated before the first chip run: a recompute
# resume writes the generated tokens' K/V through a 64-row chunk where
# decode wrote them through a 4-row tick, so their last bits may differ
# and a greedy token may flip at a near tie.  Identical streams are
# expected; where one diverges, the ample run's top-2 logit margin at the
# first divergent token must be under the full-width logit limit of the
# mode (the bound on how far an f32 summation order moves the logits),
# else the phase fails.  Swap restores the bytes it saved: no divergence.
RECOMPUTE_MARGIN = {"float": TOL_LOGITS_F, "dualmode": TOL_LOGITS_D}


def margin_spy(eng) -> dict:
    """Wrap ``eng``'s prefill and decode steps to record the top-2 logit
    margin of every token it samples: {(rid, token index): margin}."""
    margins: dict = {}
    decode, prefill = eng.decode_logits, eng.prefill_chunk_logits

    def top2(logits):
        t = logits.topk(2, dim=-1).values
        return (t[:, 0] - t[:, 1]).tolist()

    def decode_logits(tokens, pos, tables=None):
        logits = decode(tokens, pos, tables)
        m = top2(logits)
        for i, s in enumerate(eng._slots):
            if s.decoding:
                margins[(s.rid, len(s.prior_out) + len(s.out))] = m[i]
        return logits

    def prefill_chunk_logits(tokens, pos, tables, last_idx):
        _, i = min((s.seq, i) for i, s in enumerate(eng._slots)
                   if not s.free and s.prompt is not None)
        s = eng._slots[i]
        logits = prefill(tokens, pos, tables, last_idx)
        if pos + eng.prefill_chunk >= len(s.prompt):
            margins[(s.rid, len(s.prior_out))] = top2(logits)[0]
        return logits

    eng.decode_logits = decode_logits
    eng.prefill_chunk_logits = prefill_chunk_logits
    return margins


def tight_pool(tag: str, model: str, prompts, new: int) -> int:
    """Half the worst-case demand of 4 slots of ``prompts`` + ``new``
    tokens at max_seq 2048 (as faults._setup sizes it), with the
    sentinel; logs the pool."""
    from repro_torch.kernels import tiling
    bs = tiling.paged_block_size(2048)
    worst = max(tiling.cdiv(min(len(p) + new, 2048), bs) for p in prompts)
    tight = max(worst, int(PRESSURE_POOL_FRAC * 4 * worst)) + 1
    reach = [tiling.cdiv(len(p), bs) for p in prompts]
    log(f"[{tag}] {model} full width, max_seq 2048, block {bs}, 4 slots, "
        f"{len(prompts)} prompts of {[len(p) for p in prompts]} tokens "
        f"(reach {reach} blocks), {new} new each; tight pool {tight} "
        f"blocks with the sentinel (worst case {worst} a request)")
    return tight


def pressure_runs(tag: str, name: str, cfg, params, dev, prompts, new: int,
                  tight: int, kernels, launches, **engine_kw):
    """``prompts`` with ``new`` tokens each on an ample pool, then on
    ``tight`` blocks under preempt_mode 'recompute' and 'swap': every
    request finishes with all its tokens, the pool drains, nothing
    starves, each tight run preempts (the swap runs swap out and in) and
    launches every kernel of ``kernels``; swap streams equal the ample
    run's, and a recompute stream diverges only under the
    RECOMPUTE_MARGIN rule."""
    from repro_torch.kernels import _build
    from repro_torch.serve import Request, ServeEngine
    runs = {}
    for run, kw in (("ample", {}),
                    ("recompute", dict(num_blocks=tight)),
                    ("swap", dict(num_blocks=tight, preempt_mode="swap"))):
        eng = ServeEngine(cfg, params, device=dev, **engine_kw, **kw)
        margins = margin_spy(eng) if run == "ample" else None
        reqs = [Request(rid=i, prompt=p, max_new=new)
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
        st = eng.stats
        log(f"[{tag}] {name} {run}: {dt:.2f} s, "
            f"{st['decode_s'] * 1e3 / st['decode_steps']:.1f} ms/tick "
            f"({st['decode_steps']} ticks), "
            f"{st['prefill_s'] * 1e3 / st['prefill_chunks']:.1f} "
            f"ms/chunk ({st['prefill_chunks']} chunks); preemptions "
            f"{st['preemptions']}, resumes {st['resumes']}, swap "
            f"out/in {st['swap_outs']}/{st['swap_ins']} "
            f"({st['swap_bytes'] / 1e9:.3f} GB, {st['swap_s']:.3f} s), "
            f"hol_skips {st['hol_skips']}, blocked {st['admit_blocked']},"
            f" blocks_hwm {st['blocks_hwm']}; launches "
            f"{ {k: counts[k] for k in kernels} }")
        if any(len(outs.get(r.rid, [])) != new for r in reqs):
            fail(f"{tag} {name} {run}: unfinished requests "
                 f"{ {r: len(v) for r, v in outs.items()} }")
        if eng.pool.in_use() != 0 or st["starved"] or st["numeric"]:
            fail(f"{tag} {name} {run}: pool {eng.pool.in_use()}, "
                 f"starved {st['starved']}, numeric {st['numeric']}")
        for k in kernels:
            if counts[k] == 0:
                fail(f"{tag} {name} {run}: kernel {k} never launched on "
                     "its path")
        if run == "ample" and st["preemptions"]:
            fail(f"{tag} {name}: the ample pool preempted")
        if run != "ample" and not st["preemptions"]:
            fail(f"{tag} {name} {run}: the tight pool never preempted")
        if run == "swap" and not (st["swap_outs"] and st["swap_ins"]):
            fail(f"{tag} {name} swap: no swap out and in")
        runs[run] = (outs, margins)
        del eng
    ample, margins = runs["ample"]
    for run in ("recompute", "swap"):
        outs = runs[run][0]
        for rid in sorted(ample):
            a, b = ample[rid], outs[rid]
            if a == b:
                continue
            k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            m = margins[(rid, k)]
            log(f"[{tag}] {name} {run}: rid {rid} diverges at token {k} "
                f"({a[k]} vs {b[k]}); ample top-2 margin {m:.3e} (limit "
                f"{RECOMPUTE_MARGIN[name]:.0e})")
            if run == "swap" or m >= RECOMPUTE_MARGIN[name]:
                fail(f"{tag} {name} {run}: rid {rid} diverges at token {k} "
                     f"with a top-2 margin of {m:.3e}")
        log(f"  ok {name} {run}: streams "
            f"{'identical' if outs == ample else 'within the rule'} to the "
            "ample run's")
    torch.cuda.empty_cache()


def pressure_phase(dev, launches, params, prompts):
    """The serve phase's model (its first PRESSURE_LAYERS layers) and
    prompts, 144 new tokens each: an ample pool, then a pool of half the
    worst-case demand of 4 slots (as faults._setup sizes it) under
    preempt_mode 'recompute' and 'swap', float and dual-mode; then the
    chaos soak at full width and depth."""
    from repro_torch.configs import registry
    from repro_torch.serve import faults
    base = registry.get_config("qwen1.5-0.5b")
    tight = tight_pool("pressure", "qwen1.5-0.5b", prompts, PRESSURE_NEW)
    cut = base.replace(n_layers=PRESSURE_LAYERS)
    log(f"[pressure] depth {PRESSURE_LAYERS} of {base.n_layers} layers")
    cut_params = {**params, "layers": params["layers"][:PRESSURE_LAYERS]}
    for name, (sm, act, kernels) in PATHS.items():
        pressure_runs("pressure", name, cut.replace(softmax_impl=sm,
                                                    activation=act),
                      cut_params, dev, prompts, PRESSURE_NEW, tight, kernels,
                      launches, n_slots=4, max_seq=2048)
    cfg = base.replace(softmax_impl="float", activation="silu")
    for mode in ("recompute", "swap"):
        t0 = time.perf_counter()
        report = faults.chaos_soak(seed=0, preempt_mode=mode, device=dev,
                                   model=(cfg, params))
        log(f"[pressure] chaos soak float {mode}, full width, max_seq 64: "
            f"{'OK' if report['ok'] else 'FAIL'} in "
            f"{time.perf_counter() - t0:.1f} s; {report['injections']} "
            f"injections, affected {report['affected']}, reasons "
            f"{report['reasons']}, stats {report['stats']}")
        if not report["ok"]:
            fail(f"chaos soak {mode}: {report['violations']}")
        if not report["stats"]["preemptions"]:
            fail(f"chaos soak {mode}: no preemption")


def _plain_norm_provider():
    """The fused norm provider's seams, each replaced by its plain
    version (the kernels' oracles)."""
    from repro_torch.kernels import fused_norm as fn
    return {"residual_norm": fn.fused_residual_norm_plain,
            "norm_linear": fn.fused_norm_linear_plain,
            "norm_glu": fn.fused_norm_glu_plain}


def _plain_serve_kernels():
    """Patches that put the plain versions in the serve paths' kernels'
    place: the unit's row softmax and pair mode, the paged and contiguous
    decodes, the blocked float and snapped int flash, the WKV and
    selective scans, the fused norm seams and the fused GLU."""
    from contextlib import ExitStack

    from repro_torch.core import activations
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_ffn as ff

    def plain_glu(x, wg, wu, mode):
        return ff._glu_reference(x, wg, wu, mode)
    stack = ExitStack()
    stack.enter_context(mock.patch.object(dispatch, "softmax_rows",
                                          ds.softmax_rows_plain))
    stack.enter_context(mock.patch.object(activations, "pair_act",
                                          ds.pair_act_plain))
    from repro_torch.kernels import recurrence as rec
    from repro_torch.models import mamba, rwkv
    for mod, name, plain in (
            (fd, "decode_paged_partials", fd.decode_paged_partials_plain),
            (fd, "decode_dense_partials", fd.decode_dense_partials_plain),
            (fa, "flash_fwd", fa.flash_fwd_plain),
            (fai, "flash_snap", fai.flash_snap_plain),
            (rwkv, "wkv6", rec.wkv6_plain),
            (mamba, "selective_scan", rec.selective_scan_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    stack.enter_context(mock.patch.dict(
        dispatch._NORM, {"fused_pallas": _plain_norm_provider()}))
    stack.enter_context(mock.patch.dict(dispatch._FFN,
                                        {"fused_pallas": plain_glu}))
    return stack


def paged_step(cfg, params, dev, prompt, max_seq=2048) -> list:
    """One 64-token prefill chunk of ``prompt`` and the first decode step
    on a one-slot paged engine at full width: [(what, logits)]."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, n_slots=1, max_seq=max_seq, device=dev)
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
    del eng
    return [("prefill chunk", chunk), ("first decode step", dec)]


def parity(cfg, params, dev, prompt, max_seq=2048, tol_f=TOL_LOGITS_F):
    """One prefill chunk + the first decode step at full width, through
    the kernels and with the plain versions called in their place."""
    kern = paged_step(cfg, params, dev, prompt, max_seq)
    torch.cuda.empty_cache()
    with _plain_serve_kernels():
        plain = paged_step(cfg, params, dev, prompt, max_seq)
    torch.cuda.empty_cache()
    tol = tol_f if cfg.softmax_impl == "float" else TOL_LOGITS_D
    for (what, a), (_, b) in zip(kern, plain):
        check(f"{cfg.name} {cfg.softmax_impl} full-width logits, {what}", a,
              b, tol)


# ---------------- phase 4: long context ----------------

LONG = dict(max_seq=16384, n_slots=4, prefill_buckets=(512, 1024, 4096))
BUCKET = 4096            # the largest bucket: the prefill of the path's shape
PROMPT_LENS = (1000, 4000)
LONG_PATHS = {"float": ("float", "silu", "flash_pallas",
                        ("flash_fwd", "decode_dense")),
              "dualmode": ("dualmode", "silu_dualmode", "flash_pallas_int",
                           ("flash_snap", "decode_dense_int", "pair_act"))}


def long_kernel_phase(dev, results):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tiling
    gen = torch.Generator(device="cpu").manual_seed(4321)

    def randn(*shape, grid=False):
        x = torch.randn(shape, generator=gen)
        return (torch.round(x * 4) / 16 if grid else x).to(dev)

    def attn_case(b, s, t, kh, g, h, hv, q_pos, grid=False, ragged=False):
        qf = (randn(b, s, kh, g, h, grid=grid) * h ** -0.5).contiguous()
        k, v = randn(b, t, kh, h, grid=grid), randn(b, t, kh, hv)
        qp = torch.as_tensor(q_pos, dtype=torch.int32).to(dev).expand(
            b, s).contiguous()
        valid = torch.arange(t, device=dev)[None, :] <= qp.max()
        if ragged:
            valid = valid & (torch.rand(b, t, generator=gen) > 0.25).to(dev)
        return qf, k, v, qp, valid.expand(b, t).to(torch.uint8).contiguous()

    def identity_v(b, t, kh):
        return torch.eye(t, device=dev)[None, :, None, :].expand(
            b, t, kh, t).contiguous()

    # -- rows 7 / 8 at the path's shape: one bucket-4096 prefill of a
    #    16384-key row cache (keys past the prompt invalid), 16 heads, h 64
    log("[long] flash_fwd / flash_snap")
    S_, T_ = BUCKET, LONG["max_seq"]
    path = attn_case(1, S_, T_, 16, 1, 64, 64, torch.arange(S_))
    kw = dict(causal=True, block_kv=64)
    err_f = check(f"flash_fwd path (1, {S_}, 16, 1, 64) T {T_}",
                  fa.flash_fwd(*path, **kw), fa.flash_fwd_plain(*path, **kw),
                  TOL_FLASH_F)
    err_i = check("flash_snap path, random scores",
                  fai.flash_snap(*path, guard_shift=0, **kw),
                  fai.flash_snap_plain(*path, guard_shift=0, **kw),
                  TOL_FLASH_I)
    grid = attn_case(1, S_, T_, 16, 1, 64, 64, torch.arange(S_), grid=True)
    got = fai.flash_snap(*grid, guard_shift=0, return_partial=True, **kw)
    want_grid = fai.flash_snap_plain(*grid, guard_shift=0,
                                     return_partial=True, **kw)
    check("flash_snap path m words (exact scores)", got[1], want_grid[1],
          TOL_INT)
    check("flash_snap path S words (exact scores)", got[2], want_grid[2],
          TOL_INT)
    del grid, got, want_grid
    for (b, s, t, kh, g, h, hv, qpos, causal, bkv, ragged) in (
            (2, 70, 200, 2, 2, 64, 64, torch.arange(130, 200), True, 64,
             True),
            (1, 33, 129, 3, 4, 128, 72, torch.arange(96, 129), True, 16,
             True),
            (2, 64, 100, 1, 3, 32, 32, torch.arange(36, 100), False, 37,
             True),
            (2, 40, 300, 2, 2, 64, 64, torch.arange(40), True, 64, True)):
        args = attn_case(b, s, t, kh, g, h, hv, qpos, grid=True,
                         ragged=ragged)
        if qpos[0] == 0:        # row 0 sees only key 0, masked: the folded
            args[4][:, 0] = 0   # tail carries all of its mass
        ekw = dict(causal=causal, block_kv=bkv)
        name = f"({b},{s},{t},{kh},{g},{h},{hv}) causal={causal} bkv={bkv}"
        got = fa.flash_fwd(*args, return_stats=True, **ekw)
        want = fa.flash_fwd_plain(*args, return_stats=True, **ekw)
        check(f"flash_fwd out {name}", got[0], want[0], TOL_FLASH_F)
        check(f"flash_fwd m {name}", got[1], want[1], TOL_FLASH_F)
        check(f"flash_fwd l / plain l {name}", got[2] / want[2],
              torch.ones_like(want[2]), TOL_FLASH_F)
        got = fai.flash_snap(*args, guard_shift=0, return_partial=True,
                             **ekw)
        want = fai.flash_snap_plain(*args, guard_shift=0,
                                    return_partial=True, **ekw)
        check(f"flash_snap m {name}", got[1], want[1], TOL_INT)
        check(f"flash_snap S {name}", got[2], want[2], TOL_INT)
        check(f"flash_snap out {name}",
              fai.flash_snap(*args, guard_shift=0, **ekw),
              fai.flash_snap_plain(*args, guard_shift=0, **ekw), TOL_FLASH_F)
    # identity-v probe: every output is one exact probability word
    for causal, bkv in ((True, 64), (True, 16), (False, 64)):
        qf, k, _, qp, valid = attn_case(2, 40, 128, 2, 2, 64, 64,
                                        torch.arange(88, 128), grid=True,
                                        ragged=True)
        eye = identity_v(2, 128, 2)
        ekw = dict(causal=causal, block_kv=bkv, guard_shift=0)
        check(f"flash_snap identity-v causal={causal} bkv={bkv}",
              fai.flash_snap(qf, k, eye, qp, valid, **ekw),
              fai.flash_snap_plain(qf, k, eye, qp, valid, **ekw), TOL_INT)
    # 70000 keys: guard_shift 1 from the full extent
    long_row = attn_case(1, 64, 70000, 1, 1, 64, 64, torch.arange(
        69936, 70000), grid=True, ragged=True)
    gs = fai.unit.guard_shift_for(70000)
    if gs != 1:
        fail(f"guard shift for 70000 keys is {gs}, expected 1")
    for causal in (True, False):
        ekw = dict(causal=causal, block_kv=64, guard_shift=gs)
        got = fai.flash_snap(*long_row, return_partial=True, **ekw)
        want = fai.flash_snap_plain(*long_row, return_partial=True, **ekw)
        check(f"flash_snap 70000 keys S words causal={causal}", got[2],
              want[2], TOL_INT)
        check(f"flash_snap 70000 keys out causal={causal}",
              fai.flash_snap(*long_row, **ekw),
              fai.flash_snap_plain(*long_row, **ekw), TOL_FLASH_F)

    # the Hopper body's tile edges (S G and T one off 128 / 64), a causal
    # tail past one pre-pass chunk that carries all of a row's mass, q_pos <
    # 0, G 4 at h 128 with S G off 64, the 4-byte copies (h 30 / hv 62, and
    # a pointer one float off 16 bytes); two calls give the same bits.  Row
    # 8 on grid-valued q and k, its words bitwise
    edges = (
        (1, 127, 127, 2, 1, 64, 64, torch.arange(127), True, 64, False),
        (1, 43, 257, 2, 3, 64, 64, torch.arange(214, 257), True, 64, False),
        (2, 40, 1300, 2, 2, 64, 64, torch.arange(40), True, 64, True),
        (1, 20, 1100, 2, 1, 128, 128, torch.arange(-3, 17), True, 16, False),
        (1, 33, 129, 3, 4, 128, 72, torch.arange(96, 129), True, 16, False),
        (1, 67, 1601, 2, 4, 128, 128, torch.full((67,), 1600), False, 64,
         False),
        (1, 50, 90, 2, 3, 30, 62, torch.arange(40, 90), True, 37, False))
    for (b, s, t, kh, g, h, hv, qpos, causal, bkv, allm) in edges:
        name = (f"({b},{s},{t},{kh},{g},{h},{hv}) causal={causal} bkv={bkv} "
                f"all-masked row={allm}")
        args = attn_case(b, s, t, kh, g, h, hv, qpos, ragged=True)
        if allm:
            args[4][:, 0] = 0
        fwd_checks(fa, name, args, causal, bkv)
        args = attn_case(b, s, t, kh, g, h, hv, qpos, grid=True, ragged=True)
        if allm:
            args[4][:, 0] = 0
        snap_checks(fai, name, args, causal, bkv)
        snap_checks(fai, name + " pointers one float off 16 bytes",
                    tuple(off_by_one_float(x) for x in args[:3]) + args[3:],
                    causal, bkv)
    args = attn_case(1, 70, 200, 2, 2, 64, 64, torch.arange(130, 200),
                     ragged=True)
    fwd_checks(fa, "(1,70,200,2,2,64,64) pointers one float off 16 bytes",
               tuple(off_by_one_float(x) for x in args[:3]) + args[3:],
               True, 64)
    check_repeat(f"flash_fwd path (1, {S_}, 16, 1, 64) T {T_} repeat",
                 lambda: fa.flash_fwd(*path, **kw))

    # timing at the path's shape, random inputs
    pairs = S_ * (S_ + 1) // 2 * 16                 # causal (q, k) pairs
    keys = S_                                       # keys the causal run needs
    nbytes = (path[0].numel() * 4 * 2 + keys * 16 * 128 * 4 + S_ * 4
              + keys)
    b_ms, b_by = bound(nbytes, pairs * (4 * 64 + 4))
    # the library on the same work: the S_ live keys under its causal rule
    # (the keys past them score MASK_VALUE and carry no mass here)
    q_sdpa = path[0][0].permute(1, 2, 0, 3).reshape(1, 16, S_, 64)
    k_sdpa = path[1][:, :S_].permute(0, 2, 1, 3)
    v_sdpa = path[2][:, :S_].permute(0, 2, 1, 3)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q_sdpa, k_sdpa, v_sdpa, is_causal=True, scale=1.0)
    diff = (sdpa()[0].permute(1, 0, 2)[:, :, None]
            - fa.flash_fwd(*path, **kw)[0]).abs().max().item()
    lib = time_ms(sdpa, iters=10)
    log(f"  SDPA (causal, {S_} keys) vs flash_fwd: max abs diff {diff:.3g}")
    r_ = kernel_row(results.setdefault("flash_fwd_ms", {}),
                    f"path B1 S{S_} K16 G1 h64 T{T_} causal",
                    lambda: fa.flash_fwd(*path, **kw),
                    lambda: fa.flash_fwd_plain(*path, **kw), b_ms, b_by, lib,
                    plan=tuple(tiling.flash_fwd_plan(64, 64, causal=True)))
    results["flash_fwd"] = dict(max_abs_err=err_f, **{
        k_: r_[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")})
    # row 8: the same pairs and bytes, plus the int instructions a score
    # its entry adds (counted from its SASS) at the f32 rate
    n_int = snap_int_a_score(results, 64, 64, True)
    check_repeat(f"flash_snap path (1, {S_}, 16, 1, 64) T {T_} repeat",
                 lambda: fai.flash_snap(*path, guard_shift=0, **kw))
    r_ = kernel_row(results.setdefault("flash_snap_ms", {}),
                    f"path B1 S{S_} K16 G1 h64 T{T_} causal",
                    lambda: fai.flash_snap(*path, guard_shift=0, **kw),
                    lambda: fai.flash_snap_plain(*path, guard_shift=0, **kw),
                    *bound(nbytes, pairs * (4 * 64 + 4 + n_int)), None,
                    int_ops_a_score=n_int,
                    plan=tuple(tiling.flash_fwd_plan(64, 64, causal=True)))
    results["flash_snap"] = dict(max_abs_err=err_i, **{
        k_: r_[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")})

    # -- rows 5 / 6 at the path's shape: 4 slots of a 16384-key cache at
    #    depths within 1000-4016
    log("[long] decode_dense / decode_dense_int")

    def dec_case(b, t, kh, g, h, q_pos, grid=False, hv=None):
        qf = (randn(b, kh, g, h, grid=grid) * h ** -0.5).contiguous()
        k, v = randn(b, t, kh, h, grid=grid), randn(b, t, kh, hv or h)
        qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
        valid = (torch.arange(t, device=dev)[None, :] <= qp[:, None]).to(
            torch.uint8)
        return qf, k, v, qp, valid

    def dparts(kern, args, ns, bkv, int_mode):
        fn = fd.decode_dense_partials if kern else \
            fd.decode_dense_partials_plain
        return fn(*args, num_splits=ns, block_kv=bkv, causal=True,
                  int_mode=int_mode, guard_shift=fai.unit.guard_shift_for(
                      args[1].shape[1]))

    main_qpos = [x * BUCKET // 4096 for x in (1100, 2500, 3900, 4015)]
    # the (splits, tile) the path's wrappers pick (the plan's, float and
    # int), then fewer splits, and the 3 splits of 128 keys of the old int
    # rule
    ns, bkv = fd.dense_decode_tiles(T_, 4 * 16, dev)
    grids = ((ns, bkv), (1, bkv), (8, bkv), (3, 128))
    err_f = err_i = 0.0
    for g, grid_v in ((1, False), (1, True), (2, False), (4, True)):
        args = dec_case(4, T_, 16 // g, g, 64, main_qpos, grid=grid_v)
        for n_s, bk in grids:
            pk = dparts(True, args, n_s, bk, False)
            pp = dparts(False, args, n_s, bk, False)
            e = check(f"decode_dense G={g} grid={grid_v} splits={n_s} "
                      f"bkv={bk}", fd.finish_partials(*pk, int_mode=False),
                      fd.finish_partials(*pp, int_mode=False), TOL_DECODE_F)
            if g == 1 and not grid_v:
                err_f = max(err_f, e)
            ik = dparts(True, args, n_s, bk, True)
            ip = dparts(False, args, n_s, bk, True)
            if grid_v:
                check(f"decode_dense_int m G={g} splits={n_s} bkv={bk}",
                      ik[0], ip[0], TOL_INT)
                check(f"decode_dense_int S G={g} splits={n_s} bkv={bk}",
                      ik[1], ip[1], TOL_INT)
            e = check(f"decode_dense_int out G={g} grid={grid_v} "
                      f"splits={n_s} bkv={bk}",
                      fd.finish_partials(*ik, int_mode=True),
                      fd.finish_partials(*ip, int_mode=True), TOL_DECODE_I)
            if g == 1 and not grid_v:
                err_i = max(err_i, e)
    # ragged last tile, identity-v probe for the int accumulator words
    qf, k, _, qp, valid = dec_case(3, 120, 2, 2, 64, [5, 70, 119], grid=True)
    eye = identity_v(3, 120, 2)
    for n_s, bk in ((1, 16), (3, 16), (2, 128)):
        check(f"decode_dense_int identity-v acc splits={n_s} bkv={bk}",
              dparts(True, (qf, k, eye, qp, valid), n_s, bk, True)[2],
              dparts(False, (qf, k, eye, qp, valid), n_s, bk, True)[2],
              TOL_INT)
    # rows 5 / 6's edges: G 4 at h 128 with hv 96 and T off 64, q_pos < 0,
    # splits with no tile, block_kv 16 / 37, non-causal, G 8, the 4-byte
    # copies (h 30 / hv 62, and pointers one float off 16 bytes); each
    # split's m and the folded outputs against the plain version, row 6 on
    # grid-valued q and k with its m and S words bitwise
    for (b, t, kh, g, h, hv, qpos, causal, n_s, bk) in (
            (3, 1000, 2, 4, 128, 96, [-1, 500, 999], True, 8, 64),
            (4, 600, 2, 1, 64, 64, [5, 127, 300, 599], True, 40, 16),
            (2, 333, 2, 4, 128, 128, [0, 0], False, 7, 64),
            (2, 190, 3, 3, 30, 62, [100, 189], True, 4, 37),
            (2, 120, 2, 8, 128, 96, [70, 119], True, 2, 37)):
        valid_ = (torch.rand(b, t, generator=gen) > 0.25).to(torch.uint8).to(
            dev)
        for int_mode in (False, True):
            qf_, k_, v_, qp_, _ = dec_case(b, t, kh, g, h, qpos, hv=hv,
                                           grid=int_mode)
            for off in (False, True):
                ops = (qf_, k_, v_)
                if off:
                    ops = tuple(off_by_one_float(x) for x in ops)
                dkw = dict(num_splits=n_s, block_kv=bk, causal=causal,
                           int_mode=int_mode,
                           guard_shift=fai.unit.guard_shift_for(t))
                pk = fd.decode_dense_partials(*ops, qp_, valid_, **dkw)
                pp = fd.decode_dense_partials_plain(*ops, qp_, valid_, **dkw)
                name = (f"({b},{t},{kh},{g},{h},{hv}) q_pos {qpos} causal="
                        f"{causal} splits={n_s} bkv={bk} pointers off={off}")
                kern = "decode_dense_int" if int_mode else "decode_dense"
                if int_mode:
                    check(f"{kern} S {name}", pk[1], pp[1], TOL_INT)
                check(f"{kern} m {name}", pk[0], pp[0],
                      TOL_INT if int_mode else TOL_DECODE_F)
                check(f"{kern} {name}",
                      fd.finish_partials(*pk, int_mode=int_mode),
                      fd.finish_partials(*pp, int_mode=int_mode),
                      TOL_DECODE_F)

    args = dec_case(4, T_, 16, 1, 64, main_qpos)
    for int_mode in (False, True):
        check_repeat(f"decode_dense int_mode={int_mode} path B4 K16 G1 h64 "
                     f"T{T_} repeat", lambda: torch.cat(
                         [x.flatten().to(torch.float32) for x in dparts(
                             True, args, ns, bkv, int_mode)]))
    keys = sum(p + 1 for p in main_qpos)

    def dec_bound(n_s, int_mode):
        state = 17 if int_mode else 2      # m and S[16], or m and l
        nbytes = (keys * 16 * 128 * 4 + keys + args[0].numel() * 4 + 4 * 4
                  + 4 * n_s * 16 * (64 + state) * 4)
        return bound(nbytes, keys * 16 * (4 * 64 + 4))
    # the library on the same keys: the deepest slot's, masked per row
    live = max(main_qpos) + 1
    q_sdpa = args[0].reshape(4, 16, 1, 64)
    k_sdpa = args[1][:, :live].permute(0, 2, 1, 3)
    v_sdpa = args[2][:, :live].permute(0, 2, 1, 3)
    mask = args[4][:, :live].bool()[:, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q_sdpa, k_sdpa, v_sdpa, attn_mask=mask, scale=1.0)
    diff = (sdpa().reshape(4, 1, 16, 1, 64) - fd.finish_partials(
        *dparts(True, args, ns, bkv, False), int_mode=False)).abs().max()
    lib = time_ms(sdpa)
    log(f"  SDPA ({live} keys, masked) vs decode_dense: max abs diff "
        f"{diff.item():.3g}")
    for name, int_mode, err in (("decode_dense", False, err_f),
                                ("decode_dense_int", True, err_i)):
        fold = time_ms(lambda: fd.finish_partials(
            *dparts(True, args, ns, bkv, int_mode), int_mode=int_mode))
        r_ = kernel_row(results.setdefault(f"{name}_ms", {}),
                        f"path B4 K16 G1 h64 T{T_} depths {main_qpos}",
                        lambda: dparts(True, args, ns, bkv, int_mode),
                        lambda: dparts(False, args, ns, bkv, int_mode),
                        *dec_bound(ns, int_mode), None if int_mode else lib,
                        iters=50, plain_iters=3, splits=ns, block_kv=bkv,
                        with_fold_ms=fold)
        results[name] = dict(max_abs_err=err, **{
            k_: r_[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")})
    # how the kernels' times move with the split count at the plan's tile,
    # and at the old int rule's 3 splits of 128 keys
    for int_mode in (False, True):
        times = {f"{n_s}x{bk}": (
            time_ms(lambda: dparts(True, args, n_s, bk, int_mode)),
            time_ms(lambda: fd.finish_partials(*dparts(
                True, args, n_s, bk, int_mode), int_mode=int_mode)))
            for n_s, bk in ((3, 128), (8, bkv), (ns, bkv), (32, bkv),
                            (64, bkv))}
        log(f"  decode_dense int_mode={int_mode} splits x tile: " + ", ".join(
            f"{k_} {a * 1e3:.1f} us (+fold {b_ * 1e3:.1f} us total)"
            for k_, (a, b_) in times.items()))
    # the whole float wrapper as a tick calls it (plan, kernel, fold) at
    # the old int rule's 3 splits and at the plan's, in turns: host time a
    # call (issuing the calls, the card not waited on) and wall time a call
    q5, qp5 = args[0][:, None], args[3][:, None]
    wrap = {}
    for n_s in (3, ns, 3, ns):
        wrap.setdefault(n_s, []).append(host_ms(lambda: fd.flash_decode_pallas(
            q5, args[1], args[2], q_pos=qp5, kv_valid=args[4], scale=1.0,
            num_splits=n_s)))
    results["decode_dense_wrapper_ms"] = {
        f"{n_s} splits": x for n_s, x in wrap.items()}
    log("  flash_decode_pallas float, host / wall us a call: " + ", ".join(
        f"{n_s} splits " + " then ".join(
            f"{h_ * 1e3:.1f} / {w_ * 1e3:.1f}" for h_, w_ in x)
        for n_s, x in wrap.items()))


def long_serve_phase(dev, launches):
    from repro_torch.configs import registry
    from repro_torch.kernels import _build, dispatch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Request, ServeEngine
    base = registry.get_config("qwen1.5-0.5b")
    for sm in ("float", "dualmode"):
        got = dispatch.resolve_attention("auto", BUCKET, LONG["max_seq"], sm,
                                         device=dev)
        if got == "flash":
            fail(f"'auto' resolved to the plain 'flash' on the card ({sm})")
    params = init_lm(base, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.RandomState(1)
    lens = rng.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=6)
    prompts = [rng.randint(0, base.vocab, size=n).tolist() for n in lens]
    for name, (sm, act, prefill_impl, kernels) in LONG_PATHS.items():
        cfg = base.replace(softmax_impl=sm, activation=act)
        eng = ServeEngine(cfg, params, cache_mode="contiguous", device=dev,
                          **LONG)
        if (eng.prefill_attn_impl, eng.decode_attn_impl) != (
                prefill_impl, "flash_decode"):
            fail(f"long {name}: resolved prefill {eng.prefill_attn_impl}, "
                 f"decode {eng.decode_attn_impl}")
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
            if k.startswith(("flash", "decode_dense")):
                launches[k] = launches.get(k, 0) + counts[k]
        new = sum(len(v) for v in outs.values())
        st = eng.stats
        log(f"[long] {name}: {len(outs)}/{len(reqs)} requests, {new} new "
            f"tokens, prompts {int(lens.sum())} tokens, {dt:.2f} s; prefill "
            f"{st['prefill_s'] * 1e3:.0f} ms in {st['prefills']} prefills "
            f"({st['prefill_s'] * 1e3 / max(st['prefills'], 1):.1f} ms each, "
            f"{int(lens.sum()) / st['prefill_s']:.0f} prompt tok/s), decode "
            f"{st['decode_s'] * 1e3:.0f} ms in {st['decode_steps']} ticks "
            f"({st['decode_s'] * 1e3 / max(st['decode_steps'], 1):.1f} "
            f"ms/tick, {new / st['decode_s']:.1f} tok/s), cache copies "
            f"{st['cache_copies']}; launches {counts}")
        if not all(len(outs.get(r.rid, [])) == 16 for r in reqs):
            fail(f"long {name}: unfinished requests")
        if st["numeric"]:
            fail(f"long {name}: {st['numeric']} non-finite rows quarantined")
        for k in kernels:
            if counts[k] == 0:
                fail(f"long {name}: kernel {k} never launched on its path")
        del eng
        torch.cuda.empty_cache()
        long_parity(cfg, params, dev, prompts[int(np.argmax(lens))])


def long_parity(cfg, params, dev, prompt):
    """One bucket-4096 prefill into a 16384-key row and the first decode
    step, through the kernels and with the plain versions in their place."""
    from repro_torch.core import activations
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.transformer import init_caches
    from repro_torch.serve import ServeEngine

    def step():
        eng = ServeEngine(cfg, params, cache_mode="contiguous", n_slots=1,
                          max_seq=LONG["max_seq"], prefill_buckets=(BUCKET,),
                          device=dev)
        row = init_caches(cfg, 1, LONG["max_seq"], dev)
        toks = torch.tensor([prompt + [0] * (BUCKET - len(prompt))],
                            device=dev)
        pre = eng.prefill_logits(toks, row, torch.tensor(
            [len(prompt) - 1], device=dev))
        eng.caches = row
        nxt = torch.argmax(pre, dim=-1)[:, None]
        dec = eng.decode_logits(nxt, torch.tensor(
            [len(prompt)], dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        del eng, row
        return pre, dec

    kern = step()
    torch.cuda.empty_cache()
    with mock.patch.object(fa, "flash_fwd", fa.flash_fwd_plain), \
            mock.patch.object(fai, "flash_snap", fai.flash_snap_plain), \
            mock.patch.object(fd, "decode_dense_partials",
                              fd.decode_dense_partials_plain), \
            mock.patch.object(activations, "pair_act", ds.pair_act_plain):
        plain = step()
    torch.cuda.empty_cache()
    tol = TOL_LOGITS_F if cfg.softmax_impl == "float" else TOL_LOGITS_D
    for what, a, b in ((f"bucket-{BUCKET} prefill", kern[0], plain[0]),
                       ("first decode step", kern[1], plain[1])):
        check(f"{cfg.softmax_impl} long-context logits, {what}", a, b, tol)


# ---------------- phase 5: yi-6b, the block's fused seams ----------------

YI = dict(max_seq=4096, n_slots=4, prefill_chunk=64)
YI_PROMPT_LENS = (200, 3000)
FUSED = dict(norm_impl="fused_pallas", ffn_impl="fused_pallas")
YI_PATHS = {"float": (dict(softmax_impl="float", activation="silu", **FUSED),
                      ("resnorm", "norm_linear", "glu", "decode_paged")),
            "dualmode": (dict(softmax_impl="dualmode",
                              activation="silu_dualmode", **FUSED),
                         ("resnorm", "norm_linear", "softmax_rows",
                          "pair_act", "decode_paged_int"))}
YI_NEW = ("resnorm", "norm_linear", "glu")   # the kernels this phase ports


def yi_kernel_phase(dev, results):
    from repro_torch.kernels import _build
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_norm as fn
    from repro_torch.kernels import tiling
    from repro_torch.models.attention import paged_gather
    gen = torch.Generator(device="cpu").manual_seed(2024)
    eps = 1e-6

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    d, nq, nk, dff = 4096, 4096, 512, 11008
    # -- row 14: residual add + norm epilogue
    log("[yi] resnorm")
    err = 0.0
    for m, dd, kind in ((4, d, "rms"), (64, d, "rms"), (1, 1, "rms"),
                        (37, 200, "layer"), (64, d, "layer"),
                        (5, 14000, "rms")):
        x, r = randn(m, dd, scale=3.0), randn(m, dd)
        g = 1.0 + randn(dd, scale=0.1)
        b = randn(dd, scale=0.1) if kind == "layer" else None
        got = fn.fused_residual_norm(x, r, g, b, kind=kind, eps=eps)
        want = fn.fused_residual_norm_plain(x, r, g, b, kind=kind, eps=eps)
        check(f"resnorm sum {kind} ({m}, {dd})", got[0], want[0], TOL_INT)
        e = check(f"resnorm h {kind} ({m}, {dd})", got[1], want[1], TOL_NORM)
        if dd == d and kind == "rms":
            err = max(err, e)
    x, r, g = randn(64, d, scale=3.0), randn(64, d), 1.0 + randn(d, scale=0.1)
    unit_ms = {}
    for m in (4, 64):
        xs, rs = x[:m].contiguous(), r[:m].contiguous()
        plain = time_ms(lambda: fn.fused_residual_norm_plain(
            xs, rs, g, kind="rms", eps=eps))
        b_ms, b_by = bound(4 * m * d * 4 + d * 4, 8 * m * d)

        def two_calls():       # no one PyTorch call adds and normalizes
            s_ = torch.add(xs, rs)
            return s_, torch.nn.functional.rms_norm(s_, (d,), g, eps)
        r_ = unit_row(unit_ms, f"resnorm rms M{m} d{d}",
                      lambda: fn.fused_residual_norm(xs, rs, g, kind="rms",
                                                     eps=eps),
                      b_ms, two_calls, "torch.add + F.rms_norm (two calls)")
        log(f"  resnorm rms M{m} d{d}: plain {plain * 1e3:.2f} us, bound "
            f"{b_ms * 1e3:.2f} us ({b_by})")
        r_["plan"] = tuple(tiling.resnorm_plan(d))
        if m == 64:
            # library_ms stays None: no single PyTorch call computes row 14
            results["resnorm"] = dict(max_abs_err=err, ms=r_["ms"],
                                      plain_ms=plain, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=None)
    log("[unit rows] yi shapes: " + json.dumps(unit_ms))
    # the wrapper's host time by part at a decode tick (M 4), µs a call to
    # issue: the route without and with the autograd Function, and the
    # parts of _resnorm_fwd around the kernel
    xs, rs_ = x[:4].contiguous(), r[:4].contiguous()
    xo_, ho_ = torch.empty_like(xs), torch.empty_like(xs)
    plan = tiling.resnorm_plan(d)
    call = (xs.data_ptr(), rs_.data_ptr(), g.data_ptr(), None, xo_.data_ptr(),
            ho_.data_ptr(), 4, d, 0, eps, plan.row_threads, plan.words,
            plan.vec, _build.stream_ptr(dev))
    parts = {
        "fused_residual_norm": lambda: fn.fused_residual_norm(
            xs, rs_, g, kind="rms", eps=eps),
        "_ResidualNorm.apply": lambda: fn._ResidualNorm.apply(
            xs, rs_, g, None, "rms", eps),
        "_check": lambda: fn._check("fused_residual_norm", "rms", x=xs,
                                    r=rs_, g=g, b=None),
        "two empty_like": lambda: (torch.empty_like(xs),
                                   torch.empty_like(xs)),
        "plan": lambda: tiling.resnorm_plan(
            d, tiling.aligned16(xs, rs_, g, None, xo_, ho_)),
        "stream_ptr": lambda: _build.stream_ptr(dev),
        "ctypes call": lambda: fn.RESNORM(*call)}
    log("[resnorm host] us a call to issue, M4 d4096: " + json.dumps(
        {k_: 1e3 * host_ms(f_, iters=200, warmup=20)[0]
         for k_, f_ in parts.items()}))

    # -- row 15: norm -> QKV prologue over [wq | wk | wv] read in place
    log("[yi] norm_linear")
    err = 0.0
    for m, dd, widths, kind in ((4, d, (nq, nk, nk), "rms"),
                                (64, d, (nq, nk, nk), "rms"),
                                (64, d, (nq, nk, nk), "layer"),
                                (23, 200, (130, 17, 40), "rms"),
                                (100, 72, (5,), "layer"),
                                (1, 33, (64, 64), "rms")):
        x = randn(m, dd)
        g = 1.0 + randn(dd, scale=0.1)
        b = randn(dd, scale=0.1) if kind == "layer" else None
        ws = [randn(dd, n, scale=dd ** -0.5) for n in widths]
        e = check(f"norm_linear {kind} ({m}, {dd}) x {widths}",
                  fn.fused_norm_linear(x, g, b, ws, kind=kind, eps=eps),
                  fn.fused_norm_linear_plain(x, g, b, ws, kind=kind, eps=eps),
                  TOL_GEMM)
        if dd == d and kind == "rms":
            err = max(err, e)
    x, g = randn(64, d), 1.0 + randn(d, scale=0.1)
    ws = [randn(d, n, scale=d ** -0.5) for n in (nq, nk, nk)]
    wcat = torch.cat(ws, dim=1)
    f = wcat.shape[1]
    for m in (4, 64):
        xs = x[:m].contiguous()
        check_repeat(f"norm_linear rms ({m}, {d}) x {f} repeat",
                     lambda: fn.fused_norm_linear(xs, g, None, ws, kind="rms",
                                                  eps=eps))
        ms = time_ms(lambda: fn.fused_norm_linear(xs, g, None, ws, kind="rms",
                                                  eps=eps), iters=20)
        plain = time_ms(lambda: fn.fused_norm_linear_plain(
            xs, g, None, ws, kind="rms", eps=eps), iters=20)
        h = fn._scaled(xs, g, None, kind="rms", eps=eps)
        lib = time_ms(lambda: torch.matmul(h, wcat), iters=20)
        b_ms, b_by = bound((m * d + d * f + m * f + d) * 4,
                           2 * m * d * f + 5 * m * d)
        log(f"  norm_linear rms M{m} d{d} F{f}: {ms * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, torch.matmul on the normed rows "
            f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by})")
        norm_gemm_row(results, f"norm_linear yi M{m} d{d} F{f}", ms, plain,
                      b_ms, b_by, lib,
                      lambda: fn.fused_norm_linear(xs, g, None, ws, kind="rms",
                                                   eps=eps),
                      lambda: torch.matmul(h, wcat))
        if m == 64:
            results["norm_linear"] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=plain, bound_ms=b_ms,
                                          bound_by=b_by, library_ms=lib)

    # -- row 12: the fused GLU
    log("[yi] glu")
    err = 0.0
    for m, k, f, mode in ((4, d, dff, "silu"), (64, d, dff, "silu"),
                          (64, d, dff, "gelu"), (23, 200, 130, "silu"),
                          (1, 64, 1, "gelu"), (70, 37, 33, "silu")):
        x = randn(m, k)
        wg, wu = randn(k, f, scale=k ** -0.5), randn(k, f, scale=k ** -0.5)
        e = check(f"glu {mode} ({m}, {k}) x {f}",
                  ff.fused_glu(x, wg, wu, mode=mode),
                  ff._glu_reference(x, wg, wu, mode), TOL_GEMM)
        if k == d and mode == "silu":
            err = max(err, e)
    x = randn(64, d)
    wg, wu = randn(d, dff, scale=d ** -0.5), randn(d, dff, scale=d ** -0.5)
    for m in (4, 64):
        xs = x[:m].contiguous()
        check_repeat(f"glu silu ({m}, {d}) x {dff} repeat",
                     lambda: ff.fused_glu(xs, wg, wu, mode="silu"))
        ms, plain, b_ms, b_by, lib = glu_times(
            results, f"glu yi M{m} d{d} F{dff}", xs, wg, wu, iters=20)
        if m == 64:
            results["glu"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib)
    # the K split of the chunk's 172 column tiles, each split count under
    # graph replay (the plan's rule picks one of them)
    plan = tiling.norm_gemm_plan(64, d, (dff,), glu=True)
    probe = {}
    for split in (1, 2, 3, 4, 6, 8):
        forced = plan._replace(split=split)
        with mock.patch.object(tiling, "norm_gemm_plan",
                               lambda *a, f_=forced, **k_: f_):
            probe[split] = graph_ms(
                lambda: ff.fused_glu(x, wg, wu, mode="silu")) * 1e3
    log(f"[glu split probe] M64 d{d} F{dff}, plan split {plan.split}, us "
        "under graph replay by split: " + json.dumps(probe))

    # -- rows 1-4 at yi's shapes: h 128, G 8 (4 kv heads of 8 query heads)
    log("[yi] unit and paged decode kernels at h 128, G 8")
    sc = randn(2048, 4096, scale=3.0)        # 32 heads x 64 queries
    qpos = torch.arange(2048, device=dev) % 64 + 2000
    sc = torch.where(torch.arange(4096, device=dev)[None, :] <= qpos[:, None],
                     sc, torch.full_like(sc, -30.0))
    check("softmax_rows int (2048, 4096)", ds.softmax_rows(sc, "int"),
          ds.softmax_rows_plain(sc, "int"), TOL_INT)
    z = randn(64, dff, scale=3.0)
    for mode in ("silu", "gelu"):
        check(f"pair_act {mode} int (64, {dff})", ds.pair_act(z, mode, "int"),
              ds.pair_act_plain(z, mode, "int"), TOL_INT)
    b_, kh, g_, h_, bs, nblk = 4, 4, 8, 128, 128, 32
    n_pool = 1 + b_ * nblk
    ids = (torch.randperm(n_pool - 1, generator=gen) + 1).reshape(b_, nblk)
    tables = ids.to(torch.int32).to(dev)
    yi_qpos = [250, 1300, 2900, 4095]
    qp = torch.tensor(yi_qpos, dtype=torch.int32, device=dev)
    valid = (torch.arange(nblk * bs, device=dev)[None, :]
             <= qp[:, None]).to(torch.uint8)
    # the plan's split count at yi's tick (16 on 132 SMs)
    ns = tiling.decode_splits(nblk, bs, b_ * kh, dev)
    for grid in (False, True):
        q = randn(b_, kh, g_, h_)
        kp = randn(n_pool, bs, kh, h_)
        if grid:         # multiples of 2^-4: exact scores
            q, kp = torch.round(q * 4) / 16, torch.round(kp * 4) / 16
        vp = randn(n_pool, bs, kh, h_)
        args = ((q * h_ ** -0.5).contiguous(), kp, vp, tables, qp, valid)
        for n_s in sorted({1, 8, ns}):
            kw = dict(num_splits=n_s, causal=True, guard_shift=0)
            check(f"decode_paged G8 h128 grid={grid} splits={n_s}",
                  fd.finish_partials(*fd.decode_paged_partials(
                      *args, int_mode=False, **kw), int_mode=False),
                  fd.finish_partials(*fd.decode_paged_partials_plain(
                      *args, int_mode=False, **kw), int_mode=False),
                  TOL_DECODE_F)
            ik = fd.decode_paged_partials(*args, int_mode=True, **kw)
            ip = fd.decode_paged_partials_plain(*args, int_mode=True, **kw)
            if grid:
                check(f"decode_paged_int m G8 h128 splits={n_s}", ik[0],
                      ip[0], TOL_INT)
                check(f"decode_paged_int S G8 h128 splits={n_s}", ik[1],
                      ip[1], TOL_INT)
            check(f"decode_paged_int out G8 h128 grid={grid} splits={n_s}",
                  fd.finish_partials(*ik, int_mode=True),
                  fd.finish_partials(*ip, int_mode=True), TOL_DECODE_I)
    b_ms, b_by, visited = paged_bound(yi_qpos, nblk, bs, kh, g_, h_, h_, ns)
    # row 3's library call: SDPA over the gathered cache with the per-row
    # mask, the G query heads of a kv head as its query rows
    k_dense = paged_gather(kp, tables).permute(0, 2, 1, 3)
    v_dense = paged_gather(vp, tables).permute(0, 2, 1, 3)
    mask = valid.bool()[:, None, None, :]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        args[0], k_dense, v_dense, attn_mask=mask, scale=1.0))
    for name, int_mode in (("decode_paged", False),
                           ("decode_paged_int", True)):
        paged_row(results.setdefault("paged_ms", {}), f"{name} yi", fd, args,
                  ns, int_mode, b_ms, b_by, None if int_mode else lib,
                  f"B4 K4 G8 h128 bs128 4096 keys, {ns} splits, {visited} "
                  "pages")
    del k_dense, v_dense


def yi_serve_phase(dev, launches):
    import gc

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Request, ServeEngine
    gc.collect()                    # the qwen phases' weights and pools
    torch.cuda.empty_cache()
    base = registry.get_config("yi-6b")
    t0 = time.perf_counter()
    params = init_lm(base, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    log(f"[yi] yi-6b full width: {base.n_layers} layers d {base.d_model} "
        f"heads {base.n_heads}/{base.n_kv_heads} h {base.hd} d_ff "
        f"{base.d_ff} vocab {base.vocab}; init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB allocated")
    rng = np.random.RandomState(2)
    lens = rng.randint(YI_PROMPT_LENS[0], YI_PROMPT_LENS[1] + 1, size=6)
    prompts = [rng.randint(0, base.vocab, size=n).tolist() for n in lens]
    for name, (over, kernels) in YI_PATHS.items():
        cfg = base.replace(**over)
        eng = ServeEngine(cfg, params, device=dev, **YI)
        if eng.decode_attn_impl != "flash_decode":
            fail(f"yi {name}: decode resolved {eng.decode_attn_impl}")
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
        for k in YI_NEW:
            launches[k] = launches.get(k, 0) + counts[k]
        new = sum(len(v) for v in outs.values())
        st = eng.stats
        log(f"[yi] {name}: {len(outs)}/{len(reqs)} requests, {new} new "
            f"tokens, prompts {int(lens.sum())} tokens, {dt:.2f} s "
            f"({(new + int(lens.sum())) / dt:.0f} tok/s all, "
            f"{new / st['decode_s']:.1f} tok/s decode); prefill "
            f"{st['prefill_s'] * 1e3:.0f} ms in {st['prefill_chunks']} chunks "
            f"({st['prefill_s'] * 1e3 / st['prefill_chunks']:.1f} ms/chunk), "
            f"decode {st['decode_s'] * 1e3:.0f} ms in {st['decode_steps']} "
            f"ticks ({st['decode_s'] * 1e3 / st['decode_steps']:.1f} ms/tick);"
            f" peak {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB; "
            f"launches {counts}")
        if not all(len(outs.get(r.rid, [])) == 16 for r in reqs):
            fail(f"yi {name}: unfinished requests")
        if eng.pool.in_use() != 0:
            fail(f"yi {name}: pool did not drain ({eng.pool.in_use()} blocks)")
        if st["numeric"]:
            fail(f"yi {name}: {st['numeric']} non-finite rows quarantined")
        for k in kernels:
            if counts[k] == 0:
                fail(f"yi {name}: kernel {k} never launched on its path")
        del eng
        torch.cuda.empty_cache()
        parity(cfg, params, dev, prompts[0], max_seq=YI["max_seq"],
               tol_f=TOL_YI_LOGITS_F)


# ---------------- phase 6: training ----------------

TRAIN = dict(batch=2, seq=4096, steps=8, data_vocab=8192)
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "resnorm",
                 "glu", "glu_bwd")
# launches one remat step implies per layer: each forward kernel runs in
# the forward and again in the recompute, each backward kernel once
TRAIN_PER_LAYER = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1,
                   "resnorm": 2, "glu": 2, "glu_bwd": 1}


def train_kernel_phase(dev, results):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_norm as fnorm
    gen = torch.Generator(device="cpu").manual_seed(99)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def attn_case(b, s, t, kh, g, h, hv, causal, bkv, ragged=False,
                  all_masked=False):
        qf = (randn(b, s, kh, g, h) * h ** -0.5).contiguous()
        k, v = randn(b, t, kh, h), randn(b, t, kh, hv)
        qp = torch.arange(t - s, t, dtype=torch.int32, device=dev)
        if all_masked:          # row 0 sees only key 0, which is invalid
            qp = torch.arange(s, dtype=torch.int32, device=dev)
        qp = qp[None].expand(b, s).contiguous()
        valid = torch.ones(b, t, dtype=torch.uint8, device=dev)
        if ragged:
            valid = (torch.rand(b, t, generator=gen) > 0.25).to(
                torch.uint8).to(dev)
        if all_masked:
            valid[:, 0] = 0
        o, m, l = fa.flash_fwd(qf, k, v, qp, valid, causal=causal,
                               block_kv=bkv, return_stats=True)
        do = randn(*o.shape)
        return (qf, k, v, o, m, l, do, qp, valid), dict(causal=causal,
                                                        block_kv=bkv)

    def bwd_checks(name, args, kw):
        dq = fb.flash_bwd_dq(*args, **kw)
        e_q = check_rel(f"flash_bwd_dq {name}", dq,
                        fb.flash_bwd_dq_plain(*args, **kw), TOL_FLASH_BWD)
        dk, dv = fb.flash_bwd_dkdv(*args, **kw)
        dkp, dvp = fb.flash_bwd_dkdv_plain(*args, **kw)
        e_k = check_rel(f"flash_bwd_dkdv dk {name}", dk, dkp, TOL_FLASH_BWD)
        e_v = check_rel(f"flash_bwd_dkdv dv {name}", dv, dvp, TOL_FLASH_BWD)
        return e_q, max(e_k, e_v)

    # -- rows 10 / 11: the train path's shape, yi's heads, edge shapes
    log("[train] flash_bwd_dq / flash_bwd_dkdv")
    S_ = TRAIN["seq"]
    path_shape = (TRAIN["batch"], S_, S_, 16, 1, 64, 64)
    yi_shape = (1, 2048, 2048, 4, 8, 128, 128)
    path, kw = attn_case(*path_shape, True, 64)
    err_q, err_kv = bwd_checks(f"path {path_shape} causal", path, kw)
    check_repeat(f"flash_bwd_dq path {path_shape} repeat",
                 lambda: fb.flash_bwd_dq(*path, **kw))
    check_repeat(f"flash_bwd_dkdv path {path_shape} repeat",
                 lambda: torch.cat([x.flatten() for x in
                                    fb.flash_bwd_dkdv(*path, **kw)]))
    yi, ykw = attn_case(*yi_shape, True, 64)
    bwd_checks(f"yi heads {yi_shape} causal", yi, ykw)
    for (b, s, t, kh, g, h, hv, causal, bkv, ragged, allm) in (
            (2, 70, 200, 2, 2, 64, 64, True, 64, True, False),
            (2, 40, 300, 2, 2, 64, 64, True, 64, True, True),
            (1, 33, 129, 3, 4, 128, 72, True, 16, True, False),
            (2, 64, 100, 1, 3, 32, 32, False, 37, True, False),
            (1, 130, 130, 2, 1, 64, 64, False, 64, False, False),
            # the backward's tile edges (S G, T one off 128), G 8 at h
            # 128, and a shape on the 4-byte copies (h 30, hv 62)
            (1, 127, 127, 2, 1, 64, 64, True, 64, True, False),
            (1, 43, 257, 2, 3, 64, 64, True, 64, True, False),
            (1, 40, 300, 2, 8, 128, 128, True, 64, True, False),
            (1, 50, 90, 2, 3, 30, 62, True, 64, True, False)):
        args, ekw = attn_case(b, s, t, kh, g, h, hv, causal, bkv, ragged,
                              allm)
        bwd_checks(f"({b},{s},{t},{kh},{g},{h},{hv}) causal={causal} "
                   f"bkv={bkv} ragged={ragged} all-masked row={allm}",
                   args, ekw)

    def bwd_bounds(b, s, t, kh, g, h, hv):
        """(dq, dk/dv) bounds: each operand read once, each output
        written once, the causal (q, k) pairs' FMAs (q_pos t - s ..)."""
        rows, keys = b * s * kh * g, b * t * kh
        pairs = b * kh * g * (s * (t - s) + s * (s + 1) // 2)
        common = 4 * (rows * (h + 2 * hv + 2) + keys * (h + hv) + b * s) \
            + b * t
        return (bound(common + 4 * rows * h, 2 * pairs * (2 * h + hv)),
                bound(common + 4 * keys * (h + hv),
                      2 * pairs * (2 * h + 2 * hv)))

    def sdpa_bwd_ms(args, g):
        """SDPA's backward on the same work (forward + backward minus
        forward), B H S h layout, causal; K / V expanded to the G query
        heads of each kv head."""
        qf_, k_, v_, do_ = args[0], args[1], args[2], args[6]
        b_, s_, kh_, _, h_ = qf_.shape

        def heads(x):
            return x.reshape(b_, s_, kh_ * g, x.shape[-1]).permute(
                0, 2, 1, 3).detach().clone()
        q_l, do_l = heads(qf_), heads(do_).contiguous()
        k_l = k_.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).detach()
        v_l = v_.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).detach()
        for t_ in (q_l, k_l, v_l):
            t_.requires_grad_(True)

        def fwd():
            return torch.nn.functional.scaled_dot_product_attention(
                q_l, k_l, v_l, is_causal=True, scale=1.0)

        def fwd_bwd():
            torch.autograd.grad(fwd(), (q_l, k_l, v_l), do_l)
        return max(time_ms(fwd_bwd, iters=10) - time_ms(fwd, iters=10), 0.0)

    # timing at the path's shape and at yi's heads: back to back, under
    # CUDA-graph replay, each kernel's share of its bound
    flash_bwd = {}
    step_ms = {}
    for key, shape, args, akw in (("path", path_shape, path, kw),
                                  ("yi", yi_shape, yi, ykw)):
        lib = sdpa_bwd_ms(args, shape[4])
        for name, b_ms_by in zip(("flash_bwd_dq", "flash_bwd_dkdv"),
                                 bwd_bounds(*shape)):
            kern = getattr(fb, name)
            plain_fn = getattr(fb, name + "_plain")

            def fn(kern=kern, args=args, akw=akw):
                return kern(*args, **akw)
            ms = time_ms(fn, iters=10, warmup=2)
            r_ = dict(ms=ms, graph_ms=graph_ms(fn, calls=2),
                      plain_ms=time_ms(lambda: plain_fn(*args, **akw),
                                       iters=2, warmup=1),
                      bound_ms=b_ms_by[0], bound_by=b_ms_by[1],
                      library_ms=lib, bound_share=b_ms_by[0] / ms)
            flash_bwd[f"{name} {key}"] = r_
            log(f"  {name} {key} {shape} causal: {ms * 1e3:.1f} us (graph "
                f"{r_['graph_ms'] * 1e3:.1f}), plain "
                f"{r_['plain_ms'] * 1e3:.1f} us, bound "
                f"{b_ms_by[0] * 1e3:.1f} us ({b_ms_by[1]}; "
                f"{100 * r_['bound_share']:.1f}% of it reached), SDPA "
                f"backward {lib * 1e3:.1f} us (dq + dk/dv together)")
            if key == "path":
                results[name] = dict(
                    max_abs_err=err_q if name == "flash_bwd_dq" else err_kv,
                    **{k_: r_[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")})
                step_ms[name] = ms
    results["flash_bwd_ms"] = flash_bwd
    log("[flash bwd] rows 10 / 11 at the path shape and yi's heads, ms: "
        + json.dumps(flash_bwd))
    # row 7 as the train step runs it (with stats) at the same shape: held
    # to its plain version, twice the same bits, timed beside SDPA's forward
    fargs = (*path[:3], path[7], path[8])
    fwd_checks(fa, f"with stats, train path {path_shape[:5]}", fargs, True,
               64)
    check_repeat("flash_fwd with stats, train path repeat",
                 lambda: torch.cat([x.flatten() for x in fa.flash_fwd(
                     *fargs, return_stats=True, **kw)]))
    b_, s_, kh_ = TRAIN["batch"], S_, 16
    pairs = b_ * kh_ * S_ * (S_ + 1) // 2
    nbytes = 4 * (2 * b_ * S_ * kh_ * 64 * 2 + 2 * b_ * kh_ * S_ + b_ * S_) \
        + b_ * S_
    q_l = path[0].reshape(b_, S_, kh_, 64).permute(0, 2, 1, 3)
    k_l, v_l = (x.permute(0, 2, 1, 3) for x in path[1:3])
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_l, k_l, v_l, is_causal=True, scale=1.0), iters=10)
    r_ = kernel_row(results.setdefault("flash_fwd_ms", {}),
                    f"train B{b_} S{S_} K{kh_} G1 h64 causal, with stats",
                    lambda: fa.flash_fwd(*fargs, return_stats=True, **kw),
                    lambda: fa.flash_fwd_plain(*fargs, return_stats=True,
                                               **kw),
                    *bound(nbytes, pairs * (4 * 64 + 4)), lib)
    step_ms["flash_fwd"] = r_["ms"]
    del path, yi, fargs, q_l, k_l, v_l

    # -- row 13: the fused GLU backward
    log("[train] glu_bwd")
    err = 0.0
    for m, k, f, mode in ((8192, 1024, 2816, "silu"),
                          (8192, 1024, 2816, "gelu"),
                          (4096, 4096, 11008, "silu"), (23, 200, 130, "gelu"),
                          (70, 37, 33, "silu"), (1, 64, 1, "gelu")):
        x, dy = randn(m, k), randn(m, f)
        wg, wu = randn(k, f, scale=k ** -0.5), randn(k, f, scale=k ** -0.5)
        got = ff.glu_bwd(x, wg, wu, dy, mode=mode)
        want = ff._glu_bwd_plain(x, wg, wu, dy, mode)
        name = f"glu_bwd {mode} ({m}, {k}) x {f}"
        e = max(check_rel(f"{name} d_gate", got[0], want[0], TOL_GLU_BWD),
                check_rel(f"{name} d_up", got[1], want[1], TOL_GLU_BWD))
        if (m, mode) == (8192, "silu"):
            err = e
    m, k, f = TRAIN["batch"] * S_, 1024, 2816
    x, dy = randn(m, k), randn(m, f)
    wg, wu = randn(k, f, scale=k ** -0.5), randn(k, f, scale=k ** -0.5)
    check_repeat(f"glu_bwd silu ({m}, {k}) x {f} repeat",
                 lambda: torch.stack(ff.glu_bwd(x, wg, wu, dy, mode="silu")))
    ms = time_ms(lambda: ff.glu_bwd(x, wg, wu, dy, mode="silu"), iters=10)
    plain = time_ms(lambda: ff._glu_bwd_plain(x, wg, wu, dy, "silu"),
                    iters=10)

    def library():
        return torch.matmul(x, wg), torch.matmul(x, wu)
    lib = time_ms(library, iters=10)
    b_ms, b_by = bound((m * k + 2 * k * f + 3 * m * f) * 4,
                       4 * m * k * f + 30 * m * f)
    log(f"  glu_bwd silu M{m} d{k} F{f}: {ms * 1e3:.1f} us, plain "
        f"{plain * 1e3:.1f} us, two torch.matmul {lib * 1e3:.1f} us, bound "
        f"{b_ms * 1e3:.1f} us ({b_by})")
    norm_gemm_row(results, f"glu_bwd train M{m} d{k} F{f}", ms, plain, b_ms,
                  b_by, lib, lambda: ff.glu_bwd(x, wg, wu, dy, mode="silu"),
                  library)
    results["glu_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    step_ms["glu_bwd"] = ms
    step_ms["glu"] = time_ms(lambda: ff.fused_glu(x, wg, wu, mode="silu"),
                             iters=10)
    h_ = randn(m, k)
    g_ = torch.ones(k, device=dev)
    step_ms["resnorm"] = time_ms(lambda: fnorm.fused_residual_norm(
        x, h_, g_, kind="rms", eps=1e-6), iters=10)
    log("  the train step's kernels at its shapes, us a call: " + ", ".join(
        f"{k_} {v_ * 1e3:.1f}" for k_, v_ in step_ms.items()))
    results["train_step_kernel_ms"] = step_ms


def _plain_train_kernels():
    """Patches that put the plain versions in the train path kernels'
    place (the same call sites, so the same graph); the scans' entries,
    where their autograd Functions apply, take the plain scans under
    autograd."""
    from contextlib import ExitStack

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_norm as fn
    from repro_torch.kernels import recurrence as rec
    from repro_torch.models import mamba, rwkv
    stack = ExitStack()
    for mod, name, plain in ((fa, "flash_fwd", fa.flash_fwd_plain),
                             (fb, "flash_bwd_dq", fb.flash_bwd_dq_plain),
                             (fb, "flash_bwd_dkdv", fb.flash_bwd_dkdv_plain),
                             (fn, "_resnorm_fwd", fn.fused_residual_norm_plain),
                             (fn, "_norm_linear_fwd",
                              fn.fused_norm_linear_plain),
                             (ff, "_glu_fwd", ff._glu_reference),
                             (ff, "glu_bwd", ff._glu_bwd_plain),
                             (rwkv, "wkv6", rec.wkv6_plain),
                             (mamba, "selective_scan",
                              rec.selective_scan_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def train_phase(dev, launches, results):
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build, dispatch
    from repro_torch.train import Trainer, make_grad_fn
    from repro_torch.tree import tree_leaves, tree_paths
    gc.collect()                    # the serve phases' weights and pools
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = registry.get_config("qwen1.5-0.5b").replace(
        softmax_impl="float", activation="silu", norm_impl="fused_pallas",
        ffn_impl="fused_pallas")
    b, seq, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    impl = dispatch.resolve_attention(cfg.attn_impl, seq, seq, "float",
                                      device=dev)
    if impl != "flash_pallas":
        fail(f"train: 'auto' resolved {impl} at seq {seq}")
    t0 = time.perf_counter()
    data = SyntheticLM(vocab=TRAIN["data_vocab"], seq_len=seq,
                       global_batch=b, seed=0)
    log(f"[train] bigram table {TRAIN['data_vocab']}^2 built in "
        f"{time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        tcfg = TrainConfig(lr=3e-4, warmup_steps=2, remat=True,
                           total_steps=steps, checkpoint_every=1000,
                           checkpoint_dir=os.path.join(tmp, "main"))
        trainer = Trainer(cfg, tcfg, b, seq, device=dev, data=data,
                          log=lambda *_: None)
        n_par = sum(p.numel() for p in tree_leaves(trainer.state.params))
        log(f"[train] qwen1.5-0.5b full width and depth: {cfg.n_layers} "
            f"layers d {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
            f"d_ff {cfg.d_ff} vocab {cfg.vocab}, {n_par / 1e6:.1f} M "
            f"parameters; batch {b} x {seq}, data vocab "
            f"{TRAIN['data_vocab']}, remat, attn {impl}")
        for k in _build.KERNELS.values():
            k.launches = 0
        hist = []
        for i in range(steps):
            mt = trainer.run(1)
            hist.append(mt)
            log(f"  step {i}: loss {mt['loss']:.5f} grad_norm "
                f"{mt['grad_norm']:.4f} lr {mt['lr']:.3g} "
                f"{trainer.step_times[-1] * 1e3:.0f} ms")
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        ms_step = float(np.median(trainer.step_times[1:]))
        per_call = results["train_step_kernel_ms"]
        in_kernels = sum(per_call[k] * counts[k] for k in TRAIN_KERNELS
                         ) / steps
        in_attn = sum(per_call[k] * counts[k] for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")) / steps
        log(f"[train] {steps} steps: median {ms_step * 1e3:.0f} ms a step "
            f"(first {trainer.step_times[0] * 1e3:.0f} ms), "
            f"{b * seq / ms_step:.0f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB; "
            f"launches {counts}; the port's kernels ~{in_kernels:.0f} ms a "
            f"step, attention (rows 7, 10, 11) ~{in_attn:.0f} ms of it "
            f"(per-call times x launches, not a trace)")
        losses = [mt["loss"] for mt in hist]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"train: loss not finite and falling: {losses}")
        for k, n in counts.items():
            want = TRAIN_PER_LAYER.get(k, 0) * cfg.n_layers * steps
            if n != want:
                fail(f"train: kernel {k} launched {n} times, expected {want}")
        for k in TRAIN_KERNELS:
            launches[k] = launches.get(k, 0) + counts[k]

        # one step from one state, twice: the same bits
        state = trainer.state
        tokens, labels = data.batch(steps)
        batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
        s1, m1 = trainer.step_fn(state, batch)
        s2, m2 = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(tree_leaves(s1),
                                                      tree_leaves(s2))
                   if torch.is_tensor(x))
        same = same and all(torch.equal(torch.as_tensor(m1[k]),
                                        torch.as_tensor(m2[k]))
                            for k in m1)
        if not same:
            fail("train: one step from the same state gave other bits")
        log(f"  ok a step repeated from one state: identical bits (loss "
            f"{float(m1['loss']):.6f})")
        del s1, s2

        # one step's loss and gradients, kernels vs plain versions
        grad_fn = make_grad_fn(cfg, tcfg, dev)
        (ce_k, _), g_k = grad_fn(state.params, batch)
        with _plain_train_kernels():
            (ce_p, _), g_p = grad_fn(state.params, batch)
        torch.cuda.synchronize()
        rel = abs(float(ce_k) - float(ce_p)) / abs(float(ce_p))
        if rel > TOL_TRAIN_LOSS:
            fail(f"train: loss kernels {float(ce_k)} vs plain {float(ce_p)}"
                 f" (relative {rel:.2e} > {TOL_TRAIN_LOSS:.0e})")
        worst, worst_at = 0.0, "(every tensor)"
        for (path, gk), gp in zip(tree_paths(g_k), tree_leaves(g_p)):
            r = max_err(gk, gp) / max(float(gp.abs().max()), 1e-30)
            if r > worst:
                worst, worst_at = r, path
        if worst > TOL_TRAIN_GRAD:
            fail(f"train: gradient {worst_at} kernels vs plain {worst:.2e} "
                 f"of its max > {TOL_TRAIN_GRAD:.0e}")
        log(f"  ok one step, kernels vs plain: loss relative {rel:.2e} "
            f"(limit {TOL_TRAIN_LOSS:.0e}), worst gradient {worst_at} "
            f"{worst:.2e} of its max (limit {TOL_TRAIN_GRAD:.0e})")
        del g_k, g_p, trainer, state
        gc.collect()
        torch.cuda.empty_cache()

        # save and resume at full width, depth cut to 2 layers
        cut = cfg.replace(n_layers=2)
        quiet = dict(device=dev, data=data, log=lambda *_: None)
        saved = TrainConfig(lr=3e-4, warmup_steps=2, remat=True,
                            total_steps=steps, checkpoint_every=2,
                            checkpoint_dir=os.path.join(tmp, "saved"))
        Trainer(cut, saved, b, seq, **quiet).run(2)
        resumed = Trainer(cut, saved, b, seq, **quiet)
        if resumed.start_step != 2:
            fail(f"train: resumed at step {resumed.start_step}, not 2")
        m_res = resumed.run(2)
        cont = TrainConfig(lr=3e-4, warmup_steps=2, remat=True,
                           total_steps=steps, checkpoint_every=1000,
                           checkpoint_dir=os.path.join(tmp, "cont"))
        m_cont = Trainer(cut, cont, b, seq, **quiet).run(4)
        if not np.isclose(m_res["loss"], m_cont["loss"], rtol=1e-4, atol=0):
            fail(f"train: resumed loss {m_res['loss']} vs uninterrupted "
                 f"{m_cont['loss']}")
        log(f"  ok save at step 2, resume, step 4: loss {m_res['loss']:.6f} "
            f"vs uninterrupted {m_cont['loss']:.6f} (rtol 1e-4; "
            f"{'identical' if m_res['loss'] == m_cont['loss'] else 'close'})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------- phase 7: bert-base, the paper's encoder ----------------

BERT_BATCH = (8, 512)
# name: (config overrides, the path's kernels, kernels-vs-plain limit)
BERT_PATHS = {
    "float": (dict(softmax_impl="float", activation="gelu_tanh", **FUSED),
              ("resnorm", "norm_linear"), TOL_BERT_F),
    "dualmode": (dict(softmax_impl="dualmode", activation="gelu_dualmode",
                      **FUSED),
                 ("resnorm", "norm_linear", "softmax_rows", "pair_act"),
                 TOL_LOGITS_D),
    "dualmode_int3": (dict(softmax_impl="dualmode",
                           activation="gelu_dualmode",
                           attn_impl="flash_pallas_int3", **FUSED),
                      ("resnorm", "norm_linear", "flash_int3", "pair_act"),
                      TOL_LOGITS_D),
    "igelu": (dict(softmax_impl="float", activation="igelu", **FUSED),
              ("resnorm", "norm_linear"), TOL_LOGITS_D)}


def bert_kernel_phase(dev, results):
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import fused_norm as fn
    from repro_torch.kernels import tiling
    gen = torch.Generator(device="cpu").manual_seed(512)

    def randn(*shape, grid=False, scale=1.0):
        x = torch.randn(shape, generator=gen) * scale
        return (torch.round(x * 4) / 16 if grid else x).to(dev)

    def attn_case(b, s, t, kh, g, h, hv, causal_end=None, grid=False,
                  ragged=False):
        qf = randn(b, s, kh, g, h, grid=grid)
        qf = (qf if grid else qf * h ** -0.5).contiguous()
        k, v = randn(b, t, kh, h, grid=grid), randn(b, t, kh, hv)
        end = t if causal_end is None else causal_end
        qp = torch.arange(end - s, end, dtype=torch.int32, device=dev)[
            None].expand(b, s).contiguous()
        valid = torch.ones(b, t, dtype=torch.uint8, device=dev)
        if ragged:
            valid = (torch.rand(b, t, generator=gen) > 0.25).to(
                torch.uint8).to(dev)
        return qf, k, v, qp, valid

    def eye_chunks(b, t, kh, width=128):
        # the identity v in slices of <= 128 value columns (the kernels'
        # hv limit): each output column is one key's probability word
        eye = torch.eye(t, device=dev)
        for j in range(0, t, width):
            yield eye[:, j:j + width][None, :, None, :].expand(
                b, t, kh, min(width, t - j)).contiguous()

    # -- row 9 at bert's shape: one layer's attention of 8 x 512 tokens
    log("[bert] flash_int3")
    b, s, kh, h = BERT_BATCH[0], BERT_BATCH[1], 12, 64
    path = attn_case(b, s, s, kh, 1, h, h)
    kw = dict(causal=False, block_kv=64, guard_shift=0)
    err = check(f"flash_int3 path (B{b}, {s}, {kh}, 1, {h}) non-causal, "
                "random", fai.flash_int3(*path, **kw),
                fai.flash_int3_plain(*path, **kw), TOL_FLASH_I)
    qf, k, _, qp, valid = attn_case(b, s, s, kh, 1, h, h, grid=True)
    for i, eye in enumerate(eye_chunks(b, s, kh)):
        check(f"flash_int3 path identity-v (exact scores), keys from "
              f"{128 * i}", fai.flash_int3(qf, k, eye, qp, valid, **kw),
              fai.flash_int3_plain(qf, k, eye, qp, valid, **kw), TOL_INT)
    for (bb, ss, t, kk, g, hh, causal, bkv, end, allm) in (
            (2, 70, 200, 2, 2, 64, True, 64, None, False),
            (1, 33, 129, 3, 4, 128, True, 16, None, False),
            (2, 64, 100, 4, 8, 128, False, 37, None, False),
            (2, 40, 300, 2, 2, 64, True, 64, 40, True)):
        qf, k, _, qp, valid = attn_case(bb, ss, t, kk, g, hh, hh,
                                        causal_end=end, grid=True,
                                        ragged=True)
        if allm:              # row 0 sees only key 0, which is invalid
            valid[:, 0] = 0
        ekw = dict(causal=causal, block_kv=bkv, guard_shift=0)
        name = (f"({bb},{ss},{t},{kk},{g},{hh}) causal={causal} bkv={bkv}"
                f"{' all-masked row' if allm else ''}")
        for i, eye in enumerate(eye_chunks(bb, t, kk)):
            check(f"flash_int3 identity-v {name} keys from {128 * i}",
                  fai.flash_int3(qf, k, eye, qp, valid, **ekw),
                  fai.flash_int3_plain(qf, k, eye, qp, valid, **ekw),
                  TOL_INT)
        v = randn(bb, t, kk, hh)
        check(f"flash_int3 random v {name}",
              fai.flash_int3(qf, k, v, qp, valid, **ekw),
              fai.flash_int3_plain(qf, k, v, qp, valid, **ekw), TOL_FLASH_F)
    # 70000 keys: guard_shift 1 from the unpadded T; v's first column sums
    # the row's words, the others pick the last keys' words
    t = 70000
    qf, k, _, qp, valid = attn_case(1, 64, t, 1, 1, 64, 64, grid=True,
                                    ragged=True)
    v = torch.zeros(1, t, 1, 8, device=dev)
    v[0, :, 0, 0] = 1.0
    v[0, t - 7:, 0, 1:] = torch.eye(7, device=dev)
    gs = unit.guard_shift_for(t)
    if gs != 1:
        fail(f"guard shift for {t} keys is {gs}, expected 1")
    for causal in (True, False):
        ekw = dict(causal=causal, block_kv=64, guard_shift=gs)
        check(f"flash_int3 {t} keys words causal={causal}",
              fai.flash_int3(qf, k, v, qp, valid, **ekw),
              fai.flash_int3_plain(qf, k, v, qp, valid, **ekw), TOL_INT)

    check_repeat(f"flash_int3 path (B{b}, {s}, {kh}, 1, {h}) repeat",
                 lambda: fai.flash_int3(*path, **kw))
    # timing at the path's shape, back to back and under CUDA-graph replay.
    # Two bounds: the float work alone (one q.k and one p.v a (q, k) pair),
    # and that plus the int instructions a score its entry executes
    # (counted from its SASS) at the f32 rate
    pairs = b * kh * s * s
    nbytes = (4 * path[0].numel() * 2 + 4 * (path[1].numel()
              + path[2].numel()) + 4 * b * s + b * s)
    f_ms, _ = bound(nbytes, pairs * (2 * h + 2 * h))
    n_int = int3_int_a_score(results, h, h, s)
    b_ms, b_by = bound(nbytes, pairs * (4 * h + n_int))
    ms = time_ms(lambda: fai.flash_int3(*path, **kw), iters=20, warmup=3)
    g_ms = graph_ms(lambda: fai.flash_int3(*path, **kw), calls=2)
    plain = time_ms(lambda: fai.flash_int3_plain(*path, **kw), iters=3,
                    warmup=1)
    plan = tiling.flash_int3_plan(h, h, s)
    log(f"  flash_int3 (B{b} S{s} T{s} K{kh} G1 h{h} non-causal, plan "
        f"{tuple(plan)}): {ms * 1e3:.1f} us (graph {g_ms * 1e3:.1f}), plain "
        f"{plain * 1e3:.1f} us, bound {f_ms * 1e3:.1f} us (float work) and "
        f"{b_ms * 1e3:.1f} us ({b_by}, with {n_int:.2f} int instructions a "
        f"score); {100 * f_ms / g_ms:.1f}% / {100 * b_ms / g_ms:.1f}% of "
        "them reached under graph; no library call computes the unit's "
        "words")
    results["flash_int3"] = dict(max_abs_err=err, ms=ms, graph_ms=g_ms,
                                 plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                 float_bound_ms=f_ms, int_ops_a_score=n_int,
                                 library_ms=None)
    log("[flash int3] " + json.dumps(results["flash_int3"]))
    del path

    # -- rows 1, 2, 14, 15 at bert's shapes
    shapes = {}
    log("[bert] softmax_rows, pair_act, resnorm, norm_linear at bert's "
        "shapes")
    x = randn(b * kh * s, s, scale=3.0)       # one layer's score rows
    check(f"softmax_rows int ({b * kh * s}, {s})", ds.softmax_rows(x, "int"),
          ds.softmax_rows_plain(x, "int"), TOL_INT)
    # its float mode, which torch.softmax computes
    check(f"softmax_rows float ({b * kh * s}, {s})",
          ds.softmax_rows(x, "float"), ds.softmax_rows_plain(x, "float"),
          TOL_SOFTMAX_F)
    for prec in ("int", "float"):
        check_repeat(f"softmax_rows {prec} {tuple(x.shape)}",
                     lambda: ds.softmax_rows(x, prec))
    n = x.numel()
    unit_ms = {}
    for prec, ops in (("int", 80), ("float", 8)):
        shapes[f"softmax_rows {prec} {tuple(x.shape)}"] = r_ = unit_row(
            unit_ms, f"softmax_rows {prec} {tuple(x.shape)}",
            lambda: ds.softmax_rows(x, prec), bound(8 * n, ops * n)[0],
            lambda: torch.softmax(x, dim=-1), "torch.softmax")
        r_["plain_ms"] = time_ms(lambda: ds.softmax_rows_plain(x, prec),
                                 iters=5)
    del x
    z = randn(b * s, 3072, scale=3.0)         # one layer's FFN activation
    check(f"pair_act gelu int {tuple(z.shape)}", ds.pair_act(z, "gelu", "int"),
          ds.pair_act_plain(z, "gelu", "int"), TOL_INT)
    check(f"pair_act gelu float {tuple(z.shape)}",
          ds.pair_act(z, "gelu", "float"),
          ds.pair_act_plain(z, "gelu", "float"), TOL_PAIR_F)
    check_repeat(f"pair_act gelu int {tuple(z.shape)}",
                 lambda: ds.pair_act(z, "gelu", "int"))
    n = z.numel()
    for mode, lib_name, lib_fn in (
            ("gelu", "F.gelu(tanh)",
             lambda: torch.nn.functional.gelu(z, approximate="tanh")),
            ("silu", "F.silu", lambda: torch.nn.functional.silu(z))):
        for prec in ("int", "float"):
            key = f"pair_act {mode} {prec} {tuple(z.shape)}"
            shapes[key] = r_ = unit_row(
                unit_ms, key, lambda: ds.pair_act(z, mode, prec),
                bound(8 * n, 60 * n)[0], lib_fn, lib_name)
            if mode == "gelu":
                r_["plain_ms"] = time_ms(
                    lambda: ds.pair_act_plain(z, mode, prec), iters=5)
    del z
    m, d, eps = b * s, 768, 1e-12
    x, r = randn(m, d, scale=3.0), randn(m, d)
    g, bias = 1.0 + randn(d, scale=0.1), randn(d, scale=0.1)
    got = fn.fused_residual_norm(x, r, g, bias, kind="layer", eps=eps)
    want = fn.fused_residual_norm_plain(x, r, g, bias, kind="layer", eps=eps)
    check(f"resnorm sum layer ({m}, {d})", got[0], want[0], TOL_INT)
    check(f"resnorm h layer ({m}, {d})", got[1], want[1], TOL_NORM)

    def two_calls():           # no one PyTorch call adds and normalizes
        s_ = torch.add(x, r)
        return s_, torch.nn.functional.layer_norm(s_, (d,), g, bias, eps)
    shapes[f"resnorm layer ({m}, {d})"] = r_ = unit_row(
        unit_ms, f"resnorm layer ({m}, {d})",
        lambda: fn.fused_residual_norm(x, r, g, bias, kind="layer", eps=eps),
        bound(4 * m * d * 4 + 2 * d * 4, 10 * m * d)[0], two_calls,
        "torch.add + F.layer_norm (two calls)")
    r_["plain_ms"] = time_ms(lambda: fn.fused_residual_norm_plain(
        x, r, g, bias, kind="layer", eps=eps))
    log("[unit rows] bert shapes: " + json.dumps(unit_ms))
    ws = [randn(d, d, scale=d ** -0.5) for _ in range(3)]
    check(f"norm_linear layer ({m}, {d}) x {3 * d}",
          fn.fused_norm_linear(x, g, bias, ws, kind="layer", eps=eps),
          fn.fused_norm_linear_plain(x, g, bias, ws, kind="layer", eps=eps),
          TOL_GEMM)
    wcat = torch.cat(ws, dim=1)
    hn = fn._scaled(x, g, bias, kind="layer", eps=eps)
    f = 3 * d
    b_ms, b_by = bound((m * d + d * f + m * f + 2 * d) * 4,
                       2 * m * d * f + 6 * m * d)
    shapes[f"norm_linear layer ({m}, {d}) x {3 * d}"] = r_ = dict(
        ms=time_ms(lambda: fn.fused_norm_linear(x, g, bias, ws, kind="layer",
                                                eps=eps), iters=20),
        plain_ms=time_ms(lambda: fn.fused_norm_linear_plain(
            x, g, bias, ws, kind="layer", eps=eps), iters=20),
        bound_ms=b_ms,
        library_ms=time_ms(lambda: torch.matmul(hn, wcat), iters=20))
    norm_gemm_row(results, f"norm_linear bert layer M{m} d{d} F{f}",
                  r_["ms"], r_["plain_ms"], b_ms, b_by, r_["library_ms"],
                  lambda: fn.fused_norm_linear(x, g, bias, ws, kind="layer",
                                               eps=eps),
                  lambda: torch.matmul(hn, wcat))
    for name, r_ in shapes.items():
        log(f"  {name}: {r_['ms'] * 1e3:.1f} us, plain "
            + (f"{r_['plain_ms'] * 1e3:.1f} us" if "plain_ms" in r_
               else "not timed")
            + f", bound {r_['bound_ms'] * 1e3:.2f} us, library "
            f"{r_['library_ms'] * 1e3:.1f} us")
    results["bert_shape_ms"] = shapes


def _plain_bert_kernels():
    """Patches that put the plain versions in the bert path kernels'
    place (the same call sites)."""
    from contextlib import ExitStack

    from repro_torch.core import activations
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import flash_attention_int as fai
    stack = ExitStack()
    for mod, name, plain in ((dispatch, "softmax_rows", ds.softmax_rows_plain),
                             (activations, "pair_act", ds.pair_act_plain),
                             (fai, "flash_int3", fai.flash_int3_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    stack.enter_context(mock.patch.dict(
        dispatch._NORM, {"fused_pallas": _plain_norm_provider()}))
    return stack


def bert_phase(dev, launches):
    import gc

    from repro_torch.configs import registry
    from repro_torch.kernels import _build, dispatch
    from repro_torch.models.transformer import init_lm, lm_apply
    from repro_torch.tree import tree_leaves
    gc.collect()                    # the training phase's state
    torch.cuda.empty_cache()
    base = registry.get_config("bert-base")
    t0 = time.perf_counter()
    params = init_lm(base, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in tree_leaves(params))
    log(f"[bert] bert-base full width: {base.n_layers} layers d "
        f"{base.d_model} heads {base.n_heads} d_ff {base.d_ff} vocab "
        f"{base.vocab} max_seq {base.max_seq}, {n_par / 1e6:.1f} M "
        f"parameters; init {time.perf_counter() - t0:.1f} s")
    bsz, seq = BERT_BATCH
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, base.vocab, size=(bsz, seq))).to(dev)

    def forward(cfg):
        return lm_apply(params, cfg, toks, return_hidden=True, device=dev)[0]

    hidden = {}
    for name, (over, kernels, tol) in BERT_PATHS.items():
        cfg = base.replace(**over)
        impl = dispatch.resolve_attention(cfg.attn_impl, seq, seq,
                                          cfg.softmax_impl, device=dev)
        want_impl = ("flash_pallas_int3" if name == "dualmode_int3"
                     else "naive")
        if impl != want_impl:
            fail(f"bert {name}: attention resolved {impl}, not {want_impl}")
        forward(cfg)                                  # warm-up
        torch.cuda.synchronize()
        for k in _build.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        h = forward(cfg)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        for k in kernels:
            launches[k] = launches.get(k, 0) + counts[k]
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            forward(cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        log(f"[bert] {name}: {ms:.1f} ms a batch of {bsz} x {seq} (median of "
            f"5; counted run {first * 1e3:.1f} ms), "
            f"{bsz * seq / ms * 1e3:.0f} tokens/s; attention {impl}; "
            f"launches {counts}")
        if tuple(h.shape) != (bsz, seq, base.d_model):
            fail(f"bert {name}: hidden states {tuple(h.shape)}")
        if not torch.isfinite(h).all():
            fail(f"bert {name}: non-finite hidden states")
        for k, n in counts.items():
            want = base.n_layers if k in kernels else 0
            if n != want:
                fail(f"bert {name}: kernel {k} launched {n} times in one "
                     f"forward, expected {want}")
        with _plain_bert_kernels():
            plain = forward(cfg)
        check(f"bert-base {name} hidden states, kernels vs plain", h, plain,
              tol)
        hidden[name] = h
        del plain
    check("bert-base dual-mode hidden states, flash_int3 path vs naive path",
          hidden["dualmode_int3"], hidden["dualmode"], TOL_LOGITS_D)
    logits = lm_apply(params, base.replace(**BERT_PATHS["float"][0]), toks,
                      device=dev)[0]
    torch.cuda.synchronize()
    if (tuple(logits.shape) != (bsz, seq, base.vocab)
            or not torch.isfinite(logits).all()):
        fail(f"bert: logits {tuple(logits.shape)} not finite")
    log(f"  ok full logits through the head: {tuple(logits.shape)}, finite")
    del params, hidden, logits
    gc.collect()
    torch.cuda.empty_cache()


# ---------------- phase 8: llama-3.2-vision, cross attention ----------------

VISION = dict(max_seq=4096, n_slots=4, prefill_buckets=(512, 1024, 4096))
VISION_PROMPT_LENS = (200, 3000)
VISION_NO_IMAGE = 2      # the request that carries no image embeddings
VISION_GATE = 0.5        # every cross_gate: tanh(0) would shut the sublayer
VISION_PARITY_BUCKET = 1024
# the kernels at the path's shapes: d, F, the norm -> GLU rows (a decode
# tick, a bucket-512 and a bucket-4096 prefill), the image keys, the kv
# heads, query groups and head width, the cross prefill's query rows
VISION_KERNEL = dict(d=4096, f=14336, rows=(4, 512, 4096), t=1601,
                     heads=(8, 4, 128), s=(4096, 512))
# name: (config overrides, prefill impl, the layers each kernel launches
# in, a prefill and a decode tick: 'all' 40, 'self' the 32 self-attention
# layers, 'cross' the 8 cross-attention layers, None never; every kernel
# not named launches 0 times)
VISION_PATHS = {
    "float": (dict(softmax_impl="float", activation="silu", **FUSED),
              "flash_pallas",
              {"flash_fwd": ("all", None), "decode_dense": (None, "all"),
               "norm_glu": ("cross", "cross"), "glu": ("self", "self"),
               "norm_linear": ("self", "self"), "resnorm": ("self", "self")}),
    "dualmode": (dict(softmax_impl="dualmode", activation="silu_dualmode",
                      norm_impl="fused_pallas"),
                 "flash_pallas_int",
                 {"flash_snap": ("all", None),
                  "decode_dense_int": (None, "all"),
                  "pair_act": ("all", "all"), "norm_linear": ("self", "self"),
                  "resnorm": ("self", "self")})}


def vision_kernel_phase(dev, results):
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_norm as fn
    from repro_torch.kernels import tiling
    gen = torch.Generator(device="cpu").manual_seed(11)
    eps = 1e-5
    results.setdefault("flash_fwd_ms", {})
    results.setdefault("decode_dense_ms", {})

    def randn(*shape, scale=1.0, grid=False):
        x = torch.randn(shape, generator=gen) * scale
        return (torch.round(x * 4) / 16 if grid else x).to(dev)

    d, dff, rows = (VISION_KERNEL[k] for k in ("d", "f", "rows"))
    # -- row 16: norm -> gated GLU at the path's rows (a decode tick, a
    #    bucket-512 and a bucket-4096 prefill) and edge shapes
    log("[vision] norm_glu")
    x = randn(max(rows), d, scale=2.0)
    g = 1.0 + randn(d, scale=0.1)
    wg, wu = randn(d, dff, scale=d ** -0.5), randn(d, dff, scale=d ** -0.5)
    err = 0.0
    for m in rows:
        xs = x[:m].contiguous()
        e = check(f"norm_glu rms silu ({m}, {d}) x {dff}",
                  fn.fused_norm_glu(xs, g, None, wg, wu, kind="rms", eps=eps,
                                    mode="silu"),
                  fn.fused_norm_glu_plain(xs, g, None, wg, wu, kind="rms",
                                          eps=eps, mode="silu"), TOL_GEMM)
        err = max(err, e)
    for m, dd, f, kind, mode in ((5, d, 1000, "layer", "gelu"),
                                 (67, d, 1000, "rms", "silu"),
                                 (67, 72, 14336, "layer", "silu"),
                                 (5, 200, 130, "layer", "gelu"),
                                 (1, 33, 1, "rms", "gelu")):
        xe = randn(m, dd, scale=2.0)
        ge = 1.0 + randn(dd, scale=0.1)
        be = randn(dd, scale=0.1) if kind == "layer" else None
        wge = randn(dd, f, scale=dd ** -0.5)
        wue = randn(dd, f, scale=dd ** -0.5)
        check(f"norm_glu {kind} {mode} ({m}, {dd}) x {f}",
              fn.fused_norm_glu(xe, ge, be, wge, wue, kind=kind, eps=eps,
                                mode=mode),
              fn.fused_norm_glu_plain(xe, ge, be, wge, wue, kind=kind,
                                      eps=eps, mode=mode), TOL_GEMM)
    # its backward (the GLU backward kernel inside) against the plain VJP
    xb, dyb = randn(2, 37, 256), randn(2, 37, 300)
    gb, bb = 1.0 + randn(256, scale=0.1), randn(256, scale=0.1)
    wgb, wub = randn(256, 300, scale=1 / 16), randn(256, 300, scale=1 / 16)

    def grads():
        ins = [t.clone().requires_grad_(True) for t in (xb, gb, bb, wgb,
                                                         wub)]
        y = fn.fused_norm_glu(*ins, kind="layer", eps=eps, mode="silu")
        return torch.autograd.grad(y, ins, dyb)
    got = grads()
    with mock.patch.object(fn, "_norm_glu_fwd", fn.fused_norm_glu_plain), \
            mock.patch.object(ff, "glu_bwd",
                              lambda *a, mode: ff._glu_bwd_plain(*a, mode)):
        want = grads()
    for name, a, b in zip(("dx", "dg", "db", "dWg", "dWu"), got, want):
        check_rel(f"norm_glu backward {name} (2, 37, 256) x 300", a, b,
                  TOL_GLU_BWD)
    shapes = {}
    for m in rows:
        xs = x[:m].contiguous()
        it = 20 if m < max(rows) else 5
        ms = time_ms(lambda: fn.fused_norm_glu(
            xs, g, None, wg, wu, kind="rms", eps=eps, mode="silu"), iters=it)
        plain = time_ms(lambda: fn.fused_norm_glu_plain(
            xs, g, None, wg, wu, kind="rms", eps=eps, mode="silu"), iters=it)

        def library():
            h = torch.nn.functional.rms_norm(xs, (d,), g, eps)
            return torch.matmul(h, wg), torch.matmul(h, wu)
        lib = time_ms(library, iters=it)
        b_ms, b_by = bound((m * d + 2 * d * dff + m * dff + d) * 4,
                           4 * m * d * dff + 5 * m * d + 20 * m * dff)
        log(f"  norm_glu rms silu M{m} d{d} F{dff}: {ms * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, F.rms_norm + two torch.matmul "
            f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by})")
        shapes[f"norm_glu M{m}"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                        library_ms=lib)
        norm_gemm_row(results, f"norm_glu vision M{m} d{d} F{dff}", ms,
                      plain, b_ms, b_by, lib,
                      lambda: fn.fused_norm_glu(xs, g, None, wg, wu,
                                                kind="rms", eps=eps,
                                                mode="silu"), library)
        if m < max(rows):
            check_repeat(f"norm_glu rms silu ({m}, {d}) x {dff} repeat",
                         lambda: fn.fused_norm_glu(xs, g, None, wg, wu,
                                                   kind="rms", eps=eps,
                                                   mode="silu"))
        if m == rows[1]:
            results["norm_glu"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                       bound_ms=b_ms, bound_by=b_by,
                                       library_ms=lib)
    del x, wg, wu

    # -- rows 5 / 6 as a cross decode tick runs them: 4 slots, K8 G4 h128,
    #    1601 image keys, non-causal, q_pos 0
    log("[vision] decode_dense / decode_dense_int at the cross shape")
    t, (kh, gq, h) = VISION_KERNEL["t"], VISION_KERNEL["heads"]
    b = VISION["n_slots"]
    gs = unit.guard_shift_for(t)
    # the (splits, tile) a cross tick's wrappers pick (the plan's)
    ns, bkv = fd.dense_decode_tiles(t, b * kh, dev)
    qp = torch.zeros(b, dtype=torch.int32, device=dev)
    valid = torch.ones(b, t, dtype=torch.uint8, device=dev)

    def dparts(kern, args, n_s, bk, int_mode):
        f_ = fd.decode_dense_partials if kern else \
            fd.decode_dense_partials_plain
        return f_(*args, num_splits=n_s, block_kv=bk, causal=False,
                  int_mode=int_mode, guard_shift=gs)
    for grid in (True, False):          # the random operands are timed
        args = ((randn(b, kh, gq, h, grid=grid) * h ** -0.5).contiguous(),
                randn(b, t, kh, h, grid=grid), randn(b, t, kh, h), qp, valid)
        for n_s, bk in ((ns, bkv), (1, 128), (8, 128)):
            check(f"decode_dense cross T{t} grid={grid} splits={n_s} "
                  f"bkv={bk}",
                  fd.finish_partials(*dparts(True, args, n_s, bk, False),
                                     int_mode=False),
                  fd.finish_partials(*dparts(False, args, n_s, bk, False),
                                     int_mode=False), TOL_DECODE_F)
            ik, ip = (dparts(True, args, n_s, bk, True),
                      dparts(False, args, n_s, bk, True))
            if grid:
                check(f"decode_dense_int cross m words splits={n_s} "
                      f"bkv={bk}", ik[0], ip[0], TOL_INT)
                check(f"decode_dense_int cross S words splits={n_s} "
                      f"bkv={bk}", ik[1], ip[1], TOL_INT)
            check(f"decode_dense_int cross T{t} grid={grid} splits={n_s} "
                  f"bkv={bk}", fd.finish_partials(*ik, int_mode=True),
                  fd.finish_partials(*ip, int_mode=True), TOL_DECODE_I)
    keys = b * t
    nbytes = keys * kh * 2 * h * 4 + args[0].numel() * 4 + keys + 4 * b
    b_ms, _ = bound(nbytes, keys * kh * gq * (4 * h + 4))
    q_l = args[0].reshape(b, kh * gq, 1, h)
    k_l = args[1].repeat_interleave(gq, dim=2).permute(0, 2, 1, 3)
    v_l = args[2].repeat_interleave(gq, dim=2).permute(0, 2, 1, 3)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_l, k_l, v_l, scale=1.0))
    results.setdefault("decode_dense_int_ms", {})
    for name, int_mode in (("decode_dense", False),
                           ("decode_dense_int", True)):
        check_repeat(f"{name} cross repeat", lambda: torch.cat(
            [x.flatten().to(torch.float32)
             for x in dparts(True, args, ns, bkv, int_mode)]))
        fold = time_ms(lambda: fd.finish_partials(
            *dparts(True, args, ns, bkv, int_mode), int_mode=int_mode))
        shapes[f"{name} cross"] = kernel_row(
            results[f"{name}_ms"],
            f"cross B{b} K{kh} G{gq} h{h} T{t} non-causal",
            lambda: dparts(True, args, ns, bkv, int_mode),
            lambda: dparts(False, args, ns, bkv, int_mode), b_ms, "bytes",
            None if int_mode else lib, iters=50, plain_iters=3, splits=ns,
            block_kv=bkv, with_fold_ms=fold)

    # -- rows 7 / 8 as a cross prefill runs them: B1, S 4096 and 512
    #    queries against the 1601 image keys, non-causal, K8 G4 h128
    log("[vision] flash_fwd / flash_snap at the cross shape")
    kw = dict(causal=False, block_kv=64)
    results.setdefault("flash_snap_ms", {})
    for s_ in VISION_KERNEL["s"]:
        for grid in (True, False):      # the random operands are timed
            args = ((randn(1, s_, kh, gq, h, grid=grid)
                     * (1.0 if grid else h ** -0.5)).contiguous(),
                    randn(1, t, kh, h, grid=grid), randn(1, t, kh, h),
                    torch.zeros(1, s_, dtype=torch.int32, device=dev),
                    torch.ones(1, t, dtype=torch.uint8, device=dev))
            check(f"flash_fwd cross S{s_} T{t} grid={grid}",
                  fa.flash_fwd(*args, **kw), fa.flash_fwd_plain(*args, **kw),
                  TOL_FLASH_F)
            got = fai.flash_snap(*args, guard_shift=gs, return_partial=True,
                                 **kw)
            want = fai.flash_snap_plain(*args, guard_shift=gs,
                                        return_partial=True, **kw)
            if grid:
                check(f"flash_snap cross S{s_} m words", got[1], want[1],
                      TOL_INT)
                check(f"flash_snap cross S{s_} S words", got[2], want[2],
                      TOL_INT)
            check(f"flash_snap cross S{s_} T{t} grid={grid}",
                  fai.flash_snap(*args, guard_shift=gs, **kw),
                  fai.flash_snap_plain(*args, guard_shift=gs, **kw),
                  TOL_FLASH_F if grid else TOL_FLASH_I)
        pairs = s_ * t * kh * gq
        nbytes = (2 * args[0].numel() + 2 * t * kh * h) * 4 + 4 * s_ + t
        b_ms, _ = bound(nbytes, pairs * (4 * h + 4))
        q_l = args[0][0].permute(1, 2, 0, 3).reshape(1, kh * gq, s_, h)
        k_l = args[1].repeat_interleave(gq, dim=2).permute(0, 2, 1, 3)
        v_l = args[2].repeat_interleave(gq, dim=2).permute(0, 2, 1, 3)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q_l, k_l, v_l, scale=1.0), iters=10)
        shapes[f"flash_fwd cross S{s_}"] = kernel_row(
            results["flash_fwd_ms"],
            f"cross B1 S{s_} K{kh} G{gq} h{h} T{t} non-causal",
            lambda: fa.flash_fwd(*args, **kw),
            lambda: fa.flash_fwd_plain(*args, **kw), b_ms, "operations", lib)
        n_int = snap_int_a_score(results, h, h, False)
        check_repeat(f"flash_snap cross S{s_} repeat",
                     lambda: fai.flash_snap(*args, guard_shift=gs, **kw))
        shapes[f"flash_snap cross S{s_}"] = kernel_row(
            results["flash_snap_ms"],
            f"cross B1 S{s_} K{kh} G{gq} h{h} T{t} non-causal",
            lambda: fai.flash_snap(*args, guard_shift=gs, **kw),
            lambda: fai.flash_snap_plain(*args, guard_shift=gs, **kw),
            *bound(nbytes, pairs * (4 * h + 4 + n_int)), None,
            int_ops_a_score=n_int)
    # row 7's edges at the cross heads: S G off the 64-row tile, the 4-byte
    # copies (pointers one float off 16 bytes); two calls, the same bits
    args = ((randn(1, 67, kh, gq, h) * h ** -0.5).contiguous(),
            randn(1, t, kh, h), randn(1, t, kh, h),
            torch.zeros(1, 67, dtype=torch.int32, device=dev),
            (torch.rand(1, t, generator=gen) > 0.25).to(torch.uint8).to(dev))
    fwd_checks(fa, f"cross (1,67,{t},{kh},{gq},{h},{h}) ragged", args, False,
               64)
    fwd_checks(fa, f"cross (1,67,{t},{kh},{gq},{h},{h}) pointers one float "
               "off 16 bytes",
               tuple(off_by_one_float(x) for x in args[:3]) + args[3:],
               False, 64)
    check_repeat("flash_fwd cross S67 repeat",
                 lambda: fa.flash_fwd(*args, **kw))
    # -- the other path kernels at the vision forward's shapes (a decode
    #    tick's rows and a bucket-4096 prefill), timed only (each is held
    #    to its plain version above, in the phases that ported it): where
    #    a forward's time goes, per call x launches
    log("[vision] the path's other kernels at its shapes (timing)")
    nq, nk = kh * gq * h, kh * h
    big = max(rows)
    xp = randn(big, d)
    wq_, wk_, wv_ = (randn(d, n, scale=d ** -0.5) for n in (nq, nk, nk))
    wg, wu = randn(d, dff, scale=d ** -0.5), randn(d, dff, scale=d ** -0.5)
    for m in (rows[0], big):
        xs = xp[:m].contiguous()
        if m == big:
            # row 12 at the self-attention layers' bucket-4096 prefill: the
            # same products as row 16's without the norm prologue
            check(f"glu silu ({m}, {d}) x {dff}",
                  ff.fused_glu(xs, wg, wu, mode="silu"),
                  ff._glu_reference(xs, wg, wu, "silu"), TOL_GEMM)
            check_repeat(f"glu silu ({m}, {d}) x {dff} repeat",
                         lambda: ff.fused_glu(xs, wg, wu, mode="silu"))
            ms, plain, b_ms, _, lib = glu_times(
                results, f"glu vision M{m} d{d} F{dff}", xs, wg, wu, iters=5)
            shapes[f"glu M{m}"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                       library_ms=lib)
        else:
            shapes[f"glu M{m}"] = dict(ms=time_ms(lambda: ff.fused_glu(
                xs, wg, wu, mode="silu"), iters=20))
        shapes[f"norm_linear M{m}"] = dict(ms=time_ms(
            lambda: fn.fused_norm_linear(xs, g, None, (wq_, wk_, wv_),
                                         kind="rms", eps=eps),
            iters=5 if m == big else 20))
        if m == big:
            f = nq + 2 * nk
            wcat = torch.cat((wq_, wk_, wv_), dim=1)
            hn = fn._scaled(xs, g, None, kind="rms", eps=eps)
            b_ms, b_by = bound((m * d + d * f + m * f + d) * 4,
                               2 * m * d * f + 5 * m * d)
            norm_gemm_row(
                results, f"norm_linear vision M{m} d{d} F{f}",
                shapes[f"norm_linear M{m}"]["ms"],
                time_ms(lambda: fn.fused_norm_linear_plain(
                    xs, g, None, (wq_, wk_, wv_), kind="rms", eps=eps),
                    iters=5),
                b_ms, b_by, time_ms(lambda: torch.matmul(hn, wcat), iters=5),
                lambda: fn.fused_norm_linear(xs, g, None, (wq_, wk_, wv_),
                                             kind="rms", eps=eps),
                lambda: torch.matmul(hn, wcat))
            del wcat, hn
        shapes[f"resnorm M{m}"] = dict(ms=time_ms(
            lambda: fn.fused_residual_norm(xs, xs, g, kind="rms",
                                           eps=eps)))
    del xp, wq_, wk_, wv_, wg, wu
    qs = randn(1, big, kh, gq, h, scale=h ** -0.5).contiguous()
    ks, vs = randn(1, big, kh, h), randn(1, big, kh, h)
    qps = torch.arange(big, dtype=torch.int32, device=dev)[None]
    vals = torch.ones(1, big, dtype=torch.uint8, device=dev)
    sargs = (qs, ks, vs, qps, vals)
    q_l = qs[0].permute(1, 2, 0, 3).reshape(1, kh * gq, big, h)
    k_l = ks.repeat_interleave(gq, dim=2).permute(0, 2, 1, 3)
    v_l = vs.repeat_interleave(gq, dim=2).permute(0, 2, 1, 3)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_l, k_l, v_l, is_causal=True, scale=1.0), iters=5)
    del q_l, k_l, v_l
    pairs = big * (big + 1) // 2 * kh * gq
    # row 7 at the vision self-attention shape: 64-row tiles at h 128,
    # causal, walked from the last, the V tail over several pre-pass chunks
    e_self = fwd_checks(fa, f"self S{big} causal", sargs, True, 64)
    check_repeat(f"flash_fwd self S{big} causal repeat",
                 lambda: fa.flash_fwd(*sargs, causal=True, block_kv=64))
    shapes[f"flash_fwd self S{big} causal"] = kernel_row(
        results["flash_fwd_ms"], f"self B1 S{big} K{kh} G{gq} h{h} causal",
        lambda: fa.flash_fwd(*sargs, causal=True, block_kv=64),
        lambda: fa.flash_fwd_plain(*sargs, causal=True, block_kv=64),
        *bound((2 * qs.numel() + 2 * ks.numel()) * 4 + 5 * big, pairs
               * (4 * h + 4)), lib, iters=5, plain_iters=1,
        max_abs_err=e_self)
    # row 8 there: its words on grid-valued q and k, its output on random
    # ones, and the bound with its entry's int instructions a score
    gargs = ((torch.round(qs * 32) / 32).contiguous(),
             torch.round(ks * 4) / 16) + sargs[2:]
    snap_checks(fai, f"self S{big} causal", gargs, True, 64)
    skw = dict(causal=True, block_kv=64, guard_shift=0)
    e_snap = check(f"flash_snap self S{big} causal, random scores",
                   fai.flash_snap(*sargs, **skw),
                   fai.flash_snap_plain(*sargs, **skw), TOL_FLASH_I)
    n_int = snap_int_a_score(results, h, h, True)
    shapes[f"flash_snap self S{big} causal"] = kernel_row(
        results["flash_snap_ms"], f"self B1 S{big} K{kh} G{gq} h{h} causal",
        lambda: fai.flash_snap(*sargs, **skw),
        lambda: fai.flash_snap_plain(*sargs, **skw),
        *bound((2 * qs.numel() + 2 * ks.numel()) * 4 + 5 * big, pairs
               * (4 * h + 4 + n_int)), None, iters=5, plain_iters=1,
        max_abs_err=e_snap, int_ops_a_score=n_int)
    del qs, ks, vs, sargs, gargs
    t_self = VISION["max_seq"]
    qpd = torch.tensor([375, 737, 1420, 2750][:b], dtype=torch.int32,
                       device=dev)
    dargs = ((randn(b, kh, gq, h) * h ** -0.5).contiguous(),
             randn(b, t_self, kh, h), randn(b, t_self, kh, h), qpd,
             (torch.arange(t_self, device=dev)[None] <= qpd[:, None]).to(
                 torch.uint8))
    live = int(qpd.max()) + 1
    q_l = dargs[0].reshape(b, kh * gq, 1, h)
    k_l = dargs[1][:, :live].repeat_interleave(gq, dim=2).permute(0, 2, 1, 3)
    v_l = dargs[2][:, :live].repeat_interleave(gq, dim=2).permute(0, 2, 1, 3)
    mask = dargs[4][:, :live].bool()[:, None, None, :]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_l, k_l, v_l, attn_mask=mask, scale=1.0))
    del q_l, k_l, v_l
    keys = int(qpd.sum()) + b
    for name, int_mode in (("decode_dense", False),
                           ("decode_dense_int", True)):
        n_s, bk = fd.dense_decode_tiles(t_self, b * kh, dev)

        def dfn(kern, n_s=n_s, bk=bk, int_mode=int_mode):
            f_ = fd.decode_dense_partials if kern else \
                fd.decode_dense_partials_plain
            return f_(*dargs, num_splits=n_s, block_kv=bk, causal=True,
                      int_mode=int_mode, guard_shift=0)
        check(f"{name} self T{t_self} splits={n_s} bkv={bk}",
              fd.finish_partials(*dfn(True), int_mode=int_mode),
              fd.finish_partials(*dfn(False), int_mode=int_mode),
              TOL_DECODE_I if int_mode else TOL_DECODE_F)
        state = 17 if int_mode else 2
        shapes[f"{name} self T{t_self}"] = kernel_row(
            results[f"{name}_ms"],
            f"self B{b} K{kh} G{gq} h{h} T{t_self} depths {qpd.tolist()}",
            lambda: dfn(True), lambda: dfn(False),
            *bound(keys * kh * 2 * h * 4 + keys + dargs[0].numel() * 4
                   + 4 * n_s * kh * gq * (h + state) * b, keys * kh * gq
                   * (4 * h + 4)), None if int_mode else lib, iters=50,
            plain_iters=3, splits=n_s, block_kv=bk)
    del dargs
    log("  " + ", ".join(f"{k_} {v_['ms'] * 1e3:.1f} us"
                         for k_, v_ in shapes.items()
                         if k_.startswith(("glu", "norm_linear", "resnorm",
                                           "flash_fwd self",
                                           "flash_snap self"))
                         or " self T" in k_))
    results["vision_shape_ms"] = shapes
    log("[norm gemm] rows 12, 13, 15, 16 at every shape, ms: "
        + json.dumps(results["norm_gemm_ms"]))
    log("[flash fwd] row 7 at every shape, ms: "
        + json.dumps(results["flash_fwd_ms"]))
    log("[decode dense] row 5 at every shape, ms: "
        + json.dumps(results["decode_dense_ms"]))
    log("[flash snap] row 8 at every shape, ms: "
        + json.dumps(results["flash_snap_ms"]))
    log("[decode dense int] row 6 at every shape, ms: "
        + json.dumps(results["decode_dense_int_ms"]))
    log("[decode paged] rows 3 / 4 at qwen's and yi's ticks, ms: "
        + json.dumps(results["paged_ms"]))


def _plain_vision_kernels():
    """Patches that put the plain versions in the vision path kernels'
    place (the same call sites)."""
    from contextlib import ExitStack

    from repro_torch.core import activations
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_ffn as ff
    stack = ExitStack()
    for mod, name, plain in (
            (fa, "flash_fwd", fa.flash_fwd_plain),
            (fai, "flash_snap", fai.flash_snap_plain),
            (fd, "decode_dense_partials", fd.decode_dense_partials_plain),
            (activations, "pair_act", ds.pair_act_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    stack.enter_context(mock.patch.dict(dispatch._NORM, {
        "fused_pallas": _plain_norm_provider()}))
    stack.enter_context(mock.patch.dict(dispatch._FFN, {
        "fused_pallas": lambda x, wg, wu, mode: ff._glu_reference(
            x, wg, wu, mode)}))
    return stack


def vision_serve_phase(dev, launches):
    import gc

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_caches, init_lm
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import tree_leaves
    gc.collect()                    # the bert phase's weights
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = registry.get_config("llama-3.2-vision-11b")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_lm(base, gen, dev)
    for lp in params["layers"]:
        if "cross_gate" in lp:
            lp["cross_gate"].fill_(VISION_GATE)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in tree_leaves(params))
    log(f"[vision] llama-3.2-vision-11b full width: {base.n_layers} layers "
        f"({sum('cross' in lp for lp in params['layers'])} cross) d "
        f"{base.d_model} heads {base.n_heads}/{base.n_kv_heads} h {base.hd} "
        f"d_ff {base.d_ff} vocab {base.vocab} image tokens "
        f"{base.n_img_tokens}, {n_par / 1e9:.3f} B parameters; cross_gate "
        f"{VISION_GATE}; init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB allocated")
    n_cross = sum("cross" in lp for lp in params["layers"])
    n_layers = {"all": base.n_layers, "cross": n_cross,
                "self": base.n_layers - n_cross, None: 0}
    rng = np.random.RandomState(7)      # buckets 512 x 2, 1024, 4096 x 3
    lens = rng.randint(VISION_PROMPT_LENS[0], VISION_PROMPT_LENS[1] + 1,
                       size=6)
    prompts = [rng.randint(0, base.vocab, size=n).tolist() for n in lens]
    images = [None if i == VISION_NO_IMAGE else torch.randn(
        (1, base.n_img_tokens, base.d_model), generator=gen, device=dev)
        for i in range(len(prompts))]
    for name, (over, prefill_impl, per_kernel) in VISION_PATHS.items():
        cfg = base.replace(**over)
        eng = ServeEngine(cfg, params, device=dev, **VISION)
        if (eng.cache_mode, eng.prefill_attn_impl, eng.decode_attn_impl) != (
                "contiguous", prefill_impl, "flash_decode"):
            fail(f"vision {name}: cache {eng.cache_mode}, prefill "
                 f"{eng.prefill_attn_impl}, decode {eng.decode_attn_impl}")
        prefill_ms = []
        inner = eng.prefill_logits

        def timed(tokens, *a, _inner=inner, _out=prefill_ms):
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            res = _inner(tokens, *a)
            torch.cuda.synchronize()
            _out.append((tokens.shape[1], (time.perf_counter() - t_) * 1e3))
            return res
        eng.prefill_logits = timed
        reqs = [Request(rid=i, prompt=p, max_new=16, cross_src=img)
                for i, (p, img) in enumerate(zip(prompts, images))]
        for k in _build.KERNELS.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        launches["norm_glu"] = launches.get("norm_glu", 0) + counts["norm_glu"]
        new = sum(len(v) for v in outs.values())
        st = eng.stats
        by_bucket = {}
        for bucket, ms in prefill_ms:
            by_bucket.setdefault(bucket, []).append(ms)
        log(f"[vision] {name}: {len(outs)}/{len(reqs)} requests "
            f"({sum(i is not None for i in images)} with image embeddings), "
            f"{new} new tokens, prompts {int(lens.sum())} tokens, {dt:.2f} s "
            f"({(new + int(lens.sum())) / dt:.0f} tok/s all, "
            f"{new / st['decode_s']:.1f} tok/s decode); prefill "
            f"{st['prefill_s'] * 1e3:.0f} ms in {st['prefills']} prefills ("
            + ", ".join(f"bucket {k_}: " + " / ".join(f"{v_:.0f}" for v_ in v)
                        + " ms" for k_, v in sorted(by_bucket.items()))
            + f"), decode {st['decode_s'] * 1e3:.0f} ms in "
            f"{st['decode_steps']} ticks "
            f"({st['decode_s'] * 1e3 / st['decode_steps']:.1f} ms/tick); peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB; "
            f"launches {counts}")
        if not all(len(outs.get(r.rid, [])) == 16 for r in reqs):
            fail(f"vision {name}: unfinished requests")
        if st["numeric"]:
            fail(f"vision {name}: {st['numeric']} non-finite rows quarantined")
        n_pre, n_dec = st["prefills"], st["decode_steps"]
        per = {k: tuple(n_layers[w] for w in v) for k, v in per_kernel.items()}
        for k, n in counts.items():
            a, b = per.get(k, (0, 0))
            want = a * n_pre + b * n_dec
            if n != want:
                fail(f"vision {name}: kernel {k} launched {n} times, "
                     f"expected {want} ({n_pre} prefills, {n_dec} ticks)")
        log(f"  ok exact launches: {n_pre} prefills x "
            + ", ".join(f"{k} {a}" for k, (a, _) in per.items() if a)
            + f"; {n_dec} ticks x "
            + ", ".join(f"{k} {b}" for k, (_, b) in per.items() if b)
            + "; every other kernel 0")
        del eng
        torch.cuda.empty_cache()

        # one bucket-1024 prefill with image embeddings and the first
        # decode step, kernels vs plain versions, the engine's impls
        prompt = prompts[0][:VISION_PARITY_BUCKET - 24]

        def step():
            eng = ServeEngine(cfg, params, device=dev,
                              **{**VISION, "n_slots": 1})
            row = init_caches(cfg, 1, VISION["max_seq"], dev)
            toks = torch.tensor([prompt + [0] * (VISION_PARITY_BUCKET
                                                 - len(prompt))], device=dev)
            pre = eng.prefill_logits(toks, row, torch.tensor(
                [len(prompt) - 1], device=dev), images[0])
            eng.caches = row
            nxt = torch.argmax(pre, dim=-1)[:, None]
            dec = eng.decode_logits(nxt, torch.tensor(
                [len(prompt)], dtype=torch.int32, device=dev))
            torch.cuda.synchronize()
            del eng, row
            return pre, dec
        kern = step()
        torch.cuda.empty_cache()
        with _plain_vision_kernels():
            plain = step()
        torch.cuda.empty_cache()
        tol = TOL_VISION_F if name == "float" else TOL_LOGITS_D
        for what, a, b in ((f"bucket-{VISION_PARITY_BUCKET} prefill",
                            kern[0], plain[0]),
                           ("first decode step", kern[1], plain[1])):
            check(f"llama-3.2-vision {name} full-width logits, {what}", a, b,
                  tol)
        del kern, plain
    del params, images
    gc.collect()
    torch.cuda.empty_cache()


# ---------------- phase 9: granite-moe, the unit in every expert ----------------

GRANITE_ID = "granite-moe-3b-a800m"
GRANITE = dict(max_seq=2048, n_slots=4, prefill_chunk=64)
# name: (config overrides, the launches of each kernel a layer in a
# prefill chunk and in a decode tick; every kernel not named launches 0
# times).  The router's softmax is torch.softmax; the expert products are
# batched cuBLAS products; row 2 runs once a MoE layer in dual-mode.
GRANITE_PATHS = {
    "float": (dict(softmax_impl="float", activation="silu", **FUSED),
              {"norm_linear": (1, 1), "resnorm": (1, 1),
               "decode_paged": (0, 1)}),
    "dualmode": (dict(softmax_impl="dualmode", activation="silu_dualmode",
                      **FUSED),
                 {"norm_linear": (1, 1), "resnorm": (1, 1),
                  "softmax_rows": (1, 0), "pair_act": (1, 1),
                  "decode_paged_int": (0, 1)})}
# each block, kernels vs plain versions on the same input, on the tokens
# whose expert sets agree: the yi / vision full-width limits
TOL_GRANITE = {"float": TOL_YI_LOGITS_F, "dualmode": TOL_LOGITS_D}
# under pressure: 6 prompts a few tokens short of a 128-token block, so
# that each request grows a block within its first new tokens and the
# tight pool (half the worst-case demand of 4 slots: 7 blocks) preempts
# by recompute and swaps (a CPU rehearsal of the schedule: 3 preemptions
# a run in ~45 ticks; the serve phase's prompts need 96 new tokens and
# ~316 ticks for one)
GRANITE_PRESSURE_LENS = (120, 124, 250, 126, 246, 118)
GRANITE_PRESSURE_NEW = 16
# train: full width, 8 of the 32 layers (all 32 with their gradients and
# two AdamW moments would be ~62 GB before activations), 1 x 2048 tokens
GRANITE_TRAIN = dict(layers=8, batch=1, seq=2048, steps=2, data_vocab=8192)
GRANITE_TRAIN_PER_LAYER = {"norm_linear": 2, "resnorm": 2}


def _route_spy(store: list):
    """Record every MoE routing call's (router input, router, expert ids)."""
    from repro_torch.models import moe
    inner = moe._route

    def route(p, s, x):
        out = inner(p, s, x)
        store.append((x, p["router"], out[1]))
        return out
    return mock.patch.object(moe, "_route", route)


def route_flips(plain, kern, k: int):
    """Two routing records of one call: (agree (B,S) whether the expert
    sets are equal, the margins of the tokens whose sets differ (the gap
    between the k-th and (k+1)-th router probability of the plain path),
    the largest router-probability difference on the agreeing tokens)."""
    (xp, router, ip), (xk, _, ik) = plain, kern
    r = router.to(torch.float64)
    pp = torch.softmax(xp.to(torch.float64) @ r, dim=-1)
    pk = torch.softmax(xk.to(torch.float64) @ r, dim=-1)
    agree = (ip.sort(-1).values == ik.sort(-1).values).all(-1)
    top = pp.sort(-1, descending=True).values
    gap = top[..., k - 1] - top[..., k]
    diff = float((pp - pk).abs()[agree].max()) if bool(agree.any()) else 0.0
    return agree, gap[~agree], diff


def granite_blocks(cfg, params, dev, prompt, name: str, tag: str = "granite",
                   geom: dict = GRANITE) -> dict:
    """One 64-token prefill chunk and the first decode step at full width
    on the paged engine of ``geom``, block by block: each block runs on
    the kernel path's input with the plain versions, then with the
    kernels (whose output feeds the next block); a MoE block's outputs
    held on the tokens whose expert sets agree, flips counted and each
    held to the flip rule (any other block's on every token); the logits
    finite."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import _positions_from
    from repro_torch.models.layers import make_norm
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, device=dev, **{**geom, "n_slots": 1})
    eng.pool.alloc(2)
    tables = torch.tensor([[1, 2] + [0] * (eng.max_blocks - 2)],
                          dtype=torch.int32, device=dev)
    specs, k, tol = tf.layer_specs(cfg), cfg.moe.top_k, TOL_GRANITE[name]
    report = {}

    def forward(phase_cfg, toks, pos, what):
        x = params["embed"][toks]
        positions = _positions_from(pos, 1, toks.shape[1], dev)
        worst, flips, margin = 0.0, [], 0.0
        for i, (lp, spec) in enumerate(zip(params["layers"], specs)):
            rp, rk = [], []
            with _plain_serve_kernels(), _route_spy(rp):
                yp, _, _ = tf.block_apply(lp, phase_cfg, spec, x,
                                          eng.caches[i], positions=positions,
                                          pos=pos, paged=tables)
            with _route_spy(rk):
                yk, _, _ = tf.block_apply(lp, phase_cfg, spec, x,
                                          eng.caches[i], positions=positions,
                                          pos=pos, paged=tables)
            agree = torch.ones(yk.shape[:2], dtype=torch.bool, device=dev)
            if spec.ffn == "moe":
                agree, margins, diff = route_flips(rp[0], rk[0], k)
                flips.append(int(margins.numel()))
                if margins.numel():
                    margin = max(margin, float(margins.max()))
                    log(f"  {name} {what} block {i}: {margins.numel()} "
                        f"route flips, margins {margins.tolist()}, largest "
                        f"router-probability difference on agreeing tokens "
                        f"{diff:.3e}")
                    if float(margins.max()) > 2 * diff:
                        fail(f"{tag} {name} {what} block {i}: a route flip "
                             f"at margin {float(margins.max()):.3e} > twice "
                             f"{diff:.3e}")
            e = max_err(yk[agree], yp[agree])
            if not torch.isfinite(yk).all() or e > tol:
                fail(f"{tag} {name} {what} block {i}: kernels vs plain "
                     f"{e:.3e} on agreeing tokens > {tol:.0e}")
            worst = max(worst, e)
            x = yk
        h = make_norm(cfg.norm)[1](params["final_norm"], x[:, -1:],
                                   cfg.norm_eps)
        logits = (h @ tf.lm_head_weight(params, cfg))[:, -1]
        if not torch.isfinite(logits).all():
            fail(f"{tag} {name} {what}: non-finite logits")
        log(f"  ok {tag} {name} {what}, {cfg.n_layers} blocks kernels vs "
            f"plain: worst {worst:.3e} on agreeing tokens (limit "
            f"{tol:.0e}); route flips a MoE block {flips} (largest margin "
            f"{margin:.3e}); logits finite")
        report[what] = dict(worst=worst, flips=flips, margin=margin)
        return logits

    with torch.no_grad():
        toks = torch.tensor([prompt[:64]], device=dev)
        chunk = forward(eng._prefill_cfg, toks, 0, "chunk")
        nxt = torch.argmax(chunk, dim=-1)[:, None]
        forward(eng._decode_cfg, nxt,
                torch.tensor([64], dtype=torch.int32, device=dev), "tick")
    del eng
    torch.cuda.empty_cache()
    return report


def granite_moe_times(cfg, params, dev) -> dict:
    """Host and device time of the MoE sublayer of layer 0 at a decode
    tick's shape (4 slots, one token each, dropless): routing, the sort
    (ranks and the dispatch plan), dispatch, the expert products,
    combine, and the whole sublayer."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import moe_spec
    out = {}
    p = params["layers"][0]["ffn"]
    e_buf, d = p["gate"].shape[0], cfg.d_model
    h = torch.randn((4, 1, d), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    for name, (over, _) in GRANITE_PATHS.items():
        s = moe_spec(cfg.replace(**over))
        cap = moe.capacity(s, 1, dropless=True)
        with torch.no_grad():
            gates, idx, _ = moe._route(p, s, h)
            gk, dest, keep, rows = moe.slots(s, e_buf, gates, idx, cap)
            buf = moe.dispatch(h.reshape(4, d), dest, keep, rows)
            hb = moe.experts(p, s, buf.view(e_buf, 4 * cap, d))
            parts = {
                "route": lambda: moe._route(p, s, h),
                "sort": lambda: moe.slots(s, e_buf, gates, idx, cap),
                "dispatch": lambda: moe.dispatch(h.reshape(4, d), dest, keep,
                                                 rows),
                "experts": lambda: moe.experts(p, s, buf.view(
                    e_buf, 4 * cap, d)),
                "combine": lambda: moe.combine(hb.view(rows, d), gk, dest,
                                               keep),
                "moe_apply": lambda: moe.moe_apply(p, s, h, dropless=True)}
            row = {}
            for part, fn in parts.items():
                host, wall = host_ms(fn, iters=30)
                row[part] = dict(host_ms=host, wall_ms=wall,
                                 graph_ms=graph_ms(fn))
        out[name] = row
    log(f"[granite moe tick] layer 0's MoE sublayer at a tick (4 x 1 "
        f"tokens, dropless, C 1, {e_buf} x 4 buffer rows): ms a call, host "
        "to launch / back to back / device under graph replay: "
        + json.dumps(out))
    return out


def granite_phase(dev, launches):
    """Full-width granite-moe-3b-a800m: serve float and dual-mode (exact
    launches a chunk and a tick), each block kernels vs plain with the
    route-flip rule, the MoE sublayer's parts timed at a tick, the
    pressure runs; then train at 8 of 32 layers."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import tree_leaves
    gc.collect()                    # the vision phase's weights
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    base = registry.get_config(GRANITE_ID)
    t0 = time.perf_counter()
    params = init_lm(base, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in tree_leaves(params))
    m = base.moe
    log(f"[granite] {GRANITE_ID} full width and depth: {base.n_layers} "
        f"layers d {base.d_model} heads {base.n_heads}/{base.n_kv_heads} h "
        f"{base.hd}, {m.n_experts} experts top-{m.top_k} (stacks of "
        f"{max(m.ep_pad, m.n_experts)}) d_ff {m.d_ff}, vocab {base.vocab} "
        f"tied, {n_par / 1e9:.3f} B parameters; init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB allocated")
    rng = np.random.RandomState(0)      # the qwen phase's prompt lengths
    lens = rng.randint(100, 1501, size=6)
    prompts = [rng.randint(0, base.vocab, size=n).tolist() for n in lens]
    streams = {}
    for name, (over, per_layer) in GRANITE_PATHS.items():
        cfg = base.replace(**over)
        eng = ServeEngine(cfg, params, device=dev, **GRANITE)
        if (eng.cache_mode, eng.prefill_attn_impl, eng.decode_attn_impl) != (
                "paged", "naive", "flash_decode"):
            fail(f"granite {name}: cache {eng.cache_mode}, prefill "
                 f"{eng.prefill_attn_impl}, decode {eng.decode_attn_impl}")
        reqs = [Request(rid=i, prompt=p, max_new=16)
                for i, p in enumerate(prompts)]
        for k in _build.KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        for k in per_layer:
            launches[k] = launches.get(k, 0) + counts[k]
        new = sum(len(v) for v in outs.values())
        st = eng.stats
        n_chunks, n_ticks = st["prefill_chunks"], st["decode_steps"]
        log(f"[granite] {name}: {len(outs)}/{len(reqs)} requests, {new} new "
            f"tokens, prompts {int(lens.sum())} tokens, {dt:.2f} s "
            f"({(new + int(lens.sum())) / dt:.0f} tok/s all, "
            f"{new / st['decode_s']:.1f} tok/s decode); prefill "
            f"{st['prefill_s'] * 1e3:.0f} ms in {n_chunks} chunks "
            f"({st['prefill_s'] * 1e3 / n_chunks:.1f} ms/chunk), decode "
            f"{st['decode_s'] * 1e3:.0f} ms in {n_ticks} ticks "
            f"({st['decode_s'] * 1e3 / n_ticks:.1f} ms/tick); peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB; "
            f"launches {counts}")
        if not all(len(outs.get(r.rid, [])) == 16 for r in reqs):
            fail(f"granite {name}: unfinished requests")
        if eng.pool.in_use() != 0 or st["numeric"]:
            fail(f"granite {name}: pool {eng.pool.in_use()}, numeric "
                 f"{st['numeric']}")
        for k, n in counts.items():
            a, b = per_layer.get(k, (0, 0))
            want = base.n_layers * (a * n_chunks + b * n_ticks)
            if n != want:
                fail(f"granite {name}: kernel {k} launched {n} times, "
                     f"expected {want} ({n_chunks} chunks, {n_ticks} ticks)")
        log(f"  ok exact launches, a layer: chunk "
            + ", ".join(f"{k} {a}" for k, (a, _) in per_layer.items() if a)
            + "; tick " + ", ".join(f"{k} {b}" for k, (_, b)
                                    in per_layer.items() if b)
            + "; every other kernel 0")
        streams[name] = outs
        del eng
        torch.cuda.empty_cache()
        granite_blocks(cfg, params, dev, prompts[0], name)
    same = sum(streams["float"][r] == streams["dualmode"][r]
               for r in streams["float"])
    log(f"[granite] greedy streams (reported, not gated): float "
        f"{ {r: v[:8] for r, v in sorted(streams['float'].items())} }, "
        f"dual-mode { {r: v[:8] for r, v in sorted(streams['dualmode'].items())} }"
        f"; {same} of {len(streams['float'])} identical across the modes")
    granite_moe_times(base, params, dev)
    rng = np.random.RandomState(9)
    short = [rng.randint(0, base.vocab, size=n).tolist()
             for n in GRANITE_PRESSURE_LENS]
    tight = tight_pool("granite pressure", GRANITE_ID, short,
                       GRANITE_PRESSURE_NEW)
    over, per_layer = GRANITE_PATHS["float"]
    pressure_runs("granite pressure", "float", base.replace(**over), params,
                  dev, short, GRANITE_PRESSURE_NEW, tight, per_layer,
                  launches, **GRANITE)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    granite_train_phase(dev, launches)
    log(f"[granite] phase {time.perf_counter() - t_phase:.1f} s")


def granite_train_phase(dev, launches):
    """The Trainer at full width and 8 of 32 layers, remat, fused impls,
    2 steps of 1 x 2048 tokens: loss and aux finite, aux 1 a layer with a
    zero router (Switch's normalization: uniform probabilities, the
    lower-index ties), exact launches, a step repeated from one state
    gives the same bits, one step's loss and gradients through the
    kernels match the plain versions'."""
    import shutil
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import lm_apply
    from repro_torch.train import Trainer, make_grad_fn
    from repro_torch.tree import tree_leaves, tree_paths
    torch.cuda.reset_peak_memory_stats(dev)
    tr = GRANITE_TRAIN
    cfg = registry.get_config(GRANITE_ID).replace(
        n_layers=tr["layers"], **GRANITE_PATHS["float"][0])
    b, seq, steps = tr["batch"], tr["seq"], tr["steps"]
    data = SyntheticLM(vocab=tr["data_vocab"], seq_len=seq, global_batch=b,
                       seed=0)
    tmp = tempfile.mkdtemp(prefix="repro_torch_granite_")
    try:
        tcfg = TrainConfig(lr=3e-4, warmup_steps=1, remat=True,
                           total_steps=steps, checkpoint_every=1000,
                           checkpoint_dir=tmp)
        trainer = Trainer(cfg, tcfg, b, seq, device=dev, data=data,
                          log=lambda *_: None)
        n_par = sum(p.numel() for p in tree_leaves(trainer.state.params))
        log(f"[granite train] {GRANITE_ID} full width, {cfg.n_layers} of 32 "
            f"layers, {n_par / 1e9:.3f} B parameters; batch {b} x {seq}, "
            f"data vocab {tr['data_vocab']}, remat, CE + 0.01 aux")
        for k in _build.KERNELS.values():
            k.launches = 0
        hist = []
        for i in range(steps):
            mt = trainer.run(1)
            hist.append(mt)
            log(f"  step {i}: loss {mt['loss']:.5f} ce {mt['ce']:.5f} aux "
                f"{mt['aux']:.5f} ({mt['aux'] / cfg.n_layers:.4f} a layer) "
                f"grad_norm {mt['grad_norm']:.4f} "
                f"{trainer.step_times[-1] * 1e3:.0f} ms")
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        log(f"[granite train] {steps} steps, last "
            f"{trainer.step_times[-1] * 1e3:.0f} ms a step (first "
            f"{trainer.step_times[0] * 1e3:.0f} ms), peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB; "
            f"launches {counts}")
        if not np.isfinite([[mt["loss"], mt["aux"]] for mt in hist]).all():
            fail(f"granite train: non-finite loss or aux {hist}")
        for k, n in counts.items():
            want = GRANITE_TRAIN_PER_LAYER.get(k, 0) * cfg.n_layers * steps
            if n != want:
                fail(f"granite train: kernel {k} launched {n} times, "
                     f"expected {want}")
        for k in GRANITE_TRAIN_PER_LAYER:
            launches[k] = launches.get(k, 0) + counts[k]

        state = trainer.state
        tokens, labels = data.batch(steps)
        batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
        zero = {**state.params, "layers": [
            {**lp, "ffn": {**lp["ffn"], "router": torch.zeros_like(
                lp["ffn"]["router"])}} for lp in state.params["layers"]]}
        with torch.no_grad():
            _, _, aux_z = lm_apply(zero, cfg, batch["tokens"],
                                   return_hidden=True, return_aux=True,
                                   device=dev)
        aux_z = float(aux_z) / cfg.n_layers
        if not abs(aux_z - 1.0) < 1e-5:
            fail(f"granite train: aux a layer {aux_z:.7f} with a zero "
                 "router, not 1")
        log(f"  ok aux with a zero router: {aux_z:.7f} a layer (Switch's "
            f"normalization; the random router's at initialisation: "
            f"{hist[0]['aux'] / cfg.n_layers:.4f} a layer)")
        del zero
        s1, m1 = trainer.step_fn(state, batch)
        s2, m2 = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(tree_leaves(s1),
                                                      tree_leaves(s2))
                   if torch.is_tensor(x))
        same = same and all(torch.equal(torch.as_tensor(m1[k]),
                                        torch.as_tensor(m2[k])) for k in m1)
        if not same:
            fail("granite train: one step from the same state gave other "
                 "bits")
        log(f"  ok a step repeated from one state: identical bits (loss "
            f"{float(m1['loss']):.6f}, aux {float(m1['aux']):.6f})")
        del s1, s2

        grad_fn = make_grad_fn(cfg, tcfg, dev)
        (loss_k, _), g_k = grad_fn(state.params, batch)
        with _plain_train_kernels():
            (loss_p, _), g_p = grad_fn(state.params, batch)
        torch.cuda.synchronize()
        rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        if rel > TOL_TRAIN_LOSS:
            fail(f"granite train: loss kernels {float(loss_k)} vs plain "
                 f"{float(loss_p)} (relative {rel:.2e})")
        worst, worst_at = 0.0, "(every tensor)"
        for (path, gk), gp in zip(tree_paths(g_k), tree_leaves(g_p)):
            r = max_err(gk, gp) / max(float(gp.abs().max()), 1e-30)
            if r > worst:
                worst, worst_at = r, path
        if worst > TOL_TRAIN_GRAD:
            fail(f"granite train: gradient {worst_at} kernels vs plain "
                 f"{worst:.2e} of its max > {TOL_TRAIN_GRAD:.0e}")
        log(f"  ok one step, kernels vs plain: loss (CE + 0.01 aux) relative "
            f"{rel:.2e} (limit {TOL_TRAIN_LOSS:.0e}), worst gradient "
            f"{worst_at} {worst:.2e} of its max (limit "
            f"{TOL_TRAIN_GRAD:.0e})")
        del g_k, g_p, trainer, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------- phase 10: whisper-base, minicpm3-4b and qwen3-14b ----------------
#
# The remaining attention families at full width and depth, random
# weights from a seeded generator: an encoder-decoder with the unit's GELU
# (whisper-base, contiguous cache), MLA (minicpm3-4b, paged latent pools)
# and GQA with qk-norm at G 5 (qwen3-14b, paged).  The limits, stated
# before the first chip run: each kernel at the path's new shapes against
# its plain version at the kernel limits above (rows 5-8 at MLA's h 96 /
# hv 64, K 40, G 1; rows 7 / 8 non-causal over whisper's 1500 frames;
# rows 3 / 4 at G 5); the encoder's output and the logits of one prefill
# (chunk) and of the first decode step, kernels vs the plain versions
# called in their place: float 1e-4, dual-mode 5e-3 (the yi / vision /
# bert limits, PERF.md section 2); exact launches a layer of an encoder
# pass, a prefill (chunk) and a tick, and no other kernel; every request
# finishes with all its tokens, a paged pool drains, no row is
# quarantined.  Greedy streams are reported, not gated.

TOL_FAMILY = {"float": TOL_YI_LOGITS_F, "dualmode": TOL_LOGITS_D}
WHISPER_ID = "whisper-base"
# whisper's text context; every prompt fits the one bucket; the blocked
# kernels and the contiguous decode asked for by name (at these sizes
# 'auto' would pick the naive path everywhere)
WHISPER = dict(max_seq=448, n_slots=4, prefill_buckets=(16,),
               decode_attn_impl="flash_decode")
WHISPER_PROMPT_LENS = (4, 16)
WHISPER_NEW = 64
# name: (config overrides, prefill impl, the launches of each kernel a
# layer of an encoder pass, of a prefill and of a tick; every kernel not
# named launches 0 times).  A decoder layer: norm -> QKV (row 15), self
# and cross attention (rows 7 / 8 at a prefill, 5 / 6 at a tick), the
# ungated GELU MLP (row 2 in dual-mode, plain PyTorch in float); an
# encoder layer adds the residual-norm epilogue (row 14).
WHISPER_PATHS = {
    "float": (dict(softmax_impl="float", activation="gelu_tanh",
                   norm_impl="fused_pallas"), "flash_pallas",
              {"norm_linear": (1, 1, 1), "resnorm": (1, 0, 0),
               "flash_fwd": (1, 2, 0), "decode_dense": (0, 0, 2)}),
    "dualmode": (dict(softmax_impl="dualmode", activation="gelu_dualmode",
                      norm_impl="fused_pallas"), "flash_pallas_int",
                 {"norm_linear": (1, 1, 1), "resnorm": (1, 0, 0),
                  "flash_snap": (1, 2, 0), "pair_act": (1, 1, 1),
                  "decode_dense_int": (0, 0, 2)})}
MINICPM_ID = "minicpm3-4b"
QWEN3_ID = "qwen3-14b"
FAMILY_PAGED = dict(max_seq=2048, n_slots=4, prefill_chunk=64)
# name: (config overrides, the launches of each kernel a layer of a
# prefill chunk and of a tick).  minicpm3: an MLA mixer takes the plain
# norm1 (no norm -> QKV seam), its 64-token chunk attends naively (row 1
# in dual-mode) and its tick through the contiguous decode on the
# gathered, expanded latent (rows 5 / 6).  qwen3: yi's path, at G 5.
MINICPM_PATHS = {
    "float": (dict(softmax_impl="float", activation="silu", **FUSED),
              {"resnorm": (1, 1), "glu": (1, 1), "decode_dense": (0, 1)}),
    "dualmode": (dict(softmax_impl="dualmode", activation="silu_dualmode",
                      **FUSED),
                 {"resnorm": (1, 1), "softmax_rows": (1, 0),
                  "pair_act": (1, 1), "decode_dense_int": (0, 1)})}
QWEN3_PATHS = {
    "float": (dict(softmax_impl="float", activation="silu", **FUSED),
              {"norm_linear": (1, 1), "resnorm": (1, 1), "glu": (1, 1),
               "decode_paged": (0, 1)}),
    "dualmode": (dict(softmax_impl="dualmode", activation="silu_dualmode",
                      **FUSED),
                 {"norm_linear": (1, 1), "resnorm": (1, 1),
                  "softmax_rows": (1, 0), "pair_act": (1, 1),
                  "decode_paged_int": (0, 1)})}


def _randn_fn(dev, seed: int):
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*shape, scale=1.0, grid=False):
        x = torch.randn(shape, generator=gen) * scale
        return (torch.round(x * 4) / 16 if grid else x).to(dev)
    return randn


def seam_checks(tag: str, dev, cfg, rows, score_rows=None) -> None:
    """The block's seams and the unit's modes at a model's widths, against
    their plain versions: the residual-norm epilogue (row 14; sum bitwise,
    normed row TOL_NORM), the norm -> QKV prologue (row 15) and, for a
    gated MLP, the fused GLU (row 12) at TOL_GEMM, the pair mode (row 2)
    over the FFN's width and, with ``score_rows`` (rows, keys), the row
    softmax (row 1) bitwise; each at the path's row counts ``rows``."""
    from repro_torch.kernels import dualmode_softmax as ds
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_norm as fn
    randn = _randn_fn(dev, 17)
    d, f, kind, eps = cfg.d_model, cfg.d_ff, cfg.norm, cfg.norm_eps
    mode = "gelu" if cfg.activation.startswith("gelu") else "silu"
    g = 1.0 + randn(d, scale=0.1)
    b = randn(d, scale=0.1) if kind == "layer" else None
    nq, nk = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    ws = (randn(d, nq, scale=d ** -0.5), randn(d, nk, scale=d ** -0.5),
          randn(d, nk, scale=d ** -0.5))
    if cfg.gated_mlp:
        wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    for m in rows:
        x, r = randn(m, d, scale=2.0), randn(m, d)
        got = fn.fused_residual_norm(x, r, g, b, kind=kind, eps=eps)
        want = fn.fused_residual_norm_plain(x, r, g, b, kind=kind, eps=eps)
        check(f"{tag} resnorm sum ({m}, {d})", got[0], want[0], TOL_INT)
        check(f"{tag} resnorm normed ({m}, {d})", got[1], want[1], TOL_NORM)
        if cfg.mla is None:
            check(f"{tag} norm_linear ({m}, {d}) x {nq}+{nk}+{nk}",
                  fn.fused_norm_linear(x, g, b, ws, kind=kind, eps=eps),
                  fn.fused_norm_linear_plain(x, g, b, ws, kind=kind,
                                             eps=eps), TOL_GEMM)
        if cfg.gated_mlp:
            check(f"{tag} glu {mode} ({m}, {d}) x {f}",
                  ff.fused_glu(x, wg, wu, mode=mode),
                  ff._glu_reference(x, wg, wu, mode), TOL_GEMM)
        z = randn(m, f, scale=4.0)
        check(f"{tag} pair_act {mode} int ({m}, {f})",
              ds.pair_act(z, mode, "int"), ds.pair_act_plain(z, mode, "int"),
              TOL_INT)
    if score_rows is not None:
        n, t = score_rows
        x = randn(n, t, scale=3.0)
        x[:, t // 2:] = -30.0              # the chunk's masked keys
        check(f"{tag} softmax_rows int ({n}, {t})",
              ds.softmax_rows(x, "int"), ds.softmax_rows_plain(x, "int"),
              TOL_INT)


def flash_pair_checks(tag: str, dev, s: int, t: int, kh: int, h: int,
                      hv: int, causal: bool, q_end: int | None = None,
                      ragged: bool = False):
    """Rows 7 and 8 at one shape against their plain versions: row 7 on
    random operands (TOL_FLASH_F); row 8's m and S words bitwise and its
    output within TOL_FLASH_F on grid-valued q and k, its output within
    TOL_FLASH_I on random ones.  Returns the random operands."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    randn = _randn_fn(dev, s + t + kh)
    end = t if q_end is None else q_end
    qp = torch.arange(end - s, end, dtype=torch.int32, device=dev)[None]
    valid = (torch.arange(t, device=dev)[None] < end).to(torch.uint8)
    if ragged:
        valid[:, 0] = 0
    kw = dict(causal=causal, block_kv=64)
    gs = fai.unit.guard_shift_for(t)
    out = None
    for grid in (True, False):
        args = ((randn(1, s, kh, 1, h, grid=grid)
                 * (1.0 if grid else h ** -0.5)).contiguous(),
                randn(1, t, kh, h, grid=grid), randn(1, t, kh, hv), qp, valid)
        name = (f"{tag} (1,{s},{t},{kh},1,{h},{hv}) "
                f"{'causal' if causal else 'non-causal'} grid={grid}")
        check(f"flash_fwd {name}", fa.flash_fwd(*args, **kw),
              fa.flash_fwd_plain(*args, **kw), TOL_FLASH_F)
        if grid:
            got = fai.flash_snap(*args, guard_shift=gs, return_partial=True,
                                 **kw)
            want = fai.flash_snap_plain(*args, guard_shift=gs,
                                        return_partial=True, **kw)
            check(f"flash_snap m {name}", got[1], want[1], TOL_INT)
            check(f"flash_snap S {name}", got[2], want[2], TOL_INT)
        check(f"flash_snap {name}", fai.flash_snap(*args, guard_shift=gs,
                                                   **kw),
              fai.flash_snap_plain(*args, guard_shift=gs, **kw),
              TOL_FLASH_F if grid else TOL_FLASH_I)
        out = args
    return out


def decode_pair_checks(tag: str, dev, q_pos, t: int, kh: int, h: int,
                       hv: int, causal: bool):
    """Rows 5 and 6 at one shape against their plain versions, at the
    wrappers' splits and tile (``fd.dense_decode_tiles``): float on random
    operands (TOL_DECODE_F), int with m and S words bitwise on grid-valued
    q and k and within TOL_DECODE_I on random ones.  Returns (random
    operands, splits, tile)."""
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import flash_decode as fd
    randn = _randn_fn(dev, t + kh + h)
    b = len(q_pos)
    qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    valid = ((torch.arange(t, device=dev)[None] <= qp[:, None]) if causal
             else torch.ones(b, t, dtype=torch.bool, device=dev)).to(
                 torch.uint8)
    ns, bk = fd.dense_decode_tiles(t, b * kh, dev)
    kw = dict(num_splits=ns, block_kv=bk, causal=causal,
              guard_shift=unit.guard_shift_for(t))
    out = None
    for grid in (True, False):
        qf = randn(b, kh, 1, h) * h ** -0.5
        k = randn(b, t, kh, h, grid=grid)
        if grid:
            qf = torch.round(qf * 32) / 32
        args = (qf.contiguous(), k, randn(b, t, kh, hv), qp, valid)
        name = (f"{tag} B{b} K{kh} G1 h{h} hv{hv} T{t} "
                f"{'causal' if causal else 'non-causal'} grid={grid} "
                f"splits={ns} bkv={bk}")
        if not grid:
            check(f"decode_dense {name}", fd.finish_partials(
                *fd.decode_dense_partials(*args, int_mode=False, **kw),
                int_mode=False), fd.finish_partials(
                *fd.decode_dense_partials_plain(*args, int_mode=False,
                                                **kw), int_mode=False),
                TOL_DECODE_F)
        ki = fd.decode_dense_partials(*args, int_mode=True, **kw)
        pi = fd.decode_dense_partials_plain(*args, int_mode=True, **kw)
        if grid:
            check(f"decode_dense_int m {name}", ki[0], pi[0], TOL_INT)
            check(f"decode_dense_int S {name}", ki[1], pi[1], TOL_INT)
        check(f"decode_dense_int {name}",
              fd.finish_partials(*ki, int_mode=True),
              fd.finish_partials(*pi, int_mode=True),
              TOL_DECODE_F if grid else TOL_DECODE_I)
        out = args
    return out, ns, bk


def whisper_kernel_checks(dev, cfg) -> None:
    """whisper-base's kernels at its path's shapes: rows 7 / 8 non-causal
    over the 1500 frames (the encoder, and a bucket-16 cross prefill; 1500
    = 23 x 64 + 28, a phantom tail of 36 keys) and causal over a 448-key
    row (the self prefill); rows 5 / 6 over the 1500 cross keys and a
    self tick of 4 slots; rows 14, 15 (layer norm, d 512) and 2 (GELU,
    2048 wide) at the encoder's 1500 rows, a prefill's 16 and a tick's 4."""
    kh, h, t = cfg.n_kv_heads, cfg.hd, cfg.n_frames
    log(f"[whisper] kernels at the path's shapes")
    flash_pair_checks("encoder", dev, t, t, kh, h, h, False)
    flash_pair_checks("cross prefill", dev, 16, t, kh, h, h, False)
    flash_pair_checks("self prefill", dev, 16, WHISPER["max_seq"], kh, h, h,
                      True, q_end=16, ragged=True)
    decode_pair_checks("cross tick", dev, [0, 0, 0, 0], t, kh, h, h, False)
    decode_pair_checks("self tick", dev, [20, 79, 150, 447],
                       WHISPER["max_seq"], kh, h, h, True)
    seam_checks("whisper", dev, cfg, (t, 16, 4))


def minicpm_kernel_checks(dev, cfg, results) -> None:
    """minicpm3-4b's kernels at MLA's head dims (q.k over nope + rope =
    96, v at 64, K 40, G 1): rows 7 / 8 over a whole 2048-token prompt
    (S = T = 2048, causal: the blocked pick) and a 64-token chunk at the
    end of a 2048-key table; rows 5 / 6 at a tick of 4 slots over 2048
    keys; rows 5 and 7 timed beside their bounds and SDPA (which takes hv
    != h); rows 14, 12, 2 at d 2560, F 6400 and row 1 over a dual-mode
    chunk's 40 x 64 score rows of 2048 keys."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    kh = cfg.n_heads
    h, hv = cfg.mla.nope_dim + cfg.mla.rope_dim, cfg.mla.v_dim
    t = FAMILY_PAGED["max_seq"]
    log(f"[minicpm3] kernels at MLA's head dims h {h} hv {hv} K {kh} G 1")
    flash_pair_checks("mla chunk", dev, 64, t, kh, h, hv, True)
    args = flash_pair_checks("mla prompt", dev, t, t, kh, h, hv, True)
    mla: dict = {}
    kw = dict(causal=True, block_kv=64)
    pairs = t * (t + 1) // 2 * kh
    q_l = args[0][0].permute(1, 2, 0, 3).reshape(1, kh, t, h)
    k_l, v_l = args[1].permute(0, 2, 1, 3), args[2].permute(0, 2, 1, 3)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_l, k_l, v_l, is_causal=True, scale=1.0), iters=5)
    del q_l, k_l, v_l
    kernel_row(
        mla, f"flash_fwd mla B1 S{t} K{kh} G1 h{h} hv{hv} causal",
        lambda: fa.flash_fwd(*args, **kw),
        lambda: fa.flash_fwd_plain(*args, **kw),
        *bound((args[0].numel() + args[1].numel() + args[2].numel()
                + t * kh * hv) * 4 + 5 * t, pairs * (2 * h + 2 * hv + 4)),
        lib, iters=5, plain_iters=1)
    depths = [700, 1000, 1500, t - 1]
    dargs, ns, bk = decode_pair_checks("mla tick", dev, depths, t, kh, h, hv,
                                       True)
    b = len(depths)
    live = max(depths) + 1
    q_l = dargs[0].reshape(b, kh, 1, h)
    k_l = dargs[1][:, :live].permute(0, 2, 1, 3)
    v_l = dargs[2][:, :live].permute(0, 2, 1, 3)
    mask = dargs[4][:, :live].bool()[:, None, None, :]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_l, k_l, v_l, attn_mask=mask, scale=1.0))
    del q_l, k_l, v_l
    keys = sum(depths) + b
    kernel_row(
        mla, f"decode_dense mla B{b} K{kh} G1 h{h} hv{hv} T{t} depths "
        f"{depths}",
        lambda: fd.decode_dense_partials(*dargs, num_splits=ns, block_kv=bk,
                                         causal=True, int_mode=False,
                                         guard_shift=0),
        lambda: fd.decode_dense_partials_plain(
            *dargs, num_splits=ns, block_kv=bk, causal=True, int_mode=False,
            guard_shift=0),
        *bound(keys * kh * (h + hv) * 4 + keys + dargs[0].numel() * 4
               + 4 * ns * kh * (hv + 2) * b, keys * kh * (2 * h + 2 * hv + 4)),
        lib, iters=50, plain_iters=3, splits=ns, block_kv=bk)
    results["mla_ms"] = mla
    log("[mla attention] rows 7 / 5 at MLA's head dims, ms: "
        + json.dumps(mla))
    seam_checks("minicpm3", dev, cfg, (64, 4), score_rows=(kh * 64, t))


def qwen3_kernel_checks(dev, cfg, results) -> None:
    """qwen3-14b's kernels at its path's shapes: rows 3 / 4 at its tick
    (4 slots, 8 kv heads of G 5 queries -- the kernel's 8-row
    instantiation with 3 rows idle -- h 128, 16 pages of 128 keys, shuffled
    tables) at 1 split and the plan's; rows 15, 14, 12, 2 at d 5120, F
    17408 and row 1 over a dual-mode chunk's 40 x 64 score rows."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tiling
    randn = _randn_fn(dev, 23)
    b, kh, g, h = 4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    t = FAMILY_PAGED["max_seq"]
    bs = tiling.paged_block_size(t)
    nblk = t // bs
    log(f"[qwen3] kernels: paged decode at G {g}, h {h}")
    n_pool = 1 + b * nblk
    gen = torch.Generator(device="cpu").manual_seed(29)
    ids = (torch.randperm(n_pool - 1, generator=gen) + 1).reshape(b, nblk)
    depths = [100, 700, 1300, t - 1]
    qp = torch.tensor(depths, dtype=torch.int32)
    past = (qp[:, None] // bs) < torch.arange(nblk)[None, :]
    tables = torch.where(past, 0, ids).to(torch.int32).to(dev)
    valid = (torch.arange(t)[None] <= qp[:, None]).to(torch.uint8).to(dev)
    plan = tiling.decode_splits(nblk, bs, b * kh, dev)
    for grid in (True, False):
        qf = randn(b, kh, g, h) * h ** -0.5
        k = randn(n_pool, bs, kh, h, grid=grid)
        if grid:
            qf = torch.round(qf * 32) / 32
        args = (qf.contiguous(), k, randn(n_pool, bs, kh, h), tables,
                qp.to(dev), valid)
        for ns in sorted({1, plan}):
            kw = dict(num_splits=ns, causal=True, guard_shift=0)
            for int_mode in (False, True):
                name = (f"decode_paged{'_int' if int_mode else ''} qwen3 "
                        f"B{b} K{kh} G{g} h{h} T{t} grid={grid} "
                        f"splits={ns}")
                got = fd.decode_paged_partials(*args, int_mode=int_mode, **kw)
                want = fd.decode_paged_partials_plain(*args,
                                                      int_mode=int_mode, **kw)
                if int_mode and grid:
                    check(f"{name} m", got[0], want[0], TOL_INT)
                    check(f"{name} S", got[1], want[1], TOL_INT)
                check(name, fd.finish_partials(*got, int_mode=int_mode),
                      fd.finish_partials(*want, int_mode=int_mode),
                      TOL_DECODE_I if int_mode and not grid
                      else TOL_DECODE_F)
    seam_checks("qwen3", dev, cfg, (64, 4),
                score_rows=(cfg.n_heads * 64, t))


def _free_weights(dev) -> None:
    """Drop every earlier phase's weights and pools from the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def _model(tag: str, base, dev, depth_of: int | None = None):
    """Full-width random weights of ``base`` from a seeded generator on
    the card, at its depth (``depth_of``: the published depth it was cut
    from); logs their size."""
    from repro_torch.models.transformer import init_lm
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    params = init_lm(base, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in tree_leaves(params))
    depth = (f"full width and depth: {base.n_layers}" if depth_of is None
             else f"full width, {base.n_layers} of its {depth_of}")
    log(f"[{tag}] {base.name} {depth} layers"
        + (f" (+ {base.enc_layers} encoder)" if base.enc_layers else "")
        + f" d {base.d_model} heads {base.n_heads}/{base.n_kv_heads} h "
        f"{base.hd} d_ff {base.d_ff} vocab {base.vocab}, "
        f"{n_par / 1e9:.3f} B parameters; init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB allocated")
    return params


def _serve_run(tag: str, name: str, eng, reqs, new: int, per_layer: dict,
               launches: dict, expected) -> dict:
    """Run ``reqs`` on ``eng`` with every launch count at 0 before it; log
    its numbers; fail unless every request finishes with ``new`` tokens,
    no row is quarantined, a paged pool drains and each kernel launched
    exactly ``expected(per_layer's entry, stats)`` times (0 for a kernel
    not named).  Adds the path's counts to ``launches``; returns the
    streams."""
    from repro_torch.kernels import _build
    for k in _build.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(eng.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    for k in per_layer:
        launches[k] = launches.get(k, 0) + counts[k]
    st = eng.stats
    n_new = sum(len(v) for v in outs.values())
    n_prompt = sum(len(r.prompt) for r in reqs)
    n_pre = st["prefill_chunks"] if eng.cache_mode == "paged" \
        else st["prefills"]
    what = "chunks" if eng.cache_mode == "paged" else "prefills"
    log(f"[{tag}] {name}: {len(outs)}/{len(reqs)} requests, {n_new} new "
        f"tokens, prompts {n_prompt} tokens, {dt:.2f} s "
        f"({(n_new + n_prompt) / dt:.0f} tok/s all, "
        f"{n_new / st['decode_s']:.1f} tok/s decode); prefill "
        f"{st['prefill_s'] * 1e3:.0f} ms in {n_pre} {what} "
        f"({st['prefill_s'] * 1e3 / n_pre:.1f} ms each), decode "
        f"{st['decode_s'] * 1e3:.0f} ms in {st['decode_steps']} ticks "
        f"({st['decode_s'] * 1e3 / st['decode_steps']:.1f} ms/tick); peak "
        f"{torch.cuda.max_memory_allocated(eng.device) / 2**30:.1f} GiB; "
        f"launches {counts}")
    if not all(len(outs.get(r.rid, [])) == new for r in reqs):
        fail(f"{tag} {name}: unfinished requests")
    if st["numeric"]:
        fail(f"{tag} {name}: {st['numeric']} non-finite rows quarantined")
    if eng.pool is not None and eng.pool.in_use() != 0:
        fail(f"{tag} {name}: pool did not drain ({eng.pool.in_use()} blocks)")
    for k, n in counts.items():
        want = expected(per_layer.get(k), st)
        if n != want:
            fail(f"{tag} {name}: kernel {k} launched {n} times, expected "
                 f"{want} ({n_pre} {what}, {st['decode_steps']} ticks)")
    log(f"  ok exact launches a layer: "
        + "; ".join(f"{k} {v}" for k, v in per_layer.items())
        + "; every other kernel 0")
    return outs


def _report_streams(tag: str, streams: dict) -> None:
    same = sum(streams["float"][r] == streams["dualmode"][r]
               for r in streams["float"])
    log(f"[{tag}] greedy streams (reported, not gated): "
        + "; ".join(f"{m} { {r: v[:8] for r, v in sorted(s.items())} }"
                    for m, s in streams.items())
        + f"; {same} of {len(streams['float'])} identical across the modes")


def whisper_phase(dev, launches):
    """Full-width whisper-base (every cross_gate 0.5), float and dual-mode
    (the unit's softmax and GELU modes), on the contiguous engine: 6
    requests, each with its own (1, 1500, 512) frames, which the encoder
    turns into the decoder's context at admission, prompts of 4-16
    tokens, 64 new tokens each; exact launches; the encoder's output and
    one prefill and decode step, kernels vs plain versions."""
    from repro_torch.configs import registry
    from repro_torch.models.transformer import encoder_apply, init_caches
    from repro_torch.serve import Request, ServeEngine
    _free_weights(dev)
    t_phase = time.perf_counter()
    base = registry.get_config(WHISPER_ID)
    whisper_kernel_checks(dev, base)
    params = _model("whisper", base, dev)
    for lp in params["layers"]:
        lp["cross_gate"].fill_(VISION_GATE)
    rng = np.random.RandomState(5)
    lens = rng.randint(WHISPER_PROMPT_LENS[0], WHISPER_PROMPT_LENS[1] + 1,
                       size=6)
    prompts = [rng.randint(0, base.vocab, size=n).tolist() for n in lens]
    gen = torch.Generator(device=dev).manual_seed(5)
    frames = [torch.randn((1, base.n_frames, base.d_model), generator=gen,
                          device=dev) for _ in prompts]
    streams = {}
    for name, (over, prefill_impl, per_layer) in WHISPER_PATHS.items():
        cfg = base.replace(**over)
        eng = ServeEngine(cfg, params, device=dev,
                          prefill_attn_impl=prefill_impl, **WHISPER)
        impls = (eng.cache_mode, eng.prefill_attn_impl,
                 eng.encoder_attn_impl, eng.decode_attn_impl)
        if impls != ("contiguous", prefill_impl, prefill_impl,
                     "flash_decode"):
            fail(f"whisper {name}: cache, prefill, encoder, decode {impls}")
        reqs = [Request(rid=i, prompt=p, max_new=WHISPER_NEW, cross_src=f)
                for i, (p, f) in enumerate(zip(prompts, frames))]

        def expected(a, st, n_enc=len(reqs)):
            enc, pre, tick = a or (0, 0, 0)
            return (base.enc_layers * enc * n_enc
                    + base.n_layers * (pre * st["prefills"]
                                       + tick * st["decode_steps"]))
        streams[name] = _serve_run("whisper", name, eng, reqs, WHISPER_NEW,
                                   per_layer, launches, expected)
        del eng
        torch.cuda.empty_cache()

        # the encoder's output, then a bucket-16 prefill over it and the
        # first decode step, kernels vs plain versions
        def step():
            eng = ServeEngine(cfg, params, device=dev,
                              prefill_attn_impl=prefill_impl,
                              **{**WHISPER, "n_slots": 1})
            ecfg = cfg.replace(attn_impl=eng.encoder_attn_impl)
            enc = encoder_apply(params, ecfg, frames[0], device=dev)
            row = init_caches(cfg, 1, WHISPER["max_seq"], dev)
            plen = len(prompts[0])
            toks = torch.tensor([prompts[0] + [0] * (16 - plen)], device=dev)
            pre = eng.prefill_logits(toks, row, torch.tensor(
                [plen - 1], device=dev), enc)
            eng.caches = row
            dec = eng.decode_logits(torch.argmax(pre, dim=-1)[:, None],
                                    torch.tensor([plen], dtype=torch.int32,
                                                 device=dev))
            torch.cuda.synchronize()
            return enc, pre, dec
        kern = step()
        with _plain_serve_kernels():
            plain = step()
        if kern[0].shape != (1, base.n_frames, base.d_model):
            fail(f"whisper {name}: encoder output {tuple(kern[0].shape)}")
        for what, a, b_ in (("encoder output", kern[0], plain[0]),
                            ("bucket-16 prefill logits", kern[1], plain[1]),
                            ("first decode step logits", kern[2], plain[2])):
            check(f"whisper-base {name} full-width {what}", a, b_,
                  TOL_FAMILY[name])
        del kern, plain
        torch.cuda.empty_cache()
    _report_streams("whisper", streams)
    del params, frames
    _free_weights(dev)
    log(f"[whisper] phase {time.perf_counter() - t_phase:.1f} s")


def paged_family_phase(tag: str, arch: str, paths: dict, kernel_checks,
                       dev, launches, results) -> None:
    """Full-width ``arch``, float and dual-mode with the fused impls, on
    the paged engine (max_seq 2048, 4 slots, 64-token chunks), the serve
    phase's 6 prompts with 16 new tokens each: exact launches a layer of a
    chunk and of a tick; then one chunk and the first decode step, kernels
    vs plain versions (``parity``)."""
    from repro_torch.configs import registry
    from repro_torch.serve import Request, ServeEngine
    _free_weights(dev)
    t_phase = time.perf_counter()
    base = registry.get_config(arch)
    kernel_checks(dev, base, results)
    params = _model(tag, base, dev)
    rng = np.random.RandomState(0)      # the serve phase's prompt lengths
    lens = rng.randint(100, 1501, size=6)
    prompts = [rng.randint(0, base.vocab, size=n).tolist() for n in lens]
    streams = {}
    for name, (over, per_layer) in paths.items():
        cfg = base.replace(**over)
        eng = ServeEngine(cfg, params, device=dev, **FAMILY_PAGED)
        impls = (eng.cache_mode, eng.prefill_attn_impl, eng.decode_attn_impl)
        if impls != ("paged", "naive", "flash_decode"):
            fail(f"{tag} {name}: cache, prefill, decode {impls}")
        reqs = [Request(rid=i, prompt=p, max_new=16)
                for i, p in enumerate(prompts)]

        def expected(a, st):
            chunk, tick = a or (0, 0)
            return base.n_layers * (chunk * st["prefill_chunks"]
                                    + tick * st["decode_steps"])
        streams[name] = _serve_run(tag, name, eng, reqs, 16, per_layer,
                                   launches, expected)
        del eng
        torch.cuda.empty_cache()
        parity(cfg, params, dev, prompts[0], max_seq=FAMILY_PAGED["max_seq"],
               tol_f=TOL_FAMILY["float"])
    _report_streams(tag, streams)
    del params
    _free_weights(dev)
    log(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")


def minicpm_phase(dev, launches, results):
    paged_family_phase("minicpm3", MINICPM_ID, MINICPM_PATHS,
                       minicpm_kernel_checks, dev, launches, results)


def qwen3_phase(dev, launches, results):
    paged_family_phase("qwen3", QWEN3_ID, QWEN3_PATHS, qwen3_kernel_checks,
                       dev, launches, results)


# ---------------- phases 13 / 14: the recurrent mixers ----------------
#
# rwkv6-1.6b at full width and depth, jamba-v0.1-52b at full width and 8
# of its 32 layers (one period: 13.30 B parameters, 49.5 GiB; all 32 are
# 192 GiB), both on the contiguous engine that 'auto' picks for a
# recurrent state, each prompt prefilled at its own length.

TOL_SCAN = 1e-5        # wkv6 / selective_scan against the plain step loop:
#                        y and the final state within 1e-5 of max(1, max
#                        |plain|) of each -- fused multiply-adds and the
#                        hd- (64) or d_state- (16) term sums in another
#                        order, carried through the state over the steps
RWKV_ID = "rwkv6-1.6b"
RWKV = dict(max_seq=16384, n_slots=4)
RWKV_LONG = 8192       # one prompt of this many tokens beside the 6 others
RWKV_NEW = 16
# config overrides, the launches of each kernel a layer of a prefill and
# of a tick: the time mix's WKV scan and the residual-norm epilogue before
# the channel mix (norm1 stays unfused, as in the reference; relu^2 is no
# unit mode and the gate is a plain SiLU, so the arch runs float only)
RWKV_PATH = (dict(softmax_impl="float", **FUSED),
             {"wkv6": (1, 1), "resnorm": (1, 1)})
JAMBA_ID = "jamba-v0.1-52b"
JAMBA_LAYERS = 8       # one period: 7 mamba layers and 1 attention layer
JAMBA = dict(max_seq=4096, n_slots=4)
JAMBA_NEW = 16
# name: (config overrides, prefill impl, the launches of each kernel in a
# prefill and in a tick of the 8 layers).  A mamba layer: the selective
# scan and the residual-norm epilogue; the attention layer: norm -> QKV,
# rows 7 / 8 at a prefill (exact length against max_seq keys), rows 5 / 6
# at a tick, the epilogue; the 4 dense MLPs: the fused GLU in float, the
# unit's SiLU mode (row 2) in dual-mode; the 4 MoE FFNs: cuBLAS products,
# and row 2 once each in dual-mode.
JAMBA_PATHS = {
    "float": (dict(softmax_impl="float", activation="silu", **FUSED),
              "flash_pallas",
              {"selective_scan": (7, 7), "resnorm": (8, 8),
               "norm_linear": (1, 1), "glu": (4, 4), "flash_fwd": (1, 0),
               "decode_dense": (0, 1)}),
    "dualmode": (dict(softmax_impl="dualmode", activation="silu_dualmode",
                      **FUSED), "flash_pallas_int",
                 {"selective_scan": (7, 7), "resnorm": (8, 8),
                  "norm_linear": (1, 1), "pair_act": (8, 8),
                  "flash_snap": (1, 0), "decode_dense_int": (0, 1)})}


def _scan_checks(name: str, fn, plain, args, seq) -> float:
    """One recurrence kernel against its plain version on ``args`` (those
    at indices ``seq`` (B, S, ...) per step, the last the initial state):
    y and the final state within TOL_SCAN of max(1, max |plain|); a split
    of the steps in two (S1 = 1 and S1 = S // 2 + 1) carried through the
    state equals the whole call bit for bit; two calls give the same
    bits.  Returns the larger absolute error."""
    got, want = fn(*args), plain(*args)
    e = max(check_rel(f"{name} y", got[0], want[0], TOL_SCAN),
            check_rel(f"{name} state", got[1], want[1], TOL_SCAN))
    sl = args[0].shape[1]
    for s1 in sorted({1, sl // 2 + 1} - {sl}):
        head = list(args)
        tail = list(args)
        for i in seq:
            head[i] = args[i][:, :s1].contiguous()
            tail[i] = args[i][:, s1:].contiguous()
        y1, st1 = fn(*head)
        tail[-1] = st1
        y2, st2 = fn(*tail)
        torch.cuda.synchronize()
        if not (torch.equal(torch.cat([y1, y2], dim=1), got[0])
                and torch.equal(st2, got[1])):
            fail(f"{name}: {s1} then {sl - s1} steps differ from {sl} in "
                 "one call")
        log(f"  ok {name}: {s1} then {sl - s1} steps equal one call, "
            "bitwise")
    check_repeat(f"{name} repeat", lambda: torch.cat(
        [t.flatten() for t in fn(*args)]))
    return e


def _scan_row(table: dict, key: str, fn, plain, args, nbytes: float,
              flops: float, plain_iters: int) -> dict:
    """Time one recurrence kernel at one shape: back to back, under
    CUDA-graph replay, its plain version, its bound (no library call
    computes it)."""
    b_ms, b_by = bound(nbytes, flops)
    return kernel_row(table, key, lambda: fn(*args), lambda: plain(*args),
                      b_ms, b_by, None, iters=20, plain_iters=plain_iters)


def wkv6_args(dev, b: int, sl: int, h: int, hd: int, seed: int):
    """r, k, v (B, S, H, hd), a decay w in (0.6, 0.9995) per channel and
    step, u (H, hd), a nonzero S0."""
    randn = _randn_fn(dev, seed)
    r, k, v = (randn(b, sl, h, hd) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, sl, h, hd) - 3.0)).clamp(max=0.9995)
    return (r, k, v, w.contiguous(), randn(h, hd, scale=0.1),
            randn(b, h, hd, hd, scale=0.3))


def scan_args(dev, b: int, sl: int, di: int, ds: int, seed: int):
    """xc, dt (softplus, ~0.01-1) (B, S, di), A = -(1..ds) per channel as
    the model's init has it, Bm, Cm (B, S, ds), a nonzero h0."""
    randn = _randn_fn(dev, seed)
    dt = torch.nn.functional.softplus(randn(b, sl, di) - 2.0)
    a = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        di, ds).contiguous()
    return (randn(b, sl, di), dt.contiguous(), a, randn(b, sl, ds),
            randn(b, sl, ds), randn(b, di, ds, scale=0.3))


def wkv6_cost(b, sl, h, hd):
    """(bytes, flops) of one wkv6 call: r, k, v, w read and y written once
    a step, u, S0 read and S written once; 7 flops a state word a step."""
    return ((5 * b * sl * h * hd + h * hd + 2 * b * h * hd * hd) * 4,
            7 * b * sl * h * hd * hd)


def scan_cost(b, sl, di, ds):
    """(bytes, flops) of one selective_scan call: xc, dt read and y written
    a step, Bm, Cm read a step, A, h0 read and h written once; 7 flops (the
    exp counted as one) a state word a step and one a channel."""
    return ((3 * b * sl * di + 2 * b * sl * ds + di * ds + 2 * b * di * ds)
            * 4, b * sl * di * (7 * ds + 1))


def rwkv_kernel_checks(dev, cfg, results) -> None:
    """wkv6 against its plain version at rwkv6's tick (B 4, S 1, 32 heads
    of 64), a batch-1 prefill of 1500 steps, S 77 and 33 (no multiple of
    the kernel's 32-step tile) and S 8192 at one layer, the split and
    repeat checks at each; timed at the tick and at the prefill."""
    from repro_torch.kernels import recurrence as rec
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    log(f"[rwkv6] kernels: wkv6 at H {h} hd {hd}")
    table: dict = {}
    worst = 0.0
    for i, (b, sl) in enumerate(((4, 1), (1, 1500), (2, 77), (3, 33),
                                 (1, 8192))):
        args = wkv6_args(dev, b, sl, h, hd, 40 + i)
        name = f"wkv6 B{b} S{sl} H{h} hd{hd}"
        e = _scan_checks(name, rec.wkv6, rec.wkv6_plain, args, (0, 1, 2, 3))
        if (b, sl) in ((4, 1), (1, 1500)):
            row = _scan_row(table, name, rec.wkv6, rec.wkv6_plain, args,
                            *wkv6_cost(b, sl, h, hd),
                            plain_iters=3 if sl == 1 else 1)
            row["max_abs_err"] = e
        worst = max(worst, e)
        del args
    tick = table[f"wkv6 B4 S1 H{h} hd{hd}"]
    results["wkv6"] = dict(tick, max_abs_err=worst)
    results["recurrence_ms"] = {**results.get("recurrence_ms", {}), **table}
    log("[recurrence] wkv6, ms: " + json.dumps(table))


def jamba_kernel_checks(dev, cfg, results) -> None:
    """selective_scan against its plain version at jamba's tick (B 4, S 1,
    d_inner 8192, d_state 16), a batch-1 prefill of 1500 steps, S 77 at
    d_inner 200 (no multiple of the kernel's 128 channels or 32-step
    tile) and S 33 at d_state 8, the split and repeat checks at each;
    timed at the tick and at the prefill."""
    from repro_torch.kernels import recurrence as rec
    m = cfg.mamba
    log(f"[jamba] kernels: selective_scan at d_inner {m.d_inner} d_state "
        f"{m.d_state}")
    table: dict = {}
    worst = 0.0
    for i, (b, sl, di, ds) in enumerate((
            (4, 1, m.d_inner, m.d_state), (1, 1500, m.d_inner, m.d_state),
            (2, 77, 200, m.d_state), (3, 33, m.d_inner, 8))):
        args = scan_args(dev, b, sl, di, ds, 50 + i)
        name = f"selective_scan B{b} S{sl} di{di} ds{ds}"
        e = _scan_checks(name, rec.selective_scan, rec.selective_scan_plain,
                         args, (0, 1, 3, 4))
        if i < 2:
            row = _scan_row(table, name, rec.selective_scan,
                            rec.selective_scan_plain, args,
                            *scan_cost(b, sl, di, ds),
                            plain_iters=3 if sl == 1 else 1)
            row["max_abs_err"] = e
        worst = max(worst, e)
        del args
    tick = table[f"selective_scan B4 S1 di{m.d_inner} ds{m.d_state}"]
    results["selective_scan"] = dict(tick, max_abs_err=worst)
    results["recurrence_ms"] = {**results.get("recurrence_ms", {}), **table}
    log("[recurrence] selective_scan, ms: " + json.dumps(table))


def recurrent_parity(tag: str, cfg, params, dev, prompt, max_seq: int,
                     tol: float) -> None:
    """The first prefill (the prompt at its own length, batch 1) and the
    first decode tick through the engine's phase configs, kernels against
    the plain versions called in their place: logits within ``tol``."""
    from repro_torch.models.transformer import init_caches
    from repro_torch.serve import ServeEngine

    def step():
        eng = ServeEngine(cfg, params, n_slots=1, max_seq=max_seq,
                          device=dev)
        row = init_caches(cfg, 1, max_seq, dev)
        n = len(prompt)
        pre = eng.prefill_logits(torch.tensor([prompt], device=dev), row,
                                 torch.tensor([n - 1], device=dev))
        eng.caches = row
        dec = eng.decode_logits(torch.argmax(pre, dim=-1)[:, None],
                                torch.tensor([n], dtype=torch.int32,
                                             device=dev))
        torch.cuda.synchronize()
        return pre, dec
    with torch.no_grad():
        kern = step()
        with _plain_serve_kernels():
            plain = step()
    for what, a, b_ in (("prefill", kern[0], plain[0]),
                        ("first tick", kern[1], plain[1])):
        check(f"{tag} {cfg.softmax_impl} full-width logits, {len(prompt)}"
              f"-token {what}", a, b_, tol)
    del kern, plain
    torch.cuda.empty_cache()


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def contiguous_blocks(cfg, params, dev, prompt, name: str,
                      tag: str = "jamba", geom: dict = JAMBA) -> dict:
    """The prompt's prefill and the first tick at full width on the
    contiguous engine of ``geom``, block by block: each block runs on the
    kernel path's input and a copy of its cache with the plain versions,
    then with the kernels (whose output and cache feed the next block); a
    MoE block's outputs held on the tokens whose expert sets agree (route
    flips counted and held to granite's flip rule), any other block's on
    every token, the mamba states within TOL_SCAN of max(1, max |plain|).
    The prefill and the tick run with the engine's phase configs (the
    prefill's attention resolved at its widest bucket against
    max_seq)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import _positions_from
    from repro_torch.models.layers import make_norm
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, device=dev, **{**geom, "n_slots": 1})
    phase_cfgs = (eng._prefill_cfg, eng._decode_cfg)
    del eng
    tol = TOL_FAMILY[name]
    caches = tf.init_caches(cfg, 1, geom["max_seq"], dev)
    specs = tf.layer_specs(cfg)
    report = {}

    def forward(phase_cfg, toks, pos, what):
        x = params["embed"][toks]
        positions = _positions_from(pos, 1, toks.shape[1], dev)
        worst, flips, margin, st_err = 0.0, [], 0.0, 0.0
        for i, (lp, spec) in enumerate(zip(params["layers"], specs)):
            rp, rk = [], []
            cp = _clone_tree(caches[i])
            with _plain_serve_kernels(), _route_spy(rp):
                yp, _, _ = tf.block_apply(lp, phase_cfg, spec, x, cp,
                                          positions=positions, pos=pos,
                                          paged=None)
            with _route_spy(rk):
                yk, _, _ = tf.block_apply(lp, phase_cfg, spec, x, caches[i],
                                          positions=positions, pos=pos,
                                          paged=None)
            agree = torch.ones(yk.shape[:2], dtype=torch.bool, device=dev)
            if spec.ffn == "moe":
                agree, margins, diff = route_flips(rp[0], rk[0],
                                                   cfg.moe.top_k)
                flips.append(int(margins.numel()))
                if margins.numel():
                    margin = max(margin, float(margins.max()))
                    log(f"  {tag} {name} {what} block {i}: "
                        f"{margins.numel()} route flips, margins "
                        f"{margins.tolist()}, largest router-probability "
                        f"difference on agreeing tokens {diff:.3e}")
                    if float(margins.max()) > 2 * diff:
                        fail(f"{tag} {name} {what} block {i}: a route flip "
                             f"at margin {float(margins.max()):.3e} > "
                             f"twice {diff:.3e}")
            e = max_err(yk[agree], yp[agree])
            if not torch.isfinite(yk).all() or e > tol:
                fail(f"{tag} {name} {what} block {i}: kernels vs plain "
                     f"{e:.3e} on agreeing tokens > {tol:.0e}")
            worst = max(worst, e)
            if spec.mixer == "mamba":       # both runs took the same x
                for key in ("conv", "ssm"):
                    a, b_ = caches[i]["state"][key], cp["state"][key]
                    scale = max(1.0, float(b_.abs().max()))
                    st_err = max(st_err, max_err(a, b_) / scale)
                if st_err > TOL_SCAN:
                    fail(f"{tag} {name} {what} block {i}: state kernels vs "
                         f"plain {st_err:.3e} of max(1, max |plain|)")
            x = yk
        log(f"  ok {tag} {name} {what}, {cfg.n_layers} blocks kernels vs "
            f"plain: worst {worst:.3e} on agreeing tokens (limit "
            f"{tol:.0e}); route flips a MoE block {flips}"
            + (f"; mamba states {st_err:.3e} of max(1, max |plain|) (limit "
               f"{TOL_SCAN:.0e})" if "mamba" in {s.mixer for s in specs}
               else ""))
        report[what] = dict(worst=worst, flips=flips, margin=margin,
                            state=st_err)
        return x

    with torch.no_grad():
        toks = torch.tensor([prompt], device=dev)
        x = forward(phase_cfgs[0], toks, 0, f"{len(prompt)}-token prefill")
        h = make_norm(cfg.norm)[1](params["final_norm"], x[:, -1:],
                                   cfg.norm_eps)
        nxt = torch.argmax(h @ tf.lm_head_weight(params, cfg), dim=-1)
        forward(phase_cfgs[1], nxt, torch.tensor(
            [len(prompt)], dtype=torch.int32, device=dev), "tick")
    del caches
    torch.cuda.empty_cache()
    return report


def _serve_prompts(vocab: int):
    """The serve phase's 6 prompt lengths (100-1500 tokens) and tokens."""
    rng = np.random.RandomState(0)
    lens = rng.randint(100, 1501, size=6)
    return [rng.randint(0, vocab, size=n).tolist() for n in lens]


def rwkv_phase(dev, launches, results):
    """Full-width rwkv6-1.6b, float, on the contiguous engine: the serve
    phase's prompts and one of 8192 tokens, 16 new tokens each; exact
    launches a layer of a prefill and a tick; the first prefill and tick,
    kernels vs plain versions."""
    from repro_torch.configs import registry
    from repro_torch.serve import Request, ServeEngine
    _free_weights(dev)
    t_phase = time.perf_counter()
    base = registry.get_config(RWKV_ID)
    rwkv_kernel_checks(dev, base, results)
    params = _model("rwkv6", base, dev)
    prompts = _serve_prompts(base.vocab)
    prompts.append(np.random.RandomState(1).randint(
        0, base.vocab, size=RWKV_LONG).tolist())
    over, per_layer = RWKV_PATH
    cfg = base.replace(**over)
    log("[rwkv6] float only: its channel mix is relu^2 (no sigmoid-family "
        "unit mode) and its gate a plain SiLU, so its dual-mode forward is "
        "its float forward")
    eng = ServeEngine(cfg, params, device=dev, **RWKV)
    if eng.cache_mode != "contiguous" or not eng._exact_prefill:
        fail(f"rwkv6: cache {eng.cache_mode}, exact prefill "
             f"{eng._exact_prefill}")
    reqs = [Request(rid=i, prompt=p, max_new=RWKV_NEW)
            for i, p in enumerate(prompts)]

    def expected(a, st):
        pre, tick = a or (0, 0)
        return base.n_layers * (pre * st["prefills"]
                                + tick * st["decode_steps"])
    outs = _serve_run("rwkv6", "float", eng, reqs, RWKV_NEW, per_layer,
                      launches, expected)
    log(f"[rwkv6] greedy streams (reported, not gated): "
        f"{ {r: v[:8] for r, v in sorted(outs.items())} }")
    del eng
    torch.cuda.empty_cache()
    recurrent_parity("rwkv6-1.6b", cfg, params, dev, prompts[0],
                     RWKV["max_seq"], TOL_FAMILY["float"])
    del params
    _free_weights(dev)
    log(f"[rwkv6] phase {time.perf_counter() - t_phase:.1f} s")


def jamba_phase(dev, launches, results):
    """Full-width jamba-v0.1-52b at 8 of its 32 layers, float and
    dual-mode, on the contiguous engine: the serve phase's prompts with 16
    new tokens each; exact launches a prefill and a tick; the first
    prefill and tick block by block with route flips, and their logits,
    kernels vs plain versions."""
    from repro_torch.configs import registry
    from repro_torch.serve import Request, ServeEngine
    _free_weights(dev)
    t_phase = time.perf_counter()
    full = registry.get_config(JAMBA_ID)
    base = full.replace(n_layers=JAMBA_LAYERS)
    jamba_kernel_checks(dev, base, results)
    params = _model("jamba", base, dev, depth_of=full.n_layers)
    prompts = _serve_prompts(base.vocab)
    streams = {}
    for name, (over, prefill_impl, per_fwd) in JAMBA_PATHS.items():
        cfg = base.replace(**over)
        eng = ServeEngine(cfg, params, device=dev, **JAMBA)
        impls = (eng.cache_mode, eng.prefill_attn_impl, eng.decode_attn_impl)
        if impls != ("contiguous", prefill_impl, "flash_decode"):
            fail(f"jamba {name}: cache, prefill, decode {impls}")
        reqs = [Request(rid=i, prompt=p, max_new=JAMBA_NEW)
                for i, p in enumerate(prompts)]

        def expected(a, st):
            pre, tick = a or (0, 0)
            return pre * st["prefills"] + tick * st["decode_steps"]
        streams[name] = _serve_run("jamba", name, eng, reqs, JAMBA_NEW,
                                   per_fwd, launches, expected)
        del eng
        torch.cuda.empty_cache()
        contiguous_blocks(cfg, params, dev, prompts[0], name)
        recurrent_parity("jamba-v0.1-52b", cfg, params, dev, prompts[0],
                         JAMBA["max_seq"], TOL_FAMILY[name])
    _report_streams("jamba", streams)
    del params
    _free_weights(dev)
    log(f"[jamba] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------- phase 15: deepseek-v2-lite ----------------
#
# deepseek-v2-lite-16b at full width and depth (27 layers: a dense MLA +
# MLP prefix layer, then 26 of MLA over 64 experts top-6 and 2 shared
# ones; 15.71 B parameters, 58.5 GiB, alone on the card).  Its MLA runs
# q.k over nope + rope = 128 + 64 = 192 and v at 128, K 16, G 1: the 192
# class of rows 5-8.  The paged engine (the qwen prompts) ticks through
# rows 5 / 6 and attends a chunk naively; one ~3000-token prompt on the
# contiguous engine at bucket 4096 (4096^2 > 2^22) prefills through rows
# 7 / 8 by the engine's own 'auto' rule.

DEEPSEEK_ID = "deepseek-v2-lite-16b"
DEEPSEEK_MODES = {
    "float": dict(softmax_impl="float", activation="silu", **FUSED),
    "dualmode": dict(softmax_impl="dualmode", activation="silu_dualmode",
                     **FUSED)}
DEEPSEEK_LONG = dict(max_seq=4096, n_slots=1, prefill_buckets=(4096,),
                     cache_mode="contiguous")
DEEPSEEK_LONG_LEN = 3000
DEEPSEEK_NEW = 16


def deepseek_launches(cfg) -> tuple[dict, dict]:
    """The launches of each kernel in one forward of a paged chunk and of
    a tick, and of a contiguous bucket prefill and of a tick, over all of
    ``cfg``'s layers (every kernel not named: 0).  Each layer: the MLA
    mixer takes the plain norm1 and the residual-norm epilogue (row 14)
    follows it; its tick attends through rows 5 / 6, a paged chunk
    naively (row 1 in dual-mode), a bucket prefill through rows 7 / 8.
    Layer 0's dense MLP and each MoE layer's shared experts (one gated MLP
    of 2 x 1408) run the fused GLU (row 12) in float, the unit's pair
    mode (row 2) in dual-mode, which also runs once a MoE layer over the
    routed experts' buffer (their products are cuBLAS's, their SiLU
    PyTorch's in float)."""
    from repro_torch.models.transformer import layer_specs
    n = cfg.n_layers
    n_moe = sum(s.ffn == "moe" for s in layer_specs(cfg))
    if cfg.softmax_impl == "float":
        ffn = {"glu": (n, n)}
        rows = ("decode_dense", "flash_fwd", None)
    else:
        ffn = {"pair_act": (n + n_moe, n + n_moe)}
        rows = ("decode_dense_int", "flash_snap", "softmax_rows")
    dec, blocked, chunk = rows
    paged = {"resnorm": (n, n), **ffn, dec: (0, n)}
    contig = {"resnorm": (n, n), **ffn, dec: (0, n), blocked: (n, 0)}
    if chunk:
        paged[chunk] = (n, 0)
    return paged, contig


def deepseek_kernel_checks(dev, cfg, results) -> None:
    """deepseek-v2-lite's kernels at its path's shapes (q.k over nope +
    rope = 192, v 128, K 16, G 1): rows 7 / 8 over a 64-token chunk at the
    end of a 2048-key table, a whole 2048-token prompt, a 300-token one
    (a ragged last tile, key 0 masked) and the bucket-4096 prefill; rows
    5 / 6 at a tick of 4 slots over 2048 keys; rows 5-8 timed beside
    their bounds (and SDPA's time for rows 5 and 7); rows 14, 12 (d 2048,
    the dense MLP's F 10944 and the shared experts' 2816) and 2 at a
    chunk's and a tick's rows, row 1 over a dual-mode chunk's 16 x 64
    score rows of 2048 keys."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_int as fai
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tiling
    kh = cfg.n_heads
    h, hv = cfg.mla.nope_dim + cfg.mla.rope_dim, cfg.mla.v_dim
    t = FAMILY_PAGED["max_seq"]
    log(f"[deepseek] kernels at MLA's head dims h {h} hv {hv} K {kh} G 1 "
        f"(width class {tiling.head_width(h, hv)}, plan "
        f"{tuple(tiling.flash_fwd_plan(h, hv, causal=True))}, shared memory "
        f"{tiling.flash_fwd_smem(h, hv)} / "
        f"{tiling.flash_fwd_smem(h, hv, snap=True)} B a block of rows 7 / 8, "
        f"{tiling.decode_dense_smem(h, hv, False)} / "
        f"{tiling.decode_dense_smem(h, hv, True)} of rows 5 / 6)")
    flash_pair_checks("deepseek chunk", dev, 64, t, kh, h, hv, True)
    flash_pair_checks("deepseek ragged", dev, 300, 300, kh, h, hv, True,
                      ragged=True)
    flash_pair_checks("deepseek bucket", dev, DEEPSEEK_LONG["max_seq"],
                      DEEPSEEK_LONG["max_seq"], kh, h, hv, True)
    args = flash_pair_checks("deepseek prompt", dev, t, t, kh, h, hv, True)
    table: dict = {}
    kw = dict(causal=True, block_kv=64)
    pairs = t * (t + 1) // 2 * kh
    nbytes = (args[0].numel() + args[1].numel() + args[2].numel()
              + t * kh * hv) * 4 + 5 * t
    q_l = args[0][0].permute(1, 2, 0, 3).reshape(1, kh, t, h)
    k_l, v_l = args[1].permute(0, 2, 1, 3), args[2].permute(0, 2, 1, 3)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_l, k_l, v_l, is_causal=True, scale=1.0), iters=5)
    del q_l, k_l, v_l
    plan = tuple(tiling.flash_fwd_plan(h, hv, causal=True))
    kernel_row(
        table, f"flash_fwd B1 S{t} K{kh} G1 h{h} hv{hv} causal",
        lambda: fa.flash_fwd(*args, **kw),
        lambda: fa.flash_fwd_plain(*args, **kw),
        *bound(nbytes, pairs * (2 * h + 2 * hv + 4)), lib, iters=5,
        plain_iters=1, launches_a_forward=cfg.n_layers, plan=plan)
    n_int = snap_int_a_score(results, h, hv, True)
    check_repeat(f"flash_snap deepseek S{t} repeat",
                 lambda: fai.flash_snap(*args, guard_shift=0, **kw))
    kernel_row(
        table, f"flash_snap B1 S{t} K{kh} G1 h{h} hv{hv} causal",
        lambda: fai.flash_snap(*args, guard_shift=0, **kw),
        lambda: fai.flash_snap_plain(*args, guard_shift=0, **kw),
        *bound(nbytes, pairs * (2 * h + 2 * hv + 4 + n_int)), None, iters=5,
        plain_iters=1, int_ops_a_score=n_int,
        launches_a_forward=cfg.n_layers, plan=plan)
    depths = [700, 1000, 1500, t - 1]
    dargs, ns, bk = decode_pair_checks("deepseek tick", dev, depths, t, kh,
                                       h, hv, True)
    b = len(depths)
    live = max(depths) + 1
    q_l = dargs[0].reshape(b, kh, 1, h)
    k_l = dargs[1][:, :live].permute(0, 2, 1, 3)
    v_l = dargs[2][:, :live].permute(0, 2, 1, 3)
    mask = dargs[4][:, :live].bool()[:, None, None, :]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_l, k_l, v_l, attn_mask=mask, scale=1.0))
    del q_l, k_l, v_l
    keys = sum(depths) + b
    dbytes = (keys * kh * (h + hv) * 4 + keys + dargs[0].numel() * 4
              + 4 * ns * kh * (hv + 2) * b)
    gs = fai.unit.guard_shift_for(t)
    for int_mode, name in ((False, "decode_dense"),
                           (True, "decode_dense_int")):
        dkw = dict(num_splits=ns, block_kv=bk, causal=True,
                   int_mode=int_mode, guard_shift=gs)
        kernel_row(
            table, f"{name} B{b} K{kh} G1 h{h} hv{hv} T{t} depths {depths}",
            lambda dkw=dkw: fd.decode_dense_partials(*dargs, **dkw),
            lambda dkw=dkw: fd.decode_dense_partials_plain(*dargs, **dkw),
            *bound(dbytes, keys * kh * (2 * h + 2 * hv + 4)),
            None if int_mode else lib, iters=50, plain_iters=3, splits=ns,
            block_kv=bk, launches_a_forward=cfg.n_layers)
    results["deepseek_ms"] = table
    log("[deepseek attention] rows 7 / 8 / 5 / 6 at h 192 / hv 128, ms: "
        + json.dumps(table))
    seam_checks("deepseek", dev, cfg, (64, 4), score_rows=(kh * 64, t))
    m = cfg.moe
    seam_checks("deepseek shared experts", dev,
                cfg.replace(d_ff=m.d_ff * m.n_shared), (64, 4))


def deepseek_parity(tag: str, cfg, step, tol: float) -> None:
    """``step()`` (one or two forwards, returning their logits) through
    the kernels and with the plain versions called in their place, each
    MoE routing recorded: where every token's expert set agrees in every
    MoE layer, the logits within ``tol``; where a route flipped, the
    flips are logged and the logits reported, the block-by-block check's
    flip rule holding that forward (a flipped expert moves a token's
    output by O(1))."""
    rp, rk = [], []
    with torch.no_grad():
        with _route_spy(rk):
            kern = step()
        with _plain_serve_kernels(), _route_spy(rp):
            plain = step()
    flips = [int((~route_flips(p_, k_, cfg.moe.top_k)[0]).sum())
             for p_, k_ in zip(rp, rk)]
    for (what, a), (_, b_) in zip(kern, plain):
        name = f"{tag} {cfg.softmax_impl} full-width logits, {what}"
        if sum(flips):
            log(f"  {name}: kernels vs plain {max_err(a, b_):.3e} (reported: "
                f"route flips a MoE call {flips}; the blocks' flip rule "
                "holds this forward)")
            if not torch.isfinite(a).all():
                fail(f"{name}: non-finite")
        else:
            check(name, a, b_, tol)
    del kern, plain
    torch.cuda.empty_cache()


def deepseek_phase(dev, launches, results):
    """Full-width deepseek-v2-lite-16b, float and dual-mode with the fused
    impls: the paged engine (max_seq 2048, 4 slots, 64-token chunks) on
    the qwen prompts with 16 new tokens each, exact launches; each block
    of a chunk and a tick kernels vs plain with granite's flip rule; a
    chunk's and a tick's logits kernels vs plain; then one
    DEEPSEEK_LONG_LEN-token prompt on the contiguous engine at bucket
    4096, exact launches, its prefill (through rows 7 / 8) and first tick
    block by block with the flip rule, and their logits, kernels vs
    plain."""
    from repro_torch.configs import registry
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import init_caches
    from repro_torch.serve import Request, ServeEngine
    _free_weights(dev)
    t_phase = time.perf_counter()
    base = registry.get_config(DEEPSEEK_ID)
    deepseek_kernel_checks(dev, base, results)
    params = _model("deepseek", base, dev)
    m = base.moe
    log(f"[deepseek] {m.n_experts} experts top-{m.top_k} d_ff {m.d_ff} + "
        f"{m.n_shared} shared, dense prefix d_ff {base.d_ff}; MLA kv_lora "
        f"{base.mla.kv_lora_rank} nope {base.mla.nope_dim} rope "
        f"{base.mla.rope_dim} v {base.mla.v_dim}")
    prompts = _serve_prompts(base.vocab)
    long_prompt = np.random.RandomState(3).randint(
        0, base.vocab, size=DEEPSEEK_LONG_LEN).tolist()
    streams = {}
    for name, over in DEEPSEEK_MODES.items():
        cfg = base.replace(**over)
        tol = TOL_FAMILY[name]
        paged, contig = deepseek_launches(cfg)
        eng = ServeEngine(cfg, params, device=dev, **FAMILY_PAGED)
        impls = (eng.cache_mode, eng.prefill_attn_impl, eng.decode_attn_impl)
        if impls != ("paged", "naive", "flash_decode"):
            fail(f"deepseek {name}: cache, prefill, decode {impls}")
        reqs = [Request(rid=i, prompt=p, max_new=DEEPSEEK_NEW)
                for i, p in enumerate(prompts)]

        def expected(a, st):
            chunk, tick = a or (0, 0)
            return chunk * st["prefill_chunks"] + tick * st["decode_steps"]
        streams[name] = _serve_run("deepseek", f"{name} paged", eng, reqs,
                                   DEEPSEEK_NEW, paged, launches, expected)
        del eng
        torch.cuda.empty_cache()
        granite_blocks(cfg, params, dev, prompts[0], name, tag="deepseek",
                       geom=FAMILY_PAGED)

        deepseek_parity("deepseek-v2-lite-16b", cfg, lambda cfg=cfg: (
            paged_step(cfg, params, dev, prompts[0])), tol)

        eng = ServeEngine(cfg, params, device=dev, **DEEPSEEK_LONG)
        blocked = dispatch.resolve_attention(
            "auto", DEEPSEEK_LONG["max_seq"], DEEPSEEK_LONG["max_seq"],
            softmax_impl=cfg.softmax_impl, device=dev)
        impls = (eng.cache_mode, eng.prefill_attn_impl, eng.decode_attn_impl)
        if impls != ("contiguous", blocked, "flash_decode") or \
                blocked not in ("flash_pallas", "flash_pallas_int"):
            fail(f"deepseek {name} bucket 4096: cache, prefill, decode "
                 f"{impls}")

        def expected_contig(a, st):
            pre, tick = a or (0, 0)
            return pre * st["prefills"] + tick * st["decode_steps"]
        _serve_run("deepseek", f"{name} contiguous bucket 4096", eng,
                   [Request(rid=0, prompt=long_prompt, max_new=DEEPSEEK_NEW)],
                   DEEPSEEK_NEW, contig, launches, expected_contig)
        del eng
        torch.cuda.empty_cache()
        contiguous_blocks(cfg, params, dev, long_prompt, name,
                          tag="deepseek", geom=DEEPSEEK_LONG)

        def long_step(cfg=cfg):
            eng = ServeEngine(cfg, params, device=dev, **DEEPSEEK_LONG)
            row = init_caches(cfg, 1, DEEPSEEK_LONG["max_seq"], dev)
            n = len(long_prompt)
            toks = torch.tensor([long_prompt + [0] * (
                DEEPSEEK_LONG["max_seq"] - n)], device=dev)
            pre = eng.prefill_logits(toks, row, torch.tensor([n - 1],
                                                             device=dev))
            eng.caches = row
            dec = eng.decode_logits(
                torch.argmax(pre, dim=-1)[:, None],
                torch.tensor([n], dtype=torch.int32, device=dev))
            torch.cuda.synchronize()
            return [(f"bucket-4096 prefill of {n} tokens", pre),
                    ("its first tick", dec)]
        deepseek_parity("deepseek-v2-lite-16b", cfg, long_step, tol)
    _report_streams("deepseek", streams)
    del params
    _free_weights(dev)
    log(f"[deepseek] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------- phases 16 / 17: training rwkv6 and jamba ----------------
#
# The Trainer on the recurrent archs at full width: rwkv6-1.6b at its full
# depth (24 layers, 2 steps of 2 x 2048 tokens) and jamba-v0.1-52b at depth
# 1 (its layer 0: a mamba mixer over the dense MLP, 1 x 2048), remat, the
# fused impls, the 8192-token bigram stream.  Each scan's forward kernel
# runs twice a layer a step (the step's forward and the remat's recompute,
# which writes the boundary states anew) and its backward kernel once.
# The limits, stated before the first chip run (PERF.md section 2): the
# backward kernels against autograd through the plain scans at the
# training shapes, every gradient within TOL_SCAN_BWD of max(1, max
# |plain|) (du / dA TOL_SCAN_BWD_SUM); one step's loss 1e-5 relative and
# each gradient tensor 1e-3 of its own max, kernels vs plain (the train
# phase's limits, TOL_TRAIN_LOSS / TOL_TRAIN_GRAD); a step from one state
# bitwise twice; a save and resume continuing with the uninterrupted
# run's loss (rtol 1e-4); exact launches, every other kernel 0.  The
# first chip run found rwkv6's whole-model gradients 4.3e-3 of a tensor's
# max apart (kernels vs plain), and the paths move by up to 1.2e-2 on
# their own on the batch given twice (f32 reordering alone).  So each phase
# also measures that noise in the same run, both paths on the batch
# given twice, and holds each whole-model gradient tensor to
# TOL_TRAIN_GRAD or to TOL_TRAIN_NOISE times its own noise, whichever is
# larger; and each block, given the kernel path's input and one
# cotangent, to TOL_TRAIN_GRAD.

TOL_SCAN_BWD = 1e-5       # wkv6_bwd / selective_scan_bwd against autograd
#                           through the plain scans, x max(1, max |plain|):
#                           the same sums in another order (row sums, the
#                           warp butterfly) carried over up to 2048 steps
TOL_SCAN_BWD_SUM = 2e-5   # du / dA: sums over every step and batch row
TOL_TRAIN_NOISE = 4       # a whole-model gradient tensor, kernels vs plain,
#                           may exceed TOL_TRAIN_GRAD by up to this many
#                           times the larger of the two paths' own
#                           differences on the batch given twice (the same
#                           gradient in exact arithmetic, other f32 orders)
RWKV_TRAIN = dict(batch=2, seq=2048, steps=2, data_vocab=8192,
                  plain=(1, 512), resume_layers=2)
JAMBA_TRAIN = dict(layers=1, batch=1, seq=2048, steps=2, data_vocab=8192,
                   plain=(1, 2048), resume_layers=1)
# launches a layer of one step (remat: the forward kernels twice)
RWKV_TRAIN_PER_LAYER = {"wkv6": 2, "wkv6_bwd": 1, "resnorm": 2}
JAMBA_TRAIN_PER_LAYER = {"selective_scan": 2, "selective_scan_bwd": 1,
                         "resnorm": 2, "glu": 2, "glu_bwd": 1}


def wkv6_bwd_cost(b, sl, h, hd):
    """(bytes, flops) of one wkv6_bwd call: r, k, v, w, dy read and dr,
    dk, dv, dw written once a step, u read and du written, the boundary
    states and the final state's gradient read, ds0 written; 14 flops a
    state word a step: dr, dw, dk and dv 2 each (the u terms are O(hd) a
    step), dS's update 3 and the state's recompute 3."""
    nb = -(-sl // 64) + 1
    return ((9 * b * sl * h * hd + 2 * h * hd + (nb + 2) * b * h * hd * hd)
            * 4, 14 * b * sl * h * hd * hd)


def scan_bwd_cost(b, sl, di, ds):
    """(bytes, flops) of one selective_scan_bwd call: xc, dt, dy read and
    dxc, ddt written a step, Bm, Cm read and dBm, dCm written a step, A
    read and dA written, the boundary states and dh read, dh0 written; 20
    flops a state word a step: the recompute's 5 (the exp counted as
    one), dh, dC, ddt, the shared sum of dh B, dB and dA 2 each, their
    shared product dh da h_{t-1} 2 and dh's decay 1."""
    nb = -(-sl // 64) + 1
    return ((5 * b * sl * di + 4 * b * sl * ds + 2 * di * ds
             + (nb + 2) * b * di * ds) * 4, 20 * b * sl * di * ds)


def _scan_bwd_checks(name: str, key: str, fwd, bwd, plain_bwd, args,
                     douts, names, wide: str, cost, results) -> None:
    """One backward kernel at the training shape: every gradient against
    autograd through the plain scan (TOL_SCAN_BWD, ``wide``
    TOL_SCAN_BWD_SUM, x max(1, max |plain|)), a repeat bitwise; timed
    back to back and under CUDA-graph replay beside its bound and the
    plain version."""
    _, _, bnd = fwd(*args, boundary=True)
    got = bwd(*args[:5], bnd, *douts)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain_bwd(*args, *douts)        # timed once: it takes seconds
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    worst = 0.0
    for n, a, b_ in zip(names, got, want):
        tol = TOL_SCAN_BWD_SUM if n == wide else TOL_SCAN_BWD
        worst = max(worst, check_rel(f"{name} {n}", a, b_, tol))
    del want
    check_repeat(f"{name} repeat", lambda: torch.cat(
        [t.flatten() for t in bwd(*args[:5], bnd, *douts)]))
    table: dict = {}
    b_ms, b_by = bound(*cost)

    def call():
        return bwd(*args[:5], bnd, *douts)
    ms = time_ms(call, iters=5, warmup=2)
    row = table[key] = dict(ms=ms, graph_ms=graph_ms(call, calls=2),
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None, bound_share=b_ms / ms,
                            max_abs_err=worst)
    log(f"  {key}: {ms * 1e3:.1f} us (graph {row['graph_ms'] * 1e3:.1f}), "
        f"plain {plain_ms * 1e3:.1f} us (one call), bound {b_ms * 1e3:.1f} "
        f"us ({b_by}; {100 * row['bound_share']:.1f}% of it reached)")
    results[name] = row
    results["recurrence_bwd_ms"] = {**results.get("recurrence_bwd_ms", {}),
                                    **table}
    log(f"[recurrence bwd] {name}, ms: " + json.dumps(table))


def rwkv_bwd_kernel_checks(dev, cfg, results) -> None:
    from repro_torch.kernels import recurrence as rec
    b, sl = RWKV_TRAIN["batch"], RWKV_TRAIN["seq"]
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    args = wkv6_args(dev, b, sl, h, hd, 60)
    randn = _randn_fn(dev, 61)
    douts = (randn(b, sl, h, hd), randn(b, h, hd, hd))
    _scan_bwd_checks("wkv6_bwd", f"wkv6_bwd B{b} S{sl} H{h} hd{hd}",
                     rec._wkv6_fwd, rec.wkv6_bwd, rec.wkv6_bwd_plain, args,
                     douts, ("dr", "dk", "dv", "dw", "du", "ds0"), "du",
                     wkv6_bwd_cost(b, sl, h, hd), results)


def jamba_bwd_kernel_checks(dev, cfg, results) -> None:
    from repro_torch.kernels import recurrence as rec
    m = cfg.mamba
    b, sl = JAMBA_TRAIN["batch"], JAMBA_TRAIN["seq"]
    args = scan_args(dev, b, sl, m.d_inner, m.d_state, 62)
    randn = _randn_fn(dev, 63)
    douts = (randn(b, sl, m.d_inner), randn(b, m.d_inner, m.d_state))
    _scan_bwd_checks("selective_scan_bwd",
                     f"selective_scan_bwd B{b} S{sl} di{m.d_inner} "
                     f"ds{m.d_state}", rec._scan_fwd, rec.selective_scan_bwd,
                     rec.selective_scan_bwd_plain, args, douts,
                     ("dxc", "ddt", "dA", "dBm", "dCm", "dh0"), "dA",
                     scan_bwd_cost(b, sl, m.d_inner, m.d_state), results)


def _host_copy(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t,
                    tree)


def block_grad_checks(tag: str, cfg, params, batch, dev) -> tuple:
    """Each block of the kernel path's forward over ``batch``, given that
    forward's input to it: the gradients of sum(out x g) + aux (g a seeded
    unit-normal cotangent) with respect to the block's input and every
    parameter, kernels vs plain, each within TOL_TRAIN_GRAD of its own
    max.  Returns (worst ratio, where)."""
    from contextlib import nullcontext

    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import _positions_from
    from repro_torch.tree import tree_leaves, tree_map, tree_paths
    toks = batch["tokens"]
    positions = _positions_from(0, toks.shape[0], toks.shape[1], dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        x = params["embed"][toks]
    worst, worst_at = 0.0, "(every tensor)"
    for i, (lp, spec) in enumerate(zip(params["layers"],
                                       tf.layer_specs(cfg))):
        cot = torch.randn(x.shape, generator=gen, device=dev)

        def vjp(make_ctx):
            with make_ctx(), torch.enable_grad():
                live = tree_map(lambda t: t.detach().requires_grad_(True), lp)
                xl = x.detach().requires_grad_(True)
                y, _, aux = tf.block_apply(live, cfg, spec, xl, None,
                                           positions=positions, pos=0,
                                           paged=None)
                g = torch.autograd.grad((y * cot).sum() + aux,
                                        [xl] + tree_leaves(live),
                                        allow_unused=True,
                                        materialize_grads=True)
            return y.detach(), g
        y_k, g_k = vjp(nullcontext)
        _, g_p = vjp(_plain_train_kernels)
        names = ["input"] + [p for p, _ in tree_paths(lp)]
        for n, a, b_ in zip(names, g_k, g_p):
            r = max_err(a, b_) / max(float(b_.abs().max()), 1e-30)
            if r > worst:
                worst, worst_at = r, f"block {i} {n}"
        del g_k, g_p
        x = y_k
    if worst > TOL_TRAIN_GRAD:
        fail(f"{tag}: {worst_at} gradient kernels vs plain {worst:.2e} of "
             f"its max > {TOL_TRAIN_GRAD:.0e}")
    log(f"  ok every block given the kernel path's input, kernels vs plain: "
        f"worst gradient {worst_at} {worst:.2e} of its max (limit "
        f"{TOL_TRAIN_GRAD:.0e}; {cfg.n_layers} blocks)")
    return worst, worst_at


def recurrent_train_phase(tag: str, cfg, tr: dict, per_layer: dict, dev,
                          launches, results) -> None:
    """The Trainer on ``cfg`` (full width) for tr['steps'] steps of
    tr['batch'] x tr['seq'] tokens, remat: loss finite, exact launches a
    layer of a step; one step from one state twice, bitwise; one step's
    loss and gradients through the kernels against the plain versions on
    a tr['plain'] batch, each gradient within TOL_TRAIN_GRAD or
    TOL_TRAIN_NOISE times the two paths' own differences on that batch
    given twice, and every block's (:func:`block_grad_checks`); a save
    after one step and a resume continuing with the uninterrupted run's
    loss (depth cut to tr['resume_layers'])."""
    import shutil
    import tempfile
    from contextlib import nullcontext

    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.train import Trainer, make_grad_fn
    from repro_torch.tree import tree_leaves, tree_paths
    b, seq, steps = tr["batch"], tr["seq"], tr["steps"]
    data = SyntheticLM(vocab=tr["data_vocab"], seq_len=seq, global_batch=b,
                       seed=0)
    tmp = tempfile.mkdtemp(prefix=f"repro_torch_{tag}_")
    try:
        tcfg = TrainConfig(lr=3e-4, warmup_steps=1, remat=True,
                           total_steps=steps, checkpoint_every=1000,
                           checkpoint_dir=os.path.join(tmp, "main"))
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = Trainer(cfg, tcfg, b, seq, device=dev, data=data,
                          log=lambda *_: None)
        n_par = sum(p.numel() for p in tree_leaves(trainer.state.params))
        log(f"[{tag}] {cfg.name} full width, {cfg.n_layers} layers, "
            f"{n_par / 1e9:.3f} B parameters; batch {b} x {seq}, data vocab "
            f"{tr['data_vocab']}, remat, norm / ffn {cfg.norm_impl} / "
            f"{cfg.ffn_impl}")
        for k in _build.KERNELS.values():
            k.launches = 0
        hist = []
        for i in range(steps):
            mt = trainer.run(1)
            hist.append(mt)
            log(f"  step {i}: loss {mt['loss']:.5f} grad_norm "
                f"{mt['grad_norm']:.4f} {trainer.step_times[-1] * 1e3:.0f} "
                "ms")
        counts = {k: v.launches for k, v in _build.KERNELS.items()}
        log(f"[{tag}] {steps} steps, last {trainer.step_times[-1] * 1e3:.0f}"
            f" ms a step (first {trainer.step_times[0] * 1e3:.0f} ms), "
            f"{b * seq / trainer.step_times[-1]:.0f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB; "
            f"launches {counts}")
        if not np.isfinite([mt["loss"] for mt in hist]).all():
            fail(f"{tag}: non-finite loss {hist}")
        for k, n in counts.items():
            want = per_layer.get(k, 0) * cfg.n_layers * steps
            if n != want:
                fail(f"{tag}: kernel {k} launched {n} times, expected {want}")
        log(f"  ok exact launches a layer of a step: "
            + "; ".join(f"{k} {v}" for k, v in per_layer.items())
            + "; every other kernel 0")
        for k in per_layer:
            launches[k] = launches.get(k, 0) + counts[k]

        # one step from one state, twice: the same bits (the first
        # result waits on the host, so two new states need not fit)
        state = trainer.state
        tokens, labels = data.batch(steps)
        batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
        s1, m1 = trainer.step_fn(state, batch)
        s1, m1 = _host_copy(s1), _host_copy(m1)
        s2, m2 = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y.cpu()) for x, y in zip(
            tree_leaves(s1), tree_leaves(s2)) if torch.is_tensor(y))
        same = same and all(torch.equal(torch.as_tensor(m1[k]),
                                        torch.as_tensor(m2[k]).cpu())
                            for k in m1)
        if not same:
            fail(f"{tag}: one step from the same state gave other bits")
        log(f"  ok a step repeated from one state: identical bits (loss "
            f"{float(m1['loss']):.6f})")
        del s1, s2, m1, m2

        # one step's loss and gradients, kernels vs plain versions, each
        # gradient beside the two paths' own f32 noise (the batch given
        # twice); one more gradient tree at a time beside g_k and g_p
        pb, ps = tr["plain"]
        small = {k: v[:pb, :ps] for k, v in batch.items()}
        twice = {k: torch.cat([v, v]) for k, v in small.items()}
        grad_fn = make_grad_fn(cfg, tcfg, dev)
        (loss_k, _), g_k = grad_fn(state.params, small)
        with _plain_train_kernels():
            (loss_p, _), g_p = grad_fn(state.params, small)
        torch.cuda.synchronize()
        rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        if rel > TOL_TRAIN_LOSS:
            fail(f"{tag}: loss kernels {float(loss_k)} vs plain "
                 f"{float(loss_p)} (relative {rel:.2e})")
        paths = [p for p, _ in tree_paths(g_k)]
        g_k, g_p = tree_leaves(g_k), tree_leaves(g_p)
        scale = [max(float(gp.abs().max()), 1e-30) for gp in g_p]
        ratio = [max_err(gk, gp) / sc for gk, gp, sc in zip(g_k, g_p, scale)]
        noise = [0.0] * len(paths)
        for make_ctx, ref in ((nullcontext, g_k),
                              (_plain_train_kernels, g_p)):
            with make_ctx():
                _, g2 = grad_fn(state.params, twice)
            noise = [max(n, max_err(a, b_) / sc) for n, a, b_, sc in zip(
                noise, tree_leaves(g2), ref, scale)]
            del g2
        limit = [max(TOL_TRAIN_GRAD, TOL_TRAIN_NOISE * n) for n in noise]
        for path, r, n, lim in zip(paths, ratio, noise, limit):
            if r > lim:
                fail(f"{tag}: gradient {path} kernels vs plain {r:.2e} of "
                     f"its max > {lim:.2e} (TOL_TRAIN_GRAD "
                     f"{TOL_TRAIN_GRAD:.0e}; {TOL_TRAIN_NOISE} x its f32 "
                     f"noise {n:.2e})")
        worst_i = max(range(len(paths)), key=lambda i: ratio[i])
        tight_i = max(range(len(paths)), key=lambda i: ratio[i] / limit[i])
        past = sum(r > TOL_TRAIN_GRAD for r in ratio)
        med = sorted(ratio)[len(ratio) // 2]
        log(f"  ok one step on {pb} x {ps} tokens, kernels vs plain: loss "
            f"relative {rel:.2e} (limit {TOL_TRAIN_LOSS:.0e}); worst "
            f"gradient {paths[worst_i]} {ratio[worst_i]:.2e} of its max, "
            f"median {med:.2e}; f32 noise (each path on the batch given "
            f"twice) worst {max(noise):.2e}, median "
            f"{sorted(noise)[len(noise) // 2]:.2e}; {past} of {len(paths)} "
            f"tensors past {TOL_TRAIN_GRAD:.0e}, each within "
            f"{TOL_TRAIN_NOISE} x its noise; tightest {paths[tight_i]} "
            f"{ratio[tight_i]:.2e} of its {limit[tight_i]:.2e} limit")
        del g_k, g_p, trainer, grad_fn
        results.setdefault("train_grads", {})[tag] = dict(
            loss_rel=rel, worst=ratio[worst_i], worst_at=paths[worst_i],
            median=med, noise_worst=max(noise), past_tol=past,
            tightest=ratio[tight_i] / limit[tight_i])
        block_grad_checks(tag, cfg, state.params, small, dev)
        del state
        _free_weights(dev)

        # save after one step, resume, one more step: the uninterrupted
        # run's loss
        cut = cfg.replace(n_layers=tr["resume_layers"])
        quiet = dict(device=dev, data=data, log=lambda *_: None)

        def tc(name):
            return TrainConfig(lr=3e-4, warmup_steps=1, remat=True,
                               total_steps=steps, checkpoint_every=1000,
                               checkpoint_dir=os.path.join(tmp, name))
        t0 = time.perf_counter()
        first = Trainer(cut, tc("saved"), b, seq, **quiet)
        first.run(1)
        first.save(1)
        del first
        t_save = time.perf_counter() - t0
        resumed = Trainer(cut, tc("saved"), b, seq, **quiet)
        if resumed.start_step != 1:
            fail(f"{tag}: resumed at step {resumed.start_step}, not 1")
        m_res = resumed.run(1)
        del resumed
        m_cont = Trainer(cut, tc("cont"), b, seq, **quiet).run(2)
        if not np.isclose(m_res["loss"], m_cont["loss"], rtol=1e-4, atol=0):
            fail(f"{tag}: resumed loss {m_res['loss']} vs uninterrupted "
                 f"{m_cont['loss']}")
        log(f"  ok save at step 1 ({cut.n_layers} layers, {t_save:.1f} s "
            f"with the step), resume, step 2: loss {m_res['loss']:.6f} vs "
            f"uninterrupted {m_cont['loss']:.6f} (rtol 1e-4; "
            f"{'identical' if m_res['loss'] == m_cont['loss'] else 'close'})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _free_weights(dev)


def rwkv_train_phase(dev, launches, results):
    """rwkv6-1.6b at full width and depth through the Trainer, with the
    WKV's backward kernel held at its training shape first."""
    from repro_torch.configs import registry
    _free_weights(dev)
    t_phase = time.perf_counter()
    base = registry.get_config(RWKV_ID)
    rwkv_bwd_kernel_checks(dev, base, results)
    recurrent_train_phase("rwkv6 train", base.replace(**RWKV_PATH[0]),
                          RWKV_TRAIN, RWKV_TRAIN_PER_LAYER, dev, launches,
                          results)
    log(f"[rwkv6 train] phase {time.perf_counter() - t_phase:.1f} s")


def jamba_train_phase(dev, launches, results):
    """jamba-v0.1-52b at full width and depth 1 (its layer 0: a mamba
    mixer over the dense MLP) through the Trainer, with the selective
    scan's backward kernel held at its training shape first."""
    from repro_torch.configs import registry
    _free_weights(dev)
    t_phase = time.perf_counter()
    full = registry.get_config(JAMBA_ID)
    base = full.replace(n_layers=JAMBA_TRAIN["layers"])
    jamba_bwd_kernel_checks(dev, base, results)
    log(f"[jamba train] depth {base.n_layers} of {full.n_layers}: layer 0 "
        "is a mamba mixer over the dense MLP; depth 2 adds a 16-expert MoE "
        "layer (~2.8 B parameters, ~105 GB with AdamW at ~28 bytes a "
        "parameter)")
    recurrent_train_phase("jamba train", base.replace(
        **JAMBA_PATHS["float"][0]), JAMBA_TRAIN, JAMBA_TRAIN_PER_LAYER, dev,
        launches, results)
    log(f"[jamba train] phase {time.perf_counter() - t_phase:.1f} s")


PHASES = ("qwen", "long", "yi", "train", "bert", "vision", "granite",
          "whisper", "minicpm3", "qwen3", "rwkv6", "jamba", "deepseek",
          "rwkv6-train", "jamba-train")


def main() -> int:
    t_start = time.perf_counter()
    phases = PHASES
    if len(sys.argv) > 1:
        # a development run of some phases: python3 chip_smoke.py granite,yi
        phases = tuple(sys.argv[1].split(","))
        if not set(phases) <= set(PHASES):
            print(f"chip_smoke: phases are {', '.join(PHASES)}",
                  file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (sets the float32 matmul policy)
    from repro_torch.kernels import _build
    import repro_torch.kernels.dualmode_softmax  # noqa: F401  (registers)
    import repro_torch.kernels.flash_attention_bwd  # noqa: F401  (registers)
    import repro_torch.kernels.flash_attention_int  # noqa: F401  (registers)
    import repro_torch.kernels.flash_decode  # noqa: F401  (registers)
    import repro_torch.kernels.fused_ffn  # noqa: F401  (registers)
    import repro_torch.kernels.fused_norm  # noqa: F401  (registers)
    import repro_torch.kernels.recurrence  # noqa: F401  (registers)
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
            if "registers" in line or "spill" in line or (
                    src.startswith(("norm_", "glu", "flash_bwd",
                                    "flash_fwd", "flash_snap", "decode_",
                                    "softmax_rows", "pair_act", "flash_int3",
                                    "resnorm", "wkv6",
                                    "selective_scan"))
                    and "entry function" in line):
                log(f"  {src}: {line.strip()}")
    log("[sass] rows 1 / 2 int entries, instructions (total, loops, mix of "
        "the longest loop or the entry): " + json.dumps(
            sass_report(info["dir"])))
    snap_sass = snap_int_ops(info["dir"])
    log("[sass] row 8 entries, int instructions a score over row 7's "
        "(D,BQ,NS,VEC: count, key-tile loop mixes): "
        + json.dumps(snap_sass))
    int3_sass = int3_int_ops(info["dir"])
    log("[sass] row 9 entries, int instructions a score over row 7's "
        "(D,BQ,NS,VEC,CACHE: count, outermost loop mixes): "
        + json.dumps(int3_sass))

    results: dict = {"snap_sass": snap_sass, "int3_sass": int3_sass}
    launches: dict = {}
    if "qwen" in phases:
        kernel_phase(dev, results)
        qwen = serve_phase(dev, launches)
        pressure_phase(dev, launches, *qwen)
        del qwen
        torch.cuda.empty_cache()
    if "long" in phases:
        long_kernel_phase(dev, results)
        long_serve_phase(dev, launches)
    if "yi" in phases:
        yi_kernel_phase(dev, results)
        yi_serve_phase(dev, launches)
    if "train" in phases:
        train_kernel_phase(dev, results)
        train_phase(dev, launches, results)
    if "bert" in phases:
        bert_kernel_phase(dev, results)
        bert_phase(dev, launches)
    if "vision" in phases:
        vision_kernel_phase(dev, results)
        vision_serve_phase(dev, launches)
    if "granite" in phases:
        granite_phase(dev, launches)
    if "whisper" in phases:
        whisper_phase(dev, launches)
    if "minicpm3" in phases:
        minicpm_phase(dev, launches, results)
    if "qwen3" in phases:
        qwen3_phase(dev, launches, results)
    if "rwkv6" in phases:
        rwkv_phase(dev, launches, results)
    if "jamba" in phases:
        jamba_phase(dev, launches, results)
    if "deepseek" in phases:
        deepseek_phase(dev, launches, results)
    if "rwkv6-train" in phases:
        rwkv_train_phase(dev, launches, results)
    if "jamba-train" in phases:
        jamba_train_phase(dev, launches, results)
    log(f"[chip_smoke] phases {', '.join(phases)} in "
        f"{time.perf_counter() - t_start:.1f} s with the build")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi: {smi.stderr.strip()}")
    if phases != PHASES:
        print(json.dumps({"ok": True, "phases": list(phases)}), flush=True)
        return 0
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
