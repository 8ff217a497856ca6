"""Serving launcher of the port: the continuous-batching engine (paged or
contiguous KV cache) over synthetic requests, on the GPU (``--device
cpu`` runs the plain versions).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 8 --slots 4 --max-new 16 --max-seq 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --norm-impl fused_pallas --ffn-impl fused_pallas --max-seq 4096
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-11b --max-seq 4096
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --norm-impl fused_pallas \
        --ffn-impl fused_pallas --max-seq 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \
        --norm-impl fused_pallas --ffn-impl fused_pallas --max-seq 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --norm-impl fused_pallas --ffn-impl fused_pallas --max-seq 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --max-seq 448 --prefill-impl flash_pallas --decode-impl flash_decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --norm-impl fused_pallas --max-seq 16384
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
        --layers 8 --norm-impl fused_pallas --ffn-impl fused_pallas \
        --max-seq 4096
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --norm-impl fused_pallas \
        --ffn-impl fused_pallas --max-seq 2048

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --max-seq 64 --num-blocks 7 --preempt-mode swap

Full width by default; ``--reduced`` takes the arch's smoke config and
``--layers`` cuts the depth (jamba-v0.1-52b's 32 layers, 192 GiB in f32,
fit no single card; its first period of 8 does; deepseek-v2-lite-16b,
58.5 GiB, runs alone on an 80 GB card at full depth).  A
``--num-blocks`` under the traffic's demand makes the paged engine
preempt (``--preempt-mode``, ``--preempt-policy``); ``--admission``,
``--hol-window`` and ``--deadline-s`` are the reference launcher's.  The
requests are text-only, as the reference launcher's: on
llama-3.2-vision and whisper-base they attend over a zero cross cache
('auto' picks the contiguous cache there; no frames reach the encoder).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_lm
from repro_torch.serve import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--softmax-impl", default=None,
                    choices=("float", "dualmode"),
                    help="attention softmax (default: the config's)")
    ap.add_argument("--activation", default=None,
                    help="FFN activation, e.g. silu_dualmode (default: the "
                         "config's)")
    ap.add_argument("--norm-impl", default=None,
                    choices=("auto", "dense", "fused_pallas"),
                    help="the block's norm seams: 'fused_pallas' runs the "
                         "residual-norm epilogue and the norm -> QKV "
                         "prologue kernels, 'auto' picks them on a GPU "
                         "(default: the config's)")
    ap.add_argument("--ffn-impl", default=None,
                    choices=("auto", "dense", "fused_pallas"),
                    help="gated FFN: 'fused_pallas' runs the fused GLU "
                         "kernel for fusable activations, 'auto' picks it "
                         "on a GPU (default: the config's)")
    ap.add_argument("--prefill-impl", default=None,
                    help="attention impl for prefill chunks (default: "
                         "resolve the config's per phase)")
    ap.add_argument("--decode-impl", default=None,
                    help="attention impl for decode, e.g. 'flash_decode' to "
                         "force the paged split-KV kernel at any cache "
                         "length (default: 'auto', which picks it at "
                         "--max-seq >= 1024)")
    ap.add_argument("--cache-mode", default="auto",
                    choices=("auto", "paged", "contiguous"),
                    help="KV cache layout: 'paged' = block-table pool with "
                         "prefix sharing + chunked prefill, 'contiguous' = "
                         "per-slot rows with bucketed prefill, 'auto' = "
                         "paged wherever the arch supports it")
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged KV block size in tokens (0 = the tiling "
                         "policy's pick for --max-seq)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged pool size in blocks incl. the sentinel "
                         "(0 = slots * max_blocks + 1)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill chunk length in tokens (0 = 64)")
    ap.add_argument("--admission", default="reactive",
                    choices=("reactive", "worst_case"),
                    help="paged admission: 'reactive' reserves only the "
                         "prompt's block reach and grows per decode tick "
                         "(preempting under pool pressure), 'worst_case' "
                         "reserves prompt + max_new up front so admitted "
                         "requests never preempt")
    ap.add_argument("--preempt-policy", default="youngest",
                    choices=("youngest", "oldest"),
                    help="victim choice under pool pressure (always "
                         "lowest priority first; this orders ties)")
    ap.add_argument("--preempt-mode", default="recompute",
                    choices=("recompute", "swap"),
                    help="'recompute' drops a victim's blocks and "
                         "prefills again on resume; 'swap' copies them to "
                         "host memory and restores the exact bytes")
    ap.add_argument("--hol-window", type=int, default=4,
                    help="queue entries a pool-blocked head request can "
                         "be skipped past at admission (1 = strict FCFS)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline in seconds (0 = none); "
                         "expired requests retire with reason 'deadline'")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.softmax_impl:
        cfg = cfg.replace(softmax_impl=args.softmax_impl)
    if args.activation:
        cfg = cfg.replace(activation=args.activation)
    if args.norm_impl:
        cfg = cfg.replace(norm_impl=args.norm_impl)
    if args.ffn_impl:
        cfg = cfg.replace(ffn_impl=args.ffn_impl)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                     dev)
    eng = ServeEngine(cfg, params, n_slots=args.slots, max_seq=args.max_seq,
                      seed=args.seed, prefill_attn_impl=args.prefill_impl,
                      decode_attn_impl=args.decode_impl,
                      block_size=args.block_size or None,
                      num_blocks=args.num_blocks or None,
                      prefill_chunk=args.prefill_chunk or None,
                      cache_mode=args.cache_mode,
                      admission=args.admission,
                      preempt_policy=args.preempt_policy,
                      preempt_mode=args.preempt_mode,
                      hol_window=args.hol_window, device=dev)
    layout = (f"block={eng.block_size} pool={eng.num_blocks} chunk="
              f"{eng.prefill_chunk}" if eng.cache_mode == "paged"
              else f"buckets={eng.buckets}")
    print(f"[serve] {cfg.name} on {dev}: cache={eng.cache_mode} ({layout}) "
          f"attention impls: prefill={eng.prefill_attn_impl} "
          f"decode={eng.decode_attn_impl}; norm={cfg.norm_impl} "
          f"ffn={cfg.ffn_impl}")
    rng = np.random.RandomState(args.seed + 1)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.randint(2, 16))
        reqs.append(Request(rid=i, prompt=rng.randint(
            0, cfg.vocab - 1, size=plen).tolist(), max_new=args.max_new,
            temperature=args.temperature,
            deadline_s=args.deadline_s or None))
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in outs.values())
    print(f"[serve] {len(outs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) stats={eng.stats}")
    for rid in sorted(outs)[:4]:
        print(f"  rid={rid}: {outs[rid][:12]}...")


if __name__ == "__main__":
    main()
