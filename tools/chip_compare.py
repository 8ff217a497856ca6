"""Compares two trees of the PyTorch port on one GPU: run it once a tree,
in turns (parent, change, change, parent), inside one call to the card.

    python tools/chip_compare.py kernels TREE TAG [ROWS]  # rows 1, 2, 5, 7,
                                                          # 12, 13
    python tools/chip_compare.py tick TREE                # long-context serve
    python tools/chip_compare.py yi TREE                  # yi-6b serve
    python tools/chip_compare.py bert TREE                # bert-base forward

TREE is the root of a checkout (its ``src/`` holds ``repro_torch``); its
kernels build into that checkout.  ``kernels`` times rows 7 (flash_fwd)
and 5 (decode_dense, at several split counts) through the tree's
wrappers at the paths' shapes, back to back and under CUDA-graph replay,
one JSON line a shape, and the float ``flash_decode_pallas`` wrapper at
the long-context path's shape on the host's clock; rows 12 (fused_glu:
yi-6b's tick and chunk, llama-3.2-vision's bucket-4096 prefill) and 13
(glu_bwd, qwen1.5-0.5b's training shape) likewise, and rows 1
(softmax_rows, int and float: qwen1.5-0.5b's chunk rows and bert-base's
score rows) and 2 (pair_act: qwen's SiLU gate, bert's GELU activation),
with the static SASS counts of their int entries in the tree's build;
ROWS (a comma list, default all six) picks some.  Every tree runs on the timers of this
checkout's chip_smoke.py.  ``tick`` runs the tree's own
chip_smoke.py long-context serve phase (the contiguous engine at max_seq
16384, float and dual-mode), ``yi`` its yi-6b serve phase (the paged
engine with the fused impls, float and dual-mode), ``bert`` its bert-base
phase (full-width forwards of 8 x 512 tokens: float, dual-mode, row 9,
i-GELU).
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timers():
    """This checkout's chip_smoke.py, for its timers (the same for every
    tree compared)."""
    spec = importlib.util.spec_from_file_location(
        "chip_timers", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(tree: str):
    root = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(root, "src"), root]
    os.chdir(root)
    import repro_torch  # noqa: F401  (sets the float32 matmul policy)
    return root


def kernels(tree: str, tag: str, rows: str = "1,2,5,7,12,13") -> None:
    _load(tree)
    rows = {int(r) for r in rows.split(",")}
    import torch
    timers = _timers()
    time_ms, graph_ms = timers.time_ms, timers.graph_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    fwd_shapes = {"path": (1, 4096, 16384, 16, 1, 64, True, False),
                  "train": (2, 4096, 4096, 16, 1, 64, True, True),
                  "cross": (1, 4096, 1601, 8, 4, 128, False, False),
                  "self": (1, 4096, 4096, 8, 4, 128, True, False)}
    for name, (b, s, t, kh, g, h, causal, stats) in (
            fwd_shapes.items() if 7 in rows else ()):
        qf = randn(b, s, kh, g, h, scale=h ** -0.5).contiguous()
        k, v = randn(b, t, kh, h), randn(b, t, kh, h)
        qp = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
            b, s).contiguous()
        valid = (torch.arange(t, device=dev)[None] < s) if causal else \
            torch.ones(1, t, dtype=torch.bool, device=dev)
        valid = valid.expand(b, t).to(torch.uint8).contiguous()

        def fwd():
            return fa.flash_fwd(qf, k, v, qp, valid, causal=causal,
                                block_kv=64, return_stats=stats)
        print(json.dumps(dict(tag=tag, kernel="flash_fwd", shape=name,
                              ms=time_ms(fwd, iters=5, warmup=2),
                              graph_ms=graph_ms(fwd, calls=2, iters=3))),
              flush=True)
        del qf, k, v

    dec_shapes = {
        "path": (4, 16384, 16, 1, 64, [1100, 2500, 3900, 4015], True),
        "cross": (4, 1601, 8, 4, 128, [0, 0, 0, 0], False),
        "self": (4, 4096, 8, 4, 128, [375, 737, 1420, 2750], True)}
    for name, (b, t, kh, g, h, qpos, causal) in (
            dec_shapes.items() if 5 in rows else ()):
        qf = randn(b, kh, g, h, scale=h ** -0.5).contiguous()
        k, v = randn(b, t, kh, h), randn(b, t, kh, h)
        qp = torch.tensor(qpos, dtype=torch.int32, device=dev)
        valid = (torch.arange(t, device=dev)[None] <= qp[:, None]) if causal \
            else torch.ones(b, t, dtype=torch.bool, device=dev)
        valid = valid.to(torch.uint8).contiguous()
        res = {}
        for ns, bkv in ((3, 128), (8, 128), (8, 64), (17, 64), (32, 64)):
            def dec(ns=ns, bkv=bkv):
                return fd.decode_dense_partials(
                    qf, k, v, qp, valid, num_splits=ns, block_kv=bkv,
                    causal=causal, int_mode=False, guard_shift=0)
            res[f"{ns}x{bkv}"] = (time_ms(dec) * 1e3, graph_ms(dec) * 1e3)
        print(json.dumps(dict(tag=tag, kernel="decode_dense", shape=name,
                              us_and_graph_us=res)), flush=True)
        if name == "path":
            # the whole wrapper as a tick calls it, at the tree's splits
            def wrap():
                return fd.flash_decode_pallas(
                    qf[:, None], k, v, q_pos=qp[:, None], kv_valid=valid,
                    causal=causal, scale=1.0)
            runs = [timers.host_ms(wrap) for _ in range(3)]
            print(json.dumps(dict(tag=tag, kernel="flash_decode_pallas",
                                  shape=name, host_and_wall_ms=runs)),
                  flush=True)
        del qf, k, v
    _glu_rows(tag, rows, timers, randn)
    _unit_rows(tag, rows, timers, randn)


def _unit_rows(tag: str, rows: set, timers, randn) -> None:
    """Rows 1 and 2 through the tree's wrappers at the paths' shapes, and
    the SASS counts of their int entries in the tree's build."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import dualmode_softmax as ds
    time_ms, graph_ms = timers.time_ms, timers.graph_ms
    if 1 in rows:
        for name, (r, n) in {"qwen": (1024, 2048),
                             "bert": (49152, 512)}.items():
            x = randn(r, n, scale=3.0)
            if name == "qwen":   # the chunk's causal MASK_VALUE tail
                qpos = torch.arange(r, device=x.device) % 64 + 1000
                keep = torch.arange(n, device=x.device)[None] <= qpos[:, None]
                x = torch.where(keep, x, torch.full_like(x, -30.0))
            for prec in ("int", "float"):
                def fn(prec=prec):
                    return ds.softmax_rows(x, prec)
                print(json.dumps(dict(
                    tag=tag, kernel="softmax_rows", shape=name,
                    precision=prec, ms=time_ms(fn), graph_ms=graph_ms(fn))),
                    flush=True)
            del x
    if 2 in rows:
        for name, (m, f, modes) in {"qwen": (64, 2816, ("silu",)),
                                    "bert": (4096, 3072, ("gelu", "silu"))
                                    }.items():
            z = randn(m, f, scale=3.0)
            for mode in modes:
                for prec in ("int", "float"):
                    def fn(mode=mode, prec=prec):
                        return ds.pair_act(z, mode, prec)
                    print(json.dumps(dict(
                        tag=tag, kernel="pair_act", shape=name, mode=mode,
                        precision=prec, ms=time_ms(fn),
                        graph_ms=graph_ms(fn))), flush=True)
            del z
    if rows & {1, 2}:
        _build.LIBRARY.get()
        print(json.dumps(dict(tag=tag, sass=timers.sass_report(
            _build.LIBRARY.info["dir"]))), flush=True)


def _glu_rows(tag: str, rows: set, timers, randn) -> None:
    """Rows 12 and 13 through the tree's wrappers at the paths' shapes."""
    from repro_torch.kernels import fused_ffn as ff
    time_ms, graph_ms = timers.time_ms, timers.graph_ms
    for name, (row, m, k, f) in {"yi M4": (12, 4, 4096, 11008),
                                 "yi M64": (12, 64, 4096, 11008),
                                 "vision M4096": (12, 4096, 4096, 14336),
                                 "train": (13, 8192, 1024, 2816)}.items():
        if row not in rows:
            continue
        x, dy = randn(m, k), randn(m, f)
        wg, wu = randn(k, f, scale=k ** -0.5), randn(k, f, scale=k ** -0.5)
        if row == 12:
            kernel = "fused_glu"

            def fn():
                return ff.fused_glu(x, wg, wu, mode="silu")
        else:
            kernel = "glu_bwd"

            def fn():
                return ff.glu_bwd(x, wg, wu, dy, mode="silu")
        big = m * k * f > 1e10
        print(json.dumps(dict(
            tag=tag, kernel=kernel, shape=name,
            ms=time_ms(fn, iters=5 if big else 20, warmup=2),
            graph_ms=graph_ms(fn, calls=2 if big else 10, iters=3))),
            flush=True)
        del x, dy, wg, wu


def _serve(tree: str, phase: str) -> None:
    """The tree's own chip_smoke.py serve phase ``phase``."""
    root = _load(tree)
    import torch
    import chip_smoke
    import repro_torch.kernels.dualmode_softmax  # noqa: F401  (registers)
    import repro_torch.kernels.flash_attention_int  # noqa: F401
    import repro_torch.kernels.flash_decode  # noqa: F401
    import repro_torch.kernels.fused_ffn  # noqa: F401
    import repro_torch.kernels.fused_norm  # noqa: F401
    print("tree", root, flush=True)
    getattr(chip_smoke, phase)(torch.device("cuda"), {})


def tick(tree: str) -> None:
    _serve(tree, "long_serve_phase")


def yi(tree: str) -> None:
    _serve(tree, "yi_serve_phase")


def bert(tree: str) -> None:
    _serve(tree, "bert_phase")


if __name__ == "__main__":
    mode, *args = sys.argv[1:]
    {"kernels": kernels, "tick": tick, "yi": yi, "bert": bert}[mode](*args)
