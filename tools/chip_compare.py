"""Compares two trees of the PyTorch port on one GPU: run it once a tree,
in turns (parent, change, change, parent), inside one call to the card.

    python tools/chip_compare.py kernels TREE TAG [ROWS [DIR]]  # rows 1-9,
                                                  # 12-14
    python tools/chip_compare.py words DIR TAG TAG  # words two trees saved
    python tools/chip_compare.py paged_probe TREE TAG  # rows 3 / 4, G, splits
    python tools/chip_compare.py tick TREE          # long-context serve
    python tools/chip_compare.py qwen TREE          # qwen1.5-0.5b paged serve
    python tools/chip_compare.py yi TREE            # yi-6b serve
    python tools/chip_compare.py bert TREE          # bert-base forward
    python tools/chip_compare.py vision TREE        # llama-3.2-vision serve

TREE is the root of a checkout (its ``src/`` holds ``repro_torch``); its
kernels build into that checkout.  ``kernels`` times, through the tree's
wrappers at the paths' shapes, back to back and under CUDA-graph replay,
one JSON line a shape: rows 7 (flash_fwd) and 8 (flash_snap) at the
long-context path's, the vision cross and the vision self shapes, with a
digest of row 7's outputs and of row 8's (m, S) words on seeded random
inputs; rows 5 (decode_dense, at several split counts) and 6
(decode_dense_int, at the tree's own splits and tile, with the split fold,
the whole dual-mode ``flash_decode_pallas`` on the host's clock at those
and at the reference rule's, and a digest of its words at two fixed
(splits, tile)) at the long-context tick and the vision cross and self
ticks, and the float ``flash_decode_pallas`` at the long-context tick on
the host's clock; rows 3 and 4 (decode_paged, float and int) at qwen1.5-0.5b's
and yi-6b's paged ticks, at the tree's own split count, alone and with
the split fold, with digests of the folded output and the folded l words
on exact scores; rows 12 (fused_glu: yi-6b's tick and chunk, llama-3.2-vision's
bucket-4096 prefill) and 13 (glu_bwd, qwen1.5-0.5b's training shape)
likewise, and rows 1 (softmax_rows, int and float: qwen1.5-0.5b's chunk
rows and bert-base's score rows) and 2 (pair_act: qwen's SiLU gate,
bert's GELU activation), with the static SASS counts of their int entries
in the tree's build; row 9 (flash_int3) at bert-base's shape (B8 S = T =
512 K12 h64, non-causal), with the digest of its identity-v outputs on
seeded random q and k (every output one probability word: the same score
FMA order leaves them the same bits in every tree), and row 14
(fused_residual_norm) at yi-6b's tick and chunk (M 4 and 64, d 4096, rms),
bert-base's (M 4096, d 768, layer) and llama-3.2-vision's bucket-4096
prefill (M 4096, d 4096, rms), beside its two-call equivalent
(torch.add, then F.rms_norm or F.layer_norm) and with its host time to
issue a call.  ROWS (a comma list, default all twelve) picks some;
with DIR, the digested words also go to DIR/words_TAG.pt, and ``words``
counts the words that differ between two tags' files.  ``paged_probe``
times rows 3 and 4 under CUDA-graph replay by split count at yi-6b's
tick geometry for G 1, 2, 4 and 8, and at qwen1.5-0.5b's.  Every tree runs on
the timers of this checkout's chip_smoke.py.  ``tick`` runs the tree's
own chip_smoke.py long-context serve phase (the contiguous engine at
max_seq 16384, float and dual-mode), ``qwen`` its qwen1.5-0.5b serve
phase (the paged engine at max_seq 2048, float and dual-mode), ``yi``
its yi-6b serve phase (the
paged engine with the fused impls, float and dual-mode), ``bert`` its
bert-base phase (full-width forwards of 8 x 512 tokens: float, dual-mode,
row 9, i-GELU), ``vision`` its llama-3.2-vision-11b serve phase (float
and dual-mode prefills of buckets 512 / 1024 / 4096 and ticks).
"""
from __future__ import annotations

import hashlib
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


def _digest(*xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernels(tree: str, tag: str, rows: str = "1,2,3,4,5,6,7,8,9,12,13,14",
            words_dir: str | None = None) -> None:
    if words_dir is not None:
        words_dir = os.path.abspath(words_dir)   # before _load's chdir
    _load(tree)
    rows = {int(r) for r in rows.split(",")}
    import torch
    timers = _timers()
    time_ms, graph_ms = timers.time_ms, timers.graph_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(7)
    saved = {}                  # the digested words, by entry

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
        res = fwd()
        print(json.dumps(dict(tag=tag, kernel="flash_fwd", shape=name,
                              ms=time_ms(fwd, iters=5, warmup=2),
                              graph_ms=graph_ms(fwd, calls=2, iters=3),
                              digest=_digest(*(res if stats else (res,))))),
              flush=True)
        del qf, k, v, res
    if 8 in rows:
        _snap_rows(tag, timers, randn, fwd_shapes, saved)

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
        if 6 in rows:
            _dense_int_row(tag, timers, name, (qf, k, v, qp, valid), causal,
                           saved)
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
    if 6 in rows and 5 not in rows:
        raise SystemExit("row 6 is timed on row 5's operands: give 5 too")
    _paged_rows(tag, rows, timers, randn)
    _glu_rows(tag, rows, timers, randn)
    _unit_rows(tag, rows, timers, randn)
    if 9 in rows:
        _int3_row(tag, timers, randn, saved)
    if 14 in rows:
        _resnorm_rows(tag, timers, randn)
    if words_dir is not None:
        os.makedirs(words_dir, exist_ok=True)
        torch.save(saved, os.path.join(words_dir, f"words_{tag}.pt"))


def _snap_rows(tag: str, timers, randn, shapes: dict, saved: dict) -> None:
    """Row 8 through the tree's wrapper at row 7's shapes (training's left
    out), with the digest of its (m, S) words and output on seeded random
    q, k, v (the same draws in every tree)."""
    import torch
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import flash_attention_int as fai
    dev = torch.device("cuda")
    for name, (b, s, t, kh, g, h, causal, stats) in shapes.items():
        if stats:
            continue
        qf = randn(b, s, kh, g, h, scale=h ** -0.5).contiguous()
        k, v = randn(b, t, kh, h), randn(b, t, kh, h)
        qp = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
            b, s).contiguous()
        valid = (torch.arange(t, device=dev)[None] < s) if causal else \
            torch.ones(1, t, dtype=torch.bool, device=dev)
        valid = valid.expand(b, t).to(torch.uint8).contiguous()
        kw = dict(causal=causal, block_kv=64,
                  guard_shift=0 if causal else unit.guard_shift_for(t))

        def snap():
            return fai.flash_snap(qf, k, v, qp, valid, **kw)
        acc, m, S = fai.flash_snap(qf, k, v, qp, valid, return_partial=True,
                                   **kw)
        saved[f"flash_snap {name}"] = (m.cpu(), S.cpu())
        print(json.dumps(dict(tag=tag, kernel="flash_snap", shape=name,
                              ms=timers.time_ms(snap, iters=5, warmup=2),
                              graph_ms=timers.graph_ms(snap, calls=2,
                                                       iters=3),
                              words_digest=_digest(m, S),
                              out_digest=_digest(snap()))), flush=True)
        del qf, k, v, acc, m, S


def _dense_int_row(tag: str, timers, name: str, args, causal: bool,
                   saved: dict) -> None:
    """Row 6 through the tree's wrappers on row 5's operands: the kernel at
    the tree's own (splits, tile), alone and with the split fold; the
    whole dual-mode ``flash_decode_pallas`` as a tick calls it, on the
    host's clock, at the tree's (splits, tile) and at the reference rule's
    (``dense_decode_splits`` keys a split, ``decode_kv_block`` keys a tile),
    in turns; the digest of its words at (3, 128) and (17, 64)."""
    import torch
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tiling
    qf, k, v, qp, valid = args
    b, kh, t = qf.shape[0], qf.shape[1], k.shape[1]
    try:
        ns, bkv = fd.dense_decode_tiles(t, b * kh, qf.device)
    except TypeError:          # a tree whose int decode keeps its own rule
        ns, bkv = fd.dense_decode_tiles(t, b * kh, qf.device, int_mode=True)
    kw = dict(causal=causal, int_mode=True, guard_shift=unit.guard_shift_for(t))

    def dec(ns=ns, bkv=bkv):
        return fd.decode_dense_partials(qf, k, v, qp, valid, num_splits=ns,
                                        block_kv=bkv, **kw)

    def fold():
        return fd.finish_partials(*dec(), int_mode=True)
    digests = {}
    for ns_, bkv_ in ((3, 128), (17, 64)):
        m, S, _ = dec(ns_, bkv_)
        saved[f"decode_dense_int {name} {ns_}x{bkv_}"] = (m.cpu(), S.cpu())
        digests[f"{ns_}x{bkv_}"] = _digest(m, S)
    line = dict(tag=tag, kernel="decode_dense_int", shape=name,
                splits=ns, block_kv=bkv, ms=timers.time_ms(dec),
                graph_ms=timers.graph_ms(dec), with_fold_ms=timers.time_ms(
                    fold), with_fold_graph_ms=timers.graph_ms(fold),
                words_digest=digests)
    ref_ns = fd.dense_decode_splits(t, b * kh, torch.device("cpu"))
    tiles = {"own": (ns, bkv), "reference rule": (
        ref_ns, tiling.decode_kv_block(t, ref_ns))}
    wrap = {key: [] for key in tiles}
    for _ in range(3):
        for key, (ns_, bkv_) in tiles.items():
            wrap[key].append(timers.host_ms(
                lambda ns_=ns_, bkv_=bkv_: fd.flash_decode_pallas(
                    qf[:, None], k, v, q_pos=qp[:, None], kv_valid=valid,
                    causal=causal, scale=1.0, num_splits=ns_,
                    block_kv=bkv_, softmax_impl="dualmode")))
    line["wrapper_host_and_wall_ms"] = {
        f"{key} {ns_}x{bkv_}": wrap[key] for key, (ns_, bkv_) in tiles.items()}
    print(json.dumps(line), flush=True)


def _int3_row(tag: str, timers, randn, saved: dict) -> None:
    """Row 9 through the tree's wrapper at bert-base's shape, with the
    digest of its identity-v outputs (each one probability word) on seeded
    random q and k."""
    import torch
    from repro_torch.kernels import flash_attention_int as fai
    dev = torch.device("cuda")
    b, s, kh, h = 8, 512, 12, 64
    qf = randn(b, s, kh, 1, h, scale=h ** -0.5).contiguous()
    k, v = randn(b, s, kh, h), randn(b, s, kh, h)
    qp = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
        b, s).contiguous()
    valid = torch.ones(b, s, dtype=torch.uint8, device=dev)
    kw = dict(causal=False, block_kv=64, guard_shift=0)

    def fn():
        return fai.flash_int3(qf, k, v, qp, valid, **kw)
    eye = torch.eye(s, device=dev)
    words = [fai.flash_int3(qf, k, eye[:, j:j + 128][None, :, None, :].expand(
        b, s, kh, 128).contiguous(), qp, valid, **kw) for j in range(0, s, 128)]
    saved["flash_int3 bert identity-v"] = tuple(w.cpu() for w in words)
    print(json.dumps(dict(tag=tag, kernel="flash_int3", shape="bert",
                          ms=timers.time_ms(fn, iters=10, warmup=2),
                          graph_ms=timers.graph_ms(fn, calls=2, iters=3),
                          words_digest=_digest(*words))), flush=True)


def _resnorm_rows(tag: str, timers, randn) -> None:
    """Row 14 through the tree's wrapper at yi-6b's tick and chunk,
    bert-base's shape and llama-3.2-vision's bucket-4096 prefill, beside
    its two-call equivalent, with the host's time to issue a call."""
    import torch
    from repro_torch.kernels import fused_norm as fn
    F = torch.nn.functional
    for name, (m, d, kind) in {"yi M4": (4, 4096, "rms"),
                               "yi M64": (64, 4096, "rms"),
                               "bert": (4096, 768, "layer"),
                               "vision M4096": (4096, 4096, "rms")}.items():
        x, r = randn(m, d, scale=3.0), randn(m, d)
        g = 1.0 + randn(d, scale=0.1)
        b = randn(d, scale=0.1) if kind == "layer" else None

        def fn_():
            return fn.fused_residual_norm(x, r, g, b, kind=kind, eps=1e-6)

        def two():
            s_ = torch.add(x, r)
            return s_, (F.rms_norm(s_, (d,), g, 1e-6) if kind == "rms" else
                        F.layer_norm(s_, (d,), g, b, 1e-6))
        print(json.dumps(dict(
            tag=tag, kernel="resnorm", shape=name, ms=timers.time_ms(fn_),
            graph_ms=timers.graph_ms(fn_),
            host_ms=timers.host_ms(fn_, iters=200)[0],
            two_calls_ms=timers.time_ms(two),
            two_calls_graph_ms=timers.graph_ms(two),
            out_digest=_digest(*fn_()))), flush=True)


def _paged_rows(tag: str, rows: set, timers, randn) -> None:
    """Rows 3 and 4 through the tree's wrapper at qwen1.5-0.5b's paged tick
    (B4 K16 G1 h64, 16 pages of 128 keys a row) and yi-6b's (B4 K4 G8
    h128, 32 pages), at the tree's own split count
    (``tiling.decode_splits``), alone and with the split fold, with digests
    of the folded output and (int) of the folded l words.  q and k are
    grid-valued (multiples of 2^-6 and 2^-4), so every score is exact and
    the l words depend on neither the tree's dot order nor its cut."""
    import torch
    from repro_torch.core import softmax_unit as unit
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import tiling
    dev = torch.device("cuda")
    bs = 128
    shapes = {"qwen tick": (4, 16, 1, 64, 16, [300, 800, 1400, 2000]),
              "yi tick": (4, 4, 8, 128, 32, [250, 1300, 2900, 4095])}
    for name, (b, kh, g, h, nblk, q_pos) in shapes.items():
        if not rows & {3, 4}:
            break
        n_pool = 1 + b * nblk
        qf = (torch.round(randn(b, kh, g, h, scale=4.0)) / 64).contiguous()
        kp = torch.round(randn(n_pool, bs, kh, h, scale=4.0)) / 16
        vp = randn(n_pool, bs, kh, h)
        tables = (torch.arange(b * nblk, dtype=torch.int32, device=dev)
                  + 1).reshape(b, nblk)
        qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
        valid = (torch.arange(nblk * bs, device=dev)[None] <= qp[:, None]).to(
            torch.uint8)
        ns = tiling.decode_splits(nblk, bs, b * kh, dev)
        for row, int_mode in ((3, False), (4, True)):
            if row not in rows:
                continue

            def dec(int_mode=int_mode):
                return fd.decode_paged_partials(
                    qf, kp, vp, tables, qp, valid, num_splits=ns, causal=True,
                    int_mode=int_mode, guard_shift=0)

            def fold(int_mode=int_mode):
                return fd.finish_partials(*dec(), int_mode=int_mode)
            line = dict(
                tag=tag, kernel="decode_paged_int" if int_mode
                else "decode_paged", shape=name, splits=ns,
                ms=timers.time_ms(dec), graph_ms=timers.graph_ms(dec),
                with_fold_ms=timers.time_ms(fold),
                with_fold_graph_ms=timers.graph_ms(fold),
                out_digest=_digest(fold()))
            if int_mode:
                m, S, acc = dec()
                S_all = unit.online_merge_n_int(m[..., None], S, acc,
                                                dim=1)[1]
                line["l_digest"] = _digest(unit.online_finish_int(S_all))
            print(json.dumps(line), flush=True)
        del qf, kp, vp


def paged_probe(tree: str, tag: str) -> None:
    """Rows 3 and 4 through the tree's wrapper, device time under
    CUDA-graph replay (µs), by split count: at yi-6b's tick geometry (B4
    K4 h128, 32 pages of 128 keys, depths 250 / 1300 / 2900 / 4095) for G
    1, 2, 4 and 8, and at qwen1.5-0.5b's (B4 K16 G1 h64, 16 pages, depths
    300 / 800 / 1400 / 2000); one JSON line a geometry and mode."""
    _load(tree)
    import torch
    from repro_torch.kernels import flash_decode as fd
    timers = _timers()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(11)
    bs = 128
    cases = [("yi", 4, 4, g, 128, 32, [250, 1300, 2900, 4095], (8, 16, 32))
             for g in (1, 2, 4, 8)]
    cases.append(("qwen", 4, 16, 1, 64, 16, [300, 800, 1400, 2000],
                  (4, 8, 16)))
    for name, b, kh, g, h, nblk, q_pos, splits in cases:
        n_pool = 1 + b * nblk
        qf = torch.randn((b, kh, g, h), generator=gen).to(dev) * h ** -0.5
        kp, vp = (torch.randn((n_pool, bs, kh, h), generator=gen).to(dev)
                  for _ in range(2))
        tables = (torch.arange(b * nblk, dtype=torch.int32, device=dev)
                  + 1).reshape(b, nblk)
        qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
        valid = (torch.arange(nblk * bs, device=dev)[None] <= qp[:, None]).to(
            torch.uint8)
        for int_mode in (False, True):
            us = {ns: 1e3 * timers.graph_ms(
                lambda ns=ns: fd.decode_paged_partials(
                    qf, kp, vp, tables, qp, valid, num_splits=ns, causal=True,
                    int_mode=int_mode, guard_shift=0)) for ns in splits}
            print(json.dumps(dict(tag=tag, geometry=name, g=g,
                                  int_mode=int_mode, graph_us_by_splits=us)),
                  flush=True)


def words(words_dir: str, tag_a: str, tag_b: str) -> None:
    """The words two trees saved (``kernels ... DIR``): how many differ, by
    entry, one JSON line."""
    import torch
    a, b = (torch.load(os.path.join(words_dir, f"words_{t}.pt"))
            for t in (tag_a, tag_b))
    print(json.dumps({key: dict(
        words=sum(x.numel() for x in a[key]),
        differ=sum(int((x != y).sum()) for x, y in zip(a[key], b[key])))
        for key in a if key in b}), flush=True)


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


def qwen(tree: str) -> None:
    _serve(tree, "serve_phase")


def yi(tree: str) -> None:
    _serve(tree, "yi_serve_phase")


def bert(tree: str) -> None:
    _serve(tree, "bert_phase")


def vision(tree: str) -> None:
    _serve(tree, "vision_serve_phase")


if __name__ == "__main__":
    mode, *args = sys.argv[1:]
    {"kernels": kernels, "words": words, "tick": tick, "qwen": qwen, "yi": yi,
     "bert": bert, "vision": vision, "paged_probe": paged_probe}[mode](*args)
