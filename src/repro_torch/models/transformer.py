"""Transformer stack of the port (counterpart of
``repro.models.transformer``) for the dense attention + MLP pattern
(``mixer='attn'``, ``ffn='mlp'``): the qwen / yi decoders (RMSNorm,
RoPE, gated MLP) and the bert-base encoder (LayerNorm, a learned
position table, non-causal attention, an ungated MLP), with the
reference's fused norm seams (``norm_impl``) and fused GLU
(``ffn_impl``).

bert-base also rotates q and k by RoPE: its config leaves ``use_rope``
at its default (True), so the reference applies RoPE on top of the
learned table, and the port matches the reference rather than Devlin
et al.

The reference stacks each period's parameters on a leading axis for
``jax.lax.scan``; PyTorch runs eagerly, so here the layers are a plain
list and the stack is a Python loop.  ``models/convert.py`` maps the
reference's stacked pytree onto this layout.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import dispatch

from .attention import AttnSpec, _positions_from, gqa_apply
from .layers import (Params, embed_init, linear_init, make_norm, mlp,
                     mlp_init, rmsnorm_init)


def attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                    qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                    rope_theta=cfg.rope_theta, softmax_impl=cfg.softmax_impl,
                    causal=cfg.causal, use_rope=cfg.use_rope,
                    attn_impl=cfg.attn_impl, norm_eps=cfg.norm_eps)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet
    (other mixers, MoE, encoder-decoder stacks, sinusoid positions)."""
    why = []
    if cfg.prefix or any(s != LayerSpec() for s in cfg.pattern):
        why.append("layer patterns other than dense attn + mlp")
    if cfg.enc_layers or cfg.mla or cfg.moe or cfg.mamba:
        why.append("encoder / MLA / MoE / mamba layers")
    if cfg.norm not in ("rms", "layer"):
        why.append(f"norm={cfg.norm!r}")
    if cfg.pos_emb not in ("rope", "learned"):
        why.append(f"pos_emb={cfg.pos_emb!r}")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {'; '.join(why)}")


# ---------------- params ----------------

def block_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    s = attn_spec(cfg)
    norm_init, _ = make_norm(cfg.norm)
    mixer = {
        "wq": linear_init(gen, s.d_model, s.n_heads * s.head_dim, device,
                          bias=s.qkv_bias),
        "wk": linear_init(gen, s.d_model, s.n_kv_heads * s.head_dim, device,
                          bias=s.qkv_bias),
        "wv": linear_init(gen, s.d_model, s.n_kv_heads * s.head_dim, device,
                          bias=s.qkv_bias),
        "wo": linear_init(gen, s.n_heads * s.head_dim, s.d_model, device)}
    if s.qk_norm:
        mixer["qn"] = rmsnorm_init(s.head_dim, device)
        mixer["kn"] = rmsnorm_init(s.head_dim, device)
    return {"norm1": norm_init(cfg.d_model, device), "mixer": mixer,
            "norm2": norm_init(cfg.d_model, device),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, device,
                            gated=cfg.gated_mlp)}


def init_lm(cfg: ModelConfig, generator: torch.Generator, device=None
            ) -> Params:
    """Random float32 weights with the reference's distributions (normal
    x 0.02 embeddings, normal / sqrt(d_in) projections, zero biases, unit
    norm gains, zero norm biases), drawn from ``generator`` (which must
    live on ``device``).  A learned position table has min(max_seq, 2**16)
    rows, as the reference's.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    norm_init, _ = make_norm(cfg.norm)
    params: Params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dev),
        "final_norm": norm_init(cfg.d_model, dev),
        "layers": [block_init(generator, cfg, dev)
                   for _ in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(generator, cfg.d_model, cfg.vocab,
                                        dev)
    if cfg.pos_emb == "learned":
        params["pos"] = embed_init(generator, min(cfg.max_seq, 1 << 16),
                                   cfg.d_model, dev)
    return params


def paged_supported(cfg: ModelConfig) -> bool:
    """Whether every cached layer of ``cfg`` can live in a paged pool."""
    specs = tuple(cfg.prefix) + tuple(cfg.pattern)
    return (not cfg.enc_layers and
            all(s.mixer in ("attn", "mla", "none") and not s.cross
                for s in specs))


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None
                ) -> list[Params]:
    """One {'k','v'} (batch, max_seq, K, h) zero row pair per layer: the
    contiguous cache (the reference stacks the layers of each period on a
    leading axis; here they are a list, as the parameters are)."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, device=dev),
             "v": torch.zeros(shape, device=dev)}
            for _ in range(cfg.n_layers)]


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_size: int,
                      device=None) -> list[Params]:
    """One {'k','v'} (N, bs, K, h) pool pair per layer; all layers share
    one block table per request.  Block 0 is the write sentinel."""
    if not paged_supported(cfg):
        raise ValueError("paged KV requires attention-only cached layers")
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, device=dev),
             "v": torch.zeros(shape, device=dev)}
            for _ in range(cfg.n_layers)]


# ---------------- apply ----------------

def block_apply(p: Params, cfg: ModelConfig, x, cache, *, positions, pos,
                paged):
    """One attn + mlp block.  With a fused norm provider (``norm_impl``
    resolved for x's device) the reference's seams run fused: norm1 into
    the QKV projection (prologue), the attention residual add + norm2 as
    one epilogue; the FFN's own seam is the fused GLU (``ffn_impl``)."""
    nprov = dispatch.get_norm(dispatch.resolve_norm(cfg.norm_impl, x.device))
    if nprov is not None:
        o, cache = gqa_apply(p["mixer"], attn_spec(cfg), x,
                             positions=positions, cache=cache, pos=pos,
                             paged=paged, prenorm=(p["norm1"], cfg.norm,
                                                   cfg.norm_eps, nprov))
        x, h = nprov["residual_norm"](x, o, p["norm2"]["g"],
                                      p["norm2"].get("b"), kind=cfg.norm,
                                      eps=cfg.norm_eps)
    else:
        _, norm = make_norm(cfg.norm)
        h = norm(p["norm1"], x, cfg.norm_eps)
        o, cache = gqa_apply(p["mixer"], attn_spec(cfg), h,
                             positions=positions, cache=cache, pos=pos,
                             paged=paged)
        x = x + o
        h = norm(p["norm2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h, cfg.activation, impl=cfg.ffn_impl), cache


def lm_apply(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
             pos=0, caches: list | None = None, last_pos=None, paged=None,
             remat: bool = False, return_hidden: bool = False, device=None):
    """tokens (B,S) -> (logits, caches).

    caches=None : full causal forward, no state.
    caches      : :func:`init_caches` rows: prefill (pos=0, S=bucket) or
                  decode (S=1) at offset ``pos`` (scalar, or (B,) for
                  continuous batching); the rows are updated in place
                  and returned.
    caches+paged: prefill a chunk or decode one token at offset ``pos``
                  through the (B, max_blocks) block tables; the pools are
                  updated in place and returned.
    last_pos    : optional (B,) rows -- logits only there.
    remat       : train mode (caches=None): checkpoint each block
                  (``torch.utils.checkpoint``, non-reentrant), the
                  reference's per-period ``jax.checkpoint`` with one block
                  a period -- its activations are recomputed in backward.
    return_hidden: skip the LM head and return the final-norm hidden
                  states (the chunked CE applies the head itself).
    device      : where to run; None means the GPU (raising when there is
                  none).  Params and tokens must already live there.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    check_on(dev, tokens=tokens, embed=params["embed"])
    if paged is not None and caches is None:
        raise ValueError("paged block tables need the paged caches")
    b, sl = tokens.shape
    x = params["embed"][tokens]
    positions = _positions_from(pos, b, sl, dev)
    if cfg.pos_emb == "learned":
        rows = params["pos"].shape[0]
        x = x + params["pos"][torch.clamp(positions, 0, rows - 1)]
    if remat and caches is not None:
        raise ValueError("remat is for train mode (caches=None)")
    for i, lp in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_train_block, lp, cfg, x, positions,
                           use_reentrant=False)
            continue
        x, _ = block_apply(lp, cfg, x, None if caches is None else caches[i],
                           positions=positions, pos=pos, paged=paged)
    if last_pos is not None:
        idx = last_pos.to(dev).long()[:, None, None].expand(b, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    x = make_norm(cfg.norm)[1](params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, caches
    return x @ lm_head_weight(params, cfg), caches


def _train_block(lp: Params, cfg: ModelConfig, x, positions):
    return block_apply(lp, cfg, x, None, positions=positions, pos=0,
                       paged=None)[0]


def lm_head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """(d, vocab) head matrix (the transposed embedding when tied)."""
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])
