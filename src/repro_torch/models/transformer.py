"""Transformer stack of the port (counterpart of
``repro.models.transformer``): each layer's ``LayerSpec`` has mixer
``'attn'``, ``'mla'`` or ``'none'``, ffn ``'mlp'`` (or ``'moe'`` under an
'attn' or 'mla' mixer), and may carry a tanh-gated cross-attention sublayer
(``cross``); a config with ``enc_layers`` adds an encoder stack whose
output is the decoder's ``cross_src``.  That covers the qwen / yi /
qwen3 decoders (RMSNorm, RoPE, gated MLP; qwen3 with qk-norm), minicpm3
(MLA: keys and values expanded from a cached latent), the bert-base
encoder (LayerNorm, a learned position table, non-causal attention, an
ungated MLP), whisper-base (an encoder over frame embeddings with
sinusoid positions, a decoder with a learned table that cross-attends to
the encoder's output, GELU MLPs), llama-3.2-vision (a period of four
self-attention layers and one 'none'-mixer layer whose cross attention
reads the image embeddings), granite-moe (attention over a
mixture-of-experts FFN, ``models/moe.py``), deepseek-v2-lite (a dense
MLA + MLP prefix layer, then MLA over a MoE with shared experts), rwkv6
(an RWKV-6 time mix over a channel mix, ``models/rwkv.py``) and jamba (a
period of seven Mamba layers and one attention layer, over alternating
MLP and MoE FFNs, ``models/mamba.py``), with the reference's fused norm
seams (``norm_impl``) and fused GLU (``ffn_impl``).

bert-base and whisper-base also rotate q and k by RoPE: their configs
leave ``use_rope`` at its default (True), so the reference applies RoPE
on top of the position tables, and the port matches the reference rather
than the published models.

The reference stacks each period's parameters on a leading axis for
``jax.lax.scan`` and keeps the ``prefix`` layers apart, unstacked;
PyTorch runs eagerly, so here the layers are one plain list in order --
the prefix layers first, then the period repeated over ``n_periods``
(:func:`layer_specs`) -- the encoder's blocks another, and the stacks are
Python loops.  ``models/convert.py`` maps the reference's pytree onto
this layout.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import dispatch

from .attention import (AttnSpec, MLASpec, _positions_from, cross_apply,
                        cross_init, cross_kv, gqa_apply, mla_apply,
                        mla_cache_init, mla_init)
from .layers import (Params, embed_init, linear_init, make_norm, mlp,
                     mlp_init, rmsnorm_init, sinusoidal_pos_emb)
from .mamba import MambaSpec, mamba_apply, mamba_init, mamba_state_init
from .moe import MoESpec, moe_apply, moe_init
from .rwkv import (RWKVSpec, rwkv_channel_mix, rwkv_cm_init, rwkv_state_init,
                   rwkv_time_mix, rwkv_tm_init)


def attn_spec(cfg: ModelConfig, causal: bool | None = None) -> AttnSpec:
    return AttnSpec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                    qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                    rope_theta=cfg.rope_theta, softmax_impl=cfg.softmax_impl,
                    causal=cfg.causal if causal is None else causal,
                    use_rope=cfg.use_rope, attn_impl=cfg.attn_impl,
                    norm_eps=cfg.norm_eps)


def mla_spec(cfg: ModelConfig) -> MLASpec:
    m = cfg.mla
    return MLASpec(cfg.d_model, cfg.n_heads, m.q_lora_rank, m.kv_lora_rank,
                   m.nope_dim, m.rope_dim, m.v_dim,
                   rope_theta=cfg.rope_theta, softmax_impl=cfg.softmax_impl,
                   attn_impl=cfg.attn_impl, norm_eps=cfg.norm_eps)


def moe_spec(cfg: ModelConfig) -> MoESpec:
    m = cfg.moe
    return MoESpec(cfg.d_model, m.d_ff, m.n_experts, m.top_k, m.n_shared,
                   m.capacity_factor, cfg.activation, cfg.ffn_impl,
                   cfg.moe_dispatch, ep_pad=m.ep_pad)


def mamba_spec(cfg: ModelConfig) -> MambaSpec:
    m = cfg.mamba
    return MambaSpec(cfg.d_model, m.d_inner, m.d_state, m.d_conv, m.dt_rank)


def rwkv_spec(cfg: ModelConfig) -> RWKVSpec:
    return RWKVSpec(cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.rwkv_lora_r)


RECURRENT = ("mamba", "rwkv")     # mixers that carry a state, not a KV cache


def recurrent_mixers(cfg: ModelConfig) -> list[str]:
    """The state-carrying mixers among ``cfg``'s layers, sorted."""
    return sorted({s.mixer for s in tuple(cfg.prefix) + tuple(cfg.pattern)
                   if s.mixer in RECURRENT})


def _supported_spec(spec: LayerSpec) -> bool:
    if spec.mixer not in ("attn", "mla", "none") + RECURRENT or (
            spec.cross and spec.mixer in RECURRENT):
        return False
    if spec.ffn == "rwkv_cm":
        return spec.mixer == "rwkv"
    return spec.ffn == "mlp" or (spec.ffn == "moe" and not spec.cross
                                 and spec.mixer in ("attn", "mla", "mamba"))


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet
    (other layer specs, other norms).  It runs attn, MLA and 'none'
    mixers with an mlp (and an optional cross sublayer), attn, MLA and
    mamba mixers with an mlp or a moe ffn, the rwkv time mix over its
    channel mix ('rwkv_cm'), in the period and in the prefix layers, an
    encoder stack (``enc_layers``), and rope, learned, sinusoid or no
    positions."""
    why = []
    specs = tuple(cfg.prefix) + tuple(cfg.pattern)
    if not all(_supported_spec(s) for s in specs):
        why.append("layer specs other than attn / MLA / 'none' mixers "
                   "with an mlp (and an optional cross sublayer), attn, MLA "
                   "or mamba mixers with an mlp or a moe ffn, or rwkv over "
                   "rwkv_cm")
    if cfg.mamba is None and any(s.mixer == "mamba" for s in specs):
        why.append("mamba layers without a mamba config")
    if cfg.norm not in ("rms", "layer"):
        why.append(f"norm={cfg.norm!r}")
    if cfg.pos_emb not in ("rope", "learned", "sinusoid", "none"):
        why.append(f"pos_emb={cfg.pos_emb!r}")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {'; '.join(why)}")


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """The spec of every layer, in order: the prefix layers, then the
    period repeated -- ``n_periods`` times, the reference's order (a depth
    cut to a part of a period, as ``--layers`` may, ends with that
    period's first layers)."""
    body = cfg.n_layers - len(cfg.prefix)
    return list(cfg.prefix) + [cfg.pattern[i % len(cfg.pattern)]
                               for i in range(body)]


# ---------------- params ----------------

def block_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               device) -> Params:
    """The reference's keys for ``spec``: norm1 always (a 'none' block
    carries an unused one), the mixer for 'attn', 'mla', 'mamba' or
    'rwkv' (the time mix), cross_norm / cross / a 0-d cross_gate (zero:
    tanh(0) shuts the sublayer) for cross, then norm2 and the ffn (an
    MLP, the MoE's router and expert stacks, or the rwkv channel mix)."""
    s = attn_spec(cfg)
    norm_init, _ = make_norm(cfg.norm)
    p: Params = {"norm1": norm_init(cfg.d_model, device)}
    if spec.mixer == "attn":
        mixer = {
            "wq": linear_init(gen, s.d_model, s.n_heads * s.head_dim, device,
                              bias=s.qkv_bias),
            "wk": linear_init(gen, s.d_model, s.n_kv_heads * s.head_dim,
                              device, bias=s.qkv_bias),
            "wv": linear_init(gen, s.d_model, s.n_kv_heads * s.head_dim,
                              device, bias=s.qkv_bias),
            "wo": linear_init(gen, s.n_heads * s.head_dim, s.d_model,
                              device)}
        if s.qk_norm:
            mixer["qn"] = rmsnorm_init(s.head_dim, device)
            mixer["kn"] = rmsnorm_init(s.head_dim, device)
        p["mixer"] = mixer
    elif spec.mixer == "mla":
        p["mixer"] = mla_init(gen, mla_spec(cfg), device)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_init(gen, mamba_spec(cfg), device)
    elif spec.mixer == "rwkv":
        p["mixer"] = rwkv_tm_init(gen, rwkv_spec(cfg), device)
    if spec.cross:
        p["cross_norm"] = norm_init(cfg.d_model, device)
        p["cross"] = cross_init(gen, attn_spec(cfg, causal=False), device)
        p["cross_gate"] = torch.zeros((), device=device)
    p["norm2"] = norm_init(cfg.d_model, device)
    if spec.ffn == "moe":
        p["ffn"] = moe_init(gen, moe_spec(cfg), device)
    elif spec.ffn == "rwkv_cm":
        p["ffn"] = rwkv_cm_init(gen, rwkv_spec(cfg), device)
    else:
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, device,
                            gated=cfg.gated_mlp)
    return p


ENC_SPEC = LayerSpec(mixer="attn", ffn="mlp")


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: ``cfg``'s widths and impls, non-causal."""
    return cfg.replace(causal=False, pattern=(ENC_SPEC,), prefix=())


def init_lm(cfg: ModelConfig, generator: torch.Generator, device=None
            ) -> Params:
    """Random float32 weights with the reference's distributions (normal
    x 0.02 embeddings, normal / sqrt(d_in) projections, zero biases, unit
    norm gains, zero norm biases, zero cross gates), drawn from
    ``generator`` (which must live on ``device``).  A learned position
    table has min(max_seq, 2**16) rows, as the reference's.  With
    ``enc_layers``, ``params['encoder']`` holds the encoder's ``blocks``
    (a list, non-causal attn + mlp) and its final ``norm``.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    norm_init, _ = make_norm(cfg.norm)
    params: Params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dev),
        "final_norm": norm_init(cfg.d_model, dev),
        "layers": [block_init(generator, cfg, spec, dev)
                   for spec in layer_specs(cfg)]}
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(generator, cfg.d_model, cfg.vocab,
                                        dev)
    if cfg.pos_emb == "learned":
        params["pos"] = embed_init(generator, min(cfg.max_seq, 1 << 16),
                                   cfg.d_model, dev)
    if cfg.enc_layers:
        params["encoder"] = {
            "blocks": [block_init(generator, _enc_cfg(cfg), ENC_SPEC, dev)
                       for _ in range(cfg.enc_layers)],
            "norm": norm_init(cfg.d_model, dev)}
    return params


def paged_supported(cfg: ModelConfig) -> bool:
    """Whether every cached layer of ``cfg`` can live in a paged pool:
    attention and MLA layers page their rows; a mamba or rwkv state is
    not a sequence of positions, and a cross cache not one of the
    request's, so those archs stay on the contiguous cache."""
    specs = tuple(cfg.prefix) + tuple(cfg.pattern)
    return (not cfg.enc_layers and
            all(s.mixer in ("attn", "mla", "none") and not s.cross
                for s in specs))


def _kv_pair(shape, dev) -> Params:
    return {"k": torch.zeros(shape, device=dev),
            "v": torch.zeros(shape, device=dev)}


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None
                ) -> list[Params]:
    """The contiguous cache, one dict per layer (the reference stacks the
    layers of each period on a leading axis; here they are a list, as the
    parameters are): ``'kv'`` {'k','v'} (batch, max_seq, K, h) zero rows
    for an attention layer, {'ckv','krope'} (batch, max_seq,
    kv_lora_rank / rope_dim) for an MLA layer, ``'cross_kv'`` {'k','v'}
    (batch, n_img_tokens or n_frames, K, h) for a cross-attention
    layer, ``'state'`` for a recurrent layer: {'conv' (batch, d_conv - 1,
    d_inner), 'ssm' (batch, d_inner, d_state)} (mamba) or {'tm_x', 'cm_x'
    (batch, d), 'wkv' (batch, H, hd, hd)} (rwkv, shared by its time and
    channel mix), all zeros."""
    check_supported(cfg)
    dev = resolve_device(device)
    caches = []
    for spec in layer_specs(cfg):
        c: Params = {}
        if spec.mixer == "attn":
            c["kv"] = _kv_pair((batch, max_seq, cfg.n_kv_heads, cfg.hd), dev)
        elif spec.mixer == "mla":
            c["kv"] = mla_cache_init(mla_spec(cfg), batch, max_seq, dev)
        elif spec.mixer == "mamba":
            c["state"] = mamba_state_init(mamba_spec(cfg), batch, dev)
        elif spec.mixer == "rwkv":
            c["state"] = rwkv_state_init(rwkv_spec(cfg), batch, dev)
        if spec.cross:
            c["cross_kv"] = _kv_pair((batch, cfg.n_img_tokens or cfg.n_frames,
                                      cfg.n_kv_heads, cfg.hd), dev)
        caches.append(c)
    return caches


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_size: int,
                      device=None) -> list[Params]:
    """One ``'kv'`` {'k','v'} (N, bs, K, h) pool pair per attention
    layer, {'ckv','krope'} (N, bs, kv_lora_rank / rope_dim) per MLA
    layer; all layers share one block table per request.  Block 0 is the
    write sentinel."""
    if not paged_supported(cfg):
        raise ValueError("paged KV requires attention-only cached layers")
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    caches = []
    for spec in layer_specs(cfg):
        if spec.mixer == "attn":
            caches.append({"kv": _kv_pair(shape, dev)})
        elif spec.mixer == "mla":
            caches.append({"kv": mla_cache_init(mla_spec(cfg), num_blocks,
                                                block_size, dev)})
        else:
            caches.append({})
    return caches


# ---------------- apply ----------------

def _fresh_state(cfg: ModelConfig, mixer: str, x) -> Params:
    """A recurrent layer's zero state for x's batch (a pass without a
    cache starts every sequence from it)."""
    if mixer == "mamba":
        return mamba_state_init(mamba_spec(cfg), x.shape[0], x.device)
    return rwkv_state_init(rwkv_spec(cfg), x.shape[0], x.device)


def _store(state: Params, new: Params) -> None:
    """Write a sublayer's new state into the cache's state dict, in place
    (the serve engine's slot rows and admission copies hold on to these
    tensors)."""
    for key, t in new.items():
        state[key].copy_(t)


def block_apply(p: Params, cfg: ModelConfig, spec: LayerSpec, x, cache, *,
                positions, pos, paged, cross_src=None):
    """One block of ``spec`` (the reference's control flow) -> (x, cache,
    aux), aux the MoE's load-balance loss (0.0 for an MLP block).  With a
    fused norm provider (``norm_impl`` resolved for x's device) the seams
    run fused: norm1 into the QKV projection (prologue; an MLA mixer
    takes the plain norm1, as the reference's does); the attention
    residual add + norm2 as one epilogue when no cross sublayer follows;
    otherwise ('none' mixer, or a cross sublayer that touched x) norm2
    into the gate / up products (the norm -> gated-GLU seam, inside
    ``mlp``).  The FFN's own seam is the fused GLU (``ffn_impl``).  A MoE
    FFN takes the epilogue's normed rows, and runs dropless exactly when
    the block runs with a cache (the reference's ``dropless=ctx.cached``).

    The cross sublayer: dense norm, K/V from ``cross_src`` (written into
    the layer's cross cache when there is one) or from that cache, then
    x + tanh(cross_gate) * cross_apply(...).

    A mamba or rwkv mixer takes the plain norm1, starts from the cache's
    ``'state'`` (zeros without a cache) and writes its new state back into
    that dict in place; the residual add + norm2 epilogue follows it as
    after attention.  The rwkv channel mix ('rwkv_cm') reads and writes
    ``cm_x`` of the same dict."""
    nprov = dispatch.get_norm(dispatch.resolve_norm(cfg.norm_impl, x.device))
    _, norm = make_norm(cfg.norm)
    h_ffn = None
    o = None
    if spec.mixer in RECURRENT:
        st = (_fresh_state(cfg, spec.mixer, x) if cache is None
              else cache["state"])
        h = norm(p["norm1"], x, cfg.norm_eps)
        if spec.mixer == "mamba":
            o, new = mamba_apply(p["mixer"], mamba_spec(cfg), h, state=st)
        else:
            o, new = rwkv_time_mix(p["mixer"], rwkv_spec(cfg), h, state=st)
        if cache is not None:
            _store(st, new)
    elif spec.mixer in ("attn", "mla"):
        kv = None if cache is None else cache["kv"]
        if spec.mixer == "mla":
            o, _ = mla_apply(p["mixer"], mla_spec(cfg),
                             norm(p["norm1"], x, cfg.norm_eps),
                             positions=positions, cache=kv, pos=pos,
                             paged=paged)
        elif nprov is not None:
            o, _ = gqa_apply(p["mixer"], attn_spec(cfg), x,
                             positions=positions, cache=kv, pos=pos,
                             paged=paged, prenorm=(p["norm1"], cfg.norm,
                                                   cfg.norm_eps, nprov))
        else:
            o, _ = gqa_apply(p["mixer"], attn_spec(cfg),
                             norm(p["norm1"], x, cfg.norm_eps),
                             positions=positions, cache=kv, pos=pos,
                             paged=paged)
    if o is not None:
        if nprov is not None and not spec.cross:
            x, h_ffn = nprov["residual_norm"](
                x, o, p["norm2"]["g"], p["norm2"].get("b"), kind=cfg.norm,
                eps=cfg.norm_eps)
        else:
            x = x + o
    if spec.cross:
        cs = attn_spec(cfg, causal=False)
        h = norm(p["cross_norm"], x, cfg.norm_eps)
        if cross_src is not None:
            ckv = cross_kv(p["cross"], cs, cross_src)
            if cache is not None:
                for key in ("k", "v"):
                    cache["cross_kv"][key].copy_(ckv[key])
        elif cache is not None:
            ckv = cache["cross_kv"]
        else:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             "cross_src or the caches")
        x = x + torch.tanh(p["cross_gate"]) * cross_apply(p["cross"], cs, h,
                                                          ckv)
    if spec.ffn == "moe":
        h = h_ffn if h_ffn is not None else norm(p["norm2"], x, cfg.norm_eps)
        o, aux = moe_apply(p["ffn"], moe_spec(cfg), h,
                           dropless=cache is not None)
        return x + o, cache, aux
    if spec.ffn == "rwkv_cm":
        h = h_ffn if h_ffn is not None else norm(p["norm2"], x, cfg.norm_eps)
        st = (_fresh_state(cfg, "rwkv", x) if cache is None
              else cache["state"])
        o, new = rwkv_channel_mix(p["ffn"], rwkv_spec(cfg), h, state=st)
        if cache is not None:
            _store(st, new)
        return x + o, cache, 0.0
    if h_ffn is None and nprov is not None:
        return x + mlp(p["ffn"], x, cfg.activation, impl=cfg.ffn_impl,
                       prenorm=(p["norm2"], cfg.norm, cfg.norm_eps),
                       norm_impl=cfg.norm_impl), cache, 0.0
    h = h_ffn if h_ffn is not None else norm(p["norm2"], x, cfg.norm_eps)
    return (x + mlp(p["ffn"], h, cfg.activation, impl=cfg.ffn_impl), cache,
            0.0)


def lm_apply(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
             pos=0, caches: list | None = None, cross_src=None,
             last_pos=None, paged=None, remat: bool = False,
             return_hidden: bool = False, return_aux: bool = False,
             device=None):
    """tokens (B,S) -> (logits, caches), or (logits, caches, aux) with
    ``return_aux``: aux the sum over the layers of the MoE load-balance
    loss (a 0-d tensor, zero without MoE layers), as the reference's
    ``aux_total``.

    caches=None : full forward, no state.
    caches      : :func:`init_caches` rows: prefill (pos=0, S=bucket) or
                  decode (S=1) at offset ``pos`` (scalar, or (B,) for
                  continuous batching); the rows are updated in place
                  and returned.
    cross_src   : (B, n_img_tokens, d) image embeddings, or the
                  encoder's output (:func:`encoder_apply`), for the cross
                  layers; with caches, their K/V are written into the
                  cross caches (prefill).  None reads the cross caches
                  (decode, or a request without one: zeros).
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
    if cross_src is not None:
        check_on(dev, cross_src=cross_src)
    if paged is not None and caches is None:
        raise ValueError("paged block tables need the paged caches")
    b, sl = tokens.shape
    x = params["embed"][tokens]
    positions = _positions_from(pos, b, sl, dev)
    if cfg.pos_emb == "learned":
        rows = params["pos"].shape[0]
        x = x + params["pos"][torch.clamp(positions, 0, rows - 1)]
    elif cfg.pos_emb == "sinusoid":
        x = x + sinusoidal_pos_emb(sl, cfg.d_model, dev, x.dtype)[None]
    if remat and caches is not None:
        raise ValueError("remat is for train mode (caches=None)")
    aux_total = 0.0
    for i, (lp, spec) in enumerate(zip(params["layers"], layer_specs(cfg))):
        if remat:
            x, aux = checkpoint(_train_block, lp, cfg, spec, x, positions,
                                cross_src, use_reentrant=False)
        else:
            x, _, aux = block_apply(lp, cfg, spec, x,
                                    None if caches is None else caches[i],
                                    positions=positions, pos=pos,
                                    paged=paged, cross_src=cross_src)
        aux_total = aux_total + aux
    if last_pos is not None:
        idx = last_pos.to(dev).long()[:, None, None].expand(b, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    x = make_norm(cfg.norm)[1](params["final_norm"], x, cfg.norm_eps)
    out = x if return_hidden else x @ lm_head_weight(params, cfg)
    if not return_aux:
        return out, caches
    if not torch.is_tensor(aux_total):
        aux_total = torch.zeros((), device=dev)
    return out, caches, aux_total


def encoder_apply(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                  device=None) -> torch.Tensor:
    """The encoder stack over frame embeddings (B, T, d): sinusoid
    positions added, ``enc_layers`` non-causal attn + mlp blocks of
    ``cfg``'s widths, norms and impls, then the encoder's final norm ->
    (B, T, d), the decoder's ``cross_src``.  ``device`` as in
    :func:`lm_apply`."""
    check_supported(cfg)
    dev = resolve_device(device)
    check_on(dev, frames=frames, embed=params["embed"])
    b, t, d = frames.shape
    x = frames + sinusoidal_pos_emb(t, d, dev, frames.dtype)
    ecfg = _enc_cfg(cfg)
    positions = _positions_from(0, b, t, dev)
    for bp in params["encoder"]["blocks"]:
        x, _, _ = block_apply(bp, ecfg, ENC_SPEC, x, None,
                              positions=positions, pos=0, paged=None)
    return make_norm(cfg.norm)[1](params["encoder"]["norm"], x, cfg.norm_eps)


def _train_block(lp: Params, cfg: ModelConfig, spec: LayerSpec, x,
                 positions, cross_src):
    x, _, aux = block_apply(lp, cfg, spec, x, None, positions=positions,
                            pos=0, paged=None, cross_src=cross_src)
    return x, aux


def lm_head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """(d, vocab) head matrix (the transposed embedding when tied)."""
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])
