"""Loss and train step (port of ``repro.train.step``): the chunked
cross-entropy plus the MoE load-balance aux loss (weight 0.01), block
remat, microbatch accumulation, int8 gradient compression and AdamW
under the warmup-cosine schedule.

The step is (TrainState, batch) -> (TrainState, metrics) and returns a
new state, as the reference's pure step does.  Distribution (the
reference's shardings, FSDP, sequence parallelism) waits for the port's
Distributed slice: there is no mesh argument.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (init_lm, lm_apply, lm_head_weight,
                                            recurrent_mixers)
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               compress_decompress, ef_state_init,
                               wsd_schedule)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: OptState
    ef: Params          # grad-compression residuals ({} when disabled)


def check_train_config(tcfg: TrainConfig) -> None:
    """Raise NotImplementedError for what needs a mesh (the Distributed
    queue) or a remat mode the port does not have."""
    why = []
    if tcfg.fsdp:
        why.append("fsdp")
    if tcfg.inner_pins:
        why.append("inner_pins (sequence-parallel pins)")
    if tcfg.profile not in ("auto", "dp"):
        why.append(f"profile={tcfg.profile!r}")
    if tcfg.remat_mode != "period":
        why.append(f"remat_mode={tcfg.remat_mode!r}")
    if why:
        raise NotImplementedError(
            f"not ported yet (needs the Distributed slice): {', '.join(why)}")


def check_train_arch(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for the archs the port cannot train yet
    (a later training slice of the port brings them): the vlm family (its
    step feeds image embeddings to the cross layers, as the reference's
    does), the encdec family (its batch carries the reference's
    ``frames`` for the encoder), MLA mixers (the flash backward, rows
    10 / 11, is unchecked on the card at minicpm3's h 96 / hv 64 and
    takes no h past 128, deepseek's 192; deepseek's unstacked prefix
    layer also needs the reference's decay mask) and mamba / rwkv mixers
    (their scans have no backward kernels yet, nor the reference's
    chunk-boundary checkpointing)."""
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: training the vlm family (image embeddings into "
            "the cross-attention layers) is not ported yet; a later "
            "training slice of the port brings it")
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: training the encdec family (a batch with the "
            "encoder's frames) is not ported yet; a later training slice "
            "of the port brings it")
    recurrent = recurrent_mixers(cfg)
    if recurrent:
        raise NotImplementedError(
            f"{cfg.name}: training {' / '.join(recurrent)} layers is not "
            "ported yet: it needs the scans' backward kernels and the "
            "chunk-boundary checkpointing of the reference's "
            "chunked_time_scan, which a later training slice of the port "
            "brings")
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: training MLA layers (the flash backward at h "
            f"{cfg.mla.nope_dim + cfg.mla.rope_dim} / hv {cfg.mla.v_dim}, "
            "unchecked on the card or past its h 128"
            + (", and the prefix layers' weight decay" if cfg.prefix else "")
            + ") is not ported yet; a later training slice of the port "
            "brings it")


def _chunk_ce(h, head_w, labels):
    logits = (h @ head_w).to(torch.float32)                 # (bc, S, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_ce(h, head_w, labels, *, target_chunks: int = 8):
    """Mean next-token CE without the (B, S, vocab) logits: a loop over
    batch chunks, each checkpointed, so one chunk's logits are live at a
    time (recomputed in backward)."""
    b, s, _ = h.shape
    nc = min(target_chunks, b)
    while b % nc:
        nc -= 1
    bc = b // nc
    tot = None
    for i in range(nc):
        rows = slice(i * bc, (i + 1) * bc)
        part = checkpoint(_chunk_ce, h[rows], head_w, labels[rows],
                          use_reentrant=False)
        tot = part if tot is None else tot + part
    return tot / (b * s)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig, device=None,
                 aux_weight: float = 0.01):
    """loss_fn(params, batch) -> (ce + aux_weight * aux, (ce, aux)): the
    mean CE and the MoE load-balance loss summed over the layers (zero
    without MoE layers), from ``lm_apply(..., remat=tcfg.remat,
    return_hidden=True, return_aux=True)``."""
    check_train_arch(cfg)
    dev = resolve_device(device)

    def loss_fn(params, batch):
        h, _, aux = lm_apply(params, cfg, batch["tokens"], remat=tcfg.remat,
                             return_hidden=True, return_aux=True,
                             device=dev)
        ce = chunked_ce(h, lm_head_weight(params, cfg), batch["labels"])
        return ce + aux_weight * aux, (ce, aux)
    return loss_fn


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig, device=None,
                 aux_weight: float = 0.01):
    """grad_fn(params, batch) -> ((loss, (ce, aux)), grads): the value and
    gradient of the loss (``jax.value_and_grad(..., has_aux=True)``),
    grads shaped as params."""
    loss_fn = make_loss_fn(cfg, tcfg, device, aux_weight)

    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, (ce, aux) = loss_fn(live, batch)
            # the unit's quantized scores cut wq / wk (and their biases)
            # out of a dual-mode graph: their gradient is zero, as
            # jax.value_and_grad gives it
            grads = torch.autograd.grad(loss, tree_leaves(live),
                                        allow_unused=True,
                                        materialize_grads=True)
        return ((loss.detach(), (ce.detach(), aux.detach())),
                tree_unflatten(params, grads))
    return grad_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device=None):
    check_train_config(tcfg)
    grad_fn = make_grad_fn(cfg, tcfg, device)

    def train_step(state: TrainState, batch):
        lr = wsd_schedule(state.opt.step, lr=tcfg.lr,
                          warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        if tcfg.microbatch:
            b = batch["tokens"].shape[0]
            n_acc = b // tcfg.microbatch
            grads = ce = aux = None
            for i in range(n_acc):
                rows = slice(i * tcfg.microbatch, (i + 1) * tcfg.microbatch)
                (_, (ce_i, aux_i)), g_i = grad_fn(
                    state.params, {k: v[rows] for k, v in batch.items()})
                grads = g_i if grads is None else tree_map(
                    torch.add, grads, g_i)
                ce = ce_i if ce is None else ce + ce_i
                aux = aux_i if aux is None else aux + aux_i
            grads = tree_map(lambda g: g / n_acc, grads)
            ce, aux = ce / n_acc, aux / n_acc
        else:
            (_, (ce, aux)), grads = grad_fn(state.params, batch)

        ef = state.ef
        if tcfg.grad_compress:
            grads, ef = compress_decompress(grads, ef)

        params, opt, om = adamw_update(
            grads, state.opt, state.params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        metrics = {"loss": ce + 0.01 * aux, "ce": ce, "aux": aux,
                   "grad_norm": om["grad_norm"], "lr": lr}
        return TrainState(params, opt, ef), metrics

    return train_step


def make_train_state(cfg: ModelConfig, tcfg: TrainConfig, device=None,
                     seed: int | None = None) -> TrainState:
    """Fresh weights from a generator seeded with ``seed`` (default
    ``tcfg.seed``) on ``device``, zero moments and residuals."""
    dev = resolve_device(device)
    seed = tcfg.seed if seed is None else seed
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    ef = ef_state_init(params) if tcfg.grad_compress else {}
    return TrainState(params, adamw_init(params), ef)
