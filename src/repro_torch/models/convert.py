"""Weights of the reference, in the port's layout.

``params_from_numpy`` takes the pytree of ``repro.models.transformer.
init_lm`` with every leaf converted to a numpy array (so that this
module needs no JAX) and returns the port's parameter dict: the
reference stacks the blocks of each period on a leading axis, the port
keeps one dict per layer in a list.  Every leaf is taken per period, so
a cross layer's gate, stacked by the reference as (n_periods,), becomes
the 0-d ``cross_gate`` of each of its layers, and a recurrent layer's
leaves (the rwkv time mix's ``mu`` (5, d), ``dd_w2`` (5, r, d), ``u`` (H,
hd); mamba's ``A_log`` (d_inner, d_state), ``conv_w`` (d_conv, d_inner),
``dt_proj``'s pair) lose only their period axis.  The ``prefix`` blocks
(deepseek-v2-lite's dense first layer), kept unstacked by the reference,
come first in ``layers``, their leaves as they are.  An encoder's blocks,
stacked by the reference on a leading ``enc_layers`` axis, become a list
too, beside the encoder's final norm.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from .transformer import check_supported


def _to_torch(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree if index is None else tree[index])
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's ``init_lm`` pytree (numpy leaves) -> port params."""
    check_supported(cfg)
    dev = resolve_device(device)
    periods = tree["periods"]
    layers = [_to_torch(blk, dev) for blk in tree.get("prefix", [])]
    layers += [_to_torch(periods[j], dev, index=i)
               for i in range(cfg.n_periods) for j in range(len(periods))]
    params = {"embed": _to_torch(tree["embed"], dev),
              "final_norm": _to_torch(tree["final_norm"], dev),
              "layers": layers}
    for key in ("lm_head", "pos"):
        if key in tree:
            params[key] = _to_torch(tree[key], dev)
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "blocks": [_to_torch(enc["blocks"], dev, index=i)
                       for i in range(cfg.enc_layers)],
            "norm": _to_torch(enc["norm"], dev)}
    return params
