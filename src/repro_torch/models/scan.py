"""Sequential scans of the recurrent mixers (counterpart of
``repro.models.scan_utils``).

:func:`time_scan` is ``jax.lax.scan`` over the leading (time) axis, and
:func:`chunked_time_scan` the reference's ``chunked_time_scan``: the same
loop with chunk-boundary checkpointing.  The plain versions of the
recurrences (``kernels/recurrence.py``) run the chunked one; on the card
each recurrence runs as one kernel launch a layer call instead, the state
held on chip, and its backward kernel keeps the same chunk boundaries.

A plain scan saves its carry at every step for the backward pass: for
jamba's (B, d_inner, d_state) f32 state at 4096 tokens that is S x 134 MB
a layer.  The chunked scan runs an outer loop over S / chunk chunks, each
inner scan under ``torch.utils.checkpoint`` (non-reentrant): the saved
residuals drop to the chunk-boundary states, and the inner steps are
recomputed in the backward.  Values and gradients are those of
:func:`time_scan` bit for bit: the inner steps run the same operations in
the same order, and non-reentrant checkpointing keeps the forward's
autograd graph, recomputing only what it saved.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def time_scan(step, h0, xs):
    """``step(h, x_t) -> (h, y_t)`` over the leading axis of every tensor
    of the tuple ``xs`` (time-major, S >= 1) -> (h_final, ys), ys stacked
    time-major, as ``jax.lax.scan`` returns them."""
    h, ys = h0, []
    for t in range(xs[0].shape[0]):
        h, y = step(h, tuple(x[t] for x in xs))
        ys.append(y)
    return h, torch.stack(ys)


def chunked_time_scan(step, h0, xs, chunk: int = 64):
    """:func:`time_scan` with chunk-boundary checkpointing, the
    reference's rule: a plain scan when S <= chunk or chunk does not
    divide S; otherwise S / chunk inner scans of ``chunk`` steps, each
    checkpointed.  Returns (h_final, ys) as :func:`time_scan` does."""
    s_len = xs[0].shape[0]
    if s_len <= chunk or s_len % chunk:
        return time_scan(step, h0, xs)
    h, ys = h0, []
    for c in range(s_len // chunk):
        part = tuple(x[c * chunk:(c + 1) * chunk] for x in xs)
        h, y = checkpoint(time_scan, step, h, part, use_reentrant=False)
        ys.append(y)
    return h, torch.cat(ys)
