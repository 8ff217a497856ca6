"""Sequential scans of the recurrent mixers (counterpart of
``repro.models.scan_utils``).

:func:`time_scan` is ``jax.lax.scan`` over the leading (time) axis: the
loop that the plain versions of the recurrences run
(``kernels/recurrence.py``).  On the card each recurrence runs as one
kernel launch a layer call instead, the state held on chip.

The reference's ``chunked_time_scan`` adds chunk-boundary checkpointing
to the same loop.  It changes no value: it only saves memory for a
backward pass, so it comes with the training slice of these mixers.
"""
from __future__ import annotations

import torch


def time_scan(step, h0, xs):
    """``step(h, x_t) -> (h, y_t)`` over the leading axis of every tensor
    of the tuple ``xs`` (time-major, S >= 1) -> (h_final, ys), ys stacked
    time-major, as ``jax.lax.scan`` returns them."""
    h, ys = h0, []
    for t in range(xs[0].shape[0]):
        h, y = step(h, tuple(x[t] for x in xs))
        ys.append(y)
    return h, torch.stack(ys)
