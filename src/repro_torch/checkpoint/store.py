"""Checkpoint store: npz plus a JSON manifest, async save, atomic
publish (port of ``repro.checkpoint.store``).

Layout:
    <dir>/step_<N>/manifest.json       keys, shapes, dtypes, metadata
    <dir>/step_<N>/shard.npz           the leaves (path -> array)
    <dir>/step_<N>.tmp/...             in flight (renamed on completion)

* atomic   -- a save fills ``step_N.tmp/`` and ``os.replace``s it to
              ``step_N/`` last, so a crashed save is never taken for a
              complete checkpoint.
* async    -- ``save(..., block=False)`` copies the leaves to host memory
              at once and writes them on a thread; ``wait()`` joins it,
              and every save waits for the one before (one writer).
* versioned -- ``latest_step`` picks the newest complete step; ``keep``
              bounds how many stay.

The state is the port's nested dicts, lists and NamedTuples of tensors
and Python numbers (``repro_torch.tree``), flattened by path.  Leaves
are stored whole: no mesh exists yet to shard them over.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_paths, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                   else np.asarray(leaf))
            for path, leaf in tree_paths(tree)}


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


class CheckpointStore:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------

    def save(self, step: int, tree: Any, *, block: bool = True,
             extra: dict | None = None) -> None:
        """Checkpoint ``tree`` at ``step``.  The leaves are copied to host
        memory now; the write runs on a thread when ``block`` is False."""
        self.wait()
        flat = _flatten(tree)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "extra": extra or {},
        }

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if block:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for d in os.listdir(self.dir)
                       if (m := _STEP_RE.match(d)))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------- restore ----------------

    def restore(self, like: Any, *, step: int | None = None
                ) -> tuple[Any, int, dict]:
        """Restore into the structure of ``like``: each tensor leaf takes
        the dtype and device of ``like``'s, each number leaf its type.
        Returns (tree, step, extra)."""
        step = latest_step(self.dir) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "shard.npz")) as z:
            data = {k: z[k] for k in z.files}
        paths = tree_paths(like)
        missing = [k for k, _ in paths if k not in data]
        if missing:
            raise KeyError(f"checkpoint at step {step} misses {missing[:5]}")

        def leaf(key, ref):
            if torch.is_tensor(ref):
                return torch.from_numpy(np.array(data[key])).to(
                    device=ref.device, dtype=ref.dtype)
            return type(ref)(data[key].item())

        tree = tree_unflatten(like, [leaf(k, ref) for k, ref in paths])
        return tree, step, manifest.get("extra", {})
