"""Trainer: the fault-tolerant training driver (port of
``repro.train.trainer``).

* checkpoint / restart -- async saves every ``checkpoint_every`` steps;
  on construction the trainer resumes from the newest complete
  checkpoint in ``tcfg.checkpoint_dir``, and the data stream replays
  from the restored step (``batch(step)`` is pure).
* straggler monitor -- each step's wall time against an EMA watermark;
  steps slower than ``STRAGGLER_FACTOR`` x are counted and logged.

The reference's elastic remesh (``from_checkpoint`` onto a new mesh)
and every sharded layout wait for the port's Distributed slice; asking
for them raises NotImplementedError.
"""
from __future__ import annotations

import time
from typing import Any, Callable

from repro_torch.checkpoint import CheckpointStore, latest_step
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device

from .step import make_train_state, make_train_step

STRAGGLER_FACTOR = 1.5


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 global_batch: int, seq_len: int, *, device=None,
                 data: SyntheticLM | None = None,
                 log: Callable[[str], None] = print, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh needs the port's Distributed slice")
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.global_batch, self.seq_len = global_batch, seq_len
        self.data = data or SyntheticLM(vocab=cfg.vocab, seq_len=seq_len,
                                        global_batch=global_batch,
                                        seed=tcfg.seed)
        self.log = log
        self.step_fn = make_train_step(cfg, tcfg, self.device)
        self.store = CheckpointStore(tcfg.checkpoint_dir)
        self.state = make_train_state(cfg, tcfg, self.device)
        self.start_step = 0
        if latest_step(tcfg.checkpoint_dir) is not None:
            self.state, self.start_step, _ = self.store.restore(self.state)
            self.log(f"[trainer] resumed from step {self.start_step}")
        # telemetry
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []
        self._ema: float | None = None

    @classmethod
    def from_checkpoint(cls, *args, mesh=None, **kw) -> "Trainer":
        """Elastic restart onto a new mesh: not ported yet."""
        raise NotImplementedError(
            "elastic remesh needs the port's Distributed slice; construct "
            "a Trainer on the same checkpoint_dir to resume on one device")

    def save(self, step: int, block: bool = True) -> None:
        self.store.save(step, self.state, block=block,
                        extra={"arch": self.cfg.name})

    # ---------------- main loop ----------------

    def run(self, n_steps: int | None = None) -> dict[str, Any]:
        end = self.tcfg.total_steps if n_steps is None \
            else self.start_step + n_steps
        metrics: dict[str, Any] = {}
        for step in range(self.start_step, end):
            tokens, labels = self.data.batch(step)
            batch = {"tokens": tokens.to(self.device),
                     "labels": labels.to(self.device)}
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            dt = time.perf_counter() - t0
            self._watch_straggler(step, dt)
            if (step + 1) % self.tcfg.checkpoint_every == 0:
                self.save(step + 1, block=False)
            if step % 10 == 0 or step == end - 1:
                self.log(f"[trainer] step {step} loss={metrics['loss']:.4f} "
                         f"gnorm={metrics['grad_norm']:.2f} {dt*1e3:.0f}ms")
        self.store.wait()
        self.start_step = end
        return metrics

    def _watch_straggler(self, step: int, dt: float) -> None:
        self.step_times.append(dt)
        if self._ema is None:
            self._ema = dt
            return
        if dt > STRAGGLER_FACTOR * self._ema and len(self.step_times) > 3:
            self.straggler_steps.append(step)
            self.log(f"[trainer] STRAGGLER step {step}: {dt*1e3:.0f}ms vs "
                     f"EMA {self._ema*1e3:.0f}ms")
        self._ema = 0.9 * self._ema + 0.1 * dt
