"""Deterministic, sharded, resumable synthetic-token stream (port of
``repro.data.pipeline``).

Tokens follow a fixed random bigram LM (Zipf-ish marginals), so a
cross-entropy run has a real floor.  The bigram table is the
reference's, built with numpy from the same seed.  Sampling draws from
an explicit ``torch.Generator`` keyed by (seed, step, host), so
``batch(step)`` is a pure function of them and a resumed run replays
the same stream -- but its tokens are not the JAX package's (JAX's
counter-based keys have no PyTorch counterpart); tests that compare the
two packages feed both the same numpy batch.

The table is (vocab, vocab) float32 and is built eagerly: at a full
150k vocabulary that is ~92 GB.  Draw batches from a smaller vocabulary
for a full-vocabulary model (token ids stay below it).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch


def host_slice(global_batch: int, n_hosts: int, host_id: int) -> slice:
    """Contiguous rows of the global batch owned by this host."""
    per = global_batch // n_hosts
    rem = global_batch % n_hosts
    lo = host_id * per + min(host_id, rem)
    return slice(lo, lo + per + (1 if host_id < rem else 0))


def _seed_of(*parts: int) -> int:
    """A 63-bit generator seed from the key parts."""
    digest = hashlib.sha256("/".join(map(str, parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2           # marginal skew
    n_hosts: int = 1
    host_id: int = 0

    def _table(self) -> np.ndarray:
        """Fixed bigram transition logits (vocab, vocab), seed-deterministic
        (the reference's construction)."""
        rng = np.random.default_rng(self.seed)
        # sparse-ish transitions: each token prefers ~8 successors
        logits = rng.gumbel(size=(self.vocab, self.vocab)).astype(np.float32)
        top = np.partition(logits, -8, axis=-1)[:, -8:-7]
        logits = np.where(logits >= top, logits * 3.0, logits - 4.0)
        # Zipf marginal bias on successors
        bias = -self.zipf_a * np.log1p(np.arange(self.vocab, dtype=np.float32))
        return logits + bias[None, :]

    def __post_init__(self):
        object.__setattr__(self, "_tbl", torch.from_numpy(self._table()))

    @property
    def local_batch(self) -> int:
        sl = host_slice(self.global_batch, self.n_hosts, self.host_id)
        return sl.stop - sl.start

    def batch(self, step: int):
        """(tokens, labels), both (local_batch, seq_len) int64 on the CPU,
        labels the next tokens.  Pure in (seed, step, host_id)."""
        gen = torch.Generator().manual_seed(
            _seed_of(self.seed, step, self.host_id))
        b = self.local_batch
        tok = torch.randint(self.vocab, (b,), generator=gen)
        seq = [tok]
        for _ in range(self.seq_len):
            # categorical draw by the Gumbel-max rule
            u = torch.rand((b, self.vocab), generator=gen)
            tok = torch.argmax(self._tbl[tok] - torch.log(-torch.log(u)),
                               dim=-1)
            seq.append(tok)
        full = torch.stack(seq, dim=1)                   # (B, S + 1)
        return full[:, :-1].contiguous(), full[:, 1:].contiguous()
