"""Deterministic synthetic LM token pipeline — the port of
``repro.data.tokens``, copied (numpy and a thread).

Production shape: the global batch is sharded across hosts (each host
generates only its slice), batches are derived PURELY from (seed, step) so
the pipeline is stateless/resumable — restart at step k reproduces the
exact stream, which the fault-tolerance tests rely on.  A small background
prefetcher overlaps host-side generation with device compute.

The synthetic distribution is a order-2 Markov chain over the vocab with a
power-law unigram prior — enough structure for a 100M model's loss to drop
visibly in a few hundred steps (examples/lm_pretrain.py).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _batch_rng(cfg: TokenDataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    )


def synth_batch(cfg: TokenDataConfig, step: int) -> dict[str, np.ndarray]:
    """Host-local slice of the global batch for ``step``."""
    assert cfg.global_batch % cfg.n_hosts == 0
    local = cfg.global_batch // cfg.n_hosts
    rng = _batch_rng(cfg, step)
    v = cfg.vocab_size
    # power-law unigram prior ...
    base = (rng.zipf(1.3, size=(local, cfg.seq_len + 1)) - 1).astype(np.int64) % v
    # ... + copy-run bigram structure: with prob p_copy a token repeats its
    # predecessor.  Both signals are learnable within tens of steps (the
    # unigram skew almost immediately), so smoke runs show a clear loss
    # drop from ln(V), while the residual stream stays non-trivial.
    keep = rng.random((local, cfg.seq_len + 1)) > 0.5
    keep[:, 0] = True
    pos = np.where(keep, np.arange(cfg.seq_len + 1)[None, :], 0)
    src = np.maximum.accumulate(pos, axis=1)
    mixed = np.take_along_axis(base, src, axis=1)
    return {
        "tokens": mixed[:, :-1].astype(np.int32),
        "labels": mixed[:, 1:].astype(np.int32),
    }


class Prefetcher:
    """Background thread generating batches a few steps ahead."""

    def __init__(self, cfg: TokenDataConfig, start_step: int, depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._next
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
