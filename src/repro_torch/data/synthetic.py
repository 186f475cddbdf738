"""Deterministic synthetic LM data: the JAX package's pipeline, bit for bit.

A learnable next-token task: tokens follow a sparse random Markov chain
over the vocabulary, generated counter-based from (seed, step), so any
step's batch can be recomputed exactly (checkpoint-resume needs no data
state).  The transition table comes from numpy, the start tokens from
JAX's ``randint`` and the branches from JAX's ``categorical``, both drawn
by ``core.prng``: a batch equals the JAX package's for the same config and
step.  Batches are built on the host (CPU tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4      # successors per token in the Markov chain


def _transition_table(cfg: DataConfig) -> np.ndarray:
    """(vocab, branching) successor table: the task's hidden structure."""
    rng = np.random.default_rng(cfg.seed + 7)
    return rng.integers(0, cfg.vocab_size,
                        size=(cfg.vocab_size, cfg.branching), dtype=np.int32)


def batch_at_step(cfg: DataConfig, step: int,
                  table: Optional[np.ndarray] = None) -> dict:
    """{"tokens": (B, S + 1) int32} for step ``step``: inputs
    tokens[:, :-1], labels tokens[:, 1:].  Branch i is taken with
    probability ~ 2^-i, so a perfect model (always branch 0) scores about
    53 % at branching 4."""
    if table is None:
        table = _transition_table(cfg)
    key = prng.fold_in(prng.PRNGKey(cfg.seed), step)
    k0, kb = prng.split(key)
    b, s = cfg.global_batch, cfg.seq_len
    start = prng.randint(k0, (b,), 0, cfg.vocab_size).numpy()
    logits = (-torch.arange(cfg.branching, dtype=torch.float32)
              * torch.log(torch.tensor(2.0)))
    branch = prng.categorical(kb, logits, shape=(b, s)).numpy()
    tokens = np.empty((b, s + 1), dtype=np.int32)
    tokens[:, 0] = start
    for t in range(s):
        tokens[:, t + 1] = table[tokens[:, t], branch[:, t]]
    return {"tokens": torch.from_numpy(tokens)}


class SyntheticDataset:
    """Iterator facade with explicit step state (resumable)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self._table = _transition_table(cfg)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = batch_at_step(self.cfg, self.step, self._table)
        self.step += 1
        return batch
