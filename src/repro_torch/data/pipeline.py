"""Deterministic synthetic data pipeline: the counterpart of
``repro/data/pipeline.py``.

* ``SyntheticLM`` — tokens drawn from a fixed random bigram chain, so a
  language model can learn it (the loss drops toward the chain's
  entropy); deterministic in (seed, step), which is what makes a resumed
  run replay the batches of an uninterrupted one.
* ``make_batch_fn`` — uniform-random tokens and labels for the dense
  family, for throughput runs where learnability is irrelevant.

The bigram table is the JAX package's recipe in numpy (Gumbel logits from
``np.random.default_rng(seed)``, softmax in fp32).  The draws come from a
CPU ``torch.Generator`` seeded from (seed, step), a deliberate difference
like ``core.catopt.make_problem``'s: the two packages give different
tokens for the same seed, so parity tests hand both the same numpy
batches.  Batches are int32 on the CPU; the train step moves them to the
parameters' device.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator keyed by (seed, step) alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


class SyntheticLM:
    """Bigram-chain token source with controllable entropy."""

    def __init__(self, vocab: int, seed: int = 0, concentration: float = 8.0):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        logits = (rng.gumbel(size=(vocab, vocab)) * concentration).astype(
            np.float32)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        # keep a small support per row for low entropy
        self.table = e / e.sum(axis=-1, keepdims=True)
        self.seed = seed
        self._weights = torch.from_numpy(self.table + np.float32(1e-9))

    def batch(self, step: int, batch: int, seq: int
              ) -> Dict[str, torch.Tensor]:
        """(batch, seq) chain samples, split into tokens and next-token
        labels, each (batch, seq - 1) int32."""
        gen = _generator(self.seed, step)
        tok = torch.randint(0, self.vocab, (batch,), generator=gen)
        toks = [tok]
        for _ in range(seq - 1):
            tok = torch.multinomial(self._weights[tok], 1,
                                    generator=gen)[:, 0]
            toks.append(tok)
        seqs = torch.stack(toks, dim=1).to(torch.int32)
        return {"tokens": seqs[:, :-1].contiguous(),
                "labels": seqs[:, 1:].contiguous()}

    def entropy_floor(self) -> float:
        """Per-token conditional entropy of the chain (nats) — the loss a
        perfect model converges to."""
        p = self.table
        h_rows = -(p * np.log(p + 1e-12)).sum(-1)
        # stationary distribution via power iteration
        pi = np.ones(self.vocab) / self.vocab
        for _ in range(200):
            pi = pi @ p
        return float((pi * h_rows).sum())


def make_batch_fn(cfg, shape, seed: int = 0
                  ) -> Callable[[int], Dict[str, torch.Tensor]]:
    """Uniform-random (global_batch, seq_len) int32 tokens and labels for
    a dense config, deterministic in (seed, step)."""
    B, S = shape.global_batch, shape.seq_len

    def batch_fn(step: int) -> Dict[str, torch.Tensor]:
        gen = _generator(seed, step)
        return {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                        dtype=torch.int32),
                "labels": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                        dtype=torch.int32)}

    return batch_fn
