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
    """Uniform-random int32 tokens and labels matching an architecture's
    inputs, deterministic in (seed, step): (global_batch, seq_len) of
    text, less the image prefix where the config has one, and then
    standard normal ``image_embeds`` (B, n_image_tokens, d) and ``frames``
    (B, encoder_seq, d) in the compute dtype where it takes them."""
    B, S = shape.global_batch, shape.seq_len
    s_text = S - (cfg.n_image_tokens or 0)
    dt = getattr(torch, cfg.dtype)

    def batch_fn(step: int) -> Dict[str, torch.Tensor]:
        gen = _generator(seed, step)
        out = {"tokens": torch.randint(0, cfg.vocab, (B, s_text),
                                       generator=gen, dtype=torch.int32),
               "labels": torch.randint(0, cfg.vocab, (B, s_text),
                                       generator=gen, dtype=torch.int32)}
        if cfg.n_image_tokens:
            out["image_embeds"] = torch.randn(
                (B, cfg.n_image_tokens, cfg.d_model), generator=gen).to(dt)
        if cfg.n_encoder_layers:
            out["frames"] = torch.randn(
                (B, cfg.encoder_seq, cfg.d_model), generator=gen).to(dt)
        return out

    return batch_fn
