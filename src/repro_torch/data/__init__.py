"""Deterministic synthetic training data: the counterpart of
``repro.data``."""
from repro_torch.data.pipeline import SyntheticLM, make_batch_fn  # noqa: F401
