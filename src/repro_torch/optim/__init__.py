"""AdamW, its learning-rate schedule and gradient clipping: the counterpart
of ``repro.optim`` (``optim/compression.py`` waits for the collectives,
ROADMAP.md Queue 1 item 7)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update)
from repro_torch.optim.schedule import (clip_by_global_norm,  # noqa: F401
                                        cosine_schedule)
