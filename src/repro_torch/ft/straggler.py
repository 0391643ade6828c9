"""Straggler detection + speculative re-execution policy (a copy of
``repro/ft/straggler.py``, which the port cannot import).

Used by the sweep engine: task durations are tracked with an EMA; a task
running longer than ``factor`` x EMA on its device is eligible for
speculative duplication on an idle device, first finisher wins (results are
deterministic because sweep tasks are pure functions).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class StragglerPolicy:
    factor: float = 3.0          # x EMA before a task counts as straggling
    min_samples: int = 3         # need this many completions before judging
    ema_alpha: float = 0.3

    _ema: Optional[float] = field(default=None, init=False)
    _n: int = field(default=0, init=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, init=False)

    def record(self, duration: float) -> None:
        with self._lock:
            self._n += 1
            if self._ema is None:
                self._ema = duration
            else:
                self._ema = (1 - self.ema_alpha) * self._ema \
                    + self.ema_alpha * duration

    def is_straggling(self, elapsed: float) -> bool:
        with self._lock:
            if self._ema is None or self._n < self.min_samples:
                return False
            return elapsed > self.factor * self._ema

    @property
    def ema(self) -> Optional[float]:
        return self._ema
