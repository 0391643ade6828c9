"""Spot-instance preemption simulation and an auto-restarting train loop:
the counterpart of ``repro/ft/preemption.py``.

The paper's clusters run on on-demand EC2; its future-work section
proposes spot instances with checkpoint-based fault tolerance.  This
module is that loop: a training driver that (a) checkpoints every N steps,
(b) can be killed at an arbitrary step by a PreemptionSchedule (tests) or
a real signal (SIGTERM — the cloud's 2-minute warning), and (c) resumes
bit-exactly from the latest checkpoint, because the data pipeline is keyed
by step and the train step is deterministic (on the card too: the flash
attention kernels use no atomics).
"""
from __future__ import annotations

import signal
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager


class SimulatedPreemption(Exception):
    pass


@dataclass
class PreemptionSchedule:
    """Kill the run when the step counter hits one of these steps."""
    kill_at_steps: List[int] = field(default_factory=list)
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.kill_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedPreemption(f"preempted at step {step}")


def _host_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """0-d tensors to Python numbers (waits for the device)."""
    return {k: v.item() if isinstance(v, torch.Tensor) and v.dim() == 0
            else v for k, v in metrics.items()}


class PreemptibleTrainer:
    """Runs ``state, metrics = train_step(state, batch)`` with checkpoint /
    restart.  ``batch_fn(step)`` must be deterministic in step (the data
    pipeline is) so a resumed run replays the exact batch sequence.  The
    step must not modify the state it is given (``train.steps``' does
    not): every attempt starts from the same ``init_state``."""

    def __init__(self, train_step: Callable, batch_fn: Callable[[int], Any],
                 ckpt: CheckpointManager, *, checkpoint_every: int = 10,
                 async_checkpoint: bool = True):
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.async_checkpoint = async_checkpoint
        self._sigterm = threading.Event()

    def install_sigterm_handler(self) -> None:
        signal.signal(signal.SIGTERM,
                      lambda *_: self._sigterm.set())

    def run(self, init_state: Any, total_steps: int, *,
            schedule: Optional[PreemptionSchedule] = None
            ) -> Dict[str, Any]:
        """One *attempt*: restores from the latest checkpoint if present,
        trains until total_steps or preemption.  Returns a report."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest)
            start = latest
            resumed = True
        else:
            state = init_state
            start = 0
            resumed = False

        metrics_hist = []
        step = start
        try:
            for step in range(start, total_steps):
                if schedule is not None:
                    schedule.check(step)
                if self._sigterm.is_set():
                    raise SimulatedPreemption(f"SIGTERM at step {step}")
                batch = self.batch_fn(step)
                state, metrics = self.train_step(state, batch)
                metrics_hist.append(_host_metrics(metrics))
                if (step + 1) % self.checkpoint_every == 0:
                    self.ckpt.save(step + 1, state,
                                   blocking=not self.async_checkpoint)
            self.ckpt.save(total_steps, state, blocking=True)
            return {"state": state, "completed": True, "resumed_from":
                    start if resumed else None, "metrics": metrics_hist,
                    "last_step": total_steps}
        except SimulatedPreemption as e:
            self.ckpt.wait()
            return {"state": None, "completed": False,
                    "resumed_from": start if resumed else None,
                    "metrics": metrics_hist, "last_step": step,
                    "preemption": str(e)}

    def run_with_restarts(self, init_state: Any, total_steps: int, *,
                          schedule: Optional[PreemptionSchedule] = None,
                          max_restarts: int = 10) -> Dict[str, Any]:
        """The production loop: restart after every preemption."""
        attempts = []
        for _ in range(max_restarts + 1):
            rep = self.run(init_state, total_steps, schedule=schedule)
            attempts.append({k: rep[k] for k in
                             ("completed", "resumed_from", "last_step")})
            if rep["completed"]:
                rep["attempts"] = attempts
                return rep
        raise RuntimeError(f"exceeded {max_restarts} restarts")
