"""Parameter-sweep engine (the paper's second workload class), in PyTorch:
the counterpart of ``repro/core/sweep.py``.

Independent parallelism: N sweep points, no data dependencies.  Two layers:

* **Vectorised path** (``sweep_vmapped``): points stacked into tensors and
  executed as one ``torch.func.vmap`` on one device — the fastest path when
  every point has identical cost (the paper's Monte-Carlo example).

* **Task-queue path** (``SweepEngine``): points grouped into tasks
  (over-decomposition), dispatched to devices by a placement policy
  (``bynode`` round-robin / ``byslot`` packed — the paper's MPI switch),
  with work stealing and straggler-speculative re-execution
  (``ft.straggler``).  This is the fault/straggler-tolerant path a
  1000-node deployment needs.

Points are a tree (dicts, lists, tuples) of arrays stacked on axis 0:
numpy arrays or tensors.  A point function takes one point's tree of
tensors and returns a tree of tensors; it draws no random numbers (give
each point its noise as part of the point: ``vmap`` does not split a
generator).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import flatten, to_numpy, tree_map, unflatten
from repro_torch.device import DeviceLike, cuda_devices, resolve_device
from repro_torch.ft.straggler import StragglerPolicy


def _on(points: Any, dev: torch.device) -> Any:
    return tree_map(lambda a: torch.as_tensor(a).to(dev), points)


# ---------------------------------------------------------------------------
# Vectorised path
# ---------------------------------------------------------------------------

def sweep_vmapped(fn: Callable[[Any], Any], points: Any, mesh=None,
                  device: DeviceLike = None) -> Any:
    """points: tree with leading axis N (stacked sweep points), moved to
    ``device`` (``cuda`` unless given).  Returns the stacked results there.

    ``mesh=`` (N sharded over a cluster's devices) raises
    ``NotImplementedError``: it needs the port's multi-GPU sharding.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sweep_vmapped(mesh=) is not ported to PyTorch yet (ROADMAP.md "
            "Queue 1 item 13); use SweepEngine over the cluster's devices")
    dev = resolve_device(device)
    return torch.func.vmap(fn)(_on(points, dev))


# ---------------------------------------------------------------------------
# Task-queue path
# ---------------------------------------------------------------------------

@dataclass
class _Task:
    idx: int
    points: Any                 # stacked chunk (tree, leading axis = chunk)
    assigned_device: int


@dataclass
class SweepReport:
    n_points: int
    n_tasks: int
    n_speculated: int
    n_stolen: int
    device_task_counts: Dict[int, int]
    wall_time: float


class SweepEngine:
    """Host-side dispatcher: one worker thread per device in ``devices``
    (every CUDA device unless given; a device may be listed more than
    once).

    placement="bynode": tasks round-robin over devices (paper default —
    balances memory).  placement="byslot": tasks packed onto the first
    devices first (paper: fill a node's cores before moving on).  Work
    stealing makes both complete; placement governs affinity.
    """

    def __init__(self, devices: Optional[Sequence[DeviceLike]] = None, *,
                 placement: str = "bynode",
                 over_decompose: int = 4,
                 speculate: bool = True,
                 straggler_policy: Optional[StragglerPolicy] = None,
                 slowdown_injector: Optional[Callable[[int, int], float]] = None):
        if devices is None:
            devices = cuda_devices()
        self.devices = [resolve_device(d) for d in devices]
        if placement not in ("bynode", "byslot"):
            raise ValueError(f"placement must be 'bynode' or 'byslot', "
                             f"got {placement!r}")
        self.placement = placement
        self.over_decompose = max(1, over_decompose)
        self.speculate = speculate
        self.policy = straggler_policy or StragglerPolicy()
        self.slowdown_injector = slowdown_injector  # tests: fake a slow node

    def run(self, fn: Callable[[Any], Any], points: Any) -> Any:
        """points: tree stacked on axis 0.  Returns the stacked results as
        numpy arrays, plus a SweepReport at ``engine.last_report``."""
        leaves, _ = flatten(points)
        n = leaves[0].shape[0]
        n_dev = len(self.devices)
        n_tasks = min(n, max(n_dev * self.over_decompose, 1))
        bounds = np.linspace(0, n, n_tasks + 1).astype(int)
        chunks = [tree_map(lambda a, lo=lo, hi=hi: a[lo:hi], points)
                  for lo, hi in zip(bounds[:-1], bounds[1:])]

        if self.placement == "bynode":
            assignment = [i % n_dev for i in range(n_tasks)]
        else:  # byslot: pack contiguously
            per = -(-n_tasks // n_dev)
            assignment = [min(i // per, n_dev - 1) for i in range(n_tasks)]

        tasks = [_Task(i, c, a) for i, (c, a) in
                 enumerate(zip(chunks, assignment))]
        queues: List[queue.SimpleQueue] = [queue.SimpleQueue()
                                           for _ in range(n_dev)]
        for t in tasks:
            queues[t.assigned_device].put(t)

        results: Dict[int, Any] = {}
        errors: List[BaseException] = []
        done = threading.Event()
        lock = threading.Lock()
        inflight: Dict[int, float] = {}     # task idx -> start time
        speculated: set = set()
        stolen = [0]
        counts: Dict[int, int] = {i: 0 for i in range(n_dev)}
        vmapped = torch.func.vmap(fn)

        def try_get_task(dev_idx: int) -> Optional[_Task]:
            try:
                return queues[dev_idx].get_nowait()
            except queue.Empty:
                pass
            # steal from the busiest other queue
            for j in range(n_dev):
                if j == dev_idx:
                    continue
                try:
                    t = queues[j].get_nowait()
                    with lock:
                        stolen[0] += 1
                    return t
                except queue.Empty:
                    continue
            # idle: speculate on a straggling in-flight task
            if self.speculate:
                now = time.monotonic()
                with lock:
                    for idx, started in list(inflight.items()):
                        if idx in results or idx in speculated:
                            continue
                        if self.policy.is_straggling(now - started):
                            speculated.add(idx)
                            return _Task(idx, tasks[idx].points, dev_idx)
            return None

        def worker(dev_idx: int):
            dev = self.devices[dev_idx]
            while not done.is_set():
                task = try_get_task(dev_idx)
                if task is None:
                    with lock:
                        if len(results) == n_tasks:
                            done.set()
                            return
                    time.sleep(0.001)
                    continue
                with lock:
                    if task.idx in results:
                        continue
                    inflight.setdefault(task.idx, time.monotonic())
                t0 = time.monotonic()
                if self.slowdown_injector is not None:
                    time.sleep(self.slowdown_injector(dev_idx, task.idx))
                # the host copy waits for the device, as JAX's
                # block_until_ready does before the duration is recorded
                out = tree_map(to_numpy, vmapped(_on(task.points, dev)))
                self.policy.record(time.monotonic() - t0)
                with lock:
                    if task.idx not in results:   # first finisher wins
                        results[task.idx] = out
                        counts[dev_idx] += 1
                    inflight.pop(task.idx, None)
                    if len(results) == n_tasks:
                        done.set()

        def guarded(dev_idx: int):
            try:
                worker(dev_idx)
            except BaseException as e:  # noqa: BLE001  (re-raised in run)
                with lock:
                    errors.append(e)
                done.set()

        t0 = time.monotonic()
        threads = [threading.Thread(target=guarded, args=(i,), daemon=True)
                   for i in range(n_dev)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        if errors:
            raise errors[0]

        ordered = [flatten(results[i]) for i in range(n_tasks)]
        treedef = ordered[0][1]
        stacked = unflatten(treedef, [
            np.concatenate([leaves[j] for leaves, _ in ordered], axis=0)
            for j in range(len(ordered[0][0]))])
        self.last_report = SweepReport(
            n_points=n, n_tasks=n_tasks, n_speculated=len(speculated),
            n_stolen=stolen[0], device_task_counts=counts, wall_time=wall)
        return stacked
