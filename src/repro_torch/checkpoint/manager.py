"""Checkpointing — the paper's stated future work ("fault tolerance
through distributed checkpointing for spot instances"): the counterpart of
``repro/checkpoint/manager.py``, on one device (restoring onto other
shardings waits for ROADMAP.md Queue 1 item 7).

Design:
  * atomic: leaves written to ``<dir>/.tmp-<step>``, manifest last, then
    one ``rename`` — a preemption mid-save never corrupts the latest
    checkpoint.
  * versioned: keep_last N, ``latest_step()`` discovery, a sha256 of
    every leaf in the manifest, checked on restore.
  * async: ``save(..., blocking=False)`` hands the host copy to a writer
    thread, so the train loop pays only the device-to-host copy.

Trees are flattened by ``core.tree`` (JSON tree definition; dicts, lists,
tuples and the port's dataclasses such as ``TrainState``).  A tensor leaf
comes back as a tensor of its dtype on the device it was saved from,
anything else as a numpy array.  numpy has no
bfloat16, so a bf16 tensor is stored as its uint16 bit pattern and the
manifest records the dtype.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import tree as _tree


class CheckpointError(RuntimeError):
    pass


def _host(leaf: Any):
    """(host numpy array, manifest fields) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        meta = {"kind": "tensor", "dtype": str(t.dtype).split(".")[-1],
                "device": str(leaf.device)}
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), meta
        return t.numpy(), meta
    arr = np.asarray(leaf)
    return arr, {"kind": "ndarray", "dtype": str(arr.dtype)}


def _leaf(arr: np.ndarray, meta: Dict[str, Any]) -> Any:
    if meta["kind"] != "tensor":
        return arr
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(meta["device"])


class CheckpointManager:
    def __init__(self, directory: pathlib.Path, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._writer: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        self.wait()  # one async save in flight at a time
        # device -> host copy happens synchronously (consistent snapshot)
        leaves, treedef = _tree.flatten(tree)
        host = [_host(leaf) for leaf in leaves]

        def _write():
            tmp = self.dir / f".tmp-{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest: Dict[str, Any] = {"step": step, "n_leaves": len(host),
                                        "time": time.time(), "leaves": []}
            for i, (arr, meta) in enumerate(host):
                np.save(tmp / f"leaf_{i}.npy", arr)
                manifest["leaves"].append({
                    "shape": list(arr.shape), **meta,
                    "sha256": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
                })
            (tmp / "treedef.json").write_text(json.dumps(treedef))
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.step_dir(step)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)     # atomic commit
            self._gc()

        if blocking:
            _write()
        else:
            self._writer = threading.Thread(target=_write, daemon=True)
            self._writer.start()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, *,
                verify: bool = True) -> Any:
        """Load a checkpoint (the latest by default); tensor leaves go back
        to the device they were saved from."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise CheckpointError(f"no checkpoints in {self.dir}")
        d = self.step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        treedef = json.loads((d / "treedef.json").read_text())
        leaves = []
        for i, meta in enumerate(manifest["leaves"]):
            arr = np.load(d / f"leaf_{i}.npy")
            if verify:
                h = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
                if h != meta["sha256"]:
                    raise CheckpointError(
                        f"checksum mismatch in leaf {i} of step {step}")
            leaves.append(_leaf(arr, meta))
        return _tree.unflatten(treedef, leaves)
