"""Cloud-resource analogues: DevicePool, Cluster, VolumeStore (the
counterpart of ``repro/core/resources.py``).

The paper's resources map onto torch devices:
  EC2 instance            -> one CUDA device
  EC2 cluster (N nodes)   -> a named list of devices from a DevicePool; its
                             model axis (tensor-parallel width) is recorded
  EBS volume              -> VolumeStore: a persistent, snapshot-able tree
                             store on disk; attachable to ONE cluster at a
                             time (exactly EBS's attach semantics)
  EBS snapshot            -> copy-on-write clone of a VolumeStore
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.device import cuda_devices


class ResourceError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Device pool
# ---------------------------------------------------------------------------

class DevicePool:
    """The set of accelerators the platform may allocate from: every CUDA
    device unless ``devices`` is given (raises without a GPU).  Allocation
    is tracked by slot, so one device may fill several slots (a test's
    ``[torch.device("cpu")] * 4``)."""

    def __init__(self, devices: Optional[Sequence[torch.device]] = None):
        if devices is None:
            devices = cuda_devices()
        self._devices = [torch.device(d) for d in devices]
        self._allocated: Dict[str, List[int]] = {}

    @property
    def total(self) -> int:
        return len(self._devices)

    def _free_slots(self) -> List[int]:
        used = {s for slots in self._allocated.values() for s in slots}
        return [s for s in range(len(self._devices)) if s not in used]

    @property
    def free(self) -> List[torch.device]:
        return [self._devices[s] for s in self._free_slots()]

    def allocate(self, name: str, n: int) -> List[torch.device]:
        if name in self._allocated:
            raise ResourceError(f"resource name {name!r} already in use")
        free = self._free_slots()
        if len(free) < n:
            raise ResourceError(
                f"requested {n} devices, only {len(free)} free")
        self._allocated[name] = free[:n]
        return [self._devices[s] for s in free[:n]]

    def release(self, name: str) -> None:
        self._allocated.pop(name, None)


# ---------------------------------------------------------------------------
# Volume store (EBS analogue)
# ---------------------------------------------------------------------------

def _tree_hash(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    for f in sorted(path.rglob("*")):
        if f.is_file():
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


@dataclass
class VolumeStore:
    """Persistent array/object store backing bulk inputs and checkpoints.

    A value is a tree of dicts, lists, tuples and None over array leaves
    (numpy arrays, tensors on any device, scalars); ``put`` writes each
    leaf as ``<i>.npy`` beside a JSON tree definition
    (``repro_torch.core.tree``) and ``get`` gives it back with numpy
    leaves.  It does not read volumes the JAX package wrote (those keep a
    pickled ``jax.tree`` treedef)."""
    volume_id: str
    root: pathlib.Path
    attached_to: Optional[str] = None

    @classmethod
    def create(cls, workspace: pathlib.Path,
               volume_id: Optional[str] = None) -> "VolumeStore":
        vid = volume_id or f"vol-{uuid.uuid4().hex[:8]}"
        root = workspace / "volumes" / vid
        root.mkdir(parents=True, exist_ok=True)
        return cls(volume_id=vid, root=root)

    @classmethod
    def from_snapshot(cls, workspace: pathlib.Path,
                      snapshot_id: str) -> "VolumeStore":
        """New volume initialised from a snapshot (EBS snap -> vol)."""
        snap_root = workspace / "snapshots" / snapshot_id
        if not snap_root.exists():
            raise ResourceError(f"unknown snapshot {snapshot_id!r}")
        vol = cls.create(workspace)
        shutil.copytree(snap_root, vol.root, dirs_exist_ok=True)
        return vol

    def snapshot(self, workspace: pathlib.Path,
                 snapshot_id: Optional[str] = None) -> str:
        sid = snapshot_id or f"snap-{uuid.uuid4().hex[:8]}"
        dst = workspace / "snapshots" / sid
        shutil.copytree(self.root, dst, dirs_exist_ok=True)
        (dst / "_meta.json").write_text(json.dumps(
            {"source": self.volume_id, "hash": _tree_hash(self.root),
             "time": time.time()}))
        return sid

    # -- array/object I/O ---------------------------------------------------
    def put(self, name: str, value: Any) -> None:
        leaves, treedef = tree.flatten(value)
        d = self.root / name
        d.mkdir(parents=True, exist_ok=True)
        for i, leaf in enumerate(leaves):
            np.save(d / f"{i}.npy", tree.to_numpy(leaf))
        (d / "treedef.json").write_text(json.dumps(
            {"n": len(leaves), "treedef": treedef}))

    def get(self, name: str) -> Any:
        d = self.root / name
        if not d.exists():
            raise KeyError(name)
        meta = json.loads((d / "treedef.json").read_text())
        leaves = [np.load(d / f"{i}.npy") for i in range(meta["n"])]
        return tree.unflatten(meta["treedef"], leaves)

    def keys(self) -> List[str]:
        return sorted(p.name for p in self.root.iterdir() if p.is_dir())

    def delete(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)

    # -- attach semantics (one cluster at a time, like EBS) -----------------
    def attach(self, cluster_name: str) -> None:
        if self.attached_to is not None and self.attached_to != cluster_name:
            raise ResourceError(
                f"volume {self.volume_id} already attached to "
                f"{self.attached_to!r}")
        self.attached_to = cluster_name

    def detach(self) -> None:
        self.attached_to = None


# ---------------------------------------------------------------------------
# Cluster
# ---------------------------------------------------------------------------

@dataclass
class Cluster:
    """A named list of devices; devices[0] is the 'master'.  ``tp_size``
    is the model axis it was created with (serving's tensor-parallel
    width)."""
    name: str
    devices: List[torch.device]
    tp_size: int = 1
    description: str = ""
    volume: Optional[VolumeStore] = None
    in_use: bool = False
    created_at: float = field(default_factory=time.time)
    home: Optional[pathlib.Path] = None   # synced project directory

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def master(self) -> torch.device:
        return self.devices[0]

    @property
    def workers(self) -> List[torch.device]:
        return self.devices[1:]

    def lock(self) -> None:
        if self.in_use:
            raise ResourceError(f"cluster {self.name!r} is in use")
        self.in_use = True

    def unlock(self) -> None:
        self.in_use = False


def check_model_axis(n_devices: int, model_axis: int = 1) -> int:
    """The tensor-parallel width of a cluster of ``n_devices``: the
    (data, model) layout needs ``model_axis`` to divide the cluster size,
    as ``repro.core.resources.build_cluster_mesh`` checks.  Serving
    clusters put every device on it, batch analytics default to 1."""
    if model_axis < 1 or n_devices % model_axis != 0:
        raise ResourceError(
            f"model_axis {model_axis} does not divide cluster size "
            f"{n_devices}")
    return model_axis
