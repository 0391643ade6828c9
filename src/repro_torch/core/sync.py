"""ProjectSync — the rsync analogue (the counterpart of
``repro/core/sync.py``; a project's arrays may be numpy arrays or torch
tensors on any device, which are hashed through a host copy).

The paper chose rsync over scp because subsequent transfers only ship
changed data.  We keep that contract: a project (a directory, or a pytree
of arrays) is content-hashed per entry; ``sync`` copies only entries whose
hash changed since the last sync, and reports byte/entry statistics (used
by the Fig. 6/7 platform-overhead benchmark).
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.core.tree import to_numpy


@dataclass
class SyncStats:
    entries_total: int = 0
    entries_sent: int = 0
    entries_skipped: int = 0
    bytes_sent: int = 0
    bytes_total: int = 0


def _file_hash(p: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(p, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def sync_dir(src: pathlib.Path, dst: pathlib.Path) -> SyncStats:
    """One-way delta sync of a directory tree (project -> cluster home)."""
    src, dst = pathlib.Path(src), pathlib.Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    manifest_path = dst / ".sync_manifest.json"
    old: Dict[str, str] = {}
    if manifest_path.exists():
        old = json.loads(manifest_path.read_text())
    new: Dict[str, str] = {}
    stats = SyncStats()
    for f in sorted(src.rglob("*")):
        if not f.is_file():
            continue
        rel = str(f.relative_to(src))
        digest = _file_hash(f)
        new[rel] = digest
        size = f.stat().st_size
        stats.entries_total += 1
        stats.bytes_total += size
        if old.get(rel) == digest and (dst / rel).exists():
            stats.entries_skipped += 1
            continue
        target = dst / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(f, target)
        stats.entries_sent += 1
        stats.bytes_sent += size
    # remove deleted files (rsync --delete)
    for rel in set(old) - set(new):
        (dst / rel).unlink(missing_ok=True)
    manifest_path.write_text(json.dumps(new, indent=0))
    return stats


def _array_hash(x: Any) -> str:
    a = to_numpy(x)
    return hashlib.sha256(
        a.tobytes() + str(a.shape).encode() + str(a.dtype).encode()
    ).hexdigest()


def sync_pytree(project: Dict[str, Any], staged: Dict[str, Any],
                hashes: Dict[str, str]) -> Tuple[Dict[str, Any], SyncStats]:
    """Delta-sync a flat dict of arrays into ``staged`` (device-side dict).

    Returns (new_staged, stats); ``hashes`` is mutated to the new state.
    """
    stats = SyncStats()
    out = dict(staged)
    for name, value in project.items():
        host = to_numpy(value)
        digest = _array_hash(host)
        nbytes = host.nbytes
        stats.entries_total += 1
        stats.bytes_total += nbytes
        if hashes.get(name) == digest and name in out:
            stats.entries_skipped += 1
            continue
        out[name] = value
        hashes[name] = digest
        stats.entries_sent += 1
        stats.bytes_sent += nbytes
    for name in set(hashes) - set(project):
        out.pop(name, None)
        hashes.pop(name, None)
    return out, stats
