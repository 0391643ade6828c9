"""Run/resource registry — the analogue of P2RAC's configuration files
(a copy of ``repro/core/registry.py``, which the port cannot import).

The paper keeps four config files at the Analyst site (instance file,
cluster file, variables, R libraries).  We keep one JSON registry per
workspace recording clusters, volumes, snapshots and runs, with the same
lifecycle semantics (sections added on create, removed on terminate,
``in_use`` lock flags, run records keyed by runname).
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Dict, List, Optional


class Registry:
    def __init__(self, workspace: pathlib.Path):
        self.workspace = pathlib.Path(workspace)
        self.workspace.mkdir(parents=True, exist_ok=True)
        self.path = self.workspace / "registry.json"
        if not self.path.exists():
            self._write({"clusters": {}, "instances": {}, "volumes": {},
                         "snapshots": {}, "runs": {}})

    def _read(self) -> Dict[str, Any]:
        return json.loads(self.path.read_text())

    def _write(self, data: Dict[str, Any]) -> None:
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(data, indent=1, default=str))
        tmp.replace(self.path)  # atomic

    # -- generic section ops --------------------------------------------
    def add(self, section: str, name: str, record: Dict[str, Any]) -> None:
        data = self._read()
        record = dict(record, created_at=time.time())
        data[section][name] = record
        self._write(data)

    def update(self, section: str, name: str, **fields: Any) -> None:
        data = self._read()
        if name not in data[section]:
            raise KeyError(f"{section}/{name}")
        data[section][name].update(fields)
        self._write(data)

    def remove(self, section: str, name: str) -> None:
        data = self._read()
        data[section].pop(name, None)
        self._write(data)

    def get(self, section: str, name: str) -> Optional[Dict[str, Any]]:
        return self._read()[section].get(name)

    def list(self, section: str) -> List[str]:
        return sorted(self._read()[section])

    # -- lock semantics (ec2resourcelock) --------------------------------
    def set_lock(self, section: str, name: str, in_use: bool) -> None:
        self.update(section, name, in_use=in_use)

    def is_locked(self, section: str, name: str) -> bool:
        rec = self.get(section, name)
        return bool(rec and rec.get("in_use"))
