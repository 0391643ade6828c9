"""P2RAC platform in PyTorch: the five-verb analyst API (the paper's
contribution; the counterpart of ``repro/core/platform.py``).

    1. create   — ``create_instance`` / ``create_cluster``   (resources)
    2. send     — ``send_data_to_cluster`` / ``..._to_master``(data in)
    3. run      — ``run_on_instance`` / ``run_on_cluster``    (execution)
                  (+ ``serve_on_cluster``: the port's paged serving engine
                  on a one-device cluster)
    4. get      — ``get_results``                             (data out)
    5. terminate— ``terminate_cluster`` / ``terminate_all``   (release)

plus the diagnostic verbs (``list_clusters``, ``resource_lock`` ...).

An "analyst job" is a python callable (the R-script analogue) receiving a
:class:`JobContext` with the cluster and its torch devices, the synced
project data, the attached volume, and an output directory.  Batch mode
runs it synchronously under the cluster lock; interactive mode returns a
handle.  The platform allocates from a :class:`DevicePool`: every CUDA
device unless one is given.
"""
from __future__ import annotations

import json
import pathlib
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import tree
from repro_torch.core.registry import Registry
from repro_torch.core.resources import (Cluster, DevicePool, ResourceError,
                                        VolumeStore, check_model_axis)
from repro_torch.core.sync import SyncStats, sync_dir, sync_pytree


@dataclass
class JobContext:
    """What an analyst job sees (its 'environment' on the cluster)."""
    cluster: Cluster
    project: Dict[str, Any]           # synced small data (rsync analogue)
    volume: Optional[VolumeStore]     # attached bulk store (EBS analogue)
    outdir: pathlib.Path              # results directory for this run
    runname: str
    placement: str = "bynode"         # the sweep engine's placement policy

    def save_result(self, name: str, value: Any) -> None:
        """``<name>.npz`` of the tree's leaves (host copies) beside
        ``<name>.treedef.json``."""
        self.outdir.mkdir(parents=True, exist_ok=True)
        leaves, treedef = tree.flatten(value)
        np.savez(self.outdir / f"{name}.npz",
                 **{str(i): tree.to_numpy(leaf)
                    for i, leaf in enumerate(leaves)})
        (self.outdir / f"{name}.treedef.json").write_text(
            json.dumps(treedef))


@dataclass
class RunHandle:
    runname: str
    cluster_name: str
    thread: Optional[threading.Thread] = None
    status: str = "running"
    error: Optional[str] = None
    result: Any = None
    started: float = field(default_factory=time.time)
    finished: Optional[float] = None

    def wait(self, timeout: Optional[float] = None) -> "RunHandle":
        if self.thread is not None:
            self.thread.join(timeout)
        return self


def _later(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to PyTorch yet (ROADMAP.md {item})")


class Platform:
    """The P2RAC platform instance for one analyst workspace."""

    def __init__(self, workspace: pathlib.Path,
                 pool: Optional[DevicePool] = None):
        self.workspace = pathlib.Path(workspace)
        self.workspace.mkdir(parents=True, exist_ok=True)
        self.registry = Registry(self.workspace)
        self.pool = pool or DevicePool()
        self.clusters: Dict[str, Cluster] = {}
        self.volumes: Dict[str, VolumeStore] = {}
        self._staged: Dict[str, Dict[str, Any]] = {}   # per-cluster project
        self._hashes: Dict[str, Dict[str, str]] = {}
        self.runs: Dict[str, RunHandle] = {}

    # ------------------------------------------------------------------
    # 1. resource management
    # ------------------------------------------------------------------
    def create_volume(self, volume_id: Optional[str] = None) -> VolumeStore:
        vol = VolumeStore.create(self.workspace, volume_id)
        self.volumes[vol.volume_id] = vol
        self.registry.add("volumes", vol.volume_id, {"root": str(vol.root)})
        return vol

    def create_volume_from_snapshot(self, snapshot_id: str) -> VolumeStore:
        vol = VolumeStore.from_snapshot(self.workspace, snapshot_id)
        self.volumes[vol.volume_id] = vol
        self.registry.add("volumes", vol.volume_id,
                          {"root": str(vol.root), "snapshot": snapshot_id})
        return vol

    def create_instance(self, name: str, *, volume: Optional[str] = None,
                        description: str = "") -> Cluster:
        """An 'instance' is a size-1 cluster (paper §3.2.1)."""
        return self.create_cluster(name, size=1, volume=volume,
                                   description=description)

    def create_cluster(self, name: str, size: int, *,
                       model_axis: int = 1,
                       volume: Optional[str] = None,
                       snapshot: Optional[str] = None,
                       description: str = "") -> Cluster:
        if volume is not None and snapshot is not None:
            raise ResourceError("specify volume OR snapshot, not both "
                                "(paper: snap and ebsvol are exclusive)")
        if name in self.clusters:
            raise ResourceError(f"cluster {name!r} already exists")
        check_model_axis(size, model_axis)
        devices = self.pool.allocate(name, size)
        vol: Optional[VolumeStore] = None
        if snapshot is not None:
            vol = self.create_volume_from_snapshot(snapshot)
        elif volume is not None:
            if volume not in self.volumes:
                self.pool.release(name)
                raise ResourceError(f"unknown volume {volume!r}")
            vol = self.volumes[volume]
        if vol is not None:
            try:
                vol.attach(name)
            except ResourceError:
                self.pool.release(name)
                raise
        home = self.workspace / "clusters" / name / "home"
        home.mkdir(parents=True, exist_ok=True)
        cluster = Cluster(name=name, devices=list(devices),
                          tp_size=model_axis, description=description,
                          volume=vol, home=home)
        self.clusters[name] = cluster
        self.registry.add("clusters", name, {
            "size": size, "description": description, "in_use": False,
            "volume": vol.volume_id if vol else None,
            "devices": [str(d) for d in devices]})
        self._staged[name] = {}
        self._hashes[name] = {}
        return cluster

    def terminate_cluster(self, name: str, *, delete_volume: bool = False,
                          force: bool = False) -> None:
        cluster = self.clusters.get(name)
        if cluster is None:
            raise ResourceError(f"unknown cluster {name!r}")
        if cluster.in_use and not force:
            raise ResourceError(
                f"cluster {name!r} is in use; unlock it first "
                "(paper: an in-use cluster cannot be terminated)")
        if cluster.volume is not None:
            cluster.volume.detach()
            if delete_volume:
                cluster.volume.delete()
                self.volumes.pop(cluster.volume.volume_id, None)
                self.registry.remove("volumes", cluster.volume.volume_id)
        self.pool.release(name)
        del self.clusters[name]
        self._staged.pop(name, None)
        self._hashes.pop(name, None)
        self.registry.remove("clusters", name)

    def terminate_all(self, *, instances: bool = True, clusters: bool = True,
                      volumes: bool = False, snapshots: bool = False) -> None:
        for name in list(self.clusters):
            self.terminate_cluster(name, force=True)
        if volumes:
            for vid in list(self.volumes):
                self.volumes[vid].delete()
                self.registry.remove("volumes", vid)
            self.volumes.clear()
        if snapshots:
            import shutil
            shutil.rmtree(self.workspace / "snapshots", ignore_errors=True)

    # ------------------------------------------------------------------
    # 2. data management
    # ------------------------------------------------------------------
    def send_data_to_cluster(self, name: str,
                             project: Optional[Dict[str, Any]] = None,
                             project_dir: Optional[pathlib.Path] = None,
                             ) -> SyncStats:
        """Delta-sync small/frequently-changing data to every node."""
        cluster = self._cluster(name)
        stats = SyncStats()
        if project_dir is not None:
            stats = sync_dir(pathlib.Path(project_dir), cluster.home)
        if project is not None:
            self._staged[name], s2 = sync_pytree(
                project, self._staged[name], self._hashes[name])
            for f in ("entries_total", "entries_sent", "entries_skipped",
                      "bytes_sent", "bytes_total"):
                setattr(stats, f, getattr(stats, f) + getattr(s2, f))
        return stats

    def send_data_to_master(self, name: str,
                            project_dir: pathlib.Path) -> SyncStats:
        """Sync to the master only (paper: master distributes to workers)."""
        cluster = self._cluster(name)
        master_home = cluster.home.parent / "master_home"
        return sync_dir(pathlib.Path(project_dir), master_home)

    def get_results(self, runname: str, *, source: str = "master"
                    ) -> pathlib.Path:
        """Fetch a run's results directory (frommaster/fromworkers/fromall
        collapse to the same store: one process holds every device)."""
        if source not in ("master", "workers", "all"):
            raise ResourceError(
                f"get_results: unknown source {source!r}; expected "
                f"'master', 'workers', or 'all' (the paper's frommaster/"
                f"fromworkers/fromall switches)")
        rec = self.registry.get("runs", runname)
        if rec is None:
            raise KeyError(f"unknown run {runname!r}")
        return pathlib.Path(rec["outdir"])

    # ------------------------------------------------------------------
    # 3. execution management
    # ------------------------------------------------------------------
    def run_on_cluster(self, name: str, job: Callable[[JobContext], Any], *,
                       runname: Optional[str] = None,
                       mode: str = "batch",
                       placement: str = "bynode") -> RunHandle:
        """Run an analyst job under the cluster lock.

        mode="batch": synchronous (production runs).
        mode="interactive": returns immediately; the lock is held until the
        job finishes (ad hoc experimentation while watching results).
        placement: "bynode"|"byslot" — forwarded to the job context for the
        sweep engine's scheduling policy (paper's MPI-style switch).
        """
        cluster = self._cluster(name)
        runname = runname or f"run-{uuid.uuid4().hex[:8]}"
        if runname in self.runs:
            raise ResourceError(f"run name {runname!r} already used")
        cluster.lock()
        self.registry.set_lock("clusters", name, True)
        outdir = self.workspace / "results" / runname
        ctx = JobContext(cluster=cluster,
                         project=dict(self._staged.get(name, {})),
                         volume=cluster.volume, outdir=outdir,
                         runname=runname, placement=placement)
        handle = RunHandle(runname=runname, cluster_name=name)
        self.runs[runname] = handle
        self.registry.add("runs", runname, {
            "cluster": name, "status": "running", "outdir": str(outdir),
            "placement": placement})

        def _execute():
            try:
                handle.result = job(ctx)
                handle.status = "done"
            except Exception as e:  # noqa: BLE001  (reported on the handle)
                handle.status = "failed"
                handle.error = f"{e!r}\n{traceback.format_exc()}"
            finally:
                handle.finished = time.time()
                cluster.unlock()
                self.registry.set_lock("clusters", name, False)
                self.registry.update("runs", runname, status=handle.status)

        if mode == "interactive":
            t = threading.Thread(target=_execute, daemon=True)
            handle.thread = t
            t.start()
        else:
            _execute()
            if handle.status == "failed":
                raise RuntimeError(f"run {runname} failed: {handle.error}")
        return handle

    run_on_instance = run_on_cluster  # an instance is a 1-node cluster

    def serve_on_cluster(self, name: str, cfg, params,
                         requests: Optional[List[tuple]] = None, *,
                         open_loop: Optional[Dict[str, Any]] = None,
                         runname: Optional[str] = None,
                         mode: str = "batch",
                         token_budget: Optional[int] = None,
                         prefix_cache: bool = False,
                         speculate: bool = False,
                         draft_k: int = 4,
                         kv_dtype: str = "fp",
                         preempt: str = "recompute",
                         host_cache_pages: int = 0,
                         replicas: int = 1,
                         routing: str = "affinity",
                         trace=None,
                         **engine_kwargs) -> RunHandle:
        """Serve a request list with the port's paged engine on the
        cluster's master device — ``run_on_cluster`` for the serving
        workload.

        requests: ``[(prompt_tokens, max_new_tokens), ...]``: everything
        pre-staged, the engine drains.  ``params`` must be on the
        cluster's device.  token_budget: per-tick token cap for the unified
        ragged dispatch.  trace: path to dump the engine's telemetry trace
        to after the run drains (JSONL, or Chrome trace_event for
        ``.json``).  engine_kwargs: forwarded to
        :class:`repro_torch.serving.PagedServingEngine` (max_slots,
        block_size, num_blocks, ...).

        Returns a RunHandle whose ``result`` is ``{"results": {req_id:
        [token, ...]}, "metrics": engine.metrics()}``; the tokens also
        land in the run's outdir for ``get_results``.

        Not ported yet, each raising ``NotImplementedError`` with its
        ROADMAP item: ``open_loop``, ``replicas > 1``, ``prefix_cache``,
        ``speculate`` (and so ``draft_k``), ``kv_dtype="int8"``,
        ``preempt="swap"``, ``host_cache_pages`` and a cluster with
        ``tp_size > 1`` (``routing`` only matters with replicas).
        """
        cluster = self._cluster(name)
        if cluster.tp_size != cluster.size:
            raise ResourceError(
                f"cluster {name!r} has {cluster.size} devices but "
                f"model_axis={cluster.tp_size}; serving shards over the "
                f"model axis only — create it with create_cluster(name, "
                f"{cluster.size}, model_axis={cluster.size})")
        if replicas < 1:
            raise ValueError("serve_on_cluster: replicas must be >= 1")
        for lacking, option, item in (
                (open_loop is not None, "open_loop", "Queue 1 item 9"),
                (replicas > 1, "replicas > 1", "Queue 1 item 9"),
                (prefix_cache, "prefix_cache=True",
                 "Queue 1 item 6 and Queue 2 item 3"),
                (speculate, "speculate=True", "Queue 1 item 6"),
                (kv_dtype == "int8", "kv_dtype='int8'",
                 "Queue 2 item 1, int8 variant"),
                (preempt == "swap", "preempt='swap'", "Queue 1 item 6"),
                (host_cache_pages > 0, "host_cache_pages",
                 "Queue 1 item 6"),
                (cluster.tp_size > 1, "serving on a cluster with "
                 "tp_size > 1", "Queue 1 item 13")):
            if lacking:
                raise _later(option, item)
        if requests is None:
            raise ValueError("serve_on_cluster takes requests= (the "
                             "closed-loop path)")

        def job(ctx: JobContext):
            from repro_torch.serving import PagedServingEngine

            eng = PagedServingEngine(cfg, params, token_budget=token_budget,
                                     kv_dtype=kv_dtype, preempt=preempt,
                                     device=ctx.cluster.master,
                                     **engine_kwargs)
            ids = [eng.submit(p, g) for p, g in requests]
            results = eng.run_to_completion()
            out = {rid: results[rid] for rid in ids}
            metrics = eng.metrics()
            ctx.save_result("tokens", {str(rid): np.asarray(t, np.int32)
                                       for rid, t in out.items()})
            if trace is not None:
                metrics["trace"] = {"path": str(trace),
                                    "format": eng.dump_trace(trace)}
            return {"results": out, "metrics": metrics}

        return self.run_on_cluster(name, job, runname=runname, mode=mode)

    # ------------------------------------------------------------------
    # diagnostics (paper §3.3)
    # ------------------------------------------------------------------
    def list_clusters(self, names_only: bool = False):
        if names_only:
            return self.registry.list("clusters")
        return {n: self.registry.get("clusters", n)
                for n in self.registry.list("clusters")}

    def list_all_resources(self):
        return {s: self.registry.list(s)
                for s in ("clusters", "volumes", "snapshots", "runs")}

    def resource_lock(self, name: str, *, in_use: bool) -> None:
        cluster = self._cluster(name)
        if in_use:
            cluster.lock()
        else:
            cluster.unlock()
        self.registry.set_lock("clusters", name, in_use)

    def login_to_master(self, name: str) -> JobContext:
        """SSH analogue: an interactive context on the master (no lock)."""
        cluster = self._cluster(name)
        return JobContext(cluster=cluster,
                          project=dict(self._staged.get(name, {})),
                          volume=cluster.volume,
                          outdir=self.workspace / "scratch" / name,
                          runname="interactive")

    def _cluster(self, name: str) -> Cluster:
        if name not in self.clusters:
            raise ResourceError(f"unknown cluster {name!r}")
        return self.clusters[name]
