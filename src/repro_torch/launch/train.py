"""End-to-end training driver of the PyTorch port, run THROUGH the
platform (the paper's five-verb lifecycle): create cluster -> send data ->
run (train loop with checkpoint/preemption tolerance) -> get results ->
terminate.  The counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --steps 50 --batch 8 --seq 128 [--pallas-attention]

runs on the GPU (``--device cpu`` runs the plain PyTorch path on the CPU).
``--pallas-attention`` sets the two config fields the JAX package
documents for reaching its flash-attention kernel,
``use_pallas_attention=True`` and ``scan_layers=False``: here the layers
then run the port's flash-attention op (CUDA kernels on the card, their
plain versions on the CPU).  paligemma-3b and whisper-small train on the
chain's text beside random ``image_embeds`` or ``frames``
(``data.pipeline.make_batch_fn``), as in the JAX launcher.  Prints the
JAX launcher's JSON report and returns it, with the final ``TrainState``
under ``"state"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ShapeConfig, get_config, reduced
from repro_torch.core import tree
from repro_torch.core.platform import Platform
from repro_torch.core.resources import DevicePool
from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
from repro_torch.device import cuda_devices, resolve_device
from repro_torch.ft.preemption import PreemptibleTrainer, PreemptionSchedule
from repro_torch.train.steps import init_train_state, make_train_step


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config of the same family")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--workspace", default=None)
    ap.add_argument("--cluster-size", type=int, default=0,
                    help="0 = all available devices")
    ap.add_argument("--preempt-at", type=int, nargs="*", default=[],
                    help="simulate spot preemptions at these steps")
    ap.add_argument("--pallas-attention", action="store_true",
                    help="use_pallas_attention=True, scan_layers=False: "
                         "the flash-attention kernels")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, d_model=args.d_model, n_layers=args.n_layers,
                      d_ff=args.d_model * 4, vocab=args.vocab,
                      head_dim=max(16, args.d_model // 8))
    if args.pallas_attention:
        cfg = dataclasses.replace(cfg, use_pallas_attention=True,
                                  scan_layers=False)
    dev = resolve_device(args.device)
    pool = DevicePool(cuda_devices() if dev.type == "cuda" else [dev])
    ws = pathlib.Path(args.workspace or tempfile.mkdtemp(prefix="p2rac_"))
    platform = Platform(ws, pool=pool)
    size = args.cluster_size or pool.total
    platform.create_cluster("train_cluster", size,
                            description=f"train {cfg.name}")
    data = SyntheticLM(cfg.vocab, seed=0)
    platform.send_data_to_cluster("train_cluster",
                                  project={"bigram_table": data.table})

    def job(ctx):
        step_fn = make_train_step(cfg, base_lr=args.lr,
                                  total_steps=args.steps)
        state = init_train_state(cfg, seed=0, device=ctx.cluster.master)
        shape = ShapeConfig("cli", args.seq + (cfg.n_image_tokens or 0),
                            args.batch, "train")
        extra_fn = make_batch_fn(cfg, shape)

        def batch_fn(step):
            b = data.batch(step, args.batch, args.seq + 1)
            if cfg.n_image_tokens or cfg.n_encoder_layers:
                # the image prefix or the audio frames, beside the text
                extra = extra_fn(step)
                extra.update(b)
                return extra
            return b

        ckpt = CheckpointManager(ctx.outdir / "ckpt", keep_last=3)
        trainer = PreemptibleTrainer(step_fn, batch_fn, ckpt,
                                     checkpoint_every=args.checkpoint_every)
        schedule = PreemptionSchedule(kill_at_steps=list(args.preempt_at))
        t0 = time.time()
        rep = trainer.run_with_restarts(state, args.steps, schedule=schedule)
        if ctx.cluster.master.type == "cuda":
            torch.cuda.synchronize(ctx.cluster.master)
        wall = time.time() - t0
        losses = [float(m["loss"]) for m in rep["metrics"]]
        report = {
            "arch": cfg.name, "steps": args.steps, "wall_s": round(wall, 2),
            "device": (torch.cuda.get_device_name(ctx.cluster.master)
                       if ctx.cluster.master.type == "cuda" else "cpu"),
            "first_loss": losses[0], "last_loss": losses[-1],
            "entropy_floor": data.entropy_floor(),
            "attempts": rep["attempts"],
            "params": int(sum(x.numel() for x in
                              tree.flatten(rep["state"].params)[0])),
        }
        ctx.save_result("losses", np.asarray(losses))
        (ctx.outdir / "report.json").write_text(json.dumps(report, indent=1))
        report["state"] = rep["state"]
        return report

    handle = platform.run_on_cluster("train_cluster", job, runname="train")
    result = dict(handle.result)
    state = result.pop("state")
    print(json.dumps(result, indent=1))
    print("results at:", platform.get_results("train"))
    platform.terminate_cluster("train_cluster")
    return dict(result, state=state)


if __name__ == "__main__":
    main()
