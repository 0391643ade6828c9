"""The train step: the counterpart of ``repro/train/steps.py``'s
``TrainState``, ``init_train_state``, ``make_train_step``,
``make_prefill_step`` and ``make_decode_step`` (one device; sharded steps
wait for ROADMAP.md Queue 1 item 7, so no ``info=``).

A step is functional, as the jitted JAX step is: it returns a new
``TrainState`` and leaves the one it was given as it was, so one initial
state can seed several runs (``PreemptibleTrainer.run_with_restarts``
hands the same state to every attempt).  Parameters are fp32 masters
(``cfg.param_dtype``), cast to the compute dtype at every use; gradients
are fp32, clipped by their global norm, then AdamW under the cosine
schedule.  ``cfg.microbatches`` accumulates fp32 gradients over equal
slices of the batch.  The step runs on the device its state lives on; the
batch (int32 tokens and labels, and the image embeddings or audio frames
of paligemma-3b or whisper-small) is moved there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.tree import flatten, unflatten
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule)


@dataclass
class TrainState:
    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    step: torch.Tensor                 # 0-d int32, on the params' device


def init_train_state(cfg, seed: int = 0, device: DeviceLike = None,
                     opt_cfg: Optional[AdamWConfig] = None) -> TrainState:
    """Seeded random weights as ``cfg.param_dtype`` masters, zero AdamW
    states, step 0, on ``device`` (the GPU unless the caller asks for the
    CPU)."""
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    dev = resolve_device(device)
    params = M.init_params(cfg, seed, dev,
                           param_dtype=getattr(torch, cfg.param_dtype))
    return TrainState(params=params, opt_state=adamw_init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def loss_and_grads(cfg, params: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """(loss, metrics, grads) of ``M.loss_fn`` at ``params``; the params'
    tensors are not modified and gain no ``.grad``."""
    leaves, treedef = flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    loss, metrics = M.loss_fn(cfg, unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(treedef, list(grads))


def make_train_step(cfg, *, opt_cfg: Optional[AdamWConfig] = None,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, clip: float = 1.0
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """Returns train_step(state, batch) -> (new state, metrics).  Raises
    for an MoE config (``M.check_trainable``)."""
    M.check_trainable(cfg)
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    lr_fn = cosine_schedule(base_lr, warmup, total_steps)
    n_micro = max(1, cfg.microbatches)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        dev = state.step.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        if n_micro == 1:
            _, metrics, grads = loss_and_grads(cfg, state.params, batch)
        else:
            b = next(iter(batch.values())).shape[0] // n_micro
            gsum, loss_sum, toks = None, 0.0, 0
            for i in range(n_micro):
                part = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                loss_i, m_i, g_i = loss_and_grads(cfg, state.params, part)
                g_i, treedef = flatten(g_i)
                g_i = [g.float() for g in g_i]
                gsum = g_i if gsum is None else [
                    a + g for a, g in zip(gsum, g_i)]
                loss_sum = loss_sum + loss_i
                toks = toks + m_i["tokens"]
            grads = unflatten(treedef, [g / n_micro for g in gsum])
            metrics = {"loss": loss_sum / n_micro, "tokens": toks}
        grads, gnorm = clip_by_global_norm(grads, clip)
        lr = lr_fn(state.step)
        new_params, new_opt = adamw_update(grads, state.opt_state,
                                           state.params, lr, opt_cfg)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def _params_device(params: Dict[str, Any]) -> torch.device:
    return params["embed"]["table"].device


def make_prefill_step(cfg) -> Callable[[Dict[str, Any],
                                         Dict[str, torch.Tensor]],
                                        torch.Tensor]:
    """Returns prefill_step(params, batch) -> ``M.prefill``: the last
    position's final hidden (B, 1, d), with no gradient recorded.  The
    batch is moved to the params' device."""
    @torch.no_grad()
    def prefill_step(params, batch):
        dev = _params_device(params)
        return M.prefill(cfg, params, {k: v.to(dev) for k, v in batch.items()})
    return prefill_step


def make_decode_step(cfg) -> Callable[..., Tuple[torch.Tensor,
                                                 Dict[str, Any]]]:
    """Returns decode_step(params, cache, tokens, pos) -> ``M.decode_step``
    (logits (B, 1, V_padded), the cache updated in place), with no
    gradient recorded."""
    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache,
                             tokens.to(_params_device(params)), pos)
    return decode_step
