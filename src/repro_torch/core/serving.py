"""Continuous-batching serving engine over a dense KV cache (slot-based,
vLLM-lite): the legacy engine, the counterpart of
``repro/core/serving.py::ServingEngine`` and, like it, the exactness
reference of the serving stack.

The engine keeps a fixed decode batch of ``max_slots`` sequences in one
dense ``models.model.init_cache`` cache; requests are admitted into free
slots (prefilled one token at a time into the shared cache), every
``step()`` decodes one token for all active slots, and finished sequences
free their slot immediately — new requests join mid-flight without
stalling the rest.

Each slot advances alone through ``models.model.decode_step`` on a view
of the cache that holds only the slot's rows (batch axis 1 of every
leaf).  The port's decode step writes its cache in place, so the write
through that view is the per-slot commit the JAX engine makes with
``tree_map_with_path`` after a full-batch step: the other slots' rows are
never touched.  It runs the plain PyTorch model on the device, no kernel
of its own.  It serves decoder-only stacks: dense, MoE, hybrid SSM
(hymba's state is one more cache group, ``ssm``) and RWKV; it refuses
encoder-decoder and image-prefix configs, as the JAX engine does.  A slot
taken by a new request starts from a zero recurrent state (SSM or RWKV),
the state ``generate`` starts from; the JAX engine leaves the previous
request's state in the slot.

Correctness contract (tested): a request served through the engine yields
exactly the tokens it would get from the port's isolated greedy
``launch.serve.generate``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                 # (S0,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Slot-based continuous batching over a dense cache of ``max_slots``
    rows of ``max_seq`` positions, on ``device`` (``cuda`` unless given;
    ``params`` must already be there)."""

    def __init__(self, cfg, params, *, max_slots: int = 4,
                 max_seq: int = 256, device: DeviceLike = None):
        if cfg.n_encoder_layers or cfg.n_image_tokens:
            raise ValueError("continuous batching implemented for "
                             "decoder-only archs")
        self.device = resolve_device(device)
        wdev = params["embed"]["table"].device
        if wdev.type != self.device.type:
            raise ValueError(f"params are on {wdev}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.cache = M.init_cache(cfg, max_slots, max_seq, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.slot_pos = np.zeros(max_slots, np.int32)   # next position
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_id = 0
        self.dispatches = 0          # decode-step launches issued so far

    def metrics(self) -> Dict[str, Any]:
        """Point-in-time engine report, schema-compatible with
        ``PagedServingEngine.metrics()``: the same top-level keys, with
        the paged-only sections pinned to their "not applicable" shape
        (``blocks``/``cluster`` None, prefix cache and telemetry
        disabled) so ``launch/serve.py --engine legacy|paged`` reports
        stay diffable field by field."""
        return {
            "scheduler": {"num_finished": len(self.finished),
                          "num_waiting": len(self.queue),
                          "num_active": self.active},
            "blocks": None,
            # router balancing signal, same keys as the paged engine;
            # capacity here is slots, not pages, so "free" means free slots
            "queue_depth": len(self.queue),
            "free_page_fraction":
                sum(r is None for r in self.slot_req) / self.max_slots,
            "tick": "slot",              # one dispatch per slot per token
            "token_budget": None,
            # no paged pool: dense cache, evicted work is recomputed
            "kv_dtype": "fp",
            "preempt": "recompute",
            "swapped_requests_waiting": 0,
            "prefix_cache": {"enabled": False},
            "speculative": {"enabled": False},
            "dispatches": self.dispatches,
            "attention_backend": "reference",
            "cluster": None,
            "oom_finished": 0,
            "telemetry": {"enabled": False},
        }

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first "
                             "token is emitted from the prefill logits)")
        if prompt.size >= self.max_seq:
            raise ValueError(
                f"prompt of {prompt.size} tokens does not fit the "
                f"max_seq={self.max_seq} cache")
        req = Request(self._next_id, prompt, max_new_tokens)
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Prefill queued requests into free slots, token by token through
        the shared cache (per-slot sequential prefill keeps the engine
        simple and exact; chunked prefill is the paged engine's)."""
        for slot in self._free_slots():
            if not self.queue:
                return
            req = self.queue.pop(0)
            self.slot_req[slot] = req
            self.slot_pos[slot] = 0
            self._reset_state(slot)
            last_logits = None
            for tok in req.prompt:
                last_logits = self._step_one_slot(slot, int(tok))
            # first generated token comes from the prompt's last logits
            req.generated.append(self._greedy(last_logits))

    def _reset_state(self, slot: int) -> None:
        """Zero the slot's recurrent state (the K/V rows need no reset:
        a position past the slot's fill level is masked)."""
        for group in ("ssm", "rwkv"):
            leaves = self.cache.get(group)
            if leaves is None:
                continue
            for t in (leaves.values() if isinstance(leaves, dict)
                      else (leaves,)):
                t[:, slot].zero_()

    def _slot_cache(self, slot: int) -> Dict[str, Any]:
        """The cache restricted to one slot: every leaf's rows
        ``[:, slot:slot + 1]`` (batch is axis 1 of every leaf), views, so
        the decode step's in-place write lands in that slot alone."""
        return {group: ({name: t[:, slot:slot + 1]
                         for name, t in leaves.items()}
                        if isinstance(leaves, dict)
                        else leaves[:, slot:slot + 1])
                for group, leaves in self.cache.items()}

    @torch.no_grad()
    def _step_one_slot(self, slot: int, token: int) -> torch.Tensor:
        """Advance a single slot by one token; returns its logits row
        (padded vocab) on the device."""
        tokens = torch.tensor([[token]], dtype=torch.int32, device=self.device)
        logits, _ = M.decode_step(self.cfg, self.params,
                                  self._slot_cache(slot), tokens,
                                  int(self.slot_pos[slot]))
        self.dispatches += 1
        self.slot_pos[slot] += 1
        return logits[0, 0]

    def _greedy(self, logits: torch.Tensor) -> int:
        return int(torch.argmax(logits[:self.cfg.vocab].float()))

    # ------------------------------------------------------------------
    def step(self) -> Dict[int, int]:
        """Admit + decode one token for every active slot.

        Returns {req_id: new_token} for this step.  NOTE: a request's
        first generated token (produced from prefill logits during
        admission) is not included — it only appears in ``generated`` /
        ``run_to_completion``; the paged engine's step() does emit it.
        """
        self._admit()
        emitted: Dict[int, int] = {}
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            logits = self._step_one_slot(slot, req.generated[-1])
            if len(req.generated) < req.max_new_tokens:
                nxt = self._greedy(logits)
                req.generated.append(nxt)
                emitted[req.req_id] = nxt
            if len(req.generated) >= req.max_new_tokens or \
                    self.slot_pos[slot] >= self.max_seq - 1:
                req.done = True
                self.finished[req.req_id] = req
                self.slot_req[slot] = None   # free the slot immediately
        return emitted

    def clear_finished(self) -> Dict[int, List[int]]:
        """Drop retained finished requests (long-lived engines call this
        between waves to bound memory); returns what was dropped."""
        out = {rid: r.generated for rid, r in self.finished.items()}
        self.finished.clear()
        return out

    def _state_fingerprint(self):
        """Hashable snapshot of everything the next step's decisions
        read; an emit-less step that leaves it unchanged can never make
        progress later (same no-progress contract as
        ``PagedServingEngine._state_fingerprint``)."""
        return (tuple(r.req_id for r in self.queue),
                tuple((r.req_id, len(r.generated))
                      for r in self.slot_req if r is not None),
                tuple(int(p) for p in self.slot_pos),
                len(self.finished))

    def _raise_stuck(self, reason: str) -> None:
        stuck = sorted([r.req_id for r in self.slot_req if r is not None]
                       + [r.req_id for r in self.queue])
        raise RuntimeError(
            f"run_to_completion: {reason} with {self.active} active and "
            f"{len(self.queue)} waiting requests (req ids {stuck}); a "
            f"silent partial result is indistinguishable from a complete "
            f"one")

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> Dict[int, List[int]]:
        """Drain queue + slots; returns every finished request — including
        ones submitted after the call starts.  Raises RuntimeError if work
        remains after ``max_steps``, or as soon as two consecutive
        emit-less steps leave the engine state unchanged."""
        last_fp = None
        for _ in range(max_steps):
            if not self.queue and self.active == 0:
                break
            if self.step():
                last_fp = None
                continue
            fp = self._state_fingerprint()
            if fp == last_fp:
                self._raise_stuck("no step can make progress (every "
                                  "admissible slot is blocked)")
            last_fp = fp
        if self.queue or self.active:
            self._raise_stuck(f"step budget exhausted after {max_steps} "
                              f"steps; raise max_steps")
        return {rid: r.generated for rid, r in self.finished.items()}
