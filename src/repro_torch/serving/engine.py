"""Batched serving engine: continuous batching over a fixed-slot KV cache,
the port of the reference's ``repro/serving/engine.py``.

B cache slots are the "harts"; heterogeneous requests (different
lengths/phases) share one compute engine. Scheduler policy:

  * new requests are admitted into free slots (a slot's cache lines are
    invalidated first),
  * every engine step decodes ALL active slots in one batched decode
    step; a prompt enters token by token through that same step
    (prefill == teacher-forced decode), so one step function serves the
    whole engine,
  * finished sequences (EOS or max_tokens) free their slot immediately
    (continuous batching — no head-of-line blocking on long generations).

The step runs eagerly under ``torch.inference_mode()`` on the engine's
device (the card unless ``device="cpu"``); the sampler is greedy
(``argmax``, the first maximum on ties, as the reference's).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, Parallelism, ShapeConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import params as params_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.sharding import make_rules


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [len] int32
    max_new_tokens: int = 32
    eos_id: int = -1                   # -1 => never
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_seq: int = 512, rules=None, par=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.par = par or Parallelism(remat="none")
        self.rules = rules or make_rules(None, cfg, self.par)
        self.params = params_lib.tree_map(
            lambda x: x.to(self.device), params,
            is_leaf=lambda x: not isinstance(x, dict))
        self.slots = slots
        self.max_seq = max_seq
        shape = ShapeConfig("serve", "decode", max_seq, slots)
        self.shape = shape

        self._decode = steps_lib.make_decode_step(cfg, self.rules, self.par,
                                                  shape)
        self.cache = self._init_cache()
        # a slot starts after the meta tokens, prefilled once here
        self._meta = (steps_lib.meta_cache(self.params, cfg, self.rules,
                                           self.par, shape)
                      if cfg.meta_tokens else None)
        self.active: Dict[int, Request] = {}       # slot -> request
        self.queue: List[Request] = []
        self.slot_prompt_left: Dict[int, List[int]] = {}
        self._finished: List[Request] = []

    # ------------------------------------------------------------------
    def _init_cache(self):
        t = steps_lib.cache_template(self.cfg, self.shape)
        return params_lib.initialize(t, 0, device=self.device)

    def submit(self, req: Request):
        self.queue.append(req)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _reset_slot(self, s: int):
        """Invalidate a slot's cache lines before reuse (continuous
        batching: new request must not attend to stale entries)."""
        lc = self.cache["layers"]
        if self._meta is not None:
            for key, line in self._meta["layers"].items():
                lc[key][:, s] = line[:, 0]
            self.cache["pos"][s] = self._meta["pos"][0]
            return
        for key in lc:
            if key.startswith("cpos"):
                lc[key][:, s, :] = -1
        for key in ("conv", "state"):
            if key in lc:
                lc[key][:, s] = 0
        self.cache["pos"][s] = 0

    def _admit(self):
        free = [s for s in range(self.slots) if s not in self.active]
        while free and self.queue:
            s = free.pop(0)
            req = self.queue.pop(0)
            self._reset_slot(s)
            self.active[s] = req
            self.slot_prompt_left[s] = list(req.prompt)

    def step(self):
        """One engine step: feed each active slot its next token (prompt
        token during prefill phase, last sampled token during decode)."""
        self._admit()
        if not self.active:
            return False
        tokens = np.zeros((self.slots, 1), np.int32)
        for s, req in self.active.items():
            left = self.slot_prompt_left[s]
            if left:
                tokens[s, 0] = left.pop(0)
            else:
                tokens[s, 0] = req.out_tokens[-1] if req.out_tokens else 0
        logits, self.cache = self._decode(
            self.params, self.cache,
            {"tokens": torch.from_numpy(tokens).to(self.device)})
        next_tok = logits[:, -1].argmax(dim=-1).cpu().numpy()
        now = time.monotonic()
        done_slots = []
        for s, req in self.active.items():
            if self.slot_prompt_left[s]:
                continue                       # still prefill phase
            tok = int(next_tok[s])
            if req.first_token_at is None:
                req.first_token_at = now
            req.out_tokens.append(tok)
            if tok == req.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                req.done_at = now
                done_slots.append(s)
        for s in done_slots:
            self._finished.append(self.active.pop(s))
            self.slot_prompt_left.pop(s, None)
        return True

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self._finished

    @property
    def finished(self) -> List[Request]:
        return self._finished
