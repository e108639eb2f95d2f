"""LM serving: prefill / decode step builders, plus a small batched-request
engine (continuous-batching-lite), the counterpart of
``repro.serve.serve_loop``.

The engine gives every request its solo decode: each slot runs at its own
cursor (``decode_step`` with a (B,) ``cache_len``), and a refilled slot
starts from a zeroed SSM / conv state.  repro's engine shares one
``cache_len`` (the largest cursor) across the batch and never resets a
slot's state, so there a refilled request's tokens depend on the requests
that went before it in the same slot.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import model as M

_MESH_SLICE = ("serving over a mesh needs train/sharding.py, which comes "
               "with the training slice (ROADMAP queue 1 step 10b)")


def build_decode_step(cfg: ArchConfig, mesh=None,
                      shape: ShapeConfig | None = None) -> Callable:
    """decode_step(model, cache, tokens, cache_len) -> (logits, cache); the
    cache is updated in place.  ``mesh=None`` only."""
    if mesh is not None:
        raise NotImplementedError(_MESH_SLICE)

    @torch.inference_mode()
    def step(model, cache, tokens, cache_len):
        return M.decode_step(cfg, model, cache, tokens, cache_len)

    return step


def build_prefill(cfg: ArchConfig, mesh=None,
                  shape: ShapeConfig | None = None) -> Callable:
    """prefill(model, tokens) -> last-position logits.  ``mesh=None``
    only."""
    if mesh is not None:
        raise NotImplementedError(_MESH_SLICE)

    @torch.inference_mode()
    def step(model, tokens):
        return M.prefill(cfg, model, tokens, max_seq=tokens.shape[1])

    return step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray         # (len,) int32
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class BatchEngine:
    """Minimal continuous-batching engine: fixed-slot decode batch; finished
    slots are refilled from the queue; prompts are absorbed one token at a
    time through the decode path (cached prefill).  Runs on the device of
    ``model``'s parameters."""

    def __init__(self, cfg: ArchConfig, model: M.Lm, *, slots: int = 4,
                 max_seq: int = 256, eos: int = 1):
        self.cfg, self.model = cfg, model
        self.slots, self.max_seq, self.eos = slots, max_seq, eos
        self.device = model.device
        self.cache = M.init_cache(cfg, slots, max_seq, self.device)
        self.decode = build_decode_step(cfg)
        self.active: list[Request | None] = [None] * slots
        self.cursor = np.zeros(slots, np.int32)   # per-slot fill position
        self.pending: list[Request] = []
        self.ticks = 0

    def submit(self, req: Request):
        self.pending.append(req)

    def _admit(self):
        for i in range(self.slots):
            if self.active[i] is None and self.pending:
                self.active[i] = self.pending.pop(0)
                self.cursor[i] = 0
                # a slot reads only the K/V positions it has written since
                # admission (below its cursor + 1), so its K/V rows need no
                # zeroing; the recurrent state carries over and must
                for key in ("ssm", "conv"):
                    if key in self.cache:
                        self.cache[key][:, i].zero_()

    def step(self):
        """One engine tick: each active slot advances one token (prompt
        absorption or generation) at its own cursor; one host read of the
        argmax a tick."""
        self._admit()
        tokens = np.zeros((self.slots, 1), np.int32)
        for i, req in enumerate(self.active):
            if req is None:
                continue
            pos = int(self.cursor[i])
            if pos < len(req.prompt):
                tokens[i, 0] = req.prompt[pos]
            elif req.generated:
                tokens[i, 0] = req.generated[-1]
        logits, self.cache = self.decode(
            self.model, self.cache,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.cursor).to(self.device))
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        self.ticks += 1
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.cursor[i] += 1
            pos = int(self.cursor[i])
            if pos >= len(req.prompt):
                req.generated.append(int(nxt[i]))
                if (int(nxt[i]) == self.eos
                        or len(req.generated) >= req.max_new
                        or pos >= self.max_seq - 1):
                    req.done = True
                    self.active[i] = None
        return [req for req in self.active if req]

    def run_until_done(self, max_ticks: int = 10_000) -> list[Request]:
        all_reqs = list(self.pending)
        for _ in range(max_ticks):
            if not self.pending and all(a is None for a in self.active):
                break
            self.step()
        return all_reqs
