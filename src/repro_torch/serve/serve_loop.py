"""LM serving: prefill / decode step builders, plus a small batched-request
engine (continuous-batching-lite), the counterpart of
``repro.serve.serve_loop``.

The engine gives every request its solo decode: each slot runs at its own
cursor (``decode_step`` with a (B,) ``cache_len``), and a refilled slot
starts from a zeroed SSM / conv state.  repro's engine shares one
``cache_len`` (the largest cursor) across the batch and never resets a
slot's state, so there a refilled request's tokens depend on the requests
that went before it in the same slot.

With a :class:`~repro_torch.launch.mesh.SlotMesh` the built steps take
the parameters placed on its slots by ``param_specs``
(``train_loop.place_state`` or :func:`place_params`) and the cache by
``cache_specs`` (:func:`place_cache`: the batch over the fsdp slots, or
the sequence where the batch is smaller than the shard count).  Each data
slot gathers the parameters and computes its rows (the batch stays whole
on the first where it does not split into whole MoE routing groups); the
cache is gathered for the step and cut again after it.  The outputs are
the single-device steps' (logits gathered on the first slot).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import SlotMesh
from repro_torch.models import model as M
from repro_torch.train import sharding as S


def _check_mesh(mesh, shape):
    if not isinstance(mesh, SlotMesh) or mesh.devices is None:
        raise TypeError(f"a mesh is a SlotMesh with devices, got {mesh!r}")
    if shape is None:
        raise ValueError("a mesh step needs the serving shape")


def place_params(cfg: ArchConfig, model: M.Lm, mesh) -> S.Sharded:
    """``model``'s parameters placed on ``mesh`` by ``param_specs``."""
    return S.place_named(cfg, mesh, S.mesh_param_specs(cfg, mesh), model)


def place_cache(cfg: ArchConfig, cache: dict, mesh,
                shape: ShapeConfig) -> S.Sharded:
    """A decode cache (``model.init_cache``) placed on ``mesh`` by
    ``cache_specs``."""
    return S.Sharded.place(mesh, S.cache_specs(cfg, shape, mesh), cache)


def _rows(n: int, i: int, b: int) -> slice:
    return slice(i * b // n, (i + 1) * b // n)


def build_decode_step(cfg: ArchConfig, mesh=None,
                      shape: ShapeConfig | None = None) -> Callable:
    """decode_step(model, cache, tokens, cache_len) -> (logits, cache); the
    cache is updated in place.  With ``mesh``: decode_step(params, cache,
    ...) over the placed parameters and cache."""
    if mesh is None:
        @torch.inference_mode()
        def step(model, cache, tokens, cache_len):
            return M.decode_step(cfg, model, cache, tokens, cache_len)

        return step

    _check_mesh(mesh, shape)
    replicas = S.Replicas(cfg, mesh)
    home = mesh.first()

    @torch.inference_mode()
    def mesh_step(params: S.Sharded, cache: S.Sharded, tokens, cache_len):
        full = cache.gather_all(home)
        b = tokens.shape[0]
        batch_axis = next(iter(cache.specs.values()))[1]
        n = replicas.split(batch_axis, b, tokens.shape[1])
        per_row = isinstance(cache_len, torch.Tensor) and cache_len.dim() > 0
        logits = []
        for i in range(n):
            rows = _rows(n, i, b)
            model = replicas.load(i, params)
            dev = model.device
            local = {k: v[:, rows].to(dev, copy=True)
                     for k, v in full.items()}
            lg, local = M.decode_step(
                cfg, model, local, tokens[rows].to(dev),
                cache_len[rows] if per_row else cache_len)
            for k, v in local.items():
                full[k][:, rows] = v.to(home)
            logits.append(lg.to(home))
        for k, v in full.items():
            cache.assign(k, v)
        return torch.cat(logits), cache

    return mesh_step


def build_prefill(cfg: ArchConfig, mesh=None,
                  shape: ShapeConfig | None = None) -> Callable:
    """prefill(model, tokens) -> last-position logits; with ``mesh``:
    prefill(params, tokens) over the placed parameters."""
    if mesh is None:
        @torch.inference_mode()
        def step(model, tokens):
            return M.prefill(cfg, model, tokens, max_seq=tokens.shape[1])

        return step

    _check_mesh(mesh, shape)
    replicas = S.Replicas(cfg, mesh)
    batch_axis = S.batch_specs(cfg, shape, mesh)["tokens"][0]

    @torch.inference_mode()
    def mesh_step(params: S.Sharded, tokens):
        b, l = tokens.shape
        n = replicas.split(batch_axis, b, l)
        out = []
        for i in range(n):
            model = replicas.load(i, params)
            out.append(M.prefill(cfg, model,
                                 tokens[_rows(n, i, b)].to(model.device),
                                 max_seq=l).to(mesh.first()))
        return torch.cat(out)

    return mesh_step


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
