"""The training step and the fault-tolerant training loop: the
counterpart of ``repro.train.train_loop``.

``build_train_step`` returns ``step(model, opt_state, batch) -> metrics``
(``loss``, ``grad_norm``, ``lr`` as device scalars) that updates the
model and the optimizer state in place (repro donates them), with
gradient-accumulation microbatching: the batch is split on axis 0, f32
gradients are summed over the microbatches and divided by their count.
Gradients are turned on for the step alone (the ``Lm``'s parameters are
made with ``requires_grad=False`` for serving); ``cfg.remat`` picks the
recomputation (``models/model.py``).

With a :class:`~repro_torch.launch.mesh.SlotMesh` the step takes the
state placed on the slots (:func:`place_state`): parameters and moments
are stored cut by repro's specs (ZeRO-3 style), gathered onto each data
slot for its compute, the batch split over the fsdp slots by
``batch_specs``, the gradients summed over the slots, cut again, and
AdamW run on every slot's piece.  The step computes the single-device
step's function: each shard's loss terms carry the global token count
(a mean over tokens is the shards' sums over the global count, not a
mean of shard means), and the batch is split only where every shard
holds whole MoE routing groups (else each data slot would route other
groups; then it stays whole, as repro's ``batch_specs`` keeps a batch
that does not divide).  The ``model`` axis divides storage, not compute.

``train`` adds the production posture: checkpoints with atomic rename
every ``checkpoint_every`` steps, resume from the latest, deterministic
data (step -> batch), and a straggler monitor (step-time EWMA).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train import sharding as S


@contextlib.contextmanager
def _trainable(model: M.Lm):
    params = list(model.parameters())
    try:
        for p in params:
            p.requires_grad_(True)
        yield params
    finally:
        for p in params:
            p.requires_grad_(False)


def to_batch(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _grads(cfg: ArchConfig, model: M.Lm, batch: dict, loss_of=None):
    """(loss, {name: grad}) of ``loss_of(model, batch)`` (loss_fn's
    loss by default)."""
    names = [k for k, _ in model.named_parameters()]
    with torch.enable_grad(), _trainable(model) as params:
        if loss_of is None:
            loss = M.loss_fn(cfg, model, batch)[0]
        else:
            loss = loss_of(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for k, p, g in zip(names, params, grads)}


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def build_train_step(cfg: ArchConfig, opt_cfg: O.AdamWConfig, mesh=None,
                     shape: ShapeConfig | None = None,
                     microbatches: int = 1) -> Callable:
    """Returns ``step(model, opt_state, batch) -> metrics``, updating in
    place; with ``mesh``, ``step(params, opt_state, batch)`` over the
    state :func:`place_state` placed on it."""
    if mesh is not None:
        return _MeshStep(cfg, opt_cfg, mesh, shape, microbatches)

    def step(model: M.Lm, opt_state: dict, batch: dict) -> dict:
        batch = to_batch(batch, model.device)
        if microbatches > 1:
            n = next(iter(batch.values())).shape[0] // microbatches
            acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for k, p in model.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for m in range(microbatches):
                lm, g = _grads(cfg, model, _rows(batch, m * n, (m + 1) * n))
                for k, a in acc.items():
                    a += g[k]
                del g
                loss = loss + lm
            grads = {k: a / microbatches for k, a in acc.items()}
            del acc
            loss = loss / microbatches
        else:
            loss, grads = _grads(cfg, model, batch)
        om = O.adamw_update(model, grads, opt_state, opt_cfg)
        return {"loss": loss, **om}

    return step


# ------------------------------------------------------------- slot mesh --
def place_state(cfg: ArchConfig, model: M.Lm, opt_state: dict, mesh):
    """The single-device state placed on ``mesh`` by repro's specs:
    (params, opt_state) with ``Sharded`` parameters and moments and the
    step on the mesh's first slot."""
    specs = S.mesh_param_specs(cfg, mesh)
    params = S.place_named(cfg, mesh, specs, model)
    opt = {"mu": S.place_named(cfg, mesh, specs, opt_state["mu"]),
           "nu": S.place_named(cfg, mesh, specs, opt_state["nu"]),
           "step": opt_state["step"].to(mesh.first(), copy=True)}
    return params, opt


def gather_state(cfg: ArchConfig, params: S.Sharded, opt_state: dict,
                 device):
    """The placed state gathered back into a single-device ``Lm`` and
    optimizer state on ``device``."""
    model = M.Lm(cfg, device)
    convert.load_flat(convert.named_params(model),
                      S.gather_named(cfg, params, device))
    opt = {k: S.gather_named(cfg, opt_state[k], device) for k in ("mu", "nu")}
    opt["step"] = opt_state["step"].to(device, copy=True)
    return model, opt


class _MeshStep:
    """The slot-mesh train step (see the module docstring)."""

    def __init__(self, cfg, opt_cfg, mesh, shape, microbatches):
        if shape is None:
            raise ValueError("a mesh train step needs the batch's shape")
        self.cfg, self.opt_cfg, self.mesh = cfg, opt_cfg, mesh
        self.microbatches = microbatches
        self.batch_axis = S.batch_specs(cfg, shape, mesh)["tokens"][0]
        self.replicas = S.Replicas(cfg, mesh)

    def __call__(self, params: S.Sharded, opt_state: dict,
                 batch: dict) -> dict:
        cfg, mb = self.cfg, self.microbatches
        home = self.mesh.first()
        batch = to_batch(batch, "cpu")
        rows = next(iter(batch.values())).shape[0] // mb
        n = self.replicas.split(self.batch_axis, rows,
                                _seq_len(cfg, batch))
        models = [self.replicas.load(i, params) for i in range(n)]
        acc: dict = {}
        loss = torch.zeros((), dtype=torch.float32, device=home)
        for m in range(mb):
            part = _rows(batch, m * rows, (m + 1) * rows)
            tokens = _count(part)
            for i, model in enumerate(models):
                lo, hi = i * rows // n, (i + 1) * rows // n
                shard = to_batch(_rows(part, lo, hi), model.device)
                frac_rows = (hi - lo) / rows

                def partial(mdl, b, frac_rows=frac_rows):
                    _, parts = M.loss_fn(cfg, mdl, b)
                    return (parts["ce"] * (_count(b) / tokens)
                            + M.AUX_WEIGHT * parts["aux"] * frac_rows)

                lp, g = _grads(cfg, model, shard, partial)
                loss = loss + lp.to(home)
                tree = S.flatten(convert.jax_tree_from(cfg, g,
                                                       leaf=lambda t: t))
                for k, v in tree.items():
                    v = v.to(home, torch.float32)
                    acc[k] = v if k not in acc else acc[k] + v
        dtypes = {k: params.pieces[k].flat[0].dtype for k in acc}
        grads = {k: (a / mb if mb > 1 else a.to(dtypes[k]))
                 for k, a in acc.items()}
        return self.update(params, opt_state, grads, loss / mb)

    @torch.no_grad()
    def update(self, params, opt_state, grads, loss) -> dict:
        """Cut the summed gradients by the specs and run AdamW on every
        slot's piece."""
        opt_state["step"] += 1
        gnorm = O.global_norm(grads.values())
        s = O.step_scalars(self.opt_cfg, opt_state["step"], gnorm)
        for k, g in grads.items():
            base = g.ndim - S.stack_dims(k)
            pieces = S.shard(g, params.specs[k], self.mesh)
            for c, gp in np.ndenumerate(pieces):
                O.update_leaf(params.pieces[k][c], gp,
                              opt_state["mu"].pieces[k][c],
                              opt_state["nu"].pieces[k][c],
                              s.to(gp.device), self.opt_cfg,
                              decay=base >= 2)
        return {"loss": loss, "grad_norm": gnorm, "lr": s.lr}


def _count(batch: dict):
    """The token positions a batch's loss averages over: the mask's sum
    (at least 1), or rows x (text length - 1)."""
    if "mask" in batch:
        return max(float(batch["mask"].sum()), 1.0)
    t = batch["targets"]
    return t.shape[0] * (t.shape[1] - 1)


def _seq_len(cfg: ArchConfig, batch: dict) -> int:
    """Positions a row of ``batch`` feeds the model (prefix included)."""
    if cfg.modality == "embeds":
        return batch["embeds"].shape[1]
    extra = cfg.prefix_len if cfg.modality == "prefix" else 0
    return batch["tokens"].shape[1] + extra


# ---------------------------------------------------------------------------
# Fault-tolerant loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor: flags steps slower than ``threshold`` x the
    running mean; here it records events for tests and logs."""

    alpha: float = 0.1
    threshold: float = 3.0
    ewma: float | None = None
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        flagged = False
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.events.append((step, dt, self.ewma))
            flagged = True
        self.ewma = dt if self.ewma is None else (
            self.alpha * dt + (1 - self.alpha) * self.ewma)
        return flagged


def train(
    cfg: ArchConfig,
    *,
    steps: int,
    batch_fn: Callable[[int], dict],
    opt_cfg: O.AdamWConfig | None = None,
    mesh=None,
    shape: ShapeConfig | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 100,
    microbatches: int = 1,
    seed: int = 0,
    log_every: int = 10,
    device=None,
) -> dict:
    """Run training; resumes from the latest checkpoint if one exists.

    Weights are drawn from ``seed`` on ``device`` (the CUDA device when
    None; with a mesh, its first slot) and placed on the mesh after any
    restore.  A checkpoint is written every ``checkpoint_every`` steps and
    at the end (once, where the last step already wrote it).  Returns
    ``params`` (an ``Lm``, or ``Sharded`` on a mesh), ``opt_state``,
    ``history`` (step, loss, grad_norm, time_s every ``log_every`` steps
    and at the last), ``straggler_events``, ``start_step``, and the
    seconds of each save (``save_s``) and of the restore (``restore_s``).
    """
    from repro_torch.core.blest import resolve_device
    from repro_torch.train import checkpoint as C

    opt_cfg = opt_cfg or O.AdamWConfig()
    device = resolve_device(device) if mesh is None else mesh.first()
    params = M.init_params(cfg, seed=seed, device=device)
    opt_state = O.init_opt_state(params, opt_cfg)
    start_step, restore_s = 0, None
    if checkpoint_dir:
        t0 = time.perf_counter()
        restored = C.restore_latest(checkpoint_dir, (params, opt_state))
        if restored is not None:
            (params, opt_state), start_step = restored
            restore_s = time.perf_counter() - t0
    if mesh is not None:
        params, opt_state = place_state(cfg, params, opt_state, mesh)

    step_fn = build_train_step(cfg, opt_cfg, mesh=mesh, shape=shape,
                               microbatches=microbatches)
    monitor = StragglerMonitor()
    history, save_s = [], []
    saved = start_step if restore_s is not None else None

    def save(at: int):
        t0 = time.perf_counter()
        C.save(checkpoint_dir, (params, opt_state), at)
        save_s.append(time.perf_counter() - t0)

    for step in range(start_step, steps):
        batch = batch_fn(step)
        t0 = time.perf_counter()
        metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        monitor.observe(step, dt)
        if step % log_every == 0 or step == steps - 1:
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "time_s": dt})
        if checkpoint_dir and (step + 1) % checkpoint_every == 0:
            save(step + 1)
            saved = step + 1
    if checkpoint_dir and saved != steps:
        save(steps)
    return {"params": params, "opt_state": opt_state, "history": history,
            "straggler_events": monitor.events, "start_step": start_step,
            "save_s": save_s, "restore_s": restore_s}
