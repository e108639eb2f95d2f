"""AdamW with gradient clipping, and int8 stochastic-rounding gradient
compression with error feedback: the counterpart of
``repro.train.optimizer``.

The optimizer state is ``{"mu": {name: tensor}, "nu": {name: tensor},
"step": int32 tensor}``, moments keyed by parameter name on the
parameters' device in ``moment_dtype``.  :func:`adamw_update` updates the
parameters and the state in place (the counterpart of repro's donated
buffers), with repro's arithmetic in repro's order: f32 math, the clip
scale, bias correction at ``step`` as f32, the result stored in the
parameter's dtype.  Every scalar stays a device tensor, so a step reads
nothing back to the host.

Weight decay applies to matrices only, as repro's comment says: a
parameter whose own (unstacked) rank is at least 2.  repro tests the rank
of its *stacked* leaf (``p.ndim >= 2``), so there every per-layer vector
(norm scales, ``A_log``, ``D``, ``dt_bias``) decays too, while the same
vectors outside the layer stack (``final_norm``, the hybrid's
``shared_attn``) do not.

``compressed_psum`` is repro's int8 all-reduce over a list of per-slot
gradient dicts (a device group, as ``core/distributed`` drives one): the
shared scale is the largest absmax over the slots (repro's ``pmax``), the
quantized values are summed in int32 (``psum``), and each slot keeps its
own quantization residual for the next step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from repro_torch.models.convert import named_params
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # moment dtype: float32 for fidelity; bfloat16 halves optimizer memory
    moment_dtype: str = "float32"


def init_opt_state(model, cfg: AdamWConfig) -> dict:
    """Zero moments for every parameter of ``model`` (an ``Lm`` or
    ``{name: tensor}``), on its device, and step 0."""
    dt = dtype_of(cfg.moment_dtype)
    named = named_params(model)
    device = next(iter(named.values())).device
    return {
        "mu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in named.items()},
        "nu": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
               for k, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@dataclasses.dataclass(frozen=True)
class StepScalars:
    """The step's f32 device scalars shared by every leaf's update."""
    scale: torch.Tensor   # the clip scale
    lr: torch.Tensor
    bc1: torch.Tensor     # 1 - b1 ** step
    bc2: torch.Tensor     # 1 - b2 ** step

    def to(self, device) -> "StepScalars":
        return StepScalars(*(t.to(device) for t in dataclasses.astuple(self)))


def step_scalars(cfg: AdamWConfig, step: torch.Tensor,
                 gnorm: torch.Tensor) -> StepScalars:
    """The scalars of the update at ``step`` (already incremented) for a
    global gradient norm ``gnorm``."""
    stepf = step.float()
    return StepScalars(
        scale=torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                          max=1.0),
        lr=_schedule(cfg, step),
        bc1=1 - cfg.b1 ** stepf,
        bc2=1 - cfg.b2 ** stepf)


@torch.no_grad()
def update_leaf(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                nu: torch.Tensor, s: StepScalars, cfg: AdamWConfig,
                decay: bool) -> None:
    """One leaf's AdamW update, in place (``decay``: decoupled weight
    decay on this leaf)."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * s.scale
    mu_new = b1 * mu.float() + (1 - b1) * g
    nu_new = b2 * nu.float() + (1 - b2) * g * g
    delta = (mu_new / s.bc1) / (torch.sqrt(nu_new / s.bc2) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    p.copy_(p.float() - s.lr * delta)
    mu.copy_(mu_new)
    nu.copy_(nu_new)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig) -> dict:
    """Update ``params`` (an ``Lm`` or ``{name: tensor}``) and ``state``
    in place with ``grads`` (``{name: tensor}``); returns ``{"grad_norm",
    "lr"}`` as device scalars.  Decay on parameters of rank >= 2."""
    named = named_params(params)
    state["step"] += 1
    gnorm = global_norm(grads[k] for k in named)
    s = step_scalars(cfg, state["step"], gnorm)
    for k, p in named.items():
        update_leaf(p, grads[k], state["mu"][k], state["nu"][k], s, cfg,
                    decay=p.ndim >= 2)
    return {"grad_norm": gnorm, "lr": s.lr}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback (explicit data parallelism)
# ---------------------------------------------------------------------------


def _noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Uniform [-0.5, 0.5) noise of ``x``'s shape, drawn on the
    generator's device."""
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    return (u - 0.5).to(x.device)


def quantize_int8(x: torch.Tensor, generator: torch.Generator):
    """Stochastic-rounding symmetric int8 quantization: (q, scale)."""
    absmax = torch.clamp(x.abs().max(), min=1e-12)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale + _noise(x, generator)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compressed_psum(grads_per_slot: list, generator: torch.Generator,
                    errors: list | None = None):
    """int8-quantized all-reduce with error feedback over slots.

    ``grads_per_slot``: one ``{name: tensor}`` a slot (each on its slot's
    device); ``errors``: the residuals a previous call returned, or None.
    Each leaf adds its carried error in f32, is quantized with the scale
    shared by all slots (max absmax / 127) and noise drawn from
    ``generator`` (per leaf in the dicts' order, per slot in order), and
    the int8 values are summed in int32.  Returns (reduced, new_errors),
    one dict a slot each: the sum dequantized in the gradient's dtype on
    every slot, and each slot's residual ``xf - q * scale``."""
    n = len(grads_per_slot)
    home = next(iter(grads_per_slot[0].values())).device
    reduced: list = [{} for _ in range(n)]
    new_errs: list = [{} for _ in range(n)]
    for name in grads_per_slot[0]:
        xs = [g[name].float() + (errors[i][name] if errors is not None
                                 else 0.0)
              for i, g in enumerate(grads_per_slot)]
        absmax = torch.stack([torch.clamp(x.abs().max(), min=1e-12).to(home)
                              for x in xs]).max()
        scale = absmax / 127.0
        total = None
        for i, x in enumerate(xs):
            sc = scale.to(x.device)
            q = torch.clamp(torch.round(x / sc + _noise(x, generator)),
                            -127, 127)
            new_errs[i][name] = x - q * sc
            q32 = q.to(torch.int32).to(home)
            total = q32 if total is None else total + q32
        for i, g in enumerate(grads_per_slot):
            out = total.to(g[name].device).float() * scale.to(g[name].device)
            reduced[i][name] = out.to(g[name].dtype)
    return reduced, new_errs
