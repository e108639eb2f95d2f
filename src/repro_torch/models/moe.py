"""Mixture-of-Experts layer: the counterpart of ``repro.models.moe``.

GShard-style grouped top-k routing with capacity: each of the k rounds
takes every token's largest remaining gate (``argmax``: the first maximum
wins), places it at the expert's next free position in the group, and
drops it past ``capacity``; einsum dispatch and combine in
``dispatch_dtype``; the Switch/GShard load-balance aux loss; optional
always-on shared experts, fused into one wide MLP (Qwen2-MoE: 4 shared +
60 routed top-4; Llama4: 1 shared + 128 routed top-1).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    num_experts: int
    top_k: int
    expert_d_ff: int
    shared_experts: int = 0       # fused into one wide shared FFN
    group_size: int = 512         # routing group (GShard 'S')
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    dispatch_dtype: str = "float32"  # bfloat16 halves the dispatch bytes

    @property
    def capacity(self) -> int:
        return max(1, math.ceil(self.group_size * self.top_k
                                / self.num_experts * self.capacity_factor))


class Moe(nn.Module):
    """``router`` (d, E) f32, ``w_in`` (E, d, 2F), ``w_out`` (E, F, d), and
    with shared experts ``shared``, an :class:`~layers.Mlp` of width
    ``shared_experts * F``."""

    def __init__(self, cfg: MoeConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
        self.router = layers.new_param((d, e), torch.float32, device)
        self.w_in = layers.new_param((e, d, 2 * f), dtype, device)
        self.w_out = layers.new_param((e, f, d), dtype, device)
        if cfg.shared_experts:
            self.shared = layers.Mlp(d, cfg.shared_experts * f, dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        s_in = 1.0 / math.sqrt(self.cfg.d_model)
        s_out = 1.0 / math.sqrt(self.cfg.expert_d_ff)
        layers.fill_normal_(self.router, gen, s_in)
        # one expert at a time: no f32 copy of the whole expert stack
        for w_in, w_out in zip(self.w_in, self.w_out):
            layers.fill_normal_(w_in, gen, s_in)
            layers.fill_normal_(w_out, gen, s_out)
        if self.cfg.shared_experts:
            self.shared.init_(gen)


def moe_layer(p: Moe, x: torch.Tensor, cfg: MoeConfig):
    """x: (B, L, d) -> (y, aux_loss).

    Routing is done in groups of ``group_size`` tokens; each expert accepts
    at most ``capacity`` tokens per group (overflow dropped, as in GShard).
    """
    b, l, d = x.shape
    tokens = b * l
    # group size: prefer cfg.group_size; fall back to one group when the
    # token count doesn't divide (e.g. single-token decode batches)
    s = cfg.group_size if tokens % cfg.group_size == 0 else tokens
    g = tokens // s
    xg = x.reshape(g, s, d)
    e, k = cfg.num_experts, cfg.top_k
    c = max(1, math.ceil(s * k / e * cfg.capacity_factor))
    ddt = layers.dtype_of(cfg.dispatch_dtype)

    logits = xg.float() @ p.router                     # (g, s, e)
    probs = torch.softmax(logits, dim=-1)

    # top-k per token, sequential-greedy position assignment per expert
    dispatch = torch.zeros((g, s, e, c), dtype=ddt, device=x.device)
    combine = torch.zeros((g, s, e, c), dtype=ddt, device=x.device)
    gates_remaining = probs
    fill = torch.zeros((g, e), dtype=torch.int32, device=x.device)
    for _ in range(k):
        gate = gates_remaining.amax(dim=-1)            # (g, s)
        idx = gates_remaining.argmax(dim=-1)           # (g, s)
        onehot = F.one_hot(idx, e).to(torch.int32)     # (g, s, e)
        pos = fill[:, None, :] + torch.cumsum(onehot, dim=1,
                                              dtype=torch.int32) - onehot
        keep = (pos < c) & (onehot == 1)
        slot = torch.where(keep, pos, torch.full_like(pos, c))
        pos_c = F.one_hot(slot.long(), c + 1).to(ddt)[..., :c]
        d_k = onehot.to(ddt)[..., None] * pos_c
        dispatch = dispatch + d_k
        combine = combine + d_k * gate[..., None, None].to(ddt)
        fill = fill + onehot.sum(dim=1, dtype=torch.int32)
        gates_remaining = gates_remaining * (1 - onehot.float())

    # load-balance auxiliary loss (Switch/GShard form)
    me = probs.mean(dim=1)                             # (g, e)
    ce = dispatch.sum(dim=(1, 3)) / s                  # (g, e)
    aux = (me * ce).sum(dim=-1).mean() * e

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg.to(ddt))
    gate_up = torch.einsum("egcd,edf->egcf", expert_in.to(p.w_in.dtype),
                           p.w_in)
    gate_h, up_h = gate_up.chunk(2, dim=-1)
    h = F.silu(gate_h) * up_h
    expert_out = torch.einsum("egcf,efd->egcd", h, p.w_out)
    y = torch.einsum("gsec,egcd->gsd", combine, expert_out.to(ddt))
    y = y.reshape(b, l, d).to(x.dtype)
    if cfg.shared_experts:
        y = y + layers.mlp(p.shared, x)
    return y, aux
