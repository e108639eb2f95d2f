"""Unified model: init / forward / prefill / decode for every assigned
architecture family (dense, moe, ssm, hybrid, audio-stub, vlm-stub), the
counterpart of ``repro.models.model``.

The model is an :class:`Lm` module: ``embed`` (vocab, d), ``final_norm``
(d,), ``layers``, a ``ModuleList`` in execution order, and for the hybrid
``shared_attn``, the one block it reuses.  Where repro stacks a leaf per
layer for ``lax.scan``, the port holds one module per layer; the names
below a layer are repro's tree paths (``attn.wq``, ``moe.shared.w_up``,
``mamba.A_log``, ...).  llama4's interleaved superblocks are laid out
flat: superblock ``s`` holds layers ``s * moe_every + j``, its
``moe_every - 1`` dense sub-layers and then its MoE one, which is also
each sub-layer's KV-cache index.  The softmax head is tied to the
embedding.  The functions keep repro's names and take the module where
repro takes the tree.

Modality stubs (the frontend is a stub):
  * audio (``embeds``): forward consumes precomputed frame embeddings
    (B, L, d) and EnCodec-token targets;
  * vlm (``prefix``): a patch-embedding prefix (B, prefix_len, d) is
    concatenated in front of the text-token embeddings; the loss skips the
    prefix positions.

``cfg.remat`` applies where gradients are recorded (training): ``"none"``
runs the layers as they are, ``"full"`` recomputes each layer in the
backward pass (``torch.utils.checkpoint``, non-reentrant), ``"dots"``
keeps the products with no batch dims (``aten.mm`` / ``addmm``, the
weight products) and recomputes the rest, repro's
``dots_with_no_batch_dims_saveable``.  Each dense sub-layer (llama4's
too, as repro's scan body) and each SSM layer together with the hybrid's
shared block after it is one unit.  Serving (no grad) ignores it.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE

DENSE_FAMILIES = ("dense", "moe", "audio", "vlm")
AUX_WEIGHT = 0.01  # the MoE load-balance loss's weight in loss_fn


def _attn_cfg(cfg: ArchConfig) -> L.AttentionConfig:
    return L.AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)


def _moe_cfg(cfg: ArchConfig) -> MOE.MoeConfig:
    m = cfg.moe
    return MOE.MoeConfig(
        d_model=cfg.d_model, num_experts=m.num_experts, top_k=m.top_k,
        expert_d_ff=m.expert_d_ff, shared_experts=m.shared_experts,
        group_size=m.group_size, capacity_factor=m.capacity_factor,
        dispatch_dtype=m.dispatch_dtype)


def _ssm_cfg(cfg: ArchConfig) -> M2.Mamba2Config:
    s = cfg.ssm
    return M2.Mamba2Config(
        d_model=cfg.d_model, d_state=s.d_state, head_dim=s.head_dim,
        expand=s.expand, conv_width=s.conv_width, chunk=s.chunk)


# --------------------------------------------------------------- modules ---
class DenseSub(nn.Module):
    """One transformer sub-layer: ``attn_norm``, ``attn``, ``mlp_norm`` and
    either ``mlp`` (width ``d_ff``) or ``moe``."""

    def __init__(self, cfg: ArchConfig, *, d_ff: int | None = None,
                 moe: bool = False, device=None):
        super().__init__()
        dt = L.dtype_of(cfg.dtype)
        f32 = torch.float32
        self.attn_norm = L.new_param((cfg.d_model,), f32, device)
        self.mlp_norm = L.new_param((cfg.d_model,), f32, device)
        self.attn = L.Attention(_attn_cfg(cfg), dt, device)
        if moe:
            self.moe = MOE.Moe(_moe_cfg(cfg), dt, device)
        else:
            self.mlp = L.Mlp(cfg.d_model, d_ff, dt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.attn_norm.fill_(1.0)
        self.mlp_norm.fill_(1.0)
        self.attn.init_(gen)
        (self.moe if hasattr(self, "moe") else self.mlp).init_(gen)


class MambaLayer(nn.Module):
    """One SSM layer: ``norm`` and ``mamba``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.norm = L.new_param((cfg.d_model,), torch.float32, device)
        self.mamba = M2.Mamba2(_ssm_cfg(cfg), L.dtype_of(cfg.dtype), device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.norm.fill_(1.0)
        self.mamba.init_(gen)


class Lm(nn.Module):
    """The parameters of one architecture, allocated (uninitialised) on
    ``device``; :func:`init_params` draws them, ``convert.params_from_jax``
    loads repro's."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        if cfg.family not in DENSE_FAMILIES + ("ssm", "hybrid"):
            raise ValueError(cfg.family)
        self.cfg = cfg
        self.embed = L.new_param((cfg.vocab, cfg.d_model),
                                 L.dtype_of(cfg.dtype), device)
        self.final_norm = L.new_param((cfg.d_model,), torch.float32, device)
        subs: list[nn.Module] = []
        if cfg.family in DENSE_FAMILIES:
            if cfg.moe is None:
                subs = [DenseSub(cfg, d_ff=cfg.d_ff, device=device)
                        for _ in range(cfg.n_layers)]
            elif cfg.moe_every == 1:
                subs = [DenseSub(cfg, moe=True, device=device)
                        for _ in range(cfg.n_layers)]
            else:
                # interleaved MoE (llama4): superblocks of (moe_every - 1)
                # dense sub-layers followed by one MoE sub-layer
                d_ff_dense = cfg.dense_d_ff or 2 * cfg.moe.expert_d_ff
                for _ in range(cfg.n_layers // cfg.moe_every):
                    subs += [DenseSub(cfg, d_ff=d_ff_dense, device=device)
                             for _ in range(cfg.moe_every - 1)]
                    subs.append(DenseSub(cfg, moe=True, device=device))
        else:
            subs = [MambaLayer(cfg, device) for _ in range(cfg.n_layers)]
            if cfg.family == "hybrid":
                self.shared_attn = DenseSub(cfg, d_ff=cfg.d_ff, device=device)
        self.layers = nn.ModuleList(subs)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ----------------------------------------------------------------- init ----
@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Lm:
    """Random weights with repro's distributions and scales, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, one parameter at
    a time in f32 and cast, so a full-size model never needs a full f32
    copy.  ``device=None`` means the CUDA device."""
    from repro_torch.core.blest import resolve_device

    device = resolve_device(device)
    model = Lm(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L.fill_normal_(model.embed, gen, 0.02)
    model.final_norm.fill_(1.0)
    for sub in model.layers:
        sub.init_(gen)
    if cfg.family == "hybrid":
        model.shared_attn.init_(gen)
    return model


# -------------------------------------------------------------- forward ----
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, fn):
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _dense_layer(cfg: ArchConfig, p: DenseSub, x, positions):
    out, _ = L.attention(p.attn, L.rms_norm(x, p.attn_norm), p.attn.cfg,
                         positions=positions, block_k=cfg.attn_block_k)
    x = x + out
    h = L.rms_norm(x, p.mlp_norm)
    if hasattr(p, "moe"):
        y, aux = MOE.moe_layer(p.moe, h, p.moe.cfg)
    else:
        y, aux = L.mlp(p.mlp, h), 0.0
    return x + y, aux


def _hybrid_shared_block(cfg: ArchConfig, p: DenseSub, x, positions):
    out, _ = L.attention(p.attn, L.rms_norm(x, p.attn_norm), p.attn.cfg,
                         positions=positions, block_k=cfg.attn_block_k)
    x = x + out
    return x + L.mlp(p.mlp, L.rms_norm(x, p.mlp_norm))


def _applies_attn(cfg: ArchConfig, idx: int) -> bool:
    return (cfg.family == "hybrid"
            and idx % cfg.attn_every == cfg.attn_every - 1)


def forward(cfg: ArchConfig, model: Lm, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None):
    """Full-sequence forward.  Returns (logits, moe_aux_loss).

    * text / moe / dense: ``tokens`` (B, L)
    * audio stub: ``embeds`` (B, L, d): logits over the EnCodec vocab
    * vlm stub: ``tokens`` (B, L_txt) + ``embeds`` (B, prefix_len, d)
    """
    dt = L.dtype_of(cfg.dtype)
    if cfg.modality == "embeds":
        x = embeds.to(dt)
    elif cfg.modality == "prefix":
        tok_x = L.embed(model.embed, tokens)
        x = torch.cat([embeds.to(tok_x.dtype), tok_x], dim=1)
    else:
        x = L.embed(model.embed, tokens)
    b, l, _ = x.shape
    positions = torch.arange(l, device=x.device)[None].expand(b, l)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family in DENSE_FAMILIES:
        body = _remat(cfg, lambda x, p: _dense_layer(cfg, p, x, positions))
        for p in model.layers:
            x, a = body(x, p)
            aux = aux + a
    else:  # ssm / hybrid
        ssm_cfg = _ssm_cfg(cfg)

        def one_layer(x, idx):
            p = model.layers[idx]
            h, _ = M2.mamba2_block(p.mamba, L.rms_norm(x, p.norm), ssm_cfg)
            x = x + h
            if _applies_attn(cfg, idx):
                x = _hybrid_shared_block(cfg, model.shared_attn, x, positions)
            return x

        body = _remat(cfg, one_layer)
        for idx in range(len(model.layers)):
            x = body(x, idx)

    x = L.rms_norm(x, model.final_norm)
    return L.unembed(model.embed, x), aux


def loss_fn(cfg: ArchConfig, model: Lm, batch: dict,
            aux_weight: float = AUX_WEIGHT):
    """Next-token CE over token positions (prefix / embeds positions per
    modality rules).  batch keys: tokens and/or embeds, targets, [mask].
    Returns (loss, {"ce", "aux"}); differentiable."""
    logits, aux = forward(cfg, model, batch.get("tokens"),
                          batch.get("embeds"))
    targets = batch["targets"]
    if cfg.modality == "prefix":
        logits = logits[:, cfg.prefix_len:]
    # shift: predict t+1 from <=t
    ce = L.cross_entropy(logits[:, :-1], targets[:, 1:], batch.get("mask"))
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------- decode ---
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """Static-shape decode state for all families, on ``device`` (the CUDA
    device when None)."""
    from repro_torch.core.blest import resolve_device

    device = resolve_device(device)
    kdt = L.dtype_of(cfg.kv_cache_dtype)

    def kv(n):
        return torch.zeros((n, batch, max_seq, cfg.n_kv, cfg.hd), dtype=kdt,
                           device=device)

    if cfg.family in DENSE_FAMILIES:
        return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers)}
    ssm = _ssm_cfg(cfg)
    cache = {
        "ssm": torch.zeros((cfg.n_layers, batch, ssm.n_heads, ssm.head_dim,
                            ssm.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, ssm.conv_width - 1,
                             ssm.d_inner + 2 * ssm.d_state),
                            dtype=torch.float32, device=device),
    }
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.attn_every
        cache["k"] = kv(n_apps)
        cache["v"] = kv(n_apps)
    return cache


def _attn_decode(p: DenseSub, x, positions, ck, cv, cache_len, block_k):
    out, _ = L.attention(p.attn, L.rms_norm(x, p.attn_norm), p.attn.cfg,
                         positions=positions, kv_cache=(ck, cv),
                         cache_len=cache_len, block_k=block_k)
    return x + out


def decode_step(cfg: ArchConfig, model: Lm, cache: dict,
                tokens: torch.Tensor, cache_len):
    """One-token decode with a static KV / state cache.

    tokens: (B, 1) int; cache_len: an int, repro's one filled length for
    the whole batch (then any l), or a (B,) tensor of per-row lengths (one
    token a row): each row is roped at its own position, writes its K/V at
    its own offset and attends below its own ``cache_len + 1``.  The cache
    is updated in place.  Returns (logits (B, l, vocab) f32, cache).
    """
    x = L.embed(model.embed, tokens)
    b, l, _ = x.shape
    steps = torch.arange(l, device=x.device)
    if isinstance(cache_len, torch.Tensor) and cache_len.dim() > 0:
        cache_len = cache_len.to(device=x.device, dtype=torch.int64)
        positions = cache_len[:, None] + steps[None]
    else:
        cache_len = int(cache_len)
        positions = (cache_len + steps)[None].expand(b, l)
    block_k = cfg.attn_block_k

    if cfg.family in DENSE_FAMILIES:
        for i, p in enumerate(model.layers):
            x = _attn_decode(p, x, positions, cache["k"][i], cache["v"][i],
                             cache_len, block_k)
            h = L.rms_norm(x, p.mlp_norm)
            if hasattr(p, "moe"):
                y, _ = MOE.moe_layer(p.moe, h, p.moe.cfg)
            else:
                y = L.mlp(p.mlp, h)
            x = x + y
    else:
        ssm_cfg = _ssm_cfg(cfg)
        for idx, p in enumerate(model.layers):
            h, state = M2.mamba2_decode_step(
                p.mamba, L.rms_norm(x, p.norm),
                {"ssm": cache["ssm"][idx], "conv": cache["conv"][idx]},
                ssm_cfg)
            cache["ssm"][idx] = state["ssm"]
            cache["conv"][idx] = state["conv"]
            x = x + h
            if _applies_attn(cfg, idx):
                sp, app = model.shared_attn, idx // cfg.attn_every
                x = _attn_decode(sp, x, positions, cache["k"][app],
                                 cache["v"][app], cache_len, block_k)
                x = x + L.mlp(sp.mlp, L.rms_norm(x, sp.mlp_norm))

    x = L.rms_norm(x, model.final_norm)
    return L.unembed(model.embed, x), cache


def prefill(cfg: ArchConfig, model: Lm, tokens: torch.Tensor, max_seq: int):
    """Full-sequence forward; returns the last position's logits (repro's
    prefill: the KV cache is not materialised)."""
    logits, _ = forward(cfg, model, tokens=tokens)
    return logits[:, -1:]
