"""Shared transformer building blocks: the counterpart of
``repro.models.layers``, as plain functions plus the ``Attention`` and
``Mlp`` modules, with weights in repro's ``x @ W`` orientation.

Attention is blockwise ("flash-style" online softmax over KV blocks of
``block_k``), with repro's masks, its guard for a fully masked row and its
casts, so a 32k-token prefill never materialises an (L, L) score matrix and
the port follows repro's numerics block for block.  Products that repro
asks for in f32 (``preferred_element_type``) are taken on f32 copies of
their inputs: TF32 stays off (torch's default), so f32 matches on the card.

Decode with a KV cache writes the new K/V in place.  ``cache_len`` is an
int (repro's one offset for the whole batch) or, for one-token steps, a
(B,) tensor: then each row is roped at its own position, writes at its own
offset and attends below its own ``cache_len + 1``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

# float8_e4m3fn's largest finite value is 448; JAX rounds to nearest even
# and gives NaN past it (anything above 464, the midpoint to 480), where
# torch saturates to +-448
_E4M3_ROUNDS_TO_MAX = 464.0


def dtype_of(name: str) -> torch.dtype:
    """A torch dtype from repro's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast-on-store into a cache of ``dtype``.  For float8_e4m3fn a value
    past the format's range becomes NaN, as JAX's cast gives it."""
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > _E4M3_ROUNDS_TO_MAX,
                        torch.full_like(x, float("nan")), x)
    return x.to(dtype)


# ------------------------------------------------------------------ norms --
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale).to(dtype)


# ------------------------------------------------------------------- rope --
def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  The head is
    rotated in halves (repro's split), not in interleaved pairs."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention --
def _per_row(v, b: int, device):
    """An int stays an int (no host-to-device copy, which would make the
    host wait for the stream); a (B,) tensor becomes (B, 1, 1, 1, 1)."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        if v.shape != (b,):
            raise ValueError(f"per-row offsets must have shape ({b},), got "
                             f"{tuple(v.shape)}")
        return v.to(device=device, dtype=torch.int64).view(b, 1, 1, 1, 1)
    return int(v)


def blockwise_attention(
    q: torch.Tensor,           # (B, Lq, H, D)
    k: torch.Tensor,           # (B, Lk, K, D)
    v: torch.Tensor,           # (B, Lk, K, D)
    *,
    causal: bool,
    q_offset=0,                # absolute position of q[0]: int or (B,)
    kv_valid_len=None,         # mask kv positions >= this: int or (B,)
    block_k: int = 1024,
) -> torch.Tensor:
    """GQA attention with online softmax over KV blocks (flash-style).

    Never materialises more than (B, H, Lq, block_k) scores.
    """
    b, lq, h, d = q.shape
    _, lk, kh, _ = k.shape
    groups = h // kh
    scale = 1.0 / math.sqrt(d)
    block_k = min(block_k, lk)
    nblocks = -(-lk // block_k)
    pad = nblocks * block_k - lk
    dev = q.device
    q = q.reshape(b, lq, kh, groups, d)
    qf = q.float()
    q_pos = (torch.arange(lq, device=dev)[None, :, None, None, None]
             + _per_row(q_offset, b, dev))
    valid = (None if kv_valid_len is None
             else _per_row(kv_valid_len, b, dev))

    m = torch.full((b, lq, kh, groups), -math.inf, dtype=torch.float32,
                   device=dev)
    num = torch.zeros((b, lq, kh, groups, d), dtype=torch.float32, device=dev)
    den = torch.zeros((b, lq, kh, groups), dtype=torch.float32, device=dev)
    for blk in range(nblocks):
        lo = blk * block_k
        kblk = k[:, lo:lo + block_k]
        vblk = v[:, lo:lo + block_k]
        if pad and blk == nblocks - 1:
            kblk = F.pad(kblk, (0, 0, 0, 0, 0, pad))
            vblk = F.pad(vblk, (0, 0, 0, 0, 0, pad))
        kblk = kblk.to(q.dtype)  # fp8/int8 caches: dequant-on-load
        vblk = vblk.to(q.dtype)
        kv_pos = lo + torch.arange(block_k, device=dev)
        s = torch.einsum("blkgd,bskd->blkgs", qf, kblk.float()) * scale
        mask = torch.ones((1, 1, 1, 1, block_k), dtype=torch.bool,
                          device=dev)
        if causal:
            mask = mask & (kv_pos <= q_pos)
        if valid is not None:
            mask = mask & (kv_pos < valid)
        if pad:
            mask = mask & (kv_pos < lk)
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        p = p.masked_fill(~mask, 0.0)
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                     torch.full_like(m, -math.inf)))
        corr = torch.where(torch.isfinite(corr), corr, torch.zeros_like(corr))
        num = num * corr[..., None] + torch.einsum(
            "blkgs,bskd->blkgd", p.to(vblk.dtype).float(), vblk.float())
        den = den * corr + p.sum(dim=-1)
        m = m_new
    out = num / torch.clamp(den[..., None], min=1e-30)
    return out.reshape(b, lq, h, d).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0


def new_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def fill_normal_(p: torch.Tensor, gen: torch.Generator, std: float) -> None:
    """Fill ``p`` with N(0, 1) * std drawn in f32, then cast (repro's
    ``(normal(key, shape) * s).astype(dtype)``)."""
    draw = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                       device=p.device)
    p.copy_(draw * std)


class Attention(nn.Module):
    """``wq`` (d, H*hd), ``wk`` / ``wv`` (d, K*hd), ``wo`` (H*hd, d); with
    ``qk_norm`` also f32 ``q_norm`` / ``k_norm`` (hd,)."""

    def __init__(self, cfg: AttentionConfig, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
        self.wq = new_param((d, h * hd), dtype, device)
        self.wk = new_param((d, kv * hd), dtype, device)
        self.wv = new_param((d, kv * hd), dtype, device)
        self.wo = new_param((h * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = new_param((hd,), torch.float32, device)
            self.k_norm = new_param((hd,), torch.float32, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        s = 1.0 / math.sqrt(self.cfg.d_model)
        for w in (self.wq, self.wk, self.wv):
            fill_normal_(w, gen, s)
        fill_normal_(self.wo, gen, s / math.sqrt(2))
        if self.cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def attention(p: Attention, x: torch.Tensor, cfg: AttentionConfig, *,
              positions: torch.Tensor, kv_cache=None, cache_len=None,
              block_k: int = 1024):
    """Returns (out, (k_cache, v_cache)).  With a KV cache this is a decode
    / cached-prefill step: the new K/V are written into the cache tensors
    in place at ``cache_len`` (an int, or a (B,) tensor when l == 1)."""
    b, l, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ p.wq).reshape(b, l, h, hd)
    k = (x @ p.wk).reshape(b, l, kv, hd)
    v = (x @ p.wv).reshape(b, l, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        out = blockwise_attention(q, k, v, causal=True, block_k=block_k)
        k_out, v_out = k, v
    else:
        k_out, v_out = kv_cache
        if isinstance(cache_len, torch.Tensor) and cache_len.dim() > 0:
            if l != 1:
                raise ValueError("per-row cache_len needs one-token steps")
            rows = torch.arange(b, device=x.device)
            at = cache_len.to(device=x.device, dtype=torch.int64)
            k_out[rows, at] = to_cache(k[:, 0], k_out.dtype)
            v_out[rows, at] = to_cache(v[:, 0], v_out.dtype)
        else:
            cache_len = int(cache_len)
            k_out[:, cache_len:cache_len + l] = to_cache(k, k_out.dtype)
            v_out[:, cache_len:cache_len + l] = to_cache(v, v_out.dtype)
        out = blockwise_attention(
            q, k_out, v_out, causal=False, q_offset=cache_len,
            kv_valid_len=cache_len + l, block_k=block_k)
    out = out.reshape(b, l, h * hd) @ p.wo
    return out, (k_out, v_out)


# -------------------------------------------------------------------- mlp --
class Mlp(nn.Module):
    """SwiGLU: ``w_gate`` / ``w_up`` (d, d_ff), ``w_down`` (d_ff, d)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.w_gate = new_param((d_model, d_ff), dtype, device)
        self.w_up = new_param((d_model, d_ff), dtype, device)
        self.w_down = new_param((d_ff, d_model), dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        d_model, d_ff = self.w_gate.shape
        fill_normal_(self.w_gate, gen, 1.0 / math.sqrt(d_model))
        fill_normal_(self.w_up, gen, 1.0 / math.sqrt(d_model))
        fill_normal_(self.w_down, gen, 1.0 / math.sqrt(d_ff))


def mlp(p: Mlp, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


# -------------------------------------------------------------- embedding --
def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied softmax head: logits in f32 for loss stability."""
    return torch.einsum("bld,vd->blv", x.float(), table.float())


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
