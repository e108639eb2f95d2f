"""Mamba2: SSD (state-space duality, arXiv:2405.21060), the counterpart of
``repro.models.mamba2``.

Training / prefill uses the chunked SSD algorithm: intra-chunk work is
dense products, and the inter-chunk recurrence is a short loop over chunk
states (repro's ``lax.scan``).  Decode is the O(1) recurrent step:
``state = decay * state + dt * B (x) x``, ``y = C . state``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


class Mamba2(nn.Module):
    """``in_proj`` (d, 2 di + 2 n + h) in the order [z, x, B, C, dt],
    ``conv`` (w, di + 2 n), f32 ``A_log`` / ``D`` / ``dt_bias`` (h,) and
    ``norm`` (di,), ``out_proj`` (di, d)."""

    def __init__(self, cfg: Mamba2Config, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
        f32 = torch.float32
        self.in_proj = layers.new_param((d, 2 * di + 2 * n + h), dtype,
                                        device)
        self.conv = layers.new_param((cfg.conv_width, di + 2 * n), dtype,
                                     device)
        self.A_log = layers.new_param((h,), f32, device)
        self.D = layers.new_param((h,), f32, device)
        self.dt_bias = layers.new_param((h,), f32, device)
        self.norm = layers.new_param((di,), f32, device)
        self.out_proj = layers.new_param((di, d), dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        layers.fill_normal_(self.in_proj, gen, 1.0 / math.sqrt(cfg.d_model))
        layers.fill_normal_(self.conv, gen, 0.1)
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, cfg.n_heads)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.fill_(1.0)
        layers.fill_normal_(self.out_proj, gen, 1.0 / math.sqrt(cfg.d_inner))


def _split_proj(cfg: Mamba2Config, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt


def _ssd_chunked(x, dt, A, B, C, D, chunk):
    """x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, n).

    Returns (y, final_state) with state (b, h, p, n).
    Single SSM group (ngroups=1).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    assert nc * chunk == l, (l, chunk)
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    dA = dtc * (-torch.exp(A))[None, None, None, :]    # (b,nc,q,h) negative
    dA_cum = torch.cumsum(dA, dim=2)                   # within-chunk cumsum

    # intra-chunk (diagonal block): L[i,j] = exp(dA_cum_i - dA_cum_j), i>=j
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,nc,q,q,h)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # mask BEFORE exp: exp of the masked (positive, potentially huge) upper
    # triangle would be inf, and inf*0 in a backward pass gives NaN
    L = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = scores[..., None] * L * dtc[:, :, None, :, :]  # (b,nc,i,j,h)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk states: S_c = sum_j exp(dA_cum_last - dA_cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (b,nc,q,h)
    states = torch.einsum("bcjhp,bcjn->bchpn",
                          (decay_to_end * dtc)[..., None] * xc, Bc)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # (b,nc,h)

    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    entering = []  # the state *entering* each chunk
    for c in range(nc):
        entering.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)                   # (b,nc,h,p,n)

    # inter-chunk (low-rank) contribution: y_off = C_i exp(dA_cum_i) S_enter
    in_decay = torch.exp(dA_cum)                              # (b,nc,q,h)
    y_off = (torch.einsum("bcin,bchpn->bcihp", Cc, entering)
             * in_decay[..., None])

    y = (y_diag + y_off).reshape(b, l, h, p)
    y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), s


def _conv_windows(xbc: torch.Tensor, width: int) -> torch.Tensor:
    l = xbc.shape[1]
    conv_in = F.pad(xbc, (0, 0, width - 1, 0))
    return torch.stack([conv_in[:, i:i + l] for i in range(width)], dim=-1)


def mamba2_block(p: Mamba2, x: torch.Tensor, cfg: Mamba2Config):
    """Full-sequence (train / prefill) SSD block.  x: (b, l, d)."""
    b, l, d = x.shape
    z, xbc, dt = _split_proj(cfg, x @ p.in_proj)
    # depthwise causal conv over (x, B, C)
    windows = _conv_windows(xbc, cfg.conv_width)
    xbc = F.silu(torch.einsum("blcw,wc->blc", windows, p.conv))
    di, n = cfg.d_inner, cfg.d_state
    xs = xbc[..., :di].reshape(b, l, cfg.n_heads, cfg.head_dim)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt.float() + p.dt_bias)
    y, state = _ssd_chunked(xs, dt, p.A_log, B, C, p.D, cfg.chunk)
    y = y.reshape(b, l, di)
    y = layers.rms_norm(y * F.silu(z), p.norm)
    return y @ p.out_proj, state


def init_mamba2_cache(batch: int, cfg: Mamba2Config, dtype=torch.float32,
                      device=None) -> dict:
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.d_state),
                            dtype=dtype, device=device),
    }


def mamba2_decode_step(p: Mamba2, x: torch.Tensor, cache: dict,
                       cfg: Mamba2Config):
    """O(1) recurrent step.  x: (b, 1, d) -> (y, new_cache)."""
    b = x.shape[0]
    z, xbc, dt = _split_proj(cfg, x[:, 0] @ p.in_proj)    # (b, ...)
    conv_window = torch.cat(
        [cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    xbc = F.silu(torch.einsum("bwc,wc->bc", conv_window.float(),
                              p.conv.float()))
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    xs = xbc[..., :di].reshape(b, h, cfg.head_dim)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt.float() + p.dt_bias)                # (b, h)
    decay = torch.exp(dt * (-torch.exp(p.A_log))[None, :])  # (b, h)
    contrib = (dt[:, :, None, None] * xs.float()[..., None]
               * B[:, None, None, :])                      # (b, h, p, n)
    state = cache["ssm"] * decay[:, :, None, None] + contrib
    y = torch.einsum("bn,bhpn->bhp", C, state)
    y = y + xs.float() * p.D[None, :, None]
    y = y.reshape(b, di)
    y = layers.rms_norm(y * F.silu(z.float()), p.norm)
    out = (y.to(x.dtype) @ p.out_proj)[:, None, :]
    return out, {"ssm": state, "conv": conv_window[:, 1:]}
