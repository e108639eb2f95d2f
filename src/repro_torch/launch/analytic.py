"""Closed-form FLOP / HBM-byte models per (arch x shape) cell: the
counterpart of ``repro.launch.analytic``, the same float operations in the
same order, so both packages give the same numbers bit for bit.

The roofline uses the closed form.  The dry-run (``launch/dryrun``) also
counts the FLOPs of the traced step with ``FlopCounterMode``, which sees
every execution of a loop body (every layer, KV block and SSD chunk),
and records the ratio of the two as the cross-check.

Conventions:
  * FLOPs = 2 x MACs; causal attention is counted at FULL block cost
    (our blockwise kernel masks after the matmul — no triangle skipping),
    so this is what the hardware would actually execute.
  * train multiplier: backward = 2x forward matmuls; remat 'full' adds one
    forward recompute (4x total), 'dots' ~3.1x, 'none' 3x.
  * bytes: parameter traffic (per-pass re-reads), activation traffic
    (~14 d-wide tensors per layer pass), KV/state cache traffic, optimizer
    update traffic.  Napkin-grade but each term is written out.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.layers import dtype_of

BF16 = 2
F32 = 4


@dataclasses.dataclass
class CellCost:
    flops: float
    hbm_bytes: float
    detail: dict

    def to_json(self):
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "detail": self.detail}


def _attn_layer_flops(cfg: ArchConfig, B: int, Lq: int, Lkv: int) -> float:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    T = B * Lq
    proj = 2 * T * d * (h * hd) + 2 * 2 * T * d * (kv * hd) \
        + 2 * T * (h * hd) * d
    scores_pv = 4 * B * Lq * Lkv * h * hd  # QK^T + PV, full blocks
    return proj + scores_pv


def _mlp_flops(d: int, ff: int, T: int) -> float:
    return 6 * T * d * ff  # SwiGLU: gate, up, down


def _moe_layer_flops(cfg: ArchConfig, T: int) -> float:
    m = cfg.moe
    d = cfg.d_model
    e, k, f, cf = m.num_experts, m.top_k, m.expert_d_ff, m.capacity_factor
    s = m.group_size
    c = max(1, int(-(-s * k * cf // e)))
    router = 2 * T * d * e
    # dispatch + combine einsums: gsec,gsd->egcd is S*E*C*d MACs per group,
    # i.e. (E*C/S) d-wide MACs per token, twice (dispatch + combine)
    dispatch = 2 * 2 * T * e * c * d / s
    expert_ffn = 6 * (T * k * cf) * d * f  # tokens*k*cf through 3 matmuls
    shared = _mlp_flops(d, m.shared_experts * f, T) if m.shared_experts else 0
    return router + dispatch + expert_ffn + shared


def _mamba_layer_flops(cfg: ArchConfig, B: int, L: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    n = s.d_state
    h = di // s.head_dim
    q = s.chunk
    T = B * L
    proj = 2 * T * d * (2 * di + 2 * n + h) + 2 * T * di * d
    conv = 2 * T * (di + 2 * n) * s.conv_width
    # SSD: scores (L*q*n), y_diag (L*q*di), states (L*di*n), y_off (L*di*n)
    ssd = 2 * B * L * (q * n + q * di + 2 * di * n)
    return proj + conv + ssd


def _mamba_decode_flops(cfg: ArchConfig, B: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    n = s.d_state
    h = di // s.head_dim
    proj = 2 * B * d * (2 * di + 2 * n + h) + 2 * B * di * d
    state = 2 * B * di * n * 3  # decay, contrib, readout
    return proj + state


def forward_flops(cfg: ArchConfig, B: int, Lq: int, Lkv: int) -> float:
    """One forward pass: Lq query positions against Lkv context."""
    d, V = cfg.d_model, cfg.vocab
    T = B * Lq
    total = 2 * T * d * V  # unembed (tied head); embed gather ~ 0 flops
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        attn = _attn_layer_flops(cfg, B, Lq, Lkv)
        if cfg.moe is not None:
            n_moe = cfg.n_layers // cfg.moe_every
            n_dense = cfg.n_layers - n_moe
            ffd = cfg.dense_d_ff or 2 * cfg.moe.expert_d_ff
            total += cfg.n_layers * attn
            total += n_moe * _moe_layer_flops(cfg, T)
            total += n_dense * _mlp_flops(d, ffd, T)
        else:
            total += cfg.n_layers * (attn + _mlp_flops(d, cfg.d_ff, T))
    elif cfg.family == "ssm":
        total += cfg.n_layers * (_mamba_layer_flops(cfg, B, Lq) if Lq > 1
                                 else _mamba_decode_flops(cfg, B))
    elif cfg.family == "hybrid":
        mam = (_mamba_layer_flops(cfg, B, Lq) if Lq > 1
               else _mamba_decode_flops(cfg, B))
        total += cfg.n_layers * mam
        n_apps = cfg.n_layers // cfg.attn_every
        total += n_apps * (_attn_layer_flops(cfg, B, Lq, Lkv)
                           + _mlp_flops(d, cfg.d_ff, T))
    return total


def _train_mult(cfg: ArchConfig) -> float:
    return {"full": 4.0, "dots": 3.1, "none": 3.0}[cfg.remat]


def param_bytes(cfg: ArchConfig) -> float:
    return cfg.param_count() * BF16


def active_param_bytes(cfg: ArchConfig) -> float:
    return cfg.active_param_count() * BF16


def cell_cost(cfg: ArchConfig, shape: ShapeConfig) -> CellCost:
    B, L = shape.global_batch, shape.seq_len
    d = cfg.d_model
    detail = {}
    if shape.kind == "train":
        fwd = forward_flops(cfg, B, L, L)
        flops = _train_mult(cfg) * fwd
        detail["forward_flops"] = fwd
        detail["train_mult"] = _train_mult(cfg)
        # bytes: weights re-read fwd+bwd+remat (MoE: only active experts'
        # rows are gathered, but the einsum dispatch reads all E expert
        # weights once per layer -> use full weights), grads written,
        # optimizer read-modify-write (f32 moments), activations.
        passes = 1 + 2 + (1 if cfg.remat == "full" else 0)
        w = param_bytes(cfg)
        opt = cfg.param_count() * (2 * F32 * 2)      # m,v read+write
        acts = 14 * B * L * d * BF16 * max(cfg.n_layers, 1)
        if cfg.remat == "full":
            acts = 2 * 2 * B * L * d * BF16 * cfg.n_layers  # only saved x
        hbm = passes * w + 2 * w + opt + acts
        detail.update(weights_bytes=w, opt_bytes=opt, act_bytes=acts,
                      passes=passes)
    elif shape.kind == "prefill":
        flops = forward_flops(cfg, B, L, L)
        w = active_param_bytes(cfg)
        acts = 14 * B * L * d * BF16 * max(cfg.n_layers, 1)
        hbm = w + acts
        detail.update(weights_bytes=w, act_bytes=acts)
    else:  # decode: 1 token against an L-deep cache
        flops = forward_flops(cfg, B, 1, L)
        w = active_param_bytes(cfg)
        cache = 0.0
        kv_b = dtype_of(cfg.kv_cache_dtype).itemsize
        if cfg.family in ("dense", "moe", "audio", "vlm"):
            cache = cfg.n_layers * B * L * cfg.n_kv * cfg.hd * 2 * kv_b
        elif cfg.family == "hybrid":
            n_apps = cfg.n_layers // cfg.attn_every
            cache = n_apps * B * L * cfg.n_kv * cfg.hd * 2 * kv_b
            s = cfg.ssm
            di = s.expand * d
            cache += cfg.n_layers * B * (di // s.head_dim) * s.head_dim \
                * s.d_state * F32
        else:  # ssm: fixed-size state
            s = cfg.ssm
            di = s.expand * d
            cache = cfg.n_layers * B * (di // s.head_dim) * s.head_dim \
                * s.d_state * F32
        acts = 14 * B * 1 * d * BF16 * max(cfg.n_layers, 1)
        hbm = w + cache + acts
        detail.update(weights_bytes=w, cache_bytes=cache, act_bytes=acts)
    return CellCost(flops=float(flops), hbm_bytes=float(hbm), detail=detail)


# ------------------------------------------------------------- BFS cells ---
def bfs_cell_cost(shape_name: str, n: int, nv: int, tau: int, sigma: int,
                  kappa: int = 16, chips: int = 256) -> CellCost:
    """The BLEST workload: popc-semiring 'flops' = 2 x MAC-equivalents of the
    MS pull GEMM (int8), plus byte traffic of masks/rowIds/V/frontier.

    Variants (§Perf ladder): *_k64 raises kappa to 64 (amortizes the
    mask/rowId reads over 4x more BFS lanes), *_queued compacts the VSS
    sweep to |Q| = N_v/8 (the measured peak-level activity on our
    scale-free benches), ssbfs_replicated adds nothing here (its cost is
    the per-level n-byte OR-all-reduce, visible in the collective term)."""
    num_sets = n // sigma
    if shape_name.startswith("msbfs"):
        if "k64" in shape_name or "packed" in shape_name:
            kappa = 64
        nv_proc = nv // 8 if ("queued" in shape_name
                              or "packed" in shape_name) else nv
        if "packed" in shape_name:
            # kappa-bit packed state: V and frontier words at 1 bit/BFS
            flops = 2.0 * nv_proc * tau * sigma * kappa * chips
            bytes_ = chips * (
                nv_proc * tau * 5            # masks + rowIds
                + 2 * n * kappa / 8          # packed V read+write
                + num_sets * sigma * kappa / 8 * 4 / 4  # packed frontier
            )
            return CellCost(float(flops), float(bytes_),
                            {"kappa": kappa, "nv_processed": nv_proc,
                             "packed": True})
        # per device: queued VSSs pulled against kappa frontier planes
        flops = 2.0 * nv_proc * tau * sigma * kappa * chips
        bytes_ = chips * (
            nv_proc * tau * 1            # masks
            + nv_proc * tau * 4          # rowIds
            + 2 * n * kappa              # V read+write
            + num_sets * sigma * kappa   # frontier planes
        )
        return CellCost(float(flops), float(bytes_),
                        {"kappa": kappa, "nv_processed": nv_proc,
                         "per_chip_flops": flops / chips,
                         "flops_per_bfs_level": flops / (kappa * chips)})
    # ssbfs_row / ssbfs_replicated: VPU bitwise (AND+popc = 2 ops per slice
    # byte); graph sharded over 'model', so per-chip work is nv/16
    flops = 2.0 * nv * tau
    bytes_ = nv * tau * (1 + 4) + 2 * n + num_sets
    return CellCost(float(flops), float(bytes_), {})
