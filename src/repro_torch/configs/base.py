"""Architecture + shape configuration system.

Every assigned architecture is an :class:`ArchConfig`; the four assigned
input-shape presets are :data:`SHAPES`.  ``reduced()`` produces the
CPU-smoke-test variant of the same family (small depth/width/experts), per
the assignment ("FULL configs are exercised only via the dry-run").
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoeArch:
    num_experts: int
    top_k: int
    expert_d_ff: int
    shared_experts: int = 0
    group_size: int = 512
    capacity_factor: float = 1.25
    dispatch_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SsmArch:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str          # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    head_dim: int | None = None
    moe: MoeArch | None = None
    moe_every: int = 1           # MoE on every k-th layer (llama4: 2)
    dense_d_ff: int | None = None  # FFN width of the interleaved dense layers
    ssm: SsmArch | None = None
    attn_every: int = 0          # hybrid: shared attn after every k-th layer
    modality: str = "text"       # text | embeds (audio stub) | prefix (vlm)
    prefix_len: int = 0          # vlm: patch-embedding prefix length
    rope_theta: float = 1e4
    dtype: str = "bfloat16"
    remat: str = "full"          # none | full | dots
    attn_block_k: int = 1024     # flash block size (hillclimb lever)
    kv_cache_dtype: str = "bfloat16"  # 'float8_e4m3fn' halves cache traffic
    source: str = ""             # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ArchConfig":
        """Same family, toy size — used by the per-arch smoke tests."""
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv=max(1, min(self.n_kv, 2)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            prefix_len=8 if self.modality == "prefix" else 0,
            remat="none",
            attn_block_k=64,
        )
        if self.moe_every > 1:
            kw["n_layers"] = 2 * self.moe_every  # 2 superblocks
            kw["dense_d_ff"] = 64
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                expert_d_ff=32,
                shared_experts=min(self.moe.shared_experts, 1),
                group_size=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=8)
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 5  # non-multiple: exercises the remainder path
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, l = self.d_model, self.n_layers
        n = self.vocab * d  # embedding (tied head)
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            hd = self.hd
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv * hd \
                + self.n_heads * hd * d
            if self.moe is not None:
                moe_frac = 1.0 / self.moe_every
                moe_ffn = d * self.moe.num_experts  # router
                moe_ffn += self.moe.num_experts * (
                    d * 2 * self.moe.expert_d_ff + self.moe.expert_d_ff * d)
                if self.moe.shared_experts:
                    fs = self.moe.shared_experts * self.moe.expert_d_ff
                    moe_ffn += 3 * d * fs
                dense_ffn = 3 * d * (self.dense_d_ff
                                     or 2 * self.moe.expert_d_ff)
                per_layer += moe_frac * moe_ffn + (1 - moe_frac) * dense_ffn
            else:
                per_layer += 3 * d * self.d_ff
            per_layer += 2 * d  # norms
        if self.family == "ssm" or self.family == "hybrid":
            s = self.ssm
            di = s.expand * d
            nh = di // s.head_dim
            per_layer_ssm = d * (2 * di + 2 * s.d_state + nh) \
                + s.conv_width * (di + 2 * s.d_state) + di * d + di + d
            if self.family == "ssm":
                per_layer = per_layer_ssm
            else:
                per_layer = per_layer_ssm  # mamba layers dominate
                # one shared attention+mlp block (counted once below)
                hd = self.hd
                n += d * self.n_heads * hd + 2 * d * self.n_kv * hd \
                    + self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d
        n += per_layer * l
        n += d  # final norm
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        n_moe_layers = l // self.moe_every
        per_expert = d * 2 * self.moe.expert_d_ff + self.moe.expert_d_ff * d
        full_experts = self.moe.num_experts * per_expert * n_moe_layers
        active_experts = self.moe.top_k * per_expert * n_moe_layers
        return int(self.param_count() - full_experts + active_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k only for sub-quadratic families (per assignment)."""
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True
