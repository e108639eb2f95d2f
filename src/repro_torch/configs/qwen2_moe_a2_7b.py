"""qwen2-moe-a2.7b: 24L d_model=2048 16H (kv=16) expert_d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig, MoeArch

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_ff=0, vocab=151936,
    moe=MoeArch(num_experts=60, top_k=4, expert_d_ff=1408,
                shared_experts=4, group_size=512),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
))
