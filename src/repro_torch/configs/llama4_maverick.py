"""llama4-maverick-400b-a17b: 48L d_model=5120 40H (GQA kv=8) expert_d_ff=8192
vocab=202048, MoE 128 experts top-1 + shared expert, early fusion (the fused
multimodal embeddings arrive as model inputs — frontend stub).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig, MoeArch

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=0, vocab=202048,
    head_dim=128,
    moe=MoeArch(num_experts=128, top_k=1, expert_d_ff=8192,
                shared_experts=1, group_size=512),
    moe_every=2, dense_d_ff=16384,  # MoE on alternate layers (maverick)
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
