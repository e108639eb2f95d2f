"""qwen3-4b: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, qk_norm.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv=8, d_ff=9728, vocab=151936,
    qk_norm=True, head_dim=128,
    source="hf:Qwen/Qwen3-8B; hf",
))
