"""stablelm-3b: 32L d_model=2560 32H (GQA kv=32 = MHA) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv=32, d_ff=6912, vocab=50304,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
))
