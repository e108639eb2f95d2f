"""zamba2-7b: 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention block applied every 6
layers (the Zamba2 shared-block trick). [arXiv:2411.15242; unverified]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig, SsmArch

CONFIG = register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336, vocab=32000,
    ssm=SsmArch(d_state=64, head_dim=64, expand=2, chunk=256),
    attn_every=6,
    source="arXiv:2411.15242; unverified",
))
