"""mamba2-370m: 48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.
SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig, SsmArch

CONFIG = register(ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv=16, d_ff=0, vocab=50280,
    ssm=SsmArch(d_state=128, head_dim=64, expand=2, chunk=256),
    source="arXiv:2405.21060; unverified",
))
