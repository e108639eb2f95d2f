"""musicgen-large: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB —
input_specs() provides precomputed frame embeddings. [arXiv:2306.05284; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv=32, d_ff=8192, vocab=2048,
    modality="embeds",
    source="arXiv:2306.05284; hf",
))
