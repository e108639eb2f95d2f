"""internvl2-26b: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 —
InternLM2-20B language backbone; the InternViT vision frontend is a STUB
(input_specs() provides precomputed patch embeddings as a prefix).
[arXiv:2404.16821; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchConfig

CONFIG = register(ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=92553,
    modality="prefix", prefix_len=1024,
    source="arXiv:2404.16821; hf",
))
