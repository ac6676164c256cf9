"""Gemma-7B — dense, GeGLU, head_dim=256, large vocab [arXiv:2403.08295].

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    head_dim=256,
    tie_embeddings=True,
    source="arXiv:2403.08295 (Gemma 7B)",
)
