"""HuBERT X-Large — encoder-only audio backbone [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means target codebook).
The conv feature-extractor frontend is a stub: ``input_specs()`` provides
precomputed 20ms frame embeddings of shape (batch, frames, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    act="gelu",
    norm="layernorm",
    causal=False,
    frontend_positions=-1,  # all positions are frontend frames
    source="arXiv:2106.07447 (HuBERT X-Large; wav2vec2-style encoder)",
)
