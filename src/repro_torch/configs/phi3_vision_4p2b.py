"""Phi-3-Vision-4.2B — VLM: phi3-mini text backbone + CLIP frontend stub
[hf:microsoft/Phi-3-vision-128k-instruct].

Backbone: 32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064.
The CLIP ViT vision encoder + projector is a stub: ``input_specs()``
provides precomputed, projected patch embeddings (batch, patches, d_model)
interleaved at the start of the sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    act="silu",
    frontend_positions=576,  # 24x24 CLIP-L patch grid
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
