"""Zamba2-2.7B — hybrid Mamba2 + shared attention [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, one shared attention+MLP block (32H kv=32,
d_ff=10240) applied every 6 Mamba blocks with shared parameters,
ssm_state=64, vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    act="geglu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    shared_attn_every=6,
    source="arXiv:2411.15242 (Zamba2: Mamba2 backbone + shared attn blocks)",
)
