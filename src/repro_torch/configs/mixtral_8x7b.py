"""Mixtral-8x7B — MoE, 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, SWA 4096.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    act="silu",
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=14336,
                  capacity_factor=1.25, sharding="tensor"),
    source="arXiv:2401.04088 (Mixtral of Experts)",
)
