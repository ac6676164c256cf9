"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed experts, top-6
[arXiv:2401.06066].

28L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=102400.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    act="silu",
    moe=MoEConfig(n_experts=64, top_k=6, expert_d_ff=1408,
                  n_shared_experts=2, shared_d_ff=1408,
                  capacity_factor=1.25, sharding="expert"),
    source="arXiv:2401.06066 (DeepSeekMoE 16B, fine-grained + shared experts)",
)
