"""Granite-20B-Code — dense llama-arch with MQA [arXiv:2405.04324].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    act="gelu",
    norm="layernorm",
    source="arXiv:2405.04324 (Granite Code 20B, MQA)",
)
