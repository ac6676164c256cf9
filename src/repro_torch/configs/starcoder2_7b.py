"""StarCoder2-7B — dense, GQA + RoPE + sliding window [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152, SWA 4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    act="gelu",
    norm="layernorm",
    sliding_window=4096,
    rope_theta=1e5,
    source="arXiv:2402.19173 (StarCoder2-7B)",
)
