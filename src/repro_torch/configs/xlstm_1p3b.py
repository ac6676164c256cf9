"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (kv=4) d_ff=0 (blocks carry their own projections)
vocab=50304; ratio 7 mLSTM : 1 sLSTM.
"""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, conv_kernel=4),
    source="arXiv:2405.04517 (xLSTM[7:1] 1.3B)",
)
