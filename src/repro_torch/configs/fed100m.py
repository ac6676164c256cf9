"""~100M-parameter dense LM used by the end-to-end federated training
example (examples/train_federated_100m.py): 12L d_model=768 12H.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="fed100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=32000,
    act="silu",
    param_dtype="float32",
    source="GPT-2-small-scale dense LM for the e2e federated example",
)
