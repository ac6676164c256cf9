"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``folb_aggregate``, ``flash_attention``, ``ssm_scan``,
``slstm_scan``; oracles in ``ref``), their build (``build``), entry points
(``ops``) and the update guard's config (``guard``)."""
from repro_torch.kernels.guard import GuardConfig

__all__ = ["GuardConfig"]
