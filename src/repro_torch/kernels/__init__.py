"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``folb_aggregate``), their build (``build``) and entry points
(``ops``)."""
