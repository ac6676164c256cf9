"""PyTorch/CUDA port of the federated-learning system in ``repro``.

The JAX package (``repro``) is the reference; this package mirrors its
module names so each counterpart is easy to find, imports ``torch`` and
numpy only (never ``jax`` or ``repro``), and runs its hot kernels as CUDA
C++ written for Hopper (``repro_torch.kernels``).  Entry points run on the
card (``device=None`` means ``"cuda"``) unless the caller asks for the CPU.

    from repro_torch import fed
    res = fed.run(MCLR, data, fed.FLConfig(algo="folb"), rounds=20)
"""
