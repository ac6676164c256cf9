"""Federated engines of the port; ``run`` is the front door."""
from repro_torch.fed.api import run
from repro_torch.fed.simulator import FedRunResult, FLConfig

__all__ = ["run", "FLConfig", "FedRunResult"]
