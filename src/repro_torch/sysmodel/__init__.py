"""System model of the port (``repro.sysmodel``): so far the failure
scenarios the synchronous engine realizes (``scenario``)."""
from repro_torch.sysmodel.scenario import (ScenarioConfig, ScenarioDraws,
                                           as_active, check_sync, realize,
                                           scale_steps)

__all__ = ["ScenarioConfig", "ScenarioDraws", "as_active", "check_sync",
           "realize", "scale_steps"]
