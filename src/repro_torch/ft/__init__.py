"""repro_torch.ft: straggler mitigation and the trainer's restart manager
(PyTorch port of ``repro.ft``)."""
from .restart import RestartManager  # noqa: F401
from .stragglers import (StragglerPolicy, fallback_planes,  # noqa: F401
                         simulate_oracle_outcomes)

__all__ = ["RestartManager", "StragglerPolicy", "fallback_planes",
           "simulate_oracle_outcomes"]
