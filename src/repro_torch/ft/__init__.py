"""repro_torch.ft: straggler mitigation (PyTorch port of ``repro.ft``)."""
from .stragglers import (StragglerPolicy, fallback_planes,  # noqa: F401
                         simulate_oracle_outcomes)

__all__ = ["StragglerPolicy", "fallback_planes", "simulate_oracle_outcomes"]
