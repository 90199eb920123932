"""repro_torch.api: the Solver control loop, its configuration and engines."""
from .config import RunConfig, RunResult, TraceRow  # noqa: F401
from .engines import AsyncEngine, FusedEngine, algorithms  # noqa: F401
from .errors import UnsupportedConfigError  # noqa: F401
from .oracle import OracleSpec, build_problem  # noqa: F401
from .solver import Solver, evaluate_objectives  # noqa: F401
from .stopping import (MaxIters, StopContext, StopOnGap,  # noqa: F401
                       StoppingCriterion, WallTimeBudget)
from ..core.selection import CostModel  # noqa: F401

__all__ = ["RunConfig", "RunResult", "TraceRow", "AsyncEngine", "FusedEngine",
           "algorithms", "UnsupportedConfigError", "OracleSpec",
           "build_problem", "Solver", "evaluate_objectives", "MaxIters",
           "StopContext", "StopOnGap", "StoppingCriterion", "WallTimeBudget",
           "CostModel"]
