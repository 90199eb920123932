"""repro_torch.api: the Solver control loop, its configuration, the engine
registry and the engines."""
from .config import RunConfig, RunResult, TraceRow  # noqa: F401
from .engine import (Engine, EngineCapabilities, EngineEntry,  # noqa: F401
                     algorithms, capabilities_of, engine_entry,
                     register_engine, unregister_engine, validate_config)
from .engines import AsyncEngine, FusedEngine  # noqa: F401
from .errors import UnsupportedConfigError  # noqa: F401
from .oracle import Oracle, OracleSpec, build_problem  # noqa: F401
from .solver import Solver, evaluate_objectives  # noqa: F401
from .stopping import (MaxIters, StopContext, StopOnGap,  # noqa: F401
                       StoppingCriterion, WallTimeBudget)
from ..core.selection import CostModel  # noqa: F401

__all__ = ["RunConfig", "RunResult", "TraceRow", "Engine",
           "EngineCapabilities", "EngineEntry", "algorithms",
           "capabilities_of", "engine_entry", "register_engine",
           "unregister_engine", "validate_config", "AsyncEngine",
           "FusedEngine", "UnsupportedConfigError", "Oracle", "OracleSpec",
           "build_problem", "Solver", "evaluate_objectives", "MaxIters",
           "StopContext", "StopOnGap", "StoppingCriterion", "WallTimeBudget",
           "CostModel"]
