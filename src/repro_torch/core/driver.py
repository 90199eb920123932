"""Compatibility re-exports of the reference's pre-``api`` module layout
(PyTorch port of ``repro/core/driver.py``).

The control loop, the engines and the config types live in
:mod:`repro_torch.api`; the old private names resolve here lazily
(PEP 562), for those whose targets the port has.  There is no ``run``:
call ``Solver(problem, cfg).run()``.
"""
from __future__ import annotations

from ..api.config import RunConfig, RunResult, TraceRow  # noqa: F401

_MOVED = {
    # name -> (module, attribute); resolved lazily, so importing
    # repro_torch.core stays light.
    "ALGORITHMS": ("repro_torch.api.engine", "algorithms"),
    "_FusedEngine": ("repro_torch.api.engines", "FusedEngine"),
    "_Clock": ("repro_torch.api.solver", "_Clock"),
    "_evaluate": ("repro_torch.api.solver", "evaluate_objectives"),
    "_fit_pass_costs": ("repro_torch.api.solver", "_fit_pass_costs"),
    "_draw_perms": ("repro_torch.api.solver", "_draw_perms"),
    "batched_oracle": ("repro_torch.api.solver", "batched_oracle"),
}


def __getattr__(name: str):
    """PEP-562 compat shims for the pre-``api`` private surface."""
    moved = _MOVED.get(name)
    if moved is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    module, attr = moved
    value = getattr(importlib.import_module(module), attr)
    if name == "ALGORITHMS":
        return value()   # the registry's registration-order name tuple
    return value
