"""The program-contract checker of the port (PyTorch port of
``repro/analysis``), in two layers:

  1. :mod:`~repro_torch.analysis.contracts` -- run every registered
     engine's dispatches once on a tiny problem under a dispatch counter
     (and, on CUDA, under ``torch.cuda.set_sync_debug_mode("error")``)
     and hold the collectives, host syncs and dtypes they show against
     the budgets declared on
     :class:`repro_torch.api.engine.EngineCapabilities` (rules
     J001-J007); each registered serving
     :class:`repro_torch.serve.engine.DecodeEngine`'s decode round is one
     clean dispatch (J008); the async engines' iterations are two
     programs with no hazard between them (J009);
  2. :mod:`~repro_torch.analysis.lint` -- AST lint of the port's source
     for the contracts a run cannot see: stray sentinel literals, removed
     names, collectives that bypass the counters, implicit host syncs and
     blocking uploads in hot paths, float64 in device code (rules
     R001-R005, with inline ``# repro: allow[R00x] reason`` waivers).

The reference's third layer checks XLA's HLO and the Pallas tiles (rules
H001-H004); a torch program has neither, so it has no counterpart.

CLI: ``python -m repro_torch.analysis --strict`` (``--device cpu`` off
the card); see ``--help``.
"""
from __future__ import annotations

from typing import Iterable, Optional

from .contracts import (DispatchCounter, EngineTrace, ProgramFacts,
                        check_serve_engines, check_trace, count_program,
                        install_registration_guard, raise_site,
                        run_program_layer, sync_debug, trace_cases,
                        trace_engine)
from .findings import RULES, Finding, Report, rule_table
from .lint import lint_source, run_lint_layer

LAYERS = ("program", "lint")


def run_all(layers: Iterable[str] = LAYERS,
            engines: Optional[Iterable[str]] = None, root=None,
            device="cuda") -> Report:
    """Run the requested layers and aggregate one :class:`Report`.

    ``engines`` filters the engines the program layer runs (on
    ``device``; CUDA by default), ``root`` points the lint layer at
    another source root."""
    layers = list(layers)
    unknown = [l for l in layers if l not in LAYERS]
    if unknown:
        raise ValueError(f"unknown analysis layer(s) {unknown}; "
                         f"pick from {list(LAYERS)}")
    report = Report(layers=layers)
    if "program" in layers:
        findings, facts, _ = run_program_layer(
            list(engines) if engines is not None else None, device=device)
        report.extend(findings)
        report.facts.update(facts)
    if "lint" in layers:
        report.extend(run_lint_layer(root))
    return report


__all__ = [
    "LAYERS", "RULES", "DispatchCounter", "EngineTrace", "Finding",
    "ProgramFacts", "Report", "check_serve_engines", "check_trace",
    "count_program", "install_registration_guard", "lint_source",
    "raise_site", "rule_table", "run_all", "run_lint_layer",
    "run_program_layer", "sync_debug", "trace_cases", "trace_engine",
]
