"""The program-contract checker of the port (PyTorch port of
``repro/analysis``), in three layers:

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
     R001-R005, with inline ``# repro: allow[R00x] reason`` waivers);
  3. :mod:`~repro_torch.analysis.kernels` -- the counterpart of the
     reference's HLO layer for the port's hand-written CUDA kernels: every
     launch plan over a sweep of shapes fits the card and names a build
     its source has (H003, on the CPU), and every build compiles, loads
     and holds to its plans on the card, spills waived one by one (H004).
     The reference's H001/H002 (XLA's collectives against the jaxpr's)
     have their stand-in in the program layer's J001/J002.

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
from .kernels import run_kernel_layer
from .lint import lint_source, run_lint_layer

LAYERS = ("program", "lint", "kernels")


def run_all(layers: Iterable[str] = LAYERS,
            engines: Optional[Iterable[str]] = None, root=None,
            device="cuda") -> Report:
    """Run the requested layers and aggregate one :class:`Report`.

    ``engines`` filters the engines the program layer runs (on
    ``device``; CUDA by default), ``root`` points the lint layer at
    another source root.  The kernels layer runs H004 on a CUDA
    ``device`` only; off it its facts say that H004 did not run."""
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
    if "kernels" in layers:
        findings, facts = run_kernel_layer(device)
        report.extend(findings)
        report.facts.update(facts)
    return report


__all__ = [
    "LAYERS", "RULES", "DispatchCounter", "EngineTrace", "Finding",
    "ProgramFacts", "Report", "check_serve_engines", "check_trace",
    "count_program", "install_registration_guard", "lint_source",
    "raise_site", "rule_table", "run_all", "run_kernel_layer",
    "run_lint_layer",
    "run_program_layer", "sync_debug", "trace_cases", "trace_engine",
]
