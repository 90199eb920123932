"""CLI of the program-contract checker.

    python -m repro_torch.analysis --strict                # on the card
    python -m repro_torch.analysis --strict --device cpu   # off the card
    python -m repro_torch.analysis --layer lint            # source lint
    python -m repro_torch.analysis --layer kernels         # H003 + H004
    python -m repro_torch.analysis --engines mpbcfw-shard --layer program
    python -m repro_torch.analysis --json                  # machine-readable
    python -m repro_torch.analysis --rules                 # the rule table

Exit code: 0 when clean; with ``--strict``, 1 when any finding survives.
Without ``--strict`` findings are reported but the exit stays 0.  The
program layer and the kernels layer's H004 run on CUDA unless ``--device
cpu`` is given (the kernels layer then runs H003 alone and says so);
without a card they raise, they do not fall back.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import LAYERS, Report, rule_table, run_all

#: The reference's layers that have no torch counterpart of their name,
#: and what stands in for them.
_NO_COUNTERPART = {
    "jaxpr": "the program layer ('--layer program') runs each engine's "
             "dispatches and counts what they dispatched",
    "hlo": "a torch program has no HLO: the program layer's J001/J002 "
           "count the collectives each program dispatches (H001/H002's "
           "stand-in), and the kernels layer ('--layer kernels') holds "
           "the CUDA kernels' plans and builds to the card (H003/H004)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Program-contract checker of the PyTorch port "
                    "(program runs + AST lint + the kernels' plans and "
                    "builds).")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on any finding")
    p.add_argument("--layer", action="append", dest="layers",
                   metavar="LAYER",
                   help="run only these layers (repeatable; "
                        f"default: all of {', '.join(LAYERS)})")
    p.add_argument("--engines", default=None,
                   help="comma-separated engine names to run "
                        "(default: every registered engine)")
    p.add_argument("--root", default=None,
                   help="source root for the lint layer, holding "
                        "repro_torch/ (default: the repo src/ directory)")
    p.add_argument("--device", default="cuda",
                   help="device the program layer and H004 run on "
                        "(default: cuda; no fallback; cpu runs the "
                        "kernels layer's H003 alone)")
    p.add_argument("--json", action="store_true",
                   help="emit the report as JSON")
    p.add_argument("--verbose", action="store_true",
                   help="also print per-engine facts when there are "
                        "findings")
    p.add_argument("--rules", action="store_true",
                   help="print the rule table and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.rules:
        print(rule_table())
        return 0
    layers = args.layers or list(LAYERS)
    for layer in layers:
        if layer in _NO_COUNTERPART:
            parser.error(f"layer {layer!r} has no torch counterpart: "
                         f"{_NO_COUNTERPART[layer]}")
        if layer not in LAYERS:
            parser.error(f"unknown layer {layer!r}; pick from "
                         f"{', '.join(LAYERS)}")
    on_card = [l for l in ("program", "kernels") if l in layers]
    if on_card and args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(f"repro_torch.analysis: no CUDA device for "
                               f"the {' and '.join(on_card)} layer; pass "
                               "--device cpu to run it on the CPU")
    engines = (None if args.engines is None
               else [e.strip() for e in args.engines.split(",") if e.strip()])
    import torch.distributed as dist
    owned = not dist.is_initialized()      # the mesh forms may make one
    try:
        report: Report = run_all(layers=layers, engines=engines,
                                 root=args.root, device=args.device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    print(report.to_json() if args.json
          else report.format_text(verbose=args.verbose))
    return 1 if (args.strict and not report.ok) else 0


if __name__ == "__main__":
    sys.exit(main())
