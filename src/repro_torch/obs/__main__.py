"""CLI of the obs layer (PyTorch port of ``python -m repro.obs``; the two
read each other's files).

    python -m repro_torch.obs run.jsonl                   # summarize a run
    python -m repro_torch.obs --diff a.jsonl b.jsonl      # compare two runs
    python -m repro_torch.obs --validate run.jsonl        # schema check
    python -m repro_torch.obs --export-trace run.jsonl -o trace.json
    python -m repro_torch.obs --smoke-run out.jsonl --algo mpbcfw

``--smoke-run`` drives the reference's tiny deterministic
(CostModel-clocked) Solver run with a :class:`~repro_torch.obs.RunRecorder`
installed, on CUDA unless ``--device cpu`` is given: it raises on a host
without a card rather than falling back to the CPU.

Exit status: nonzero on validation errors or unreadable runs.
"""
from __future__ import annotations

import argparse
import sys


def _smoke_run(out_path: str, algo: str, seed: int, iters: int,
               device: str) -> int:
    # Local imports: the summarize/diff/validate/export paths never import
    # torch.
    from ..api import CostModel, RunConfig, Solver
    from ..core.oracles import multiclass
    from ..data import synthetic
    from . import RunRecorder

    x, y = synthetic.usps_like(n=24, f=8, num_classes=4, seed=7)
    problem = multiclass.make_problem(x, y, 4, device=device)
    cfg = RunConfig(lam=0.1, algo=algo, cap=8, ttl=5, max_iters=iters,
                    max_approx_passes=12, approx_batch=4, seed=seed,
                    cost_model=CostModel(oracle_cost=1.0, plane_cost=1e-3))
    with RunRecorder(out_path) as rec:
        Solver(problem, cfg, recorder=rec).run()
    print(f"smoke run ({algo}, seed={seed}, {iters} iters, {device}) -> "
          f"{out_path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize, diff, validate, and export obs run traces.")
    ap.add_argument("runs", nargs="*", help="run JSONL file(s)")
    ap.add_argument("--diff", action="store_true",
                    help="diff two runs (requires exactly two files)")
    ap.add_argument("--validate", action="store_true",
                    help="validate the JSONL against the schema")
    ap.add_argument("--export-trace", action="store_true",
                    help="write a Chrome-trace/Perfetto JSON")
    ap.add_argument("-o", "--out", default=None,
                    help="output path for --export-trace")
    ap.add_argument("--smoke-run", action="store_true",
                    help="produce a tiny recorded run at RUNS[0]")
    ap.add_argument("--algo", default="mpbcfw",
                    help="engine for --smoke-run (default: mpbcfw)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="device of --smoke-run (default: cuda; no "
                    "fallback to the CPU)")
    args = ap.parse_args(argv)

    if args.smoke_run:
        if len(args.runs) != 1:
            ap.error("--smoke-run needs exactly one output path")
        return _smoke_run(args.runs[0], args.algo, args.seed, args.iters,
                          args.device)

    from .schema import validate_file
    from .summary import (diff_runs, format_diff, format_summary, load_run,
                          summarize)

    if args.validate:
        if not args.runs:
            ap.error("--validate needs at least one run file")
        status = 0
        for path in args.runs:
            count, errs = validate_file(path)
            if errs:
                status = 1
                print(f"{path}: {count} records, {len(errs)} error(s)")
                for e in errs[:20]:
                    print(f"  {e}")
            else:
                print(f"{path}: {count} records, schema OK")
        return status

    if args.export_trace:
        from .trace_export import export_chrome_trace

        if len(args.runs) != 1 or not args.out:
            ap.error("--export-trace needs one run file and -o OUT")
        n = export_chrome_trace(args.runs[0], args.out)
        print(f"{args.out}: {n} trace events")
        return 0

    if args.diff:
        if len(args.runs) != 2:
            ap.error("--diff needs exactly two run files")
        print(format_diff(diff_runs(load_run(args.runs[0]),
                                    load_run(args.runs[1]))))
        return 0

    if len(args.runs) != 1:
        ap.error("expected one run file (or --diff with two)")
    print(format_summary(summarize(load_run(args.runs[0]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
