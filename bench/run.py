"""Run one cell of the port's benchmark once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (timed as ``setup_s``): import,
CUDA, the cell's data from ``--seed`` on the card, the port's problem and
``Solver``, and the warm-up iterations, which build and load every kernel
(``build/repro_torch/``, inside the checkout) and capture the block
steps' CUDA graphs.  Then the window: ``Solver.iterate()`` in a closed
loop for ``--seconds``; with ``--trace 1`` one iteration of it under the
profiler.  Then the plain reference decides ``correct``.  Earlier lines of
standard output carry each iteration's row, the card's clocks and power
limit and the traced kernel counts; the last line is the result object.
The numbers compared for ``correct`` close standard error, each with its
limit.

Exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), where the port cannot be imported, and
where a module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """The checkout's root (this package) and the port's ``src`` first on
    the path; the build caches at fixed paths inside the checkout."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    marks = [("python", time.perf_counter())]
    import torch
    marks.append(("import_torch", time.perf_counter()))
    from bench.harness import Cell, forbidden_modules, run_cell
    chips = int(Cell(ROOT, args.workload).entry.get("chips", 1))
    marks.append(("import_harness", time.perf_counter()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    marks.append(("cuda_query", time.perf_counter()))
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START,
                      marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
