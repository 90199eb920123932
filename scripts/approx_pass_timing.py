#!/usr/bin/env python3
"""``approx_pass``'s whole-pass time on the trained full-size OCR state,
for this tree or another checkout's ``src`` tree, on a card.

    python3 scripts/approx_pass_timing.py [--src DIR] [--reps N]

Trains ``chip_smoke.py``'s main run with the tree's own code (mpbcfw on
the full-size OCR scenario, n = 6877, d = 4004, cap 64, 3 outer
iterations of up to 8 passes), then times one whole approximate pass over
all 6877 blocks (one launch) by CUDA events, in the plain mode and in the
Sec-3.5 mode (10 steps, the Gram leaf computed from the trained planes),
``N`` times each, the modes in turns.  Prints one JSON line: the tree,
each timing in ms and their medians, the plan, and the registers ptxas
reported for the approx_pass builds; then the card's name and power
limit.  Run it for a parent checkout and for this tree in turns in one
call (parent, tree, tree, parent) to compare two trees on one card.
~40 s per tree, its build included.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OCR = dict(n=6877, f=128, num_labels=26, mean_len=8, max_len=14, seed=0)
RUN = dict(algo="mpbcfw", cap=64, ttl=10, max_iters=3, approx_batch=8,
           max_approx_passes=8)
STEPS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src tree whose kernel is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("approx_pass_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.data.synthetic import ocr_like
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import approx_pass as t_ap
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build(["approx_pass", "viterbi"])
    build_s = time.perf_counter() - t0
    n = OCR["n"]
    X, Y, M = ocr_like(**OCR)
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    solver = Solver(problem, RunConfig(lam=1.0 / n,
                                       cost_model=CostModel(0.3, 1e-4),
                                       **RUN))
    solver.run()
    mp, lam, c = solver.state, solver.cfg.lam, solver.state.cache
    gram = torch.bmm(c.planes[..., :-1], c.planes[..., :-1].transpose(1, 2))
    ids = torch.from_numpy(np.random.RandomState(2).permutation(n)).cuda()

    def one(steps):
        ops.approx_pass(mp.inner.phi, mp.inner.phi_i, mp.avg.bar_approx,
                        c.planes, c.valid, c.last_active, ids, lam=lam,
                        k0=mp.avg.k_approx, outer_it=mp.outer_it,
                        gram=gram if steps else None, steps=steps)

    def ms(steps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one(steps)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    modes = {"plain": None, "sec35": STEPS}
    for steps in modes.values():
        one(steps)                       # warm-up
    times = {m: [] for m in modes}
    for r in range(args.reps):
        order = list(modes) if r % 2 == 0 else list(modes)[::-1]
        for m in order:
            times[m].append(ms(modes[m]))
    regs = [ln.strip() for ln in _build.build_log("approx_pass").splitlines()
            if "registers" in ln]
    print(json.dumps({
        "tree": str(Path(args.src).resolve()), "build_s": build_s,
        "valid_planes": int(c.valid.sum()), "ms": times,
        "median_ms": {m: statistics.median(v) for m, v in times.items()},
        "plan": {m: t_ap.plan(problem.d, RUN["cap"], s or 0)._asdict()
                 for m, s in modes.items()},
        "ptxas_registers": regs}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
