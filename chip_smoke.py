#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

  1. build    -- compile the kernels in ``src/repro_torch/kernels/csrc`` with
                 nvcc for sm_90a (one process per source, in parallel).
  2. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the main path's shapes and at ragged ones, then timed
                 with CUDA events beside its plain version, its bound and
                 (where one exists) a single PyTorch call computing the same
                 function.
  3. parity   -- a short Solver run of the port on the card against the same
                 run on the CPU (plain versions), on the CI-sized OCR
                 scenario.
  4. main     -- the main path: Solver + mpbcfw on the full-size OCR chain
                 scenario (n=6877, f=128, C=26, d=4004, cap=64), 3 outer
                 iterations, with every kernel launch counted.
  5. profile  -- where the main path's time goes: one exact-pass and one
                 approximate-pass window on the trained state, timed plain
                 and then under torch.profiler (device busy share, kernels
                 per block step, device time by kernel).
  6. kernels line, the card's name and power limit, and the result line
     ``{"ok": true, "device": {...}}`` last.

Any failed check raises, so the script exits non-zero and prints no result
line.  It needs a CUDA device and the repository's ``src`` tree beside it.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 3e-5                      # kernel vs plain: |err| <= TOL*(1+|ref|)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, data sheet
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores

# The full-size OCR chain scenario (configs/paper.py::OCR) and the run.
OCR = dict(n=6877, f=128, num_labels=26, mean_len=8, max_len=14, seed=0)
RUN = dict(algo="mpbcfw", cap=64, ttl=10, max_iters=3, approx_batch=8,
           max_approx_passes=8)
ORACLE_COST, PLANE_COST = 0.3, 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(nbytes: float, ops: float):
    """Least time for the work: bytes over HBM rate vs fp32 ops over peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, calls: int, warmup: int = 3) -> float:
    """Mean milliseconds per ``fn(k)`` call, k = 0..calls-1, CUDA events."""
    for k in range(warmup):
        fn(k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(calls):
        fn(k)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.SOURCES}
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds,
         ptxas=ptxas)


def check_plane_scores(torch, gen):
    from repro_torch.kernels import ops, ref

    def case(n, d):
        block = torch.randn((n, d + 1), generator=gen, device="cuda")
        w = torch.randn((d,), generator=gen, device="cuda")
        P, b = block[:, :-1], block[:, -1]       # strided, unaligned views
        out = ops.plane_scores(P, w, b)
        want = ref.plane_scores_ref(P, w, b)
        torch.cuda.synchronize()
        err = (out - want).abs()
        check(bool((err <= TOL * (1 + want.abs())).all()),
              f"plane_scores {n}x{d}: max err {float(err.max())}")
        return float(err.max())

    main_err = case(64, 4004)
    ragged = {f"{n}x{d}": case(n, d) for n in (1, 7, 65, 4096)
              for d in (1, 127, 4004)}

    # Main-path timing: blocks of a 131 MB stack (> the 50 MB L2), as an
    # approximate pass walks the 7 GB cache and finds each block cold.
    nblk, cap, d = 128, 64, 4004
    stack = torch.randn((nblk, cap, d + 1), generator=gen, device="cuda")
    w = torch.randn((d,), generator=gen, device="cuda")
    ms = time_ms(torch, lambda k: ops.plane_scores(
        stack[k % nblk, :, :-1], w, stack[k % nblk, :, -1]), 4 * nblk)
    plain_ms = time_ms(torch, lambda k: ref.plane_scores_ref(
        stack[k % nblk, :, :-1], w, stack[k % nblk, :, -1]), 4 * nblk)
    library_ms = time_ms(torch, lambda k: torch.addmv(
        stack[k % nblk, :, -1], stack[k % nblk, :, :-1], w), 4 * nblk)
    bms, by = bound_ms(4.0 * (cap * d + d + 2 * cap), 2.0 * cap * d)
    emit("kernel", name="plane_scores", shape=[cap, d], max_abs_err=main_err,
         ragged_max_abs_err=ragged, ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, bound_ms=bms, bound_by=by)
    return dict(name="plane_scores", route="cuda",
                source="src/repro_torch/kernels/csrc/plane_scores.cu",
                replaces="src/repro/kernels/plane_scores.py:52",
                max_abs_err=max([main_err, *ragged.values()]), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms)


def viterbi_work(mask, C: int):
    """(bytes, ops) a decode of these rows needs: unaries, table, mask and
    labels once; 2*C*C max-adds per valid step, C per padded step and for
    the final argmax."""
    B, L = mask.shape
    valid_steps = int(mask[:, 1:].sum())
    padded_steps = B * (L - 1) - valid_steps
    nbytes = 4 * B * L * C + 4 * C * C + B * L + 4 * B * L
    return nbytes, 2 * C * C * valid_steps + C * (padded_steps + B)


def check_viterbi(torch, gen, masks):
    from repro_torch.kernels import ops, ref
    C = OCR["num_labels"]
    L = masks.shape[1]

    def inputs(B, tie):
        mask = masks[:B].contiguous()
        if tie:   # small integers: many exactly equal candidates
            unary = torch.randint(-2, 3, (B, L, C), generator=gen,
                                  device="cuda").float()
            trans = torch.randint(-2, 3, (C, C), generator=gen,
                                  device="cuda").float()
        else:
            unary = torch.randn((B, L, C), generator=gen, device="cuda")
            trans = torch.randn((C, C), generator=gen, device="cuda")
        return unary, trans, mask

    results = {}
    for B in (1, masks.shape[0]):
        for tie in (False, True):
            unary, trans, mask = inputs(B, tie)
            got = ops.viterbi_decode(unary, trans, mask)
            want = ref.viterbi_decode_ref(unary, trans, mask)
            want_cpu = ref.viterbi_decode_ref(unary.cpu(), trans.cpu(),
                                              mask.cpu())
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"viterbi B={B} tie={tie}: "
                  "kernel labels differ from the plain version on the card")
            check(torch.equal(got.cpu(), want_cpu), f"viterbi B={B} "
                  f"tie={tie}: kernel labels differ from the CPU plain run")
            results[f"B{B}{'_tie' if tie else ''}"] = 0
    timing = {}
    for B in (1, masks.shape[0]):
        unary, trans, mask = inputs(B, False)
        calls = 200 if B == 1 else 20
        nbytes, ops_n = viterbi_work(mask, C)
        bms, by = bound_ms(nbytes, ops_n)
        timing[B] = dict(
            ms=time_ms(torch, lambda k: ops.viterbi_decode(unary, trans, mask),
                       calls),
            plain_ms=time_ms(torch, lambda k: ref.viterbi_decode_ref(
                unary, trans, mask), max(calls // 10, 2)),
            bound_ms=bms, bound_by=by)
    emit("kernel", name="viterbi_decode", shape=[1, L, C], checks=results,
         timing={f"B={B}": t for B, t in timing.items()},
         library_ms=None, library_note="no single PyTorch call decodes a "
         "chain; the plain version is a loop of L steps")
    t1 = timing[1]
    return dict(name="viterbi_decode", route="cuda",
                source="src/repro_torch/kernels/csrc/viterbi.cu",
                replaces="src/repro/kernels/viterbi.py:34", max_abs_err=0.0,
                ms=t1["ms"], plain_ms=t1["plain_ms"], bound_ms=t1["bound_ms"],
                bound_by=t1["bound_by"], library_ms=None)


def phase_parity(torch):
    """The port on the card vs the port on the CPU (plain versions), on the
    CI-sized OCR scenario: same schedule, duals within rtol 1e-4."""
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.configs.paper import SMALL
    from repro_torch.core.oracles import chain
    from repro_torch.data.synthetic import ocr_like
    sc = SMALL["ocr"]
    X, Y, M = ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                       mean_len=sc.mean_len, max_len=sc.max_len, seed=0)
    traces = {}
    for dev in ("cuda", "cpu"):
        cfg = RunConfig(lam=1.0 / sc.n, max_iters=3, cap=16, approx_batch=4,
                        max_approx_passes=6,
                        cost_model=CostModel(sc.oracle_cost, sc.plane_cost))
        prob = chain.make_problem(X, Y, M, sc.num_classes, device=dev)
        traces[dev] = Solver(prob, cfg).run().trace
    rows = []
    for g, c in zip(traces["cuda"], traces["cpu"]):
        check((g.n_exact, g.n_approx, g.approx_passes)
              == (c.n_exact, c.n_approx, c.approx_passes),
              f"parity: schedule differs at iteration {g.iteration}")
        for f in ("dual", "primal"):
            a, b = getattr(g, f), getattr(c, f)
            check(abs(a - b) <= 1e-4 * abs(b) + 1e-7,
                  f"parity: {f} {a} vs {b} at iteration {g.iteration}")
        rows.append([g.dual, c.dual, g.primal, c.primal, g.approx_passes])
    emit("parity", scenario="SMALL[ocr]", rows=rows)


def phase_main(torch, data):
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.kernels import ops
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    check(problem.d == 4004, f"d = {problem.d}, expected 4004")
    torch.cuda.reset_peak_memory_stats()
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, cost_model=CostModel(oracle_cost=ORACLE_COST,
                                          plane_cost=PLANE_COST), **RUN))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    walls, rows = [], []
    rows_iter = solver.iterate()
    while True:
        t0 = time.perf_counter()
        row = next(rows_iter, None)
        torch.cuda.synchronize()
        if row is None:
            break
        walls.append(time.perf_counter() - t0)
        rows.append(row)
        emit("main_row", wall_s=walls[-1], **row.__dict__)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(len(rows) == RUN["max_iters"], f"{len(rows)} iterations ran")
    prev = -float("inf")
    for r in rows:
        check(r.dual >= prev, f"dual decreased at iteration {r.iteration}")
        check(r.gap >= -1e-5 * abs(r.primal),
              f"negative gap {r.gap} at iteration {r.iteration}")
        check(math.isfinite(r.dual) and math.isfinite(r.primal),
              f"non-finite objective at iteration {r.iteration}")
        prev = r.dual
    last = rows[-1]
    check(last.n_exact == n * len(rows), f"n_exact {last.n_exact}")
    check(launches["plane_scores"] >= last.n_approx,
          f"plane_scores launches {launches['plane_scores']} < n_approx "
          f"{last.n_approx}")
    check(launches["viterbi_decode"] >= last.n_exact,
          f"viterbi launches {launches['viterbi_decode']} < n_exact "
          f"{last.n_exact}")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    w = solver.result().w
    check(w.shape == (4004,) and all(map(math.isfinite, w.tolist())),
          "weights not finite")
    emit("main", scenario="OCR", n=n, d=problem.d, cap=RUN["cap"],
         iterations=len(rows), wall_s_per_iteration=walls,
         max_memory_allocated=peak, launches=launches,
         n_exact=last.n_exact, n_approx=last.n_approx)
    return launches, solver


def phase_profile(torch, solver, n_exact: int = 256, n_approx: int = 1024):
    """Host and device time of the two passes on the trained state: each
    window is timed untraced, then traced.  Busy share = device time of
    all kernels and copies / the traced window's wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import mpbcfw
    problem, lam = solver.problem, solver.cfg.lam
    mp = solver.state
    passes = {
        "exact": (n_exact, lambda m, blocks: mpbcfw.exact_pass(
            problem, m, blocks, lam)),
        "approx": (n_approx, lambda m, blocks: mpbcfw.approx_pass(
            None, m, blocks, lam)),
    }
    out = {}
    for name, (count, run) in passes.items():
        blocks = np.arange(count)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp = run(mp, blocks)
        torch.cuda.synchronize()
        untraced = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mp = run(mp, blocks)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kernel = {}
        for e in dev:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us())
        busy_us = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        out[name] = dict(
            blocks=count, ms_per_block=1e3 * untraced / count,
            traced_ms_per_block=1e3 * traced / count,
            device_events=len(dev),
            device_ops_per_block=len(dev) / count,
            device_us_per_block=busy_us / count,
            device_busy_share=(busy_us * 1e-6 / traced) if dev else None,
            top_device_us=[[k[:60], v] for k, v in top])
    emit("profile", scenario="OCR", **out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()

    from repro_torch.data.synthetic import ocr_like
    t0 = time.perf_counter()
    data = ocr_like(**OCR)
    emit("data", seconds=time.perf_counter() - t0, shape=list(data[0].shape))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    masks = torch.from_numpy(data[2]).cuda()
    kernels = [check_plane_scores(torch, gen),
               check_viterbi(torch, gen, masks)]
    phase_parity(torch)
    launches, solver = phase_main(torch, data)
    phase_profile(torch, solver)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
