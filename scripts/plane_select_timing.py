#!/usr/bin/env python3
"""B2 ``plane_select`` timed again and again by both of the smoke's
yardsticks, on a card.

    python3 scripts/plane_select_timing.py [--src DIR] [--reps N] [--plans]

All 6877 rows of a (6877, 64, 4004) cache, read through a permutation as
the pipelined path reads them, at the path's density (2/64, with
``chip_smoke.py``'s empty rows and ties) and with every slot valid.  Each
repetition times the kernel by ``chip_smoke.graph_ms`` (the calls captured
in one CUDA graph) and ``chip_smoke.time_ms`` (the event loop), at 5 and
at 20 calls per timing, in an order that alternates between repetitions,
while ``nvidia-smi`` samples the card's SM and memory clocks, power draw
and temperature every 20 ms.  Each timing prints one JSON line with the
samples taken during it; each density prints the bound from its valid
count (``chip_smoke.select_bound``) and a hash of the result's bits, which
every tree that keeps the kernel's order must share.

``--src`` times the kernel of another checkout's ``src`` tree (a parent
commit's), so that two trees can be run in turn on one card.
``--after-plain`` then times all valid by both yardsticks at 5 calls
right after two calls of the plain version (``ref.plane_select_ref``,
whose 7 GB gather the allocator keeps cached, as it is when
``chip_smoke.py`` times B2), and again with that cache emptied and 0.5 s
waited before the timing.  ``--plans``
(this tree only) then launches the kernel through its library under each
rows-per-CTA and place of w that fits shared memory, at both densities and
at k = 64, checks that each gives the picked plan's bits, and times
``index_select`` of the path's valid planes (read once, written once) as a
yardstick of the card on the same scattered bytes.  Last, the card's name
and power limit.  ~20 s per tree.
"""
import argparse
import datetime
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
N, CAP, D = 6877, 64, 4004
SMI = ["nvidia-smi", "-i", "0", "--format=csv,noheader,nounits",
       "--query-gpu=timestamp,clocks.sm,clocks.mem,power.draw,"
       "temperature.gpu"]


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src tree whose kernel is timed")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--after-plain", action="store_true",
                    help="also time all valid right after the plain "
                    "version, with and without its cache emptied")
    ap.add_argument("--plans", action="store_true",
                    help="also time every plan of this tree's kernel")
    return ap.parse_args()


class Sampler:
    """nvidia-smi sampling the card every 20 ms; :meth:`during` gives the
    samples taken between two host times."""

    def __init__(self):
        self.proc = subprocess.Popen(SMI + ["-lms", "20"],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        self.rows = None
        time.sleep(1.0)                     # its first sample

    def stop(self):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.rows = []
        for line in out.splitlines():
            f = [x.strip() for x in line.split(",")]
            try:
                at = datetime.datetime.strptime(f[0], "%Y/%m/%d %H:%M:%S.%f")
                self.rows.append((at, *(float(x) for x in f[1:])))
            except (ValueError, IndexError):
                continue

    def during(self, t0, t1):
        got = [r for r in self.rows if t0 <= r[0] <= t1]
        if not got:
            return None
        cols = list(zip(*got))
        return dict(samples=len(got),
                    sm_mhz=[min(cols[1]), max(cols[1])],
                    mem_mhz=[min(cols[2]), max(cols[2])],
                    power_w=[min(cols[3]), max(cols[3])],
                    temp_c=[min(cols[4]), max(cols[4])])


def masks(gen):
    """The path's density as chip_smoke.py::check_plane_select makes it,
    and every slot valid."""
    path = torch.rand((N, CAP), generator=gen, device="cuda") < 2.0 / CAP
    path[::11] = False
    path[1::5, 10] = path[1::5, 40] = True
    return (("path", path),
            ("full", torch.ones((N, CAP), dtype=torch.bool, device="cuda")))


def bits(best, idx) -> str:
    return hashlib.sha256(best.cpu().numpy().tobytes()
                          + idx.cpu().numpy().tobytes()).hexdigest()[:16]


def yardsticks(smoke, ops, P, b, w, rows, gen, reps, tree):
    timings = []
    for density, valid in masks(gen):
        best, idx = ops.plane_select(P, w, b, valid, rows=rows)
        n_valid, bound, _ = smoke.select_bound(torch, valid, rows, D)
        print(json.dumps({"tree": tree, "density": density,
                          "valid_slots": n_valid, "bound_ms": bound,
                          "bits": bits(best, idx)}), flush=True)

        def kernel(k, valid=valid):
            return ops.plane_select(P, w, b, valid, rows=rows)
        ways = [("graph_ms", 5), ("event_loop_ms", 5), ("graph_ms", 20),
                ("event_loop_ms", 20)]
        for rep in range(reps):
            for way, calls in (ways if rep % 2 == 0 else ways[::-1]):
                timer = smoke.graph_ms if way == "graph_ms" else smoke.time_ms
                t0 = datetime.datetime.now()
                ms = timer(torch, kernel, calls)
                t1 = datetime.datetime.now()
                timings.append(dict(tree=tree, density=density, rep=rep,
                                    way=way, calls=calls, ms=ms,
                                    over_bound=ms / bound, t0=t0, t1=t1))
    return timings


def after_plain(smoke, ops, ref, P, b, w, rows, reps, tree):
    valid = torch.ones((N, CAP), dtype=torch.bool, device="cuda")

    def kernel(k):
        return ops.plane_select(P, w, b, valid, rows=rows)
    for rep in range(reps):
        for emptied in (False, True):
            for _ in range(2):
                ref.plane_select_ref(P, w, b, valid, rows)
            torch.cuda.synchronize()
            cached = torch.cuda.memory_reserved() \
                - torch.cuda.memory_allocated()
            if emptied:
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                time.sleep(0.5)
            print(json.dumps({
                "tree": tree, "after_plain": True, "emptied_first": emptied,
                "rep": rep, "cached_gb": cached / 1e9,
                "graph_ms": smoke.graph_ms(torch, kernel, 5),
                "event_loop_ms": smoke.time_ms(torch, kernel, 5)}),
                flush=True)


def plans(smoke, ops, t_psel, stack, w, rows, gen):
    """Every rows-per-CTA and place of w, through the library's launch."""
    P, b = stack[..., :-1], stack[..., -1]
    lib = t_psel._lib()
    chunk = t_psel.chunk_of(D)

    def launch(valid, sel, per_cta, w_shared):
        k = sel.numel()
        best = torch.empty(k, device="cuda")
        idx = torch.empty(k, dtype=torch.int32, device="cuda")
        rc = lib.plane_select_launch(
            P.data_ptr(), P.stride(0), P.stride(1), w.data_ptr(),
            b.data_ptr(), b.stride(0), b.stride(1), valid.data_ptr(),
            valid.stride(0), valid.stride(1), sel.data_ptr(), k, N, CAP, D,
            float(ops.INVALID_SCORE), best.data_ptr(), idx.data_ptr(),
            per_cta, chunk, int(w_shared),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"plane_select ({per_cta}, {w_shared}): "
                               f"cudaError {rc}")
        return best, idx
    for density, valid in masks(gen):
        for k in (N, 64):
            slices = [rows[i:i + k] for i in range(0, N - k + 1, k)]
            picked = t_psel.plan(k, CAP, D)
            want = ops.plane_select(P, w, b, valid, rows=slices[0])
            calls = 20 if k == 64 or density == "path" else 5
            for per_cta in (1, 2, 4, 8, 16):
                for w_shared in (True, False):
                    need = t_psel.smem_bytes(per_cta, chunk, D, CAP, w_shared)
                    if need > t_psel.SMEM_LIMIT or per_cta > k:
                        continue
                    got = launch(valid, slices[0], per_cta, w_shared)
                    same = bool(torch.equal(got[0], want[0])
                                and torch.equal(got[1], want[1]))
                    ms = smoke.graph_ms(torch, lambda i: launch(
                        valid, slices[i % len(slices)], per_cta, w_shared),
                        calls)
                    print(json.dumps({
                        "plan": {"rows": per_cta, "w_shared": w_shared},
                        "density": density, "k": k, "ms": ms,
                        "picked": (per_cta, w_shared) == (picked.rows,
                                                          picked.w_shared),
                        "bits_equal_picked": same}), flush=True)
                    if not same:
                        raise RuntimeError("a plan changed the bits")
    path = masks(gen)[0][1]
    flat = stack.view(N * CAP, D + 1)
    slots = torch.arange(CAP, device="cuda")
    ids = (rows[:, None] * CAP + slots)[path[rows]]
    ms = smoke.graph_ms(torch, lambda i: flat.index_select(0, ids), 5)
    nbytes = 2 * 4 * ids.numel() * (D + 1)
    print(json.dumps({"reference": "index_select of the path's valid planes",
                      "planes": ids.numel(), "ms": ms,
                      "read_and_written_bytes": nbytes,
                      "rate_tb_s": nbytes / ms * 1e-9}), flush=True)


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("plane_select_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import plane_select as t_psel
    tree = str(Path(args.src).resolve().relative_to(ROOT)
               if Path(args.src).resolve().is_relative_to(ROOT)
               else args.src)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stack = torch.randn((N, CAP, D + 1), generator=gen, device="cuda") \
        / math.sqrt(D)
    stack[1::5, 40] = stack[1::5, 10]
    P, b = stack[..., :-1], stack[..., -1]
    w = torch.randn((D,), generator=gen, device="cuda")
    rows = torch.randperm(N, generator=gen, device="cuda")
    ops.plane_select(P, w, b, torch.ones((N, CAP), dtype=torch.bool,
                                         device="cuda"), rows=rows)
    torch.cuda.synchronize()                    # built and loaded
    sampler = Sampler()
    try:
        timings = yardsticks(smoke, ops, P, b, w, rows, gen, args.reps, tree)
    finally:
        sampler.stop()
    for t in timings:
        t["card"] = sampler.during(t.pop("t0"), t.pop("t1"))
        print(json.dumps(t), flush=True)
    if args.after_plain:
        after_plain(smoke, ops, ref, P, b, w, rows, args.reps, tree)
    if args.plans:
        plans(smoke, ops, t_psel, stack, w, rows, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
