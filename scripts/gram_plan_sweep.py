#!/usr/bin/env python3
"""B4 ``gram`` under every launch plan it builds, on a card.

    python3 scripts/gram_plan_sweep.py

``kernels/gram.py::plan`` picks a tile edge and a split-K cluster size
from the shape alone.  This script launches the kernel under each (tile,
split) the source accepts at one plane-cache block (64, 4004) and at a
flattened 64-block working set (4096, 4004), read in place from rows of
4005 floats, and prints one JSON line per plan: milliseconds per call
with the host out of the loop (the calls captured in one CUDA graph,
replayed between two CUDA events), the kernel's own device time per call
from torch.profiler, and whether it is the plan the wrapper picks;
``torch.mm(P, P.T)`` (TF32 off) is timed the same way.  Last, the card's
name and power limit.  ~30 s.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import gram as kgram  # noqa: E402


def launch(P, tile: int, split: int):
    n, d = P.shape
    out = torch.empty((n, n), dtype=torch.float32, device=P.device)
    rc = kgram._lib().gram_launch(P.data_ptr(), P.stride(0), out.data_ptr(),
                                  n, d, tile, split,
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gram ({tile}, {split}) failed: cudaError {rc}")
    return out


def graph_ms(fn, calls: int):
    """ms per call of ``fn`` from one replay of ``calls`` captured calls,
    and the device us per call of the kernels whose name holds ``gram``
    or ``gemm`` in a traced replay."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return ms, sum(e.time_range.elapsed_us() for e in dev) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("gram_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    d = 4004
    for n, calls in ((64, 200), (4096, 10)):
        P = torch.randn((n, d + 1), generator=gen, device="cuda")[:, :d]
        want = torch.mm(P, P.T)
        picked = kgram.plan(n, d)
        ms, us = graph_ms(lambda: torch.mm(P, P.T), calls)
        print(json.dumps({"shape": [n, d], "call": "torch.mm", "ms": ms,
                          "device_us": us}), flush=True)
        for tile in kgram.TILES:
            for split in (1, 2, 4, 8, 16):
                if n == 4096 and split > 1:
                    continue
                got = launch(P, tile, split)
                err = float((got - want).abs().max())
                ms, us = graph_ms(lambda: launch(P, tile, split), calls)
                print(json.dumps({
                    "shape": [n, d], "tile": tile, "split": split,
                    "picked": (tile, split) == picked, "ms": ms,
                    "device_us": us, "symmetric": bool(torch.equal(
                        got, got.T)), "max_abs_err": err}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
