#!/usr/bin/env python3
"""The port's dry-run records beside the reference's compiled ones, cell
by cell, and the op that sets the port's peak where its temporaries
exceed the reference's.

    python3 scripts/dryrun_side_by_side.py [--port DIR] [--reference DIR]
        [--peak-ops]
    python3 scripts/dryrun_side_by_side.py --peak-op ARCH SHAPE MESH

Make the records first, both under the git-ignored ``results/``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
        (-> results/torch/dryrun/)
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all
        (-> results/dryrun/)

The first form prints one markdown row per (arch, shape): the port's
per-device FLOPs, all-trips collective bytes, arguments and temporaries
on 256 and 512 ranks, then the reference's temporaries on both
(``memory_analysis`` of its XLA compile).  It names each cell
whose port temporaries exceed the reference's, and each whose arguments
are neither the reference's nor the reference's less 4 bytes (its step
counter or position).  ``--peak-ops`` traces each such cell again in a
subprocess (``--peak-op``) and prints the local op that last raised the
counter's peak: its aten name, output shapes, the autograd node running
it (in a backward), the innermost ``repro_torch`` lines that called it
and the largest storages live at that peak.

It imports ``repro_torch`` (the cells' order, ``--peak-op``) and
nothing of the reference, whose records it reads as JSON.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
#: The reference's step counter (train) or decode position: an int32
#: scalar among its arguments that the port keeps on the host.
COUNTER_BYTES = 4


def _records(directory: pathlib.Path) -> dict:
    out = {}
    for path in sorted(directory.glob("*_baseline.json")):
        rec = json.loads(path.read_text())
        out[rec["arch"], rec["shape"], rec["mesh"]] = rec
    return out


def _port_cell(rec) -> str:
    if not rec:
        return "missing"
    if not rec.get("ok"):
        return f"FAILED {rec.get('error', '')[:60]}"
    mem = rec["memory_analysis"]
    return (f"{rec['flops']:.4e}, "
            f"{rec['collective_bytes_all_trips']:.4e}, "
            f"{mem['argument_size_in_bytes']:,} / "
            f"{mem['temp_size_in_bytes']:.4e}")


def side_by_side(port: dict, ref: dict) -> tuple:
    """``(rows, findings)``: the markdown rows and, per cell and mesh,
    where the port's temporaries exceed the reference's or its arguments
    differ from them by other than the counter."""
    rows, findings = [], []
    from repro_torch.launch.dryrun import all_cells
    cells = list(all_cells())
    cells += sorted({(a, s) for a, s, _ in list(port) + list(ref)}
                    - set(cells))
    for arch, shape in cells:
        cols, ref_temps = [], []
        for mesh in MESHES:
            p, r = port.get((arch, shape, mesh)), ref.get((arch, shape, mesh))
            cols.append(_port_cell(p))
            if not (r and r.get("ok")):
                ref_temps.append("not compiled")
                continue
            rm = r["memory_analysis"]
            ref_temps.append(f"{rm['temp_size_in_bytes']:.4e}")
            if not (p and p.get("ok")):
                continue
            pm = p["memory_analysis"]
            if pm["temp_size_in_bytes"] > rm["temp_size_in_bytes"]:
                findings.append(dict(
                    arch=arch, shape=shape, mesh=mesh, what="temp",
                    port=pm["temp_size_in_bytes"],
                    reference=rm["temp_size_in_bytes"]))
            gap = rm["argument_size_in_bytes"] - pm["argument_size_in_bytes"]
            if gap not in (0, COUNTER_BYTES):
                findings.append(dict(
                    arch=arch, shape=shape, mesh=mesh, what="arguments",
                    port=pm["argument_size_in_bytes"],
                    reference=rm["argument_size_in_bytes"]))
        rows.append(f"| {arch} `{shape}` | {cols[0]} | {cols[1]} | "
                    f"{ref_temps[0]} / {ref_temps[1]} |")
    return rows, findings


# ---------------------------------------------------------------------------
# The op that sets a cell's peak


def peak_op(arch: str, shape: str, mesh: str) -> dict:
    """Trace one cell as ``launch.dryrun.run_cell`` does, with a dispatch
    mode above the counter that notes the local op after which the
    counter's peak last rose."""
    import os
    import time
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch import dryrun

    src = os.sep + "repro_torch" + os.sep
    skip = (os.path.join("launch", "dryrun.py"),
            os.path.join("launch", "trace_analysis.py"))

    class PeakWatch(TorchDispatchMode):
        def __init__(self, counter):
            super().__init__()
            self.counter = counter
            self.at = {}

        def _callers(self) -> list:
            """The innermost three ``repro_torch`` lines on the stack."""
            out, f = [], sys._getframe(2)
            while f is not None and len(out) < 3:
                name = f.f_code.co_filename
                if src in name and not name.endswith(skip):
                    out.append(f"{name.split(src, 1)[1]}:{f.f_lineno} "
                               f"{f.f_code.co_name}")
                f = f.f_back
            return out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if DTensor in types or func is dryrun._DEVICE:
                return NotImplemented
            before = self.counter.peak_bytes
            out = func(*args, **(kwargs or {}))
            if self.counter.peak_bytes > before:
                node = torch._C._current_autograd_node()
                live = sorted((st.nbytes() for st, ref in
                               self.counter._storages.items()
                               if ref is not None), reverse=True)
                self.at = dict(
                    peak=self.counter.peak_bytes, op=str(func),
                    out=[[list(t.shape), str(t.dtype).replace("torch.", "")]
                         for t in dryrun._tensors(out)],
                    node=None if node is None else node.name(),
                    callers=self._callers(), largest_live=live[:4])
            return out

    watches = []

    def trace_step(step, args):
        counter = dryrun.LocalCounter()
        counter.hold(args)
        watch = PeakWatch(counter)
        t0 = time.time()
        with counter, watch:
            out = step(*args)
        watches.append(watch)
        return counter, out, time.time() - t0

    dryrun.trace_step = trace_step
    rec = dryrun.run_cell(arch, shape, mesh == "multi")
    return dict(arch=arch, shape=shape, mesh=mesh,
                temp=rec["memory_analysis"]["temp_size_in_bytes"],
                **watches[-1].at)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", default=str(ROOT / "results" / "torch"
                                          / "dryrun"))
    ap.add_argument("--reference", default=str(ROOT / "results" / "dryrun"))
    ap.add_argument("--peak-ops", action="store_true")
    ap.add_argument("--peak-op", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.peak_op:
        print(json.dumps(peak_op(*args.peak_op)))
        return
    port = _records(pathlib.Path(args.port))
    ref = _records(pathlib.Path(args.reference))
    rows, findings = side_by_side(port, ref)
    print("| cell | port, 256 ranks | port, 512 ranks | reference temp, "
          "256 / 512 |")
    print("| --- | --- | --- | --- |")
    print("\n".join(rows))
    for f in findings:
        if args.peak_ops and f["what"] == "temp":
            done = subprocess.run(
                [sys.executable, __file__, "--peak-op", f["arch"],
                 f["shape"], f["mesh"]], capture_output=True, text=True)
            f["peak"] = (json.loads(done.stdout.strip().splitlines()[-1])
                         if done.returncode == 0 else done.stderr[-2000:])
        print(json.dumps(f))


if __name__ == "__main__":
    main()
