"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything is found by name under the benchmark's root:
``BENCHMARK.json`` (the cell's chips and the metrics it reports),
``bench/workloads/<cell>.json`` (configuration, traffic, warm-up, the
iterations the reference follows, what a traced run traces, the limits of
``correct``), ``bench/configs/<config>.json``, ``bench/traffic/<traffic>
.json`` (the engine and its ``RunConfig`` fields), the configuration
kind's generator ``bench/data/<kind>.py`` and reference
``bench/reference/<kind>.py``, and one reader per metric,
``bench/metrics/<metric>.py`` (``read(run) -> float or None``).

The system under test is the port's main path, ``repro_torch.api.Solver``
over the problem of the port's own ``make_problem``.  The window is a
closed loop over ``Solver.iterate()``: the next outer iteration starts
when the last one has been yielded.
"""
from __future__ import annotations

import bisect
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from bench import compare, counting
from bench.trace import DeviceTrace, by_name

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TOP = 10
# The port's named kernels (``kernels/ops.py::launch_counts`` keys) and
# the text their records' names hold in the profiler's trace.
KERNEL_NAMES = {"viterbi_decode": "viterbi", "approx_pass": "approx_pass",
                "plane_scores": "plane_scores",
                "plane_select": "plane_select", "gram": "gram"}
TRACE_ATTEMPTS = 3


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """A cell's files, read by name from ``root``."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.spec = load_json(self.root / "bench" / "workloads"
                              / f"{name}.json")
        self.cfg = load_json(self.root / "bench" / "configs"
                             / f"{self.entry['config']}.json")
        self.traffic = load_json(self.root / "bench" / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.kind = self.cfg["kind"]
        self.data = importlib.import_module(f"bench.data.{self.kind}")

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports in a run of this kind."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        path = self.root / "bench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    @property
    def lam(self) -> float:
        return float(self.cfg["lam_n"]) / int(self.cfg["n"])


def solver_seed(seed: int) -> int:
    """The control loop's ``RandomState`` seed (32 bits) of a run seed."""
    return int(seed) % (2 ** 32)


class Iteration:
    """One outer iteration of the window: its trace row, its wall seconds
    (from the previous iteration's yield to this one's) and whether it
    ran under the profiler."""

    def __init__(self, row, wall: float, traced: bool):
        self.row, self.wall, self.traced = row, wall, traced


class RunRecord:
    """What a run measured, for the metric readers."""

    def __init__(self, cell: Cell, device):
        self.cell = cell
        self.device = device
        self.setup_s = 0.0
        self.setup_phases: Dict[str, float] = {}
        self.window_s = 0.0
        self.iterations: List[Iteration] = []
        self.warmup_rows: list = []
        self.peak_window_bytes = 0
        self.trace: Optional[DeviceTrace] = None
        self.traced_row = None
        self.traced_prev_row = None
        self.launches: Dict[str, int] = {}
        self.trace_complete = False
        self.work: dict = {}

    @property
    def n(self) -> int:
        return int(self.cell.cfg["n"])

    @property
    def d(self) -> int:
        return int(self.cell.cfg["d"])

    @property
    def cap(self) -> int:
        return int(self.cell.traffic["run"].get("cap", 0))

    @property
    def uses_cache(self) -> bool:
        return self.cell.traffic["engine"].startswith("mpbcfw")

    def untraced(self) -> List[Iteration]:
        return [it for it in self.iterations if not it.traced]

    def iteration_least_time(self, row) -> float:
        """Least time of the work of the iteration ``row`` reports."""
        planes = int(round(row.ws_mean * self.n))
        sweeps = int(self.cell.traffic.get("eval_sweeps", 1))
        return counting.iteration_least_time(
            self.n, self.d, self.cap, self.work, planes, row.approx_passes,
            self.uses_cache, sweeps)


def nvidia_smi() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _row_dict(row) -> dict:
    return {k: getattr(row, k) for k in (
        "iteration", "primal", "dual", "gap", "primal_avg", "approx_passes",
        "ws_mean", "host_syncs", "dispatches", "n_exact", "n_approx",
        "planes_evicted")}


def _finite(row) -> bool:
    return all(math.isfinite(v) for v in (row.primal, row.dual,
                                          row.primal_avg))


def emit(out, kind: str, **fields) -> None:
    print(json.dumps({"bench": kind, **fields}), file=out, flush=True)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, out=None,
             probe=None, marks=()) -> dict:
    """Run the cell once and return the result object (the last line's
    keys, ``checks`` last).  ``device`` is ``cuda`` on the card; the tests
    drive the same path on the CPU at small sizes.  ``probe(cell, host,
    final)``, where given, runs after the check on the same arrays (on the
    host) and the program's last weights (``readings.py``'s control; a
    benchmark run passes none); what it returns is printed beside the
    readings.  ``marks``, ``(name, perf_counter)`` pairs taken since
    ``t_start``, open the set-up's phases (``bench/run.py``'s imports)."""
    import torch
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.kernels import ops

    out = sys.stdout if out is None else out
    t_start = time.perf_counter() if t_start is None else t_start
    phases: Dict[str, float] = {}
    t_phase = [t_start]

    def phase(name: str, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        phases[name] = now - t_phase[0]
        t_phase[0] = now

    for name, when in marks:
        phase(name, when)
    phase("import_port")
    cell = Cell(root, workload)
    spec, cfg, traffic = cell.spec, cell.cfg, cell.traffic
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.empty(1, device=dev)
        _sync(dev)
    phase("device")
    rec = RunRecord(cell, dev)
    warmup = int(spec.get("warmup_iterations", 1))
    followed = int(spec["followed_iterations"])
    scope = spec.get("trace_scope", "iteration")

    # -- set-up: data from the seed, the port's problem, the Solver, the
    # warm-up iterations (every kernel built and loaded, graphs captured).
    arrays = cell.data.generate(cfg, seed, dev)
    _sync(dev)
    phase("data")
    problem = cell.data.problem(arrays, cfg)
    if problem.d != int(cfg["d"]):
        raise RuntimeError(f"d = {problem.d}, the configuration says "
                           f"{cfg['d']}")
    rec.work = cell.data.work(cfg, cell.data.stats(arrays))
    run_cfg = RunConfig(
        lam=cell.lam, algo=traffic["engine"], max_iters=10 ** 9,
        seed=solver_seed(seed),
        cost_model=CostModel(oracle_cost=float(cfg["oracle_cost"]),
                             plane_cost=float(cfg["plane_cost"])),
        **traffic["run"])
    solver = Solver(problem, run_cfg)
    engine = solver.engine
    rows = solver.iterate()
    _sync(dev)
    phase("problem_and_solver")
    followed_rows: list = []
    snapshots: list = []
    failed, attempted, error = 0, 0, None

    def take_snapshot():
        w, w_avg = engine.extract(solver.state)
        return {"w": np.asarray(w), "w_avg": None if w_avg is None
                else np.asarray(w_avg)}

    for k in range(warmup):
        t0 = time.perf_counter()
        row = next(rows)
        _sync(dev)
        rec.warmup_rows.append(row)
        if len(followed_rows) < followed:
            followed_rows.append(row)
            snapshots.append(take_snapshot())
        emit(out, "warmup_row", wall_s=time.perf_counter() - t0,
             **_row_dict(row))
        phase(f"warmup_iteration_{k + 1}")
    rec.setup_s = time.perf_counter() - t_start
    rec.setup_phases = phases
    emit(out, "setup", setup_s=rec.setup_s, phases=phases)

    # -- the window.  A traced run traces the first iteration past the
    # followed ones, and the next (up to TRACE_ATTEMPTS) where the
    # profiler's records of the port's named kernels fall short of the
    # launches the port counted (the profiler drops records on a busy
    # host): the per-layer metrics read a trace that holds every launch.
    traced_at = followed + 1 if trace else None
    attempts = 0
    need = max(followed, traced_at + 1 if trace else 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    w0 = t_prev = time.perf_counter()
    total = warmup
    while True:
        elapsed = time.perf_counter() - w0
        if elapsed >= seconds and total >= need:
            break
        it_no = total + 1
        tracer = None
        restore = None
        if traced_at == it_no:
            attempts += 1
            ops.reset_launch_counts()
            tracer = DeviceTrace(dev)
            if scope == "evaluation":
                orig = engine.evaluate

                def traced_eval(state, _orig=orig, _tr=tracer):
                    ops.reset_launch_counts()
                    with _tr:
                        return _orig(state)
                engine.evaluate = traced_eval
                restore = orig
        try:
            if tracer is not None and scope == "iteration":
                with tracer:
                    row = next(rows)
            else:
                row = next(rows)
            _sync(dev)
        except Exception:  # an iteration that raised is failed
            failed += 1
            attempted += 1
            error = traceback.format_exc()
            break
        finally:
            if restore is not None:
                engine.evaluate = restore
        now = time.perf_counter()
        wall, t_prev = now - t_prev, now
        attempted += 1
        total += 1
        if not _finite(row):
            failed += 1
        rec.iterations.append(Iteration(row, wall, tracer is not None))
        emit(out, "row", wall_s=wall, traced=tracer is not None,
             **_row_dict(row))
        if tracer is not None:
            rec.trace, rec.traced_row = tracer, row
            prev = rec.iterations[-2].row if len(rec.iterations) > 1 else (
                rec.warmup_rows[-1] if rec.warmup_rows else None)
            rec.traced_prev_row = prev
            rec.launches = ops.launch_counts()
            missing = dropped(tracer, rec.launches)
            rec.trace_complete = not missing
            emit(out, "trace_attempt", iteration=it_no, attempt=attempts,
                 dropped=missing)
            if missing and attempts < TRACE_ATTEMPTS:
                traced_at = it_no + 1
                need = max(need, traced_at + 1)
        if len(followed_rows) < followed:
            followed_rows.append(row)
            snapshots.append(take_snapshot())
            t_prev = time.perf_counter()
    rec.window_s = time.perf_counter() - w0
    if dev.type == "cuda":
        rec.peak_window_bytes = torch.cuda.max_memory_allocated(dev)
    final = None
    if attempted and not error:
        w_last, w_avg_last = engine.extract(solver.state)
        last = rec.iterations[-1].row
        final = {"w": np.asarray(w_last), "primal": last.primal}
        if int(traffic.get("eval_sweeps", 1)) > 1 and w_avg_last is not None:
            # The engine evaluates its averaged iterate too.
            final.update(w_avg=np.asarray(w_avg_last),
                         primal_avg=last.primal_avg)
    emit(out, "window", seconds=rec.window_s, attempted=attempted,
         failed=failed, error=error, card=nvidia_smi()
         if dev.type == "cuda" else None)

    # -- metrics, from what the run recorded.
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": device_info(dev, rec, trace)}
    if trace and rec.trace is not None:
        result["breakdown"] = breakdown(rec.trace)
        emit(out, "trace_counts", scope=scope, attempts=attempts,
             complete=rec.trace_complete,
             kernels=len(rec.trace.kernels()),
             device_records=len(rec.trace.device_events),
             profiler_by_kernel=kernel_calls(rec.trace),
             launch_counts=rec.launches)

    # -- free the program's state, then the reference.
    host = {k: v.detach().cpu().numpy() for k, v in arrays.items()}
    del rows, solver, engine, problem, arrays
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if final is None or len(followed_rows) < followed:
        readings = {}
        checks = {"iterations_followed": {"value": len(followed_rows),
                                          "limit": followed}}
        ok = False
    else:
        ref = compare.reference_run(
            cell, host, seed, followed,
            follow=[r.approx_passes for r in followed_rows])
        readings = compare.readings(followed_rows, snapshots, final, ref,
                                    int(cfg["n"]))
        ok, checks = compare.judge(readings, spec.get("limits", {}))
    probed = None if probe is None or final is None else probe(
        cell, host, final)
    emit(out, "reference", seconds=time.perf_counter() - t_ref,
         readings=readings, probe=probed)
    result["correct"] = bool(ok and failed == 0 and attempted > 0)
    result["checks"] = checks
    return result


def device_info(dev, rec: RunRecord, trace: bool) -> dict:
    import torch
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": int(rec.cell.entry.get("chips", 1)),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    dev))}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace and rec.trace is not None and rec.trace.window is not None:
        s, e = rec.trace.window
        info["busy_s"] = counting.union_seconds(
            (a, b) for _, a, b in rec.trace.device_events) * 1e-9
        info["window_s"] = (e - s) * 1e-9
    return info


def kernel_calls(tr: DeviceTrace) -> Dict[str, int]:
    """Kernel records per named kernel of the port, by the text of
    :data:`KERNEL_NAMES` in their names."""
    out: Dict[str, int] = {}
    for name, _, _ in tr.kernels():
        for key in KERNEL_NAMES.values():
            if key in name:
                out[key] = out.get(key, 0) + 1
    return out


def dropped(tr: DeviceTrace, launches: Dict[str, int]) -> Dict[str, list]:
    """The port's named kernels whose records in the trace differ from the
    launches the port counted over it: ``{name: [records, launches]}``
    (empty where the trace holds every launch)."""
    calls = kernel_calls(tr)
    out = {}
    for key, text in KERNEL_NAMES.items():
        want, got = int(launches.get(key, 0)), calls.get(text, 0)
        if got != want:
            out[key] = [got, want]
    return out


def breakdown(tr: DeviceTrace) -> dict:
    """The device operations that took most time, and the longest idle
    stretches of the traced window by the host op running at their
    midpoint (the innermost one; "host" where no profiled op ran)."""
    ops = sorted(by_name(tr.device_events).items(), key=lambda kv: -kv[1])
    out = {"device_ops": [[n[:120], s] for n, s in ops[:TOP]]}
    if tr.window is None:
        return out
    busy = counting.merged((a, b) for _, a, b in tr.device_events)
    idle = counting.gaps(busy, *tr.window)
    host = sorted((s, e, n) for n, s, e in tr.host)
    starts = [h[0] for h in host]
    by_label: Dict[str, float] = {}
    for s, e in idle:
        mid = 0.5 * (s + e)
        k = bisect.bisect_right(starts, mid)
        label = "host"
        for j in range(k - 1, max(k - 400, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        by_label[label] = by_label.get(label, 0.0) + (e - s) * 1e-9
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    out["idle_gaps"] = [[n[:120], s] for n, s in top]
    return out
