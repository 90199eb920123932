"""The harness: cells and metrics found by name, nothing of JAX loaded,
no result without a card or without the port."""
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench.harness import run_cell
from bench.tests.layout import REPO, small_layout

ENV = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}",
           CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def _digest(root):
    h = hashlib.sha256()
    for p in sorted((root / "bench").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    h.update((root / "BENCHMARK.json").read_bytes())
    return h.hexdigest()


def test_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    root = small_layout(tmp_path)
    before = _digest(REPO)
    b = root / "bench"
    (b / "traffic" / "mpbcfw-short.json").write_text(json.dumps(
        {"engine": "mpbcfw", "eval_sweeps": 1,
         "run": {"cap": 4, "ttl": 2, "approx_batch": 2,
                 "max_approx_passes": 2}}))
    (b / "workloads" / "ocr.mpbcfw-short.json").write_text(json.dumps(
        {"config": "ocr", "traffic": "mpbcfw-short", "warmup_iterations": 1,
         "followed_iterations": 3, "limits": {"dual_rel": 1e-4}}))
    (b / "metrics" / "passes_per_iter.py").write_text(
        "def read(run):\n"
        "    its = run.iterations\n"
        "    return sum(i.row.approx_passes for i in its) / len(its)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ocr.mpbcfw-short", "config": "ocr",
                              "traffic": "mpbcfw-short", "chips": 1,
                              "why": "a test cell"})
    bench["per_layer"].append({"name": "passes_per_iter",
                               "unit": "passes/iter", "better": "higher",
                               "source": "program_counter",
                               "layer": "control loop", "moves": "iter_s",
                               "workloads": ["ocr.mpbcfw-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "ocr.mpbcfw-short", 11, 0.0, True, device="cpu",
                   out=io.StringIO())
    assert res["correct"] and res["attempted"] >= 3
    assert 0 < res["metrics"]["passes_per_iter"]["value"] <= 2
    assert res["metrics"]["host_syncs_per_iter"]["value"] == 1
    assert "iter_mfu" in res["metrics"]
    assert list(res)[-1] == "checks"
    assert _digest(REPO) == before


def test_untraced_run_reports_the_end_to_end_metrics(tmp_path):
    root = small_layout(tmp_path)
    res = run_cell(root, "ocr.bcfw-avg", 12, 0.0, False, device="cpu",
                   out=io.StringIO())
    assert res["correct"]
    assert set(res["metrics"]) == {"setup_s", "iter_s"}   # no card memory
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}


def test_nothing_of_jax_is_loaded(tmp_path):
    root = small_layout(tmp_path)
    code = f"""
import importlib, io, json, sys
from pathlib import Path
import bench.harness as h, bench.compare, bench.counting, bench.faults
import bench.data.chain, bench.data.graph, bench.run, bench.readings
root = Path({str(root)!r})
for w in ("ocr.mpbcfw", "horseseg.mpbcfw", "ocr.bcfw-avg"):
    cell = h.Cell(root, w)
    for m in cell.bench["end_to_end"] + cell.bench["per_layer"]:
        cell.reader(m["name"])
h.run_cell(root, "ocr.mpbcfw", 3, 0.0, True, device="cpu", out=io.StringIO())
print(json.dumps(h.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_port():
    code = """
import json, sys
import bench.reference.ssvm, bench.reference.chain, bench.reference.graph
tops = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(tops & {"repro_torch", "repro", "jax", "jaxlib",
                                 "torch"})))
"""
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []
    word = "bench" + "marks"     # the JAX package's benchmark folder
    assert not any(word in p.read_text()
                   for p in (REPO / "bench").rglob("*.py"))


def _run(cwd):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "ocr.mpbcfw",
         "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
        env=dict(ENV, PYTHONPATH=""), cwd=cwd, capture_output=True,
        text=True, timeout=120)


def test_run_without_a_card_fails_and_prints_no_result():
    out = _run(REPO)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "correct" not in out.stdout


def test_run_without_the_port_fails_and_prints_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "correct" not in out.stdout


def test_a_trace_short_of_the_ports_launches_reads_nothing(tmp_path):
    # The profiler drops records on a busy host: a trace whose records of
    # the port's named kernels differ from the launches the port counted
    # gives no profiler-read metric (the harness traces the next
    # iteration instead).
    import torch

    from bench.harness import Cell, RunRecord, dropped
    from bench.trace import DeviceTrace

    class Row:
        def __init__(self, n_exact):
            self.n_exact, self.approx_passes, self.ws_mean = n_exact, 1, 1.0

    tr = DeviceTrace(torch.device("cpu"))
    tr.device_events = [("viterbi_decode_kernel", 0, 10)] * 3 + [
        ("approx_pass_kernel", 10, 20), ("Memcpy HtoD", 20, 30)]
    tr.window = (0, 100)
    assert dropped(tr, {"viterbi_decode": 3, "approx_pass": 1}) == {}
    assert dropped(tr, {"viterbi_decode": 4, "approx_pass": 1}) == {
        "viterbi_decode": [3, 4]}
    rec = RunRecord(Cell(small_layout(tmp_path), "ocr.mpbcfw"),
                    torch.device("cpu"))
    rec.trace, rec.traced_row, rec.traced_prev_row = tr, Row(4), Row(2)
    names = ("device_ops_per_block", "oracle_ms_per_iter",
             "approx_pass_roofline", "device_idle")
    rec.trace_complete = True
    read = {m: rec.cell.reader(m)(rec) for m in names}
    assert read["device_ops_per_block"] == 2.0          # 4 kernels / 2 steps
    assert read["device_idle"] == 100.0 * (1 - 30 / 100)
    assert all(v is not None for v in read.values())
    rec.trace_complete = False
    assert all(rec.cell.reader(m)(rec) is None for m in names)
