"""The port's dry-run (``repro_torch.launch.dryrun``) on the reference's
two full cells, through its CLI, on the CPU: qwen2-0.5b ``train_4k`` on
the (16, 16) mesh of 256 ranks and olmoe-1b-7b ``decode_32k`` on the (2,
16, 16) mesh of 512, each in a process of its own (the fake group is
process-global), as ``tests/test_launch.py`` runs the reference's.

Checked: ``ok``; ``chips`` 256 / 512; collectives counted (> 0); FLOPs
from the local ops (``flops_source`` "flop_counter", per device less
than the global step's model FLOPs); the parameter count the reference's
(``param_count``, which ``tests/test_torch_launch.py`` holds equal to the
reference's ``count_params``); tokens as the reference counts them.
~30 s and ~15 s here.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro import configs as jconfigs

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen2-0.5b", "train_4k", "single"),
    ("olmoe-1b-7b", "decode_32k", "multi"),
])
def test_dryrun_cli_runs_the_reference_cells(tmp_path, arch, shape, mesh):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--mesh", mesh,
                    "--out", str(tmp_path)], check=True, timeout=300,
                   env=env, capture_output=True)
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert rec["ok"], rec
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    assert rec["mesh"] == mesh
    assert rec["collective_bytes_static"] \
        + rec["collective_in_loop_bytes"] > 0
    assert sum(rec["collective_counts"].values()) \
        + sum(rec["collective_in_loop_counts"].values()) > 0
    assert rec["flops_source"] == "flop_counter"
    assert 0 < rec["flops"] < rec["model_flops"]
    assert rec["bytes_accessed"] > 0
    assert rec["params_total"] == jconfigs.get_config(arch).param_count()
    cell = jconfigs.SHAPES[shape]
    assert rec["tokens"] == cell.global_batch * (
        cell.seq_len if cell.kind != "decode" else 1)
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
