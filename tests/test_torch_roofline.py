"""The port's roofline (``repro_torch.launch.roofline``): its probe
extrapolation against a full-depth dry-run trace of a reduced config of
each family, and its CLI on one full cell, on the CPU.

Each family's ``reduced_config`` is probed at the reference's schedule
(``probe_schedule``) on a (4, 4) mesh of a fake 16-rank group, at a
train cell of 16 sequences of 16 tokens, and the solved metrics are held
against one trace at the config's own depth:

  * the transformer family (qwen2-0.5b, olmoe-1b-7b, deepseek-v3-671b's
    dense + MoE groups) and whisper-base's encoder-decoder: FLOPs within
    1e-9 relative (every layer of a kind runs the same ops); bytes and
    collective bytes within 1e-3 (DTensor places the stacked layers'
    gradients by whether the layer count divides a mesh axis: reduced
    qwen2-0.5b's 4 layers on 4-way axes land 4e-4 and 2e-4 off; the
    others exact);
  * zamba2-7b and xlstm-125m: within 15 %.  The reference's schedule
    varies the group size (``attn_every``, ``slstm_every``) between
    probe points, and the port's program is not linear in those knobs:
    the tail layers run outside the groups' remat and DTensor picks other
    strategies for other group compositions (FLOPs 7.8 % and 9.4 % off
    at these cells, bytes 3.5 % and 8.4 %, collectives 2.7 % and 5.5 %).
    ROADMAP lists a group-and-tail schedule for them.

The probes run in three subprocesses side by side (the fake group is
process-global), the CLI on qwen2-0.5b ``train_4k`` (two probes at full
width on 256 ranks) in a fourth: ``ok``, the H100's terms, 256 chips.
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUPS = (("qwen2-0.5b", "olmoe-1b-7b", "whisper-base"),
          ("deepseek-v3-671b",), ("zamba2-7b", "xlstm-125m"))
EXACT = ("qwen2-0.5b", "olmoe-1b-7b", "deepseek-v3-671b", "whisper-base")
_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun, roofline
    cell = ShapeCell("train", 16, 16, "train")
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = configs.reduced_config(arch)
        rec = roofline.analyse_cell(arch, "train_4k", mesh_shape=(4, 4),
                                    cfg=cfg, cell=cell)
        full = roofline.probe_metrics(dryrun.run_cell(
            arch, "train_4k", False, mesh_shape=(4, 4), cfg=cfg, cell=cell))
        out[arch] = dict(rec=rec, full=full)
    print(json.dumps(out))
    """)


@pytest.fixture(scope="module")
def runs():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out_dir = tempfile.mkdtemp(prefix="roofline_")
    procs = [subprocess.Popen([sys.executable, "-c", _SCRIPT, ",".join(g)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for g in GROUPS]
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--arch",
         "qwen2-0.5b", "--shape", "train_4k", "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    recs = {}
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        recs.update(json.loads(out.strip().splitlines()[-1]))
    _, err = cli.communicate(timeout=300)
    assert cli.returncode == 0, err[-3000:]
    recs["cli"] = json.loads(next(pathlib.Path(out_dir).glob(
        "*.json")).read_text())
    return recs


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("arch", EXACT)
def test_probe_extrapolation_equals_a_full_depth_trace(runs, arch):
    rec, full = runs[arch]["rec"], runs[arch]["full"]
    assert rec["ok"] and rec["chips"] == 16
    assert _rel(rec["flops_per_device"], full["flops"]) <= 1e-9
    assert _rel(rec["hbm_bytes_per_device"], full["bytes"]) <= 1e-3
    assert _rel(rec["collective_bytes_per_device"],
                full["coll_total"]) <= 1e-3
    assert rec["corrections"] == {"flops_correction": 0.0}


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_grouped_families_extrapolate_within_their_known_gap(runs, arch):
    rec, full = runs[arch]["rec"], runs[arch]["full"]
    assert rec["ok"]
    for got, key in ((rec["flops_per_device"], "flops"),
                     (rec["hbm_bytes_per_device"], "bytes"),
                     (rec["collective_bytes_per_device"], "coll_total")):
        assert _rel(got, full[key]) <= 0.15, (key, got, full[key])


def test_roofline_cli_runs_one_full_cell(runs):
    rec = runs["cli"]
    assert rec["ok"] and rec["chips"] == 256
    assert rec["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert rec["probe_points"] == [{"L": 1}, {"L": 2}]
    t = rec["terms_s"]
    assert t["compute_s"] == rec["flops_per_device"] / 989e12
    assert t["memory_s"] == rec["hbm_bytes_per_device"] / 3.35e12
    assert t["collective_s"] == rec["collective_bytes_per_device"] / 450e9
    assert rec["dominant"] in t and rec["step_time_bound_s"] == max(
        t.values())
    assert 0 < rec["roofline_fraction"] <= 1
