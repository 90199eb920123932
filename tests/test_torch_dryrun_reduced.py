"""The port's dry-run on every arch's ``reduced_config`` on a (4, 4)
('data', 'model') mesh of a fake 16-rank group, in one subprocess (the
group is process-global), on the CPU: a train step of each of the ten
archs, and a prefill and a decode step of one arch of each family, at
small cells (16 sequences of 16 tokens; a 32-token decode cache).  Three
subprocesses side by side: the train steps in two halves, the prefill and
decode steps.

Checked per record: ``ok``, 16 chips, collectives counted (> 0), FLOPs
and bytes from the local ops (> 0), the parameter count the JAX
package's ``param_count`` of the same reduced config.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro import configs as jconfigs
from repro_torch import configs

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILY_ARCHS = ("qwen2-0.5b", "olmoe-1b-7b", "deepseek-v3-671b",
                "zamba2-7b", "xlstm-125m", "whisper-base")
_SCRIPT = textwrap.dedent("""
    import json
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    import sys
    out = {}
    archs = sorted(configs.ARCHS)
    part = int(sys.argv[1])
    cells = ([(a, "train") for a in archs[part::2]] if part < 2 else
             [(a, k) for a in %r for k in ("prefill", "decode")])
    for arch, kind in cells:
        seq = 32 if kind == "decode" else 16
        rec = dryrun.run_cell(arch, kind, False, mesh_shape=(4, 4),
                              cfg=configs.reduced_config(arch),
                              cell=ShapeCell(kind, seq, 16, kind))
        out[arch + "/" + kind] = rec
    print(json.dumps(out))
    """) % (FAMILY_ARCHS,)


@pytest.fixture(scope="module")
def records():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _SCRIPT, part],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for part in ("0", "1", "2")]
    recs = {}
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        recs.update(json.loads(out.strip().splitlines()[-1]))
    return recs


@pytest.mark.parametrize("cell", [f"{a}/train" for a in sorted(configs.ARCHS)]
                         + [f"{a}/{k}" for a in FAMILY_ARCHS
                            for k in ("prefill", "decode")])
def test_reduced_cell_traces_on_a_4x4_mesh(records, cell):
    rec = records[cell]
    arch = cell.split("/")[0]
    assert rec["ok"] and rec["chips"] == 16 and rec["mesh_shape"] == [4, 4]
    assert rec["collective_bytes_static"] \
        + rec["collective_in_loop_bytes"] > 0
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["flops_source"] == "flop_counter"
    assert rec["params_total"] == \
        jconfigs.reduced_config(arch).param_count()
