"""The plain references against the port's CPU path (its plain
versions): the oracles example by example, and each cell's first three
outer iterations through the harness, on the same arrays and seed."""
import numpy as np
import pytest
import torch

from bench import compare
from bench.harness import Cell, run_cell
from bench.tests.layout import small_layout

SEED = 2 ** 31 + 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_layout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["ocr.mpbcfw", "horseseg.mpbcfw"])
def test_oracle_planes_equal_the_ports(root, workload):
    cell = Cell(root, workload)
    arrays = cell.data.generate(cell.cfg, SEED, torch.device("cpu"))
    problem = cell.data.problem(arrays, cell.cfg)
    host = {k: v.numpy() for k, v in arrays.items()}
    ref = compare.oracle_for(cell, host)
    rng = np.random.RandomState(0)
    w = (0.3 * rng.randn(problem.d)).astype(np.float32)
    planes = problem.oracle(torch.from_numpy(w), problem.data).numpy()
    for i in range(problem.n):
        want = ref.plane(w, i)
        np.testing.assert_allclose(planes[i], want, rtol=1e-5, atol=1e-6)
    hinge = planes[:, :-1] @ w + planes[:, -1]
    np.testing.assert_allclose(ref.hinges(w), hinge, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("workload",
                         ["ocr.mpbcfw", "horseseg.mpbcfw", "ocr.bcfw-avg"])
def test_three_iterations_agree(root, workload, capsys):
    import io
    import json
    log = io.StringIO()
    run_cell(root, workload, SEED, 0.0, False, device="cpu", out=log)
    ref = [json.loads(x) for x in log.getvalue().splitlines()
           if '"reference"' in x][-1]["readings"]
    assert ref["passes_diff"] == 0 and ref["ws_diff"] == 0
    assert ref["rule_flips"] == 0
    assert ref["dual_rel"] < 1e-5
    assert ref["w_rel"] < 1e-5 and ref["w_avg_rel"] < 1e-5
    assert ref["primal_rel"] < 1e-3 and ref["final_primal_rel"] < 1e-3
