"""``correct`` fails where it must: the control (the reference in TF32 in
the program's place, over the followed iterations and in the final
evaluation) and each fault a training cell can have, and a wrong averaged
iterate, planted in the port's timed path underneath a whole run of the
harness (the card is not looked for).  And a sound run passes.  Small
shapes on the CPU; the cells' own limits."""
import io

import pytest
import torch

from bench import compare, faults
from bench.harness import Cell, run_cell
from bench.tests.layout import small_layout

CELLS = ["ocr.mpbcfw", "horseseg.mpbcfw", "ocr.bcfw-avg"]
SEED = 2 ** 31 + 21


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_layout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(root, workload):
    res = run_cell(root, workload, SEED, 0.0, False, device="cpu",
                   out=io.StringIO())
    assert res["correct"], res["checks"]
    assert res["checks"] and set(res["checks"]) == set(
        Cell(root, workload).spec["limits"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(root, workload):
    cell = Cell(root, workload)
    arrays = cell.data.generate(cell.cfg, SEED, torch.device("cpu"))
    host = {k: v.numpy() for k, v in arrays.items()}
    vals = compare.control_readings(cell, host, SEED,
                                    cell.spec["followed_iterations"])
    ok, checks = compare.judge(vals, cell.spec["limits"])
    assert not ok, checks


@pytest.mark.parametrize("workload", ["ocr.mpbcfw", "ocr.bcfw-avg"])
def test_final_control_is_told_from_the_program(root, workload):
    # The evaluation after the window in TF32 (the control of
    # final_primal_rel) reads far above the program's own evaluation.  Its
    # limit is set at the cell's size, where the control reads 1.7e-4 and
    # more (PERF.md, section 2); here the two readings are compared.
    probe = {}

    def keep(cell, host, final):
        probe.update(compare.final_control_readings(cell, host, final))
        return probe
    res = run_cell(root, workload, SEED, 0.0, False, device="cpu",
                   out=io.StringIO(), probe=keep)
    assert res["correct"], res["checks"]
    sound = res["checks"]["final_primal_rel"]["value"]
    assert probe["control_final_primal_rel"] > 10 * sound, (probe, sound)


@pytest.mark.parametrize("workload", CELLS)
def test_whole_control_is_judged_not_correct(root, workload):
    # readings.py --mode control: the TF32 reference in the program's place
    # over the followed iterations and in the evaluation at the program's
    # last weights, judged by the cell's limits as a run is.
    cell = Cell(root, workload)
    got = {}

    def control(c, host, final):
        got["final"] = compare.final_control_readings(c, host, final)
        got["vals"] = compare.control_readings(
            c, host, SEED, c.spec["followed_iterations"], final)
        return got
    res = run_cell(root, workload, SEED, 0.0, False, device="cpu",
                   out=io.StringIO(), probe=control)
    assert res["correct"], res["checks"]
    vals = got["vals"]
    for key, v in got["final"].items():
        assert vals[key[len("control_"):]] == v
    ok, checks = compare.judge(vals, cell.spec["limits"])
    assert not ok, checks


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(root, workload, fault):
    with faults.planted(fault):
        res = run_cell(root, workload, SEED, 0.0, False, device="cpu",
                       out=io.StringIO())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.AVERAGE_FAULTS)
def test_average_fault_is_not_correct(root, fault):
    with faults.planted(fault):
        res = run_cell(root, "ocr.bcfw-avg", SEED, 0.0, False, device="cpu",
                       out=io.StringIO())
    assert not res["correct"], res["checks"]
    check = res["checks"]["w_avg_rel_it1"]
    assert check["value"] > check["limit"], res["checks"]
