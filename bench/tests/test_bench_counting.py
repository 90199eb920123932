"""The counting functions behind approx_pass_roofline, iter_mfu and
device_idle, on shapes small enough to count by hand."""
import pytest

from bench import counting
from bench.data import chain, graph


def test_approx_pass_work_by_hand():
    # n=2 blocks, d=3 (rows of 4 floats = 16 B), cap=4, 5 valid planes:
    # planes 5*16, phi_i rows 2*2*16, valid+last_active 2*4*(1+4),
    # stamps 2*4, permutation 2*8.
    nbytes, flops = counting.approx_pass_work(2, 3, 4, 5)
    assert nbytes == 80 + 64 + 40 + 8 + 16
    # 2*(d+1) per plane scored, 10*(d+1) per block's step.
    assert flops == 2 * 4 * 5 + 10 * 4 * 2


def test_exact_step_and_evaluation_work_by_hand():
    assert counting.exact_step_work(3, 100, 50, cache=True) == (
        100 + 6 * 16 + 16, 50 + 40)
    assert counting.exact_step_work(3, 100, 50, cache=False) == (
        100 + 6 * 16, 50 + 40)
    # Two sweeps: the data and w read each time, n*(oracle + 2(d+1)).
    assert counting.evaluation_work(2, 3, 1000, 50, 2) == (
        2 * (1000 + 16), 2 * 2 * (50 + 8))


def test_least_time_takes_the_larger_bound():
    assert counting.least_time(3.35e12, 0) == pytest.approx(1.0)
    assert counting.least_time(0, 67e12) == pytest.approx(1.0)
    assert counting.least_time(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_iteration_least_time_sums_the_parts():
    work = {"example_bytes": 100.0, "data_bytes": 200.0,
            "oracle_flops": 50.0}
    eb, ef = counting.exact_step_work(3, 100, 50, True)
    ab, af = counting.approx_pass_work(2, 3, 4, 5)
    vb, vf = counting.evaluation_work(2, 3, 200, 50, 1)
    want = counting.least_time(2 * eb + 3 * ab + vb, 2 * ef + 3 * af + vf)
    assert counting.iteration_least_time(2, 3, 4, work, 5, 3, True,
                                         1) == pytest.approx(want)


def test_chain_and_graph_work_by_hand():
    cfg = {"n": 2, "f": 4, "num_labels": 3, "max_len": 5}
    w = chain.work(cfg, {"positions": 6})      # 3 valid positions each
    assert w["example_bytes"] == 3 * 4 * 4 + 5 * 5
    assert w["data_bytes"] == 2 * w["example_bytes"]
    assert w["oracle_flops"] == 3 * (2 * 4 * 3 + 2 * 9 + 2 * 4)
    g = graph.work({"n": 1, "f": 4, "sweeps": 2},
                   {"positions": 4, "edges": 4})   # a 2 x 2 lattice
    assert g["example_bytes"] == 4 * 4 * 4 + 4 * 9 + 4 * 9
    assert g["oracle_flops"] == 4 * 16 + 2 * 2 * (16 + 16) + 4 * 4 * 4


def test_union_of_overlapping_intervals():
    # Two streams: durations sum to 31 in a window of 30, the union 25.
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert sum(e - s for s, e in iv) > 30
    assert counting.union_seconds(iv) == 25
    assert counting.merged(iv) == [(0, 15), (20, 30)]
    assert counting.gaps(counting.merged(iv), 0, 30) == [(15, 20)]
    assert counting.gaps([(2, 3)], 0, 5) == [(0, 2), (3, 5)]
    assert counting.union_seconds([]) == 0
