"""The port's shard engines at world size 1 against their single-device
twins in the port, bit for bit, on ``SMALL`` usps, ocr and horseseg (the
reference's own claims: ``tests/test_shard.py:192-272``,
``tests/test_policy.py:160``): ``mpbcfw-shard`` = ``mpbcfw``,
``-shard-avg`` = ``mpbcfw-avg``, ``-shard-gram`` and ``mpbcfw-gram``
with a mesh = ``mpbcfw-gram``, ``mpbcfw-gap`` with a mesh =
``mpbcfw-gap``, ``-shard-async`` = ``mpbcfw-async`` (as JAX's are on a
1-device mesh).  Every ``TraceRow`` field and the weights are equal; the
shard engine charges one collective per program and one per pass.  The
Sec-3.5 runs take 5 recurrence steps, both twins alike.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.launch import mesh as tmesh

from test_torch_shard import TWINS, rows_equal, run_cfg, small

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_data_mesh(device="cpu")


@pytest.mark.parametrize("name", ["usps", "ocr", "horseseg"])
@pytest.mark.parametrize("algo,twin", TWINS)
def test_world_size_one_trace_equals_its_single_device_twin(name, algo,
                                                            twin, mesh):
    sc, (_, tp) = small(name)
    # A CostModel is a run's clock: one each.
    mine = Solver(tp, run_cfg(RunConfig, CostModel, sc, algo, mesh=mesh,
                              gram_steps=5))
    ref = Solver(tp, run_cfg(RunConfig, CostModel, sc, twin, gram_steps=5))
    ta, tb = mine.run().trace, ref.run().trace
    assert len(ta) == len(tb) == 3
    for ra, rb in zip(ta, tb):
        rows_equal(ra, rb)
    ra, rb = mine.result(), ref.result()
    assert np.array_equal(ra.w, rb.w) and np.array_equal(ra.w_avg, rb.w_avg)
    # One setup collective per multi-pass program (each read once), one
    # per pass that ran.
    n_coll = sum(r.host_syncs + r.approx_passes for r in ta)
    assert mine.engine.ledger.collectives == n_coll
    assert ref.engine.ledger.collectives == 0
