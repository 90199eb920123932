"""The engines ``fw``, ``ssg``, ``bcfw``, ``bcfw-avg`` and ``mpbcfw-avg`` of
repro_torch vs the JAX package, on the CPU.

Three-iteration Solver traces on the paper's ``SMALL`` scenarios (usps,
ocr, horseseg), from the same numpy data and seed: the schedule
(``n_exact``, ``n_approx``, ``approx_passes``) and the sync contract
(``dispatches``, ``host_syncs``) equal row for row; ``primal``, ``dual``
and ``primal_avg`` within rtol 1e-4 (``ssg`` has no dual: NaN on both
sides).  Then checkpoints of ``bcfw-avg`` and ``ssg`` cross between the
packages and the resumed tail matches the other package's uninterrupted
run.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.paper import SMALL
from repro.core.oracles import chain as jchain
from repro.core.oracles import graph as jgraph
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.oracles import graph as tgraph
from repro_torch.core.oracles import multiclass as tmulti

torch.set_num_threads(1)
ALGOS = ["fw", "ssg", "bcfw", "bcfw-avg", "mpbcfw-avg"]


def _small(name):
    """``SMALL[name]`` as a problem of each package, from one numpy set."""
    sc = SMALL[name]
    if sc.kind == "multiclass":
        x, y = jsyn.usps_like(n=sc.n, f=sc.f, num_classes=sc.num_classes)
        return sc, (jmulti.make_problem(jnp.asarray(x), jnp.asarray(y),
                                        sc.num_classes),
                    tmulti.make_problem(x, y, sc.num_classes, device="cpu"))
    if sc.kind == "graph":
        arrays = jsyn.horseseg_like(n=sc.n, grid=sc.grid, f=sc.f)
        return sc, (jgraph.make_problem(*map(jnp.asarray, arrays),
                                        num_sweeps=sc.oracle_sweeps),
                    tgraph.make_problem(*arrays, num_sweeps=sc.oracle_sweeps,
                                        device="cpu"))
    X, Y, M = jsyn.ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                            mean_len=sc.mean_len, max_len=sc.max_len, seed=0)
    return sc, (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                    jnp.asarray(M), sc.num_classes),
                tchain.make_problem(X, Y, M, sc.num_classes, device="cpu"))


def _close(a: float, b: float, what: str) -> None:
    """Within rtol 1e-4, or NaN on both sides."""
    if math.isnan(b):
        assert math.isnan(a), f"{what}: {a} where JAX has NaN"
    else:
        assert_allclose(a, b, rtol=1e-4, err_msg=what)


def _assert_rows_match(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.iteration == b.iteration
        assert (a.n_exact, a.n_approx, a.approx_passes, a.dispatches,
                a.host_syncs) == (b.n_exact, b.n_approx, b.approx_passes,
                                  b.dispatches, b.host_syncs), a.iteration
        for f in ("primal", "dual", "primal_avg", "gap"):
            _close(getattr(a, f), getattr(b, f), f"{f} at {a.iteration}")
        assert_allclose(a.time, b.time, rtol=1e-12)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["usps", "ocr", "horseseg"])
def test_three_iterations_match_jax(name, algo):
    sc, (jp, tp) = _small(name)
    kw = dict(lam=1.0 / sc.n, algo=algo, cap=16, ttl=2, max_iters=3,
              approx_batch=8, max_approx_passes=8)
    jr = JSolver(jp, JRunConfig(cost_model=JCostModel(
        sc.oracle_cost, sc.plane_cost), **kw)).run()
    tr = Solver(tp, RunConfig(cost_model=CostModel(
        sc.oracle_cost, sc.plane_cost), **kw)).run()
    assert len(tr.trace) == 3
    _assert_rows_match(tr.trace, jr.trace)
    for r in tr.trace:
        assert r.dispatches == 1 and r.host_syncs == 1
    assert_allclose(tr.w, jr.w, rtol=1e-4, atol=1e-4)
    if jr.w_avg is None:
        assert tr.w_avg is None
    else:
        assert_allclose(tr.w_avg, jr.w_avg, rtol=1e-4, atol=1e-4)


# -- checkpoints across packages ---------------------------------------------

@pytest.fixture(scope="module")
def chain_problems():
    """The conftest chain problem in both packages."""
    X, Y, M = jsyn.ocr_like(n=24, f=8, num_labels=5, mean_len=6, max_len=8,
                            seed=1)
    return (jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(M), 5),
            tchain.make_problem(X, Y, M, 5, device="cpu"))


def _kw(n, algo):
    return dict(lam=1.0 / n, algo=algo, max_iters=4, cap=8, seed=3)


@pytest.mark.parametrize("algo", ["bcfw-avg", "ssg"])
def test_port_resumes_a_jax_checkpoint(tmp_path, chain_problems, algo):
    """JAX saves at iteration 2; the port restores and runs iterations
    2-3, matching JAX's uninterrupted run."""
    jp, tp = chain_problems
    jcfg = JRunConfig(cost_model=JCostModel(plane_cost=1e-3),
                      **_kw(jp.n, algo))
    jfull = JSolver(jp, jcfg).run()
    js = JSolver(jp, JRunConfig(cost_model=JCostModel(plane_cost=1e-3),
                                **_kw(jp.n, algo)))
    it = js.iterate()
    [next(it) for _ in range(2)]
    js.save(JManager(str(tmp_path / "j")))
    ts = Solver.restore(tp, RunConfig(cost_model=CostModel(plane_cost=1e-3),
                                      **_kw(tp.n, algo)),
                        CheckpointManager(str(tmp_path / "j")))
    assert ts.iteration == 2
    _assert_rows_match(list(ts.iterate()), jfull.trace[2:])


@pytest.mark.parametrize("algo", ["bcfw-avg", "ssg"])
def test_jax_resumes_a_port_checkpoint(tmp_path, chain_problems, algo):
    """The port saves at iteration 2; JAX restores and runs iterations
    2-3, matching the port's uninterrupted run."""
    jp, tp = chain_problems
    tfull = Solver(tp, RunConfig(cost_model=CostModel(plane_cost=1e-3),
                                 **_kw(tp.n, algo))).run()
    ts = Solver(tp, RunConfig(cost_model=CostModel(plane_cost=1e-3),
                              **_kw(tp.n, algo)))
    it = ts.iterate()
    [next(it) for _ in range(2)]
    ts.save(CheckpointManager(str(tmp_path / "t")))
    js = JSolver.restore(jp, JRunConfig(cost_model=JCostModel(
        plane_cost=1e-3), **_kw(jp.n, algo)), JManager(str(tmp_path / "t")))
    assert js.iteration == 2
    _assert_rows_match(list(js.iterate()), tfull.trace[2:])


@pytest.mark.parametrize("algo", ["fw", "ssg", "bcfw-avg"])
def test_resume_within_the_port_is_bitwise(tmp_path, chain_problems, algo):
    """A port run saved at iteration 2 and resumed gives the uninterrupted
    run's rows and weights bit for bit."""
    _, tp = chain_problems
    cfg = RunConfig(cost_model=CostModel(plane_cost=1e-3), **_kw(tp.n, algo))
    full = Solver(tp, cfg).run()
    s = Solver(tp, RunConfig(cost_model=CostModel(plane_cost=1e-3),
                             **_kw(tp.n, algo)))
    it = s.iterate()
    [next(it) for _ in range(2)]
    mgr = CheckpointManager(str(tmp_path / "p"))
    s.save(mgr)
    r = Solver.restore(tp, RunConfig(cost_model=CostModel(plane_cost=1e-3),
                                     **_kw(tp.n, algo)), mgr)
    tail = list(r.iterate())
    assert [(a.primal, a.n_exact) for a in tail] == [
        (b.primal, b.n_exact) for b in full.trace[2:]]
    assert np.array_equal(r.result().w, full.w)
