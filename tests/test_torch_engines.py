"""The engine registry of repro_torch (``repro_torch.api.engine``) against the
JAX package's, on the CPU: the registered names and their capabilities,
the duplicate guard, registration hooks, the capability checks of
``validate_config``, a third-party engine driven end to end through the
port's Solver, and ``repro_torch.core.driver``'s re-exports.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.api import engine as jengine
from repro.data import synthetic as jsyn
from repro_torch.api import (CostModel, Engine, EngineCapabilities,
                             RunConfig, Solver, UnsupportedConfigError,
                             algorithms, capabilities_of, engine_entry,
                             register_engine, unregister_engine,
                             validate_config)
from repro_torch.api import engine as tengine
from repro_torch.api import engines as tengines
from repro_torch.api.engine import (add_registration_hook,
                                    remove_registration_hook)
from repro_torch.core import bcfw
from repro_torch.core.averaging import init_averaging
from repro_torch.core.graphs import StepGraphs
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.selection import SyncLedger
from repro_torch.core.ssvm import init_state, weights_of

torch.set_num_threads(1)
PORTED = ("fw", "ssg", "bcfw", "bcfw-avg", "mpbcfw", "mpbcfw-avg",
          "mpbcfw-gap", "mpbcfw-gram", "mpbcfw-async", "mpbcfw-shard-async",
          "mpbcfw-shard", "mpbcfw-shard-avg", "mpbcfw-shard-tau",
          "mpbcfw-shard-gram")
MESH_ALGOS = ("mpbcfw-gap", "mpbcfw-gram", "mpbcfw-shard-async",
              "mpbcfw-shard", "mpbcfw-shard-avg", "mpbcfw-shard-tau",
              "mpbcfw-shard-gram")


@pytest.fixture(scope="module")
def problem():
    """The conftest chain problem on the CPU."""
    X, Y, M = jsyn.ocr_like(n=24, f=8, num_labels=5, mean_len=6, max_len=8,
                            seed=1)
    return tchain.make_problem(X, Y, M, 5, device="cpu")


# -- names and capabilities --------------------------------------------------

def test_algorithms_are_the_references_in_its_order():
    assert algorithms() == PORTED == jengine.algorithms()
    assert tengine.NOT_YET_PORTED == ()


@pytest.mark.parametrize("name", PORTED)
def test_capabilities_equal_the_references(name, problem):
    caps = capabilities_of(name)
    assert dataclasses.asdict(caps) == dataclasses.asdict(
        jengine.capabilities_of(name))
    engine = engine_entry(name).factory(problem, RunConfig(lam=0.1,
                                                           algo=name))
    assert engine.capabilities is caps
    assert isinstance(engine, Engine)


@pytest.mark.parametrize("algo,match", [
    ("mpbcfw-shard-gap", "unknown algorithm"),
    ("mpbcfw-shards", "unknown algorithm"),
    ("shard-async", "unknown algorithm"), ("nope", "unknown algorithm"),
    ("", "unknown algorithm")])
def test_lookup_of_a_name_the_port_does_not_run(algo, match):
    with pytest.raises(UnsupportedConfigError, match=match) as err:
        engine_entry(algo)
    assert "registered: ('fw', 'ssg'" in str(err.value)


# -- registration ------------------------------------------------------------

def _factory(problem, cfg):
    return tengines.BCFWEngine(problem, cfg.lam)


def test_duplicate_guard_and_overwrite():
    original = engine_entry("bcfw")
    with pytest.raises(ValueError, match="already registered"):
        register_engine("bcfw", _factory)
    try:
        register_engine("bcfw", _factory, overwrite=True)
        assert engine_entry("bcfw").factory is _factory
        assert engine_entry("bcfw").capabilities == EngineCapabilities()
        assert algorithms() == PORTED      # replaced in place
    finally:
        register_engine("bcfw", original.factory, original.capabilities,
                        overwrite=True)
    assert engine_entry("bcfw") == original


@pytest.mark.parametrize("name", ["", None, 3])
def test_register_refuses_a_name_that_is_not_a_string(name):
    with pytest.raises(ValueError, match="non-empty str"):
        register_engine(name, _factory)


@pytest.mark.parametrize("caps,match", [
    (EngineCapabilities(collectives_per_pass=-1), "collectives_per_pass"),
    (EngineCapabilities(collectives_setup=1.5), "collectives_setup"),
    (EngineCapabilities(host_callbacks=-1), "host_callbacks"),
    (EngineCapabilities(host_callbacks=True + 0.5), "host_callbacks"),
    (EngineCapabilities(accum_dtype=""), "accum_dtype"),
    (EngineCapabilities(accum_dtype=32), "accum_dtype")])
def test_malformed_budgets_are_refused_at_registration(caps, match):
    with pytest.raises(ValueError, match=match):
        register_engine("bad-budget", _factory, caps)
    assert "bad-budget" not in algorithms()


def test_hooks_run_retroactively_and_on_every_registration():
    seen = []
    hook = seen.append
    add_registration_hook(hook)
    try:
        assert [e.name for e in seen] == list(PORTED)
        register_engine("hooked", _factory)
        assert seen[-1].name == "hooked"
    finally:
        remove_registration_hook(hook)
        unregister_engine("hooked")
    register_engine("unhooked", _factory)
    unregister_engine("unhooked")
    assert seen[-1].name == "hooked"
    remove_registration_hook(hook)       # absent: a no-op


def test_a_hook_vetoes_by_raising_and_late_hooks_can_skip_the_past():
    def veto(entry):
        if entry.capabilities.supports_mesh and \
                entry.capabilities.collectives_per_pass is None:
            raise ValueError(f"{entry.name}: undeclared collectives")

    add_registration_hook(veto, retroactive=False)
    try:
        with pytest.raises(ValueError, match="undeclared collectives"):
            register_engine("meshy", _factory,
                            EngineCapabilities(supports_mesh=True))
        assert "meshy" not in algorithms()
        register_engine("meshy", _factory, EngineCapabilities(
            supports_mesh=True, collectives_per_pass=1))
        assert "meshy" in algorithms()
    finally:
        remove_registration_hook(veto)
        unregister_engine("meshy")

    def strict(entry):
        veto(dataclasses.replace(entry, capabilities=dataclasses.replace(
            entry.capabilities, collectives_per_pass=None)))

    try:
        with pytest.raises(ValueError, match="mpbcfw-gap: undeclared"):
            add_registration_hook(strict)
    finally:
        remove_registration_hook(strict)


# -- validate_config ---------------------------------------------------------

@pytest.mark.parametrize("algo,kw,match", [
    ("bcfw", dict(approx_batch=0), "approx_batch"),
    ("mpbcfw", dict(gap_tol=-1.0), "gap_tol"),
    ("mpbcfw", dict(ttl=0), "ttl must be >= 1"),
    ("mpbcfw-async", dict(ttl=-2), "ttl must be >= 1"),
    ("bcfw", dict(mesh="data"),
     "only consumed by " + re.escape(str(MESH_ALGOS))),
    ("mpbcfw", dict(tau=4), "tau-nice chunk size"),
    ("mpbcfw-gram", dict(tau=4), "only consumes RunConfig.tau on a mesh"),
    ("bcfw", dict(policies=("uniform",)), "predates the policy layer"),
    ("mpbcfw", dict(policies=("uniform",)),
     "missing a eviction/oracle policy")])
def test_validate_config_refuses_by_capability(algo, kw, match):
    with pytest.raises(UnsupportedConfigError, match=match):
        validate_config(engine_entry(algo), RunConfig(lam=0.1, algo=algo,
                                                      **kw))


def test_validate_config_admits_what_the_capabilities_allow():
    # ttl only matters to multipass engines; a mesh to gram is admitted.
    validate_config(engine_entry("bcfw"), RunConfig(lam=0.1, ttl=0))
    validate_config(engine_entry("mpbcfw-gram"),
                    RunConfig(lam=0.1, mesh="data", tau=2))
    entry = tengine.EngineEntry(
        "needs-tau", _factory, EngineCapabilities(uses_tau=True,
                                                  requires_tau=True))
    with pytest.raises(UnsupportedConfigError, match="requires RunConfig"):
        validate_config(entry, RunConfig(lam=0.1))
    validate_config(entry, RunConfig(lam=0.1, tau=3))


# -- a third-party engine ----------------------------------------------------

class _CyclicBCFWEngine:
    """BCFW with a fixed cyclic block schedule, registered from test code
    through the public protocol: the full Solver loop (ledger accounting,
    evaluation, extraction) without touching the port's engines."""

    capabilities = EngineCapabilities(needs_perm=False,
                                      supports_averaging=True)

    def __init__(self, problem, cfg):
        self.problem, self.lam = problem, cfg.lam
        self.ledger = SyncLedger()
        self.graphs = StepGraphs()

    def init_state(self, cap):
        del cap
        return (init_state(self.problem, "cpu"),
                init_averaging(self.problem.d, "cpu"))

    def outer_iteration(self, state, perm, perms, clock, *, ttl):
        assert perm is None          # needs_perm=False: nothing drawn
        st, avg = state
        self.ledger.dispatched()
        st, avg = bcfw.exact_pass(self.problem, st, avg,
                                  np.arange(self.problem.n), self.lam,
                                  graphs=self.graphs)
        return (st, avg), None, (st.n_exact, st.phi[-1:])

    def read_stats(self, stats):
        n_exact, _ = self.ledger.sync(stats)
        return tengines.IterStats(n_exact=int(n_exact), n_approx=0)

    def evaluate(self, state):
        from repro_torch.api import evaluate_objectives
        return evaluate_objectives(self.problem, state[0].phi, None,
                                   self.lam)

    def extract(self, state):
        return weights_of(state[0].phi, self.lam).numpy(), None


def test_third_party_engine_end_to_end(problem):
    lam = 1.0 / problem.n
    register_engine("cyclic-bcfw", _CyclicBCFWEngine,
                    _CyclicBCFWEngine.capabilities)
    try:
        assert algorithms()[-1] == "cyclic-bcfw"
        solver = Solver(problem, RunConfig(lam=lam, algo="cyclic-bcfw",
                                           max_iters=4,
                                           cost_model=CostModel()))
        assert solver.caps is _CyclicBCFWEngine.capabilities
        state0 = solver._rng.get_state()[1].copy()
        rows = list(solver.iterate())
        assert len(rows) == 4
        duals = [r.dual for r in rows]
        assert all(b >= a - 1e-7 for a, b in zip(duals, duals[1:]))
        assert rows[-1].gap < rows[0].gap
        assert rows[-1].n_exact == 4 * problem.n
        for r in rows:
            assert r.host_syncs == 1 and r.dispatches == 1
            assert r.approx_passes == 0 and r.n_approx == 0
        # needs_perm=False: the seeded stream drew nothing.
        assert (solver._rng.get_state()[1] == state0).all()
        res = solver.result()
        assert res.w is not None and res.w_avg is None
        # The same blocks in order through the built-in bcfw step body.
        st, avg = init_state(problem, "cpu"), init_averaging(problem.d, "cpu")
        graphs = StepGraphs()
        for _ in range(4):
            st, avg = bcfw.exact_pass(problem, st, avg,
                                      np.arange(problem.n), lam,
                                      graphs=graphs)
        assert np.array_equal(weights_of(st.phi, lam).numpy(), res.w)
    finally:
        unregister_engine("cyclic-bcfw")
    with pytest.raises(UnsupportedConfigError, match="unknown algorithm"):
        Solver(problem, RunConfig(lam=lam, algo="cyclic-bcfw"))


# -- core.driver's re-exports ------------------------------------------------

def test_driver_reexports_resolve_to_the_api():
    from repro_torch.api import engines, solver
    from repro_torch.core import driver
    from repro_torch.core import ssvm
    assert driver.ALGORITHMS == algorithms()
    assert driver._FusedEngine is engines.FusedEngine
    assert driver._Clock is solver._Clock
    assert driver._evaluate is solver.evaluate_objectives
    assert driver._fit_pass_costs is solver._fit_pass_costs
    assert driver._draw_perms is solver._draw_perms
    assert driver.batched_oracle is ssvm.batched_oracle
    assert driver.RunConfig is RunConfig
    for name in ("run", "_ShardDriverEngine", "nope"):
        with pytest.raises(AttributeError, match=name):
            getattr(driver, name)
