"""The port's shard engines on four gloo ranks on the CPU, against the JAX
package's shard engines on four forced host devices.

One spawned run of four processes (each ``launch.mesh.init_ranks`` over
a ``FileStore`` and a CPU ``DataMesh``) drives every case; one JAX
subprocess (``force_host_platform_device_count(4)``) drives the same
cases on the reference, in parallel.  Cases: ``mpbcfw-shard`` (tau = S =
4) on ``usps_like(n=48, f=12, 5)`` and on ``SMALL`` ocr (n = 120),
``mpbcfw-shard-tau`` at tau = 8, ``mpbcfw-shard-gram``,
``mpbcfw-shard-async``, ``mpbcfw-gap`` with a mesh (refused by both, tau
pinned to 1 on 4 shards) and the reference's ``_MULTIDEV_SCRIPT`` (the
engine's outer iteration at tau = 8 with a straggler mask, run_all).

Checked: the rows are equal on every rank; duals never decrease; ``phi
== sum_i phi_i`` within 1e-5; one host sync per iteration on every rank;
collectives and bytes equal JAX's; rows within rtol 1e-4 of JAX's
4-device run, the schedule (oracle calls, passes) equal.  Checkpoints:
a 4-rank run resumes bit for bit at 4 ranks; a world-size-1 checkpoint
resumes at 4 ranks as JAX's 4-device run resumes it; the 4-rank
checkpoint and a JAX 4-device checkpoint resume in the port at world
size 1 as in JAX on one device.  Each spawned run has a limit of 120 s.
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.data import synthetic as jsyn
from repro.launch.mesh import make_data_mesh as jmake_mesh
from repro_torch.api import CostModel, RunConfig, Solver
from repro_torch.checkpoint import CheckpointManager, restore_resharded
from repro_torch.core.oracles import multiclass as tmulti
from repro_torch.launch.mesh import make_data_mesh

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 120
SOLVER_CASES = ("shard_usps", "shard_ocr", "tau_ocr", "gram_usps",
                "async_usps")
# Row columns: dual, primal, primal_avg, n_exact, n_approx, approx_passes,
# host_syncs, dispatches, ws_mean, cache_hit_rate, planes_evicted,
# oracle_overlap.
INT_COLS = (3, 4, 5, 6, 7, 10)

_COMMON = textwrap.dedent("""
    import json, sys
    import numpy as np

    def rows(trace):
        return [[r.dual, r.primal, r.primal_avg, r.n_exact, r.n_approx,
                 r.approx_passes, r.host_syncs, r.dispatches, r.ws_mean,
                 r.cache_hit_rate, r.planes_evicted, r.oracle_overlap]
                for r in trace]

    CASES = [("shard_usps", "usps", "mpbcfw-shard", {}),
             ("shard_ocr", "ocr", "mpbcfw-shard", {}),
             ("tau_ocr", "ocr", "mpbcfw-shard-tau", {"tau": 8}),
             ("gram_usps", "usps", "mpbcfw-shard-gram", {}),
             ("async_usps", "usps", "mpbcfw-shard-async", {})]
    """)

_PORT_SCRIPT = _COMMON + textwrap.dedent("""
    import torch
    torch.set_num_threads(1)
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.checkpoint import CheckpointManager, restore_resharded
    from repro_torch.core import mpbcfw
    from repro_torch.core.oracles import chain, multiclass
    from repro_torch.core.ssvm import dual_value
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import init_ranks, make_data_mesh
    from repro_torch.obs import RunRecorder
    from repro_torch.shard import ShardEngine

    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    init_ranks(rank, world, store)
    mesh = make_data_mesh(device="cpu")
    x, y = synthetic.usps_like(n=48, f=12, num_classes=5, seed=0)
    X, Y, M = synthetic.ocr_like(n=120, f=32, num_labels=12, mean_len=7,
                                 max_len=10, seed=0)
    probs = {"usps": multiclass.make_problem(x, y, 5, device="cpu"),
             "ocr": chain.make_problem(X, Y, M, 12, device="cpu")}
    res = {"rank": rank, "world": mesh.size}

    def drift(mp):
        s = mp.inner.phi_i.sum(0)
        mesh.all_reduce(s)
        return float((mp.inner.phi - s).abs().max())

    def cfg(prob, algo, iters=3, **kw):
        return RunConfig(lam=1.0 / prob.n, algo=algo, mesh=mesh,
                         max_iters=iters, cap=8, max_approx_passes=32,
                         cost_model=CostModel(), **kw)

    for name, pname, algo, kw in CASES:
        s = Solver(probs[pname], cfg(probs[pname], algo, **kw))
        r = s.run()
        st = s.state.mp if hasattr(s.state, "mp") else s.state
        res[name] = dict(rows=rows(r.trace), coll=s.engine.ledger.collectives,
                         bytes=s.engine.ledger.collective_bytes,
                         drift=drift(st), w=r.w.tolist())
    usps = probs["usps"]
    try:
        Solver(usps, cfg(usps, "mpbcfw-gap", iters=1)).run()
        res["gap_refusal"] = None
    except ValueError as err:
        res["gap_refusal"] = str(err)
    try:
        Solver(usps, cfg(usps, "mpbcfw-shard"),
               recorder=RunRecorder(f"{out}/rec{rank}.jsonl"))
        res["recorder"] = "admitted"
    except ValueError as err:
        res["recorder"] = str(err)

    # The reference's _MULTIDEV_SCRIPT: tau = 8 with stragglers, run_all.
    eng = ShardEngine(usps, mesh, lam=1 / 48)
    rng = np.random.RandomState(0)
    mp = eng.init_state(cap=8)
    f_prev, duals = 0.0, []
    for ep in range(3):
        perm = rng.permutation(48)
        done = rng.rand(48 // 8, 8) > 0.2
        perms = np.stack([rng.permutation(48) for _ in range(6)])
        clock = mpbcfw.make_slope_clock(0.0, f_prev, 48.0, 1e-3, "cpu")
        mp, clock, stats = eng.outer_iteration(mp, perm, perms, clock,
                                               tau=8, ttl=10, done=done,
                                               run_all=True)
        st = eng.read_stats(stats)
        mp = mpbcfw.count_passes(mp, int(st.passes_run), 48)
        duals.append([float(st.f_entry)] + [float(d) for d in st.duals])
        f_prev = float(dual_value(mp.inner.phi, 1 / 48))
    res["engine_tau8"] = dict(duals=duals, syncs=eng.ledger.host_syncs,
                              coll=eng.ledger.collectives,
                              bytes=eng.ledger.collective_bytes,
                              drift=drift(mp),
                              psums=eng.psums_per_approx_pass,
                              setup=eng.setup_psums, gathers=eng.gathers)

    # Checkpoints: 2 iterations, save (rank 0 writes), resume 2 more.
    ck = sys.argv[5]
    full = Solver(usps, cfg(usps, "mpbcfw-shard", iters=4)).run()
    s = Solver(usps, cfg(usps, "mpbcfw-shard", iters=2))
    s.run()
    s.save(CheckpointManager(f"{ck}/c4"))
    r = Solver.restore(usps, cfg(usps, "mpbcfw-shard", iters=4),
                       CheckpointManager(f"{ck}/c4")).run()
    res["resume4"] = dict(full=rows(full.trace), resumed=rows(r.trace))
    r = Solver.restore(usps, cfg(usps, "mpbcfw-shard", iters=4),
                       CheckpointManager(f"{ck}/c1")).run()
    res["from_c1"] = rows(r.trace)
    tree, _ = restore_resharded(CheckpointManager(f"{ck}/c1"), s.state,
                                mesh)
    res["placed"] = dict(phi_i=tree.inner.phi_i.tolist(),
                         valid=tree.cache.valid.tolist(),
                         lo=rank * (48 // world))
    json.dump(res, open(f"{out}/rank{rank}.json", "w"))
    """)

_JAX_SCRIPT = _COMMON + textwrap.dedent("""
    from repro.launch.mesh import force_host_platform_device_count, \\
        make_data_mesh
    assert force_host_platform_device_count(4)
    import jax.numpy as jnp
    from repro.api import RunConfig, Solver
    from repro.checkpoint.manager import CheckpointManager
    from repro.core import mpbcfw
    from repro.core.oracles import chain, multiclass
    from repro.core.selection import CostModel
    from repro.core.ssvm import dual_value
    from repro.data import synthetic
    from repro.shard import ShardEngine

    out, ck = sys.argv[1], sys.argv[2]
    mesh = make_data_mesh(4)
    x, y = synthetic.usps_like(n=48, f=12, num_classes=5, seed=0)
    X, Y, M = synthetic.ocr_like(n=120, f=32, num_labels=12, mean_len=7,
                                 max_len=10, seed=0)
    probs = {"usps": multiclass.make_problem(jnp.asarray(x),
                                             jnp.asarray(y), 5),
             "ocr": chain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                       jnp.asarray(M), 12)}
    res = {}

    def drift(mp):
        return float(jnp.abs(mp.inner.phi - mp.inner.phi_i.sum(0)).max())

    def cfg(prob, algo, iters=3, **kw):
        return RunConfig(lam=1.0 / prob.n, algo=algo, mesh=mesh,
                         max_iters=iters, cap=8, max_approx_passes=32,
                         cost_model=CostModel(), **kw)

    for name, pname, algo, kw in CASES:
        s = Solver(probs[pname], cfg(probs[pname], algo, **kw))
        r = s.run()
        st = s.state.mp if hasattr(s.state, "mp") else s.state
        res[name] = dict(rows=rows(r.trace), coll=s.engine.ledger.collectives,
                         bytes=s.engine.ledger.collective_bytes,
                         drift=drift(st), w=np.asarray(r.w).tolist())
    usps = probs["usps"]
    try:
        Solver(usps, cfg(usps, "mpbcfw-gap", iters=1)).run()
        res["gap_refusal"] = None
    except ValueError as err:
        res["gap_refusal"] = str(err)
    eng = ShardEngine(usps, mesh, lam=1 / 48)
    rng = np.random.RandomState(0)
    mp = eng.init_state(cap=8)
    f_prev, duals = 0.0, []
    for ep in range(3):
        perm = jnp.asarray(rng.permutation(48))
        done = jnp.asarray(rng.rand(48 // 8, 8) > 0.2)
        perms = jnp.asarray(np.stack([rng.permutation(48)
                                      for _ in range(6)]))
        clock = mpbcfw.make_slope_clock(0.0, f_prev, 48.0, 1e-3)
        mp, clock, stats = eng.outer_iteration(mp, perm, perms, clock,
                                               tau=8, ttl=10, done=done,
                                               run_all=True)
        st = eng.read_stats(stats)
        duals.append([float(st.f_entry)]
                     + [float(d) for d in np.asarray(st.duals)])
        f_prev = float(dual_value(mp.inner.phi, 1 / 48))
    res["engine_tau8"] = dict(duals=duals, syncs=eng.ledger.host_syncs,
                              coll=eng.ledger.collectives,
                              bytes=eng.ledger.collective_bytes,
                              drift=drift(mp),
                              psums=eng.psums_per_approx_pass,
                              setup=eng.setup_psums)
    s = Solver(usps, cfg(usps, "mpbcfw-shard", iters=2))
    s.run()
    s.save(CheckpointManager(f"{ck}/cj4"))
    r = Solver.restore(usps, cfg(usps, "mpbcfw-shard", iters=4),
                       CheckpointManager(f"{ck}/c1")).run()
    res["from_c1"] = rows(r.trace)
    json.dump(res, open(f"{out}/jax.json", "w"))
    """)


def _usps():
    x, y = jsyn.usps_like(n=48, f=12, num_classes=5, seed=0)
    return (jmulti.make_problem(jnp.asarray(x), jnp.asarray(y), 5),
            tmulti.make_problem(x, y, 5, device="cpu"))


def _cfg(cls, cm, mesh, iters):
    return cls(lam=1 / 48, algo="mpbcfw-shard", mesh=mesh, max_iters=iters,
               cap=8, max_approx_passes=32, cost_model=cm())


def _rows(trace):
    return [[r.dual, r.primal, r.primal_avg, r.n_exact, r.n_approx,
             r.approx_passes, r.host_syncs, r.dispatches, r.ws_mean,
             r.cache_hit_rate, r.planes_evicted, r.oracle_overlap]
            for r in trace]


def _wait_all(procs, what):
    """Wait for every process within the limit; kill them all past it."""
    try:
        for p in procs:
            p.wait(timeout=LIMIT)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{what} ran past {LIMIT} s")
    for p in procs:
        out, err = p.communicate()
        assert p.returncode == 0, f"{what}: {err[-3000:]}"


@pytest.fixture(scope="module")
def runs():
    """The world-size-1 checkpoint c1 (written here), then the 4-rank run
    and the JAX 4-device run side by side; both resume c1."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="shard_ranks_"))
    ck = tmp / "ck"
    _, tp = _usps()
    mesh1 = make_data_mesh(device="cpu")
    s = Solver(tp, _cfg(RunConfig, CostModel, mesh1, 2))
    s.run()
    s.save(CheckpointManager(str(ck / "c1")))
    (tmp / "port_rank.py").write_text(_PORT_SCRIPT)
    (tmp / "reference_run.py").write_text(_JAX_SCRIPT)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    store = tmp / "store"
    jax_proc = subprocess.Popen(
        [sys.executable, str(tmp / "reference_run.py"), str(tmp), str(ck)],
        env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = [subprocess.Popen(
        [sys.executable, str(tmp / "port_rank.py"), str(r), "4", str(store),
         str(tmp), str(ck)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    _wait_all(ranks, "the 4-rank run")
    _wait_all([jax_proc], "the JAX 4-device run")
    port = [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(4)]
    jax_res = json.loads((tmp / "jax.json").read_text())
    return dict(port=port, jax=jax_res, ck=ck, c1_state=s.state)


def _close_rows(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert (a[:, INT_COLS] == b[:, INT_COLS]).all(), (what, a, b)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7, err_msg=what)


# -- the cases, on every rank ------------------------------------------------

@pytest.mark.parametrize("case", SOLVER_CASES + ("engine_tau8",))
def test_ranks_hold_the_same_results(runs, case):
    port = runs["port"]
    assert [r["world"] for r in port] == [4] * 4
    assert [r["rank"] for r in port] == [0, 1, 2, 3]
    for r in port[1:]:
        assert r[case] == port[0][case]


@pytest.mark.parametrize("case", SOLVER_CASES)
def test_four_ranks_match_jax_four_devices(runs, case):
    mine, ref = runs["port"][0][case], runs["jax"][case]
    _close_rows(mine["rows"], ref["rows"], case)
    assert (mine["coll"], mine["bytes"]) == (ref["coll"], ref["bytes"])
    np.testing.assert_allclose(mine["w"], ref["w"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", SOLVER_CASES)
def test_four_ranks_monotone_one_sync_consistent(runs, case):
    res = runs["port"][0][case]
    duals = [row[0] for row in res["rows"]]
    assert all(b >= a - 1e-7 for a, b in zip(duals, duals[1:])), duals
    dispatches = 2 if case.startswith("async") else 1
    for row in res["rows"]:
        assert row[6] == 1 and row[7] == dispatches, row
    assert res["drift"] < 1e-5


def test_engine_tau8_with_stragglers_matches_jax(runs):
    """The reference's 8-device script at 4 ranks: every pass monotone
    (damped recombination), one sync per iteration, one collective per
    pass, duals within rtol 1e-4 of JAX's."""
    mine, ref = runs["port"][0]["engine_tau8"], runs["jax"]["engine_tau8"]
    for it in mine["duals"]:
        assert all(b >= a - 1e-7 for a, b in zip(it, it[1:])), it
    assert mine["syncs"] == 3 and mine["psums"] == 1 and mine["setup"] == 1
    assert mine["drift"] < 1e-5
    # One packed gather per tau-nice chunk (6 per epoch) at S > 1.
    assert mine["gathers"] == 3 * 48 // 8
    assert (mine["coll"], mine["bytes"], mine["psums"], mine["setup"]) == (
        ref["coll"], ref["bytes"], ref["psums"], ref["setup"])
    np.testing.assert_allclose(mine["duals"], ref["duals"], rtol=1e-4,
                               atol=1e-9)


def test_gap_on_four_ranks_refused_as_the_reference(runs):
    """mpbcfw-gap pins tau to 1, which 4 shards do not divide: both
    packages refuse the first iteration with the same message."""
    assert runs["jax"]["gap_refusal"] == "tau=1 not divisible by 4 shards"
    for r in runs["port"]:
        assert r["gap_refusal"] == runs["jax"]["gap_refusal"]


def test_recorder_taken_on_rank_zero_only(runs):
    port = runs["port"]
    assert port[0]["recorder"] == "admitted"
    for r in port[1:]:
        assert "rank 0 only" in r["recorder"]


# -- checkpoints across world sizes and packages ------------------------------

def test_four_rank_checkpoint_resumes_bit_for_bit(runs):
    res = runs["port"][0]["resume4"]
    assert res["resumed"] == res["full"][2:]


def test_world_size_one_checkpoint_resumes_at_four_ranks(runs):
    """c1 (world size 1, 2 iterations) resumed at 4 ranks: the same rows
    on every rank, within rtol 1e-4 of JAX's 4-device resume of c1."""
    for r in runs["port"]:
        assert r["from_c1"] == runs["port"][0]["from_c1"]
    _close_rows(runs["port"][0]["from_c1"], runs["jax"]["from_c1"], "c1")


def test_restore_resharded_places_each_ranks_rows(runs):
    """restore_resharded at 4 ranks: each rank holds its 12 rows of the
    world-size-1 checkpoint's global arrays."""
    st = runs["c1_state"]
    for r in runs["port"]:
        lo = r["placed"]["lo"]
        np.testing.assert_array_equal(
            np.asarray(r["placed"]["phi_i"], np.float32),
            st.inner.phi_i[lo:lo + 12].numpy())
        np.testing.assert_array_equal(np.asarray(r["placed"]["valid"]),
                                      st.cache.valid[lo:lo + 12].numpy())


@pytest.mark.parametrize("ckpt", ["c4", "cj4"])
def test_sharded_checkpoints_resume_at_world_size_one(runs, ckpt):
    """The port's 4-rank checkpoint (c4) and JAX's 4-device one (cj4),
    resumed for 2 iterations at world size 1 in the port and on one
    device in JAX: the same schedule, rows within rtol 1e-4; the port's
    restored arrays are the files' global arrays."""
    jp, tp = _usps()
    d = str(runs["ck"] / ckpt)
    mesh1 = make_data_mesh(device="cpu")
    mine = Solver.restore(tp, _cfg(RunConfig, CostModel, mesh1, 4),
                          CheckpointManager(d))
    tree, _ = restore_resharded(CheckpointManager(d), mine.state, mesh1)
    with np.load(pathlib.Path(d) / "step_0000000002" / "arrays.npz") as z:
        np.testing.assert_array_equal(tree.inner.phi_i.numpy(),
                                      z[".inner//.phi_i"])
        np.testing.assert_array_equal(mine.state.cache.planes.numpy(),
                                      z[".cache//.planes"])
    ref = JSolver.restore(jp, _cfg(JRunConfig, JCostModel, jmake_mesh(), 4),
                          JManager(d))
    _close_rows(_rows(mine.run().trace), _rows(ref.run().trace), ckpt)
