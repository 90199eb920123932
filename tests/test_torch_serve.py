"""repro_torch.serve on the CPU, against the JAX package's repro.serve.

The load-bearing test is the train -> export -> save -> load -> serve
round trip: every labeling served through the batched bucketed path
equals the model's own per-example ``spec.decode`` (labels equal, no
tolerance), and ``w`` is bit-equal across save and load.  Exports cross
between the packages (the manifest and npz are the reference's format),
and a port server and a JAX server serve equal labels on the same
requests.  Multiclass rows are scored one at a time because a batched
float32 matmul rounds a row's scores by batch size; the batch-invariance
tests hold every spec's served labels to the per-example decode at batch
sizes 1, 3 and 8.  Every round is exactly one dispatch and one sync.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import serve as jserve
from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.paper import SMALL
from repro.core.oracles import chain as jchain
from repro.core.oracles import graph as jgraph
from repro.core.oracles import multiclass as jmulti
from repro.core.selection import CostModel as JCostModel
from repro.obs import metrics as jmetrics
from repro_torch import serve
from repro_torch.api import CostModel, OracleSpec, RunConfig, Solver
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.oracles import chain as tchain
from repro_torch.core.oracles import graph as tgraph
from repro_torch.core.oracles import multiclass as tmulti
from repro_torch.core.oracles.chain import ChainSpec
from repro_torch.core.oracles.graph import GraphSpec
from repro_torch.core.oracles.multiclass import MulticlassSpec
from repro_torch.core.types import SSVMProblem
from repro_torch.data import synthetic
from repro_torch.obs import metrics as tmetrics

torch.set_num_threads(1)


def _trim(ex, L):
    """Cut an example's padded arrays down to its true length."""
    return {k: np.asarray(v)[:L] for k, v in ex.items()}


def _chain_data(n=24, f=8, C=5, mean_len=6, max_len=8, seed=1):
    """The conftest chain data (or another draw), as mixed-length
    requests."""
    X, Y, M = synthetic.ocr_like(n=n, f=f, num_labels=C, mean_len=mean_len,
                                 max_len=max_len, seed=seed)
    reqs = [_trim({"x": X[i], "y": Y[i], "mask": M[i]}, int(M[i].sum()))
            for i in range(n)]
    return (X, Y, M), reqs


def _multiclass_data(n=48, f=12, C=5, seed=0):
    x, y = synthetic.usps_like(n=n, f=f, num_classes=C, seed=seed)
    return (x, y), [{"x": x[i], "y": y[i]} for i in range(n)]


def _graph_data(n=16, grid=(4, 4), f=8, seed=2):
    arrays = synthetic.horseseg_like(n=n, grid=grid, f=f, seed=seed)
    keys = ("x", "y", "mask", "edges", "edge_mask", "color")
    return arrays, [{k: a[i] for k, a in zip(keys, arrays)}
                    for i in range(n)]


def _random_w(d, seed):
    return np.random.RandomState(seed).randn(d).astype(np.float32)


# (spec, data maker, granularity) of the three bundled specs; the graph
# granularity 8 pads 4x4 lattices (16 nodes, 24 edges) to (16, 24) and 3x5
# ones (15 nodes, 22 edges) to (16, 24).
SPECS = {
    "chain": (ChainSpec(num_labels=5), _chain_data, 4),
    "multiclass": (MulticlassSpec(num_classes=5), _multiclass_data, 4),
    "graph": (GraphSpec(num_sweeps=8), _graph_data, 8),
}
JSPECS = {"chain": jchain.ChainSpec(num_labels=5),
          "multiclass": jmulti.MulticlassSpec(num_classes=5),
          "graph": jgraph.GraphSpec(num_sweeps=8)}


def _model(kind, seed=0):
    spec, make, gran = SPECS[kind]
    arrays, reqs = make()
    w = torch.from_numpy(_random_w(spec.dim({"x": arrays[0]}), seed))
    return serve.ServableModel(spec, w), reqs, gran


def _assert_served_equal_per_example(model, server, requests):
    """Labels equal (no tolerance) to the per-example decode; one dispatch
    and one sync per round."""
    served = server.serve(requests)
    assert len(served) == len(requests)
    for i, (ex, lab) in enumerate(zip(requests, served)):
        ref = model.decode(ex).numpy()
        assert lab.dtype == np.int32 and ref.dtype == np.int32
        assert np.array_equal(lab, ref), f"request {i} diverged"
    rounds, dispatches, syncs = server.ledger.counts()
    assert rounds > 0 and dispatches == rounds and syncs == rounds
    return served


# -- the acceptance round trip ----------------------------------------------


def test_train_export_save_load_serve_round_trip(tmp_path):
    """Train a ChainSpec SSVM, export, persist, reload in a fresh manager,
    and serve a mixed-length stream through the bucketed batcher: every
    labeling equal to the oracle decode, ``w`` bit-equal after the load."""
    (X, Y, M), reqs = _chain_data()
    problem = tchain.make_problem(X, Y, M, 5, device="cpu")
    solver = Solver(problem, RunConfig(lam=0.01, algo="mpbcfw", max_iters=4))
    solver.run()
    model = solver.servable(meta={"note": "round-trip"})
    assert model.meta["algo"] == "mpbcfw"
    assert model.meta["iteration"] == solver.iteration == 4
    assert model.d == problem.d
    assert torch.equal(model.w, torch.from_numpy(solver.result().w))
    model.save(CheckpointManager(tmp_path / "ck"), step=3)

    loaded = serve.ServableModel.load(CheckpointManager(tmp_path / "ck"),
                                      device="cpu")
    assert loaded.spec == model.spec
    assert loaded.w.dtype == torch.float32 and loaded.w.device.type == "cpu"
    assert torch.equal(loaded.w, model.w)
    assert loaded.meta["note"] == "round-trip"

    server = serve.StructuredServer(loaded, batch_size=4,
                                    bucket_granularity=4)
    _assert_served_equal_per_example(loaded, server, reqs)


def test_multiclass_round_trip():
    model, reqs, _ = _model("multiclass")
    server = serve.StructuredServer(model, batch_size=8)
    _assert_served_equal_per_example(model, server, reqs[:12])


def test_graph_round_trip():
    model, reqs, _ = _model("graph", seed=1)
    server = serve.StructuredServer(model, batch_size=4,
                                    bucket_granularity=8)
    _assert_served_equal_per_example(model, server, reqs[:8])


# -- batch invariance ----------------------------------------------------------


def _mixed_graph_requests():
    """4x4 and 3x5 lattices: two shapes in one bucket at granularity 8."""
    _, a = _graph_data(n=6, grid=(4, 4), seed=3)
    _, b = _graph_data(n=5, grid=(3, 5), seed=4)
    return [r for pair in zip(a, b) for r in pair] + a[5:]


@pytest.mark.parametrize("batch_size", [1, 3, 8])
@pytest.mark.parametrize("kind", ["chain", "multiclass", "graph"])
def test_served_labels_are_batch_invariant(kind, batch_size):
    """Every spec's served labels equal the per-example decode at batch
    sizes 1, 3 and 8 (filler rows, padded tails and mixed shapes
    included)."""
    model, reqs, gran = _model(kind, seed=5)
    if kind == "graph":
        reqs = _mixed_graph_requests()
    server = serve.StructuredServer(model, batch_size=batch_size,
                                    bucket_granularity=gran)
    _assert_served_equal_per_example(model, server, reqs)


@pytest.mark.parametrize("batch_size", [1, 3, 8])
def test_multiclass_served_labels_at_usps_width(batch_size):
    """Full usps width (f = 256, C = 10), where a row's scores in an
    (8, 256) @ (256, 10) matmul differ in their bits from the same row
    scored alone: the engine scores each row alone, so the labels and the
    scores behind them are the per-example decode's."""
    spec = MulticlassSpec(num_classes=10)
    x, y = synthetic.usps_like(n=40, f=256, num_classes=10, seed=7)
    w = torch.from_numpy(_random_w(spec.dim({"x": x}), 7))
    model = serve.ServableModel(spec, w)
    reqs = [{"x": x[i], "y": y[i]} for i in range(40)]
    server = serve.StructuredServer(model, batch_size=batch_size)
    _assert_served_equal_per_example(model, server, reqs)
    # The hazard this guards against, on this host's matmul.
    wc = w.reshape(10, 256)
    batched = torch.from_numpy(x[:8]) @ wc.T
    alone = torch.cat([torch.from_numpy(x[i:i + 1]) @ wc.T
                       for i in range(8)])
    assert not torch.equal(batched, alone)


# -- across packages -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["chain", "multiclass", "graph"])
def test_jax_export_serves_in_the_port(tmp_path, kind):
    """An export saved by repro.checkpoint loads in the port and the port's
    server serves the labels JAX's StructuredServer serves (labels equal),
    with ``w`` bit-equal."""
    spec, make, gran = SPECS[kind]
    arrays, reqs = make()
    w = _random_w(spec.dim({"x": arrays[0]}), 11)
    jmodel = jserve.ServableModel(JSPECS[kind], jnp.asarray(w),
                                  meta={"from": "jax"})
    jmodel.save(JManager(str(tmp_path / "ck")), step=2)
    model = serve.ServableModel.load(CheckpointManager(tmp_path / "ck"),
                                     device="cpu")
    assert model.spec == spec and model.meta == {"from": "jax"}
    assert np.array_equal(model.w.numpy(), w)
    want = jserve.StructuredServer(jmodel, batch_size=4,
                                   bucket_granularity=gran).serve(reqs)
    server = serve.StructuredServer(model, batch_size=4,
                                    bucket_granularity=gran)
    got = _assert_served_equal_per_example(model, server, reqs)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, np.asarray(b)), f"request {i}"


@pytest.mark.parametrize("kind", ["chain", "multiclass", "graph"])
def test_port_export_serves_in_jax(tmp_path, kind):
    """The other way round: a port export loads in the JAX package, whose
    server serves the port server's labels."""
    model, reqs, gran = _model(kind, seed=12)
    model.meta["from"] = "port"
    model.save(CheckpointManager(tmp_path / "ck"), step=4)
    jmodel = jserve.ServableModel.load(JManager(str(tmp_path / "ck")))
    assert jmodel.spec == JSPECS[kind]
    assert jmodel.meta == {"from": "port"}
    assert np.array_equal(np.asarray(jmodel.w), model.w.numpy())
    want = serve.StructuredServer(model, batch_size=4,
                                  bucket_granularity=gran).serve(reqs)
    got = jserve.StructuredServer(jmodel, batch_size=4,
                                  bucket_granularity=gran).serve(reqs)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(a), b), f"request {i}"


def test_servable_meta_matches_jax_on_small_ocr():
    """``Solver.servable`` on the same SMALL ocr run in both packages: the
    same meta keys and values (``train_gap`` within the Solver tolerance,
    rtol 1e-4), ``w`` and the averaged ``w`` within rtol = atol = 3e-5 of
    JAX's, and ``averaged=True`` exports the averaged iterate."""
    sc = SMALL["ocr"]
    X, Y, M = synthetic.ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                                 mean_len=sc.mean_len, max_len=sc.max_len,
                                 seed=0)
    kw = dict(lam=1.0 / sc.n, algo="mpbcfw", max_iters=3, cap=8)
    jsolver = JSolver(jchain.make_problem(jnp.asarray(X), jnp.asarray(Y),
                                          jnp.asarray(M), sc.num_classes),
                      JRunConfig(cost_model=JCostModel(), **kw))
    tsolver = Solver(tchain.make_problem(X, Y, M, sc.num_classes,
                                         device="cpu"),
                     RunConfig(cost_model=CostModel(), **kw))
    jsolver.run()
    tsolver.run()
    for averaged in (False, True):
        jm = jsolver.servable(averaged=averaged, meta={"k": 1})
        tm = tsolver.servable(averaged=averaged, meta={"k": 1})
        assert set(tm.meta) == set(jm.meta)
        for key in ("algo", "iteration", "n", "averaged", "k"):
            assert tm.meta[key] == jm.meta[key], key
        assert_allclose(tm.meta["train_gap"], jm.meta["train_gap"],
                        rtol=1e-4)
        assert_allclose(tm.w.numpy(), np.asarray(jm.w), rtol=3e-5,
                        atol=3e-5)
    want = tsolver.result().w_avg
    assert np.array_equal(tsolver.servable(averaged=True).w.numpy(), want)


def test_servable_averaged_refused_without_an_average():
    (x, y), _ = _multiclass_data()
    solver = Solver(tmulti.make_problem(x, y, 5, device="cpu"),
                    RunConfig(lam=0.01, algo="ssg", max_iters=1))
    solver.run()
    with pytest.raises(ValueError, match="keeps no averaged iterate"):
        solver.servable(averaged=True)
    assert solver.servable().meta["algo"] == "ssg"


# -- export / persistence ----------------------------------------------------


def test_servable_manifest_contents(tmp_path):
    """The manifest's ``extra["servable"]`` is the reference's key for key
    (JAX writes the same export next to it)."""
    spec = ChainSpec(num_labels=3)
    w = torch.arange(3 * 4 + 9, dtype=torch.float32)
    mgr = CheckpointManager(tmp_path / "ck")
    serve.ServableModel(spec, w, meta={"k": 1}).save(mgr, step=5)
    man = mgr.load_manifest(5)
    sv = man["extra"]["servable"]
    assert sv["kind"] == "chain"
    assert sv["params"] == {"num_labels": 3}
    assert sv["meta"] == {"k": 1}
    assert sv["d"] == 21
    jmgr = JManager(str(tmp_path / "jck"))
    jserve.ServableModel(jchain.ChainSpec(num_labels=3),
                         jnp.arange(21, dtype=jnp.float32),
                         meta={"k": 1}).save(jmgr, step=5)
    jman = jmgr.load_manifest(5)
    assert jman["extra"] == man["extra"]
    assert jman["leaves"] == man["leaves"]


def test_load_rejects_non_servable_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(0, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="not a servable export"):
        serve.ServableModel.load(mgr, device="cpu")


def test_load_defaults_to_cuda(tmp_path):
    """Without ``device`` the weights go to CUDA; a host without it raises
    (never a silent CPU load)."""
    mgr = CheckpointManager(tmp_path / "ck")
    serve.ServableModel(MulticlassSpec(num_classes=2),
                        torch.ones(8)).save(mgr)
    if torch.cuda.is_available():
        assert serve.ServableModel.load(mgr).w.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.ServableModel.load(mgr)


def test_spec_registry_round_trip_and_errors():
    assert set(serve.servable_spec_kinds()) >= {"chain", "multiclass",
                                                "graph"}
    assert serve.spec_kind(GraphSpec(num_sweeps=2)) == "graph"

    @dataclasses.dataclass(frozen=True)
    class MySpec(OracleSpec):
        scale: float = 1.0

    with pytest.raises(KeyError, match="not a registered servable spec"):
        serve.spec_kind(MySpec())
    serve.register_servable_spec("my", MySpec)
    try:
        assert serve.spec_kind(MySpec(scale=2.0)) == "my"
    finally:
        serve.unregister_servable_spec("my")
    assert "my" not in serve.servable_spec_kinds()


def test_load_rejects_an_unregistered_kind(tmp_path):
    @dataclasses.dataclass(frozen=True)
    class MySpec(OracleSpec):
        scale: float = 1.0

    serve.register_servable_spec("mine", MySpec)
    mgr = CheckpointManager(tmp_path / "ck")
    try:
        serve.ServableModel(MySpec(scale=3.0), torch.ones(4)).save(mgr)
        back = serve.ServableModel.load(mgr, device="cpu")
        assert back.spec == MySpec(scale=3.0)
    finally:
        serve.unregister_servable_spec("mine")
    with pytest.raises(KeyError, match="'mine' is not registered"):
        serve.ServableModel.load(mgr, device="cpu")


def test_from_solver_requires_spec():
    (x, y), _ = _multiclass_data()
    problem = tmulti.make_problem(x, y, 5, device="cpu")
    bare = SSVMProblem(n=problem.n, d=problem.d, data=problem.data,
                       oracle=problem.oracle)
    solver = Solver(bare, RunConfig(lam=0.01, algo="bcfw", max_iters=1))
    with pytest.raises(ValueError, match="problem.spec is None"):
        solver.servable()


# -- batcher -----------------------------------------------------------------


def test_bucket_key_rounds_up():
    for key, g in [((5,), 4), ((8,), 4), ((1, 17), 8), ((), 4), ((0,), 4),
                   ((13, 2), 1), ((3,), 0)]:
        assert serve.bucket_key(key, g) == jserve.bucket_key(key, g)
    assert serve.bucket_key((5,), 4) == (8,)
    assert serve.bucket_key((8,), 4) == (8,)
    assert serve.bucket_key((1, 17), 8) == (8, 24)
    assert serve.bucket_key((), 4) == ()
    assert serve.bucket_key((0,), 4) == (4,)  # degenerate dim still valid


def test_one_dispatch_per_round_and_bucketing():
    spec = ChainSpec(num_labels=4)
    (X, Y, M), reqs = _chain_data(n=10, f=5, C=4, mean_len=5, max_len=7,
                                  seed=4)
    w = torch.from_numpy(_random_w(spec.dim({"x": X}), 2))
    server = serve.StructuredServer(serve.ServableModel(spec, w),
                                    batch_size=3, bucket_granularity=16)
    # granularity 16 forces a single bucket: 10 requests / 3 slots.
    for r in reqs:
        server.submit(r)
    assert server.pending == 10
    done = server.drain()
    assert len(done) == 10 and server.pending == 0
    assert server.ledger.counts() == (4, 4, 4)  # ceil(10/3) rounds
    assert server.engine.replays == 0 and server.engine.programs == {}


def test_fifo_across_buckets():
    """Round scheduling picks the bucket holding the oldest waiting
    request: interleaved shapes cannot starve each other."""
    spec = MulticlassSpec(num_classes=3)
    x, y = synthetic.usps_like(n=6, f=4, num_classes=3, seed=5)
    w = torch.zeros((spec.dim({"x": x}),), dtype=torch.float32)

    class TwoBucketEngine(serve.MulticlassDecodeEngine):
        def shape_key(self, example):
            return (int(example["parity"]) + 1,)

        def pad(self, example, key):
            return {"x": np.asarray(example["x"], np.float32),
                    "y": np.asarray(example["y"], np.int32)}

    model = serve.ServableModel(spec, w)
    server = serve.StructuredServer(model, batch_size=2,
                                    engine=TwoBucketEngine(model),
                                    bucket_granularity=1)
    for i in range(6):
        server.submit({"x": x[i], "y": y[i], "parity": i % 2})
    order = []
    while server.pending:
        order.append(sorted(r.rid for r in server.step()))
    # oldest head first: evens 0,2 then odds 1,3 then 4 then 5
    assert order == [[0, 2], [1, 3], [4], [5]]


def test_step_on_empty_server_is_noop():
    model = serve.ServableModel(MulticlassSpec(num_classes=2),
                                torch.zeros((8,), dtype=torch.float32))
    server = serve.StructuredServer(model)
    assert server.step() == []
    assert server.ledger.counts() == (0, 0, 0)


def test_server_refusals():
    model = serve.ServableModel(MulticlassSpec(num_classes=2),
                                torch.zeros((8,), dtype=torch.float32))
    with pytest.raises(ValueError, match="batch_size must be >= 1"):
        serve.StructuredServer(model, batch_size=0)


def test_server_records_rounds_and_requests(tmp_path):
    """With a RunRecorder: one serve_round span per round and one
    serve_request event per request, the served labels those of a server
    without it, and one dispatch and sync per round either way."""
    from repro_torch.obs import RunRecorder, load_run, validate_file
    model, reqs, _ = _model("chain")
    path = tmp_path / "serve.jsonl"
    with RunRecorder(path) as rec:
        server = serve.StructuredServer(model, batch_size=3, recorder=rec)
        got = server.serve(reqs)
    bare = serve.StructuredServer(model, batch_size=3)
    want = bare.serve(reqs)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert server.ledger.counts() == bare.ledger.counts()
    assert validate_file(path)[1] == []
    run = load_run(path)
    assert run["meta"]["algo"] == "serve:ChainSpec"
    rounds = [s for s in run["spans"] if s["name"] == "serve_round"]
    assert len(rounds) == server.ledger.rounds
    assert sum(s["batch"] for s in rounds) == len(reqs)
    assert sorted(e["rid"] for e in run["events"]
                  if e["name"] == "serve_request") == list(range(len(reqs)))
    assert run["rows"] == []


def test_virtual_clock_latencies():
    """The injectable clock: a request's latency is its round's end minus
    its submission time, and the metrics see every request."""
    model, reqs, _ = _model("multiclass")
    ticks = iter(range(1000))
    server = serve.StructuredServer(model, batch_size=4,
                                    clock=lambda: float(next(ticks)))
    for i, r in enumerate(reqs[:6]):
        server.submit(r, t=float(-i))
    done = server.drain()
    assert [r.latency for r in done] == [0.0 + 1, 1 + 1, 2 + 1, 3 + 1,
                                         4 + 3, 5 + 3]
    reg = server.metrics.registry
    assert reg.counter("serve_requests").value == 6
    assert reg.counter("serve_rounds").value == 2
    assert reg.gauge("serve_queue_depth").value == 0


# -- ledger / metrics ----------------------------------------------------------


def test_serve_ledger_contract():
    led = serve.ServeLedger()
    with pytest.raises(RuntimeError, match="without begin_round"):
        led.commit_round()
    led.begin_round()
    with pytest.raises(RuntimeError, match="already open"):
        led.begin_round()
    with pytest.raises(RuntimeError, match="0 dispatches"):
        led.commit_round()
    led = serve.ServeLedger()
    led.begin_round()
    led.dispatched()
    led.dispatched()
    with pytest.raises(RuntimeError, match="2 dispatches"):
        led.commit_round()
    led = serve.ServeLedger()
    led.begin_round()
    led.dispatched()
    out = led.sync(torch.arange(3, dtype=torch.int32))
    led.commit_round()
    assert isinstance(out, np.ndarray) and out.tolist() == [0, 1, 2]
    assert led.counts() == (1, 1, 1)


def test_serve_metrics_series_match_jax():
    """The same observations give the same snapshot in both packages."""
    ms = (serve.ServeMetrics(), jserve.ServeMetrics())
    for m in ms:
        m.observe_request(0.001, 7)
        m.observe_request(0.004, 9)
        m.observe_round(batch=2, fill=0.5, round_s=0.01, bucket=(8,))
        m.set_queue_depth(3)
    reg = ms[0].registry
    assert reg.counter("serve_requests").value == 2
    assert reg.counter("serve_labels").value == 16
    assert reg.counter("serve_rounds").value == 1
    assert reg.gauge("serve_queue_depth").value == 3
    assert ms[0].latency_quantile(0.5) is not None
    assert ms[0].snapshot()["serve_latency"]["count"] == 2
    assert ms[0].snapshot() == ms[1].snapshot()
    for q in (0.0, 0.5, 0.99, 1.0):
        assert ms[0].latency_quantile(q) == ms[1].latency_quantile(q)


def test_metrics_registry_matches_the_reference():
    """obs/metrics.py is the reference's copy: histograms, quantiles,
    counters, gauges, TraceRow ingestion and snapshot/load agree."""
    from repro.api.config import TraceRow as JRow
    from repro_torch.api.config import TraceRow as TRow
    r = np.random.RandomState(0)
    values = np.concatenate([r.lognormal(-6, 3, 200), [0.0, -1.0, 1e9,
                                                       math.nan]])
    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg, Row in zip(regs, (TRow, JRow)):
        for v in values:
            reg.histogram("h").observe(v)
        reg.counter("c").inc(3)
        reg.gauge("g").set(0.25)
        for it in range(3):
            reg.observe_row(Row(it, 10 * (it + 1), 40 * it, 0.5 * it, 2.0,
                                1.0 - 0.1 * it, 1.0 + 0.1 * it, 2.0, 1.5,
                                it, 1, 1), collectives=it)
    assert regs[0].snapshot() == regs[1].snapshot()
    for q in (0.01, 0.5, 0.9, 0.99, 1.0):
        assert regs[0].histogram("h").quantile(q) == \
            regs[1].histogram("h").quantile(q)
    back = tmetrics.MetricsRegistry()
    back.load(regs[1].snapshot())
    assert back.snapshot() == regs[0].snapshot()
    with pytest.raises(TypeError, match="is a Counter"):
        regs[0].histogram("c")
    with pytest.raises(ValueError, match="counters only go up"):
        regs[0].counter("c").inc(-1)


# -- engine registry -----------------------------------------------------------


def test_vmap_fallback_for_unregistered_spec():
    @dataclasses.dataclass(frozen=True)
    class SignSpec(OracleSpec):
        def dim(self, data):
            return int(data["x"].shape[-1])

        def truth(self, batch):
            return batch["y"]

        def decode(self, w, batch):
            return (batch["x"] @ w > 0).to(torch.int32)

    r = np.random.RandomState(4)
    x = r.randn(6, 5).astype(np.float32)
    w = torch.from_numpy(r.randn(5).astype(np.float32))
    model = serve.ServableModel(SignSpec(), w)
    engine = serve.decode_engine_for(model)
    assert type(engine) is serve.VmapDecodeEngine
    server = serve.StructuredServer(model, batch_size=4, engine=engine)
    served = server.serve([{"x": x[i], "y": np.int32(0)} for i in range(6)])
    for i, lab in enumerate(served):
        assert np.array_equal(lab, model.decode({"x": x[i],
                                                 "y": np.int32(0)}).numpy())


def test_engine_resolution_and_registration():
    """Exact class first, then the MRO, then the fallback; a registered
    factory wins until it is unregistered."""
    @dataclasses.dataclass(frozen=True)
    class MyChain(ChainSpec):
        pass

    w = torch.zeros(3 * 4 + 9)
    assert type(serve.decode_engine_for(
        serve.ServableModel(MyChain(num_labels=3), w))) \
        is serve.ChainDecodeEngine

    class Custom(serve.ChainDecodeEngine):
        pass

    serve.register_decode_engine(MyChain, Custom,
                                 trace_case=lambda: None,
                                 trace_label="mine")
    try:
        assert type(serve.decode_engine_for(
            serve.ServableModel(MyChain(num_labels=3), w))) is Custom
    finally:
        serve.unregister_decode_engine(MyChain, trace_label="mine")
    assert type(serve.decode_engine_for(
        serve.ServableModel(MyChain(num_labels=3), w))) \
        is serve.ChainDecodeEngine
    assert {label for label, _, _ in serve.serve_trace_cases()} == \
        {"chain", "multiclass", "graph"}


def test_registered_engines_have_trace_cases():
    """The three tiny trace cases, as the reference registers them: the
    same labels, engines and padded batch shapes; each decodes on the CPU
    to labels of the batch's shape."""
    cases = {label: (engine, batch)
             for label, engine, batch in serve.serve_trace_cases()}
    jcases = {label: (engine, batch)
              for label, engine, batch in jserve.serve_trace_cases()}
    assert set(cases) == {"chain", "multiclass", "graph"} <= set(jcases)
    for label, (engine, batch) in cases.items():
        jengine, jbatch = jcases[label]
        assert type(engine).__name__ == type(jengine).__name__
        assert {k: v.shape for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in jbatch.items()}
        labels = engine.decode(batch)
        assert labels.dtype == torch.int32
        assert tuple(labels.shape) == batch["y"].shape
