"""repro_torch.analysis: the port's program-contract checker, on the CPU.

The counterpart of each ``tests/test_analysis.py`` test that torch can
have: the AST lint against the reference's on the same shared-syntax
fixtures (each at its path mapped from ``repro/`` to ``repro_torch/``),
the torch-only spellings, the program layer on every engine with its
facts held to the declared budgets, a negative case for each J rule, the
CLI, the registration guard, and the port's lint on ``src/repro_torch/``.
Also the shared host-to-device upload (``core.types.upload``) that
closed the pageable-copy fault.

The reference's jaxpr tests fail under jax 0.9.0 (``jax.core.ClosedJaxpr``
is gone), so the program facts here are held to the budgets the engines
declare (the reference's own), not to the reference's traces.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis.lint import lint_source as ref_lint_source
from repro_torch.analysis import (RULES, count_program, lint_source, run_all,
                                  run_program_layer)
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.contracts import (DispatchCounter, EngineTrace,
                                            check_serve_engines, check_trace,
                                            trace_cases, trace_engine)
from repro_torch.analysis.lint import parse_waivers, run_lint_layer
from repro_torch.api import engines as tengines
from repro_torch.api.engine import (EngineCapabilities, algorithms,
                                    capabilities_of, register_engine,
                                    remove_registration_hook,
                                    unregister_engine)
from repro_torch.core import mpbcfw as tmp
from repro_torch.core import types as ttypes

ROOT = Path(__file__).resolve().parents[1]

_HOT = "repro/shard/hot.py"        # in R004 scope (+ R003, R005 scopes)
_COLD = "repro/api/cold.py"        # outside the hot-path scopes


def _port(rel: str) -> str:
    return "repro_torch/" + rel[len("repro/"):]


def _rules(findings):
    return [f.rule for f in findings]


def _rule_lines(findings):
    return [(f.rule, int(f.where.rsplit(":", 1)[1])) for f in findings]


# ---------------------------------------------------------------------------
# Lint: parity with the reference on the shared syntax


_SHARED = {
    "r001_literals": (_COLD, "LO = -1e30\nHI = 1e30\n"),
    "r001_ops_home": ("repro/kernels/ops.py", "INVALID_SCORE = -1e30\n"),
    "r001_named": ("repro/kernels/viterbi.py",
                   "from .ops import INVALID_SCORE\nneg = INVALID_SCORE\n"),
    "r002_names": (_COLD, "from repro.core.types import WorkSet\n"
                          "from repro.core.driver import run\n"
                          "ws = WorkSet\n"
                          "gc = GramCache()\n"
                          "res = driver.run(problem)\n"),
    "r002_alias": ("repro/core/types.py",
                   "from ..cache.state import PlaneCache as WorkSet\n"),
    "r004_hot": (_HOT, "import numpy as np\n"
                       "def step(x):\n"
                       "    a = float(x)\n"
                       "    b = np.asarray(x)\n"
                       "    c = x.item()\n"
                       "    x.block_until_ready()\n"
                       "    return a, b, c\n"),
    "r004_init_module": (_HOT, "lam0 = float('1.0')\n"
                               "class E:\n"
                               "    def __init__(self, lam):\n"
                               "        self.lam = float(lam)\n"),
    "r004_cold": (_COLD, "def f(x):\n    return float(x)\n"),
    "r005_dtype_string": (_HOT, "def f(x):\n"
                                "    return zeros(3, dtype='float64')\n"),
    "waivers": (_HOT, "def step(x):\n"
                      "    a = float(x)  # repro: allow[R004] measured\n"
                      "    b = float(x)  # repro: allow[R001] wrong rule\n"
                      "    return a, b\n"),
    "syntax_error": (_COLD, "def f(:\n"),
}


@pytest.mark.parametrize("case", sorted(_SHARED))
def test_lint_matches_reference_on_shared_syntax(case):
    rel, src = _SHARED[case]
    want = _rule_lines(ref_lint_source(rel, src))
    got = _rule_lines(lint_source(_port(rel), src))
    assert got == want, (case, got, want)


def test_lint_shared_fixtures_fire():
    """The parity cases are not all empty: each rule's fixture fires."""
    counts = {case: _rules(lint_source(_port(rel), src))
              for case, (rel, src) in _SHARED.items()}
    assert counts["r001_literals"] == ["R001", "R001"]
    assert counts["r002_names"] == ["R002"] * 5
    assert counts["r004_hot"] == ["R004"] * 4
    assert counts["r005_dtype_string"] == ["R005"]
    assert counts["waivers"] == ["R004"]
    assert counts["syntax_error"] == ["R000"]
    assert counts["r004_init_module"] == counts["r004_cold"] == []


def test_waiver_parser_multi_rule():
    w = parse_waivers("x = 1  # repro: allow[R001, R004] both\n")
    assert w == {1: {"R001", "R004"}}


# ---------------------------------------------------------------------------
# Lint: the torch-only spellings

_SHARD = "repro_torch/shard/hot.py"


def test_r003_flags_direct_collectives_in_shard():
    src = ("import torch\nimport torch.distributed as dist\n"
           "def f(x, out):\n"
           "    dist.all_reduce(x)\n"
           "    dist.all_gather(out, x)\n"
           "    torch.distributed.all_gather_into_tensor(out, x)\n")
    assert _rule_lines(lint_source(_SHARD, src)) == [
        ("R003", 4), ("R003", 5), ("R003", 6)]
    # the counters themselves, and code outside repro_torch/shard/
    for rel in ("repro_torch/shard/telemetry.py",
                "repro_torch/launch/mesh.py", "repro_torch/core/x.py"):
        assert lint_source(rel, src) == []
    assert lint_source(_SHARD, "def f(m, x):\n    m.all_reduce(x)\n") == []


def test_r005_flags_torch_float64_spellings():
    src = ("import torch\nimport numpy as np\n"
           "def f(x):\n"
           "    a = x.to(torch.float64)\n"
           "    b = torch.zeros(3, dtype=torch.double)\n"
           "    c = x.double()\n"
           "    d = torch.zeros(3, dtype='float64')\n"
           "    e = np.zeros(3, np.float64)\n"
           "    return a, b, c, d, e\n")
    assert _rule_lines(lint_source("repro_torch/core/x.py", src)) == [
        ("R005", 4), ("R005", 5), ("R005", 6), ("R005", 7)]
    assert lint_source("repro_torch/api/x.py", src) == []


@pytest.mark.parametrize("line,fires", [
    ("torch.as_tensor(a, device=dev)", True),
    ("torch.tensor(1.0, dtype=torch.float32, device=dev)", True),
    ("torch.from_numpy(a).to(dev)", True),
    ("torch.from_numpy(a).to(dev, non_blocking=False)", True),
    ("torch.from_numpy(a).to(dev, non_blocking=True)", False),
    ("torch.as_tensor(a)", False),
    ("upload(a, dev)", False),
    ("x.tolist()", True),
    ("x.cpu()", True),
    ("x.numpy()", True),
    ("torch.cuda.synchronize()", True),
])
def test_r004_flags_blocking_uploads_and_device_reads(line, fires):
    src = f"def step(a, x, dev):\n    return {line}\n"
    got = _rules(lint_source("repro_torch/core/mpbcfw.py", src))
    assert got == (["R004"] if fires else [])
    # outside the hot scope nothing fires
    assert lint_source("repro_torch/api/solver.py", src) == []


def test_r004_hot_scope_covers_core_distributed():
    src = "def f(x):\n    return x.item()\n"
    assert _rules(lint_source("repro_torch/core/distributed.py", src)) == [
        "R004"]


def test_r002_flags_resurrected_workset_module(tmp_path):
    shim = tmp_path / "repro_torch" / "core"
    shim.mkdir(parents=True)
    (shim / "workset.py").write_text("# back from the dead\n")
    findings = run_lint_layer(tmp_path)
    assert [f.rule for f in findings] == ["R002"]
    assert "repro_torch/core/workset.py" in findings[0].where


def test_port_is_lint_clean():
    """The port's counterpart of ``test_repo_is_lint_clean``: the lint on
    ``src/repro_torch/`` (its default root) finds nothing."""
    assert run_lint_layer() == []


def test_rule_table_has_no_hlo_rules():
    """No rule of XLA's HLO (H001/H002: J001/J002 stand in); H003/H004
    are the kernels layer's."""
    for rid in ("J001", "J002", "J003", "J004", "J005", "J006", "J007",
                "J008", "J009", "R001", "R002", "R003", "R004", "R005",
                "H003", "H004"):
        assert rid in RULES
    assert sorted(r for r in RULES if r.startswith("H")) == ["H003", "H004"]


# ---------------------------------------------------------------------------
# The dispatch counter


def test_count_program_counts_syncs_f64_and_nothing_else():
    x = torch.arange(4, dtype=torch.float32)
    _, f, err = count_program(lambda: (x * 2).sum() + 1)
    assert (f.host_syncs, f.f64_values, f.collectives, err) == (0, 0, 0, None)
    assert f.ops >= 3
    _, f, _ = count_program(lambda: x.sum().item())
    assert f.host_syncs == 1 and "sync:aten::_local_scalar_dense" in f.detail
    _, f, _ = count_program(lambda: x[x > 1])       # a boolean mask
    assert f.host_syncs == 1
    _, f, _ = count_program(lambda: x.double() + 1)
    assert f.f64_values == 2


def test_count_program_separates_cpu_only_checks():
    """``one_hot`` reads its labels on the host on the CPU only."""
    y = torch.tensor([0, 2, 1])
    _, f, _ = count_program(
        lambda: torch.nn.functional.one_hot(y, 3).float())
    assert f.host_syncs == 0 and f.cpu_only_syncs == 2


def test_count_program_counts_a_gloo_collective():
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(device="cpu")
    t = torch.ones(3)
    _, f, _ = count_program(lambda: mesh.all_reduce(t))
    assert f.collectives == 1 and f.host_syncs == 0
    assert any(k.startswith("collective:c10d::allreduce") for k in f.detail)


def test_counter_flags_a_read_after_write_between_programs():
    c = DispatchCounter()
    a = torch.ones(4)
    with c:
        with c.program("async_oracle"):
            out = a * 2                    # a fresh output
            view = out[:2]                 # a view writes nothing
        with c.program("async_cache"):
            (a + 1).sum()                  # reads what it may
        assert c.hazards == []
        with c.program("async_cache"):
            (view + 1).sum()
    assert len(c.hazards) == 1 and "async_cache reads" in c.hazards[0]
    assert c.entries == {"async_oracle": 1, "async_cache": 2}


# ---------------------------------------------------------------------------
# The program layer on every engine


@pytest.fixture(scope="module")
def program_layer():
    return run_program_layer(device="cpu")


def test_program_layer_clean_on_every_engine(program_layer):
    findings, facts, traces = program_layer
    assert findings == [], [str(f) for f in findings]
    labels = {et.label for et in traces}
    want = set(algorithms()) - {"mpbcfw-gram", "mpbcfw-gap"}
    want |= {"mpbcfw-gram[single]", "mpbcfw-gram[mesh]",
             "mpbcfw-gap[single]", "mpbcfw-gap[mesh]"}
    assert len(algorithms()) == 14 and labels == want
    for label in ("serve:chain", "serve:multiclass", "serve:graph"):
        assert facts[label] == {"collectives": 0, "host_syncs": 0,
                                "f64_values": 0}


def test_program_facts_equal_declared_budgets(program_layer):
    _, facts, traces = program_layer
    for et in traces:
        caps = et.caps
        exp_pass, exp_setup = et.expected_budgets()
        assert exp_pass is not None and exp_setup is not None, et.label
        progs = {"outer", "continue"} if caps.multipass else {"outer"}
        assert {pr.name for pr in et.programs} == progs, et.label
        for pr in et.programs:
            f = pr.facts
            assert pr.sync_error is None, et.label
            assert f.pass_collectives == exp_pass, (et.label, pr.name)
            assert f.setup_collectives == exp_setup, (et.label, pr.name)
            assert f.host_syncs <= caps.host_callbacks == 0, et.label
            assert f.f64_values == 0, et.label
            if et.on_mesh:
                # every queued pass issues its all-reduce; the ledger
                # charges the passes that ran
                assert f.collectives == pr.mesh_issued == (
                    exp_setup + pr.queued_passes * exp_pass)
                assert pr.ledger_collectives == (
                    exp_setup + pr.passes_run * exp_pass)
            else:
                assert f.collectives == 0
            if caps.async_oracle and pr.name == "outer":
                assert pr.entries == {"async_oracle": 1, "async_cache": 1}
        assert facts[et.label]["on_mesh"] == et.on_mesh


def test_mesh_optional_engines_run_both_forms(program_layer):
    _, facts, _ = program_layer
    for name in ("mpbcfw-gram", "mpbcfw-gap"):
        assert facts[f"{name}[single]"]["outer_pass"] == 0
        assert facts[f"{name}[mesh]"]["outer_pass"] == 1
        assert facts[f"{name}[mesh]"]["outer_setup"] == 1


# ---------------------------------------------------------------------------
# Negative cases: each J rule fires on an injected fault


def _registered(name, factory, caps):
    register_engine(name, factory, caps, overwrite=True)
    return name


@pytest.fixture
def injected():
    names = []

    def add(name, factory, caps):
        names.append(_registered(name, factory, caps))
        return name
    yield add
    for name in names:
        unregister_engine(name)


def _rules_of(name, **kw):
    findings, _ = check_trace(trace_engine(name, device="cpu", **kw))
    return {f.rule for f in findings}, findings


class _SyncInDispatch(tengines.FusedEngine):
    def outer_iteration(self, mp, perm, perms, clock, *, ttl, key=None):
        out = super().outer_iteration(mp, perm, perms, clock, ttl=ttl)
        out[0].inner.phi.sum().item()          # the injected host sync
        return out


class _F64InDispatch(tengines.FusedEngine):
    def outer_iteration(self, mp, perm, perms, clock, *, ttl, key=None):
        out = super().outer_iteration(mp, perm, perms, clock, ttl=ttl)
        out[0].inner.phi.double()              # the injected float64
        return out


class _F64State(tengines.BCFWEngine):
    def init_state(self, cap):
        st, avg = super().init_state(cap)
        return st, avg._replace(bar_exact=avg.bar_exact.double())


def _gloo_mesh():
    from repro_torch.launch.mesh import make_data_mesh
    return make_data_mesh(device="cpu")


class _CollectiveInDispatch(tengines.FusedEngine):
    def __init__(self, problem, lam):
        super().__init__(problem, lam)
        self.side_mesh = _gloo_mesh()

    def outer_iteration(self, mp, perm, perms, clock, *, ttl, key=None):
        out = super().outer_iteration(mp, perm, perms, clock, ttl=ttl)
        self.side_mesh.all_reduce(torch.zeros(2))
        return out


class _NoObsMetrics(tengines.FusedEngine):
    def outer_iteration(self, mp, perm, perms, clock, *, ttl, key=None):
        mp, clock, stats = super().outer_iteration(mp, perm, perms, clock,
                                                   ttl=ttl)
        return mp, clock, stats._replace(metrics=None)


def _fused(cls):
    return lambda p, cfg: cls(p, cfg.lam)


def test_j003_flags_a_host_sync_in_a_dispatch(injected):
    name = injected("leaky-sync", _fused(_SyncInDispatch),
                    tengines.FusedEngine.capabilities)
    rules, findings = _rules_of(name)
    assert "J003" in rules
    assert any("_local_scalar_dense" in f.message for f in findings)


def test_j005_flags_float64_values_and_state(injected):
    name = injected("leaky-f64", _fused(_F64InDispatch),
                    tengines.FusedEngine.capabilities)
    assert "J005" in _rules_of(name)[0]
    name = injected("f64-state", _fused(_F64State),
                    tengines.BCFWEngine.capabilities)
    rules, findings = _rules_of(name)
    assert rules == {"J005"}
    assert any("float64" in f.message and "state" in f.message
               for f in findings)


def test_j002_flags_a_collective_in_a_single_device_dispatch(injected):
    name = injected("leaky-collective", _fused(_CollectiveInDispatch),
                    tengines.FusedEngine.capabilities)
    rules, _ = _rules_of(name)
    assert "J002" in rules


def test_j006_flags_missing_obs_metrics(injected):
    name = injected("no-metrics", _fused(_NoObsMetrics),
                    tengines.FusedEngine.capabilities)
    rules, findings = _rules_of(name)
    assert "J006" in rules and any("metrics is None" in f.message
                                   for f in findings)


def test_j007_flags_missing_gap_total(injected):
    gap = tengines._gap_factory

    def factory(p, cfg):
        eng = gap(p, cfg)
        inner = eng.outer_iteration

        def outer(*a, **kw):
            mp, clock, stats = inner(*a, **kw)
            return mp, clock, stats._replace(
                metrics=stats.metrics._replace(gap_total=None))
        eng.outer_iteration = outer
        return eng
    name = injected("no-gap-total", factory, capabilities_of("mpbcfw-gap"))
    rules, findings = _rules_of(name, on_mesh=False)
    assert rules == {"J007"}
    assert "gap_total" in findings[0].message


def test_j008_flags_a_sync_in_a_decode_round():
    from repro_torch import serve
    from repro_torch.core.oracles.multiclass import MulticlassSpec

    class LeakySpec(MulticlassSpec):
        pass

    class LeakyEngine(serve.MulticlassDecodeEngine):
        def _decode_batch(self, w, batch):
            w.sum().item()
            return super()._decode_batch(w, batch)

    def leaky_case():
        model = serve.ServableModel(LeakySpec(num_classes=2),
                                    torch.zeros((10,), dtype=torch.float32))
        engine = LeakyEngine(model)
        batch = engine.stack([engine.pad(
            {"x": np.zeros(5, np.float32), "y": np.int32(0)}, ())])
        return model, batch

    serve.register_decode_engine(LeakySpec, LeakyEngine,
                                 trace_case=leaky_case, trace_label="leaky")
    try:
        findings, facts = check_serve_engines(device="cpu")
        j8 = [f for f in findings if f.where == "serve:leaky"]
        assert [f.rule for f in j8] == ["J008"]
        assert "host sync" in j8[0].message
        assert facts["serve:leaky"]["host_syncs"] == 1
    finally:
        serve.unregister_decode_engine(LeakySpec, trace_label="leaky")
    findings, _ = check_serve_engines(device="cpu")
    assert findings == []


class _CollectiveInOracle(tengines.AsyncEngine):
    def __init__(self, problem, lam):
        super().__init__(problem, lam)
        self.side_mesh = _gloo_mesh()

    def _dispatch_oracle(self, w, w_ready, perm):
        self.side_mesh.all_reduce(torch.zeros(2))
        return super()._dispatch_oracle(w, w_ready, perm)


class _CacheReadsOracle(tengines.AsyncEngine):
    def _dispatch_oracle(self, w, w_ready, perm):
        out = super()._dispatch_oracle(w, w_ready, perm)
        self.fresh_planes = out[1]
        return out


def test_j009_flags_a_collective_in_the_oracle_program(injected):
    name = injected("async-collective",
                    lambda p, cfg: _CollectiveInOracle(p, cfg.lam),
                    capabilities_of("mpbcfw-async"))
    rules, findings = _rules_of(name)
    j9 = [f for f in findings if f.rule == "J009"]
    assert j9 and "1 collective(s)" in j9[0].message


def test_j009_flags_the_cache_program_reading_the_oracle(injected,
                                                         monkeypatch):
    engine = []

    def factory(p, cfg):
        engine.append(_CacheReadsOracle(p, cfg.lam))
        return engine[-1]
    name = injected("async-hazard", factory, capabilities_of("mpbcfw-async"))
    passes = tmp.multi_approx_pass

    def reading(mp, *a, **kw):
        planes = getattr(engine[-1], "fresh_planes", None)
        if planes is not None:
            planes.sum()                       # reads the oracle's output
        return passes(mp, *a, **kw)
    monkeypatch.setattr(tmp, "multi_approx_pass", reading)
    rules, findings = _rules_of(name)
    j9 = [f for f in findings if f.rule == "J009"]
    assert j9 and all("read-after-write" in f.message for f in j9)
    assert any("async_cache reads" in f.message for f in j9)


def test_j009_flags_a_fused_engine_masquerading_as_async():
    import dataclasses

    et = trace_engine("mpbcfw", device="cpu")
    fake = EngineTrace(engine="fake-async", label="fake-async",
                       caps=dataclasses.replace(et.caps, async_oracle=True),
                       on_mesh=False, device="cpu", programs=et.programs)
    findings, _ = check_trace(fake)
    assert [f.rule for f in findings] == ["J009"] * 2    # 2 iterations
    assert all("0 oracle / 0 cache" in f.message for f in findings)


# ---------------------------------------------------------------------------
# CLI, run_all, the registration guard


def test_cli_strict_exit_codes(tmp_path):
    bad = tmp_path / "repro_torch" / "api"
    bad.mkdir(parents=True)
    (bad / "mod.py").write_text("SENTINEL = 1e30\n")
    assert main(["--layer", "lint", "--strict", "--root",
                 str(tmp_path)]) == 1
    assert main(["--layer", "lint", "--root", str(tmp_path)]) == 0
    (bad / "mod.py").write_text("SENTINEL = None\n")
    assert main(["--layer", "lint", "--strict", "--root",
                 str(tmp_path)]) == 0
    assert main(["--rules"]) == 0


@pytest.mark.parametrize("fault,rule", [
    (_SyncInDispatch, "J003"), (_CollectiveInDispatch, "J002"),
    (_F64InDispatch, "J005")])
def test_cli_strict_fails_on_an_injected_fault(injected, capsys, fault,
                                               rule):
    name = injected(f"cli-{rule}", _fused(fault),
                    tengines.FusedEngine.capabilities)
    argv = ["--strict", "--device", "cpu", "--layer", "program",
            "--engines", name]
    assert main(argv) == 1
    out = capsys.readouterr().out
    assert f"{rule} {name}:outer" in out
    assert main(["--strict", "--device", "cpu", "--layer", "program",
                 "--engines", "mpbcfw"]) == 0


@pytest.mark.parametrize("layer,names", [("jaxpr", "program layer"),
                                         ("hlo", "no HLO")])
def test_cli_refuses_the_reference_only_layers(capsys, layer, names):
    with pytest.raises(SystemExit) as exc:
        main(["--layer", layer])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "no torch counterpart" in err and names in err


def test_cli_program_layer_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--layer", "program", "--engines", "fw"])


def test_cli_json_report(capsys):
    import json

    assert main(["--strict", "--device", "cpu", "--json", "--engines",
                 "fw,mpbcfw-shard"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["layers"] == ["program", "lint", "kernels"]
    assert rep["facts"]["kernels"]["h004"].startswith("not run")
    assert rep["facts"]["mpbcfw-shard"]["outer_pass"] == 1
    assert "serve:chain" in rep["facts"]


def test_run_all_lint_on_fixture_tree(tmp_path):
    bad = tmp_path / "repro_torch" / "api"
    bad.mkdir(parents=True)
    (bad / "mod.py").write_text("SENTINEL = -1e30\n")
    report = run_all(layers=["lint"], root=tmp_path)
    assert not report.ok
    assert [f.rule for f in report.findings] == ["R001"]
    assert "R001" in report.to_json()


def test_run_all_rejects_unknown_layer():
    with pytest.raises(ValueError):
        run_all(layers=["program", "nope"], device="cpu")


def test_registration_guard_rejects_undeclared_mesh_engine():
    from repro_torch.analysis import install_registration_guard

    hook = install_registration_guard()
    try:
        with pytest.raises(ValueError, match="collectives_per_pass"):
            register_engine("bad-mesh-engine", lambda p, cfg: None,
                            EngineCapabilities(supports_mesh=True))
        register_engine("ok-mesh-engine", lambda p, cfg: None,
                        EngineCapabilities(supports_mesh=True,
                                           collectives_per_pass=1,
                                           collectives_setup=1))
    finally:
        remove_registration_hook(hook)
        unregister_engine("ok-mesh-engine")
    assert "bad-mesh-engine" not in algorithms()
    assert "ok-mesh-engine" not in algorithms()


def test_capability_validation_rejects_negative_budget():
    with pytest.raises(ValueError):
        register_engine("neg-budget", lambda p, cfg: None,
                        EngineCapabilities(collectives_per_pass=-1))


# ---------------------------------------------------------------------------
# The one host-to-device upload (the pageable-copy fault)


def test_uploads_share_one_helper():
    """``index_tensor`` and the upload sites that had their own pinned
    copy (the captured steps' control buffers, the shard engine's ids, the
    gap sampler's noise, the serving inputs) all go through
    ``core.types.upload``: no other port module pins memory."""
    from repro_torch.cache import ops as cache_ops
    from repro_torch.core import distributed, graphs
    from repro_torch.policy import sampling
    from repro_torch.serve import engine as serve_engine
    from repro_torch.shard import engine as shard_engine

    for mod in (graphs, sampling, serve_engine, shard_engine, tmp):
        assert mod.upload is ttypes.upload, mod.__name__
    for mod in (shard_engine, tmp, distributed, cache_ops):
        assert mod.index_tensor is ttypes.index_tensor, mod.__name__
    assert not hasattr(graphs, "_upload")
    assert not hasattr(shard_engine, "_device_ids")
    assert not hasattr(sampling, "_on")
    pinning = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Attribute)
                    and node.attr == "pin_memory"):
                pinning.append(path.relative_to(ROOT / "src").as_posix())
    assert pinning == ["repro_torch/core/types.py"]


def test_to_device_and_index_tensor_on_the_cpu():
    ids = np.array([3, 1, 2], np.int32)
    t = ttypes.index_tensor(ids, "cpu")
    assert t.dtype == torch.int64 and t.tolist() == [3, 1, 2]
    assert ttypes.index_tensor([], "cpu").dtype == torch.int64
    assert ttypes.index_tensor(torch.tensor([4]), "cpu").tolist() == [4]
    out = torch.full((4, 2), -1.0)
    got = ttypes.upload(np.ones((2, 2), np.float64), out=out)
    assert got is out and out[:2].eq(1).all() and out[2:].eq(-1).all()
    noise = ttypes.upload(torch.arange(3.0), "cpu")
    assert noise.tolist() == [0.0, 1.0, 2.0]
    clock = tmp.make_slope_clock(0.5, -1.0, 2.0, 1e-3, "cpu")
    assert [c.shape for c in clock] == [()] * 4
    assert all(c.dtype == torch.float32 for c in clock)
    assert clock.plane_cost.item() == np.float32(1e-3)


@pytest.mark.parametrize("call", [
    lambda: trace_engine("mpbcfw"),
    lambda: trace_cases(["mpbcfw"]),
    lambda: check_serve_engines(),
    lambda: run_program_layer(["mpbcfw"]),
], ids=["trace_engine", "trace_cases", "check_serve_engines",
        "run_program_layer"])
def test_program_layer_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                               call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        call()
