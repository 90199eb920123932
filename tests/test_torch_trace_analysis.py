"""The port's loop tracer and the dry-run record it completes
(``repro_torch.launch.trace_analysis``, ``launch.dryrun``), the
counterpart of ``repro/launch/hlo_analysis.py`` and the reference's
dry-run record, on the CPU.

  * The counterparts of ``tests/test_launch.py``'s HLO parser tests, on a
    fake 4-rank group in a subprocess (the group is process-global): an
    all-gather outside a marked 3-trip loop and an all-reduce inside it
    land in the static and the per-trip buckets; a nested loop counts its
    site once; a trip that issues another collective is named; the
    backward of a node a trip made is in that trip; a layer loop under
    the probe switch is no loop, a chunk loop still is.
  * The ten archs' ``reduced_config`` train steps, and a decode step of
    one arch of each family, on a (4, 4) mesh of a fake 16-rank group,
    three subprocesses side by side under a time limit: static plus each
    loop's per-trip bytes times its trips equals the all-trips total,
    kind by kind; ``while_trip_counts`` holds the layer loops' trips; no
    loop's trips differ.
  * The reference side by side: qwen2-0.5b, olmoe-1b-7b and xlstm-125m
    against the reference's scanned compile (``repro.launch.dryrun
    .run_cell`` on 16 forced host devices, the same reduced config and
    cell) in a fourth subprocess.  The record's key set is the
    reference's less the XLA-only keys and plus the port's own, both
    named here; both programs loop over the layers (the reference's
    compiled while loops' ``known_trip_count``: its record's
    ``while_trip_counts`` grep finds nothing in jax 0.9's CPU HLO, whose
    loop conditions compare two parameters); each device's argument bytes
    equal the reference's less its step counter (an int32 scalar; the
    port's step is a host int), and no shard is padded here (the rules
    shard only dims the mesh axis divides).
    Each device's temporaries are at most the reference compile's.
  * The temporaries: at world size 1, on real CPU tensors, the counter's
    ``temp_size_in_bytes`` is within 2 % of ``torch.distributed._tools
    .mem_tracker.MemTracker``'s peak less the arguments.  Plain tensors
    never reach the DTensor path; ``tests/test_torch_dryrun_memory.py``
    holds the counter to MemTracker there, on a (2, 2) mesh.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun, roofline, trace_analysis
from repro_torch.models import hybrid, xlstm_lm

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 300
B, S, MESH = 16, 16, (4, 4)
FAMILY_ARCHS = ("qwen2-0.5b", "olmoe-1b-7b", "deepseek-v3-671b",
                "zamba2-7b", "xlstm-125m", "whisper-base")
SIDE_BY_SIDE = ("qwen2-0.5b", "olmoe-1b-7b", "xlstm-125m")
#: Keys of the reference's record that only an XLA compile has.
XLA_ONLY = {"hlo_bytes", "compile_s", "cost_analysis", "lower_s"}
#: Keys only the port's record has (``trace_s`` in ``lower_s``'s place).
PORT_ONLY = {"trace_s", "mesh_shape", "flops_by_op",
             "collective_bytes_all_trips", "collective_all_trips_by_kind",
             "collective_all_trips_counts", "collective_loops",
             "collective_uneven_trips"}
#: The reference's step counter: an int32 scalar among its arguments.
STEP_COUNTER_BYTES = 4


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return env


def _run(procs):
    """Each ``(key, Popen)``'s last stdout line as JSON, by key."""
    got = {}
    try:
        for key, p in procs:
            out, err = p.communicate(timeout=LIMIT)
            assert p.returncode == 0, err[-3000:]
            got[key] = json.loads(out.strip().splitlines()[-1])
    finally:
        for _, p in procs:
            p.kill()
    return got


def _popen(script, *argv):
    return subprocess.Popen([sys.executable, "-c", script, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env())


# -- units on a fake 4-rank group ---------------------------------------------

_UNITS = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.dryrun import LocalCounter
    from repro_torch.launch.trace_analysis import loop
    from repro_torch.models import common

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    group = dist.group.WORLD

    def gather(t):          # f32[n] -> f32[4 n]
        return funcol.all_gather_tensor(t, 0, group)

    def reduce(t):
        return funcol.all_reduce(t, "sum", group)

    class Gathered(torch.autograd.Function):
        # an all-gather whose backward reduce-scatters, as DTensor's
        # redistribution of a sharded weight
        @staticmethod
        def forward(ctx, t):
            return gather(t)

        @staticmethod
        def backward(ctx, g):
            return funcol.reduce_scatter_tensor(g, "sum", 0, group)

    def traced(fn):
        counter = LocalCounter()
        with counter:
            fn()
        s = counter.loops.stats()
        return dict(static=s.bytes_by_kind, static_counts=s.count_by_kind,
                    in_loop=s.in_loop_bytes_by_kind,
                    in_loop_counts=s.in_loop_count_by_kind,
                    all_trips=s.all_trips_bytes_by_kind,
                    total_bytes=s.total_bytes,
                    total_in_loop_bytes=s.total_in_loop_bytes,
                    total_count=s.total_count, loops=s.loops,
                    uneven=s.uneven, trips=counter.loops.trip_counts())

    def flat():
        gather(torch.ones(2))
        for _ in loop("body", 3):
            reduce(torch.ones(4))

    def nested():
        for _ in loop("outer", 2):
            for _ in loop("inner", 3):
                reduce(torch.ones(4))

    def uneven():
        for i in loop("u", 3):
            (gather if i == 1 else reduce)(torch.ones(4))

    def backward():
        w = torch.ones(2, requires_grad=True)
        y = 0
        for _ in loop("layers", 2):
            y = y + Gathered.apply(w).sum()
        torch.autograd.grad(y, [w])

    def unrolled():
        common.set_probe_unroll(True)
        try:
            for _ in common.layer_loop("layers", 2):
                for _ in loop("chunks", 3):
                    reduce(torch.ones(4))
        finally:
            common.set_probe_unroll(False)

    print(json.dumps({f.__name__: traced(f) for f in
                      (flat, nested, uneven, backward, unrolled)}))
    """)


@pytest.fixture(scope="module")
def units():
    return _run([("units", _popen(_UNITS))])["units"]


def test_static_and_per_trip_buckets(units):
    """The counterpart of ``test_hlo_collective_parser_in_loop_buckets``:
    the all-gather outside the loop is static, the all-reduce inside it
    counted once with one trip's bytes; the trip count is 3."""
    got = units["flat"]
    assert got["static_counts"] == {"all-gather": 1}
    assert got["static"] == {"all-gather": 8 * 4}
    assert got["in_loop_counts"] == {"all-reduce": 1}
    assert got["in_loop"] == {"all-reduce": 4 * 4}
    assert got["total_bytes"] == 32          # static bucket only
    assert got["total_in_loop_bytes"] == 16  # caller owns the trip count
    assert got["total_count"] == 2
    assert got["trips"] == [3]
    assert got["all_trips"] == {"all-gather": 32, "all-reduce": 3 * 16}
    assert got["loops"] == [{"loop": "body", "trips": 3,
                             "bytes_by_kind": {"all-reduce": 16},
                             "count_by_kind": {"all-reduce": 1}}]
    assert got["uneven"] == []


def test_a_nested_loop_counts_its_site_once(units):
    got = units["nested"]
    assert got["trips"] == [2, 3]
    assert got["static"] == {}
    assert got["in_loop_counts"] == {"all-reduce": 3}   # one outer trip
    assert got["all_trips"] == {"all-reduce": 2 * 3 * 16}
    assert [e["loop"] for e in got["loops"]] == ["outer"]
    assert got["uneven"] == []


def test_a_trip_that_differs_is_named(units):
    got = units["uneven"]
    assert got["in_loop_counts"] == {"all-reduce": 1}   # the first trip's
    assert [(u["loop"], u["trip"]) for u in got["uneven"]] == [("u", 1)]
    assert got["uneven"][0]["count_by_kind"] == {"all-gather": 1}


def test_the_backward_of_a_trip_is_in_that_trip(units):
    """The reduce-scatter each trip's node issues in the backward, outside
    the Python loop, is in the loop, as the reference's backward scan."""
    got = units["backward"]
    assert got["static"] == {}
    assert got["in_loop_counts"] == {"all-gather": 1, "reduce-scatter": 1}
    assert got["in_loop"] == {"all-gather": 32, "reduce-scatter": 8}
    assert got["uneven"] == [] and got["trips"] == [2]


def test_the_probe_switch_unrolls_layer_loops_only(units):
    got = units["unrolled"]
    assert got["trips"] == [3]
    assert [e["loop"] for e in got["loops"]] == ["chunks", "chunks"]
    assert got["in_loop_counts"] == {"all-reduce": 2}   # two entries
    assert got["all_trips"] == {"all-reduce": 2 * 3 * 16}


def test_loop_is_a_range_without_a_tracer():
    assert trace_analysis.active_tracer() is None
    assert trace_analysis.loop("x", 3) == range(3)
    with trace_analysis.LoopTracer() as tracer:
        assert list(trace_analysis.loop("x", 3)) == [0, 1, 2]
        assert trace_analysis.loop("empty", 0) == range(0)
    assert trace_analysis.active_tracer() is None
    assert tracer.trip_counts() == [3]


def test_the_roofline_reads_the_cards_peaks_from_here():
    assert roofline.roofline_terms is trace_analysis.roofline_terms
    assert (roofline.CARD, roofline.PEAK_FLOPS, roofline.HBM_BW,
            roofline.LINK_BW) == (trace_analysis.CARD,
                                  trace_analysis.PEAK_FLOPS,
                                  trace_analysis.HBM_BW,
                                  trace_analysis.LINK_BW)
    t = trace_analysis.roofline_terms(2 * 989e12, 3.35e12, 450e9, 256)
    assert t == {"compute_s": 2.0, "memory_s": 1.0, "collective_s": 1.0}


# -- the ten archs on a (4, 4) mesh -------------------------------------------

_PORT = textwrap.dedent("""
    import json, sys
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    out = {}
    for cell in sys.argv[1].split(","):
        arch, kind = cell.split("/")
        seq = 32 if kind == "decode" else %(S)d
        out[cell] = dryrun.run_cell(
            arch, kind, False, mesh_shape=%(mesh)r,
            cfg=configs.reduced_config(arch),
            cell=ShapeCell(kind, seq, %(B)d, kind))
    print(json.dumps(out))
    """) % dict(S=S, B=B, mesh=MESH)

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import json, re, sys
    import jax
    jax.devices()       # 16 devices, before the dry-run module's 512
    from repro import configs
    from repro.configs.shapes import ShapeCell
    from repro.launch import dryrun, hlo_analysis

    configs.SHAPES["reduced_train"] = ShapeCell("reduced_train", %(S)d,
                                                %(B)d, "train")
    dryrun.build_config = lambda arch, shape, ov: \\
        configs.reduced_config(arch)
    texts = []
    grep = hlo_analysis.while_trip_counts

    def seen(hlo):
        texts.append(hlo)
        return grep(hlo)
    hlo_analysis.while_trip_counts = seen
    out = {}
    for arch in sys.argv[1].split(","):
        rec = dryrun.run_cell(arch, "reduced_train", False,
                              mesh_shape=%(mesh)r)
        rec["known_trip_counts"] = [int(n) for n in re.findall(
            r'"known_trip_count":\\{"n":"(\\d+)"\\}', texts[-1])]
        out[arch] = rec
    print(json.dumps(out))
    """) % dict(S=S, B=B, mesh=MESH)

CELLS = ([f"{a}/train" for a in sorted(configs.ARCHS)]
         + [f"{a}/decode" for a in FAMILY_ARCHS])


@pytest.fixture(scope="module")
def records():
    parts = [",".join(CELLS[i::3]) for i in range(3)]
    got = _run([(i, _popen(_PORT, part)) for i, part in enumerate(parts)]
               + [("reference", _popen(_REFERENCE, ",".join(SIDE_BY_SIDE)))])
    recs = {"reference": got.pop("reference")}
    for part in got.values():
        recs.update(part)
    return recs


def layer_trips(cfg, kind: str) -> list:
    """The trips of the layer loops a step of ``cfg`` runs (the
    reference's layer scans)."""
    if cfg.family == "hybrid":
        n_groups, k, tail = hybrid._groups(cfg)
        return [n_groups, k] + ([tail] if tail else [])
    if cfg.family == "ssm":
        n_groups, k, tail = xlstm_lm._groups(cfg)
        return [n_groups, k - 1] + ([tail] if tail else [])
    if cfg.family == "audio":
        return ([cfg.encoder_layers] if kind != "decode" else []) \
            + [cfg.num_layers]
    if cfg.moe and cfg.first_dense_layers:
        return [cfg.first_dense_layers,
                cfg.num_layers - cfg.first_dense_layers]
    return [cfg.num_layers]


@pytest.mark.parametrize("cell", CELLS)
def test_static_plus_trips_times_per_trip_is_the_total(records, cell):
    rec = records[cell]
    assert rec["ok"] and rec["chips"] == 16
    for what in ("by_kind", "counts"):
        static = rec[{"by_kind": "collective_by_kind",
                      "counts": "collective_counts"}[what]]
        key = "bytes_by_kind" if what == "by_kind" else "count_by_kind"
        total = dict(static)
        per_trip = {}
        for entry in rec["collective_loops"]:
            for kind, n in entry[key].items():
                total[kind] = total.get(kind, 0) + n * entry["trips"]
                per_trip[kind] = per_trip.get(kind, 0) + n
        assert total == rec[f"collective_all_trips_{what}"], what
        assert per_trip == rec[f"collective_in_loop_{what}"], what
    assert rec["collective_bytes_all_trips"] == sum(
        rec["collective_all_trips_by_kind"].values()) > 0
    assert rec["collective_in_loop_bytes"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_while_trip_counts_hold_the_layer_loops(records, cell):
    arch, kind = cell.split("/")
    trips = records[cell]["while_trip_counts"]
    want = layer_trips(configs.reduced_config(arch), kind)
    assert all(t in trips for t in want), (want, trips)
    assert len(trips) <= trace_analysis.MAX_TRIP_COUNTS


@pytest.mark.parametrize("cell", CELLS)
def test_no_loop_trip_differs(records, cell):
    assert records[cell]["collective_uneven_trips"] == []


@pytest.mark.parametrize("arch", SIDE_BY_SIDE)
def test_record_keys_are_the_references(records, arch):
    port, ref = records[f"{arch}/train"], records["reference"][arch]
    ref = {k: v for k, v in ref.items() if k != "known_trip_counts"}
    assert set(ref) - XLA_ONLY == set(port) - PORT_ONLY
    assert set(ref["memory_analysis"]) - {"generated_code_size_in_bytes"} \
        == set(port["memory_analysis"])
    assert port["memory_analysis"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("arch", SIDE_BY_SIDE)
def test_both_programs_loop_over_the_layers(records, arch):
    port, ref = records[f"{arch}/train"], records["reference"][arch]
    want = layer_trips(configs.reduced_config(arch), "train")
    assert all(t in port["while_trip_counts"] for t in want)
    # XLA folds a one-trip loop into its caller (xlstm-125m's one mLSTM
    # layer per group and its one-layer tail).
    assert all(t in ref["known_trip_counts"] for t in want if t > 1), \
        ref["known_trip_counts"]


@pytest.mark.parametrize("arch", SIDE_BY_SIDE)
def test_argument_bytes_per_device_are_the_references(records, arch):
    port, ref = records[f"{arch}/train"], records["reference"][arch]
    assert port["memory_analysis"]["argument_size_in_bytes"] \
        + STEP_COUNTER_BYTES == ref["memory_analysis"][
            "argument_size_in_bytes"]


@pytest.mark.parametrize("arch", SIDE_BY_SIDE)
def test_temp_bytes_per_device_at_most_the_references(records, arch):
    """The eager step's peak of made bytes against XLA's temporaries for
    the same cell (qwen2 2.39e5 against 5.33e5 B, olmoe 4.34e5 against
    5.53e5, xlstm 1.06e6 against 1.69e6, torch 2.13 and jax 0.9)."""
    port, ref = records[f"{arch}/train"], records["reference"][arch]
    assert 0 < port["memory_analysis"]["temp_size_in_bytes"] \
        <= ref["memory_analysis"]["temp_size_in_bytes"]


# -- the temporaries at world size 1 ------------------------------------------

@pytest.mark.parametrize("arch,remat", [
    ("qwen2-0.5b", "nothing"), ("qwen2-0.5b", "none"),
    ("olmoe-1b-7b", "nothing"), ("xlstm-125m", "nothing")])
def test_temp_bytes_agree_with_mem_tracker(arch, remat):
    """One train step on real CPU tensors (8 sequences of 32 tokens,
    weights from seed 0, token ids 0): the counter's peak of the bytes
    made in the step against MemTracker's peak less the arguments."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              remat_policy=remat)
    step, args, _ = dryrun.cell_step(cfg, ShapeCell("train", 32, 8,
                                                    "train"))
    gen = torch.Generator().manual_seed(0)
    leaves = [t for t in dryrun.tree_leaves(args)
              if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for t in leaves:
            if t.is_floating_point():
                t.copy_(0.02 * torch.randn(t.shape, generator=gen))
            else:
                t.zero_()
    counter, out, _ = dryrun.trace_step(step, args)
    temp = counter.peak_bytes
    del out
    assert counter.live_bytes == 0      # each made storage freed
    tracker = MemTracker()
    tracker.track_external(*leaves)
    with tracker:
        out = step(*args)
    peak = tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    independent = peak - dryrun._local_bytes(args)
    assert abs(temp - independent) <= 0.02 * independent, (temp, independent)
