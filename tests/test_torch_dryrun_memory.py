"""The dry-run's temporaries on the sharded path
(``repro_torch.launch.dryrun.LocalCounter`` on DTensors), held to an
independent tracker, on the CPU.

  * A unit: inside the counter, an op whose output lies on the meta
    device (shape without storage; no rank holds it) moves neither
    ``peak_bytes`` nor ``bytes``, with or without ``FakeTensorMode``; its
    FLOPs are counted.  The same op on the CPU adds its bytes.
  * ``kernels.ops.contiguous_stride`` is the stride ``torch.empty`` gives a
    shape, made from the shape alone.
  * The arguments counted are those an op reads (through a view, a
    collective or an in-place write too), as XLA's executable takes only
    the arguments its program uses: one no op touches is left out.
  * One ``dryrun.make_train_step`` step and one prefill step on *real* CPU
    tensors, on a (2, 2) ('data', 'model') mesh of a fake 4-rank group
    (the dry-run's own, ``launch.mesh.force_host_platform_device_count``),
    weights from seed 0, token ids 0, remat "nothing", for reduced
    olmoe-1b-7b and deepseek-v3-671b (the experts on DTensors, MLA) and
    reduced qwen2-0.5b (the dense control): the counter's peak is within
    2 % of ``torch.distributed._tools.mem_tracker.MemTracker``'s peak less
    the arguments (MemTracker told of each rank's local shards), every
    storage it counted is freed by the end, and no op on a rank's shards
    makes a tensor on the meta device.  At 128 sequences of 8 tokens the
    experts' global (E, C, D) slab outweighs the gap to the peak: the
    earlier counter, which counted the meta tensor made to read that
    slab's stride, is over by 3.7-29 % on both MoE archs' train and
    prefill steps, and equal on the dense control.  Reduced zamba2-7b's
    prefill is a case of its own at 4 sequences of 512 tokens (2 SSD
    chunks of 256), where the SSD's intra-chunk slabs set the peak
    (``tests/test_torch_ssd_memory.py``).
  * The recurrent decode caches' whole-layer writes
    (``models.common.cache_write`` with no position): reduced xlstm-125m
    and zamba2-7b decode steps traced as ``dryrun.run_cell`` traces them,
    on a (4, 4) mesh of a fake 16-rank group, the cache placed by
    ``dryrun.cache_shardings``.  Where the cache is sharded, no local op
    inside such a write makes a tensor of the whole state's size; the
    earlier write, which gathered the new state whole on every rank
    (kept here), does.  Against it the step's FLOPs are equal,
    its all-gathered bytes lower by at least the states it gathered, its
    temporaries no higher.  The sharded values are held to the unsharded
    run in ``tests/test_torch_lm_sharded*.py``.
  * Reduced whisper-base's decode on that mesh reads no weight of the
    encoder and neither of the cross-attention's k and v projections
    (their k and v are in the cache), and every other weight: no rank
    gathers a weight the step does not use.

Each step in a subprocess of its own (the fake group is process-global),
side by side, under a time limit.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 300
B, S, MESH = 128, 8, (2, 2)
ARCHS = ("olmoe-1b-7b", "deepseek-v3-671b", "qwen2-0.5b")
KINDS = ("train", "prefill")
# (arch, kind) -> (batch, seq): ARCHS x KINDS at B x S, and zamba2-7b's
# prefill where its SSD slabs outweigh the rest
STEPS = {(a, k): (B, S) for a in ARCHS for k in KINDS}
STEPS["zamba2-7b", "prefill"] = (4, 512)
STEP_IDS = [f"{a}-{k}" for a, k in STEPS]
TOLERANCE = 0.02


# -- units --------------------------------------------------------------------

@pytest.mark.parametrize("fake", [False, True], ids=["plain", "fake"])
def test_a_meta_output_holds_no_bytes(fake):
    """A (1024, 1024, 64) tensor made on the meta device and a batched
    product of it: no byte counted, the product's FLOPs counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import contextlib
    shape = (1024, 1024, 64)
    with FakeTensorMode(allow_non_fake_inputs=True) if fake \
            else contextlib.nullcontext():
        counter = dryrun.LocalCounter()
        with counter:
            m = torch.empty(shape, device="meta")
            p = torch.bmm(m.transpose(1, 2), m)
        assert m.device.type == "meta" and p.device.type == "meta"
    assert counter.peak_bytes == counter.live_bytes == 0
    assert counter.bytes == 0
    assert counter.flops == 2 * 1024 * 64 * 1024 * 64


def test_a_cpu_output_of_that_shape_adds_its_bytes():
    """The same ops on (fake) CPU tensors: the empty tensor's and the
    product's bytes, both live at the peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = (1024, 1024, 64)
    n = 1024 * 1024 * 64 * 4
    prod = 1024 * 64 * 64 * 4
    with FakeTensorMode(allow_non_fake_inputs=True):
        counter = dryrun.LocalCounter()
        with counter:
            m = torch.empty(shape)
            p = torch.bmm(m.transpose(1, 2), m)
        assert p.device.type == "cpu"
        assert counter.peak_bytes == n + prod
        assert counter.bytes == n + (2 * n + prod)  # bmm reads m twice
        assert counter.flops == 2 * 1024 * 64 * 1024 * 64


@pytest.mark.parametrize("shape", [(), (3,), (2, 0, 3), (4, 1, 0, 2),
                                   (256, 32768, 7168), (1, 1, 5)])
def test_contiguous_stride_is_torchs(shape):
    from repro_torch.kernels.ops import contiguous_stride
    assert contiguous_stride(shape) \
        == torch.empty(shape, device="meta").stride()


def test_arguments_count_only_what_the_step_reads():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        tok = torch.empty(8, 4, dtype=torch.int32)
        args = {"read": torch.empty(64, 32), "viewed": torch.empty(8, 8),
                "written": torch.empty(16), "unused": torch.empty(1024),
                "tokens": tok, "labels": tok}
        counter = dryrun.LocalCounter()
        counter.hold(args)
        with counter:
            y = args["read"] * 2
            z = args["viewed"][2:4].sum()
            args["written"].copy_(torch.ones(16))
            t = args["tokens"].long()
        del y, z, t
    # tokens and labels, one tensor at world size 1, are two arguments
    assert counter.argument_bytes == (64 * 32 + 8 * 8 + 16 + 2 * 32) * 4
    assert counter.argument_bytes == dryrun._local_bytes(args) - 1024 * 4


# -- the sharded step against MemTracker --------------------------------------

_STEP = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import force_host_platform_device_count
    from repro_torch.models import common, registry

    arch, kind, B, S = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:5])
    force_host_platform_device_count(%(world)d)
    mesh = init_device_mesh("cpu", %(mesh)r,
                            mesh_dim_names=("data", "model"))


    class MetaOutputs(TorchDispatchMode):
        \"\"\"The local ops that make a tensor on the meta device (the
        ops DTensor's sharding propagation traces left out).\"\"\"
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if DTensor in types:
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if not getattr(dryrun._PROPAGATING, "depth", 0) and any(
                    t.device.type == "meta" for t in dryrun._tensors(out)):
                self.ops.add(str(func))
            return out


    cfg = dataclasses.replace(configs.reduced_config(arch),
                              remat_policy="nothing")
    psh = common.param_shardings(registry.param_specs(cfg), mesh)
    step, args, _ = dryrun.cell_step(cfg, ShapeCell(kind, S, B, kind),
                                     mesh, psh)
    local = [t.to_local() if common.is_dtensor(t) else t
             for t in dryrun.tree_leaves(args) if isinstance(t, torch.Tensor)]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in local:
            if t.is_floating_point():
                t.copy_(0.02 * torch.randn(t.shape, generator=gen))
            else:
                t.zero_()
    counter, meta = dryrun.LocalCounter(), MetaOutputs()
    counter.hold(args)
    with counter, meta:
        out = step(*args)
    del out
    tracker = MemTracker()
    tracker.track_external(*local)
    with tracker:
        out = step(*args)
    peak = tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    print(json.dumps(dict(
        temp=counter.peak_bytes, live=counter.live_bytes,
        arguments=dryrun._local_bytes(args),
        independent=peak - dryrun._local_bytes(args),
        meta_ops=sorted(meta.ops))))
    """) % dict(world=MESH[0] * MESH[1], mesh=MESH)


_DECODE = textwrap.dedent("""
    import json, math, sys
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.models import attention, common, hybrid, xlstm_lm
    from repro_torch.models.common import (full_replicate, is_dtensor,
                                           local_region)

    arch = sys.argv[1]


    def earlier_cache_write(c, val, dim=None, index=0):
        # the write before: ``val`` gathered whole on every rank, each
        # rank then copying the part it holds
        if is_dtensor(val):
            val = full_replicate(val).to_local()
        if not is_dtensor(c):
            (c if dim is None else c.select(dim, index)).copy_(val)
            return
        shape, off = local_region(c.shape, c.device_mesh, c.placements)
        local = c.to_local()
        if dim is not None:
            if not off[dim] <= index < off[dim] + shape[dim]:
                return
            local = local.select(dim, index - off[dim])
            shape = tuple(shape[:dim]) + tuple(shape[dim + 1:])
            off = tuple(off[:dim]) + tuple(off[dim + 1:])
        local.copy_(val[tuple(slice(o, o + n) for o, n in zip(off, shape))])


    class Largest(TorchDispatchMode):
        # the most elements of any tensor a rank's local op makes
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if DTensor in types or func is dryrun._DEVICE:
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if not getattr(dryrun._PROPAGATING, "depth", 0):
                for t in dryrun._tensors(out):
                    self.numel = max(self.numel, t.numel())
            return out


    def traced(write):
        writes = []

        def watched(c, val, dim=None, index=0):
            if dim is not None or not is_dtensor(c):
                return write(c, val, dim, index)
            largest = Largest()
            with largest:
                write(c, val, dim, index)
            writes.append(dict(made=largest.numel,
                               shard=c.to_local().numel(),
                               whole=c.numel(),
                               nbytes=val.numel() * val.element_size()))

        for mod in (attention, common, hybrid, xlstm_lm):
            if hasattr(mod, "cache_write"):
                mod.cache_write = watched
        rec = dryrun.run_cell(arch, "decode", False, mesh_shape=%(mesh)r,
                              cfg=configs.reduced_config(arch),
                              cell=ShapeCell("decode", 32, %(B)d, "decode"))
        return dict(writes=writes, flops=rec["flops"],
                    temp=rec["memory_analysis"]["temp_size_in_bytes"],
                    gathered=rec["collective_all_trips_by_kind"].get(
                        "all-gather", 0))


    print(json.dumps(dict(now=traced(common.cache_write),
                          earlier=traced(earlier_cache_write))))
    """) % dict(mesh=(4, 4), B=16)
RECURRENT = ("xlstm-125m", "zamba2-7b")

_WHISPER = textwrap.dedent("""
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import force_host_platform_device_count
    from repro_torch.models import common, registry
    from torch.distributed.device_mesh import init_device_mesh

    force_host_platform_device_count(16)
    mesh = init_device_mesh("cpu", %(mesh)r, mesh_dim_names=("data", "model"))
    cfg = configs.reduced_config("whisper-base")
    psh = common.param_shardings(registry.param_specs(cfg), mesh)


    def paths(tree, pre=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from paths(tree[k], f"{pre}/{k}" if pre else k)
        elif tree is not None:
            yield pre, tree


    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, _ = dryrun.cell_step(
            cfg, ShapeCell("decode", 32, %(B)d, "decode"), mesh, psh)
        counter, out, _ = dryrun.trace_step(step, args)
        unread = sorted(p for p, t in paths(args[0])
                        if t.to_local().untyped_storage()
                        in counter._unread)
    print(json.dumps(dict(unread=unread,
                          params=[p for p, _ in paths(args[0])])))
    """) % dict(mesh=(4, 4), B=16)


def _spawn(jobs) -> dict:
    """Each ``(key, script, argv)`` in a subprocess of its own, side by
    side: its last stdout line as JSON, by key."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [(key, subprocess.Popen(
        [sys.executable, "-c", script, *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env))
        for key, script, argv in jobs]
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


@pytest.fixture(scope="module")
def steps():
    return _spawn([((arch, kind), _STEP, (arch, kind, str(b), str(s)))
                   for (arch, kind), (b, s) in STEPS.items()])


@pytest.fixture(scope="module")
def decodes():
    return _spawn([(arch, _DECODE, (arch,)) for arch in RECURRENT]
                  + [("whisper-base", _WHISPER, ())])


@pytest.mark.parametrize("arch,kind", list(STEPS), ids=STEP_IDS)
def test_temp_bytes_agree_with_mem_tracker_on_a_mesh(steps, arch, kind):
    rec = steps[arch, kind]
    assert rec["live"] == 0             # each made storage freed
    assert rec["arguments"] > 0 and rec["independent"] > 0
    assert abs(rec["temp"] - rec["independent"]) \
        <= TOLERANCE * rec["independent"], rec


@pytest.mark.parametrize("arch,kind", list(STEPS), ids=STEP_IDS)
def test_no_local_op_makes_a_meta_tensor(steps, arch, kind):
    assert steps[arch, kind]["meta_ops"] == []


@pytest.mark.parametrize("arch", RECURRENT)
def test_no_rank_gathers_a_recurrent_state_whole(decodes, arch):
    now, earlier = decodes[arch]["now"]["writes"], \
        decodes[arch]["earlier"]["writes"]
    assert now and len(now) == len(earlier)
    assert any(w["shard"] < w["whole"] for w in now)   # sharded caches
    assert all(w["made"] < w["whole"] for w in now
               if w["shard"] < w["whole"]), now
    assert any(w["made"] == w["whole"] > w["shard"] for w in earlier), \
        earlier


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_counts_against_the_earlier_write(decodes, arch):
    now, earlier = decodes[arch]["now"], decodes[arch]["earlier"]
    assert now["flops"] == earlier["flops"]
    assert now["temp"] <= earlier["temp"]
    whole = sum(w["nbytes"] for w in earlier["writes"]
                if w["made"] == w["whole"] > w["shard"])
    assert now["gathered"] <= earlier["gathered"] - whole, (now, earlier)


def test_whisper_decode_reads_only_the_weights_it_uses(decodes):
    got = decodes["whisper-base"]
    unused = {p for p in got["params"] if p.startswith("enc_")} | {
        "dec_layers/cross_attn/wk", "dec_layers/cross_attn/wv"}
    assert "dec_layers/cross_attn/wq" in got["params"]
    assert set(got["unread"]) == unused
