"""The LM substrate's launch layer in repro_torch against the JAX package:
the sharding rules, the pod meshes, the dry-run's shardings and
accounting, the roofline's probe schedule and terms, on the CPU.

The reference's rules run on a ``jax.sharding.AbstractMesh`` (no devices
needed); the port's on a ``{axis: size}`` mapping and, for DTensor
placements, on the production ``DeviceMesh`` of a fake process group of
256 or 512 ranks, which is process-global: every test that makes one runs
in a subprocess, as ``tests/test_launch.py`` does.  The reference's
``launch/dryrun.py`` and ``launch/roofline.py`` force 512 host devices
when imported, so their functions run in one JAX subprocess too (the
``ref`` fixture), whose results the tests compare.  Equalities are exact
(specs, counts, schedules); ``solve_linear`` to rtol 1e-12.  The dry-run
itself: ``tests/test_torch_dryrun.py`` (the reference's two full cells)
and ``tests/test_torch_dryrun_reduced.py``; the roofline's probes:
``tests/test_torch_roofline.py``.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.launch import dryrun, roofline
from repro_torch.models import common, registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(name):
    return AbstractMesh(*MESHES[name])


def _tmesh(name):
    return dict(zip(MESHES[name][1], MESHES[name][0]))


def _jspec(ps):
    """A reference PartitionSpec as the port's plain tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in ps)


def _run(script: str, timeout: int = 120) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _spec_leaves(cfg_t, cfg_j, mesh):
    """(port spec, reference spec) per parameter leaf, reference order."""
    tl = common.leaves(registry.param_specs(cfg_t))
    jl = jax.tree_util.tree_leaves(
        jregistry.param_specs(cfg_j),
        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))
    assert len(tl) == len(jl)
    return [(common.logical_to_spec(t.axes, t.shape, _tmesh(mesh)),
             _jspec(jcommon.logical_to_spec(j.axes, j.shape, _jmesh(mesh))))
            for t, j in zip(tl, jl)]


# -- the rules ----------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_logical_to_spec_matches_the_reference_on_every_leaf(arch, mesh):
    assert common.DEFAULT_RULES == jcommon.DEFAULT_RULES
    pairs = _spec_leaves(configs.get_config(arch),
                         jconfigs.get_config(arch), mesh)
    for got, want in pairs:
        assert got == want
    sharded = sum(any(e is not None for e in g) for g, _ in pairs)
    assert sharded > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_shardings_place_every_leaf_as_the_reference(mesh):
    """DTensor placements on the production DeviceMesh of a fake group,
    read back as specs, for every leaf of the ten configs."""
    got = _run(f"""
        import json
        from repro_torch import configs
        from repro_torch.launch.mesh import (force_host_platform_device_count,
                                             make_production_mesh)
        from repro_torch.models import common, registry
        multi = {mesh == "multi"}
        force_host_platform_device_count(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi)
        out = {{}}
        for arch in sorted(configs.ARCHS):
            specs = registry.param_specs(configs.get_config(arch))
            plc = common.param_shardings(specs, mesh)
            out[arch] = [list(common.placements_to_spec(p, len(s.shape),
                                                        mesh))
                         for s, p in zip(common.leaves(specs),
                                         common.leaves(plc))]
        print(json.dumps(out))
        """)
    for arch in sorted(configs.ARCHS):
        want = [w for _, w in _spec_leaves(configs.get_config(arch),
                                           jconfigs.get_config(arch), mesh)]
        assert [_jspec(g) for g in got[arch]] == want, arch


def test_activation_sharding_and_shard_batch_without_a_mesh():
    from torch.distributed.tensor import Replicate, Shard
    assert common.activation_sharding(_tmesh("multi"), "batch", None,
                                      "model") == (Shard(0), Shard(0),
                                                   Shard(2))
    assert common.activation_sharding(_tmesh("single"), None, "batch") == (
        Shard(1), Replicate())
    import torch
    x = torch.ones(2, 3)
    assert common.shard_batch(x, None) is x


# -- the dry-run's input shardings, accounting and probe schedule -----------

_REF_SCRIPT = """
import json
import numpy as np
from jax.sharding import AbstractMesh
from repro import configs
from repro.launch import dryrun, roofline
from repro.models import registry

MESHES = {meshes}
out = {{}}
for arch in sorted(configs.ARCHS):
    cfg0 = configs.get_config(arch)
    counts = dryrun.count_params(registry.param_specs(cfg0))
    points, full = roofline.probe_schedule(cfg0)
    rng = np.random.RandomState(len(arch))
    metrics = [{{"flops": float(rng.rand() * 1e12),
                 "bytes": float(rng.rand() * 1e9)}} for _ in points]
    rec = dict(counts=counts,
               flops={{k: dryrun.model_flops(cfg0, counts, 4096, k)
                      for k in ("train", "prefill", "decode")}},
               schedule=[points, full], metrics=metrics,
               solved=roofline.solve_linear(points, metrics, full),
               cells={{}})
    for shape in configs.supported_shapes(cfg0):
        cell = configs.SHAPES[shape]
        cfg = dryrun.build_config(arch, shape, {{}})
        for mname, (sizes, names) in MESHES.items():
            mesh = AbstractMesh(tuple(sizes), tuple(names))
            if cell.kind == "decode":
                tok, pos, cache = registry.decode_input_specs(
                    cfg, cell.global_batch, cell.seq_len)
                tree = {{"tokens": tok}}
                import jax
                csh = dryrun.cache_shardings(cache, cfg, cell.global_batch,
                                             mesh, seq_len=cell.seq_len)
                leaves = jax.tree_util.tree_leaves
                c = dict(cache=[[list(l.shape),
                                 [list(e) if isinstance(e, tuple) else e
                                  for e in s.spec]]
                                for l, s in zip(leaves(cache), leaves(csh))])
            else:
                tree = registry.train_input_specs(cfg, cell.global_batch,
                                                  cell.seq_len)
                c = {{}}
            bsh = dryrun.batch_shardings(tree, mesh)
            c["batch"] = {{k: [list(tree[k].shape), str(tree[k].dtype),
                              [list(e) if isinstance(e, tuple) else e
                               for e in bsh[k].spec]] for k in tree}}
            rec["cells"][shape + "/" + mname] = c
    out[arch] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's shardings, counts and schedules, from one JAX
    subprocess (its dry-run module forces 512 host devices on import)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    meshes = {k: [list(v[0]), list(v[1])] for k, v in MESHES.items()}
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT.format(
        meshes=repr(meshes))], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _placement_leaves(tree):
    """The placement tuples of a shardings tree, in leaf order."""
    from torch.distributed.tensor.placement_types import Placement
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _placement_leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not all(
            isinstance(p, Placement) for p in tree):
        return [x for v in tree for x in _placement_leaves(v)]
    return [] if tree is None else [tree]


def _spec_json(spec):
    """A spec as JSON, a one-axis tuple as its axis (as PartitionSpec
    normalizes it)."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, (tuple, list))
            else e for e in spec]


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_batch_and_cache_shardings_match_the_reference(ref, arch):
    for shape in configs.supported_shapes(configs.get_config(arch)):
        cell = configs.SHAPES[shape]
        tcfg = dryrun.build_config(arch, shape, {})
        for mname in MESHES:
            tm = _tmesh(mname)
            want = ref[arch]["cells"][f"{shape}/{mname}"]
            if cell.kind == "decode":
                tt, tpos, tc = registry.decode_input_specs(
                    tcfg, cell.global_batch, cell.seq_len)
                assert tuple(tpos.shape) == () and tt.device.type == "meta"
                tree = {"tokens": tt}
                shapes = [tuple(t.shape) for t in dryrun.tree_leaves(tc)]
                assert [list(s) for s in shapes] == [
                    c[0] for c in want["cache"]]
                got = [dryrun.cache_spec(s, tcfg, cell.global_batch, tm,
                                         cell.seq_len) for s in shapes]
                assert [_spec_json(g) for g in got] == [
                    _spec_json(c[1]) for c in want["cache"]]
                # The port keeps the layer axes before the batch's whole
                # (its decode writes each layer's entry in place).
                plc = _placement_leaves(dryrun.cache_shardings(
                    tc, tcfg, cell.global_batch, tm, cell.seq_len))
                for spec, p in zip(got, plc):
                    b = next((i for i, e in enumerate(spec)
                              if isinstance(e, tuple)), 0)
                    assert _spec_json(common.placements_to_spec(
                        p, len(spec), tm)) == _spec_json(
                            [None if i < b else e
                             for i, e in enumerate(spec)])
            else:
                tree = registry.train_input_specs(tcfg, cell.global_batch,
                                                  cell.seq_len)
            assert sorted(tree) == sorted(want["batch"])
            plc = dryrun.batch_shardings(tree, tm)
            for k, t in tree.items():
                shape_w, dtype_w, spec_w = want["batch"][k]
                assert list(t.shape) == shape_w
                assert str(t.dtype)[6:] == dtype_w
                spec = dryrun.batch_spec(tuple(t.shape), tm)
                assert _spec_json(spec) == _spec_json(spec_w)
                assert _spec_json(common.placements_to_spec(
                    plc[k], t.ndim, tm)) == spec_w


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_count_params_model_flops_and_probe_schedule_match(ref, arch):
    want = ref[arch]
    tcfg = configs.get_config(arch)
    tc = dryrun.count_params(registry.param_specs(tcfg))
    assert tc == want["counts"] and tc["total"] == tcfg.param_count()
    for kind in ("train", "prefill", "decode"):
        assert dryrun.model_flops(tcfg, tc, 4096, kind) == \
            want["flops"][kind]
    points, full = roofline.probe_schedule(tcfg)
    assert json.loads(json.dumps([points, full])) == want["schedule"]
    got = roofline.solve_linear(points, want["metrics"], full)
    assert set(got) == set(want["solved"])
    for k in ("flops", "bytes"):
        np.testing.assert_allclose(got[k], want["solved"][k], rtol=1e-12)
    assert roofline.analytic_corrections(tcfg, configs.SHAPES["train_4k"],
                                         256) == {"flops_correction": 0.0}


def test_roofline_terms_use_the_h100_datasheet():
    assert roofline.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    t = roofline.roofline_terms(989e12, 3.35e12, 450e9, 256)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}


# -- the meshes ---------------------------------------------------------------

def test_force_host_platform_device_count_three_outcomes():
    got = _run("""
        import json
        import torch.distributed as dist
        from repro_torch.launch.mesh import (force_host_platform_device_count,
                                             make_production_mesh)
        made = force_host_platform_device_count(256)
        again = force_host_platform_device_count(256)
        try:
            force_host_platform_device_count(512)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        m = make_production_mesh()
        print(json.dumps(dict(made=made, again=again, raised=raised,
                              world=dist.get_world_size(),
                              names=list(m.mesh_dim_names),
                              shape=list(m.shape))))
        """)
    assert got["made"] is True and got["again"] is False
    assert "256" in got["raised"] and "fresh process" in got["raised"]
    assert got["world"] == 256
    assert (got["names"], got["shape"]) == (["data", "model"], [16, 16])
    with pytest.raises(ValueError, match=">= 1"):
        from repro_torch.launch.mesh import force_host_platform_device_count
        force_host_platform_device_count(0)


def test_host_mesh_and_validate_mesh():
    got = _run("""
        import json
        from repro_torch.launch.mesh import make_host_mesh, validate_mesh
        m = make_host_mesh(device="cpu")
        validate_mesh(m, ("data", "model"))
        try:
            validate_mesh(m, ("pod",))
            bad = None
        except ValueError as e:
            bad = str(e)
        print(json.dumps(dict(names=list(m.mesh_dim_names),
                              shape=list(m.shape), type=m.device_type,
                              bad=bad)))
        """)
    assert got == {"names": ["data", "model"], "shape": [1, 1],
                   "type": "cpu", "bad": got["bad"]}
    assert "missing required ['pod']" in got["bad"]
