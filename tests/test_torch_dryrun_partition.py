"""The partition of the port's sharded LM programs: each rank does no more
work than the reference's compiled program does per device, on the CPU.

One train step of each family's ``reduced_config`` (qwen2-0.5b with 6 q
heads and 2 kv heads of 16, so that the 4-way model axis divides neither
and each projection's shard ends mid-head, as qwen2-0.5b's 14:2 on a
16-way axis; zamba2-7b's and xlstm-125m's 2 heads do not divide it
either) on a (4, 4) ('data', 'model') mesh of a fake 16-rank group,
16 sequences of 20 tokens: the port's ``dryrun.run_cell`` with every
``mm``/``bmm`` recorded by its operand shapes, beside the reference's
compiled step for the same config and mesh (``jax.jit(dryrun
.make_train_step)`` lowered and compiled over 16 forced host devices,
the layers unrolled and ``attn_chunk = S``, as the reference's roofline
probes do), two subprocesses a side, all four side by side, each under
a 300 s limit (~40 s in all).

Per-device FLOPs (an 8-core CPU host, torch 2.13, jax 0.9.0; counts,
not device metrics): the port before its partition repair (the residual
stream carried partial sums, and the heads and the experts' tokens were
gathered) and after it, the reference's compiled count, and the
model's 6 N D / 16:

    arch                before     after      reference  model
    qwen2-0.5b (6:2)    4.686e7    2.474e7    4.713e7    1.784e7
    mistral-nemo-12b    3.604e7    2.130e7    4.058e7    1.678e7
    olmoe-1b-7b         6.160e7    2.425e7    4.248e7    1.604e7
    deepseek-v3-671b    6.973e7    4.073e7    6.608e7    2.199e7
    zamba2-7b           1.027e8    9.631e7    1.214e8    2.282e7
    whisper-base        6.477e7    3.853e7    6.968e7    3.504e7
    xlstm-125m          8.462e7    5.882e7    6.519e7    3.568e7

Checked per family: the port's FLOPs are at most the reference's and at
least the model's; every FFN gate/up product on the local tokens is
``d_ff / 4`` wide; the experts' batched products hold ``E / 4`` experts
and ``C / 4`` capacity rows; the score products hold a 4th of the local
(batch, head) pairs; no product's operand holds the local tokens
at the full width of a parameter dim the rules shard over 'model' (an
activation gathered whole over the axis).
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch import configs
from repro_torch.models import common, moe, registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 300
B, S, MESH = 16, 20, (4, 4)
CASES = {
    "qwen2-0.5b": dict(num_heads=6, num_kv_heads=2, head_dim=16),
    "mistral-nemo-12b": {},
    "olmoe-1b-7b": {},
    "deepseek-v3-671b": {},
    "zamba2-7b": {},
    "whisper-base": {},
    "xlstm-125m": {},
}

_PORT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.utils.flop_counter import flop_registry
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun

    ops = []
    for name in ("mm", "bmm", "addmm", "baddbmm"):
        packet = getattr(torch.ops.aten, name)
        count = flop_registry[packet]

        def recorded(*a, count=count, name=name, out_val=None, **k):
            n = count(*a, out_val=out_val, **k)
            ops.append([name, [list(t.shape) for t in a
                               if isinstance(t, torch.Tensor)], n])
            return n
        flop_registry[packet] = recorded
    out = {}
    for arch, over in json.loads(sys.argv[1]).items():
        cfg = dataclasses.replace(configs.reduced_config(arch), **over)
        ops.clear()
        rec = dryrun.run_cell(arch, "train", False, mesh_shape=%(mesh)r,
                              cfg=cfg, cell=ShapeCell("train", %(S)d,
                                                      %(B)d, "train"))
        out[arch] = dict(flops=rec["flops"], model=rec["model_flops"],
                         chips=rec["chips"], ops=list(ops))
    print(json.dumps(out))
    """) % dict(mesh=MESH, S=S, B=B)

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import dataclasses, json, sys
    import jax, jax.numpy as jnp
    jax.devices()       # 16 devices, before the dry-run module's 512
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import dryrun
    from repro.models import common, registry
    from repro.optim import AdamWConfig, adamw_init

    mesh = jax.make_mesh(%(mesh)r, ("data", "model"))
    common.set_probe_unroll(True)
    out = {}
    for arch, over in json.loads(sys.argv[1]).items():
        cfg = dataclasses.replace(configs.reduced_config(arch),
                                  attn_chunk=%(S)d, **over)
        specs = registry.param_specs(cfg)
        params = common.abstract_params(specs)
        psh = common.param_shardings(specs, mesh)
        ocfg = AdamWConfig(state_dtype=jnp.float32)
        opt = jax.eval_shape(lambda p: adamw_init(p, ocfg), params)
        osh = type(opt)(step=NamedSharding(mesh, P()), m=psh, v=psh)
        batch = registry.train_input_specs(cfg, %(B)d, %(S)d)
        bsh = dryrun.batch_shardings(batch, mesh)
        fn = jax.jit(dryrun.make_train_step(cfg, ocfg),
                     in_shardings=(psh, osh, bsh),
                     out_shardings=(psh, osh, NamedSharding(mesh, P()),
                                    NamedSharding(mesh, P())))
        cost = fn.lower(params, opt, batch).compile().cost_analysis()
        out[arch] = float(cost["flops"])
    print(json.dumps(out))
    """) % dict(mesh=MESH, S=S, B=B)


def _split(n):
    archs = list(CASES)
    return [json.dumps({a: CASES[a] for a in archs[i::n]}) for i in range(n)]


@pytest.fixture(scope="module")
def counts():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [("port", subprocess.Popen(
        [sys.executable, "-c", _PORT, part], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)) for part in _split(2)]
    procs += [("reference", subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, part], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)) for part in _split(2)]
    got = {"port": {}, "reference": {}}
    try:
        for side, p in procs:
            out, err = p.communicate(timeout=LIMIT)
            assert p.returncode == 0, err[-3000:]
            got[side].update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for _, p in procs:
            p.kill()
    return got


def _cfg(arch):
    return dataclasses.replace(configs.reduced_config(arch), **CASES[arch])


def _products(rec):
    return [(name, [tuple(s) for s in shapes]) for name, shapes, _ in
            rec["ops"]]


@pytest.mark.parametrize("arch", list(CASES))
def test_port_does_no_more_work_per_device_than_the_reference(counts, arch):
    assert counts["port"][arch]["flops"] <= counts["reference"][arch]


@pytest.mark.parametrize("arch", list(CASES))
def test_port_does_at_least_the_model_flops_per_device(counts, arch):
    rec = counts["port"][arch]
    assert rec["chips"] == math.prod(MESH)
    assert rec["flops"] >= rec["model"] / rec["chips"]


@pytest.mark.parametrize("arch", [a for a in CASES if _cfg(a).d_ff and not (
    _cfg(a).moe and not _cfg(a).first_dense_layers)])
def test_ffn_gate_and_up_run_on_their_local_columns(counts, arch):
    """Every product of the local tokens (B S / 4 rows) with d_model
    inputs into ``d_ff`` or ``d_ff / 4`` columns is ``d_ff / 4`` wide,
    and there are such products (gate and up)."""
    cfg = _cfg(arch)
    rows, model = B * S // MESH[0], MESH[1]
    widths = [b[1] for name, (a, b) in _products(counts["port"][arch])
              if name == "mm" and a == (rows, cfg.d_model)
              and b[0] == cfg.d_model and b[1] in (cfg.d_ff,
                                                   cfg.d_ff // model)]
    assert widths and set(widths) == {cfg.d_ff // model}, widths


@pytest.mark.parametrize("arch", [a for a in CASES if _cfg(a).moe])
def test_experts_run_on_their_experts_and_capacity_rows(counts, arch):
    """The expert FFN's batched products hold ``E / 4`` experts (the
    model axis) and ``C / 4`` capacity rows (the data axis), never all
    experts or all of the global capacity."""
    cfg = _cfg(arch)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    C = moe.capacity(cfg, B * S)
    e, c = E // MESH[1], -(-C // MESH[0])
    expert = [shapes for name, shapes in _products(counts["port"][arch])
              if name == "bmm" and shapes[0][0] in (E, e)
              and {D, F} <= {d for s in shapes for d in s[1:]}]
    assert expert
    for shapes in expert:
        assert all(s[0] == e for s in shapes), shapes
        assert C in (D, F) or C not in {d for s in shapes
                                         for d in s[1:]}, shapes
    assert [(e, c, D), (e, D, F)] in expert


@pytest.mark.parametrize("arch", [a for a in CASES if a != "zamba2-7b"])
def test_attention_runs_its_share_of_the_batch_head_pairs(counts, arch):
    """Every product over a score slab (an operand whose last two dims
    are sequence lengths: attention's, and the mLSTM's chunk) holds at
    most ``ceil(B_local H / 4)`` (batch, head) pairs: heads the model
    axis does not divide are split by pairs, not run whole on every
    rank.  (zamba2-7b's SSD runs its (batch, chunk, head) products on
    every model rank, as the reference's program does; its shared
    attention is in the FLOPs bound.)"""
    cfg = _cfg(arch)
    seqs = {S, cfg.encoder_seq} - {0}
    share = -(-(B // MESH[0]) * cfg.num_heads // MESH[1])
    slabs = [s[0] for _, shapes in _products(counts["port"][arch])
             for s in shapes if len(s) == 3 and set(s[1:]) <= seqs]
    assert slabs and max(slabs) <= share, (share, sorted(set(slabs)))


@pytest.mark.parametrize("arch", list(CASES))
def test_no_product_takes_an_activation_gathered_over_the_model_axis(
        counts, arch):
    """No ``mm``/``bmm`` operand holds the local tokens (B S / 4 rows) at
    the full width of a parameter dim the rules shard over 'model' (a
    width that no parameter dim left whole over 'model', and no such
    dim's local shard, also has)."""
    cfg = _cfg(arch)
    sizes = dict(zip(("data", "model"), MESH))
    sharded, whole = set(), set()
    for spec in common.leaves(registry.param_specs(cfg)):
        entries = common.logical_to_spec(spec.axes, spec.shape, sizes)
        for dim, entry in zip(spec.shape, entries):
            (sharded if entry == "model" else whole).add(dim)
    full = sharded - whole - {w // MESH[1] for w in sharded}
    rows = B * S // MESH[0]
    bad = [shapes for _, shapes in _products(counts["port"][arch])
           if any(rows in s and full & set(s) for s in shapes)]
    assert full and not bad, (sorted(full), bad[:5])
