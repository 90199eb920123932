"""The LM models on DTensor parameters: four gloo ranks on a (2, 2)
('data', 'model') ``DeviceMesh``, against the unsharded port run and the
JAX package, on the CPU.

Six families at ``reduced_config`` in float32 (qwen2-0.5b and
olmoe-1b-7b here; deepseek-v3-671b, zamba2-7b, and xlstm-125m with
whisper-base in ``tests/test_torch_lm_sharded_{mla,recurrent,encdec}.py``,
which reuse this file's spawn and checks), one set of weights
each, drawn by the JAX package (``init_params(PRNGKey(0))``) and carried
into the port.  Every rank places them by the reference's rules
(``models.common.shard_params``), shards the batch over 'data'
(``shard_batch``) and the decode cache by the dry-run's
``cache_shardings``, then runs a prefill, 4 decode steps and one
``loss_fn`` with its gradients (``launch.train.value_and_grad``) on
DTensors, counting DTensor's collectives (``CommDebugMode``).  Spawned as
4 processes in the ``tests/test_torch_shard_ranks.py`` pattern
(``launch.mesh.init_ranks`` over a ``FileStore``), under a 120 s limit.

Checked: every rank holds the same full values; the sharded run equals
the unsharded port run within float32 rtol 1e-5 (atol 1e-6 for the
near-zero elements), on the same MoE expert choices: a top-k whose
choice differs between the runs must be a near tie (the k-th and
(k+1)-th values within 1e-4), and then the unsharded run replays the
sharded run's choices (6 of reduced olmoe-1b-7b's 56 top-k calls flip
here, each a near tie); the unsharded forward (prefill logits, loss) equals
the JAX package's at ``tests/test_torch_lm*``'s tolerances (rtol = atol =
1e-4 for logits, rtol 1e-5 for the loss; their decode and gradients
against JAX are those files' tests); each family's collectives > 0.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro_torch import configs, convert
from repro_torch.launch import train
from repro_torch.models import common, moe, registry

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 120
# qwen2-0.5b and olmoe-1b-7b here; the others in
# tests/test_torch_lm_sharded_{mla,recurrent,encdec}.py (one spawn per
# file, each within a worker's minute).
ARCHS = ("qwen2-0.5b", "olmoe-1b-7b", "qwen2-0.5b-3h")
B, S, DECODE, CACHE = 8, 8, 4, 16
# A reduced config the 2-way model axis does not divide the heads of (3
# q heads, 1 kv head, each projection's shard ending mid-head, as
# qwen2-0.5b's 14:2 on a 16-way axis): attention over (batch, head)
# pairs (``models.common._pair_shard``).
# xlstm-125m-1h: one mLSTM / sLSTM head, whole on both 'model' ranks, so
# the mLSTM's recurrence splits by pairs.
VARIANTS = {"qwen2-0.5b-3h": ("qwen2-0.5b", dict(num_heads=3, num_kv_heads=1,
                                                  head_dim=16)),
            "xlstm-125m-1h": ("xlstm-125m", dict(num_heads=1))}


def reduced(arch, pkg):
    """``pkg``'s (the port's or the JAX package's ``configs``) reduced
    config of ``arch`` or of a variant's base arch with its overrides."""
    base, over = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(pkg.reduced_config(base), **over)

_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import torch
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import configs
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.models import (common, encdec, hybrid, moe, registry,
                                    ssm, transformer, xlstm)

    routing = []            # each top-k's indices, in call order
    ffn_inputs = []         # the FFN's, experts' or mixer's input placements

    def placed(fn, i):
        def run(*a, **k):
            if common.is_dtensor(a[i]):
                ffn_inputs.append(tuple(repr(p) for p in a[i].placements))
            return fn(*a, **k)
        return run
    for mod in (transformer, hybrid, encdec, moe):
        mod.swiglu = placed(mod.swiglu, 0)
    moe.moe_forward = placed(moe.moe_forward, 1)
    ssm.ssd_forward = placed(ssm.ssd_forward, 1)
    xlstm.mlstm_forward = placed(xlstm.mlstm_forward, 1)
    xlstm.slstm_forward = placed(xlstm.slstm_forward, 1)
    _top_k = moe.top_k

    def recorded(x, k):
        vals, idx = _top_k(x, k)
        routing.append(idx.detach().clone())
        return vals, idx
    moe.top_k = recorded
    rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    init_ranks(rank, world, store)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch in sys.argv[5].split(","):
        base, over = {VARIANTS}.get(arch, (arch, {}))
        cfg = dataclasses.replace(configs.reduced_config(base), **over,
                                  dtype=torch.float32)
        got = torch.load(f"{tmp}/{arch}.pt")
        specs = registry.param_specs(cfg)
        params = common.shard_params(got["params"], specs, mesh)
        batch = {k: common.shard_batch(v, mesh)
                 for k, v in got["batch"].items()}
        routing.clear()
        ffn_inputs.clear()
        comm = CommDebugMode()
        with comm:
            logits = registry.prefill(params, cfg, batch).full_tensor()
            cache = registry.init_cache(cfg, {B}, {CACHE}, "cpu")
            plc = dryrun.cache_shardings(cache, cfg, {B}, mesh, {CACHE})
            cache = _place(cache, plc, mesh)
            steps = []
            for pos in range({DECODE}):
                tok = common.shard_batch(
                    got["batch"]["tokens"][:, pos:pos + 1], mesh)
                lg, cache = registry.decode_step(params, cfg, cache, tok, pos)
                steps.append(lg.full_tensor())
            loss, grads = train.value_and_grad(params, cfg, batch)
            loss = loss.full_tensor()
            grads = common.tree_map(lambda g: g.full_tensor(), grads)
        out[arch] = dict(logits=logits, decode=torch.stack(steps), loss=loss,
                         grads=grads, comms=comm.get_total_counts(),
                         routing=list(routing), ffn_inputs=list(ffn_inputs))
    # B5's wrapper on CPU DTensors: its plain version on each rank's
    # batch shard (heads gathered), against the plain version on the whole.
    from torch.distributed.tensor import Shard
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn(8, 12, 4, 16, generator=gen) for _ in range(3)]
    dq, dk, dv = (distribute_tensor(t, mesh, [Shard(0), Shard(2)])
                  for t in qkv)
    out["flash_dtensor"] = dict(
        got=ops.flash_attention(dq, dk, dv, window=3,
                                score_dtype="bf16").full_tensor(),
        want=ref.flash_attention_ref(*qkv, window=3, score_dtype="bf16"))
    # The pair split on its own: 6 sequences over 'data' (3 per rank) of
    # 3 heads, 9 pairs per rank over the 2-way 'model' axis in chunks of
    # 5 and 4: the output and the gradients of q, k, v against the plain
    # attention on the whole.
    from torch.distributed.tensor import Replicate
    from repro_torch.models import attention
    qkv = [torch.randn(6, 6, 3, 8, generator=gen) for _ in range(3)]
    wt = torch.randn(6, 6, 3, 8, generator=gen)
    plain = [t.clone().requires_grad_() for t in qkv]
    want = attention.chunked_causal_attention(*plain, 4)
    (want * wt).sum().backward()
    dist = [distribute_tensor(t, mesh, [Shard(0), Replicate()])
            .requires_grad_() for t in qkv]
    got = attention.chunked_causal_attention(*dist, 4)
    placements = [repr(p) for p in got.placements]
    got = got.full_tensor()
    (got * wt).sum().backward()
    out["pairs"] = dict(got=got, want=want.detach(), placements=placements,
                        grads=[t.grad.full_tensor() for t in dist],
                        want_grads=[t.grad for t in plain])
    torch.save(out, f"{tmp}/rank{rank}.pt")
    """)

_PLACE = textwrap.dedent("""
    def _place(tree, plc, mesh):
        if isinstance(tree, dict):
            return {k: _place(tree[k], plc[k], mesh) for k in tree}
        if isinstance(tree, (tuple, list)):
            return type(tree)(_place(t, p, mesh) for t, p in zip(tree, plc))
        if tree is None:
            return None
        return distribute_tensor(tree, mesh, plc)
    """)


def _models(arch):
    jcfg = dataclasses.replace(reduced(arch, jconfigs), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduced(arch, configs), dtype=torch.float32)
    jp = jcommon.init_params(jregistry.param_specs(jcfg),
                             jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _plain(tcfg, tp, batch, replay=None):
    """The unsharded port run: prefill, 4 decode steps, loss and grads;
    each MoE top-k's input and indices recorded (``routing``), or with
    ``replay``, each top-k taking the given indices in turn (the values
    gathered from its own input, so gradients flow as before)."""
    seen = []
    orig = moe.top_k
    it = iter(replay or ())

    def top_k(x, k):
        if replay is not None:
            idx = next(it)
            return x.gather(-1, idx), idx
        vals, idx = orig(x, k)
        seen.append((x.detach().clone(), idx))
        return vals, idx
    moe.top_k = top_k
    try:
        out = _plain_run(tcfg, tp, batch)
    finally:
        moe.top_k = orig
    out["routing"] = seen
    return out


def _plain_run(tcfg, tp, batch):
    logits = registry.prefill(tp, tcfg, batch)
    cache = registry.init_cache(tcfg, B, CACHE, "cpu")
    steps = []
    for pos in range(DECODE):
        lg, cache = registry.decode_step(
            tp, tcfg, cache, batch["tokens"][:, pos:pos + 1], pos)
        steps.append(lg)
    loss, grads = train.value_and_grad(tp, tcfg, batch)
    return dict(logits=logits, decode=torch.stack(steps), loss=loss,
                grads=grads)


def spawn(archs):
    """The 4 ranks' results for ``archs`` (one spawn) beside each arch's
    (JAX cfg, JAX params, port cfg, port params, batch)."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="lm_sharded_"))
    models = {}
    for arch in archs:
        jcfg, jp, tcfg, tp = _models(arch)
        batch = registry.make_train_batch(tcfg, B, S, 1)
        torch.save({"params": tp, "batch": batch}, tmp / f"{arch}.pt")
        models[arch] = (jcfg, jp, tcfg, tp, batch)
    script = _RANK_SCRIPT.replace("{B}", str(B)).replace(
        "{CACHE}", str(CACHE)).replace("{DECODE}", str(DECODE)).replace(
        "{VARIANTS}", repr(VARIANTS))
    script = script.replace("out = {}\n", _PLACE + "out = {}\n", 1)
    (tmp / "rank.py").write_text(script)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = tmp / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "rank.py"), str(r), "4", str(store),
         str(tmp), ",".join(archs)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        for p in procs:
            p.wait(timeout=LIMIT)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the 4 ranks ran past {LIMIT} s")
    for p in procs:
        _, err = p.communicate()
        assert p.returncode == 0, err[-4000:]
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(4)]
    return models, ranks


def _assert_tree_close(got, want, **tol):
    got_l, want_l = common.leaves(got), common.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **tol)


def check_ranks_agree(runs, arch):
    _, ranks = runs
    for r in ranks[1:]:
        for key in ("logits", "decode", "loss"):
            assert torch.equal(r[arch][key], ranks[0][arch][key]), key
        _assert_tree_close(r[arch]["grads"], ranks[0][arch]["grads"],
                           rtol=0, atol=0)


def _near_ties(plain_routing, sharded_routing):
    """Every top-k whose indices differ between the two runs differs only
    where the plain run's k-th and (k+1)-th values lie within 1e-4 of
    each other (relative): an expert choice that float32 sums taken in
    another order can flip.  Returns the number of such calls."""
    assert len(plain_routing) == len(sharded_routing)
    flips = 0
    for (x, idx), got in zip(plain_routing, sharded_routing):
        if torch.equal(idx, got):
            continue
        flips += 1
        k = idx.shape[-1]
        vals = torch.sort(x, dim=-1, descending=True, stable=True)[0]
        rows = (torch.sort(idx, -1)[0] != torch.sort(got, -1)[0]).any(-1)
        gap = (vals[..., k - 1] - vals[..., k])[rows]
        scale = vals[..., k - 1].abs()[rows].clamp_min(1e-30)
        assert bool((gap <= 1e-4 * scale).all()), (gap, scale)
    return flips


def check_equals_unsharded(runs, arch):
    """On the same expert choices: where a near tie flipped one (see
    ``_near_ties``), the unsharded run is held replaying the sharded
    run's choices."""
    models, ranks = runs
    _, _, tcfg, tp, batch = models[arch]
    got = ranks[0][arch]
    want = _plain(tcfg, tp, batch)
    if _near_ties(want["routing"], got["routing"]):
        want = _plain(tcfg, tp, batch, replay=got["routing"])
    for key in ("logits", "decode", "loss"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5,
                                   atol=1e-6)
    _assert_tree_close(got["grads"], want["grads"], rtol=1e-5, atol=1e-6)
    assert got["comms"] > 0


def check_ffn_inputs_reduced(runs, arch):
    """Every half's output joined the residual stream reduced: the FFN's
    (swiglu's), the experts' and the Mamba2 / xLSTM mixers' inputs
    arrive with no ``Partial`` placement, on every rank, in the prefill,
    the decode steps and the training step."""
    _, ranks = runs
    for r in ranks:
        seen = r[arch]["ffn_inputs"]
        assert seen, arch
        assert not [p for p in seen if any("Partial" in q for q in p)], seen


def check_unsharded_forward_equals_jax(runs, arch):
    models, _ = runs
    jcfg, jp, tcfg, tp, batch = models[arch]
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    assert_allclose(registry.prefill(tp, tcfg, batch).numpy(),
                    np.asarray(jregistry.prefill(jp, jcfg, jb)),
                    rtol=1e-4, atol=1e-4)
    assert_allclose(float(registry.loss_fn(tp, tcfg, batch)),
                    float(jregistry.loss_fn(jp, jcfg, jb)), rtol=1e-5)


@pytest.fixture(scope="module")
def runs():
    return spawn(ARCHS)


def test_flash_attention_wrapper_on_dtensors_runs_per_shard(runs):
    """On CPU DTensors the kernel's wrapper runs its plain version on each
    rank's batch shard through ``local_map``: equal to the plain version
    on the whole batch."""
    got = runs[1][0]["flash_dtensor"]
    torch.testing.assert_close(got["got"], got["want"], rtol=0, atol=0)


def test_heads_the_model_axis_does_not_divide_split_by_pairs(runs):
    """The (batch, head) pair split over the model axis, on uneven
    chunks: its output a partial sum over 'model' that sums to the plain
    attention, and the gradients of q, k, v equal the plain ones."""
    for r in runs[1]:
        got = r["pairs"]
        assert got["placements"] == ["Shard(dim=0)", "Partial(sum)"]
        torch.testing.assert_close(got["got"], got["want"], rtol=1e-6,
                                   atol=1e-6)
        for g, w in zip(got["grads"], got["want_grads"]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_ffn_input_holds_no_partial_sum(runs, arch):
    check_ffn_inputs_reduced(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_hold_the_same_values(runs, arch):
    check_ranks_agree(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_run_equals_the_unsharded_port_run(runs, arch):
    check_equals_unsharded(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_forward_equals_jax(runs, arch):
    check_unsharded_forward_equals_jax(runs, arch)
