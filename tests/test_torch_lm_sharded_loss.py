"""The token cross entropy and the embedding lookup on DTensors
(``repro_torch.models.layers.cross_entropy`` / ``embed_tokens``): four
gloo ranks on a (2, 2) ('data', 'model') ``DeviceMesh``, against the same
functions on plain tensors, on the CPU.

On DTensor logits the loss runs on each rank's own (batch rows, vocab
columns) block (vocab-parallel cross entropy: a max, a sum of exps and
the gold logit reduced over the vocab's mesh dims), and on a DTensor
table the lookup on each rank's own vocab rows (an all-reduce of the
activations).  Inputs from ``numpy.random.RandomState(0)``, placed by the
reference's rules (``models.common.logical_to_spec``): logits ("batch",
None, "vocab"), the table ("vocab", "embed"), labels, masks and tokens
over the batch.  The cases: labels in every vocab shard; a mask; a vocab
the 2-way model axis does not divide (replicated by the rules: the loss
and the lookup on the local batch rows); the MTP shifts (the logits at
0..S-3 against the labels at 2..S-1); and the loss of reduced qwen2-0.5b
(tied embeddings) and deepseek-v3-671b (MTP: the lookup of the labels
and a second loss) with their gradients.  Each value and gradient
equals the plain run within rtol 1e-5, atol 1e-6; where the vocab is
sharded, the loss and the lookup issue no all-gather and the gradients
keep the inputs' placements (DTensor's collectives counted by
``CommDebugMode``).  The plain loss equals the JAX package's
``repro.models.layers.cross_entropy`` within 1e-5.

Spawned as 4 processes in ``tests/test_torch_lm_sharded.py``'s pattern
(``launch.mesh.init_ranks`` over a ``FileStore``), under a 120 s limit.
"""
import dataclasses
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

from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import common, layers, registry

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 120
TOL = dict(rtol=1e-5, atol=1e-6)
B, S, D = 4, 6, 8
#: name -> (vocab, mask, shift): the logits at 0..S-1-shift against the
#: labels at shift..S-1.
LOSS_CASES = {"sharded": (16, False, 0), "mask": (16, True, 0),
              "undivided": (15, False, 0), "undivided_mask": (15, True, 0),
              "mtp_shift": (16, False, 2), "next_token": (16, True, 1)}
#: name -> (vocab, d_model): the table's embed dim split over 'data' (the
#: rules' FSDP) where it divides.
EMBED_CASES = {"sharded": (16, D), "fsdp_off": (16, 7),
               "undivided": (15, D)}
ARCHS = ("qwen2-0.5b", "deepseek-v3-671b")
MB, MS = 4, 8       # the models' batch and sequence


def _loss_inputs(vocab, rng):
    logits = rng.standard_normal((B, S, vocab)).astype(np.float32) * 3
    labels = rng.randint(0, vocab, (B, S))
    # labels in every vocab shard: the first and the last id of each half
    labels[0, :4] = [0, vocab // 2 - 1, vocab // 2, vocab - 1]
    mask = rng.rand(B, S) < 0.6
    mask[0, 0] = True
    return logits, labels.astype(np.int32), mask


def _inputs():
    rng = np.random.RandomState(0)
    loss = {}
    for name, (vocab, use_mask, shift) in LOSS_CASES.items():
        logits, labels, mask = _loss_inputs(vocab, rng)
        loss[name] = dict(logits=torch.from_numpy(logits),
                          labels=torch.from_numpy(labels),
                          mask=torch.from_numpy(mask) if use_mask else None,
                          shift=shift)
    embed = {}
    for name, (vocab, d) in EMBED_CASES.items():
        embed[name] = dict(
            table=torch.from_numpy(rng.standard_normal((vocab, d))
                                   .astype(np.float32)),
            tokens=torch.from_numpy(rng.randint(0, vocab, (B, S))
                                    .astype(np.int32)),
            weight=torch.from_numpy(rng.standard_normal((B, S, d))
                                    .astype(np.float32)))
    models = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = common.init_params(registry.param_specs(cfg),
                                    torch.Generator().manual_seed(0), "cpu")
        models[arch] = dict(params=params, batch=registry.make_train_batch(
            cfg, MB, MS, 1))
    return dict(loss=loss, embed=embed, models=models)


def _cfg(arch):
    return dataclasses.replace(configs.reduced_config(arch),
                               dtype=torch.float32)


def _shifted(logits, labels, mask, shift):
    n = logits.shape[1] - shift
    return (logits[:, :n], labels[:, shift:],
            None if mask is None else mask[:, shift:])


_RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import torch
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.models import common, layers, registry

    rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    init_ranks(rank, world, store)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    got = torch.load(f"{tmp}/inputs.pt")

    def placed(t, axes):
        plc = common.spec_to_placements(
            common.logical_to_spec(axes, tuple(t.shape), mesh), mesh)
        return distribute_tensor(t, mesh, plc)

    def comms(mode):
        return {str(k): v for k, v in mode.get_comm_counts().items()}

    out = {"loss": {}, "embed": {}, "models": {}}
    for name, c in got["loss"].items():
        logits = placed(c["logits"], ("batch", None, "vocab"))
        logits.requires_grad_()
        labels = common.shard_batch(c["labels"], mesh)
        mask = (None if c["mask"] is None
                else common.shard_batch(c["mask"], mesh))
        n = logits.shape[1] - c["shift"]
        mode = CommDebugMode()
        with mode:
            loss = layers.cross_entropy(
                logits[:, :n], labels[:, c["shift"]:],
                None if mask is None else mask[:, c["shift"]:])
            loss.backward()
        out["loss"][name] = dict(
            loss=loss.full_tensor(), grad=logits.grad.full_tensor(),
            placements=[repr(p) for p in logits.placements],
            grad_placements=[repr(p) for p in logits.grad.placements],
            comms=comms(mode))
    for name, c in got["embed"].items():
        table = placed(c["table"], ("vocab", "embed"))
        table.requires_grad_()
        tokens = common.shard_batch(c["tokens"], mesh)
        weight = common.shard_batch(c["weight"], mesh)
        mode = CommDebugMode()
        with mode:
            x = layers.embed_tokens({"embedding": table}, tokens, None)
            (x * weight).sum().backward()
        out["embed"][name] = dict(
            x=x.full_tensor(), grad=table.grad.full_tensor(),
            x_placements=[repr(p) for p in x.placements],
            placements=[repr(p) for p in table.placements],
            grad_placements=[repr(p) for p in table.grad.placements],
            comms=comms(mode))
    for arch, m in got["models"].items():
        cfg = dataclasses.replace(configs.reduced_config(arch),
                                  dtype=torch.float32)
        specs = registry.param_specs(cfg)
        params = common.shard_params(m["params"], specs, mesh)
        batch = {k: common.shard_batch(v, mesh) for k, v in m["batch"].items()}
        loss, grads = train.value_and_grad(params, cfg, batch)
        out["models"][arch] = dict(
            loss=loss.full_tensor(),
            grads=common.tree_map(lambda g: g.full_tensor(), grads),
            table=[repr(p) for p in params["embedding"].placements],
            table_grad=[repr(p) for p in grads["embedding"].placements])
    torch.save(out, f"{tmp}/rank{rank}.pt")
    """)


@pytest.fixture(scope="module")
def runs():
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="lm_sharded_loss_"))
    inputs = _inputs()
    torch.save(inputs, tmp / "inputs.pt")
    (tmp / "rank.py").write_text(_RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "rank.py"), str(r), "4",
         str(tmp / "store"), str(tmp)], env=env, stdout=subprocess.PIPE,
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
    return inputs, [torch.load(tmp / f"rank{r}.pt") for r in range(4)]


def _plain_loss(c):
    logits = c["logits"].clone().requires_grad_()
    loss = layers.cross_entropy(*_shifted(logits, c["labels"], c["mask"],
                                          c["shift"]))
    loss.backward()
    return loss.detach(), logits.grad


@pytest.mark.parametrize("name", LOSS_CASES)
def test_sharded_loss_equals_plain(runs, name):
    inputs, ranks = runs
    loss, grad = _plain_loss(inputs["loss"][name])
    for r in ranks:
        got = r["loss"][name]
        torch.testing.assert_close(got["loss"], loss, **TOL)
        torch.testing.assert_close(got["grad"], grad, **TOL)


@pytest.mark.parametrize("name", LOSS_CASES)
def test_sharded_loss_keeps_the_vocab_on_its_shards(runs, name):
    """The logits' gradient comes back placed as the logits were: the
    vocab's shards stay shards and no rank holds a replicated copy; a
    sharded vocab is never gathered."""
    vocab = LOSS_CASES[name][0]
    for r in runs[1]:
        got = r["loss"][name]
        assert got["grad_placements"] == got["placements"]
        want = "Shard(dim=2)" if vocab % 2 == 0 else "Replicate()"
        assert got["placements"] == ["Shard(dim=0)", want]
        assert not [k for k in got["comms"] if "all_gather" in k], \
            got["comms"]


@pytest.mark.parametrize("name", EMBED_CASES)
def test_sharded_lookup_equals_plain(runs, name):
    inputs, ranks = runs
    c = inputs["embed"][name]
    table = c["table"].clone().requires_grad_()
    x = layers.embed_tokens({"embedding": table}, c["tokens"], None)
    (x * c["weight"]).sum().backward()
    for r in ranks:
        got = r["embed"][name]
        torch.testing.assert_close(got["x"], x.detach(), **TOL)
        torch.testing.assert_close(got["grad"], table.grad, **TOL)


@pytest.mark.parametrize("name", EMBED_CASES)
def test_sharded_lookup_keeps_the_table_on_its_shards(runs, name):
    """The lookup's output is placed as the tokens' batch rows, whole
    over the rest; the table's gradient keeps the table's vocab
    placement; a vocab-sharded table with its embed dim whole is never
    gathered."""
    vocab, d = EMBED_CASES[name]
    for r in runs[1]:
        got = r["embed"][name]
        assert got["x_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert got["grad_placements"][1] == got["placements"][1] == (
            "Shard(dim=0)" if vocab % 2 == 0 else "Replicate()")
        if vocab % 2 == 0 and d % 2:
            assert not [k for k in got["comms"] if "all_gather" in k], \
                got["comms"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_model_loss_equals_plain(runs, arch):
    inputs, ranks = runs
    m = inputs["models"][arch]
    loss, grads = train.value_and_grad(m["params"], _cfg(arch), m["batch"])
    for r in ranks:
        got = r["models"][arch]
        torch.testing.assert_close(got["loss"], loss, **TOL)
        got_l, want_l = common.leaves(got["grads"]), common.leaves(grads)
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            torch.testing.assert_close(g, w, **TOL)
        # the table's gradient on the table's shards (vocab over 'model')
        assert got["table_grad"] == got["table"]
        assert got["table"][1] == "Shard(dim=0)"


@pytest.mark.parametrize("name", LOSS_CASES)
def test_plain_loss_equals_jax(runs, name):
    c = runs[0]["loss"][name]
    logits, labels, mask = _shifted(c["logits"], c["labels"], c["mask"],
                                    c["shift"])
    got = layers.cross_entropy(logits, labels, mask)
    want = jlayers.cross_entropy(
        jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()),
        None if mask is None else jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
