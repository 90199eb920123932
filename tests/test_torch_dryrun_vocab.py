"""The dry-run's counts of the sharded step's two ends and of the sLSTM's
time loop (``repro_torch.launch.dryrun.LocalCounter``), at reduced width
on fake process groups, on the CPU.

  * The vocab-parallel loss and lookup (``models.layers.cross_entropy`` /
    ``embed_tokens`` on DTensors) on a (4, 4) ('data', 'model') mesh of a
    fake 16-rank group, forward and backward under the counter: no tensor
    either makes holds more elements than the rank's local logits block
    (its batch rows by its vocab columns); the loss gathers nothing, the
    lookup only FSDP's gather of its own vocab rows.  The loss and the
    lookup as they were before (the vocab all-gathered, the whole table
    gathered onto every rank, both kept here) break these.
  * A reduced qwen2-0.5b train step on that mesh, its vocab widened to
    64 d_model (the published config's is 170 d_model, so the loss sets
    the step's peak there too): its temporaries fall, against the same
    step with the earlier loss and lookup, by at least the replicated
    gradient the earlier loss's ``gather`` backward made (the whole
    batch's fp32 logits: B x (S - 1) x V x 4 bytes); FLOPs and arguments
    unchanged, fewer collective bytes.
  * The sLSTM's time loop on each rank's local rows against the loop on
    DTensors it replaced (kept here), reduced xlstm-125m train steps at S
    = 32 and 64: the same collectives and trip counts; each trip past the
    first the same FLOPs, bytes and temporaries (the step at 64 less the
    step at 32); the whole step's FLOPs less by exactly the first trip's
    recurrent product on the whole batch, which the DTensor loop ran on
    a replicated zero state (2 (B - B / 4) H hd 4hd per product, in the
    forward and the remat recompute of each sLSTM layer), and its
    temporaries within 2 %.
  * Reduced whisper-base's prefill on a (4, 8) mesh, a model axis wider
    than the heads (each rank one (batch, head) pair): the pair split's
    output stays viewable for the heads merge and the encoder's output
    projection (it failed on a non-contiguous local shard before).

Each part in a subprocess of its own (the fake group is process-global),
side by side, under a time limit.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 300
B, S, VOCAB, D = 16, 32, 1024, 64

_EARLIER = textwrap.dedent('''
    import torch
    from repro_torch.models.common import (as_replicated, batch_local,
                                           gather_fsdp, is_dtensor,
                                           replicate_dims)


    def gathered_cross_entropy(logits, labels, mask=None):
        logits = replicate_dims(logits, -1).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - gold
        if mask is not None:
            m = mask.float()
            return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
        return torch.mean(nll)


    def gathered_embed_tokens(params, tokens, cfg):
        w = gather_fsdp(params["embedding"])
        if is_dtensor(w):
            return batch_local(lambda t, e: e[t.long()],
                               as_replicated(tokens, w), w)
        return w[tokens.long()]
    ''')

_ENDS = _EARLIER + textwrap.dedent('''
    import json, math
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import force_host_platform_device_count
    from repro_torch.models import common, layers

    B, S, V, D = %(B)d, %(S)d, %(V)d, %(D)d
    force_host_platform_device_count(16)
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))


    class Largest(TorchDispatchMode):
        """The most elements of any tensor a rank's local op makes (a
        view makes none)."""
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if DTensor in types:
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if not getattr(dryrun._PROPAGATING, "depth", 0) and not any(
                    r.alias_info is not None for r in func._schema.returns):
                for t in dryrun._tensors(out):
                    self.numel = max(self.numel, t.numel())
            return out


    def placed(shape, axes, dtype=torch.float32):
        plc = common.spec_to_placements(
            common.logical_to_spec(axes, shape, mesh), mesh)
        return dryrun.as_dtensor(torch.empty(shape, dtype=dtype), mesh, plc)


    def run(fn):
        counter, largest = dryrun.LocalCounter(), Largest()
        with counter, largest:
            fn()
        return dict(largest=largest.numel, peak=counter.peak_bytes,
                    collectives=counter.loops.stats().all_trips_bytes_by_kind)


    out = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        logits = placed((B, S, V), ("batch", None, "vocab")).requires_grad_()
        labels = placed((B, S), ("batch", None), torch.int32)
        table = placed((V, D), ("vocab", "embed")).requires_grad_()
        tokens = placed((B, S), ("batch", None), torch.int32)
        out["local_block"] = math.prod(logits.to_local().shape)
        for name, ce, look in (
                ("sharded", layers.cross_entropy, layers.embed_tokens),
                ("gathered", gathered_cross_entropy, gathered_embed_tokens)):
            def loss():
                value = ce(logits[:, :-1], labels[:, 1:])
                torch.autograd.grad(value, [logits])

            def lookup():
                x = look({"embedding": table}, tokens, None)
                torch.autograd.grad(x.sum(), [table])
            out[name] = dict(loss=run(loss), lookup=run(lookup))
    print(json.dumps(out))
    ''') % dict(B=B, S=S, V=VOCAB, D=D)

_QWEN2 = _EARLIER + textwrap.dedent('''
    import dataclasses, json
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer

    cfg = configs.reduced_config("qwen2-0.5b")
    cfg = dataclasses.replace(cfg, vocab_size=64 * cfg.d_model)
    cell = ShapeCell("train", %(S)d, %(B)d, "train")
    out = {"vocab": cfg.vocab_size}
    out["sharded"] = dryrun.run_cell("qwen2-0.5b", "train", False,
                                     mesh_shape=(4, 4), cfg=cfg, cell=cell)
    transformer.cross_entropy = gathered_cross_entropy
    transformer.embed_tokens = gathered_embed_tokens
    out["gathered"] = dryrun.run_cell("qwen2-0.5b", "train", False,
                                      mesh_shape=(4, 4), cfg=cfg, cell=cell)
    print(json.dumps(out))
    ''') % dict(B=B, S=S)

_SLSTM = textwrap.dedent('''
    import json
    import torch
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.trace_analysis import loop
    from repro_torch.models import xlstm
    from repro_torch.models.common import merge_heads, split_heads
    from repro_torch.models.layers import rms_norm


    def dtensor_loop(p, x, cfg):
        """The sLSTM's time loop on DTensors, as the port ran it before."""
        B, S, D = x.shape
        H = cfg.num_heads
        hd = D // H
        gx = split_heads(torch.matmul(x, p["wx"]), H, 4 * hd)
        h = torch.zeros((B, H, hd), dtype=x.dtype, device=x.device)
        c = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        hs = []
        for t in loop("xlstm.slstm_steps", S):
            g = gx[:, t] + torch.einsum("bhd,hdk->bhk", h, p["rh"])
            h, c, n = xlstm._slstm_cell(g, c, n, x.dtype)
            hs.append(h)
        y = merge_heads(torch.stack(hs, dim=1))
        y = rms_norm(y, p["norm"], cfg.norm_eps)
        return torch.matmul(y, p["down"])


    cfg = configs.reduced_config("xlstm-125m")
    local_loop = xlstm.slstm_forward
    out = {}
    for name, fn in (("local", local_loop), ("dtensor", dtensor_loop)):
        xlstm.slstm_forward = fn
        for seq in (32, 64):
            out[f"{name}/{seq}"] = dryrun.run_cell(
                "xlstm-125m", "train", False, mesh_shape=(4, 4), cfg=cfg,
                cell=ShapeCell("train", seq, %(B)d, "train"))
    print(json.dumps(out))
    ''') % dict(B=B)

_WHISPER = textwrap.dedent('''
    import json
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun

    cfg = configs.reduced_config("whisper-base")
    rec = dryrun.run_cell("whisper-base", "prefill", False,
                          mesh_shape=(4, 8), cfg=cfg,
                          cell=ShapeCell("prefill", 16, 8, "prefill"))
    print(json.dumps(dict(rec, heads=cfg.num_heads)))
    ''')


def _popen(script):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


@pytest.fixture(scope="module")
def runs():
    procs = {k: _popen(s) for k, s in (("ends", _ENDS), ("qwen2", _QWEN2),
                                       ("slstm", _SLSTM),
                                       ("whisper", _WHISPER))}
    got = {}
    try:
        for key, p in procs.items():
            out, err = p.communicate(timeout=LIMIT)
            assert p.returncode == 0, err[-3000:]
            got[key] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            p.kill()
    return got


@pytest.mark.parametrize("part", ["loss", "lookup"])
def test_nothing_past_the_local_logits_block(runs, part):
    got = runs["ends"]
    assert got["local_block"] == (B // 4) * S * (VOCAB // 4)
    assert 0 < got["sharded"][part]["largest"] <= got["local_block"]
    # the earlier loss and lookup made the whole vocab on every rank
    assert got["gathered"][part]["largest"] > got["local_block"]


def test_the_loss_gathers_nothing(runs):
    got = runs["ends"]
    assert "all-gather" not in got["sharded"]["loss"]["collectives"]
    assert got["sharded"]["loss"]["collectives"]["all-reduce"] > 0
    assert got["gathered"]["loss"]["collectives"]["all-gather"] \
        >= B // 4 * (S - 1) * VOCAB * 4


def test_the_lookup_gathers_only_its_fsdp_rows(runs):
    """The lookup's one all-gather is FSDP's, of the rank's own vocab
    rows over 'data' (``gather_fsdp``, the reference's too); the earlier
    lookup gathered the whole table onto every rank."""
    got = runs["ends"]
    own_rows = VOCAB // 4 * D * 4
    assert got["sharded"]["lookup"]["collectives"]["all-gather"] == own_rows
    assert got["gathered"]["lookup"]["collectives"]["all-gather"] \
        == own_rows + VOCAB * D * 4


def test_train_step_temporaries_fall_by_the_replicated_gradient(runs):
    got = runs["qwen2"]
    new, old = got["sharded"], got["gathered"]
    assert new["ok"] and old["ok"]
    replicated = B * (S - 1) * got["vocab"] * 4
    temp = "temp_size_in_bytes"
    assert old["memory_analysis"][temp] - new["memory_analysis"][temp] \
        >= replicated, (old["memory_analysis"], new["memory_analysis"])
    assert new["flops"] == old["flops"]
    assert new["memory_analysis"]["argument_size_in_bytes"] \
        == old["memory_analysis"]["argument_size_in_bytes"]
    assert new["collective_bytes_all_trips"] \
        < old["collective_bytes_all_trips"]


@pytest.mark.parametrize("key", [
    "collective_all_trips_by_kind", "collective_all_trips_counts",
    "collective_by_kind", "collective_in_loop_by_kind", "while_trip_counts",
    "collective_uneven_trips"])
def test_slstm_local_loop_issues_the_dtensor_loops_collectives(runs, key):
    got = runs["slstm"]
    for seq in (32, 64):
        assert got[f"local/{seq}"][key] == got[f"dtensor/{seq}"][key]
    assert seq in got["local/64"]["while_trip_counts"]


def _temp(rec):
    return rec["memory_analysis"]["temp_size_in_bytes"]


@pytest.mark.parametrize("what", ["flops", "bytes_accessed", "temp",
                                  "collective_bytes_all_trips"])
def test_slstm_each_trip_counts_as_the_dtensor_loops(runs, what):
    got = runs["slstm"]
    read = _temp if what == "temp" else (lambda rec: rec[what])
    per_trip = {name: read(got[f"{name}/64"]) - read(got[f"{name}/32"])
                for name in ("local", "dtensor")}
    assert per_trip["local"] == per_trip["dtensor"] > 0


def test_slstm_step_counts_less_the_replicated_first_trip(runs):
    from repro_torch import configs
    cfg = configs.reduced_config("xlstm-125m")
    H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    n_slstm = cfg.num_layers // cfg.slstm_every
    product = 2 * (B - B // 4) * H * hd * 4 * hd
    got = runs["slstm"]
    for seq in (32, 64):
        local, dtensor = got[f"local/{seq}"], got[f"dtensor/{seq}"]
        assert dtensor["flops"] - local["flops"] == 2 * n_slstm * product
        assert abs(_temp(local) - _temp(dtensor)) <= 0.02 * _temp(dtensor)
        assert local["memory_analysis"]["argument_size_in_bytes"] \
            == dtensor["memory_analysis"]["argument_size_in_bytes"]


def test_whisper_prefill_with_more_model_ranks_than_heads(runs):
    rec = runs["whisper"]
    assert rec["ok"] and rec["chips"] == 32 and rec["heads"] < 8
    assert rec["flops"] > 0 and rec["collective_bytes_all_trips"] > 0
