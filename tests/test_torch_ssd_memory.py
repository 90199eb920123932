"""The SSD's intra-chunk slabs (``repro_torch.models.ssm.ssd_forward``)
live no longer than they are used, on the CPU.

The intra-chunk step makes (B, nc, Q, Q, H) float32 slabs: the segment
sums, their masked copy, the decay L, the scores, and the einsum's
permuted copy of the scores.  An eager step frees a tensor when its last
reference goes; the earlier body (kept here) held ``seg``, ``L`` and
``scores`` as locals to its end, where the reference's XLA program frees
each buffer after its last use.

  * Live slabs: a no-grad ``ssd_forward`` of reduced zamba2-7b at its
    published chunk (Q = 256) on 2 x 1024 tokens: no op sees more than
    two slabs live (storages of a slab's bytes, counted after each op
    made its outputs); the earlier body shows four.
  * Values: outputs and float32 gradients, leaf by leaf, equal the
    earlier body's bit for bit on the same numpy-seeded inputs (with and
    without a padded last chunk); the mLSTM, which passes its segment
    sums named, equals itself under the earlier ``_masked_exp``.
  * Against the reference's compile: a reduced zamba2-7b prefill of
    ``PREFILL`` on a (2, 2) mesh of a fake 4-rank group, traced by
    ``dryrun.run_cell``, in one subprocess with the earlier body's trace
    (``ssm.ssd_forward`` replaced); the reference's ``memory_analysis`` of
    the same config and cell in a JAX subprocess beside it.  Q = 256 and
    H = d_inner / 64 make Q·H = 4·d_inner at any width, so at 2 chunks the
    slabs outweigh the stream, as at full size: the port's temporaries
    are at or under the reference's (0.87 of them, as at full size), the
    earlier body's over them (1.30; 1.39 at full size), the FLOPs and
    arguments of the two port traces equal.  (At 1024 tokens the shared
    attention's (S, S) scores set the reference's peak, and the earlier
    body is under it too.)
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import configs
from repro_torch.launch.trace_analysis import loop
from repro_torch.models import ssm, xlstm
from repro_torch.models.common import batch_local, merge_heads

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "zamba2-7b"
B, S = 2, 1024                      # 4 chunks of the published 256
PREFILL = dict(B=4, S=512, mesh=(2, 2))   # 2 chunks
LIMIT = 300


# -- the earlier body: every slab a local until the function returns ----------

def earlier_masked_exp(seg: torch.Tensor, Q: int) -> torch.Tensor:
    qi = torch.arange(Q, device=seg.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    return torch.exp(seg.masked_fill(~causal, float("-inf")))


def earlier_ssd_forward(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    Bsz, S, _ = x.shape
    d_inner, H, N = ssm.ssm_dims(cfg)
    pdim = ssm.HEADDIM
    Q = min(cfg.ssm_chunk, S)
    pad = -S % Q
    z, xBC, dt = ssm._split_proj(p, x, cfg)
    xBC = batch_local(ssm._causal_conv, xBC, p["conv_w"], p["conv_b"])
    if pad:
        xBC, dt = (batch_local(lambda t: F.pad(t, (0, 0, 0, pad)), t)
                   for t in (xBC, dt))
    Sp = xBC.shape[1]
    nc = Sp // Q
    xs = xBC[..., :d_inner].reshape(Bsz, nc, Q, H, pdim).float()
    Bm = xBC[..., d_inner:d_inner + N].reshape(Bsz, nc, Q, N).float()
    Cm = xBC[..., d_inner + N:].reshape(Bsz, nc, Q, N).float()
    dt = F.softplus(dt.float() + p["dt_bias"]).reshape(Bsz, nc, Q, H)
    A = -torch.exp(p["A_log"])
    a = dt * A
    cum = batch_local(lambda t: torch.cumsum(t, dim=2), a)

    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = earlier_masked_exp(seg, Q)
    cb = torch.einsum("bcqn,bcsn->bcqs", Cm, Bm)
    scores = cb[..., None] * L * dt[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xs)

    decay_out = torch.exp(cum[:, :, -1:, :] - cum)
    sc = torch.einsum("bcsh,bcsn,bcshp->bchnp", dt * decay_out, Bm, xs)
    chunk_decay = torch.exp(cum[:, :, -1, :])

    state = torch.zeros((Bsz, H, N, pdim), dtype=torch.float32,
                        device=x.device)
    states = []
    for c in loop("ssm.ssd_chunks", nc):
        states.append(state)
        state = state * chunk_decay[:, c, :, None, None] + sc[:, c]
    states = torch.stack(states, dim=1)

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cm, torch.exp(cum),
                           states)
    y = (y_intra + y_inter).reshape(Bsz, Sp, H, pdim)[:, :S]
    y = y + p["D"][None, None, :, None] * \
        xBC[..., :d_inner].reshape(Bsz, Sp, H, pdim)[:, :S]
    y = merge_heads(y).to(x.dtype)
    y = y * F.silu(z)
    y = ssm._gated_norm(y, p["norm"], cfg)
    return torch.matmul(y, p["out_proj"])


FORWARDS = {"now": ssm.ssd_forward, "earlier": earlier_ssd_forward}


# -- helpers ------------------------------------------------------------------

def _cfg(**over):
    return dataclasses.replace(configs.reduced_config(ARCH),
                               dtype=torch.float32, **over)


def _inputs(cfg, Bsz, Sq, seed=0):
    """One SSD layer's float32 weights and its input, from numpy; dt's
    bias near Mamba2's initial -4, so a chunk's decays stay normal floats
    (no denormal arithmetic)."""
    rng = np.random.default_rng(seed)
    p = {k: torch.from_numpy((0.5 * rng.standard_normal(s.shape))
                             .astype(np.float32))
         for k, s in sorted(ssm.ssm_specs(cfg).items())}
    p["dt_bias"] -= 4.0
    x = torch.from_numpy(rng.standard_normal((Bsz, Sq, cfg.d_model))
                         .astype(np.float32))
    return p, x


class LiveSlabs(TorchDispatchMode):
    """The most storages of ``nbytes`` live at once, read after each op
    has made its outputs (its operands still held)."""

    def __init__(self, nbytes: int):
        super().__init__()
        self.nbytes, self.live, self.most = nbytes, WeakIdKeyDictionary(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) \
                    and t.untyped_storage().nbytes() == self.nbytes:
                self.live[t.untyped_storage()] = True
        self.most = max(self.most, len(self.live))
        return out


# -- live slabs ---------------------------------------------------------------

def _most_live(forward) -> tuple:
    cfg = _cfg()
    _, H, _ = ssm.ssm_dims(cfg)
    Q = cfg.ssm_chunk
    slab = B * (S // Q) * Q * Q * H * 4
    p, x = _inputs(cfg, B, S)
    mode = LiveSlabs(slab)
    with torch.no_grad(), mode:
        forward(p, x, cfg)
    return mode.most, len(mode.live)


def test_reduced_zamba2_is_at_the_published_chunk():
    cfg = _cfg()
    d_inner, H, _ = ssm.ssm_dims(cfg)
    assert cfg.ssm_chunk == 256 and S % cfg.ssm_chunk == 0
    assert cfg.ssm_chunk * H == 4 * d_inner


@pytest.mark.parametrize("which,most", [("now", 2), ("earlier", 4)])
def test_live_intra_chunk_slabs(which, most):
    got, left = _most_live(FORWARDS[which])
    assert got == most, (which, got)
    assert left == 0                    # every slab freed by the end


# -- values -------------------------------------------------------------------

@pytest.mark.parametrize("Sq,chunk", [(S, 256), (300, 64)],
                         ids=["4-chunks", "padded"])
def test_outputs_and_gradients_equal_the_earlier_body(Sq, chunk):
    cfg = _cfg(ssm_chunk=chunk)
    got = {}
    for which, forward in FORWARDS.items():
        p, x = _inputs(cfg, B, Sq, seed=1)
        leaves = dict(p, x=x)
        for t in leaves.values():
            t.requires_grad_(True)
        y = forward(p, x, cfg)
        w = torch.from_numpy(np.random.default_rng(2).standard_normal(
            y.shape).astype(np.float32))
        (y * w).sum().backward()
        with torch.no_grad():
            y0 = forward(p, x, cfg)
        got[which] = (y.detach(), y0,
                      {k: t.grad for k, t in leaves.items()})
    (y, y0, g), (ey, ey0, eg) = got["now"], got["earlier"]
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, ey) and torch.equal(y0, ey0) and torch.equal(y, y0)
    assert g.keys() == eg.keys() == set(ssm.ssm_specs(cfg)) | {"x"}
    for k in g:
        assert g[k] is not None and torch.equal(g[k], eg[k]), k


def test_mlstm_is_unmoved_by_the_masked_exp(monkeypatch):
    rng = np.random.default_rng(3)
    Bsz, Sq, H, hd = 2, 40, 2, 8

    def run():
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (Bsz, Sq, H, hd)).astype(np.float32)) for _ in range(3))
        i_g, f_g = (torch.from_numpy(rng.uniform(0.1, 1.0, (Bsz, Sq, H))
                                     .astype(np.float32)) for _ in range(2))
        ins = (q, k, v, i_g, f_g)
        for t in ins:
            t.requires_grad_(True)
        y = xlstm._mlstm_heads(*ins, chunk=16)
        y.square().sum().backward()
        return y.detach(), [t.grad for t in ins]

    state = rng.bit_generator.state
    y, g = run()
    rng.bit_generator.state = state
    monkeypatch.setattr(xlstm, "_masked_exp", earlier_masked_exp)
    ey, eg = run()
    assert torch.equal(y, ey)
    assert all(torch.equal(a, b) for a, b in zip(g, eg))


# -- against the reference's compile ------------------------------------------

_PORT = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, %(tests)r)
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.models import ssm
    from test_torch_ssd_memory import earlier_ssd_forward

    def record():
        rec = dryrun.run_cell(%(arch)r, "prefill", False,
                              mesh_shape=%(mesh)r,
                              cfg=configs.reduced_config(%(arch)r),
                              cell=ShapeCell("prefill", %(S)d, %(B)d,
                                             "prefill"))
        assert rec["ok"], rec
        return dict(flops=rec["flops"], **rec["memory_analysis"])

    now = record()
    ssm.ssd_forward = earlier_ssd_forward
    print(json.dumps(dict(now=now, earlier=record())))
    """) % dict(tests=str(ROOT / "tests"), arch=ARCH, **PREFILL)

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    jax.devices()
    from repro import configs
    from repro.configs.shapes import ShapeCell
    from repro.launch import dryrun

    configs.SHAPES["reduced_prefill"] = ShapeCell("reduced_prefill", %(S)d,
                                                  %(B)d, "prefill")
    dryrun.build_config = lambda arch, shape, ov: \\
        configs.reduced_config(arch)
    rec = dryrun.run_cell(%(arch)r, "reduced_prefill", False,
                          mesh_shape=%(mesh)r)
    assert rec["ok"], rec
    print(json.dumps(rec["memory_analysis"]))
    """) % dict(arch=ARCH, **PREFILL)


@pytest.fixture(scope="module")
def prefill_records():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {key: subprocess.Popen(
        [sys.executable, "-c", script], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for key, script in (("port", _PORT), ("reference", _REFERENCE))}
    got = {}
    try:
        for key, p in procs.items():
            out, err = p.communicate(timeout=LIMIT)
            assert p.returncode == 0, err[-3000:]
            got[key] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            p.kill()
    return dict(got.pop("port"), **got)


def test_prefill_temporaries_at_or_under_the_reference_compile(
        prefill_records):
    now, ref = prefill_records["now"], prefill_records["reference"]
    assert 0 < now["temp_size_in_bytes"] <= ref["temp_size_in_bytes"], \
        prefill_records


def test_the_earlier_body_is_over_the_reference_compile(prefill_records):
    now, earlier = prefill_records["now"], prefill_records["earlier"]
    assert earlier["temp_size_in_bytes"] \
        > prefill_records["reference"]["temp_size_in_bytes"], prefill_records
    assert earlier["flops"] == now["flops"]
    assert earlier["argument_size_in_bytes"] \
        == now["argument_size_in_bytes"]
