"""LM training, the trainer's entry point and the reference's public names
in repro_torch against the JAX package, on the CPU.

Inputs come from numpy with a seed; LM weights are drawn by the JAX
package (``init_params(PRNGKey(0))``) and cross into the port through
:mod:`repro_torch.convert`, or through a step-0 checkpoint that both
trainers resume.  Tolerances, each stated beside its check: the SSVM
names at rtol = atol = 3e-5 (labels equal); the loss and cross entropy
in float32 at rtol 1e-5; step-1 gradients leaf by leaf at rtol 1e-4,
atol 1e-6; 5 trainer steps in float32 with losses and grad norms at rtol
1e-4 and parameters at atol 2 lr steps (AdamW's first steps are
sign-like, so a near-zero gradient that rounds to the other sign moves a
weight by up to 2 lr a step); in bfloat16 the losses at rtol 2e-2;
whole Solver traces with equal counts and objectives at rtol 1e-4.
"""
import contextlib
import dataclasses
import io
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import paper as jpaper
from repro.core import averaging as javg
from repro.core import ssvm as jssvm
from repro.core import types as jtypes
from repro.core.oracles import chain as jchain
from repro.data import lm as jlm
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro.trainer import ssvm_head as jhead
from repro_torch import configs, convert
from repro_torch.api import Oracle
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import paper as tpaper
from repro_torch.core import averaging as tavg
from repro_torch.core import ssvm as tssvm
from repro_torch.core import types as ttypes
from repro_torch.core.oracles import chain as tchain
from repro_torch.data import lm as tlm
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import common, layers, registry
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_grads, cosine_schedule,
                               decompress_grads)
from repro_torch.trainer import ssvm_head

torch.set_num_threads(1)
ARCHS = ("qwen2-0.5b", "olmoe-1b-7b")
TOL = dict(rtol=3e-5, atol=3e-5)
LR, STEPS = 3e-4, 5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32_configs(monkeypatch):
    """Both packages' reduced configs in float32, for the trainers that
    build their config from the arch's name."""
    for mod, dt in ((jconfigs, jnp.float32), (configs, torch.float32)):
        plain = mod.reduced_config
        monkeypatch.setattr(mod, "reduced_config",
                            lambda name, plain=plain, dt=dt:
                            dataclasses.replace(plain(name), dtype=dt))


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params) in float32: one set
    of weights, drawn by the JAX package and carried across."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.reduced_config(arch),
                               dtype=torch.float32)
    jp = jcommon.init_params(jregistry.param_specs(jcfg),
                             jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _batch(vocab, B=4, S=16, seed=0):
    toks = jlm.TokenDataset(jlm.DataConfig(vocab_size=vocab, batch_size=B,
                                           seq_len=S, seed=seed)).batch(0)
    return toks, {k: _t(np.asarray(v)) for k, v in toks.items()}


def _leaves(tree):
    """A numpy tree's (or tensor tree's) leaves in sorted key order, as
    float32 arrays."""
    return [np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                       else x, np.float32) for x in common.leaves(tree)]


# -- the reference's public names ---------------------------------------------

def _chain_pair():
    X, Y, M = synthetic.ocr_like(n=12, f=6, num_labels=4, mean_len=5,
                                 max_len=7, seed=3)
    jp = jchain.make_problem(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(M),
                             4)
    tp = tchain.make_problem(X, Y, M, 4, device="cpu")
    return jp, tp


def test_duality_gap_matches_reference():
    jp, tp = _chain_pair()
    r = np.random.RandomState(0)
    lam = 1.0 / jp.n
    for _ in range(3):
        phi = (r.randn(jp.d + 1) * 0.05).astype(np.float32)
        phi_i = np.zeros((jp.n, jp.d + 1), np.float32)
        want = jssvm.duality_gap(
            jp, jtypes.BCFWState(jnp.asarray(phi_i), jnp.asarray(phi),
                                 jnp.int32(0), jnp.int32(0)), lam)
        got = tssvm.duality_gap(
            tp, ttypes.BCFWState(_t(phi_i), _t(phi), 0, 0), lam)
        assert got.shape == () and got.dtype == torch.float32
        assert_allclose(float(got), float(want), **TOL)


def test_update_average_matches_reference():
    r = np.random.RandomState(1)
    d = 9
    javg_state = javg.init_averaging(d)
    tavg_state = tavg.init_averaging(d, "cpu")
    for k in range(6):
        phi = r.randn(d + 1).astype(np.float32)
        exact = k % 3 != 2
        javg_state = javg.update_average(javg_state, jnp.asarray(phi),
                                         exact=exact)
        tavg_state = tavg.update_average(tavg_state, _t(phi), exact=exact)
    assert (tavg_state.k_exact, tavg_state.k_approx) == (
        int(javg_state.k_exact), int(javg_state.k_approx)) == (4, 2)
    for f in ("bar_exact", "bar_approx"):
        assert_allclose(getattr(tavg_state, f).numpy(),
                        np.asarray(getattr(javg_state, f)), **TOL)


@pytest.mark.parametrize("seed", range(4))
def test_viterbi_decode_matches_reference(seed):
    r = np.random.RandomState(seed)
    L, C = 9, 5
    unary = r.randn(L, C).astype(np.float32)
    trans = r.randn(C, C).astype(np.float32)
    mask = np.arange(L) < r.randint(1, L + 1)
    want = np.asarray(jchain.viterbi_decode(jnp.asarray(unary),
                                            jnp.asarray(trans),
                                            jnp.asarray(mask)))
    got = tchain.viterbi_decode(_t(unary), _t(trans), _t(mask))
    assert got.dtype == torch.int32 and got.shape == (L,)
    assert (got.numpy() == want).all()


def test_pass_stats_and_the_oracle_protocol():
    assert ttypes.PassStats._fields == jtypes.PassStats._fields
    _, tp = _chain_pair()
    assert isinstance(tp.oracle, Oracle)
    assert not isinstance(3, Oracle)
    w = torch.zeros(tp.d)
    planes = tp.oracle(w, {k: v[:2] for k, v in tp.data.items()})
    assert planes.shape == (2, tp.d + 1)


@pytest.mark.parametrize("name", ["usps", "ocr", "horseseg"])
def test_build_problem_matches_reference(name):
    jprob = jhead.build_problem(jpaper.SMALL[name])
    tspec, tdata = ssvm_head.scenario_spec_and_data(tpaper.SMALL[name],
                                                    device="cpu")
    tprob = ssvm_head.build_problem(tpaper.SMALL[name], device="cpu")
    assert (tprob.n, tprob.d) == (jprob.n, jprob.d)
    assert type(tprob.spec).__name__ == type(jprob.spec).__name__
    assert set(tprob.data) == set(jprob.data) == set(tdata)
    for k, v in jprob.data.items():
        got = tprob.data[k]
        assert got.device.type == "cpu"
        assert str(got.dtype).split(".")[-1] == str(v.dtype)
        assert (got.numpy() == np.asarray(v)).all(), k
    assert type(tspec) is type(tprob.spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_long_context_overrides_match_reference(arch):
    assert configs.long_context_overrides(arch) == \
        jconfigs.long_context_overrides(arch)
    # zamba2-7b (ported) carries the reference's window; an unknown arch
    # raises as in the reference.
    assert configs.long_context_overrides("zamba2-7b") == \
        jconfigs.long_context_overrides("zamba2-7b") == \
        {"sliding_window": 4096}
    with pytest.raises(KeyError):
        configs.long_context_overrides("gpt-5")


# -- the loss and its gradients -----------------------------------------------

def test_cross_entropy_matches_reference():
    r = np.random.RandomState(2)
    logits = r.randn(3, 7, 11).astype(np.float32) * 3
    labels = r.randint(0, 11, (3, 7)).astype(np.int32)
    mask = r.rand(3, 7) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = layers.cross_entropy(_t(logits), _t(labels),
                                   None if m is None else _t(m))
        assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    got = layers.cross_entropy(_t(logits).to(torch.bfloat16), _t(labels))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    jb, tb = _batch(tcfg.vocab_size)
    want = jregistry.loss_fn(jp, jcfg, jb)
    got = registry.loss_fn(tp, tcfg, tb)
    assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_one_gradients_match_jax_grad(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    jb, tb = _batch(tcfg.vocab_size)
    want = jax.grad(lambda p: jregistry.loss_fn(p, jcfg, jb))(jp)
    loss, grads = train.value_and_grad(tp, tcfg, tb)
    assert not loss.requires_grad
    want_l = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    got_l = _leaves(grads)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_make_train_batch_matches_reference():
    tcfg = configs.reduced_config("qwen2-0.5b")
    jcfg = jconfigs.reduced_config("qwen2-0.5b")
    want = jregistry.make_train_batch(jcfg, 3, 8, 5)
    got = registry.make_train_batch(tcfg, 3, 8, 5)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        assert (got[k].numpy() == np.asarray(want[k])).all()


# -- the optimizer ------------------------------------------------------------

def _opt_trees(r, dtype):
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return r.randn(*tree).astype(np.float32)
    p, g = draw(shapes), draw(shapes)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jmap = lambda tr: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jdt), tr)
    tmap = lambda tr: common.tree_map(  # noqa: E731
        lambda a: _t(a).to(tdt), tr)
    return jmap(p), jmap(g), tmap(p), tmap(g)


@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_adamw_update_matches_reference(param_dtype, state_dtype):
    """Three updates (the first at lr 0, as the trainer's schedule starts)
    with a clipped global norm: parameters, moments and the norm within
    float32 rounding (rtol 1e-5), bf16 leaves within one bf16 ulp."""
    r = np.random.RandomState(3)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[state_dtype]
    jcfg = jadamw.AdamWConfig(lr=0.01, grad_clip=0.5, state_dtype=jdt)
    tcfg = AdamWConfig(lr=0.01, grad_clip=0.5, state_dtype=tdt)
    jp, jg, tp, tg = _opt_trees(r, param_dtype)
    jst, tst = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    tol = (dict(rtol=1e-5, atol=1e-7) if "bf16" not in (param_dtype,
                                                        state_dtype)
           else dict(rtol=2.0 ** -7, atol=1e-6))
    for step in range(3):
        jlr = jsched.cosine_schedule(jnp.asarray(step, jnp.int32),
                                     peak_lr=0.01, warmup=2, total=10)
        tlr = cosine_schedule(step, peak_lr=0.01, warmup=2, total=10)
        jp, jst, jstats = jadamw.adamw_update(jg, jst, jp, jcfg, jlr)
        tp, tst, tstats = adamw_update(tg, tst, tp, tcfg, tlr)
        assert tst.step == int(jst.step) == step + 1
        assert_allclose(float(tstats["grad_norm"]),
                        float(jstats["grad_norm"]), rtol=1e-6)
        for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
            for a, b in zip(_leaves(got),
                            [np.asarray(x, np.float32)
                             for x in jax.tree_util.tree_leaves(want)]):
                assert_allclose(a, b, **tol)
    assert common.leaves(tst.m)[0].dtype == tdt
    assert common.leaves(tp)[0].dtype == common.leaves(tg)[0].dtype


def test_cosine_schedule_matches_reference():
    for step in range(0, 45):
        want = jsched.cosine_schedule(jnp.asarray(step, jnp.int32),
                                      peak_lr=3e-4, warmup=20, total=40)
        got = cosine_schedule(step, peak_lr=3e-4, warmup=20, total=40)
        assert got.dtype == torch.float32
        assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)
    got = cosine_schedule(torch.tensor([3, 30]), peak_lr=1.0, warmup=20,
                          total=40)
    assert got.shape == (2,)


def test_compress_grads_matches_reference():
    r = np.random.RandomState(4)
    jp, jg, tp, tg = _opt_trees(r, "f32")
    jres = jax.tree_util.tree_map(lambda a: a * 0.01, jp)
    tres = common.tree_map(lambda a: a * 0.01, tp)
    for jr, tr in ((None, None), (jres, tres)):
        jq, js, jnew = jcomp.compress_grads(jg, jr)
        tq, ts, tnew = compress_grads(tg, tr)
        for a, b in zip(common.leaves(tq), jax.tree_util.tree_leaves(jq)):
            assert a.dtype == torch.int8
            assert (a.numpy() == np.asarray(b)).all()
        assert_allclose(_leaves(ts), [np.asarray(x) for x in
                                      jax.tree_util.tree_leaves(js)],
                        rtol=1e-7)
        for a, b in zip(_leaves(tnew), jax.tree_util.tree_leaves(jnew)):
            assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
        for a, b in zip(_leaves(decompress_grads(tq, ts)),
                        jax.tree_util.tree_leaves(
                            jcomp.decompress_grads(jq, js))):
            assert_allclose(a, np.asarray(b), rtol=1e-7)


# -- the data pipeline --------------------------------------------------------

@pytest.mark.parametrize("shard", [0, 3])
def test_token_dataset_batches_equal_reference(shard):
    kw = dict(vocab_size=500, batch_size=3, seq_len=17, seed=2,
              num_shards=4, shard=shard)
    jd = jlm.TokenDataset(jlm.DataConfig(**kw))
    td = tlm.TokenDataset(tlm.DataConfig(**kw))
    for step in (0, 1, 9):
        want, got = jd.batch(step), td.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert got[k].device.type == "cpu"
            assert (got[k].numpy() == np.asarray(want[k])).all()
    pf = tlm.Prefetcher(td, start_step=9)
    try:
        assert (pf.next()["tokens"] == td.batch(9)["tokens"]).all()
        assert (pf.next()["tokens"] == td.batch(10)["tokens"]).all()
    finally:
        pf.close()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("arch,target", [("qwen2-0.5b", 10 ** 8),
                                         ("olmoe-1b-7b", 3 * 10 ** 8)])
def test_scale_to_params_picks_the_reference_width(arch, target):
    want = jtrain.scale_to_params(jconfigs.get_config(arch), target)
    got = train.scale_to_params(configs.get_config(arch), target)
    for f in ("d_model", "d_ff", "num_heads", "num_kv_heads"):
        assert getattr(got, f) == getattr(want, f), f


# -- the trainer --------------------------------------------------------------

def _jax_state0(arch):
    jcfg = jconfigs.reduced_config(arch)
    params = jcommon.init_params(jregistry.param_specs(jcfg),
                                 jax.random.PRNGKey(0))
    return jcfg, {"params": params,
                  "opt": jadamw.adamw_init(params,
                                           jadamw.AdamWConfig(lr=LR))}


def _jax_steps(jcfg, state, steps, B, S):
    """The reference trainer's step (``repro/launch/train.py``'s
    ``step_fn``) for ``steps`` steps from ``state``: (losses, grad
    norms, final state)."""
    ocfg = jadamw.AdamWConfig(lr=LR)
    data = jlm.TokenDataset(jlm.DataConfig(vocab_size=jcfg.vocab_size,
                                           batch_size=B, seq_len=S))

    @jax.jit
    def step_fn(state, batch, step):
        lr = jsched.cosine_schedule(step, peak_lr=ocfg.lr, warmup=20,
                                    total=steps)
        loss, grads = jax.value_and_grad(
            lambda p: jregistry.loss_fn(p, jcfg, batch))(state["params"])
        params, opt, stats = jadamw.adamw_update(grads, state["opt"],
                                                 state["params"], ocfg, lr)
        return {"params": params, "opt": opt}, loss, stats["grad_norm"]

    losses, norms = [], []
    for step in range(steps):
        state, loss, gnorm = step_fn(state, data.batch(step),
                                     jnp.asarray(step, jnp.int32))
        losses.append(float(loss))
        norms.append(float(gnorm))
    return losses, norms, state


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_lm_matches_reference_in_float32(arch, tmp_path, monkeypatch):
    """5 steps of the port's ``train_lm`` from the reference's initial
    state (a step-0 checkpoint both read) against the reference's step:
    losses and grad norms within rtol 1e-4, the step-5 parameters within
    atol 2 lr steps, the moments within rtol 1e-3."""
    _f32_configs(monkeypatch)
    B, S = 4, 16
    jcfg, state0 = _jax_state0(arch)
    JCheckpointManager(str(tmp_path / "t")).save(0, state0)
    losses, norms, jstate = _jax_steps(jcfg, state0, STEPS, B, S)
    out = _quiet(train.train_lm, arch, STEPS, B, S, True,
                 str(tmp_path / "t"), STEPS, log_every=1, device="cpu")
    assert_allclose(out["step_losses"], losses, rtol=1e-4)
    assert_allclose(out["grad_norms"], norms, rtol=1e-4)
    assert [s for s, _ in out["losses"]] == list(range(STEPS))
    tcfg = configs.reduced_config(arch)
    template = train.init_state(tcfg, AdamWConfig(lr=LR), "cpu")
    got, manifest = CheckpointManager(str(tmp_path / "t")).restore(template)
    assert manifest["step"] == STEPS and got["opt"].step == STEPS
    assert_allclose(manifest["extra"]["loss"], losses[-1], rtol=1e-4)
    want_p = [np.asarray(x) for x in
              jax.tree_util.tree_leaves(jstate["params"])]
    for a, b in zip(_leaves(got["params"]), want_p):
        assert_allclose(a, b, rtol=0, atol=2 * LR * STEPS)
    want_v = [np.asarray(x) for x in
              jax.tree_util.tree_leaves(jstate["opt"].v)]
    for a, b in zip(_leaves(got["opt"].v), want_v):
        assert_allclose(a, b, rtol=1e-3, atol=1e-9)


def test_train_lm_matches_reference_in_bfloat16(tmp_path):
    """The published dtype (bf16 weights): losses within rtol 2e-2."""
    arch, B, S = "qwen2-0.5b", 4, 16
    jcfg, state0 = _jax_state0(arch)
    JCheckpointManager(str(tmp_path / "t")).save(0, state0)
    losses, _, _ = _jax_steps(jcfg, state0, STEPS, B, S)
    out = _quiet(train.train_lm, arch, STEPS, B, S, True,
                 str(tmp_path / "t"), 100, log_every=100, device="cpu")
    assert_allclose(out["step_losses"], losses, rtol=2e-2)
    assert [s for s, _ in out["losses"]] == [0, STEPS - 1]


def test_checkpoints_resume_across_packages(tmp_path, monkeypatch):
    """The reference trainer saves at step 3 and the port resumes it; the
    port saves at step 3 and the reference resumes it.  The resumed
    steps' losses equal the writer's uninterrupted ones within rtol
    1e-4 (float32)."""
    _f32_configs(monkeypatch)
    arch, B, S, steps = "qwen2-0.5b", 4, 16, 5
    whole = _quiet(jtrain.train_lm, arch, steps, B, S, True,
                   str(tmp_path / "j"), 3, log_every=1)
    shutil.copytree(tmp_path / "j" / "step_0000000003",
                    tmp_path / "t" / "step_0000000003")
    resumed = _quiet(train.train_lm, arch, steps, B, S, True,
                     str(tmp_path / "t"), 3, log_every=1, device="cpu")
    assert [s for s, _ in resumed["losses"]] == [3, 4]
    assert_allclose(resumed["step_losses"],
                    [v for _, v in whole["losses"][3:]], rtol=1e-4)

    whole = _quiet(train.train_lm, arch, steps, B, S, True,
                   str(tmp_path / "p"), 3, log_every=1, device="cpu")
    shutil.copytree(tmp_path / "p" / "step_0000000003",
                    tmp_path / "q" / "step_0000000003")
    resumed = _quiet(jtrain.train_lm, arch, steps, B, S, True,
                     str(tmp_path / "q"), 3, log_every=1)
    assert [s for s, _ in resumed["losses"]] == [3, 4]
    assert_allclose([v for _, v in resumed["losses"]],
                    whole["step_losses"][3:], rtol=1e-4)


def test_lm_train_state_converts_both_ways():
    jcfg, state = _jax_state0("olmoe-1b-7b")
    tcfg = configs.reduced_config("olmoe-1b-7b")
    host = jax.device_get(state)
    got = convert.lm_train_state_from_numpy(host, tcfg, "cpu")
    assert got["opt"].step == 0
    assert common.leaves(got["params"])[0].dtype in (torch.bfloat16,
                                                     torch.float32)
    assert all(t.dtype == torch.float32 for t in common.leaves(got["opt"].m))
    back = convert.lm_train_state_to_numpy(got)
    assert back["opt"]["step"] == 0
    for a, b in zip(common.leaves(back["params"]),
                    jax.tree_util.tree_leaves(host["params"])):
        assert (a == np.asarray(b, np.float32)).all()
    for a, b in zip(common.leaves(back["opt"]["v"]),
                    jax.tree_util.tree_leaves(host["opt"].v)):
        assert (a == np.asarray(b)).all()


@pytest.mark.parametrize("name", ["usps", "ocr", "horseseg"])
def test_train_ssvm_traces_match_reference(name):
    want = _quiet(jtrain.train_ssvm, name, 3)["trace"]
    got = _quiet(train.train_ssvm, name, 3, device="cpu")["trace"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.n_exact, g.n_approx, g.approx_passes) == (
            w.n_exact, w.n_approx, w.approx_passes)
        assert_allclose([g.dual, g.primal], [w.dual, w.primal], rtol=1e-4,
                        atol=1e-7)


def test_train_main_runs_on_the_cpu(capsys):
    out = train.main(["--trainer", "ssvm", "--scenario", "ocr", "--iters",
                      "3", "--device", "cpu"])
    assert len(out["trace"]) == 3
    out = train.main(["--trainer", "lm", "--reduced", "--steps", "5",
                      "--seq-len", "16", "--batch-size", "2", "--device",
                      "cpu"])
    assert len(out["step_losses"]) == 5
    assert np.isfinite(out["step_losses"]).all()
    text = capsys.readouterr().out
    assert "iter   2" in text and "step     4" in text


def test_train_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        train.train_lm("qwen2-0.5b", 1, 2, 8, True)
    with pytest.raises(RuntimeError, match="no CUDA"):
        train.train_ssvm("ocr", 1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ssvm_head.build_problem(tpaper.SMALL["ocr"])


# -- the kernels' autograd Functions ------------------------------------------

def _no_plain_versions(monkeypatch):
    """Make the plain versions raise: a backward must not call them."""
    def boom(*a, **k):
        raise AssertionError("a backward called kernels/ref.py")
    monkeypatch.setattr(ref, "flash_attention_ref", boom)
    monkeypatch.setattr(ref, "moe_ffn_ref", boom)


@pytest.mark.parametrize("shapes,scale", [
    (((2, 7, 4, 8), (2, 7, 2, 8)), None),
    (((2, 9, 6, 16), (2, 9, 1, 16)), 0.3),
    (((3, 11, 5), (3, 11, 5)), None)])
def test_flash_attention_function_gradient_is_the_chunked_attention(
        shapes, scale, monkeypatch):
    """On CPU tensors the Function's gradient equals autograd through the
    chunked causal attention over repeated kv heads (the reference's
    training math), within float32 rounding (rtol = atol = 1e-5)."""
    r = np.random.RandomState(len(shapes[0]))
    q = _t(r.randn(*shapes[0]).astype(np.float32)).requires_grad_()
    k, v = (_t(r.randn(*shapes[1]).astype(np.float32)).requires_grad_()
            for _ in range(2))
    out = ops.FlashAttention.apply(q, k, v, scale)
    gout = torch.randn_like(out)
    want_out = ops.attention_math(q, k, v, scale)
    want = torch.autograd.grad(want_out, (q, k, v), gout)
    _no_plain_versions(monkeypatch)
    got = torch.autograd.grad(out, (q, k, v), gout)
    assert_allclose(out.detach().numpy(), want_out.detach().numpy(),
                    rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_moe_ffn_function_gradient_is_the_einsum_swiglu(monkeypatch):
    """The Function's gradient against autograd through the reference's
    off-TPU einsums, and through the plain version, within float32
    rounding (rtol = atol = 1e-5); only the inputs that need one get a
    gradient."""
    r = np.random.RandomState(5)
    xs = _t(r.randn(3, 6, 8).astype(np.float32)).requires_grad_()
    wg, wu = (_t(r.randn(3, 8, 5).astype(np.float32)).requires_grad_()
              for _ in range(2))
    wd = _t(r.randn(3, 5, 8).astype(np.float32))
    out = ops.MoeFFN.apply(xs, wg, wu, wd)
    gout = torch.randn_like(out)
    want = torch.autograd.grad(ops.moe_ffn_math(xs, wg, wu, wd),
                               (xs, wg, wu), gout)
    plain = torch.autograd.grad(ref.moe_ffn_ref(xs, wg, wu, wd),
                                (xs, wg, wu), gout)
    _no_plain_versions(monkeypatch)
    got = torch.autograd.grad(out, (xs, wg, wu), gout)
    for a, b, c in zip(got, want, plain):
        assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
        assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-5)


def test_wrappers_on_cpu_tensors_stay_differentiable():
    """On the CPU the wrappers run the plain versions, which autograd
    differentiates: the model's CPU path needs no Function."""
    r = np.random.RandomState(6)
    q, k, v = (_t(r.randn(2, 5, 2, 4).astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is not None
    xs = _t(r.randn(2, 3, 4).astype(np.float32)).requires_grad_()
    w = [_t(r.randn(*s).astype(np.float32)) for s in
         ((2, 4, 3), (2, 4, 3), (2, 3, 4))]
    assert ops.moe_ffn(xs, *w).grad_fn is not None
