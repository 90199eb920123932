"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU, each at a small size, and where the reference's script runs in a few
seconds, against it.

The reference scripts in ``examples/`` are loaded from their files and
their ``main()`` run with the standard output captured; the port's
``main(argv)`` returns the figures it prints.  Tolerances: printed
figures (5 decimals) within 1.5e-5, counts and labels equal; the SSVM
head's Solver trace on the reference's float32 weights at rtol 1e-4.
"""
import contextlib
import dataclasses
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import configs as jconfigs
from repro.api import RunConfig as JRunConfig
from repro.api import Solver as JSolver
from repro.core.selection import CostModel as JCostModel
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.trainer import ssvm_head as jhead
from repro_torch import configs, convert
from repro_torch.examples import (lm_train, quickstart,
                                  segmentation_distributed,
                                  sequence_labeling, ssvm_head)
from repro_torch.trainer.ssvm_head import tagging_task

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _reference(name):
    """The reference script ``examples/<name>.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def test_quickstart_runs_small_on_the_cpu():
    out, text = _run(quickstart.main, ["--device", "cpu", "--n", "40",
                                       "--max-iters", "2"])
    assert out["served_equal"]
    assert 0.0 <= out["accuracy"] <= 1.0 and np.isfinite(out["ordinal_mae"])
    for algo in ("bcfw", "mpbcfw", "mpbcfw-shard"):
        assert np.isfinite(out[algo])
    assert "mpbcfw-shard (1 shard(s))" in text
    assert "[1 dispatch / 1 sync]" in text


def test_sequence_labeling_matches_the_reference_script():
    out, text = _run(sequence_labeling.main, ["--device", "cpu"])
    _, want = _run(_reference("sequence_labeling").main)
    rows = [ln for ln in text.splitlines() if ln.startswith("iter")]
    want_rows = [ln for ln in want.splitlines() if ln.startswith("iter")]
    assert len(rows) == len(want_rows) == 5
    for got, ref in zip(rows, want_rows):
        g, r = (re.findall(r"[-\d.]+", x) for x in (got, ref))
        assert g[:3] == r[:3]                   # iteration, passes, ws
        assert abs(float(g[3]) - float(r[3])) <= 1.5e-5
    acc = float(re.search(r"token accuracy: ([\d.]+)", want).group(1))
    assert abs(out["token_accuracy"] - acc) <= 1e-3
    assert out["labels"].shape == (150, 12)


def test_segmentation_distributed_matches_the_reference_script():
    out, text = _run(segmentation_distributed.main, ["--device", "cpu"])
    _, want = _run(_reference("segmentation_distributed").main)
    want_rows = [ln for ln in want.splitlines() if ln.startswith("epoch")]
    got_rows = [ln for ln in text.splitlines() if ln.startswith("epoch")]
    assert len(got_rows) == len(want_rows) == 8
    for gap, got, ref in zip(out["gaps"], got_rows, want_rows):
        g, r = (re.findall(r"[-\d.]+", x) for x in (got, ref))
        assert g[0] == r[0] and g[3:] == r[3:]  # epoch, passes, oracles
        assert abs(float(g[1]) - float(r[1])) <= 1.5e-5
        assert abs(gap - float(r[2])) <= 1.5e-5
    assert out["host_syncs"] == out["dispatches"] == 8
    assert "8 host syncs, 48 collectives, 8 dispatches" in want + text


def test_ssvm_head_example_runs_on_the_cpu():
    out, text = _run(ssvm_head.main, ["--device", "cpu", "--iters", "2"])
    assert len(out["trace"]) == 2 and np.isfinite(out["gap"])
    assert "SSVM head trained on backbone features" in text


def test_ssvm_head_run_on_the_reference_weights_matches_it():
    """The example's run over the reference's weights (float32, carried
    across) against the reference script's problem and Solver."""
    jcfg = dataclasses.replace(jconfigs.reduced_config("qwen2-0.5b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.reduced_config("qwen2-0.5b"),
                               dtype=torch.float32)
    jp = jcommon.init_params(jregistry.param_specs(jcfg),
                             jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.device_get(jp), tcfg, "cpu")
    tokens, gold, mask = tagging_task(tcfg.vocab_size, 48, 12, 5)
    jprob = jhead.backbone_chain_problem(jcfg, jp, jnp.asarray(tokens),
                                         jnp.asarray(gold),
                                         jnp.asarray(mask), 5)
    want = JSolver(jprob, JRunConfig(
        lam=1.0 / jprob.n, algo="mpbcfw", max_iters=3, cap=16,
        cost_model=JCostModel(oracle_cost=0.5))).run().trace
    problem, res = ssvm_head.run(tcfg, tp, "cpu", iters=3)
    assert_allclose(problem.data["x"].numpy(), np.asarray(jprob.data["x"]),
                    rtol=1e-4, atol=1e-4)
    for g, w in zip(res.trace, want):
        assert (g.n_exact, g.n_approx) == (w.n_exact, w.n_approx)
        assert_allclose([g.dual, g.primal], [w.dual, w.primal], rtol=1e-4)


def test_lm_train_example_runs_on_the_cpu(tmp_path):
    out, text = _run(lm_train.main, ["--device", "cpu", "--steps", "4",
                                     "--seq-len", "16", "--batch-size", "2",
                                     "--ckpt-dir", str(tmp_path)])
    assert len(out["step_losses"]) == 4
    assert np.isfinite(out["step_losses"]).all()
    assert "over 4 steps" in text
    out, _ = _run(lm_train.main, ["--device", "cpu", "--steps", "2",
                                  "--seq-len", "16", "--batch-size", "2"])
    assert len(out["step_losses"]) == 2


@pytest.mark.parametrize("mod", [quickstart, sequence_labeling,
                                 segmentation_distributed, ssvm_head,
                                 lm_train])
def test_examples_default_to_cuda_and_raise_without_it(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        _run(mod.main, [])
