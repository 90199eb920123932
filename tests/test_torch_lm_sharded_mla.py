"""The reduced deepseek-v3-671b (MLA, its dense and MoE groups, MTP) on
DTensor parameters
on four gloo ranks on a (2, 2) ('data', 'model') mesh, against the
unsharded port run and the JAX package, on the CPU:
``tests/test_torch_lm_sharded.py``'s spawn and checks (and tolerances),
in a file of its own so that each spawn keeps its file within a worker's
minute.
"""
import pytest

import test_torch_lm_sharded as base

ARCHS = ("deepseek-v3-671b",)


@pytest.fixture(scope="module")
def runs():
    return base.spawn(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_hold_the_same_values(runs, arch):
    base.check_ranks_agree(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_run_equals_the_unsharded_port_run(runs, arch):
    base.check_equals_unsharded(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_ffn_input_holds_no_partial_sum(runs, arch):
    base.check_ffn_inputs_reduced(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_forward_equals_jax(runs, arch):
    base.check_unsharded_forward_equals_jax(runs, arch)
