"""``remat_policy`` in repro_torch: the four activation-checkpoint policies
(``models.common.remat_wrap``, ``torch.utils.checkpoint`` with
``use_reentrant=False``) give ``"none"``'s loss and gradients leaf by
leaf, bit for bit on the CPU (the recompute runs the same ops on the same
inputs), for a reduced config of each family that checkpoints its layers
(transformer blocks, MoE + MLA + MTP, Mamba2 groups, xLSTM groups, the
whisper decoder), in float32.  Also: the default is ``"nothing"``, an
unknown policy is refused, ``"dots"`` keeps the 2-D products and
recomputes the rest, and no policy wraps anything under ``no_grad``.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import common, registry

torch.set_num_threads(1)
ARCHS = ("qwen2-0.5b", "deepseek-v3-671b", "zamba2-7b", "xlstm-125m",
         "whisper-base")


def _grads(arch, policy):
    cfg = dataclasses.replace(configs.reduced_config(arch),
                              dtype=torch.float32, remat_policy=policy)
    gen = torch.Generator().manual_seed(0)
    params = common.init_params(registry.param_specs(cfg), gen, "cpu")
    batch = registry.make_train_batch(cfg, 2, 12, 3)
    return train.value_and_grad(params, cfg, batch)


@pytest.mark.parametrize("policy", ["nothing", "dots", "selective"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_plain_gradients_bit_for_bit(arch, policy):
    loss0, g0 = _grads(arch, "none")
    loss, g = _grads(arch, policy)
    assert torch.equal(loss, loss0)
    for a, b in zip(common.leaves(g), common.leaves(g0)):
        assert torch.equal(a, b)
    assert any(bool(a.abs().max() > 0) for a in common.leaves(g))


def test_remat_default_and_refusal():
    assert configs.get_config("qwen2-0.5b").remat_policy == "nothing"
    cfg = dataclasses.replace(configs.reduced_config("qwen2-0.5b"),
                              remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        common.remat_wrap(cfg, lambda x: x)


def test_remat_recomputes_by_policy():
    """Count the forward's matrix products run again in the backward: the
    whole body under "nothing", none of the 2-D ones under "dots", none
    without remat."""
    seen = []

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    w = torch.randn(8, 8, requires_grad=True)

    def body(x):
        return torch.tanh(torch.matmul(torch.tanh(torch.matmul(x, w)), w))

    def mms(policy):
        cfg = dataclasses.replace(configs.reduced_config("qwen2-0.5b"),
                                  remat_policy=policy)
        fn = common.remat_wrap(cfg, body)
        x = torch.randn(4, 8, requires_grad=True)
        out = fn(x).sum()
        seen.clear()
        with Count():
            out.backward()
        return sum(f == torch.ops.aten.mm.default for f in seen)

    plain = mms("none")
    assert mms("nothing") == plain + 2      # both products again
    assert mms("dots") == plain             # the 2-D products kept
    with torch.no_grad():
        cfg = configs.reduced_config("qwen2-0.5b")
        assert common.remat_wrap(cfg, body)(torch.ones(1, 8)).shape == (1, 8)
