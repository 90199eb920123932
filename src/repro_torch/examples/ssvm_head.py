"""SSVM head on backbone features, the port of ``examples/ssvm_head.py``:
the paper's technique over the LM substrate, a chain-CRF tag head on
qwen2-family token features, trained with MP-BCFW (convex given the
frozen features).  On the card the feature pass runs the flash-attention
kernel, and the head's oracle the Viterbi kernel.

    python -m repro_torch.examples.ssvm_head [--device cpu]

The backbone's weights are random from seed 0 (a torch generator, so not
the reference's ``PRNGKey(0)`` weights); :func:`run` takes any parameter
tree, e.g. the reference's through :mod:`repro_torch.convert`.
"""
from __future__ import annotations

import argparse

import torch

from .. import configs
from ..api import CostModel, RunConfig, Solver
from ..core.oracles.chain import resolve_device
from ..models import common, registry
from ..trainer.ssvm_head import backbone_chain_problem, tagging_task


def run(cfg, params: dict, device, iters: int = 8, n: int = 48,
        L: int = 12, tags: int = 5):
    """The example's task and run over ``params`` (on ``device``): the
    synthetic tagging task (tag = token id mod ``tags``), the head's
    problem on the backbone's features, and the Solver's result."""
    tokens, gold, mask = tagging_task(cfg.vocab_size, n, L, tags)
    problem = backbone_chain_problem(cfg, params, tokens, gold, mask, tags,
                                     device=device)
    cfg_run = RunConfig(lam=1.0 / problem.n, algo="mpbcfw", max_iters=iters,
                        cap=16, cost_model=CostModel(oracle_cost=0.5))
    return problem, Solver(problem, cfg_run).run()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.reduced_config("qwen2-0.5b")
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    params = common.init_params(registry.param_specs(cfg), gen, dev)
    _, res = run(cfg, params, dev, iters=args.iters)
    for r in res.trace[::2] + [res.trace[-1]]:
        print(f"iter {r.iteration:2d}  gap {r.gap:.5f}  "
              f"approx-passes {r.approx_passes}")
    print("SSVM head trained on backbone features with MP-BCFW.")
    return {"gap": res.trace[-1].gap, "trace": res.trace}


if __name__ == "__main__":
    main()
