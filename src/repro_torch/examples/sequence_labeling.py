"""Sequence labeling (OCR-style) with the chain/Viterbi max-oracle (the
port of ``examples/sequence_labeling.py``).

Shows the paper's costly-oracle regime: the Viterbi oracle is much more
expensive than an approximate (cached-plane) step, so the slope rule runs
many approximate passes per exact pass.  The decode of the learned
weights is :func:`repro_torch.core.oracles.chain.viterbi_decode`, the
Viterbi kernel on the card.

    python -m repro_torch.examples.sequence_labeling [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..api import CostModel, RunConfig, Solver
from ..core.oracles import chain
from ..core.oracles.chain import resolve_device, viterbi_decode
from ..data import synthetic


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=150)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    C, f = 12, 32
    X, Y, M = synthetic.ocr_like(n=args.n, f=f, num_labels=C, mean_len=8,
                                 max_len=12, seed=0)
    problem = chain.make_problem(X, Y, M, C, device=dev)
    lam = 1.0 / problem.n
    cfg = RunConfig(
        lam=lam, algo="mpbcfw", max_iters=args.iters, cap=32,
        cost_model=CostModel(oracle_cost=0.3, plane_cost=1e-4))
    res = Solver(problem, cfg).run()
    for r in res.trace[::3] + [res.trace[-1]]:
        print(f"iter {r.iteration:2d}  approx-passes {r.approx_passes:3d}  "
              f"ws {r.ws_mean:5.1f}  gap {r.gap:.5f}")

    # token accuracy with the learned weights
    w = torch.from_numpy(res.w).to(dev)
    wu, wp = w[: C * f].reshape(C, f), w[C * f:].reshape(C, C)
    x, mask = problem.data["x"], problem.data["mask"]
    labels = torch.stack([viterbi_decode(x[i] @ wu.T, wp, mask[i])
                          for i in range(problem.n)]).cpu().numpy()
    correct = int(((labels == Y) & M).sum())
    total = int(M.sum())
    print(f"token accuracy: {correct / total:.3f}")
    return {"gap": res.trace[-1].gap, "token_accuracy": correct / total,
            "labels": labels}


if __name__ == "__main__":
    main()
