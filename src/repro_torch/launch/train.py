"""End-to-end training driver (the ``--arch`` entry point), PyTorch port
of ``repro/launch/train.py``.

Runs real steps on the card (or the CPU with ``--device cpu``): data
pipeline -> train step (forward, autograd backward, AdamW) ->
checkpoint/restart -> metrics.  ``--trainer ssvm`` switches to the
paper's MP-BCFW on one of its three scenarios.

Examples
--------
  # reduced qwen2-family LM for a few hundred steps
  # (repro_torch.examples.lm_train wraps this):
  python -m repro_torch.launch.train --arch qwen2-0.5b --reduced --steps 300

  # MP-BCFW structured training:
  python -m repro_torch.launch.train --trainer ssvm --scenario ocr --iters 20

The forward runs the flash-attention kernel (and, in MoE models, the
expert-FFN kernel) on the card; their backward recomputes the reference's
differentiable math (:mod:`repro_torch.kernels.ops`).  Each layer runs
under the config's ``remat_policy`` (``"nothing"`` by default: the
backward recomputes the layer's forward, kernels included).  As the
reference, ``train_lm`` builds the 1 x 1 host mesh and drops it at once:
one device here; the dry-run (:mod:`repro_torch.launch.dryrun`) runs the
pod meshes.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Optional

import torch

from .. import configs
from ..core.oracles.chain import resolve_device
from ..core.types import upload
from ..data.lm import DataConfig, Prefetcher, TokenDataset
from ..ft.restart import RestartManager
from .mesh import make_host_mesh
from ..models import common, registry
from ..optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from ..optim.adamw import tree_zip


def value_and_grad(params: dict, cfg, batch: dict):
    """``(loss, grads)``: the mean-token loss of ``batch`` (detached, a ()
    device tensor) and its gradient as a tree of ``params``'s structure
    (zeros for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    live = tree_zip(lambda p: p.detach().requires_grad_(), params)
    with registry.sharded(live):    # DTensor parameters: the backward too
        loss = registry.loss_fn(live, cfg, batch)
        flat = common.leaves(live)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, got)}
    return loss.detach(), tree_zip(lambda p: by_id[id(p)], live)


def train_step(state: dict, cfg, batch: dict, ocfg: AdamWConfig, lr):
    """One step: ``(new_state, loss, grad_norm)``, the losses and norm ()
    device tensors (nothing waits for the device)."""
    loss, grads = value_and_grad(state["params"], cfg, batch)
    params, opt, stats = adamw_update(grads, state["opt"], state["params"],
                                      ocfg, lr)
    return {"params": params, "opt": opt}, loss, stats["grad_norm"]


def init_state(cfg, ocfg: AdamWConfig, device) -> dict:
    """``{"params", "opt"}``: parameters from seed 0 (a torch generator on
    ``device``; not the reference's ``PRNGKey(0)`` weights) and zeroed
    AdamW moments."""
    gen = torch.Generator(device)
    gen.manual_seed(0)
    params = common.init_params(registry.param_specs(cfg), gen, device)
    return {"params": params, "opt": adamw_init(params, ocfg)}


def train_lm(arch: str, steps: int, batch_size: int, seq_len: int,
             reduced: bool, ckpt_dir: Optional[str] = None,
             save_every: int = 50, log_every: int = 10,
             target_params: int = 0, device: Optional[Any] = None) -> dict:
    """Train ``arch`` (reduced, or at its published size) for ``steps``
    steps of AdamW (lr 3e-4, cosine schedule with 20 warmup steps) on the
    synthetic token stream, resuming from ``ckpt_dir`` when it holds a
    checkpoint and saving every ``save_every`` steps.  A VLM's batches
    also carry :func:`registry.make_train_batch`'s ``vision_embeds`` for
    the step (seed = step); an MTP config's loss has its MTP term.

    Returns ``{"losses": [(step, loss)] at the logged steps, "final_loss",
    "step_losses", "grad_norms"}``, the last two one float per step run
    (read in one sync after the loop).  With a checkpoint directory every
    step reads its loss for the save's manifest, one sync per step, as the
    reference does."""
    dev = resolve_device(device)
    cfg = configs.reduced_config(arch) if reduced else configs.get_config(arch)
    if target_params:
        cfg = scale_to_params(cfg, target_params)
    ocfg = AdamWConfig(lr=3e-4)
    mesh = make_host_mesh(device=dev)
    del mesh  # one device here; the dry-run runs the pod meshes

    rm = RestartManager(ckpt_dir, save_every) if ckpt_dir else None
    if rm is not None:
        state, start_step = rm.resume_or_init(
            lambda: init_state(cfg, ocfg, dev))
    else:
        state, start_step = init_state(cfg, ocfg, dev), 0

    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                   batch_size=batch_size, seq_len=seq_len))
    pf = Prefetcher(data, start_step=start_step)
    losses, step_losses, grad_norms = [], [], []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            batch = pf.next()
            if cfg.family == "vlm":   # the stub's patch embeddings
                batch["vision_embeds"] = registry.make_train_batch(
                    cfg, batch_size, seq_len, step)["vision_embeds"]
            batch = {k: upload(v, dev) for k, v in batch.items()}
            lr = cosine_schedule(step, peak_lr=ocfg.lr, warmup=20,
                                 total=steps)
            state, loss, gnorm = train_step(state, cfg, batch, ocfg, lr)
            step_losses.append(loss)
            grad_norms.append(gnorm)
            if step % log_every == 0 or step == steps - 1:
                value = float(loss)
                losses.append((step, value))
                print(f"step {step:5d}  loss {value:.4f}  gnorm "
                      f"{float(gnorm):.3f}  {time.time() - t0:.1f}s",
                      flush=True)
            if rm is not None:   # a sync every step, as in the reference
                rm.maybe_save(step + 1, state, {"loss": float(loss)})
    finally:
        pf.close()
    per_step = (torch.stack(step_losses + grad_norms).float().cpu().tolist()
                if step_losses else [])
    n = len(step_losses)
    return {"losses": losses, "final_loss": losses[-1][1],
            "step_losses": per_step[:n], "grad_norms": per_step[n:]}


def scale_to_params(cfg, target: int):
    """Crude width scaling of a family config to ~target params (the
    reference's bisection over d_model)."""
    lo, hi = 32, 16384
    best = cfg
    while lo < hi - 16:
        mid = ((lo + hi) // 2) // 16 * 16
        trial = dataclasses.replace(
            cfg, d_model=mid, d_ff=4 * mid if cfg.d_ff else 0,
            num_heads=max(4, mid // 64),
            num_kv_heads=max(2, min(cfg.num_kv_heads, mid // 128)))
        n = sum(math.prod(s.shape)
                for s in common.leaves(registry.param_specs(trial)))
        if n < target:
            lo = mid
            best = trial
        else:
            hi = mid
    return best


def train_ssvm(scenario: str, iters: int, algo: str = "mpbcfw",
               device: Optional[Any] = None) -> dict:
    """MP-BCFW trainer mode: the ``SMALL`` scenario through the Solver on
    ``device`` (CUDA by default), under the scenario's cost model."""
    from ..api import RunConfig, Solver
    from ..configs.paper import SMALL
    from ..core.selection import CostModel
    from ..trainer.ssvm_head import build_problem

    sc = SMALL[scenario]
    prob = build_problem(sc, device=resolve_device(device))
    cfg = RunConfig(
        lam=1.0 / prob.n, algo=algo, max_iters=iters,
        cost_model=CostModel(oracle_cost=sc.oracle_cost,
                             plane_cost=sc.plane_cost))
    res = Solver(prob, cfg).run()
    for r in res.trace:
        print(f"iter {r.iteration:3d}  exact {r.n_exact:6d}  "
              f"approx {r.n_approx:7d}  dual {r.dual:.5f}  gap {r.gap:.5f}")
    return {"trace": res.trace}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trainer", choices=["lm", "ssvm"], default="lm")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--target-params", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--scenario", default="ocr")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--algo", default="mpbcfw")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.trainer == "ssvm":
        return train_ssvm(args.scenario, args.iters, args.algo,
                          device=args.device)
    return train_lm(args.arch, args.steps, args.batch_size, args.seq_len,
                    args.reduced, args.ckpt_dir, args.save_every,
                    target_params=args.target_params, device=args.device)


if __name__ == "__main__":
    main()
