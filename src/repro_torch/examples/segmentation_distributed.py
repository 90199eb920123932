"""HorseSeg-style segmentation with a costly graph oracle, trained with the
mesh-sharded tau-nice MP-BCFW engine (:mod:`repro_torch.shard`), the port
of ``examples/segmentation_distributed.py``; simulated stragglers have
their oracle results replaced by their cached planes from one batched
scoring call (the paper's approximate oracle doubling as the
fault-tolerance path).

Each outer iteration is one dispatch: TTL eviction, the tau-nice exact
epoch (the chunk's oracles at its stale w, a sequential monotone
fold-in) and the slope-ruled batch of sharded approximate passes (one
all-reduce per pass), with the slope clock seeded from the device dual;
the host syncs once per iteration to read the stats.  The same engine is
reachable through ``repro_torch.api.Solver`` with ``algo="mpbcfw-shard"``;
this example drives it directly to show the straggler ``done`` mask.  The
reference's removed host chunk loop (``distributed.tau_nice_pass``) has no
counterpart in the port.

With S processes, each calling ``repro_torch.launch.mesh.init_ranks``
first, the same script shards blocks, plane cache and oracles over the S
ranks; alone it runs at world size 1.

    python -m repro_torch.examples.segmentation_distributed [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import mpbcfw
from ..core.oracles import graph
from ..core.oracles.chain import resolve_device
from ..core.ssvm import dual_value, duality_gap
from ..data import synthetic
from ..ft import StragglerPolicy, simulate_oracle_outcomes
from ..launch.mesh import make_data_mesh
from ..shard import ShardEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, tau, batch = 64, 8, 6
    Xg, Yg, Mg, Eg, EMg, Cg = synthetic.horseseg_like(
        n=n, grid=(8, 8), f=48, seed=0)
    problem = graph.make_problem(Xg, Yg, Mg, Eg, EMg, Cg, num_sweeps=30,
                                 device=dev)
    lam = 1.0 / n

    mesh = make_data_mesh(device=dev)
    engine = ShardEngine(problem, mesh, lam=lam)
    mp = engine.init_state(cap=16)
    rng = np.random.RandomState(0)
    policy = StragglerPolicy(straggler_prob=0.05)

    f_prev, gaps = 0.0, []
    for epoch in range(args.epochs):
        perm = rng.permutation(n)
        perms = np.stack([rng.permutation(n) for _ in range(batch)])
        done_np, lat = simulate_oracle_outcomes(n, policy, rng)
        done = done_np.reshape(n // tau, tau)
        clock = mpbcfw.make_slope_clock(0.0, f_prev, float(n), 1e-3, dev)
        mp, clock, stats = engine.outer_iteration(
            mp, perm, perms, clock, tau=tau, ttl=10, done=done)
        st = engine.read_stats(stats)  # the epoch's single host sync
        f_prev = float(dual_value(mp.inner.phi, lam))
        gaps.append(float(duality_gap(problem, mp.inner, lam)))
        print(f"epoch {epoch}  dual {f_prev:.5f}  gap {gaps[-1]:.5f}"
              f"  approx-passes {int(st.passes_run)}"
              f"  oracles-ok {int(done_np.sum())}/{n}"
              f"  (worst latency {lat.max():.1f}x median)")
    syncs, collectives, dispatches = engine.ledger.counts()
    print(f"\nstraggler-tolerant sharded MP-BCFW converged on "
          f"{engine.n_shards} shard(s): {syncs} host syncs, "
          f"{collectives} collectives, {dispatches} dispatches over "
          f"{args.epochs} epochs ({engine.psums_per_approx_pass} "
          f"all-reduce per approximate pass).")
    return {"dual": f_prev, "gaps": gaps, "host_syncs": syncs,
            "dispatches": dispatches}


if __name__ == "__main__":
    main()
