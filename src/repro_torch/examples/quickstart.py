"""Quickstart: train structural SVMs through the public ``repro_torch.api``
(the port of ``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

Three layers, one seam each:

  * **Tasks** are :class:`repro_torch.api.OracleSpec` subclasses (joint
    feature map, loss and loss-augmented decode, each over a batch of
    examples); ``repro_torch.api.build_problem`` assembles the max-oracle.
    The bundled specs cover the paper's three scenarios (multiclass /
    chain / graph); a custom task is a ~20-line spec, demoed below.
  * **Algorithms** are engines in the ``repro_torch.api`` registry
    (``algorithms()`` lists the 14 names: ``fw``, ``ssg``, ``bcfw``,
    ``bcfw-avg``, ``mpbcfw``, ``mpbcfw-avg``, ``mpbcfw-gram``,
    ``mpbcfw-gap``, ``mpbcfw-async`` and the ``mpbcfw-shard*`` engines on
    a data mesh); third parties add their own with ``register_engine``.
  * **The control loop** is :class:`repro_torch.api.Solver`: streaming
    ``iterate()``, gap-tolerance / time-budget stopping, callbacks,
    checkpoint/resume.

Underneath every MP engine sits the plane cache (:mod:`repro_torch.cache`),
declared by a :class:`~repro_torch.cache.CacheLayout`.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..api import CostModel, OracleSpec, RunConfig, Solver, build_problem
from ..cache import CacheLayout
from .. import cache as plane_cache
from ..checkpoint import CheckpointManager
from ..core.oracles import chain, multiclass
from ..core.oracles.chain import resolve_device
from ..data import synthetic
from ..launch.mesh import make_data_mesh
from ..obs import RunRecorder, summarize_run
from ..serve import ServableModel, StructuredServer


def cm():
    return CostModel(oracle_cost=0.02, plane_cost=1e-4)


class OrdinalSpec(OracleSpec):
    """Ordinal regression, absolute-error loss: labels 0..C-1,
    Delta(y, y') = |y - y'| / (C-1).  These five methods, each over a
    batch, are all the optimizer needs; build_problem assembles the
    max-oracle."""

    C = 5

    def dim(self, data):
        return self.C * int(data["x"].shape[-1])

    def truth(self, batch):
        return batch["y"]

    def decode(self, w, batch):
        x, y = batch["x"], batch["y"]
        wc = w.reshape(self.C, x.shape[-1])
        c = torch.arange(self.C, device=x.device)
        delta = (c[None] - y[:, None]).abs() / (self.C - 1.0)
        return torch.argmax(x @ wc.T + delta, dim=1)  # loss-augmented

    def features(self, batch, y):
        x = batch["x"]
        onehot = torch.nn.functional.one_hot(y.long(), self.C).to(x.dtype)
        return (onehot[:, :, None] * x[:, None, :]).reshape(x.shape[0], -1)

    def loss(self, batch, y):
        return (y - batch["y"]).abs().float() / (self.C - 1.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=300,
                    help="usps-like examples (the reference's 300)")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="cap on every run's outer iterations")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    def iters(k: int) -> int:
        return k if args.max_iters is None else min(k, args.max_iters)

    x, y = synthetic.usps_like(n=args.n, f=64, num_classes=10, seed=0)
    problem = multiclass.make_problem(x, y, 10, device=dev)
    lam = 1.0 / problem.n

    print("== BCFW (baseline) vs MP-BCFW (paper), same oracle budget ==")
    for algo in ("bcfw", "mpbcfw"):
        res = Solver(problem, RunConfig(lam=lam, algo=algo,
                                        max_iters=iters(10), cap=32,
                                        cost_model=cm())).run()
        last = res.trace[-1]
        out[algo] = last.gap
        print(f"{algo:8s}: exact oracle calls {last.n_exact:5d}  "
              f"approx steps {last.n_approx:6d}  "
              f"duality gap {last.gap:.5f}  dual {last.dual:.5f}")

    # -- streaming iteration + gap-tolerance stopping ----------------------
    solver = Solver(problem, RunConfig(lam=lam, algo="mpbcfw",
                                       max_iters=iters(50), cap=32,
                                       gap_tol=1e-3, cost_model=cm()))
    for row in solver.iterate():            # rows stream as iterations run
        print(f"  iter {row.iteration:2d}  gap {row.gap:.6f}  "
              f"hit {row.cache_hit_rate:.2f}  evicted {row.planes_evicted}  "
              f"oracle share {row.oracle_share:.2f}  "
              f"[{row.dispatches} dispatch / {row.host_syncs} sync]")
    print(f"stopped after {solver.iteration} of {iters(50)} iterations "
          f"(gap_tol=1e-3, final gap {solver.trace[-1].gap:.2e})")

    # -- the same run on the mesh-sharded engine ---------------------------
    # (this process's ranks; at world size 1 bit for bit mpbcfw)
    mesh = make_data_mesh(device=dev)
    res = Solver(problem, RunConfig(lam=lam, algo="mpbcfw-shard", mesh=mesh,
                                    max_iters=iters(10), cap=32,
                                    cost_model=cm())).run()
    last = res.trace[-1]
    syncs = sum(r.host_syncs for r in res.trace)
    disp = sum(r.dispatches for r in res.trace)
    out["mpbcfw-shard"] = last.gap
    print(f"mpbcfw-shard ({mesh.shape['data']} shard(s)): "
          f"gap {last.gap:.5f}  dual {last.dual:.5f}  "
          f"[{disp} dispatches / {syncs} host syncs over "
          f"{len(res.trace)} iterations]")

    # -- the plane cache is a first-class subsystem ------------------------
    res = Solver(problem, RunConfig(lam=lam, algo="mpbcfw-shard-gram",
                                    mesh=mesh, max_iters=iters(5), cap=32,
                                    cost_model=cm())).run()
    print(f"mpbcfw-shard-gram: gap {res.trace[-1].gap:.5f}  "
          f"ws_mean {res.trace[-1].ws_mean:.1f}  "
          f"[{res.trace[-1].dispatches} dispatch / "
          f"{res.trace[-1].host_syncs} sync per iteration]")
    layout = CacheLayout(cap=8, gram=True, axis="data")
    demo = plane_cache.init(layout, n=4, d=problem.d, device=dev)
    demo = plane_cache.insert(demo, 0, torch.ones((problem.d + 1,),
                                                  device=dev), 0)
    print(f"PlaneCache: planes {tuple(demo.planes.shape)}  gram "
          f"{tuple(demo.gram.shape)}  sizes "
          f"{plane_cache.sizes(demo).cpu().numpy()}  specs "
          f"{plane_cache.partition_specs(layout).planes}")

    # -- gap-proportional sampling: the repro_torch.policy layer -----------
    res = Solver(problem, RunConfig(lam=lam, algo="mpbcfw-gap",
                                    max_iters=iters(8), cap=32,
                                    gap_frac=0.25, cost_model=cm())).run()
    for row in res.trace:
        print(f"  mpbcfw-gap iter {row.iteration:2d}  "
              f"sampled {row.gap_sampled:3d}/{problem.n} blocks  "
              f"gap_total {row.gap_total:.5f}  gap {row.gap:.5f}  "
              f"exact calls {row.n_exact:4d}")

    # -- async oracle pipelining: hide the costly oracle -------------------
    def slow_cfg(algo):
        return RunConfig(lam=lam, algo=algo, max_iters=iters(8), cap=16,
                         max_approx_passes=32, approx_batch=32,
                         cost_model=CostModel(oracle_cost=1.0,
                                              plane_cost=0.25))

    t_fused = Solver(problem, slow_cfg("mpbcfw")).run().trace[-1].time
    res = Solver(problem, slow_cfg("mpbcfw-async")).run()
    ovl = [r.oracle_overlap for r in res.trace]
    print(f"mpbcfw-async: mean oracle_overlap {sum(ovl) / len(ovl):.2f}  "
          f"modeled speedup {t_fused / res.trace[-1].time:.2f}x  "
          f"[{max(r.dispatches for r in res.trace)} dispatches / "
          f"{max(r.host_syncs for r in res.trace)} sync per iteration]")

    # -- record a run: repro_torch.obs (spans + metrics, no extra sync) ----
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/run.jsonl"
        with RunRecorder(path) as rec:
            Solver(problem, RunConfig(lam=lam, algo="mpbcfw",
                                      max_iters=iters(5), cap=32,
                                      cost_model=cm()),
                   recorder=rec).run()
        s = summarize_run(path)
    print(f"recorded run: {s['iterations']} iterations  "
          f"oracle share {s['oracle_share_mean']:.2f}  "
          f"host_syncs/iter <= {s['contract']['host_syncs_per_iter_max']}")

    # -- train -> serve: the repro_torch.serve path -------------------------
    Xc, Yc, Mc = synthetic.ocr_like(n=80, f=16, num_labels=8,
                                    mean_len=9, max_len=14, seed=3)
    chain_problem = chain.make_problem(Xc, Yc, Mc, num_labels=8, device=dev)
    csolver = Solver(chain_problem,
                     RunConfig(lam=1.0 / chain_problem.n, algo="mpbcfw",
                               max_iters=iters(6), cap=32, cost_model=cm()))
    csolver.run()
    with tempfile.TemporaryDirectory() as ckdir:
        csolver.servable().save(CheckpointManager(ckdir), step=6)
        model = ServableModel.load(CheckpointManager(ckdir), device=dev)
    requests = [{"x": Xc[i, :int(Mc[i].sum())],
                 "y": Yc[i, :int(Mc[i].sum())],
                 "mask": Mc[i, :int(Mc[i].sum())]} for i in range(16)]
    server = StructuredServer(model, batch_size=8)
    served = server.serve(requests)
    ok = all(np.array_equal(
        np.asarray(lab), model.spec.decode(model.w, {
            k: torch.from_numpy(np.ascontiguousarray(v))[None].to(dev)
            for k, v in r.items()})[0].cpu().numpy())
        for lab, r in zip(served, requests))
    rounds, dispatches, _ = server.ledger.counts()
    out["served_equal"] = ok
    print(f"served {len(served)} mixed-length chain requests in {rounds} "
          f"rounds ({dispatches} dispatches)  "
          f"equal to the per-example decode: {ok}")

    # -- accuracy of the learned (averaged) predictor ----------------------
    res = Solver(problem, RunConfig(lam=lam, algo="mpbcfw-avg",
                                    max_iters=iters(10), cap=32,
                                    cost_model=CostModel())).run()
    w = res.w_avg.reshape(10, -1)
    out["accuracy"] = float(np.mean(np.argmax(x @ w.T, axis=1) == y))
    print(f"train accuracy (mpbcfw-avg): {out['accuracy']:.3f}")

    # -- a custom task: define an OracleSpec, get every engine for free ----
    r = np.random.RandomState(1)
    xo = r.randn(200, 16).astype(np.float32)
    yo = np.clip((xo @ r.randn(16) * 0.7 + 2.5), 0, 4.99).astype(np.int32)
    ordinal = build_problem(OrdinalSpec(), {
        "x": torch.from_numpy(xo).to(dev), "y": torch.from_numpy(yo).to(dev)})
    res = Solver(ordinal, RunConfig(lam=1.0 / ordinal.n, algo="mpbcfw",
                                    max_iters=iters(10), cap=16,
                                    cost_model=cm())).run()
    wo = res.w.reshape(5, -1)
    out["ordinal_mae"] = float(np.mean(np.abs(np.argmax(xo @ wo.T, axis=1)
                                              - yo)))
    print(f"custom OrdinalSpec via mpbcfw: gap {res.trace[-1].gap:.5f}  "
          f"train MAE {out['ordinal_mae']:.3f}")
    return out


if __name__ == "__main__":
    main()
