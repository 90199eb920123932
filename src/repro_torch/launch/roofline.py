"""Roofline analysis via differential depth probing, PyTorch port of
``repro/launch/roofline.py``.

The reference probes because XLA's cost analysis counts a while-loop body
once whatever its trip count.  The port's dry-run (:mod:`.dryrun`)
traces an eager step, which runs every trip of every layer loop, so its
count is exact at every depth; probing here only saves time: each cell
is traced at a few tiny depths and the exact linear model

    metric(depths) = a + sum_k c_k * depth_k

is solved per metric (FLOPs, bytes accessed, per-kind collective bytes)
and extrapolated to the production depth.  Costs are layer-linear by
construction (every layer of a kind runs the same ops), so the
extrapolation equals a full-depth trace.  No analytic correction is
needed: the sLSTM's time loop and the SSD / mLSTM chunk loops are traced
trip by trip (:func:`analytic_corrections` returns 0).

The three roofline terms use one card's datasheet figures (NVIDIA H100
80GB HBM3 SXM at its 700 W limit, dense, no sparsity): 989 TFLOP/s bf16
(:data:`PEAK_FLOPS`), 3.35 TB/s HBM (:data:`HBM_BW`), 450 GB/s of NVLink
4 per direction (:data:`LINK_BW`), kept in :mod:`.trace_analysis` as the
reference keeps its chip's in ``hlo_analysis``.  A mesh past one host's 8
cards crosses the network between hosts, which is slower than NVLink;
this bound ignores it, so its collective term is a lower bound there.
The collective metrics are the dry-run's all-trips totals (every
collective the step issued, loop trips included).

Usage:  python -m repro_torch.launch.roofline --arch X --shape Y
        python -m repro_torch.launch.roofline --all     (one subprocess
                                                          per cell)
Records go to ``results/torch/roofline/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import traceback
from typing import Optional

import numpy as np

from .. import configs
from .trace_analysis import (CARD, HBM_BW, LINK_BW, PEAK_FLOPS,
                             roofline_terms)

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "torch" / "roofline")


# ---------------------------------------------------------------------------
# Probe schedules: (overrides, knob-counts) per point; knob-counts at full
# scale; each schedule has len(knobs)+1 points (exactly determined system).


def probe_schedule(cfg):
    """Returns (points, full_counts): points = [(overrides, counts)]."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return ([({"num_layers": 1}, {"L": 1}),
                 ({"num_layers": 2}, {"L": 2})],
                {"L": cfg.num_layers})
    if fam == "moe":
        if cfg.first_dense_layers:
            return ([({"first_dense_layers": 1, "num_layers": 2},
                      {"Ld": 1, "Lm": 1}),
                     ({"first_dense_layers": 2, "num_layers": 3},
                      {"Ld": 2, "Lm": 1}),
                     ({"first_dense_layers": 1, "num_layers": 3},
                      {"Ld": 1, "Lm": 2})],
                    {"Ld": cfg.first_dense_layers,
                     "Lm": cfg.num_layers - cfg.first_dense_layers})
        return ([({"num_layers": 1}, {"Lm": 1}),
                 ({"num_layers": 2}, {"Lm": 2})],
                {"Lm": cfg.num_layers})
    if fam == "hybrid":
        # group = attn_every mamba layers + 1 shared-attn invocation
        n_attn = cfg.num_layers // cfg.attn_every
        return ([({"attn_every": 1, "num_layers": 1},
                  {"Lm": 1, "La": 1}),
                 ({"attn_every": 1, "num_layers": 2},
                  {"Lm": 2, "La": 2}),
                 ({"attn_every": 2, "num_layers": 2},
                  {"Lm": 2, "La": 1})],
                {"Lm": cfg.num_layers, "La": n_attn})
    if fam == "ssm":  # xlstm
        n_s = cfg.num_layers // cfg.slstm_every
        n_m = cfg.num_layers - n_s
        return ([({"slstm_every": 2, "num_layers": 2},
                  {"Lm": 1, "Ls": 1}),
                 ({"slstm_every": 2, "num_layers": 4},
                  {"Lm": 2, "Ls": 2}),
                 ({"slstm_every": 3, "num_layers": 3},
                  {"Lm": 2, "Ls": 1})],
                {"Lm": n_m, "Ls": n_s})
    if fam == "audio":
        return ([({"encoder_layers": 1, "num_layers": 1},
                  {"Le": 1, "Ld": 1}),
                 ({"encoder_layers": 2, "num_layers": 1},
                  {"Le": 2, "Ld": 1}),
                 ({"encoder_layers": 1, "num_layers": 2},
                  {"Le": 1, "Ld": 2})],
                {"Le": cfg.encoder_layers, "Ld": cfg.num_layers})
    raise ValueError(fam)


def solve_linear(points, metrics_list, full_counts):
    """Solve metric = a + sum_k c_k n_k from len(knobs)+1 probe points."""
    knobs = sorted(full_counts)
    A = np.array([[1.0] + [float(counts[k]) for k in knobs]
                  for _, counts in points])
    out = {}
    keys = set()
    for m in metrics_list:
        keys |= set(m)
    for key in keys:
        y = np.array([float(m.get(key, 0.0)) for m in metrics_list])
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        a, cs = coef[0], coef[1:]
        out[key] = float(a + sum(c * full_counts[k]
                                 for c, k in zip(cs, knobs)))
        out[key + "__per_layer"] = {k: float(c)
                                    for k, c in zip(knobs, cs)}
    return out


def analytic_corrections(cfg, shape_cell, chips: int) -> dict:
    """The reference's extra FLOPs for time loops XLA counts once; the
    eager trace counts every sLSTM step and every chunk, so none."""
    del cfg, shape_cell, chips
    return {"flops_correction": 0.0}


# ---------------------------------------------------------------------------
# Runner


def probe_metrics(rec: dict) -> dict:
    """A dry-run record's probed metrics (the collectives of every loop
    trip)."""
    m = {"flops": rec["flops"], "bytes": rec["bytes_accessed"]}
    for k, v in rec["collective_all_trips_by_kind"].items():
        m[f"coll_{k}"] = v
    m["coll_total"] = rec["collective_bytes_all_trips"]
    return m


def run_probe(arch: str, shape: str, overrides: dict,
              mesh_shape: Optional[tuple] = None,
              replicate_fsdp: bool = False, cfg=None, cell=None) -> dict:
    """Trace one probe point in-process (``cfg`` with ``overrides``, or
    the arch's) and return its metrics."""
    from . import dryrun
    if cfg is not None:
        cfg = dataclasses.replace(cfg, **overrides)
    rec = dryrun.run_cell(arch, shape, multi_pod=False, overrides=overrides,
                          mesh_shape=mesh_shape,
                          replicate_fsdp=replicate_fsdp, cfg=cfg, cell=cell)
    return probe_metrics(rec)


def analyse_cell(arch: str, shape: str, user_overrides: Optional[dict] = None,
                 mesh_shape: Optional[tuple] = None,
                 replicate_fsdp: bool = False, cfg=None, cell=None) -> dict:
    """Probe one cell and solve its roofline; ``cfg`` and ``cell``
    replace the arch's config and the shape's cell (the tests' reduced
    ones)."""
    from .dryrun import count_params, model_flops
    from ..models import registry
    base = cfg
    if cfg is None:
        cfg = configs.get_config(arch)
        if shape == "long_500k":
            cfg = dataclasses.replace(
                cfg, **configs.long_context_overrides(arch))
    if user_overrides:
        cfg = dataclasses.replace(cfg, **user_overrides)
    cell = cell or configs.SHAPES[shape]
    points, full_counts = probe_schedule(cfg)
    metrics = []
    for overrides, _ in points:
        if base is None:
            m = run_probe(arch, shape, dict(user_overrides or {},
                                            **overrides),
                          mesh_shape=mesh_shape,
                          replicate_fsdp=replicate_fsdp, cell=cell)
        else:
            m = run_probe(arch, shape, overrides, mesh_shape=mesh_shape,
                          replicate_fsdp=replicate_fsdp, cfg=cfg, cell=cell)
        metrics.append(m)
    solved = solve_linear(points, metrics, full_counts)
    chips = int(np.prod(mesh_shape)) if mesh_shape else 256
    corr = analytic_corrections(cfg, cell, chips)
    flops = solved.get("flops", 0.0) + corr["flops_correction"]
    hbm = solved.get("bytes", 0.0)
    coll = solved.get("coll_total", 0.0)
    terms = roofline_terms(flops, hbm, coll, chips)
    dominant = max(terms, key=terms.get)

    counts_p = count_params(registry.param_specs(cfg))
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mf = model_flops(cfg, counts_p, tokens, cell.kind)
    return {
        "arch": arch, "shape": shape, "chips": chips, "ok": True,
        "card": CARD, "flops_per_device": flops,
        "hbm_bytes_per_device": hbm,
        "collective_bytes_per_device": coll,
        "collective_by_kind": {
            k[5:]: solved[k] for k in solved
            if k.startswith("coll_") and not k.endswith("__per_layer")
            and k != "coll_total"},
        "terms_s": terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "model_flops_per_device": mf / chips,
        "useful_flops_ratio": (mf / chips) / flops if flops else 0.0,
        "step_time_bound_s": max(terms.values()),
        "roofline_fraction": (
            (mf / chips / PEAK_FLOPS) / max(terms.values())
            if max(terms.values()) > 0 else 0.0),
        "corrections": corr,
        "probe_points": [dict(p[1]) for p in points],
        "per_layer": {k[:-len("__per_layer")]: v for k, v in solved.items()
                      if k.endswith("__per_layer")},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--replicate-fsdp", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)
    user_overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        user_overrides[k] = v
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        from .dryrun import all_cells
        failures = 0
        for arch, shape in all_cells():
            path = outdir / f"{arch}_{shape}_{args.tag}.json"
            if path.exists() and json.loads(path.read_text()).get("ok"):
                print(f"[skip] {arch} {shape}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.roofline",
                   "--arch", arch, "--shape", shape, "--out", str(outdir),
                   "--tag", args.tag]
            print(f"[run ] {arch} {shape}", flush=True)
            try:
                subprocess.run(cmd, check=True, timeout=args.timeout)
            except Exception as e:
                failures += 1
                path.write_text(json.dumps(
                    {"arch": arch, "shape": shape, "ok": False,
                     "error": str(e)}))
                print(f"[FAIL] {arch} {shape}: {e}", flush=True)
        print(f"roofline sweep done, failures={failures}")
        sys.exit(1 if failures else 0)

    path = outdir / f"{args.arch}_{args.shape}_{args.tag}.json"
    try:
        rec = analyse_cell(args.arch, args.shape, user_overrides,
                           mesh_shape, args.replicate_fsdp)
        rec["overrides"] = user_overrides
        rec["mesh_shape"] = list(mesh_shape) if mesh_shape else None
    except Exception as e:
        rec = {"arch": args.arch, "shape": args.shape, "ok": False,
               "error": repr(e), "traceback": traceback.format_exc()}
    path.write_text(json.dumps(rec, indent=2))
    if rec.get("ok"):
        t = rec["terms_s"]
        print(f"{args.arch} {args.shape}: compute {t['compute_s']:.4f}s "
              f"memory {t['memory_s']:.4f}s coll {t['collective_s']:.4f}s "
              f"-> {rec['dominant']}  roofline_frac "
              f"{rec['roofline_fraction']:.3f}")
    else:
        print(rec.get("traceback", rec.get("error")))
        sys.exit(1)


if __name__ == "__main__":
    main()
