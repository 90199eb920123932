"""How ``correct`` is decided: the program's first outer iterations and
its last evaluation against the plain reference (``bench/reference/``).

The reference follows the cell's first ``followed_iterations`` outer
iterations from the same arrays and seed, running the approximate passes
the program's slope rule chose (a decision at a float32 near-tie is
rounding's to make, and a different count moves everything after it);
the rule itself is judged by ``rule_flips``.  The numbers are

* ``dual_rel``: the widest relative gap of the dual ``F(phi)`` over those
  iterations, and ``dual_rel_it<k>`` the gap after the ``k``-th;
* ``primal_rel``: the same of the primal, and of the primal at the
  averaged iterate;
* ``w_rel_it<k>`` and ``w_avg_rel_it<k>``: the relative distance of the
  weights and of the averaged weights after the ``k``-th, and ``w_rel``,
  ``w_avg_rel`` the same after the last followed iteration;
* ``passes_diff``: the approximate passes the slope rule ran, summed
  absolute difference (0 where the reference follows the program's
  counts);
* ``ws_diff``: the cached planes after each exact pass, summed absolute
  difference (every exact step inserts one);
* ``rule_flips``: the slope rule's decisions of the program that the
  rule on the reference's own duals contradicts by more than rounding
  (``bench/reference/ssvm.py::RULE_TOLERANCE``);
* ``final_primal_rel``: the primal the program reported for its last
  iteration against the reference's primal at the program's last weights
  (the oracle and the evaluation after the whole window), and, where the
  engine evaluates its averaged iterate, ``final_primal_avg_rel``: the
  reported primal at the averaged iterate against the reference's at the
  program's last averaged weights.

A number is compared where the cell's ``limits`` name it; every number is
printed.  The control puts the reference in TF32 in the program's place:
over the followed iterations (:func:`standin_readings`) and in the
evaluation after the window (:func:`final_control_readings`), judged
together (:func:`control_readings`).
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, Tuple

import numpy as np

from bench.reference import ssvm


def oracle_for(cell, host: dict, precision: str = "float32"):
    mod = importlib.import_module(f"bench.reference.{cell.kind}")
    return mod.ORACLE(host, cell.cfg, precision)


def reference_run(cell, host: dict, seed: int, iterations: int,
                  precision: str = "float32", follow=None) -> dict:
    """The reference's ``iterations`` outer iterations of the cell's
    engine (running the pass counts ``follow`` where given), and its
    primal function (for the final check)."""
    from bench.harness import solver_seed
    oracle = oracle_for(cell, host, precision)
    algo = ssvm.ALGORITHMS[cell.traffic["engine"]]
    ref = algo(oracle, cell.lam, cell.traffic["run"],
               {"oracle_cost": float(cell.cfg["oracle_cost"]),
                "plane_cost": float(cell.cfg["plane_cost"])},
               solver_seed(seed), iterations, follow)
    ref["primal_at"] = lambda w: primal_at(oracle, cell.lam, w)
    return ref


def primal_at(oracle, lam: float, w) -> float:
    w = np.asarray(w, np.float32)
    w64 = w.astype(np.float64)
    return float(0.5 * lam * np.dot(w64, w64) + oracle.hinges(w).sum())


def _rel(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _vrel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def readings(rows, snapshots, final: dict, ref: dict, n: int) -> Dict:
    """The numbers compared.  ``rows`` are the program's first trace rows
    (objects with ``dual``, ``primal``, ``primal_avg``, ``approx_passes``
    and ``ws_mean``, the cached planes per block after the exact pass),
    ``snapshots`` its ``w``/``w_avg`` after each of them, ``final`` its
    last weights and reported primal (and, where the engine evaluates its
    averaged iterate, ``w_avg`` and ``primal_avg``); ``n`` the blocks."""
    out = {"dual_rel": 0.0, "primal_rel": 0.0, "passes_diff": 0,
           "ws_diff": 0, "rule_flips": int(ref["rule_flips"])}
    for k, (p, r, snap) in enumerate(zip(rows, ref["rows"], snapshots), 1):
        out["ws_diff"] += abs(int(round(p.ws_mean * n)) - int(r["planes"]))
        out[f"dual_rel_it{k}"] = _rel(p.dual, r["dual"])
        out["dual_rel"] = max(out["dual_rel"], out[f"dual_rel_it{k}"])
        out["primal_rel"] = max(out["primal_rel"],
                                _rel(p.primal, r["primal"]),
                                _rel(p.primal_avg, r["primal_avg"]))
        out["passes_diff"] += abs(int(p.approx_passes) - int(r["passes"]))
        out[f"w_rel_it{k}"] = out["w_rel"] = _vrel(snap["w"], r["w"])
        if snap.get("w_avg") is not None:
            out[f"w_avg_rel_it{k}"] = out["w_avg_rel"] = _vrel(
                snap["w_avg"], r["w_avg"])
    out["final_primal_rel"] = _rel(final["primal"],
                                   ref["primal_at"](final["w"]))
    if final.get("w_avg") is not None:
        out["final_primal_avg_rel"] = _rel(final["primal_avg"],
                                           ref["primal_at"](final["w_avg"]))
    return out


def judge(values: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """Each limited number against its limit (a number missing or not
    finite fails).  Returns ``(ok, {name: {"value", "limit"}})``."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


class _Row:
    def __init__(self, r: dict, n: int):
        self.dual, self.primal = r["dual"], r["primal"]
        self.primal_avg, self.approx_passes = r["primal_avg"], r["passes"]
        self.ws_mean = r["planes"] / n


def standin_readings(cell, host: dict, seed: int, iterations: int,
                     precision: str) -> Dict:
    """The reference computed in ``precision`` put in the program's place
    over the followed iterations, judged against the float32 reference by
    :func:`readings` (which follows its pass counts); its weights after
    the last of them stand for the window's last ones.  ``tf32`` is the
    control of ``correct``; ``float32-via-float64`` a witness of what
    rounding alone moves."""
    low = reference_run(cell, host, seed, iterations, precision=precision)
    ref = reference_run(cell, host, seed, iterations,
                        follow=[r["passes"] for r in low["rows"]])
    n = int(cell.cfg["n"])
    rows = [_Row(r, n) for r in low["rows"]]
    final = {"w": low["w"], "primal": low["primal_at"](low["w"])}
    if int(cell.traffic.get("eval_sweeps", 1)) > 1:
        final.update(w_avg=low["w_avg"],
                     primal_avg=low["primal_at"](low["w_avg"]))
    return readings(rows, low["rows"], final, ref, n)


def final_control_readings(cell, host: dict, final: dict) -> Dict:
    """The evaluation after the window in TF32 in the program's place:
    the reference's primal in TF32 at the program's last weights (and
    averaged weights, where the engine evaluates them) against the float32
    reference's at the same weights, under the names of the numbers they
    stand in for, prefixed ``control_``."""
    out = {}
    for key, w in (("final_primal_rel", final["w"]),
                   ("final_primal_avg_rel", final.get("w_avg"))):
        if w is None:
            continue
        want = primal_at(oracle_for(cell, host), cell.lam, w)
        low = primal_at(oracle_for(cell, host, "tf32"), cell.lam, w)
        out[f"control_{key}"] = _rel(low, want)
    return out


def control_readings(cell, host: dict, seed: int, iterations: int,
                     final: dict = None) -> Dict:
    """The control, as :func:`judge` reads it: the TF32 reference in the
    program's place over the followed iterations and, given the program's
    ``final`` weights after a window, in the evaluation after it (its
    numbers replace the stand-in's own ``final_primal_rel`` and
    ``final_primal_avg_rel``)."""
    vals = standin_readings(cell, host, seed, iterations, "tf32")
    if final is not None:
        for key, v in final_control_readings(cell, host, final).items():
            vals[key[len("control_"):]] = v
    return vals
