"""Plain references of the two training algorithms the cells run.

* MP-BCFW (Shah, Kolmogorov, Lampert, arXiv:1408.6804, Alg. 3): an outer
  iteration evicts planes idle for more than ``ttl`` iterations, runs an
  exact BCFW pass (one oracle call per block, its plane cached in the
  block's working set, the least recently active one replaced when the
  set is full), then up to ``max_approx_passes`` approximate passes over
  the cached planes, stopped by the slope rule (Sec. 3.4) on a modelled
  clock: ``oracle_cost * n`` for the exact pass, ``plane_cost`` per
  cached plane for an approximate one.  Two averaged iterates are kept,
  one after every exact and one after every approximate step
  (Sec. 3.6); the reported one interpolates them at the best dual.
* BCFW-avg (Lacoste-Julien et al., ICML 2013, Alg. 4 with weighted
  averaging): exact passes only, the averaged iterate reported.

Everything is float32 as the configurations state, but the sums of the
primal objective, which run in float64.  Block orders come from
``np.random.RandomState(seed)``, drawn in the order the port's control
loop draws them: per outer iteration one permutation for the exact pass,
then, for MP-BCFW, ``min(approx_batch, max_approx_passes)`` for the
approximate batch (used or not), and one more batch each time the rule
still wants passes past a full batch.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

F32 = np.float32
_EPS = F32(1e-12)
_EMPTY_KEY = -2 ** 31 + 1


def dual(phi, lam):
    """F(phi) = -||phi*||^2 / (2 lam) + phi_o (paper eq. 5), float32."""
    return F32(-np.dot(phi[:-1], phi[:-1]) / F32(2.0 * lam) + phi[-1])


def weights(phi, lam):
    return -phi[:-1] / F32(lam)


def avg_weights(k):
    kf = F32(k)
    return kf / (kf + F32(2.0)), F32(2.0) / (kf + F32(2.0))


class Trainer:
    """The state and steps both algorithms share."""

    def __init__(self, oracle, lam: float, cap: int = 0):
        n, d = oracle.n, oracle.d
        self.oracle, self.lam, self.n, self.d = oracle, float(lam), n, d
        self.phi_i = np.zeros((n, d + 1), F32)
        self.phi = np.zeros(d + 1, F32)
        self.bar_exact = np.zeros(d + 1, F32)
        self.bar_approx = np.zeros(d + 1, F32)
        self.k_exact = self.k_approx = 0
        self.outer_it = 0
        if cap:
            # Lazily zeroed: only the slots a block fills are touched.
            self.planes = np.zeros((n, cap, d + 1), F32)
            self.valid = np.zeros((n, cap), bool)
            self.last_active = np.full((n, cap), -1, np.int32)
            self.used = np.zeros(n, np.int64)   # slots ever filled

    def block_update(self, i, plane):
        """BCFW's step on block ``i`` with the exact line search."""
        lam, phi, old = self.lam, self.phi, self.phi_i[i]
        diff = old - plane
        num = F32(np.dot(diff[:-1], phi[:-1]) - F32(lam) * diff[-1])
        den = F32(np.dot(diff[:-1], diff[:-1]))
        gamma = (F32(min(max(num / max(den, F32(1e-30)), 0.0), 1.0))
                 if den > 0 else F32(0.0))
        new = (F32(1.0) - gamma) * old + gamma * plane
        self.phi = phi + (new - old)
        self.phi_i[i] = new

    def average(self, bar, k):
        a, b = avg_weights(k)
        return a * bar + b * self.phi

    def exact_pass(self, perm, cache: bool):
        for pos, i in enumerate(perm):
            plane = self.oracle.plane(weights(self.phi, self.lam), i)
            self.block_update(i, plane)
            self.bar_exact = self.average(self.bar_exact, self.k_exact + pos)
            if cache:
                self.insert(i, plane)
        self.k_exact += len(perm)

    def insert(self, i, plane):
        key = np.where(self.valid[i], self.last_active[i], _EMPTY_KEY)
        slot = int(key.argmin())
        self.planes[i, slot] = plane
        self.valid[i, slot] = True
        self.last_active[i, slot] = self.outer_it
        self.used[i] = max(self.used[i], slot + 1)

    def approx_pass(self, perm, k0):
        mm = self.oracle.mm
        for pos, i in enumerate(perm):
            w = weights(self.phi, self.lam)
            hi = self.used[i]
            valid = self.valid[i, :hi]
            if valid.any():
                p = self.planes[i, :hi]
                s = np.where(valid, mm(p[:, :-1], w) + p[:, -1], -np.inf)
                slot = int(s.argmax())
                plane = p[slot]
            else:
                slot, plane = 0, np.zeros(self.d + 1, F32)
            self.block_update(i, plane)
            self.last_active[i, slot] = self.outer_it
            self.bar_approx = self.average(self.bar_approx, k0 + pos)

    def extract(self):
        """The averaged iterate: the best-dual interpolation of the two
        tracks (a track with no steps yields to the other)."""
        a, b = self.bar_exact, self.bar_approx
        diff = b - a
        num = F32(-np.dot(a[:-1], diff[:-1]) + F32(self.lam) * diff[-1])
        den = F32(np.dot(diff[:-1], diff[:-1]))
        beta = (F32(min(max(num / max(den, F32(1e-30)), 0.0), 1.0))
                if den > 0 else F32(0.0))
        if self.k_approx == 0:
            beta = F32(0.0)
        if self.k_exact == 0:
            beta = F32(1.0)
        return (F32(1.0) - beta) * a + beta * b

    def primal(self, phi):
        w = weights(phi, self.lam)
        w64 = w.astype(np.float64)
        return float(0.5 * self.lam * np.dot(w64, w64)
                     + self.oracle.hinges(w).sum())


def _slope_continue(f0, t0, f_prev, t_prev, f_last, t_last):
    dt_last = max(F32(t_last - t_prev), _EPS)
    dt_iter = max(F32(t_last - t0), _EPS)
    return (F32(f_last - f_prev) / dt_last
            >= F32(f_last - f0) / dt_iter)


def run_mpbcfw(oracle, lam: float, run: Dict, cost: Dict, seed: int,
               iterations: int, follow: Optional[List[int]] = None) -> Dict:
    """``iterations`` outer iterations of MP-BCFW.  Returns the rows
    (``dual``, ``primal``, ``primal_avg`` (the primal again, as an engine
    without averaging reports it), ``passes`` and ``planes``, the cached
    planes after the exact pass, and the weights ``w`` and averaged
    weights ``w_avg``, per iteration), ``w`` and ``w_avg`` after the last
    one, and ``rule_flips``.

    With ``follow`` (the approximate passes another run made in each
    iteration) the reference runs those counts, and the slope rule is
    judged by itself: ``rule_flips`` counts the decisions where the rule
    on the reference's own duals says otherwise by more than
    :data:`RULE_TOLERANCE` of the dual (a decision closer than that is
    rounding's to make).  Without it the rule decides, and ``rule_flips``
    is 0."""
    n = oracle.n
    cap, ttl = int(run["cap"]), int(run["ttl"])
    most = int(run["max_approx_passes"])
    batch = min(int(run["approx_batch"]), most)
    tr = Trainer(oracle, lam, cap)
    rng = np.random.RandomState(seed)
    rows: List[Dict] = []
    flips = 0
    for it in range(iterations):
        tr.outer_it += 1
        tr.valid &= (tr.outer_it - tr.last_active) <= ttl
        f0 = dual(tr.phi, lam)
        t0 = F32(0.0)
        perm = rng.permutation(n)
        perms = [rng.permutation(n) for _ in range(batch)]
        tr.exact_pass(perm, cache=True)
        total = int(tr.valid.sum())
        step_cost = F32(cost["plane_cost"]) * F32(max(total, 1))
        t = F32(np.float32(cost["oracle_cost"] * n))
        f = dual(tr.phi, lam)
        goal = None if follow is None else int(follow[it])
        passes, more = 0, True
        while True:
            for p in perms:
                if not more:
                    break
                tr.approx_pass(p, tr.k_approx + passes * n)
                f_new = dual(tr.phi, lam)
                t_new = F32(t + step_cost)
                cont = _slope_continue(f0, t0, f, t, f_new, t_new)
                passes += 1
                if goal is not None:
                    want = passes < goal
                    if passes < most and want != cont and _beyond_rounding(
                            f0, t0, f, t, f_new, t_new):
                        flips += 1
                    cont = want
                t, f = t_new, f_new
                more = more and cont
            if not (more and passes < most):
                break
            perms = [rng.permutation(n) for _ in range(
                min(batch, most - passes))]
        tr.k_approx += passes * n
        primal = tr.primal(tr.phi)
        rows.append(dict(dual=float(dual(tr.phi, lam)), primal=primal,
                         primal_avg=primal, passes=passes, planes=total,
                         w=weights(tr.phi, lam),
                         w_avg=weights(tr.extract(), lam)))
    return dict(rows=rows, w=weights(tr.phi, lam),
                w_avg=weights(tr.extract(), lam), rule_flips=flips)


# A slope-rule decision within this share of the dual is rounding's to
# make: the duals of two sound float32 runs differ by ~1e-6 of themselves
# after a few iterations, and a stalled pass moves the dual by less.
RULE_TOLERANCE = 1e-5


def _beyond_rounding(f0, t0, f_prev, t_prev, f_last, t_last) -> bool:
    """Whether the slope rule's two sides differ by more than
    :data:`RULE_TOLERANCE` of the dual, in dual units over the last
    pass's time: ``|(f_last - f_prev) - (f_last - f0) dt_last / dt_iter|
    > RULE_TOLERANCE |f_last|``."""
    dt_last = float(max(F32(t_last - t_prev), _EPS))
    dt_iter = float(max(F32(t_last - t0), _EPS))
    gap = (float(f_last) - float(f_prev)
           - (float(f_last) - float(f0)) * dt_last / dt_iter)
    return abs(gap) > RULE_TOLERANCE * abs(float(f_last))


def run_bcfw_avg(oracle, lam: float, run: Dict, cost: Dict, seed: int,
                 iterations: int, follow: Optional[List[int]] = None
                 ) -> Dict:
    """``iterations`` BCFW passes with the averaged iterate reported
    (``follow`` is unused: no pass is ruled)."""
    del run, cost, follow
    tr = Trainer(oracle, lam)
    rng = np.random.RandomState(seed)
    rows: List[Dict] = []
    for _ in range(iterations):
        tr.exact_pass(rng.permutation(oracle.n), cache=False)
        avg = tr.extract()
        rows.append(dict(dual=float(dual(tr.phi, lam)),
                         primal=tr.primal(tr.phi), primal_avg=tr.primal(avg),
                         passes=0, planes=0, w=weights(tr.phi, lam),
                         w_avg=weights(avg, lam)))
    return dict(rows=rows, w=weights(tr.phi, lam),
                w_avg=weights(tr.extract(), lam), rule_flips=0)


ALGORITHMS = {"mpbcfw": run_mpbcfw, "bcfw-avg": run_bcfw_avg}
