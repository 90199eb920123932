"""Faults planted in the port's timed path, to show that ``correct`` comes
out false (``bench/tests/test_bench_control.py``, and ``readings.py
--mode fault:<name>`` on the card at a cell's own size).  The first three
(:data:`FAULTS`) are those a training cell can have; the last
(:data:`AVERAGE_FAULTS`) breaks the averaged iterate alone.

* ``unchanged``: every step returns its state unchanged (no exact block
  step, no approximate pass runs).
* ``half_batch``: the exact pass visits only the first half of its
  permutation; the rest of the batch of blocks is left out.
* ``altered_answer``: the max-oracle's labelling is altered where it is
  produced (the first position's label moved to the next label).
* ``uniform_average``: the averaged iterate steps with the uniform
  average's weights ``(k/(k+1), 1/(k+1))`` in place of the weighted
  average's ``(k/(k+2), 2/(k+2))`` (Sec. 3.6); the iterate itself is
  untouched.

A cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

from contextlib import contextmanager


def _patches(name: str):
    import numpy as np
    from repro_torch.core import bcfw, graphs, mpbcfw
    from repro_torch.core.oracles import chain, graph

    if name == "unchanged":
        def mp_exact(problem, mp, perm, lam, *, graphs):
            return mp

        def bc_exact(problem, st, avg, perm, lam, *, graphs):
            return st, avg
        return [(mpbcfw, "exact_pass", mp_exact),
                (mpbcfw, "run_pass", lambda *a, **k: None),
                (bcfw, "exact_pass", bc_exact)]
    if name == "half_batch":
        mp_orig, bc_orig = mpbcfw.exact_pass, bcfw.exact_pass

        def mp_half(problem, mp, perm, lam, *, graphs):
            return mp_orig(problem, mp, perm[:len(perm) // 2], lam,
                           graphs=graphs)

        def bc_half(problem, st, avg, perm, lam, *, graphs):
            return bc_orig(problem, st, avg, perm[:len(perm) // 2], lam,
                           graphs=graphs)
        return [(mpbcfw, "exact_pass", mp_half),
                (bcfw, "exact_pass", bc_half)]
    if name == "altered_answer":
        c_orig = chain.ChainSpec.decode_scores
        g_orig = graph.GraphSpec.decode_scores

        def c_alter(self, w, unary, ex):
            y = c_orig(self, w, unary, ex).clone()
            y[:, 0] = (y[:, 0] + 1) % self.num_labels
            return y

        def g_alter(self, w, unary, ex):
            y = g_orig(self, w, unary, ex).clone()
            y[:, 0] = 1 - y[:, 0]
            return y
        return [(chain.ChainSpec, "decode_scores", c_alter),
                (graph.GraphSpec, "decode_scores", g_alter)]
    if name == "uniform_average":
        def uniform(k0, m, stride=1):
            kf = (k0 + stride * np.arange(m, dtype=np.int64)).astype(
                np.float32)
            one = np.float32(1.0)
            return np.stack([kf / (kf + one), one / (kf + one)], axis=1)
        return [(graphs, "weight_table", uniform),
                (mpbcfw, "weight_table", uniform)]
    raise KeyError(f"unknown fault {name!r}; one of "
                   f"{FAULTS + AVERAGE_FAULTS}")


FAULTS = ("unchanged", "half_batch", "altered_answer")
# A fault of the averaged iterate alone: ``ocr.bcfw-avg`` reports that
# iterate, and its first iteration's averaged weights catch it.
AVERAGE_FAULTS = ("uniform_average",)


@contextmanager
def planted(name: str):
    """The port with fault ``name`` planted, restored on exit."""
    patches = _patches(name)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, fn in patches:
            setattr(obj, attr, fn)
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
